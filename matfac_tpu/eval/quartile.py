"""Quartile (frequency-bucket) RMSE / ranking reports.

Analog of the reference driver's post-train reporting
(quartileRMSEs main.cpp:700-768, quartileHR :656, quartileARHR :612,
quartileNDCG :568, with the partitions built by getUserItemRankMap
main.cpp:1137-1168): users and items are split into frequency quartiles
on the TRAIN matrix, and test/val RMSE is reported restricted to each
user-quartile and item-quartile (count + RMSE per bucket).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from matfac_tpu.utils import freq as ufreq


def split_residuals(view, ev, which: str):
    """One full predict pass + device->host fetch for a split; pass the
    result to repeated filtered_rmse calls (quartile reports issue 16+
    bucket queries — recomputing per bucket cost ~16 full-nnz device
    passes AND device->host fetches)."""
    from matfac_tpu.eval.metrics import predict_pairs

    coo = {"train": ev.train_coo, "test": ev.test_coo,
           "val": ev.val_coo}[which]
    pred = np.asarray(predict_pairs(view, coo.rows, coo.cols))
    return (np.asarray(coo.rows), np.asarray(coo.cols),
            np.asarray(coo.vals) - pred, np.asarray(coo.valid) > 0)


def filtered_rmse(view, ev, which: str, user_filter=None,
                  item_filter=None, residuals=None) -> Tuple[int, float]:
    """(count, RMSE) over entries whose user/item passes the filter —
    Model::RMSE(mat, filtItems, ...) / RMSEU semantics
    (model.cpp:348-486). ``residuals``: optional split_residuals()
    output reused across bucket calls."""
    if residuals is None:
        residuals = split_residuals(view, ev, which)
    r, c, d, valid = residuals
    mask = valid.copy()
    if user_filter is not None:
        mask &= user_filter[r]
    if item_filter is not None:
        mask &= item_filter[c]
    if not mask.any():
        return 0, float("nan")
    dm = d[mask]
    return int(mask.sum()), float(np.sqrt((dm * dm).mean()))


def _pad_zeros(a: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad (np.resize tiles CYCLICALLY — entities beyond the train
    matrix would inherit entity 0,1,2...'s frequencies and land in the
    wrong quartiles; review r3)."""
    a = np.asarray(a)
    return a[:n] if len(a) >= n else np.pad(a, (0, n - len(a)))


def quartile_partitions(data, inval_u, inval_i, n_quantiles: int = 4
                        ) -> Tuple[np.ndarray, np.ndarray]:
    user_freq, item_freq = ufreq.row_col_freq(data.train_mat)
    user_freq = _pad_zeros(user_freq, data.n_users)
    item_freq = _pad_zeros(item_freq, data.n_items)
    uq = ufreq.quartile_assignments(user_freq, ~inval_u, n_quantiles)
    iq = ufreq.quartile_assignments(item_freq, ~inval_i, n_quantiles)
    return uq, iq


def quartile_report(view, data, ev, inval_u, inval_i,
                    n_quantiles: int = 4) -> str:
    uq, iq = quartile_partitions(data, inval_u, inval_i, n_quantiles)
    lines: List[str] = []
    for which in ("test", "val"):
        if (which == "test" and ev.test_coo is None) or \
           (which == "val" and ev.val_coo is None):
            continue
        lines.append(f"{which.capitalize()} RMSE by quartile "
                     f"(q0 = least frequent):")
        res = split_residuals(view, ev, which)   # one pass per split
        for label, q in (("Items", iq), ("Users", uq)):
            parts = []
            for b in range(n_quantiles):
                filt = q == b
                cnt, rmse = filtered_rmse(
                    view, ev, which,
                    user_filter=filt if label == "Users" else None,
                    item_filter=filt if label == "Items" else None,
                    residuals=res)
                parts.append(f"{cnt} {rmse:.6f}")
            lines.append(f"  {label} Part: " + "  ".join(parts))
    return "\n".join(lines)


def quartile_ranking_report(view, data, scorer, inval_u, inval_i,
                            n_quantiles: int = 4, n: int = 10,
                            evaluator=None) -> str:
    """quartileHR / quartileARHR / quartileNDCG analogs
    (main.cpp:568-698): leave-one-out HR and ARHR (and NDCG when an
    Evaluator is provided) restricted to users in each frequency
    quartile."""
    from matfac_tpu.eval.ranking import _loo_score

    uq, _ = quartile_partitions(data, inval_u, inval_i, n_quantiles)
    _, top_hr = scorer.topk(view, n)
    _, top_ar = scorer.topk(view, min(1000, data.n_items))
    lines = []
    for label, ti, recip in ((f"Test HR@{n}", top_hr, False),
                             ("Test ARHR", top_ar, True)):
        parts = []
        for b in range(n_quantiles):
            inval_mask = inval_u | (uq != b)
            v = _loo_score(ti, data.test_mat, inval_mask,
                           data.n_users, reciprocal=recip)
            parts.append(f"q{b}={v:.4f}")
        lines.append(f"{label} by user quartile:\n  " + "  ".join(parts))
    if evaluator is not None:
        parts = []
        for b in range(n_quantiles):
            nd = evaluator.ndcg(view, "test", n=n, user_mask=(uq == b))
            parts.append(f"q{b}={nd:.4f}")
        lines.append("Test NDCG@10 by user quartile:\n  "
                     + "  ".join(parts))
    return "\n".join(lines)


def submat_rmse(view, ev, which: str, u_range, i_range,
                exclude: bool = False):
    """subMatRMSE / subMatExRMSE analogs (model.h:179-181): (count,
    RMSE) over entries inside (or, with exclude=True, outside) the
    [uStart, uEnd) x [iStart, iEnd) block."""
    u_lo, u_hi = u_range
    i_lo, i_hi = i_range
    n_u = len(np.asarray(ev.valid_u))
    n_i = len(np.asarray(ev.valid_i))
    uf = np.zeros(n_u, bool)
    uf[u_lo:u_hi] = True
    itf = np.zeros(n_i, bool)
    itf[i_lo:i_hi] = True
    if not exclude:
        return filtered_rmse(view, ev, which, user_filter=uf,
                             item_filter=itf)
    # exclude: entries NOT fully inside the block
    import jax.numpy as jnp
    from matfac_tpu.eval.metrics import predict_pairs

    coo = {"train": ev.train_coo, "test": ev.test_coo,
           "val": ev.val_coo}[which]
    mask = np.asarray(coo.valid) > 0
    r = np.asarray(coo.rows)
    c = np.asarray(coo.cols)
    mask &= ~(uf[r] & itf[c])
    if not mask.any():
        return 0, float("nan")
    pred = np.asarray(predict_pairs(view, coo.rows, coo.cols))
    d = (np.asarray(coo.vals) - pred)[mask]
    return int(mask.sum()), float(np.sqrt((d * d).mean()))
