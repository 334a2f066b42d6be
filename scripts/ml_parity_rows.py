"""Fill the BASELINE.md measurement-plan parity rows.

The image has no MovieLens files, so each row runs on a
*shape- and rating-distribution-matched* synthetic: power-law item
popularity + 1-5 star quantile quantization (data.synthetic
`stars=True`), tagged SYNTHETIC in BASELINE.md. Rows:

  * ML-1M shape   (6040 x 3706, ~1M ratings), rank-64 ALS   -> RMSE
  * ML-10M shape  (69878 x 10677, ~10M),     rank-64 CCD++ -> RMSE
  * ML-10M shape  implicit positives,        rank-64 BPR   -> HR@10/NDCG@10
  * ML-20M shape  (138k x 27k, ~20M),        rank-128 TMF+Poisson -> RMSE
    (+ frequency-quartile RMSEs — the WWW'19 long-tail protocol)

Run on the GPU: PYTHONPATH=. python scripts/ml_parity_rows.py
(one JAX process per card).
"""

import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def pointwise_row(name, algo, method, n_users, n_items, density, k,
                  max_iter, seed=11, quartiles=False, **params_kw):
    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.train.loop import train_model

    data, _, _ = synthetic_data(
        n_users=n_users, n_items=n_items, k=16,
        density=density, seed=seed, noise=0.4, power_law=0.9,
        nonneg=True, stars=True)
    r0, c0, v0 = data.train_mat.to_coo()
    rv, cv, vv = data.val_mat.to_coo()
    base = float(np.sqrt(((vv - v0.mean()) ** 2).mean()))
    log(f"--- {name}: {data.train_mat} k={k} method={method} "
        f"mean-baseline val RMSE={base:.4f}")
    p = Params(fac_dim=k, max_iter=max_iter, seed=1, disp_iter=10 ** 6,
               **params_kw)
    t0 = time.time()
    rep, model, ev, (iu, ii) = train_model(
        data, p, algo=algo, mf_method=method, log_fn=lambda s: None)
    test = ev.rmse(model.eval_view(rep.best_state), "test")
    log(f"{name}: best_val={rep.best_metric:.4f} test={test:.4f} "
        f"best_iter={rep.best_iter} stop={rep.stop_reason} "
        f"wall={time.time()-t0:.0f}s")
    if quartiles:
        from matfac_tpu.eval.quartile import quartile_report
        rpt = quartile_report(model.eval_view(rep.best_state), data, ev,
                              iu, ii)
        log(f"{name} quartiles:\n{rpt}")
    return rep


def bpr_row(n_users=69878, n_items=10677, per_user=140, k=64,
            max_iter=40, temp=0.3):
    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import leave_one_out_data
    from matfac_tpu.train.loop import train_model

    data = leave_one_out_data(n_users=n_users, n_items=n_items, k=16,
                              per_user=per_user, seed=6,
                              structured=True, temp=temp)
    log(f"--- ML-10M-shape BPR (temp={temp}): {data.train_mat}")
    p = Params(fac_dim=k, max_iter=max_iter, seed=2, learn_rate=0.1,
               u_reg=0.001, i_reg=0.001, batch_size=65536,
               disp_iter=10, n_negatives=2, bpr_sampler="rankgap")
    t0 = time.time()
    rep, model, scorer, _ = train_model(data, p, algo="bpr",
                                        log_fn=log)
    view = model.eval_view(rep.best_state)
    hr = scorer.hit_rate(view, data.test_mat, 10)
    arhr = scorer.arhr(view, data.test_mat)
    try:
        from matfac_tpu.eval.metrics import Evaluator
        iu = np.zeros(n_users, bool)
        ii = np.zeros(n_items, bool)
        ev = Evaluator(data, iu, ii, p)
        ndcg = f"{ev.ndcg(view, 'test'):.4f}"
    except Exception as e:  # noqa: BLE001 — remote-compile flakiness
        ndcg = f"n/a ({type(e).__name__})"
    log(f"ML-10M-shape BPR: best_val_HR={rep.best_metric:.4f} "
        f"test_HR@10={hr:.4f} test_ARHR={arhr:.4f} "
        f"test_NDCG@10={ndcg} wall={time.time()-t0:.0f}s")

    # non-saturated protocol: the held-out item vs 999
    # POPULARITY-sampled negatives, with the popularity scorer itself
    # as the margin base — full-catalog HR ~1.0 on this data says only
    # that the pipeline runs
    from matfac_tpu.eval.ranking import (popularity_ranking_metrics,
                                         sampled_ranking_metrics)
    iu = np.zeros(n_users, bool)
    ii = np.zeros(n_items, bool)
    pop = data.train_mat.col_degrees().astype(np.float64) + 0.1
    shr, sar = sampled_ranking_metrics(
        view, data.test_mat, data.train_mat, iu, ii, n=10,
        n_candidates=1000, popularity=pop, seed=7)
    phr, par = popularity_ranking_metrics(
        data.test_mat, data.train_mat, iu, ii, n_users, n_items,
        n=10, n_candidates=1000, popularity=pop, seed=7)
    log(f"ML-10M-shape BPR sampled-negatives (999 pop-sampled): "
        f"model HR@10={shr:.4f} ARHR={sar:.4f} | popularity scorer "
        f"HR@10={phr:.4f} ARHR={par:.4f} | margin {shr-phr:+.4f}")


def main():
    import os

    import jax
    log("devices:", jax.devices())
    rows = os.environ.get("PARITY_ROWS", "als,ccdpp,tmf,bpr").split(",")
    # ML-1M shape, ALS rank-64 (reg from the CPU sweep: lambda=10 is
    # the val basin at 600k ratings / 623k params — reg 0.05 overfits
    # to 1.76, worse than the mean predictor)
    if "als" in rows:
        pointwise_row("ML-1M-shape ALS", "mf", "als", 6040, 3706,
                      1_000_000 / (6040 * 3706), 64, 60,
                      u_reg=10.0, i_reg=10.0)
    # ML-10M shape, CCD++ rank-64 (sorted engine), same basin
    if "ccdpp" in rows:
        pointwise_row("ML-10M-shape CCD++", "mf", "ccd++", 69878,
                      10677, 10_000_000 / (69878 * 10677), 64, 12,
                      u_reg=10.0, i_reg=10.0)
    # ML-20M shape, TMF+Poisson rank-128 + quartiles
    if "tmf" in rows:
        pointwise_row("ML-20M-shape TMFDropout", "tmfdropout", "auto",
                      138_000, 27_000,
                      20_000_000 / (138_000 * 27_000), 128, 60,
                      u_reg=0.005, i_reg=0.005, learn_rate=0.05,
                      rho_rms=1.0, alpha=0.0, batch_size=65536,
                      quartiles=True)
    # ML-10M shape, BPR
    if "bpr" in rows:
        bpr_row()
    # harder preference noise (temp=1.0): the NON-saturated ranking row
    # (HR@10 < 0.99 so quality differences are visible)
    if "bprhard" in rows:
        bpr_row(temp=1.0)
    log("PARITY_ROWS_DONE")


if __name__ == "__main__":
    main()
