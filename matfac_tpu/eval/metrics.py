"""Pointwise evaluation: RMSE family, regularized objective, NDCG@10.

JAX analog of the reference metric suite (model.cpp:214-251 RMSE
with invalid filtering, model.cpp:1770-1815 objective, model.cpp:760-830
NDCG). Everything is jitted over static-shape device arrays; the
Evaluator wrapper owns the host→device staging of a Data bundle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.models.base import EvalView


class CooDevice(NamedTuple):
    """Static-shape COO triplets with a validity weight on device."""
    rows: jax.Array   # [n] int32
    cols: jax.Array   # [n] int32
    vals: jax.Array   # [n] float32
    valid: jax.Array  # [n] float32


# entries per reduction chunk: XLA materializes the gathered [n, k]
# factor rows for the error einsum, so an unchunked pass at 100M nnz
# asks for a 51 GB intermediate (observed HBM OOM at the 1M-user scale
# run). 2^21 entries -> ~0.5 GB transient at k=64.
_EVAL_CHUNK = 1 << 21


def stage_coo(mat: RatingMatrix, invalid_users: np.ndarray,
              invalid_items: np.ndarray, n_users: int, n_items: int,
              pad_multiple: int = 1024) -> CooDevice:
    """Filter entries by invalid masks + bounds (RMSE semantics,
    model.cpp:222-240) and pad to a static size. Streams larger than
    _EVAL_CHUNK pad to a chunk multiple so reductions can scan."""
    r, c, v = mat.to_coo()
    keep = (r < n_users) & (c < n_items)
    keep &= ~invalid_users[np.clip(r, 0, n_users - 1)]
    keep &= ~invalid_items[np.clip(c, 0, n_items - 1)]
    r, c, v = r[keep], c[keep], v[keep]
    n = len(r)
    if n > _EVAL_CHUNK:
        # keep any caller-required divisibility (mesh shard count) —
        # shard-local streams that end up non-chunk-aligned are padded
        # in-trace by _chunked_err_reduce
        pad_multiple = int(np.lcm(pad_multiple, _EVAL_CHUNK))
    n_pad = (-n) % pad_multiple if n else pad_multiple
    pad = lambda a, z: np.concatenate([a, np.full(n_pad, z, a.dtype)])
    return CooDevice(
        jnp.asarray(pad(r.astype(np.int32), 0)),
        jnp.asarray(pad(c.astype(np.int32), 0)),
        jnp.asarray(pad(v.astype(np.float32), 0.0)),
        jnp.asarray(np.concatenate([np.ones(n, np.float32),
                                    np.zeros(n_pad, np.float32)])))


@jax.jit
def predict_pairs(view: EvalView, rows: jax.Array, cols: jax.Array
                  ) -> jax.Array:
    dots = jnp.einsum("ek,ek->e", view.u_fac[rows], view.i_fac[cols],
                      preferred_element_type=jnp.float32)
    return (view.mu + view.u_bias[rows] + view.i_bias[cols] + dots)


def _chunked_err_reduce(view: EvalView, coo: CooDevice,
                        weights: Optional[jax.Array]
                        ) -> Tuple[jax.Array, jax.Array]:
    """(sum of (weighted) squared errors, valid count), scanning
    _EVAL_CHUNK-entry slices so the gathered factor rows never
    materialize at full-nnz size."""
    n = coo.rows.shape[0]
    if n > _EVAL_CHUNK and n % _EVAL_CHUNK:
        # pad to a chunk multiple in-trace (valid=0 ⇒ zero contribution)
        # — reached by shard-local streams whose length the host-side
        # staging didn't chunk-align (Evaluator mesh mode)
        n_pad = (-n) % _EVAL_CHUNK
        zpad = lambda a: jnp.concatenate(
            [a, jnp.zeros((n_pad,), a.dtype)])
        coo = CooDevice(*(zpad(a) for a in coo))
        weights = zpad(weights) if weights is not None else None
        n = coo.rows.shape[0]

    def one(r, c, v, w, wt):
        pred = predict_pairs(view, r, c)
        d = v - pred
        se = w * d * d if wt is None else wt * w * d * d
        return jnp.sum(se), jnp.sum(w)

    if n <= _EVAL_CHUNK:
        return one(coo.rows, coo.cols, coo.vals, coo.valid, weights)
    m = n // _EVAL_CHUNK
    xs = [coo.rows.reshape(m, -1), coo.cols.reshape(m, -1),
          coo.vals.reshape(m, -1), coo.valid.reshape(m, -1)]
    xs.append(weights.reshape(m, -1) if weights is not None
              else jnp.zeros((m, 1)))

    def body(carry, x):
        r, c, v, w, wt = x
        s, cnt = one(r, c, v, w, None if weights is None else wt)
        return (carry[0] + s, carry[1] + cnt), None

    (s, cnt), _ = jax.lax.scan(body, (jnp.zeros(()), jnp.zeros(())),
                               tuple(xs))
    return s, cnt


@jax.jit
def sse(view: EvalView, coo: CooDevice) -> Tuple[jax.Array, jax.Array]:
    """(sum of squared errors, count) over valid entries."""
    return _chunked_err_reduce(view, coo, None)


@jax.jit
def weighted_sse(view: EvalView, coo: CooDevice, weights: jax.Array
                 ) -> jax.Array:
    """IFWMF objective data term (modelInvPopMF.cpp:22-32)."""
    return _chunked_err_reduce(view, coo, weights)[0]


def rmse_value(view: EvalView, coo: CooDevice) -> float:
    s, n = sse(view, coo)
    return float(jnp.sqrt(s / jnp.maximum(n, 1)))


@functools.partial(jax.jit, static_argnames=("u_reg", "i_reg"))
def reg_penalty(u_fac: jax.Array, i_fac: jax.Array,
                valid_u: jax.Array, valid_i: jax.Array,
                u_reg: float, i_reg: float) -> jax.Array:
    """u_reg*||uFac[valid]||^2 + i_reg*||iFac[valid]||^2
    (model.cpp:1782-1807). Uses the RAW (unmasked) factors — the
    reference regularizes all fac_dim dims even for truncated models."""
    u = jnp.sum(jnp.sum(u_fac * u_fac, axis=1) * valid_u)
    i = jnp.sum(jnp.sum(i_fac * i_fac, axis=1) * valid_i)
    return u_reg * u + i_reg * i


def ndcg_at_n(view: EvalView, test_cols: jax.Array, test_vals: jax.Array,
              test_mask: jax.Array, user_ids: jax.Array,
              user_valid: jax.Array, n: int = 10,
              eps: float = 1e-5) -> Tuple[jax.Array, jax.Array]:
    """NDCG@n with the reference's exact protocol (model.cpp:760-830):
    per user, keep the n test items with the HIGHEST PREDICTED rating;
    DCG uses their actual ratings in prediction order, the 'ideal' DCG
    re-sorts those same n by actual rating. Users with <2 valid test
    entries or ideal DCG <= eps are skipped.

    Inputs are padded per-user test rows [B, C]; returns (sum ndcg,
    n contributing users)."""
    B, C = test_cols.shape
    preds = (view.mu + view.u_bias[user_ids][:, None]
             + view.i_bias[test_cols]
             + jnp.einsum("bk,bck->bc", view.u_fac[user_ids],
                          view.i_fac[test_cols],
                          preferred_element_type=jnp.float32))
    neg_inf = jnp.float32(-3e38)
    masked_preds = jnp.where(test_mask > 0, preds, neg_inf)
    n_eff = min(n, C)
    top_pred, top_idx = jax.lax.top_k(masked_preds, n_eff)
    rels = jnp.take_along_axis(test_vals, top_idx, axis=1)
    sel_valid = jnp.take_along_axis(test_mask, top_idx, axis=1) > 0
    discounts = 1.0 / jnp.log2(jnp.arange(2, n_eff + 2, dtype=jnp.float32))
    gains = jnp.where(sel_valid, jnp.exp2(rels) - 1.0, 0.0)
    dcg = jnp.sum(gains * discounts[None, :], axis=1)
    # ideal order: valid gains (which may be negative for negative
    # ratings) sorted descending and COMPACTED to the front — masked
    # padding must sort strictly last, not interleave at gain 0
    sort_key = jnp.where(sel_valid, gains, neg_inf)
    ideal_sorted = -jnp.sort(-sort_key, axis=1)
    ideal_gains = jnp.where(ideal_sorted > neg_inf / 2, ideal_sorted, 0.0)
    idcg = jnp.sum(ideal_gains * discounts[None, :], axis=1)
    counts = jnp.sum(test_mask, axis=1)
    ok = (user_valid > 0) & (counts >= 2) & (idcg > eps)
    return jnp.sum(jnp.where(ok, dcg / jnp.maximum(idcg, eps), 0.0)), \
        jnp.sum(ok)


class Evaluator:
    """Owns device-staged eval inputs for one Data bundle + invalid masks.

    Provides the metric surface of the reference Model:
    RMSE(train/test/val), objective, NDCG@10 (hit-rate family lives in
    eval.ranking since it needs full-catalog scoring).
    """

    def __init__(self, data, invalid_users: np.ndarray,
                 invalid_items: np.ndarray, params, mesh=None):
        """``mesh``: shard the SSE/RMSE/objective reductions over all
        mesh devices — the COO stream splits across shards (each shard
        runs the chunked error reduce on its slice under shard_map) and
        partial (sse, count) psum; the result equals the single-device
        reduction up to f32 summation order."""
        self.params = params
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size) if mesh is not None else 1
        self._sse_fns = {}
        self.n_users = data.n_users
        self.n_items = data.n_items
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.valid_u = jnp.asarray(~invalid_users, jnp.float32)
        self.valid_i = jnp.asarray(~invalid_items, jnp.float32)

        def _stage(mat):
            coo = stage_coo(mat, invalid_users, invalid_items,
                            self.n_users, self.n_items,
                            pad_multiple=1024 * self.n_shards)
            if mesh is None:
                return coo
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
            return CooDevice(*(jax.device_put(a, sh) for a in coo))

        self.train_coo = _stage(data.train_mat)
        self.test_coo = (_stage(data.test_mat)
                         if data.test_mat is not None else None)
        self.val_coo = (_stage(data.val_mat)
                        if data.val_mat is not None else None)
        self._ndcg_cache = {}
        self._data = data

    def _sse(self, view: EvalView, coo: CooDevice,
             weights: Optional[jax.Array] = None
             ) -> Tuple[jax.Array, jax.Array]:
        """(sse, count) — sharded over the mesh when one is active."""
        if self.mesh is None:
            if weights is None:
                return sse(view, coo)
            return weighted_sse(view, coo, weights), jnp.zeros(())
        from jax.sharding import PartitionSpec as P
        axes = tuple(self.mesh.axis_names)
        key = weights is not None
        fn = self._sse_fns.get(key)
        if fn is None:
            def run(view, rows, cols, vals, valid, wt):
                s, cnt = _chunked_err_reduce(
                    view, CooDevice(rows, cols, vals, valid),
                    wt if key else None)
                return (jax.lax.psum(s, axes), jax.lax.psum(cnt, axes))

            fn = jax.jit(jax.shard_map(
                run, mesh=self.mesh,
                in_specs=(P(), P(axes), P(axes), P(axes), P(axes),
                          P(axes) if key else P()),
                out_specs=(P(), P()),
                # scan carry mixes replicated zeros with varying
                # inputs (see ranking._sharded); psum still reduces
                check_vma=False))
            self._sse_fns[key] = fn
        wt = weights if key else jnp.zeros((), jnp.float32)
        return fn(view, coo.rows, coo.cols, coo.vals, coo.valid, wt)

    # -- RMSE ----------------------------------------------------------
    def rmse(self, view: EvalView, which: str = "test") -> float:
        coo = {"train": self.train_coo, "test": self.test_coo,
               "val": self.val_coo}[which]
        if coo is None:
            raise ValueError(f"no {which} matrix")
        s, n = self._sse(view, coo)
        return float(jnp.sqrt(s / jnp.maximum(n, 1)))

    # -- objective -----------------------------------------------------
    def objective(self, view: EvalView, state,
                  weights: Optional[jax.Array] = None,
                  use_factors: bool = True,
                  use_bias: bool = False) -> float:
        """SSE(train) + reg penalty (model.cpp:1770-1815). ``weights``
        aligned with train_coo switches to the IFWMF weighted objective.
        ``use_factors=False`` drops the factor penalty and
        ``use_bias=True`` adds u_reg*||uBias||^2 + i_reg*||iBias||^2
        over valid entities — ModelMFBias counts ONLY bias reg
        (modelMFBias.cpp:87-88, factor term commented out) while
        ModelDropoutMFBias counts both (modelDropoutMFBias.cpp:77)."""
        s, _ = self._sse(view, self.train_coo, weights)
        reg = 0.0
        if use_factors:
            reg = reg_penalty(state.u_fac, state.i_fac, self.valid_u,
                              self.valid_i, float(self.params.u_reg),
                              float(self.params.i_reg))
        if use_bias:
            reg = reg + (
                float(self.params.u_reg)
                * jnp.sum(state.u_bias * state.u_bias * self.valid_u)
                + float(self.params.i_reg)
                * jnp.sum(state.i_bias * state.i_bias * self.valid_i))
        return float(s + reg)

    def objective_sing(self, view: EvalView, state,
                       singular_vals) -> float:
        """objectiveSing (model.cpp:1818-1865): L2 penalty weighted
        per-dim by the singular values, with NO uReg/iReg scaling."""
        s, _ = self._sse(view, self.train_coo)
        sv = jnp.asarray(singular_vals, jnp.float32)[None, :]
        u = jnp.sum(jnp.sum(state.u_fac * state.u_fac * sv, axis=1)
                    * self.valid_u)
        i = jnp.sum(jnp.sum(state.i_fac * state.i_fac * sv, axis=1)
                    * self.valid_i)
        return float(s + u + i)

    def full_low_rank_err(self, view: EvalView,
                          orig_u_fac, orig_i_fac,
                          exclude_rated: bool = True,
                          user_block: int = 512) -> float:
        """fullLowRankErr (model.cpp:1942-2038): RMSE between the model
        and a known ground-truth low-rank model over all valid
        (user, item) cells — optionally excluding train-rated cells
        (synthetic-recovery validation, SURVEY.md §4). Blocked dense."""
        ou = jnp.asarray(orig_u_fac, jnp.float32)
        oi = jnp.asarray(orig_i_fac, jnp.float32)
        n_users = self.n_users
        rated_cols = rated_mask = None
        if exclude_rated:
            cols, _, mask = self._data.train_mat.pad_rows()
            if self._data.train_mat.nrows < n_users:
                pad = n_users - self._data.train_mat.nrows
                cols = np.pad(cols, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            rated_cols = jnp.asarray(cols)
            rated_mask = jnp.asarray(mask.astype(np.float32))
        total = 0.0
        count = 0.0
        for s in range(0, n_users, user_block):
            e = min(s + user_block, n_users)
            uids = jnp.arange(s, e)
            pred = (view.mu + view.u_bias[uids][:, None]
                    + view.i_bias[None, :]
                    + view.u_fac[uids] @ view.i_fac.T)
            orig = ou[uids] @ oi.T
            ok = (self.valid_u[uids][:, None] * self.valid_i[None, :])
            if exclude_rated:
                B = e - s
                blk = jnp.ones((B, self.n_items))
                rows = jnp.arange(B)[:, None]
                rc = rated_cols[uids]
                blk = blk.at[rows, rc].min(
                    jnp.where(rated_mask[uids] > 0, 0.0, 1.0),
                    mode="drop")
                ok = ok * blk
            d = (orig - pred) * ok
            total += float(jnp.sum(d * d))
            count += float(jnp.sum(ok))
        return float(np.sqrt(total / max(count, 1.0)))

    # -- NDCG ----------------------------------------------------------
    def _padded_test(self, which: str):
        if which not in self._ndcg_cache:
            mat = (self._data.test_mat if which == "test"
                   else self._data.val_mat)
            cols, vals, mask = mat.pad_rows()
            # invalid items are excluded from the scan (model.cpp:785)
            mask = mask & ~self.invalid_items[cols]
            user_ids = np.arange(mat.nrows, dtype=np.int32)
            user_valid = (~self.invalid_users[:mat.nrows]).astype(np.float32)
            self._ndcg_cache[which] = tuple(map(jnp.asarray, (
                cols, vals.astype(np.float32), mask.astype(np.float32),
                user_ids, user_valid)))
        return self._ndcg_cache[which]

    def ndcg(self, view: EvalView, which: str = "test", n: int = 10,
             user_mask=None) -> float:
        """``user_mask``: optional boolean [n_users-ish] restricting the
        averaged users (quartileNDCG, main.cpp:568)."""
        cols, vals, mask, user_ids, user_valid = self._padded_test(which)
        if user_mask is not None:
            um = jnp.asarray(np.asarray(
                user_mask[: user_valid.shape[0]], np.float32))
            user_valid = user_valid * um
        total, cnt = ndcg_at_n(view, cols, vals, mask, user_ids,
                               user_valid, n=n, eps=self.params.eps)
        cnt = float(cnt)
        return float(total) / cnt if cnt else 0.0
