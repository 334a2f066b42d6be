"""Device-batched primitives for the analysis layer.

Round-1 analysis drivers dispatched one tiny device call per user/item
(~10^5 round trips at the reference's 10k-user protocols). These
helpers move the math into a few block dispatches:

  * ``catalog_sq_err``: per-user squared pred-vs-orig error over the
    whole catalog, one [B, n_items] matmul block at a time — feeds
    every bucket-RMSE family (confCompute.cpp:1358-1447,
    topBucketComp.cpp:2669/3883 inner loops).
  * ``score_pools``: batched scoring of per-pair candidate pools
    ({test item} ∪ sampled negatives) — the longTail.cpp:279-502
    topNRec hot loop as gather-dot batches.

Both consume EvalViews, so rank-truncated (TMF-family) models work
unchanged (masking is folded into the view's factors).
"""

from __future__ import annotations

import functools
from typing import Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.models.base import EvalView


@jax.jit
def _sq_err_block(orig_view: EvalView, full_view: EvalView,
                  user_ids: jax.Array) -> jax.Array:
    """[B, n_items] squared error between the two models' predictions
    for a block of users over the full catalog."""
    def scores(view):
        u = view.u_fac[user_ids]
        s = jnp.dot(u, view.i_fac.T, preferred_element_type=jnp.float32)
        return (s + view.mu + view.u_bias[user_ids][:, None]
                + view.i_bias[None, :])
    d = scores(orig_view) - scores(full_view)
    return d * d


@jax.jit
def _preds_block(view: EvalView, user_ids: jax.Array) -> jax.Array:
    """[B, n_items] predicted scores for a block of users."""
    u = view.u_fac[user_ids]
    s = jnp.dot(u, view.i_fac.T, preferred_element_type=jnp.float32)
    return (s + view.mu + view.u_bias[user_ids][:, None]
            + view.i_bias[None, :])


def catalog_preds(view: EvalView, users: np.ndarray, block: int = 1024
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (user_block_positions, preds[B, n_items]) host arrays, one
    fixed-size jitted dispatch per block — NEVER materialize the full
    [n_users, n_items] score matrix on device (HBM OOM at 100k x 100k;
    review r3)."""
    users = np.asarray(users, np.int32)
    n = len(users)
    for s in range(0, n, block):
        ids = users[s:s + block]
        m = len(ids)
        ids_p = np.pad(ids, (0, block - m)) if m < block else ids
        p = np.asarray(_preds_block(view, jnp.asarray(ids_p)))
        yield np.arange(s, s + m), p[:m]


def catalog_sq_err(orig_view: EvalView, full_view: EvalView,
                   users: np.ndarray, block: int = 1024
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (user_block_positions, d2[B, n_items]) host arrays, one
    jitted dispatch per block (padded to a fixed block size so the
    kernel compiles once)."""
    users = np.asarray(users, np.int32)
    n = len(users)
    for s in range(0, n, block):
        ids = users[s:s + block]
        m = len(ids)
        ids_p = np.pad(ids, (0, block - m)) if m < block else ids
        d2 = np.asarray(_sq_err_block(orig_view, full_view,
                                      jnp.asarray(ids_p)))
        yield np.arange(s, s + m), d2[:m]


@functools.partial(jax.jit, static_argnames=("pair_block",))
def _pool_scores_scan(view: EvalView, pool_users: jax.Array,
                      pools: jax.Array, pair_block: int) -> jax.Array:
    """[P, C] predicted scores for P (user, candidate-pool) pairs,
    computed pair_block pairs at a time inside one dispatch."""
    P = pool_users.shape[0]
    n_blocks = P // pair_block

    def body(_, blk):
        s0 = blk * pair_block
        u = jax.lax.dynamic_slice_in_dim(pool_users, s0, pair_block)
        c = jax.lax.dynamic_slice_in_dim(pools, s0, pair_block)
        pu = view.u_fac[u]                        # [Pb, k]
        qi = view.i_fac[c]                        # [Pb, C, k]
        sc = jnp.einsum("pk,pck->pc", pu, qi,
                        preferred_element_type=jnp.float32)
        sc = (sc + view.mu + view.u_bias[u][:, None] + view.i_bias[c])
        return _, sc

    _, out = jax.lax.scan(body, None,
                          jnp.arange(n_blocks, dtype=jnp.int32))
    return out.reshape(P, pools.shape[1])


def score_pools(view: EvalView, pool_users: np.ndarray,
                pools: np.ndarray, pair_block: int = 256) -> np.ndarray:
    """Host wrapper: pad to a block multiple, run the one-dispatch scan,
    strip padding. pools: [P, C] item ids; returns [P, C] f32."""
    P = len(pool_users)
    pad = (-P) % pair_block
    if pad:
        pool_users = np.pad(pool_users, (0, pad))
        pools = np.pad(pools, ((0, pad), (0, 0)))
    out = np.asarray(_pool_scores_scan(
        view, jnp.asarray(pool_users.astype(np.int32)),
        jnp.asarray(pools.astype(np.int32)), pair_block))
    return out[:P]


def sample_unrated_pools(train_mat, valid_items: np.ndarray,
                         users: np.ndarray, test_items: np.ndarray,
                         n_negatives: int, rng) -> np.ndarray:
    """[P, 1 + n_negatives] candidate pools: column 0 = the test item,
    the rest uniform unrated valid negatives (the reference's sampling,
    longTail.cpp:279-366), vectorized rejection per pair against the
    sorted CSR row."""
    P = len(users)
    n_items = len(valid_items)
    pools = np.empty((P, 1 + n_negatives), np.int64)
    pools[:, 0] = test_items
    indptr, indices = train_mat.indptr, train_mat.indices
    for p in range(P):
        u, ti = int(users[p]), int(test_items[p])
        row = np.sort(indices[indptr[u]:indptr[u + 1]])
        chosen = np.empty(0, np.int64)
        stalls = 0
        while len(chosen) < n_negatives:
            need = n_negatives - len(chosen)
            cand = rng.integers(0, n_items, size=2 * need + 8)
            ok = valid_items[cand] & (cand != ti)
            if len(row):
                pos = np.searchsorted(row, cand)
                rated = (pos < len(row)) & (
                    row[np.minimum(pos, len(row) - 1)] == cand)
                ok &= ~rated
            cand = cand[ok]
            # the reference draws DISTINCT negatives (unordered_set
            # insert until 1000 members, longTail.cpp:373-408): dedupe
            # within the draw (keep first occurrence) and vs chosen
            _, first = np.unique(cand, return_index=True)
            cand = cand[np.sort(first)]
            cand = cand[~np.isin(cand, chosen)][:need]
            chosen = np.concatenate([chosen, cand])
            stalls = stalls + 1 if len(cand) == 0 else 0
            if stalls >= 4 and len(chosen) < n_negatives:
                # fewer distinct valid unrated items than requested
                # (tiny catalogs): exhaust the exact remainder, then
                # pad by cycling (the reference would loop forever
                # here; its datasets always have >1000 candidates)
                avail = np.setdiff1d(
                    np.nonzero(valid_items)[0],
                    np.concatenate([row, [ti], chosen]))
                rng.shuffle(avail)
                chosen = np.concatenate(
                    [chosen, avail[: n_negatives - len(chosen)]])
                if len(chosen) < n_negatives:
                    base = chosen if len(chosen) else np.asarray([ti])
                    chosen = np.concatenate(
                        [chosen,
                         np.resize(base, n_negatives - len(chosen))])
                break
        pools[p, 1:] = chosen
    return pools
