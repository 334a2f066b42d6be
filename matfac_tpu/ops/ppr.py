"""PageRank / personalized PageRank via sparse power iteration.

JAX replacement for GKlib's ``gk_rw_PageRank`` (used throughout
the reference analysis layer: confCompute.cpp:18, topBucketComp.cpp:377,
othersrc/computePPR.cpp:24): random walk with restart on the item-item
graph,

    pr <- (1 - lamda) * restart + lamda * W_norm^T pr

with row-stochastic W, iterated to L1 tolerance ``eps`` or
``max_iter`` (reference call sites use eps=1e-4, max 10k / MAX_PR_ITER).
Restart vectors are batched so the per-user PPR sweeps of
topBucketComp run as one [n_nodes, B] matmul-shaped power iteration
instead of per-user walks.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.data.csr import RatingMatrix


class PPREngine:
    def __init__(self, graph: RatingMatrix):
        r, c, v = graph.to_coo()
        deg = np.zeros(graph.nrows, np.float64)
        np.add.at(deg, r, v.astype(np.float64))
        norm = np.where(deg[r] > 0, v / deg[r], 0.0)
        self.rows = jnp.asarray(r.astype(np.int32))
        self.cols = jnp.asarray(c.astype(np.int32))
        self.w = jnp.asarray(norm.astype(np.float32))
        self.n = graph.nrows
        self.dangling = jnp.asarray((deg == 0).astype(np.float32))

    @functools.partial(jax.jit,
                       static_argnames=("self", "max_iter"))
    def _iterate(self, restart, rows, cols, w, dangling, lamda, eps,
                 max_iter: int):
        n = self.n

        def step(pr):
            # out[j] = sum_i pr[i] w_ij  (walk along normalized edges)
            spread = jax.ops.segment_sum(w[:, None] * pr[rows], cols, n)
            # dangling mass restarts (standard PPR completion)
            lost = jnp.sum(pr * dangling[:, None], axis=0,
                           keepdims=True)
            return (1.0 - lamda) * restart + lamda * (
                spread + lost * restart)

        def cond(carry):
            pr, prev, it = carry
            diff = jnp.max(jnp.sum(jnp.abs(pr - prev), axis=0))
            return (diff > eps) & (it < max_iter)

        def body(carry):
            pr, _, it = carry
            return (step(pr), pr, it + 1)

        pr0 = restart
        pr, _, _ = jax.lax.while_loop(
            cond, body, (step(pr0), pr0, jnp.int32(1)))
        return pr

    def ppr(self, restart: jax.Array, lamda: float = 0.85,
            eps: float = 1e-4, max_iter: int = 10_000) -> jax.Array:
        """restart: [n] or [n, B] restart distribution(s) (will be
        normalized). Returns stationary PPR scores, same shape."""
        squeeze = restart.ndim == 1
        r = restart[:, None] if squeeze else restart
        r = r / jnp.maximum(jnp.sum(r, axis=0, keepdims=True), 1e-12)
        pr = self._iterate(r.astype(jnp.float32), self.rows, self.cols,
                           self.w, self.dangling, jnp.float32(lamda),
                           jnp.float32(eps), max_iter)
        return pr[:, 0] if squeeze else pr

    def global_pagerank(self, lamda: float = 0.85, eps: float = 1e-4,
                        max_iter: int = 10_000) -> jax.Array:
        """GPR: uniform restart (confCompute's gpr usage)."""
        return self.ppr(jnp.ones(self.n), lamda, eps, max_iter)

    def user_ppr(self, train_mat: RatingMatrix, users: np.ndarray,
                 lamda: float = 0.85, eps: float = 1e-4,
                 max_iter: int = 10_000) -> np.ndarray:
        """Per-user PPR with restart on the user's rated items weighted
        by rating (itemGraphItemScores, topBucketComp.cpp:348-400).
        Returns [len(users), n_items]."""
        B = len(users)
        restart = np.zeros((self.n, B), np.float32)
        for j, u in enumerate(users):
            cols, vals = train_mat.row(int(u))
            restart[cols, j] = vals
        out = self.ppr(jnp.asarray(restart), lamda, eps, max_iter)
        return np.asarray(out).T
