"""Incremental-rank MF.

JAX analog of ModelIncrement (/root/reference/modelIncrement.cpp):
every user/item starts at rank 1; estRating truncates the dot product at
min(rank_u, rank_i) (:10-18); every INC_ITER=5 epochs an entity whose
probe RMSE (on ``data.graph_mat`` used as a probe set) improved grows
its rank by +5 (clamped to fac_dim), otherwise its factors roll back to
the last snapshot and it stops growing (:251-316).

Because the rank tables mutate between epochs they are explicit traced
arguments of the jitted epoch (a closure would bake them as constants),
so this model ships with its own trainer instead of reusing SGDSolver.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.data.batching import coo_batches
from matfac_tpu.models.base import MFState, ModelMF, init_state, rank_mask

INC_ITER = 5      # modelIncrement.h / reference constant
INC_STEP = 5


class ModelIncrement(ModelMF):
    name = "increment"

    def __init__(self, params: Params, n_users: int, n_items: int, **_):
        super().__init__(params, n_users, n_items)
        self.rank_u = jnp.ones(n_users, jnp.int32)
        self.rank_i = jnp.ones(n_items, jnp.int32)

    def entity_ranks(self):
        return self.rank_u, self.rank_i


@dataclasses.dataclass
class IncrementReport:
    state: MFState
    rank_u: np.ndarray
    rank_i: np.ndarray
    history: List[Tuple[int, int, int]]   # (epoch, incremented_u, _i)


def _build_epoch(n_total, n_batches, B, u_reg, i_reg, k):
    # staged arrays are jit arguments, not closures (compile-time cost)
    @functools.partial(jax.jit, donate_argnums=(0,))
    def epoch(state: MFState, rows, cols, vals, valid, rank_u, rank_i,
              lr, key):
        border = jax.random.permutation(key, n_batches)

        def step(st, b_idx):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, b_idx * B, B)
            u, i = sl(rows), sl(cols)
            r, v = sl(vals), sl(valid)
            m = rank_mask(jnp.minimum(rank_u[u], rank_i[i]), k)
            pu, qi = st.u_fac[u], st.i_fac[i]
            pred = jnp.einsum("ek,ek->e", pu * m, qi,
                              preferred_element_type=jnp.float32)
            diff = r - pred
            gu = (-2.0 * (v * diff)[:, None] * qi
                  + 2.0 * u_reg * v[:, None] * pu) * m
            gi = (-2.0 * (v * diff)[:, None] * pu
                  + 2.0 * i_reg * v[:, None] * qi) * m
            return st._replace(u_fac=st.u_fac.at[u].add((-lr * gu).astype(st.u_fac.dtype)),
                               i_fac=st.i_fac.at[i].add((-lr * gi).astype(st.i_fac.dtype))), None

        state, _ = jax.lax.scan(step, state, border)
        return state

    return epoch


def _build_probe_rmse(n_users, n_items, k):
    @jax.jit
    def probe_rmse(state: MFState, rows, cols, vals, valid, rank_u,
                   rank_i):
        """Per-user and per-item RMSE on the probe set; -1 where the
        entity has no probe entries (RMSEUser/RMSEItem semantics)."""
        m = rank_mask(jnp.minimum(rank_u[rows], rank_i[cols]), k)
        pred = jnp.einsum("ek,ek->e", state.u_fac[rows] * m,
                          state.i_fac[cols],
                          preferred_element_type=jnp.float32)
        d2 = valid * (vals - pred) ** 2
        su = jax.ops.segment_sum(d2, rows, n_users)
        cu = jax.ops.segment_sum(valid, rows, n_users)
        si = jax.ops.segment_sum(d2, cols, n_items)
        ci = jax.ops.segment_sum(valid, cols, n_items)
        ru = jnp.where(cu > 0, jnp.sqrt(su / jnp.maximum(cu, 1)), -1.0)
        ri = jnp.where(ci > 0, jnp.sqrt(si / jnp.maximum(ci, 1)), -1.0)
        return ru, ri

    return probe_rmse


def train_increment(data, params: Params,
                    invalid_users: np.ndarray, invalid_items: np.ndarray,
                    max_iter: Optional[int] = None,
                    log_fn=print) -> Tuple[IncrementReport, ModelIncrement]:
    if data.graph_mat is None:
        raise ValueError("ModelIncrement needs a probe matrix in "
                         "data.graph_mat (reference uses graphMat as "
                         "the probe set)")
    k = params.fac_dim
    n_users, n_items = data.n_users, data.n_items
    model = ModelIncrement(params, n_users, n_items)

    b = coo_batches(data.train_mat, params.batch_size, invalid_users,
                    invalid_items)
    sperm = np.random.default_rng(params.seed).permutation(b.n_total)
    stage = [jnp.asarray(a[sperm]) for a in (b.rows, b.cols, b.vals,
                                             b.valid)]
    epoch_fn = _build_epoch(b.n_total, b.n_batches, b.batch_size,
                            float(params.u_reg), float(params.i_reg), k)
    epoch = lambda st, ru, ri, lr, key: epoch_fn(st, *stage, ru, ri,
                                                 lr, key)

    pr, pc, pv = data.graph_mat.to_coo()
    keep = (pr < n_users) & (pc < n_items)
    keep &= ~invalid_users[np.clip(pr, 0, n_users - 1)]
    keep &= ~invalid_items[np.clip(pc, 0, n_items - 1)]
    probe_stage = (jnp.asarray(pr[keep].astype(np.int32)),
                   jnp.asarray(pc[keep].astype(np.int32)),
                   jnp.asarray(pv[keep].astype(np.float32)),
                   jnp.ones(int(keep.sum()), jnp.float32))
    probe_fn = _build_probe_rmse(n_users, n_items, k)
    probe = lambda st, ru, ri: probe_fn(st, *probe_stage, ru, ri)

    state = init_state(params, n_users, n_items)
    rank_u = np.ones(n_users, np.int32)
    rank_i = np.ones(n_items, np.int32)
    prev_rank_u, prev_rank_i = rank_u.copy(), rank_i.copy()
    grow_u = ~invalid_users.copy()
    grow_i = ~invalid_items.copy()
    prev_rmse_u = np.full(n_users, 10.0)
    prev_rmse_i = np.full(n_items, 10.0)
    ru0, ri0 = probe(state, jnp.asarray(rank_u), jnp.asarray(rank_i))
    ru0, ri0 = np.asarray(ru0), np.asarray(ri0)
    prev_rmse_u[ru0 >= 0] = ru0[ru0 >= 0]
    prev_rmse_i[ri0 >= 0] = ri0[ri0 >= 0]
    u_prev = np.asarray(state.u_fac)
    i_prev = np.asarray(state.i_fac)

    key = jax.random.PRNGKey(params.seed)
    history = []
    n_epochs = max_iter or params.max_iter
    for it in range(n_epochs):
        key, ek = jax.random.split(key)
        state = epoch(state, jnp.asarray(rank_u), jnp.asarray(rank_i),
                      jnp.float32(params.learn_rate), ek)

        if it > 0 and it % INC_ITER == 0:
            ru, ri = probe(state, jnp.asarray(rank_u),
                           jnp.asarray(rank_i))
            ru, ri = np.asarray(ru), np.asarray(ri)
            u_fac = np.array(state.u_fac)   # writable host copies
            i_fac = np.array(state.i_fac)
            inc_u = inc_i = 0
            for (ranks, prev_ranks, grow, prev_rmse, cur, fac, fac_prev
                 ) in ((rank_u, prev_rank_u, grow_u, prev_rmse_u, ru,
                        u_fac, u_prev),
                       (rank_i, prev_rank_i, grow_i, prev_rmse_i, ri,
                        i_fac, i_prev)):
                active = grow.copy()
                no_probe = active & (cur < 0)
                grow[no_probe] = False
                improved = active & (cur >= 0) & (cur < prev_rmse) \
                    & (ranks < k)
                stalled = active & ~no_probe & ~improved
                prev_ranks[improved] = ranks[improved]
                prev_rmse[improved] = cur[improved]
                ranks[improved] += INC_STEP
                capped = improved & (ranks >= k)
                ranks[capped] = k
                grow[capped] = False
                ranks[stalled] = prev_ranks[stalled]
                fac[stalled] = fac_prev[stalled]
                grow[stalled] = False
                if fac is u_fac:
                    inc_u = int(improved.sum())
                else:
                    inc_i = int(improved.sum())
            state = state._replace(u_fac=jnp.asarray(u_fac),
                                   i_fac=jnp.asarray(i_fac))
            u_prev, i_prev = u_fac.copy(), i_fac.copy()
            history.append((it, inc_u, inc_i))
            if inc_u or inc_i:
                log_fn(f"iter {it}: incremented users {inc_u} "
                       f"items {inc_i}")
        if it == 0:
            u_prev = np.asarray(state.u_fac)
            i_prev = np.asarray(state.i_fac)

    model.rank_u = jnp.asarray(rank_u)
    model.rank_i = jnp.asarray(rank_i)
    return IncrementReport(state, rank_u, rank_i, history), model
