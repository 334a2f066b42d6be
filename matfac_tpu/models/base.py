"""Model state + the base model families (MF, MF-bias).

JAX analog of the reference ``Model`` hierarchy
(/root/reference/model.h:22-264). The reference couples model and solver
in one class; here a *model* is a pure description of

  * how a rating is predicted (factor dot, truncated dot, biases), and
  * how one observed example re-weights / rank-masks its SGD update,

while *solvers* (matfac_tpu.solvers) consume that description. All
per-entity quantities (frequencies, effective ranks, popularity weights)
are dense device tables so every model evaluates through one fused
matmul path.

Central trick (no reference analog — accelerator design): the WWW'19 adaptive
models truncate the dot product at a rank derived from the **less
frequent** of (user, item) through a monotone map R(freq). Monotonicity
gives R(min(fu, fi)) = min(R(fu), R(fi)), so the pair-rank truncation
factorizes into independent per-entity factor masks — truncated
full-catalog scoring stays a single dense [B,k]x[k,I] matmul
instead of a per-pair gather loop (reference does per-pair truncation in
scalar loops: adapDotProd, util.cpp:1067-1074).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params


class MFState(NamedTuple):
    """Trainable arrays. Mirrors Model's uFac/iFac/uBias/iBias/mu
    (model.h:37-41)."""
    u_fac: jax.Array    # [n_users, k]
    i_fac: jax.Array    # [n_items, k]
    u_bias: jax.Array   # [n_users]
    i_bias: jax.Array   # [n_items]
    mu: jax.Array       # scalar global bias


class EvalView(NamedTuple):
    """Pre-masked arrays such that every model's estRating is
    ``mu + u_bias[u] + i_bias[i] + <u_fac[u], i_fac[i]>`` — rank
    truncation and bias on/off are already folded in."""
    u_fac: jax.Array
    i_fac: jax.Array
    u_bias: jax.Array
    i_bias: jax.Array
    mu: jax.Array


def init_state(params: Params, n_users: int, n_items: int,
               seed: Optional[int] = None) -> MFState:
    """uniform(-0.01, 0.01) init for factors and biases
    (Model::Model, model.cpp:2331-2362)."""
    key = jax.random.PRNGKey(params.seed if seed is None else seed)
    k_uf, k_if, k_ub, k_ib = jax.random.split(key, 4)
    dt = jnp.dtype(params.dtype)
    k = params.fac_dim
    lb, ub = -0.01, 0.01
    return MFState(
        u_fac=jax.random.uniform(k_uf, (n_users, k), dt, lb, ub),
        i_fac=jax.random.uniform(k_if, (n_items, k), dt, lb, ub),
        u_bias=jax.random.uniform(k_ub, (n_users,), dt, lb, ub),
        i_bias=jax.random.uniform(k_ib, (n_items,), dt, lb, ub),
        mu=jnp.zeros((), dt),
    )


def rank_mask(ranks: jax.Array, k: int) -> jax.Array:
    """[n] int ranks → [n, k] {0,1} mask keeping dims j < rank."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
    return (iota < ranks[:, None]).astype(jnp.float32)


class ModelMF:
    """Plain MF: estRating = <p_u, q_i> (model.cpp:547-549); SGD update
    weight 1, full rank."""

    name = "mf"
    use_bias = False
    use_factors = True
    # True when update_rank_mask draws RANDOM ranks per update — such
    # models need an engine that samples in-kernel (scatter SGD / DSGD),
    # not one that stages static per-pair ranks (block engines)
    stochastic_rank = False

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: Optional[np.ndarray] = None,
                 item_freq: Optional[np.ndarray] = None):
        self.params = params
        self.n_users = n_users
        self.n_items = n_items
        self.k = params.fac_dim
        self.user_freq = user_freq
        self.item_freq = item_freq

    # ---- prediction -------------------------------------------------
    def entity_ranks(self):
        """(rank_u[n_users], rank_i[n_items]) inference truncation ranks,
        or None for full rank."""
        return None

    def eval_view(self, state: MFState) -> EvalView:
        zeros_u = jnp.zeros_like(state.u_bias)
        zeros_i = jnp.zeros_like(state.i_bias)
        u_fac, i_fac = state.u_fac, state.i_fac
        ranks = self.entity_ranks()
        if ranks is not None:
            r_u, r_i = ranks
            u_fac = u_fac * rank_mask(r_u, self.k).astype(u_fac.dtype)
            i_fac = i_fac * rank_mask(r_i, self.k).astype(i_fac.dtype)
        if not self.use_factors:
            u_fac = jnp.zeros_like(u_fac)
            i_fac = jnp.zeros_like(i_fac)
        if self.use_bias:
            return EvalView(u_fac, i_fac, state.u_bias, state.i_bias,
                            jnp.zeros_like(state.mu))
        return EvalView(u_fac, i_fac, zeros_u, zeros_i,
                        jnp.zeros_like(state.mu))

    # ---- SGD hooks ---------------------------------------------------
    def example_weight(self, u_idx: jax.Array, i_idx: jax.Array
                       ) -> jax.Array:
        """Per-example data-fit weight w_ui multiplying the squared error
        (1 for plain MF)."""
        return jnp.ones(u_idx.shape, jnp.float32)

    def update_rank_mask(self, key: jax.Array, u_idx: jax.Array,
                         i_idx: jax.Array) -> Optional[jax.Array]:
        """[B, k] {0,1} mask of dims updated/predicted for each example
        during training, or None for full rank."""
        return None

    def update_side_masks(self, u_idx: jax.Array, i_idx: jax.Array):
        """Optional per-SIDE update gates: (m_u, m_i), each [B, k] (or
        broadcastable [B, 1]) {0,1}, multiplying the FULL user-/item-side
        gradient (data fit + reg) without touching the prediction — the
        othersrc per-side semantics where one side's update is skipped
        or truncated while the other side trains at full rank
        (ModelMFFreq's entity gates, othersrc/modelMFFreq.cpp:22-39;
        ModelMFLoc's per-entity effFacDim, othersrc/modelMFLoc.cpp:124-159).
        None = both sides fully updated. Unlike ``update_rank_mask``,
        these masks do NOT enter the predicted rating."""
        return None

    def transform_init_state(self, state: MFState) -> MFState:
        """Hook applied once to the freshly-initialized state before
        training (identity by default). ModelMFLoc zeroes tail entities'
        upper factor dims here (zeroedTail*Facs,
        othersrc/modelMFLoc.cpp:4-31)."""
        return state


class ModelMFBias:
    """Bias-only model: estRating = b_u + b_i — factors and the global
    mean are excluded from prediction (modelMFBias.cpp:94-99, where mu
    and the dot product are commented out)."""

    name = "mf_bias"
    use_bias = True
    use_factors = False

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq=None, item_freq=None):
        self.params = params
        self.n_users = n_users
        self.n_items = n_items
        self.k = params.fac_dim

    entity_ranks = ModelMF.entity_ranks
    eval_view = ModelMF.eval_view
    example_weight = ModelMF.example_weight
    update_rank_mask = ModelMF.update_rank_mask
    update_side_masks = ModelMF.update_side_masks
    transform_init_state = ModelMF.transform_init_state
