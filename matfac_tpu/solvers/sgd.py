"""Minibatched scatter-add SGD — the device SGD family.

Replaces the reference's sequential SGD (ModelMF::train,
modelMF.cpp:4-151), DSGD block-parallel SGD (trainSGDPar,
modelMF.cpp:154-350), user-shuffled SGD (trainUShuffle) and hogwild SGD
(hogTrain, modelMF.cpp:1656-1808) with ONE engine: per epoch the rating
stream is re-permuted on device, scanned in fixed-size minibatches, and
each batch applies

    e      = r_ui - <p_u * m, q_i * m>          (m = per-example rank mask)
    p_u   -= lr * m * (-2 w e q_i + 2 reg_u p_u)
    q_i   -= lr * m * (-2 w e p_u + 2 reg_i q_i)

via segment-sum scatter-add (`.at[].add`), which is the deterministic
analog of hogwild: within a batch colliding rows accumulate gradients
computed at the same stale value. Update rules match modelMF.cpp:83-105
exactly (per-occurrence regularization included); w is the IFWMF weight
hook (modelInvPopMF.cpp:163-178) and m the TMF/Poisson rank-mask hook
(modelDropoutSigmoid.cpp:158-191, modelPoissonDropout.cpp:189-226).

Parity with the sequential reference is statistical (final RMSE), not
bitwise — SURVEY.md §7 "SGD semantic gap".
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.data.batching import coo_batches
from matfac_tpu.models.base import MFState


class SGDSolver:
    """Owns the staged rating stream and the jitted epoch function."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 batch_size: Optional[int] = None,
                 reg_vec: Optional[np.ndarray] = None,
                 collision_norm: Optional[bool] = None,
                 reg_scale_u: Optional[np.ndarray] = None,
                 reg_scale_i: Optional[np.ndarray] = None):
        """``reg_vec``: optional per-dim regularization rates replacing
        the scalar u_reg/i_reg for BOTH sides — the singular-value-
        weighted scheme of trainSGDParSVD (modelMF.cpp:496-506, rate
        (sing_a+1)/(sing_b+sigma_k)).

        ``reg_scale_u``/``reg_scale_i``: optional per-ENTITY
        multipliers on the L2 rate ([n_users]/[n_items]) — the
        marginal-weighted regularization of the othersrc experiments
        (uReg * pow(uMarg, alpha-1), othersrc/modelMFWtReg.cpp:96,
        WtRegArb :86) and the iALS scaled-lambda family. Applied per
        occurrence like the scalar rates.

        ``collision_norm``: scale each example's gradient by 1/count of
        its entity within the minibatch, so a hot entity's net batch
        update is the MEAN of its colliding gradients instead of the
        sum. The sum overshoots: an entity occurring n times in a batch
        takes one stale n*lr step (unstable once n*lr*||q||^2 ~ 1 —
        observed divergence on power-law data), where the sequential
        reference takes n separate lr steps (modelMF.cpp:83-105).
        Default (None -> read Params.sgd_collision_norm) is on; with it
        the minibatched engine reaches the coordinate-solver basin
        (scripts/sgd_parity.py)."""
        self.model = model
        self.params = params
        if reg_vec is not None and model.use_bias:
            raise ValueError("per-dim reg_vec is factor-only")
        self.reg_vec = reg_vec
        self.reg_scale_u = (None if reg_scale_u is None
                            else jnp.asarray(reg_scale_u, jnp.float32))
        self.reg_scale_i = (None if reg_scale_i is None
                            else jnp.asarray(reg_scale_i, jnp.float32))
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None
                               else collision_norm)
        bs = batch_size or params.batch_size
        b = coo_batches(train_mat, bs, invalid_users, invalid_items)
        # One static host-side shuffle; per-epoch randomness is a random
        # cyclic offset + random batch order (tiny sort) instead of a
        # full device permutation — a 10M-element sort is pathologically
        # slow to compile and adds nothing statistically for SGD
        # (the reference itself full-shuffles only every 10th epoch,
        # modelMF.cpp:76-81).
        sperm = np.random.default_rng(params.seed).permutation(b.n_total)
        self.rows = jnp.asarray(b.rows[sperm])
        self.cols = jnp.asarray(b.cols[sperm])
        self.vals = jnp.asarray(b.vals[sperm])
        self.valid = jnp.asarray(b.valid[sperm])
        self.batch_size = b.batch_size
        self.n_batches = b.n_batches
        self.nnz = b.nnz
        if self.collision_norm:
            # Batch CONTENTS are static (fixed contiguous slices; only
            # the batch order is random), so the within-batch collision
            # counts are static too — precompute 1/count per element on
            # the host via the shared vectorized helper (one pass, not
            # ~2 numpy calls per batch; review r3). Elements whose
            # entity has no valid occurrence are themselves invalid
            # (their gradient is zeroed by w/vmask), so dividing by the
            # clamped count instead of forcing 0 is update-equivalent.
            from matfac_tpu.solvers.block_sgd import (
                stage_batch_collision_counts)
            rn, cn, vn = b.rows[sperm], b.cols[sperm], b.valid[sperm]
            wts = vn.astype(np.float32).reshape(1, -1)
            cnt_u = stage_batch_collision_counts(
                wts, rn.reshape(1, -1), b.batch_size,
                model.n_users).ravel()
            cnt_i = stage_batch_collision_counts(
                wts, cn.reshape(1, -1), b.batch_size,
                model.n_items).ravel()
            self.inv_nu = jnp.asarray(
                np.where(vn > 0, 1.0 / cnt_u, 0.0).astype(np.float32))
            self.inv_ni = jnp.asarray(
                np.where(vn > 0, 1.0 / cnt_i, 0.0).astype(np.float32))
        else:
            self.inv_nu = jnp.zeros((1,), jnp.float32)
            self.inv_ni = jnp.zeros((1,), jnp.float32)
        self._epoch = self._build_epoch()

    # ------------------------------------------------------------------
    def _build_epoch(self):
        model = self.model
        if self.reg_vec is not None:
            u_reg = jnp.asarray(self.reg_vec, jnp.float32)[None, :]
            i_reg = u_reg
        else:
            u_reg = float(self.params.u_reg)
            i_reg = float(self.params.i_reg)
        use_bias = model.use_bias
        use_factors = model.use_factors
        n_batches = self.n_batches
        B = self.batch_size
        collision_norm = self.collision_norm
        rs_u, rs_i = self.reg_scale_u, self.reg_scale_i

        n_total = self.rows.shape[0]

        # NOTE: the staged stream is passed as ARGUMENTS, not closed
        # over — closure-captured arrays are embedded in the HLO as
        # constants and a 10M-element constant makes (remote) XLA
        # compilation take minutes instead of seconds.
        @functools.partial(jax.jit, donate_argnums=(0,))
        def epoch(state: MFState, rows, cols, vals, valid, inv_nu_s,
                  inv_ni_s, lr, key) -> MFState:
            k_ord, mask_key = jax.random.split(key)
            border = jax.random.permutation(k_ord, n_batches)

            def step(carry, xs):
                st = carry
                b_idx, k_b = xs
                # contiguous slices of the statically-shuffled stream;
                # per-epoch randomness = random batch ORDER. (An
                # element-level rotation costs 4 scalar-gather passes
                # over the stream, more than the whole update.)
                start = b_idx * B
                sl = functools.partial(jax.lax.dynamic_slice_in_dim,
                                       start_index=start, slice_size=B)
                u = sl(rows)
                i = sl(cols)
                r = sl(vals)
                v = sl(valid)
                w = model.example_weight(u, i) * v
                m = model.update_rank_mask(k_b, u, i)
                side = model.update_side_masks(u, i)
                if collision_norm:
                    # host-precomputed static per-element 1/counts
                    inv_nu = sl(inv_nu_s)
                    inv_ni = sl(inv_ni_s)
                else:
                    inv_nu = inv_ni = None
                pu = st.u_fac[u]
                qi = st.i_fac[i]
                pred = jnp.zeros_like(r)
                if use_factors:
                    if m is None:
                        pred = jnp.einsum(
                            "ek,ek->e", pu, qi,
                            preferred_element_type=jnp.float32)
                    else:
                        pred = jnp.einsum(
                            "ek,ek->e", pu * m, qi,
                            preferred_element_type=jnp.float32)
                if use_bias:
                    pred = pred + st.u_bias[u] + st.i_bias[i]
                diff = (r - pred)
                # per-entity reg multipliers ride the same gathered
                # indices as the factor rows (othersrc WtReg semantics)
                ru = rs_u[u] * v if rs_u is not None else v
                ri = rs_i[i] * v if rs_i is not None else v
                new = st
                if use_factors:
                    gu = -2.0 * (w * diff)[:, None] * qi \
                        + 2.0 * u_reg * (ru[:, None] * pu)
                    gi = -2.0 * (w * diff)[:, None] * pu \
                        + 2.0 * i_reg * (ri[:, None] * qi)
                    if m is not None:
                        gu = gu * m
                        gi = gi * m
                    if side is not None:
                        # per-SIDE gates on the FULL gradient (data fit
                        # + reg), prediction untouched — othersrc
                        # modelMFLoc.cpp:124-159 / modelMFFreq.cpp:22-39
                        su, si_ = side
                        gu = gu * su
                        gi = gi * si_
                    if collision_norm:
                        gu = gu * inv_nu[:, None]
                        gi = gi * inv_ni[:, None]
                    new = new._replace(
                        u_fac=new.u_fac.at[u].add((-lr * gu).astype(st.u_fac.dtype)),
                        i_fac=new.i_fac.at[i].add((-lr * gi).astype(st.i_fac.dtype)))
                if use_bias:
                    gbu = -2.0 * w * diff + 2.0 * u_reg * ru * st.u_bias[u]
                    gbi = -2.0 * w * diff + 2.0 * i_reg * ri * st.i_bias[i]
                    if side is not None:
                        # entity-level gate (dim 0 is always the least
                        # truncated) rides onto the bias update too
                        gbu = gbu * side[0][:, 0]
                        gbi = gbi * side[1][:, 0]
                    if collision_norm:
                        gbu = gbu * inv_nu
                        gbi = gbi * inv_ni
                    new = new._replace(
                        u_bias=new.u_bias.at[u].add((-lr * gbu).astype(st.u_bias.dtype)),
                        i_bias=new.i_bias.at[i].add((-lr * gbi).astype(st.i_bias.dtype)))
                return new, None

            keys = jax.random.split(mask_key, n_batches)
            state, _ = jax.lax.scan(step, state, (border, keys))
            return state

        return epoch

    # ------------------------------------------------------------------
    def epoch(self, state: MFState, lr: float, key) -> MFState:
        return self._epoch(state, self.rows, self.cols, self.vals,
                           self.valid, self.inv_nu, self.inv_ni,
                           jnp.float32(lr), key)
