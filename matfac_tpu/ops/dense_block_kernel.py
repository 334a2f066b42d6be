"""Dense-cell SGD epoch: per-cell masked-residual GD as dense matmuls.

The one-hot engine (ops/block_sgd_kernel.py) pays 4k(bu+bi) FLOP
per *rating* to turn gathers/scatters into matmuls, plus the one-hot
materialization traffic that is ~85% of its epoch at the bench shapes
(PERF.md "Diagonal schedule"). But at cell-sized batches — which the
auto batch sizing already picks at the bench shapes (n_steps=1) — the
minibatch one-hot update is EXACTLY a dense masked-residual GD step on
the cell:

    P  = U I^T                    [bu, bi]   (matmul)
    E  = W  *  (R - P)            elementwise; E[u,i] = coeff_{u,i}
    gu = -2 E I  + 2*u_reg*cnt_u[:,None]*U    (matmul + elementwise)
    gi = -2 E^T U + 2*i_reg*cnt_i[:,None]*I
    U -= lr * gu / max(cnt_u,1)   (collision normalization = the
    I -= lr * gi / max(cnt_i,1)    within-batch same-entity mean)

where R/W are the cell's ratings/weights as STATIC dense [bu, bi]
tiles and cnt = per-row/col valid counts (W > 0). Per dense slot this
is 6k matmul FLOP and ~3-6 B of HBM — versus the one-hot engine's
4k(bu+bi) FLOP and ~(bu+bi)*8 B per *stream slot*; dense wins FLOP
whenever cells hold more than ~0.75*b ratings, and always wins
traffic. The trade is HBM residency: the dense tiles materialize the
whole padded matrix (n_users_pad * n_items_pad * (2..6) bytes), so the
solver gates this engine on a byte budget and falls back to the
one-hot engine above it (solvers/block_sgd.py).

Update semantics = modelMF.cpp:83-105 per-occurrence-regularized SGD,
minibatched at batch = cell (README deviation #1), identical to
BlockSGDSolver(schedule="diag") with bs = S: the equivalence argument
is the separability of the one-hot aggregation —
oh_u^T diag(coeff) oh_i == E restricted to the cell's support, and
per-occurrence reg sums to cnt * lambda * row. Parity is pinned
against the one-hot engine in tests/test_dense_block.py.

Rank-masked models (TMF family) would need per-side mask matmuls for
the reg term; they stay on the one-hot/scatter engines (the solver
guards). Per-example weights (IFWMF) ride W.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule


def cell_dense_update(U, I, R, W, lr, u_reg, i_reg, collision_norm,
                      mm_dtype, Mu=None, Mi=None, r_scale=None):
    """One full-batch GD step on one (bu x bi) cell. U [bu,k], I [bi,k]
    f32; R [bu,bi] ratings (any float dtype); W [bu,bi] weights (float
    or int8 validity). Math mirrors block_sgd_kernel._batch_update at
    bs = cell size; see module docstring for the equivalence.

    ``W=None`` + ``r_scale``: int8 rating-CODE tiles — R holds integer
    codes with rating = code * r_scale and validity = (code != 0), so
    the whole cell costs 1 B/slot of HBM instead of 3-6 (the ML-20M
    single-chip enabler; star data is exactly representable, the
    solver's staging proves it per dataset). Only defined for
    uniform-0/1-weight models (the staging gates).

    ``Mu``/``Mi`` [bu,k]/[bi,k] 0/1: deterministic rank masks (TMF).
    The pair mask factorizes — dim d is active iff d < min(r_u, r_i)
    iff Mu[u,d]*Mi[i,d] (models/base.py monotone-map argument) — so
    masked prediction = (U o Mu) @ (I o Mi)^T, masked data grads ride
    the same matmuls, and the per-occurrence masked reg count is
    cnt[u,d] = (vm @ Mi)[u,d] * Mu[u,d] (one extra matmul per side;
    the scatter engine's `... * m` per pair, parallel/dsgd.py)."""
    if W is None:
        vm = (R != 0).astype(jnp.float32)
        Wf = vm
        Rf = R.astype(jnp.float32) * jnp.float32(r_scale)
    else:
        Wf = W.astype(jnp.float32)
        Rf = R.astype(jnp.float32)
        vm = (Wf > 0).astype(jnp.float32)
    Ue = U if Mu is None else U * Mu
    Ie = I if Mi is None else I * Mi
    P = jnp.dot(Ue.astype(mm_dtype), Ie.astype(mm_dtype).T,
                preferred_element_type=jnp.float32)
    E = Wf * (Rf - P)
    cnt_u = jnp.sum(vm, axis=1)
    cnt_i = jnp.sum(vm, axis=0)
    Em = E.astype(mm_dtype)
    gu_data = -2.0 * jnp.dot(Em, Ie.astype(mm_dtype),
                             preferred_element_type=jnp.float32)
    gi_data = -2.0 * jnp.dot(Em.T, Ue.astype(mm_dtype),
                             preferred_element_type=jnp.float32)
    if Mu is None:
        gu = gu_data + (2.0 * u_reg) * cnt_u[:, None] * U
        gi = gi_data + (2.0 * i_reg) * cnt_i[:, None] * I
    else:
        vmm = vm.astype(mm_dtype)
        cntm_u = jnp.dot(vmm, Mi.astype(mm_dtype),
                         preferred_element_type=jnp.float32) * Mu
        cntm_i = jnp.dot(vmm.T, Mu.astype(mm_dtype),
                         preferred_element_type=jnp.float32) * Mi
        gu = gu_data * Mu + (2.0 * u_reg) * cntm_u * U
        gi = gi_data * Mi + (2.0 * i_reg) * cntm_i * I
    if collision_norm:
        gu = gu / jnp.maximum(cnt_u, 1.0)[:, None]
        gi = gi / jnp.maximum(cnt_i, 1.0)[:, None]
    return U - lr * gu, I - lr * gi


def dense_sweep_diag(u_tab3: jax.Array, i_tab3: jax.Array,
                     ub_idx: jax.Array, lr,
                     R_cells: jax.Array, W_cells, NI: int,
                     u_reg: float, i_reg: float,
                     collision_norm: bool, mm_bf16: bool = True,
                     r_scale=None) -> Tuple[jax.Array, jax.Array]:
    """Diagonal-scheduled dense epoch (Gemulla DSGD rounds with
    identity item lanes, exactly block_sgd_kernel.block_sweep_diag's
    schedule — modelMF.cpp:154-350 / util.cpp:1077-1107 semantics).

    u_tab3 [NU+1, bu, k] (row NU = dummy), i_tab3 [NI, bi, k];
    ub_idx [R, G=NI] per-round user-block per lane (lane l owns item
    block l); R_cells/W_cells [n_cells+1, bu, bi] dense tiles in
    cell-major order (cell = ub*NI + ib; last row = all-invalid dummy
    addressed by padding lanes)."""
    Rr, G = ub_idx.shape
    n_cells_pad = R_cells.shape[0]
    mm_dtype = jnp.bfloat16 if mm_bf16 else jnp.float32
    lr_f = jnp.asarray(lr, jnp.float32)
    lanes = jnp.arange(G, dtype=jnp.int32)

    if W_cells is None:
        vstep = jax.vmap(
            lambda U, I, R: cell_dense_update(
                U, I, R, None, lr_f, u_reg, i_reg, collision_norm,
                mm_dtype, r_scale=r_scale))
    else:
        vstep = jax.vmap(
            lambda U, I, R, W: cell_dense_update(
                U, I, R, W, lr_f, u_reg, i_reg, collision_norm,
                mm_dtype))

    def round_body(t, tabs):
        u3, i3 = tabs
        ub = ub_idx[t]
        cell = jnp.minimum(ub * NI + lanes, n_cells_pad - 1)
        if W_cells is None:
            U, I = vstep(u3[ub], i3, R_cells[cell])
        else:
            U, I = vstep(u3[ub], i3, R_cells[cell], W_cells[cell])
        return (u3.at[ub].set(U), I)

    return jax.lax.fori_loop(0, Rr, round_body, (u_tab3, i_tab3))


@functools.partial(
    jax.jit, donate_argnums=(0, 1),
    static_argnames=("NI", "u_reg", "i_reg", "collision_norm",
                     "mm_bf16", "r_scale"))
def dense_epoch_diag_keyed(u_tab3: jax.Array, i_tab3: jax.Array,
                           key: jax.Array, lr,
                           R_cells: jax.Array, W_cells, NI: int,
                           u_reg: float, i_reg: float,
                           collision_norm: bool, mm_bf16: bool = True,
                           r_scale=None) -> Tuple[jax.Array, jax.Array]:
    """dense_sweep_diag with the round schedule generated ON-DEVICE
    from a PRNG key (same schedule generator as the one-hot diag
    engine, so the two engines visit identical cell sequences for the
    same key — pinned in tests)."""
    NU = u_tab3.shape[0] - 1
    ub_idx, _, _ = device_diag_schedule(key, NU, NI, 1)
    return dense_sweep_diag(u_tab3, i_tab3, ub_idx, lr, R_cells,
                            W_cells, NI, u_reg, i_reg, collision_norm,
                            mm_bf16, r_scale=r_scale)


def dense_sweep_rows(u_tab3: jax.Array, i_tab: jax.Array,
                     row_order: jax.Array, lr,
                     R_rows: jax.Array, W_rows,
                     u_reg: float, i_reg: float, collision_norm: bool,
                     mm_bf16: bool = True, Mu3=None, Mi=None,
                     r_scale=None, Lu3=None, Li=None, pois_cdf=None,
                     round_u=None) -> Tuple[jax.Array, jax.Array]:
    """Row-STRIPE dense epoch: each round takes one user stripe's full
    catalog row (bi = n_items_pad, i.e. the cell grid degenerates to
    NI = 1) in one masked-residual GD step. Identical math to
    dense_sweep_diag at G = 1; split out because the per-round stripe
    moves by SCALAR indexing (u3[ub], R_rows[ub] — lowered to
    dynamic-slice) instead of a vector gather of scattered cells, and
    its matmuls run at full catalog width ([bu, k] @ [k, ni_pad]).

    u_tab3 [NU+1, bu, k] (row NU = unused dummy, matching the diag
    staging), i_tab [ni_pad, k]; R_rows/W_rows [NU+1, bu, ni_pad];
    row_order [NU]. Schedule semantics: a random stripe order per epoch
    — the DSGD round structure of modelMF.cpp:154-350 with one item
    block (README deviation #1's batch-size hyperparameter at
    batch = stripe).

    ``Lu3`` [NU+1, bu] / ``Li`` [ni_pad] int32 lambda tables +
    ``pois_cdf`` [k, k] + ``round_u`` [NU] uniforms: per-round CRN
    Poisson rank RESAMPLING (TMF+Dropout). Each round computes the
    Poisson quantile at the round's uniform for every lambda value,
    q_t[lam] = clip(#{m : cdf[lam-1, m] < U_t}, 1, k), and masks with
    rank_e = q_t[lambda_e] — pair rank = q_t[min lambda] with the
    reference's exact per-update marginal
    (models/longtail.ModelPoissonDropout.poisson_cdf_table docstring;
    modelPoissonDropout.cpp:189-207; README deviation #15)."""
    NU = row_order.shape[0]
    mm_dtype = jnp.bfloat16 if mm_bf16 else jnp.float32
    lr_f = jnp.asarray(lr, jnp.float32)
    k_dim = i_tab.shape[-1]
    iota = jnp.arange(k_dim, dtype=jnp.int32)

    def body(t, tabs):
        u3, I = tabs
        ub = row_order[t]
        if pois_cdf is not None:
            qt = jnp.clip(jnp.sum((pois_cdf < round_u[t]).astype(
                jnp.int32), axis=1), 1, k_dim)          # [k]
            Mu_t = (iota[None, :]
                    < qt[Lu3[ub] - 1][:, None]).astype(jnp.float32)
            Mi_t = (iota[None, :]
                    < qt[Li - 1][:, None]).astype(jnp.float32)
        else:
            Mu_t = None if Mu3 is None else Mu3[ub]
            Mi_t = Mi
        U, I = cell_dense_update(u3[ub], I, R_rows[ub],
                                 None if W_rows is None else W_rows[ub],
                                 lr_f, u_reg, i_reg, collision_norm,
                                 mm_dtype, Mu=Mu_t, Mi=Mi_t,
                                 r_scale=r_scale)
        return (u3.at[ub].set(U), I)

    return jax.lax.fori_loop(0, NU, body, (u_tab3, i_tab))


@functools.partial(
    jax.jit, donate_argnums=(0, 1),
    static_argnames=("u_reg", "i_reg", "collision_norm", "mm_bf16",
                     "r_scale"))
def dense_epoch_rows_keyed(u_tab3: jax.Array, i_tab: jax.Array,
                           key: jax.Array, lr,
                           R_rows: jax.Array, W_rows,
                           u_reg: float, i_reg: float,
                           collision_norm: bool, mm_bf16: bool = True,
                           Mu3=None, Mi=None, r_scale=None,
                           Lu3=None, Li=None, pois_cdf=None
                           ) -> Tuple[jax.Array, jax.Array]:
    """dense_sweep_rows with the stripe order generated on-device from
    a PRNG key. Uses device_diag_schedule(G=1) so the visit order for a
    given key EQUALS the diag engines' (parity tests pin rows == diag
    at NI = 1). Mu3 [NU+1, bu, k] / Mi [ni_pad, k]: TMF rank masks.
    ``W_rows=None`` + ``r_scale``: int8 rating-code tiles (see
    cell_dense_update). ``Lu3``/``Li``/``pois_cdf``: per-round CRN
    Poisson resampling (dense_sweep_rows docstring); the per-round
    uniforms come from a second fold of the same key."""
    NU = u_tab3.shape[0] - 1
    round_u = None
    if pois_cdf is not None:
        key, ku = jax.random.split(key)
        round_u = jax.random.uniform(ku, (NU,), jnp.float32)
    ub_idx, _, _ = device_diag_schedule(key, NU, 1, 1)
    return dense_sweep_rows(u_tab3, i_tab, ub_idx[:, 0], lr, R_rows,
                            W_rows, u_reg, i_reg, collision_norm,
                            mm_bf16, Mu3=Mu3, Mi=Mi, r_scale=r_scale,
                            Lu3=Lu3, Li=Li, pois_cdf=pois_cdf,
                            round_u=round_u)


@functools.partial(jax.jit, static_argnames=("n", "dtype"))
def _scatter_flat(idx: jax.Array, vals: jax.Array, n: int, dtype):
    return jnp.zeros(n, dtype).at[idx].add(vals.astype(dtype))


@functools.partial(jax.jit, donate_argnums=(0,))
def _put_rows(buf: jax.Array, chunk: jax.Array, r0) -> jax.Array:
    return jax.lax.dynamic_update_slice(buf, chunk,
                                        (r0, jnp.int32(0)))


def densify_rows_host(cell: "np.ndarray", u_loc: "np.ndarray",
                      i_loc: "np.ndarray", vals: "np.ndarray",
                      n_cells_pad: int, bu: int, bi: int, dtype,
                      chunk_elems: int = 1 << 28) -> jax.Array:
    """Scatter a COO stream into the dense [cells, bu, bi] grid via
    CHUNKED flat 1-D scatters (host driver, device compute).

    Why not one 3-index scatter (.at[cell, ul, il].add): its
    [nnz, 3] s32 index matrix is a device-memory temp of its own, and
    some backends pad it to a tiled layout many times its size. A flat
    1-D index stream is the smallest index operand; chunking row
    ranges keeps every flat index inside int32 and bounds the
    per-chunk temp to ``chunk_elems`` slots. The output buffer is
    donated through each row-range update, so peak device memory =
    grid + one chunk."""
    import numpy as np

    rows = cell.astype(np.int64) * bu + u_loc.astype(np.int64)
    flat = rows * bi + i_loc.astype(np.int64)
    N2 = n_cells_pad * bu
    max_rows = max(min((2**31 - 1) // bi, chunk_elems // bi), 1)
    buf = jnp.zeros((N2, bi), dtype)
    order = np.argsort(rows, kind="stable")
    rows_s, flat_s, vals_s = rows[order], flat[order], vals[order]
    for r0 in range(0, N2, max_rows):
        r1 = min(r0 + max_rows, N2)
        lo = np.searchsorted(rows_s, r0, "left")
        hi = np.searchsorted(rows_s, r1, "left")
        if lo == hi:
            continue
        idx = (flat_s[lo:hi] - r0 * np.int64(bi)).astype(np.int32)
        chunk = _scatter_flat(jnp.asarray(idx),
                              jnp.asarray(vals_s[lo:hi]),
                              n=(r1 - r0) * bi,
                              dtype=dtype).reshape(r1 - r0, bi)
        buf = _put_rows(buf, chunk, jnp.int32(r0))
    return buf.reshape(n_cells_pad, bu, bi)
