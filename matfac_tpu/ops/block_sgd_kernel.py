"""One-hot block SGD epochs (plain XLA).

Ratings are staged into (user-block x item-block) cells
(solvers/block_sgd.py), the single-device analog of the DSGD grid
(modelMF.cpp:154-350). Every minibatch of a cell does

    oh_u = onehot(u)  [b, bu]
    p    = oh_u @ U
    ...gradient math...
    U   += oh_u.T @ gu

so the per-rating gathers/scatters become dense matmuls against the
cell's factor blocks, at ~4k(bu+bi) FLOP per rating. Per-example
weights (IFWMF) and deterministic rank masks (TMF) ride the staged
stream; collision normalization (mean of same-entity gradients within
a batch) rides it too — batch CONTENTS are static (fixed slices; only
batch order is random), so the within-batch counts are precomputed on
the host (solvers/block_sgd.py).

Two schedules share ``_batch_update``: the row schedule
(``block_sweep_rows``: user-block rows in random order, item blocks
swept within a row) and the diagonal schedule (``block_sweep_diag``:
DSGD rounds of axis-disjoint cells batched into one vmapped group).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _batch_update(U, I, u, i, r, w, cn_u, cn_i, lam, lr, k, bu, bi,
                  u_reg, i_reg, collision_norm, use_mask, mm_dtype):
    """One minibatch of one-hot-matmul SGD on factor blocks U [bu,k],
    I [bi,k] — shared by both schedules and by parallel/block_dsgd.py,
    so every one-hot engine runs identical math. cn_u/cn_i [b] are the
    host-precomputed max(within-batch valid count of this element's
    entity, 1) divisors (None unless collision_norm)."""
    iota_u = jax.lax.broadcasted_iota(jnp.int32, (u.shape[0], bu), 1)
    iota_i = jax.lax.broadcasted_iota(jnp.int32, (i.shape[0], bi), 1)
    oh_u = (u[:, None] == iota_u).astype(mm_dtype)
    oh_i = (i[:, None] == iota_i).astype(mm_dtype)
    pu = jnp.dot(oh_u, U.astype(mm_dtype),
                 preferred_element_type=jnp.float32)
    qi = jnp.dot(oh_i, I.astype(mm_dtype),
                 preferred_element_type=jnp.float32)
    if use_mask:
        iota_k = jax.lax.broadcasted_iota(jnp.int32, (u.shape[0], k), 1)
        m = (iota_k < lam[:, None]).astype(jnp.float32)
        pred = jnp.sum(pu * m * qi, axis=1)
    else:
        m = None
        pred = jnp.sum(pu * qi, axis=1)
    coeff = w * (r - pred)
    vmask = (w > 0).astype(jnp.float32)
    gu = -2.0 * coeff[:, None] * qi + 2.0 * u_reg * vmask[:, None] * pu
    gi = -2.0 * coeff[:, None] * pu + 2.0 * i_reg * vmask[:, None] * qi
    if use_mask:
        gu = gu * m
        gi = gi * m
    if collision_norm:
        gu = gu / cn_u[:, None]
        gi = gi / cn_i[:, None]
    U = U + jnp.dot(oh_u.T, (-lr * gu).astype(mm_dtype),
                    preferred_element_type=jnp.float32).astype(U.dtype)
    I = I + jnp.dot(oh_i.T, (-lr * gi).astype(mm_dtype),
                    preferred_element_type=jnp.float32).astype(I.dtype)
    return U, I


def block_sweep_diag(u_tab3: jax.Array, i_tab3: jax.Array,
                     ub_idx: jax.Array, ib_idx: jax.Array,
                     boff: jax.Array, lr,
                     u_loc: jax.Array, i_loc: jax.Array,
                     vals: jax.Array, wts: jax.Array,
                     cnu: jax.Array, cni: jax.Array,
                     lam: jax.Array,
                     bs: int, bu: int, bi: int, NI: int,
                     u_reg: float, i_reg: float,
                     collision_norm: bool, use_mask: bool,
                     mm_bf16: bool = True,
                     ib_identity: bool = False
                     ) -> Tuple[jax.Array, jax.Array]:
    """Diagonal-batched one-hot SGD epoch (Gemulla DSGD schedule on
    one device — the single-device analog of parallel/dsgd.py, cf.
    modelMF.cpp:154-350 / util.cpp:1077-1107).

    Each of the R rounds processes G = NI cells that are disjoint in
    BOTH axes (user block j paired with item block (j+d) % NI), so the
    G cell updates are exactly independent and run as ONE batched
    one-hot matmul group [G, bs, b*] @ [G, b*, k]. Versus the
    row-sequential engine this shortens the sequential chain by G× and
    keeps the matmuls wide at small block sizes, where per-rating FLOP
    (∝ 4k(bu+bi)) is proportionally lower.

    u_tab3 [NU+1, bu, k] / i_tab3 [NI, bi, k]: factor blocks; row NU of
    u_tab3 is a dummy block addressed by padding lanes (their stream
    row is all-invalid so the write-back is a no-op value).
    ub_idx/ib_idx/boff [R, G]: per-round user-block / item-block /
    batch-offset per lane. Streams [n_cells+1, S]; the last row is the
    all-invalid dummy cell.
    """
    R, G = ub_idx.shape
    n_cells_pad, S = u_loc.shape
    n_steps = S // bs
    k = u_tab3.shape[2]
    NU = u_tab3.shape[0] - 1
    mm_dtype = jnp.bfloat16 if mm_bf16 else jnp.float32
    lr_f = jnp.asarray(lr, jnp.float32)

    def one(U, I, su, si, sv, sw, scu, sci, slm):
        return _batch_update(
            U, I, su, si, sv, sw,
            scu if collision_norm else None,
            sci if collision_norm else None,
            slm if use_mask else None,
            lr_f, k, bu, bi, u_reg, i_reg, collision_norm, use_mask,
            mm_dtype)

    vstep = jax.vmap(one)

    def slice_one(row, start):
        return jax.lax.dynamic_slice(row, (start,), (bs,))

    vslice = jax.vmap(slice_one)

    lanes_c = jnp.arange(G, dtype=jnp.int32)

    def round_body(t, tabs):
        u3, i3 = tabs
        ub = ub_idx[t]
        bo = boff[t]
        U = u3[ub]
        if ib_identity:
            # item lane l owns item block l for the whole epoch (the
            # diagonal rotation is carried by the ROTATED ub_idx — a
            # pure lane relabeling, device_diag_schedule): the i-table
            # never moves through gather/scatter, halving the
            # per-round table traffic
            ib = lanes_c
            I = i3
        else:
            ib = ib_idx[t]
            I = i3[ib]
        # dummy lanes (ub == NU) address the all-invalid dummy cell
        cell = jnp.minimum(ub * NI + ib, n_cells_pad - 1)
        rows = [x[cell] for x in (u_loc, i_loc, vals, wts, cnu, cni,
                                  lam)]

        def step(s, UI):
            U, I = UI
            starts = ((s + bo) % n_steps) * bs
            sliced = [vslice(x, starts) for x in rows]
            return vstep(U, I, *sliced)

        U, I = jax.lax.fori_loop(0, n_steps, step, (U, I))
        u3 = u3.at[ub].set(U)
        i3 = I if ib_identity else i3.at[ib].set(I)
        return (u3, i3)

    return jax.lax.fori_loop(0, R, round_body, (u_tab3, i_tab3))


def device_diag_schedule(key: jax.Array, NU: int, G: int, n_steps: int
                         ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """On-device diag schedule (DSGD rounds, util.cpp:1077-1107
    semantics with rotation instead of a random Latin square — README
    deviation #3): random groups of G user blocks (pad lanes -> dummy NU),
    randomly-ordered rotated diagonals per group, random batch
    offsets. Generating this on the device saves three per-epoch
    host->device schedule transfers."""
    k1, k2, k3 = jax.random.split(key, 3)
    n_groups = -(-NU // G)
    total = n_groups * G
    ub_all = jnp.concatenate(
        [jnp.arange(NU, dtype=jnp.int32),
         jnp.full((total - NU,), NU, jnp.int32)])
    ub_all = jax.random.permutation(k1, ub_all).reshape(n_groups, G)
    dperm = jax.vmap(lambda kk: jax.random.permutation(kk, G))(
        jax.random.split(k2, n_groups)).astype(jnp.int32)
    lanes = jnp.arange(G, dtype=jnp.int32)
    # The rotation is applied to the USER side: lane l keeps item
    # block l for the whole epoch and round d pairs it with user block
    # ub_all[g, (l - d) % G] — a pure lane relabeling of the classic
    # (u_l, i_(l+d)%G) diagonal (same cell set per round; lanes are
    # independent), which lets block_sweep_diag(ib_identity=True) skip
    # the per-round i-table gather/scatter entirely.
    ub_rep = jnp.repeat(ub_all, G, axis=0)              # [R, G]
    src = (lanes[None, :] - dperm.reshape(-1, 1)) % G   # [R, G]
    ub_idx = jnp.take_along_axis(ub_rep, src, axis=1)
    ib_idx = jnp.broadcast_to(lanes, ub_idx.shape)      # identity lanes
    boff = jax.random.randint(k3, (n_groups * G, G), 0,
                              max(n_steps, 1)).astype(jnp.int32)
    return ub_idx, ib_idx, boff


@functools.partial(
    jax.jit, donate_argnums=(0, 1),
    static_argnames=("bs", "bu", "bi", "NI", "u_reg", "i_reg",
                     "collision_norm", "use_mask", "mm_bf16"))
def block_sgd_epoch_diag_keyed(u_tab3: jax.Array, i_tab3: jax.Array,
                               key: jax.Array, lr,
                               u_loc: jax.Array, i_loc: jax.Array,
                               vals: jax.Array, wts: jax.Array,
                               cnu: jax.Array, cni: jax.Array,
                               lam: jax.Array,
                               bs: int, bu: int, bi: int, NI: int,
                               u_reg: float, i_reg: float,
                               collision_norm: bool, use_mask: bool,
                               mm_bf16: bool = True
                               ) -> Tuple[jax.Array, jax.Array]:
    """block_sgd_epoch_diag with the schedule generated ON-DEVICE from
    a PRNG key (no per-epoch schedule h2d transfers)."""
    NU = u_tab3.shape[0] - 1
    S = u_loc.shape[1]
    ub_idx, ib_idx, boff = device_diag_schedule(key, NU, NI, S // bs)
    return block_sweep_diag(
        u_tab3, i_tab3, ub_idx, ib_idx, boff, lr, u_loc, i_loc, vals,
        wts, cnu, cni, lam, bs, bu, bi, NI, u_reg, i_reg,
        collision_norm, use_mask, mm_bf16, ib_identity=True)


def block_sweep_rows(u_tab: jax.Array, i_tab: jax.Array,
                     row_of: jax.Array, ib_seq: jax.Array,
                     boff: jax.Array, lr,
                     u_loc: jax.Array, i_loc: jax.Array,
                     vals: jax.Array, wts: jax.Array,
                     cnu: jax.Array, cni: jax.Array, lam: jax.Array,
                     bs: int, bu: int, bi: int, NI: int,
                     u_reg: float, i_reg: float,
                     collision_norm: bool, use_mask: bool,
                     mm_bf16: bool = True
                     ) -> Tuple[jax.Array, jax.Array]:
    """Row-schedule one-hot sweep over u_tab [NU*bu, k] /
    i_tab [NI*bi, k] with streams [NU, NI*S] — the traceable core
    shared by the jitted single-device epoch (block_sgd_epoch_xla) and
    the per-shard-round sweep of parallel/block_dsgd.py."""
    NU, row_len = u_loc.shape
    S = row_len // NI
    n_steps = S // bs
    k = u_tab.shape[1]
    mm_dtype = jnp.bfloat16 if mm_bf16 else jnp.float32
    lr_f = jnp.asarray(lr, jnp.float32)

    def row_body(t, tabs):
        u_tab, i_tab = tabs
        ro = row_of[t]
        U = jax.lax.dynamic_slice(u_tab, (ro * bu, 0), (bu, k))
        row = [jax.lax.dynamic_slice(x, (ro, 0), (1, row_len))[0]
               for x in (u_loc, i_loc, vals, wts, cnu, cni, lam)]
        su_, si_, sv_, sw_, scu_, sci_, sl_ = row

        def cell_body(j, carry):
            U, i_tab = carry
            ib = ib_seq[t, j]
            bo = boff[t, j]
            I = jax.lax.dynamic_slice(i_tab, (ib * bi, 0), (bi, k))
            base = ib * S

            def step(s, UI):
                U, I = UI
                start = base + ((s + bo) % n_steps) * bs

                def sl(x):
                    return jax.lax.dynamic_slice(x, (start,), (bs,))

                lam_b = sl(sl_) if use_mask else None
                cnu_b = sl(scu_) if collision_norm else None
                cni_b = sl(sci_) if collision_norm else None
                return _batch_update(
                    U, I, sl(su_), sl(si_), sl(sv_), sl(sw_), cnu_b,
                    cni_b, lam_b, lr_f, k, bu, bi, u_reg, i_reg,
                    collision_norm, use_mask, mm_dtype)

            U, I = jax.lax.fori_loop(0, n_steps, step, (U, I))
            i_tab = jax.lax.dynamic_update_slice(i_tab, I, (ib * bi, 0))
            return (U, i_tab)

        U, i_tab = jax.lax.fori_loop(0, NI, cell_body, (U, i_tab))
        u_tab = jax.lax.dynamic_update_slice(u_tab, U, (ro * bu, 0))
        return (u_tab, i_tab)

    return jax.lax.fori_loop(0, NU, row_body, (u_tab, i_tab))


@functools.partial(
    jax.jit, donate_argnums=(0, 1),
    static_argnames=("bs", "bu", "bi", "NI", "u_reg", "i_reg",
                     "collision_norm", "use_mask", "mm_bf16"))
def block_sgd_epoch_xla(u_tab: jax.Array, i_tab: jax.Array,
                        row_of: jax.Array, ib_seq: jax.Array,
                        boff: jax.Array, lr,
                        u_loc: jax.Array, i_loc: jax.Array,
                        vals: jax.Array, wts: jax.Array,
                        cnu: jax.Array, cni: jax.Array, lam: jax.Array,
                        bs: int, bu: int, bi: int, NI: int,
                        u_reg: float, i_reg: float,
                        collision_norm: bool, use_mask: bool,
                        mm_bf16: bool = True
                        ) -> Tuple[jax.Array, jax.Array]:
    """Jitted row-schedule one-hot epoch (block_sweep_rows). Stream
    arrays [NU, NI*S] hold each user-block row's cells contiguously in
    ib-ascending order; row_of [NU] = random row order; ib_seq/boff
    [NU, NI] = per-row random cell order and batch offsets. Factor
    blocks move by dynamic_slice/update, one device-memory round trip
    per cell (~bi*k*8 B, small against the matmul work)."""
    return block_sweep_rows(
        u_tab, i_tab, row_of, ib_seq, boff, lr, u_loc, i_loc, vals,
        wts, cnu, cni, lam, bs, bu, bi, NI, u_reg, i_reg,
        collision_norm, use_mask, mm_bf16)
