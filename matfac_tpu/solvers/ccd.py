"""CCD++ and per-entity CCD — coordinate descent via segment-sums.

JAX analog of ModelMF::trainCCDPP (modelMF.cpp:931-1169),
trainCCDPPFreqAdap (modelMF.cpp:1172-1423) and trainCCD
(modelMF.cpp:1426-1653). The reference maintains a duplicated CSR
residual in row AND column views (with benign cross-view races); here
the residual is a single COO value vector and both the user- and
item-side closed-form 1-D updates are `segment_sum` reductions over it:

    u_k(u) = sum_i res_ui v_k(i) / (uReg + sum_i v_k(i)^2)

CCD++ (Yu et al. rank-1 sweeps): per latent dim, add back the dim's
contribution to the residual, run 5 inner user/item alternations, then
subtract the new contribution — the epoch is a lax.scan over shuffled
dims. The freq-adaptive variant zeroes v_k (k>0) for items with
frequency below a threshold (hard rank truncation, modelMF.cpp:1336-1343).

Per-entity CCD: one user sweep over all dims (add-back folded into the
numerator), then one item sweep — same math, Gauss-Seidel ordering.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.models.base import MFState


def _cdiv_i(a, b):
    return -(-a // b)


# ----------------------------------------------------------------------
# sorted-segment reduction (the "sorted" CCD++ engine's core trick)
# ----------------------------------------------------------------------

def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (|e| <= eps|s|)."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def _sorted_segment_sum2(x2, bounds, block):
    """Segmented sum of ``x2`` [n_pad, W] over CONTIGUOUS segments
    (``bounds`` [n_seg+1] = start positions; padding rows must be 0)
    with NO per-element index stream — the scatter-free replacement for
    `segment_sum` when the stream is sorted by segment id.

    Two-level for f32 safety: within-block inclusive cumsum (magnitude
    bounded by the block sum), compensated double-f32 associative scan
    over block totals (accelerators have no fast f64), assembled per segment with
    an exact TwoSum difference — absolute error stays O(block_sum*eps),
    independent of nnz.  Cost: one contiguous cumsum pass + O(n_seg)
    boundary gathers, vs segment_sum's nnz-element scatter stream."""
    n, W = x2.shape
    nb = n // block
    within = jnp.cumsum(x2.reshape(nb, block, W), axis=1)
    btot = within[:, -1, :]                       # [nb, W]
    h, l = jax.lax.associative_scan(
        lambda a, b: (lambda s_e: (s_e[0], s_e[1] + a[1] + b[1]))(
            _two_sum(a[0], b[0])),
        (btot, jnp.zeros_like(btot)), axis=0)
    # exclusive block prefixes
    z2 = jnp.zeros((1, W), btot.dtype)
    h = jnp.concatenate([z2, h[:-1]], axis=0)
    l = jnp.concatenate([z2, l[:-1]], axis=0)

    def prefix(pos):
        """(block-prefix hi, lo, within-block inclusive) at pos; -1 -> 0."""
        safe = jnp.maximum(pos, 0)
        b, o = safe // block, safe % block
        valid = (pos >= 0)[:, None].astype(btot.dtype)
        return h[b] * valid, l[b] * valid, within[b, o] * valid

    he, le, we = prefix(bounds[1:] - 1)
    hs, ls, ws = prefix(bounds[:-1] - 1)
    d, e = _two_sum(he, -hs)          # exact hi-part difference
    return d + (e + (le - ls) + (we - ws))


def _make_sweep_core(n_users, n_items, u_reg, i_reg, n_inner,
                     item_dim_ok, nc, chunk):
    """Build dim_sweep(u_fac, i_fac, res, stream, kk) -> (u, i, res)
    for the SCATTER engine (stream = (rows, cols)).

    nc == 0: monolithic segment ops over the full nnz stream.
    nc > 0: rows/cols/res are padded to nc*chunk (pad rows/cols point at
    the sentinel entity n_users/n_items) and every nnz-sized gather /
    scatter runs as nc chunked passes with fori_loop accumulation, so
    no single indexed op spans more than ``chunk`` elements. The
    chunking was added for an accelerator whose backend faulted on
    single indexed ops beyond ~4M elements; whether a GPU needs it is
    open (ROADMAP speed item 4).
    """

    def plain(u_fac, i_fac, res, rows, cols, kk):
        def seg_u(x):
            return jax.ops.segment_sum(x, rows, n_users)

        def seg_i(x):
            return jax.ops.segment_sum(x, cols, n_items)

        u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
        v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)
        # add back this dim's contribution (no-op on first epoch where
        # u_fac == 0, matching the iter>0 gate at modelMF.cpp:1036)
        res = res + u_k[rows] * v_k[cols]

        def inner(_, uv):
            u_k, v_k = uv
            vg = v_k[cols]
            # one stacked segment pass per side (halves the indexed
            # ops, which bound this loop)
            su = seg_u(jnp.stack([res * vg, vg * vg], axis=1))
            u_k = su[:, 0] / (u_reg + su[:, 1])
            ug = u_k[rows]
            si = seg_i(jnp.stack([res * ug, ug * ug], axis=1))
            v_k = si[:, 0] / (i_reg + si[:, 1])
            return (u_k, v_k)

        u_k, v_k = jax.lax.fori_loop(0, n_inner, inner, (u_k, v_k))
        if item_dim_ok is not None:
            # dims > 0 are truncated for infrequent items
            v_k = jnp.where(kk == 0, v_k, v_k * item_dim_ok)
        res = res - u_k[rows] * v_k[cols]
        return _set_col(u_fac, kk, u_k), _set_col(i_fac, kk, v_k), res

    def _pad1(x):
        return jnp.concatenate([x, jnp.zeros((1,), x.dtype)])

    def _sl(x, off):
        return jax.lax.dynamic_slice(x, (off,), (chunk,))

    def chunked(u_fac, i_fac, res, rows, cols, kk):
        u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
        v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)

        def res_delta(res, u_k, v_k, sign):
            u_p, v_p = _pad1(u_k), _pad1(v_k)

            def body(c, res):
                off = c * chunk
                r_c, c_c = _sl(rows, off), _sl(cols, off)
                res_c = _sl(res, off) + sign * u_p[r_c] * v_p[c_c]
                return jax.lax.dynamic_update_slice(res, res_c, (off,))

            return jax.lax.fori_loop(0, nc, body, res)

        res = res_delta(res, u_k, v_k, 1.0)

        def inner(_, uv):
            u_k, v_k = uv
            v_p = _pad1(v_k)

            def acc_u(c, su):
                off = c * chunk
                vg = v_p[_sl(cols, off)]
                return su + jax.ops.segment_sum(
                    jnp.stack([_sl(res, off) * vg, vg * vg], axis=1),
                    _sl(rows, off), n_users + 1)

            su = jax.lax.fori_loop(
                0, nc, acc_u, jnp.zeros((n_users + 1, 2), res.dtype))
            u_k = su[:n_users, 0] / (u_reg + su[:n_users, 1])
            u_p = _pad1(u_k)

            def acc_i(c, si):
                off = c * chunk
                ug = u_p[_sl(rows, off)]
                return si + jax.ops.segment_sum(
                    jnp.stack([_sl(res, off) * ug, ug * ug], axis=1),
                    _sl(cols, off), n_items + 1)

            si = jax.lax.fori_loop(
                0, nc, acc_i, jnp.zeros((n_items + 1, 2), res.dtype))
            v_k = si[:n_items, 0] / (i_reg + si[:n_items, 1])
            return (u_k, v_k)

        u_k, v_k = jax.lax.fori_loop(0, n_inner, inner, (u_k, v_k))
        if item_dim_ok is not None:
            v_k = jnp.where(kk == 0, v_k, v_k * item_dim_ok)
        res = res_delta(res, u_k, v_k, -1.0)
        return _set_col(u_fac, kk, u_k), _set_col(i_fac, kk, v_k), res

    inner_core = plain if nc == 0 else chunked

    def core(u_fac, i_fac, res, stream, kk):
        return inner_core(u_fac, i_fac, res, stream[0], stream[1], kk)

    return core


def _make_sweep_core_sorted(n_users, n_items, u_reg, i_reg, n_inner,
                            item_dim_ok, nc, chunk, seg_block):
    """The SORTED engine's dim sweep: stream = (rows, cols, col_order,
    rows_cs, row_bounds, col_bounds), rows ASCENDING, col_order the
    static permutation to the column-sorted view.

    Index-stream accounting vs the scatter engine (per-element index
    streams bound both engines; the scatter engine issues ~24
    streams/dim):
      * both sides' segment reductions become _sorted_segment_sum2
        (contiguous cumsums, 0 per-element streams) — the inner
        residual is CONSTANT through the 5 alternations (modelMF.cpp's
        res is only touched by the add-back/subtract passes), so ONE
        permute into the col-sorted view per dim serves all 5 item
        sides;
      * remaining streams/dim: add-back 2, permute 1, 5x(vg gather 1)
        + 5x(ug gather 1), subtract 2 = 15.
    Math is the reference's exact closed form; only fp summation order
    differs from the scatter engine (tests pin ~1e-3 agreement).
    """

    def _pad1(x):
        return jnp.concatenate([x, jnp.zeros((1,), x.dtype)])

    def _sl(x, off):
        return jax.lax.dynamic_slice(x, (off,), (chunk,))

    def core(u_fac, i_fac, res, stream, kk):
        rows, cols, col_order, rows_cs, row_bounds, col_bounds = stream
        n_pad = res.shape[0]
        u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
        v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)
        u_p, v_p = _pad1(u_k), _pad1(v_k)

        # dim-removed residual, in both sorted views (pad entries stay
        # exactly 0: sentinel gathers hit the _pad1 zero row)
        if nc == 0:
            resn = res + u_p[rows] * v_p[cols]
            resn_cs = resn[col_order]
        else:
            def bld(c, buf):
                off = c * chunk
                val = (_sl(res, off)
                       + u_p[_sl(rows, off)] * v_p[_sl(cols, off)])
                return jax.lax.dynamic_update_slice(buf, val, (off,))

            resn = jax.lax.fori_loop(0, nc, bld, jnp.zeros_like(res))

            def prm(c, buf):
                off = c * chunk
                val = resn[_sl(col_order, off)]
                return jax.lax.dynamic_update_slice(buf, val, (off,))

            resn_cs = jax.lax.fori_loop(0, nc, prm,
                                        jnp.zeros_like(res))

        def x2(resv, idx, tab_p):
            """[resv*g, g*g] where g = tab_p[idx] — the stacked
            numerator/denominator integrand of the closed-form 1-D
            update (modelMF.cpp:1061-1090)."""
            if nc == 0:
                g = tab_p[idx]
                return jnp.stack([resv * g, g * g], axis=1)

            def b(c, buf):
                off = c * chunk
                g = tab_p[_sl(idx, off)]
                x = jnp.stack([_sl(resv, off) * g, g * g], axis=1)
                return jax.lax.dynamic_update_slice(buf, x, (off, 0))

            return jax.lax.fori_loop(
                0, nc, b, jnp.zeros((n_pad, 2), res.dtype))

        def inner(_, uv):
            u_k, v_k = uv
            su = _sorted_segment_sum2(x2(resn, cols, _pad1(v_k)),
                                      row_bounds, seg_block)
            u_k = su[:, 0] / (u_reg + su[:, 1])
            si = _sorted_segment_sum2(x2(resn_cs, rows_cs, _pad1(u_k)),
                                      col_bounds, seg_block)
            v_k = si[:, 0] / (i_reg + si[:, 1])
            return (u_k, v_k)

        u_k, v_k = jax.lax.fori_loop(0, n_inner, inner, (u_k, v_k))
        if item_dim_ok is not None:
            v_k = jnp.where(kk == 0, v_k, v_k * item_dim_ok)
        u_p, v_p = _pad1(u_k), _pad1(v_k)
        if nc == 0:
            res = resn - u_p[rows] * v_p[cols]
        else:
            def sub(c, buf):
                off = c * chunk
                val = (_sl(resn, off)
                       - u_p[_sl(rows, off)] * v_p[_sl(cols, off)])
                return jax.lax.dynamic_update_slice(buf, val, (off,))

            res = jax.lax.fori_loop(0, nc, sub, resn)
        return _set_col(u_fac, kk, u_k), _set_col(i_fac, kk, v_k), res

    return core


def _chol_solve_unrolled(G, b):
    """Solve [n, g, g] SPD systems with a trace-time-unrolled
    Cholesky-Crout + triangular solves — every step is an elementwise
    op over [n] vectors, avoiding a batched Cholesky kernel launch per
    solve, which would dominate grouped-CCD's millions of tiny
    solves."""
    g = b.shape[1]
    L = [[None] * g for _ in range(g)]
    for j in range(g):
        s = G[:, j, j] - sum((L[j][p] ** 2 for p in range(j)),
                             jnp.zeros(()))
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        for i2 in range(j + 1, g):
            s2 = G[:, i2, j] - sum((L[i2][p] * L[j][p]
                                    for p in range(j)), jnp.zeros(()))
            L[i2][j] = s2 / L[j][j]
    y = [None] * g
    for i2 in range(g):
        y[i2] = (b[:, i2] - sum((L[i2][p] * y[p] for p in range(i2)),
                                jnp.zeros(()))) / L[i2][i2]
    x = [None] * g
    for i2 in reversed(range(g)):
        x[i2] = (y[i2] - sum((L[p][i2] * x[p]
                              for p in range(i2 + 1, g)),
                             jnp.zeros(()))) / L[i2][i2]
    return jnp.stack(x, axis=1)


def _make_sweep_core_sorted_grouped(n_users, n_items, u_reg, i_reg,
                                    n_inner, item_dim_ok, nc, chunk,
                                    seg_block, g):
    """Grouped (rank-g block) CCD++ sweep over the sorted views: one
    group sweep processes g dims together —
    add-back/permute/subtract and the per-alternation vg/ug gathers
    issue ONCE per GROUP (a g-wide row gather costs about what a scalar
    one does — index streams are counted per element), so the
    per-dim stream count drops from 15 to 15/g. The inner alternations
    solve per-entity g x g normal equations (joint block-coordinate
    update — at least as strong per sweep as g sequential 1-D updates;
    README deviation #14) via sorted segment sums of the packed
    [g(g+1)/2 + g]-wide Gram/b integrand and the unrolled Cholesky
    above. Math reduces exactly to the rank-1 sorted engine at g=1.
    """
    iu_g, il_g = np.triu_indices(g)
    P = len(iu_g)
    pos = np.zeros((g, g), np.int32)
    pos[iu_g, il_g] = np.arange(P, dtype=np.int32)
    pos[il_g, iu_g] = pos[iu_g, il_g]
    unpack = jnp.asarray(pos.reshape(-1))
    eye_flat = jnp.asarray(np.eye(g, dtype=np.float32).reshape(-1))

    def _padr(x):
        """append a zero ROW (sentinel gathers)."""
        return jnp.concatenate(
            [x, jnp.zeros((1, x.shape[1]), x.dtype)], axis=0)

    def _sl(x, off):
        return jax.lax.dynamic_slice(x, (off,), (chunk,))

    def _solve(su, reg, mask=None):
        """su [n_seg, P + g] -> [n_seg, g] solutions of
        (Gram + reg I) x = b; ``mask`` [n_seg, g] zeroes truncated
        (entity, dim) slots by solving with their rows/cols removed
        (Gram masked symmetric + unit diagonal on masked slots)."""
        n_seg = su.shape[0]
        G = jnp.take(su[:, :P], unpack, axis=1)
        G = G + reg * eye_flat[None, :]
        G = G.reshape(n_seg, g, g)
        b = su[:, P:]
        if mask is not None:
            mm = mask[:, :, None] * mask[:, None, :]
            G = G * mm + (1.0 - mm) * jnp.eye(g, dtype=G.dtype)[None]
            b = b * mask
        x = _chol_solve_unrolled(G, b)
        return x if mask is None else x * mask

    def core(u_fac, i_fac, res, stream, dims_g):
        rows, cols, col_order, rows_cs, row_bounds, col_bounds = stream
        n_pad = res.shape[0]
        U = jnp.take(u_fac, dims_g, axis=1)          # [n_users, g]
        V = jnp.take(i_fac, dims_g, axis=1)
        U_p, V_p = _padr(U), _padr(V)

        if item_dim_ok is not None:
            # dim 0 always allowed; other dims only for frequent items
            v_mask = jnp.where(dims_g[None, :] == 0, 1.0,
                               item_dim_ok[:, None])
        else:
            v_mask = None

        # dim-removed residual in both sorted views
        if nc == 0:
            resn = res + jnp.sum(U_p[rows] * V_p[cols], axis=1)
            resn_cs = resn[col_order]
        else:
            def bld(c, buf):
                off = c * chunk
                val = (_sl(res, off)
                       + jnp.sum(U_p[_sl(rows, off)]
                                 * V_p[_sl(cols, off)], axis=1))
                return jax.lax.dynamic_update_slice(buf, val, (off,))

            resn = jax.lax.fori_loop(0, nc, bld, jnp.zeros_like(res))

            def prm(c, buf):
                off = c * chunk
                val = resn[_sl(col_order, off)]
                return jax.lax.dynamic_update_slice(buf, val, (off,))

            resn_cs = jax.lax.fori_loop(0, nc, prm,
                                        jnp.zeros_like(res))

        def xW(resv, idx, tab_p):
            """[n_pad, P + g]: packed t (x) t | resv * t where
            t = tab_p[idx] — the grouped Gram/b integrand."""
            if nc == 0:
                t = tab_p[idx]
                return jnp.concatenate(
                    [t[:, iu_g] * t[:, il_g], resv[:, None] * t],
                    axis=1)

            def b(c, buf):
                off = c * chunk
                t = tab_p[_sl(idx, off)]
                x = jnp.concatenate(
                    [t[:, iu_g] * t[:, il_g],
                     _sl(resv, off)[:, None] * t], axis=1)
                return jax.lax.dynamic_update_slice(buf, x, (off, 0))

            return jax.lax.fori_loop(
                0, nc, b, jnp.zeros((n_pad, P + g), res.dtype))

        def inner(_, uv):
            U, V = uv
            su = _sorted_segment_sum2(xW(resn, cols, _padr(V)),
                                      row_bounds, seg_block)
            U = _solve(su, u_reg)
            si = _sorted_segment_sum2(xW(resn_cs, rows_cs, _padr(U)),
                                      col_bounds, seg_block)
            V = _solve(si, i_reg, v_mask)
            return (U, V)

        U, V = jax.lax.fori_loop(0, n_inner, inner, (U, V))
        U_p, V_p = _padr(U), _padr(V)
        if nc == 0:
            res = resn - jnp.sum(U_p[rows] * V_p[cols], axis=1)
        else:
            def sub(c, buf):
                off = c * chunk
                val = (_sl(resn, off)
                       - jnp.sum(U_p[_sl(rows, off)]
                                 * V_p[_sl(cols, off)], axis=1))
                return jax.lax.dynamic_update_slice(buf, val, (off,))

            res = jax.lax.fori_loop(0, nc, sub, resn)
        u_fac = u_fac.at[:, dims_g].set(U.astype(u_fac.dtype))
        i_fac = i_fac.at[:, dims_g].set(V.astype(i_fac.dtype))
        return u_fac, i_fac, res

    return core


class CCDPPSolver:
    """Rank-1 coordinate-descent sweeps. State extra: the residual vector,
    carried across epochs (reference carries `res` across epochs too)."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 n_inner: int = 5, freq_adaptive: bool = False,
                 freq_thresh: float = 75.0, item_freq=None,
                 sweep_mode: Optional[str] = None, dim_chunk: int = 8,
                 nnz_chunk: Optional[int] = None,
                 engine: str = "sorted", seg_block: int = 4096,
                 group_dims: int = 1, **_):
        """``sweep_mode``: "scan" = whole epoch as one lax.scan over
        dims (fastest dispatch); "per_dim" = one jitted call per dim;
        "chunked" = one jitted scan per ``dim_chunk`` dims; None =
        auto ("scan" below 3M nnz, "chunked" above — see below).

        ``nnz_chunk``: split every nnz-sized gather/segment op into
        passes of at most this many elements (None = auto: chunking
        kicks in above 3M nnz with 2M chunks; 0 = never).

        Scale defaults: at scale the auto mode runs "chunked" dim-scans
        over nnz-chunked segment passes, which bounds the size of every
        program and every indexed op. It was chosen on an accelerator
        whose backend faulted on the monolithic 64-dim scan at ML-10M
        scale; whether a GPU needs the chunking is open (ROADMAP speed
        item 4).

        ``engine``: "sorted" (default — scatter-free segment reductions
        over row-/col-sorted views, ~15 index streams/dim; see
        _make_sweep_core_sorted) or "scatter" (segment_sum both sides,
        the round-1/2 engine, ~24 streams/dim).

        ``group_dims`` (sorted engine only): process g dims per sweep
        as a rank-g BLOCK update with per-entity g x g solves — the
        per-dim index-stream count drops ~g-fold
        (_make_sweep_core_sorted_grouped; README deviation #14).
        fac_dim must be divisible by g."""
        self.model = model
        self.params = params
        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        self.n_users = int(model.n_users)
        self.n_items = int(model.n_items)
        self.n_inner = n_inner
        self.engine = engine
        self.g = max(int(group_dims), 1)
        if self.g > 1:
            if engine != "sorted":
                raise ValueError("group_dims > 1 needs engine='sorted'")
            if model.k % self.g:
                raise ValueError(
                    f"fac_dim={model.k} not divisible by "
                    f"group_dims={self.g}")
        nnz = len(r)
        if nnz_chunk is None:
            nnz_chunk = 2_000_000 if nnz > 3_000_000 else 0
        if sweep_mode is None:
            sweep_mode = "chunked" if nnz > 3_000_000 else "scan"
        self.sweep_mode = sweep_mode
        if nnz_chunk and nnz > nnz_chunk:
            self.nc = -(-nnz // nnz_chunk)
            self.chunk = nnz_chunk
        else:
            self.nc = 0
            self.chunk = 0
        n_pad = self.nc * self.chunk if self.nc else nnz
        if engine == "sorted":
            # the sorted engine's bounds come from a row-ascending
            # stream (to_coo from CSR already is; sort to be robust)
            order = np.argsort(r, kind="stable")
            r, c, v = r[order], c[order], v[order]
            # cumsum blocks must tile the padded stream exactly
            self.seg_block = seg_block
            n_pad = max(_cdiv_i(n_pad, seg_block), 1) * seg_block
        pad = n_pad - nnz
        if pad:
            # pad indices hit the sentinel row/col (gathers read the
            # appended _pad1 zero; scatter bin is sliced off), values 0
            r = np.concatenate([r, np.full(pad, self.n_users, r.dtype)])
            c = np.concatenate([c, np.full(pad, self.n_items, c.dtype)])
            v = np.concatenate([v, np.zeros(pad, v.dtype)])
        self.rows = jnp.asarray(r.astype(np.int32))
        self.cols = jnp.asarray(c.astype(np.int32))
        self.vals = jnp.asarray(v.astype(np.float32))
        if engine == "sorted":
            col_order = np.argsort(c, kind="stable")
            self.stream = (
                self.rows, self.cols,
                jnp.asarray(col_order.astype(np.int32)),
                jnp.asarray(r[col_order].astype(np.int32)),
                jnp.asarray(np.searchsorted(
                    r, np.arange(self.n_users + 1)).astype(np.int32)),
                jnp.asarray(np.searchsorted(
                    c[col_order],
                    np.arange(self.n_items + 1)).astype(np.int32)))
        else:
            self.stream = (self.rows, self.cols)
        self.res: Optional[jax.Array] = None
        if freq_adaptive:
            if item_freq is None:
                item_freq = train_mat.col_degrees().astype(np.float64)
            fa = np.zeros(self.n_items, np.float32)
            fa[: len(item_freq)] = (item_freq >= freq_thresh)
            # dim 0 always allowed; dims >0 only for frequent items
            self.item_dim_ok = jnp.asarray(fa)
        else:
            self.item_dim_ok = None
        self.dim_chunk = dim_chunk
        self._epoch = self._build_epoch()
        self._dim_sweep = self._build_dim_sweep()
        self._chunk_sweep = self._build_chunk_sweep()
        self._initialized = False

    def _sweep_core(self):
        if self.engine == "sorted":
            if self.g > 1:
                return _make_sweep_core_sorted_grouped(
                    self.n_users, self.n_items,
                    float(self.params.u_reg),
                    float(self.params.i_reg), self.n_inner,
                    self.item_dim_ok, self.nc, self.chunk,
                    self.seg_block, self.g)
            return _make_sweep_core_sorted(
                self.n_users, self.n_items, float(self.params.u_reg),
                float(self.params.i_reg), self.n_inner,
                self.item_dim_ok, self.nc, self.chunk, self.seg_block)
        return _make_sweep_core(
            self.n_users, self.n_items, float(self.params.u_reg),
            float(self.params.i_reg), self.n_inner, self.item_dim_ok,
            self.nc, self.chunk)

    def _build_dim_sweep(self):
        """Single-dim sweep for sweep_mode="per_dim" (same math as one
        scan step of _build_epoch)."""
        core = self._sweep_core()

        @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
        def dim_sweep(u_fac, i_fac, res, stream, kk):
            return core(u_fac, i_fac, res, stream, kk)

        return dim_sweep

    def _build_chunk_sweep(self):
        """Scan over an explicit chunk of dims (sweep_mode="chunked"):
        same math as _build_epoch's scan body, host-driven chunking."""
        core = self._sweep_core()

        @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
        def chunk_sweep(u_fac, i_fac, res, stream, dims):
            def dim_sweep(carry, kk):
                u_fac, i_fac, res = carry
                return core(u_fac, i_fac, res, stream, kk), None

            (u_fac, i_fac, res), _ = jax.lax.scan(
                dim_sweep, (u_fac, i_fac, res), dims)
            return u_fac, i_fac, res

        return chunk_sweep

    def _build_epoch(self):
        core = self._sweep_core()
        g = self.g

        # staged arrays are jit ARGUMENTS (closure constants make XLA
        # compile time explode at nnz scale — see solvers/sgd.py)
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(state: MFState, res, stream, key):
            dims = jax.random.permutation(key, state.u_fac.shape[1])
            if g > 1:
                dims = dims.reshape(-1, g)

            def dim_sweep(carry, kk):
                u_fac, i_fac, res = carry
                return core(u_fac, i_fac, res, stream, kk), None

            (u_fac, i_fac, res), _ = jax.lax.scan(
                dim_sweep, (state.u_fac, state.i_fac, res), dims)
            return state._replace(u_fac=u_fac, i_fac=i_fac), res

        return epoch

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        del lr
        if not self._initialized:
            # uFac zero-init (modelMF.cpp:1020) => residual = ratings.
            # Copy: the epoch fn donates its res argument and self.vals
            # must stay alive for reset().
            state = state._replace(u_fac=jnp.zeros_like(state.u_fac))
            self.res = jnp.array(self.vals, copy=True)
            self._initialized = True
        if self.sweep_mode == "per_dim":
            dims = np.asarray(jax.random.permutation(
                key, state.u_fac.shape[1]))
            if self.g > 1:
                dims = dims.reshape(-1, self.g)
            u_fac, i_fac, res = state.u_fac, state.i_fac, self.res
            for kk in dims:
                u_fac, i_fac, res = self._dim_sweep(
                    u_fac, i_fac, res, self.stream,
                    jnp.asarray(kk) if self.g > 1 else int(kk))
            self.res = res
            return state._replace(u_fac=u_fac, i_fac=i_fac)
        if self.sweep_mode == "chunked":
            k = state.u_fac.shape[1]
            dims = np.asarray(jax.random.permutation(key, k))
            u_fac, i_fac, res = state.u_fac, state.i_fac, self.res
            if self.g > 1:
                # scan over GROUPS of g dims, dim_chunk groups per call
                groups = dims.reshape(-1, self.g)
                C = min(self.dim_chunk, len(groups))
                n_full = (len(groups) // C) * C
                for s in range(0, n_full, C):
                    u_fac, i_fac, res = self._chunk_sweep(
                        u_fac, i_fac, res, self.stream,
                        jnp.asarray(groups[s:s + C]))
                for kk in groups[n_full:]:
                    u_fac, i_fac, res = self._dim_sweep(
                        u_fac, i_fac, res, self.stream,
                        jnp.asarray(kk))
                self.res = res
                return state._replace(u_fac=u_fac, i_fac=i_fac)
            C = min(self.dim_chunk, k)
            # pad the permutation to a chunk multiple by REPEATING the
            # tail dims? No — a repeated sweep would change results;
            # instead run the last partial chunk through per-dim calls.
            n_full = (k // C) * C
            for s in range(0, n_full, C):
                u_fac, i_fac, res = self._chunk_sweep(
                    u_fac, i_fac, res, self.stream,
                    jnp.asarray(dims[s:s + C]))
            for kk in dims[n_full:]:
                u_fac, i_fac, res = self._dim_sweep(
                    u_fac, i_fac, res, self.stream, int(kk))
            self.res = res
            return state._replace(u_fac=u_fac, i_fac=i_fac)
        state, self.res = self._epoch(state, self.res, self.stream, key)
        return state

    def reset(self):
        self._initialized = False
        self.res = None

    # -- exact-resume hooks (TrainLoop checkpoints; the reference carries
    # the residual across its whole process lifetime) -------------------
    def internal_state(self) -> dict:
        if not self._initialized:
            return {}
        return {"res": self.res}

    def set_internal_state(self, d: dict) -> None:
        if "res" in d:
            res = jnp.asarray(d["res"])
            n = int(self.vals.shape[0])  # staged (possibly padded) len
            if res.shape[0] < n:
                res = jnp.concatenate(
                    [res, jnp.zeros((n - res.shape[0],), res.dtype)])
            elif res.shape[0] > n:
                res = res[:n]
            self.res = res
            self._initialized = True


class CCDSolver(CCDPPSolver):
    """Per-entity CCD (trainCCD): full user sweep over all dims, then
    full item sweep; add-back folded into the numerator; residual is NOT
    reinitialized (uFac starts at 0 per modelMF.cpp:1520-1526).

    sweep_mode is pinned to "scan": the inherited per_dim/chunked paths
    run the CCD++ dim sweep (add-back + alternations + subtract), which
    is NOT trainCCD's user-sweep-then-item-sweep ordering — before
    round 3 the >3M-nnz auto mode silently picked "chunked" and trained
    the wrong algorithm. Scale is still served: _build_epoch has its own
    nnz-chunked passes."""

    def __init__(self, *args, **kw):
        kw.pop("n_inner", None)
        kw["sweep_mode"] = "scan"
        kw.setdefault("engine", "scatter")
        super().__init__(*args, n_inner=1, **kw)

    def _build_epoch(self):
        n_users, n_items = self.n_users, self.n_items
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        nc, chunk = self.nc, self.chunk

        def _pad1(x):
            return jnp.concatenate([x, jnp.zeros((1,), x.dtype)])

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(state: MFState, res, stream, key):
            rows, cols = stream[0], stream[1]
            k_u, k_i = jax.random.split(key)

            if nc == 0:
                def user_dim(carry, kk):
                    u_fac, i_fac, res = carry
                    u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
                    v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)
                    vg = v_k[cols]
                    su = jax.ops.segment_sum(
                        jnp.stack([(res + u_k[rows] * vg) * vg,
                                   vg * vg], axis=1), rows, n_users)
                    new_u = su[:, 0] / (u_reg + su[:, 1])
                    res = res - (new_u[rows] - u_k[rows]) * vg
                    return (_set_col(u_fac, kk, new_u), i_fac, res), None

                def item_dim(carry, kk):
                    u_fac, i_fac, res = carry
                    u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
                    v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)
                    ug = u_k[rows]
                    si = jax.ops.segment_sum(
                        jnp.stack([(res + ug * v_k[cols]) * ug,
                                   ug * ug], axis=1), cols, n_items)
                    new_v = si[:, 0] / (i_reg + si[:, 1])
                    res = res - ug * (new_v[cols] - v_k[cols])
                    return (u_fac, _set_col(i_fac, kk, new_v), res), None
            else:
                def _sl(x, off):
                    return jax.lax.dynamic_slice(x, (off,), (chunk,))

                def user_dim(carry, kk):
                    u_fac, i_fac, res = carry
                    u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
                    v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)
                    u_p, v_p = _pad1(u_k), _pad1(v_k)

                    def acc(c, su):
                        off = c * chunk
                        vg = v_p[_sl(cols, off)]
                        r_c = _sl(rows, off)
                        return su + jax.ops.segment_sum(
                            jnp.stack([(_sl(res, off) + u_p[r_c] * vg)
                                       * vg, vg * vg], axis=1),
                            r_c, n_users + 1)

                    su = jax.lax.fori_loop(
                        0, nc, acc, jnp.zeros((n_users + 1, 2), res.dtype))
                    new_u = su[:n_users, 0] / (u_reg + su[:n_users, 1])
                    d_p = _pad1(new_u - u_k)

                    def upd(c, res):
                        off = c * chunk
                        vg = v_p[_sl(cols, off)]
                        res_c = _sl(res, off) - d_p[_sl(rows, off)] * vg
                        return jax.lax.dynamic_update_slice(
                            res, res_c, (off,))

                    res = jax.lax.fori_loop(0, nc, upd, res)
                    return (_set_col(u_fac, kk, new_u), i_fac, res), None

                def item_dim(carry, kk):
                    u_fac, i_fac, res = carry
                    u_k = jax.lax.dynamic_index_in_dim(u_fac, kk, 1, False)
                    v_k = jax.lax.dynamic_index_in_dim(i_fac, kk, 1, False)
                    u_p, v_p = _pad1(u_k), _pad1(v_k)

                    def acc(c, si):
                        off = c * chunk
                        ug = u_p[_sl(rows, off)]
                        c_c = _sl(cols, off)
                        return si + jax.ops.segment_sum(
                            jnp.stack([(_sl(res, off) + ug * v_p[c_c])
                                       * ug, ug * ug], axis=1),
                            c_c, n_items + 1)

                    si = jax.lax.fori_loop(
                        0, nc, acc, jnp.zeros((n_items + 1, 2), res.dtype))
                    new_v = si[:n_items, 0] / (i_reg + si[:n_items, 1])
                    d_p = _pad1(new_v - v_k)

                    def upd(c, res):
                        off = c * chunk
                        ug = u_p[_sl(rows, off)]
                        res_c = (_sl(res, off)
                                 - ug * d_p[_sl(cols, off)])
                        return jax.lax.dynamic_update_slice(
                            res, res_c, (off,))

                    res = jax.lax.fori_loop(0, nc, upd, res)
                    return (u_fac, _set_col(i_fac, kk, new_v), res), None

            k = state.u_fac.shape[1]
            carry = (state.u_fac, state.i_fac, res)
            carry, _ = jax.lax.scan(user_dim, carry,
                                    jax.random.permutation(k_u, k))
            carry, _ = jax.lax.scan(item_dim, carry,
                                    jax.random.permutation(k_i, k))
            u_fac, i_fac, res = carry
            return state._replace(u_fac=u_fac, i_fac=i_fac), res

        return epoch


def _set_col(mat: jax.Array, kk, col: jax.Array) -> jax.Array:
    return jax.lax.dynamic_update_slice(mat, col[:, None].astype(mat.dtype),
                                        (0, kk))
