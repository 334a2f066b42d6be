"""ALS — batched normal-equation solves.

JAX analog of ModelMF::trainALS (modelMF.cpp:709-928): per user
u, accumulate the Gram YTY = sum_i q_i q_i^T and b = sum_i r_ui q_i over
the rated items with rating > 0 (the reference's explicit rating>0 gate,
modelMF.cpp:820/:862), add reg to the diagonal, solve the k x k system;
then symmetrically for items over the column view.

The reference loops scalar Gram accumulation per row under OpenMP; here
rows are grouped into power-of-two degree buckets (data.batching) and
each bucket runs one einsum Gram + one batched Cholesky solve — dense
[nb, cap, k] x [nb, cap, k] -> [nb, k, k] contractions, O(log max_deg)
compiled shapes total.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.data.batching import RowBucket, bucketed_rows
from matfac_tpu.models.base import MFState


def solve_spd_cg(gram, b, x0, iters: int, eps: float = 1e-12):
    """Warm-started batched conjugate gradient for SPD systems —
    gram [n,k,k], b/x0 [n,k]. CG is nothing but batched matvecs, and
    batched Cholesky can be the costliest part of an ALS epoch; with
    the previous factors as x0 a handful of iterations reaches ALS-quality
    solves (the iALS warm-start trick, Hu et al. / iALS++)."""
    def mv(x):
        return jnp.einsum("bij,bj->bi", gram, x,
                          preferred_element_type=jnp.float32)

    def body(carry, _):
        x, r, p, rs = carry
        ap = mv(p)
        alpha = rs / (jnp.sum(p * ap, axis=1) + eps)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = jnp.sum(r * r, axis=1)
        beta = rs_new / (rs + eps)
        p = r + beta[:, None] * p
        return (x, r, p, rs_new), None

    r0 = b - mv(x0)
    p0 = r0
    rs0 = jnp.sum(r0 * r0, axis=1)
    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, p0, rs0), None,
                                   length=iters)
    return x


@functools.partial(jax.jit,
                   static_argnames=("reg", "cg_iters", "reg_exp"),
                   donate_argnums=(0,))
def _solve_bucket(target_fac: jax.Array, source_fac: jax.Array,
                  row_ids: jax.Array, cols: jax.Array, vals: jax.Array,
                  mask: jax.Array, reg: float,
                  cg_iters: int = 0, reg_exp: float = 0.0) -> jax.Array:
    """Solve rows `row_ids` of target_fac from their padded rated lists.

    cols/vals/mask: [nb, cap]; source_fac: [n_src, k].
    ``reg_exp``: frequency-scaled regularization — per-row lambda =
    reg * count^reg_exp where count = the row's valid rated entries
    (the iALS scaled-lambda, Rendle et al.; the othersrc experiments'
    marginal-weighted reg, othersrc/modelMFWtReg.cpp:96). 0 = the
    reference's flat lambda (exactly, not approximately).
    """
    k = target_fac.shape[1]
    q = source_fac[cols]                                  # [nb, cap, k]
    w = (mask * (vals > 0)).astype(q.dtype)               # rating>0 gate
    qm = q * w[:, :, None]
    # Gram: sum_c w * q q^T  (w is 0/1 so one-sided masking suffices)
    yty = jnp.einsum("bck,bcl->bkl", qm, q,
                     preferred_element_type=jnp.float32)
    b = jnp.einsum("bc,bck->bk", vals * w, q,
                   preferred_element_type=jnp.float32)
    if reg_exp:
        cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)        # [nb]
        reg_row = reg * cnt ** reg_exp
        yty = yty + reg_row[:, None, None] \
            * jnp.eye(k, dtype=yty.dtype)[None]
    else:
        yty = yty + reg * jnp.eye(k, dtype=yty.dtype)[None]
    if cg_iters > 0:
        x0 = target_fac[row_ids].astype(jnp.float32)
        sol = solve_spd_cg(yty, b, x0, cg_iters).astype(target_fac.dtype)
    else:
        chol = jax.lax.linalg.cholesky(yty)
        sol = jax.lax.linalg.triangular_solve(
            chol, b[..., None], left_side=True, lower=True)
        sol = jax.lax.linalg.triangular_solve(
            chol, sol, left_side=True, lower=True, transpose_a=True)
        sol = sol[..., 0].astype(target_fac.dtype)
    # dummy padded rows (mask all-zero) would clobber row 0 — route their
    # writes out of range so the scatter drops them
    real = (jnp.sum(mask, axis=1) > 0)
    safe_ids = jnp.where(real, row_ids, target_fac.shape[0])
    return target_fac.at[safe_ids].set(sol, mode="drop")


class ALSSolver:
    """Owns the bucketed row/column layouts and runs one ALS sweep per
    epoch (user pass then item pass, like modelMF.cpp:795-880)."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 cg_iters: int = 0, **_):
        self.model = model
        self.params = params
        self.cg_iters = cg_iters
        self.reg_exp = float(getattr(params, "reg_exponent", 0.0))
        self.u_buckets: List[RowBucket] = bucketed_rows(
            train_mat, invalid=invalid_users)
        self.i_buckets: List[RowBucket] = bucketed_rows(
            train_mat.transpose(), invalid=invalid_items)
        # chunk large buckets so the gathered [nb, cap, k] block and the
        # [nb, k, k] grams stay ~<=1 GiB each (a 122k-row cap-256 bucket
        # at k=128 otherwise compiles to a 15 GiB temp -> HBM OOM)
        k = max(model.k, 1)
        budget = 1 << 28   # f32 elements

        def chunks(b: RowBucket):
            max_rows = max(budget // max(b.cap * k, k * k), 256)
            max_rows -= max_rows % 8
            if len(b.row_ids) <= max_rows:
                yield b.row_ids, b.cols, b.vals, b.mask
                return
            for s0 in range(0, len(b.row_ids), max_rows):
                e0 = min(s0 + max_rows, len(b.row_ids))
                yield (b.row_ids[s0:e0], b.cols[s0:e0], b.vals[s0:e0],
                       b.mask[s0:e0])

        self._stage = [
            [tuple(map(jnp.asarray, c)) for b in bs for c in chunks(b)]
            for bs in (self.u_buckets, self.i_buckets)]

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        del lr, key  # ALS has no step size / randomness
        u_fac, i_fac = state.u_fac, state.i_fac
        for ids, cols, vals, mask in self._stage[0]:
            u_fac = _solve_bucket(u_fac, i_fac, ids, cols, vals, mask,
                                  float(self.params.u_reg),
                                  cg_iters=self.cg_iters,
                                  reg_exp=self.reg_exp)
        for ids, cols, vals, mask in self._stage[1]:
            i_fac = _solve_bucket(i_fac, u_fac, ids, cols, vals, mask,
                                  float(self.params.i_reg),
                                  cg_iters=self.cg_iters,
                                  reg_exp=self.reg_exp)
        return state._replace(u_fac=u_fac, i_fac=i_fac)


@functools.partial(jax.jit, static_argnames=("reg", "d"),
                   donate_argnums=(0,))
def _subspace_solve_bucket(target_fac, source_fac, row_ids, cols, vals,
                           mask, blocks, reg: float, d: int):
    """One iALS++-style sweep over a bucket: for each coordinate block S
    (|S| = d), solve the d x d normal equations for the block holding
    all other coordinates fixed (subspace optimization — iALS++,
    arXiv:2110.14044; explicit-feedback form). Residuals are maintained
    incrementally so a full sweep costs O(|R_u| k d + k d^2) instead of
    ALS's O(|R_u| k^2 + k^3).

    blocks: [n_blocks, d] int32 coordinate indices (a shuffled partition
    of range(k)).
    """
    q = source_fac[cols]                                  # [nb, cap, k]
    w = (mask * (vals > 0)).astype(q.dtype)               # rating>0 gate
    p0 = target_fac[row_ids]                              # [nb, k]
    pred = jnp.einsum("bk,bck->bc", p0, q,
                      preferred_element_type=jnp.float32)

    def block_step(carry, S):
        p, pred = carry
        qS = jnp.take(q, S, axis=2)                       # [nb, cap, d]
        qSw = qS * w[:, :, None]
        H = jnp.einsum("bcd,bce->bde", qSw, qS,
                       preferred_element_type=jnp.float32) \
            + reg * jnp.eye(d, dtype=jnp.float32)[None]
        e = (vals - pred) * w
        g = jnp.einsum("bc,bcd->bd", e, qS,
                       preferred_element_type=jnp.float32) \
            - reg * jnp.take(p, S, axis=1)
        chol = jax.lax.linalg.cholesky(H)
        delta = jax.lax.linalg.triangular_solve(
            chol, g[..., None], left_side=True, lower=True)
        delta = jax.lax.linalg.triangular_solve(
            chol, delta, left_side=True, lower=True,
            transpose_a=True)[..., 0]
        p = p.at[:, S].add(delta.astype(p.dtype))
        pred = pred + jnp.einsum("bd,bcd->bc", delta, qS,
                                 preferred_element_type=jnp.float32)
        return (p, pred), None

    (p, _), _ = jax.lax.scan(block_step, (p0, pred), blocks)
    real = (jnp.sum(mask, axis=1) > 0)
    safe_ids = jnp.where(real, row_ids, target_fac.shape[0])
    return target_fac.at[safe_ids].set(p, mode="drop")


class SubspaceALSSolver(ALSSolver):
    """iALS++-style block-coordinate ALS: same bucketed layout, but each
    sweep solves k/d subspace systems of size d instead of one k x k
    system — the scaling win for large fac_dim (PAPERS.md iALS++)."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users, invalid_items, block_dim: int = 16, **_):
        super().__init__(model, params, train_mat, invalid_users,
                         invalid_items)
        if self.reg_exp:
            raise ValueError(
                "reg_exponent (per-row lambda) is implemented in the "
                "bucketed ALSSolver and the SGD engine; "
                "SubspaceALSSolver would silently train flat lambda")
        k = params.fac_dim
        self.d = min(block_dim, k)
        if k % self.d != 0:
            # pad the block list by wrapping (coords may repeat across
            # blocks within a sweep; harmless for coordinate descent)
            n_blocks = -(-k // self.d)
            idx = np.resize(np.arange(k), n_blocks * self.d)
        else:
            idx = np.arange(k)
        self._block_idx = idx.reshape(-1, self.d).astype(np.int32)

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        del lr
        if key is not None:
            perm = np.asarray(jax.random.permutation(
                key, self._block_idx.shape[0]))
        else:
            perm = np.arange(self._block_idx.shape[0])
        blocks = jnp.asarray(self._block_idx[perm])
        u_fac, i_fac = state.u_fac, state.i_fac
        for ids, cols, vals, mask in self._stage[0]:
            u_fac = _subspace_solve_bucket(
                u_fac, i_fac, ids, cols, vals, mask, blocks,
                float(self.params.u_reg), self.d)
        for ids, cols, vals, mask in self._stage[1]:
            i_fac = _subspace_solve_bucket(
                i_fac, u_fac, ids, cols, vals, mask, blocks,
                float(self.params.i_reg), self.d)
        return state._replace(u_fac=u_fac, i_fac=i_fac)


@functools.partial(jax.jit,
                   static_argnames=("reg", "blk", "transposed",
                                    "cg_iters", "packed", "gram_int8"),
                   donate_argnums=(0,))
def _dense_als_sweep(target_fac, source_fac, dense_vals, reg: float,
                     blk: int, transposed: bool = False,
                     cg_iters: int = 0, packed: bool = True,
                     gram_int8: bool = False, mask8=None):
    """Dense masked-Gram ALS sweep: for each row block,

        G[u] = sum_i 1[r_ui > 0] q_i q_i^T  =  M @ QQ      (one matmul)
        b[u] = sum_i r_ui q_i               =  Wv @ Q      (one matmul)

    with QQ[i, (k,l)] = q_ik q_il. Identical normal equations to
    _solve_bucket (modelMF.cpp:806-880 semantics incl. the rating>0
    gate) but zero gathers — pure matmul work. Requires the dense ratings
    block-row Wv [n_rows, n_src] in HBM (bf16 is fine for ratings).

    ``packed``: exploit Gram symmetry — QQ carries only the k(k+1)/2
    upper-triangle products and the full [blk, k, k] Gram is rebuilt by
    a static take along the packed axis. Column (a,b) of the full QQ
    equals column (b,a) exactly, so the packed sweep computes the SAME
    f32 contractions (bit-identical columns) at ~half the Gram-matmul
    FLOP — the dominant cost of the sweep.

    ``gram_int8``: run the Gram matmul as int8 x int8 -> int32 (twice
    the bf16 tensor-core rate on the spec sheet; not yet measured here).
    The mask operand is 0/1 so int8 x int8 -> int32 accumulation is
    EXACT in it; only QQ quantizes (symmetric per-column scales,
    <= 2^-8 relative — the same error class as the bf16 mode). The
    b-vector and solves stay bf16/f32. ``mask8``: PRESTAGED int8 mask
    in the sweep's OWN orientation ([n_rows_pad, n_src] row-sliced in
    both modes — the item sweep gets the transposed copy), so the
    int8 operand reaches the dot as stored, with no in-sweep cast or
    transpose in front of it. Requires
    cg_iters > 0: the quantization error is absolute per column, so a
    LOW-count row's small Gram can go indefinite past the ridge retry
    and Cholesky NaNs (observed); warm bounded CG degrades gracefully
    instead.
    CAVEAT (measured): int8 is an opt-in perf mode for factor tables
    with homogeneous row scales (the bench regime, where it matches
    f32 CG quality); with strongly heterogeneous factor magnitudes
    (e.g. boosted tail rows) a few large source rows set the column
    scales and CG on the distorted Grams can diverge across epochs —
    the train loop's NaN/val rollback is the backstop, or use the
    bf16 default.
    """
    if gram_int8 and cg_iters <= 0:
        raise ValueError("gram_int8 requires cg_iters > 0 "
                         "(see docstring)")
    n_rows = target_fac.shape[0]
    k = target_fac.shape[1]
    # big matmuls run with bf16 operands + f32 accumulation;
    # the k x k solves stay f32
    mm_dtype = dense_vals.dtype if dense_vals.dtype == jnp.bfloat16 \
        else jnp.float32
    qf = source_fac.astype(jnp.float32)
    q = qf.astype(mm_dtype)
    if packed:
        iu, il = np.triu_indices(k)
        qq = qf[:, iu] * qf[:, il]             # [n_src, k(k+1)/2] f32
        # full-index map: (a, b) -> packed slot of (min, max)
        pos = np.zeros((k, k), np.int32)
        pos[iu, il] = np.arange(iu.size, dtype=np.int32)
        pos[il, iu] = pos[iu, il]
        unpack_idx = jnp.asarray(pos.reshape(-1))
    else:
        qq = (qf[:, :, None] * qf[:, None, :]).reshape(
            qf.shape[0], k * k)
        unpack_idx = None
    if gram_int8:
        qq_scale = jnp.max(jnp.abs(qq), axis=0) / 127.0 + 1e-30
        qq = jnp.round(qq / qq_scale).astype(jnp.int8)
        gram_dtype, mask_dtype = jnp.int32, jnp.int8
    else:
        qq = qq.astype(mm_dtype)
        qq_scale = None
        gram_dtype, mask_dtype = jnp.float32, mm_dtype

    def solve_block(_, s):
        if transposed:
            # dense_vals is [n_src, n_rows_pad]: slice COLUMNS and
            # contract over axis 0 (no transpose materialization)
            wv = jax.lax.dynamic_slice_in_dim(
                dense_vals, s * blk, blk, axis=1)
            if mask8 is not None:
                m8 = jax.lax.dynamic_slice_in_dim(mask8, s * blk, blk)
                gram = jnp.dot(m8, qq,
                               preferred_element_type=gram_dtype)
            else:
                gram = jnp.einsum("ur,uk->rk",
                                  (wv > 0).astype(mask_dtype), qq,
                                  preferred_element_type=gram_dtype)
            # staging applies the rating>0 gate, so wv doubles as the
            # masked values: b = wv @ Q with no elementwise pass
            b = jnp.einsum("ur,uk->rk", wv.astype(mm_dtype), q,
                           preferred_element_type=jnp.float32)
        else:
            wv = jax.lax.dynamic_slice_in_dim(dense_vals, s * blk, blk)
            if mask8 is not None:
                m8 = jax.lax.dynamic_slice_in_dim(mask8, s * blk, blk)
                gram = jnp.dot(m8, qq,
                               preferred_element_type=gram_dtype)
            else:
                gram = jnp.dot((wv > 0).astype(mask_dtype), qq,
                               preferred_element_type=gram_dtype)
            b = jnp.dot(wv.astype(mm_dtype), q,
                        preferred_element_type=jnp.float32)
        if gram_int8:
            gram = gram.astype(jnp.float32) * qq_scale[None]
        if packed:
            gram = jnp.take(gram, unpack_idx, axis=1)
        gram = gram.reshape(blk, k, k) \
            + reg * jnp.eye(k, dtype=jnp.float32)[None]
        if cg_iters > 0:
            x0 = jax.lax.dynamic_slice_in_dim(
                target_fac, s * blk, blk).astype(jnp.float32)
            return _, solve_spd_cg(gram, b, x0, cg_iters)
        chol = jax.lax.linalg.cholesky(gram)
        if mm_dtype == jnp.bfloat16 or gram_int8:
            # bf16 Gram accumulation carries ~2^-8 relative error; once
            # factor magnitudes grow the masked Gram can turn (slightly)
            # indefinite and Cholesky emits NaN. Retry the failed
            # matrices with a diagonal ridge scaled to their trace —
            # only bf16-mode needs this (f32 Grams are exact-PSD+reg).
            bad = ~jnp.isfinite(chol).all(axis=(1, 2))
            ridge = 8e-3 * jnp.trace(gram, axis1=1, axis2=2) / k + 1e-6
            gram_j = gram + (jnp.where(bad, ridge, 0.0)[:, None, None]
                             * jnp.eye(k, dtype=jnp.float32)[None])
            chol = jnp.where(bad[:, None, None],
                             jax.lax.linalg.cholesky(gram_j), chol)
        sol = jax.lax.linalg.triangular_solve(
            chol, b[..., None], left_side=True, lower=True)
        sol = jax.lax.linalg.triangular_solve(
            chol, sol, left_side=True, lower=True, transpose_a=True)
        return _, sol[..., 0]

    n_blocks = n_rows // blk
    _, sols = jax.lax.scan(solve_block, None,
                           jnp.arange(n_blocks, dtype=jnp.int32))
    return sols.reshape(n_rows, k).astype(target_fac.dtype)


class DenseALSSolver:
    """ALS via dense masked Grams — the gather-free formulation.

    The bucketed ALS gathers one factor row per rating; this variant
    trades those nnz-sized gathers for dense [rows x cols] matmuls,
    which pays when the matrix is dense enough. Memory: needs the
    dense rating matrix (bf16) in HBM — guarded below.
    """

    # the sweeps' live temps are per-block (~hundreds of MB), so this
    # caps the dense staging (values + optional int8 masks). 10 GiB
    # covers the full bench shape with gram_int8 (bf16 values 4.2 GB +
    # two int8 masks 4.2 GB); an inherited size, not yet derived from
    # device memory (ROADMAP speed item 10).
    MAX_DENSE_BYTES = 10 * 1024 ** 3

    def __init__(self, model, params: Params, train_mat,
                 invalid_users, invalid_items, row_block: int = 1024,
                 dense_dtype=None, cg_iters: int = 0,
                 packed: bool = True, gram_int8: bool = False, **_):
        """cg_iters > 0: warm-started CG solves instead of Cholesky
        (see solve_spd_cg); 0 (default) = exact normal-equation solves,
        matching the reference's ldlt (modelMF.cpp:836,874). Perf paths
        (bench.py) opt into CG explicitly.

        dense_dtype None = auto: f32 storage (exact parity) when the
        dense matrix fits in 2 GiB, else bf16 (HBM scale mode; ~2^-8
        rating rounding — quality floor measured ~0.15 vs 0.136 on the
        ML-100K-shape parity run)."""
        self.model = model
        self.params = params
        self.cg_iters = cg_iters
        self.packed = packed
        self.gram_int8 = gram_int8
        if gram_int8 and cg_iters <= 0:
            raise ValueError("gram_int8 requires cg_iters > 0 — the "
                             "quantized Gram of a low-count row can go "
                             "indefinite and Cholesky NaNs; warm CG is "
                             "the int8 perf path (_dense_als_sweep)")
        if float(getattr(params, "reg_exponent", 0.0)):
            raise ValueError(
                "reg_exponent (per-row lambda) is implemented in the "
                "bucketed ALSSolver and the SGD engine; DenseALSSolver "
                "would silently train flat lambda")
        n_users, n_items = model.n_users, model.n_items
        self.row_block = row_block
        # guards must use the PADDED allocation (rows/cols round up to
        # row_block multiples) — the raw n_users*n_items estimate was
        # up to 20x under the real footprint at skinny shapes (review
        # r3)
        self.nu_pad = _cdiv(n_users, row_block) * row_block
        self.ni_pad = _cdiv(n_items, row_block) * row_block
        if dense_dtype is None:
            dense_dtype = (jnp.float32
                           if self.nu_pad * self.ni_pad * 4
                           <= 2 * 1024 ** 3
                           else jnp.bfloat16)
        need = (self.nu_pad * self.ni_pad
                * (jnp.dtype(dense_dtype).itemsize
                   + (2 if gram_int8 else 0)))
        if need > self.MAX_DENSE_BYTES:
            raise ValueError(
                f"DenseALSSolver needs {need/2**30:.1f} GiB dense "
                "storage (padded to row_block multiples); use "
                "ALSSolver for this shape")
        dense = np.zeros((self.nu_pad, self.ni_pad), np.float32)
        r, c, v = train_mat.to_coo()
        # the rating>0 gate (modelMF.cpp:820/:862) is applied at
        # staging, so the sweep's b-vector needs no mask multiply and
        # (dense > 0) IS the Gram mask
        keep = (v > 0) & ~invalid_users[r] & ~invalid_items[c]
        dense[r[keep], c[keep]] = v[keep]
        # single copy; the item sweep slices columns (transposed mode)
        self.dense = jnp.asarray(dense, dense_dtype)
        del dense
        if gram_int8:
            # prestaged int8 masks in EACH sweep's row orientation
            # (_dense_als_sweep docstring); +2 bytes/slot accounted in
            # the guard above
            self.mask_rows = jax.jit(
                lambda d: (d > 0).astype(jnp.int8))(self.dense)
            self.mask_cols = jax.jit(
                lambda m: m.T.copy())(self.mask_rows)
        else:
            self.mask_rows = self.mask_cols = None

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        del lr, key
        n_users, n_items = self.model.n_users, self.model.n_items
        k = self.model.k
        u_pad = self.nu_pad - n_users
        i_pad = self.ni_pad - n_items
        # padded source rows/cols of the dense matrix are zero => they
        # contribute nothing to Grams; pad factors accordingly
        u_fac = jnp.pad(state.u_fac, ((0, u_pad), (0, 0))) if u_pad \
            else state.u_fac
        i_fac = jnp.pad(state.i_fac, ((0, i_pad), (0, 0))) if i_pad \
            else state.i_fac
        u_fac = _dense_als_sweep(u_fac, i_fac, self.dense,
                                 float(self.params.u_reg),
                                 self.row_block,
                                 cg_iters=self.cg_iters,
                                 packed=self.packed,
                                 gram_int8=self.gram_int8,
                                 mask8=self.mask_rows)
        i_fac = _dense_als_sweep(i_fac, u_fac, self.dense,
                                 float(self.params.i_reg),
                                 self.row_block, transposed=True,
                                 cg_iters=self.cg_iters,
                                 packed=self.packed,
                                 gram_int8=self.gram_int8,
                                 mask8=self.mask_cols)
        return state._replace(u_fac=u_fac[:n_users],
                              i_fac=i_fac[:n_items])


def _cdiv(a, b):
    return -(-a // b)
