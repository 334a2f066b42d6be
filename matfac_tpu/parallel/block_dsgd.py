"""Block-DSGD: the one-hot block engine nested inside mesh-sharded DSGD.

parallel/dsgd.py shards factor tables over a 1-D mesh and rotates item
blocks by `lax.ppermute` (Gemulla DSGD; modelMF.cpp:154-350), but its
per-shard inner update is the scatter engine, bound by its per-index
cost. This solver keeps the identical outer
structure (same rounds, same rotation, same disjointness) and replaces
each shard-round's inner sweep with the single-chip block engine's
DIAG schedule (ops/block_sgd_kernel.block_sweep_diag): the
(shard-users x item-block) cell is sub-blocked into (sub_bu x sub_bi)
cells, and each inner round batches SI axis-disjoint sub-cells into
one vmapped one-hot matmul group — per-shard throughput ≈ the
single-chip block engine instead of the scatter engine.

Layout:
  * users keep their CONTIGUOUS shard assignment (same ownership as
    DSGDShardedSolver) but are frequency-balanced WITHIN each shard
    block across its sub-blocks (rank r in the shard ->
    sub-block r % SU, slot r // SU) so power-law mass spreads evenly;
  * items are snake-balanced ACROSS shard blocks (parallel/dsgd.py
    balance_items) and interleaved within each block the same way;
  * streams are staged CELL-MAJOR: one [S] row per
    (shard, round, sub-cell) plus an all-invalid dummy row per
    shard-round, global shape [N, N, SU*SI + 1, S], sharded over the
    mesh axis so each shard holds only its own rounds. block_sweep_diag
    indexes rows by cell id (dummy lanes -> the last row).

Semantics: identical update math to BlockSGDSolver (sum of
within-batch gradients with optional collision normalization); the
outer rotation is identical to DSGDShardedSolver. Per-epoch randomness
= per-round random sub-row order / sub-cell order / batch offsets,
derived on-device from the epoch key (multi-host safe).

Multi-process staging (so the one-hot engine — not the scatter
fallback — carries modelMF.cpp:154-350's stratification on a real
multi-host pod): each process builds ONLY the (shard, round, cell)
rows of the user blocks whose shard lives on its addressable devices
and assembles the global stream with
jax.make_array_from_process_local_data (the parallel/dsgd.py
pattern). Three things keep staging process-independent:
  * entity frequencies (which define both permutations) are
    allgather-summed, so every process derives the SAME u_perm/i_perm
    even when it holds only its host-local rating rows;
  * the within-cell shuffle key is a splitmix64 hash of the GLOBAL
    (user, item) pair id — not a positional RNG stream — so a process
    staging any subset orders each cell identically;
  * the padded cell size S is allgather-maxed (dsgd.py pattern).
Caller contract: the MODEL's own statistics (freq tables behind
example_weight/pair_rank) must already be global — train_model
allgathers them before model construction; a hand-built model fed
host-local frequencies would stage inconsistent weights/ranks.

Limitation: Poisson-sampled ranks route to DSGD/SGD (block engines
stage static per-pair ranks — see BlockSGDSolver guard).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from matfac_tpu.config import Params
from matfac_tpu.models.base import MFState
from matfac_tpu.ops.block_sgd_kernel import block_sweep_diag


def _cdiv(a, b):
    return -(-a // b)


def _interleave_local(rank: np.ndarray, n_sub: int, sub: int
                      ) -> np.ndarray:
    """rank within a block (0 = most frequent) -> local id that
    round-robins frequency over the n_sub sub-blocks."""
    return (rank % n_sub) * sub + rank // n_sub


_MASK64 = (1 << 64) - 1


def _pair_hash(r: np.ndarray, c: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64-style hash of the global (user, item) pair id — the
    within-cell shuffle key. Depends only on pair identity (+ seed),
    never on how many elements this process staged, so any process
    staging any subset of a cell orders it identically."""
    x = (r.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + c.astype(np.uint64)
         + np.uint64((seed * 0x2545F4914F6CDD1D + 0x1234567) & _MASK64))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class BlockDSGDSolver:
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 mesh: Mesh, axis: str = "u", sub_bu: int = 384,
                 sub_bi: int = 384,
                 batch_size: Optional[int] = None,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True, pad_k: int = 0):
        """``batch_size=None`` = auto: size the minibatch so one
        sequential step of each shard's diag sweep carries ~64k
        ratings over its G = SI lanes (the dispatch-floor fix of
        solvers/block_sgd.py, PERF.md "Medium-scale dispatch floor"),
        fitted to the allgather-maxed cell size so every process picks
        the same value."""
        if model.use_bias or not model.use_factors:
            raise ValueError("BlockDSGDSolver is factor-only")
        if hasattr(model, "pair_lambda"):
            raise ValueError(
                "block engines stage static per-pair ranks; "
                f"{model.name} needs Poisson-sampled ranks — use "
                "DSGDShardedSolver")
        self.model = model
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.mm_bf16 = mm_bf16
        self.pad_k = max(int(pad_k), 0)
        if self.pad_k and self.pad_k < model.k:
            raise ValueError("pad_k must be >= fac_dim")
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None
                               else collision_norm)
        N = mesh.shape[axis]
        self.n_shards = N
        n_users, n_items = model.n_users, model.n_items
        # shard block sizes, rounded so sub-blocks tile exactly
        self.bu = _cdiv(_cdiv(n_users, N), sub_bu) * sub_bu
        self.bi = _cdiv(_cdiv(n_items, N), sub_bi) * sub_bi
        self.SU = self.bu // sub_bu
        self.SI = self.bi // sub_bi
        self.sub_bu, self.sub_bi = sub_bu, sub_bi
        self.n_users_pad = self.bu * N
        self.n_items_pad = self.bi * N

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        u_freq = np.bincount(r, minlength=n_users).astype(np.int64)
        i_freq = np.bincount(c, minlength=n_items).astype(np.int64)
        multiproc = jax.process_count() > 1
        if multiproc:
            # permutations below must agree across processes even when
            # each holds only its host-local rating rows: sum the local
            # frequency counts. (If every process holds the FULL matrix
            # the counts scale uniformly xP — same argsort order.)
            from jax.experimental import multihost_utils
            u_freq = multihost_utils.process_allgather(
                u_freq).sum(axis=0)
            i_freq = multihost_utils.process_allgather(
                i_freq).sum(axis=0)

        # ---- user permutation: contiguous shard ownership (old id //
        # ceil(n_users/N) like DSGD), frequency-interleaved locally ----
        own = np.minimum(np.arange(n_users) // _cdiv(n_users, N), N - 1)
        u_perm = np.empty(n_users, np.int64)
        for sh in range(N):
            ids = np.nonzero(own == sh)[0]
            rank = np.empty(len(ids), np.int64)
            rank[np.argsort(-u_freq[ids], kind="stable")] = \
                np.arange(len(ids))
            u_perm[ids] = sh * self.bu + _interleave_local(
                rank, self.SU, sub_bu)
        self.u_perm = u_perm

        # ---- item permutation: snake across shard blocks +
        # frequency interleave within each block ----
        order = np.argsort(-i_freq, kind="stable")
        blk = np.arange(n_items) % N
        pos = np.arange(n_items) // N
        snake_blk = np.where(pos % 2 == 1, N - 1 - blk, blk)
        i_perm = np.empty(n_items, np.int64)
        i_perm[order] = snake_blk * self.bi + _interleave_local(
            pos, self.SI, sub_bi)
        self.i_perm = i_perm

        self.u_perm_dev = jnp.asarray(u_perm.astype(np.int32))
        self.i_perm_dev = jnp.asarray(i_perm.astype(np.int32))
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[u_perm] = np.arange(n_users)
        i_inv = np.zeros(self.n_items_pad, np.int64)
        i_inv[i_perm] = np.arange(n_items)
        self.u_perm_inv_dev = jnp.asarray(u_inv.astype(np.int32))
        self.i_perm_inv_dev = jnp.asarray(i_inv.astype(np.int32))

        # ---- multi-process staging: each process keeps only the rows
        # of its addressable shards' user blocks (dsgd.py pattern) ----
        mesh_devs = np.asarray(mesh.devices).reshape(-1)
        proc = jax.process_index()
        self.local_blocks = [b for b in range(N)
                             if mesh_devs[b].process_index == proc]
        nb = len(self.local_blocks)
        r2 = u_perm[r]
        c2 = i_perm[c]
        sh = r2 // self.bu
        if multiproc:
            local = np.isin(sh, self.local_blocks)
            r, c, v = r[local], c[local], v[local]
            r2, c2, sh = r2[local], c2[local], sh[local]
        self.nnz = len(r)          # local nnz in multi-process runs

        # model hooks BEFORE relabeling
        w = np.asarray(model.example_weight(
            jnp.asarray(r.astype(np.int32)),
            jnp.asarray(c.astype(np.int32)))).astype(np.float32)
        if hasattr(model, "pair_rank"):
            lam = np.asarray(model.pair_rank(
                jnp.asarray(r.astype(np.int32)),
                jnp.asarray(c.astype(np.int32)))).astype(np.int32)
            self.use_mask = True
        else:
            lam = np.full(len(r), model.k, np.int32)
            self.use_mask = False

        ib = c2 // self.bi
        t = (ib - sh) % N
        su = (r2 % self.bu) // sub_bu
        si = (c2 % self.bi) // sub_bi
        blk_pos = np.full(N, -1, np.int64)
        blk_pos[self.local_blocks] = np.arange(nb)
        cell = ((blk_pos[sh] * N + t) * self.SU + su) * self.SI + si
        n_cells = nb * N * self.SU * self.SI
        counts = np.bincount(cell, minlength=n_cells)
        S = max(int(counts.max()), 1)
        if multiproc:
            # the padded cell size must agree across processes
            from jax.experimental import multihost_utils
            S = int(np.max(multihost_utils.process_allgather(
                np.asarray(S))))
        if batch_size is None:
            from matfac_tpu.solvers.block_sgd import auto_batch_size
            batch_size = auto_batch_size(S, self.SI)
        S = _cdiv(S, batch_size) * batch_size
        self.S = S
        self.bs = min(batch_size, S)
        self.pad_frac = n_cells * S / max(self.nnz, 1)

        u_loc = np.zeros((n_cells, S), np.int32)
        i_loc = np.zeros((n_cells, S), np.int32)
        vals = np.zeros((n_cells, S), np.float32)
        wts = np.zeros((n_cells, S), np.float32)
        lams = np.ones((n_cells, S), np.int32)
        # deterministic pseudo-random order within cells: one lexsort
        # (not a python loop over n_cells — N^2*SU*SI cells at scale)
        # keyed by the global pair hash so it is process-independent
        order = np.lexsort((_pair_hash(r2, c2, params.seed), cell))
        r2, c2, v, w, lam = (r2[order], c2[order], v[order], w[order],
                             lam[order])
        cell = cell[order]
        pos = np.arange(len(r2)) - np.searchsorted(cell, cell, "left")
        u_loc[cell, pos] = (r2 % sub_bu).astype(np.int32)
        i_loc[cell, pos] = (c2 % sub_bi).astype(np.int32)
        vals[cell, pos] = v
        wts[cell, pos] = w
        lams[cell, pos] = lam

        if self.collision_norm:
            from matfac_tpu.solvers.block_sgd import (
                stage_batch_collision_counts)
            cnu = stage_batch_collision_counts(wts, u_loc, self.bs,
                                               sub_bu)
            cni = stage_batch_collision_counts(wts, i_loc, self.bs,
                                               sub_bi)
        else:
            cnu = cni = wts

        # cell-major [N, N, SU*SI + 1, S] (dummy all-invalid last row
        # per shard-round, addressed by the diag schedule's pad lanes),
        # sharded over the mesh axis; multi-process runs assemble the
        # global array from each process's nb local shard blocks
        nc_sr = self.SU * self.SI
        sharding = NamedSharding(mesh, P(axis, None, None, None))

        def put(a, fill):
            a = a.reshape(nb, N, nc_sr, S)
            a = np.concatenate(
                [a, np.full((nb, N, 1, S), fill, a.dtype)], axis=2)
            if multiproc:
                return jax.make_array_from_process_local_data(
                    sharding, a, (N,) + a.shape[1:])
            return jax.device_put(jnp.asarray(a), sharding)

        self.u_loc = put(u_loc, 0)
        self.i_loc = put(i_loc, 0)
        self.vals = put(vals, 0)
        self.wts = put(wts, 0)
        self.lams = put(lams, 1)
        self.cnu = put(cnu, 1.0) if self.collision_norm else self.wts
        self.cni = put(cni, 1.0) if self.collision_norm else self.wts
        self._epoch = self._build_epoch()
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None

    # ------------------------------------------------------------------
    def _build_epoch(self, mode: str = "full"):
        """``mode`` isolates epoch phases for the scaling attribution
        (PERF.md "Virtual-mesh scaling curve", VERDICT r3 #7): "full" =
        the real epoch; "nopermute" = identical rounds with the
        ppermute replaced by identity (pure per-shard compute);
        "permuteonly" = rounds carry ONLY the item-block rotation
        (collective + loop overhead). comm fraction ~
        (full - nopermute) / full, cross-checked against permuteonly.
        Only "full" is ever used for training."""
        assert mode in ("full", "nopermute", "permuteonly")
        N = self.n_shards
        SU, SI, S, bs = self.SU, self.SI, self.S, self.bs
        sub_bu, sub_bi = self.sub_bu, self.sub_bi
        n_steps = S // bs
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        axis = self.axis
        mesh = self.mesh
        k_dim = self.pad_k or self.model.k
        kw = dict(bs=bs, bu=sub_bu, bi=sub_bi, NI=SI, u_reg=u_reg,
                  i_reg=i_reg, collision_norm=self.collision_norm,
                  use_mask=self.use_mask, mm_bf16=self.mm_bf16)
        from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule

        def diag_schedule(key):
            return device_diag_schedule(key, SU, SI, n_steps)

        def shard_epoch(u_fac, i_fac, u_loc, i_loc, vals, wts, cnu,
                        cni, lams, lr, key):
            streams = [x[0] for x in (u_loc, i_loc, vals, wts, cnu,
                                      cni, lams)]   # [N, SU*SI+1, S]
            me = jax.lax.axis_index(axis)
            # shard-local 3-D table views (+ dummy user sub-block)
            u3 = jnp.concatenate(
                [u_fac.reshape(SU, sub_bu, k_dim),
                 jnp.zeros((1, sub_bu, k_dim), jnp.float32)], axis=0)

            def round_body(t, carry):
                u3, i_blk, key = carry
                key, ks = jax.random.split(key)
                if mode != "permuteonly":
                    ub_idx, ib_idx, boff = diag_schedule(
                        jax.random.fold_in(ks, me))
                    st = [jax.lax.dynamic_index_in_dim(x, t, 0, False)
                          for x in streams]
                    i3 = i_blk.reshape(SI, sub_bi, k_dim)
                    u3, i3 = block_sweep_diag(
                        u3, i3, ub_idx, ib_idx, boff, lr,
                        st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                        ib_identity=True, **kw)
                    i_blk = i3.reshape(SI * sub_bi, k_dim)
                if mode != "nopermute":
                    i_blk = jax.lax.ppermute(
                        i_blk, axis,
                        [(j, (j - 1) % N) for j in range(N)])
                return (u3, i_blk, key)

            u3, i_fac, key = jax.lax.fori_loop(
                0, N, round_body, (u3, i_fac, key))
            u_fac = u3[:SU].reshape(SU * sub_bu, k_dim)
            return u_fac, i_fac

        fac_spec = P(axis, None)
        dat_spec = P(axis, None, None, None)
        mapped = jax.shard_map(
            shard_epoch, mesh=mesh,
            in_specs=(fac_spec, fac_spec) + (dat_spec,) * 7 + (P(), P()),
            out_specs=(fac_spec, fac_spec),
            check_vma=False)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(u_fac, i_fac, u_loc, i_loc, vals, wts, cnu, cni,
                  lams, lr, key):
            return mapped(u_fac, i_fac, u_loc, i_loc, vals, wts, cnu,
                          cni, lams, lr, key)

        return epoch

    # ------------------------------------------------------------------
    def _stage_factors(self, state: MFState):
        u = state.u_fac[self.u_perm_inv_dev].astype(jnp.float32)
        i = state.i_fac[self.i_perm_inv_dev].astype(jnp.float32)
        if self.pad_k > u.shape[1]:
            pad = self.pad_k - u.shape[1]
            u = jnp.pad(u, ((0, 0), (0, pad)))
            i = jnp.pad(i, ((0, 0), (0, pad)))
        sh = NamedSharding(self.mesh, P(self.axis, None))
        return jax.device_put(u, sh), jax.device_put(i, sh)

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            u_fac, i_fac = self._resident
        else:
            u_fac, i_fac = self._stage_factors(state)
        u_fac, i_fac = self._epoch(
            u_fac, i_fac, self.u_loc, self.i_loc, self.vals, self.wts,
            self.cnu, self.cni, self.lams, jnp.float32(lr), key)
        self._resident = (u_fac, i_fac)
        u_view = u_fac[self.u_perm_dev][:, : self.model.k]
        i_view = i_fac[self.i_perm_dev][:, : self.model.k]
        # store POST-cast arrays: a dtype-changing astype returns a new
        # object and a stale identity misses the resident cache every
        # epoch (the round-5 block_sgd.py fix, applied to the siblings)
        u_ret = u_view.astype(state.u_fac.dtype)
        i_ret = i_view.astype(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)


class DenseBlockDSGDSolver:
    """Row-dense stripes nested inside the DSGD rotation — the
    multi-chip vehicle for the round-4 headline engine.

    Outer structure = BlockDSGDSolver (users contiguous-sharded, items
    snake-balanced into N blocks, Gemulla rotation by `lax.ppermute`;
    modelMF.cpp:154-350 / util.cpp:1077-1107 semantics); the per-round
    inner sweep is the row-dense engine
    (ops/dense_block_kernel.cell_dense_update): each (user stripe x
    held item block) cell runs ONE masked-residual GD step on static
    dense rating/validity tiles — 3 full-width matmuls, no one-hots,
    no per-rating index streams. Update math identical to
    BlockSGDSolver(engine="dense") at batch = stripe-cell (README
    deviation #1).

    Dense tiles live sharded [N, N, SU, sub_bu, bi] (shard, round,
    stripe) — total HBM = the padded dense matrix, same as the
    single-chip dense engine, split over shards. Multi-process pods
    stage host-locally (round 5): each process densifies only the user
    blocks whose shard lives on its addressable devices and assembles
    the global tile array with make_array_from_process_local_data,
    with permutations / staging-ladder choices made process-independent
    by allgathered frequencies and allgather-agreed code scales (the
    BlockDSGDSolver pattern; 2-process bit-equality pinned in
    tests/test_parallel.py + tests/dense_bdsgd_worker.py). Rank-masked
    models route to the one-hot engines (same guard as BlockSGDSolver
    engine='dense')."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 mesh: Mesh, axis: str = "u",
                 sub_bu: Optional[int] = None,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True,
                 dense_budget_bytes: int = 8 << 30,
                 dense_codes: str = "auto"):
        if model.use_bias or not model.use_factors:
            raise ValueError("DenseBlockDSGDSolver is factor-only")
        if dense_codes not in ("auto", "codes", "off"):
            raise ValueError(f"unknown dense_codes {dense_codes!r}")
        if hasattr(model, "pair_lambda") or hasattr(model, "pair_rank"):
            raise ValueError(
                "dense engines do not support rank-masked/sampled "
                f"models; {model.name} -> BlockDSGDSolver or DSGD")
        self.model = model
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.mm_bf16 = mm_bf16
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None
                               else collision_norm)
        N = mesh.shape[axis]
        self.n_shards = N
        n_users, n_items = model.n_users, model.n_items
        if sub_bu is None:
            # >= 8 stripes per shard keeps the epoch SGD-like (batch =
            # stripe-cell; the same rule as the single-chip row engine,
            # solvers/block_sgd.py); 8-row quantum so tiny shards still
            # get their 8 stripes
            sub_bu = min(2560, max(
                _cdiv(_cdiv(n_users, 8 * N), 8) * 8, 8))
        self.sub_bu = sub_bu
        self.bu = _cdiv(_cdiv(n_users, N), sub_bu) * sub_bu
        self.SU = self.bu // sub_bu
        self.bi = _cdiv(_cdiv(n_items, N), 128) * 128
        self.n_users_pad = self.bu * N
        self.n_items_pad = self.bi * N
        slots = self.n_users_pad * self.n_items_pad
        if slots > dense_budget_bytes:        # 1 B/slot floor (codes)
            raise ValueError(
                f"dense DSGD tiles need >= {slots/2**30:.1f} GiB > "
                f"budget {dense_budget_bytes/2**30:.1f} GiB; use "
                "BlockDSGDSolver")

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        u_freq = np.bincount(r, minlength=n_users).astype(np.int64)
        i_freq = np.bincount(c, minlength=n_items).astype(np.int64)
        multiproc = jax.process_count() > 1
        if multiproc:
            # process-independent permutations from allgather-summed
            # frequencies (the BlockDSGDSolver pattern — each process
            # may hold only its host-local rating rows)
            from jax.experimental import multihost_utils
            u_freq = multihost_utils.process_allgather(
                u_freq).sum(axis=0)
            i_freq = multihost_utils.process_allgather(
                i_freq).sum(axis=0)

        # user permutation: contiguous shard ownership, frequency
        # round-robined over the SU stripes within each shard
        own = np.minimum(np.arange(n_users) // _cdiv(n_users, N), N - 1)
        u_perm = np.empty(n_users, np.int64)
        for sh in range(N):
            ids = np.nonzero(own == sh)[0]
            rank = np.empty(len(ids), np.int64)
            rank[np.argsort(-u_freq[ids], kind="stable")] = \
                np.arange(len(ids))
            u_perm[ids] = sh * self.bu + _interleave_local(
                rank, self.SU, sub_bu)
        self.u_perm = u_perm
        # item permutation: snake across shard blocks by frequency
        order = np.argsort(-i_freq, kind="stable")
        blk = np.arange(n_items) % N
        pos = np.arange(n_items) // N
        snake_blk = np.where(pos % 2 == 1, N - 1 - blk, blk)
        i_perm = np.empty(n_items, np.int64)
        i_perm[order] = snake_blk * self.bi + pos
        self.i_perm = i_perm

        self.u_perm_dev = jnp.asarray(u_perm.astype(np.int32))
        self.i_perm_dev = jnp.asarray(i_perm.astype(np.int32))
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[u_perm] = np.arange(n_users)
        i_inv = np.zeros(self.n_items_pad, np.int64)
        i_inv[i_perm] = np.arange(n_items)
        self.u_perm_inv_dev = jnp.asarray(u_inv.astype(np.int32))
        self.i_perm_inv_dev = jnp.asarray(i_inv.astype(np.int32))

        # multi-process: keep only the rows of the user blocks whose
        # shard lives on this process's addressable devices
        mesh_devs = np.asarray(mesh.devices).reshape(-1)
        proc = jax.process_index()
        self.local_blocks = [b for b in range(N)
                             if mesh_devs[b].process_index == proc]
        nb = len(self.local_blocks)
        r2 = u_perm[r]
        sh = r2 // self.bu
        if multiproc:
            local = np.isin(sh, self.local_blocks)
            r, c, v = r[local], c[local], v[local]
            r2, sh = r2[local], sh[local]
        self.nnz = len(r)          # local nnz in multi-process runs

        w = np.asarray(model.example_weight(
            jnp.asarray(r.astype(np.int32)),
            jnp.asarray(c.astype(np.int32)))).astype(np.float32)

        c2 = i_perm[c]
        t = (c2 // self.bi - sh) % N
        su = (r2 % self.bu) // sub_bu
        ul = r2 % sub_bu
        il = c2 % self.bi
        uniform01 = bool(np.all((w == 0.0) | (w == 1.0)))
        if multiproc:
            # the staging LADDER choice must agree across processes
            from jax.experimental import multihost_utils
            uniform01 = bool(np.all(multihost_utils.process_allgather(
                np.asarray(uniform01))))
        sharding = NamedSharding(mesh, P(axis, None, None, None, None))
        a32 = lambda x: jnp.asarray(x.astype(np.int32))

        # int8 rating-code tiles when the data is exactly star-grid
        # representable (1 B/slot; the ML-20M-on-a-mesh enabler — same
        # staging ladder as the single-chip engine,
        # solvers/block_sgd.rating_code_scale)
        from matfac_tpu.solvers.block_sgd import rating_code_scale
        want_codes = uniform01 and dense_codes in ("auto", "codes")
        if want_codes and dense_codes == "auto":
            # same measured speed policy as BlockSGDSolver: codes only
            # for traffic-bound or over-budget grids
            if slots < int(1.5e9) and slots * 3 <= dense_budget_bytes:
                want_codes = False
        self.r_scale = rating_code_scale(v) if want_codes else None
        if dense_codes == "codes" and self.r_scale is None \
                and not multiproc:
            raise ValueError(
                "dense_codes='codes' requires exactly star-grid-"
                "representable ratings with uniform 0/1 weights")
        if multiproc and want_codes:
            # the SCALE must agree across processes: allgather the
            # local candidates, take the min, re-verify locally at it
            from jax.experimental import multihost_utils
            gs = multihost_utils.process_allgather(np.asarray(
                np.nan if self.r_scale is None else self.r_scale))
            gmin = float(np.min(gs))
            ok = False
            if np.all(np.isfinite(gs)):
                codes = np.round(v.astype(np.float64) / gmin)
                ok = (len(codes) == 0
                      or (np.abs(codes).max() <= 127
                          and np.abs(codes).min() >= 1
                          and np.array_equal(
                              codes.astype(np.float32)
                              * np.float32(gmin), v)))
            ok = bool(np.all(multihost_utils.process_allgather(
                np.asarray(ok))))
            self.r_scale = gmin if ok else None

        def local5(a, fill, dtype):
            """[nb, N, SU, sub_bu, bi] host-local dense tiles."""
            blk_pos = np.full(N, -1, np.int64)
            blk_pos[self.local_blocks] = np.arange(nb)
            out = np.full((nb, N, self.SU, sub_bu, self.bi), fill,
                          dtype)
            out[blk_pos[sh], t, su, ul, il] = a
            return out

        if self.r_scale is not None:
            codes = np.round(v.astype(np.float64) / self.r_scale)
            if multiproc:
                # host-local densify + global assembly (the one-hot
                # engine's make_array_from_process_local_data pattern;
                # host RAM cost = the process's grid share)
                self.R_tiles = jax.make_array_from_process_local_data(
                    sharding, local5(codes.astype(np.int8), 0,
                                     np.int8),
                    (N, N, self.SU, sub_bu, self.bi))
            else:

                @functools.partial(jax.jit, out_shardings=sharding)
                def densify_c(sh_d, t_d, su_d, ul_d, il_d, code_d):
                    R = jnp.zeros((N, N, self.SU, sub_bu, self.bi),
                                  jnp.int8)
                    return R.at[sh_d, t_d, su_d, ul_d, il_d].add(code_d)

                self.R_tiles = densify_c(
                    a32(sh), a32(t), a32(su), a32(ul), a32(il),
                    jnp.asarray(codes.astype(np.int8)))
            self.W_tiles = None
        else:
            wdtype = jnp.int8 if uniform01 else jnp.bfloat16
            if slots * 3 > dense_budget_bytes:    # bf16 R + int8 W
                raise ValueError(
                    f"dense DSGD tiles need {slots*3/2**30:.1f} GiB > "
                    f"budget {dense_budget_bytes/2**30:.1f} GiB; use "
                    "BlockDSGDSolver")
            if multiproc:
                import ml_dtypes
                shape5 = (N, N, self.SU, sub_bu, self.bi)
                self.R_tiles = jax.make_array_from_process_local_data(
                    sharding,
                    local5(v.astype(ml_dtypes.bfloat16), 0,
                           ml_dtypes.bfloat16), shape5)
                wnp = (np.int8 if wdtype == jnp.int8
                       else ml_dtypes.bfloat16)
                self.W_tiles = jax.make_array_from_process_local_data(
                    sharding, local5(w.astype(wnp), 0, wnp), shape5)
            else:

                @functools.partial(jax.jit,
                                   out_shardings=(sharding, sharding))
                def densify(sh_d, t_d, su_d, ul_d, il_d, v_d, w_d):
                    shape = (N, N, self.SU, sub_bu, self.bi)
                    R = jnp.zeros(shape, jnp.bfloat16)
                    W = jnp.zeros(shape, wdtype)
                    R = R.at[sh_d, t_d, su_d, ul_d, il_d].add(
                        v_d.astype(jnp.bfloat16))
                    W = W.at[sh_d, t_d, su_d, ul_d, il_d].add(
                        w_d.astype(wdtype))
                    return R, W

                self.R_tiles, self.W_tiles = densify(
                    a32(sh), a32(t), a32(su), a32(ul), a32(il),
                    jnp.asarray(v.astype(np.float32)),
                    jnp.asarray(w))
        self._epoch = self._build_epoch()
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None

    # ------------------------------------------------------------------
    def _build_epoch(self, mode: str = "full"):
        """``mode``: "full" | "nopermute" | "permuteonly" — the same
        phase-attribution variants as BlockDSGDSolver (scaling curve
        --phase-split); only "full" trains."""
        assert mode in ("full", "nopermute", "permuteonly")
        N = self.n_shards
        SU, sub_bu, bi = self.SU, self.sub_bu, self.bi
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        axis = self.axis
        mesh = self.mesh
        k_dim = self.model.k
        collision = self.collision_norm
        mm_dtype = jnp.bfloat16 if self.mm_bf16 else jnp.float32
        r_scale = self.r_scale
        from matfac_tpu.ops.dense_block_kernel import cell_dense_update

        def shard_epoch(u_fac, i_fac, R_tiles, W_tiles, lr, key):
            R_t = R_tiles[0]                     # [N, SU, sub_bu, bi]
            W_t = None if W_tiles is None else W_tiles[0]
            me = jax.lax.axis_index(axis)
            u3 = u_fac.reshape(SU, sub_bu, k_dim)

            def round_body(t, carry):
                u3, i_blk, key = carry
                key, ks = jax.random.split(key)
                if mode != "permuteonly":
                    sperm = jax.random.permutation(
                        jax.random.fold_in(ks, me), SU)

                    def stripe(s, c2):
                        u3, I = c2
                        su = sperm[s]
                        U, I = cell_dense_update(
                            u3[su], I, R_t[t, su],
                            None if W_t is None else W_t[t, su],
                            jnp.asarray(lr, jnp.float32), u_reg, i_reg,
                            collision, mm_dtype, r_scale=r_scale)
                        return (u3.at[su].set(U), I)

                    u3, i_blk = jax.lax.fori_loop(0, SU, stripe,
                                                  (u3, i_blk))
                if mode != "nopermute":
                    i_blk = jax.lax.ppermute(
                        i_blk, axis,
                        [(j, (j - 1) % N) for j in range(N)])
                return (u3, i_blk, key)

            u3, i_fac, key = jax.lax.fori_loop(
                0, N, round_body, (u3, i_fac, key))
            return u3.reshape(SU * sub_bu, k_dim), i_fac

        fac_spec = P(axis, None)
        dat_spec = P(axis, None, None, None, None)
        mapped = jax.shard_map(
            shard_epoch, mesh=mesh,
            in_specs=(fac_spec, fac_spec, dat_spec, dat_spec, P(), P()),
            out_specs=(fac_spec, fac_spec),
            check_vma=False)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(u_fac, i_fac, R_tiles, W_tiles, lr, key):
            return mapped(u_fac, i_fac, R_tiles, W_tiles, lr, key)

        return epoch

    # ------------------------------------------------------------------
    def _stage_factors(self, state: MFState):
        u = state.u_fac[self.u_perm_inv_dev].astype(jnp.float32)
        i = state.i_fac[self.i_perm_inv_dev].astype(jnp.float32)
        sh = NamedSharding(self.mesh, P(self.axis, None))
        return jax.device_put(u, sh), jax.device_put(i, sh)

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            u_fac, i_fac = self._resident
        else:
            u_fac, i_fac = self._stage_factors(state)
        u_fac, i_fac = self._epoch(u_fac, i_fac, self.R_tiles,
                                   self.W_tiles, jnp.float32(lr), key)
        self._resident = (u_fac, i_fac)
        u_view = u_fac[self.u_perm_dev]
        i_view = i_fac[self.i_perm_dev]
        # POST-cast identity (see BlockDSGDSolver.epoch note)
        u_ret = u_view.astype(state.u_fac.dtype)
        i_ret = i_view.astype(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)
