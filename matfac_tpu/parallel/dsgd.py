"""Sharded DSGD: block-stratified SGD over a device mesh.

The mesh re-design of the reference's shared-memory DSGD
(ModelMF::trainSGDPar, modelMF.cpp:154-350 + the Latin-square block
schedule sgdUpdateBlockSeq, util.cpp:1077-1107), mapped to hardware the
way SURVEY.md §2/§7 prescribes:

  * uFac and iFac are row-sharded into N contiguous blocks over a 1-D
    mesh axis; shard i permanently owns user block i.
  * Ratings are pre-partitioned host-side into the N x N (user-block,
    item-block) grid. An epoch is N rounds; in round t shard i processes
    grid block (i, (i+t) mod N) — every shard touches a DISJOINT item
    block each round (the diagonal rotation = the reference's random
    Latin square, with identical coverage).
  * Between rounds each shard passes its item block to its left
    neighbor with `jax.lax.ppermute` — the only communication
    in the epoch. No gradient all-reduce, no parameter server: updates
    are always local to the shard that currently owns the rows.

Per-example IFWMF weights and TMF/Poisson ranks are precomputed into the
staged stream (they are static per (u, i) pair), so all SGD model
families run through this engine. Caller contract (multi-process): the
model's own statistics (freq tables behind example_weight/pair_rank)
must be GLOBAL — train_model allgathers them before model
construction; a model fed host-local frequencies would stage
inconsistent weights/ranks across processes.
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


def _cdiv(a, b):
    return -(-a // b)


class DSGDShardedSolver:
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 mesh: Mesh, axis: str = "u",
                 batch_size: Optional[int] = None,
                 balance_items: bool = False):
        """``balance_items``: relabel items so frequency is spread evenly
        across item blocks (round-robin over descending train frequency)
        — the power-law hot-spot mitigation of SURVEY.md §7. The item
        permutation is applied to iFac rows on entry/exit of each epoch
        (two row gathers of [n_items, k] — negligible vs the stream)."""
        self.model = model
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        N = self.n_shards
        n_users, n_items = model.n_users, model.n_items
        self.bu = _cdiv(n_users, N)
        self.bi = _cdiv(n_items, N)
        self.n_users_pad = self.bu * N
        self.n_items_pad = self.bi * N

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        self.item_perm = None
        if balance_items:
            freq = np.bincount(c, minlength=n_items)
            order = np.argsort(-freq, kind="stable")
            # round-robin blocks, snake order to balance within-block sums
            perm = np.empty(n_items, np.int64)   # old id -> new id
            pos_in_block = np.arange(n_items) // N
            blk = np.arange(n_items) % N
            snake = np.where(pos_in_block % 2 == 1, N - 1 - blk, blk)
            perm[order] = snake * self.bi + pos_in_block
            self.item_perm = perm.astype(np.int32)
            self.item_perm_dev = jnp.asarray(self.item_perm)
            inv = np.empty_like(self.item_perm)
            inv[self.item_perm] = np.arange(n_items, dtype=np.int32)
            self.item_perm_inv_dev = jnp.asarray(inv)
        # static per-example weight / rank from the model hooks —
        # computed on ORIGINAL item ids, BEFORE any balance relabeling
        # (the model's freq/rank/pop tables are in original ids; the
        # pre-r3 ordering fed relabeled ids to the hooks under
        # balance_items, silently swapping hot/tail weights — review r3)
        w = np.asarray(model.example_weight(jnp.asarray(r.astype(np.int32)),
                                            jnp.asarray(c.astype(np.int32))))
        self.sample_poisson = model.name == "tmf_dropout"
        if (getattr(model, "stochastic_rank", False)
                and not self.sample_poisson):
            # this engine samples Poisson ranks in-kernel but stages
            # everything else STATIC; an adaptive-dropout model here
            # would silently train deterministic truncation
            raise ValueError(
                f"{model.name} samples non-Poisson update ranks — "
                "train it on the single-device sgd engine")
        if self.sample_poisson:
            # Poisson rate per pair; sampled inside the kernel each epoch
            lam = np.asarray(model.pair_lambda(
                jnp.asarray(r.astype(np.int32)),
                jnp.asarray(c.astype(np.int32)))).astype(np.int32)
        elif hasattr(model, "pair_rank"):
            lam = np.asarray(model.pair_rank(
                jnp.asarray(r.astype(np.int32)),
                jnp.asarray(c.astype(np.int32)))).astype(np.int32)
        else:
            lam = np.full(len(r), model.k, np.int32)
        if self.item_perm is not None:
            c = self.item_perm[c]

        ub = r // self.bu            # owning shard of the user row
        ib = c // self.bi            # item block
        rnd = (ib - ub) % N          # round in which this entry is live

        # ---- multi-host staging (SURVEY §7 step 5) ----
        # Each process builds ONLY the (user-block, round) cells whose
        # shard lives on one of its addressable devices, so no host ever
        # holds the full staged stream. In a multi-process run the
        # caller may pass either the full matrix or just its host-local
        # rows (parallel.distributed.host_local_ratings) — out-of-block
        # rows are dropped here either way.
        mesh_devs = np.asarray(mesh.devices).reshape(-1)
        proc = jax.process_index()
        self.local_blocks = [b for b in range(N)
                             if mesh_devs[b].process_index == proc]
        multiproc = jax.process_count() > 1
        local = np.isin(ub, self.local_blocks)
        r, c, v, w, lam = r[local], c[local], v[local], w[local], lam[local]
        ub, ib, rnd = ub[local], ib[local], rnd[local]
        self.nnz = len(r)          # local nnz in multi-process runs

        bs = batch_size or params.batch_size
        counts = np.zeros((N, N), np.int64)
        np.add.at(counts, (ub, rnd), 1)
        S = max(int(counts.max()), 1)
        if multiproc:
            # the staged cell size must agree across processes
            from jax.experimental import multihost_utils
            S = int(np.max(multihost_utils.process_allgather(
                np.asarray(S))))
        S = _cdiv(S, bs) * bs if S > bs else bs
        self.S = S
        self.bs = min(bs, S)
        nb = len(self.local_blocks)
        blk_pos = {b: j for j, b in enumerate(self.local_blocks)}
        ub_loc = np.vectorize(blk_pos.__getitem__, otypes=[np.int64])(
            ub) if len(ub) else ub
        u_loc = np.zeros((nb, N, S), np.int32)
        i_loc = np.zeros((nb, N, S), np.int32)
        vals = np.zeros((nb, N, S), np.float32)
        wts = np.zeros((nb, N, S), np.float32)    # 0 weight = padding
        lams = np.ones((nb, N, S), np.int32)
        order = np.lexsort((rnd, ub))
        r, c, v, w, lam = r[order], c[order], v[order], w[order], lam[order]
        ub, ib, rnd = ub[order], ib[order], rnd[order]
        ub_loc = ub_loc[order] if len(ub) else ub
        # position within each (shard, round) group
        grp = ub * N + rnd
        pos = np.arange(len(r)) - np.searchsorted(grp, grp, side="left")
        u_loc[ub_loc, rnd, pos] = (r - ub * self.bu).astype(np.int32)
        i_loc[ub_loc, rnd, pos] = (c - ib * self.bi).astype(np.int32)
        vals[ub_loc, rnd, pos] = v
        wts[ub_loc, rnd, pos] = w
        lams[ub_loc, rnd, pos] = lam
        # static shuffle within every cell: the stream is user-sorted and
        # an unshuffled minibatch holds whole user rows -> scatter-add
        # collisions blow up the effective step. Per-epoch randomness is
        # then a cheap random rotation (no full device sort per
        # epoch). The rng is seeded PER CELL so
        # any process staging any subset builds identical cells.
        for j, b in enumerate(self.local_blocks):
            for t_s in range(N):
                cnt = int(counts[b, t_s])
                if cnt > 1:
                    rng = np.random.default_rng(
                        self.params.seed * 1000003 + b * N + t_s + 17)
                    p = rng.permutation(cnt)
                    for arr in (u_loc, i_loc, vals, wts, lams):
                        arr[j, t_s, :cnt] = arr[j, t_s, :cnt][p]

        sh = NamedSharding(mesh, P(axis, None, None))
        if multiproc:
            put = lambda a: jax.make_array_from_process_local_data(
                sh, a, (N,) + a.shape[1:])
        else:
            put = lambda a: jax.device_put(jnp.asarray(a), sh)
        self.u_loc = put(u_loc)
        self.i_loc = put(i_loc)
        self.vals = put(vals)
        self.wts = put(wts)
        self.lams = put(lams)
        self._epoch = self._build_epoch()
        # epoch-resident factor layout (see epoch())
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None

    # ------------------------------------------------------------------
    def _build_epoch(self, mode: str = "full"):
        """``mode``: "full" (training), "nopermute" (rounds without the
        item-block rotation — pure per-shard compute), "permuteonly"
        (rotation only) — the phase-attribution variants for the
        scaling curve (scripts/scaling_curve.py --phase-split)."""
        assert mode in ("full", "nopermute", "permuteonly")
        N = self.n_shards
        S, bs = self.S, self.bs
        k = self.model.k
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        axis = self.axis
        mesh = self.mesh
        sample_poisson = self.sample_poisson
        n_steps = S // bs

        def shard_epoch(u_fac, i_fac, u_loc, i_loc, vals, wts, lams,
                        lr, key):
            # leading shard dim of staged arrays is 1 inside shard_map
            u_loc, i_loc = u_loc[0], i_loc[0]
            vals, wts, lams = vals[0], wts[0], lams[0]
            me = jax.lax.axis_index(axis)

            def round_body(t, carry):
                u_fac, i_fac_blk, key = carry
                # per-epoch randomness: random batch-START rotation of
                # the statically-shuffled cell stream, batch-granular so
                # stream access stays contiguous slices (element-level
                # index math costs scalar-gather passes — solvers/sgd.py)
                key, pk = jax.random.split(key)
                boff = jax.random.randint(pk, (), 0, n_steps)

                def batch_body(s, inner):
                    u_fac, i_fac_blk, key = inner
                    start = ((s + boff) % n_steps) * bs
                    sl = lambda a: jax.lax.dynamic_slice_in_dim(
                        a[t], start, bs)
                    u = sl(u_loc)
                    i = sl(i_loc)
                    r = sl(vals)
                    w = sl(wts)
                    lam = sl(lams)
                    if sample_poisson:
                        key, sk = jax.random.split(key)
                        rank = jnp.clip(jax.random.poisson(
                            sk, lam.astype(jnp.float32)).astype(jnp.int32),
                            1, k)
                    else:
                        rank = lam
                    iota = jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
                    m = (iota < rank[:, None]).astype(u_fac.dtype)
                    pu = u_fac[u]
                    qi = i_fac_blk[i]
                    pred = jnp.einsum("ek,ek->e", pu * m, qi,
                                      preferred_element_type=jnp.float32)
                    diff = r - pred
                    vmask = (w > 0).astype(u_fac.dtype)
                    gu = (-2.0 * (w * diff)[:, None] * qi
                          + 2.0 * u_reg * vmask[:, None] * pu) * m
                    gi = (-2.0 * (w * diff)[:, None] * pu
                          + 2.0 * i_reg * vmask[:, None] * qi) * m
                    u_fac = u_fac.at[u].add((-lr * gu).astype(u_fac.dtype))
                    i_fac_blk = i_fac_blk.at[i].add(
                        (-lr * gi).astype(i_fac_blk.dtype))
                    return (u_fac, i_fac_blk, key)

                if mode != "permuteonly":
                    u_fac, i_fac_blk, key = jax.lax.fori_loop(
                        0, n_steps, batch_body, (u_fac, i_fac_blk, key))
                # pass the item block to the left neighbor:
                # shard i held block (i+t); next round it needs (i+t+1),
                # currently held by shard i+1
                if mode != "nopermute":
                    i_fac_blk = jax.lax.ppermute(
                        i_fac_blk, axis,
                        [(j, (j - 1) % N) for j in range(N)])
                return (u_fac, i_fac_blk, key)

            u_fac, i_fac, key = jax.lax.fori_loop(
                0, N, round_body, (u_fac, i_fac, key))
            return u_fac, i_fac

        fac_spec = P(axis, None)
        dat_spec = P(axis, None, None)
        mapped = jax.shard_map(
            shard_epoch, mesh=mesh,
            in_specs=(fac_spec, fac_spec, dat_spec, dat_spec, dat_spec,
                      dat_spec, dat_spec, P(), P()),
            out_specs=(fac_spec, fac_spec),
            check_vma=False)

        # staged arrays are jit ARGUMENTS: closure capture would embed
        # them as HLO constants (compile blowup at scale, CLAUDE.md) and
        # is illegal for multi-process global arrays
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(u_fac, i_fac, u_loc, i_loc, vals, wts, lams, lr, key):
            return mapped(u_fac, i_fac, u_loc, i_loc, vals, wts, lams,
                          lr, key)

        return epoch

    # ------------------------------------------------------------------
    def _stage_factors(self, state: MFState):
        """Logical factors -> padded / item-permuted / mesh-sharded."""
        n_users = state.u_fac.shape[0]
        n_items = state.i_fac.shape[0]
        pu = self.n_users_pad - n_users
        pi = self.n_items_pad - n_items
        u_fac = jnp.pad(state.u_fac, ((0, pu), (0, 0))) if pu else state.u_fac
        i_fac = state.i_fac
        if self.item_perm is not None:
            # reorder rows into balanced-label space: new row p[i] = old i
            i_fac = i_fac[self.item_perm_inv_dev]
        i_fac = jnp.pad(i_fac, ((0, pi), (0, 0))) if pi else i_fac
        u_sh = NamedSharding(self.mesh, P(self.axis, None))
        return jax.device_put(u_fac, u_sh), jax.device_put(i_fac, u_sh)

    def _logical_view(self, u_fac, i_fac, n_users: int, n_items: int):
        if self.n_users_pad != n_users:
            u_fac = u_fac[:n_users]
        i_view = i_fac
        if self.n_items_pad != n_items:
            i_view = i_view[:n_items]
        if self.item_perm is not None:
            i_view = i_view[self.item_perm_dev]
        return u_fac, i_view

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        """The sharded factors stay RESIDENT in the padded/permuted
        layout across epochs (VERDICT r1 weak #3: round 1 re-padded and
        re-device_put both tables every call); staging happens only on
        the first epoch or when the caller hands back a state we did not
        produce (e.g. after a NaN rollback to a snapshot)."""
        n_users = state.u_fac.shape[0]
        n_items = state.i_fac.shape[0]
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            u_fac, i_fac = self._resident
        else:
            u_fac, i_fac = self._stage_factors(state)
        u_fac, i_fac = self._epoch(u_fac, i_fac, self.u_loc, self.i_loc,
                                   self.vals, self.wts, self.lams,
                                   jnp.float32(lr), key)
        self._resident = (u_fac, i_fac)
        u_view, i_view = self._logical_view(u_fac, i_fac, n_users,
                                            n_items)
        self._last_u_view, self._last_i_view = u_view, i_view
        return state._replace(u_fac=u_view, i_fac=i_view)
