"""Cell-blocked SGD solver — host staging for ops/block_sgd_kernel and
ops/dense_block_kernel.

Single-device engine with the same update semantics as SGDSolver (per
modelMF.cpp:83-105 + optional collision normalization) but restructured
into (user-block x item-block) cells, so each minibatch runs its
gathers/scatters as one-hot matmuls against the cell's factor blocks
(engine="xla"), or each cell runs one dense masked-residual step
(engine="dense").

Users and items are RELABELED (round-robin over descending train
frequency, snake order) so the power-law mass spreads evenly over
blocks — this bounds the padded cell size S (cells are padded to the
max cell population). The relabeling permutations are applied to the
factor tables on entry and undone on exit; tables stay resident in the
relabeled/padded layout across epochs (same pattern as
parallel/dsgd.py).

Supports plain MF, IFWMF weights and deterministic TMF rank masks
(static per pair, staged with the stream). Poisson-sampled ranks and
bias models route to SGDSolver instead.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.models.base import MFState
from matfac_tpu.ops.block_sgd_kernel import (block_sgd_epoch_diag_keyed,
                                             block_sgd_epoch_xla)
from matfac_tpu.ops.dense_block_kernel import (dense_epoch_diag_keyed,
                                               dense_epoch_rows_keyed,
                                               densify_rows_host)


def _cdiv(a, b):
    return -(-a // b)


def auto_batch_size(s0: int, lanes: int, target_ratings: int = 65536,
                    quantum: int = 256) -> int:
    """Size a diag-schedule minibatch so one sequential step carries
    ~``target_ratings`` across its ``lanes`` parallel cells — below
    that, the fixed cost of each sequential loop step dominates small
    shapes.
    Fitted to the max cell size ``s0`` so padding stays minimal; the
    per-lane target is clamped to [1024, 8192] and the result rounds
    to the ``quantum`` (so tiny cells can land below 1024). Shared by
    BlockSGDSolver and parallel/block_dsgd.py — keep the engines'
    sizing identical."""
    per_lane = min(max(target_ratings // max(lanes, 1), 1024), 8192)
    n_steps = max(_cdiv(s0, per_lane), 1)
    return _cdiv(_cdiv(s0, n_steps), quantum) * quantum


def stage_batch_collision_counts(wts: np.ndarray, loc: np.ndarray,
                                 bs: int, width: int) -> np.ndarray:
    """max(within-batch same-entity valid count, 1) divisors for a
    staged stream [n_cells, S]. Batch CONTENTS are static (fixed
    bs-slices of each cell; only batch order is random), so the counts
    are host-precomputable — counting on-device cost four extra thin
    one-hot matmuls per step (PERF.md). Shared by BlockSGDSolver and
    parallel/block_dsgd.py, whose update semantics must stay
    identical."""
    n_cells, S = wts.shape
    valid = (wts > 0).ravel().astype(np.float64)
    batch_id = np.arange(n_cells * S, dtype=np.int64) // bs
    key = batch_id * np.int64(width) + loc.ravel()
    _, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv, weights=valid)[inv]
    return np.maximum(cnt, 1.0).astype(np.float32).reshape(n_cells, S)


def rating_code_scale(vals: np.ndarray) -> Optional[float]:
    """Exact int8 rating-code scale for ``vals``, or None.

    Returns g such that every rating equals code * g EXACTLY in f32
    with integer code, 1 <= |code| <= 127 (code 0 is reserved for
    "unrated" — validity derives from it, so zero-valued ratings
    disqualify the mode). Star data (0.5..5.0 step 0.5 or 1..5) always
    qualifies; continuous synthetic ratings never do. Candidates tried:
    the smallest |rating| and the smallest gap between distinct
    |rating|s (covers non-contiguous grids like {2, 3, 5})."""
    v = np.asarray(vals, np.float32)
    if len(v) == 0 or np.any(v == 0) or not np.all(np.isfinite(v)):
        return None
    mags = np.unique(np.abs(v)).astype(np.float64)
    cands = {float(mags[0])}
    if len(mags) > 1:
        cands.add(float(np.diff(mags).min()))
    for g in sorted(cands, reverse=True):
        if g <= 0:
            continue
        codes = np.round(v.astype(np.float64) / g)
        if np.abs(codes).max() > 127 or np.abs(codes).min() < 1:
            continue
        if np.array_equal(
                (codes.astype(np.float32) * np.float32(g)), v):
            return g
    return None


def _balance_perm(freq: np.ndarray, n: int, n_blocks: int,
                  block: int) -> np.ndarray:
    """old id -> new id; round-robin blocks over descending frequency,
    snake order (parallel/dsgd.py balance_items)."""
    order = np.argsort(-freq, kind="stable")
    perm = np.empty(n, np.int64)
    pos_in_block = np.arange(n) // n_blocks
    blk = np.arange(n) % n_blocks
    snake = np.where(pos_in_block % 2 == 1, n_blocks - 1 - blk, blk)
    perm[order] = snake * block + pos_in_block
    return perm


class BlockSGDSolver:
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 batch_size: Optional[int] = 256,
                 bu: Optional[int] = 1024, bi: Optional[int] = 1024,
                 collision_norm: Optional[bool] = None,
                 mm_bf16: bool = True,
                 engine: str = "xla", schedule: str = "row",
                 pad_k: int = 0,
                 dense_budget_bytes: int = 8 << 30,
                 dense_codes: str = "auto"):
        """``engine``: "xla" (default — the one-hot matmul epoch of
        ops/block_sgd_kernel.py) or "dense" (below).

        ``batch_size=None`` = auto (diag schedule): size the minibatch
        so one sequential step carries ~64k ratings across its G = NI
        lanes — below that, the fixed cost of each sequential step
        dominates the epoch at small shapes. Bounded to [1024, 8192]
        and fitted to the max cell size so padding stays minimal.

        ``schedule``: "row" (user-block rows processed sequentially,
        item blocks swept within a row) or "diag" (Gemulla DSGD rounds
        — NI axis-disjoint cells per round batched into one vmapped
        one-hot matmul group). "diag" keeps the matmuls wide at small
        bu/bi where per-rating FLOP is lower.

        ``pad_k``: if > fac_dim, stage the factor tables zero-padded to
        this width. EXACTLY equivalent to training at fac_dim (a zero
        column has zero prediction contribution and zero gradient —
        the data term is ∝ qi=0 and the reg term ∝ pu=0 — so it stays
        zero); the one-hot matmuls then run at the padded width. The
        dense engine ignores it (its FLOP is ∝ k, so padding is NOT
        free there).

        ``engine="dense"``: per-cell masked-residual GD on dense
        [bu, bi] rating/weight tiles (ops/dense_block_kernel.py) —
        the same update as schedule="diag" at batch = cell, with no
        one-hots at all. Requires the padded dense tiles to fit
        ``dense_budget_bytes`` of HBM; rank-masked models stay on the
        one-hot engines. Pass bu/bi=None to auto-size blocks (square
        cell grid: NU ≈ NI minimizes the round count).

        ``dense_codes``: int8 rating CODES — 1 B/slot, validity
        derived from code != 0 — for ratings EXACTLY representable as
        code * scale (star data; rating_code_scale proves it per
        dataset) with uniform-0/1 weights; this is what puts the
        ML-20M dense grid (11.4 GiB at bf16+int8) inside the
        default budget at ~3.8 GiB. "auto" (default) takes codes
        only when float tiles miss the budget or the grid is large
        (>= 1.5e9 slots, where reading 1 B instead of 3 B per slot
        should pay for the int8 decode). "codes" forces them (error when
        not representable). "off" always stages float tiles. "lossy"
        additionally quantizes non-representable ratings to 127 signed
        levels of max|r|/127 (absolute error <= scale/2, except
        near-zero ratings clamped to ±1 code so none is dropped —
        error <= scale there); training math is otherwise identical
        (modelMF.cpp:83-105)."""
        if schedule not in ("row", "diag"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if engine not in ("xla", "dense"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "dense":
            schedule = "diag"  # dense reuses the diag round schedule
        self.schedule = schedule
        if model.use_bias or not model.use_factors:
            raise ValueError("BlockSGDSolver is factor-only")
        from matfac_tpu.models.base import ModelMF as _MF
        if type(model).update_side_masks is not _MF.update_side_masks:
            # mf_loc/mf_freq gate the user/item updates per side; this
            # engine applies one pair mask to both sides
            raise ValueError("per-side update gates need SGDSolver")
        self.model = model
        self.params = params
        self.engine = engine
        self.mm_bf16 = mm_bf16
        self.pad_k = max(int(pad_k), 0)
        if self.pad_k and self.pad_k < model.k:
            raise ValueError("pad_k must be >= fac_dim")
        self.collision_norm = (params.sgd_collision_norm
                               if collision_norm is None
                               else collision_norm)
        n_users, n_items = model.n_users, model.n_items
        k = model.k
        if engine == "dense":
            # ROW-stripe layout by default: bi = the full padded
            # catalog width (NI = 1), so each round moves one stripe by
            # dynamic-slice and runs full-width matmuls instead of a
            # per-round vector gather of scattered cells. Pass bi <
            # width explicitly to get the diag cell grid back.
            if bi is None:
                bi = _cdiv(n_items, 128) * 128
            if bu is None:
                # >=8 stripes keeps the epoch SGD-like (per-round
                # batch = stripe); 2560 caps the [bu, ni_pad] f32
                # residual intermediates at ~200 MB. Prefer a 256-row
                # quantum for matmul-friendly stripe heights, falling
                # to an 8-row quantum only when 256 would starve the
                # stripe count (a 256 floor collapsed <2k-user
                # problems to full-batch GD — near-frozen learning at
                # SGD learn rates)
                target = _cdiv(n_users, 8 * _cdiv(n_items, bi))
                bu = min(2560, max(_cdiv(target, 256) * 256, 256))
                if _cdiv(n_users, bu) < 8:
                    bu = min(2560, max(_cdiv(target, 8) * 8, 8))
            self.pad_k = 0  # dense FLOP is ∝ k: padding is not free
            if dense_codes not in ("auto", "codes", "off", "lossy"):
                raise ValueError(f"unknown dense_codes {dense_codes!r}")
        else:
            if bu is None:
                bu = 1024
            if bi is None:
                bi = 1024
        self.dense_codes = dense_codes if engine == "dense" else "off"
        self.r_scale = None
        self.bu, self.bi = bu, bi
        self.NU = _cdiv(n_users, bu)
        self.NI = _cdiv(n_items, bi)
        self.n_users_pad = self.NU * bu
        self.n_items_pad = self.NI * bi

        r, c, v = train_mat.to_coo()
        keep = ~invalid_users[r] & ~invalid_items[c]
        r, c, v = r[keep], c[keep], v[keep]
        self.nnz = len(r)

        # frequency-balanced relabeling of BOTH axes
        u_freq = np.bincount(r, minlength=n_users)
        i_freq = np.bincount(c, minlength=n_items)
        self.u_perm = _balance_perm(u_freq, n_users, self.NU, bu)
        self.i_perm = _balance_perm(i_freq, n_items, self.NI, bi)
        self.u_perm_dev = jnp.asarray(self.u_perm.astype(np.int32))
        self.i_perm_dev = jnp.asarray(self.i_perm.astype(np.int32))
        # inverse over the PADDED label space (perm image is a
        # non-contiguous subset of [0, n_pad)); rows outside the image
        # are dead padding and read row 0 harmlessly
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[self.u_perm] = np.arange(n_users)
        i_inv = np.zeros(self.n_items_pad, np.int64)
        i_inv[self.i_perm] = np.arange(n_items)
        self.u_perm_inv_dev = jnp.asarray(u_inv.astype(np.int32))
        self.i_perm_inv_dev = jnp.asarray(i_inv.astype(np.int32))

        # model hooks BEFORE relabeling (freq tables are in old ids)
        # Poisson TMF (pair_lambda + entity_lambdas): the dense ROW
        # engine resamples entity ranks per stripe visit with per-round
        # common-random-number quantiles — the reference's exact
        # per-update rank marginal (dense_sweep_rows docstring; README
        # deviation #15). Every other engine/path stages STATIC ranks,
        # so routing a sampled-rank model there would silently train
        # the deterministic variant.
        self._pois = (engine == "dense"
                      and hasattr(model, "pair_lambda")
                      and hasattr(model, "entity_lambdas"))
        if self._pois and self.NI != 1:
            raise ValueError("Poisson-resampled dense needs the row "
                             "layout (bi=None)")
        if (hasattr(model, "pair_lambda") or getattr(
                model, "stochastic_rank", False)) and not self._pois:
            raise ValueError(
                "block-SGD stages static per-pair ranks; "
                f"{model.name} needs per-update sampled ranks — use "
                "the sgd engine (or DSGD, which samples in-kernel), "
                "or the dense row engine (per-stripe-visit CRN "
                "resampling)")
        w = np.asarray(model.example_weight(
            jnp.asarray(r.astype(np.int32)),
            jnp.asarray(c.astype(np.int32)))).astype(np.float32)
        self._mask_tabs = None
        self._pois_tabs = None
        if self._pois:
            # lambda tables staged after relabeling below; the staged
            # stream itself carries no masks
            lam = np.full(len(r), k, np.int32)
            self.use_mask = False
        elif hasattr(model, "pair_rank"):
            if engine == "dense":
                # the pair mask factorizes per entity (min(r_u, r_i)
                # => Mu[d]*Mi[d], models/base.py), so the ROW layout
                # carries TMF via per-side mask matmuls in
                # cell_dense_update. Needs per-entity rank tables and
                # the rows path (the diag grid doesn't thread masks).
                if not hasattr(model, "entity_ranks"):
                    raise ValueError(
                        "dense engine needs per-entity rank tables "
                        f"(entity_ranks); {model.name} has none — use "
                        "engine='xla'")
                if self.NI != 1:
                    raise ValueError(
                        "rank-masked dense needs the row layout "
                        "(bi=None)")
            lam = np.asarray(model.pair_rank(
                jnp.asarray(r.astype(np.int32)),
                jnp.asarray(c.astype(np.int32)))).astype(np.int32)
            self.use_mask = True
        else:
            lam = np.full(len(r), k, np.int32)
            self.use_mask = False

        r = self.u_perm[r]
        c = self.i_perm[c]
        ub = r // bu
        ib = c // bi
        cell = ub * self.NI + ib
        n_cells = self.NU * self.NI
        if engine == "dense":
            self._stage_dense(cell, (r % bu).astype(np.int32),
                              (c % bi).astype(np.int32),
                              v.astype(np.float32), w, n_cells,
                              dense_budget_bytes)
            if self.use_mask:
                # factorized TMF masks in relabeled order (+ all-ones
                # dummy stripe matching the u_tab3 layout); pad
                # entities keep full-rank masks — their W is 0
                ru = np.full(self.n_users_pad, k, np.int64)
                ri = np.full(self.n_items_pad, k, np.int64)
                eru, eri = model.entity_ranks()
                ru[self.u_perm] = np.asarray(eru, np.int64)
                ri[self.i_perm] = np.asarray(eri, np.int64)
                iota = np.arange(k)
                mu3 = (iota[None, :] < ru[:, None]).astype(
                    np.float32).reshape(self.NU, bu, k)
                mu3 = np.concatenate(
                    [mu3, np.ones((1, bu, k), np.float32)], axis=0)
                mi = (iota[None, :] < ri[:, None]).astype(np.float32)
                self._mask_tabs = (jnp.asarray(mu3), jnp.asarray(mi))
            if self._pois:
                # per-entity TRAINING lambdas in relabeled order (+
                # full-rank dummy stripe); pad entities get lambda = k
                # (their W slots are 0, so masks never bite)
                lu = np.full(self.n_users_pad, k, np.int64)
                li = np.full(self.n_items_pad, k, np.int64)
                elu, eli = model.entity_lambdas()
                lu[self.u_perm] = np.asarray(elu, np.int64)
                li[self.i_perm] = np.asarray(eli, np.int64)
                lu3 = np.concatenate(
                    [lu.reshape(self.NU, bu),
                     np.full((1, bu), k, np.int64)],
                    axis=0).astype(np.int32)
                self._pois_tabs = (
                    jnp.asarray(lu3),
                    jnp.asarray(li.astype(np.int32)),
                    jnp.asarray(model.poisson_cdf_table()))
            self.S = self.bs = 0
            self.pad_frac = n_cells * bu * bi / max(self.nnz, 1)
            self._sched_rng = np.random.default_rng(params.seed + 41)
            self._resident = None
            self._last_u_view = None
            self._last_i_view = None
            return
        counts = np.bincount(cell, minlength=n_cells)
        S0 = max(int(counts.max()), 1)
        if batch_size is None:
            # auto: ~64k ratings per sequential step over the diag
            # schedule's G = NI parallel lanes (row schedule: 1 lane)
            batch_size = auto_batch_size(
                S0, self.NI if schedule == "diag" else 1)
        S = _cdiv(S0, batch_size) * batch_size
        self.S = S
        self.bs = min(batch_size, S)
        self.pad_frac = n_cells * S / max(self.nnz, 1)

        # [NU, NI*S]: each user-block row's cells contiguous, ib order
        u_loc = np.zeros((n_cells, S), np.int32)
        i_loc = np.zeros((n_cells, S), np.int32)
        vals = np.zeros((n_cells, S), np.float32)
        wts = np.zeros((n_cells, S), np.float32)
        lams = np.ones((n_cells, S), np.int32)
        order = np.argsort(cell, kind="stable")
        r, c, v, w, lam = r[order], c[order], v[order], w[order], lam[order]
        cell = cell[order]
        pos = np.arange(len(r)) - np.searchsorted(cell, cell, "left")
        u_loc[cell, pos] = (r % bu).astype(np.int32)
        i_loc[cell, pos] = (c % bi).astype(np.int32)
        vals[cell, pos] = v
        wts[cell, pos] = w
        lams[cell, pos] = lam
        # static per-cell shuffle (stream is row-sorted; see solvers/sgd)
        for cc in np.nonzero(counts > 1)[0]:
            rng = np.random.default_rng(params.seed * 999983 + int(cc))
            p = rng.permutation(int(counts[cc]))
            for arr in (u_loc, i_loc, vals, wts, lams):
                arr[cc, : len(p)] = arr[cc, : len(p)][p]

        if self.collision_norm:
            cnu = stage_batch_collision_counts(wts, u_loc, self.bs, bu)
            cni = stage_batch_collision_counts(wts, i_loc, self.bs, bi)
        else:
            cnu = cni = None

        if self.schedule == "diag":
            # cell-major layout with one trailing all-invalid dummy row
            # (addressed by padding lanes of the diagonal schedule)
            def pad_row(a, fill):
                return np.concatenate(
                    [a, np.full((1, S), fill, a.dtype)], axis=0)

            self.u_loc = jnp.asarray(pad_row(u_loc, 0))
            self.i_loc = jnp.asarray(pad_row(i_loc, 0))
            self.vals = jnp.asarray(pad_row(vals, 0))
            self.wts = jnp.asarray(pad_row(wts, 0))
            self.lams = jnp.asarray(pad_row(lams, 1))
            if self.collision_norm:
                self.cnu = jnp.asarray(pad_row(cnu, 1.0))
                self.cni = jnp.asarray(pad_row(cni, 1.0))
            else:
                self.cnu = self.cni = self.wts
        else:
            shape = (self.NU, self.NI * S)
            if self.collision_norm:
                self.cnu = jnp.asarray(cnu.reshape(shape))
                self.cni = jnp.asarray(cni.reshape(shape))
            self.u_loc = jnp.asarray(u_loc.reshape(shape))
            self.i_loc = jnp.asarray(i_loc.reshape(shape))
            self.vals = jnp.asarray(vals.reshape(shape))
            self.wts = jnp.asarray(wts.reshape(shape))
            self.lams = jnp.asarray(lams.reshape(shape))
            if not self.collision_norm:
                # unused inside the (static) collision_norm=False
                # branch; alias a buffer so no extra HBM is staged
                self.cnu = self.cni = self.wts
        self._sched_rng = np.random.default_rng(params.seed + 41)
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None

    # ------------------------------------------------------------------
    def _stage_dense(self, cell, u_loc, i_loc, vals, wts, n_cells,
                     budget):
        """Dense [bu, bi] rating/weight tiles per cell (+ one dummy),
        built by a one-time device scatter from the relabeled COO
        (ops/dense_block_kernel.densify_rows_host). Staging ladder, best
        first: int8 rating CODES with validity derived from code != 0
        (1 B/slot; exact for star-grid data, lossy opt-in —
        rating_code_scale + the dense_codes knob) when weights are
        uniform 0/1; else int8 validity W + f32/bf16 R (plain MF);
        else f32/bf16 W by budget (IFWMF)."""
        uniform01 = bool(np.all((wts == 0.0) | (wts == 1.0)))
        slots = (n_cells + 1) * self.bu * self.bi
        use_codes = uniform01 and self.dense_codes != "off"
        if use_codes and self.dense_codes == "auto":
            # speed policy: codes cut the R+W read 3x, which should
            # pay at large grids, while at small ones the int8 decode
            # is overhead when traffic is cheap. Auto takes codes only
            # when float tiles would not fit the budget or the grid is
            # large; dense_codes='codes'/'lossy' force them. The
            # 1.5e9-slot cut is not yet measured on a GPU (ROADMAP).
            if slots < int(1.5e9) and slots * 3 <= budget:
                use_codes = False
        if use_codes:
            g = rating_code_scale(vals)
            codes = None
            if g is not None:
                codes = np.round(vals.astype(np.float64) / g)
            elif self.dense_codes == "lossy":
                # 127 signed levels of max|r|/127; near-zero ratings
                # clamp to ±1 code so none silently drops (documented
                # error class: <= g/2 absolute, <= g for the clamped)
                finite = vals[np.isfinite(vals)]
                mx = float(np.abs(finite).max()) if len(finite) else 0.0
                if mx > 0:
                    g = mx / 127.0
                    codes = np.clip(np.round(vals / g), -127, 127)
                    # ratings that would land on code 0 (incl. exact
                    # 0.0 values) clamp to +/-1 so NONE drops — code 0
                    # means "unrated" in-kernel (error <= g for these)
                    zero = codes == 0
                    sgn = np.sign(vals[zero])
                    codes[zero] = np.where(sgn == 0, 1.0, sgn)
            if codes is None and self.dense_codes == "codes":
                raise ValueError(
                    "dense_codes='codes' requires exactly star-grid-"
                    "representable ratings (rating_code_scale); use "
                    "'lossy' or 'auto'")
            if codes is not None:
                if slots > budget:
                    raise ValueError(
                        f"dense code tiles need {slots / 2**30:.1f} "
                        f"GiB > dense_budget {budget / 2**30:.1f} GiB; "
                        "use engine='xla'")
                self.r_scale = float(g)
                self.R_cells = densify_rows_host(
                    cell, u_loc, i_loc, codes.astype(np.int8),
                    n_cells_pad=n_cells + 1, bu=self.bu, bi=self.bi,
                    dtype=jnp.int8)
                self.W_cells = None
                return
        if uniform01:
            wdtype, wbytes = jnp.int8, 1
        elif slots * 8 <= budget:
            wdtype, wbytes = jnp.float32, 4
        else:
            wdtype, wbytes = jnp.bfloat16, 2
        if slots * (4 + wbytes) <= budget:
            vdtype = jnp.float32
        elif slots * (2 + wbytes) <= budget:
            vdtype = jnp.bfloat16
        else:
            raise ValueError(
                f"dense tiles need {slots * (2 + wbytes) / 2**30:.1f} "
                f"GiB > dense_budget {budget / 2**30:.1f} GiB; use "
                "engine='xla'")
        # chunked flat scatters bound the staging temps
        # (densify_rows_host docstring)
        self.R_cells = densify_rows_host(
            cell, u_loc, i_loc, vals, n_cells_pad=n_cells + 1,
            bu=self.bu, bi=self.bi, dtype=vdtype)
        self.W_cells = densify_rows_host(
            cell, u_loc, i_loc, wts.astype(np.float32),
            n_cells_pad=n_cells + 1, bu=self.bu, bi=self.bi,
            dtype=wdtype)

    # ------------------------------------------------------------------
    def _build_schedule(self):
        """Per-epoch randomness: random user-row order, random cell
        order within each row, random batch offset within each cell."""
        rng = self._sched_rng
        row_of = rng.permutation(self.NU).astype(np.int32)
        ib_seq = np.stack([rng.permutation(self.NI)
                           for _ in range(self.NU)]).astype(np.int32)
        boff = rng.integers(0, max(self.S // self.bs, 1),
                            size=(self.NU, self.NI)).astype(np.int32)
        return (jnp.asarray(row_of), jnp.asarray(ib_seq),
                jnp.asarray(boff))

    def _stage_factors(self, state: MFState):
        # staged[new_id] = logical[inv[new_id]] over the padded space
        u = state.u_fac[self.u_perm_inv_dev]
        i = state.i_fac[self.i_perm_inv_dev]
        u = u.astype(jnp.float32)
        i = i.astype(jnp.float32)
        if self.pad_k > u.shape[1]:
            pad = self.pad_k - u.shape[1]
            u = jnp.pad(u, ((0, 0), (0, pad)))
            i = jnp.pad(i, ((0, 0), (0, pad)))
        if self.schedule == "diag":
            k = u.shape[1]
            u3 = jnp.concatenate(
                [u.reshape(self.NU, self.bu, k),
                 jnp.zeros((1, self.bu, k), jnp.float32)], axis=0)
            return u3, i.reshape(self.NI, self.bi, k)
        return u, i

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        del key  # randomness comes from the host schedule rng
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            u_tab, i_tab = self._resident
        else:
            u_tab, i_tab = self._stage_factors(state)
        if self.engine == "dense":
            ek = jax.random.PRNGKey(int(self._sched_rng.integers(2**31)))
            if self.NI == 1:
                k0 = u_tab.shape[2]
                # row-stripe sweep (scalar-indexed stripes; see
                # ops/dense_block_kernel.dense_sweep_rows)
                mu3, mi = (self._mask_tabs
                           if self._mask_tabs is not None
                           else (None, None))
                lu3, li, cdf = (self._pois_tabs
                                if self._pois_tabs is not None
                                else (None, None, None))
                u3, i2 = dense_epoch_rows_keyed(
                    u_tab, i_tab.reshape(self.n_items_pad, k0), ek,
                    jnp.float32(lr), self.R_cells, self.W_cells,
                    u_reg=float(self.params.u_reg),
                    i_reg=float(self.params.i_reg),
                    collision_norm=self.collision_norm,
                    mm_bf16=self.mm_bf16, Mu3=mu3, Mi=mi,
                    r_scale=self.r_scale, Lu3=lu3, Li=li,
                    pois_cdf=cdf)
                i3 = i2.reshape(1, self.bi, k0)
            else:
                u3, i3 = dense_epoch_diag_keyed(
                    u_tab, i_tab, ek, jnp.float32(lr),
                    self.R_cells, self.W_cells, NI=self.NI,
                    u_reg=float(self.params.u_reg),
                    i_reg=float(self.params.i_reg),
                    collision_norm=self.collision_norm,
                    mm_bf16=self.mm_bf16, r_scale=self.r_scale)
            self._resident = (u3, i3)
            kk = u3.shape[2]
            u_flat = u3[:self.NU].reshape(self.NU * self.bu, kk)
            i_flat = i3.reshape(self.n_items_pad, kk)
            u_view = u_flat[self.u_perm_dev][:, :self.model.k]
            i_view = i_flat[self.i_perm_dev][:, :self.model.k]
            # store the POST-cast arrays: astype to a different dtype
            # returns a new object, and a stale identity here makes the
            # resident check miss every epoch (and re-stage the tables)
            u_ret = u_view.astype(state.u_fac.dtype)
            i_ret = i_view.astype(state.i_fac.dtype)
            self._last_u_view, self._last_i_view = u_ret, i_ret
            return state._replace(u_fac=u_ret, i_fac=i_ret)
        common = dict(
            bs=self.bs, bu=self.bu, bi=self.bi, NI=self.NI,
            u_reg=float(self.params.u_reg),
            i_reg=float(self.params.i_reg),
            collision_norm=self.collision_norm,
            use_mask=self.use_mask, mm_bf16=self.mm_bf16)
        if self.schedule == "diag":
            # schedule generated ON-DEVICE from a key: no per-epoch
            # host->device schedule transfers (schedule semantics =
            # ops/block_sgd_kernel.device_diag_schedule — DSGD rounds,
            # README deviation #3)
            ek = jax.random.PRNGKey(int(self._sched_rng.integers(2**31)))
            u3, i3 = block_sgd_epoch_diag_keyed(
                u_tab, i_tab, ek, jnp.float32(lr),
                self.u_loc, self.i_loc, self.vals, self.wts,
                self.cnu, self.cni, self.lams, **common)
            self._resident = (u3, i3)
            k = u3.shape[2]
            u_flat = u3[:self.NU].reshape(self.NU * self.bu, k)
            i_flat = i3.reshape(self.n_items_pad, k)
            u_view = u_flat[self.u_perm_dev][:, :self.model.k]
            i_view = i_flat[self.i_perm_dev][:, :self.model.k]
            # store the POST-cast arrays: astype to a different dtype
            # returns a new object, and a stale identity here makes the
            # resident check miss every epoch (and re-stage the tables)
            u_ret = u_view.astype(state.u_fac.dtype)
            i_ret = i_view.astype(state.i_fac.dtype)
            self._last_u_view, self._last_i_view = u_ret, i_ret
            return state._replace(u_fac=u_ret, i_fac=i_ret)
        row_of, ib_seq, boff = self._build_schedule()
        u_tab, i_tab = block_sgd_epoch_xla(
            u_tab, i_tab, row_of, ib_seq, boff, jnp.float32(lr),
            self.u_loc, self.i_loc, self.vals, self.wts,
            self.cnu, self.cni, self.lams, **common)
        self._resident = (u_tab, i_tab)
        # logical[old] = staged[perm[old]] (perm values span the padded
        # space, so gather BEFORE any truncation)
        u_view = u_tab[self.u_perm_dev][:, :self.model.k]
        i_view = i_tab[self.i_perm_dev][:, :self.model.k]
        u_ret = u_view.astype(state.u_fac.dtype)
        i_ret = i_view.astype(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)
