"""Dense-stripe BPR: pairwise ranking on full-catalog score panels.

The stream BPR engine (solvers/bpr.py) is bound by the per-INDEX cost
of 9 index streams per pair (3 row gathers + 3 row scatters + 3
sampler streams). This
engine restructures the epoch the way the row-dense SGD engine did
(ops/dense_block_kernel.dense_sweep_rows): per user STRIPE, one dense
score panel serves every positive of the stripe, and the per-pair work
drops to 4 SCALAR streams + shared matmuls:

  P2 = U @ I^T - BIG * W          [bu, ni]  (one matmul; W = the
                                   stripe's 0/1 rated/invalid mask)
  s+ = P2[ul, ip] + BIG           (1 element-gather; ip rated => the
                                   -BIG cancels to f32 rounding: the
                                   (raw-60)+60 round-trip loses low
                                   bits, ~4e-6 absolute — the parity
                                   tests' tolerance floor)
  s- = P2[ul, j],  j ~ U[0, ni)   (1 element-gather; if j is rated or
                                   invalid, s- = raw - BIG so the
                                   sigmoid coefficient underflows to 0
                                   — sampling rejection FOLDED into
                                   the score, no mask lookup)
  c  = w * (-1 / (1 + exp(s+ - s-)))
  C  = scatter +c at (ul, ip), -c at (ul, j)    (2 element-scatters)
  gU = C @ I + reg;  gI = C^T @ U + reg         (2 matmuls)

Update semantics = modelMFBPR.cpp:501-521 per-triple gradients
(solvers/bpr.bpr_pair_terms), minibatched at batch = stripe with
optional collision normalization — the block engines' README deviation
#1. Negative scope matches the reference: uniform over items with a
train rating, excluding the user's positively-rated items
(sampleNegItem, modelMFBPR.cpp:191-242); rated/invalid draws DROP the
pair (weight ~0, probability ~ density + invalid fraction ~1% at the
bench shape) — the reference's own budget-exhaustion handling
(:227-241), like the stream engine's n_tries=1 config. Documented
deviations: (a) batch = stripe staleness; (b) the negative-side reg +
collision counts use the EXPECTED per-item draw count (draws are
uniform) instead of the realized one — exact counting would cost a 5th
index stream for a <= lr*reg-sized correction; (c) multi-negative mode
(n_negs > 1) amortizes the s+ gather and the positive-side scatter
over several independent draws per positive — each (positive, draw)
pair still gets the exact BPR gradient, and the draws are AVERAGED
(an unbiased variance-reduced estimate of the single-draw gradient,
so the learn_rate needs no retuning; the summed form diverged at the
unadjusted lr in the T=2 probe).

Rank-masked BPR models (triple_rank_mask) stay on the stream engine —
per-pair dim masks do not factor through the shared C matmuls (the
solver guards).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.models.base import MFState
from matfac_tpu.solvers.block_sgd import _balance_perm, _cdiv

_BIG = 60.0   # sigmoid(-60) ~ 9e-27: rated-negative pairs self-cancel


class DenseBPRSolver:
    """Drop-in BPRSolver alternative (mode='stream' semantics only)."""

    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 bu: Optional[int] = None, n_negs: int = 1,
                 collision_norm: bool = False,
                 dense_budget_bytes: int = 8 << 30,
                 panel_q: Optional[int] = None, **_):
        """collision_norm=False (default) sums the stripe's per-pair
        gradients — the stream engine's (and reference's) semantics at
        the same learn_rate; True takes the within-batch mean, which
        needs a ~count-times larger lr but is divergence-proof for
        power-law hot entities (measured sweep in the module tests)."""
        # ModelMFBPR's mask hook returns None (plain BPR); the Poisson/
        # sigmoid hybrids return real [B, k] masks which do not factor
        # through the shared C matmuls
        if model.triple_rank_mask(jax.random.PRNGKey(0),
                                  jnp.zeros(1, jnp.int32),
                                  jnp.zeros(1, jnp.int32),
                                  jnp.zeros(1, jnp.int32)) is not None:
            raise ValueError(
                "DenseBPRSolver shares one C matrix across the stripe; "
                f"{model.name} needs per-pair rank masks — use "
                "BPRSolver")
        self.model = model
        self.params = params
        self.n_negs = int(n_negs)
        self.panel_q = None if panel_q is None else int(panel_q)
        self.collision_norm = collision_norm
        n_users, n_items = model.n_users, model.n_items
        k = model.k

        r, c, v = train_mat.to_coo()
        keep = (v > 0) & ~invalid_users[r] & ~invalid_items[c]
        pr, pc = r[keep].astype(np.int64), c[keep].astype(np.int64)
        self.n_pos = len(pr)

        self.ni_pad = _cdiv(n_items, 128) * 128
        if self.panel_q is not None and self.ni_pad % self.panel_q:
            raise ValueError(
                f"panel_q={self.panel_q} must divide the padded "
                f"catalog width {self.ni_pad}")
        if bu is None:
            bu = min(2560, max(_cdiv(_cdiv(n_users, 8), 256) * 256, 256))
        self.bu = bu
        self.NU = _cdiv(n_users, bu)
        self.n_users_pad = self.NU * bu
        slots = self.NU * bu * self.ni_pad
        if slots > dense_budget_bytes:   # int8 mask
            raise ValueError(
                f"dense BPR mask needs {slots/2**30:.1f} GiB > budget "
                f"{dense_budget_bytes/2**30:.1f} GiB; use BPRSolver")

        # frequency-balanced user relabel (stripe loads stay even under
        # power-law degrees — same permutation family as block-SGD)
        u_freq = np.bincount(pr, minlength=n_users)
        self.u_perm = _balance_perm(u_freq, n_users, self.NU, bu)
        self.u_perm_dev = jnp.asarray(self.u_perm.astype(np.int32))
        u_inv = np.zeros(self.n_users_pad, np.int64)
        u_inv[self.u_perm] = np.arange(n_users)
        self.u_perm_inv_dev = jnp.asarray(u_inv.astype(np.int32))

        r2 = self.u_perm[pr]
        stripe = r2 // bu
        counts = np.bincount(stripe, minlength=self.NU)
        S = max(int(counts.max()), 1)
        self.nb = 1
        if self.panel_q is not None:
            # panel mode sub-batches the stripe (~4k positives each);
            # each sub-batch draws its own tile so per-epoch item
            # coverage matches uniform sampling while concentration
            # stays bounded (_build_epoch_panel docstring)
            self.nb = max(1, -(-S // 4096))
            S = -(-S // self.nb) * self.nb
        self.S = S
        self.pad_frac = self.NU * S / max(self.n_pos, 1)

        u_loc = np.zeros((self.NU, S), np.int32)
        ipos = np.zeros((self.NU, S), np.int32)
        wpos = np.zeros((self.NU, S), np.float32)
        order = np.argsort(stripe, kind="stable")
        r2s, pcs, stripes = r2[order], pc[order], stripe[order]
        locs = (r2s % bu).astype(np.int32)
        pos = np.arange(len(r2s)) - np.searchsorted(stripes, stripes,
                                                    "left")
        u_loc[stripes, pos] = locs
        ipos[stripes, pos] = pcs.astype(np.int32)
        wpos[stripes, pos] = 1.0
        self.u_locs = jnp.asarray(u_loc)
        self.ipos = jnp.asarray(ipos)
        self.wpos = jnp.asarray(wpos)

        # static per-stripe occurrence counts (reg + collision norms)
        cnt_u = np.zeros((self.NU, bu), np.float32)
        np.add.at(cnt_u, (stripes, locs), 1.0)
        cnt_ip = np.zeros((self.NU, self.ni_pad), np.float32)
        np.add.at(cnt_ip, (stripes, pcs), 1.0)
        # negatives are uniform over the catalog: expected draws per
        # item per stripe, times the 1/T draw-averaging weight
        # (deviations (b)+(c) in the module docstring) — T-independent
        cnt_neg = counts.astype(np.float32) / max(self.ni_pad, 1)
        self.cnt_u = jnp.asarray(cnt_u)
        self.cnt_i = jnp.asarray(cnt_ip + cnt_neg[:, None])
        self.cnt_neg = jnp.asarray(cnt_neg)
        # rated-only per-stripe item counts: the panel epoch's
        # collision divisors add the REALIZED panel count on top
        self.cnt_ip = (jnp.asarray(cnt_ip) if self.panel_q is not None
                       else None)

        # stripe-row dense mask: 1 = positively rated, invalid item, or
        # padded column (all self-cancel through -BIG); one-time device
        # scatter, int8
        mask0 = np.zeros(self.ni_pad, np.int8)
        mask0[n_items:] = 1
        deg_i = train_mat.col_degrees()
        never = np.ones(n_items, bool)
        never[: len(deg_i)] &= deg_i == 0
        mask0[: n_items][never | invalid_items[:n_items]] = 1

        @jax.jit
        def build_w(stripe_d, ul_d, ip_d):
            W = jnp.broadcast_to(jnp.asarray(mask0),
                                 (self.NU, bu, self.ni_pad))
            return W.at[stripe_d, ul_d, ip_d].max(
                jnp.ones(stripe_d.shape, jnp.int8))

        self.W_rows = build_w(jnp.asarray(stripes.astype(np.int32)),
                              jnp.asarray(locs),
                              jnp.asarray(pcs.astype(np.int32)))
        self.n_items_real = n_items
        self._epoch = self._build_epoch()
        self._resident = None
        self._last_u_view = None
        self._last_i_view = None
        self.last_loss = jnp.zeros(())
        self.last_inversions = jnp.zeros((), jnp.int32)

    # ------------------------------------------------------------------
    def _build_epoch(self):
        if self.panel_q is not None:
            return self._build_epoch_panel()
        NU, bu, S, T = self.NU, self.bu, self.S, self.n_negs
        ni_pad = self.ni_pad
        n_items = self.n_items_real
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        eps = float(self.params.eps)
        collision = self.collision_norm

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(u3, i_tab, u_locs, ipos, wpos, W_rows, cnt_u, cnt_i,
                  lr, key):
            k_ord, k_neg = jax.random.split(key)
            row_of = jax.random.permutation(
                k_ord, jnp.arange(NU, dtype=jnp.int32))
            js = jax.random.randint(k_neg, (NU, T, S), 0, n_items,
                                    dtype=jnp.int32)

            def body(t, carry):
                u3, I, loss, inv = carry
                ub = row_of[t]
                U = u3[ub]                          # [bu, k]
                W = W_rows[ub].astype(jnp.float32)  # [bu, ni_pad]
                P2 = jnp.dot(U.astype(jnp.bfloat16),
                             I.astype(jnp.bfloat16).T,
                             preferred_element_type=jnp.float32
                             ) - _BIG * W
                ul = u_locs[ub]
                ip = ipos[ub]
                w = wpos[ub]
                splus = P2[ul, ip] + _BIG           # [S]
                j = js[t]                           # [T, S]
                sneg = P2[ul[None, :], j]           # [T, S]
                r = splus[None, :] - sneg
                # average over the T draws (unbiased single-draw-scale
                # gradient; see module docstring deviation (c))
                c = w[None, :] * (-1.0 / (T * (1.0 + jnp.exp(r))))
                # loss/inversions are per-DRAW means (the 1/T scale
                # matching the averaged gradient), so cross-engine loss
                # comparisons and loss-based termination stay on the
                # stream engine's scale at any T
                loss = loss + jnp.sum(
                    w[None, :] * jnp.logaddexp(0.0, -r)) / T
                inv = inv + jnp.sum(
                    jnp.where((-r > eps) & (w[None, :] > 0),
                              1.0 / T, 0.0))
                # routing matrix: +coeff at (ul, ip), -coeff at (ul, j)
                # so C @ I = sum coeff*(qp - qn) = the gu data term and
                # C^T @ U = the gp/gn data terms of bpr_pair_terms —
                # then U - lr*(C@I + reg) matches the stream engine's
                # u_fac.at[u].add(-lr*gu) exactly
                C = jnp.zeros((bu, ni_pad), jnp.float32)
                C = C.at[ul, ip].add(jnp.sum(c, axis=0))
                C = C.at[jnp.broadcast_to(ul, (T, S)).reshape(-1),
                         j.reshape(-1)].add(-c.reshape(-1))
                gU = (jnp.dot(C, I, preferred_element_type=jnp.float32)
                      + (2.0 * u_reg) * cnt_u[ub][:, None] * U)
                gI = (jnp.dot(C.T, U,
                              preferred_element_type=jnp.float32)
                      + (2.0 * i_reg) * cnt_i[ub][:, None] * I)
                if collision:
                    gU = gU / jnp.maximum(cnt_u[ub], 1.0)[:, None]
                    gI = gI / jnp.maximum(cnt_i[ub], 1.0)[:, None]
                return (u3.at[ub].set(U - lr * gU), I - lr * gI,
                        loss, inv)

            u3, i_tab, loss, inv = jax.lax.fori_loop(
                0, NU, body,
                (u3, i_tab, jnp.zeros(()), jnp.zeros(())))
            return u3, i_tab, loss, jnp.round(inv).astype(jnp.int32)

        return epoch

    def _build_epoch_panel(self):
        """Panel-stratified negatives (round 5, past the 4-stream
        roofline): the stripe's positives are split into ``nb``
        position-contiguous SUB-BATCHES (~4k each); every sub-batch
        draws its own Q-wide tile of the relabeled item axis and all
        its positives take the tile's Q columns as negatives, averaged
        at 1/Q weight. The negative-side gather and scatter become ROW
        ops (1 index per positive each, carrying Q draws — the 7 ns
        indexed-op cost is per INDEX, not per element), so index
        streams per (positive, draw) pair fall from 4 to 4/Q and
        pairs/s scale ~linearly in Q at flat epoch time (measured).

        Sampling-scope deviation (extends docstring deviation (c)):
        a sub-batch shares its tile; a positive's Q draws are the
        tile's Q distinct columns. MARGINALLY each item is a negative
        with probability Q/ni_pad per sub-batch = uniform over the
        padded catalog, and rated/invalid/padding columns self-cancel
        through the -BIG fold. Per-(positive, draw) gradients stay the
        exact bpr_pair_terms math; the negative REG expectation
        cnt_neg = counts/ni_pad is unchanged. Per-epoch item coverage:
        NU*nb*Q/ni_pad panel hits per item — the sub-batching is what
        keeps it at uniform-sampling scale (one shared panel per
        stripe measured FLAT loss curves: items too rarely/too hard
        hit).

        Stability: a tile column's realized per-visit count is
        nv_sb/Q summed contributions — with ~4k-positive sub-batches
        and Q >= 32 that is the same order as uniform draws'
        ~nv/ni_pad realized counts, so the default summed semantics
        hold at stream-tuned lr; ONE shared stripe panel (nb=1)
        measured divergent, which is why sub-batching is not
        optional. collision_norm=True additionally applies the
        engines' within-batch mean with REALIZED divisors (rated
        occurrences + the per-tile nv_sb/Q) — divergence-proof, needs
        a ~count-times larger lr (README deviation #1 family)."""
        NU, bu, S, Q = self.NU, self.bu, self.S, self.panel_q
        nb = self.nb
        sb_size = S // nb
        ni_pad = self.ni_pad
        n_tiles = ni_pad // Q
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        eps = float(self.params.eps)
        cnt_ip = self.cnt_ip
        collision = self.collision_norm

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def epoch(u3, i_tab, u_locs, ipos, wpos, W_rows, cnt_u, cnt_i,
                  lr, key):
            k_ord, k_neg = jax.random.split(key)
            row_of = jax.random.permutation(
                k_ord, jnp.arange(NU, dtype=jnp.int32))
            tiles = jax.random.randint(k_neg, (NU, nb), 0, n_tiles,
                                       dtype=jnp.int32)
            sb = (jnp.arange(S, dtype=jnp.int32) // sb_size)   # [S]
            qi = jnp.arange(Q, dtype=jnp.int32)

            def body(t, carry):
                u3, I, loss, inv = carry
                ub = row_of[t]
                U = u3[ub]                          # [bu, k]
                W = W_rows[ub].astype(jnp.float32)  # [bu, ni_pad]
                P2 = jnp.dot(U.astype(jnp.bfloat16),
                             I.astype(jnp.bfloat16).T,
                             preferred_element_type=jnp.float32
                             ) - _BIG * W
                ul = u_locs[ub]
                ip = ipos[ub]
                w = wpos[ub]
                cols = (tiles[t][:, None] * Q
                        + qi[None, :]).reshape(-1)   # [nb*Q]
                Pn = P2[:, cols]                     # [bu, nb*Q]
                # flatten [bu, nb, Q] WITHOUT a physical transpose:
                # row index = ul*nb + sb (transposes cost ~2x epoch)
                Pn2 = Pn.reshape(bu * nb, Q)
                splus = P2[ul, ip] + _BIG            # [S]
                Sn = Pn2[ul * nb + sb]               # [S, Q] row gather
                r = splus[:, None] - Sn
                c = w[:, None] * (-1.0 / (Q * (1.0 + jnp.exp(r))))
                loss = loss + jnp.sum(
                    w[:, None] * jnp.logaddexp(0.0, -r)) / Q
                inv = inv + jnp.sum(
                    jnp.where((-r > eps) & (w[:, None] > 0),
                              1.0 / Q, 0.0))
                C = jnp.zeros((bu, ni_pad), jnp.float32)
                C = C.at[ul, ip].add(jnp.sum(c, axis=1))
                Cn = jnp.zeros((bu * nb, Q), jnp.float32
                               ).at[ul * nb + sb].add(-c)
                Cn = Cn.reshape(bu, nb * Q)
                C = C.at[:, cols].add(Cn)
                gU = (jnp.dot(C, I, preferred_element_type=jnp.float32)
                      + (2.0 * u_reg) * cnt_u[ub][:, None] * U)
                gI = (jnp.dot(C.T, U,
                              preferred_element_type=jnp.float32)
                      + (2.0 * i_reg) * cnt_i[ub][:, None] * I)
                if collision:
                    # collision-MEAN with realized per-tile counts
                    nv_sb = jax.ops.segment_sum(
                        (w > 0).astype(jnp.float32), sb,
                        num_segments=nb)
                    div_i = cnt_ip[ub].at[cols].add(
                        jnp.repeat(nv_sb / Q, Q))
                    gU = gU / jnp.maximum(cnt_u[ub], 1.0)[:, None]
                    gI = gI / jnp.maximum(div_i, 1.0)[:, None]
                return (u3.at[ub].set(U - lr * gU), I - lr * gI,
                        loss, inv)

            u3, i_tab, loss, inv = jax.lax.fori_loop(
                0, NU, body,
                (u3, i_tab, jnp.zeros(()), jnp.zeros(())))
            return u3, i_tab, loss, jnp.round(inv).astype(jnp.int32)

        return epoch

    # ------------------------------------------------------------------
    def _stage_factors(self, state: MFState):
        u = state.u_fac[self.u_perm_inv_dev].astype(jnp.float32)
        k = u.shape[1]
        u3 = u.reshape(self.NU, self.bu, k)
        i = state.i_fac.astype(jnp.float32)
        pad = self.ni_pad - i.shape[0]
        if pad:
            i = jnp.pad(i, ((0, pad), (0, 0)))
        return u3, i

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        if (self._resident is not None
                and state.u_fac is self._last_u_view
                and state.i_fac is self._last_i_view):
            u3, i_tab = self._resident
        else:
            u3, i_tab = self._stage_factors(state)
        u3, i_tab, self.last_loss, self.last_inversions = self._epoch(
            u3, i_tab, self.u_locs, self.ipos, self.wpos, self.W_rows,
            self.cnt_u, self.cnt_i, jnp.float32(lr), key)
        self._resident = (u3, i_tab)
        k = self.model.k
        u_view = u3.reshape(self.n_users_pad, k)[self.u_perm_dev]
        i_view = i_tab[: self.model.n_items]
        # POST-cast identity (see solvers/block_sgd.py epoch note)
        u_ret = u_view.astype(state.u_fac.dtype)
        i_ret = i_view.astype(state.i_fac.dtype)
        self._last_u_view, self._last_i_view = u_ret, i_ret
        return state._replace(u_fac=u_ret, i_fac=i_ret)
