"""BPR pairwise-ranking SGD with device-side gap negative sampling.

JAX analog of ModelMFBPR::train / trainHog
(modelMFBPR.cpp:245-722). Positives are train entries with rating > 0
(getBPRUIRatings, modelMFBPR.cpp:46-58). Negative sampling replicates
the reference's CSR gap trick (sampleNegItem, modelMFBPR.cpp:191-242)
with flat-array gathers:

  try: jj ~ U[0, deg_u); if rowval[jj]==0 accept that explicit zero;
  else j ~ U[gap between rated item jj and the next rated item), accept
  if j is a train item (>=1 rating). Up to `n_tries` tries; failures
  drop the example (weight 0 — the reference's own failure handling
  after its 100-try budget, modelMFBPR.cpp:227-241). First-try
  acceptance measured >90% (PERF.md), so the default budget is 2 tries
  (~1% of pairs dropped/epoch) — the sampler is gather-bound and each
  try costs a [B,3] row-gather, so a 16-try budget spent 8x the gathers
  to rescue <10% of pairs.

The pairwise update (modelMFBPR.cpp:501-521):

  r_uij = <p_u, q_p> - <p_u, q_n>;  c = -1 / (1 + exp(r_uij))
  p_u  -= lr (c (q_p - q_n) + 2 uReg p_u)
  q_p  -= lr (c p_u + 2 iReg q_p)
  q_n  -= lr (-c p_u + 2 iReg q_n)

applied batched with scatter-add; the BPRxPoisson hybrid masks dims via
model.triple_rank_mask. LR decays x0.9 per epoch in the caller
(modelMFBPR.cpp:533).

Stream-mode throughput design: the epoch is bound by the per-INDEX
cost of gathers/scatters, so the engine minimizes index streams/pair:

  * (start, deg) of each positive's user row are HOST-STAGED next to
    the positive stream (batch contents are static — only batch order
    is random), removing both indptr element-gather streams;
  * all sampler randomness for the epoch is pre-generated OUTSIDE the
    batch scan as one `jax.random.bits` tensor (one dispatch instead of
    per-batch threefry splits);
  * sampler="rankgap" (default) folds the gap bounds AND the count of
    train items in the gap into the staged CSR row
    (col, val, cum_lo, cnt) so each try costs ONE [B,4] row-gather;
    the accepted candidate is carried as a RANK into the sorted
    train-item list and resolved with one post-try sel[rank] gather.
    Per gap this samples uniformly over train items in the gap —
    identical to the reference's accept distribution within a try
    (modelMFBPR.cpp:211-241); the only deviation is the mixture across
    gaps when a gap contains never-rated items (the reference re-rolls
    the rated-index jj on such rejections, mine never rejects), which
    is O(fraction of untrained items) and zero when every item has a
    train rating. sampler="gap" keeps the literal per-try
    trainItems-rejection semantics.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.models.base import MFState


def bpr_pair_terms(pu, qp, qn, w, m, u_reg: float, i_reg: float):
    """Batched pairwise BPR loss + analytic gradients
    (modelMFBPR.cpp:501-521). The per-triple loss being minimized:

        w * [ ln(1 + e^{-r_uij}) + u_reg ||pu ⊙ m||^2
              + i_reg (||qp ⊙ m||^2 + ||qn ⊙ m||^2) ]

    with r_uij = <pu ⊙ m, qp − qn> (m = all-ones when None — plain
    BPR; the BPR×Poisson hybrid passes the triple rank mask). Returns
    (gu, gp, gn, r_uij, loss_sum) where loss_sum is the DATA term only
    (the epoch log's loss line, modelMFBPR.cpp:545-553) and the
    gradients are the exact gradient of the full per-triple loss —
    pinned by a central finite-difference test (the gradCheck analog,
    modelMFBPR.cpp:5-43; tests/test_bpr.py)."""
    pm = pu if m is None else pu * m
    r_ui = jnp.einsum("ek,ek->e", pm, qp,
                      preferred_element_type=jnp.float32)
    r_uj = jnp.einsum("ek,ek->e", pm, qn,
                      preferred_element_type=jnp.float32)
    r_uij = r_ui - r_uj
    loss_sum = jnp.sum(w * jnp.logaddexp(0.0, -r_uij))
    coeff = w * (-1.0 / (1.0 + jnp.exp(r_uij)))
    gu = coeff[:, None] * (qp - qn) + 2.0 * u_reg * w[:, None] * pu
    gp = coeff[:, None] * pu + 2.0 * i_reg * w[:, None] * qp
    gn = -coeff[:, None] * pu + 2.0 * i_reg * w[:, None] * qn
    if m is not None:
        gu, gp, gn = gu * m, gp * m, gn * m
    return gu, gp, gn, r_uij, loss_sum


class BPRSolver:
    def __init__(self, model, params: Params, train_mat,
                 invalid_users: np.ndarray, invalid_items: np.ndarray,
                 batch_size: Optional[int] = None, n_tries: int = 2,
                 mode: str = "stream", sampler: str = "rankgap"):
        """mode="stream": iterate all positives per epoch (train,
        modelMFBPR.cpp:405-559). mode="posneg": per step sample a
        random train user, a random positive from their row, and a
        negative that is either a LOWER-RATED rated item or a gap item
        (trainHogPosNeg + samplePosNegItem, modelMFBPR.cpp:61-132,
        :562-722). sampler="rankgap"|"gap" picks the stream-mode
        negative sampler (see module docstring); posneg always uses the
        literal gap sampler."""
        if sampler not in ("rankgap", "gap"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.model = model
        self.params = params
        self.n_tries = n_tries
        self.mode = mode
        self.sampler = sampler
        if model.n_items >= 2 ** 24:
            raise ValueError("packed gap sampler stores item ids in "
                             "f32 (exact below 2^24 items)")
        bs = batch_size or params.batch_size

        # positives: rating > 0, valid entities
        r, c, v = train_mat.to_coo()
        keep = (v > 0) & ~invalid_users[r] & ~invalid_items[c]
        pr, pc = r[keep], c[keep]
        # static host shuffle; per-epoch randomness = offset + batch
        # order (see solvers/sgd.py note on device-sort cost)
        sperm = np.random.default_rng(params.seed).permutation(len(pr))
        pr, pc = pr[sperm], pc[sperm]
        n = len(pr)
        n_pad = (-n) % bs if n else bs
        pr_pad = np.concatenate([pr, np.zeros(n_pad, np.int32)]
                                ).astype(np.int32)
        self.pos_u = jnp.asarray(pr_pad)
        self.pos_i = jnp.asarray(np.concatenate(
            [pc, np.zeros(n_pad, np.int32)]).astype(np.int32))
        self.pos_valid = jnp.asarray(np.concatenate(
            [np.ones(n, np.float32), np.zeros(n_pad, np.float32)]))
        # host-staged row (start, deg) per positive: batch CONTENTS are
        # static (only batch order is random), so these replace two
        # per-batch indptr element-gather streams (PERF.md)
        ip = train_mat.indptr
        starts_np = ip[pr_pad]
        degs_np = np.maximum(ip[pr_pad + 1] - starts_np, 1)
        self.pos_start = jnp.asarray(starts_np.astype(np.int32))
        self.pos_deg = jnp.asarray(degs_np.astype(np.int32))
        self.n_pos = n
        self.batch_size = bs
        self.n_batches = len(self.pos_u) // bs

        # flat CSR of the full train row (incl. explicit zeros) for gap
        # sampling; rows sorted by construction (RatingMatrix.from_coo).
        # The per-try lookup (col, val, next_col) is PACKED into one
        # row so each try costs one row-gather instead of three —
        # per-index cost dominates narrow gathers, so width-3 rows are
        # ~free.
        self.csr_indptr = jnp.asarray(train_mat.indptr.astype(np.int32))
        self.csr_cols = jnp.asarray(train_mat.indices.astype(np.int32))
        self.csr_vals = jnp.asarray(train_mat.values.astype(np.float32))
        nxt = np.empty(train_mat.nnz, np.float32)
        if train_mat.nnz:
            nxt[:-1] = train_mat.indices[1:]
            nxt[-1] = train_mat.indices[-1]
        packed = np.stack([train_mat.indices.astype(np.float32),
                           train_mat.values.astype(np.float32),
                           nxt], axis=1)
        self.csr_packed = jnp.asarray(packed)   # [nnz, 3] f32
        # items with >= 1 train rating (trainItems set, :442-448)
        ti = np.zeros(model.n_items, bool)
        deg_i = train_mat.col_degrees()
        ti[: len(deg_i)] = deg_i > 0
        self.train_items = jnp.asarray(ti)
        self.n_items = int(model.n_items)

        if sampler == "rankgap" and mode == "stream":
            # per-CSR-entry gap metadata (static): when the sampled
            # rated index jj lands on entry e, the candidate gap is
            #   jj==0      -> [0, col_e)            (modelMFBPR.cpp:211)
            #   jj==deg-1  -> [col_e+1, n_items)    (:216)
            #   else       -> [col_e+1, next_col)   (:219)
            # (branch precedence: jj==0 wins for single-entry rows).
            # cum_lo/cnt index into the sorted train-item list so a
            # try needs only this one row; the accepted RANK resolves
            # through sel[] once per batch.
            cols = train_mat.indices.astype(np.int64)
            nnz = train_mat.nnz
            deg_full = np.diff(ip).astype(np.int64)
            row_id = np.repeat(np.arange(len(deg_full)), deg_full)
            idx_in_row = np.arange(nnz) - ip[row_id]
            first = idx_in_row == 0
            last = idx_in_row == deg_full[row_id] - 1
            nxt_col = np.empty(nnz, np.int64)
            if nnz:
                nxt_col[:-1] = cols[1:]
                nxt_col[-1] = cols[-1]
            lo = np.where(first, 0, cols + 1)
            hi = np.where(first, cols,
                          np.where(last, self.n_items, nxt_col))
            cum = np.zeros(self.n_items + 1, np.int64)
            np.cumsum(ti, out=cum[1:])
            cum_lo = cum[lo]
            cnt = cum[hi] - cum_lo
            packed4 = np.stack(
                [cols.astype(np.float32),
                 train_mat.values.astype(np.float32),
                 cum_lo.astype(np.float32),
                 cnt.astype(np.float32)], axis=1)
            self.csr_packed4 = jnp.asarray(packed4)   # [nnz, 4] f32
            sel = np.nonzero(ti)[0].astype(np.int32)
            if len(sel) == 0:
                sel = np.zeros(1, np.int32)
            self.sel_items = jnp.asarray(sel)
        deg_u = train_mat.row_degrees()
        tu = np.nonzero((deg_u > 0) & ~invalid_users[: train_mat.nrows])[0]
        self.train_users = jnp.asarray(tu.astype(np.int32))
        if mode == "posneg":
            # packed per-train-user (user id, row start, row deg): one
            # [B, 3] row gather replaces the train_users element gather
            # plus two indptr element gathers per step
            sd = np.stack([tu, ip[tu],
                           np.maximum(ip[tu + 1] - ip[tu], 1)],
                          axis=1).astype(np.int32)
            self.train_user_sd = jnp.asarray(sd)
        self._epoch = (self._build_epoch() if mode == "stream"
                       else self._build_posneg_epoch())
        self.last_loss = jnp.zeros(())
        self.last_inversions = jnp.zeros((), jnp.int32)

    # ------------------------------------------------------------------
    def _sample_gap_bits(self, u, start, deg, jj_bits, j_bits, csr):
        """Literal gap sampler (modelMFBPR.cpp:191-242) from
        pre-generated random bits. jj_bits/j_bits: [n_tries, B] uint32.
        Returns (neg_idx[B], ok[B])."""
        csr_packed, train_items = csr
        B = u.shape[0]
        deg_u = deg.astype(jnp.uint32)

        def one_try(carry, bits_t):
            neg, ok = carry
            b_jj, b_j = bits_t
            jj = (b_jj % deg_u).astype(jnp.int32)
            pos = start + jj
            row = csr_packed[pos]                    # one [B, 3] gather
            item_jj = row[:, 0].astype(jnp.int32)
            val_jj = row[:, 1]
            # explicit zero at sampled position -> direct accept
            explicit = val_jj == 0.0
            # gap bounds (modelMFBPR.cpp:211-222)
            lo = jnp.where(jj == 0, 0, item_jj + 1)
            # packed next-col is exact except at the very last nnz entry
            # (clamped there, matching the jj==deg-1 branch below anyway)
            next_item = row[:, 2].astype(jnp.int32)
            # branch precedence matches :211-222 — jj==0 before jj==deg-1,
            # so a single-rating user samples from [0, first rated item)
            hi = jnp.where(jj == 0, item_jj,
                           jnp.where(jj == deg - 1, self.n_items,
                                     next_item))
            span = jnp.maximum(hi - lo, 1)
            j = lo + (b_j % span.astype(jnp.uint32)).astype(jnp.int32)
            valid_gap = (hi - lo > 0) & train_items[
                jnp.clip(j, 0, self.n_items - 1)]
            cand = jnp.where(explicit, item_jj, j)
            cand_ok = explicit | valid_gap
            take = cand_ok & ~ok
            neg = jnp.where(take, cand, neg)
            ok = ok | cand_ok
            return (neg, ok), None

        (neg, ok), _ = jax.lax.scan(
            one_try, (jnp.zeros(B, jnp.int32), jnp.zeros(B, bool)),
            (jj_bits, j_bits))
        return neg, ok

    def _sample_rankgap_bits(self, start, deg, jj_bits, j_bits,
                             packed4, sel):
        """Rank-gap sampler (module docstring): one [B,4] row-gather
        per try + one sel[rank] gather at the end. Returns
        (neg_idx[B], ok[B])."""
        B = start.shape[0]
        deg_u = deg.astype(jnp.uint32)
        n_sel = sel.shape[0]
        # all tries' rows in ONE gather op (same index count, one
        # dispatch instead of n_tries)
        jj_all = (jj_bits % deg_u[None, :]).astype(jnp.int32)
        rows_all = packed4[start[None, :] + jj_all]  # [n_tries, B, 4]

        def one_try(carry, xs):
            vr, is_rank, ok = carry
            row, b_m = xs
            item_jj = row[:, 0].astype(jnp.int32)
            val_jj = row[:, 1]
            cum_lo = row[:, 2].astype(jnp.int32)
            cnt = row[:, 3].astype(jnp.int32)
            explicit = val_jj == 0.0
            gap_ok = cnt > 0
            m = (b_m % jnp.maximum(cnt, 1).astype(jnp.uint32)
                 ).astype(jnp.int32)
            cand_vr = jnp.where(explicit, item_jj, cum_lo + m)
            cand_is_rank = ~explicit & gap_ok
            cand_ok = explicit | gap_ok
            take = cand_ok & ~ok
            vr = jnp.where(take, cand_vr, vr)
            is_rank = jnp.where(take, cand_is_rank, is_rank)
            ok = ok | cand_ok
            return (vr, is_rank, ok), None

        (vr, is_rank, ok), _ = jax.lax.scan(
            one_try,
            (jnp.zeros(B, jnp.int32), jnp.zeros(B, bool),
             jnp.zeros(B, bool)),
            (rows_all, j_bits))
        neg = jnp.where(is_rank, sel[jnp.clip(vr, 0, n_sel - 1)], vr)
        return neg, ok

    def _sample_negatives(self, key, u, csr=None):
        """Vectorized gap sampling for a batch of users (key-based
        compatibility path; the stream epoch uses the bits cores with
        staged start/deg). Returns (neg_idx[B], ok[B]). ``csr``:
        (indptr, packed, train_items) passed as traced args from the
        epoch (closure constants blow up compile time); defaults to the
        staged arrays for direct calls."""
        if csr is None:
            csr = (self.csr_indptr, self.csr_packed, self.train_items)
        indptr, csr_packed, train_items = csr
        B = u.shape[0]
        start = indptr[u]
        deg = jnp.maximum(indptr[u + 1] - start, 1)
        bits = jax.random.bits(key, (2, self.n_tries, B), jnp.uint32)
        return self._sample_gap_bits(u, start, deg, bits[0], bits[1],
                                     (csr_packed, train_items))

    # ------------------------------------------------------------------
    def _build_epoch(self):
        model = self.model
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        n_batches = self.n_batches
        B = self.batch_size
        eps = float(self.params.eps)
        n_tries = self.n_tries
        rankgap = self.sampler == "rankgap"

        @functools.partial(jax.jit, donate_argnums=(0,))
        def epoch(state: MFState, pos_u, pos_i, pos_valid, pos_start,
                  pos_deg, samp_a, samp_b, lr, key):
            # samp_a/samp_b: (csr_packed4, sel) for rankgap,
            # (csr_packed, train_items) for the literal gap sampler
            k_ord, k_bits, key = jax.random.split(key, 3)
            border = jax.random.permutation(k_ord, n_batches)
            # ALL sampler randomness in one dispatch (in-scan threefry
            # splits/randints cost a pass per batch)
            bits = jax.random.bits(
                k_bits, (n_batches, 2, n_tries, B), jnp.uint32)

            def step(carry, xs):
                st, loss, inv = carry
                b_idx, bbits, k_b = xs
                # contiguous slices + random batch order (element-level
                # rotation costs scalar-gather passes — see solvers/sgd.py)
                k_mask = k_b
                u = jax.lax.dynamic_slice_in_dim(pos_u, b_idx * B, B)
                p = jax.lax.dynamic_slice_in_dim(pos_i, b_idx * B, B)
                v = jax.lax.dynamic_slice_in_dim(pos_valid, b_idx * B, B)
                start = jax.lax.dynamic_slice_in_dim(
                    pos_start, b_idx * B, B)
                deg = jax.lax.dynamic_slice_in_dim(pos_deg, b_idx * B, B)
                if rankgap:
                    neg, ok = self._sample_rankgap_bits(
                        start, deg, bbits[0], bbits[1], samp_a, samp_b)
                else:
                    neg, ok = self._sample_gap_bits(
                        u, start, deg, bbits[0], bbits[1],
                        (samp_a, samp_b))
                w = v * ok.astype(jnp.float32)
                m = model.triple_rank_mask(k_mask, u, p, neg)
                pu = st.u_fac[u]
                qp = st.i_fac[p]
                qn = st.i_fac[neg]
                gu, gp, gn, r_uij, batch_loss = bpr_pair_terms(
                    pu, qp, qn, w, m, u_reg, i_reg)
                inv = inv + jnp.sum((-r_uij > eps) & (w > 0)
                                    ).astype(jnp.int32)
                loss = loss + batch_loss
                # one fused scatter over [p; neg] instead of two passes
                i_idx = jnp.concatenate([p, neg])
                i_upd = jnp.concatenate([gp, gn])
                st = st._replace(
                    u_fac=st.u_fac.at[u].add((-lr * gu).astype(st.u_fac.dtype)),
                    i_fac=st.i_fac.at[i_idx].add((-lr * i_upd).astype(st.i_fac.dtype)))
                return (st, loss, inv), None

            keys = jax.random.split(key, n_batches)
            (state, loss, inv), _ = jax.lax.scan(
                step, (state, jnp.zeros(()), jnp.zeros((), jnp.int32)),
                (border, bits, keys))
            return state, loss, inv

        return epoch

    # ------------------------------------------------------------------
    def _build_posneg_epoch(self):
        model = self.model
        u_reg = float(self.params.u_reg)
        i_reg = float(self.params.i_reg)
        n_batches = self.n_batches
        B = self.batch_size
        eps = float(self.params.eps)
        n_tries = self.n_tries

        @functools.partial(jax.jit, donate_argnums=(0,))
        def epoch(state: MFState, train_user_sd, csr_packed,
                  train_items, lr, key):
            n_tr = train_user_sd.shape[0]
            k_bits, key = jax.random.split(key)
            # all sampler randomness in one dispatch (see stream epoch)
            bits = jax.random.bits(
                k_bits, (n_batches, 2 + 2 * n_tries, B), jnp.uint32)

            def step(carry, xs):
                st, loss, inv = carry
                bbits, k_mask = xs
                u_idx = (bbits[0] % jnp.uint32(n_tr)).astype(jnp.int32)
                usd = train_user_sd[u_idx]          # one [B, 3] gather
                u = usd[:, 0]
                start = usd[:, 1]
                deg = usd[:, 2]
                deg_u = deg.astype(jnp.uint32)
                jj_p = (bbits[1] % deg_u).astype(jnp.int32)
                prow = csr_packed[start + jj_p]
                p = prow[:, 0].astype(jnp.int32)
                pos_rat = prow[:, 1]
                pos_ok = pos_rat > 0

                # negative: explicit lower-rated item or gap item
                def one_try(carry2, bits_t):
                    neg, ok = carry2
                    b_jj, b_m = bits_t
                    jj = (b_jj % deg_u).astype(jnp.int32)
                    row = csr_packed[start + jj]
                    item_jj = row[:, 0].astype(jnp.int32)
                    val_jj = row[:, 1]
                    explicit = val_jj < pos_rat   # :88 explicit negative
                    lo = jnp.where(jj == 0, 0, item_jj + 1)
                    nxt = row[:, 2].astype(jnp.int32)
                    hi = jnp.where(jj == 0, item_jj,
                                   jnp.where(jj == deg - 1, self.n_items,
                                             nxt))
                    span = jnp.maximum(hi - lo, 1)
                    j = lo + (b_m % span.astype(jnp.uint32)
                              ).astype(jnp.int32)
                    gap_ok = (hi - lo > 0) & train_items[
                        jnp.clip(j, 0, self.n_items - 1)]
                    cand = jnp.where(explicit, item_jj, j)
                    cand_ok = explicit | gap_ok
                    take = cand_ok & ~ok
                    return (jnp.where(take, cand, neg), ok | cand_ok), None

                jj_bits = bbits[2: 2 + n_tries]
                m_bits = bbits[2 + n_tries:]
                (neg, ok), _ = jax.lax.scan(
                    one_try, (jnp.zeros(B, jnp.int32),
                              jnp.zeros(B, bool)), (jj_bits, m_bits))
                w = (pos_ok & ok).astype(jnp.float32)
                m = model.triple_rank_mask(k_mask, u, p, neg)
                pu = st.u_fac[u]
                qp = st.i_fac[p]
                qn = st.i_fac[neg]
                gu, gp, gn, r_uij, batch_loss = bpr_pair_terms(
                    pu, qp, qn, w, m, u_reg, i_reg)
                inv = inv + jnp.sum((-r_uij > eps) & (w > 0)
                                    ).astype(jnp.int32)
                loss = loss + batch_loss
                # one fused scatter over [p; neg] instead of two passes
                i_idx = jnp.concatenate([p, neg])
                i_upd = jnp.concatenate([gp, gn])
                st = st._replace(
                    u_fac=st.u_fac.at[u].add((-lr * gu).astype(st.u_fac.dtype)),
                    i_fac=st.i_fac.at[i_idx].add((-lr * i_upd).astype(st.i_fac.dtype)))
                return (st, loss, inv), None

            keys = jax.random.split(key, n_batches)
            (state, loss, inv), _ = jax.lax.scan(
                step, (state, jnp.zeros(()), jnp.zeros((), jnp.int32)),
                (bits, keys))
            return state, loss, inv

        return epoch

    def epoch(self, state: MFState, lr: float, key) -> MFState:
        if self.mode == "posneg":
            state, self.last_loss, self.last_inversions = self._epoch(
                state, self.train_user_sd, self.csr_packed,
                self.train_items, jnp.float32(lr), key)
        else:
            samp = ((self.csr_packed4, self.sel_items)
                    if self.sampler == "rankgap"
                    else (self.csr_packed, self.train_items))
            state, self.last_loss, self.last_inversions = self._epoch(
                state, self.pos_u, self.pos_i, self.pos_valid,
                self.pos_start, self.pos_deg, samp[0], samp[1],
                jnp.float32(lr), key)
        return state
