"""Long-tail adaptive models (WWW'19): IFWMF, TMF, TMF+Dropout.

JAX re-design of /root/reference/modelInvPopMF.cpp,
modelDropoutSigmoid.cpp and modelPoissonDropout.cpp: per-entity
popularity weights and sigmoid/Poisson effective ranks are precomputed
dense device tables; truncation becomes factor masking (see
models/base.py for why pair-rank truncation factorizes per entity).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.models.base import ModelMF, rank_mask


class ModelInvPopMF(ModelMF):
    """IFWMF — inverse-popularity-frequency weighted MF.

    Weight semantics (modelInvPopMF.cpp:98-178): per-entity popularity
    score = freq / n_valid_other_side, normalized to sum 1 over valid
    entities; per-rating weight uses the **less frequent** of (u, i)'s
    score p and multiplies only the data-fit term with
    w = 1 / (1 + rhoRMS * p).
    """

    name = "ifwmf"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        valid_u = (~invalid_users if invalid_users is not None
                   else np.ones(n_users, bool))
        valid_i = (~invalid_items if invalid_items is not None
                   else np.ones(n_items, bool))
        n_tr_users = max(int(valid_u.sum()), 1)
        n_tr_items = max(int(valid_i.sum()), 1)
        inv_pop_u = np.where(valid_u, user_freq / n_tr_items, 0.0)
        s = inv_pop_u.sum()
        inv_pop_u = inv_pop_u / (s if s > 0 else 1.0)
        inv_pop_i = np.where(valid_i, item_freq / n_tr_users, 0.0)
        s = inv_pop_i.sum()
        inv_pop_i = inv_pop_i / (s if s > 0 else 1.0)
        self.inv_pop_u = jnp.asarray(inv_pop_u, jnp.float32)
        self.inv_pop_i = jnp.asarray(inv_pop_i, jnp.float32)
        self._user_freq_dev = jnp.asarray(user_freq, jnp.float32)
        self._item_freq_dev = jnp.asarray(item_freq, jnp.float32)

    def example_weight(self, u_idx, i_idx):
        fu = self._user_freq_dev[u_idx]
        fi = self._item_freq_dev[i_idx]
        # default item score; switch to user score when the item is MORE
        # frequent than the user (modelInvPopMF.cpp:163-168)
        pop = jnp.where(fi > fu, self.inv_pop_u[u_idx],
                        self.inv_pop_i[i_idx])
        return 1.0 / (1.0 + self.params.rho_rms * pop)


def _sigmoid_rank_table(freq: np.ndarray, mean: float, std: float,
                        rho: float, alpha: float, k: int) -> np.ndarray:
    """R(f) = clamp(ceil(sigmoid(rho*((f-mean)/std - alpha)) * k), 1, k) —
    the TMF effective-rank map (modelDropoutSigmoid.cpp:158-172).
    Monotone nondecreasing in f for rho >= 0, which is what makes pair
    ranks factorize as min(R(fu), R(fi))."""
    scale = (freq - mean) / (std if std > 0 else 1.0)
    sigm = 1.0 / (1.0 + np.exp(-rho * (scale - alpha)))
    ranks = np.ceil(sigm * k).astype(np.int64)
    return np.clip(ranks, 1, k).astype(np.int32)


class ModelDropoutSigmoid(ModelMF):
    """TMF — truncate prediction/update to the first
    R(min_freq(u,i)) dims (modelDropoutSigmoid.cpp:140-246).

    The z-scoring constants are mean/std of concat(userFreq, itemFreq)
    over ALL entities (modelDropoutSigmoid.h ctor)."""

    name = "tmf"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        concat = np.concatenate([user_freq, item_freq]).astype(np.float64)
        self.mean_freq = float(concat.mean())
        self.std_freq = float(concat.std())
        if params.rho_rms < 0:
            raise ValueError("TMF requires rho_rms >= 0 (monotone rank map)")
        self.rank_u = jnp.asarray(_sigmoid_rank_table(
            user_freq, self.mean_freq, self.std_freq, params.rho_rms,
            params.alpha, self.k))
        self.rank_i = jnp.asarray(_sigmoid_rank_table(
            item_freq, self.mean_freq, self.std_freq, params.rho_rms,
            params.alpha, self.k))

    def entity_ranks(self):
        return self.rank_u, self.rank_i

    def pair_rank(self, u_idx, i_idx):
        return jnp.minimum(self.rank_u[u_idx], self.rank_i[i_idx])

    def update_rank_mask(self, key, u_idx, i_idx):
        return rank_mask(self.pair_rank(u_idx, i_idx), self.k)


def poisson_cdf_ranks(fac_dim: int, cdf_cut: float = 0.99) -> np.ndarray:
    """initCDFRanks (modelPoissonDropout.cpp:25-47): for each lambda in
    1..k, the smallest index m with P(X <= m+1) >= cdf_cut under
    Poisson(lambda) — prediction then uses dims 0..m inclusive. Replicates
    the reference loop exactly, including the k==facDim fallback."""
    out = np.zeros(fac_dim, dtype=np.int32)
    for lam in range(1, fac_dim + 1):
        cdf = math.exp(-lam)  # P(X = 0)
        k = 0
        for k in range(fac_dim):
            wt = math.exp(-lam + (k + 1) * math.log(lam)
                          - math.lgamma(k + 2))  # P(X = k+1)
            cdf += wt
            if cdf >= cdf_cut:
                break
        else:
            k = fac_dim - 1
        out[lam - 1] = k
    return out


class ModelPoissonDropout(ModelDropoutSigmoid):
    """TMF+Dropout — training rank sampled per example from
    Poisson(lambda(u,i)), lambda = ceil(sigmPc * k); inference uses the
    deterministic Poisson-0.99-CDF truncation (modelPoissonDropout.cpp)."""

    name = "tmf_dropout"
    stochastic_rank = True

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray, **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        # entity lambda tables == the sigmoid rank tables of TMF
        self.lambda_u = self.rank_u
        self.lambda_i = self.rank_i
        cdf_ranks = poisson_cdf_ranks(self.k)
        # inference dims for lambda: cdfRanks[lambda-1]+1, capped at k
        eff = np.minimum(cdf_ranks + 1, self.k).astype(np.int32)
        eff_dev = jnp.asarray(eff)
        self.rank_u = eff_dev[self.lambda_u - 1]
        self.rank_i = eff_dev[self.lambda_i - 1]
        self.cdf_ranks = cdf_ranks

    def pair_lambda(self, u_idx, i_idx):
        return jnp.minimum(self.lambda_u[u_idx], self.lambda_i[i_idx])

    def update_rank_mask(self, key, u_idx, i_idx):
        lam = self.pair_lambda(u_idx, i_idx).astype(jnp.float32)
        r = jax.random.poisson(key, lam).astype(jnp.int32)
        r = jnp.clip(r, 1, self.k)   # modelPoissonDropout.cpp:200-206
        return rank_mask(r, self.k)

    def entity_lambdas(self):
        """Per-entity TRAINING lambda tables (int32 in [1, k]) — the
        sigmoid rank map before the CDF inference transform. Consumed
        by the dense row engine's per-round CRN Poisson resampling."""
        return self.lambda_u, self.lambda_i

    def poisson_cdf_table(self) -> np.ndarray:
        """C [k, k] f32 with C[lam-1, m] = P(Poisson(lam) <= m) for
        m = 0..k-1 — the quantile table behind the dense engine's
        common-random-number rank draw (README deviation #15):

        per round the engine draws ONE uniform U and sets every
        entity's rank to the Poisson quantile
        q(lam) = clip(#{m : C[lam-1, m] < U}, 1, k). Because the
        Poisson family is stochastically increasing in lam, q is
        monotone nondecreasing in lam, so the PAIR rank
        min(q(lam_u), q(lam_i)) equals q(min(lam_u, lam_i)) — and for
        uniform U that quantile transform has EXACTLY the reference's
        per-update marginal clip(Poisson(lam_pair), 1, k)
        (modelPoissonDropout.cpp:189-207). What differs is only the
        correlation structure: within one stripe visit all pairs share
        the round's quantile level, and an entity's rank is redrawn
        per stripe visit rather than per rating."""
        k = self.k
        C = np.zeros((k, k), np.float64)
        for lam in range(1, k + 1):
            cdf = math.exp(-lam)                       # P(X = 0)
            C[lam - 1, 0] = cdf
            for m in range(1, k):
                cdf += math.exp(-lam + m * math.log(lam)
                                - math.lgamma(m + 1))  # P(X = m)
                C[lam - 1, m] = cdf
        return C.astype(np.float32)


def adaptive_rank_map(freq: np.ndarray, fac_dim: int) -> np.ndarray:
    """setAdapRank (main.cpp:1109-1135): entities sorted by DESCENDING
    frequency are split into four quartiles assigned ranks
    k, k/2, k/4, k/8 (integer halving, floor 1; the 4th part absorbs
    the remainder). Ties break by entity id (the reference's std::sort
    on (id, freq) pairs is unstable; we pin stable id order)."""
    freq = np.asarray(freq, np.float64)
    n = len(freq)
    order = np.argsort(-freq, kind="stable")
    ranks = np.zeros(n, np.int32)
    cur, i, part = fac_dim, 0, 0
    while i < n:
        end = int(i + 0.25 * n)
        if end > n or part == 3:
            end = n
        end = max(end, i + 1)   # tiny-n guard (reference assumes n>=4)
        ranks[order[i:end]] = cur
        cur = max(cur // 2, 1)
        i, part = end, part + 1
    return ranks


class ModelAdaptiveDropoutMF(ModelMF):
    """othersrc ModelDropoutMF — adaptive-rank MF with a SOFT
    three-tier prediction (othersrc/modelDropoutMF.cpp:4-20):

        estRating = sum_k w_k u_k v_k,
        w_k = 1.0  for k <  c           (c = max(facDim/8, 1))
              0.5  for c <= k < minRank (minRank = min(rank_u, rank_i))
              0.15 for k >= minRank

    Design: the pair-dependent soft weights factorize into a
    width-DOUBLED per-entity embedding, so scoring stays one dense
    matmul — with m_e = [k < rank_e] and g = [k >= c]:

        w_k = alpha_k + 0.35 * g_k * m_u,k * m_i,k
        (alpha_k = 1 for k < c else 0.15;
         checks: k<c -> alpha=1, g=0; c<=k<minR -> 0.15+0.35=0.5;
         k>=minR -> m_u*m_i=0 -> 0.15)

        estRating = <[u*alpha ; 0.35*u*m_u*g], [v ; v*m_i*g]>

    (the asymmetric split keeps f32 exactness — no sqrt rounding).
    Rank maps are the frequency-quartile assignment of
    main.cpp setAdapRank. Training rank per update
    (update_rank_mask, SGD engine only — the masks are RANDOM):

      * mode='prob'        (trainSGDProbPar, :423-650): minRank
        lifted to facDim with prob rhoRMS (default 0.3 when unset,
        :548-550); predict+update HARD-truncated at that rank
        (adapDotProd, :579).
      * mode='ordered'     (trainSGDProbOrderedPar, :650-884): prob
        lift, then with prob 0.5 cap at c (:800-808).
      * mode='onlyordered' (trainSGDOnlyOrderedPar, :884-1115): full
        rank, with prob 0.5 capped at c (:1037-1042).

    The ranks-list curriculum trainer (trainSGDAdapPar, :201-423) is
    intentionally subsumed: stage-wise dim growth is ModelIncrement's
    mechanism and stage-wise entity gating is mf_freq's.
    """

    name = "dropoutmf"
    stochastic_rank = True

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 mode: str = "prob", **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        if mode not in ("prob", "ordered", "onlyordered"):
            raise ValueError(f"unknown dropoutmf mode {mode!r}")
        self.mode = mode
        self.cand = max(self.k // 8, 1)
        # rhoRMS < EPS -> 0.3 (modelDropoutMF.cpp:548-550)
        self.rho = (params.rho_rms if params.rho_rms >= params.eps
                    else 0.3)
        self.rank_u = jnp.asarray(adaptive_rank_map(user_freq, self.k))
        self.rank_i = jnp.asarray(adaptive_rank_map(item_freq, self.k))

    def pair_rank(self, u_idx, i_idx):
        return jnp.minimum(self.rank_u[u_idx], self.rank_i[i_idx])

    def update_rank_mask(self, key, u_idx, i_idx):
        if self.mode == "onlyordered":
            cap = jax.random.uniform(key, u_idx.shape) <= 0.5
            r = jnp.where(cap, self.cand, self.k)
        else:
            r = self.pair_rank(u_idx, i_idx)
            k1, k2 = jax.random.split(key)
            lift = ((r != self.k)
                    & (jax.random.uniform(k1, u_idx.shape) <= self.rho))
            r = jnp.where(lift, self.k, r)
            if self.mode == "ordered":
                cap = jax.random.uniform(k2, u_idx.shape) <= 0.5
                r = jnp.where(cap, jnp.minimum(r, self.cand), r)
        return rank_mask(r, self.k)

    def entity_ranks(self):
        return None   # soft three-tier eval below, not hard truncation

    def eval_view(self, state):
        iota = np.arange(self.k)
        alpha = jnp.asarray(np.where(iota < self.cand, 1.0, 0.15),
                            jnp.float32)
        gate = jnp.asarray((iota >= self.cand).astype(np.float32))
        m_u = rank_mask(self.rank_u, self.k)
        m_i = rank_mask(self.rank_i, self.k)
        uf = state.u_fac.astype(jnp.float32)
        vf = state.i_fac.astype(jnp.float32)
        u_hat = jnp.concatenate(
            [uf * alpha[None, :], 0.35 * uf * m_u * gate[None, :]],
            axis=1)
        v_hat = jnp.concatenate([vf, vf * m_i * gate[None, :]], axis=1)
        from matfac_tpu.models.base import EvalView
        z_u = jnp.zeros_like(state.u_bias)
        z_i = jnp.zeros_like(state.i_bias)
        return EvalView(u_hat, v_hat, z_u, z_i,
                        jnp.zeros_like(state.mu))


class ModelDropoutSigmoidBias(ModelDropoutSigmoid):
    """TMF + biases — othersrc's ModelDropoutMFBias: estRating is the
    rank-truncated dot PLUS u/i biases with NO global mean
    (othersrc/modelDropoutMFBias.cpp:3-23), biases trained by the same
    SGD rule as the factors (grad -2*diff + 2*reg*bias,
    othersrc/modelDropoutMFBias.cpp:243-261). The abandoned reference
    keys its rank off an externally supplied userRankMap/itemRankMap
    (modelDropoutMF.h ctor); here the map is the TMF sigmoid table —
    the map the main-tree models derive from the same frequencies."""

    name = "tmf_bias"
    use_bias = True


class ModelLocalityMF(ModelMF):
    """MFLoc — static head/tail rank split (othersrc/modelMFLoc.cpp).

    Tail entities (outside the ``head_pc`` rating-mass head,
    getHeadItems/getHeadUsers util.cpp:4-66) live in the first
    fac_dim/2 dims only: their upper factor halves are zeroed at init
    (zeroedTail*Facs, modelMFLoc.cpp:4-31) and every update writes only
    the first effFacDim dims of each SIDE independently
    (modelMFLoc.cpp:124-159 — the full gradient incl. reg is computed,
    then applied to dims < effFacDim). Prediction stays the FULL-rank
    dot (modelMFLoc.cpp:120-121); because masked dims start at zero and
    are never updated, the full dot equals the rank-truncated dot, so
    ``entity_ranks`` exposes the truncation for the fused eval path.
    """

    name = "mf_loc"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 head_user_mask: np.ndarray, head_item_mask: np.ndarray,
                 **_):
        super().__init__(params, n_users, n_items)
        tail_rank = max(self.k // 2, 1)
        hu = np.zeros(n_users, bool)
        hu[: len(head_user_mask)] = head_user_mask[:n_users]
        hi = np.zeros(n_items, bool)
        hi[: len(head_item_mask)] = head_item_mask[:n_items]
        self.rank_u = jnp.asarray(
            np.where(hu, self.k, tail_rank).astype(np.int32))
        self.rank_i = jnp.asarray(
            np.where(hi, self.k, tail_rank).astype(np.int32))

    def entity_ranks(self):
        return self.rank_u, self.rank_i

    def update_side_masks(self, u_idx, i_idx):
        return (rank_mask(self.rank_u[u_idx], self.k),
                rank_mask(self.rank_i[i_idx], self.k))

    def transform_init_state(self, state):
        return state._replace(
            u_fac=state.u_fac * rank_mask(self.rank_u, self.k
                                          ).astype(state.u_fac.dtype),
            i_fac=state.i_fac * rank_mask(self.rank_i, self.k
                                          ).astype(state.i_fac.dtype))


class ModelSideGatedMF(ModelMF):
    """Plain MF whose user-side / item-side updates are gated by static
    per-entity {0,1} masks — the building block of ModelMFFreq's
    head-first curriculum (othersrc/modelMFFreq.cpp:1-41: updateModelInval
    skips the USER update when u is in the phase's invalid set and the
    ITEM update when i is, while the prediction always uses both).
    ``gate_u``/``gate_i`` are boolean [n_users]/[n_items] = "this
    entity's factors train in this phase"."""

    name = "mf_freq"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 gate_u: np.ndarray, gate_i: np.ndarray, **_):
        super().__init__(params, n_users, n_items)
        self._gate_u = jnp.asarray(gate_u.astype(np.float32))
        self._gate_i = jnp.asarray(gate_i.astype(np.float32))

    def update_side_masks(self, u_idx, i_idx):
        return (self._gate_u[u_idx][:, None],
                self._gate_i[i_idx][:, None])


class ModelHeadWeightedMF(ModelMF):
    """Head-item down-weighted MF — othersrc's ModelMFWt experiment
    (othersrc/modelMFWt.cpp:151-176): per-rating data-fit weight
    lambda0 for HEAD items (the items covering ``head_pc`` of rating
    mass, getHeadItems util.cpp:4-34) and lambda0 + lambda1 = 1.0 for
    tail items, so tail ratings drive the fit harder. The weight rides
    the data-fit gradient and the objective's squared error only (same
    hook as IFWMF). Note: the abandoned reference's OBJECTIVE
    additionally intersects head USERS (modelMFWt.cpp:31-44) while its
    train rule keys on items alone — we follow the train rule for
    both, which makes objective and gradient consistent.
    """

    name = "mf_headwt"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 head_item_mask: np.ndarray, lambda0: float = 0.8):
        super().__init__(params, n_users, n_items)
        self.lambda0 = float(lambda0)
        hm = np.zeros(n_items, bool)
        hm[: len(head_item_mask)] = head_item_mask[:n_items]
        self._head = jnp.asarray(hm)

    def example_weight(self, u_idx, i_idx):
        return jnp.where(self._head[i_idx], self.lambda0, 1.0)
