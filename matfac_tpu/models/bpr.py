"""BPR ranking models: plain BPR and the BPR x TMF+Poisson hybrid.

JAX analog of ModelMFBPR (/root/reference/modelMFBPR.cpp) and
ModelBPRPoissonDropout (/root/reference/modelBPRPoissonDropout.cpp).
Prediction is the plain factor dot; what differs from pointwise MF is
the *pairwise* sigmoid update and HR-based model selection, which live
in solvers/bpr.py and train/loop.py (TrainLoopHR). The Poisson hybrid
contributes a per-triple rank mask from the minimum frequency among
(user, positive, negative) (modelBPRPoissonDropout.cpp:169-191).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.models.base import ModelMF, rank_mask
from matfac_tpu.models.longtail import (ModelDropoutSigmoid,
                                        poisson_cdf_ranks)


class ModelMFBPR(ModelMF):
    """Plain BPR: full-rank pairwise updates (modelMFBPR.cpp:405-559)."""

    name = "bpr"
    is_ranking = True

    def triple_rank_mask(self, key, u_idx, pos_idx, neg_idx
                         ) -> Optional[jax.Array]:
        """[B, k] mask of dims used in a pairwise update; None = full."""
        return None


class ModelBPRPoissonDropout(ModelDropoutSigmoid):
    """BPR x TMF hybrid.

    Training rank: lambda = ceil(sigmoid-rank of the LEAST frequent of
    (u, pos, neg)); sampled ~ Poisson(lambda) in `train`
    (modelBPRPoissonDropout.cpp:76-259), deterministic lambda in
    `trainSigmoid` (:262-441). Inference truncates at the Poisson
    0.99-CDF rank like TMF+Dropout (own initCDFRanks, :3-23).
    """

    name = "bpr_poisson"
    is_ranking = True

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 sample_poisson: bool = True, **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        self.sample_poisson = sample_poisson
        self.lambda_u = self.rank_u
        self.lambda_i = self.rank_i
        cdf = poisson_cdf_ranks(self.k)
        eff = np.minimum(cdf + 1, self.k).astype(np.int32)
        eff_dev = jnp.asarray(eff)
        # inference ranks (estRating, modelBPRPoissonDropout.cpp:27-47)
        self.rank_u = eff_dev[self.lambda_u - 1]
        self.rank_i = eff_dev[self.lambda_i - 1]

    def triple_rank_mask(self, key, u_idx, pos_idx, neg_idx):
        lam = jnp.minimum(jnp.minimum(self.lambda_u[u_idx],
                                      self.lambda_i[pos_idx]),
                          self.lambda_i[neg_idx])
        if self.sample_poisson:
            r = jax.random.poisson(key, lam.astype(jnp.float32)
                                   ).astype(jnp.int32)
            r = jnp.clip(r, 1, self.k)
        else:
            r = lam
        return rank_mask(r, self.k)
