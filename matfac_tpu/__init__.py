"""matfac_tpu — a JAX matrix-factorization framework.

A from-scratch JAX/XLA re-design of the capabilities of the
``mohit-shrma/matfac`` C++/OpenMP reference: scalable matrix completion via
SGD / ALS / CCD / CCD++, the WWW'19 long-tail adaptive models (MF, IFWMF,
TMF sigmoid-dropout, TMF+Poisson-dropout), and BPR pairwise ranking —
plus the evaluation protocols (invalid-entity-filtered RMSE, leave-one-out
HR@10 / ARHR / NDCG@10, quartile and head/tail analyses).

Design notes (accelerator-first, not a port):
  * Ratings live on device as padded COO shards; factor tables are dense
    ``[n, k]`` arrays that can be row-sharded over a ``jax.sharding.Mesh``.
  * The reference's sequential / hogwild SGD becomes minibatched
    scatter-add SGD (deterministic segment-sum gradient aggregation).
  * ALS becomes bucketed, padded per-row Gram accumulation + batched
    Cholesky solves; CCD++ becomes residual segment-sum sweeps.
  * The long-tail models are per-example weight / rank-mask functions fused
    into one generic update engine (masking == truncation mathematically).
"""

from matfac_tpu.config import Params
from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.data.dataset import Data

__version__ = "0.1.0"

__all__ = ["Params", "RatingMatrix", "Data", "__version__"]
