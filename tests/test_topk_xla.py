"""The XLA top-N path (eval/ranking.topk_catalog_block behind
Recommender, and CatalogScorer's COO-exclusion pass) against a numpy
brute force: rated and invalid items excluded, scores descending,
lowest item id first on ties."""

import numpy as np
import pytest

import jax.numpy as jnp

from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.eval.ranking import CatalogScorer
from matfac_tpu.models.base import EvalView
from matfac_tpu.serving import Recommender
from matfac_tpu.utils import freq


def _case(n_users, n_items, k, seed, ties):
    rng = np.random.default_rng(seed)
    if ties:
        # integer factors: many exactly equal scores per user
        u = rng.integers(-2, 3, (n_users, k)).astype(np.float32)
        it = rng.integers(-2, 3, (n_items, k)).astype(np.float32)
    else:
        u = rng.standard_normal((n_users, k)).astype(np.float32)
        it = rng.standard_normal((n_items, k)).astype(np.float32)
    rows = rng.integers(0, n_users, 6 * n_users)
    cols = rng.integers(0, n_items - 3, 6 * n_users)   # last 3 unrated
    key = np.unique(rows.astype(np.int64) * n_items + cols)
    mat = RatingMatrix.from_coo(key // n_items, key % n_items,
                                np.ones(len(key), np.float32), n_users,
                                n_items)
    view = EvalView(jnp.asarray(u), jnp.asarray(it),
                    jnp.zeros(n_users), jnp.zeros(n_items),
                    jnp.float32(0))
    return mat, view, u, it


def _brute(mat, u, it, invalid_items, n):
    s = u.astype(np.float64) @ it.astype(np.float64).T
    s[:, invalid_items] = -np.inf
    for r in range(len(u)):
        s[r, mat.row(r)[0]] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :n], s


@pytest.mark.parametrize("n_items,item_block,n,ties", [
    (64, 32, 10, False),    # catalog a multiple of item_block
    (70, 32, 10, False),    # ... and not (padded, masked tail)
    (64, 32, 1, False),
    (70, 32, 1, False),
    (64, 32, 10, True),     # exact ties: lowest id wins
])
def test_xla_topk_matches_bruteforce(n_items, item_block, n, ties):
    n_users = 40
    mat, view, u, it = _case(n_users, n_items, 6, 11, ties)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    want, s = _brute(mat, u, it, ii, n)
    users = np.arange(n_users)
    rec = Recommender(view, mat, n_users, n_items, iu, ii, user_block=16,
                      item_block=item_block)
    got, scores = rec.recommend(users, n=n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(scores, np.take_along_axis(s, want, 1),
                               rtol=1e-5)
    _, got_all = CatalogScorer(mat, iu, ii, n_users, n_items,
                               user_block=16,
                               item_block=item_block).topk(view, n)
    np.testing.assert_array_equal(got_all, want)
