"""Serving-path tests."""

import numpy as np
import pytest

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import leave_one_out_data, synthetic_data
from matfac_tpu.models.base import ModelMF, init_state
from matfac_tpu.serving import Recommender
from matfac_tpu.train import checkpoint as ck
from matfac_tpu.utils import freq


def test_recommender_excludes_rated_and_ranks():
    data = leave_one_out_data(n_users=50, n_items=40, per_user=10,
                              seed=3, structured=True)
    params = Params(fac_dim=6, seed=1)
    model = ModelMF(params, data.n_users, data.n_items)
    state = init_state(params, data.n_users, data.n_items)
    rec = Recommender(model.eval_view(state), data.train_mat,
                      data.n_users, data.n_items, user_block=16,
                      item_block=16)
    users = [0, 7, 33]
    items, scores = rec.recommend(users, n=5)
    assert items.shape == (3, 5)
    for j, u in enumerate(users):
        rated = set(data.train_mat.row(u)[0])
        assert not (set(items[j]) & rated)
        # scores descending
        assert (np.diff(scores[j]) <= 1e-6).all()
    with pytest.raises(ValueError):
        rec.recommend([999])


def test_recommender_has_no_pallas_option():
    data = leave_one_out_data(n_users=20, n_items=16, per_user=4, seed=5)
    params = Params(fac_dim=4, seed=2)
    model = ModelMF(params, data.n_users, data.n_items)
    view = model.eval_view(init_state(params, data.n_users, data.n_items))
    with pytest.raises(TypeError):
        Recommender(view, data.train_mat, data.n_users, data.n_items,
                    use_pallas=True)


def test_recommender_from_checkpoint(tmp_path):
    from matfac_tpu.train import train_model

    data, _, _ = synthetic_data(n_users=60, n_items=45, k=3,
                                density=0.35, seed=7, noise=0.05,
                                nonneg=True)
    p = Params(fac_dim=3, u_reg=0.05, i_reg=0.05, max_iter=8, seed=1,
               batch_size=256, disp_iter=1000)
    prefix = str(tmp_path / "m")
    train_model(data, p, mf_method="als", log_fn=lambda s: None,
                prefix=prefix)
    rec = Recommender.from_checkpoint(prefix, p, data, user_block=16,
                                      item_block=16)
    items, scores = rec.recommend([0, 5], n=3)
    assert np.isfinite(scores).all()
    with pytest.raises(FileNotFoundError):
        Recommender.from_checkpoint(str(tmp_path / "nope"), p, data)


def test_recommend_chunks_large_queries():
    """Queries above the per-dispatch cap chunk correctly and agree
    with the eval scorer's full-catalog top-k."""
    from matfac_tpu.data.synthetic import leave_one_out_data
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.serving import Recommender
    from matfac_tpu.utils import freq

    n_users, n_items = 5000, 64
    data = leave_one_out_data(n_users=n_users, n_items=n_items,
                              per_user=6, seed=2)
    params = Params(fac_dim=4, seed=3)
    model = ModelMF(params, n_users, n_items)
    view = model.eval_view(init_state(params, n_users, n_items))
    iu, ii = freq.invalid_users_items(data.train_mat, n_users, n_items)
    rec = Recommender(view, data.train_mat, n_users, n_items, iu, ii,
                      user_block=256, item_block=64)
    users = list(range(n_users))          # > the 4096 chunk cap
    items, scores = rec.recommend(users, n=5)
    assert items.shape == (n_users, 5)
    sc = CatalogScorer(data.train_mat, iu, ii, n_users, n_items,
                       user_block=256, item_block=64)
    _, expect = sc.topk(view, 5)
    np.testing.assert_array_equal(items, expect)
