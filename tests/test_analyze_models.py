"""analyzeModels named surface: averageModels,
compareModels, meanAndVarSameGround{All,Samp}Users against brute-force
numpy oracles over the dense cell grid (the reference loops the cells
scalar-wise; analyzeModels.cpp:338/:489/:1258/:1366)."""

import numpy as np

from matfac_tpu.analysis.compare import (
    average_models_rmse, compare_models_accuracy,
    mean_and_var_same_ground_all_users,
    mean_and_var_same_ground_samp_users, write_accu_counts)
from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.models.base import EvalView

import jax.numpy as jnp


def _view(rng, n_users, n_items, k, bias=False):
    uf = rng.normal(size=(n_users, k)).astype(np.float32) * 0.3
    vf = rng.normal(size=(n_items, k)).astype(np.float32) * 0.3
    ub = (rng.normal(size=n_users).astype(np.float32) * 0.1
          if bias else np.zeros(n_users, np.float32))
    ib = (rng.normal(size=n_items).astype(np.float32) * 0.1
          if bias else np.zeros(n_items, np.float32))
    mu = np.float32(rng.normal() * 0.1 if bias else 0.0)
    return EvalView(jnp.asarray(uf), jnp.asarray(vf), jnp.asarray(ub),
                    jnp.asarray(ib), jnp.asarray(mu))


def _dense_pred(view):
    return (float(view.mu) + np.asarray(view.u_bias)[:, None]
            + np.asarray(view.i_bias)[None, :]
            + np.asarray(view.u_fac) @ np.asarray(view.i_fac).T)


def _setup(seed=0, n_users=60, n_items=40, k=4, m=3):
    rng = np.random.default_rng(seed)
    views = [_view(rng, n_users, n_items, k, bias=(i == 0))
             for i in range(m)]
    orig = _view(rng, n_users, n_items, k)
    nnz = 300
    r = rng.integers(0, n_users, nnz)
    c = rng.integers(0, n_items, nnz)
    key = r * n_items + c
    _, idx = np.unique(key, return_index=True)
    train = RatingMatrix.from_coo(
        r[idx], c[idx], rng.uniform(1, 5, len(idx)).astype(np.float32),
        n_users, n_items)
    iu = np.zeros(n_users, bool)
    ii = np.zeros(n_items, bool)
    iu[[3, 17]] = True
    ii[[5]] = True
    rated = np.zeros((n_users, n_items), bool)
    rr, cc, _ = train.to_coo()
    rated[rr, cc] = True
    ok = (~iu[:, None]) & (~ii[None, :]) & (~rated)
    return views, orig, train, iu, ii, ok


def test_all_users_matches_oracle():
    views, orig, train, iu, ii, ok = _setup()
    out = mean_and_var_same_ground_all_users(views, orig, train, iu, ii,
                                             user_block=16)
    preds = np.stack([_dense_pred(v) for v in views])
    po = _dense_pred(orig)
    cnt = ok.sum()
    rmse_m = np.sqrt((((preds - po[None]) ** 2) * ok[None]
                      ).sum(axis=(1, 2)) / cnt)
    mean = preds.mean(axis=0)
    var = preds.var(axis=0)
    avg_rmse = np.sqrt((((mean - po) ** 2) * ok).sum() / cnt)
    np.testing.assert_allclose(out["rmse_models"], rmse_m, rtol=1e-5)
    assert abs(out["avg_rmse"] - avg_rmse) < 1e-5
    assert abs(out["best_rmse"] - rmse_m.min()) < 1e-5
    assert out["count"] == cnt
    assert abs(out["mean_var"] - (var * ok).sum() / cnt) < 1e-6


def test_average_models_matches_oracle():
    views, orig, train, iu, ii, ok = _setup(seed=1)
    out = average_models_rmse(views, orig, train, iu, ii, user_block=32)
    preds = np.stack([_dense_pred(v) for v in views]).mean(axis=0)
    po = _dense_pred(orig)
    cnt = ok.sum()
    rmse = np.sqrt((((preds - po) ** 2) * ok).sum() / cnt)
    assert abs(out["rmse"] - rmse) < 1e-5
    assert out["count"] == cnt


def test_compare_models_matches_oracle(tmp_path):
    views, orig, train, iu, ii, ok = _setup(seed=2, m=2)
    first, second = views
    eps = 0.25
    out = compare_models_accuracy(first, second, orig, train, iu, ii,
                                  epsilon=eps, user_block=16)
    p1, p2, po = (_dense_pred(first), _dense_pred(second),
                  _dense_pred(orig))
    a1 = (np.abs(p1 - po) <= eps) & ok
    a2 = (np.abs(p2 - po) <= eps) & ok
    i1 = (np.abs(p1 - po) > eps) & ok
    i2 = (np.abs(p2 - po) > eps) & ok
    np.testing.assert_array_equal(out["first_accu"], a1.sum(axis=0))
    np.testing.assert_array_equal(out["second_accu"], a2.sum(axis=0))
    np.testing.assert_array_equal(out["both_accu"],
                                  (a1 & a2).sum(axis=0))
    np.testing.assert_array_equal(out["first_inaccu"], i1.sum(axis=0))
    np.testing.assert_array_equal(out["second_inaccu"], i2.sum(axis=0))
    np.testing.assert_array_equal(out["both_inaccu"],
                                  (i1 & i2).sum(axis=0))
    path = tmp_path / "accu.txt"
    write_accu_counts(str(path), out, ii)
    lines = path.read_text().splitlines()
    # one line per VALID item, 7 columns (analyzeModels.cpp:613-623)
    assert len(lines) == (~ii).sum()
    assert all(len(ln.split()) == 7 for ln in lines)


def test_samp_users_matches_oracle():
    views, orig, train, iu, ii, ok = _setup(seed=3)
    out = mean_and_var_same_ground_samp_users(
        views, orig, train, iu, ii, samp_frac=0.2, seed=11)
    users, items = out["users"], out["items"]
    # sampled pairs are valid, unrated, and unique per item
    assert ok[users, items].all()
    for item in np.unique(items):
        pick = users[items == item]
        assert len(np.unique(pick)) == len(pick)
        assert len(pick) == min(int(0.2 * 60), ok[:, item].sum())
    preds = np.stack([_dense_pred(v) for v in views])
    po = _dense_pred(orig)
    np.testing.assert_allclose(out["mean"],
                               preds[:, users, items].mean(axis=0),
                               rtol=1e-5)
    np.testing.assert_allclose(out["var"],
                               preds[:, users, items].var(axis=0),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        out["err"],
        np.abs(preds[:, users, items].mean(axis=0) - po[users, items]),
        rtol=1e-4, atol=1e-6)


def test_invalid_item_excluded_from_sampling():
    views, orig, train, iu, ii, ok = _setup(seed=4)
    out = mean_and_var_same_ground_samp_users(
        views, orig, train, iu, ii, samp_frac=0.1, seed=5)
    assert not np.isin(np.nonzero(ii)[0], out["items"]).any()
    assert not np.isin(np.nonzero(iu)[0], out["users"]).any()
