"""BlockSGDSolver / one-hot cell engine tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import low_rank_ratings, synthetic_data
from matfac_tpu.eval.metrics import Evaluator
from matfac_tpu.models.base import ModelMF, init_state
from matfac_tpu.solvers.block_sgd import BlockSGDSolver
from matfac_tpu.utils import freq


def _mk(collision_norm, seed=5):
    mat, _, _ = low_rank_ratings(30, 20, 3, density=0.4, seed=seed,
                                 noise=0.05, nonneg=True)
    params = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
                    seed=2)
    iu, ii = freq.invalid_users_items(mat, 30, 20)
    model = ModelMF(params, 30, 20)
    sol = BlockSGDSolver(model, params, mat, iu, ii, batch_size=8,
                         bu=8, bi=8, collision_norm=collision_norm,
                         mm_bf16=False)
    return mat, params, model, sol, iu, ii


@pytest.mark.parametrize("collision_norm", [False, True])
def test_block_sgd_matches_numpy_oracle(collision_norm):
    """One kernel epoch == a literal numpy transcription of the cell
    schedule (same staged stream, same per-batch stale-value update)."""
    mat, params, model, sol, iu, ii = _mk(collision_norm)
    # a twin solver consumes its schedule rng identically
    _, _, _, twin, _, _ = _mk(collision_norm)
    row_of, ib_seq, boff = [np.asarray(x) for x in twin._build_schedule()]

    state = init_state(params, 30, 20, seed=3)
    out = sol.epoch(state, params.learn_rate, None)

    # ---- numpy oracle over the same staged arrays ----
    u_tab = np.asarray(state.u_fac)[np.asarray(sol.u_perm_inv_dev)]
    i_tab = np.asarray(state.i_fac)[np.asarray(sol.i_perm_inv_dev)]
    u_loc = np.asarray(sol.u_loc)
    i_loc = np.asarray(sol.i_loc)
    vals = np.asarray(sol.vals)
    wts = np.asarray(sol.wts)
    bs, bu, bi, S = sol.bs, sol.bu, sol.bi, sol.S
    n_steps = S // bs
    lr, ur, ir = params.learn_rate, params.u_reg, params.i_reg
    for t in range(sol.NU):
        row = int(row_of[t])
        U = u_tab[row * bu:(row + 1) * bu]
        for j in range(sol.NI):
            ib = int(ib_seq[t, j])
            I = i_tab[ib * bi:(ib + 1) * bi]
            for s in range(n_steps):
                start = ib * S + ((s + int(boff[t, j])) % n_steps) * bs
                sl = slice(start, start + bs)
                u, i = u_loc[row, sl], i_loc[row, sl]
                r, w = vals[row, sl], wts[row, sl]
                pu, qi = U[u], I[i]
                pred = (pu * qi).sum(1)
                coeff = w * (r - pred)
                vmask = (w > 0).astype(np.float32)
                gu = (-2 * coeff[:, None] * qi
                      + 2 * ur * vmask[:, None] * pu)
                gi = (-2 * coeff[:, None] * pu
                      + 2 * ir * vmask[:, None] * qi)
                if collision_norm:
                    cu = np.zeros(bu)
                    np.add.at(cu, u, vmask)
                    ci = np.zeros(bi)
                    np.add.at(ci, i, vmask)
                    gu = gu / np.maximum(cu[u], 1)[:, None]
                    gi = gi / np.maximum(ci[i], 1)[:, None]
                np.add.at(U, u, -lr * gu)
                np.add.at(I, i, -lr * gi)
    want_u = u_tab[np.asarray(sol.u_perm_dev)]
    want_i = i_tab[np.asarray(sol.i_perm_dev)]
    np.testing.assert_allclose(np.asarray(out.u_fac), want_u,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.i_fac), want_i,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("collision_norm", [False, True])
def test_block_sgd_diag_matches_numpy_oracle(collision_norm):
    """One diag-schedule epoch == a literal numpy transcription of the
    DSGD rounds (disjoint cells per round all see the same pre-round
    factor blocks is NOT required — cells are axis-disjoint, so
    sequential application per round is identical)."""
    mat, _, _ = low_rank_ratings(30, 20, 3, density=0.4, seed=5,
                                 noise=0.05, nonneg=True)
    params = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
                    seed=2)
    iu, ii = freq.invalid_users_items(mat, 30, 20)
    model = ModelMF(params, 30, 20)

    def mk():
        return BlockSGDSolver(model, params, mat, iu, ii, batch_size=8,
                              bu=8, bi=8,
                              collision_norm=collision_norm,
                              mm_bf16=False, schedule="diag")

    sol, twin = mk(), mk()
    # the diag schedule is generated ON-DEVICE from a key drawn from
    # the host schedule rng — replicate via the twin's identical rng
    from matfac_tpu.ops.block_sgd_kernel import device_diag_schedule
    ek = jax.random.PRNGKey(int(twin._sched_rng.integers(2 ** 31)))
    ub_idx, ib_idx, boff = [
        np.asarray(x) for x in device_diag_schedule(
            ek, twin.NU, twin.NI, twin.S // twin.bs)]

    state = init_state(params, 30, 20, seed=3)
    out = sol.epoch(state, params.learn_rate, None)

    u_tab = np.asarray(state.u_fac)[np.asarray(sol.u_perm_inv_dev)]
    i_tab = np.asarray(state.i_fac)[np.asarray(sol.i_perm_inv_dev)]
    u_loc = np.asarray(sol.u_loc)
    i_loc = np.asarray(sol.i_loc)
    vals = np.asarray(sol.vals)
    wts = np.asarray(sol.wts)
    bs, bu, bi, S = sol.bs, sol.bu, sol.bi, sol.S
    NU, NI = sol.NU, sol.NI
    n_cells = NU * NI
    n_steps = S // bs
    lr, ur, ir = params.learn_rate, params.u_reg, params.i_reg
    for t in range(ub_idx.shape[0]):
        for lane in range(ub_idx.shape[1]):
            ub, ib = int(ub_idx[t, lane]), int(ib_idx[t, lane])
            cell = min(ub * NI + ib, n_cells)
            if ub >= NU:
                continue  # dummy lane: all-invalid stream, no-op
            U = u_tab[ub * bu:(ub + 1) * bu]
            I = i_tab[ib * bi:(ib + 1) * bi]
            for s in range(n_steps):
                start = ((s + int(boff[t, lane])) % n_steps) * bs
                sl = slice(start, start + bs)
                u, i = u_loc[cell, sl], i_loc[cell, sl]
                r, w = vals[cell, sl], wts[cell, sl]
                pu, qi = U[u], I[i]
                pred = (pu * qi).sum(1)
                coeff = w * (r - pred)
                vmask = (w > 0).astype(np.float32)
                gu = (-2 * coeff[:, None] * qi
                      + 2 * ur * vmask[:, None] * pu)
                gi = (-2 * coeff[:, None] * pu
                      + 2 * ir * vmask[:, None] * qi)
                if collision_norm:
                    cu = np.zeros(bu)
                    np.add.at(cu, u, vmask)
                    ci = np.zeros(bi)
                    np.add.at(ci, i, vmask)
                    gu = gu / np.maximum(cu[u], 1)[:, None]
                    gi = gi / np.maximum(ci[i], 1)[:, None]
                np.add.at(U, u, -lr * gu)
                np.add.at(I, i, -lr * gi)
    want_u = u_tab[np.asarray(sol.u_perm_dev)]
    want_i = i_tab[np.asarray(sol.i_perm_dev)]
    np.testing.assert_allclose(np.asarray(out.u_fac), want_u,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.i_fac), want_i,
                               rtol=2e-4, atol=2e-4)


def test_block_sgd_diag_converges():
    data, _, _ = synthetic_data(n_users=60, n_items=40, k=3,
                                density=0.35, seed=8, noise=0.05,
                                nonneg=True)
    params = Params(fac_dim=6, u_reg=0.002, i_reg=0.002,
                    learn_rate=0.05, seed=1)
    iu, ii = freq.invalid_users_items(data.train_mat, 60, 40)
    model = ModelMF(params, 60, 40)
    sol = BlockSGDSolver(model, params, data.train_mat, iu, ii,
                         batch_size=16, bu=16, bi=16, mm_bf16=False,
                         schedule="diag")
    ev = Evaluator(data, iu, ii, params)
    st = init_state(params, 60, 40)
    for e in range(60):
        st = sol.epoch(st, params.learn_rate, None)
    val = ev.rmse(model.eval_view(st), "val")
    assert val < 0.35, val


@pytest.mark.parametrize("schedule", ["row", "diag"])
def test_block_sgd_pad_k_exact(schedule):
    """Zero-padding the factor width (pad_k) is exactly equivalent:
    padded dims have zero prediction contribution and zero gradient, so
    epochs agree to f32 roundoff and the pad columns stay zero."""
    mat, _, _ = low_rank_ratings(30, 20, 3, density=0.4, seed=5,
                                 noise=0.05, nonneg=True)
    params = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, learn_rate=0.05,
                    seed=2)
    iu, ii = freq.invalid_users_items(mat, 30, 20)
    model = ModelMF(params, 30, 20)

    def mk(pad):
        return BlockSGDSolver(model, params, mat, iu, ii, batch_size=8,
                              bu=8, bi=8, mm_bf16=False,
                              schedule=schedule, pad_k=pad)

    state = init_state(params, 30, 20, seed=3)
    out0 = mk(0).epoch(state, params.learn_rate, None)
    outp = mk(16).epoch(state, params.learn_rate, None)
    assert outp.u_fac.shape == out0.u_fac.shape
    np.testing.assert_allclose(np.asarray(outp.u_fac),
                               np.asarray(out0.u_fac),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(outp.i_fac),
                               np.asarray(out0.i_fac),
                               rtol=1e-6, atol=1e-7)


def test_block_sgd_converges():
    data, _, _ = synthetic_data(n_users=60, n_items=40, k=3,
                                density=0.35, seed=8, noise=0.05,
                                nonneg=True)
    params = Params(fac_dim=6, u_reg=0.002, i_reg=0.002,
                    learn_rate=0.05, seed=1)
    iu, ii = freq.invalid_users_items(data.train_mat, 60, 40)
    model = ModelMF(params, 60, 40)
    sol = BlockSGDSolver(model, params, data.train_mat, iu, ii,
                         batch_size=16, bu=16, bi=16, mm_bf16=False)
    ev = Evaluator(data, iu, ii, params)
    st = init_state(params, 60, 40)
    for e in range(60):
        st = sol.epoch(st, params.learn_rate, None)
    val = ev.rmse(model.eval_view(st), "val")
    assert val < 0.35, val


def test_block_sgd_rejects_removed_pallas_engine():
    mat, params, model, _, iu, ii = _mk(False)
    with pytest.raises(ValueError, match="engine"):
        BlockSGDSolver(model, params, mat, iu, ii, engine="pallas")


def test_block_sgd_via_train_model():
    from matfac_tpu.train.loop import train_model

    data, _, _ = synthetic_data(n_users=40, n_items=30, k=3,
                                density=0.35, seed=4, noise=0.05,
                                nonneg=True)
    params = Params(fac_dim=4, u_reg=0.002, i_reg=0.002,
                    learn_rate=0.05, max_iter=8, batch_size=16, seed=1)
    rep, model, ev, _ = train_model(data, params, mf_method="blocksgd",
                                    log_fn=lambda s: None)
    assert np.isfinite(rep.best_metric)


def test_block_sgd_auto_batch_sizing():
    """batch_size=None sizes the diag minibatch for ~64k ratings per
    sequential step (the medium-shape dispatch-floor fix), fitted so
    cell padding stays small, and still converges."""
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.eval.metrics import Evaluator
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.solvers.block_sgd import BlockSGDSolver
    from matfac_tpu.utils import freq

    data, _, _ = synthetic_data(n_users=160, n_items=96, k=4,
                                density=0.3, seed=9, noise=0.05)
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
               seed=5)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMF(p, data.n_users, data.n_items)
    s = BlockSGDSolver(model, p, data.train_mat, iu, ii,
                       batch_size=None, bu=16, bi=8, schedule="diag")
    # auto lands on a multiple of 256 fitted to the max cell
    assert s.bs % 256 == 0 or s.bs == s.S
    assert s.S % s.bs == 0
    assert s.S - s.bs < 256 * max(s.S // s.bs, 1)
    ev = Evaluator(data, iu, ii, p)
    state = init_state(p, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(50):
        key, k = jax.random.split(key)
        state = s.epoch(state, 0.02, k)
    val = ev.rmse(model.eval_view(state), "val")
    assert val < 0.3, val
