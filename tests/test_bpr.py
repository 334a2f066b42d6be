"""BPR solver + model tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import leave_one_out_data
from matfac_tpu.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
from matfac_tpu.solvers.bpr import BPRSolver
from matfac_tpu.train.loop import train_model
from matfac_tpu.utils import freq


@pytest.fixture(scope="module")
def lo_data():
    return leave_one_out_data(n_users=80, n_items=50, per_user=14, seed=6,
                              structured=True)


def test_negative_sampling_validity(lo_data):
    data = lo_data
    params = Params(fac_dim=4, seed=0, batch_size=128)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMFBPR(params, data.n_users, data.n_items)
    solver = BPRSolver(model, params, data.train_mat, iu, ii,
                       batch_size=128, n_tries=16)
    u = solver.pos_u[:128]
    neg, ok = jax.jit(solver._sample_negatives)(jax.random.PRNGKey(0), u)
    neg = np.asarray(neg)
    ok = np.asarray(ok)
    u = np.asarray(u)
    assert ok.mean() > 0.9  # dense-ish rows still leave many gaps
    deg_i = data.train_mat.col_degrees()
    for b in range(128):
        if not ok[b]:
            continue
        rated = set(data.train_mat.row(u[b])[0])
        assert neg[b] not in rated, f"sampled a rated item for user {u[b]}"
        assert deg_i[neg[b]] > 0  # trainItems membership


def test_rankgap_sampler_validity_and_support(lo_data):
    """rankgap sampler: every accepted negative is an unrated train
    item of the user, and its support equals the union of
    train-items-in-gaps (same accept support as the literal sampler)."""
    data = lo_data
    params = Params(fac_dim=4, seed=0, batch_size=128)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMFBPR(params, data.n_users, data.n_items)
    solver = BPRSolver(model, params, data.train_mat, iu, ii,
                       batch_size=128, n_tries=16, sampler="rankgap")
    start = solver.pos_start[:128]
    deg = solver.pos_deg[:128]
    deg_i = data.train_mat.col_degrees()
    u = np.asarray(solver.pos_u[:128])
    seen = {b: set() for b in range(128)}
    for s in range(40):
        bits = jax.random.bits(jax.random.PRNGKey(s), (2, 16, 128),
                               jnp.uint32)
        neg, ok = jax.jit(solver._sample_rankgap_bits)(
            start, deg, bits[0], bits[1], solver.csr_packed4,
            solver.sel_items)
        neg, ok = np.asarray(neg), np.asarray(ok)
        for b in range(128):
            if not ok[b]:
                continue
            rated = set(data.train_mat.row(u[b])[0])
            assert neg[b] not in rated
            assert deg_i[neg[b]] > 0  # trainItems membership
            seen[b].add(int(neg[b]))
    # support check on user 0: all train items outside the rated row
    # that fall in a sampleable gap must be reachable
    u0 = int(u[0])
    cols = data.train_mat.row(u0)[0]
    gaps = [(0, cols[0])] + [(cols[i] + 1, cols[i + 1])
                             for i in range(len(cols) - 1)] \
        + [(cols[-1] + 1, data.n_items)]
    expect = {j for lo, hi in gaps for j in range(lo, hi)
              if deg_i[j] > 0}
    b0 = [b for b in range(128) if u[b] == u0]
    got = set().union(*(seen[b] for b in b0))
    assert got <= expect
    # with 40x16 tries across this user's lanes we should cover most
    assert len(got) >= min(len(expect), 5)


def test_samplers_accept_explicit_zeros():
    """Rated-with-zero entries are direct-accept negatives in BOTH
    samplers (modelMFBPR.cpp:206-210 explicit-zero branch), and
    positively-rated items are never sampled."""
    from matfac_tpu.data.csr import RatingMatrix

    rng = np.random.default_rng(0)
    n_users, n_items = 60, 40
    rows, cols, vals = [], [], []
    for u in range(n_users):
        its = rng.choice(n_items, size=12, replace=False)
        for i, it in enumerate(sorted(its)):
            rows.append(u)
            cols.append(it)
            vals.append(0.0 if i % 3 == 0 else 5.0)  # third rated zero
    mat = RatingMatrix.from_coo(np.array(rows), np.array(cols),
                                np.array(vals, np.float32),
                                n_users, n_items)
    params = Params(fac_dim=4, seed=0, batch_size=64)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    model = ModelMFBPR(params, n_users, n_items)
    pos_of = {u: set(mat.row(u)[0][mat.row(u)[1] > 0])
              for u in range(n_users)}
    zero_of = {u: set(mat.row(u)[0][mat.row(u)[1] == 0.0])
               for u in range(n_users)}
    for sampler in ("gap", "rankgap"):
        solver = BPRSolver(model, params, mat, iu, ii, batch_size=64,
                           n_tries=16, sampler=sampler)
        u = np.asarray(solver.pos_u[:64])
        start = solver.pos_start[:64]
        deg = solver.pos_deg[:64]
        got_zero = 0
        for s in range(30):
            bits = jax.random.bits(jax.random.PRNGKey(s), (2, 16, 64),
                                   jnp.uint32)
            if sampler == "rankgap":
                neg, ok = jax.jit(solver._sample_rankgap_bits)(
                    start, deg, bits[0], bits[1], solver.csr_packed4,
                    solver.sel_items)
            else:
                neg, ok = jax.jit(solver._sample_gap_bits)(
                    jnp.asarray(u), start, deg, bits[0], bits[1],
                    (solver.csr_packed, solver.train_items))
            neg, ok = np.asarray(neg), np.asarray(ok)
            for b in range(64):
                if not ok[b]:
                    continue
                assert neg[b] not in pos_of[u[b]], (sampler, u[b], neg[b])
                if neg[b] in zero_of[u[b]]:
                    got_zero += 1
        # explicit zeros are 1/3 of each row's sampled positions —
        # they must actually be reachable
        assert got_zero > 50, (sampler, got_zero)


def test_bpr_training_improves_hr(lo_data):
    data = lo_data
    params = Params(fac_dim=8, u_reg=0.001, i_reg=0.001, learn_rate=0.3,
                    max_iter=30, seed=2, batch_size=256, disp_iter=1000,
                    eval_user_block=128, eval_item_block=128)
    rep, model, scorer, _ = train_model(data, params, algo="bpr",
                                        log_fn=lambda s: None)
    # random HR@10 would be ~10/(50-12) ≈ 0.26; trained must beat it big
    assert rep.best_metric > 0.55, f"best HR {rep.best_metric}"


def test_bpr_poisson_masks_updates(lo_data):
    data = lo_data
    params = Params(fac_dim=8, rho_rms=1.0, alpha=0.5, seed=2)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    uf, itf = freq.row_col_freq(data.train_mat)
    uf = np.resize(uf, data.n_users)
    itf = np.resize(itf, data.n_items)
    model = ModelBPRPoissonDropout(params, data.n_users, data.n_items,
                                   uf, itf)
    m = model.triple_rank_mask(jax.random.PRNGKey(0),
                               jnp.arange(16), jnp.arange(16),
                               jnp.arange(16, 32))
    m = np.asarray(m)
    assert m.shape == (16, 8)
    # prefix masks: each row is 1s then 0s with at least one 1
    for row in m:
        ones = int(row.sum())
        assert ones >= 1
        np.testing.assert_array_equal(row[:ones], 1.0)
        np.testing.assert_array_equal(row[ones:], 0.0)


def test_bpr_poisson_end_to_end(lo_data):
    data = lo_data
    params = Params(fac_dim=8, u_reg=0.001, i_reg=0.001, learn_rate=0.3,
                    max_iter=12, seed=2, batch_size=256, disp_iter=1000,
                    rho_rms=1.0, alpha=0.0,
                    eval_user_block=128, eval_item_block=128)
    rep, model, scorer, _ = train_model(data, params,
                                        algo="bprPoissonDropout",
                                        log_fn=lambda s: None)
    assert np.isfinite(rep.best_metric)
    assert rep.best_metric > 0.3


def test_bpr_posneg_mode(lo_data):
    """posneg sampling mode with HR selection (NDCG selection needs
    >=2-entry val rows, which leave-one-out data lacks by design)."""
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.models.base import init_state
    from matfac_tpu.train.loop import TrainLoopHR

    data = lo_data
    params = Params(fac_dim=8, u_reg=0.001, i_reg=0.001, learn_rate=0.3,
                    max_iter=20, seed=2, batch_size=256, disp_iter=1000)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMFBPR(params, data.n_users, data.n_items)
    solver = BPRSolver(model, params, data.train_mat, iu, ii,
                       batch_size=256, mode="posneg")
    scorer = CatalogScorer(data.train_mat, iu, ii, data.n_users,
                           data.n_items, user_block=128, item_block=128)
    loop = TrainLoopHR(model, solver, scorer, data.val_mat, params,
                       log_fn=lambda s: None)
    rep = loop.run(init_state(params, data.n_users, data.n_items))
    assert rep.best_metric > 0.5, rep.best_metric


def test_bpr_loss_no_overflow_at_extreme_scores(lo_data):
    """softplus via logaddexp: r_uij ~ -3600 overflowed the old
    log1p(exp(-r)) to inf in f32 (reference computes in double; advisor
    round-1 finding). The loss must stay finite."""
    data = lo_data
    params = Params(fac_dim=4, seed=0, batch_size=128, u_reg=0.0,
                    i_reg=0.0, learn_rate=0.0)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMFBPR(params, data.n_users, data.n_items)
    solver = BPRSolver(model, params, data.train_mat, iu, ii,
                       batch_size=128, n_tries=8)
    from matfac_tpu.models.base import init_state
    st = init_state(params, data.n_users, data.n_items)
    # rated items score hugely negative, everything else hugely positive
    rated = np.zeros(data.n_items, bool)
    rated[data.train_mat.indices] = True
    i_fac = np.where(rated[:, None], -30.0, 30.0).astype(np.float32)
    st = st._replace(u_fac=jnp.ones_like(st.u_fac) * 30.0,
                     i_fac=jnp.asarray(np.broadcast_to(
                         i_fac, (data.n_items, 4)).copy()))
    solver.epoch(st, 0.0, jax.random.PRNGKey(0))
    assert np.isfinite(float(solver.last_loss))
    assert float(solver.last_loss) > 0


def _run_hr_loop(data, params, prefix, resume):
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.models.base import init_state
    from matfac_tpu.train.loop import TrainLoopHR

    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMFBPR(params, data.n_users, data.n_items)
    solver = BPRSolver(model, params, data.train_mat, iu, ii,
                       batch_size=256)
    scorer = CatalogScorer(data.train_mat, iu, ii, data.n_users,
                           data.n_items, user_block=128, item_block=128)
    loop = TrainLoopHR(model, solver, scorer, data.val_mat, params,
                       log_fn=lambda s: None, prefix=prefix,
                       invalid_users=iu, invalid_items=ii)
    return loop.run(init_state(params, data.n_users, data.n_items),
                    resume=resume)


def test_hr_loop_resume_bit_exact(lo_data, tmp_path):
    """TrainLoopHR checkpoint/resume: a BPR run
    interrupted at epoch 5 and resumed reaches the SAME final state and
    best HR as an uninterrupted run — the raw PRNG key chain, decayed
    lr, best snapshot and solver loss/inversions are all persisted
    (bestModel semantics, model.cpp:89-101 / modelMFBPR.cpp:405-559)."""
    import os

    from matfac_tpu.train import checkpoint as ckpt

    data = lo_data
    base = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, learn_rate=0.1,
                  max_iter=10, seed=3, batch_size=256, disp_iter=1000,
                  save_iter=1)
    rep_full = _run_hr_loop(data, base, str(tmp_path / "full"), False)
    _run_hr_loop(data, base.replace(max_iter=5),
                 str(tmp_path / "part"), False)
    rep_res = _run_hr_loop(data, base, str(tmp_path / "part"), True)
    np.testing.assert_array_equal(np.asarray(rep_full.state.u_fac),
                                  np.asarray(rep_res.state.u_fac))
    np.testing.assert_array_equal(np.asarray(rep_full.state.i_fac),
                                  np.asarray(rep_res.state.i_fac))
    assert rep_full.best_metric == rep_res.best_metric
    assert rep_full.best_iter == rep_res.best_iter
    # best-on-validation factors + invalid sets are on disk with the
    # model-signature names
    sig = ckpt.model_signature(base, data.n_users, data.n_items)
    up, ip = ckpt.fac_paths(str(tmp_path / "full"), sig)
    assert os.path.exists(up) and os.path.exists(ip)
    assert os.path.exists(str(tmp_path / "full") + "_invalUsers.txt")


def test_bpr_train_model_prefix_checkpoints(lo_data, tmp_path):
    """The train_model front door forwards prefix to the ranking loop."""
    import os

    from matfac_tpu.train import checkpoint as ckpt

    data = lo_data
    params = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, learn_rate=0.1,
                    max_iter=3, seed=2, batch_size=256, disp_iter=1000,
                    save_iter=1, eval_user_block=128, eval_item_block=128)
    prefix = str(tmp_path / "bpr")
    rep, model, scorer, _ = train_model(data, params, algo="bpr",
                                        log_fn=lambda s: None,
                                        prefix=prefix)
    sig = ckpt.model_signature(params, data.n_users, data.n_items)
    up, ip = ckpt.fac_paths(prefix, sig)
    assert os.path.exists(up) and os.path.exists(ip)
    assert os.path.exists(prefix + "_loop.npz")
    # the text checkpoint holds the BEST snapshot
    from matfac_tpu.models.base import init_state
    st = ckpt.load_facs(init_state(params, data.n_users, data.n_items),
                        prefix, sig)
    np.testing.assert_allclose(np.asarray(st.u_fac),
                               np.asarray(rep.best_state.u_fac),
                               rtol=0, atol=2e-5)
