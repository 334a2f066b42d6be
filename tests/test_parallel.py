"""Sharding tests on the virtual 8-device CPU mesh."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from matfac_tpu.config import Params
from matfac_tpu.data.synthetic import synthetic_data
from matfac_tpu.eval.metrics import Evaluator
from matfac_tpu.models.base import ModelMF, init_state
from matfac_tpu.models.longtail import ModelInvPopMF
from matfac_tpu.parallel.dsgd import DSGDShardedSolver
from matfac_tpu.parallel.mesh import make_mesh, shard_state
from matfac_tpu.utils import freq

NOISE = 0.05


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    mesh2 = make_mesh((4, 2), ("u", "i"))
    assert mesh2.shape == {"u": 4, "i": 2}
    with pytest.raises(ValueError):
        make_mesh((3, 2))


def test_shard_state_placement():
    params = Params(fac_dim=4)
    mesh = make_mesh((4, 2), ("u", "i"))
    state = init_state(params, 64, 32)
    sharded = shard_state(state, mesh)
    assert sharded.u_fac.sharding.spec == P("u", None)
    assert sharded.i_fac.sharding.spec == P("i", None)
    np.testing.assert_allclose(np.asarray(sharded.u_fac),
                               np.asarray(state.u_fac))


def test_shard_state_replicates_uneven_tables():
    """A height that does not divide the mesh axis (ML-20M's 138,493
    users over 4 devices) replicates that table instead of failing."""
    params = Params(fac_dim=4)
    mesh = make_mesh((4,), ("u",), devices=jax.devices()[:4])
    state = init_state(params, 66, 32)
    sharded = shard_state(state, mesh, "u", "u")
    assert sharded.u_fac.sharding.spec == P(None, None)
    assert sharded.u_bias.sharding.spec == P(None)
    assert sharded.i_fac.sharding.spec == P("u", None)
    assert len(sharded.u_fac.sharding.device_set) == 4
    np.testing.assert_array_equal(np.asarray(sharded.u_fac),
                                  np.asarray(state.u_fac))


@pytest.fixture(scope="module")
def setup():
    data, _, _ = synthetic_data(n_users=160, n_items=96, k=4,
                                density=0.3, seed=9, noise=NOISE)
    params = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
                    seed=5, batch_size=256)
    inval_u, inval_i = freq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    ev = Evaluator(data, inval_u, inval_i, params)
    model = ModelMF(params, data.n_users, data.n_items)
    return data, params, ev, model, inval_u, inval_i


def test_dsgd_partition_covers_all_ratings(setup):
    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((8,), ("u",))
    solver = DSGDShardedSolver(model, params, data.train_mat, iu, ii, mesh)
    wts = np.asarray(solver.wts)
    assert int((wts > 0).sum()) == solver.nnz
    # every staged entry lands in the correct (shard, round) cell
    u_loc = np.asarray(solver.u_loc)
    i_loc = np.asarray(solver.i_loc)
    N = solver.n_shards
    for shard in range(N):
        for rnd in range(N):
            mask = wts[shard, rnd] > 0
            gu = u_loc[shard, rnd][mask] + shard * solver.bu
            blk = (shard + rnd) % N
            gi = i_loc[shard, rnd][mask] + blk * solver.bi
            assert (gu < data.n_users).all()
            assert (gi < data.n_items).all()
            assert (gu // solver.bu == shard).all()
            assert (gi // solver.bi == blk).all()


def test_dsgd_converges_on_mesh(setup):
    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((8,), ("u",))
    solver = DSGDShardedSolver(model, params, data.train_mat, iu, ii, mesh,
                               batch_size=256)
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(60):
        key, k = jax.random.split(key)
        state = solver.epoch(state, 0.02, k)
    val = ev.rmse(model.eval_view(state), "val")
    assert val < 3 * NOISE + 0.05, f"val RMSE {val}"


def test_dsgd_single_shard_matches_convergence(setup):
    """1-shard DSGD is plain minibatch SGD — same convergence regime."""
    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((1,), ("u",), devices=jax.devices()[:1])
    solver = DSGDShardedSolver(model, params, data.train_mat, iu, ii, mesh,
                               batch_size=256)
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(60):
        key, k = jax.random.split(key)
        state = solver.epoch(state, 0.02, k)
    val = ev.rmse(model.eval_view(state), "val")
    assert val < 3 * NOISE + 0.1


def test_dsgd_with_ifwmf_weights(setup):
    data, params, ev, model, iu, ii = setup
    uf, itf = freq.row_col_freq(data.train_mat)
    uf = np.resize(uf, data.n_users)
    itf = np.resize(itf, data.n_items)
    m = ModelInvPopMF(params, data.n_users, data.n_items, uf, itf,
                      invalid_users=iu, invalid_items=ii)
    mesh = make_mesh((8,), ("u",))
    solver = DSGDShardedSolver(m, params, data.train_mat, iu, ii, mesh,
                               batch_size=256)
    # staged weights match the model's weight fn
    wts = np.asarray(solver.wts)
    real = wts[wts > 0]
    assert (real <= 1.0 + 1e-6).all() and real.min() < 1.0
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(30):
        key, k = jax.random.split(key)
        state = solver.epoch(state, 0.02, k)
    val = ev.rmse(m.eval_view(state), "val")
    assert val < 0.5


def test_sharded_als_spmd(setup):
    """Row-sharded tables + the bucketed ALS under SPMD
    auto-partitioning: converges and preserves sharding."""
    from matfac_tpu.solvers.als import ALSSolver

    data, params, ev, model, iu, ii = setup
    solver = ALSSolver(model, params, data.train_mat, iu, ii)
    mesh = make_mesh((8,), ("u",))
    state = shard_state(init_state(params, data.n_users, data.n_items),
                        mesh, "u", "u")
    for _ in range(8):
        state = solver.epoch(state, 0, None)
    # nonneg gate: this dataset has signed ratings, ALS sees only
    # positive ones — just require finite + sharding preserved and
    # objective sane
    val = ev.rmse(model.eval_view(state), "val")
    assert np.isfinite(val)
    assert state.u_fac.sharding.spec == P("u", None)


def test_graft_entry_dryrun():
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1024,)
    g.dryrun_multichip(8)


def test_train_model_with_mesh(setup):
    """train_model front door with a mesh routes SGD through the
    sharded DSGD solver and the full termination loop."""
    from matfac_tpu.train.loop import train_model

    data, _, _, _, iu, ii = setup
    mesh = make_mesh((8,), ("u",))
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.02,
               max_iter=25, seed=5, batch_size=256, disp_iter=1000)
    rep, model, ev, _ = train_model(data, p, algo="mf",
                                    mf_method="sgdpar",
                                    log_fn=lambda s: None, mesh=mesh)
    assert rep.best_metric < 1.0, rep.best_metric


def test_dsgd_with_tmf_rank_tables(setup):
    """DSGD staging honors TMF deterministic pair ranks and TMF+Poisson
    sampling flags."""
    from matfac_tpu.models.longtail import (ModelDropoutSigmoid,
                                            ModelPoissonDropout)

    data, params, ev, _, iu, ii = setup
    uf, itf = freq.row_col_freq(data.train_mat)
    uf = np.resize(uf, data.n_users)
    itf = np.resize(itf, data.n_items)
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, rho_rms=1.0,
               alpha=0.0, seed=5, batch_size=256)
    mesh = make_mesh((8,), ("u",))
    for cls, sampled in ((ModelDropoutSigmoid, False),
                         (ModelPoissonDropout, True)):
        m = cls(p, data.n_users, data.n_items, uf, itf)
        solver = DSGDShardedSolver(m, p, data.train_mat, iu, ii, mesh,
                                   batch_size=256)
        assert solver.sample_poisson == sampled
        lams = np.asarray(solver.lams)
        real = np.asarray(solver.wts) > 0
        assert lams[real].min() >= 1 and lams[real].max() <= p.fac_dim
        state = init_state(p, data.n_users, data.n_items)
        key = jax.random.PRNGKey(0)
        for _ in range(10):
            key, kk = jax.random.split(key)
            state = solver.epoch(state, 0.02, kk)
        val = ev.rmse(m.eval_view(state), "val")
        assert np.isfinite(val)


def test_dsgd_item_balancing():
    """balance_items spreads a power-law item distribution evenly over
    blocks and still converges to the same regime."""
    from matfac_tpu.data.synthetic import synthetic_data as sd

    data, _, _ = sd(n_users=160, n_items=96, k=4, density=0.3, seed=13,
                    noise=0.05, power_law=1.2)
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, seed=5,
               batch_size=256)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMF(p, data.n_users, data.n_items)
    mesh = make_mesh((8,), ("u",))
    plain = DSGDShardedSolver(model, p, data.train_mat, iu, ii, mesh,
                              batch_size=256)
    bal = DSGDShardedSolver(model, p, data.train_mat, iu, ii, mesh,
                            batch_size=256, balance_items=True)

    def block_loads(solver):
        wts = np.asarray(solver.wts) > 0
        # ratings per item block = per (shard, round) col-block cell sums
        return wts.reshape(solver.n_shards * solver.n_shards, -1
                           ).sum(axis=1)

    # balanced staging has a smaller max cell (padded S is set by it)
    assert bal.S <= plain.S
    # permutation is a bijection
    assert sorted(bal.item_perm) == list(range(data.n_items))

    ev = Evaluator(data, iu, ii, p)
    vals = {}
    for name, solver in (("plain", plain), ("balanced", bal)):
        state = init_state(p, data.n_users, data.n_items)
        key = jax.random.PRNGKey(0)
        for _ in range(40):
            key, k = jax.random.split(key)
            state = solver.epoch(state, 0.02, k)
        vals[name] = ev.rmse(model.eval_view(state), "val")
    # hot-item collisions destabilize the plain variant on this
    # power-law data; balancing must not be worse
    assert vals["balanced"] <= vals["plain"] + 0.05, vals
    assert vals["balanced"] < 0.8, vals


def test_dsgd_two_process_distributed(tmp_path):
    """Real multi-host path: two jax.distributed
    processes, each staging only its host-local rating rows and its own
    4 of 8 shard blocks, produce the SAME trained factors as one process
    staging everything on an 8-device mesh."""
    import socket
    import subprocess
    import sys

    # free port for the coordination service
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    worker = os.path.join(os.path.dirname(__file__), "dsgd_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(worker))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i}:\n{outs[i]}"
        assert "WORKER_OK" in outs[i]
    multi = np.load(str(tmp_path / "multi.npz"))

    # identical problem on the in-process single-process 8-device mesh
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.parallel.dsgd import DSGDShardedSolver
    from matfac_tpu.utils import freq as ufreq
    data, _, _ = synthetic_data(n_users=64, n_items=48, k=3,
                                density=0.3, seed=11, noise=0.05,
                                nonneg=True)
    params = Params(fac_dim=3, u_reg=0.02, i_reg=0.02, learn_rate=0.03,
                    batch_size=32, seed=3)
    iu, ii = ufreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    mesh = make_mesh()
    model = ModelMF(params, data.n_users, data.n_items)
    solver = DSGDShardedSolver(model, params, data.train_mat, iu, ii,
                               mesh)
    state = init_state(params, data.n_users, data.n_items, seed=7)
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, ek = jax.random.split(key)
        state = solver.epoch(state, params.learn_rate, ek)
    np.testing.assert_allclose(multi["u_fac"], np.asarray(state.u_fac),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(multi["i_fac"], np.asarray(state.i_fac),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# Block-DSGD: the one-hot engine nested inside mesh-sharded DSGD
# ----------------------------------------------------------------------

def test_block_dsgd_partition_covers_all_ratings(setup):
    from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((8,), ("u",))
    s = BlockDSGDSolver(model, params, data.train_mat, iu, ii, mesh,
                        sub_bu=8, sub_bi=4, batch_size=16)
    wts = np.asarray(s.wts)          # [N, N, SU*SI+1, S] cell-major
    assert int((wts > 0).sum()) == s.nnz
    # dummy row (last cell per shard-round) is all-invalid
    assert (wts[:, :, -1, :] == 0).all()
    # every staged entry maps back to a rating in the right cell
    u_loc = np.asarray(s.u_loc)
    i_loc = np.asarray(s.i_loc)
    vals = np.asarray(s.vals)
    u_inv = np.asarray(s.u_perm_inv_dev)
    i_inv = np.asarray(s.i_perm_inv_dev)
    r, c, v = data.train_mat.to_coo()
    truth = {(int(a), int(b)): float(x) for a, b, x in zip(r, c, v)}
    N, SU, SI, S = s.n_shards, s.SU, s.SI, s.S
    for sh in range(N):
        for t in range(N):
            blk = (sh + t) % N
            for cell in range(SU * SI):
                su, si = divmod(cell, SI)
                mask = wts[sh, t, cell] > 0
                gu_new = (sh * s.bu + su * s.sub_bu
                          + u_loc[sh, t, cell])
                gi_new = (blk * s.bi + si * s.sub_bi
                          + i_loc[sh, t, cell])
                for j in np.nonzero(mask)[0]:
                    uo = int(u_inv[gu_new[j]])
                    io = int(i_inv[gi_new[j]])
                    assert truth[(uo, io)] == vals[sh, t, cell, j]


def test_block_dsgd_converges_on_mesh(setup):
    from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((8,), ("u",))
    s = BlockDSGDSolver(model, params, data.train_mat, iu, ii, mesh,
                        sub_bu=8, sub_bi=4, batch_size=16)
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(60):
        key, k = jax.random.split(key)
        state = s.epoch(state, 0.02, k)
    val = ev.rmse(model.eval_view(state), "val")
    assert val < 3 * NOISE + 0.05, f"val RMSE {val}"


def test_block_dsgd_single_shard_converges(setup):
    from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((1,), ("u",), devices=jax.devices()[:1])
    s = BlockDSGDSolver(model, params, data.train_mat, iu, ii, mesh,
                        sub_bu=16, sub_bi=8, batch_size=32)
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(60):
        key, k = jax.random.split(key)
        state = s.epoch(state, 0.02, k)
    val = ev.rmse(model.eval_view(state), "val")
    assert val < 3 * NOISE + 0.1, f"val RMSE {val}"


def test_block_dsgd_two_process_distributed(tmp_path):
    """The headline multi-chip engine stages multi-process (VERDICT r2
    #1): two jax.distributed processes, each staging only its
    host-local rating rows and its own 4 of 8 shard blocks, produce
    the SAME trained factors as one process staging everything."""
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    worker = os.path.join(os.path.dirname(__file__),
                          "block_dsgd_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(worker))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i}:\n{outs[i]}"
        assert "WORKER_OK" in outs[i]
        # multi-host orbax sharded checkpoint round-trip succeeded
        assert "ORBAX_OK" in outs[i]
    multi = np.load(str(tmp_path / "multi.npz"))

    # identical problem, single process, 8-device mesh
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver
    from matfac_tpu.utils import freq as ufreq
    data, _, _ = synthetic_data(n_users=64, n_items=48, k=3,
                                density=0.3, seed=11, noise=0.05,
                                nonneg=True)
    params = Params(fac_dim=3, u_reg=0.02, i_reg=0.02, learn_rate=0.03,
                    batch_size=16, seed=3)
    iu, ii = ufreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    mesh = make_mesh()
    model = ModelMF(params, data.n_users, data.n_items)
    solver = BlockDSGDSolver(model, params, data.train_mat, iu, ii,
                             mesh, sub_bu=8, sub_bi=4, batch_size=16)
    state = init_state(params, data.n_users, data.n_items, seed=7)
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, ek = jax.random.split(key)
        state = solver.epoch(state, params.learn_rate, ek)
    np.testing.assert_allclose(multi["u_fac"], np.asarray(state.u_fac),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(multi["i_fac"], np.asarray(state.i_fac),
                               rtol=1e-6, atol=1e-6)


def test_train_model_mesh_auto_and_bias_guard(setup):
    """auto under a mesh resolves to sharded ALS for plain MF (VERDICT
    r2 #6); bias models are rejected with a clear error."""
    from matfac_tpu.train.loop import train_model

    data, _, _, _, iu, ii = setup
    mesh = make_mesh((8,), ("u",))
    p = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, max_iter=6, seed=5,
               disp_iter=10 ** 6)
    logs = []
    rep, model, ev, _ = train_model(data, p, algo="mf",
                                    mf_method="auto",
                                    log_fn=logs.append, mesh=mesh)
    assert any("resolved to 'als'" in s for s in logs), logs
    assert np.isfinite(rep.best_metric)
    assert rep.best_state.u_fac.sharding.spec == P("u", None)

    with pytest.raises(ValueError, match="bias models"):
        train_model(data, p, algo="mf_bias", mf_method="auto",
                    log_fn=lambda s: None, mesh=mesh)


def test_block_dsgd_tmf_rank_mask(setup):
    """TMF rank masks ride the staged stream in block-DSGD too."""
    from matfac_tpu.models.longtail import ModelDropoutSigmoid
    from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    uf, itf = freq.row_col_freq(data.train_mat)
    uf = np.pad(uf, (0, data.n_users - len(uf)))
    itf = np.pad(itf, (0, data.n_items - len(itf)))
    m = ModelDropoutSigmoid(params.replace(rho_rms=1.0, alpha=0.0),
                            data.n_users, data.n_items, uf, itf)
    mesh = make_mesh((4,), ("u",), devices=jax.devices()[:4])
    s = BlockDSGDSolver(m, params, data.train_mat, iu, ii, mesh,
                        sub_bu=8, sub_bi=4, batch_size=16)
    assert s.use_mask
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    before = ev.rmse(m.eval_view(state), "val")
    for _ in range(30):
        key, k = jax.random.split(key)
        state = s.epoch(state, 0.02, k)
    after = ev.rmse(m.eval_view(state), "val")
    assert after < before


def test_block_dsgd_streams_balanced_under_power_law():
    """Frequency-interleaved staging keeps per-shard staged streams
    balanced (max/median <= 2) under power-law data at N=8 — the
    hot-item shard-imbalance regression guard (SURVEY §7, PERF.md
    "Virtual-mesh scaling curve")."""
    from matfac_tpu.data.synthetic import synthetic_data as sd
    from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver

    data, _, _ = sd(n_users=320, n_items=160, k=4, density=0.25,
                    seed=17, noise=0.05, power_law=1.3, nonneg=True)
    p = Params(fac_dim=4, u_reg=0.01, i_reg=0.01, seed=5,
               batch_size=64)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMF(p, data.n_users, data.n_items)
    mesh = make_mesh((8,), ("u",))
    s = BlockDSGDSolver(model, p, data.train_mat, iu, ii, mesh,
                        sub_bu=8, sub_bi=4, batch_size=16)
    wts = np.asarray(s.wts) > 0
    per_shard = wts.reshape(8, -1).sum(axis=1)
    assert per_shard.max() / max(np.median(per_shard), 1) <= 2.0, \
        per_shard
    # and the padded cell size is not blown up by a hot cell
    assert s.pad_frac < 6.0, s.pad_frac


def test_dsgd_balance_items_hooks_use_original_ids(setup):
    """balance_items relabels item ids; model hooks (IFWMF weights)
    must be computed BEFORE relabeling or every staged weight comes
    from an unrelated item (review r3)."""
    uf, itf = freq.row_col_freq(setup[0].train_mat)
    data = setup[0]
    iu, ii = setup[4], setup[5]
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, seed=5,
               batch_size=256)
    uf = np.pad(uf, (0, data.n_users - len(uf)))
    itf = np.pad(itf, (0, data.n_items - len(itf)))
    m = ModelInvPopMF(p, data.n_users, data.n_items, uf, itf,
                      invalid_users=iu, invalid_items=ii)
    mesh = make_mesh((8,), ("u",))
    s = DSGDShardedSolver(m, p, data.train_mat, iu, ii, mesh,
                          balance_items=True, batch_size=256)
    wts = np.asarray(s.wts)
    r, c, _ = data.train_mat.to_coo()
    expect = np.asarray(m.example_weight(
        jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32))))
    keep = ~iu[r] & ~ii[c]
    assert sorted(np.round(wts[wts > 0], 6).tolist()) == \
        sorted(np.round(expect[keep], 6).tolist())


def test_dense_block_dsgd_tiles_cover_all_ratings(setup):
    """Every kept rating lands in exactly one (shard, round, stripe)
    dense tile slot with the right value."""
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((4,), ("u",), devices=jax.devices()[:4])
    s = DenseBlockDSGDSolver(model, params, data.train_mat, iu, ii,
                             mesh, sub_bu=16)
    W = np.asarray(s.W_tiles)
    R = np.asarray(s.R_tiles, dtype=np.float32)
    assert int((W > 0).sum()) == s.nnz
    r, c, v = data.train_mat.to_coo()
    keep = ~iu[r] & ~ii[c]
    r, c, v = r[keep], c[keep], v[keep]
    r2 = s.u_perm[r]
    c2 = s.i_perm[c]
    sh = r2 // s.bu
    t = (c2 // s.bi - sh) % s.n_shards
    su = (r2 % s.bu) // s.sub_bu
    got = R[sh, t, su, r2 % s.sub_bu, c2 % s.bi]
    np.testing.assert_allclose(got, v, rtol=1e-2)  # bf16 tiles


def test_dense_block_dsgd_converges_on_mesh(setup):
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((4,), ("u",), devices=jax.devices()[:4])
    s = DenseBlockDSGDSolver(model, params, data.train_mat, iu, ii,
                             mesh, sub_bu=16)
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(60):
        key, k = jax.random.split(key)
        state = s.epoch(state, 0.05, k)
    val = ev.rmse(model.eval_view(state), "val")
    assert val < 3 * NOISE + 0.05, f"val RMSE {val}"


def test_dense_block_dsgd_matches_manual_round(setup):
    """One epoch at N=1 == a host replica of the stripe sweep with the
    same keys (pins schedule derivation + cell_dense_update wiring)."""
    from matfac_tpu.ops.dense_block_kernel import cell_dense_update
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((1,), ("u",), devices=jax.devices()[:1])
    s = DenseBlockDSGDSolver(model, params, data.train_mat, iu, ii,
                             mesh, sub_bu=32, mm_bf16=False)
    state = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(4)
    out = s.epoch(state, 0.02, key)

    u3 = np.asarray(state.u_fac)[np.asarray(s.u_perm_inv_dev)].reshape(
        s.SU, s.sub_bu, model.k)
    i_blk = np.asarray(state.i_fac)[np.asarray(s.i_perm_inv_dev)]
    u3 = jnp.asarray(u3)
    i_blk = jnp.asarray(i_blk)
    R = jnp.asarray(np.asarray(s.R_tiles, np.float32))
    W = jnp.asarray(np.asarray(s.W_tiles, np.float32))
    # replicate the in-kernel key chain: one split per round, fold_in(me)
    k2 = key
    k2, ks = jax.random.split(k2)
    sperm = np.asarray(jax.random.permutation(
        jax.random.fold_in(ks, 0), s.SU))
    for su in sperm:
        U, i_blk = cell_dense_update(
            u3[su], i_blk, R[0, 0, su], W[0, 0, su],
            jnp.float32(0.02), float(params.u_reg),
            float(params.i_reg), s.collision_norm, jnp.float32)
        u3 = u3.at[su].set(U)
    exp_u = np.asarray(u3).reshape(-1, model.k)[np.asarray(s.u_perm_dev)]
    exp_i = np.asarray(i_blk)[np.asarray(s.i_perm_dev)]
    np.testing.assert_allclose(np.asarray(out.u_fac), exp_u, atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.i_fac), exp_i, atol=2e-5,
                               rtol=1e-4)


def test_dense_block_dsgd_guards(setup):
    from matfac_tpu.models.longtail import ModelDropoutSigmoid
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((2,), ("u",), devices=jax.devices()[:2])
    uf = data.train_mat.row_degrees().astype(np.float32)
    itf = data.train_mat.col_degrees().astype(np.float32)
    p2 = Params(fac_dim=4, rho_rms=1.0, alpha=0.0, seed=1)
    tmf = ModelDropoutSigmoid(p2, data.n_users, data.n_items, uf, itf)
    with pytest.raises(ValueError):
        DenseBlockDSGDSolver(tmf, p2, data.train_mat, iu, ii, mesh)
    with pytest.raises(ValueError):
        DenseBlockDSGDSolver(model, params, data.train_mat, iu, ii,
                             mesh, dense_budget_bytes=1024)


def test_dense_block_dsgd_train_model_dispatch(setup):
    """mesh + mf_method='densesgd' drives DenseBlockDSGDSolver through
    the full loop; a rank-masked model falls back to mesh blocksgd."""
    from matfac_tpu.train.loop import train_model

    data, params, ev, model, iu, ii = setup
    mesh = make_mesh((4,), ("u",), devices=jax.devices()[:4])
    p = Params(fac_dim=4, u_reg=0.001, i_reg=0.001, learn_rate=0.05,
               max_iter=25, seed=5, disp_iter=10 ** 6)
    rep, m2, ev2, _ = train_model(data, p, algo="mf",
                                  mf_method="densesgd",
                                  log_fn=lambda s: None, mesh=mesh)
    assert rep.best_metric < 3 * NOISE + 0.1, rep.best_metric

    logs = []
    p3 = Params(fac_dim=4, rho_rms=1.0, alpha=0.0, learn_rate=0.05,
                max_iter=3, seed=5, disp_iter=10 ** 6)
    train_model(data, p3, algo="TMF", mf_method="densesgd",
                log_fn=logs.append, mesh=mesh)
    assert any("falling back" in s for s in logs), logs[:3]


def test_dense_block_dsgd_codes_bit_exact(setup):
    """Star-grid data: the mesh dense engine's int8 rating-code tiles
    (W_tiles=None, validity from code != 0) are bit-exact vs the float
    tile staging — star values are exact in bf16 too, so the two
    stagings feed identical numbers into identical update math."""
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver

    data, params, ev, model, iu, ii = setup
    mat = data.train_mat.copy()
    mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                     * 0.5).astype(np.float32)
    mesh = make_mesh((4,), ("u",), devices=jax.devices()[:4])
    code = DenseBlockDSGDSolver(model, params, mat, iu, ii, mesh,
                                sub_bu=16, mm_bf16=False,
                                dense_codes="codes")
    assert code.W_tiles is None and code.r_scale == 0.5
    flt = DenseBlockDSGDSolver(model, params, mat, iu, ii, mesh,
                               sub_bu=16, mm_bf16=False,
                               dense_codes="off")
    assert flt.W_tiles is not None
    sc = init_state(params, data.n_users, data.n_items)
    sf = init_state(params, data.n_users, data.n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, k = jax.random.split(key)
        sc = code.epoch(sc, 0.03, k)
        sf = flt.epoch(sf, 0.03, k)
    assert np.array_equal(np.asarray(sc.u_fac), np.asarray(sf.u_fac))
    assert np.array_equal(np.asarray(sc.i_fac), np.asarray(sf.i_fac))


@pytest.mark.parametrize("mode", ["float", "codes"])
def test_dense_block_dsgd_two_process_distributed(tmp_path, mode):
    """VERDICT r4 #5: two jax.distributed processes, each staging only
    its host-local DENSE tiles (float and int8-code ladders), produce
    the SAME trained factors as one process staging everything."""
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    worker = os.path.join(os.path.dirname(__file__),
                          "dense_bdsgd_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(worker))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i), str(tmp_path), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i}:\n{outs[i]}"
        assert "WORKER_OK" in outs[i]
    multi = np.load(str(tmp_path / f"multi_{mode}.npz"))

    # identical problem, single process, 8-device mesh
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver
    from matfac_tpu.utils import freq as ufreq
    data, _, _ = synthetic_data(n_users=64, n_items=48, k=3,
                                density=0.3, seed=11, noise=0.05,
                                nonneg=True)
    if mode == "codes":
        m = data.train_mat
        m.values[:] = (np.clip(np.round(m.values / 0.5), 1, 10)
                       * 0.5).astype(np.float32)
    params = Params(fac_dim=3, u_reg=0.02, i_reg=0.02, learn_rate=0.03,
                    seed=3)
    iu, ii = ufreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    mesh = make_mesh()
    model = ModelMF(params, data.n_users, data.n_items)
    solver = DenseBlockDSGDSolver(model, params, data.train_mat, iu,
                                  ii, mesh, sub_bu=8, mm_bf16=False,
                                  dense_codes=("codes" if mode ==
                                               "codes" else "off"))
    state = init_state(params, data.n_users, data.n_items, seed=7)
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, ek = jax.random.split(key)
        state = solver.epoch(state, params.learn_rate, ek)
    assert np.array_equal(np.asarray(state.u_fac), multi["u_fac"])
    assert np.array_equal(np.asarray(state.i_fac), multi["i_fac"])
