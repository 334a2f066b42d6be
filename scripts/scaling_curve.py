"""DSGD / BlockDSGD scaling curve on the virtual CPU mesh (VERDICT r2
#5): epoch wall-clock at N = 1/2/4/8 shards for the scatter DSGD and
the one-hot BlockDSGD, with parallel efficiency and staged-stream
balance columns.

CPU numbers are NOT device throughput — the point is the SHAPE: they
expose schedule pathologies (ppermute serialization, stream imbalance,
round overhead growing with N) that are invariant to the backend.
Results are recorded in PERF.md "Virtual-mesh scaling curve".

--phase-split additionally times each solver's epoch
with the ppermute removed ("compute") and with ONLY the ppermute
("permute") via _build_epoch(mode=...), attributing the BlockDSGD
scaling sag to compute vs collectives instead of assuming it.

Run: python scripts/scaling_curve.py [--phase-split]
(forces CPU, 8 virtual devices)
"""

import os
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from matfac_tpu.config import Params  # noqa: E402
from matfac_tpu.data.synthetic import synthetic_data  # noqa: E402
from matfac_tpu.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu.parallel.mesh import make_mesh  # noqa: E402
from matfac_tpu.utils import freq as ufreq  # noqa: E402


def stream_balance(solver):
    """max/median real (non-padding) staged entries per shard."""
    wts = np.asarray(getattr(solver, "wts", None)
                     if hasattr(solver, "wts")
                     else solver.W_tiles) > 0
    per_shard = wts.reshape(wts.shape[0], -1).sum(axis=1)
    return float(per_shard.max() / max(np.median(per_shard), 1))


def _time_epoch_fn(solver, epoch_fn, make_state, epochs, is_block):
    """min epoch wall-clock of one prebuilt epoch function over the
    solver's resident staged arrays. make_state: fresh state per call
    (the epoch donates its factor args — a shared state would be
    consumed)."""
    u_fac, i_fac = solver._stage_factors(make_state())
    key = jax.random.PRNGKey(0)
    if is_block == "dense":
        args = (solver.R_tiles, solver.W_tiles)
    elif is_block:
        args = (solver.u_loc, solver.i_loc, solver.vals, solver.wts,
                solver.cnu, solver.cni, solver.lams)
    else:
        args = (solver.u_loc, solver.i_loc, solver.vals, solver.wts,
                solver.lams)
    import jax.numpy as jnp
    lr = jnp.float32(0.005)
    key, ek = jax.random.split(key)
    u_fac, i_fac = epoch_fn(u_fac, i_fac, *args, lr, ek)  # compile
    jax.block_until_ready(u_fac)
    times = []
    for _ in range(4):
        key, ek = jax.random.split(key)
        t0 = time.time()
        u_fac, i_fac = epoch_fn(u_fac, i_fac, *args, lr, ek)
        jax.block_until_ready(u_fac)
        times.append(time.time() - t0)
    return min(times)


def run(n_users=16384, n_items=4096, nnz=1_000_000, k=32, epochs=4,
        phase_split=False):
    rng = np.random.default_rng(0)
    data, _, _ = synthetic_data(n_users=n_users, n_items=n_items, k=8,
                                density=nnz / (n_users * n_items),
                                seed=3, noise=0.1, power_law=1.1,
                                nonneg=True)
    params = Params(fac_dim=k, u_reg=0.01, i_reg=0.01, learn_rate=0.005,
                    seed=1, batch_size=4096)
    iu, ii = ufreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    model = ModelMF(params, data.n_users, data.n_items)
    del rng

    rows = []
    for engine in ("dsgd", "blockdsgd", "densedsgd"):
        base = None
        for N in (1, 2, 4, 8):
            mesh = make_mesh((N,), ("u",), devices=jax.devices()[:N])
            if engine == "dsgd":
                from matfac_tpu.parallel.dsgd import DSGDShardedSolver
                solver = DSGDShardedSolver(model, params, data.train_mat,
                                           iu, ii, mesh,
                                           balance_items=True)
            elif engine == "blockdsgd":
                from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver
                solver = BlockDSGDSolver(model, params, data.train_mat,
                                         iu, ii, mesh, sub_bu=512,
                                         sub_bi=512, batch_size=1024)
            else:
                from matfac_tpu.parallel.block_dsgd import (
                    DenseBlockDSGDSolver)
                solver = DenseBlockDSGDSolver(model, params,
                                              data.train_mat, iu, ii,
                                              mesh, sub_bu=512)
            state = init_state(params, data.n_users, data.n_items)
            key = jax.random.PRNGKey(0)
            key, ek = jax.random.split(key)
            state = solver.epoch(state, 0.005, ek)   # compile
            jax.block_until_ready(state.u_fac)
            times = []
            for _ in range(epochs):
                key, ek = jax.random.split(key)
                t0 = time.time()
                state = solver.epoch(state, 0.005, ek)
                jax.block_until_ready(state.u_fac)
                times.append(time.time() - t0)
            dt = min(times)
            if base is None:
                base = dt
            eff = base / (dt * 1)   # CPU cores shared: report speedup
            bal = stream_balance(solver)
            comp = perm = None
            if phase_split:
                mk = lambda: init_state(params, data.n_users,
                                        data.n_items)
                kind = ("dense" if engine == "densedsgd"
                        else engine == "blockdsgd")
                comp = _time_epoch_fn(
                    solver, solver._build_epoch("nopermute"), mk,
                    epochs, kind)
                perm = _time_epoch_fn(
                    solver, solver._build_epoch("permuteonly"), mk,
                    epochs, kind)
            rows.append((engine, N, dt, base / dt, bal, comp, perm))
            extra = ""
            if phase_split:
                extra = (f" compute={comp*1000:7.1f} ms "
                         f"permute_only={perm*1000:6.1f} ms "
                         f"comm_frac={(dt-comp)/dt:5.1%}")
            print(f"{engine:10s} N={N} epoch={dt*1000:7.1f} ms "
                  f"speedup_vs_N1={base/dt:5.2f} balance={bal:4.2f}"
                  + extra, flush=True)
    hdr = ("\n| engine | N | epoch ms | speedup vs N=1 | max/median "
           "stream |")
    if phase_split:
        hdr = hdr[:-1] + " compute ms | permute-only ms | comm frac |"
    print(hdr)
    print("|---|---|---|---|---|" + ("---|" * 3 if phase_split else ""))
    for e, N, dt, sp, bal, comp, perm in rows:
        line = f"| {e} | {N} | {dt*1000:.1f} | {sp:.2f} | {bal:.2f} |"
        if phase_split:
            line += (f" {comp*1000:.1f} | {perm*1000:.1f} |"
                     f" {(dt-comp)/dt:.1%} |")
        print(line)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase-split", action="store_true")
    a = ap.parse_args()
    run(phase_split=a.phase_split)
