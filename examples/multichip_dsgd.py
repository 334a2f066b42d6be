"""Multi-device DSGD on a device mesh.

On a machine with several GPUs, `jax.devices()` supplies the cards and
the same code shards over them (NVLink joins every pair, so the 1-D
mesh follows the algorithm alone). With --cpu it runs the identical
program on 8 virtual CPU devices (the standard JAX substitute;
SURVEY.md §4):

    PYTHONPATH=/path/to/repo python examples/multichip_dsgd.py [--cpu]

For MULTI-HOST runs, each process additionally calls
`matfac_tpu.parallel.distributed.init_distributed()` and loads only its
local user-block rows via `host_local_ratings` — see
tests/dsgd_worker.py for a complete two-process example where no host
ever holds the full rating stream.
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-device DSGD")
    ap.add_argument("--cpu", action="store_true",
                    help="run on 8 virtual CPU devices instead of GPUs")
    args = ap.parse_args(argv)
    if args.cpu and "xla_force_host_platform_device_count" not in \
            os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   "=8").strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    if not args.cpu and devices[0].platform != "gpu":
        sys.exit(f"no GPU found ({devices[0].platform}); pass --cpu to "
                 "run on 8 virtual CPU devices")
    if len(devices) < 2:
        sys.exit(f"a mesh needs >= 2 devices, found {len(devices)}")
    from matfac_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(f"devices: {devices}")
    _run(jax, devices)


def _run(jax, devices):
    from jax.sharding import Mesh

    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import low_rank_ratings
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.parallel.dsgd import DSGDShardedSolver
    from matfac_tpu.utils import freq

    n_users, n_items, k = 4096, 2048, 16
    mat, _, _ = low_rank_ratings(n_users, n_items, k=4, density=0.02,
                                 seed=0, noise=0.05, power_law=0.5,
                                 nonneg=True)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    params = Params(fac_dim=k, u_reg=0.01, i_reg=0.01,
                    learn_rate=0.002, seed=0)
    model = ModelMF(params, n_users, n_items)

    # 1-D mesh: factor tables row-shard over axis "u"; each epoch runs
    # N rotated rounds and item blocks travel by lax.ppermute between
    # devices (parallel/dsgd.py — the mesh re-design of trainSGDPar,
    # modelMF.cpp:154-350)
    mesh = Mesh(np.array(devices), ("u",))
    solver = DSGDShardedSolver(model, params, mat, iu, ii, mesh,
                               balance_items=True)
    state = init_state(params, n_users, n_items)
    key = jax.random.PRNGKey(0)

    from matfac_tpu.eval.metrics import Evaluator

    class _D:     # minimal Data bundle for the Evaluator
        pass

    _D.train_mat, _D.test_mat, _D.val_mat = mat, None, None
    _D.n_users, _D.n_items = n_users, n_items
    ev = Evaluator(_D, iu, ii, params)
    lr = params.learn_rate
    for epoch in range(12):
        key, ek = jax.random.split(key)
        state = solver.epoch(state, lr, ek)
        lr *= 0.95   # the full TrainLoop adds NaN-rollback + halving
        r = ev.rmse(model.eval_view(state), "train")
        print(f"epoch {epoch}: train RMSE {r:.4f}")


if __name__ == "__main__":
    main()
