"""Worker process for the 2-process jax.distributed DENSE Block-DSGD
test.

Each process creates 4 virtual CPU devices (8-device global mesh),
loads ONLY its host-local rating rows and builds DenseBlockDSGDSolver
— which must stage only the dense tiles of its addressable shards
(host-local densify + make_array_from_process_local_data) and still
agree bit-for-bit with a single process staging everything. Run once
with continuous ratings (bf16+int8 tiles) and once star-quantized
(int8 code tiles) via argv[4].

Usage: python dense_bdsgd_worker.py <port> <process_id> <out_dir> <mode>
"""

import os
import sys


def main():
    port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "float"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2, process_id=pid)
    assert jax.device_count() == 8, jax.device_count()

    import numpy as np
    from jax.sharding import Mesh

    from matfac_tpu.config import Params
    from matfac_tpu.data.csr import RatingMatrix
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver
    from matfac_tpu.parallel.distributed import host_local_ratings
    from matfac_tpu.utils import freq as ufreq

    data, _, _ = synthetic_data(n_users=64, n_items=48, k=3,
                                density=0.3, seed=11, noise=0.05,
                                nonneg=True)
    if mode == "codes":
        m = data.train_mat
        m.values[:] = (np.clip(np.round(m.values / 0.5), 1, 10)
                       * 0.5).astype(np.float32)
    n_users, n_items = data.n_users, data.n_items
    iu, ii = ufreq.invalid_users_items(data.train_mat, n_users, n_items)
    params = Params(fac_dim=3, u_reg=0.02, i_reg=0.02, learn_rate=0.03,
                    seed=3)

    r, c, v = host_local_ratings(data.train_mat, n_users, 2, pid)
    local_mat = RatingMatrix.from_coo(r, c, v, n_users, n_items)

    mesh = Mesh(np.asarray(jax.devices()), ("u",))
    model = ModelMF(params, n_users, n_items)
    solver = DenseBlockDSGDSolver(model, params, local_mat, iu, ii,
                                  mesh, sub_bu=8, mm_bf16=False,
                                  dense_codes=("codes" if mode ==
                                               "codes" else "off"))
    if mode == "codes":
        assert solver.W_tiles is None and solver.r_scale == 0.5, \
            (solver.r_scale,)
    else:
        assert solver.W_tiles is not None
    # tiles really are process-locally staged: this process holds only
    # its 4 of 8 shard slices
    assert len(solver.R_tiles.addressable_shards) == 4

    state = init_state(params, n_users, n_items, seed=7)
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, ek = jax.random.split(key)
        state = solver.epoch(state, params.learn_rate, ek)

    from jax.experimental import multihost_utils
    u = multihost_utils.process_allgather(state.u_fac, tiled=True)
    i = multihost_utils.process_allgather(state.i_fac, tiled=True)
    if pid == 0:
        np.savez(os.path.join(out_dir, f"multi_{mode}.npz"),
                 u_fac=np.asarray(u), i_fac=np.asarray(i))
    jax.distributed.shutdown()
    print("WORKER_OK", pid)


if __name__ == "__main__":
    main()
