"""CCD++ vs ALS quality parity at ML-10M shape.

CPU run (chunked sweeps are platform-agnostic); RMSE parity on the
100k x 20k / ~10M-nnz synthetic split is the quality half of the
CCD++-at-scale deliverable (the rate half is a device measurement).

Usage: PYTHONPATH=. python scripts/ccdpp_scale_parity.py
"""

import time

import numpy as np


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.eval.metrics import Evaluator
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.solvers.als import ALSSolver
    from matfac_tpu.solvers.ccd import CCDPPSolver
    from matfac_tpu.utils import freq

    data, _, _ = synthetic_data(
        n_users=100_000, n_items=20_000, k=8, density=0.005, seed=11,
        noise=0.1, power_law=0.6, nonneg=True, test_pc=0.05, val_pc=0.05)
    print("config:", data, flush=True)
    p = Params(fac_dim=32, u_reg=0.05, i_reg=0.05, seed=1)
    m = ModelMF(p, data.n_users, data.n_items)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    ev = Evaluator(data, iu, ii, p)

    for name, solver, n_ep in [
            ("als", ALSSolver(m, p, data.train_mat, iu, ii), 12),
            ("ccd++", CCDPPSolver(m, p, data.train_mat, iu, ii), 12),
            ("ccd++g4", CCDPPSolver(m, p, data.train_mat, iu, ii,
                                    group_dims=4), 12),
    ]:
        st = init_state(p, data.n_users, data.n_items)
        key = jax.random.PRNGKey(3)
        best = float("inf")
        for e in range(n_ep):
            key, ek = jax.random.split(key)
            t0 = time.time()
            st = solver.epoch(st, 0, ek)
            dt = time.time() - t0
            val = ev.rmse(m.eval_view(st), "val")
            best = min(best, val)
            print(f"{name} epoch {e}: val={val:.4f} ({dt:.1f}s)",
                  flush=True)
        print(f"{name} BEST val={best:.4f}", flush=True)


if __name__ == "__main__":
    main()
