"""SGD quality parity in the reference regime.

The reference's sequential SGD runs with maxiter 1000+ under the
termination machine (model.cpp:1471-1540: lr halving at 100 stagnant
epochs, CHANCE_ITER=500 give-up) and converges to the same basin as the
coordinate solvers. This script runs OUR minibatched SGD engine with
that budget on the ML-100K-shaped synthetic split used by
scripts/quality_report.py and records best val/test RMSE per
(lr, batch) config. Target: within 0.01 of ALS (~0.136 val,
BASELINE.md quality table).

Usage: PYTHONPATH=. python scripts/sgd_parity.py [--cpu] [--maxiter N]
"""

import argparse
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maxiter", type=int, default=3000)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.train.loop import train_model

    data, _, _ = synthetic_data(
        n_users=943, n_items=1682, k=8, density=0.063, seed=100,
        noise=0.1, power_law=0.6, nonneg=True, test_pc=0.1, val_pc=0.1)
    print(f"config: {data} (ML-100K shape)", flush=True)

    # NOTE on regs: SGD applies the L2 term PER OCCURRENCE
    # (modelMF.cpp:92-105), so its effective per-entity lambda is
    # freq * reg — the coordinate solvers' u_reg=0.05 corresponds to
    # SGD regs ~50x smaller on this split (mean freq ~78). With that
    # and collision_norm (solvers/sgd.py) the minibatched engine lands
    # in the ALS basin: best val 0.1355 vs ALS 0.1359 (round-2 run).
    grids = [
        dict(learn_rate=0.05, batch_size=2048, u_reg=0.005, i_reg=0.005),
        dict(learn_rate=0.05, batch_size=2048, u_reg=0.001, i_reg=0.001),
        dict(learn_rate=0.1, batch_size=2048, u_reg=0.005, i_reg=0.005),
    ]
    best = None
    for kw in grids:
        p = Params(fac_dim=10, max_iter=args.maxiter, seed=1,
                   disp_iter=10 ** 6, **kw)
        t0 = time.time()
        rep, model, ev, _ = train_model(data, p, mf_method="sgd",
                                        log_fn=lambda s: None)
        test = ev.rmse(model.eval_view(rep.best_state), "test")
        print(f"lr={kw['learn_rate']} B={kw['batch_size']}: "
              f"best_val={rep.best_metric:.4f} test={test:.4f} "
              f"best_iter={rep.best_iter} stop={rep.stop_reason} "
              f"({time.time()-t0:.0f}s)", flush=True)
        if best is None or rep.best_metric < best[0]:
            best = (rep.best_metric, test, kw)
    print(f"BEST: val={best[0]:.4f} test={best[1]:.4f} cfg={best[2]}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
