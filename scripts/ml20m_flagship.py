"""Flagship end-to-end run at the ML-20M shape on ONE device.

Exercises the whole production path at the north-star scale: star-
quantized ratings (the int8 code staging engages), train/val/test
splits, TrainLoop termination + best-on-val snapshot + checkpointing,
the row-dense code engine, and the ranking eval — with wall-clock for
each phase. The reference's flagship config is ML-20M rank-64/128
(BASELINE.md north star).

Run: PYTHONPATH=. python scripts/ml20m_flagship.py  (one JAX process
per card)
"""

import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from matfac_tpu.config import Params
    from matfac_tpu.data.csr import RatingMatrix
    from matfac_tpu.data.dataset import Data
    from matfac_tpu.data.io import split_train_test_val
    from matfac_tpu.data.synthetic import low_rank_ratings
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.train.loop import train_model
    from matfac_tpu.utils import freq as ufreq

    print("devices:", jax.devices(), flush=True)
    n_users, n_items = 138_000, 27_000
    t0 = time.time()
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8,
                                 density=20e6 / (n_users * n_items),
                                 seed=0, noise=0.35, power_law=0.8,
                                 nonneg=True)
    mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                     * 0.5).astype(np.float32)
    tr, te, va = split_train_test_val(mat, 0.1, 0.05, seed=1)
    data = Data(train_mat=tr, test_mat=te, val_mat=va)
    print(f"data: {data} gen+split {time.time()-t0:.0f}s", flush=True)

    for k in (64, 128):
        params = Params(fac_dim=k, u_reg=0.002, i_reg=0.002,
                        learn_rate=0.05, seed=0, max_iter=60,
                        obj_iter=5, disp_iter=20,
                        save_iter=50)
        t0 = time.time()
        rep, model, ev, _ = train_model(
            data, params, algo="mf", mf_method="densesgd",
            prefix=f"/tmp/ml20m_k{k}", log_fn=print)
        train_s = time.time() - t0
        test = ev.rmse(model.eval_view(rep.best_state), "test")
        print(f"k={k}: {rep.best_iter + 1}+ epochs in {train_s:.0f}s "
              f"wall (incl. staging+compile+evals), best val "
              f"{rep.best_metric:.4f}, test {test:.4f}, "
              f"stop={rep.stop_reason}", flush=True)
        # checkpoint exists (TrainLoop best-snapshot protocol)
        import glob
        cks = glob.glob(f"/tmp/ml20m_k{k}*")
        print(f"k={k}: {len(cks)} checkpoint files", flush=True)

        if k == 64:
            # full-catalog ranking eval at the flagship shape
            iu, ii = ufreq.invalid_users_items(tr, n_users, n_items)
            scorer = CatalogScorer(tr, iu, ii, n_users, n_items)
            rng = np.random.default_rng(1)
            loo = RatingMatrix.from_coo(
                np.arange(n_users, dtype=np.int64),
                rng.integers(0, n_items, n_users),
                np.ones(n_users, np.float32), n_users, n_items)
            view = model.eval_view(rep.best_state)
            scorer.hit_rate(view, loo, 10)   # compile
            t0 = time.time()
            scorer.hit_rate(view, loo, 10)
            print(f"k=64: full-catalog HR@10 eval (138k x 27k) = "
                  f"{time.time()-t0:.2f}s", flush=True)


if __name__ == "__main__":
    main()
