"""Benchmark — prints ONE JSON line. Runs on a GPU only.

Primary metric: SGD ratings/sec/chip on a synthetic problem (the best
of the scatter, one-hot block and row-dense engines); ALS, BPR and a
full-catalog HR@10 pass ride in "extra". The reference publishes no
numbers (SURVEY.md §6). Every measurement runs in its own guard: one
that raises is reported as failed under "failed" and makes the script
exit non-zero after printing the line.

Env knobs:
  BENCH_SCALE=small|medium|full   (default medium)
  BENCH_EPOCHS=N                  timed epochs (default 3)
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

SCALE = os.environ.get("BENCH_SCALE", "medium")
TIMED_EPOCHS = int(os.environ.get("BENCH_EPOCHS", "3"))


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench.py measures a GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 2
    from matfac_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import low_rank_ratings
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.solvers.als import ALSSolver
    from matfac_tpu.solvers.block_sgd import BlockSGDSolver
    from matfac_tpu.solvers.sgd import SGDSolver
    from matfac_tpu.utils import freq

    scales = {
        "small": (2000, 1000, 16, 0.02, 8192),
        "medium": (20_000, 5_000, 64, 0.05, 65_536),
        "full": (100_000, 20_000, 64, 0.005, 65_536),
    }
    n_users, n_items, k, density, bs = scales[SCALE]

    mat, _, _ = low_rank_ratings(n_users, n_items, k=8, density=density,
                                 seed=0, noise=0.1, power_law=0.6,
                                 nonneg=True)
    params = Params(fac_dim=k, u_reg=0.01, i_reg=0.01, learn_rate=0.005,
                    seed=0, batch_size=bs)
    inval_u, inval_i = freq.invalid_users_items(mat, n_users, n_items)
    model = ModelMF(params, n_users, n_items)

    def time_epochs(solver, n, _params=None, _nu=None, _ni=None):
        _params = _params or params
        state = init_state(_params, _nu or n_users, _ni or n_items)
        key = jax.random.PRNGKey(0)
        # warmup — TWO epochs: solvers with resident staged layouts
        # compile a second (donated-input) program variant on their
        # second call, which a 1-epoch warmup leaves in the timed window
        for _ in range(2):
            key, k1 = jax.random.split(key)
            state = solver.epoch(state, _params.learn_rate, k1)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(n):
            key, k1 = jax.random.split(key)
            state = solver.epoch(state, _params.learn_rate, k1)
        jax.block_until_ready(state)
        return (time.perf_counter() - t0) / n

    extra = {"device": str(jax.devices()[0]),
             "device_kind": jax.devices()[0].device_kind,
             "gpu": subprocess.run(
                 ["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"], capture_output=True,
                 text=True, check=True).stdout.strip(),
             "nnz": int(mat.nnz), "fac_dim": k}
    failed = []

    def measure(name, fn):
        """Run one measurement; a raise marks ``name`` failed."""
        try:
            extra.update(fn())
        except Exception as e:  # noqa: BLE001 — reported, exit non-zero
            traceback.print_exc()
            failed.append(name)
            extra[f"{name}_error"] = f"{type(e).__name__}: {e}"

    def sgd():
        s = SGDSolver(model, params, mat, inval_u, inval_i)
        t = time_epochs(s, TIMED_EPOCHS)
        return {"sgd_epoch_s": t, "sgd_ratings_per_sec": s.nnz / t}

    def blocksgd():
        # one-hot cell engine, diag schedule, auto-sized minibatches,
        # k zero-padded to 128 (exact; solvers/block_sgd.py pad_k)
        s = BlockSGDSolver(model, params, mat, inval_u, inval_i,
                           batch_size=None, bu=384, bi=384,
                           collision_norm=True, engine="xla",
                           schedule="diag", pad_k=128 if k <= 128 else 0)
        t = time_epochs(s, TIMED_EPOCHS)
        return {"blocksgd_epoch_s": t, "blocksgd_ratings_per_sec": s.nnz / t}

    def densesgd():
        # row-stripe dense engine (ops/dense_block_kernel.dense_sweep_rows)
        s = BlockSGDSolver(model, params, mat, inval_u, inval_i,
                           collision_norm=True, engine="dense",
                           bu=None, bi=None)
        t = time_epochs(s, TIMED_EPOCHS)
        return {"densesgd_epoch_s": t,
                "densesgd_ratings_per_sec": s.nnz / t}

    def densesgd_codes():
        # the same engine on star-quantized ratings, staged as int8
        # rating codes (1 B/slot)
        smat = mat.copy()
        smat.values[:] = (np.clip(np.round(smat.values / 0.5), 1, 10)
                          * 0.5).astype(np.float32)
        s = BlockSGDSolver(model, params, smat, inval_u, inval_i,
                           collision_norm=True, engine="dense",
                           bu=None, bi=None, dense_codes="codes")
        return {"densesgd_codes_ratings_per_sec":
                s.nnz / time_epochs(s, TIMED_EPOCHS)}

    def als():
        # warm-started CG solves (solvers/als.py solve_spd_cg)
        s = ALSSolver(model, params, mat, inval_u, inval_i, cg_iters=6)
        t = time_epochs(s, TIMED_EPOCHS)
        return {"als_epoch_s": t, "als_ratings_per_sec": mat.nnz / t}

    def alsdense():
        from matfac_tpu.solvers.als import DenseALSSolver
        s = DenseALSSolver(model, params, mat, inval_u, inval_i,
                           cg_iters=6, gram_int8=True)
        return {"alsdense_ratings_per_sec":
                mat.nnz / time_epochs(s, TIMED_EPOCHS)}

    def bpr():
        from matfac_tpu.models.bpr import ModelMFBPR
        from matfac_tpu.solvers.bpr import BPRSolver
        bmodel = ModelMFBPR(params, n_users, n_items)
        s = BPRSolver(bmodel, params, mat, inval_u, inval_i, n_tries=2,
                      sampler="rankgap")
        return {"bpr_pairs_per_sec": s.n_pos / time_epochs(s,
                                                           TIMED_EPOCHS)}

    def bpr_dense():
        from matfac_tpu.models.bpr import ModelMFBPR
        from matfac_tpu.solvers.bpr_dense import DenseBPRSolver
        bmodel = ModelMFBPR(params, n_users, n_items)
        s = DenseBPRSolver(bmodel, params, mat, inval_u, inval_i)
        return {"bpr_dense_pairs_per_sec":
                s.n_pos / time_epochs(s, TIMED_EPOCHS)}

    def hr10():
        # full-catalog HR@10 pass (tiled exact top-k + COO exclusion +
        # device-side leave-one-out credit)
        from matfac_tpu.data.csr import RatingMatrix
        from matfac_tpu.eval.ranking import CatalogScorer
        scorer = CatalogScorer(mat, inval_u, inval_i, n_users, n_items,
                               user_block=4096, item_block=32768)
        rng = np.random.default_rng(1)
        loo = RatingMatrix.from_coo(
            np.arange(n_users, dtype=np.int64),
            rng.integers(0, n_items, n_users),
            np.ones(n_users, np.float32), n_users, n_items)
        view = model.eval_view(init_state(params, n_users, n_items))
        scorer.hit_rate(view, loo, 10)   # compile + stage
        t0 = time.perf_counter()
        for _ in range(TIMED_EPOCHS):
            scorer.hit_rate(view, loo, 10)   # host float: synced
        return {"hr10_eval_ms":
                (time.perf_counter() - t0) / TIMED_EPOCHS * 1000}

    def full_densesgd():
        # the row-dense engine at the full shape beside the medium run
        fu, fi, fk, fd = 100_000, 20_000, 64, 0.005
        fmat, _, _ = low_rank_ratings(fu, fi, k=8, density=fd, seed=0,
                                      noise=0.1, power_law=0.6,
                                      nonneg=True)
        fparams = Params(fac_dim=fk, u_reg=0.01, i_reg=0.01,
                         learn_rate=0.005, seed=0)
        f_iu, f_ii = freq.invalid_users_items(fmat, fu, fi)
        s = BlockSGDSolver(ModelMF(fparams, fu, fi), fparams, fmat,
                           f_iu, f_ii, collision_norm=True,
                           engine="dense", bu=None, bi=None)
        t = time_epochs(s, TIMED_EPOCHS, _params=fparams, _nu=fu, _ni=fi)
        return {"full_densesgd_epoch_s": t,
                "full_densesgd_ratings_per_sec": s.nnz / t}

    steps = [("sgd", sgd), ("blocksgd", blocksgd), ("densesgd", densesgd),
             ("densesgd_codes", densesgd_codes), ("als", als),
             ("alsdense", alsdense)]
    if SCALE != "small":
        steps += [("bpr", bpr), ("bpr_dense", bpr_dense), ("hr10", hr10)]
    if SCALE == "medium":
        steps.append(("full_densesgd", full_densesgd))
    for name, fn in steps:
        measure(name, fn)

    candidates = {e: extra[f"{e}_ratings_per_sec"]
                  for e in ("sgd", "blocksgd", "densesgd")
                  if f"{e}_ratings_per_sec" in extra}
    engine = max(candidates, key=candidates.get) if candidates else None
    extra["engine"] = engine
    extra["failed"] = failed
    print(json.dumps({
        "metric": "sgd_ratings_per_sec_per_chip",
        "value": candidates.get(engine),
        "unit": "ratings/s/chip",
        "extra": extra}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
