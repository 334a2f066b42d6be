"""Times of the plain-XLA paths that earlier hand-written kernels
shadowed, on one GPU. A hand-written GPU kernel for either path has to beat
these numbers end to end.

    python scripts/gpu_xla_baselines.py

Prints one JSON line per measurement, after the card's name and power
limit:

* ``dense_rows``: the row-dense SGD engine (BlockSGDSolver
  engine="dense", the bench configuration) at the full bench shape
  (100k x 20k, 0.5% density, continuous ratings -> float tiles) and
  the ML-20M shape (star ratings -> int8 code tiles): epoch and
  per-stripe time, the bytes XLA's cost model charges one stripe step
  times the stripe count, and the irreducible read of the staged grid.
* ``hr10``: one full-catalog HR@10 pass through CatalogScorer with
  its tiled exact top-k (eval/ranking._exact_topk_tiles) and with
  plain ``lax.top_k`` in its place, at the medium and ML-20M shapes.
* ``reference_rates``: a large bf16 matmul and a large copy, the
  achievable rates to read the two above against.

Timings end in ``block_until_ready``; every shape is warmed up first.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _emit(name, **kw):
    print(json.dumps({"measure": name, **kw}), flush=True)


def _timed(fn, reps):
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def reference_rates():
    import jax
    import jax.numpy as jnp
    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda x: jnp.dot(x, x, preferred_element_type=jnp.float32))
    t_mm = _timed(lambda: mm(a), 20)
    x = jnp.ones((1 << 30,), jnp.float32)          # 4 GiB
    cp = jax.jit(lambda v: v * 1.0001)
    t_cp = _timed(lambda: cp(x), 20)
    _emit("reference_rates", bf16_matmul_tflops=2 * n ** 3 / t_mm / 1e12,
          copy_gbps=2 * x.nbytes / t_cp / 1e9)


def dense_rows(tag, mat, n_users, n_items, k=64, epochs=5):
    import functools

    import jax
    import jax.numpy as jnp

    from matfac_tpu.config import Params
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.ops.dense_block_kernel import cell_dense_update
    from matfac_tpu.solvers.block_sgd import BlockSGDSolver
    from matfac_tpu.utils import freq

    params = Params(fac_dim=k, u_reg=0.01, i_reg=0.01, learn_rate=0.005,
                    seed=0)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    model = ModelMF(params, n_users, n_items)
    t0 = time.perf_counter()
    sol = BlockSGDSolver(model, params, mat, iu, ii, collision_norm=True,
                         engine="dense", bu=None, bi=None)
    jax.block_until_ready(sol.R_cells)
    stage_s = time.perf_counter() - t0
    state = init_state(params, n_users, n_items)
    key = jax.random.PRNGKey(0)
    for _ in range(2):                 # compile + donated-input variant
        state = sol.epoch(state, params.learn_rate, key)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(epochs):
        state = sol.epoch(state, params.learn_rate, key)
    jax.block_until_ready(state)
    epoch_s = (time.perf_counter() - t0) / epochs

    # XLA's cost model for one stripe step at the staged dtypes
    R1 = sol.R_cells[0]
    W1 = None if sol.W_cells is None else sol.W_cells[0]
    U1 = jnp.zeros((sol.bu, k), jnp.float32)
    I1 = jnp.zeros((sol.n_items_pad, k), jnp.float32)
    step = jax.jit(functools.partial(
        cell_dense_update, lr=jnp.float32(0.005), u_reg=0.01, i_reg=0.01,
        collision_norm=True, mm_dtype=jnp.bfloat16, r_scale=sol.r_scale))
    cost = step.lower(U1, I1, R1, W1).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    stripe_bytes = float(cost.get("bytes accessed", float("nan")))
    grid_bytes = sol.R_cells.nbytes + (0 if sol.W_cells is None
                                       else sol.W_cells.nbytes)
    _emit("dense_rows", shape=tag, nnz=int(sol.nnz), stripes=sol.NU,
          bu=sol.bu, ni_pad=sol.n_items_pad,
          tiles="codes" if sol.W_cells is None else
          f"R {sol.R_cells.dtype} + W {sol.W_cells.dtype}",
          staging_s=stage_s, epoch_ms=epoch_s * 1e3,
          stripe_ms=epoch_s * 1e3 / sol.NU,
          ratings_per_s=sol.nnz / epoch_s,
          model_bytes_per_epoch=stripe_bytes * sol.NU,
          grid_bytes=grid_bytes,
          bytes_over_grid=stripe_bytes * sol.NU / grid_bytes,
          model_gbps=stripe_bytes * sol.NU / epoch_s / 1e9)


def hr10(tag, mat, n_users, n_items, k=64, reps=5):
    import jax

    from matfac_tpu.config import Params
    from matfac_tpu.data.csr import RatingMatrix
    from matfac_tpu.eval import ranking
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.utils import freq

    params = Params(fac_dim=k, seed=0)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    view = ModelMF(params, n_users, n_items).eval_view(
        init_state(params, n_users, n_items))
    rng = np.random.default_rng(1)
    loo = RatingMatrix.from_coo(np.arange(n_users, dtype=np.int64),
                                rng.integers(0, n_items, n_users),
                                np.ones(n_users, np.float32), n_users,
                                n_items)
    tiled = ranking._exact_topk_tiles
    res = {}
    for name in ("tiled", "lax_top_k"):
        if name == "lax_top_k":
            ranking._exact_topk_tiles = (
                lambda s, n, tile=128: jax.lax.top_k(s, n))
            jax.clear_caches()
        sc = ranking.CatalogScorer(mat, iu, ii, n_users, n_items)
        hr = sc.hit_rate(view, loo, 10)
        t0 = time.perf_counter()
        for _ in range(reps):
            sc.hit_rate(view, loo, 10)   # returns a host float: synced
        res[name] = {"pass_ms": (time.perf_counter() - t0) / reps * 1e3,
                     "hr": hr}
    ranking._exact_topk_tiles = tiled
    jax.clear_caches()
    _emit("hr10", shape=tag, users=n_users, items=n_items,
          user_block=sc.user_block, item_block=sc.item_block, **res)


def main():
    import jax

    from matfac_tpu.data.synthetic import low_rank_ratings
    from matfac_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("no GPU: these are device measurements")
    enable_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    reference_rates()

    import chip_smoke
    full, _, _ = low_rank_ratings(100_000, 20_000, k=8, density=0.005,
                                  seed=0, noise=0.1, power_law=0.6,
                                  nonneg=True)
    dense_rows("full", full, 100_000, 20_000)
    del full
    med = chip_smoke.make_star_data(**chip_smoke.MEDIUM, seed=0)
    hr10("medium", med.train_mat, med.n_users, med.n_items)
    del med
    big = chip_smoke.make_star_data(**chip_smoke.ML20M, seed=0)
    dense_rows("ml20m", big.train_mat, big.n_users, big.n_items)
    hr10("ml20m", big.train_mat, big.n_users, big.n_items)


if __name__ == "__main__":
    main()
