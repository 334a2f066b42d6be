"""Device microbenchmarks — the primitive rates that explain solver
performance: gathers, scatter-adds, element-stream gathers, batched
Cholesky and CG solves, and a bf16 matmul. Timings end in
``jax.block_until_ready``.

Usage: PYTHONPATH=. python scripts/microbench.py [--cpu] [--quick]
Run one JAX process per card.
"""

import argparse
import sys
import time

import numpy as np


def timeit(fn, n=3):
    import jax
    jax.block_until_ready(fn())
    t = time.perf_counter()
    for _ in range(n):
        r = fn()
    jax.block_until_ready(r)
    return (time.perf_counter() - t) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    print(f"device: {dev}")
    nnz = 2_000_000 if args.quick else 9_830_400
    bs, k, n_users = 65_536, 64, 100_000
    nb = nnz // bs
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, n_users, nnz).astype(np.int32))
    tbl = jnp.zeros((n_users, k))
    g = jnp.ones((bs, k))

    # chained gathers
    @jax.jit
    def gather_chain(tbl, idx):
        def step(acc, s):
            sl = jax.lax.dynamic_slice_in_dim(idx, s * bs, bs)
            return acc + jnp.sum(tbl[sl]), None
        acc, _ = jax.lax.scan(step, 0.0,
                              jnp.arange(nb, dtype=jnp.int32))
        return acc

    dt = timeit(lambda: gather_chain(tbl, idx))
    print(f"gather chain ({nnz} rows, k={k}): {dt*1000:.0f} ms "
          f"-> {nnz/dt/1e6:.0f}M rows/s")

    # chained scatter-adds
    @jax.jit
    def scatter_chain(tbl, idx):
        def step(t, s):
            sl = jax.lax.dynamic_slice_in_dim(idx, s * bs, bs)
            return t.at[sl].add(g), None
        t, _ = jax.lax.scan(step, tbl, jnp.arange(nb, dtype=jnp.int32))
        return t

    dt = timeit(lambda: scatter_chain(tbl, idx))
    print(f"scatter chain: {dt*1000:.0f} ms -> {nnz/dt/1e6:.0f}M rows/s")

    # element-level stream gather (solvers/sgd.py uses contiguous
    # slices instead)
    @jax.jit
    def elem_gather(idx):
        def step(acc, s):
            i2 = (s * bs + jnp.arange(bs, dtype=jnp.int32)) % nnz
            return acc + jnp.sum(idx[i2]), None
        acc, _ = jax.lax.scan(step, jnp.int32(0),
                              jnp.arange(nb, dtype=jnp.int32))
        return acc

    dt = timeit(lambda: elem_gather(idx))
    print(f"element-level stream gather: {dt*1000:.0f} ms "
          f"(vs ~0 for contiguous slices)")

    # batched cholesky solve
    n_sys = 16_384 if args.quick else 102_400
    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (n_sys, k, k))
    gram = jnp.einsum("bij,bkj->bik", a, a) + 10.0 * jnp.eye(k)[None]
    b = jax.random.normal(key, (n_sys, k))

    @jax.jit
    def chol(gram, b):
        c = jax.lax.linalg.cholesky(gram)
        s = jax.lax.linalg.triangular_solve(c, b[..., None],
                                            left_side=True, lower=True)
        return jax.lax.linalg.triangular_solve(
            c, s, left_side=True, lower=True, transpose_a=True)[..., 0]

    dt = timeit(lambda: chol(gram, b))
    print(f"batched cholesky+solve [{n_sys},{k},{k}]: {dt*1000:.0f} ms "
          f"({dt/n_sys*1e6:.1f} us/system)")

    # warm-started CG alternative
    from matfac_tpu.solvers.als import solve_spd_cg

    @jax.jit
    def cg(gram, b):
        return solve_spd_cg(gram, b, jnp.zeros_like(b), 6)

    dt = timeit(lambda: cg(gram, b))
    print(f"batched CG-6 solve: {dt*1000:.0f} ms "
          f"({dt/n_sys*1e6:.1f} us/system)")

    # dense matmul rate
    m = jnp.ones((8192, 20480), jnp.bfloat16)
    qq = jnp.ones((20480, 4096), jnp.bfloat16)

    @jax.jit
    def mm(m, qq):
        return jnp.sum(jnp.dot(m, qq, preferred_element_type=jnp.float32))

    dt = timeit(lambda: mm(m, qq), n=5)
    fl = 2 * 8192 * 20480 * 4096
    print(f"bf16 matmul 8192x20480x4096: {dt*1000:.1f} ms "
          f"-> {fl/dt/1e12:.0f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
