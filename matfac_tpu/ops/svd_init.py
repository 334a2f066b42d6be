"""Truncated SVD factor initialization.

JAX replacement for the SVDLIBC Lanczos wrapper
(svdFrmSvdlibCSREig, /root/reference/svdFrmsvdlib.cpp:69-134, and the
binary-sparsity variant svdFrmSvdlibCSRSparsityEig, :202-262):
randomized subspace-iteration SVD where every heavy op is a dense
matmul against the sparse matrix expressed as COO segment-sums — runs
jitted on the device, no host linear-algebra library.

API parity: returns (u_fac, i_fac, singular_vals); ``pure_svd=True``
scales iFac columns by the singular values (the reference's "pureSVD"
mode); ``sparsity_only=True`` factorizes the binary pattern instead of
the values.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.data.csr import RatingMatrix


@functools.partial(jax.jit, static_argnames=("n_rows", "n_cols", "n_iter"))
def _randomized_svd_coo(rows, cols, vals, omega, n_rows: int, n_cols: int,
                        n_iter: int):
    """Randomized range-finder SVD of the sparse matrix A (COO).

    A @ X:  segment_sum over rows of vals * X[cols]
    A.T @ Y: segment_sum over cols of vals * Y[rows]
    """
    def a_mm(x):        # [n_cols, r] -> [n_rows, r]
        return jax.ops.segment_sum(vals[:, None] * x[cols], rows, n_rows)

    def at_mm(y):       # [n_rows, r] -> [n_cols, r]
        return jax.ops.segment_sum(vals[:, None] * y[rows], cols, n_cols)

    y = a_mm(omega)
    for _ in range(n_iter):
        y, _ = jnp.linalg.qr(y)
        z, _ = jnp.linalg.qr(at_mm(y))
        y = a_mm(z)
    q, _ = jnp.linalg.qr(y)                      # [n_rows, r]
    b = at_mm(q)                                 # [n_cols, r] = (Q^T A)^T
    ub, s, vt = jnp.linalg.svd(b.T, full_matrices=False)
    u = q @ ub
    return u, s, vt.T                            # A ≈ U S V^T


def svd_init(mat: RatingMatrix, rank: int, pure_svd: bool = False,
             sparsity_only: bool = False, seed: int = 0,
             n_iter: int = 6, oversample: int = 8
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-``rank`` truncated SVD of the rating matrix.

    Returns (u_fac [nrows, rank], i_fac [ncols, rank], singular_vals
    [rank]) with the reference's conventions: uFac = left singular
    vectors, iFac = right singular vectors (times S if pure_svd).
    """
    r, c, v = mat.to_coo()
    if sparsity_only:
        v = np.ones_like(v)
    r_dev = jnp.asarray(r.astype(np.int32))
    c_dev = jnp.asarray(c.astype(np.int32))
    v_dev = jnp.asarray(v.astype(np.float32))
    rr = min(rank + oversample, min(mat.nrows, mat.ncols))
    omega = jax.random.normal(jax.random.PRNGKey(seed), (mat.ncols, rr))
    u, s, vmat = _randomized_svd_coo(r_dev, c_dev, v_dev, omega,
                                     mat.nrows, mat.ncols, n_iter)
    u = np.asarray(u[:, :rank])
    s = np.asarray(s[:rank])
    vmat = np.asarray(vmat[:, :rank])
    if pure_svd:
        vmat = vmat * s[None, :]
    return u.astype(np.float32), vmat.astype(np.float32), \
        s.astype(np.float32)
