"""Matrix / vector / factor IO.

Replacement for the reference's IO layer
(/root/reference/io.h:1-100, io.cpp): GKlib-text CSR read/write,
factor-matrix text + binary IO, train/test/val splitting, binarization,
triplet export. A native C++ fast-path parser (see ``native/``) is used
when available; a pure-numpy path is the fallback.

GKlib text CSR format (as read by ``gk_csr_Read(..., GK_CSR_FMT_CSR,
GK_CSR_IS_VAL, 0)``, datastruct.cpp:16): line ``i`` holds row ``i`` as
whitespace-separated ``col val`` pairs with 0-indexed columns.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.utils import native


# ----------------------------------------------------------------------
# GKlib text CSR
# ----------------------------------------------------------------------

def read_csr(path: str, with_values: bool = True,
             ncols: Optional[int] = None) -> RatingMatrix:
    """Read a GKlib-text CSR file (gk_csr_Read analog).

    ``with_values=False`` reads an index-only file (one token per entry);
    the values are set to 1.0.
    """
    parsed = native.parse_csr_text(path, with_values)
    if parsed is not None:
        indptr, cols, vals = parsed
    else:
        indptr_l = [0]
        cols_l, vals_l = [], []
        with open(path, "r") as f:
            for lineno, line in enumerate(f):
                parts = line.split()
                if with_values:
                    if len(parts) % 2:
                        raise ValueError(
                            f"{path}:{lineno + 1}: odd token count "
                            f"({len(parts)}) — expected 'col val' pairs")
                    cols_l.append(np.asarray(parts[0::2], dtype=np.int64))
                    vals_l.append(np.asarray(parts[1::2], dtype=np.float32))
                else:
                    cols_l.append(np.asarray(parts, dtype=np.int64))
                indptr_l.append(indptr_l[-1] + len(cols_l[-1]))
        indptr = np.asarray(indptr_l, dtype=np.int64)
        cols = (np.concatenate(cols_l) if cols_l else
                np.zeros(0, dtype=np.int64))
        if with_values:
            vals = (np.concatenate(vals_l) if vals_l else
                    np.zeros(0, dtype=np.float32))
        else:
            vals = np.ones(len(cols), dtype=np.float32)
    if ncols is None:
        ncols = int(cols.max()) + 1 if len(cols) else 0
    return RatingMatrix(indptr, cols.astype(np.int32),
                        vals.astype(np.float32), ncols)


def write_csr(mat: RatingMatrix, path: str, with_values: bool = True) -> None:
    """Write GKlib-text CSR (gk_csr_Write analog)."""
    with open(path, "w") as f:
        for u in range(mat.nrows):
            cols, vals = mat.row(u)
            if with_values:
                f.write(" ".join(
                    f"{c} {_fmt(v)}" for c, v in zip(cols, vals)))
            else:
                f.write(" ".join(str(c) for c in cols))
            f.write("\n")


def _fmt(v: float) -> str:
    fv = float(v)
    return str(int(fv)) if fv == int(fv) else f"{fv:g}"


# ----------------------------------------------------------------------
# factor matrices (text parity with reference readMat/writeMat,
# io.cpp:48-156: whitespace-separated floats, one row per line)
# ----------------------------------------------------------------------

def read_factor_mat(path: str, nrows: int, ncols: int) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    if data.shape != (nrows, ncols):
        data = data.reshape(nrows, ncols)
    return data.astype(np.float32)


def write_factor_mat(mat: np.ndarray, path: str) -> None:
    np.savetxt(path, np.asarray(mat), fmt="%.7g")


def read_factor_mat_bin(path: str, nrows: Optional[int] = None,
                        ncols: Optional[int] = None) -> np.ndarray:
    """readMatBin analog (io.cpp:273-303): a headerless row-major stream
    of little-endian float64, nrows*ncols values — bit-compatible with
    files written by the reference binary. With nrows/ncols omitted the
    flat vector is returned (caller reshapes)."""
    raw = np.fromfile(path, dtype="<f8")
    if nrows is None or ncols is None:
        return raw.astype(np.float32)
    if raw.size < nrows * ncols:
        raise ValueError(f"{path}: {raw.size} values < {nrows}x{ncols}")
    return raw[: nrows * ncols].reshape(nrows, ncols).astype(np.float32)


def write_factor_mat_bin(mat: np.ndarray, path: str) -> None:
    """writeMatBin analog (io.cpp:157-184): raw little-endian float64
    row-major stream, no header — readable by the reference."""
    np.asarray(mat, dtype="<f8").tofile(path)


def read_vector(path: str) -> np.ndarray:
    """readVector analog (io.h): one float per line."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def write_vector(vec: np.ndarray, path: str) -> None:
    np.savetxt(path, np.asarray(vec).reshape(-1), fmt="%.7g")


# ----------------------------------------------------------------------
# splits / transforms
# ----------------------------------------------------------------------

def split_train_test_val(mat: RatingMatrix, test_pc: float, val_pc: float,
                         seed: int) -> Tuple[RatingMatrix, RatingMatrix,
                                             RatingMatrix]:
    """writeTrainTestValMat analog (io.cpp:410-459): color ``test_pc*nnz``
    random entries (with replacement → approximate count) as test, then
    ``val_pc*nnz`` distinct remaining entries as val; split keeps the full
    (nrows, ncols) shape for all three parts (gk_csr_Split semantics)."""
    nnz = mat.nnz
    rng = np.random.default_rng(seed)
    color = np.zeros(nnz, dtype=np.int8)
    n_test = int(test_pc * nnz)
    n_val = int(val_pc * nnz)
    # test: sample with replacement like the reference (duplicates collapse)
    color[rng.integers(0, nnz, size=n_test)] = 1
    i = 0
    while i < n_val:
        k = int(rng.integers(0, nnz))
        if color[k] == 0:
            color[k] = 2
            i += 1
    r, c, v = mat.to_coo()
    out = []
    for tag in (0, 1, 2):
        m = color == tag
        out.append(RatingMatrix.from_coo(r[m], c[m], v[m],
                                         mat.nrows, mat.ncols))
    return out[0], out[1], out[2]


def binarize(mat: RatingMatrix, thresh: float) -> RatingMatrix:
    """writeBinarizedTrainValTest analog (io.cpp:187): keep entries with
    value >= thresh at value 1, drop the rest."""
    r, c, v = mat.to_coo()
    m = v >= thresh
    return RatingMatrix.from_coo(r[m], c[m], np.ones(m.sum(), np.float32),
                                 mat.nrows, mat.ncols)


def subsample(mat: RatingMatrix, keep_pc: float, seed: int) -> RatingMatrix:
    """Random nnz subsample (writeSubSampledMat analog)."""
    rng = np.random.default_rng(seed)
    r, c, v = mat.to_coo()
    m = rng.random(mat.nnz) < keep_pc
    return RatingMatrix.from_coo(r[m], c[m], v[m], mat.nrows, mat.ncols)


def write_triplets(mat: RatingMatrix, path: str) -> None:
    """writeTriplets analog (io.cpp:1183-1191): ``u i r`` per line."""
    with open(path, "w") as f:
        r, c, v = mat.to_coo()
        for u, i, val in zip(r, c, v):
            f.write(f"{u} {i} {_fmt(val)}\n")


def read_triplets(path: str, nrows: Optional[int] = None,
                  ncols: Optional[int] = None) -> RatingMatrix:
    data = np.loadtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    r = data[:, 0].astype(np.int64)
    c = data[:, 1].astype(np.int64)
    v = data[:, 2].astype(np.float32)
    if nrows is None:
        nrows = int(r.max()) + 1 if len(r) else 0
    if ncols is None:
        ncols = int(c.max()) + 1 if len(c) else 0
    return RatingMatrix.from_coo(r, c, v, nrows, ncols)


# ----------------------------------------------------------------------
# item-item similarity graphs (io.cpp:943-1060 writeItemSimMat /
# writeItemJaccSimMat / *Par): cosine or Jaccard over item columns,
# written as a CSR adjacency with values. Computed blocked on device-able
# dense math (numpy here; small graphs) — top-k sparsified.
# ----------------------------------------------------------------------

def item_cosine_sim(mat: RatingMatrix, top_k: int = 50,
                    block: int = 1024) -> RatingMatrix:
    n_items = mat.ncols
    colptr, rowind, colval = mat.csc()
    # native OpenMP two-hop fast path (writeItemSimMatPar analog)
    out = native.item_cosine_topk(colptr, rowind, colval, mat.indptr,
                                  mat.indices, mat.values, n_items,
                                  mat.nrows, top_k)
    if out is not None:
        cols_n, vals_n = out
        keep = (cols_n >= 0) & (vals_n > 0)
        rr = np.repeat(np.arange(n_items), top_k).reshape(n_items, top_k)
        return RatingMatrix.from_coo(rr[keep], cols_n[keep], vals_n[keep],
                                     n_items, n_items)
    # dense item x user is too big; use normalized sparse columns blocked
    import scipy.sparse as sp  # available in the baked image via deps
    X = sp.csr_matrix((colval, rowind, colptr), shape=(n_items, mat.nrows))
    norms = np.sqrt(X.multiply(X).sum(axis=1)).A.ravel()
    norms[norms == 0] = 1.0
    rows_out, cols_out, vals_out = [], [], []
    for s in range(0, n_items, block):
        e = min(s + block, n_items)
        sim = (X[s:e] @ X.T).toarray() / (norms[s:e, None] * norms[None, :])
        np.fill_diagonal(sim[:, s:e], 0.0)
        k = min(top_k, n_items - 1)
        idx = np.argpartition(-sim, k, axis=1)[:, :k]
        v = np.take_along_axis(sim, idx, axis=1)
        keep = v > 0
        rr = np.repeat(np.arange(s, e), k).reshape(e - s, k)
        rows_out.append(rr[keep])
        cols_out.append(idx[keep])
        vals_out.append(v[keep])
    return RatingMatrix.from_coo(
        np.concatenate(rows_out), np.concatenate(cols_out),
        np.concatenate(vals_out), n_items, n_items)


def item_jaccard_sim(mat: RatingMatrix, top_k: int = 50,
                     block: int = 1024) -> RatingMatrix:
    """writeItemJaccSimMatPar analog (io.cpp:1027): |A∩B| / |A∪B| over the
    rating-support sets of item pairs."""
    n_items = mat.ncols
    colptr, rowind, _ = mat.csc()
    import scipy.sparse as sp
    X = sp.csr_matrix((np.ones(mat.nnz, np.float32), rowind, colptr),
                      shape=(n_items, mat.nrows))
    sizes = np.asarray(X.sum(axis=1)).ravel()
    rows_out, cols_out, vals_out = [], [], []
    for s in range(0, n_items, block):
        e = min(s + block, n_items)
        inter = (X[s:e] @ X.T).toarray()
        union = sizes[s:e, None] + sizes[None, :] - inter
        union[union == 0] = 1.0
        sim = inter / union
        np.fill_diagonal(sim[:, s:e], 0.0)
        k = min(top_k, n_items - 1)
        idx = np.argpartition(-sim, k, axis=1)[:, :k]
        v = np.take_along_axis(sim, idx, axis=1)
        keep = v > 0
        rr = np.repeat(np.arange(s, e), k).reshape(e - s, k)
        rows_out.append(rr[keep])
        cols_out.append(idx[keep])
        vals_out.append(v[keep])
    return RatingMatrix.from_coo(
        np.concatenate(rows_out), np.concatenate(cols_out),
        np.concatenate(vals_out), n_items, n_items)


def write_csr_with_model_values(mat: RatingMatrix, u_fac: np.ndarray,
                                i_fac: np.ndarray, path: str,
                                with_values: bool = True) -> None:
    """writeCSRWSparsityStructure analog (io.cpp:690-714): same sparsity
    pattern, values replaced by a factor model's predictions."""
    r, c, _ = mat.to_coo()
    vals = np.einsum("ek,ek->e", u_fac[r], i_fac[c]).astype(np.float32)
    out = RatingMatrix.from_coo(r, c, vals, mat.nrows, mat.ncols)
    write_csr(out, path, with_values)


def tail_test_mat(mat: RatingMatrix, head_mask: np.ndarray,
                  max_ratings: int = 5000) -> RatingMatrix:
    """writeTailTestMat analog (io.cpp:~500): keep only tail-item test
    entries, capped at ``max_ratings`` total."""
    r, c, v = mat.to_coo()
    keep = ~head_mask[c]
    r, c, v = r[keep], c[keep], v[keep]
    if len(r) > max_ratings:
        r, c, v = r[:max_ratings], c[:max_ratings], v[:max_ratings]
    return RatingMatrix.from_coo(r, c, v, mat.nrows, mat.ncols)


def split_in_half(mat: RatingMatrix, seed: int
                  ) -> Tuple[RatingMatrix, RatingMatrix]:
    """splitValMat analog (main.cpp:1203-1231): random exact-half nnz
    split, both halves keeping the full shape."""
    rng = np.random.default_rng(seed)
    nnz = mat.nnz
    color = np.zeros(nnz, np.int8)
    color[rng.permutation(nnz)[: nnz // 2]] = 1
    r, c, v = mat.to_coo()
    a = RatingMatrix.from_coo(r[color == 0], c[color == 0], v[color == 0],
                              mat.nrows, mat.ncols)
    b = RatingMatrix.from_coo(r[color == 1], c[color == 1], v[color == 1],
                              mat.nrows, mat.ncols)
    return a, b
