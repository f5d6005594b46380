"""Random matrix generators and check policies for tests and chip runs.

A copy of the numpy half of ``sparsematrix_tpu/utils/testutils.py`` (the
port imports nothing of the JAX package).  Mirrors the reference harness:
  * ``gen_matrix_random`` — dense uniform values in ±1000
    (the reference's ``src/test/blas_test.h:120-130``).
  * ``gen_sparse_index_matrix`` — density*100% nonzeros drawn as codebook
    indices into a random value table (blas_test.h:133-147; default density
    0.25, 255-entry table, blas_test.h:224,139).
  * ``relative_check`` — per-element relative error ≤ tol with an allowance
    of ``size * outlier_frac`` outliers (blas_test.h:161-182: tol 0.1,
    outlier_frac 1e-4) — loose because values span ±1000 and summation
    order differs between implementations.
  * ``quantized_check`` — the scale-floored policy for bf16/quantized paths.
  * ``gen_zipf_csr`` — power-law rows (and columns), a copy of the JAX
    bench's generator (``sparsematrix_tpu/bench/suite.py:716-741``).
  * ``poisson2d`` — the 5-point 2-D Poisson operator of the JAX bench's
    solver rows (``suite.py:1444-1461``).
  * ``triangular`` / ``tri_oracle`` — a diagonally dominant random
    triangular factor and its float64 ``spsolve_triangular`` solve.
  * ``scattered_lower`` — the JAX bench's ``trisolve`` factor, a lower
    factor of uniformly scattered entries.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "gen_matrix_random",
    "gen_sparse_index_matrix",
    "gen_random_dense_sparse",
    "gen_zipf_csr",
    "poisson2d",
    "triangular",
    "tri_oracle",
    "scattered_lower",
    "relative_check",
    "quantized_check",
    "REF_TOL",
    "REF_OUTLIER_FRAC",
]

REF_TOL = 0.1
REF_OUTLIER_FRAC = 1e-4


def gen_matrix_random(rng: np.random.Generator, rows: int, cols: int,
                      lo: float = -1000.0, hi: float = 1000.0,
                      dtype=np.float32) -> np.ndarray:
    return rng.uniform(lo, hi, size=(rows, cols)).astype(dtype)


def gen_sparse_index_matrix(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    density: float = 0.25,
    table_size: int = 255,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (index_matrix, val_table).

    Entries equal to ``table_size`` denote zero (out-of-table sentinel
    index), matching the reference convention that indices outside
    ``[0, table_size)`` are zeros (sparse-matrix.cc:44).
    """
    val_table = rng.uniform(-1000.0, 1000.0, size=(table_size,)).astype(np.float32)
    idx = rng.integers(0, table_size, size=(rows, cols))
    mask = rng.random((rows, cols)) < density
    idx_mtx = np.where(mask, idx, table_size).astype(np.int64)
    return idx_mtx, val_table


def gen_random_dense_sparse(rng: np.random.Generator, rows: int, cols: int,
                            density: float = 0.25,
                            dtype=np.float32) -> np.ndarray:
    """Dense array with ``density`` fraction of nonzeros, values ±1000."""
    vals = rng.uniform(-1000.0, 1000.0, size=(rows, cols)).astype(dtype)
    mask = rng.random((rows, cols)) < density
    return np.where(mask, vals, 0).astype(dtype)


def relative_check(result, oracle, tol: float = REF_TOL,
                   outlier_frac: float = REF_OUTLIER_FRAC) -> bool:
    """Reference tolerance policy (blas_test.h:161-182)."""
    result = np.asarray(result, dtype=np.float64)
    oracle = np.asarray(oracle, dtype=np.float64)
    denom = np.maximum(np.abs(oracle), 1e-30)
    rel = np.abs(result - oracle) / denom
    # entries tiny in both are fine regardless of relative error
    tiny = (np.abs(oracle) < 1e-3) & (np.abs(result) < 1e-3)
    bad = (rel > tol) & ~tiny
    allowed = max(1, int(result.size * outlier_frac))
    return int(bad.sum()) <= allowed


def quantized_check(result, oracle, med_tol: float = 0.02,
                    q99_tol: float = 0.1) -> bool:
    """Check policy for bf16/quantized paths: operand rounding puts the
    error at ~0.4 % of the OUTPUT SCALE, which a per-element relative
    policy cannot express at cancellation points — judge against the
    fp64 oracle with a scale-floored denominator instead."""
    result = np.asarray(result, dtype=np.float64)
    oracle = np.asarray(oracle, dtype=np.float64)
    scale = np.abs(oracle).max()
    rel = np.abs(result - oracle) / (np.abs(oracle) + 0.02 * max(scale, 1e-30))
    return bool(np.median(rel) < med_tol and np.quantile(rel, 0.99) < q99_tol)


def gen_zipf_csr(seed, n, m, total_nnz, alpha=0.8, col_zipf=False):
    """Power-law structure: row degrees follow a rank-α power law
    ``deg_i ∝ (i+1)^-α`` shuffled over rows (α=0.8 ≈ web/social-graph
    out-degree); ``col_zipf`` draws column targets from the same law (hub
    columns), else uniform.  Values uniform in ±1000.  Duplicates merge,
    so the realized nnz is slightly under ``total_nnz``.  Returns a scipy
    CSR matrix."""
    import scipy.sparse as sps

    g = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** (-alpha)
    deg = np.maximum(1, np.round(w * (total_nnz / w.sum()))).astype(
        np.int64)
    g.shuffle(deg)
    rows_ = np.repeat(np.arange(n), deg)
    if col_zipf:
        wc = (np.arange(m) + 1.0) ** (-alpha)
        cols_ = g.choice(m, size=rows_.size, p=wc / wc.sum())
    else:
        cols_ = g.integers(0, m, rows_.size)
    data_ = g.uniform(-1000, 1000, rows_.size).astype(np.float32)
    sp = sps.coo_matrix((data_, (rows_, cols_)), shape=(n, m)).tocsr()
    sp.sum_duplicates()
    return sp


def poisson2d(n, eps=1.0):
    """5-point Laplacian on a √n×√n grid, −u_xx − eps·u_yy (anisotropic
    for eps != 1); returns (n_actual, scipy CSR, fp64).  The JAX bench's
    ``_poisson2d`` with the diagonals' type given (the same matrix, without
    scipy's warning about integer diagonals)."""
    import scipy.sparse as sps

    side = int(np.sqrt(n))
    n = side * side
    Iq = sps.eye(side)
    if eps == 1.0:
        T = sps.diags([-1, 4, -1], [-1, 0, 1], (side, side),
                      dtype=np.float64)
        Apo = (sps.kron(Iq, T) + sps.kron(sps.diags([-1, -1], [-1, 1],
                                                    (side, side),
                                                    dtype=np.float64),
                                          Iq)).tocsr()
    else:
        Tx = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (side, side),
                       dtype=np.float64)
        Apo = (sps.kron(Iq, Tx) + eps * sps.kron(Tx, Iq)).tocsr()
    return n, Apo


def triangular(n, per_row, band=None, unit=False, lower=True, seed=0):
    """A diagonally dominant triangular scipy CSR (fp32): ``per_row``
    off-diagonal draws a row (duplicates merged), within ``band`` of the
    diagonal (None: anywhere below it), values in ±1; the diagonal is 1 +
    the row's absolute sum, or 1 with the row scaled to an absolute sum
    ≤ 0.5 when ``unit``; the transpose when not ``lower``.  Dominance
    bounds how far a solve amplifies summation-order differences."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(1, n), per_row)
    if band is None:
        c = (rng.random(r.size) * r).astype(np.int64)
    else:
        c = r - rng.integers(1, band + 1, r.size)
    keep = c >= 0
    r, c = r[keep], c[keep]
    E = sps.coo_matrix((rng.uniform(-1, 1, r.size), (r, c)),
                       shape=(n, n)).tocsr()
    E.sum_duplicates()
    rowsum = np.asarray(abs(E).sum(axis=1)).ravel()
    if unit:
        E = sps.diags(0.5 / np.maximum(rowsum, 0.5)) @ E
        d = np.ones(n)
    else:
        d = 1.0 + rowsum
    T = (E + sps.diags(d)).tocsr().astype(np.float32)
    return T if lower else T.T.tocsr()


def tri_oracle(sp, b, lower=True, unit=False):
    """float64 ``spsolve_triangular`` of ``sp`` (its diagonal taken as 1
    where ``unit``); a 2-D ``b`` solves column by column."""
    import scipy.sparse.linalg as spla

    sp64 = sp.astype(np.float64).tolil()
    if unit:
        sp64.setdiag(1.0)
    return spla.spsolve_triangular(sp64.tocsr(),
                                   np.asarray(b, np.float64), lower=lower)


def scattered_lower(n: int = 65536, nnz_row: int = 8):
    """The JAX bench's ``trisolve`` factor (``bench/suite.py:1264-1278``)
    at n = 65536: the strictly lower part of a uniformly random n×n
    pattern of ``nnz_row`` entries a row (values in [0, 1)) plus 4·I; b
    from ``default_rng(6)``, values in ±1000.  The bench draws the pattern
    with ``sps.random``, which takes minutes at this n (it samples n²
    positions without replacement); this draws the same law from
    ``default_rng(6)`` with replacement, duplicates merged.  Returns
    (scipy CSR, b)."""
    import scipy.sparse as sps

    rng = np.random.default_rng(6)
    k = n * nnz_row
    d = sps.coo_matrix((rng.random(k, dtype=np.float32),
                        (rng.integers(0, n, k), rng.integers(0, n, k))),
                       shape=(n, n)).tocsr()
    d.sum_duplicates()
    L = (sps.tril(d, k=-1).tocsr()
         + sps.eye(n, format="csr", dtype=np.float32) * 4.0).tocsr()
    return L, gen_matrix_random(rng, n, 1)[:, 0]
