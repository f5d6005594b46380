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
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "gen_matrix_random",
    "gen_sparse_index_matrix",
    "gen_random_dense_sparse",
    "gen_zipf_csr",
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
