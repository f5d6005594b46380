"""Transposed products and the transpose on the device.

Twin of ``sparsematrix_tpu/ops/transpose_ops.py``.  ``spmv_t``/``spmm_t``:
``Aᵀ @ y`` without materializing Aᵀ (the same gather-multiply with the
row and column indices swapped).  ``csr_transpose_device``: the full
structural transpose computed on the container's device with two stable
sorts and a ``searchsorted``, the reference's ``sblas_trans_kernel``
(kernel.cc:31-187).  Padding entries (zero value, in-range indices) sort
to the end and stay harmless.
"""
from __future__ import annotations

import torch

from ..formats import COO, CSR

__all__ = ["spmv_t", "spmm_t", "csr_transpose_device"]


def _ids(A):
    if isinstance(A, CSR):
        return A._row_ids_or_compute().long(), A.indices.long()
    if isinstance(A, COO):
        return A.row.long(), A.col.long()
    raise TypeError(f"transposed ops support CSR/COO, got {type(A).__name__}")


def _gathered(A, rid, Y):
    """``Y[rid]`` with padding entries (row id ``rows``) reading 0."""
    valid = rid < A.shape[0]
    rows = Y[rid.clamp(max=A.shape[0] - 1)]
    mask = valid if Y.dim() == 1 else valid[:, None]
    return torch.where(mask, rows, torch.zeros((), dtype=Y.dtype,
                                               device=Y.device))


def spmv_t(A, y: torch.Tensor) -> torch.Tensor:
    """``x = Aᵀ @ y`` for a CSR/COO ``A`` (m×n), ``y`` of length m."""
    if y.shape[0] != A.shape[0]:
        raise ValueError(f"spmv_t: y shape {tuple(y.shape)} vs matrix {A.shape}")
    rid, cid = _ids(A)
    prod = A.data * _gathered(A, rid, y)
    out = torch.zeros(A.shape[1], dtype=prod.dtype, device=y.device)
    return out.index_add_(0, cid, prod)


def spmm_t(A, Y: torch.Tensor) -> torch.Tensor:
    """``X = Aᵀ @ Y`` for a CSR/COO ``A`` (m×n), ``Y`` (m, k)."""
    if Y.shape[0] != A.shape[0]:
        raise ValueError(f"spmm_t: Y shape {tuple(Y.shape)} vs matrix {A.shape}")
    rid, cid = _ids(A)
    prod = A.data[:, None] * _gathered(A, rid, Y)
    out = torch.zeros((A.shape[1], Y.shape[1]), dtype=prod.dtype,
                      device=Y.device)
    return out.index_add_(0, cid, prod)


def csr_transpose_device(A: CSR) -> CSR:
    """``Aᵀ`` as a new CSR, computed on the device.

    Two stable argsorts (by source row, then by source column, padding
    forced last) put the entries in the transposed row-major order;
    ``searchsorted`` rebuilds ``indptr``.  No fused sort key, so no index
    arithmetic can overflow at large shapes."""
    m, n = A.shape
    rid = A._row_ids_or_compute().long()
    cols = A.indices.long()
    valid = rid < m
    eff_cols = torch.where(valid, cols, torch.full_like(cols, n))  # pads last
    ord1 = torch.argsort(torch.where(valid, rid, torch.full_like(rid, m)),
                         stable=True)
    ord2 = torch.argsort(eff_cols[ord1], stable=True)
    order = ord1[ord2]
    v_o = valid[order]
    new_rid = torch.where(v_o, cols[order], torch.full_like(cols, n))
    new_cols = torch.where(v_o, rid[order].clamp(max=m - 1),
                           torch.zeros_like(rid))
    new_data = torch.where(v_o, A.data[order],
                           torch.zeros((), dtype=A.data.dtype,
                                       device=A.data.device))
    indptr = torch.searchsorted(
        new_rid, torch.arange(n + 1, device=new_rid.device), right=False)
    return CSR(
        indptr=indptr.to(A.indptr.dtype),
        indices=new_cols.to(A.indices.dtype),
        data=new_data,
        row_ids=new_rid.to(A.indices.dtype),
        shape=(n, m),
        nnz=A.nnz,
    )
