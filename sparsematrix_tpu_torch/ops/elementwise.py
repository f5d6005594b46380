"""Elementwise and structural utilities on sparse containers.

Twin of ``sparsematrix_tpu/ops/elementwise.py``.  They act on the value
array only (the structure stays), and every one keeps padding slots at
zero.
"""
from __future__ import annotations

import dataclasses

import torch

from ..formats import CSR

__all__ = ["scale", "axpy_same_pattern", "diagonal", "frobenius_norm",
           "with_data"]


def with_data(A, data):
    """The same structure with another value array."""
    return dataclasses.replace(A, data=data)


def scale(A, alpha):
    """``alpha * A``; padding stays zero (alpha * 0 == 0)."""
    return with_data(A, A.data * alpha)


def axpy_same_pattern(alpha, A, B):
    """``alpha*A + B`` for containers of identical structure (same class,
    same indices).  Equal structure is the caller's contract; only the
    shapes are checked."""
    if (type(A) is not type(B) or A.shape != B.shape
            or A.data.shape != B.data.shape):
        raise ValueError("axpy_same_pattern requires identical structure")
    return with_data(B, alpha * A.data + B.data)


def diagonal(A: CSR) -> torch.Tensor:
    """The main diagonal of a CSR as a dense vector."""
    n = min(A.shape)
    rid = A._row_ids_or_compute().long()
    cols = A.indices.long()
    is_diag = (rid == cols) & (rid < n)
    contrib = torch.where(is_diag, A.data,
                          torch.zeros((), dtype=A.data.dtype,
                                      device=A.data.device))
    seg = torch.where(is_diag, rid, torch.full_like(rid, n))
    out = torch.zeros(n + 1, dtype=A.data.dtype, device=A.data.device)
    return out.index_add_(0, seg, contrib)[:n]


def frobenius_norm(A) -> torch.Tensor:
    """‖A‖_F in fp32; padding slots hold zeros, so nothing is masked."""
    return torch.sqrt(torch.sum(A.data.float() ** 2))
