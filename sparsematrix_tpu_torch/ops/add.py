"""Sparse + sparse over different patterns: a plan of the union.

Twin of ``sparsematrix_tpu/ops/add.py``.  The host computes the union
structure once and the slot of C that each input entry lands in; the
numeric phase is two scatter-adds on the device, reusable for new values
on the same patterns.  ``alpha*A + beta*B`` for any two CSR patterns.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats import CSR
from ..formats.base import default_index_dtype, sparse_container, static_field

__all__ = ["SparseAddPlan", "sparse_add_plan", "sparse_add_apply",
           "sparse_add"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class SparseAddPlan:
    a_target: torch.Tensor  # (a_cap,) slot of C per A entry (padding: c_nnz)
    b_target: torch.Tensor  # (b_cap,)
    c_indptr: torch.Tensor
    c_indices: torch.Tensor
    c_row_ids: torch.Tensor
    shape: Tuple[int, int] = static_field()
    c_nnz: int = static_field()


def sparse_add_plan(A: CSR, B: CSR) -> SparseAddPlan:
    if A.shape != B.shape:
        raise ValueError(f"sparse_add: shapes {A.shape} vs {B.shape}")
    sa = A.to_scipy().tocsr()
    sb = B.to_scipy().tocsr()
    sa.sort_indices()
    sb.sort_indices()
    m, n = sa.shape

    # the union pattern from the structure, not the values: an explicitly
    # stored zero is a stored slot and gets a target like any other
    def ind(s):
        return sps.csr_matrix(
            (np.ones(len(s.indices), np.int8), s.indices, s.indptr),
            shape=s.shape)

    pattern = (ind(sa) + ind(sb)).tocsr()
    pattern.sort_indices()
    c_nnz = int(pattern.nnz)
    c_indptr, c_indices = pattern.indptr, pattern.indices
    # row-major with sorted columns: row*n + col is sorted, so each input
    # entry's slot is one searchsorted
    c_rows = np.repeat(np.arange(m), np.diff(c_indptr))
    key_c = c_rows.astype(np.int64) * n + c_indices.astype(np.int64)

    def targets(s, cap):
        rows_s = np.repeat(np.arange(m), np.diff(s.indptr))
        key_s = rows_s.astype(np.int64) * n + s.indices.astype(np.int64)
        out = np.full(cap, c_nnz, dtype=np.int64)  # padding: the drop slot
        out[: len(key_s)] = np.searchsorted(key_c, key_s)
        return out

    crow = np.full(max(c_nnz, 1), m, np.int64)
    crow[:c_nnz] = c_rows
    ci = np.zeros(max(c_nnz, 1), np.int64)
    ci[:c_nnz] = c_indices

    def dev(a):
        return torch.from_numpy(a).to(A.device, default_index_dtype)

    return SparseAddPlan(
        a_target=dev(targets(sa, A.capacity)),
        b_target=dev(targets(sb, B.capacity)),
        c_indptr=dev(c_indptr.astype(np.int64)),
        c_indices=dev(ci),
        c_row_ids=dev(crow),
        shape=A.shape,
        c_nnz=c_nnz,
    )


def sparse_add_apply(plan: SparseAddPlan, a_data, b_data, alpha=1.0,
                     beta=1.0) -> CSR:
    cap = plan.c_indices.shape[0]
    dt = torch.promote_types(a_data.dtype, b_data.dtype)
    # one spare slot takes the padding entries and is cut away
    c = torch.zeros(cap + 1, dtype=dt, device=a_data.device)
    c.index_add_(0, plan.a_target.long(), (alpha * a_data).to(dt))
    c.index_add_(0, plan.b_target.long(), (beta * b_data).to(dt))
    return CSR(indptr=plan.c_indptr, indices=plan.c_indices, data=c[:-1],
               row_ids=plan.c_row_ids, shape=plan.shape, nnz=plan.c_nnz)


def sparse_add(A: CSR, B: CSR, alpha=1.0, beta=1.0) -> CSR:
    """``alpha*A + beta*B`` over the union pattern."""
    plan = sparse_add_plan(A, B)
    return sparse_add_apply(plan, A.data, B.data, alpha, beta)
