"""Structure validators: host-side checks of sparse containers.

Twin of ``sparsematrix_tpu/formats/validate.py``.  The reference checks
only with ``assert`` (kernel.h:22); ``validate`` verifies every invariant
the kernels rely on (monotone indptr, in-range indices, harmless padding)
and returns a list of readable problems (empty = valid).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .base import host_values
from .bsr import BSR
from .codebook import CodebookCSR
from .coo import COO
from .csr import CSR

__all__ = ["validate"]


def _check_csr_like(sp, problems: List[str], cols: int):
    indptr = host_values(sp.indptr)
    indices = host_values(sp.indices)
    if indptr[0] != 0:
        problems.append(f"indptr[0] = {indptr[0]} != 0")
    if (np.diff(indptr) < 0).any():
        problems.append("indptr not monotone non-decreasing")
    if indptr[-1] != sp.nnz:
        problems.append(f"indptr[-1] = {indptr[-1]} != nnz = {sp.nnz}")
    if sp.nnz > indices.shape[0]:
        problems.append(f"nnz {sp.nnz} exceeds capacity {indices.shape[0]}")
    real = indices[: sp.nnz]
    if real.size and (real.min() < 0 or real.max() >= cols):
        problems.append(f"column indices out of range [0, {cols})")
    if sp.row_ids is not None and not problems:
        rid = host_values(sp.row_ids)[: sp.nnz]
        if rid.size and (np.diff(rid) < 0).any():
            problems.append("row_ids not sorted")
        counts = np.diff(indptr)
        expect = np.repeat(np.arange(len(counts)), counts)[: sp.nnz]
        if not np.array_equal(rid, expect):
            problems.append("row_ids inconsistent with indptr")


def validate(sp) -> List[str]:
    problems: List[str] = []
    rows, cols = sp.shape
    if isinstance(sp, COO):
        r = host_values(sp.row)[: sp.nnz]
        c = host_values(sp.col)[: sp.nnz]
        if r.size and (r.min() < 0 or r.max() >= rows):
            problems.append("row indices out of range")
        if c.size and (c.min() < 0 or c.max() >= cols):
            problems.append("col indices out of range")
        pad = host_values(sp.data)[sp.nnz:]
        if pad.size and np.abs(pad).max() != 0:
            problems.append("padding data not zero")
    elif isinstance(sp, CodebookCSR):
        _check_csr_like(sp, problems, cols)
        vi = host_values(sp.val_idx)
        if vi[: sp.nnz].size and vi[: sp.nnz].max() > sp.table_size:
            problems.append("val_idx beyond sentinel slot")
        if (vi[sp.nnz:] != sp.table_size).any():
            problems.append("padding val_idx not pointing at sentinel")
        if float(host_values(sp.val_table)[-1]) != 0.0:
            problems.append("sentinel table slot not zero")
    elif isinstance(sp, CSR):
        _check_csr_like(sp, problems, cols)
        pad = host_values(sp.data)[sp.nnz:]
        if pad.size and np.abs(pad).max() != 0:
            problems.append("padding data not zero")
    elif isinstance(sp, BSR):
        indptr = host_values(sp.indptr)
        if (np.diff(indptr) < 0).any():
            problems.append("block indptr not monotone")
        if indptr[-1] != sp.num_blocks:
            problems.append("indptr[-1] != num_blocks")
        bi = host_values(sp.indices)[: sp.num_blocks]
        nbc = -(-cols // sp.block_shape[1])
        if bi.size and (bi.min() < 0 or bi.max() >= nbc):
            problems.append("block column indices out of range")
        pad = host_values(sp.data)[sp.num_blocks:]
        if pad.size and np.abs(pad).max() != 0:
            problems.append("padding blocks not zero")
    else:
        problems.append(f"validate: unsupported type {type(sp).__name__}")
    return problems
