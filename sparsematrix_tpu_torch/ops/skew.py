"""Hybrid layout for power-law structures: its statistics and container.

Twin of ``sparsematrix_tpu/ops/skew.py`` (``skew_stats`` and ``SkewSpmv``
only).  On Zipf-degree matrices one hub row or column forces every
(tile, window) it touches to its own slab depth, so the auto routes of
``prepare_spmv`` and ``spmm`` send such matrices to the hybrid layout
(hub rows and columns dense, the rest degree-sorted and packed).  Its
output permutation runs on the window-permute kernel, which is not ported
yet: ``pack_skew`` and the products over a ``SkewSpmv`` raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats import CSR

__all__ = ["SkewSpmv", "pack_skew", "skew_stats", "SKEW_TODO"]

SKEW_TODO = ("the skew layout needs the output permutation (the window "
             "permute, kernel row 17), not ported yet (ROADMAP.md, Queue 1 "
             "item 5, Queue 2 item 7)")


@dataclasses.dataclass(frozen=True)
class SkewSpmv:
    base: object  # packed layout over the degree-sorted remainder
    out_perm: object  # planned permutation: base slot → original row
    hub_rows: torch.Tensor  # (hr,) int32 original row ids
    hub_rows_dense: torch.Tensor  # (hr, cols) fp32
    hub_cols: torch.Tensor  # (hc,) int32 original col ids
    hub_cols_dense: torch.Tensor  # (rows, hc) fp32
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})


def skew_stats(A: CSR):
    """(max_row_deg, mean_row_deg, max_col_deg) from host arrays."""
    deg = np.diff(A.indptr.cpu().numpy())
    cd = np.bincount(A.indices[: A.nnz].cpu().numpy(), minlength=A.shape[1])
    mean = max(A.nnz / max(A.shape[0], 1), 1e-9)
    return int(deg.max(initial=0)), float(mean), int(cd.max(initial=0))


def is_skewed(A: CSR) -> bool:
    """The auto routes' power-law guard (``ops/spmv.py:232-244``,
    ``ops/spmm.py:225-236`` of the JAX package)."""
    if A.shape[0] < 4096 or A.nnz < 65536:
        return False
    dmax, dmean, cmax = skew_stats(A)
    cmean = max(A.nnz / max(A.shape[1], 1), 1e-9)
    return dmax >= max(32 * dmean, 512) or cmax >= max(32 * cmean, 512)


def pack_skew(A: CSR, **kwargs) -> SkewSpmv:
    raise NotImplementedError(f"pack_skew: {SKEW_TODO}")
