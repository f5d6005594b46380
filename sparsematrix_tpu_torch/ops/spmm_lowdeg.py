"""Sliced-ELL row-gather SpMM — the low-degree multi-RHS layout.

Twin of ``sparsematrix_tpu/ops/spmm_lowdeg.py``, plain PyTorch as the JAX
version is plain jnp:

    y[r] = Σ_j vals[r, j] · X[cols[r, j], :]

Rows are degree-sorted and split into segments whose widths track their
own maximum degree (cut where padding would exceed ``max_waste``); one
batched product per segment, and the output is restored by a row gather.
``spmm`` routes low-density CSR with at most 16 entries per row here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats import CSR

__all__ = ["SlicedEllMM", "pack_sliced_ell", "spmm_sliced_ell"]


@dataclasses.dataclass(frozen=True)
class SlicedEllMM:
    vals: tuple  # per segment: (nb, w) fp32 (zero padding)
    cols: tuple  # per segment: (nb, w) int32 (sentinel = cols → zero row)
    out_rows: torch.Tensor  # (rows,) int32: sorted-slot index per row
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def fill_rate(self) -> float:
        pad = sum(int(v.numel()) for v in self.vals)
        return self.nnz / max(pad, 1)


def pack_sliced_ell(A: CSR, max_waste: float = 0.33,
                    max_segments: int = 8) -> SlicedEllMM:
    """Degree-sort rows and cut segments where a single width would
    waste more than ``max_waste`` of its cells; on the CSR's device."""
    dev = A.device
    sp = A.to_scipy().tocsr()
    sp.sum_duplicates()
    rows, cols = sp.shape
    deg = np.diff(sp.indptr)
    order = np.argsort(-deg, kind="stable")
    sdeg = deg[order]
    # segment cuts: width = segment's first (max) degree; close the
    # segment when mean/width drops under 1 - max_waste, respecting the
    # segment budget (the tail segment takes whatever remains)
    cuts = [0]
    i = 0
    while i < rows and len(cuts) <= max_segments:
        w = max(int(sdeg[i]), 1)
        j = i
        acc = 0
        while j < rows:
            nxt = acc + int(sdeg[j])
            if (j - i + 1) * w * (1 - max_waste) > nxt \
                    and len(cuts) < max_segments:
                break
            acc = nxt
            j += 1
        cuts.append(j)
        i = j
    if cuts[-1] < rows:
        cuts.append(rows)
    vals_b, cols_b = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        seg_rows = order[a:b]
        w = max(int(sdeg[a]) if a < rows else 1, 1)
        nb = b - a
        v = np.zeros((nb, w), np.float32)
        c = np.full((nb, w), cols, np.int64)
        lo = sp.indptr[seg_rows]
        ln = deg[seg_rows]
        t_ix = np.repeat(np.arange(nb), ln)
        j_ix = np.arange(int(ln.sum())) - np.repeat(
            np.cumsum(ln) - ln, ln)
        src_ix = np.repeat(lo, ln) + j_ix
        v[t_ix, j_ix] = sp.data[src_ix]
        c[t_ix, j_ix] = sp.indices[src_ix]
        vals_b.append(torch.from_numpy(v).to(dev))
        cols_b.append(torch.from_numpy(c).to(dev, torch.int32))
    g = np.empty(rows, np.int64)
    g[order] = np.arange(rows)
    return SlicedEllMM(
        vals=tuple(vals_b), cols=tuple(cols_b),
        out_rows=torch.from_numpy(g).to(dev, torch.int32),
        shape=(rows, cols), nnz=int(sp.nnz))


def spmm_sliced_ell(packed: SlicedEllMM, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` (differentiable in X; row gathers and batched
    products, fp32 without TF32)."""
    k = X.shape[1]
    Xp = torch.cat([X, X.new_zeros((1, k))])  # sentinel row
    parts = [torch.einsum("rw,rwk->rk", v.to(X.dtype), Xp[c.long()])
             for v, c in zip(packed.vals, packed.cols)]
    y_sorted = torch.cat(parts, dim=0)  # (rows, k) in degree order
    return y_sorted[packed.out_rows.long()]
