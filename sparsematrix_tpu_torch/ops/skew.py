"""Hybrid SpMV/SpMM layout for power-law structures.

Twin of ``sparsematrix_tpu/ops/skew.py``.  On Zipf-degree matrices one hub
row or column forces every (tile, window) it touches to its own slab
depth, so the auto routes of ``prepare_spmv`` and ``spmm`` send such
matrices here:

1. **Hub columns** (column degree ≥ rows/8) move to a dense
   (rows × hc) block.
2. **Hub rows** (row degree ≥ cols/8, after the hub columns left) move to
   a dense (hr × cols) block.
3. **The rest is sorted by row degree** and packed by the normal auto
   layout; the output permutation is a planned permutation
   (``ops/permute.py``; a Clos plan on the window-permute kernel at
   these sizes).

    y = P⁻¹(spmv(base, x)) + D_rows @ x + scatter(D_cols @ x[hub_cols]).

The dense hub blocks are plain ``torch.matmul`` in fp32 (TF32 off), as
the JAX package leaves them to ``jnp.dot``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats import CSR
from ..formats.base import sparse_container, static_field

__all__ = ["SkewSpmv", "pack_skew", "spmv_skew", "spmm_skew", "skew_stats",
           "is_skewed"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class SkewSpmv:
    base: object  # packed layout over the degree-sorted remainder
    out_perm: object  # planned permutation: base slot → original row
    hub_rows: torch.Tensor  # (hr,) int32 original row ids
    hub_rows_dense: torch.Tensor  # (hr, cols) fp32
    hub_cols: torch.Tensor  # (hc,) int32 original col ids
    hub_cols_dense: torch.Tensor  # (rows, hc) fp32
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    @property
    def fill_rate(self) -> float:  # the base's fill
        return getattr(self.base, "fill_rate", 1.0)


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


def pack_skew(A: CSR, row_hub_frac: float = 0.125,
              col_hub_frac: float = 0.125, device=None,
              **base_kwargs) -> SkewSpmv:
    """Split hub rows/cols to dense blocks, degree-sort and pack the rest,
    on ``device`` (default: the CSR's)."""
    from .permute import plan_permutation_auto
    from .spmv import prepare_spmv

    dev = A.device if device is None else torch.device(device)
    sp = A.to_scipy().tocsr(copy=True)
    sp.sum_duplicates()
    rows, cols = sp.shape
    col_deg = np.bincount(sp.indices, minlength=cols)
    hub_cols = np.flatnonzero(col_deg >= max(int(rows * col_hub_frac), 64))
    if len(hub_cols):
        keep_mask = np.ones(cols, bool)
        keep_mask[hub_cols] = False
        csc = sp.tocsc()
        hub_cols_dense = np.asarray(csc[:, hub_cols].todense(),
                                    dtype=np.float32)
        # drop the hub columns from the sparse remainder
        keep_entry = keep_mask[sp.indices]
        rows_of = np.repeat(np.arange(rows), np.diff(sp.indptr))
        cnt = np.bincount(rows_of[keep_entry], minlength=rows)
        sp = sps.csr_matrix(
            (sp.data[keep_entry], sp.indices[keep_entry],
             np.concatenate([[0], np.cumsum(cnt)])),
            shape=(rows, cols))
    else:
        hub_cols_dense = np.zeros((rows, 0), np.float32)
    deg = np.diff(sp.indptr)
    hub_rows = np.flatnonzero(deg >= max(int(cols * row_hub_frac), 64))
    if len(hub_rows) == rows:
        # every row is a hub: keep one row in the sparse base so the
        # output-permutation plan stays well-formed
        hub_rows = hub_rows[:-1]
    if len(hub_rows):
        hub_rows_dense = np.asarray(sp[hub_rows].todense(), dtype=np.float32)
    else:
        hub_rows_dense = np.zeros((0, cols), np.float32)
    rest = np.setdiff1d(np.arange(rows), hub_rows, assume_unique=True)
    # degree-sort (descending, stable) so tiles carry near-uniform degrees
    order = rest[np.argsort(-deg[rest], kind="stable")]
    A_rest = sp[order].tocsr()
    base = prepare_spmv(CSR.from_scipy(A_rest, device=dev), skew="off",
                        **base_kwargs)
    # out[r] = y_rest[position of r in order]; hub rows read zero padding
    g = np.full(rows, len(order), np.int64)
    g[order] = np.arange(len(order))
    out_perm = plan_permutation_auto(g, n_src=max(len(order), 1),
                                     device=dev)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return SkewSpmv(
        base=base,
        out_perm=out_perm,
        hub_rows=put(hub_rows, torch.int32),
        hub_rows_dense=put(hub_rows_dense, torch.float32),
        hub_cols=put(hub_cols, torch.int32),
        hub_cols_dense=put(hub_cols_dense, torch.float32),
        shape=(rows, cols), nnz=A.nnz)


def _add_hubs(packed: SkewSpmv, y: torch.Tensor, X: torch.Tensor):
    """``y`` plus the dense hub blocks' products (vector or matrix X)."""
    if packed.hub_cols_dense.shape[1]:
        y = y + packed.hub_cols_dense @ X[packed.hub_cols.long()]
    if packed.hub_rows_dense.shape[0]:
        y = y.index_add(0, packed.hub_rows.long(), packed.hub_rows_dense @ X)
    return y


def spmv_skew(packed: SkewSpmv, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over the hybrid layout (differentiable: a composition
    of differentiable pieces)."""
    from .permute import apply_permutation
    from .spmv import spmv

    y_rest = spmv(packed.base, x)
    return _add_hubs(packed, apply_permutation(packed.out_perm, y_rest), x)


def _base_spmm(base, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS over the degree-sorted base pack: ``spmm`` where the pack
    type has a multi-RHS product, else one SpMV a column (any base
    layout, e.g. a rowlane superblock pack, which has none)."""
    from ..formats import StripDense
    from ..kernels.spmv_dualgather import DualGather
    from ..kernels.spmv_octet import Octet
    from .spmm import spmm
    from .spmm_lowdeg import SlicedEllMM
    from .spmv import spmv

    ok = isinstance(base, (Octet, SlicedEllMM, StripDense))
    if isinstance(base, DualGather):
        ok = base.k_tiles > 1 or (base.tail is None and not base.splits)
    if ok:
        return spmm(base, X)
    return torch.stack([spmv(base, X[:, j].contiguous())
                        for j in range(X.shape[1])], dim=1)


def spmm_skew(packed: SkewSpmv, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over the hybrid layout: the base's multi-RHS product,
    the row-wise planned unpermutation and the dense hub blocks
    (differentiable)."""
    from .permute import apply_permutation

    rows, cols = packed.shape
    if X.dim() != 2 or X.shape[0] != cols:
        raise ValueError(f"spmm_skew: X shape {tuple(X.shape)} incompatible "
                         f"with {packed.shape}")
    y_rest = _base_spmm(packed.base, X)
    return _add_hubs(packed, apply_permutation(packed.out_perm, y_rest), X)
