"""Format conversions.

Twin of ``sparsematrix_tpu/formats/convert.py``.  Conversions are
host-side build-time operations (the reference's encode-once /
multiply-many design, ``CopyForm``, sparse-matrix.cc:21-99): they go
through scipy or numpy and return containers on ``device`` (default: the
input's device).

``bsr_to_csr`` and ``ell_to_csr`` return the CSR the JAX package returns
(``CSR.fromdense`` of the dense matrix: explicit zeros dropped, columns
sorted, the same capacity) but build it through scipy, without ever
materializing the dense matrix.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import default_index_dtype, host_values
from .bsr import BSR
from .coo import COO
from .csr import CSR
from .ell import ELL, BlockedELL

__all__ = ["coo_to_csr", "csr_to_coo", "csr_to_ell", "csr_to_blocked_ell",
           "csr_to_bsr", "bsr_to_csr", "ell_to_csr"]


def _dev(x, device):
    return x.device if device is None else resolve_device(device)


def coo_to_csr(coo: COO, capacity: int | None = None, device=None) -> CSR:
    return CSR.from_scipy(coo.to_scipy(), capacity=capacity or coo.capacity,
                          device=_dev(coo, device))


def csr_to_coo(csr: CSR, capacity: int | None = None, device=None) -> COO:
    return COO.from_scipy(csr.to_scipy(), capacity=capacity or csr.capacity,
                          device=_dev(csr, device))


def csr_to_ell(csr: CSR, row_capacity: int | None = None,
               sort_rows: bool = False, truncate: bool = False,
               device=None) -> Tuple[ELL, np.ndarray]:
    """CSR → ELL.  With ``sort_rows=True`` rows are permuted by descending
    count (SELL-C-sigma style, sigma = all rows) to cut padding; returns
    the row permutation (the identity without sorting), so that
    ``y[perm] = y_ell``.  Rows over ``row_capacity`` raise unless
    ``truncate=True``; a truncated ELL's ``nnz`` counts its stored
    entries."""
    sp = csr.to_scipy()
    rows = sp.shape[0]
    counts = np.diff(sp.indptr)
    perm = np.argsort(-counts, kind="stable") if sort_rows else np.arange(rows)
    R = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if row_capacity is not None:
        R = int(row_capacity)
        if counts.size and int(counts.max()) > R and not truncate:
            raise ValueError(
                f"csr_to_ell: a row has {int(counts.max())} entries > "
                f"row_capacity={R}; pass truncate=True to drop the excess"
            )
    # output row o holds source row perm[o]: its first min(count, R)
    # entries, in their stored order
    keep = np.minimum(counts[perm], R)
    out_row = np.repeat(np.arange(rows), keep)
    rank = np.arange(out_row.size) - np.repeat(np.cumsum(keep) - keep, keep)
    src = sp.indptr[perm][out_row] + rank
    cols = np.zeros((rows, R), dtype=np.int64)
    vals = np.zeros((rows, R), dtype=sp.data.dtype)
    valid = np.zeros((rows, R), dtype=bool)
    cols[out_row, rank] = sp.indices[src]
    vals[out_row, rank] = sp.data[src]
    valid[out_row, rank] = True
    dev = _dev(csr, device)
    ell = ELL(
        cols=torch.from_numpy(cols).to(dev, csr.indices.dtype),
        data=torch.from_numpy(vals).to(dev),
        valid=torch.from_numpy(valid).to(dev),
        shape=csr.shape,
        nnz=int(keep.sum()),
    )
    return ell, perm


def csr_to_blocked_ell(csr: CSR, block_shape=(8, 128),
                       max_blocks_per_row: int | None = None,
                       truncate: bool = False, device=None) -> BlockedELL:
    """CSR → BlockedELL without densifying the whole matrix: block occupancy
    is computed on the scipy structure, then only non-empty blocks are
    materialized.  Block-rows exceeding ``max_blocks_per_row`` raise unless
    ``truncate=True``."""
    import scipy.sparse as s

    dev = _dev(csr, device)
    sp = csr.to_scipy()
    rows, cols = sp.shape
    bm, bk = block_shape
    nbr = -(-rows // bm)
    nbc = -(-cols // bk)
    if rows % bm == 0 and cols % bk == 0:
        bsr = sp.tobsr(blocksize=(bm, bk))
    else:
        indptr = np.concatenate(
            [sp.indptr, np.full(nbr * bm - rows, sp.indptr[-1], sp.indptr.dtype)]
        )
        padded = s.csr_matrix((sp.data, sp.indices, indptr),
                              shape=(nbr * bm, nbc * bk))
        bsr = padded.tobsr(blocksize=(bm, bk))
    bsr.sort_indices()
    counts = np.diff(bsr.indptr)
    M = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if max_blocks_per_row is not None:
        M = int(max_blocks_per_row)
        if counts.size and int(counts.max()) > M and not truncate:
            raise ValueError(
                f"csr_to_blocked_ell: a block-row has {int(counts.max())} "
                f"blocks > max_blocks_per_row={M}; pass truncate=True to "
                "drop the excess"
            )
    block_cols = np.zeros((nbr, M), dtype=np.int64)
    blocks = np.zeros((nbr, M, bm, bk), dtype=sp.data.dtype)
    valid = np.zeros((nbr, M), dtype=bool)
    stored_nnz = 0
    for i in range(nbr):
        s_, e_ = bsr.indptr[i], bsr.indptr[i + 1]
        k = min(e_ - s_, M)
        block_cols[i, :k] = bsr.indices[s_ : s_ + k]
        blocks[i, :k] = bsr.data[s_ : s_ + k]
        valid[i, :k] = True
        stored_nnz += int((bsr.data[s_ : s_ + k] != 0).sum())
    return BlockedELL(
        block_cols=torch.from_numpy(block_cols).to(dev, csr.indices.dtype),
        blocks=torch.from_numpy(blocks).to(dev),
        valid=torch.from_numpy(valid).to(dev),
        shape=(rows, cols),
        nnz=stored_nnz,
        block_shape=(bm, bk),
    )


def csr_to_bsr(csr: CSR, block_shape=(8, 8), block_capacity: int | None = None,
               device=None) -> BSR:
    """CSR → BSR through scipy's ``tobsr`` (every block that holds a
    stored entry, explicit zeros included), without densifying."""
    import scipy.sparse as s

    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    bm, bn = block_shape
    nbr = -(-rows // bm)
    nbc = -(-cols // bn)
    indptr = np.concatenate(
        [sp.indptr, np.full(nbr * bm - rows, sp.indptr[-1], sp.indptr.dtype)])
    padded = s.csr_matrix((sp.data, sp.indices, indptr),
                          shape=(nbr * bm, nbc * bn))
    b = padded.tobsr(blocksize=(bm, bn))
    b.sort_indices()
    nblocks = int(b.indices.shape[0])
    cap = max(nblocks, 1) if block_capacity is None else int(block_capacity)
    indices = np.zeros((cap,), dtype=np.int64)
    indices[:nblocks] = b.indices
    blocks = np.zeros((cap, bm, bn), dtype=sp.data.dtype)
    blocks[:nblocks] = b.data
    brow = np.full((cap,), nbr, dtype=np.int64)
    brow[:nblocks] = np.repeat(np.arange(nbr), np.diff(b.indptr))
    dev = _dev(csr, device)
    return BSR(
        indptr=torch.from_numpy(b.indptr.astype(np.int64)).to(
            dev, default_index_dtype),
        indices=torch.from_numpy(indices).to(dev, default_index_dtype),
        data=torch.from_numpy(blocks).to(dev),
        block_row_ids=torch.from_numpy(brow).to(dev, default_index_dtype),
        shape=(rows, cols),
        nnz=csr.nnz,
        block_shape=(bm, bn),
        num_blocks=nblocks,
    )


def _nonzero_csr(mat, shape, capacity, dtype, device) -> CSR:
    """The CSR ``CSR.fromdense`` makes of ``mat``'s dense matrix: duplicates
    summed, zeros dropped, columns sorted; built without densifying."""
    m = mat.tocsr()[: shape[0], : shape[1]].tocsr()
    m.sum_duplicates()
    m.eliminate_zeros()
    m.sort_indices()
    out = CSR.from_arrays(m.indptr, m.indices, m.data, shape, capacity,
                          device=device)
    return out if out.dtype == dtype else out.astype(dtype)


def bsr_to_csr(bsr: BSR, capacity: int | None = None, device=None) -> CSR:
    import scipy.sparse as s

    bm, bn = bsr.block_shape
    nbr = bsr.num_block_rows
    nbc = -(-bsr.shape[1] // bn)
    # every slot scatters as ``BSR.todense`` does: a padding slot's
    # block-row nbr lies past the matrix and is cut away
    brow = bsr._block_row_ids_or_compute().long().cpu().numpy()
    order = np.argsort(brow, kind="stable")
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(brow, minlength=nbr + 1))])
    full = s.bsr_matrix(
        (host_values(bsr.data)[order], bsr.indices.cpu().numpy()[order],
         indptr), shape=((nbr + 1) * bm, nbc * bn))
    return _nonzero_csr(full, bsr.shape, capacity, bsr.data.dtype,
                        _dev(bsr, device))


def ell_to_csr(ell: ELL, capacity: int | None = None, device=None) -> CSR:
    import scipy.sparse as s

    rows, R = ell.cols.shape
    # every cell, padding included, scatters as ``ELL.todense`` does
    coo = s.coo_matrix(
        (host_values(ell.data).reshape(-1),
         (np.repeat(np.arange(rows), R), ell.cols.cpu().numpy().reshape(-1))),
        shape=ell.shape)
    return _nonzero_csr(coo, ell.shape, capacity, ell.data.dtype,
                        _dev(ell, device))
