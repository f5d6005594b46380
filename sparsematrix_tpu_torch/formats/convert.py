"""Format conversions.

Twin of ``sparsematrix_tpu/formats/convert.py`` (``csr_to_blocked_ell``
only).  Conversions are host-side build-time operations (the reference's
encode-once / multiply-many design, ``CopyForm``, sparse-matrix.cc:21-99):
they go through scipy or numpy and return containers on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .csr import CSR
from .ell import BlockedELL

__all__ = ["csr_to_blocked_ell"]


def csr_to_blocked_ell(csr: CSR, block_shape=(8, 128),
                       max_blocks_per_row: int | None = None,
                       truncate: bool = False, device=None) -> BlockedELL:
    """CSR → BlockedELL without densifying the whole matrix: block occupancy
    is computed on the scipy structure, then only non-empty blocks are
    materialized.  Block-rows exceeding ``max_blocks_per_row`` raise unless
    ``truncate=True``."""
    import scipy.sparse as s

    dev = resolve_device(device)
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
