"""BSR (block compressed sparse row) format.

Twin of ``sparsematrix_tpu/formats/bsr.py``: block-CSR with dense
(bm × bn) blocks, so a product is a dense block product per stored block,
indexed by the block-CSR structure.  The block arrays are padded to a
``block_capacity``; a padding slot has ``block_row_ids == nbr`` (a
block-row every product drops), block-column 0 and a zero block, and
contributes nothing (the reference's sentinel-zero trick,
sparse-matrix.cc:29-31).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import (SparseFormat, default_index_dtype, host_values,
                   sparse_container, static_field)

__all__ = ["BSR"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class BSR(SparseFormat):
    indptr: torch.Tensor  # (nbr+1,) int32
    indices: torch.Tensor  # (block_capacity,) int32 block-column ids
    data: torch.Tensor  # (block_capacity, bm, bn)
    block_row_ids: Optional[torch.Tensor]  # (block_capacity,) int32
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()  # scalar nonzeros
    block_shape: Tuple[int, int] = static_field()
    num_blocks: int = static_field()

    @property
    def block_capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def num_block_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @classmethod
    def fromdense(cls, dense, block_shape: Tuple[int, int] = (8, 8),
                  block_capacity: int | None = None,
                  index_dtype=default_index_dtype, device=None):
        """Every (bm × bn) tile with a nonzero is stored, block-row by
        block-row, block-columns ascending."""
        dev = resolve_device(device)
        dense = np.asarray(dense)
        rows, cols = dense.shape
        bm, bn = block_shape
        nbr = -(-rows // bm)
        nbc = -(-cols // bn)
        padded = np.zeros((nbr * bm, nbc * bn), dtype=dense.dtype)
        padded[:rows, :cols] = dense
        tiles = padded.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
        nonempty = np.abs(tiles).sum(axis=(2, 3)) != 0  # (nbr, nbc)
        indptr = np.zeros(nbr + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(nonempty.sum(axis=1))
        nblocks = int(indptr[-1])
        cap = max(nblocks, 1) if block_capacity is None else int(block_capacity)
        # np.nonzero walks (block-row, block-column) in row-major order
        bi, bj = np.nonzero(nonempty)
        indices = np.zeros((cap,), dtype=np.int64)
        indices[:nblocks] = bj
        blocks = np.zeros((cap, bm, bn), dtype=dense.dtype)
        blocks[:nblocks] = tiles[bi, bj]
        brow = np.full((cap,), nbr, dtype=np.int64)
        brow[:nblocks] = bi
        return cls(
            indptr=torch.from_numpy(indptr).to(dev, index_dtype),
            indices=torch.from_numpy(indices).to(dev, index_dtype),
            data=torch.from_numpy(blocks).to(dev),
            block_row_ids=torch.from_numpy(brow).to(dev, index_dtype),
            shape=(int(rows), int(cols)),
            nnz=int((dense != 0).sum()),
            block_shape=(int(bm), int(bn)),
            num_blocks=nblocks,
        )

    @classmethod
    def from_scipy(cls, mat, block_shape=(8, 8), **kw):
        """Through the dense matrix, as the JAX package builds it
        (``formats.csr_to_bsr`` builds a BSR without densifying)."""
        return cls.fromdense(np.asarray(mat.todense()),
                             block_shape=block_shape, **kw)

    def _block_row_ids_or_compute(self) -> torch.Tensor:
        if self.block_row_ids is not None:
            return self.block_row_ids
        # padding slots land in block-row nbr, which products drop
        pos = torch.arange(self.block_capacity, dtype=self.indptr.dtype,
                           device=self.indptr.device)
        return (torch.searchsorted(self.indptr, pos, right=True) - 1).to(
            self.indptr.dtype)

    def todense(self) -> torch.Tensor:
        bm, bn = self.block_shape
        nbr = self.num_block_rows
        nbc = -(-self.shape[1] // bn)
        # one spare block-row takes the padding slots and is cut away
        out = torch.zeros((nbr + 1, nbc, bm, bn), dtype=self.data.dtype,
                          device=self.data.device)
        brow = self._block_row_ids_or_compute().long()
        out.index_put_((brow, self.indices.long()), self.data, accumulate=True)
        dense = out[:nbr].permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bn)
        return dense[: self.shape[0], : self.shape[1]]

    def to_scipy(self):
        """A ``scipy.sparse`` CSR matrix of the stored blocks (scipy slices
        no BSR matrix, so the ragged edge is cut from its CSR)."""
        import scipy.sparse as sp

        bm, bn = self.block_shape
        nb = self.num_blocks
        return sp.bsr_matrix(
            (
                host_values(self.data[:nb]),
                self.indices[:nb].cpu().numpy(),
                self.indptr.cpu().numpy(),
            ),
            shape=(self.num_block_rows * bm, (-(-self.shape[1] // bn)) * bn),
        ).tocsr()[: self.shape[0], : self.shape[1]]
