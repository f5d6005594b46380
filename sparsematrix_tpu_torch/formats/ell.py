"""ELL and Blocked-ELL formats.

Twin of ``sparsematrix_tpu/formats/ell.py``.  ``ELL``: every row padded to
a fixed entry count R, as dense (rows, R) index and value planes.
``BlockedELL``: the matrix is tiled into (bm × bk) dense blocks; each
block-row stores a fixed number of blocks, so SpMM is a sum of dense
(bm × bk) @ (bk × n) products indexed by ``block_cols``.  Padding entries
and slots reference (block-)column 0 with zero values and contribute
exactly 0 to every product (sparse-matrix.cc:29-31).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import (SparseFormat, default_index_dtype, sparse_container,
                   static_field)

__all__ = ["ELL", "BlockedELL"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class ELL(SparseFormat):
    cols: torch.Tensor  # (rows, R) int32
    data: torch.Tensor  # (rows, R)
    valid: torch.Tensor  # (rows, R) bool, True for stored entries
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    @property
    def row_capacity(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def fromdense(cls, dense, row_capacity: int | None = None,
                  index_dtype=default_index_dtype, truncate: bool = False,
                  device=None):
        """Rows with more than ``row_capacity`` entries raise unless
        ``truncate=True``; a truncated ELL's ``nnz`` counts the entries it
        stores."""
        dev = resolve_device(device)
        dense = np.asarray(dense)
        rows, _ = dense.shape
        counts = (dense != 0).sum(axis=1)
        R = int(counts.max()) if row_capacity is None else int(row_capacity)
        R = max(R, 1)
        if counts.size and int(counts.max()) > R and not truncate:
            raise ValueError(
                f"ELL.fromdense: a row has {int(counts.max())} entries > "
                f"row_capacity={R}; pass truncate=True to drop the excess"
            )
        cols = np.zeros((rows, R), dtype=np.int64)
        vals = np.zeros((rows, R), dtype=dense.dtype)
        valid = np.zeros((rows, R), dtype=bool)
        # the stored entries of each row, in column order, by their rank
        r, c = np.nonzero(dense)
        rank = np.arange(r.size) - np.repeat(np.cumsum(counts) - counts, counts)
        keep = rank < R
        r, c, rank = r[keep], c[keep], rank[keep]
        cols[r, rank] = c
        vals[r, rank] = dense[r, c]
        valid[r, rank] = True
        return cls(
            cols=torch.from_numpy(cols).to(dev, index_dtype),
            data=torch.from_numpy(vals).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            shape=(int(rows), int(dense.shape[1])),
            nnz=int(np.minimum(counts, R).sum()),
        )

    def todense(self) -> torch.Tensor:
        rows, R = self.cols.shape
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        rid = torch.arange(rows, device=self.cols.device)[:, None].expand(rows, R)
        # zero padding values make the duplicate (row, 0) scatters harmless
        return out.index_put_((rid.reshape(-1), self.cols.reshape(-1).long()),
                              self.data.reshape(-1), accumulate=True)


@sparse_container
@dataclasses.dataclass(frozen=True)
class BlockedELL(SparseFormat):
    block_cols: torch.Tensor  # (nbr, max_blocks) int32 — block-column ids
    blocks: torch.Tensor  # (nbr, max_blocks, bm, bk) values
    valid: torch.Tensor  # (nbr, max_blocks) bool
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()  # scalar nnz pre-blocking
    block_shape: Tuple[int, int] = static_field()

    @classmethod
    def fromdense(cls, dense, block_shape: Tuple[int, int] = (8, 128),
                  max_blocks_per_row: int | None = None,
                  index_dtype=default_index_dtype, truncate: bool = False,
                  device=None):
        dev = resolve_device(device)
        dense = np.asarray(dense)
        rows, cols = dense.shape
        bm, bk = block_shape
        nbr = -(-rows // bm)
        nbc = -(-cols // bk)
        padded = np.zeros((nbr * bm, nbc * bk), dtype=dense.dtype)
        padded[:rows, :cols] = dense
        # (nbr, nbc, bm, bk) view
        tiles = padded.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
        nonempty = np.abs(tiles).sum(axis=(2, 3)) != 0  # (nbr, nbc)
        per_row = nonempty.sum(axis=1)
        M = int(per_row.max()) if per_row.size else 0
        if max_blocks_per_row is not None:
            M = int(max_blocks_per_row)
        M = max(M, 1)
        if per_row.size and int(per_row.max()) > M and not truncate:
            raise ValueError(
                f"BlockedELL.fromdense: a block-row has {int(per_row.max())} "
                f"blocks > max_blocks_per_row={M}; pass truncate=True to "
                "drop the excess"
            )
        block_cols = np.zeros((nbr, M), dtype=np.int64)
        blocks = np.zeros((nbr, M, bm, bk), dtype=dense.dtype)
        valid = np.zeros((nbr, M), dtype=bool)
        stored_nnz = 0
        for i in range(nbr):
            (bcids,) = np.nonzero(nonempty[i])
            bcids = bcids[:M]
            block_cols[i, : len(bcids)] = bcids
            blocks[i, : len(bcids)] = tiles[i, bcids]
            valid[i, : len(bcids)] = True
            stored_nnz += int((tiles[i, bcids] != 0).sum())
        return cls(
            block_cols=torch.from_numpy(block_cols).to(dev, index_dtype),
            blocks=torch.from_numpy(blocks).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            shape=(int(rows), int(cols)),
            nnz=stored_nnz,
            block_shape=(int(bm), int(bk)),
        )

    def todense(self) -> torch.Tensor:
        nbr, M = self.block_cols.shape
        bm, bk = self.block_shape
        nbc = -(-self.shape[1] // bk)
        out = torch.zeros((nbr, nbc, bm, bk), dtype=self.blocks.dtype,
                          device=self.blocks.device)
        brow = torch.arange(nbr, device=self.blocks.device)[:, None].expand(nbr, M)
        # mask padded blocks to zero before scattering (a padded slot may
        # collide with a real block at block-col 0)
        contrib = torch.where(self.valid[:, :, None, None], self.blocks,
                              torch.zeros((), dtype=self.blocks.dtype,
                                          device=self.blocks.device))
        out.index_put_((brow.reshape(-1), self.block_cols.reshape(-1).long()),
                       contrib.reshape(-1, bm, bk), accumulate=True)
        dense = out.permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bk)
        return dense[: self.shape[0], : self.shape[1]]
