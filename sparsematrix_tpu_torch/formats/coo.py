"""COO (coordinate) sparse format.

Twin of ``sparsematrix_tpu/formats/coo.py``.  The arrays are padded to a
``capacity``; padding entries carry ``row = col = 0`` and ``data = 0``, so
they are harmless under accumulation (the reference's sentinel-zero
filler, sparse-matrix.cc:46-51).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import (SparseFormat, default_index_dtype, host_values, pad_to,
                   sparse_container, static_field)

__all__ = ["COO"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class COO(SparseFormat):
    row: torch.Tensor  # (capacity,) int32
    col: torch.Tensor  # (capacity,) int32
    data: torch.Tensor  # (capacity,) values
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    # -- construction ---------------------------------------------------
    @classmethod
    def fromdense(cls, dense, capacity: int | None = None,
                  index_dtype=default_index_dtype, device=None):
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError("COO.fromdense expects a 2-D array")
        r, c = np.nonzero(dense)
        order = np.lexsort((c, r))  # row-major order
        r, c = r[order], c[order]
        return cls.from_arrays(r, c, dense[r, c], dense.shape, capacity,
                               index_dtype, device=device)

    @classmethod
    def from_arrays(cls, row, col, data, shape, capacity: int | None = None,
                    index_dtype=default_index_dtype, device=None):
        dev = resolve_device(device)
        row = np.asarray(row)
        col = np.asarray(col)
        data = np.asarray(data)
        nnz = int(row.shape[0])
        if capacity is None:
            capacity = nnz
        return cls(
            row=pad_to(torch.as_tensor(row).to(dev, index_dtype), capacity, 0),
            col=pad_to(torch.as_tensor(col).to(dev, index_dtype), capacity, 0),
            data=pad_to(torch.as_tensor(data).to(dev), capacity, 0),
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
        )

    @classmethod
    def from_scipy(cls, mat, capacity: int | None = None, device=None):
        coo = mat.tocoo()
        order = np.lexsort((coo.col, coo.row))
        return cls.from_arrays(coo.row[order], coo.col[order],
                               coo.data[order], coo.shape, capacity,
                               device=device)

    # -- decode ---------------------------------------------------------
    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        # scatter-add: padding entries are (0, 0) with value 0
        return out.index_put_((self.row.long(), self.col.long()), self.data,
                               accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.nnz
        return sp.coo_matrix(
            (host_values(self.data[:n]),
             (self.row[:n].cpu().numpy(), self.col[:n].cpu().numpy())),
            shape=self.shape)

    def transpose(self) -> "COO":
        """Logical transpose; entries re-sorted to row-major on the host."""
        n = self.nnz
        r = self.col[:n].cpu().numpy()
        c = self.row[:n].cpu().numpy()
        d = self.data[:n].cpu().numpy()
        order = np.lexsort((c, r))
        return COO.from_arrays(r[order], c[order], d[order],
                               (self.shape[1], self.shape[0]), self.capacity,
                               device=self.device)

    @property
    def T(self) -> "COO":
        return self.transpose()
