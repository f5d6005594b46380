"""CSR (compressed sparse row) format.

Twin of ``sparsematrix_tpu/formats/csr.py``.  ``indptr`` has length
``rows + 1``; ``indices``/``data`` are padded to a capacity with in-range
column 0 and value 0 (harmless padding, the reference's sentinel-zero
entries, sparse-matrix.cc:29-31).  ``row_ids`` is the expanded per-entry
row index; padding entries get ``rows``, a row that every product drops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import (SparseFormat, default_index_dtype, pad_to, sparse_container,
                   static_field)

__all__ = ["CSR", "CSC"]


def _expand_rowids(indptr: np.ndarray, capacity: int, rows: int) -> np.ndarray:
    """Per-entry row id; padding entries get ``rows`` (dropped by products)."""
    counts = np.diff(indptr)
    ids = np.repeat(np.arange(rows, dtype=np.int64), counts)
    out = np.full((capacity,), rows, dtype=np.int64)
    out[: ids.shape[0]] = ids
    return out


@sparse_container
@dataclasses.dataclass(frozen=True)
class CSR(SparseFormat):
    indptr: torch.Tensor  # (rows+1,) int32
    indices: torch.Tensor  # (capacity,) int32 column ids
    data: torch.Tensor  # (capacity,)
    row_ids: Optional[torch.Tensor]  # (capacity,) int32 or None
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    # -- construction ---------------------------------------------------
    @classmethod
    def from_arrays(cls, indptr, indices, data, shape, capacity: int | None = None,
                    index_dtype=default_index_dtype, with_row_ids: bool = True,
                    device=None):
        dev = resolve_device(device)
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        data = np.asarray(data)
        nnz = int(indptr[-1])
        if capacity is None:
            capacity = max(nnz, 1)
        rows = int(shape[0])
        row_ids = None
        if with_row_ids:
            row_ids = torch.as_tensor(
                _expand_rowids(indptr, capacity, rows)).to(dev, index_dtype)
        return cls(
            indptr=torch.as_tensor(indptr).to(dev, index_dtype),
            indices=pad_to(torch.as_tensor(indices).to(dev, index_dtype),
                           capacity, 0),
            data=pad_to(torch.as_tensor(data).to(dev), capacity, 0),
            row_ids=row_ids,
            shape=(rows, int(shape[1])),
            nnz=nnz,
        )

    @classmethod
    def fromdense(cls, dense, capacity: int | None = None, device=None, **kw):
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError("CSR.fromdense expects a 2-D array")
        rows, _ = dense.shape
        r, c = np.nonzero(dense)
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
        vals = dense[r, c]
        indptr = np.zeros(rows + 1, dtype=np.int64)
        np.add.at(indptr[1:], r, 1)
        indptr = np.cumsum(indptr)
        return cls.from_arrays(indptr, c, vals, dense.shape, capacity,
                               device=device, **kw)

    @classmethod
    def from_scipy(cls, mat, capacity: int | None = None, device=None, **kw):
        """From a ``scipy.sparse`` matrix (indices sorted per row).  The
        host copy is kept, so ``to_scipy`` and the packers read it instead
        of copying the tensors back."""
        csr = mat.tocsr()
        csr.sort_indices()
        out = cls.from_arrays(csr.indptr, csr.indices, csr.data, csr.shape,
                              capacity, device=device, **kw)
        object.__setattr__(out, "_host_scipy", csr)
        return out

    # -- decode ---------------------------------------------------------
    def _row_ids_or_compute(self) -> torch.Tensor:
        if self.row_ids is not None:
            return self.row_ids
        # padding entries land in row `rows`, which todense/spmm drop
        pos = torch.arange(self.capacity, dtype=self.indptr.dtype,
                           device=self.indptr.device)
        return (torch.searchsorted(self.indptr, pos, right=True) - 1).to(
            self.indptr.dtype)

    def todense(self) -> torch.Tensor:
        rows, cols = self.shape
        rid = self._row_ids_or_compute().long()
        # one spare row takes the padding entries and is cut away
        out = torch.zeros((rows + 1, cols), dtype=self.data.dtype,
                          device=self.data.device)
        out.index_put_((rid, self.indices.long()), self.data, accumulate=True)
        return out[:rows]

    def to_scipy(self):
        """Host copy as a ``scipy.sparse.csr_matrix`` (build-time use),
        made once per container and kept."""
        import scipy.sparse as sp

        cached = getattr(self, "_host_scipy", None)
        if cached is not None:
            return cached
        out = sp.csr_matrix(
            (
                self.data[: self.nnz].cpu().numpy(),
                self.indices[: self.nnz].cpu().numpy(),
                self.indptr.cpu().numpy(),
            ),
            shape=self.shape,
        )
        object.__setattr__(self, "_host_scipy", out)
        return out

    def transpose(self) -> "CSR":
        """Host-side transpose (a build-time step, like the reference's
        ``SblasTrans`` encode-time transpose, sparse-matrix.cc:65-98)."""
        return CSR.from_scipy(self.to_scipy().T.tocsr(), capacity=self.capacity,
                              device=self.device)

    @property
    def T(self) -> "CSR":
        return self.transpose()


class CSC:
    """CSC is the CSR of the transpose: ``CSC.fromdense(a)`` returns the
    ``CSR`` of ``a.T`` (every kernel reads CSR-like layouts)."""

    @staticmethod
    def fromdense(dense, **kw) -> CSR:
        return CSR.fromdense(np.asarray(dense).T, **kw)
