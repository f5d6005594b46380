"""Codebook-quantized sparse format — the reference's core format.

Twin of ``sparsematrix_tpu/formats/codebook.py`` (``CodebookCSR`` only).
The reference stores a weight matrix as codebook indices into a ≤255-entry
float table plus an appended sentinel ``val_table[size] = 0``
(sparse-matrix.cc:29-31,46-51).  ``CodebookCSR`` is a CSR structure whose
per-entry payload is an index into ``val_table``; padding entries point at
the sentinel and contribute 0.  The delta-stream wire codec of the JAX
package is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import (SparseFormat, default_index_dtype, sparse_container,
                   static_field)
from .csr import CSR, _expand_rowids

__all__ = ["CodebookCSR"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class CodebookCSR(SparseFormat):
    indptr: torch.Tensor  # (rows+1,) int32
    indices: torch.Tensor  # (capacity,) int32 column ids
    val_idx: torch.Tensor  # (capacity,) int32 ∈ [0, table_size]; table_size = sentinel
    val_table: torch.Tensor  # (table_size+1,) values, sentinel 0 appended
    row_ids: Optional[torch.Tensor]  # (capacity,) int32
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()
    table_size: int = static_field()

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def data(self) -> torch.Tensor:
        """Dequantized per-entry values (lookup in the codebook)."""
        return self.val_table[self.val_idx.long()]

    # -- construction ---------------------------------------------------
    @classmethod
    def from_index_matrix(cls, index_matrix, val_table, trans: bool = False,
                          capacity: int | None = None,
                          index_dtype=default_index_dtype, device=None):
        """Encode from a dense matrix of codebook indices.

        Mirrors ``CopyForm`` semantics (sparse-matrix.cc:21-99): an entry
        ``v`` denotes value ``val_table[v]`` iff ``0 <= v < len(val_table)``,
        otherwise the entry is zero (not stored).  ``trans=True`` encodes the
        transpose at build time (the ``SblasTrans`` path,
        sparse-matrix.cc:65-98).
        """
        dev = resolve_device(device)
        idx = np.asarray(index_matrix)
        table = np.asarray(val_table)
        ts = int(table.shape[0])
        if ts < 1 or ts > 255:
            raise ValueError("val_table size must be in [1, 255]")
        if trans:
            idx = idx.T
        rows, cols = idx.shape
        mask = (idx >= 0) & (idx < ts)
        r, c = np.nonzero(mask)
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
        vi = idx[r, c].astype(np.int64)
        nnz = int(r.shape[0])
        cap = max(nnz, 1) if capacity is None else int(capacity)
        indptr = np.zeros(rows + 1, dtype=np.int64)
        np.add.at(indptr[1:], r, 1)
        indptr = np.cumsum(indptr)
        indices = np.zeros((cap,), dtype=np.int64)
        indices[:nnz] = c
        val_idx = np.full((cap,), ts, dtype=np.int64)  # padding → sentinel
        val_idx[:nnz] = vi
        table_ext = np.concatenate([table, np.zeros((1,), dtype=table.dtype)])

        def put(a):
            return torch.from_numpy(a).to(dev, index_dtype)

        return cls(
            indptr=put(indptr),
            indices=put(indices),
            val_idx=put(val_idx),
            val_table=torch.from_numpy(table_ext).to(dev),
            row_ids=put(_expand_rowids(indptr, cap, rows)),
            shape=(rows, cols),
            nnz=nnz,
            table_size=ts,
        )

    # -- decode ---------------------------------------------------------
    def to_csr(self) -> CSR:
        return CSR(
            indptr=self.indptr,
            indices=self.indices,
            data=self.data,
            row_ids=self.row_ids,
            shape=self.shape,
            nnz=self.nnz,
        )

    def todense(self) -> torch.Tensor:
        return self.to_csr().todense()

    def transpose(self) -> "CodebookCSR":
        """Host-side transpose preserving quantization."""
        import scipy.sparse as sp

        r = self.row_ids[: self.nnz].cpu().numpy()
        c = self.indices[: self.nnz].cpu().numpy()
        vi = self.val_idx[: self.nnz].cpu().numpy()
        # transpose the *index* matrix, then re-encode
        m = sp.coo_matrix((vi + 1, (c, r)),
                          shape=(self.shape[1], self.shape[0])).toarray()
        idx_mtx = np.where(m > 0, m - 1, self.table_size)  # table_size = "zero"
        return CodebookCSR.from_index_matrix(
            idx_mtx, self.val_table[: self.table_size].cpu().numpy(),
            capacity=self.capacity, device=self.device,
        )

    @property
    def T(self) -> "CodebookCSR":
        return self.transpose()
