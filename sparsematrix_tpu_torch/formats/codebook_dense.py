"""CodebookDense — dense uint8 index plane + value table.

Twin of ``sparsematrix_tpu/formats/codebook_dense.py``.  At the
reference's benchmark density (25 %) the quantized matrix is best kept as
a dense uint8 index plane (1 byte per element, a quarter of fp32) whose
dequantization ``table[idx]`` is a 256-entry lookup; on the card the
lookup runs inside the product kernel (``kernels/codebook.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import SparseFormat, sparse_container, static_field

__all__ = ["CodebookDense"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class CodebookDense(SparseFormat):
    idx: torch.Tensor  # (rows, cols) uint8 — table_size means zero
    val_table: torch.Tensor  # (table_size+1,) with sentinel 0 appended
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()
    table_size: int = static_field()

    @classmethod
    def from_index_matrix(cls, index_matrix, val_table, trans: bool = False,
                          device=None):
        """Same encode semantics as CodebookCSR.from_index_matrix
        (CopyForm, sparse-matrix.cc:21-99): entries outside
        [0, table_size) denote zero and are remapped to the sentinel."""
        dev = resolve_device(device)
        idx = np.asarray(index_matrix)
        table = np.asarray(val_table)
        ts = int(table.shape[0])
        if ts < 1 or ts > 255:
            raise ValueError("val_table size must be in [1, 255]")
        if trans:
            idx = idx.T
        valid = (idx >= 0) & (idx < ts)
        idx_u8 = np.ascontiguousarray(np.where(valid, idx, ts).astype(np.uint8))
        table_ext = np.concatenate([table, np.zeros((1,), dtype=table.dtype)])
        return cls(
            idx=torch.from_numpy(idx_u8).to(dev),
            val_table=torch.from_numpy(table_ext).to(dev),
            shape=(int(idx.shape[0]), int(idx.shape[1])),
            nnz=int(valid.sum()),
            table_size=ts,
        )

    def todense(self) -> torch.Tensor:
        # 256-entry lookup, no scatter
        return self.val_table[self.idx.long()]

    def transpose(self) -> "CodebookDense":
        # a build-time copy: the kernel reads a row-major index plane
        return dataclasses.replace(
            self, idx=self.idx.T.contiguous(),
            shape=(self.shape[1], self.shape[0]))

    @property
    def T(self) -> "CodebookDense":
        return self.transpose()
