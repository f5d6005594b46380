"""QuantDense — int8 per-row-quantized dense container for the densify
regime.

Twin of ``sparsematrix_tpu/formats/quantdense.py``.  1 byte an element
instead of 4 (fp32) or 2 (bf16) for the materialized A plane, the same
trade the reference makes with its 255-entry codebook quantization,
generalized to arbitrary values via per-row scales.  Symmetric per-row
quantization gives |ΔA|/|A| ≤ 1/254 per element.

Multiply path (``ops/spmm.py``): X is quantized per column at call time,
the contraction runs int8·int8→int32 (``torch._int_mm`` on the card,
``ops/quantized.py``), and the result is rescaled by the rank-1 outer
product of the two scale vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import SparseFormat, sparse_container, static_field

__all__ = ["QuantDense"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class QuantDense(SparseFormat):
    data: torch.Tensor  # (rows, cols) int8 quantized values
    scale: torch.Tensor  # (rows,) fp32 per-row dequant scale
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    @classmethod
    def fromdense(cls, dense, device=None):
        """Quantize a dense matrix (numpy, or a tensor) on the host; the
        planes go to ``device``."""
        if isinstance(dense, torch.Tensor):
            dense = dense.detach().float().cpu().numpy()
        dense = np.asarray(dense, np.float32)
        rowmax = np.abs(dense).max(axis=1)
        scale = np.where(rowmax > 0, rowmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(dense / scale[:, None]), -127, 127).astype(np.int8)
        dev = resolve_device(device)
        return cls(
            data=torch.from_numpy(q).to(dev),
            scale=torch.from_numpy(scale).to(dev),
            shape=(int(dense.shape[0]), int(dense.shape[1])),
            nnz=int((dense != 0).sum()),
        )

    @classmethod
    def from_sparse(cls, sp):
        """Quantize any sparse container once (build step), on the
        container's device."""
        return cls.fromdense(sp.todense(), device=sp.device)

    def todense(self) -> torch.Tensor:
        return self.data.float() * self.scale[:, None]

    @property
    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])
