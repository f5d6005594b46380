"""Dense container — the materialized matrix behind the densify path.

Twin of ``sparsematrix_tpu/formats/dense.py``: the materialization is
stored once at build time, so a product is one dense matrix product,
while the sparse-container interface (shape/nnz/todense) stays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import SparseFormat, sparse_container, static_field

__all__ = ["Dense"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class Dense(SparseFormat):
    data: torch.Tensor  # (rows, cols) materialized values
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    @classmethod
    def fromdense(cls, dense, dtype=None, device=None):
        """``dtype=torch.bfloat16`` stores the plane half-width."""
        dense = np.asarray(dense)
        arr = torch.as_tensor(dense).to(resolve_device(device))
        if dtype is not None:
            arr = arr.to(dtype)
        return cls(
            data=arr,
            shape=(int(dense.shape[0]), int(dense.shape[1])),
            nnz=int((dense != 0).sum()),
        )

    @classmethod
    def from_sparse(cls, sp, dtype=None):
        """Materialize any sparse container once (a build step), on the
        container's device."""
        arr = sp.todense()
        if dtype is not None:
            arr = arr.to(dtype)
        return cls(data=arr, shape=sp.shape, nnz=sp.nnz)

    def todense(self) -> torch.Tensor:
        return self.data

    def transpose(self) -> "Dense":
        return Dense(data=self.data.T, shape=(self.shape[1], self.shape[0]),
                     nnz=self.nnz)

    @property
    def T(self) -> "Dense":
        return self.transpose()

    @property
    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])
