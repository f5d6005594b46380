"""Base class for sparse-format containers.

Twin of ``sparsematrix_tpu/formats/base.py``.  Every container is a frozen
dataclass of torch tensors with the JAX container's field names.  Fields
whose metadata holds ``static=True`` are plain Python values (shape, nnz,
block sizes); the others are tensors.  Padding entries are harmless under
accumulation (zero value, in-range index), the sentinel-zero trick of the
reference (sparse-matrix.cc:29-31).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import torch

__all__ = ["SparseFormat", "sparse_container", "pad_to", "default_index_dtype"]

default_index_dtype = torch.int32


def pad_to(arr: torch.Tensor, capacity: int, fill, axis: int = 0) -> torch.Tensor:
    """Pad ``arr`` along ``axis`` to length ``capacity`` with ``fill``."""
    cur = arr.shape[axis]
    if cur > capacity:
        raise ValueError(f"array length {cur} exceeds capacity {capacity}")
    if cur == capacity:
        return arr
    shape = list(arr.shape)
    shape[axis] = capacity - cur
    pad = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=axis)


def sparse_container(cls):
    """Record which dataclass fields are tensors and which are static."""
    fields = dataclasses.fields(cls)
    cls._data_fields = tuple(f.name for f in fields
                             if not f.metadata.get("static", False))
    cls._static_fields = tuple(f.name for f in fields
                               if f.metadata.get("static", False))
    return cls


def static_field():
    return dataclasses.field(metadata={"static": True})


class SparseFormat:
    """Mixin with common sparse-container behaviour.

    All containers provide ``shape`` (logical rows, cols), ``nnz`` (logical
    number of stored entries) and ``todense()`` (the ``CopyTo`` analogue,
    sparse-matrix.cc:102-137).
    """

    _data_fields: ClassVar[Tuple[str, ...]]
    _static_fields: ClassVar[Tuple[str, ...]]

    def todense(self) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return getattr(self, self._data_fields[0]).device
