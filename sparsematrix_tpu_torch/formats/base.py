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
import weakref
from typing import ClassVar, Tuple

import numpy as np
import torch

__all__ = ["SparseFormat", "sparse_container", "pad_to", "default_index_dtype",
           "host_values", "cached_on"]

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


def host_values(t: torch.Tensor) -> np.ndarray:
    """A value tensor as a host numpy array; bf16 goes through fp32, which
    holds it exactly (numpy and scipy have no bf16)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def cached_on(cache: dict, A, build):
    """``build(A)``, computed once per container: keyed by identity (a
    container holds unhashable tensors), the entry leaves with ``A``."""
    key = id(A)
    entry = cache.get(key)
    if entry is not None and entry[0]() is A:
        return entry[1]
    value = build(A)
    ref = weakref.ref(A, lambda _unused, k=key: cache.pop(k, None))
    cache[key] = (ref, value)
    return value


def sparse_container(cls):
    """Record which dataclass fields are tensors and which are static.  A
    ``SparseFormat`` keeps the base's short ``__repr__`` (its static
    fields), where the dataclass would print every tensor."""
    fields = dataclasses.fields(cls)
    cls._data_fields = tuple(f.name for f in fields
                             if not f.metadata.get("static", False))
    cls._static_fields = tuple(f.name for f in fields
                               if f.metadata.get("static", False))
    if issubclass(cls, SparseFormat):
        cls.__repr__ = SparseFormat.__repr__
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

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def ndim(self) -> int:
        return 2

    def todense(self) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return getattr(self, self._data_fields[0]).device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def astype(self, dtype):
        return dataclasses.replace(self, data=self.data.to(dtype))

    def block_until_ready(self):
        """Waits for the card's work on this container's device (nothing
        to wait for on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def allclose(self, other, rtol=0.0, atol=0.0) -> bool:
        """The reference's ``operator==`` (sparse-matrix.cc:198-207): the
        same logical matrix, compared by densified values on the host."""
        if self.shape != other.shape:
            return False
        a = self.todense().cpu().numpy()
        b = other.todense().cpu().numpy()
        return bool(np.allclose(a, b, rtol=rtol, atol=atol))

    def __repr__(self):
        statics = {n: getattr(self, n) for n in self._static_fields}
        return f"{type(self).__name__}({statics})"
