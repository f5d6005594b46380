"""Containers built from a JAX container's fields.

The port's containers have the JAX containers' field names, so weights
built by the JAX package carry across field by field: take each array
field with ``np.asarray`` and each static field as it is, and hand both
here.  Nothing of the JAX package is imported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import resolve_device
from .codebook import CodebookCSR
from .codebook_dense import CodebookDense
from .csr import CSR
from .dense import Dense
from .ell import BlockedELL

__all__ = ["from_numpy_fields", "KINDS"]

KINDS = {cls.__name__: cls
         for cls in (CodebookDense, CodebookCSR, CSR, Dense, BlockedELL)}


def from_numpy_fields(kind: str, fields: Dict[str, np.ndarray],
                      static: Dict[str, object], device=None):
    """The port's ``kind`` container (a class name in ``KINDS``) holding
    ``fields`` as tensors on ``device`` and ``static`` as its static
    fields.  Field names must match the container's exactly; an array
    field may be ``None`` where the container allows it (``row_ids``)."""
    cls = KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown container kind {kind!r}; "
                         f"expected one of {sorted(KINDS)}")
    if set(fields) != set(cls._data_fields):
        raise ValueError(f"{kind}: array fields {sorted(fields)} differ from "
                         f"{sorted(cls._data_fields)}")
    if set(static) != set(cls._static_fields):
        raise ValueError(f"{kind}: static fields {sorted(static)} differ from "
                         f"{sorted(cls._static_fields)}")
    dev = resolve_device(device)
    # np.array copies: an array taken from a JAX container is read-only
    tensors = {
        name: None if arr is None else torch.from_numpy(np.array(arr)).to(dev)
        for name, arr in fields.items()
    }
    statics = {name: tuple(int(v) for v in val) if isinstance(val, (tuple, list))
               else int(val) for name, val in static.items()}
    return cls(**tensors, **statics)
