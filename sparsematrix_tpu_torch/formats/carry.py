"""Containers built from a JAX container's fields.

The port's containers have the JAX containers' field names, so weights and
packs built by the JAX package carry across field by field: take each
array field with ``np.asarray`` and each static field as it is, and hand
both here.  A nested container (a ``DualGather``'s ``t_pack`` or
``tail``, an ``Octet``'s ``rem``, a ``SkewSpmv``'s ``base``, a legacy
``SellRowLane``'s ``SellSpmv`` ``spill_packed``) is carried first and
passed as it is; an optional field may be ``None``; a tuple of arrays (a
``ClosPermutePlan``'s plane triples) is carried element by element.
Triangular-solve plans carry the same way: a ``TriWavesPlan``'s or
``TriFusedPlan``'s ``t_plan`` and a ``TriFixPlan``'s ``e_packed`` (a
``SellRowLane``) first; a string static (``mode``) stays a string.  A
``BSR`` whose ``block_row_ids`` is None carries as None.  bf16 arrays
(numpy's ``bfloat16`` extension type) become ``torch.bfloat16`` tensors
bit for bit.  A ``QuantDense`` and a ``QuantizedCodebookDense`` carry
their int8 planes and fp32 scales as they are (a 0-d ``scale`` stays
0-d).  Nothing of the JAX package is imported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import resolve_device
from .bsr import BSR
from .codebook import CodebookCSR
from .codebook_dense import CodebookDense
from .coo import COO
from .csr import CSR
from .dense import Dense
from .ell import ELL, BlockedELL
from .quantdense import QuantDense
from .stripdense import StripDense

__all__ = ["from_numpy_fields", "kinds"]


def kinds() -> dict:
    """Container classes by name.  The packed layouts live in
    ``kernels/``, which imports this package, so they are looked up when
    called."""
    from ..kernels.bsr import BSRPanels
    from ..kernels.spmv_dualgather import DualGather, PooledDG
    from ..kernels.spmv_octet import Octet
    from ..kernels.spmv_rowlane import SellRowLane
    from ..kernels.spmv_sell import SellRowPure, SellSpmv
    from ..kernels.spmv_superblock import SellSuperblock
    from ..ops.permute import PermutePlan
    from ..ops.permute_clos import ClosPermutePlan
    from ..ops.skew import SkewSpmv
    from ..kernels.trisolve_fused import TriFusedPlan
    from ..kernels.trisolve_waves import TriWavesPlan
    from ..ops.direct import SpluSolver
    from ..ops.quantized import QuantizedCodebookDense
    from ..ops.spgemm import SpGEMMPacked, SpGEMMPlan
    from ..ops.trisolve import TriFixPlan, TriLevelPlan, TriSolvePlan

    return {cls.__name__: cls
            for cls in (CodebookDense, CodebookCSR, CSR, Dense, BlockedELL,
                        StripDense, BSR, COO, ELL, BSRPanels, DualGather,
                        PooledDG, Octet, SellRowLane, SellSuperblock,
                        SellSpmv, SellRowPure, PermutePlan, ClosPermutePlan,
                        SkewSpmv, SpGEMMPlan, SpGEMMPacked, TriSolvePlan,
                        TriFixPlan, TriLevelPlan, TriFusedPlan, TriWavesPlan,
                        SpluSolver, QuantDense, QuantizedCodebookDense)}


def _tensor(arr, dev):
    if isinstance(arr, (tuple, list)):
        return tuple(_tensor(a, dev) for a in arr)
    if arr is None or not isinstance(arr, np.ndarray):
        return arr  # None, or a container carried already
    # np.array copies: an array taken from a JAX container is read-only
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _static(val):
    if isinstance(val, str):
        return val
    if isinstance(val, (bool, np.bool_)):
        return bool(val)
    if isinstance(val, (tuple, list)):
        return tuple(int(v) for v in val)
    return int(val)


def from_numpy_fields(kind: str, fields: Dict[str, object],
                      static: Dict[str, object], device=None):
    """The port's ``kind`` container (a class name in ``kinds()``) holding
    ``fields`` as tensors on ``device`` and ``static`` as its static
    fields.  Field names must match the container's exactly."""
    cls = kinds().get(kind)
    if cls is None:
        raise ValueError(f"unknown container kind {kind!r}; "
                         f"expected one of {sorted(kinds())}")
    if set(fields) != set(cls._data_fields):
        raise ValueError(f"{kind}: array fields {sorted(fields)} differ from "
                         f"{sorted(cls._data_fields)}")
    if set(static) != set(cls._static_fields):
        raise ValueError(f"{kind}: static fields {sorted(static)} differ from "
                         f"{sorted(cls._static_fields)}")
    dev = resolve_device(device)
    tensors = {name: _tensor(arr, dev) for name, arr in fields.items()}
    statics = {name: _static(val) for name, val in static.items()}
    return cls(**tensors, **statics)
