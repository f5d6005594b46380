"""Sparse containers: frozen dataclasses of torch tensors whose field names
match the JAX package's containers."""
from .base import SparseFormat, default_index_dtype, pad_to
from .bsr import BSR
from .carry import from_numpy_fields
from .codebook import CodebookCSR
from .codebook_dense import CodebookDense
from .convert import (bsr_to_csr, coo_to_csr, csr_to_blocked_ell, csr_to_bsr,
                      csr_to_coo, csr_to_ell, ell_to_csr)
from .coo import COO
from .csr import CSC, CSR
from .dense import Dense
from .ell import ELL, BlockedELL
from .interop import from_torch, to_torch
from .stripdense import StripDense
from .validate import validate

__all__ = [
    "SparseFormat",
    "default_index_dtype",
    "pad_to",
    "from_numpy_fields",
    "BSR",
    "COO",
    "CSC",
    "CSR",
    "ELL",
    "BlockedELL",
    "CodebookCSR",
    "CodebookDense",
    "Dense",
    "StripDense",
    "coo_to_csr",
    "csr_to_coo",
    "csr_to_ell",
    "csr_to_blocked_ell",
    "csr_to_bsr",
    "bsr_to_csr",
    "ell_to_csr",
    "validate",
    "from_torch",
    "to_torch",
]
