"""Sparse containers: frozen dataclasses of torch tensors whose field names
match the JAX package's containers."""
from .base import SparseFormat, default_index_dtype, pad_to
from .carry import from_numpy_fields
from .codebook import CodebookCSR
from .codebook_dense import CodebookDense
from .convert import csr_to_blocked_ell
from .csr import CSR
from .dense import Dense
from .ell import BlockedELL
from .stripdense import StripDense

__all__ = [
    "SparseFormat",
    "default_index_dtype",
    "pad_to",
    "from_numpy_fields",
    "CodebookCSR",
    "CodebookDense",
    "csr_to_blocked_ell",
    "CSR",
    "Dense",
    "BlockedELL",
    "StripDense",
]
