"""sparsematrix_tpu_torch — the PyTorch and CUDA port of sparsematrix_tpu.

Plain tensor code is PyTorch; each Pallas kernel of the JAX package on the
ported path is a hand-written CUDA kernel for sm_90a (``csrc/``), built at
first use.  The JAX package stays the reference: this package imports
neither it nor JAX.  Entry points and container constructors run on the
card unless given ``device="cpu"``; a CPU tensor takes the plain PyTorch
version of each kernel.
"""
from . import config
from .formats import (CSR, BlockedELL, CodebookCSR, CodebookDense, Dense,
                      csr_to_blocked_ell, from_numpy_fields)
from .kernels import codebook_matmul, spmm_blocked_ell
from .ops import add_mat_mat, spmm, spmm_densify, spmm_reference

__all__ = [
    "config",
    "CSR",
    "BlockedELL",
    "CodebookCSR",
    "CodebookDense",
    "Dense",
    "csr_to_blocked_ell",
    "from_numpy_fields",
    "codebook_matmul",
    "spmm_blocked_ell",
    "add_mat_mat",
    "spmm",
    "spmm_densify",
    "spmm_reference",
]
