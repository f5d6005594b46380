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
                      StripDense, csr_to_blocked_ell, from_numpy_fields)
from .kernels import (DualGather, codebook_matmul, pack_dualgather,
                      spmm_blocked_ell, spmm_dualgather, spmv_dualgather)
from .ops import (add_mat_mat, prepare_spmv, spmm, spmm_densify,
                  spmm_reference, spmv, spmv_reference)

__all__ = [
    "config",
    "CSR",
    "BlockedELL",
    "CodebookCSR",
    "CodebookDense",
    "Dense",
    "StripDense",
    "csr_to_blocked_ell",
    "from_numpy_fields",
    "DualGather",
    "pack_dualgather",
    "codebook_matmul",
    "spmm_blocked_ell",
    "spmv_dualgather",
    "spmm_dualgather",
    "add_mat_mat",
    "spmm",
    "spmm_densify",
    "spmm_reference",
    "spmv",
    "spmv_reference",
    "prepare_spmv",
]
