"""Hand-written CUDA kernels for sm_90a, each beside its plain PyTorch
version.  Importing builds nothing; a kernel is compiled at its first
launch (``_build.py``)."""
from ._build import launch_counts
from .codebook import codebook_matmul, codebook_spmm, codebook_spmm_reference
from .spmm_blocked_ell import spmm_blocked_ell, spmm_blocked_ell_reference

__all__ = [
    "launch_counts",
    "codebook_matmul",
    "codebook_spmm",
    "codebook_spmm_reference",
    "spmm_blocked_ell",
    "spmm_blocked_ell_reference",
]
