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
from .kernels import (DualGather, Octet, SellRowLane, SellSuperblock,
                      codebook_matmul, pack_dualgather, pack_octet,
                      pack_sell_rowlane, pack_superblock, spmm_blocked_ell,
                      spmm_dualgather, spmv_dualgather, spmv_octet,
                      spmv_sell_rowlane, spmv_superblock, window_permute)
from .ops import (SkewSpmv, SpGEMMPacked, add_mat_mat, apply_permutation,
                  pack_skew, plan_permutation_auto, prepare_spmv, spgemm,
                  spgemm_apply_packed, spgemm_apply_packed_csc,
                  spgemm_plan_packed, spmm, spmm_densify, spmm_reference,
                  spmv, spmv_reference)

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
    "Octet",
    "pack_octet",
    "spmv_octet",
    "SellRowLane",
    "pack_sell_rowlane",
    "spmv_sell_rowlane",
    "SellSuperblock",
    "pack_superblock",
    "spmv_superblock",
    "window_permute",
    "SkewSpmv",
    "pack_skew",
    "apply_permutation",
    "plan_permutation_auto",
    "spgemm",
    "SpGEMMPacked",
    "spgemm_plan_packed",
    "spgemm_apply_packed",
    "spgemm_apply_packed_csc",
    "add_mat_mat",
    "spmm",
    "spmm_densify",
    "spmm_reference",
    "spmv",
    "spmv_reference",
    "prepare_spmv",
]
