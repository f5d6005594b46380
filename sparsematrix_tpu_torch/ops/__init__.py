"""Sparse ops: SpMV, SpMM, SpGEMM, planned permutations and the reference's
AddMatMat."""
from .addmatmat import add_mat_mat
from .permute import (PermutePlan, apply_permutation, plan_gather_permutation,
                      plan_permutation_auto)
from .permute_clos import (ClosPermutePlan, apply_clos_permutation,
                           plan_clos_permutation)
from .skew import SkewSpmv, pack_skew, skew_stats, spmm_skew, spmv_skew
from .spgemm import (SpGEMMPacked, SpGEMMPlan, spgemm, spgemm_apply,
                     spgemm_apply_packed, spgemm_apply_packed_csc,
                     spgemm_densify, spgemm_extract, spgemm_plan,
                     spgemm_plan_packed)
from .spmm import spmm, spmm_densify, spmm_reference
from .spmm_lowdeg import SlicedEllMM, pack_sliced_ell, spmm_sliced_ell
from .spmv import prepare_spmv, spmv, spmv_reference

__all__ = ["add_mat_mat", "spmm", "spmm_densify", "spmm_reference", "spmv",
           "spmv_reference", "prepare_spmv", "SkewSpmv", "pack_skew",
           "skew_stats", "spmv_skew", "spmm_skew", "SlicedEllMM",
           "pack_sliced_ell", "spmm_sliced_ell", "PermutePlan",
           "plan_gather_permutation", "plan_permutation_auto",
           "apply_permutation", "ClosPermutePlan", "plan_clos_permutation",
           "apply_clos_permutation", "SpGEMMPlan", "spgemm_plan",
           "spgemm_apply", "spgemm", "spgemm_densify", "spgemm_extract",
           "SpGEMMPacked", "spgemm_plan_packed", "spgemm_apply_packed",
           "spgemm_apply_packed_csc"]
