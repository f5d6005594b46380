"""Sparse ops: SpMV, SpMM, SpGEMM, planned permutations, triangular solves
with ILU(0)/IC(0) and SuperLU, the reference's AddMatMat (and its
quantized int8/int16 twins), transposed
products, sparse addition and elementwise utilities."""
from ..kernels.trisolve_fused import (TriFusedPlan, trisolve_fused_apply,
                                      trisolve_fused_apply_batched,
                                      trisolve_fused_plan)
from ..kernels.trisolve_waves import (TriWavesPlan, trisolve_waves_apply,
                                      trisolve_waves_apply_mm,
                                      trisolve_waves_plan,
                                      trisolve_waves_solve)
from .add import SparseAddPlan, sparse_add, sparse_add_apply, sparse_add_plan
from .addmatmat import add_mat_mat
from .direct import SpluSolver, splu_plans, splu_solve
from .elementwise import (axpy_same_pattern, diagonal, frobenius_norm, scale,
                          with_data)
from .ichol import (ic0, ic0_fixpoint_plans, ic0_fused_plans, ic0_level_plans,
                    ic0_plans, ic0_waves_plans, ic_apply)
from .ilu import (ilu0, ilu0_fixpoint_plans, ilu0_fused_plans,
                  ilu0_level_plans, ilu0_plans, ilu0_waves_plans, ilu_apply)
from .permute import (PermutePlan, apply_permutation, plan_gather_permutation,
                      plan_permutation_auto)
from .quantized import (QuantizedCodebookDense, add_mat_mat_int8,
                        add_mat_mat_int16, int8_matmul, quantize_codebook)
from .permute_clos import (ClosPermutePlan, apply_clos_permutation,
                           plan_clos_permutation)
from .skew import SkewSpmv, pack_skew, skew_stats, spmm_skew, spmv_skew
from .spgemm import (SpGEMMPacked, SpGEMMPlan, spgemm, spgemm_apply,
                     spgemm_apply_packed, spgemm_apply_packed_csc,
                     spgemm_densify, spgemm_extract, spgemm_plan,
                     spgemm_plan_packed)
from .spmm import spmm, spmm_densify, spmm_reference, spmm_right
from .spmm_lowdeg import SlicedEllMM, pack_sliced_ell, spmm_sliced_ell
from .spmv import prepare_spmv, spmv, spmv_reference
from .transpose_ops import csr_transpose_device, spmm_t, spmv_t
from .trisolve import (TriFixPlan, TriLevelPlan, TriSolvePlan, trisolve,
                       trisolve_apply, trisolve_fixpoint_apply,
                       trisolve_fixpoint_plan, trisolve_level_apply,
                       trisolve_level_plan, trisolve_plan)

__all__ = ["add_mat_mat", "QuantizedCodebookDense", "quantize_codebook",
           "add_mat_mat_int8", "add_mat_mat_int16", "int8_matmul", "spmm", "spmm_densify", "spmm_reference",
           "spmm_right", "spmv_t", "spmm_t", "csr_transpose_device",
           "SparseAddPlan", "sparse_add", "sparse_add_apply",
           "sparse_add_plan", "scale", "axpy_same_pattern", "diagonal",
           "frobenius_norm", "with_data", "spmv",
           "spmv_reference", "prepare_spmv", "SkewSpmv", "pack_skew",
           "skew_stats", "spmv_skew", "spmm_skew", "SlicedEllMM",
           "pack_sliced_ell", "spmm_sliced_ell", "PermutePlan",
           "plan_gather_permutation", "plan_permutation_auto",
           "apply_permutation", "ClosPermutePlan", "plan_clos_permutation",
           "apply_clos_permutation", "SpGEMMPlan", "spgemm_plan",
           "spgemm_apply", "spgemm", "spgemm_densify", "spgemm_extract",
           "SpGEMMPacked", "spgemm_plan_packed", "spgemm_apply_packed",
           "spgemm_apply_packed_csc", "TriWavesPlan", "trisolve_waves_apply",
           "trisolve_waves_apply_mm", "trisolve_waves_solve",
           "trisolve_waves_plan", "TriFusedPlan", "trisolve_fused_apply",
           "trisolve_fused_apply_batched", "trisolve_fused_plan",
           "TriFixPlan", "TriLevelPlan", "trisolve_level_apply",
           "trisolve_level_plan", "TriSolvePlan", "trisolve",
           "trisolve_apply", "trisolve_fixpoint_apply",
           "trisolve_fixpoint_plan", "trisolve_plan", "ic0",
           "ic0_fixpoint_plans", "ic0_fused_plans", "ic0_waves_plans",
           "ic0_level_plans", "ic0_plans", "ic_apply", "SpluSolver",
           "splu_plans", "splu_solve", "ilu0", "ilu0_fixpoint_plans",
           "ilu0_fused_plans", "ilu0_waves_plans", "ilu0_level_plans",
           "ilu0_plans", "ilu_apply"]
