"""Sparse ops: SpMV, SpMM and the reference's AddMatMat."""
from .addmatmat import add_mat_mat
from .skew import SkewSpmv, skew_stats
from .spmm import spmm, spmm_densify, spmm_reference
from .spmm_lowdeg import SlicedEllMM, pack_sliced_ell, spmm_sliced_ell
from .spmv import prepare_spmv, spmv, spmv_reference

__all__ = ["add_mat_mat", "spmm", "spmm_densify", "spmm_reference", "spmv",
           "spmv_reference", "prepare_spmv", "SkewSpmv", "skew_stats",
           "SlicedEllMM", "pack_sliced_ell", "spmm_sliced_ell"]
