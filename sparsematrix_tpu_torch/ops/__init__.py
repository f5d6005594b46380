"""Sparse ops: SpMM and the reference's AddMatMat."""
from .addmatmat import add_mat_mat
from .spmm import spmm, spmm_densify, spmm_reference

__all__ = ["add_mat_mat", "spmm", "spmm_densify", "spmm_reference"]
