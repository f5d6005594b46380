"""``add_mat_mat`` — the reference's single math op, with identical semantics.

Twin of ``sparsematrix_tpu/ops/addmatmat.py``:
``C = beta * C + alpha * A_dense(m×k) @ B_sparse(k×n)``
(sparse-matrix.cc:140-194).  B is stored pre-transposed (``B_t``: n×k,
built with ``trans=True``, the reference's ``SblasTrans`` encode), so the
product is a plain SpMM: ``A @ B = spmm(B_t, A^T)^T``.  ``A^T`` is a view;
the kernels read it through its strides without a copy.
"""
from __future__ import annotations

import torch

from .spmm import spmm

__all__ = ["add_mat_mat"]


def add_mat_mat(a: torch.Tensor, b_t_sparse, c=None, alpha=1.0, beta=0.0):
    """Compute ``beta*C + alpha * A @ B`` with ``B`` given as sparse ``B^T``.

    Args:
      a: dense (m, k).
      b_t_sparse: sparse container storing ``B^T`` with shape (n, k).
      c: optional dense (m, n); required when ``beta != 0``.
      alpha, beta: scalars (reference defaults: alpha=beta=1.0 for the sparse
        benchmark path, blas_test.h:313).
    Returns:
      dense (m, n).
    """
    if c is None:
        try:
            beta_static = float(beta)
        except (TypeError, ValueError, RuntimeError):
            beta_static = None  # not a scalar: cannot prove it is 0
        if beta_static is None or beta_static != 0.0:
            raise ValueError("add_mat_mat: beta != 0 requires c (the matrix "
                             "being accumulated into)")
    prod = spmm(b_t_sparse, a.T).T  # (m, n)
    out = alpha * prod
    if c is not None:
        out = out + beta * torch.as_tensor(c, device=out.device)
    return out
