"""SpMM: ``Y = A_sparse @ X_dense`` (multi-vector RHS, k = X.shape[1]).

Twin of ``sparsematrix_tpu/ops/spmm.py``.  ``spmm`` keeps the JAX
package's auto-routing, in its order and with its thresholds, as it runs
on the TPU: a format with a kernel goes to its kernel wrapper, and the
wrapper decides by the tensor's device (a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises).  So the CPU tests
walk the same routes as the card.

One routing differs on purpose: a ``CodebookDense`` goes to the
hand-written fused dequantize + product kernel (``kernels/codebook.py``),
where the JAX package sends it to XLA's lookup + dot
(``spmm.py:421-429``).  Formats and routes of the JAX package that the
port does not have yet raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..formats import CSR, BlockedELL, CodebookCSR, CodebookDense, Dense
from ..kernels.codebook import codebook_spmm
from ..kernels.spmm_blocked_ell import (spmm_blocked_ell,
                                        spmm_blocked_ell_reference)

__all__ = ["spmm", "spmm_reference", "spmm_densify"]


def _matmul(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` in the promoted type, returned in X's type (the JAX
    package's ``preferred_element_type=X.dtype``)."""
    dt = torch.promote_types(A.dtype, X.dtype)
    return (A.to(dt) @ X.to(dt)).to(X.dtype)


def _spmm_csr_plain(A: CSR, X):
    rows = A.shape[0]
    rid = A._row_ids_or_compute().long()
    prod = A.data[:, None] * X[A.indices.long()]  # (cap, k)
    # one spare row takes the padding entries (the segment_sum drop)
    out = torch.zeros((rows + 1, X.shape[1]), dtype=prod.dtype, device=X.device)
    return out.index_add_(0, rid, prod)[:rows]


def _spmm_codebook_plain(A: CodebookCSR, X):
    return _spmm_csr_plain(A.to_csr(), X)


def _spmm_codebook_dense_plain(A: CodebookDense, X):
    # for a non-fp32 X the table is cast first, so the dequantized plane
    # has X's type (``_spmm_codebook_dense_jnp``)
    table = A.val_table if X.dtype == torch.float32 else A.val_table.to(X.dtype)
    return table[A.idx.long()] @ X


def _spmm_dense_plain(A: Dense, X):
    if A.data.dtype == torch.bfloat16 and X.dtype == torch.float32:
        # half-width A plane, fp32 accumulation: only the input rounding
        return A.data.float() @ X.to(torch.bfloat16).float()
    return _matmul(A.data, X)


_PLAIN_IMPLS = {
    CSR: _spmm_csr_plain,
    BlockedELL: spmm_blocked_ell_reference,
    CodebookCSR: _spmm_codebook_plain,
    CodebookDense: _spmm_codebook_dense_plain,
    Dense: _spmm_dense_plain,
}


def _spmm_codebook_dense_kernel(A: CodebookDense, X):
    return codebook_spmm(A.idx, A.val_table, X)


# formats whose product is a hand-written kernel (the twin of
# ``_pallas_impl``); CodebookDense is the port's one routing difference
_KERNEL_IMPLS = {
    BlockedELL: spmm_blocked_ell,
    CodebookDense: _spmm_codebook_dense_kernel,
}


def spmm_reference(A, X):
    """Plain PyTorch product for every ported format (the ``_JNP_IMPLS``
    twins)."""
    impl = _PLAIN_IMPLS.get(type(A))
    if impl is None:
        raise NotImplementedError(
            f"spmm: format {type(A).__name__} is not ported yet "
            "(ROADMAP.md, Queue 1)")
    return impl(A, X)


def spmm_densify(A, X):
    """Materialize A and run one dense product (fp32 stays fp32: TF32 is
    off, ``config.py``)."""
    return _matmul(A.todense(), X)


# densify when at least this fraction of entries are stored and the dense
# temporary stays small
_DENSIFY_MIN_DENSITY = 0.05
_DENSIFY_MAX_ELEMS = 64 * 1024 * 1024


def _should_densify(A) -> bool:
    m, n = A.shape
    size = m * n
    return size <= _DENSIFY_MAX_ELEMS and A.nnz >= _DENSIFY_MIN_DENSITY * size


# CodebookCSR → CodebookDense conversion cache: converting once per
# container makes the default add_mat_mat/spmm path reach the fused kernel
# with no caller-side preparation.  Entries leave with their container.
_CBD_CACHE: dict = {}


def _codebook_dense_of(A: CodebookCSR):
    if A.shape[0] * A.shape[1] > _DENSIFY_MAX_ELEMS:
        return None  # index plane too large to materialize
    key = id(A)
    entry = _CBD_CACHE.get(key)
    if entry is not None and entry[0]() is A:
        return entry[1]
    rid = A.to_csr()._row_ids_or_compute()[: A.nnz].cpu().numpy()
    cid = A.indices[: A.nnz].cpu().numpy()
    vi = A.val_idx[: A.nnz].cpu().numpy()
    idxm = np.full(A.shape, A.table_size, np.int64)  # sentinel = zero
    idxm[rid, cid] = vi
    bd = CodebookDense.from_index_matrix(
        idxm, A.val_table[: A.table_size].cpu().numpy(), device=A.device)
    ref = weakref.ref(A, lambda _unused, k=key: _CBD_CACHE.pop(k, None))
    _CBD_CACHE[key] = (ref, bd)
    return bd


def spmm(A, X: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """``Y = A @ X`` with sparse ``A`` and dense ``X``.

    method: "auto" (density-adaptive), "sparse" (format kernels only), or
    "densify" (materialize A and run one dense product).
    """
    if X.ndim != 2 or X.shape[0] != A.shape[1]:
        raise ValueError(
            f"spmm: X shape {tuple(X.shape)} incompatible with matrix {A.shape}"
        )
    if method not in ("auto", "sparse", "densify"):
        raise ValueError(f"spmm: unknown method {method!r}")
    if type(A) not in _PLAIN_IMPLS:
        raise NotImplementedError(
            f"spmm: format {type(A).__name__} is not ported yet "
            "(ROADMAP.md, Queue 1)")
    if method == "densify":
        return spmm_densify(A, X)
    if type(A) is Dense:
        # already materialized: its plain product is the fast path
        return spmm_reference(A, X)
    impl = _KERNEL_IMPLS.get(type(A))
    if impl is not None:
        return impl(A, X)
    if method == "auto" and type(A) is CodebookCSR:
        bd = _codebook_dense_of(A)
        if bd is not None:
            return spmm(bd, X)  # fused dequant + product kernel
    if method == "auto" and type(A) is CSR and not _should_densify(A):
        raise NotImplementedError(
            "spmm: low-density CSR auto-routes to the strip and dual-gather "
            "layouts, not ported yet (ROADMAP.md, Queue 1 item 3); pass "
            "method='sparse' for the segment-sum product")
    if method == "auto" and _should_densify(A):
        return spmm_densify(A, X)
    return spmm_reference(A, X)
