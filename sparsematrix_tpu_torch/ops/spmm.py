"""SpMM: ``Y = A_sparse @ X_dense`` (multi-vector RHS, k = X.shape[1]).

Twin of ``sparsematrix_tpu/ops/spmm.py``.  ``spmm`` keeps the JAX
package's auto-routing, in its order and with its thresholds, as it runs
on the TPU: a format with a kernel goes to its kernel wrapper, and the
wrapper decides by the tensor's device (a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises).  So the CPU tests
walk the same routes as the card.

A ``BSR`` takes the JAX package's routes: at densify-eligible density a
small-block BSR (bm·bn < 4096) is materialized once (a ``Dense`` cached
on the container) and multiplied by one dense product, as the JAX package
leaves it to XLA; otherwise ``bsr_dispatch``: (128, 128)-class blocks
(bm·bn ≥ 4096) the grouped kernel, small blocks with ``bn % 8 == 0`` and
at most 64 blocks a block-row the panel kernel (both through
``kernels/bsr.py``'s ``spmm_bsr``), any other BSR the plain block
product.  ``COO`` and ``ELL`` have plain products only, as in the JAX
package.

Low-density CSR takes the JAX package's multi-RHS routes: band-local
matrices the strip layout, power-law matrices the skew hybrid
(``ops/skew.py``), ≤16 entries a row the sliced-ELL row gather, the rest
the dual-gather walk (``kernels/spmm_dualgather.py``), each pack built
once per container and cached.  Packed layouts serve ``spmm``
directly: a ``DualGather`` (a superblock pack with its pooled spill tail
too), an ``Octet`` (``kernels/spmv_octet.py``'s ``spmm_octet``, ``rem``
included) or a ``SkewSpmv`` from ``prepare_spmv``, and a ``SlicedEllMM``.
The SpMV-only layouts (rowlane, the rowlane superblock, SELL) raise
``TypeError``, as in the JAX package.

A ``CodebookDense`` takes the JAX package's route too: its plain table
lookup and one dense product (``_spmm_codebook_dense_plain``, the twin of
``_spmm_codebook_dense_jnp``), which the JAX ``_pallas_impl`` picks over
its Pallas kernel (``spmm.py:421-429``), as the lookup beats the port's
fused kernel on the card at 4096 rows of X (PERF.md, kernel row 1).  That kernel stays
callable by name (``kernels/codebook.py``'s ``codebook_spmm`` and
``codebook_matmul``).  Formats and routes of the JAX package that the
port does not have yet raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats import (BSR, COO, CSR, ELL, BlockedELL, CodebookCSR,
                       CodebookDense, Dense, QuantDense, StripDense)
from ..formats.base import cached_on
from ..kernels.bsr import (small_blocks, spmm_bsr, spmm_bsr_grouped_reference,
                           takes_kernel)
from ..kernels.spmm_blocked_ell import (spmm_blocked_ell,
                                        spmm_blocked_ell_reference)
from ..kernels.spmm_dualgather import spmm_dualgather
from ..kernels.spmv_dualgather import DualGather, pack_dualgather
from ..kernels.spmv_octet import Octet, spmm_octet
from ..kernels.spmv_rowlane import SellRowLane
from ..kernels.spmv_sell import SellRowPure, SellSpmv
from ..kernels.spmv_superblock import SellSuperblock
from .quantized import int8_matmul
from .skew import SkewSpmv, is_skewed, pack_skew, spmm_skew
from .spmm_lowdeg import SlicedEllMM, pack_sliced_ell, spmm_sliced_ell
from .spmv import _maybe_strip

__all__ = ["spmm", "spmm_reference", "spmm_densify", "spmm_right"]


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


def _spmm_coo_plain(A: COO, X):
    prod = A.data[:, None] * X[A.col.long()]
    out = torch.zeros((A.shape[0], X.shape[1]), dtype=prod.dtype,
                      device=X.device)
    return out.index_add_(0, A.row.long(), prod)


def _spmm_ell_plain(A: ELL, X):
    # padding cells hold 0 at column 0
    dt = torch.promote_types(A.data.dtype, X.dtype)
    return torch.einsum("rn,rnk->rk", A.data.to(dt), X[A.cols.long()].to(dt))


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


def _spmm_quantdense_plain(A: QuantDense, X):
    # per-column symmetric quantization of X, int8 contraction with int32
    # accumulate, rank-1 rescale (``_spmm_quantdense_jnp``)
    colmax = X.abs().amax(dim=0)
    t = torch.where(colmax > 0, colmax / 127.0,
                    torch.ones_like(colmax)).float()
    Xq = torch.clamp(torch.round(X / t[None, :]), -127, 127).to(torch.int8)
    Yi = int8_matmul(A.data, Xq)
    return (Yi.float() * A.scale[:, None] * t[None, :]).to(X.dtype)


def _spmm_strip_plain(A: StripDense, X):
    # per strip, the X rows of its window, then one batched product
    Xg = X[A.window_index()]  # (n_strips, width, k)
    Y = torch.einsum("srw,swk->srk", A.strips, Xg.to(A.strips.dtype))
    return Y.reshape(-1, X.shape[1])[: A.shape[0]]


_PLAIN_IMPLS = {
    CSR: _spmm_csr_plain,
    COO: _spmm_coo_plain,
    ELL: _spmm_ell_plain,
    BSR: spmm_bsr_grouped_reference,
    BlockedELL: spmm_blocked_ell_reference,
    CodebookCSR: _spmm_codebook_plain,
    CodebookDense: _spmm_codebook_dense_plain,
    Dense: _spmm_dense_plain,
    QuantDense: _spmm_quantdense_plain,
    StripDense: _spmm_strip_plain,
}


def bsr_dispatch(A: BSR, X):
    """The JAX package's ``bsr_dispatch`` (``ops/spmm.py:433-450``):
    MXU-sized blocks the grouped kernel; small blocks the panel kernel
    where the panel layout applies; else the plain block product."""
    if takes_kernel(A):
        return spmm_bsr(A, X)
    return spmm_bsr_grouped_reference(A, X)


# the twin of the JAX package's ``_pallas_impl``: the formats whose
# product is a hand-written kernel where the JAX package's is a Pallas
# kernel, and CodebookDense's plain lookup + product, which the JAX
# package takes there in place of its Pallas kernel
_KERNEL_IMPLS = {
    BlockedELL: spmm_blocked_ell,
    BSR: bsr_dispatch,
}
_ROUTE_IMPLS = {**_KERNEL_IMPLS, CodebookDense: _spmm_codebook_dense_plain}


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
# container makes the default add_mat_mat/spmm path reach the lookup +
# product with no caller-side preparation.  Entries leave with their container.
_CBD_CACHE: dict = {}


def _codebook_dense_of(A: CodebookCSR):
    if A.shape[0] * A.shape[1] > _DENSIFY_MAX_ELEMS:
        return None  # index plane too large to materialize
    return cached_on(_CBD_CACHE, A, _codebook_dense_build)


def _codebook_dense_build(A: CodebookCSR):
    rid = A.to_csr()._row_ids_or_compute()[: A.nnz].cpu().numpy()
    cid = A.indices[: A.nnz].cpu().numpy()
    vi = A.val_idx[: A.nnz].cpu().numpy()
    idxm = np.full(A.shape, A.table_size, np.int64)  # sentinel = zero
    idxm[rid, cid] = vi
    return CodebookDense.from_index_matrix(
        idxm, A.val_table[: A.table_size].cpu().numpy(), device=A.device)


# a small-block BSR's dense matrix, materialized once per container
_BSR_DENSE_CACHE: dict = {}


def _bsr_dense_of(A: BSR) -> Dense:
    return cached_on(_BSR_DENSE_CACHE, A, Dense.from_sparse)


# multi-RHS walk packs per CSR container (misses cached too)
_DG_CACHE: dict = {}
_STRIP_CACHE: dict = {}


def _dg_pack_build(A: CSR):
    # power-law guard, as prepare_spmv's: the hybrid skew layout
    if is_skewed(A):
        return pack_skew(A)
    # ≲16 entries a row: the sliced-ELL row gather
    if A.nnz <= 16 * A.shape[0]:
        return pack_sliced_ell(A)
    packed = pack_dualgather(A, k_tiles=1)
    # below this fill the slab bytes explode; the plain product instead
    return None if packed.fill_rate < 0.05 else packed


def _dg_pack_of(A: CSR):
    """The multi-RHS walk pack of a CSR (the JAX package's
    ``_dg_pack_of``): None below 4096 entries or for a pathological
    fill, a ``SlicedEllMM`` at ≤16 entries a row, else a k_tiles=1
    ``DualGather``, or the skew hybrid for power-law matrices."""
    if A.nnz < 4096:
        return None
    return cached_on(_DG_CACHE, A, _dg_pack_build)


def _strip_of(A: CSR):
    """Cached StripDense conversion for band-local CSR (the spmv auto
    path's rule)."""
    return cached_on(_STRIP_CACHE, A, _maybe_strip)


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
    if isinstance(A, SkewSpmv):
        return spmm_skew(A, X)
    if isinstance(A, DualGather):
        return spmm_dualgather(A, X)  # packed layouts serve spmv and spmm
    if isinstance(A, Octet):
        return spmm_octet(A, X)
    if isinstance(A, SlicedEllMM):
        return spmm_sliced_ell(A, X)
    if isinstance(A, (SellRowLane, SellSuperblock, SellRowPure, SellSpmv)):
        # as in the JAX package, these layouts serve SpMV only
        raise TypeError(f"spmm: unsupported format {type(A).__name__}")
    if type(A) not in _PLAIN_IMPLS:
        raise NotImplementedError(
            f"spmm: format {type(A).__name__} is not ported yet "
            "(ROADMAP.md, Queue 1)")
    if method == "densify":
        return spmm_densify(A, X)
    if type(A) in (Dense, QuantDense):
        # already materialized: its plain product (the bf16 plane, the
        # int8 contraction) is the fast path; never re-densify
        return spmm_reference(A, X)
    if (method == "auto" and type(A) is BSR and _should_densify(A)
            and small_blocks(A)):
        # small blocks at densify-eligible density: one dense product of
        # the matrix materialized once
        return spmm_reference(_bsr_dense_of(A), X)
    impl = _ROUTE_IMPLS.get(type(A))
    if impl is not None:
        return impl(A, X)
    if method == "auto" and type(A) is CodebookCSR:
        bd = _codebook_dense_of(A)
        if bd is not None:
            return spmm(bd, X)  # the dequantized lookup + one product
    if method == "auto" and type(A) is CSR and not _should_densify(A):
        # band-local CSR: the strip batched product
        S = _strip_of(A)
        if S is not None:
            return _spmm_strip_plain(S, X)
        if X.shape[1] <= 64:
            # low-density multi-RHS: walk the dual-gather slabs per column
            packed = _dg_pack_of(A)
            if isinstance(packed, SkewSpmv):
                return spmm_skew(packed, X)
            if isinstance(packed, SlicedEllMM):
                return spmm_sliced_ell(packed, X)
            if packed is not None:
                return spmm_dualgather(packed, X)
    if method == "auto" and _should_densify(A):
        return spmm_densify(A, X)
    return spmm_reference(A, X)


def spmm_right(X: torch.Tensor, A_transposed) -> torch.Tensor:
    """``Y = X @ A`` for dense X and sparse A, through ``X @ A = (Aᵀ @
    Xᵀ)ᵀ``.  ``A_transposed`` is the sparse storage of ``Aᵀ`` (n×k for a
    logical k×n A), made at build time, as the reference encodes B with
    ``SblasTrans`` (blas_test.h:145, sparse-matrix.cc:65-98)."""
    return spmm(A_transposed, X.T).T
