"""SpMV: ``y = A @ x``.

Twin of ``sparsematrix_tpu/ops/spmv.py``.  Each ported format has a plain
PyTorch product (``spmv_reference``, the ``_JNP_IMPLS`` twins), and a CSR
takes the JAX package's auto-routing as it runs on the TPU: it is packed
once (``prepare_spmv``, cached per container) into the layout the JAX
package would pick, with its rules and thresholds, and the pack's
product runs its kernel wrapper, which decides by the tensor's device (a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises).  So the CPU tests walk the same routes as the card.

A small-block ``BSR`` (bm·bn < 4096) is converted once to CSR
(``bsr_to_csr``, cached on the container, never through the dense
matrix) and takes the CSR route; a larger-block BSR, a ``COO`` and an
``ELL`` take their plain products, as in the JAX package (its
``spmv_pallas.PALLAS_IMPLS`` is empty).

The layouts: dual-gather (the default; ``spill_cap`` adds its pooled
spill tail), strip (band-local), octet (≲2 entries a row), the rowlane
superblock (scattered patterns), rowlane, and the skew hybrid (power-law
matrices).  ``spmv`` also takes the SELL packs ``pack_sell`` and
``pack_sell_rowpure`` build (``kernels/spmv_sell.py``), which no auto
route picks, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..formats import (BSR, COO, CSR, ELL, BlockedELL, CodebookCSR,
                       CodebookDense, Dense, StripDense, bsr_to_csr)
from ..formats.base import cached_on
from ..kernels.bsr import small_blocks, spmm_bsr_grouped_reference
from ..kernels.spmm_blocked_ell import spmm_blocked_ell_reference
from ..kernels.spmv_dualgather import (DualGather, pack_dualgather,
                                       spmv_dualgather)
from ..kernels.spmv_octet import Octet, pack_octet, spmv_octet
from ..kernels.spmv_rowlane import (SellRowLane, pack_sell_rowlane,
                                    spmv_sell_rowlane)
from ..kernels.spmv_sell import (SellRowPure, SellSpmv, spmv_sell,
                                 spmv_sell_rowpure)
from ..kernels.spmv_superblock import (SellSuperblock, pack_superblock,
                                       spmv_superblock)
from .skew import SkewSpmv, is_skewed, pack_skew, spmv_skew

__all__ = ["spmv", "spmv_reference", "prepare_spmv"]


# ---------------------------------------------------------------------------
# plain implementations
# ---------------------------------------------------------------------------

def _spmv_csr_plain(A: CSR, x):
    rows = A.shape[0]
    rid = A._row_ids_or_compute().long()
    prod = A.data * x[A.indices.long()]
    # one spare row takes the padding entries (the segment_sum drop)
    out = torch.zeros(rows + 1, dtype=prod.dtype, device=x.device)
    return out.index_add_(0, rid, prod)[:rows]


def _spmv_coo_plain(A: COO, x):
    prod = A.data * x[A.col.long()]
    out = torch.zeros(A.shape[0], dtype=prod.dtype, device=x.device)
    return out.index_add_(0, A.row.long(), prod)


def _spmv_ell_plain(A: ELL, x):
    # padding cells hold 0 at column 0
    return (A.data * x[A.cols.long()]).sum(dim=1)


def _spmv_bsr_plain(A: BSR, x):
    return spmm_bsr_grouped_reference(A, x[:, None])[:, 0]


def _spmv_bell_plain(A: BlockedELL, x):
    return spmm_blocked_ell_reference(A, x[:, None])[:, 0]


def _spmv_codebook_plain(A: CodebookCSR, x):
    return _spmv_csr_plain(A.to_csr(), x)


def _spmv_codebook_dense_plain(A: CodebookDense, x):
    # the 256-entry table is cast first for a non-fp32 x
    table = A.val_table if x.dtype == torch.float32 else A.val_table.to(x.dtype)
    return table[A.idx.long()] @ x


def _spmv_dense_plain(A: Dense, x):
    if A.data.dtype == torch.bfloat16 and x.dtype == torch.float32:
        # half-width A plane, fp32 accumulation: only the input rounding
        return A.data.float() @ x.to(torch.bfloat16).float()
    dt = torch.promote_types(A.data.dtype, x.dtype)
    return A.data.to(dt) @ x.to(dt)


def _spmv_strip_plain(A: StripDense, x):
    # per strip, the x window at its first column, then one batched matvec
    xg = x[A.window_index()]  # (n_strips, width)
    y = torch.einsum("srw,sw->sr", A.strips, xg.to(A.strips.dtype))
    return y.reshape(-1)[: A.shape[0]]


_PLAIN_IMPLS = {
    CSR: _spmv_csr_plain,
    COO: _spmv_coo_plain,
    ELL: _spmv_ell_plain,
    BSR: _spmv_bsr_plain,
    BlockedELL: _spmv_bell_plain,
    CodebookCSR: _spmv_codebook_plain,
    CodebookDense: _spmv_codebook_dense_plain,
    Dense: _spmv_dense_plain,
    StripDense: _spmv_strip_plain,
}


def spmv_reference(A, x):
    """Plain PyTorch SpMV of every ported format."""
    impl = _PLAIN_IMPLS.get(type(A))
    if impl is None:
        raise NotImplementedError(
            f"spmv: format {type(A).__name__} is not ported yet "
            "(ROADMAP.md, Queue 1)")
    return impl(A, x)


# ---------------------------------------------------------------------------
# packing and routing
# ---------------------------------------------------------------------------

# auto-pack cache: CSR container → its pack, built at the first spmv;
# small-block BSR container → its CSR
_AUTO_PACK_CACHE: dict = {}
_BSR_CSR_CACHE: dict = {}


# auto-pack pays off once rows are long enough for slabs to fill; below
# this the plain CSR product is used
_AUTO_PACK_MIN_NNZ_PER_ROW = 8
_AUTO_PACK_MIN_NNZ = 4096


def prepare_spmv(A: CSR, layout: str = "auto", skew: str = "auto",
                 **pack_kwargs):
    """Explicit build step: pack a CSR for the fast SpMV kernel.

    ``layout``: ``"dualgather"``, ``"rowlane"``, ``"superblock"``,
    ``"strip"`` (band-local matrices), ``"octet"``, ``"skew"``, or
    ``"auto"``: the skew hybrid for power-law matrices, strip when the
    matrix is band-local and dense enough within the band, octet at ≲2
    entries a row, else the dual-gather layout with the JAX package's
    k_tiles/group table, and the rowlane superblock when that pack comes
    out step-bound (group ≤ 2 over many tiles).  The pack lies on the
    CSR's device.
    """
    if layout == "dualgather":
        return pack_dualgather(A, **pack_kwargs)
    if layout == "superblock":
        return pack_superblock(A, **pack_kwargs)
    if layout == "strip":
        return StripDense.from_csr(A, **pack_kwargs)
    if layout == "octet":
        return pack_octet(A, **pack_kwargs)
    if layout == "skew":
        return pack_skew(A, **pack_kwargs)
    if layout not in ("auto", "rowlane"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "auto" and skew == "auto" and not pack_kwargs and is_skewed(A):
        # power-law guard: one hub row/column forces every (tile, window)
        # it touches to its own depth; the hybrid layout takes hubs apart
        return pack_skew(A)
    if layout == "auto" and not pack_kwargs:
        strip = _maybe_strip(A)
        if strip is not None:
            return strip
        if A.nnz <= 2 * A.shape[0] and A.shape[0] >= 2048:
            # ≲2 entries a row: the octet layout spans 8 tiles per slab
            return pack_octet(A)
    if layout == "auto":
        n_tiles = -(-A.shape[0] // 128)
        # the JAX package's table: two-window slabs on superblocks; at
        # many tiles kt=8/g=128, at few tiles kt=32/g=256 (kt=8's
        # per-superblock group padding collapses fill there)
        if n_tiles >= 128:
            kt, grp = 8, 128
        elif n_tiles >= 16:
            kt, grp = min(32, n_tiles), 256
        else:
            kt, grp = 1, None
        dg_kwargs = {k: v for k, v in pack_kwargs.items()
                     if k in ("dtype", "group", "k_tiles", "spill_cap",
                              "with_transpose", "two_win")}
        dg_kwargs.setdefault("k_tiles", kt)
        if kt > 1 and "spill_cap" not in dg_kwargs:
            dg_kwargs.setdefault("two_win", True)
        packed = pack_dualgather(A, **dg_kwargs)
        if (grp is not None and "group" not in pack_kwargs
                and packed.two_win and packed.group < grp):
            # the ≤15 %-waste auto group ignores per-step overhead; a large
            # fixed group wins unless its superblock padding collapses
            # fill (the slot assignment is cached: only the scatter reruns)
            wide = pack_dualgather(A, **{**dg_kwargs, "group": grp})
            if wide.fill_rate >= 0.8 * packed.fill_rate:
                packed = wide
        # scattered patterns (~1 slab a tile) go to the rowlane superblock
        if packed.group > 2 or packed.n_tiles <= 256:
            return packed
        sb_kwargs = {k: v for k, v in pack_kwargs.items() if k == "dtype"}
        return pack_superblock(A, **sb_kwargs)
    return pack_sell_rowlane(A, **pack_kwargs)


def _maybe_strip(A: CSR):
    """StripDense pack when the matrix is band-local and dense within the
    band (strip fill ≥ 0.25); None otherwise."""
    if A.nnz == 0 or A.shape[0] < 128:
        return None
    try:
        S = StripDense.from_csr(A, max_width=2048)
    except ValueError:
        return None
    if S.fill_rate < 0.25:
        return None
    return S


def _auto_pack(A: CSR):
    """Pack-and-cache for a CSR; None when auto-packing does not apply."""
    if A.nnz < _AUTO_PACK_MIN_NNZ or A.nnz < _AUTO_PACK_MIN_NNZ_PER_ROW * A.shape[0]:
        return None
    return cached_on(_AUTO_PACK_CACHE, A, prepare_spmv)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x``.  Accepts every ported format and the packed layouts
    of ``prepare_spmv``; a CSR is packed at its first call and the pack
    cached on the container."""
    if isinstance(A, SkewSpmv):
        return spmv_skew(A, x)
    if isinstance(A, DualGather):
        return spmv_dualgather(A, x)
    if isinstance(A, Octet):
        return spmv_octet(A, x)
    if isinstance(A, SellRowLane):
        return spmv_sell_rowlane(A, x)
    if isinstance(A, SellSuperblock):
        return spmv_superblock(A, x)
    if isinstance(A, SellRowPure):
        return spmv_sell_rowpure(A, x)
    if isinstance(A, SellSpmv):
        return spmv_sell(A, x)
    if x.ndim != 1 or x.shape[0] != A.shape[1]:
        raise ValueError(
            f"spmv: x shape {tuple(x.shape)} incompatible with matrix {A.shape}")
    if type(A) is BSR and small_blocks(A):
        # small blocks: the CSR auto-pack route
        A = cached_on(_BSR_CSR_CACHE, A, bsr_to_csr)
    if type(A) is CSR:
        packed = _auto_pack(A)
        if packed is not None:
            if isinstance(packed, StripDense):
                return _spmv_strip_plain(packed, x)
            return spmv(packed, x)
    return spmv_reference(A, x)
