"""BSR times dense: ``csrc/spmm_bsr.cu``, the grouped and the panel kernel.

Twin of ``sparsematrix_tpu/kernels/bsr_pallas.py``.  ``spmm_bsr(A, X)``
computes ``Y = A @ X`` for a ``BSR`` A through one of two layouts, chosen
as the JAX wrapper chooses (``_spmm_bsr_forward``):

- the panel layout (``BSRPanels``, ``pack_bsr_panels``: each block-row's
  blocks side by side as one (bm × M·bn) panel, packed once on the host
  and cached on the container) when ``bn % 8 == 0``, ``bm·bn < 4096`` and
  M, the most blocks a block-row holds, is at most 64;
- else the grouped layout: the BSR's own stored blocks, block-row by
  block-row.

The JAX package takes the grouped kernel for a traced container too
(``jax.jit(spmm_bsr)``); the port has no tracers, so a small-block BSR
reaches the grouped kernel only through ``bn % 8 != 0`` or M > 64.

The panel kernel has two designs, picked on the host by ``panel_plan``:
``narrow`` (a thread a row of Y and a 16-byte column vector, no shared
memory: block CG's k = 8) and ``wide`` (warps that stage block-row panels
in shared memory and spend each gathered X row on up to 8 rows), taken
where k >= 32 and bn % 8 == 0.  Both walk each block-row's slots only up
to its last one that holds a nonzero value (``panel_counts``): the panel
layout pads every block-row to the longest one's M slots.

The grouped kernel has two designs too, picked by ``grouped_design``:
blocks of bm >= 32 (the ones ``spmm`` sends it, bm·bn >= 4096) take the
tile design, a register-blocked fp32 product of up to 128 rows of a
block-row by 128 (or 64) columns of Y, its contraction streamed by
``cp.async`` from the block and the X row-block it names; the host cuts
each block-row's slot list into chunks of about equal work
(``tile_plan``), chunks of a split block-row write fp32 partial tiles
that a second kernel sums in chunk order, so two calls give the same
bits.  Smaller blocks (the bench's (8, 8), odd blocks, more than 64
blocks a block-row) keep the first design, the Blocked-ELL skeleton.

Each kernel has a plain PyTorch version beside it; on CPU tensors the
wrapper runs it, on CUDA tensors it launches the kernel or raises.
``spmm_bsr`` is differentiable in the stored blocks and in ``X``, with the
JAX VJP's math (``_bsr_bwd``) in plain torch: block-granular products,
padding slots' block gradients zeroed, no gradient for the index fields.
The panel cache keys on the container: a container whose ``data`` is
changed in place keeps its old panels (``dataclasses.replace`` makes a new
container, and a new pack).
"""
from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.base import (cached_on, sparse_container, static_field,
                            values_version)
from ..formats.bsr import BSR
from . import _build
from ._walk import sms

__all__ = ["BSRPanels", "PanelPlan", "TilePlan", "pack_bsr_panels",
           "panel_counts", "panel_plan", "tile_plan", "tile_plan_plain",
           "grouped_design",
           "spmm_bsr",
           "spmm_bsr_grouped_reference", "spmm_bsr_panel_reference",
           "small_blocks", "takes_kernel"]

_GROUPED_ARGTYPES = (
    ctypes.c_void_p,  # indptr (nbr+1,) int32
    ctypes.c_void_p,  # indices (cap,) int32
    ctypes.c_void_p,  # data (cap, bm, bn)
    ctypes.c_void_p,  # X (ncols, nrhs) row-major
    ctypes.c_int,  # bf16
    ctypes.c_void_p,  # out (nrows, nrhs)
    ctypes.c_int,  # nrows
    ctypes.c_int,  # ncols
    ctypes.c_int,  # nbr
    ctypes.c_int,  # bm
    ctypes.c_int,  # bn
    ctypes.c_int,  # nrhs
    ctypes.c_void_p,  # stream
)
_TILE_ARGTYPES = (
    ctypes.c_void_p,  # indices (cap,) int32
    ctypes.c_void_p,  # data (cap, bm, bn)
    ctypes.c_void_p,  # X (ncols, nrhs) row-major
    ctypes.c_int,  # bf16
    ctypes.c_void_p,  # out (nrows, nrhs)
    ctypes.c_void_p,  # scratch (n_partials, TR, TC) fp32
    ctypes.c_void_p,  # items (n_items, 8) int32
    ctypes.c_void_p,  # block_ptr (grid + 1,) int32: each block's items
    ctypes.c_int,  # grid
    ctypes.c_void_p,  # sums (n_sums, 8) int32
    ctypes.c_int,  # n_sums
    ctypes.c_int,  # nrows
    ctypes.c_int,  # ncols
    ctypes.c_int,  # bm
    ctypes.c_int,  # bn
    ctypes.c_int,  # nrhs
    ctypes.c_int,  # TR: rows a tile
    ctypes.c_int,  # TC: columns a tile
    ctypes.c_int,  # ring: TILE_RINGS
    ctypes.c_void_p,  # stream
)
_PANEL_ARGTYPES = (
    ctypes.c_void_p,  # bcols (nbr, M) int32
    ctypes.c_void_p,  # counts (nbr,) int32: the slots walked a block-row
    ctypes.c_void_p,  # panels (nbr, bm, M*bn)
    ctypes.c_void_p,  # X (ncols, nrhs) row-major
    ctypes.c_int,  # bf16
    ctypes.c_void_p,  # out (nrows, nrhs)
    ctypes.c_int,  # nrows
    ctypes.c_int,  # ncols
    ctypes.c_int,  # nbr
    ctypes.c_int,  # M
    ctypes.c_int,  # bm
    ctypes.c_int,  # bn
    ctypes.c_int,  # nrhs
    ctypes.c_int,  # design: 1 narrow, 2 wide
    ctypes.c_int,  # V: columns a thread or lane
    ctypes.c_int,  # RT: rows a wide item
    ctypes.c_int,  # SC: slots a wide stage
    ctypes.c_void_p,  # stream
)

# blocks of bm·bn below this are small: the panel layout serves them where
# their width is a multiple of 8 and a block-row holds at most
# _PANEL_MAX_M blocks
_SMALL_BLOCK = 4096
_PANEL_MAX_M = 64


def small_blocks(A: BSR) -> bool:
    """Whether ``A``'s blocks are small (bm·bn < 4096), the JAX package's
    one threshold for the panel layout, ``spmm``'s densify route and
    ``spmv``'s CSR route."""
    bm, bn = A.block_shape
    return bm * bn < _SMALL_BLOCK


@sparse_container
@dataclasses.dataclass(frozen=True)
class BSRPanels:
    panels: torch.Tensor  # (nbr, bm, M*bn)
    bcols: torch.Tensor  # (nbr, M) int32; padding slots point at block-column 0
    shape: Tuple[int, int] = static_field()
    block_shape: Tuple[int, int] = static_field()
    nnz: int = static_field()


def pack_bsr_panels(A: BSR) -> BSRPanels:
    """The panel layout of ``A`` (a host-side encode, on ``A``'s device):
    block-row i's stored blocks side by side, padding slots zero at
    block-column 0."""
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    indptr = A.indptr.cpu().numpy().astype(np.int64)
    counts = np.diff(indptr)
    n_real = int(indptr[-1])  # padding slots past the real blocks are left out
    M = max(int(counts.max()) if nbr else 1, 1)
    brow = np.repeat(np.arange(nbr), counts)
    slot = np.arange(n_real) - indptr[brow]
    # the block values move on A's device (bf16 included), outside any
    # autograd graph; the index math is numpy
    dev = A.data.device
    brow_t = torch.from_numpy(brow).to(dev)
    slot_t = torch.from_numpy(slot).to(dev)
    p4 = torch.zeros((nbr, M, bm, bn), dtype=A.data.dtype, device=dev)
    p4[brow_t, slot_t] = A.data.detach()[:n_real]
    bcols = np.zeros((nbr, M), np.int32)
    bcols[brow, slot] = A.indices[:n_real].cpu().numpy()
    return BSRPanels(
        panels=p4.permute(0, 2, 1, 3).reshape(nbr, bm, M * bn).contiguous(),
        bcols=torch.from_numpy(bcols).to(dev),
        shape=A.shape,
        block_shape=(bm, bn),
        nnz=A.nnz,
    )


_PANEL_CACHE: dict = {}


def _panels_for(A: BSR) -> BSRPanels:
    """``pack_bsr_panels(A)``, packed once per container (the entry leaves
    with it)."""
    return cached_on(_PANEL_CACHE, A, pack_bsr_panels)


def _acc_types(data_dtype, x_dtype):
    """(result type, accumulation type): bf16 operands are summed in fp32
    and rounded once, as the kernels do."""
    dt = torch.promote_types(data_dtype, x_dtype)
    return dt, torch.promote_types(dt, torch.float32)


def _x_blocks(X: torch.Tensor, bn: int, nbc: int, dtype) -> torch.Tensor:
    """X zero-padded to whole row-blocks: (nbc, bn, k)."""
    Xp = torch.zeros((nbc * bn, X.shape[1]), dtype=dtype, device=X.device)
    Xp[: X.shape[0]] = X
    return Xp.reshape(nbc, bn, X.shape[1])


def spmm_bsr_grouped_reference(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped kernel (twin of ``_spmm_bsr_jnp``): the
    X row-block of every stored block, one batched product, summed into
    the block-rows; padding slots fall into a spare block-row."""
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    nbc = -(-A.shape[1] // bn)
    dt, acc_dt = _acc_types(A.data.dtype, X.dtype)
    gathered = _x_blocks(X, bn, nbc, acc_dt)[A.indices.long()]  # (cap, bn, k)
    prod = torch.einsum("cij,cjk->cik", A.data.to(acc_dt), gathered)
    brow = A._block_row_ids_or_compute().long()
    acc = torch.zeros((nbr + 1, bm, X.shape[1]), dtype=acc_dt, device=X.device)
    acc.index_add_(0, brow, prod)
    return acc[:nbr].reshape(nbr * bm, X.shape[1])[: A.shape[0]].to(dt)


def spmm_bsr_panel_reference(P: BSRPanels, X: torch.Tensor) -> torch.Tensor:
    """Plain version of the panel kernel: the M X row-blocks of each
    block-row stacked, one batched product a block-row."""
    bm, bn = P.block_shape
    nbr, M = P.bcols.shape
    nbc = -(-P.shape[1] // bn)
    dt, acc_dt = _acc_types(P.panels.dtype, X.dtype)
    stacked = _x_blocks(X, bn, nbc, acc_dt)[P.bcols.long()].reshape(
        nbr, M * bn, X.shape[1])
    acc = torch.bmm(P.panels.to(acc_dt), stacked)  # (nbr, bm, k)
    return acc.reshape(nbr * bm, X.shape[1])[: P.shape[0]].to(dt)


def _check_inputs(name: str, vals: torch.Tensor, index: torch.Tensor,
                  X: torch.Tensor, ncols: int) -> torch.Tensor:
    if not (X.is_cuda and vals.device == X.device and index.device == X.device):
        raise ValueError(f"{name}: the matrix and X must lie on one CUDA device")
    if X.dtype not in (torch.float32, torch.bfloat16) or vals.dtype != X.dtype:
        raise ValueError(f"{name}: blocks and X must both be fp32 or both "
                         f"bf16, not {vals.dtype} and {X.dtype}")
    if index.dtype != torch.int32 or not (index.is_contiguous()
                                          and vals.is_contiguous()):
        raise ValueError(f"{name}: the index arrays must be contiguous int32 "
                         "and the blocks contiguous")
    if X.dim() != 2 or X.shape[0] != ncols:
        raise ValueError(f"{name}: X shape {tuple(X.shape)} does not match "
                         f"{ncols} columns")
    return X.contiguous()


def _launch(name: str, counter: str, argtypes, args, out: torch.Tensor):
    fn = _build.load("spmm_bsr", argtypes, symbol=name)
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    _build.launch_counts[counter] += 1
    return out


# ---------------------------------------------------------------------------
# row 3: the grouped kernel's designs
# ---------------------------------------------------------------------------

GROUPED_DESIGNS = ("tile", "skeleton")
_TILE_MIN_BM = 32
_TILE_ITEMS_PER_SM = 4  # the plan's target: items an SM
# the tile kernel's cp.async rings (csrc/spmm_bsr.cu tile::ring_of), as
# (chunk depth, stages): 0 (16, 3), the only ring of the 32- and 64-row
# tiles; the 128-row tiles also 1 (32, 3), 2 (16, 4) and 3 (32, 4), their
# default (0.218 against ring 0's 0.234 ms at (128, 128), PERF.md §6)
TILE_RINGS = (0, 1, 2, 3)


def tile_rings(TR: int):
    """The rings of a tile of TR rows, its default first."""
    return (3, 0, 1, 2) if TR == 128 else (0,)
_TILE_GRIDS: dict = {}


def _tile_grid(TR: int, TC: int, dtype, ring: int, dev) -> int:
    """The tile kernel's blocks that the card holds at once (asked of the
    card once: ``spmm_bsr_tile_blocks``, whose bounds put one 128 x 128
    tile an SM and two of the others); on the CPU one an SM."""
    if dev.type != "cuda":
        return sms(dev)
    key = (dev.index, TR, TC, dtype, ring)
    if key not in _TILE_GRIDS:
        fn = _build.load("spmm_bsr", (ctypes.c_int,) * 4,
                         "spmm_bsr_tile_blocks")
        with torch.cuda.device(dev):
            n = fn(TR, TC, int(dtype == torch.bfloat16), ring)
        if n <= 0:
            raise RuntimeError("spmm_bsr: the card's occupancy query failed "
                               f"for the {TR} x {TC} tile, ring {ring}")
        _TILE_GRIDS[key] = n
    return _TILE_GRIDS[key]


def grouped_design(A: BSR) -> str:
    """The grouped kernel's design for ``A``: ``"tile"`` for large blocks
    of at least 32 rows (bm·bn >= 4096, the ones ``spmm`` sends it), else
    ``"skeleton"`` (the first design, kept for the by-name calls on small
    or narrow blocks)."""
    bm, _ = A.block_shape
    return ("tile" if not small_blocks(A) and bm >= _TILE_MIN_BM
            else "skeleton")


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tile design's launch for ``k`` columns of X.  Tiles of ``TR``
    rows of a block-row by ``TC`` columns of Y; each block-row's slot list
    cut into chunks of at most ``split`` blocks, as equal as they come.
    ``items`` (n_items, 8) int32: (block-row, row0, col0, first slot, end
    slot, partial tile or -1, 0, 0); an item of a block-row of one chunk
    writes Y (-1), the others write their partial tile.  Block b of the
    ``grid`` walks items ``block_ptr[b]`` .. ``block_ptr[b+1]``: the items,
    largest first, each given to the block with the least work so far
    (``grid``: at most the blocks of the kernel's ``ring`` that the card
    holds at once, ``_tile_grid``).  ``sums`` (n_sums, 8) int32:
    (block-row, row0, col0, first partial tile, partials, 0, 0, 0) of
    every tile of a block-row of several chunks or none (an empty
    block-row: zeros), its partials in chunk order."""

    TR: int
    TC: int
    split: int
    ring: int
    items: torch.Tensor
    sums: torch.Tensor
    n_partials: int
    block_ptr: torch.Tensor
    grid: int


def _tile_rows(A: BSR) -> int:
    return next(t for t in (32, 64, 128) if t >= min(A.block_shape[0], 128))


def _tile_plan_build(A: BSR, k: int, split: int, TC: int, ring: int,
                     n_sms: int, grid_cap: int) -> TilePlan:
    bm, _ = A.block_shape
    nbr = A.num_block_rows
    TR = _tile_rows(A)
    rts = np.arange(0, bm, TR)
    cts = np.arange(0, k, TC)
    indptr = A.indptr.cpu().numpy().astype(np.int64)
    cnt = np.diff(indptr)
    tiles = len(rts) * len(cts)
    if not split:
        # about _TILE_ITEMS_PER_SM items an SM over the whole product
        split = max(1, -(-int(cnt.sum()) * tiles
                          // (_TILE_ITEMS_PER_SM * n_sms)))
    parts = -(-cnt // split)  # chunks a block-row (0: empty)
    items, sums = [], []
    n_partials = 0
    for i in np.flatnonzero(parts != 1):  # partial tiles, then the sums
        p = int(parts[i])
        for r0 in rts:
            for c0 in cts:
                sums.append((i, r0, c0, n_partials, p, 0, 0, 0))
                for j in range(p):
                    a = indptr[i] + (cnt[i] * j) // p
                    b = indptr[i] + (cnt[i] * (j + 1)) // p
                    items.append((i, r0, c0, a, b, n_partials + j, 0, 0))
                n_partials += p
    for i in np.flatnonzero(parts == 1):
        for r0 in rts:
            for c0 in cts:
                items.append((i, r0, c0, indptr[i], indptr[i + 1], -1, 0, 0))
    items = np.array(items, np.int64).reshape(-1, 8)
    items = items[np.argsort(items[:, 3] - items[:, 4], kind="stable")]
    grid = min(len(items), grid_cap)
    # largest first, each item to the block with the least work so far
    heap = [(0, b) for b in range(grid)]
    owner = np.empty(len(items), np.int64)
    for n, size in enumerate(items[:, 4] - items[:, 3]):
        load, b = heapq.heappop(heap)
        owner[n] = b
        heapq.heappush(heap, (load + int(size), b))
    order = np.argsort(owner, kind="stable")
    items = items[order]
    block_ptr = np.searchsorted(owner[order], np.arange(grid + 1))
    sums = np.array(sums, np.int64).reshape(-1, 8)
    dev = A.data.device
    return TilePlan(
        TR=TR, TC=TC, split=split, ring=ring,
        items=torch.from_numpy(items.astype(np.int32)).to(dev),
        sums=torch.from_numpy(sums.astype(np.int32)).to(dev),
        n_partials=n_partials,
        block_ptr=torch.from_numpy(block_ptr.astype(np.int32)).to(dev),
        grid=grid)


_TILE_PLANS: dict = {}


def tile_plan(A: BSR, k: int, split: int = 0, ring: Optional[int] = None,
              tc: int = 0) -> TilePlan:
    """The tile design's plan of ``A`` for ``k`` columns of X, ``split``
    the most blocks a chunk (0: the rule, about 4 items an SM), ``tc`` the
    columns a tile (0: the rule, 64 up to k = 64, else 128; 64 or 128 for
    measurements), ``ring`` the kernel's (None: the tile's default,
    ``tile_rings``; the ring sets the grid); built once a container,
    state of its block index (``values_version`` of ``indptr``), k's
    tiles, split, ring and tile width."""
    rings = tile_rings(_tile_rows(A))
    ring = rings[0] if ring is None else ring
    if tc not in (0, 64, 128) or ring not in rings:
        raise ValueError(f"spmm_bsr: tc must be 0, 64 or 128 and ring one "
                         f"of {rings}, not {tc}, {ring}")
    plans = cached_on(_TILE_PLANS, A, lambda _: {},
                      values_version(A.indptr))
    dev = A.data.device
    TC = tc or (64 if k <= 64 else 128)
    grid_cap = _tile_grid(_tile_rows(A), TC, A.data.dtype, ring, dev)
    key = (TC, -(-k // TC), split, ring, sms(dev), grid_cap)
    if key not in plans:
        plans[key] = _tile_plan_build(A, k, split, TC, ring, sms(dev),
                                      grid_cap)
    return plans[key]


def tile_plan_plain(A: BSR, X: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """The tile design's result read off its plan on any device: each
    item's blocks times their X row-blocks summed in slot order into its
    tile (Y, or its partial tile), then each sum's partials added in chunk
    order; fp32 sums, Y in X's type.  Equal to
    ``spmm_bsr_grouped_reference`` up to the order of the fp32 sums."""
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    k = X.shape[1]
    TR, TC = plan.TR, plan.TC
    nbc = -(-A.shape[1] // bn)
    Xb = _x_blocks(X, bn, nbc, torch.float32)
    rows = -(-bm // TR) * TR
    Y = torch.zeros((nbr, rows, -(-k // TC) * TC), dtype=torch.float32,
                    device=X.device)
    parts = torch.zeros((max(plan.n_partials, 1), TR, TC),
                        dtype=torch.float32, device=X.device)
    data = A.data.float()
    for i, r0, c0, a, b, dst, _, _ in plan.items.cpu().tolist():
        tile = torch.zeros((TR, TC), dtype=torch.float32, device=X.device)
        for s in range(a, b):
            blk = torch.zeros((TR, bn), dtype=torch.float32, device=X.device)
            blk[: min(TR, bm - r0)] = data[s, r0: r0 + TR]
            xs = torch.zeros((bn, TC), dtype=torch.float32, device=X.device)
            xc = Xb[int(A.indices[s])][:, c0: c0 + TC]
            xs[:, : xc.shape[1]] = xc
            tile += blk @ xs
        if dst < 0:
            Y[i, r0: r0 + TR, c0: c0 + TC] = tile
        else:
            parts[dst] = tile
    for i, r0, c0, base, p, _, _, _ in plan.sums.cpu().tolist():
        tile = torch.zeros((TR, TC), dtype=torch.float32, device=X.device)
        for j in range(p):
            tile += parts[base + j]
        Y[i, r0: r0 + TR, c0: c0 + TC] = tile
    Y = Y[:, :bm, :k].reshape(nbr * bm, k)[: A.shape[0]]
    return Y.to(_acc_types(A.data.dtype, X.dtype)[0])


def _spmm_bsr_cuda(A: BSR, X: torch.Tensor, *, design: str = "",
                   split: int = 0, ring: Optional[int] = None,
                   tc: int = 0, parts: int = 0) -> torch.Tensor:
    """The grouped kernel (row 3) in ``grouped_design(A)``'s design;
    ``design`` ("tile" or "skeleton"), ``split``, ``tc`` (``tile_plan``'s)
    and ``ring`` (``TILE_RINGS``) are forced for measurements and tests;
    ``parts`` 1 (the tiles alone, no sum of the partials) or 2 (the sums
    alone) is an ablation whose result is not the product."""
    X = _check_inputs("spmm_bsr", A.data, A.indices, X, A.shape[1])
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    if (A.indptr.dtype != torch.int32 or A.indptr.device != X.device
            or A.data.shape != (A.block_capacity, bm, bn) or nbr * bm < A.shape[0]):
        raise ValueError(f"spmm_bsr: indptr {A.indptr.dtype} or blocks "
                         f"{tuple(A.data.shape)} do not match block shape "
                         f"{A.block_shape} and matrix {A.shape}")
    if design not in ("",) + GROUPED_DESIGNS or parts not in (0, 1, 2):
        raise ValueError(f"spmm_bsr: design must be one of "
                         f"{GROUPED_DESIGNS} and parts 0-2, not {design!r}, "
                         f"{parts}")
    out = torch.empty((A.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    if (design or grouped_design(A)) == "skeleton":
        return _launch("spmm_bsr", "spmm_bsr", _GROUPED_ARGTYPES, (
            A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(),
            X.data_ptr(), int(X.dtype == torch.bfloat16), out.data_ptr(),
            A.shape[0], A.shape[1], nbr, bm, bn, X.shape[1]), out)
    plan = tile_plan(A, X.shape[1], split, ring, tc)
    scratch = torch.empty((max(plan.n_partials, 1), plan.TR, plan.TC),
                          dtype=torch.float32, device=X.device)
    return _launch("spmm_bsr_tile", "spmm_bsr", _TILE_ARGTYPES, (
        A.indices.data_ptr(), A.data.data_ptr(), X.data_ptr(),
        int(X.dtype == torch.bfloat16), out.data_ptr(), scratch.data_ptr(),
        plan.items.data_ptr(), plan.block_ptr.data_ptr(),
        0 if parts == 2 else plan.grid, plan.sums.data_ptr(),
        0 if parts == 1 else plan.sums.shape[0], A.shape[0], A.shape[1],
        bm, bn, X.shape[1], plan.TR, plan.TC, plan.ring), out)


# the panel kernel's designs (csrc/spmm_bsr.cu): a thread a (row, column
# vector) with no shared memory, or warps that stage block-row panels and
# spend each gathered X row on several rows
DESIGNS = {"narrow": 1, "wide": 2}
_NARROW_MAX_K = 32
_STAGE_ELEMS = 1024  # panel values a wide stage: about 4 KB of fp32


def _counts_build(P: BSRPanels) -> torch.Tensor:
    bm, bn = P.block_shape
    nbr, M = P.bcols.shape
    nz = (P.panels.reshape(nbr, bm, M, bn) != 0).any(3).any(1)  # (nbr, M)
    slot = torch.arange(1, M + 1, device=nz.device)
    return torch.where(nz, slot, 0).amax(1).to(torch.int32).contiguous()


_COUNTS: dict = {}


def panel_counts(P: BSRPanels) -> torch.Tensor:
    """(nbr,) int32: the slots the panel kernel walks in each block-row,
    up to its last slot that holds a nonzero value (the slots past it are
    padding or zero blocks and add 0); built once a pack and state of its
    panels (``values_version``).  An inf or NaN of X under a slot past it
    gives 0 on the card, where the plain version gives NaN."""
    return cached_on(_COUNTS, P, _counts_build, values_version(P.panels))


@dataclasses.dataclass(frozen=True)
class PanelPlan:
    """A launch of the panel kernel.  ``narrow``: thread t computes row
    t // (k / V) of Y at columns V·(t % (k / V)) .. + V.  ``wide``: item
    it = (i·RC + rc)·P + p, with RC = ceil(bm / RT) and P = ceil(k / 32V),
    is block-row i's rows RT·rc .. + RT at columns 32V·p .. + 32V (lane j
    the V at 32V·p + V·j), its M slots walked in stages of SC; warp w of a
    persistent grid takes items w, w + warps, ...  Rows at or past bm or
    nrows and columns at or past k are computed by no one."""

    design: str
    V: int
    RT: int = 1
    SC: int = 0

    def items(self, nbr: int, bm: int, k: int) -> int:
        """Threads (narrow, over nbr·bm rows) or warp items (wide)."""
        if self.design == "narrow":
            return nbr * bm * (k // self.V)
        return nbr * -(-bm // self.RT) * -(-k // (32 * self.V))


def _widest(k: int, widths) -> int:
    return next(v for v in widths if k % v == 0)


def panel_plan(P: BSRPanels, k: int, design: str = "") -> PanelPlan:
    """The panel kernel's launch for ``k`` right-hand sides.  ``design``
    "" takes the rule: ``"wide"`` where k >= 32 and bn % 8 == 0 (each X
    row gathered once for up to 8 rows of Y), else ``"narrow"`` (no lane
    idle at block CG's k = 8).  Narrow: V the widest 16-byte vector that
    divides k.  Wide: V the widest of 4, 2, 1 that divides k, leaves no
    lane idle (V <= k / 32) and still gives 2 warp items an SM (the bench's
    (8, 8) BSR, 256 block-rows, takes V = 2 at k = 128), else 1; RT the
    rows an item, 8 or the power of two at or above bm; SC the slots a
    stage of about 1024 values."""
    bm, bn = P.block_shape
    nbr, M = P.bcols.shape
    if not design:
        design = "wide" if k >= _NARROW_MAX_K and bn % 8 == 0 else "narrow"
    if design not in DESIGNS or (design == "wide" and bn % 8):
        raise ValueError(f"spmm_bsr_panel: design must be one of "
                         f"{sorted(DESIGNS)} (wide: bn % 8 == 0), not "
                         f"{design!r} at block shape {P.block_shape}")
    if design == "narrow":
        vmax = 16 // P.panels.element_size()
        return PanelPlan("narrow", _widest(k, (vmax, 4, 2, 1)))
    rt = next(r for r in (1, 2, 4, 8) if r >= min(bm, 8))
    sc = int(np.clip(_STAGE_ELEMS // (rt * bn), 1, M))
    n_sms = sms(P.panels.device)
    v = next(v for v in (4, 2, 1) if v == 1 or (
        k % v == 0 and v <= k // 32
        and PanelPlan("wide", v, rt, sc).items(nbr, bm, k) >= 2 * n_sms))
    return PanelPlan("wide", v, rt, sc)


def _spmm_bsr_panel_cuda(P: BSRPanels, X: torch.Tensor, *,
                         design: str = "", vec: int = 0) -> torch.Tensor:
    """The panel kernel (row 4) at ``panel_plan(P, k, design)``;
    ``design`` ("narrow" or "wide") and ``vec`` (the plan's V, which must
    divide k; 0 the plan's own) are forced for measurements only."""
    X = _check_inputs("spmm_bsr_panel", P.panels, P.bcols, X, P.shape[1])
    bm, bn = P.block_shape
    nbr, M = P.bcols.shape
    if (P.panels.shape != (nbr, bm, M * bn) or nbr * bm < P.shape[0]
            or M < 1 or P.panels.data_ptr() % 16):
        raise ValueError(f"spmm_bsr_panel: panels {tuple(P.panels.shape)} do "
                         f"not match bcols {tuple(P.bcols.shape)}, block "
                         f"shape {P.block_shape} and matrix {P.shape}, or "
                         "are not 16-byte aligned")
    if X.data_ptr() % 16:
        X = X.clone()  # a fresh allocation: the kernel reads 16-byte vectors
    plan = panel_plan(P, X.shape[1], design)
    if vec:
        plan = dataclasses.replace(plan, V=vec)
    out = torch.empty((P.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    counts = panel_counts(P)
    return _launch("spmm_bsr_panel", "spmm_bsr_panel", _PANEL_ARGTYPES, (
        P.bcols.data_ptr(), counts.data_ptr(), P.panels.data_ptr(),
        X.data_ptr(),
        int(X.dtype == torch.bfloat16), out.data_ptr(), P.shape[0],
        P.shape[1], nbr, M, bm, bn, X.shape[1], DESIGNS[plan.design],
        plan.V, plan.RT, plan.SC), out)


def panel_route(A: BSR):
    """The panels ``spmm_bsr`` multiplies ``A`` with, or None where it
    takes the grouped layout (the JAX wrapper's rule)."""
    if A.block_shape[1] % 8 != 0 or not small_blocks(A):
        return None
    packed = _panels_for(A)
    return packed if packed.bcols.shape[1] <= _PANEL_MAX_M else None


def takes_kernel(A: BSR) -> bool:
    """Whether ``spmm`` sends ``A`` to ``spmm_bsr`` (the JAX package's
    ``bsr_dispatch``): large blocks (the grouped kernel) or a BSR the
    panel layout serves; any other BSR takes the plain block product."""
    return not small_blocks(A) or panel_route(A) is not None


def _spmm_bsr_forward(A: BSR, X: torch.Tensor) -> torch.Tensor:
    on_cpu = X.device.type == "cpu" and A.data.device.type == "cpu"
    packed = panel_route(A)
    if packed is not None:
        if on_cpu:
            return spmm_bsr_panel_reference(packed, X)
        return _spmm_bsr_panel_cuda(packed, X)
    if on_cpu:
        return spmm_bsr_grouped_reference(A, X)
    return _spmm_bsr_cuda(A, X)


class _SpmmBsr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, data, X):
        # ``data`` is passed so autograd tracks it; the kernels read the
        # container, so it must be the container's own tensor
        if data is not A.data:
            raise ValueError("spmm_bsr: data must be A.data")
        ctx.A = A
        ctx.save_for_backward(X)
        return _spmm_bsr_forward(A, X)

    @staticmethod
    def backward(ctx, g):
        A = ctx.A
        (X,) = ctx.saved_tensors
        bm, bn = A.block_shape
        nbr = A.num_block_rows
        nbc = -(-A.shape[1] // bn)
        k = X.shape[1]
        gp = torch.zeros((nbr * bm, k), dtype=g.dtype, device=g.device)
        gp[: g.shape[0]] = g
        brow = A._block_row_ids_or_compute().long()
        # padding slots clamp to the last block-row; their zero blocks kill
        # the X term, and their block gradients are zeroed below
        g_blk = gp.reshape(nbr, bm, k)[brow.clamp(max=nbr - 1)]  # (cap, bm, k)
        cols = A.indices.long()
        dX = ddata = None
        if ctx.needs_input_grad[2]:
            contrib = torch.einsum("cij,cik->cjk", A.data.to(g.dtype), g_blk)
            dXp = torch.zeros((nbc, bn, k), dtype=X.dtype, device=X.device)
            dXp.index_add_(0, cols, contrib.to(X.dtype))
            dX = dXp.reshape(nbc * bn, k)[: A.shape[1]]
        if ctx.needs_input_grad[1]:
            Xt = _x_blocks(X, bn, nbc, g.dtype)[cols]  # (cap, bn, k)
            ddata = torch.einsum("cik,cjk->cij", g_blk, Xt)
            pad = (brow >= nbr)[:, None, None]
            ddata = torch.where(pad, torch.zeros((), dtype=ddata.dtype,
                                                 device=ddata.device), ddata)
            ddata = ddata.to(A.data.dtype)
        return None, ddata, dX


def spmm_bsr(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` through the BSR kernels; Y has X's type.  For the
    gradient in the blocks, give ``A`` a ``data`` that requires it
    (``dataclasses.replace(A, data=A.data.clone().requires_grad_())``)."""
    return _SpmmBsr.apply(A, A.data, X)
