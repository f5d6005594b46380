"""Row-lane SpMM: ``Y = A @ X`` over a ``SellRowLane`` pack and
``csrc/spmm_rowlane.cu``.

Twin of ``sparsematrix_tpu/kernels/spmm_rowlane.py``: the slabs of the
row-lane SpMV (``spmv_rowlane.py``) applied to k dense RHS columns, one
pack serving both.  For a pack with ``lanes_per_row == 1``, group g, its
tile t = ``group_tile[g]``, slab b of the group, w = ``slab_win[g, b]``,
sublane u and lane l:

    Y[t*128 + l, j] += vals[g, b*8+u, l] * X[w*1024 + u*128 + s_idx[g, b*8+u, l], j]

Y is fp32 whatever X's type (fp32 or bf16), cut to ``rows``; a tile no
group touches is zero.  The JAX wrapper refuses a pack of several lanes a
row and a pack with a spill tail, and so does this one.  It has no custom
VJP, so neither has this one.

``spmm_rowlane(packed, X)`` runs ``spmm_rowlane_reference`` when the pack
and X lie on the CPU, and otherwise launches the kernel or raises.  Both
multiply and add in fp32 (the Pallas body multiplies in the operands'
type, so with bf16 values and bf16 X its products round to bf16 first).

The kernel walks ``rowlane_mm_walk`` (``csrc/spmm_rowlane.cu``
``spmm_rowlane_window``): the pack's slabs that hold a value listed window
by window and tile by tile and cut into about one block an SM, each block
staging its window's rows of X in shared memory.  The first design, the
gather walk (``spmm_rowlane``: each kept slot's X row read from L2), is
kept only as a measurement variant (``design="gather"`` and its ablations
``parts``).  Neither reads an X row under a zero value, so an inf or NaN
of X there gives 0 on the card, where the plain version gives NaN
(ROADMAP, deliberate differences).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..formats.base import cached_on, values_version
from . import _build
from ._walk import sms, window_cut
from .spmv_rowlane import _LANES, _W, SellRowLane

__all__ = ["spmm_rowlane", "spmm_rowlane_reference", "rowlane_mm_walk",
           "rowlane_mm_walk_plain"]

# gathered X elements a step of the plain walk (its (n, 8, 128, k)
# temporary): 64 MB of fp32
_PLAIN_ELEMS = 1 << 24


def _check(packed: SellRowLane, X: torch.Tensor) -> None:
    if packed.lanes_per_row != 1:
        raise ValueError("spmm_rowlane requires a lanes_per_row=1 pack")
    if packed.spill is not None and packed.spill.nnz:
        raise ValueError("spmm_rowlane does not support spilled packs")
    if packed.vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm_rowlane: values must be fp32 or bf16, not "
                         f"{packed.vals.dtype}")
    cols = packed.shape[1]
    if (X.dim() != 2 or X.shape[0] != cols
            or X.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"spmm_rowlane: X must be an fp32 or bf16 matrix "
                         f"of {cols} rows, not {X.dtype} {tuple(X.shape)}")


def spmm_rowlane_reference(packed: SellRowLane,
                           X: torch.Tensor) -> torch.Tensor:
    """Plain version of ``Y = A @ X``: per slab the gathered X rows times
    the values, summed over sublanes, added into the slab's tile; fp32
    products, sums and result."""
    _check(packed, X)
    rows, cols = packed.shape
    k = X.shape[1]
    dev = X.device
    Xp = torch.zeros((packed.n_win * _W, k), dtype=torch.float32, device=dev)
    Xp[:cols] = X
    si = packed.s_idx.reshape(-1, 8, _LANES).long() & 127
    vv = packed.vals.reshape(-1, 8, _LANES)
    base = (packed.slab_win.reshape(-1).long()[:, None, None] * _W
            + torch.arange(8, device=dev)[None, :, None] * _LANES)
    tiles = packed.group_tile.long().repeat_interleave(packed.group).clamp(
        max=packed.n_tiles)  # a spare tile for strays
    out = torch.zeros((packed.n_tiles + 1, _LANES, k), dtype=torch.float32,
                      device=dev)
    step = max(1, _PLAIN_ELEMS // (8 * _LANES * k))
    for s0 in range(0, si.shape[0], step):
        sl = slice(s0, s0 + step)
        g = Xp[base[sl] + si[sl]]  # (n, 8, 128, k)
        part = (vv[sl].float()[..., None] * g).sum(dim=1)  # (n, 128, k)
        out.index_add_(0, tiles[sl], part)
    return out[: packed.n_tiles].reshape(-1, k)[:rows]


# ---------------------------------------------------------------------------
# the window walk's plan
# ---------------------------------------------------------------------------

DESIGNS = ("window", "gather")  # the product, the measurement variant
_TEAMS = 4  # teams of four warps a window-walk block
_ITEM_CHUNK = 8192  # items a step of rowlane_mm_walk_plain


@dataclasses.dataclass(frozen=True)
class RowlaneMmWalk:
    """The window walk of a pack: ``items`` (n_items, 4) int32, (slab,
    tile, window, 0) of every slab that holds a nonzero value, each slab
    once, ordered by window, then tile, then slab; ``part_ptr``
    (n_blocks · teams + 1,) int32, the items of block b's team q at part
    b·teams + q, every block's items inside one window, about one block
    an SM shared among the windows by their slabs; ``nnz`` the nonzero
    values of the pack."""

    items: torch.Tensor
    part_ptr: torch.Tensor
    n_blocks: int
    teams: int
    nnz: int


def _walk_build(packed: SellRowLane) -> RowlaneMmWalk:
    n = packed.n_slabs
    nz = packed.vals.reshape(n, -1) != 0
    held = nz.any(1)
    s = torch.nonzero(held).flatten()
    tile = packed.group_tile.long().repeat_interleave(packed.group)[s]
    win = packed.slab_win.reshape(-1)[s].long()
    s, tile, win = (t.cpu().numpy().astype(np.int64) for t in (s, tile, win))
    items, part_ptr, n_blocks = window_cut(s, tile, win, _TEAMS,
                                           sms(packed.vals.device))
    dev = packed.vals.device
    return RowlaneMmWalk(items=torch.from_numpy(items).to(dev),
                         part_ptr=torch.from_numpy(part_ptr).to(dev),
                         n_blocks=n_blocks, teams=_TEAMS,
                         nnz=int(nz.sum()))


_WALKS: dict = {}


def rowlane_mm_walk(packed: SellRowLane) -> RowlaneMmWalk:
    """The pack's window walk, built once a pack and state of its values
    (``values_version``: an in-place write into ``vals`` builds it
    anew)."""
    return cached_on(_WALKS, packed, _walk_build,
                     values_version(packed.vals))


def rowlane_mm_walk_plain(packed: SellRowLane,
                          X: torch.Tensor) -> torch.Tensor:
    """The window walk's sum read off its items on any device: each item's
    slots times X's rows of the item's window, added into the item's tile.
    Equal to ``spmm_rowlane_reference`` wherever X is finite."""
    _check(packed, X)
    walk = rowlane_mm_walk(packed)
    rows, cols = packed.shape
    k = X.shape[1]
    dev = X.device
    s, tile, win, _ = walk.items.to(dev).long().T
    Xp = torch.zeros((packed.n_win * _W, k), dtype=torch.float32, device=dev)
    Xp[:cols] = X
    y = torch.zeros((packed.n_tiles * _LANES, k), dtype=torch.float32,
                    device=dev)
    si_all = packed.s_idx.reshape(-1, 8, _LANES)
    v_all = packed.vals.reshape(-1, 8, _LANES)
    sub = torch.arange(8, device=dev)[None, :, None] * _LANES
    lane = torch.arange(_LANES, device=dev)
    for i0 in range(0, len(s), _ITEM_CHUNK):
        sl = slice(i0, i0 + _ITEM_CHUNK)
        si = s[sl]
        col = (win[sl, None, None] * _W + sub
               + (si_all[si].long() & 127))  # (n, 8, 128)
        part = (v_all[si].float()[..., None] * Xp[col]).sum(dim=1)
        row = tile[sl, None] * _LANES + lane  # (n, 128)
        y.index_add_(0, row.reshape(-1), part.reshape(-1, k))
    return y[:rows]


def panel_width(k: int) -> int:
    """Columns of X the window walk stages a pass: 32, or 16 / 8 where k
    is that narrow."""
    return 8 if k <= 8 else 16 if k <= 16 else 32


_ARGTYPES = (
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # group_tile (n_groups,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # X (cols, k) fp32 or bf16
    ctypes.c_void_p,  # Y (rows, k) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # k
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # group
    ctypes.c_int,  # bf16 values
    ctypes.c_int,  # bf16 X
    ctypes.c_int,  # parts: 0 the product, 1-3 an ablation
    ctypes.c_void_p,  # stream
)
_WINDOW_ARGTYPES = (
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # items (n_items, 4) int32
    ctypes.c_void_p,  # part_ptr int32
    ctypes.c_int,  # blocks
    ctypes.c_void_p,  # X (cols, k) fp32 or bf16, 16-byte aligned
    ctypes.c_void_p,  # Y (rows, k) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # k
    ctypes.c_int,  # columns a pass: 8, 16 or 32
    ctypes.c_int,  # bf16 values
    ctypes.c_int,  # bf16 X
    ctypes.c_void_p,  # stream
)


def _spmm_rowlane_cuda(packed: SellRowLane, X: torch.Tensor, *,
                       design: str = "window",
                       parts: int = 0) -> torch.Tensor:
    """The kernel (no plain fallback): raises unless the pack and X are
    contiguous on one CUDA device.  ``design="gather"`` (the first design)
    and ``parts`` (the gather walk's ablations 1-3, whose result is not
    the product; 0 the product) are for measurements only: the product
    takes the window walk."""
    _check(packed, X)
    rows, cols = packed.shape
    planes = (packed.s_idx, packed.vals, packed.group_tile, packed.slab_win)
    if not X.is_cuda or not all(t.device == X.device and t.is_contiguous()
                                for t in planes):
        raise ValueError("spmm_rowlane: the pack and X must lie on one CUDA "
                         "device, the planes contiguous")
    n_groups, group = packed.s_idx.shape[0], packed.group
    if (packed.s_idx.dtype != torch.int8
            or any(t.dtype != torch.int32 for t in planes[2:])
            or packed.s_idx.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.s_idx.shape
            or packed.group_tile.shape != (n_groups,)
            or packed.slab_win.numel() != n_groups * group):
        raise ValueError("spmm_rowlane: inconsistent pack planes")
    if design not in DESIGNS or parts not in (0, 1, 2, 3) or (
            parts and design != "gather"):
        raise ValueError(f"spmm_rowlane: design must be one of {DESIGNS} "
                         f"and parts 0-3 (the gather walk's), not "
                         f"{design!r}, {parts}")
    k = X.shape[1]
    Y = torch.zeros((rows, k), dtype=torch.float32, device=X.device)
    if rows == 0 or cols == 0 or k == 0:
        return Y
    X = X.contiguous()
    if X.data_ptr() % 16:
        X = X.clone()  # a fresh allocation: the window is staged by 16 bytes
    vbf, xbf = (int(packed.vals.dtype == torch.bfloat16),
                int(X.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(X.device).cuda_stream
    if design == "window":
        walk = rowlane_mm_walk(packed)
        if walk.n_blocks == 0:  # no nonzero value
            return Y
        fn = _build.load("spmm_rowlane", _WINDOW_ARGTYPES,
                         "spmm_rowlane_window")
        with torch.cuda.device(X.device):
            err = fn(packed.s_idx.data_ptr(), packed.vals.data_ptr(),
                     walk.items.data_ptr(), walk.part_ptr.data_ptr(),
                     walk.n_blocks, X.data_ptr(), Y.data_ptr(), rows, cols,
                     k, panel_width(k), vbf, xbf, stream)
    else:
        fn = _build.load("spmm_rowlane", _ARGTYPES)
        with torch.cuda.device(X.device):
            err = fn(packed.s_idx.data_ptr(), packed.vals.data_ptr(),
                     packed.group_tile.data_ptr(),
                     packed.slab_win.data_ptr(), X.data_ptr(), Y.data_ptr(),
                     rows, cols, k, packed.n_slabs, group, vbf, xbf, parts,
                     stream)
    if err != 0:
        raise RuntimeError(f"spmm_rowlane: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["spmm_rowlane"] += 1
    return Y


def spmm_rowlane(packed: SellRowLane, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over a row-lane pack; X is (cols, k) dense, Y (rows,
    k) fp32.  Lane l of tile t is row ``t*128 + l``, as in ``spmv``."""
    if X.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmm_rowlane_reference(packed, X)
    return _spmm_rowlane_cuda(packed, X)
