"""Superblock row-lane SpMV: the packer and ``csrc/spmv_superblock.cu``.

Twin of ``sparsematrix_tpu/kernels/spmv_superblock.py``.  The rowlane
layout keys a group to one 128-row tile, so a matrix whose tiles own only
1-2 slabs (clustered SpGEMM pair programs) degenerates to group 1.  This
layout keys a group to a superblock of ``k_tiles`` tiles: each slab names
its tile within the superblock (``slab_tloc``), and slab padding is per
superblock.  Slabs are the rowlane layout's at lanes_per_row 1, so
``pack_superblock`` regroups a group-1 rowlane pack; its planes come out
``np.array_equal`` to the JAX packer's.

``spmv_superblock(packed, x)`` runs ``spmv_superblock_reference`` when
all its inputs lie on the CPU, and otherwise launches the kernel or
raises.  The kernel is the rowlane kernel's warp walk
(``csrc/rowlane.cuh``) with the superblock's tile rule: it walks each
group's slabs only up to its last that holds a nonzero value
(``group_real``), so it never reads the padding slabs at a superblock's
end, and its warps walk ranges of slabs cut at tile starts
(``superblock_walk``), so that each stores its own tiles and y needs no
zero fill; both are built from the planes once a pack and cached.  It is
differentiable in x and in ``vals`` (the JAX wrapper's custom VJP,
``spmv_superblock.py:232-260``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats.base import cached_on, sparse_container, static_field
from ..formats.csr import CSR
from . import _build
from .spmv_rowlane import (_pack_arrays, _pack_arrays_native, _put,
                           group_real, resident_warps, slab_walk_plain,
                           walk_ranges)

__all__ = ["SellSuperblock", "pack_superblock", "spmv_superblock",
           "spmv_superblock_reference"]

_LANES = 128
_W = 1024


@sparse_container
@dataclasses.dataclass(frozen=True)
class SellSuperblock:
    s_idx: torch.Tensor  # (n_groups, group*8, 128) int8
    vals: torch.Tensor  # (n_groups, group*8, 128) fp32 or bf16
    group_super: torch.Tensor  # (n_groups,) int32, ascending
    slab_win: torch.Tensor  # (n_groups*group,) int32
    slab_tloc: torch.Tensor  # (n_groups*group,) int32: tile % k_tiles
    shape: Tuple[int, int] = static_field()
    n_tiles: int = static_field()
    n_super: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    k_tiles: int = static_field()
    nnz: int = static_field()

    @property
    def fill_rate(self) -> float:
        return self.nnz / max(self.vals.numel(), 1)

    @property
    def n_slabs(self) -> int:
        return self.s_idx.shape[0] * self.group


def pack_superblock(csr: CSR, group: int = 16, k_tiles: int = 16,
                    dtype=None, device=None) -> SellSuperblock:
    """Pack a CSR row-lane (lanes_per_row 1) on ``device`` (default: the
    CSR's), regrouped into superblocks of ``k_tiles`` tiles with ``group``
    slabs a group.  ``dtype=torch.bfloat16`` stores the values in bf16."""
    dev = csr.device if device is None else torch.device(device)
    sp = csr.to_scipy().tocoo()
    rows, cols = sp.shape
    r = sp.row.astype(np.int64)
    c = sp.col.astype(np.int64)
    v = sp.data
    arrs = None
    if r.size:
        arrs = _pack_arrays_native(r, c, v, rows, cols, 1, 1)
    if arrs is None:
        arrs = _pack_arrays(r, c, v, rows, cols, 1, 1, v.dtype)
    n_tiles, n_win = arrs["n_tiles"], arrs["n_win"]
    sidx = np.asarray(arrs["s_idx"]).reshape(-1, 8, _LANES)
    vals = np.asarray(arrs["vals"]).reshape(-1, 8, _LANES)
    tiles = np.asarray(arrs["group_tile"]).astype(np.int64)
    wins = np.asarray(arrs["slab_win"]).reshape(-1).astype(np.int64)

    n_super = max(-(-n_tiles // k_tiles), 1)
    sb = tiles // k_tiles  # slabs are tile-major, so superblock-major too
    counts = np.bincount(sb, minlength=n_super)
    padded = -(-counts // group) * group
    offset = np.concatenate([[0], np.cumsum(padded)])
    first = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = offset[sb] + (np.arange(len(sb)) - first[sb])
    total = int(offset[-1])
    n_groups = total // group

    s_idx_a = np.zeros((total, 8, _LANES), np.int8)
    vals_a = np.zeros((total, 8, _LANES), vals.dtype)
    win_a = np.zeros(total, np.int32)
    tloc_a = np.zeros(total, np.int32)
    s_idx_a[slot] = sidx
    vals_a[slot] = vals
    win_a[slot] = wins
    tloc_a[slot] = tiles % k_tiles
    # padding slots keep the window and tile of their superblock's last
    # slab, so every read and write stays in range (their values are 0)
    pad = np.ones(total, bool)
    pad[slot] = False
    if pad.any():
        pad_sb = np.searchsorted(offset[1:], np.nonzero(pad)[0],
                                 side="right")
        last = np.zeros(n_super, np.int64)
        nonempty = counts > 0
        last_idx = first + counts - 1
        last[nonempty] = last_idx[nonempty]
        win_a[pad] = wins[last[pad_sb]] if len(wins) else 0
        tloc_a[pad] = (tiles[last[pad_sb]] % k_tiles) if len(tiles) else 0

    group_super = np.repeat(np.arange(n_super), padded // group)
    vals_t = _put(vals_a.reshape(n_groups, group * 8, _LANES), dev)
    return SellSuperblock(
        s_idx=_put(s_idx_a.reshape(n_groups, group * 8, _LANES), dev),
        vals=vals_t if dtype is None else vals_t.to(dtype),
        group_super=_put(group_super, dev, torch.int32),
        slab_win=_put(win_a, dev),
        slab_tloc=_put(tloc_a, dev),
        shape=(rows, cols),
        n_tiles=n_tiles,
        n_super=n_super,
        n_win=n_win,
        group=group,
        k_tiles=k_tiles,
        nnz=csr.nnz,
    )


def _slab_tiles(packed: SellSuperblock) -> torch.Tensor:
    return (packed.group_super.long().repeat_interleave(packed.group)
            * packed.k_tiles + packed.slab_tloc.long())


def _check(packed: SellSuperblock, x: torch.Tensor) -> None:
    if packed.vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("spmv_superblock: values must be fp32 or bf16, not "
                         f"{packed.vals.dtype}")
    cols = packed.shape[1]
    if x.dtype != torch.float32 or x.shape != (cols,):
        raise ValueError(f"spmv_superblock: x must be an fp32 vector of "
                         f"length {cols}, not {x.dtype} {tuple(x.shape)}")


def spmv_superblock_reference(packed: SellSuperblock,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``y = A @ x`` (fp32 accumulation and result)."""
    _check(packed, x)
    n_rows_sb = packed.n_super * packed.k_tiles
    out = slab_walk_plain(packed.s_idx, packed.vals, packed.slab_win,
                          _slab_tiles(packed), packed.n_win, n_rows_sb, x)
    return out.reshape(-1)[: packed.shape[0]]


_ARGTYPES = (
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # group_super (n_groups,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # slab_tloc (n_slabs,) int32
    ctypes.c_void_p,  # group_real (n_groups,) int32
    ctypes.c_void_p,  # warp_ptr (n_warps+1,) int32
    ctypes.c_void_p,  # x (cols,) fp32
    ctypes.c_void_p,  # y (rows,) fp32, zero in the split tiles
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # group
    ctypes.c_int,  # k_tiles
    ctypes.c_int,  # n_warps
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)
# spmv_superblock_tuned: the mode after the bf16 flag
_TUNED_ARGTYPES = _ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_void_p)


def _walk_build(packed: SellSuperblock, spw: int):
    """The pack's ``walk_ranges`` (``spmv_rowlane.py``) at ``spw`` slabs a
    warp, the slabs past each group's ``group_real`` (a superblock's
    padding slabs among them) counting as skipped."""
    tiles = _slab_tiles(packed).cpu().numpy()
    real = group_real(packed).cpu().numpy()
    slab = np.arange(tiles.size)
    return walk_ranges(tiles, slab % packed.group < real[slab // packed.group],
                       spw, _LANES, packed.shape[0], packed.s_idx.device)


_WALKS: dict = {}


def default_spw(packed: SellSuperblock) -> int:
    """The default slabs a warp: the slabs over the warps the card holds at
    once (one wave), rounded up to whole groups where that at most doubles
    it (at ``spgemm_xl``'s P, group 16: 16 slabs a warp were faster than
    the one wave's 10, and 8, 12, 19 and 32 slower; ``chip_smoke.py``'s
    variant lines)."""
    one = -(-packed.n_slabs // _resident_warps(packed.s_idx.device))
    whole = -(-one // packed.group) * packed.group
    return whole if whole <= 2 * one else one


def _resident_warps(device: torch.device) -> int:
    return resident_warps("spmv_superblock", device)


def superblock_walk(packed: SellSuperblock, spw: int = 0):
    """The pack's ``_walk_build`` at ``spw`` slabs a warp (0:
    ``default_spw``), built once per pack and ``spw``."""
    walks = cached_on(_WALKS, packed, lambda _: {})
    if spw == 0:
        if 0 not in walks:
            walks[0] = default_spw(packed)
        spw = walks[0]
    if spw not in walks:
        walks[spw] = _walk_build(packed, spw)
    return walks[spw]


def _spmv_superblock_cuda(packed: SellSuperblock, x: torch.Tensor, *,
                          spw: int = 0, mode: int = 0) -> torch.Tensor:
    """The kernel.  ``spw`` (slabs a warp; 0: ``default_spw``) and
    ``mode`` (0: none; 1: no x gather, not A @ x; 2: every slab streamed)
    are knobs for measurements only."""
    _check(packed, x)
    rows, cols = packed.shape
    planes = (packed.s_idx, packed.vals, packed.group_super, packed.slab_win,
              packed.slab_tloc)
    if not x.is_cuda or not all(t.device == x.device and t.is_contiguous()
                                for t in planes):
        raise ValueError("spmv_superblock: the pack and x must be contiguous "
                         "on one CUDA device")
    n_groups, group = packed.s_idx.shape[0], packed.group
    if (packed.s_idx.dtype != torch.int8
            or any(t.dtype != torch.int32 for t in planes[2:])
            or packed.s_idx.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.s_idx.shape
            or packed.group_super.shape != (n_groups,)
            or packed.slab_win.numel() != n_groups * group
            or packed.slab_tloc.numel() != n_groups * group):
        raise ValueError("spmv_superblock: inconsistent pack planes")
    bf16 = packed.vals.dtype == torch.bfloat16
    if (packed.vals.data_ptr() % (8 if bf16 else 16)
            or packed.s_idx.data_ptr() % 4):
        raise ValueError("spmv_superblock: the planes must be aligned for "
                         "4-slot loads")
    if rows == 0 or cols == 0:
        return torch.zeros(rows, dtype=torch.float32, device=x.device)
    real = group_real(packed)
    warp_ptr, _, split_rows = superblock_walk(packed, spw)
    # the kernel writes every row but those of the tiles a cut splits,
    # into which it adds
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    if split_rows.numel():
        y.index_fill_(0, split_rows, 0.0)
    tuned = bool(mode)
    fn = _build.load("spmv_superblock",
                     _TUNED_ARGTYPES if tuned else _ARGTYPES,
                     "spmv_superblock_tuned" if tuned else None)
    with torch.cuda.device(x.device):
        err = fn(packed.s_idx.data_ptr(), packed.vals.data_ptr(),
                 packed.group_super.data_ptr(), packed.slab_win.data_ptr(),
                 packed.slab_tloc.data_ptr(), real.data_ptr(),
                 warp_ptr.data_ptr(), x.contiguous().data_ptr(), y.data_ptr(),
                 rows, cols, packed.n_slabs, group, packed.k_tiles,
                 warp_ptr.numel() - 1, int(bf16),
                 *((int(mode),) if tuned else ()),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_superblock: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["spmv_superblock"] += 1
    return y


def _superblock_forward(packed: SellSuperblock,
                        x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmv_superblock_reference(packed, x)
    return _spmv_superblock_cuda(packed, x)


def _slot_row_col(packed: SellSuperblock):
    """Per-slot (row, col), each (n_groups, group*8, 128) int64."""
    n_groups, GH, _ = packed.s_idx.shape
    dev = packed.s_idx.device
    lane = torch.arange(_LANES, device=dev)[None, None, :]
    tile = _slab_tiles(packed).reshape(n_groups, packed.group)
    tile = tile.repeat_interleave(8, dim=1)[:, :, None]
    row = tile * _LANES + lane
    subl = (torch.arange(GH, device=dev) % 8)[None, :, None]
    winb = packed.slab_win.long().reshape(n_groups, packed.group)
    winb = winb.repeat_interleave(8, dim=1)[:, :, None]
    col = winb * _W + subl * _LANES + (packed.s_idx.long() & 127)
    return row.expand_as(col), col


class _SpmvSuperblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, x):
        # ``vals`` is ``packed.vals``, passed so autograd tracks it
        ctx.packed = packed
        ctx.save_for_backward(x)
        return _superblock_forward(packed, x)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        (x,) = ctx.saved_tensors
        rows, cols = packed.shape
        row, col = _slot_row_col(packed)
        gpad = torch.zeros(packed.n_super * packed.k_tiles * _LANES,
                           dtype=torch.float32, device=g.device)
        gpad[:rows] = g
        gx = dvals = None
        if ctx.needs_input_grad[2]:
            gx = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                             device=g.device)
            gx.index_add_(0, col.reshape(-1),
                          (gpad[row] * packed.vals.float()).reshape(-1))
            gx = gx[:cols].to(x.dtype)
        if ctx.needs_input_grad[1]:
            xpad = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                               device=x.device)
            xpad[:cols] = x
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            dvals = torch.where(packed.vals != 0, xpad[col] * gpad[row],
                                zero).to(packed.vals.dtype)
        return None, dvals, gx


def spmv_superblock(packed: SellSuperblock, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` on the superblock layout (fp32 result), differentiable
    in x and in ``packed.vals``."""
    return _SpmvSuperblock.apply(packed, packed.vals, x)
