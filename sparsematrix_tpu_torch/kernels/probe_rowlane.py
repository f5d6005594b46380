"""Row-lane walk ablation: ``csrc/probe_rowlane.cu`` and its plain version.

Twin of the three Pallas kernels of ``variant_kernels`` in
``benchmarks/probe_xl_spmv.py``: the rowlane SpMV's walk over a
``SellRowLane`` pack with one piece of the slab step taken out, each
summing into row 8t of tile t's (8, 128) output block:

* ``"dma-only"``:        ``vals[u, l]``
* ``"fixed-window"``:    ``vals[u, l] * xp[u, s_idx[u, l]]`` (window 0)
* ``"slice-no-gather"``: ``vals[u, l] * xp[8w + u, l]``, w = ``slab_win``

``xp`` is x zero-padded to whole windows, viewed (S, 128) (``pad_x``).
The result is (n_tiles * 8, 128) fp32; rows 8t+1 .. 8t+7 are 0.  The JAX
kernel leaves the blocks of tiles that no group visits unwritten; both
versions here return 0 there.  A spill tail of the pack is not walked
(the probe strips it), and the values must be fp32 (the probe walks fp32
packs only).

``probe_rowlane(packed, xp, step)`` runs ``probe_rowlane_reference`` when
its inputs lie on the CPU, and otherwise launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["STEPS", "pad_x", "probe_rowlane", "probe_rowlane_reference"]

_LANES = 128
_W = 1024
STEPS = ("dma-only", "fixed-window", "slice-no-gather")
# the kernel's step number and launch counter of each body
_STEP_ID = {"dma-only": 1, "fixed-window": 2, "slice-no-gather": 3}
_COUNTER = {step: "probe_rowlane_" + step.replace("-", "_") for step in STEPS}
# slabs a step of the plain walk: bounds its temporaries
_PLAIN_SLABS = 1 << 12

_ARGTYPES = (
    ctypes.c_int,  # step
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals fp32
    ctypes.c_void_p,  # group_tile (n_groups,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # xp (S * 128,) fp32
    ctypes.c_void_p,  # out (n_tiles * 1024,) fp32, zeroed
    ctypes.c_int,  # n_tiles
    ctypes.c_int,  # S
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # group
    ctypes.c_void_p,  # stream
)


def pad_x(x: torch.Tensor, n_win: int) -> torch.Tensor:
    """x zero-padded to ``n_win`` windows of 1024, viewed (n_win * 8, 128)
    (the probe's ``xp``)."""
    xp = torch.zeros(n_win * _W, dtype=torch.float32, device=x.device)
    xp[:x.shape[0]] = x
    return xp.reshape(n_win * 8, _LANES)


def _check(packed, xp: torch.Tensor, step: str) -> None:
    if step not in _STEP_ID:
        raise ValueError(f"probe_rowlane: step must be one of {STEPS}, "
                         f"not {step!r}")
    if packed.vals.dtype != torch.float32:
        raise ValueError("probe_rowlane: values must be fp32 (the probe "
                         f"walks the fp32 pack), not {packed.vals.dtype}")
    n_groups, group = packed.s_idx.shape[0], packed.group
    if (packed.s_idx.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.s_idx.shape
            or packed.group_tile.numel() != n_groups
            or packed.slab_win.numel() != n_groups * group):
        raise ValueError("probe_rowlane: inconsistent pack planes")
    if xp.dtype != torch.float32 or xp.dim() != 2 or xp.shape[1] != _LANES:
        raise ValueError("probe_rowlane: xp must be fp32 (S, 128), not "
                         f"{xp.dtype} {tuple(xp.shape)}")


def probe_rowlane_reference(packed, xp: torch.Tensor,
                            step: str) -> torch.Tensor:
    """Plain version: the slab walk of ``step`` in chunks of slabs, fp32
    accumulation; a column past the end of xp, or a tile past n_tiles,
    adds nothing (as the kernel's bounds checks)."""
    _check(packed, xp, step)
    n_tiles, dev = packed.n_tiles, xp.device
    cols = xp.numel()
    xf = xp.reshape(-1)
    si = packed.s_idx.reshape(-1, 8, _LANES)
    vv = packed.vals.reshape(-1, 8, _LANES)
    win = packed.slab_win.reshape(-1).long().to(dev)
    tiles = packed.group_tile.long().to(dev).repeat_interleave(packed.group)
    tiles = torch.where(tiles < n_tiles, tiles, n_tiles)  # a spare tile
    base = (torch.arange(8, device=dev) * _LANES).view(1, 8, 1)
    lane = torch.arange(_LANES, device=dev).view(1, 1, _LANES)
    out = torch.zeros((n_tiles + 1, _LANES), dtype=torch.float32,
                      device=dev)
    for s0 in range(0, si.shape[0], _PLAIN_SLABS):
        sl = slice(s0, s0 + _PLAIN_SLABS)
        v = vv[sl].to(dev)
        if step == "dma-only":
            part = v.sum(dim=1)
        else:
            if step == "fixed-window":
                col = base + (si[sl].to(dev).long() & 127)
            else:
                col = win[sl].view(-1, 1, 1) * _W + base + lane
            ok = col < cols
            g = torch.where(ok, xf[col.clamp(max=cols - 1)], 0.0)
            part = (v * g).sum(dim=1)
        out.index_add_(0, tiles[sl], part)
    res = torch.zeros((n_tiles, 8, _LANES), dtype=torch.float32, device=dev)
    res[:, 0] = out[:n_tiles]
    return res.reshape(n_tiles * 8, _LANES)


def _probe_rowlane_cuda(packed, xp: torch.Tensor, step: str) -> torch.Tensor:
    _check(packed, xp, step)
    planes = (packed.s_idx, packed.vals, packed.group_tile, packed.slab_win)
    if not (xp.is_cuda and xp.is_contiguous() and all(
            t.device == xp.device and t.is_contiguous() for t in planes)):
        raise ValueError("probe_rowlane: the pack and xp must be contiguous "
                         "on one CUDA device")
    if (packed.s_idx.dtype != torch.int8
            or any(t.dtype != torch.int32 for t in planes[2:])):
        raise ValueError("probe_rowlane: s_idx must be int8 and the tile "
                         "and window planes int32")
    n_tiles = packed.n_tiles
    out = torch.zeros((n_tiles * 8, _LANES), dtype=torch.float32,
                      device=xp.device)
    if packed.s_idx.numel() == 0 or n_tiles == 0:
        return out
    fn = _build.load("probe_rowlane", _ARGTYPES)
    with torch.cuda.device(xp.device):
        err = fn(_STEP_ID[step], packed.s_idx.data_ptr(),
                 packed.vals.data_ptr(), packed.group_tile.data_ptr(),
                 packed.slab_win.data_ptr(), xp.data_ptr(), out.data_ptr(),
                 n_tiles, xp.shape[0], packed.s_idx.shape[0] * packed.group,
                 packed.group, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_rowlane: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts[_COUNTER[step]] += 1
    return out


def probe_rowlane(packed, xp: torch.Tensor, step: str) -> torch.Tensor:
    """The walk of ``step`` over ``packed``'s body: (n_tiles * 8, 128)."""
    if xp.device.type == "cpu" and packed.vals.device.type == "cpu":
        return probe_rowlane_reference(packed, xp, step)
    return _probe_rowlane_cuda(packed, xp, step)
