"""Tile gather: ``csrc/probe_tile_gather.cu`` and its plain version.

Twin of the Pallas kernel ``gather_kernel`` of
``docs/repro_dynamic_gather_shapes.py``: ``out = take_along_axis(tab,
idx, axis=1)`` for an (R, C) fp32 table and an (R, C) int32 index array,
at any R and C (Mosaic compiled it only at (8, 128)).  An index outside
[0, C) gives 0, in both versions.

``tile_gather(tab, idx)`` runs ``tile_gather_reference`` when its inputs
lie on the CPU, and otherwise launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["tile_gather", "tile_gather_reference"]

_ARGTYPES = (
    ctypes.c_void_p,  # tab (R, C) fp32
    ctypes.c_void_p,  # idx (R, C) int32
    ctypes.c_void_p,  # out (R, C) fp32
    ctypes.c_longlong,  # R
    ctypes.c_int,  # C
    ctypes.c_void_p,  # stream
)


def _check(tab: torch.Tensor, idx: torch.Tensor) -> None:
    if (tab.dim() != 2 or idx.shape != tab.shape
            or tab.dtype != torch.float32 or idx.dtype != torch.int32):
        raise ValueError("tile_gather: tab must be fp32 (R, C) and idx int32 "
                         f"of its shape; got {tab.dtype} {tuple(tab.shape)} "
                         f"and {idx.dtype} {tuple(idx.shape)}")


def tile_gather_reference(tab: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing of each row by its indices."""
    _check(tab, idx)
    R, C = tab.shape
    if tab.numel() == 0:
        return torch.zeros_like(tab)
    i = idx.long()
    ok = (i >= 0) & (i < C)
    rows = torch.arange(R, device=tab.device).view(R, 1)
    return torch.where(ok, tab[rows, i.clamp(0, C - 1)], 0.0)


def _tile_gather_cuda(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check(tab, idx)
    if not (tab.is_cuda and idx.device == tab.device and tab.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("tile_gather: tab and idx must be contiguous on one "
                         "CUDA device")
    out = torch.empty_like(tab)
    if tab.numel() == 0:
        return out
    fn = _build.load("probe_tile_gather", _ARGTYPES)
    with torch.cuda.device(tab.device):
        err = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0],
                 tab.shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_tile_gather: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["probe_tile_gather"] += 1
    return out


def tile_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, j] = tab[r, idx[r, j]]``."""
    if tab.device.type == "cpu" and idx.device.type == "cpu":
        return tile_gather_reference(tab, idx)
    return _tile_gather_cuda(tab, idx)
