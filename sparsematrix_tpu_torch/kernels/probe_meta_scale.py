"""Metadata scale: ``csrc/probe_meta_scale.cu`` and its plain version.

Twin of the Pallas kernels ``kernel_1d`` and ``kernel_2d`` of
``docs/repro_smem_lane_padding.py``: a run of steps in order, step i
writing ``out = x * meta_i`` (an int32 scalar taken as fp32), so that the
last step's value remains.  Step i's scalar is

* ``meta[i * cols]`` for flat metadata (``meta`` 1-D, ``cols`` its row
  length: ``kernel_1d``), numel // cols steps;
* ``meta[i, 0]`` for 2-D metadata (``kernel_2d``), one step a row, read
  through the array's row stride (so a view with padded rows works).

At most 512 steps, the repro's grid (the kernel stages every scalar in
shared memory at once).

``meta_scale(meta, x, cols=None)`` runs ``meta_scale_reference`` when its
inputs lie on the CPU, and otherwise launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["MAX_STEPS", "meta_scale", "meta_scale_reference"]

MAX_STEPS = 512  # the repro's grid; csrc/probe_meta_scale.cu's kMaxSteps

_ARGTYPES = (
    ctypes.c_void_p,  # meta int32
    ctypes.c_void_p,  # x fp32
    ctypes.c_void_p,  # out fp32
    ctypes.c_longlong,  # n
    ctypes.c_int,  # steps
    ctypes.c_longlong,  # stride of a step's scalar, in elements
    ctypes.c_void_p,  # stream
)


def _steps(meta: torch.Tensor, x: torch.Tensor,
           cols: Optional[int]) -> Tuple[int, int]:
    """(steps, stride) of ``meta``; validates the inputs."""
    if meta.dtype != torch.int32 or x.dtype != torch.float32:
        raise ValueError("meta_scale: meta must be int32 and x fp32, not "
                         f"{meta.dtype} and {x.dtype}")
    if meta.dim() == 1:
        if cols is None or cols <= 0 or meta.stride(0) != 1:
            raise ValueError("meta_scale: flat metadata needs its row length "
                             "cols > 0 and a contiguous array")
        steps, stride = meta.numel() // cols, cols
    elif meta.dim() == 2 and cols is None and meta.shape[1] > 0:
        steps, stride = meta.shape[0], meta.stride(0)
    else:
        raise ValueError("meta_scale: meta must be 1-D with cols, or 2-D, "
                         f"not {tuple(meta.shape)} with cols={cols}")
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"meta_scale: 1 to {MAX_STEPS} steps, not {steps}")
    return steps, stride


def meta_scale_reference(meta: torch.Tensor, x: torch.Tensor,
                         cols: Optional[int] = None) -> torch.Tensor:
    """Plain version: x times the last step's scalar."""
    steps, _ = _steps(meta, x, cols)
    last = meta[(steps - 1) * cols] if meta.dim() == 1 else meta[steps - 1, 0]
    return x * last.to(torch.float32)


def _meta_scale_cuda(meta: torch.Tensor, x: torch.Tensor,
                     cols: Optional[int] = None) -> torch.Tensor:
    steps, stride = _steps(meta, x, cols)
    if not (x.is_cuda and meta.device == x.device and x.is_contiguous()):
        raise ValueError("meta_scale: meta and a contiguous x must lie on one "
                         "CUDA device")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _build.load("probe_meta_scale", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(meta.data_ptr(), x.data_ptr(), out.data_ptr(), x.numel(),
                 steps, stride, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_meta_scale: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["probe_meta_scale"] += 1
    return out


def meta_scale(meta: torch.Tensor, x: torch.Tensor,
               cols: Optional[int] = None) -> torch.Tensor:
    """x times the last step's metadata scalar, the steps run in order."""
    if meta.device.type == "cpu" and x.device.type == "cpu":
        return meta_scale_reference(meta, x, cols)
    return _meta_scale_cuda(meta, x, cols)
