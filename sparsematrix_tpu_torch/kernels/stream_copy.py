"""Stream copy: ``csrc/stream_copy.cu`` and its plain version.

Twin of the Pallas ``copy_call`` in ``sparsematrix_tpu/bench/suite.py``'s
``bench_calibrate``: ``y = x`` for a contiguous fp32 tensor of any
length, the HBM-bandwidth probe behind the ``calibrate/hbm-stream`` row.

``stream_copy(x)`` runs ``stream_copy_reference`` (``x.clone()``) when x
lies on the CPU, and otherwise launches the kernel or raises.  The result
is a new tensor on x's device, allocated with x's alignment modulo 16
bytes, so that the kernel's 16-byte path takes a view that starts
mid-vector (a slice such as ``x[1:]``) too.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["stream_copy", "stream_copy_reference"]

_ARGTYPES = (
    ctypes.c_void_p,  # x fp32
    ctypes.c_void_p,  # y fp32
    ctypes.c_longlong,  # n
    ctypes.c_int,  # chunk bytes (0: the default)
    ctypes.c_int,  # stages (0: the default)
    ctypes.c_int,  # blocks a streaming multiprocessor (0: the default)
    ctypes.c_void_p,  # stream
)


def stream_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a copy."""
    return x.clone()


def _stream_copy_cuda(x: torch.Tensor, *, chunk: int = 0, stages: int = 0,
                      blocks_per_sm: int = 0) -> torch.Tensor:
    """The kernel.  ``chunk`` (bytes a bulk copy, a multiple of 16),
    ``stages`` (shared buffers a block) and ``blocks_per_sm`` are knobs
    for measurements only, 0 each for the kernel's default; each gives a
    copy."""
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("stream_copy: x must be a contiguous fp32 tensor "
                         f"on a CUDA device (got {x.dtype} on {x.device}, "
                         f"contiguous={x.is_contiguous()})")
    n = x.numel()
    # y shares x's offset from a 16-byte boundary
    off = (x.data_ptr() % 16) // 4
    y = torch.empty(n + off, dtype=x.dtype, device=x.device)[off:].view(
        x.shape)
    if n == 0:
        return y
    fn = _build.load("stream_copy", _ARGTYPES, "stream_copy_tuned")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), n, chunk, stages, blocks_per_sm,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_copy: launch failed with CUDA error {err}")
    _build.launch_counts["stream_copy"] += 1
    return y


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """``y = x`` for a contiguous fp32 tensor (a new tensor)."""
    if x.device.type == "cpu":
        return stream_copy_reference(x)
    return _stream_copy_cuda(x)
