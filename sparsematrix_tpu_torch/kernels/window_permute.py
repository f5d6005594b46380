"""Window permute: ``csrc/window_permute.cu`` and its plain version.

Twin of ``sparsematrix_tpu/kernels/permute_pallas.py``.  Each
1024-element window, viewed (8, 128), applies an arbitrary bijection
through three chained gathers of int8 planes::

    t1[c, m] = xw[c, POS[c, m]]     (pos plane:   lane gather)
    t2[u, m] = t1[CH[u, m], m]      (chunk plane: sublane gather)
    y [u, l] = t2[u, RT[u, l]]      (lane route:  lane gather)

a rearrangeable three-stage Clos network C(128, 128, 8), planned on the
host by ``ops/permute_clos.py``.

``window_permute(x, pos, chk, rte)`` runs ``window_permute_reference``
when all its inputs lie on the CPU, and otherwise launches the kernel
(4-byte payloads: fp32 and int32) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["window_permute", "window_permute_reference"]

_LANES = 128

_ARGTYPES = (
    ctypes.c_void_p,  # x (W, 8, 128) 4-byte words
    ctypes.c_void_p,  # pos int8
    ctypes.c_void_p,  # chk int8
    ctypes.c_void_p,  # rte int8
    ctypes.c_void_p,  # out (W, 8, 128)
    ctypes.c_longlong,  # n_windows
    ctypes.c_void_p,  # stream
)


def _check_shapes(x, pos, chk, rte) -> None:
    W = x.shape[0]
    if x.dim() != 3 or x.shape != (W, 8, _LANES) or any(
            p.shape != x.shape for p in (pos, chk, rte)):
        raise ValueError("window_permute: x and the planes must be "
                         f"(W, 8, 128); got {tuple(x.shape)}, "
                         f"{[tuple(p.shape) for p in (pos, chk, rte)]}")


def window_permute_reference(x: torch.Tensor, pos: torch.Tensor,
                             chk: torch.Tensor,
                             rte: torch.Tensor) -> torch.Tensor:
    """Plain version: the three gathers per window, any dtype."""
    _check_shapes(x, pos, chk, rte)
    t1 = torch.gather(x, 2, pos.long())
    t2 = torch.gather(t1, 1, chk.long())
    return torch.gather(t2, 2, rte.long())


def _window_permute_cuda(x, pos, chk, rte) -> torch.Tensor:
    _check_shapes(x, pos, chk, rte)
    if x.element_size() != 4 or x.is_complex():
        raise ValueError("window_permute: the kernel moves 4-byte words "
                         f"(fp32, int32), not {x.dtype}")
    tensors = (x, pos, chk, rte)
    if not all(t.is_cuda and t.device == x.device and t.is_contiguous()
               for t in tensors):
        raise ValueError("window_permute: x and the planes must be "
                         "contiguous on one CUDA device")
    if any(p.dtype != torch.int8 for p in (pos, chk, rte)):
        raise ValueError("window_permute: the planes must be int8")
    if x.data_ptr() % 16 or any(p.data_ptr() % 4 for p in (pos, chk, rte)):
        raise ValueError("window_permute: x must be 16-byte and the planes "
                         "4-byte aligned")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = _build.load("window_permute", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), pos.data_ptr(), chk.data_ptr(), rte.data_ptr(),
                 out.data_ptr(), x.shape[0],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_permute: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["window_permute"] += 1
    return out


def window_permute(x: torch.Tensor, pos: torch.Tensor, chk: torch.Tensor,
                   rte: torch.Tensor) -> torch.Tensor:
    """Apply per-window bijections: x and the result are (W, 8, 128), the
    planes (W, 8, 128) int8."""
    if all(t.device.type == "cpu" for t in (x, pos, chk, rte)):
        return window_permute_reference(x, pos, chk, rte)
    return _window_permute_cuda(x, pos, chk, rte)
