"""Gather-step probes: ``csrc/probe_gather_step.cu`` and its plain
versions.

Twins of three Pallas kernels: ``single_call`` and ``dual_call`` of
``benchmarks/probe_dualgather.py`` and ``pooled_call`` of
``benchmarks/probe_sublane_slice.py``.  Each sums one gather step over
every slab of a run of groups into one (8, 128) block (row 0; rows 1-7
are 0).  Planes are (n_groups, group * 8, 128): ``idxA`` (int8, in
[0, 8)), ``idxB`` (int8, in [0, 128)) and ``vals`` (fp32); ``xp`` is x as
(S, 128) fp32.  With c = idxB[u, l]:

* ``single_step(win, idxB, vals, xp)``: ``vals[u,l] * xw[u, c]``
* ``dual_step(win, idxA, idxB, vals, xp)``: ``vals[u,l] * xw[idxA[u, c], c]``
* ``pooled_step(ptr, idxA, idxB, vals, xp)``: as dual, with each sublane's
  own chunk: ``xw[r] = xp[ptr[g, b, r]]``

where ``xw = xp[8w : 8w + 8]``, ``w = win[g, b]`` (``win`` (n_groups,
group) int32, ``ptr`` (n_groups, group, 8) int32).  The chunk index is
read at the routed lane c, as the JAX kernels' two ``take_along_axis``
calls compose.  An index outside its range (a lane >= 128, a chunk >= 8,
an x row outside [0, S)) adds nothing, in both versions.

Each runs its ``_reference`` when its inputs lie on the CPU, and
otherwise launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["single_step", "dual_step", "pooled_step",
           "single_step_reference", "dual_step_reference",
           "pooled_step_reference"]

_LANES = 128
_MODES = {"single": 0, "dual": 1, "pooled": 2}
# slabs a step of the plain walk: bounds its temporaries
_PLAIN_SLABS = 1 << 12

_ARGTYPES = (
    ctypes.c_int,  # mode: 0 single, 1 dual, 2 pooled
    ctypes.c_void_p,  # win (n_slabs,) or ptr (n_slabs * 8,) int32
    ctypes.c_void_p,  # idxA int8 (null for single)
    ctypes.c_void_p,  # idxB int8
    ctypes.c_void_p,  # vals fp32
    ctypes.c_void_p,  # xp (S * 128,) fp32
    ctypes.c_void_p,  # out (1024,) fp32, zeroed
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # S
    ctypes.c_void_p,  # stream
)


def _check(mode: str, win, idxA: Optional[torch.Tensor], idxB, vals,
           xp) -> int:
    """Validates the inputs; returns the number of slabs."""
    n_groups, gh = idxB.shape[0], idxB.shape[1] if idxB.dim() == 3 else 0
    group = gh // 8
    n_slabs = n_groups * group
    want_win = (n_groups, group, 8) if mode == "pooled" else (n_groups, group)
    if (idxB.dim() != 3 or idxB.shape[2] != _LANES or gh % 8
            or idxB.dtype != torch.int8 or vals.shape != idxB.shape
            or vals.dtype != torch.float32
            or (idxA is not None and (idxA.shape != idxB.shape
                                      or idxA.dtype != torch.int8))
            or tuple(win.shape) != want_win or win.dtype != torch.int32
            or xp.dim() != 2 or xp.shape[1] != _LANES
            or xp.dtype != torch.float32):
        raise ValueError(
            f"{mode}_step: planes must be (n_groups, group*8, 128) (idxA, "
            f"idxB int8, vals fp32), the windows int32 {want_win} and xp "
            f"fp32 (S, 128); got idxB {idxB.dtype} {tuple(idxB.shape)}, "
            f"vals {vals.dtype} {tuple(vals.shape)}, windows {win.dtype} "
            f"{tuple(win.shape)}, xp {xp.dtype} {tuple(xp.shape)}")
    return n_slabs


def _step_plain(mode: str, win, idxA, idxB, vals, xp) -> torch.Tensor:
    n_slabs = _check(mode, win, idxA, idxB, vals, xp)
    dev = xp.device
    S = xp.shape[0]
    xf = xp.reshape(-1)
    B = idxB.reshape(n_slabs, 8, _LANES)
    A = None if idxA is None else idxA.reshape(n_slabs, 8, _LANES)
    V = vals.reshape(n_slabs, 8, _LANES)
    W = win.reshape(n_slabs, -1).long().to(dev)
    u = torch.arange(8, device=dev).view(1, 8, 1)
    acc = torch.zeros(_LANES, dtype=torch.float32, device=dev)
    for s0 in range(0, n_slabs, _PLAIN_SLABS):
        sl = slice(s0, s0 + _PLAIN_SLABS)
        c = B[sl].to(dev).long() & 255  # the byte, unsigned
        cc = c.clamp(max=_LANES - 1)
        if mode == "single":
            r = W[sl].view(-1, 1, 1) * 8 + u
        else:
            a = torch.gather(A[sl].to(dev).long() & 255, 2, cc)
            a = torch.where(c < _LANES, a, 8)
            ac = a.clamp(max=7)
            if mode == "dual":
                r = W[sl].view(-1, 1, 1) * 8 + ac
            else:
                r = torch.gather(W[sl].view(-1, 1, 8).expand(-1, 8, 8), 2,
                                 ac)
            r = torch.where(a < 8, r, -1)
        ok = (c < _LANES) & (r >= 0) & (r < S)
        xv = torch.where(ok, xf[r.clamp(0, S - 1) * _LANES + cc], 0.0)
        acc += (V[sl].to(dev) * xv).sum(dim=(0, 1))
    out = torch.zeros((8, _LANES), dtype=torch.float32, device=dev)
    out[0] = acc
    return out


def _step_cuda(mode: str, win, idxA, idxB, vals, xp) -> torch.Tensor:
    n_slabs = _check(mode, win, idxA, idxB, vals, xp)
    ins = [t for t in (win, idxA, idxB, vals, xp) if t is not None]
    if not (xp.is_cuda and all(t.device == xp.device and t.is_contiguous()
                               for t in ins)):
        raise ValueError(f"{mode}_step: every input must be contiguous on "
                         "one CUDA device")
    out = torch.zeros((8, _LANES), dtype=torch.float32, device=xp.device)
    if n_slabs == 0 or xp.shape[0] == 0:
        return out
    fn = _build.load("probe_gather_step", _ARGTYPES)
    with torch.cuda.device(xp.device):
        err = fn(_MODES[mode], win.data_ptr(),
                 None if idxA is None else idxA.data_ptr(), idxB.data_ptr(),
                 vals.data_ptr(), xp.data_ptr(), out.data_ptr(), n_slabs,
                 xp.shape[0], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_gather_step ({mode}): launch failed with "
                           f"CUDA error {err}")
    _build.launch_counts[f"probe_gather_{mode}"] += 1
    return out


def _dispatch(mode, win, idxA, idxB, vals, xp):
    ins = [t for t in (win, idxA, idxB, vals, xp) if t is not None]
    if all(t.device.type == "cpu" for t in ins):
        return _step_plain(mode, win, idxA, idxB, vals, xp)
    return _step_cuda(mode, win, idxA, idxB, vals, xp)


def single_step(win, idxB, vals, xp) -> torch.Tensor:
    """One single-gather step over every slab: (8, 128), row 0 the sum."""
    return _dispatch("single", win, None, idxB, vals, xp)


def dual_step(win, idxA, idxB, vals, xp) -> torch.Tensor:
    """One dual-gather step over every slab: (8, 128), row 0 the sum."""
    return _dispatch("dual", win, idxA, idxB, vals, xp)


def pooled_step(ptr, idxA, idxB, vals, xp) -> torch.Tensor:
    """One dual-gather step over every slab, each sublane of a slab on its
    own chunk of x (``ptr``): (8, 128), row 0 the sum."""
    return _dispatch("pooled", ptr, idxA, idxB, vals, xp)


def single_step_reference(win, idxB, vals, xp) -> torch.Tensor:
    """Plain version of ``single_step``."""
    return _step_plain("single", win, None, idxB, vals, xp)


def dual_step_reference(win, idxA, idxB, vals, xp) -> torch.Tensor:
    """Plain version of ``dual_step``."""
    return _step_plain("dual", win, idxA, idxB, vals, xp)


def pooled_step_reference(ptr, idxA, idxB, vals, xp) -> torch.Tensor:
    """Plain version of ``pooled_step``."""
    return _step_plain("pooled", ptr, idxA, idxB, vals, xp)
