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
from typing import Tuple

import numpy as np
import torch

from ..formats.base import cached_on, sparse_container, static_field
from ..formats.bsr import BSR
from . import _build

__all__ = ["BSRPanels", "pack_bsr_panels", "spmm_bsr",
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
_PANEL_ARGTYPES = (
    ctypes.c_void_p,  # bcols (nbr, M) int32
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


def _spmm_bsr_cuda(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """The grouped kernel (row 3)."""
    X = _check_inputs("spmm_bsr", A.data, A.indices, X, A.shape[1])
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    if (A.indptr.dtype != torch.int32 or A.indptr.device != X.device
            or A.data.shape != (A.block_capacity, bm, bn) or nbr * bm < A.shape[0]):
        raise ValueError(f"spmm_bsr: indptr {A.indptr.dtype} or blocks "
                         f"{tuple(A.data.shape)} do not match block shape "
                         f"{A.block_shape} and matrix {A.shape}")
    out = torch.empty((A.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    return _launch("spmm_bsr", "spmm_bsr", _GROUPED_ARGTYPES, (
        A.indptr.data_ptr(), A.indices.data_ptr(), A.data.data_ptr(),
        X.data_ptr(), int(X.dtype == torch.bfloat16), out.data_ptr(),
        A.shape[0], A.shape[1], nbr, bm, bn, X.shape[1]), out)


def _spmm_bsr_panel_cuda(P: BSRPanels, X: torch.Tensor) -> torch.Tensor:
    """The panel kernel (row 4)."""
    X = _check_inputs("spmm_bsr_panel", P.panels, P.bcols, X, P.shape[1])
    bm, bn = P.block_shape
    nbr, M = P.bcols.shape
    if P.panels.shape != (nbr, bm, M * bn) or nbr * bm < P.shape[0]:
        raise ValueError(f"spmm_bsr_panel: panels {tuple(P.panels.shape)} do "
                         f"not match bcols {tuple(P.bcols.shape)}, block "
                         f"shape {P.block_shape} and matrix {P.shape}")
    out = torch.empty((P.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    return _launch("spmm_bsr_panel", "spmm_bsr_panel", _PANEL_ARGTYPES, (
        P.bcols.data_ptr(), P.panels.data_ptr(), X.data_ptr(),
        int(X.dtype == torch.bfloat16), out.data_ptr(), P.shape[0],
        P.shape[1], nbr, M, bm, bn, X.shape[1]), out)


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
