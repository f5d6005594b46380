"""Blocked-ELL times dense: ``csrc/spmm_blocked_ell.cu``.

Twin of ``sparsematrix_tpu/kernels/spmm_pallas.py``: per block-row,
``Y[i] = sum_m blocks[i, m] @ X[block_cols[i, m] * bk : + bk]``.  Padding
slots are zero blocks at block-column 0 and contribute exactly 0.

``spmm_blocked_ell(A, X)`` runs ``spmm_blocked_ell_reference`` when all
its inputs lie on the CPU, and otherwise launches the kernel or raises.  It is
differentiable in the stored blocks and in ``X``, with the JAX wrapper's
backward math (``spmm_pallas.py:137-172``) in plain torch; ``block_cols``
gets no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import BlockedELL
from . import _build
from .codebook import x_layout

__all__ = ["spmm_blocked_ell", "spmm_blocked_ell_reference"]

_ARGTYPES = (
    ctypes.c_void_p,  # block_cols (nbr, M) int32
    ctypes.c_void_p,  # blocks (nbr, M, bm, bk)
    ctypes.c_void_p,  # X
    ctypes.c_longlong,  # ldx
    ctypes.c_int,  # x_kmajor
    ctypes.c_int,  # bf16
    ctypes.c_void_p,  # out (nrows, nrhs)
    ctypes.c_int,  # nrows
    ctypes.c_int,  # ncols
    ctypes.c_int,  # nbr
    ctypes.c_int,  # M
    ctypes.c_int,  # bm
    ctypes.c_int,  # bk
    ctypes.c_int,  # nrhs
    ctypes.c_void_p,  # stream
)
# spmm_blocked_ell_tuned: the same, then split and mode before the stream
_TUNED_ARGTYPES = _ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p)


def _padded_x(A: BlockedELL, X: torch.Tensor, dtype) -> torch.Tensor:
    """X zero-padded to whole block-columns: (nbc, bk, k)."""
    bk = A.block_shape[1]
    nbc = -(-A.shape[1] // bk)
    Xp = torch.zeros((nbc * bk, X.shape[1]), dtype=dtype, device=X.device)
    Xp[: A.shape[1]] = X
    return Xp.reshape(nbc, bk, X.shape[1])


def spmm_blocked_ell_reference(A: BlockedELL, X: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the X tiles, one batched product (twin of
    ``_spmm_bell_jnp``, ``ops/spmm.py:70-80``).  bf16 operands are
    accumulated in fp32 and rounded once, as the kernel does."""
    bm = A.block_shape[0]
    nbr = A.block_cols.shape[0]
    dt = torch.promote_types(A.blocks.dtype, X.dtype)
    acc_dt = torch.promote_types(dt, torch.float32)
    gathered = _padded_x(A, X, acc_dt)[A.block_cols.long()]  # (nbr, M, bk, k)
    acc = torch.einsum("rmij,rmjk->rik", A.blocks.to(acc_dt), gathered)
    return acc.reshape(nbr * bm, X.shape[1])[: A.shape[0]].to(dt)


def _spmm_blocked_ell_cuda(A: BlockedELL, X: torch.Tensor, *, split: int = 0,
                           mode: int = 0) -> torch.Tensor:
    """The kernel.  For block heights below 32, ``split`` (blocks a tile
    summing into one output tile; 0: the kernel's choice) and ``mode``
    (the ablations of ``csrc/spmm_blocked_ell.cu``: 1 stages every chunk
    but does no FMA, 2 skips no zeros, 6 stages nothing; 1 and 6 do not
    give A @ X) are knobs for measurements only."""
    blocks, bcols = A.blocks, A.block_cols
    if not (X.is_cuda and blocks.device == X.device and bcols.device == X.device):
        raise ValueError("spmm_blocked_ell: A and X must lie on one CUDA device")
    if X.dtype not in (torch.float32, torch.bfloat16) or blocks.dtype != X.dtype:
        raise ValueError("spmm_blocked_ell: blocks and X must both be fp32 or "
                         f"both bf16, not {blocks.dtype} and {X.dtype}")
    if (bcols.dtype != torch.int32 or not bcols.is_contiguous()
            or not blocks.is_contiguous()):
        raise ValueError("spmm_blocked_ell: block_cols must be contiguous "
                         "int32 and blocks contiguous")
    if X.dim() != 2 or X.shape[0] != A.shape[1]:
        raise ValueError(f"spmm_blocked_ell: X shape {tuple(X.shape)} does "
                         f"not match matrix {A.shape}")
    nrows, ncols = A.shape
    nbr, M = bcols.shape
    bm, bk = A.block_shape
    if blocks.shape != (nbr, M, bm, bk) or nbr * bm < nrows:
        raise ValueError(f"spmm_blocked_ell: blocks {tuple(blocks.shape)} do "
                         f"not match block_cols {tuple(bcols.shape)}, block "
                         f"shape {A.block_shape} and matrix {A.shape}")
    nrhs = X.shape[1]
    out = torch.empty((nrows, nrhs), dtype=X.dtype, device=X.device)
    if nrows == 0 or nrhs == 0:
        return out
    X, ldx, kmajor = x_layout(X)
    tuned = split != 0 or mode != 0
    fn = _build.load("spmm_blocked_ell",
                     _TUNED_ARGTYPES if tuned else _ARGTYPES,
                     "spmm_blocked_ell_tuned" if tuned else None)
    knobs = (int(split), int(mode)) if tuned else ()
    with torch.cuda.device(X.device):
        err = fn(bcols.data_ptr(), blocks.data_ptr(), X.data_ptr(), ldx,
                 int(kmajor), int(X.dtype == torch.bfloat16), out.data_ptr(),
                 nrows, ncols, nbr, M, bm, bk, nrhs, *knobs,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"spmm_blocked_ell: launch failed with CUDA error {err}")
    _build.launch_counts["spmm_blocked_ell"] += 1
    return out


class _SpmmBlockedEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, blocks, X):
        # ``blocks`` is ``A.blocks``, passed so autograd tracks it
        ctx.A = A
        ctx.save_for_backward(X)
        if all(t.device.type == "cpu" for t in (A.block_cols, blocks, X)):
            return spmm_blocked_ell_reference(A, X)
        return _spmm_blocked_ell_cuda(A, X)

    @staticmethod
    def backward(ctx, g):
        A = ctx.A
        (X,) = ctx.saved_tensors
        bm, bk = A.block_shape
        nbr, M = A.block_cols.shape
        k = X.shape[1]
        bcols = A.block_cols.long()
        gp = torch.zeros((nbr * bm, k), dtype=g.dtype, device=g.device)
        gp[: g.shape[0]] = g
        gb = gp.reshape(nbr, bm, k)
        valid = A.valid[:, :, None, None]
        zero = torch.zeros((), dtype=A.blocks.dtype, device=A.blocks.device)
        dX = dblocks = None
        if ctx.needs_input_grad[2]:
            # dX[j-tile] += block(i,m)^T @ g-rowblock(i) for every stored block
            blocks_m = torch.where(valid, A.blocks, zero)
            contrib = torch.einsum("rmij,rik->rmjk", blocks_m.to(g.dtype), gb)
            Xp = _padded_x(A, X, X.dtype)
            dXp = torch.zeros_like(Xp).index_add_(
                0, bcols.reshape(-1), contrib.reshape(nbr * M, bk, k).to(X.dtype))
            dX = dXp.reshape(-1, k)[: A.shape[1]]
        if ctx.needs_input_grad[1]:
            # dblocks(i,m) = g-rowblock(i) @ x-tile(block_cols[i,m])^T
            Xt = _padded_x(A, X, g.dtype)[bcols]  # (nbr, M, bk, k)
            dblocks = torch.einsum("rik,rmjk->rmij", gb, Xt)
            dblocks = torch.where(valid, dblocks.to(A.blocks.dtype), zero)
        return None, dblocks, dX


def spmm_blocked_ell(A: BlockedELL, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` through the Blocked-ELL layout; Y has X's type."""
    return _SpmmBlockedEll.apply(A, A.blocks, X)
