"""Dual-gather SpMM: ``csrc/spmm_dualgather.cu``.

Twin of ``sparsematrix_tpu/kernels/spmm_dualgather.py``: the dual-gather
SpMV slab walk (``spmv_dualgather.py``) per right-hand-side column,
``Y = A @ X`` for a dense X of shape (cols, k).  It takes a k_tiles=1 pack
without tail or splits (the walk ``ops.spmm`` builds for low-density CSR)
or a superblock pack (``spmm(prepare_spmv(A), X)``), whose pooled spill
tail (``spill_cap``) is then a second launch, ``csrc/spmv_pooled.cu`` on
all k columns at once (the JAX package runs its tail kernel once a
column; the sum is the same).

``spmm_dualgather(packed, X)`` runs ``spmm_dualgather_reference`` when all
its inputs lie on the CPU, and otherwise launches the kernels or raises.
It is differentiable in X and in the values, with the JAX wrapper's
backward math (``spmm_dualgather.py:300-334``): the X cotangent is the
plain scatter ``A^T @ G``, the values' the masked ``X[col] · G[row]``
summed over the columns.  Unlike the JAX backward pass, which leaves the
tail out, both take the tail's entries too.
"""
from __future__ import annotations

import torch

from .spmv_dualgather import (_W, DualGather, _check_pack, _dvals,
                              _slot_row_col, _slot_row_col_pooled,
                              _tail_vals, _walk_plain, launch_pooled,
                              launch_walk)

__all__ = ["spmm_dualgather", "spmm_dualgather_reference"]


def _check(packed: DualGather, X: torch.Tensor) -> None:
    if packed.k_tiles == 1 and (packed.tail is not None or packed.splits):
        raise ValueError("spmm_dualgather needs a superblock pack or a "
                         "plain k_tiles=1 pack (no tail, no splits)")
    _check_pack(packed, "spmm_dualgather")
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != packed.shape[1]:
        raise ValueError(f"spmm_dualgather: X must be fp32 of shape "
                         f"({packed.shape[1]}, k), not {X.dtype} "
                         f"{tuple(X.shape)}")


def spmm_dualgather_reference(packed: DualGather,
                              X: torch.Tensor) -> torch.Tensor:
    """Plain version: the SpMV kernel's two-gather walk with a trailing
    column dimension, the pooled tail included; fp32 accumulation and
    result."""
    _check(packed, X)
    return _walk_plain(packed, X)


def _spmm_dualgather_cuda(packed: DualGather, X: torch.Tensor) -> torch.Tensor:
    _check(packed, X)
    if not X.is_cuda:
        raise ValueError("spmm_dualgather: X must lie on the pack's CUDA "
                         "device")
    Y = torch.zeros((packed.shape[0], X.shape[1]), dtype=torch.float32,
                    device=X.device)
    X = X.contiguous()
    launch_walk("spmm_dualgather", packed, X, Y)
    if packed.tail is not None:
        launch_pooled(packed.tail, X, Y)
    return Y


def _spmm_dg_forward(packed: DualGather, X: torch.Tensor) -> torch.Tensor:
    if X.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmm_dualgather_reference(packed, X)
    return _spmm_dualgather_cuda(packed, X)


class _SpmmDualGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, tail_vals, X):
        # ``vals`` and ``tail_vals`` are the body's and the tail's values,
        # passed so autograd tracks them
        ctx.packed = packed
        ctx.save_for_backward(X)
        return _spmm_dg_forward(packed, X)

    @staticmethod
    def backward(ctx, G):
        packed = ctx.packed
        (X,) = ctx.saved_tensors
        rows, cols = packed.shape
        k = X.shape[1]
        Gpad = torch.cat([G.float(), G.new_zeros((1, k), dtype=torch.float32)])
        Xpad = torch.zeros((packed.n_win * _W, k), dtype=torch.float32,
                           device=X.device)
        Xpad[:cols] = X
        gX = out = None
        if ctx.needs_input_grad[3]:
            # padding slots past ``cols`` land in the spare row (dropped)
            out = torch.zeros((cols + 1, k), dtype=torch.float32,
                              device=X.device)
        grads = [None, None]
        parts = [(packed, _slot_row_col, 1)]
        if packed.tail is not None:
            parts.append((packed.tail, _slot_row_col_pooled, 2))
        for part, coords, slot in parts:
            row, col = coords(part)  # (n_groups, group*8, 128)
            Grow = Gpad[row.clamp(max=rows)]  # (n_groups, GH, 128, k)
            if out is not None:
                gv = Grow * part.vals.float()[..., None]
                out.index_add_(0, col.clamp(max=cols).reshape(-1),
                               gv.reshape(-1, k))
            if ctx.needs_input_grad[slot]:
                grads[slot - 1] = _dvals(part, (Xpad[col] * Grow).sum(dim=-1))
        if out is not None:
            gX = out[:cols].to(X.dtype)
        return None, grads[0], grads[1], gX


def spmm_dualgather(packed: DualGather, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over a dual-gather pack (fp32 result), the pooled tail
    included; X is (cols, k) fp32.  Differentiable in X and in the values
    of the body and the tail."""
    return _SpmmDualGather.apply(packed, packed.vals, _tail_vals(packed), X)
