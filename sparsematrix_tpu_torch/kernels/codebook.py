"""Fused codebook dequantize + product: ``csrc/codebook_spmm.cu``.

Twin of ``sparsematrix_tpu/kernels/codebook_pallas.py``.  The JAX package
keeps its Pallas kernel off the default path, because Mosaic's gather only
compiles at the (8, 128) tile and the kernel lost to XLA's fused gather +
dot.  On Hopper the 1 KB table sits in shared memory, so the kernel never
writes the dequantized plane to device memory (the plain version does);
it beats the lookup + one product at 117 rows of X but not at 4096
(PERF.md, kernel row 1), so ``ops.spmm`` keeps the JAX route and the
kernel runs by name.

``codebook_spmm(idx, table, X)`` computes ``table[idx] @ X``; when all
its inputs lie on the CPU it runs ``codebook_spmm_reference``, otherwise
it launches the kernel or raises.  X is read through its strides: the
view ``a.T`` of AddMatMat is not copied.  ``codebook_matmul(a, b_t)`` keeps the JAX
signature.  The gradient is taken with respect to ``X`` only (the JAX
wrapper's custom VJP, ``codebook_pallas.py:203-220``): the integer indices
and the table get none.
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import CodebookDense
from . import _build

__all__ = ["codebook_spmm", "codebook_spmm_reference", "codebook_matmul"]

_ARGTYPES = (
    ctypes.c_void_p,  # idx (n, k) uint8, 16-byte aligned
    ctypes.c_void_p,  # table (table_len,) fp32
    ctypes.c_int,  # table_len
    ctypes.c_void_p,  # X, 16-byte aligned
    ctypes.c_longlong,  # ldx
    ctypes.c_int,  # x_kmajor
    ctypes.c_int,  # x_bf16
    ctypes.c_void_p,  # out (n, m)
    ctypes.c_int,  # n
    ctypes.c_int,  # k
    ctypes.c_int,  # m
    ctypes.c_int,  # split (0: the kernel's choice)
    ctypes.c_void_p,  # work (split, n, m) fp32 for a split above 1, or null
    ctypes.c_void_p,  # stream
)
_SPLIT_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int)  # n, k, m


def codebook_spmm_reference(idx: torch.Tensor, table: torch.Tensor,
                            X: torch.Tensor) -> torch.Tensor:
    """Plain version with the kernel's arithmetic: the fp32 table lookup,
    one fp32 matrix product, the result in X's type (as the Pallas kernel,
    ``codebook_pallas.py:200``).  The table is padded to 256 zero slots,
    so any index byte is safe."""
    return (_table256(table)[idx.long()] @ X.float()).to(X.dtype)


def _table256(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([table, table.new_zeros(256 - table.numel())])


def x_layout(X: torch.Tensor):
    """``(X, ldx, kmajor)`` for a kernel that reads ``X(r, c)`` at
    ``X[r * ldx + c]`` or, when ``kmajor``, at ``X[r + c * ldx]``.  A
    row-major tensor and a transposed view such as ``a.T`` are read as
    they are; any other layout is copied to row-major first."""
    if X.stride(1) == 1:
        return X, X.stride(0), False
    if X.stride(0) == 1:
        return X, X.stride(1), True
    X = X.contiguous()
    return X, X.stride(0), False


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _codebook_spmm_cuda(idx: torch.Tensor, table: torch.Tensor,
                        X: torch.Tensor, *, split: int = 0) -> torch.Tensor:
    """The kernel.  ``split`` (the ways k is cut: 1, 2, 4 or 8; 0: the
    kernel's choice, ``codebook_split``) is a knob for measurements only;
    each split gives the product, its partials summed in split order by
    a second kernel."""
    if not (idx.is_cuda and table.device == idx.device and X.device == idx.device):
        raise ValueError("codebook_spmm: idx, table and X must lie on one "
                         "CUDA device")
    if idx.dtype != torch.uint8 or idx.dim() != 2 or not idx.is_contiguous():
        raise ValueError("codebook_spmm: idx must be a contiguous 2-D uint8 "
                         "tensor")
    if (table.dtype != torch.float32 or table.dim() != 1
            or not 1 <= table.numel() <= 256 or not table.is_contiguous()):
        raise ValueError("codebook_spmm: table must be a contiguous fp32 "
                         "vector of 1 to 256 entries")
    if X.dtype not in (torch.float32, torch.bfloat16) or X.dim() != 2:
        raise ValueError("codebook_spmm: X must be a 2-D fp32 or bf16 tensor")
    if split not in (0, 1, 2, 4, 8):
        raise ValueError(f"codebook_spmm: split must be 0, 1, 2, 4 or 8, not "
                         f"{split}")
    n, k = idx.shape
    if X.shape[0] != k:
        raise ValueError(f"codebook_spmm: X shape {tuple(X.shape)} does not "
                         f"match idx shape {tuple(idx.shape)}")
    m = X.shape[1]
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    if n == 0 or m == 0:
        return out
    # the kernel's 16-byte copies start on 16 bytes of each base: a view
    # that starts elsewhere is copied
    if not _aligned(idx):
        idx = idx.clone()
    X, ldx, kmajor = x_layout(X)
    if not _aligned(X):
        X, ldx, kmajor = x_layout(
            X.clone(memory_format=torch.contiguous_format))
    S = split or codebook_split(n, k, m, X.device)
    work = None
    if S > 1:
        work = torch.empty((S, n, m), dtype=torch.float32, device=X.device)
    fn = _build.load("codebook_spmm", _ARGTYPES)
    with torch.cuda.device(X.device):
        err = fn(idx.data_ptr(), table.data_ptr(), table.numel(),
                 X.data_ptr(), ldx, int(kmajor),
                 int(X.dtype == torch.bfloat16), out.data_ptr(), n, k, m,
                 S, None if work is None else work.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"codebook_spmm: launch failed with CUDA error {err}")
    _build.launch_counts["codebook_spmm"] += 1
    return out


def codebook_split(n: int, k: int, m: int, device: torch.device) -> int:
    """The ways the kernel cuts k by default for an (n, k) index plane and m
    columns of X: the most of 1, 2, 4, 8 that keeps its blocks within one
    a streaming multiprocessor of ``device`` and each split at least two
    steps of 32."""
    fn = _build.load("codebook_spmm", _SPLIT_ARGTYPES, "codebook_spmm_split")
    with torch.cuda.device(device):
        return int(fn(n, k, m))


class _CodebookSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, table, X):
        ctx.save_for_backward(idx, table)
        if all(t.device.type == "cpu" for t in (idx, table, X)):
            return codebook_spmm_reference(idx, table, X)
        return _codebook_spmm_cuda(idx, table, X)

    @staticmethod
    def backward(ctx, dY):
        # dX = dequant(idx)^T @ dY — one lookup on the cold path
        idx, table = ctx.saved_tensors
        if not ctx.needs_input_grad[2]:
            return None, None, None
        B = _table256(table)[idx.long()]  # (n, k)
        dX = (B.T @ dY.to(B.dtype)).to(dY.dtype)
        return None, None, dX


def codebook_spmm(idx: torch.Tensor, table: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """``table[idx] @ X`` for a uint8 index plane ``idx`` (n, k), a table of
    at most 256 values with its sentinel 0, and ``X`` (k, m) in fp32 or
    bf16; the result (n, m) has X's type."""
    return _CodebookSpmm.apply(idx, table, X)


def codebook_matmul(a: torch.Tensor, b_t: CodebookDense) -> torch.Tensor:
    """``A @ B`` with ``b_t`` storing B^T as a CodebookDense (n, k);
    differentiable with respect to ``a``."""
    return codebook_spmm(b_t.idx, b_t.val_table, a.T).T
