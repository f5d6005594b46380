"""Integer-activation GEMM — the reference's ``wgemm_plus`` capability.

Twin of ``sparsematrix_tpu/ops/quantized.py``.  The reference's vendored
OpenBLAS fork ships a non-standard int16 activation GEMM
(``cblas_wgemm_plus``) so quantized activations can multiply the
codebook-quantized weights without an fp32 blow-up.  Here activations
are quantized per tensor, the ≤255-entry codebook is quantized to int8
once at build time, the contraction runs int8×int8→int32, and one scalar
rescale recovers the fp32 result.

The JAX products are plain ``dot_general`` outside any Pallas kernel, so
the integer product here is a library call too: ``torch._int_mm``
(cuBLASLt's int8 GEMM on the card).  On the card it needs more than 16
rows and a depth and width that are multiples of 8; ``int8_matmul`` pads
with zeros, which is exact for an integer product, and slices the result.

Accuracy: the codebook already restricts weights to ≤255 distinct values,
so an 8-bit weight grid loses little; activations get the usual
per-tensor symmetric int8 error (~0.4 % of the dynamic range).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.base import sparse_container, static_field
from ..formats.codebook_dense import CodebookDense

__all__ = ["QuantizedCodebookDense", "quantize_codebook",
           "add_mat_mat_int8", "add_mat_mat_int16", "int8_matmul"]


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int8 ``a`` (m, k) and ``b`` (k, n), exact in int32.

    Rows are padded to at least 17 and k and n to multiples of 8 with
    zeros (``torch._int_mm``'s shape rule on the card), and the result is
    sliced back."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError("int8_matmul: both operands must be int8")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    mp, kp, np_ = max(m, 17), _up(max(k, 1), 8), _up(max(n, 1), 8)
    ap = F.pad(a, (0, kp - k, 0, mp - m)).contiguous()
    # the second operand column-major, cuBLASLt's int8 layout
    bp = F.pad(b.T, (0, kp - k, 0, np_ - n)).contiguous().T
    return torch._int_mm(ap, bp)[:m, :n]


@sparse_container
@dataclasses.dataclass(frozen=True)
class QuantizedCodebookDense:
    """Codebook matrix with an int8-quantized table (built once)."""

    idx: torch.Tensor  # (rows, cols) uint8
    q_table: torch.Tensor  # (table_size+1,) int8, sentinel 0
    scale: torch.Tensor  # () fp32 — table dequant scale
    shape: Tuple[int, int] = static_field()
    table_size: int = static_field()

    @property
    def q_dense(self) -> torch.Tensor:
        """int8 dense weight matrix (gathered at each call)."""
        return self.q_table[self.idx.long()]


def quantize_codebook(B: CodebookDense) -> QuantizedCodebookDense:
    """Quantize the value table to int8 (symmetric, per-tensor)."""
    table = B.val_table.detach().float().cpu().numpy()
    amax = float(np.abs(table).max())
    scale = amax / 127.0 if amax > 0 else 1.0
    # np.round rounds half to even, as jnp.round and torch.round do
    q = np.clip(np.round(table / scale), -127, 127).astype(np.int8)
    q[-1] = 0  # sentinel stays exactly zero
    dev = B.idx.device
    return QuantizedCodebookDense(
        idx=B.idx,
        q_table=torch.from_numpy(q).to(dev),
        scale=torch.tensor(scale, dtype=torch.float32, device=dev),
        shape=B.shape,
        table_size=B.table_size,
    )


def _finish(prod: torch.Tensor, factor: torch.Tensor, c, beta):
    out = factor * prod
    if c is not None:
        out = out + beta * c
    return out


def add_mat_mat_int8(a, b_t_q: QuantizedCodebookDense, c=None,
                     alpha=1.0, beta=0.0):
    """``beta*C + alpha * A @ B`` with int8 activations × int8 codebook.

    ``b_t_q`` stores B^T (the ``SblasTrans`` convention).  A is quantized
    per-tensor symmetric; the int32 contraction runs on the integer path;
    one rescale restores fp32."""
    if beta != 0 and c is None:
        raise ValueError("add_mat_mat_int8: beta != 0 requires c")
    a_amax = torch.clamp(a.abs().max(), min=1e-30)
    a_scale = a_amax / 127.0
    aq = torch.clamp(torch.round(a / a_scale), -127, 127).to(torch.int8)
    bq = b_t_q.q_dense  # (n, k) int8
    prod_i32 = int8_matmul(aq, bq.T)  # (m, n)
    return _finish(prod_i32.float(), alpha * a_scale * b_t_q.scale, c, beta)


def add_mat_mat_int16(a, b_t_q: QuantizedCodebookDense, c=None,
                      alpha=1.0, beta=0.0):
    """``beta*C + alpha * A @ B`` with int16 activations × int8 codebook —
    the direct ``cblas_wgemm_plus`` analogue.

    The integer product is int8×int8→int32, so the int16 activation is
    split into two int8 planes::

        a16 = 256·hi + (lo' + 128),  hi, lo' ∈ [-128, 127]
        A@B = 256·(hi@B) + lo'@B + 128·colsum(B)

    Two integer products buy a 256× finer activation grid; each partial
    stays inside int32 (≤ k·128·127), and the colsum too."""
    if beta != 0 and c is None:
        raise ValueError("add_mat_mat_int16: beta != 0 requires c")
    a_amax = torch.clamp(a.abs().max(), min=1e-30)
    a_scale = a_amax / 32767.0
    aq = torch.clamp(torch.round(a / a_scale), -32767, 32767).to(torch.int32)
    hi = (aq >> 8).to(torch.int8)                    # floor-div: -128..127
    lo = (aq - ((aq >> 8) << 8) - 128).to(torch.int8)  # residual-128
    bq = b_t_q.q_dense  # (n, k) int8
    p_hi = int8_matmul(hi, bq.T)
    p_lo = int8_matmul(lo, bq.T)
    colsum = bq.to(torch.int32).sum(dim=1)  # (n,) int32
    prod = (256.0 * p_hi.float() + p_lo.float()
            + 128.0 * colsum.float()[None, :])
    return _finish(prod, alpha * a_scale * b_t_q.scale, c, beta)
