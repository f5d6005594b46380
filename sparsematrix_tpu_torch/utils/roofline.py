"""Roofline accounting: HBM-traffic models per op/format → speed-of-light
nnz/s on the card, so measured numbers can be reported as % of SoL.

Twin of ``sparsematrix_tpu/utils/roofline.py``.  The byte models
(``spmv_csr_bytes``, ``spmm_bytes``, ``speed_of_light_nnz_s``) are the JAX
package's, unchanged, so a SoL % means the same in both packages; the
denominator is the card's published spec sheet (``H100_SXM``).  Sparse
ops are memory-bound: the ceiling is HBM bytes moved, not FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ChipSpec", "H100_SXM", "PEAK_FP32", "PEAK_BF16", "PEAK_BYTES",
           "spmv_csr_bytes", "spmm_bytes", "speed_of_light_nnz_s",
           "set_measured_chip", "measured_chip", "active_chip"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # HBM bandwidth GB/s
    bf16_tflops: float
    fp32_tflops: float


# NVIDIA H100 SXM data sheet (dense rates, 700 W): HBM3 3.35 TB/s,
# 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them
H100_SXM = ChipSpec(name="H100 SXM", hbm_gbps=3350.0, bf16_tflops=989.0,
                    fp32_tflops=67.0)

# the same peaks in FLOP/s and bytes/s, for bounds (``chip_smoke.py``)
PEAK_FP32 = H100_SXM.fp32_tflops * 1e12
PEAK_BF16 = H100_SXM.bf16_tflops * 1e12
PEAK_BYTES = H100_SXM.hbm_gbps * 1e9

# Constants measured by a run (the suite's calibrate rows): recorded
# to normalize one run against another, never the SoL denominator.
_MEASURED: ChipSpec | None = None


def set_measured_chip(hbm_gbps: float, bf16_tflops: float | None = None,
                      fp32_tflops: float | None = None) -> ChipSpec:
    """Record roofline constants measured by a run (context only)."""
    global _MEASURED
    _MEASURED = ChipSpec(
        name="measured",
        hbm_gbps=float(hbm_gbps),
        bf16_tflops=float(bf16_tflops or H100_SXM.bf16_tflops),
        fp32_tflops=float(fp32_tflops or H100_SXM.fp32_tflops),
    )
    return _MEASURED


def active_chip() -> ChipSpec:
    """The SoL denominator: always the spec sheet."""
    return H100_SXM


def measured_chip() -> ChipSpec | None:
    return _MEASURED


def spmv_csr_bytes(nnz: int, rows: int, cols: int, val_bytes: int = 4,
                   idx_bytes: int = 4) -> int:
    """Minimum HBM traffic for CSR SpMV: read data + indices + x once,
    write y once.  (x re-reads due to random access are excluded — this is
    the optimistic speed-of-light.)"""
    return nnz * (val_bytes + idx_bytes) + cols * val_bytes + rows * val_bytes


def spmm_bytes(nnz: int, rows: int, cols: int, k: int, val_bytes: int = 4,
               idx_bytes: int = 4, stored_block_waste: float = 1.0) -> int:
    """Minimum HBM traffic for SpMM vs k dense RHS columns.
    ``stored_block_waste`` ≥ 1 inflates matrix bytes for padded block
    layouts (blocked-ELL stores zero-filled blocks)."""
    matrix = int(nnz * (val_bytes + idx_bytes) * stored_block_waste)
    rhs = cols * k * val_bytes
    out = rows * k * val_bytes
    return matrix + rhs + out


def speed_of_light_nnz_s(nnz: int, traffic_bytes: int,
                         chip: ChipSpec | None = None) -> float:
    """nnz/s if the op ran at full HBM bandwidth (the spec sheet's, unless
    a chip is given)."""
    if chip is None:
        chip = active_chip()
    seconds = traffic_bytes / (chip.hbm_gbps * 1e9)
    return nnz / seconds
