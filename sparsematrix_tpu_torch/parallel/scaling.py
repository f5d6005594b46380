"""Weak-scaling accounting: per-device collective bytes and compute work.

Twin of ``sparsematrix_tpu/parallel/scaling.py``: the same byte counts,
which the partition geometry fixes exactly, so that scaling efficiency
can be modelled from a measured single-card throughput and the bytes a
device exchanges.  Model: a step on ``n`` devices takes local compute
bytes / HBM rate + collective bytes / link rate (no overlap: pessimistic);
weak-scaling efficiency is t(1) / t(n) with the problem grown in
proportion.

The rates are an H100 SXM's, not the TPU's: HBM3 at 3.35 TB/s (NVIDIA
H100 Tensor Core GPU data sheet, SXM5 column, "GPU memory bandwidth") and
NVLink 4 at 900 GB/s a card, 450 GB/s each way (the same data sheet,
"Interconnect"; NVIDIA Hopper architecture white paper, NVLink section).
The link stands where the JAX model has ICI.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = ["CollectiveCost", "spmv_row_cost", "spmv_col_cost",
           "spmm_row_cost", "spmm_col_cost", "halo_cost",
           "weak_scaling_table"]

# H100 SXM (module docstring): HBM3 3.35 TB/s; NVLink 4, 450 GB/s each way
HBM_GBPS = 3350.0
LINK_GBPS = 450.0


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """Per-device, per-op-invocation byte accounting."""

    op: str
    n_devices: int
    collective: str
    comm_bytes_per_device: int  # bytes each device moves over the link
    local_compute_bytes: int  # bytes each device streams from HBM
    notes: str = ""

    def step_time_s(self, hbm_gbps: float = HBM_GBPS,
                    link_gbps: float = LINK_GBPS) -> float:
        return (self.local_compute_bytes / (hbm_gbps * 1e9)
                + self.comm_bytes_per_device / (link_gbps * 1e9))


def _itemsize(dtype) -> int:
    return int(np.dtype(dtype).itemsize)


def _ag_bytes(total_len: int, n: int, itemsize: int) -> int:
    """all_gather: each device receives (n-1)/n of the full array."""
    return int(total_len * itemsize * (n - 1) // max(n, 1))


def spmv_row_cost(rows: int, cols: int, nnz: int, n: int,
                  dtype=np.float32, index_bytes: int = 4) -> CollectiveCost:
    it = _itemsize(dtype)
    return CollectiveCost(
        op="dist_spmv(rows)", n_devices=n, collective="all_gather(x)",
        comm_bytes_per_device=_ag_bytes(cols, n, it),
        local_compute_bytes=(nnz // n) * (it + index_bytes),
        notes="x all-gathered; rows and nnz split n ways",
    )


def spmv_col_cost(rows: int, cols: int, nnz: int, n: int,
                  dtype=np.float32, index_bytes: int = 4,
                  reduce: str = "psum_scatter") -> CollectiveCost:
    it = _itemsize(dtype)
    if reduce == "psum":
        # ring all-reduce moves ~2x(n-1)/n of the vector per device
        comm = int(2 * rows * it * (n - 1) // max(n, 1))
    else:  # psum_scatter keeps the output sharded: half the bytes
        comm = int(rows * it * (n - 1) // max(n, 1))
    return CollectiveCost(
        op=f"dist_spmv(cols,{reduce})", n_devices=n,
        collective=reduce,
        comm_bytes_per_device=comm,
        local_compute_bytes=(nnz // n) * (it + index_bytes),
        notes="partial row sums reduced over devices",
    )


def spmm_row_cost(rows: int, cols: int, nnz: int, k: int, n: int,
                  dtype=np.float32, index_bytes: int = 4) -> CollectiveCost:
    it = _itemsize(dtype)
    return CollectiveCost(
        op="dist_spmm(rows)", n_devices=n, collective="all_gather(X)",
        comm_bytes_per_device=_ag_bytes(cols * k, n, it),
        local_compute_bytes=(nnz // n) * (it + index_bytes)
        + (nnz // n) * k * it,  # RHS rows touched per entry
        notes="X (n×k) all-gathered; A rows split",
    )


def spmm_col_cost(rows: int, cols: int, nnz: int, k: int, n: int,
                  dtype=np.float32, index_bytes: int = 4,
                  reduce: str = "psum_scatter") -> CollectiveCost:
    it = _itemsize(dtype)
    if reduce == "psum":
        comm = int(2 * rows * k * it * (n - 1) // max(n, 1))
    else:
        comm = int(rows * k * it * (n - 1) // max(n, 1))
    return CollectiveCost(
        op=f"dist_spmm(cols,{reduce})", n_devices=n, collective=reduce,
        comm_bytes_per_device=comm,
        local_compute_bytes=(nnz // n) * (it + index_bytes)
        + (nnz // n) * k * it,
        notes="partial (m×k) products reduced over devices",
    )


def halo_cost(part, dtype=np.float32, index_bytes: int = 4) -> CollectiveCost:
    """Cost of the variable-halo exchange (VarHaloPartitionedCSR)."""
    it = _itemsize(dtype)
    n = part.n_shards
    return CollectiveCost(
        op="dist_spmv_halo_var", n_devices=n, collective="ragged_all_to_all",
        comm_bytes_per_device=part.ragged_bytes // max(n, 1),
        local_compute_bytes=(part.nnz // n) * (it + index_bytes),
        notes=f"ragged {part.ragged_bytes}B vs padded {part.padded_bytes}B "
              "per exchange (all links)",
    )


def weak_scaling_table(base_rows: int, nnz_per_row: int, k: int = 0,
                       ns: List[int] = (1, 2, 4, 8),
                       measured_single_chip_gnnz: float | None = None,
                       dtype=np.float32) -> List[Dict]:
    """Weak scaling: rows grow ∝ n (constant per-device work).

    Returns one dict per device count with the modeled per-step time and
    efficiency t(1)/t(n); with ``measured_single_chip_gnnz`` (a card's
    measured Gnnz/s) the local compute term is calibrated to that kernel
    instead of the HBM roofline.
    """
    out = []
    t1 = None
    for n in ns:
        rows = base_rows * n
        nnz = rows * nnz_per_row
        if k:
            c = spmm_row_cost(rows, rows, nnz, k, n, dtype)
        else:
            c = spmv_row_cost(rows, rows, nnz, n, dtype)
        t = c.step_time_s()
        if measured_single_chip_gnnz:
            local = (nnz / n) / (measured_single_chip_gnnz * 1e9)
            t = local + c.comm_bytes_per_device / (LINK_GBPS * 1e9)
        if t1 is None:
            t1 = t
        out.append({
            "n_devices": n,
            "rows": rows,
            "nnz": nnz,
            "comm_bytes_per_device": c.comm_bytes_per_device,
            "local_compute_bytes": c.local_compute_bytes,
            "modeled_step_s": t,
            "weak_scaling_efficiency": t1 / t,
        })
    return out
