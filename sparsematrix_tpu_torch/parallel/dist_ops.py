"""Distributed SpMV / SpMM over a row or column partition.

Twin of ``sparsematrix_tpu/parallel/dist_ops.py``.  Row partition: each
rank holds a row band of A and a band of x; x is all-gathered and each
rank runs its local product.  Column partition: each rank holds a column
band (rebased ids) and the matching x band; the local products are
partial sums reduced with ``psum`` (replicated y) or ``psum_scatter``
(each rank keeps its row band).  The local compute is the JAX package's
plain gather and segment-sum (``dist_ops.py:47-55``), so it stays plain
torch.  Calling convention (``mesh.py``): x in and y out are this rank's
bands.
"""
from __future__ import annotations

import torch

from .mesh import Mesh, band, make_mesh, shard_partitioned
from .partition import PartitionedCSR

__all__ = ["dist_spmv", "dist_spmm", "shard_partitioned", "make_mesh"]


def local_product(indices, data, row_ids, X, local_rows: int):
    """``segment_sum(data * X[indices], row_ids)`` over ``local_rows``
    segments; padding entries (row ``local_rows``) are dropped.  X a
    vector or a matrix."""
    prod = (data * X[indices.long()] if X.dim() == 1
            else data[:, None] * X[indices.long()])
    out = torch.zeros((local_rows + 1,) + tuple(X.shape[1:]),
                      dtype=prod.dtype, device=prod.device)
    out.index_add_(0, row_ids.long().clamp(max=local_rows), prod)
    return out[:local_rows]


def _dist_product(part: PartitionedCSR, x, mesh: Mesh, axis_name, reduce):
    p = shard_partitioned(part, mesh, axis_name)
    _, ix, dd, rid = p.local_csr_arrays()
    rows, cols = part.shape
    if part.partition_axis == "rows":
        x_full = mesh.all_gather(x, axis_name)[:cols]
        return local_product(ix, dd, rid, x_full, part.local_rows)
    if part.partition_axis != "cols":
        raise ValueError(part.partition_axis)
    if reduce not in ("psum", "psum_scatter"):
        raise ValueError(f"unknown reduce {reduce!r}")
    partial = local_product(ix, dd, rid, x, part.local_rows)
    if reduce == "psum":
        return mesh.psum(partial, axis_name)[:rows]
    rows_pad = part.n_shards * band(rows, part.n_shards)
    padded = torch.zeros((rows_pad,) + tuple(partial.shape[1:]),
                         dtype=partial.dtype, device=partial.device)
    padded[: part.local_rows] = partial
    return mesh.psum_scatter(padded, axis_name)


def dist_spmv(part: PartitionedCSR, x, mesh: Mesh, axis_name: str = "shard",
              reduce: str = "psum"):
    """``y = A @ x`` with A row- or column-partitioned over ``mesh``.

    ``x`` is this rank's band: ceil(cols / n) values of x zero-padded to
    n bands (``shard_vector``).  Row partition: returns this rank's
    ``local_rows`` rows of y.  Column partition: ``reduce="psum"`` returns
    y whole on every rank; ``"psum_scatter"`` this rank's band of
    ceil(rows / n) rows, at 1/n of the psum output bytes.
    """
    return _dist_product(part, x, mesh, axis_name, reduce)


def dist_spmm(part: PartitionedCSR, X, mesh: Mesh, axis_name: str = "shard",
              reduce: str = "psum"):
    """``Y = A @ X`` with X dense (cols × k): X's row band in, Y's row band
    out (or Y whole under ``psum``), as ``dist_spmv``."""
    return _dist_product(part, X, mesh, axis_name, reduce)
