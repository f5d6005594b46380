"""Distributed SpMM with pre-densified row bands.

Twin of ``sparsematrix_tpu/parallel/dist_dense.py``: for the
densify-eligible regime each rank's row band is materialized once at
partition time and the local product is one dense product of the band
and the gathered RHS.  The JAX package leaves that product to XLA
(``jnp.dot``, ``dist_dense.py:109,141``), so here it is a plain
``torch.matmul``: fp32 at full precision (TF32 off, ``config.py``), bf16
bands in bf16.

* ``dist_spmm_dense``: 1-D row partition, X all-gathered, Y's row band
  out.
* ``dist_spmm_dense_2d``: a ('row', 'col') mesh; X's column panel
  gathered over 'row' only, Y sharded (row, col) with no reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats.base import sparse_container, static_field
from ..formats.csr import CSR
from .mesh import Mesh, shard_partitioned

__all__ = ["PartitionedDense", "partition_dense_rows", "dist_spmm_dense",
           "dist_spmm_dense_2d", "shard_dense"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class PartitionedDense:
    bands: torch.Tensor  # (n_shards, local_rows, cols)
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    local_rows: int = static_field()
    nnz: int = static_field()


def partition_dense_rows(csr: CSR, n_shards: int,
                         dtype=None) -> PartitionedDense:
    """Dense row bands of ceil(rows / n) rows (host, once).
    ``dtype=torch.bfloat16`` stores them in bf16."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    bands = np.zeros((n_shards, local_rows, cols), sp.dtype)
    for s in range(n_shards):
        r0, r1 = s * local_rows, min((s + 1) * local_rows, rows)
        if r0 < rows:
            bands[s, : r1 - r0] = sp[r0:r1].toarray()
    out = torch.from_numpy(bands)
    if dtype is not None:
        out = out.to(dtype)
    return PartitionedDense(bands=out, shape=(rows, cols), n_shards=n_shards,
                            local_rows=local_rows, nnz=csr.nnz)


def shard_dense(part: PartitionedDense, mesh: Mesh,
                axis_name: str = "shard") -> PartitionedDense:
    """This rank's band on its device (``shard_partitioned``)."""
    return shard_partitioned(part, mesh, axis_name)


def dist_spmm_dense(part: PartitionedDense, X, mesh: Mesh,
                    axis_name: str = "shard"):
    """``Y = A @ X``: this rank's X row band (ceil(cols / n) rows) in, its
    ``local_rows`` rows of Y out."""
    p = shard_partitioned(part, mesh, axis_name)
    X_full = mesh.all_gather(X, axis_name)[: part.shape[1]]
    b = p.bands[0]
    return torch.matmul(b, X_full.to(b.dtype))


def dist_spmm_dense_2d(part: PartitionedDense, X, mesh: Mesh):
    """``Y = A @ X`` on a ('row', 'col') mesh: A row-partitioned over
    'row' (``n_shards`` must be the 'row' size), this rank's (row, col)
    block of X in (ceil(cols / n_row) × ceil(k / n_col)), its
    (``local_rows`` × ceil(k / n_col)) block of Y out."""
    if part.n_shards != mesh.shape["row"]:
        raise ValueError("partition count must match the mesh 'row' size")
    p = shard_partitioned(part, mesh, "row")
    X_panel = mesh.all_gather(X, "row")[: part.shape[1]]
    b = p.bands[0]
    return torch.matmul(b, X_panel.to(b.dtype))
