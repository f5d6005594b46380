"""Row and column partitions of a CSR, stacked on a leading shard axis.

Twin of ``sparsematrix_tpu/parallel/partition.py``: the same planes,
``np.array_equal`` field by field.  Per-shard local CSR arrays are padded
to one static capacity and stacked on a leading axis of ``n_shards``;
padding entries hold zero data, column 0 and row ``local_rows``, so they
add nothing.  The stacked planes stay on the host (CPU tensors);
``shard_partitioned`` (``mesh.py``) puts one rank's slice on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats.base import sparse_container, static_field
from ..formats.csr import CSR

__all__ = ["PartitionedCSR", "partition_csr_rows", "partition_csr_cols"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Row- or column-partitioned CSR, stacked on a leading shard axis.

    For ``partition_axis="rows"``: shard i owns global rows
    [i*local_rows, ...), with global column ids.  For ``"cols"``: shard i
    owns global columns [i*local_cols, ...), column ids rebased to the
    band, every row.
    """

    indptr: torch.Tensor  # (n_shards, local_rows+1)
    indices: torch.Tensor  # (n_shards, cap) local (rebased) column ids
    data: torch.Tensor  # (n_shards, cap)
    row_ids: torch.Tensor  # (n_shards, cap) local rows (pad: local_rows)
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    partition_axis: str = static_field()  # "rows" | "cols"
    local_rows: int = static_field()
    local_cols: int = static_field()
    nnz: int = static_field()

    @property
    def capacity(self) -> int:
        return self.indices.shape[1]

    def local_csr_arrays(self):
        """(indptr, indices, data, row_ids) of a one-shard slice (leading
        axis 1, as ``shard_partitioned`` leaves it)."""
        return self.indptr[0], self.indices[0], self.data[0], self.row_ids[0]


def _planes(n_indptr, n_indices, n_data, n_rowids, idt):
    return (torch.from_numpy(n_indptr).to(idt),
            torch.from_numpy(n_indices).to(idt),
            torch.from_numpy(n_data),
            torch.from_numpy(n_rowids).to(idt))


def partition_csr_rows(csr: CSR, n_shards: int) -> PartitionedCSR:
    """``n_shards`` contiguous row bands of equal padded height, per-shard
    entries padded to the largest band's (host)."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    indptr_full = sp.indptr
    if local_rows * n_shards > rows:
        indptr_full = np.concatenate(
            [indptr_full, np.full(local_rows * n_shards - rows,
                                  indptr_full[-1], indptr_full.dtype)])
    shards = []
    for s in range(n_shards):
        r0 = s * local_rows
        lo, hi = indptr_full[r0], indptr_full[r0 + local_rows]
        shards.append((r0, int(lo), int(hi)))
    cap = max(max(hi - lo for _, lo, hi in shards), 1)
    n_indptr = np.zeros((n_shards, local_rows + 1), dtype=np.int64)
    n_indices = np.zeros((n_shards, cap), dtype=np.int64)
    n_data = np.zeros((n_shards, cap), dtype=sp.data.dtype)
    n_rowids = np.full((n_shards, cap), local_rows, dtype=np.int64)
    for s, (r0, lo, hi) in enumerate(shards):
        n_indptr[s] = indptr_full[r0: r0 + local_rows + 1] - lo
        k = hi - lo
        n_indices[s, :k] = sp.indices[lo:hi]
        n_data[s, :k] = sp.data[lo:hi]
        n_rowids[s, :k] = np.repeat(np.arange(local_rows),
                                    np.diff(n_indptr[s]))
    ip, ix, dd, rid = _planes(n_indptr, n_indices, n_data, n_rowids,
                              csr.indices.dtype)
    return PartitionedCSR(indptr=ip, indices=ix, data=dd, row_ids=rid,
                          shape=(rows, cols), n_shards=n_shards,
                          partition_axis="rows", local_rows=local_rows,
                          local_cols=cols, nnz=csr.nnz)


def partition_csr_cols(csr: CSR, n_shards: int) -> PartitionedCSR:
    """``n_shards`` column bands, each with every row and its column ids
    rebased to the band; products over it are partial sums reduced with
    ``psum`` or ``psum_scatter`` (host)."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_cols = -(-cols // n_shards)
    mats = [sp[:, s * local_cols: min((s + 1) * local_cols, cols)].tocsr()
            for s in range(n_shards)]
    cap = max(max(int(m.nnz) for m in mats), 1)
    n_indptr = np.zeros((n_shards, rows + 1), dtype=np.int64)
    n_indices = np.zeros((n_shards, cap), dtype=np.int64)
    n_data = np.zeros((n_shards, cap), dtype=sp.data.dtype)
    n_rowids = np.full((n_shards, cap), rows, dtype=np.int64)
    for s, m in enumerate(mats):
        n_indptr[s] = m.indptr
        k = int(m.nnz)
        n_indices[s, :k] = m.indices
        n_data[s, :k] = m.data
        n_rowids[s, :k] = np.repeat(np.arange(rows), np.diff(m.indptr))
    ip, ix, dd, rid = _planes(n_indptr, n_indices, n_data, n_rowids,
                              csr.indices.dtype)
    return PartitionedCSR(indptr=ip, indices=ix, data=dd, row_ids=rid,
                          shape=(rows, cols), n_shards=n_shards,
                          partition_axis="cols", local_rows=rows,
                          local_cols=local_cols, nnz=csr.nnz)
