"""Distributed SpMV / SpMM with the row-lane kernels as the local compute.

Twin of ``sparsematrix_tpu/parallel/dist_rowlane.py``: a 1-D row
partition, the RHS all-gathered, and each rank's row band packed for the
row-lane layout, so the local product is ``spmv_sell_rowlane``
(``csrc/spmv_rowlane.cu``, table row 7) or ``spmm_rowlane``
(``csrc/spmm_rowlane.cu``, row 8).

Each band (a whole number of 128-row tiles) is packed on its own
(``pack_sell_rowlane``), then the packs are equalized (one ``group``,
slab groups padded to the largest shard's) and stacked on a leading shard
axis, as ``PartitionedCSR`` is.  Padding groups point at the shard's last
tile with zero values: they add exactly 0 and start no new tile.  A band
past the last row (rows < n·128) packs as an empty matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import scipy.sparse as sps
import torch

from ..formats.base import cached_on, sparse_container, static_field
from ..formats.csr import CSR
from ..kernels.spmm_rowlane import spmm_rowlane
from ..kernels.spmv_rowlane import (SellRowLane, pack_sell_rowlane,
                                    spmv_sell_rowlane)
from .mesh import Mesh, shard_partitioned

__all__ = ["PartitionedRowLane", "partition_rowlane", "dist_spmv_rowlane",
           "dist_spmm_rowlane"]

_LANES = 128


@sparse_container
@dataclasses.dataclass(frozen=True)
class PartitionedRowLane:
    s_idx: torch.Tensor  # (n_shards, n_groups, group*8, 128) int8
    vals: torch.Tensor  # (n_shards, n_groups, group*8, 128)
    group_tile: torch.Tensor  # (n_shards, n_groups) int32
    slab_win: torch.Tensor  # (n_shards, n_groups, group) int32
    tile_nonempty: torch.Tensor  # (n_shards, n_tiles) bool
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    band_rows: int = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    lanes_per_row: int = static_field()
    nnz: int = static_field()


def row_bands(csr: CSR, n_shards: int):
    """(scipy CSR, band rows, [each band as a (band, cols) scipy CSR]):
    ceil(rows / n) rows a band rounded up to whole 128-row tiles (the
    bands of ``partition_rowlane`` and ``partition_dualgather``)."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    b = -(-rows // n_shards)
    b = -(-b // _LANES) * _LANES
    bands = []
    for s in range(n_shards):
        lo, hi = s * b, min((s + 1) * b, rows)
        local = sp[lo:hi] if lo < rows else sp[0:0]
        local = sps.csr_matrix(local, shape=(max(hi - lo, 0), cols))
        local.resize((b, cols))
        bands.append(local)
    return sp, b, bands


def partition_rowlane(csr: CSR, n_shards: int, group: int = 32,
                      dtype=None) -> PartitionedRowLane:
    """Row-partition and pack each band for the row-lane kernels (host;
    the stacked planes stay on the CPU).  ``dtype=torch.bfloat16`` stores
    the values in bf16."""
    sp, b, bands = row_bands(csr, n_shards)
    packs = [pack_sell_rowlane(CSR.from_scipy(local, device="cpu"),
                               group=group, dtype=dtype, device="cpu")
             for local in bands]
    n_groups = max(p.s_idx.shape[0] for p in packs)
    gh = group * 8
    si = torch.zeros((n_shards, n_groups, gh, _LANES), dtype=torch.int8)
    va = torch.zeros((n_shards, n_groups, gh, _LANES),
                     dtype=packs[0].vals.dtype)
    gt = torch.zeros((n_shards, n_groups), dtype=torch.int32)
    sw = torch.zeros((n_shards, n_groups, group), dtype=torch.int32)
    tne = torch.zeros((n_shards, packs[0].n_tiles), dtype=torch.bool)
    for s, p in enumerate(packs):
        assert p.group == group and p.spill is None
        g = p.s_idx.shape[0]
        si[s, :g] = p.s_idx
        va[s, :g] = p.vals
        gt[s, :g] = p.group_tile
        # padding groups: the last real group's tile (no new tile starts;
        # zero values add nothing)
        gt[s, g:] = gt[s, g - 1] if g else 0
        sw[s, :g] = p.slab_win
        tne[s] = p.tile_nonempty
    return PartitionedRowLane(
        s_idx=si, vals=va, group_tile=gt, slab_win=sw, tile_nonempty=tne,
        shape=sp.shape, n_shards=n_shards, band_rows=b,
        n_tiles=packs[0].n_tiles, n_win=packs[0].n_win, group=group,
        lanes_per_row=1, nnz=csr.nnz)


def local_sell(part: PartitionedRowLane, p_local) -> SellRowLane:
    """The ``SellRowLane`` of a one-shard slice (``_local_sell``)."""
    return SellRowLane(
        s_idx=p_local.s_idx[0], vals=p_local.vals[0],
        group_tile=p_local.group_tile[0], slab_win=p_local.slab_win[0],
        tile_nonempty=p_local.tile_nonempty[0], spill=None,
        spill_packed=None, t_pack=None, shape=(part.band_rows, part.shape[1]),
        n_tiles=part.n_tiles, n_win=part.n_win, group=part.group,
        lanes_per_row=part.lanes_per_row, nnz=0)


_LOCAL: dict = {}


def _local_sell_of(part: PartitionedRowLane, mesh: Mesh, axis_name):
    """This rank's ``local_sell``, made once per partition and rank, so
    that the rowlane kernel's side structures (built once a pack) are
    too."""
    packs = cached_on(_LOCAL, part, lambda _: {})
    key = (mesh.axis_index(axis_name), str(mesh.device))
    if key not in packs:
        packs[key] = local_sell(part, shard_partitioned(part, mesh,
                                                        axis_name))
    return packs[key]


def dist_spmv_rowlane(part: PartitionedRowLane, x, mesh: Mesh,
                      axis_name: str = "shard"):
    """``y = A @ x``: this rank's x band (ceil(cols / n) values) in, its
    ``band_rows`` rows of y out; the local product on the row-lane SpMV
    kernel."""
    x_full = mesh.all_gather(x, axis_name)[: part.shape[1]]
    return spmv_sell_rowlane(_local_sell_of(part, mesh, axis_name), x_full)


def dist_spmm_rowlane(part: PartitionedRowLane, X, mesh: Mesh,
                      axis_name: str = "shard"):
    """``Y = A @ X`` (k dense columns): this rank's X row band in, its
    ``band_rows`` rows of Y (fp32) out; the local product on the row-lane
    SpMM kernel (``spmm_rowlane``, table row 8)."""
    p = shard_partitioned(part, mesh, axis_name)
    X_full = mesh.all_gather(X, axis_name)[: part.shape[1]]
    return spmm_rowlane(local_sell(part, p), X_full)
