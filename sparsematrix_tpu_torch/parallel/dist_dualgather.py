"""Distributed SpMV / SpMM with the dual-gather kernels as the local
compute.

Twin of ``sparsematrix_tpu/parallel/dist_dualgather.py``: the composition
of ``dist_rowlane.py`` (row partition, RHS all-gathered) with each band
dual-gather-packed at ``k_tiles=1``, so the local products are
``spmv_dualgather`` (``csrc/spmv_dualgather.cu``, table rows 10/11) and
``spmm_dualgather`` (``csrc/spmm_dualgather.cu``, rows 13/14).  Padding
groups repeat the band's last tile with zero values and add exactly 0.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..formats.base import (cached_on, sparse_container, static_field,
                            values_version)
from ..formats.csr import CSR
from ..kernels.spmm_dualgather import spmm_dualgather
from ..kernels.spmv_dualgather import (DualGather, pack_dualgather,
                                       spmv_dualgather)
from .dist_rowlane import row_bands
from .mesh import Mesh, shard_partitioned

__all__ = ["PartitionedDualGather", "partition_dualgather",
           "dist_spmv_dualgather", "dist_spmm_dualgather"]

_LANES = 128


@sparse_container
@dataclasses.dataclass(frozen=True)
class PartitionedDualGather:
    idxA: torch.Tensor  # (n_shards, n_groups, group*8, 128) int8
    idxB: torch.Tensor  # (n_shards, n_groups, group*8, 128) int8
    vals: torch.Tensor  # (n_shards, n_groups, group*8, 128)
    group_tile: torch.Tensor  # (n_shards, n_groups) int32
    slab_win: torch.Tensor  # (n_shards, n_groups, group) int32
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    band_rows: int = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    nnz: int = static_field()


def partition_dualgather(csr: CSR, n_shards: int, group: int = 32,
                         dtype=None) -> PartitionedDualGather:
    """Row-partition and dual-gather-pack each band (host; the stacked
    planes stay on the CPU)."""
    sp, b, bands = row_bands(csr, n_shards)
    packs = []
    for local in bands:
        p = pack_dualgather(CSR.from_scipy(local, device="cpu"), group=group,
                            k_tiles=1, dtype=dtype, device="cpu")
        assert p.k_tiles == 1 and p.tail is None and not p.splits
        packs.append(p)
    n_groups = max(p.idxA.shape[0] for p in packs)
    gh = group * 8
    ia = torch.zeros((n_shards, n_groups, gh, _LANES), dtype=torch.int8)
    ib = torch.zeros((n_shards, n_groups, gh, _LANES), dtype=torch.int8)
    va = torch.zeros((n_shards, n_groups, gh, _LANES),
                     dtype=packs[0].vals.dtype)
    gt = torch.zeros((n_shards, n_groups), dtype=torch.int32)
    sw = torch.zeros((n_shards, n_groups, group), dtype=torch.int32)
    for s, p in enumerate(packs):
        g = p.idxA.shape[0]
        ia[s, :g] = p.idxA
        ib[s, :g] = p.idxB
        va[s, :g] = p.vals
        gt[s, :g] = p.group_tile
        gt[s, g:] = gt[s, g - 1] if g else 0  # no new tile starts
        sw[s, :g] = p.slab_win
    return PartitionedDualGather(
        idxA=ia, idxB=ib, vals=va, group_tile=gt, slab_win=sw,
        shape=sp.shape, n_shards=n_shards, band_rows=b,
        n_tiles=packs[0].n_tiles, n_win=packs[0].n_win, group=group,
        nnz=csr.nnz)


def local_dg(part: PartitionedDualGather, p_local) -> DualGather:
    """The k_tiles=1 ``DualGather`` of a one-shard slice (``_local_dg``)."""
    return DualGather(
        idxA=p_local.idxA[0], idxB=p_local.idxB[0], vals=p_local.vals[0],
        group_tile=p_local.group_tile[0], slab_win=p_local.slab_win[0],
        slab_tloc=None, commit=None, tail=None, t_pack=None,
        shape=(part.band_rows, part.shape[1]), n_tiles=part.n_tiles,
        n_win=part.n_win, group=part.group, k_tiles=1, nnz=0)


_LOCAL: dict = {}


def _local_dg_of(part: PartitionedDualGather, mesh: Mesh, axis_name):
    """This rank's ``local_dg``, made once per partition, rank and state of
    its planes, so that the SpMM walk's side structure (built once a pack)
    is too.  ``shard_partitioned`` copies host planes to the card: an
    in-place write into the partition's planes makes the copy anew."""
    packs = cached_on(_LOCAL, part, lambda _: {}, values_version(
        *(getattr(part, f) for f in part._data_fields)))
    key = (mesh.axis_index(axis_name), str(mesh.device))
    if key not in packs:
        packs[key] = local_dg(part, shard_partitioned(part, mesh, axis_name))
    return packs[key]


def dist_spmv_dualgather(part: PartitionedDualGather, x, mesh: Mesh,
                         axis_name: str = "shard"):
    """``y = A @ x``: this rank's x band in, its ``band_rows`` rows of y
    out; the local product on the dual-gather SpMV kernel."""
    x_full = mesh.all_gather(x, axis_name)[: part.shape[1]]
    return spmv_dualgather(_local_dg_of(part, mesh, axis_name), x_full)


def dist_spmm_dualgather(part: PartitionedDualGather, X, mesh: Mesh,
                         axis_name: str = "shard"):
    """``Y = A @ X`` (X cols × k, k ≤ 64, the walk's regime): this rank's
    X row band in, its ``band_rows`` rows of Y out; the local product on
    the dual-gather multi-RHS walk."""
    X_full = mesh.all_gather(X, axis_name)[: part.shape[1]]
    return spmm_dualgather(_local_dg_of(part, mesh, axis_name), X_full)
