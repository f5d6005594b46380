"""Distributed block-format SpMM: a row-partitioned BlockedELL.

Twin of ``sparsematrix_tpu/parallel/dist_block.py``: each rank owns a band
of block-rows (stacked on a leading shard axis), the dense RHS is
all-gathered, and the local product is the JAX package's einsum over the
gathered X blocks (``dist_block.py:96-99``), so it stays plain torch
(fp32 at full precision, TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..formats.base import sparse_container, static_field
from ..formats.ell import BlockedELL
from .mesh import Mesh, shard_partitioned

__all__ = ["PartitionedBlockedELL", "partition_bell_rows", "shard_bell",
           "dist_spmm_bell"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class PartitionedBlockedELL:
    block_cols: torch.Tensor  # (n_shards, local_nbr, M)
    blocks: torch.Tensor  # (n_shards, local_nbr, M, bm, bk)
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    local_nbr: int = static_field()
    block_shape: Tuple[int, int] = static_field()
    nnz: int = static_field()


def partition_bell_rows(bell: BlockedELL,
                        n_shards: int) -> PartitionedBlockedELL:
    """Bands of ceil(nbr / n) block-rows; a padding block-row has block
    column 0 and zero blocks (host; the planes stay on the CPU)."""
    nbr, M = bell.block_cols.shape
    bm, bk = bell.block_shape
    local_nbr = -(-nbr // n_shards)
    bc_src = bell.block_cols.cpu()
    bl_src = bell.blocks.cpu()
    bc = torch.zeros((n_shards, local_nbr, M), dtype=bc_src.dtype)
    bl = torch.zeros((n_shards, local_nbr, M, bm, bk), dtype=bl_src.dtype)
    for s in range(n_shards):
        r0, r1 = s * local_nbr, min((s + 1) * local_nbr, nbr)
        bc[s, : max(r1 - r0, 0)] = bc_src[r0:r1]
        bl[s, : max(r1 - r0, 0)] = bl_src[r0:r1]
    return PartitionedBlockedELL(block_cols=bc, blocks=bl, shape=bell.shape,
                                 n_shards=n_shards, local_nbr=local_nbr,
                                 block_shape=(bm, bk), nnz=bell.nnz)


def shard_bell(part: PartitionedBlockedELL, mesh: Mesh,
               axis_name: str = "shard") -> PartitionedBlockedELL:
    """This rank's block-rows on its device (``shard_partitioned``)."""
    return shard_partitioned(part, mesh, axis_name)


def dist_spmm_bell(part: PartitionedBlockedELL, X, mesh: Mesh,
                   axis_name: str = "shard"):
    """``Y = A @ X``: this rank's X row band in (X padded to n bands of
    ceil(nbc·bk / n) rows, nbc = ceil(cols / bk): ``shard_vector(X, mesh,
    length=nbc * bk)``), its ``local_nbr · bm`` rows of Y out."""
    bm, bk = part.block_shape
    nbc = -(-part.shape[1] // bk)
    k = X.shape[1]
    p = shard_partitioned(part, mesh, axis_name)
    X_full = mesh.all_gather(X, axis_name)[: nbc * bk]
    Xb = X_full.reshape(nbc, bk, k)
    blocks = p.blocks[0]
    dt = torch.promote_types(blocks.dtype, Xb.dtype)
    gathered = Xb[p.block_cols[0].long()].to(dt)  # (local_nbr, M, bk, k)
    acc = torch.einsum("rmij,rmjk->rik", blocks.to(dt), gathered)
    return acc.reshape(part.local_nbr * bm, k)
