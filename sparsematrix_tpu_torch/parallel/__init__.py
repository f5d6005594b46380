"""The distribution layer on ``torch.distributed``.

Twin of ``sparsematrix_tpu/parallel``, without ``dist_spgemm`` (a later
item).  One process a rank: ``initialize_multihost`` (or
``init_process_group``), then ``make_mesh``/``make_mesh_2d``.  The
partitioners return the JAX package's stacked planes (on the host);
``shard_partitioned`` keeps this rank's slice on its device; every
``dist_*`` takes this rank's band of x or X and returns its band of y or
Y (``shard_vector``/``gather_vector`` cut and join bands by the JAX
padding rules).  See ``mesh.py``.
"""
from .dist2d import dist_spmm_2d, make_mesh_2d
from .dist_block import (PartitionedBlockedELL, dist_spmm_bell,
                         partition_bell_rows, shard_bell)
from .dist_dense import (PartitionedDense, dist_spmm_dense,
                         dist_spmm_dense_2d, partition_dense_rows, shard_dense)
from .dist_dualgather import (PartitionedDualGather, dist_spmm_dualgather,
                              dist_spmv_dualgather, partition_dualgather)
from .dist_ops import dist_spmm, dist_spmv, make_mesh, shard_partitioned
from .dist_precond import (ShardedPrecond, block_ic0_precond,
                           block_ilu0_precond)
from .dist_rowlane import (PartitionedRowLane, dist_spmm_rowlane,
                           dist_spmv_rowlane, partition_rowlane)
from .dist_solve import dist_bicgstab, dist_cg, dist_gmres
from .halo import (HaloPartitionedCSR, RingHaloCSR, VarHaloPartitionedCSR,
                   dist_spmv_halo, dist_spmv_halo_ring, dist_spmv_halo_var,
                   partition_csr_halo, partition_csr_halo_ring,
                   partition_csr_halo_var, shard_halo, shard_halo_ring)
from .mesh import Mesh, gather_vector, shard_vector
from .multihost import global_mesh, initialize_multihost
from .partition import PartitionedCSR, partition_csr_cols, partition_csr_rows
from .scaling import (CollectiveCost, halo_cost, spmm_col_cost,
                      spmm_row_cost, spmv_col_cost, spmv_row_cost,
                      weak_scaling_table)

__all__ = [
    "PartitionedRowLane",
    "partition_rowlane",
    "dist_spmv_rowlane",
    "dist_spmm_rowlane",
    "PartitionedDense",
    "partition_dense_rows",
    "shard_dense",
    "dist_spmm_dense",
    "dist_spmm_dense_2d",
    "PartitionedCSR",
    "partition_csr_rows",
    "partition_csr_cols",
    "dist_spmv",
    "dist_spmm",
    "dist_bicgstab",
    "dist_cg",
    "ShardedPrecond",
    "PartitionedDualGather",
    "partition_dualgather",
    "dist_spmv_dualgather",
    "dist_spmm_dualgather",
    "block_ic0_precond",
    "block_ilu0_precond",
    "dist_gmres",
    "shard_partitioned",
    "make_mesh",
    "PartitionedBlockedELL",
    "partition_bell_rows",
    "shard_bell",
    "dist_spmm_bell",
    "HaloPartitionedCSR",
    "VarHaloPartitionedCSR",
    "partition_csr_halo",
    "partition_csr_halo_ring",
    "dist_spmv_halo_ring",
    "shard_halo_ring",
    "RingHaloCSR",
    "partition_csr_halo_var",
    "dist_spmv_halo_var",
    "CollectiveCost",
    "spmv_row_cost",
    "spmv_col_cost",
    "spmm_row_cost",
    "spmm_col_cost",
    "halo_cost",
    "weak_scaling_table",
    "shard_halo",
    "dist_spmv_halo",
    "make_mesh_2d",
    "dist_spmm_2d",
    "initialize_multihost",
    "global_mesh",
    "Mesh",
    "shard_vector",
    "gather_vector",
]
