"""2-D mesh distributed SpMM: matrix rows × RHS columns.

Twin of ``sparsematrix_tpu/parallel/dist2d.py``.  A is row-partitioned
over the 'row' axis (replicated over 'col'); the dense RHS is sharded
(rows over 'row', columns over 'col').  Each rank all-gathers its RHS
column panel over 'row' and runs the plain local product (gather and
segment-sum, as ``dist_ops``): Y lands sharded over both axes with no
reduction.
"""
from __future__ import annotations

from .dist_ops import local_product
from .mesh import Mesh, make_mesh_2d, shard_partitioned
from .partition import PartitionedCSR

__all__ = ["make_mesh_2d", "dist_spmm_2d"]


def dist_spmm_2d(part: PartitionedCSR, X, mesh: Mesh):
    """``Y = A @ X`` on a ('row', 'col') mesh.  ``part`` is a row partition
    with ``n_shards`` the 'row' size; this rank's (row, col) block of X in
    (ceil(cols / n_row) × ceil(k / n_col)), its (``local_rows`` ×
    ceil(k / n_col)) block of Y out."""
    if part.partition_axis != "rows" or part.n_shards != mesh.shape["row"]:
        raise ValueError("need row partition matching the mesh 'row' axis")
    p = shard_partitioned(part, mesh, "row")
    X_panel = mesh.all_gather(X, "row")[: part.shape[1]]
    _, ix, dd, rid = p.local_csr_arrays()
    return local_product(ix, dd, rid, X_panel, part.local_rows)
