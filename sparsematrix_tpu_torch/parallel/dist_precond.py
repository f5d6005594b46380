"""Per-shard block preconditioning for the distributed Krylov solvers.

Twin of ``sparsematrix_tpu/parallel/dist_precond.py``: block Jacobi with
incomplete factorizations.  Each shard owns the IC(0)/ILU(0) factors of
its diagonal block ``A_ii`` and applies them to its residual band with no
communication: through the wave solves (``engine="waves"``: the chain and
binv kernels, table rows 19/20) or the truncated-Neumann fixed point
(``engine="fixpoint"``: the row-lane SpMV, row 7).

The JAX package stacks the shards' plans along a shard axis, which needs
every shard's plan to share one static layout (it raises otherwise); here
each rank holds its own plan object, so ``state`` is a tuple of one plan
(pair) a shard and no layout need agree.  With a ``mesh`` only this
rank's block is factored, on the mesh's device (each process needs only
its own); the other entries are None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import scipy.sparse as sps

from ..formats.csr import CSR
from ..ops.ichol import ic0_fixpoint_plans, ic0_waves_plans
from ..ops.ilu import ilu0_fixpoint_plans, ilu0_waves_plans, ilu_apply

__all__ = ["ShardedPrecond", "block_ic0_precond", "block_ilu0_precond"]


@dataclasses.dataclass(frozen=True)
class ShardedPrecond:
    """A preconditioner with one state a shard.  ``fn(r_local, state[i])``
    returns ``M_i⁻¹ r_local`` for shard i; the dist solvers pass each rank
    its own entry."""

    state: Any  # tuple, one entry a shard (None where not built here)
    fn: Callable


def _local_block(sp, r0, lr, n):
    """The diagonal block of rows [r0, r0 + lr); past the last row, a unit
    diagonal keeps the factors exact."""
    real = min(n - r0, lr)
    blk = sp[r0:r0 + real, r0:r0 + real].tocoo()
    if real == lr:
        return blk.tocsr()
    pad = np.arange(real, lr)
    r = np.concatenate([blk.row, pad])
    c = np.concatenate([blk.col, pad])
    v = np.concatenate([blk.data, np.ones(lr - real, blk.data.dtype)])
    return sps.coo_matrix((v, (r, c)), shape=(lr, lr)).tocsr()


_PLANS = {("ic0", "waves"): ic0_waves_plans,
          ("ic0", "fixpoint"): ic0_fixpoint_plans,
          ("ilu0", "waves"): ilu0_waves_plans,
          ("ilu0", "fixpoint"): ilu0_fixpoint_plans}


def _block_factor_precond(A: CSR, n_shards: int, factor: str, engine: str,
                          mesh=None, axis_name: Optional[str] = None,
                          **plan_kwargs) -> ShardedPrecond:
    if engine not in ("waves", "fixpoint"):
        raise ValueError(f"unknown engine {engine!r}")
    build = _PLANS[(factor, engine)]
    sp = A.to_scipy().tocsr()
    n = sp.shape[0]
    lr = -(-n // n_shards)
    if mesh is None:
        shards, dev = range(n_shards), A.device
    else:
        shards, dev = [mesh.axis_index(axis_name)], mesh.device
    state = [None] * n_shards
    for s in shards:
        blk = CSR.from_scipy(_local_block(sp, s * lr, lr, n), device=dev)
        state[s] = build(blk, **plan_kwargs)
    return ShardedPrecond(state=tuple(state), fn=lambda r, plans: ilu_apply(
        plans, r))


def block_ic0_precond(A: CSR, n_shards: int, engine: str = "waves",
                      mesh=None, axis_name: Optional[str] = None,
                      **plan_kwargs) -> ShardedPrecond:
    """IC(0) of each shard's diagonal block, solved exactly each apply.
    ``engine``: "waves" (host-inverted block solves) or "fixpoint"
    (truncated Neumann series; pass ``n_iters=``)."""
    return _block_factor_precond(A, n_shards, "ic0", engine, mesh, axis_name,
                                 **plan_kwargs)


def block_ilu0_precond(A: CSR, n_shards: int, engine: str = "waves",
                       mesh=None, axis_name: Optional[str] = None,
                       **plan_kwargs) -> ShardedPrecond:
    """ILU(0) of each shard's diagonal block (nonsymmetric systems)."""
    return _block_factor_precond(A, n_shards, "ilu0", engine, mesh,
                                 axis_name, **plan_kwargs)
