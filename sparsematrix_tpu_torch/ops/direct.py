"""Sparse direct solve: host SuperLU factorization, solves on the card.

Twin of ``sparsematrix_tpu/ops/direct.py``.  The factorization is host
set-up (scipy ``splu``); the triangular factors are planned for the wave
engine (or the fused one), so repeated solves against new right-hand
sides run on the card: a gather, two triangular solves, a gather.
scipy's convention is ``A = Prᵀ L U Pcᵀ``, hence ``x = Pc U⁻¹ L⁻¹ (Pr b)``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats.base import sparse_container, static_field
from ..formats.csr import CSR

__all__ = ["splu_plans", "splu_solve", "SpluSolver"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class SpluSolver:
    l_plan: object  # TriWavesPlan or TriFusedPlan, unit-lower
    u_plan: object  # TriWavesPlan or TriFusedPlan, upper
    inv_perm_r: torch.Tensor  # (n,) int32 — gather indices for Pr @ b
    perm_c: torch.Tensor  # (n,) int32 — gather indices for Pc @ y
    shape: Tuple[int, int] = static_field()
    lu_nnz: int = static_field()  # fill included


def splu_plans(A: CSR, engine: str = "waves", **plan_kwargs) -> SpluSolver:
    """Factor ``A`` (square, nonsingular) with SuperLU and plan the two
    triangular solves on A's device.  ``engine``: "waves" (host-inverted
    blocks) or "fused" (slab walk).  ``plan_kwargs`` go to the plan
    builder (``dtype=torch.bfloat16``, binv ``m=``)."""
    import scipy.sparse.linalg as spla

    from ..kernels.trisolve_fused import trisolve_fused_plan
    from ..kernels.trisolve_waves import trisolve_waves_plan

    if A.shape[0] != A.shape[1]:
        raise ValueError(f"splu needs a square matrix, got {A.shape}")
    if engine not in ("waves", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    lu = spla.splu(A.to_scipy().tocsc())
    n = A.shape[0]
    L = CSR.from_scipy(lu.L.tocsr(), device=A.device)
    U = CSR.from_scipy(lu.U.tocsr(), device=A.device)
    plan = trisolve_waves_plan if engine == "waves" else trisolve_fused_plan
    # (Pr @ b)[perm_r[i]] = b[i]  ⇔  gather with the inverse permutation
    inv_pr = np.empty(n, np.int32)
    inv_pr[lu.perm_r] = np.arange(n, dtype=np.int32)
    return SpluSolver(
        l_plan=plan(L, lower=True, unit_diagonal=True, **plan_kwargs),
        u_plan=plan(U, lower=False, unit_diagonal=False, **plan_kwargs),
        inv_perm_r=torch.from_numpy(inv_pr).to(A.device),
        perm_c=torch.from_numpy(lu.perm_c.astype(np.int32)).to(A.device),
        shape=tuple(A.shape),
        lu_nnz=int(lu.L.nnz + lu.U.nnz),
    )


def splu_solve(solver: SpluSolver, b: torch.Tensor) -> torch.Tensor:
    """``x = A⁻¹ b``: gather → L-solve → U-solve → gather.  ``b`` is (n,)
    or an (n, k) panel (the wave engine then solves 8 columns a launch)."""
    from ..kernels.trisolve_fused import (trisolve_fused_apply,
                                          trisolve_fused_apply_batched)
    from ..kernels.trisolve_waves import (TriWavesPlan, trisolve_waves_apply,
                                          trisolve_waves_apply_mm)

    waves = isinstance(solver.l_plan, TriWavesPlan)
    if b.dim() == 2:
        apply_ = (trisolve_waves_apply_mm if waves
                  else trisolve_fused_apply_batched)
    else:
        apply_ = trisolve_waves_apply if waves else trisolve_fused_apply
    y = b[solver.inv_perm_r.long()]
    y = apply_(solver.l_plan, y)
    y = apply_(solver.u_plan, y)
    return y[solver.perm_c.long()]
