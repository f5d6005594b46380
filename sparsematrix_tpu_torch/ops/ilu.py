"""ILU(0) — incomplete LU factorization with zero fill-in.

Twin of ``sparsematrix_tpu/ops/ilu.py``.  The factorization is host
set-up (IKJ on the CSR pattern, in ``native/factor.cc`` built by ``g++``
at first use, or the Python walk where no compiler is found; both give
the JAX package's factors bit for bit) producing unit-lower L and upper
U on A's pattern; the preconditioner ``M⁻¹ r = U⁻¹ (L⁻¹ r)`` runs on any
triangular-solve plan family.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats.csr import CSR
from ..kernels import _build
from .trisolve import (TriFixPlan, TriLevelPlan, TriSolvePlan, trisolve_apply,
                       trisolve_fixpoint_apply, trisolve_fixpoint_plan,
                       trisolve_level_apply, trisolve_level_plan,
                       trisolve_plan)

__all__ = ["ilu0", "ilu0_plans", "ilu0_fixpoint_plans", "ilu0_level_plans",
           "ilu0_fused_plans", "ilu0_waves_plans", "ilu_apply"]

FACTOR_ARGTYPES = (
    ctypes.c_void_p,  # indptr (n+1,) int64
    ctypes.c_void_p,  # indices int32, sorted per row
    ctypes.c_void_p,  # a fp64, in place
    ctypes.c_long,  # n
)


def _ilu0_factor_python(indptr, indices, a, n):
    """The IKJ walk in Python (the native factorization's twin)."""
    col_pos = [
        {int(indices[s]): s for s in range(indptr[i], indptr[i + 1])}
        for i in range(n)
    ]
    for i in range(n):
        if i not in col_pos[i]:
            raise ValueError(f"ilu0: missing diagonal at row {i}")
    for i in range(1, n):
        for s in range(indptr[i], indptr[i + 1]):
            k = int(indices[s])
            if k >= i:
                break
            piv = a[col_pos[k][k]]
            if piv == 0:
                raise ZeroDivisionError(f"ilu0: zero pivot at {k}")
            lik = a[s] / piv
            a[s] = lik
            for t in range(indptr[k], indptr[k + 1]):
                j = int(indices[t])
                if j <= k:
                    continue
                pos = col_pos[i].get(j)
                if pos is not None:
                    a[pos] -= lik * a[t]


def _ilu0_factor_native(indptr, indices, a, n) -> bool:
    """The native IKJ (``native/factor.cc``: smtpu_ilu0); False where no
    ``g++`` is found."""
    fn = _build.load_host("factor", "smtpu_ilu0", FACTOR_ARGTYPES)
    if fn is None:
        return False
    ip = np.ascontiguousarray(indptr, np.int64)
    ix = np.ascontiguousarray(indices, np.int32)
    rc = fn(ip.ctypes.data, ix.ctypes.data, a.ctypes.data, n)
    if rc == 0:
        return True
    if rc >= -n:
        raise ValueError(f"ilu0: missing diagonal at row {-1 - rc}")
    raise ZeroDivisionError(f"ilu0: zero pivot at {-rc - n - 1}")


def ilu0(A: CSR) -> Tuple[CSR, CSR]:
    """Factor A ≈ L @ U on A's sparsity pattern; L unit-lower (its unit
    diagonal stored), U upper, both on A's device."""
    sp = A.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("ilu0 needs a square matrix")
    indptr, indices = sp.indptr, sp.indices
    a = np.ascontiguousarray(sp.data, np.float64).copy()
    if not _ilu0_factor_native(indptr, indices, a, n):
        _ilu0_factor_python(indptr, indices, a, n)

    rid = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices.astype(np.int64)
    low = cols < rid
    dt = sp.data.dtype
    lr = np.concatenate([rid[low], np.arange(n)])
    lc = np.concatenate([cols[low], np.arange(n)])
    lv = np.concatenate([a[low], np.ones(n)]).astype(dt)
    L = CSR.from_scipy(sps.coo_matrix((lv, (lr, lc)), shape=(n, n)).tocsr(),
                       device=A.device)
    U = CSR.from_scipy(
        sps.coo_matrix((a[~low].astype(dt), (rid[~low], cols[~low])),
                       shape=(n, n)).tocsr(), device=A.device)
    return L, U


def ilu0_plans(A: CSR) -> Tuple[TriSolvePlan, TriSolvePlan]:
    """Factor + level-scheduled solve plans."""
    L, U = ilu0(A)
    return (trisolve_plan(L, lower=True, unit_diagonal=True),
            trisolve_plan(U, lower=False, unit_diagonal=False))


def ilu0_fixpoint_plans(A: CSR, n_iters: int | None = None,
                        **pack_kwargs) -> Tuple[TriFixPlan, TriFixPlan]:
    """Factor + fixed-point (row-lane SpMV) solve plans; ``n_iters``
    truncates both solves (an approximate preconditioner, still a fixed
    linear operator); ``None`` → exact."""
    L, U = ilu0(A)
    return (
        trisolve_fixpoint_plan(L, lower=True, unit_diagonal=True,
                               n_iters=n_iters, **pack_kwargs),
        trisolve_fixpoint_plan(U, lower=False, unit_diagonal=False,
                               n_iters=n_iters, **pack_kwargs),
    )


def ilu0_level_plans(A: CSR, **plan_kwargs) -> Tuple[TriLevelPlan,
                                                     TriLevelPlan]:
    """Factor + level-packed solve plans (one row-lane SpMV a level)."""
    L, U = ilu0(A)
    return (trisolve_level_plan(L, lower=True, unit_diagonal=True,
                                **plan_kwargs),
            trisolve_level_plan(U, lower=False, unit_diagonal=False,
                                **plan_kwargs))


def ilu0_fused_plans(A: CSR, **plan_kwargs):
    """Factor + fused single-launch solve plans."""
    from ..kernels.trisolve_fused import trisolve_fused_plan

    L, U = ilu0(A)
    return (trisolve_fused_plan(L, lower=True, unit_diagonal=True,
                                **plan_kwargs),
            trisolve_fused_plan(U, lower=False, unit_diagonal=False,
                                **plan_kwargs))


def ilu0_waves_plans(A: CSR, **plan_kwargs):
    """Factor + wave-solve plans (host-inverted diagonal blocks)."""
    from ..kernels.trisolve_waves import trisolve_waves_plan

    L, U = ilu0(A)
    return (trisolve_waves_plan(L, lower=True, unit_diagonal=True,
                                **plan_kwargs),
            trisolve_waves_plan(U, lower=False, unit_diagonal=False,
                                **plan_kwargs))


def ilu_apply(plans, r: torch.Tensor) -> torch.Tensor:
    """Apply the preconditioner ``M⁻¹ r`` for any plan family.  A 2-D
    ``r`` panel (n, k) takes the multi-RHS engines (waves: 8 RHS a
    launch; fused: a column at a time; the others a column at a time)."""
    from ..kernels.trisolve_fused import (TriFusedPlan, trisolve_fused_apply,
                                          trisolve_fused_apply_batched)
    from ..kernels.trisolve_waves import (TriWavesPlan, trisolve_waves_apply,
                                          trisolve_waves_apply_mm)

    lp, up = plans
    if isinstance(lp, TriFusedPlan):
        if r.dim() == 2:
            return trisolve_fused_apply_batched(
                up, trisolve_fused_apply_batched(lp, r))
        return trisolve_fused_apply(up, trisolve_fused_apply(lp, r))
    if isinstance(lp, TriWavesPlan):
        if r.dim() == 2:
            return trisolve_waves_apply_mm(up, trisolve_waves_apply_mm(lp, r))
        return trisolve_waves_apply(up, trisolve_waves_apply(lp, r))
    if isinstance(lp, TriFixPlan):
        solve = trisolve_fixpoint_apply
    elif isinstance(lp, TriLevelPlan):
        solve = trisolve_level_apply
    else:
        solve = trisolve_apply
    if r.dim() == 2:
        return torch.stack([solve(up, solve(lp, c)) for c in r.T], dim=1)
    return solve(up, solve(lp, r))
