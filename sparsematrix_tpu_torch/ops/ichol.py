"""IC(0) — incomplete Cholesky factorization with zero fill-in.

Twin of ``sparsematrix_tpu/ops/ichol.py``.  For SPD systems: factor
``A ≈ L Lᵀ`` on the pattern of ``tril(A)`` on the host
(``native/factor.cc``: smtpu_ic0, or the Python walk; both give the JAX
package's factor bit for bit), then precondition with ``M⁻¹ r = L⁻ᵀ
(L⁻¹ r)`` on any triangular-solve plan family, the upper solve on ``Lᵀ``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from ..formats.csr import CSR
from ..kernels import _build
from .ilu import FACTOR_ARGTYPES
from .trisolve import trisolve_fixpoint_plan, trisolve_level_plan, trisolve_plan

__all__ = ["ic0", "ic0_plans", "ic0_fixpoint_plans", "ic0_level_plans",
           "ic0_fused_plans", "ic0_waves_plans", "ic_apply"]


def _ic0_factor_python(indptr, indices, a, n):
    """The row-wise up-looking walk in Python (the native one's twin)."""
    for i in range(n):
        end = indptr[i + 1]
        if end == indptr[i] or indices[end - 1] != i:
            raise ValueError(f"ic0: missing diagonal at row {i}")
        for s in range(indptr[i], end):
            j = int(indices[s])
            acc = 0.0
            p, t = indptr[i], indptr[j]
            tend = indptr[j + 1] - 1
            while p < s and t < tend:
                if indices[p] < indices[t]:
                    p += 1
                elif indices[p] > indices[t]:
                    t += 1
                else:
                    acc += a[p] * a[t]
                    p += 1
                    t += 1
            if j < i:
                piv = a[tend]
                if piv <= 0.0:
                    raise ZeroDivisionError(
                        f"ic0: non-positive pivot at row {j}")
                a[s] = (a[s] - acc) / piv
            else:
                d = a[s] - acc
                if d <= 0.0:
                    raise ZeroDivisionError(
                        f"ic0: non-positive pivot at row {i}")
                a[s] = np.sqrt(d)


def _ic0_factor_native(indptr, indices, a, n) -> bool:
    """The native walk (``native/factor.cc``: smtpu_ic0); False where no
    ``g++`` is found."""
    fn = _build.load_host("factor", "smtpu_ic0", FACTOR_ARGTYPES)
    if fn is None:
        return False
    ip = np.ascontiguousarray(indptr, np.int64)
    ix = np.ascontiguousarray(indices, np.int32)
    rc = fn(ip.ctypes.data, ix.ctypes.data, a.ctypes.data, n)
    if rc == 0:
        return True
    if rc >= -n:
        raise ValueError(f"ic0: missing diagonal at row {-1 - rc}")
    raise ZeroDivisionError(f"ic0: non-positive pivot at row {-rc - n - 1}")


def ic0(A: CSR) -> CSR:
    """Factor SPD ``A ≈ L Lᵀ`` on ``tril(A)``'s pattern; returns L on A's
    device.  Only the lower triangle of ``A`` is read."""
    sp = A.to_scipy().tocsr()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("ic0 needs a square matrix")
    low = sps.tril(sp, k=0).tocsr()
    low.sort_indices()
    indptr = low.indptr.astype(np.int64)
    indices = low.indices
    a = np.ascontiguousarray(low.data, np.float64).copy()
    if not _ic0_factor_native(indptr, indices, a, n):
        _ic0_factor_python(indptr, indices, a, n)
    L = sps.csr_matrix((a.astype(sp.data.dtype), indices, low.indptr),
                       shape=(n, n))
    return CSR.from_scipy(L, device=A.device)


def _lt(L: CSR) -> CSR:
    """Host-side ``Lᵀ`` (upper triangular) for the second solve."""
    return CSR.from_scipy(L.to_scipy().T.tocsr(), device=L.device)


def ic0_plans(A: CSR):
    """Factor + level-scheduled solve plans: ``(L lower, Lᵀ upper)``."""
    L = ic0(A)
    return (trisolve_plan(L, lower=True, unit_diagonal=False),
            trisolve_plan(_lt(L), lower=False, unit_diagonal=False))


def ic0_fixpoint_plans(A: CSR, n_iters: int | None = None, **pack_kwargs):
    """Factor + fixed-point (row-lane SpMV) solve plans; ``n_iters``
    truncates both solves."""
    L = ic0(A)
    return (
        trisolve_fixpoint_plan(L, lower=True, unit_diagonal=False,
                               n_iters=n_iters, **pack_kwargs),
        trisolve_fixpoint_plan(_lt(L), lower=False, unit_diagonal=False,
                               n_iters=n_iters, **pack_kwargs),
    )


def ic0_level_plans(A: CSR, **plan_kwargs):
    """Factor + level-packed solve plans (one row-lane SpMV a level)."""
    L = ic0(A)
    return (trisolve_level_plan(L, lower=True, unit_diagonal=False,
                                **plan_kwargs),
            trisolve_level_plan(_lt(L), lower=False, unit_diagonal=False,
                                **plan_kwargs))


def ic0_fused_plans(A: CSR, **plan_kwargs):
    """Factor + fused single-launch solve plans."""
    from ..kernels.trisolve_fused import trisolve_fused_plan

    L = ic0(A)
    return (trisolve_fused_plan(L, lower=True, unit_diagonal=False,
                                **plan_kwargs),
            trisolve_fused_plan(_lt(L), lower=False, unit_diagonal=False,
                                **plan_kwargs))


def ic0_waves_plans(A: CSR, **plan_kwargs):
    """Factor + wave-solve plans (host-inverted diagonal blocks)."""
    from ..kernels.trisolve_waves import trisolve_waves_plan

    L = ic0(A)
    return (trisolve_waves_plan(L, lower=True, unit_diagonal=False,
                                **plan_kwargs),
            trisolve_waves_plan(_lt(L), lower=False, unit_diagonal=False,
                                **plan_kwargs))


def ic_apply(plans, r):
    """Apply ``M⁻¹ r = L⁻ᵀ (L⁻¹ r)``: ``ilu_apply``'s dispatch over any
    (lower, upper) plan pair."""
    from .ilu import ilu_apply

    return ilu_apply(plans, r)
