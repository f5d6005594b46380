"""Krylov solvers (CG, BiCGSTAB) over the sparse ops, with optional
preconditioning (``ilu_apply``/``ic_apply`` partials or any callable).

Twin of ``sparsematrix_tpu/solvers/krylov.py``.  The JAX loop is a
``lax.while_loop`` that tests ``‖r‖/‖b‖ > tol`` on the device each
iteration; here the loop runs on the host and makes the same test each
iteration (one read of the residual norm), so it stops at the same
iteration rule.  With ``tol <= 0`` the test is skipped — it could only
stop a run whose residual is exactly 0 — so a ``tol=0, maxiter=k`` run
does exactly k iterations and never waits for the card: that run is how
the time of an iteration is measured.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.spmv import spmv

__all__ = ["cg", "bicgstab", "SolveResult"]


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # final ‖r‖ (0-d)
    # True when the method hit a numerical breakdown (BiCGSTAB's rho or
    # omega ~ 0) and stopped early; the residual is still reported
    breakdown: bool = False


def _as_linop(A) -> Callable:
    if callable(A):
        return A
    return lambda v: spmv(A, v)


def _running(r, bnorm, tol) -> bool:
    """The JAX loop's test ``‖r‖/‖b‖ > tol`` (a read of one scalar)."""
    return tol <= 0 or bool(torch.linalg.norm(r) / bnorm > tol)


def cg(A, b, x0=None, tol: float = 1e-6, maxiter: int = 1000,
       M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for SPD ``A`` (a sparse container, a pack, or a
    linear operator).  ``M`` is a preconditioner ``r -> M⁻¹ r``."""
    matvec = _as_linop(A)
    precond = M if M is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.linalg.norm(b).clamp_min(1e-30)
    k = 0
    while k < maxiter and _running(r, bnorm, tol):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
    return SolveResult(x=x, iters=k, residual=torch.linalg.norm(r))


def _nz(t):
    """``t`` with an exact 0 replaced by 1e-30 (the JAX guard)."""
    return torch.where(t == 0, torch.full_like(t, 1e-30), t)


def bicgstab(A, b, x0=None, tol: float = 1e-6, maxiter: int = 1000,
             M: Optional[Callable] = None) -> SolveResult:
    """BiCGSTAB for general (nonsymmetric) ``A``."""
    matvec = _as_linop(A)
    precond = M if M is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    bnorm = torch.linalg.norm(b).clamp_min(1e-30)
    k = 0
    while k < maxiter and _running(r, bnorm, tol):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / _nz(torch.dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = torch.dot(t, t)
        omega = torch.where(tt == 0, torch.zeros_like(tt),
                            torch.dot(t, s) / _nz(tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return SolveResult(x=x, iters=k, residual=torch.linalg.norm(r))
