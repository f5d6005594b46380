"""Block conjugate gradients for several right-hand sides.

Twin of ``sparsematrix_tpu/solvers/block.py``.  Block CG (O'Leary 1980)
advances all k right-hand sides through one Krylov space: an iteration is
one SpMM, two (n,k)ᵀ(n,k) Gram products and two k×k solves.  ``M`` may be
an ``ic_apply``/``ilu_apply`` partial over wave plans, whose (n, k)
residual panel then takes the 8-RHS trisolve kernel.

The loop runs on the host and tests every column's ``‖r_j‖/‖b_j‖ > tol``
each iteration, the JAX loop's rule; with ``tol <= 0`` the test is
skipped, so a ``tol=0, maxiter=k`` run does exactly k iterations and never
waits for the card.  The k×k solves do not check for a singular matrix
(no host sync), as the JAX ``jnp.linalg.solve`` does not.  Products run
in full fp32 (TF32 is off, ``config.py``), the JAX code's HIGHEST.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.spmm import spmm

__all__ = ["block_cg", "BlockSolveResult"]


class BlockSolveResult(NamedTuple):
    x: torch.Tensor  # (n, k)
    iters: int
    residuals: torch.Tensor  # (k,) final per-column ‖r_j‖


def _as_linop_mm(A) -> Callable:
    if callable(A):
        return A
    return lambda V: spmm(A, V)


def block_cg(A, B, X0=None, tol: float = 1e-6, maxiter: int = 1000,
             M: Optional[Callable] = None,
             reg: float = 1e-12) -> BlockSolveResult:
    """Block CG for SPD ``A`` and a right-hand-side panel ``B`` (n, k).

    ``M`` is a panel preconditioner ``R -> M⁻¹ R``.  Stops when every
    column satisfies ``‖r_j‖ ≤ tol·‖b_j‖``.  ``reg`` regularizes the k×k
    systems once columns converge (their directions go rank-deficient)."""
    matmat = _as_linop_mm(A)
    precond = M if M is not None else (lambda R: R)
    k = B.shape[1]
    X = torch.zeros_like(B) if X0 is None else X0
    R = B - matmat(X)
    Z = precond(R)
    P = Z
    G = R.T @ Z
    bnorm = torch.linalg.norm(B, dim=0).clamp_min(1e-30)
    eye = torch.eye(k, dtype=B.dtype, device=B.device)

    def solve_kxk(S, T):
        return torch.linalg.solve_ex(S + reg * eye, T,
                                     check_errors=False).result

    it = 0
    while it < maxiter and (tol <= 0 or bool(
            (torch.linalg.norm(R, dim=0) / bnorm > tol).any())):
        Q = matmat(P)
        alpha = solve_kxk(P.T @ Q, G)  # (PᵀAP)⁻¹ RᵀZ
        X = X + P @ alpha
        R = R - Q @ alpha
        Z = precond(R)
        G_new = R.T @ Z
        beta = solve_kxk(G, G_new)
        P = Z + P @ beta
        G = G_new
        it += 1
    return BlockSolveResult(x=X, iters=it,
                            residuals=torch.linalg.norm(R, dim=0))
