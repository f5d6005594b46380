"""Distributed Krylov solvers over a row-partitioned CSR.

Twin of ``sparsematrix_tpu/parallel/dist_solve.py``.  The JAX solvers run
the whole iteration inside one ``shard_map`` region under a
``lax.while_loop``; here each rank runs the same loop on its host, with
the JAX stopping rules, and every rank reads the same all-reduced
residual once an iteration and so takes the same branch.  An iteration
communicates what the JAX one does: one all-gather of the search
direction (the matvec) and the scalar ``psum``s, two dot products stacked
into one where JAX stacks them.  State (x, r, p, z) stays in this rank's
row band the whole solve.

Preconditioning is local by construction (block-diagonal): ``"jacobi"``
inverts the diagonal of the local band; a ``ShardedPrecond``
(``dist_precond.py``) applies this rank's factors; any other callable
gets ``(r_local, rank)`` and returns a local band.

Calling convention (``mesh.py``): ``b`` (and ``x0``) are this rank's
bands of ``local_rows`` values (``shard_vector(b, mesh,
length=n * local_rows)``); the result's ``x`` is this rank's band, its
``iters`` and ``residual`` the same on every rank.  With ``tol <= 0`` the
residual is not read (a ``tol=0, maxiter=k`` run does k iterations).
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from ..solvers.krylov import SolveResult
from .dist_ops import local_product
from .mesh import Mesh, shard_partitioned
from .partition import PartitionedCSR

__all__ = ["dist_cg", "dist_bicgstab", "dist_gmres"]


def _local_diag_inv(ix, dd, rid, local_rows: int, row0: int):
    """The inverse diagonal of the local row band (Jacobi): an entry is
    diagonal iff its global column is its global row; padding entries
    (row ``local_rows``) are dropped; a zero diagonal inverts to 1."""
    rid = rid.long()
    is_diag = ix.long() == rid + row0
    diag = torch.zeros(local_rows + 1, dtype=dd.dtype, device=dd.device)
    diag.index_add_(0, rid.clamp(max=local_rows),
                    torch.where(is_diag, dd, torch.zeros_like(dd)))
    diag = diag[:local_rows]
    big = diag.abs() > 1e-30
    ones = torch.ones_like(diag)
    return torch.where(big, 1.0 / torch.where(big, diag, ones), ones)


class _Env:
    """One rank's matvec, preconditioner and global dot products."""

    def __init__(self, part: PartitionedCSR, mesh: Mesh, axis_name, precond,
                 name: str):
        from .dist_precond import ShardedPrecond

        if part.partition_axis != "rows":
            raise ValueError(f"{name} requires a row-partitioned matrix")
        if part.shape[0] != part.shape[1]:
            raise ValueError(f"{name} requires a square matrix, got "
                             f"{part.shape}")
        self.mesh, self.axis = mesh, axis_name
        p = shard_partitioned(part, mesh, axis_name)
        _, self.ix, self.dd, self.rid = p.local_csr_arrays()
        self.part = part
        rank = mesh.axis_index(axis_name)
        if isinstance(precond, str) and precond == "jacobi":
            dinv = _local_diag_inv(self.ix, self.dd, self.rid,
                                   part.local_rows, rank * part.local_rows)
            self.M = lambda r: r * dinv
        elif isinstance(precond, ShardedPrecond):
            local = precond.state[rank]
            if local is None:
                raise ValueError(f"{name}: the preconditioner holds no "
                                 f"factors for rank {rank}")
            self.M = lambda r: precond.fn(r, local)
        elif callable(precond):
            self.M = lambda r: precond(r, rank)
        else:
            self.M = lambda r: r

    def matvec(self, v):
        v_full = self.mesh.all_gather(v, self.axis)[: self.part.shape[1]]
        return local_product(self.ix, self.dd, self.rid, v_full,
                             self.part.local_rows)

    def dots(self, *pairs):
        """The global dot products of (a, c) pairs, in one all-reduce."""
        local = torch.stack([torch.dot(a, c) for a, c in pairs])
        return self.mesh.psum(local, self.axis)


def dist_cg(part: PartitionedCSR, b, mesh: Mesh, axis_name: str = "shard",
            precond: Union[None, str, Callable] = None, x0=None,
            tol: float = 1e-6, maxiter: int = 1000) -> SolveResult:
    """Conjugate gradients for SPD ``A`` row-partitioned over ``mesh``.
    An iteration: one all-gather (the matvec), one scalar psum (p·Ap) and
    one stacked psum of r·z and r·r; the stopping test reads that r·r."""
    env = _Env(part, mesh, axis_name, precond, "dist_cg")
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - env.matvec(x)
    z = env.M(r)
    p = z
    rz, rr = env.dots((r, z), (r, r))
    bnorm = torch.sqrt(env.dots((b, b))[0].clamp_min(1e-60))
    k = 0
    while k < maxiter and (tol <= 0 or float(
            torch.sqrt(rr.clamp_min(0.0)) / bnorm) > tol):
        Ap = env.matvec(p)
        alpha = rz / env.dots((p, Ap))[0].clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = env.M(r)
        rz_new, rr = env.dots((r, z), (r, r))
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
    return SolveResult(x=x, iters=k, residual=torch.sqrt(rr.clamp_min(0.0)))


def _nz(t):
    """``t`` with an exact 0 replaced by 1e-30 (the JAX guard)."""
    return torch.where(t == 0, torch.full_like(t, 1e-30), t)


def dist_bicgstab(part: PartitionedCSR, b, mesh: Mesh,
                  axis_name: str = "shard",
                  precond: Union[None, str, Callable] = None, x0=None,
                  tol: float = 1e-6, maxiter: int = 1000) -> SolveResult:
    """BiCGSTAB for general row-partitioned ``A``, preconditioned on the
    right (the residual is the true one).  An iteration: two all-gathered
    matvecs and four psums (rho, rhat·v, a stacked t·t / t·s, and r·r
    recomputed).  On rho or t·t collapsing below 1e3·tiny the solver stops
    with ``breakdown`` set (with ``tol <= 0`` neither the residual nor the
    breakdown flag is read)."""
    env = _Env(part, mesh, axis_name, precond, "dist_bicgstab")
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - env.matvec(x)
    rhat = r
    rr = env.dots((r, r))[0]
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    bnorm = torch.sqrt(env.dots((b, b))[0].clamp_min(1e-60))
    eps_bd = torch.finfo(b.dtype).tiny * 1e3
    bad = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter:
        if tol > 0:
            # one read an iteration: the residual test and the breakdown
            rel, stop = torch.stack([torch.sqrt(rr.clamp_min(0.0)) / bnorm,
                                     bad.to(rr.dtype)]).tolist()
            if stop or rel <= tol:
                break
        rho_new = env.dots((rhat, r))[0]
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        phat = env.M(p)
        v = env.matvec(phat)
        alpha = rho_new / _nz(env.dots((rhat, v))[0])
        s = r - alpha * v
        shat = env.M(s)
        t = env.matvec(shat)
        tt, ts = env.dots((t, t), (t, s))
        omega = torch.where(tt == 0, torch.zeros_like(tt), ts / _nz(tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rr = env.dots((r, r))[0]
        # rho or t·t ~ 0: the method broke down; stop and flag
        bad = (rho_new.abs() < eps_bd) | (tt.abs() < eps_bd)
        rho = rho_new
        k += 1
    return SolveResult(x=x, iters=k, residual=torch.sqrt(rr.clamp_min(0.0)),
                       breakdown=bool(bad))


def dist_gmres(part: PartitionedCSR, b, mesh: Mesh, axis_name: str = "shard",
               precond: Union[None, str, Callable] = None, x0=None,
               tol: float = 1e-6, restart: int = 20,
               maxiter: int = 50) -> SolveResult:
    """Restarted GMRES(m) for general row-partitioned ``A``, left
    preconditioned (M⁻¹A), stopping on the true residual recomputed each
    cycle.  The Krylov basis stays in this rank's band as (m+1,
    local_rows); an Arnoldi step is one all-gather (the matvec) and two
    stacked psums of length m+1 (classical Gram-Schmidt with one
    re-orthogonalization, CGS2).  The small least-squares problem is
    replicated scalar math: every rank solves it on its host, in fp64, with
    the SVD (minimum norm, as ``jnp.linalg.lstsq``), so the zero columns an
    early breakdown leaves are harmless.  ``maxiter`` counts restart cycles and
    ``iters`` is cycles × restart, an upper bound when convergence comes
    mid-cycle (the JAX convention)."""
    env = _Env(part, mesh, axis_name, precond, "dist_gmres")
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")
    x = torch.zeros_like(b) if x0 is None else x0
    nloc, dtype, dev = b.shape[0], b.dtype, b.device
    bnorm = float(torch.sqrt(env.dots((b, b))[0].clamp_min(1e-60)))
    steps = torch.arange(m + 1, device=dev)
    eps = torch.finfo(dtype).eps

    def rnorm_of(xx):
        rt = b - env.matvec(xx)
        return torch.sqrt(env.dots((rt, rt))[0].clamp_min(0.0))

    rnorm = rnorm_of(x)
    k = 0
    while k < maxiter and (tol <= 0 or float(rnorm) / bnorm > tol):
        r = env.M(b - env.matvec(x))
        beta = torch.sqrt(env.dots((r, r))[0].clamp_min(1e-60))
        V = torch.zeros((m + 1, nloc), dtype=dtype, device=dev)
        V[0] = r / beta
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        for j in range(m):
            w = env.M(env.matvec(V[j]))
            mask = (steps <= j).to(dtype)
            h1 = env.mesh.psum(V @ w, env.axis) * mask
            w = w - h1 @ V
            h2 = env.mesh.psum(V @ w, env.axis) * mask
            w = w - h2 @ V
            h = h1 + h2
            wnorm = torch.sqrt(env.dots((w, w))[0].clamp_min(0.0))
            hnorm = torch.sqrt(torch.dot(h, h).clamp_min(0.0))
            # happy breakdown: w numerically inside span(V) — a zero column
            # instead of normalized noise
            tiny = wnorm <= eps * hnorm.clamp_min(1.0)
            H[:, j] = h
            H[j + 1, j] = torch.where(tiny, torch.zeros_like(wnorm), wnorm)
            V[j + 1] = torch.where(tiny, torch.zeros_like(w),
                                   w / wnorm.clamp_min(1e-30))
        e1 = torch.zeros(m + 1, 1, dtype=torch.float64)
        e1[0, 0] = float(beta)
        y = torch.linalg.lstsq(H.double().cpu(), e1, driver="gelsd")
        y = y.solution[:, 0].to(dev, dtype)
        x = x + y @ V[:m]
        rnorm = rnorm_of(x)
        k += 1
    return SolveResult(x=x, iters=k * m, residual=rnorm)
