"""The solvers of the port (``solvers/krylov.py``, ``solvers/block.py``,
``ops/direct.py``) against the JAX package on the 32×32 Poisson system
(eps 1 and the stiff anisotropic eps 1000).

``cg``, ``bicgstab`` and ``block_cg`` must reach tol in the JAX solver's
iteration count within ±2 (summation order differs between the two
packages' products), and their solutions and ``splu_solve``'s must agree
with the JAX package's under ``relative_check`` (the reference's policy:
per-element relative error 0.1, 1e-4 outliers); every solution must
reach its tolerance against the fp64 matrix.

The JAX package's wave solve of an upper plan aborts XLA's CPU compiler
when jitted ("Invalid binary instruction opcode map": the reversal meets
the simplifier; ROADMAP Queue 3), and its solvers jit their loop, so the
JAX side runs each preconditioner through its level-scheduled plans: the
same operator, ``U⁻¹ L⁻¹`` of the same factors.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparsematrix_tpu_torch as smt
from sparsematrix_tpu_torch.utils.testutils import poisson2d, relative_check
from test_torch_trisolve import both, one_thread

jsolvers = importlib.import_module("sparsematrix_tpu.solvers")
jops = importlib.import_module("sparsematrix_tpu.ops")

TOL = 1e-5


@functools.lru_cache(maxsize=None)
def system(eps):
    if str(eps).startswith("convect"):  # unsymmetric: plus convection
        side = 16 if eps == "convect16" else 32
        n, sp = poisson2d(side * side)
        sp = sp + 0.5 * sps.kron(sps.eye(side), sps.diags(
            [-1.0, 1.0], [-1, 1], (side, side)))
    else:
        n, sp = poisson2d(1024, eps)
    sp = sp.tocsr().astype(np.float32)
    b = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    return sp, b


def _precond(name, A, JA):
    if name is None:
        return None, None
    tb, tapply = {"ic0-waves": (smt.ic0_waves_plans, smt.ic_apply),
                  "ilu0-waves": (smt.ilu0_waves_plans, smt.ilu_apply),
                  "ilu0-level-sched": (smt.ilu0_plans, smt.ilu_apply)}[name]
    jb, japply = {"ic0-waves": (jops.ic0_plans, jops.ic_apply),
                  "ilu0-waves": (jops.ilu0_plans, jops.ilu_apply),
                  "ilu0-level-sched": (jops.ilu0_plans, jops.ilu_apply)}[name]
    p, jp = tb(A), jb(JA)
    return (lambda r: tapply(p, r)), (lambda r: japply(jp, r))


def _check(sp, b, res, jres, bnorm_axis=None):
    x = res.x.double().numpy()
    assert abs(int(res.iters) - int(jres.iters)) <= 2
    assert relative_check(x, np.asarray(jres.x))
    true = np.linalg.norm(sp.astype(np.float64) @ x - b, axis=bnorm_axis)
    assert np.all(true <= 10 * TOL * np.linalg.norm(b, axis=bnorm_axis))


@pytest.mark.parametrize("eps,precond", [
    (1.0, None), (1.0, "ic0-waves"), (1000.0, "ic0-waves")])
def test_cg_matches_jax(eps, precond):
    sp, b = system(eps)
    A, JA = both(sp)
    M, JM = _precond(precond, A, JA)
    res = smt.cg(smt.prepare_spmv(A), torch.from_numpy(b), tol=TOL,
                 maxiter=3000, M=M)
    jres = jsolvers.cg(JA, jnp.asarray(b), tol=TOL, maxiter=3000, M=JM)
    _check(sp, b, res, jres)
    if precond is not None:  # the bench's check against plain CG
        assert res.iters <= 0.6 * smt.cg(
            smt.prepare_spmv(A), torch.from_numpy(b), tol=TOL,
            maxiter=3000).iters


def test_cg_fixed_iterations():
    """tol=0 runs exactly maxiter iterations (no residual test)."""
    sp, b = system(1.0)
    A, JA = both(sp)
    res = smt.cg(smt.prepare_spmv(A), torch.from_numpy(b), tol=0.0,
                 maxiter=7)
    jres = jsolvers.cg(JA, jnp.asarray(b), tol=0.0, maxiter=7)
    assert res.iters == int(jres.iters) == 7
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("precond", ["ilu0-waves"])
def test_bicgstab_matches_jax(precond):
    sp, b = system("convect")
    A, JA = both(sp)
    M, JM = _precond(precond, A, JA)
    res = smt.bicgstab(smt.prepare_spmv(A), torch.from_numpy(b), tol=TOL,
                       maxiter=2000, M=M)
    jres = jsolvers.bicgstab(JA, jnp.asarray(b), tol=TOL, maxiter=2000,
                             M=JM)
    _check(sp, b, res, jres)


@pytest.mark.parametrize("precond", ["ic0-waves"])
def test_block_cg_matches_jax(precond):
    sp, _ = system(1.0)
    A, JA = both(sp)
    B = np.random.default_rng(9).standard_normal((1024, 8)).astype(
        np.float32)
    M, JM = _precond(precond, A, JA)
    res = smt.block_cg(lambda V: smt.spmm(A, V), torch.from_numpy(B),
                       tol=TOL, maxiter=1000, M=M)
    jres = jsolvers.block_cg(JA, jnp.asarray(B), tol=TOL, maxiter=1000,
                             M=JM)
    assert abs(res.iters - int(jres.iters)) <= 2
    X = res.x.double().numpy()
    assert relative_check(X, np.asarray(jres.x))
    true = np.linalg.norm(sp.astype(np.float64) @ X - B, axis=0)
    assert np.all(true <= 10 * TOL * np.linalg.norm(B, axis=0))


@pytest.mark.parametrize("engine,multi", [("waves", False), ("waves", True),
                                          ("fused", False)])
def test_splu_solve_matches_jax(engine, multi):
    """On the 16×16 convection system (the fused engine's many SuperLU
    levels make its walk long; its panel path is held against JAX in
    ``test_torch_trisolve_fused.py``)."""
    sp, b = system("convect16")
    A, JA = both(sp)
    solver = smt.splu_plans(A, engine=engine)
    jsolver = jops.splu_plans(JA, engine=engine)
    assert solver.lu_nnz == jsolver.lu_nnz
    np.testing.assert_array_equal(solver.perm_c.numpy(),
                                  np.asarray(jsolver.perm_c))
    rhs = (np.random.default_rng(4).standard_normal((256, 3)).astype(
        np.float32) if multi else b)
    x = smt.splu_solve(solver, torch.from_numpy(rhs)).double().numpy()
    jx = np.asarray(jops.splu_solve(jsolver, jnp.asarray(rhs)))
    assert relative_check(x, jx)
    want = np.linalg.solve(sp.toarray().astype(np.float64), rhs)
    assert relative_check(x, want)
