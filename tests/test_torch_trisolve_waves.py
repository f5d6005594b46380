"""The wave triangular solve of the port (``kernels/trisolve_waves.py``)
against the JAX package.

Plans must be ``np.array_equal`` to the JAX plans field by field (bf16
planes bit for bit, the transposed plan and the gradient pattern
included) with equal statics.  ``trisolve_waves_apply``, ``_apply_mm``
and ``_solve`` (the plain chain and binv programs on the CPU) must agree
with an fp64 oracle, and on a case of each kind with the JAX kernels
(Pallas in interpret mode, a compile each), at the JAX tests' tolerance,
rtol 2e-3 and atol 1e-3 (3e-2 for bf16 plans, the JAX bf16 test's); so
must the cotangents in ``b`` and the values.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from test_torch_spmv import assert_same_container
from sparsematrix_tpu_torch.utils.testutils import tri_oracle, triangular
from test_torch_trisolve import SOLVE_TOL, both, jax_kw, one_thread, vec

jw = importlib.import_module("sparsematrix_tpu.kernels.trisolve_waves")
tw = importlib.import_module("sparsematrix_tpu_torch.kernels.trisolve_waves")
jilu = importlib.import_module("sparsematrix_tpu.ops.ilu")

BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@functools.lru_cache(maxsize=None)
def poisson_ilu(side):
    """The ILU(0) factors of the side×side Poisson system, as scipy."""
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    _, sp = poisson2d(side * side)
    L, U = jilu.ilu0(both(sp.astype(np.float32))[1])
    return L.to_scipy().astype(np.float32), U.to_scipy().astype(np.float32)


# name -> (scipy matrix, lower, unit, plan arguments, expected mode, K)
CASES = {
    "poisson-ilu-L": (lambda: poisson_ilu(32)[0], True, True, {}, "chain", 1),
    "poisson-ilu-U": (lambda: poisson_ilu(32)[1], False, False, {}, "chain",
                      1),
    "band-reach-1": (lambda: triangular(300, 2, band=100), True, False, {},
                     "chain", 1),
    "band-reach-2": (lambda: triangular(1300, 2, band=200), True, False, {},
                     "chain", 2),
    "band-reach-3": (lambda: triangular(1100, 4, band=380), True, False, {},
                     "chain", 3),
    "binv-m2": (lambda: triangular(900, 4), True, False, dict(m=2), "binv",
                None),
    "binv-m8": (lambda: triangular(1100, 5), True, False, dict(m=8), "binv",
                None),
    "binv-upper-unit": (lambda: triangular(640, 5, unit=True,
                                                lower=False),
                        False, True, dict(mode="binv", m=4), "binv", None),
    "bf16": (lambda: triangular(512, 2, band=90), True, False,
             dict(dtype=torch.bfloat16), "chain", 1),
    "with-transpose": (lambda: triangular(1300, 2, band=200), True, False,
                       dict(with_transpose=True), "chain", 2),
    "with-grads-binv": (lambda: triangular(384, 4, lower=False), False,
                        False, dict(mode="binv", m=2, with_grads=True),
                        "binv", None),
    "diagonal": (lambda: sps.diags(np.linspace(1, 2, 200)).tocsr().astype(
        np.float32), True, False, {}, "chain", 1),
}


@functools.lru_cache(maxsize=None)
def plans(name):
    mk, lower, unit, kw, _, _ = CASES[name]
    sp = mk()
    A, JA = both(sp)
    return (sp, tw.trisolve_waves_plan(A, lower=lower, unit_diagonal=unit,
                                       **kw),
            jw.trisolve_waves_plan(JA, lower=lower, unit_diagonal=unit,
                                   **jax_kw(kw)))


# the cases whose solve is also held against the JAX kernel (each JAX
# call compiles an interpret-mode kernel); every plan is compared
JAX_SOLVES = {"band-reach-3", "binv-m2", "binv-upper-unit", "bf16"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax_and_solves(name):
    _, lower, unit, kw, mode, K = CASES[name]
    sp, plan, jplan = plans(name)
    assert plan.mode == mode and (K is None or plan.K == K)
    assert_same_container(plan, jplan)
    b = vec(sp.shape[0], len(name))
    x = tw.trisolve_waves_apply(plan, torch.from_numpy(b)).numpy()
    tol = BF16_TOL if "dtype" in kw else SOLVE_TOL
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, unit), **tol)
    if name in JAX_SOLVES:
        jx = np.asarray(jw.trisolve_waves_apply(jplan, jnp.asarray(b)))
        np.testing.assert_allclose(x, jx, **tol)


@pytest.mark.parametrize("name,k,jax_cmp", [
    ("band-reach-2", 1, False), ("band-reach-2", 12, True),
    ("poisson-ilu-U", 8, False), ("binv-m2", 3, True)])
def test_apply_mm_matches_jax(name, k, jax_cmp):
    """8 RHS a chain pane (a ragged second pane at k = 12), the upper
    solve through the panel reversal, binv a column at a time; the JAX
    kernels (one interpret-mode compile each) on two of the cases."""
    _, lower, unit, _, _, _ = CASES[name]
    sp, plan, jplan = plans(name)
    B = vec(sp.shape[0], k, k=k)
    X = tw.trisolve_waves_apply_mm(plan, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X, tri_oracle(sp, B, lower, unit), **SOLVE_TOL)
    if jax_cmp:
        np.testing.assert_allclose(
            X, np.asarray(jw.trisolve_waves_apply_mm(jplan, jnp.asarray(B))),
            **SOLVE_TOL)


def test_rev_pad_is_the_jax_reversal():
    v = np.arange(1024, dtype=np.float32)
    for n in (1, 700, 1024):
        np.testing.assert_array_equal(
            tw._rev_pad(torch.from_numpy(v), n, 1024).numpy(),
            np.asarray(jw._rev_pad(jnp.asarray(v), n, 1024)))


@pytest.mark.parametrize("mm", [False, True])
def test_b_cotangent_matches_jax(mm):
    sp, plan, jplan = plans("with-transpose")
    n = sp.shape[0]
    b, g = vec(n, 1, k=3 if mm else None), vec(n, 2, k=3 if mm else None)
    fn, jfn = ((tw.trisolve_waves_apply_mm, jw.trisolve_waves_apply_mm) if mm
               else (tw.trisolve_waves_apply, jw.trisolve_waves_apply))
    bt = torch.from_numpy(b).requires_grad_()
    (fn(plan, bt) * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda bb: jfn(jplan, bb), jnp.asarray(b))
    (jgb,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), **SOLVE_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), tri_oracle(sp.T.tocsr(), g,
                                                       lower=False),
                               **SOLVE_TOL)


def test_backward_without_transpose_raises():
    _, plan, _ = plans("band-reach-1")
    bt = torch.from_numpy(vec(300)).requires_grad_()
    with pytest.raises(ValueError, match="with_transpose=True"):
        tw.trisolve_waves_apply(plan, bt).sum().backward()


@pytest.mark.parametrize("case", ["chain-unit", "binv-upper"])
def test_solve_value_and_b_cotangents_match_jax(case):
    if case == "chain-unit":
        sp, lower, unit = poisson_ilu(16)[0], True, True
        kw = dict(with_grads=True)
    else:
        sp, lower, unit = triangular(384, 4, lower=False), False, False
        kw = dict(mode="binv", m=2, with_grads=True)
    A, JA = both(sp)
    plan = tw.trisolve_waves_plan(A, lower=lower, unit_diagonal=unit, **kw)
    jplan = jw.trisolve_waves_plan(JA, lower=lower, unit_diagonal=unit,
                                   **kw)
    assert_same_container(plan, jplan)
    n = sp.shape[0]
    b, w = vec(n, 4), vec(n, 5)
    vals = A.data.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (tw.trisolve_waves_solve(plan, vals, bt)
     * torch.from_numpy(w)).sum().backward()

    def loss(v, bb):
        return jnp.vdot(jnp.asarray(w), jw.trisolve_waves_solve(jplan, v, bb))

    jgv, jgb = jax.grad(loss, argnums=(0, 1))(JA.data, jnp.asarray(b))
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(jgv),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), **SOLVE_TOL)
    np.testing.assert_allclose(bt.grad.numpy(),
                               tri_oracle(sp.T.tocsr(), w, not lower, unit),
                               **SOLVE_TOL)


def test_binv_m_not_dividing_8_raises():
    """The JAX binv commit places wave tiles inside one 8-row block, so a
    plan with m = 3 solves wrongly there (ROADMAP Queue 3); the port's
    planner builds the same plan and its apply refuses it."""
    sp = triangular(1500, 7)
    A, JA = both(sp)
    plan = tw.trisolve_waves_plan(A, mode="binv", m=3)
    assert_same_container(plan, jw.trisolve_waves_plan(JA, mode="binv", m=3))
    with pytest.raises(ValueError, match="m dividing 8"):
        tw.trisolve_waves_apply(plan, torch.from_numpy(vec(1500)))
