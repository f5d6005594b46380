"""The fused triangular solve of the port (``kernels/trisolve_fused.py``)
against the JAX package.

Plans must be ``np.array_equal`` to the JAX plans field by field (the
level sort's ``perm``/``rank``, the gate rows, bf16 values bit for bit,
the transposed plan) with equal statics.  ``trisolve_fused_apply`` and
its batched form (the plain segment walk on the CPU) must agree with the
JAX kernel (Pallas in interpret mode) and with an fp64 oracle at the JAX
tests' tolerance, rtol 2e-3 and atol 1e-3 (3e-2 for bf16 values), and so
must the cotangents in ``b`` and in ``plan.vals``.
"""
import dataclasses
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
from test_torch_trisolve_waves import poisson_ilu

jfu = importlib.import_module("sparsematrix_tpu.kernels.trisolve_fused")
tfu = importlib.import_module("sparsematrix_tpu_torch.kernels.trisolve_fused")

BF16_TOL = dict(rtol=3e-2, atol=3e-2)

# name -> (scipy matrix, lower, unit, plan arguments)
CASES = {
    "lower": (lambda: triangular(300, 7), True, False, {}),
    "upper": (lambda: triangular(150, 7, lower=False), False, False, {}),
    "poisson-ilu-L": (lambda: poisson_ilu(16)[0], True, True, {}),
    "poisson-ilu-U": (lambda: poisson_ilu(16)[1], False, False,
                      dict(group=2)),
    "bf16": (lambda: triangular(300, 3, band=60), True, False,
             dict(dtype=torch.bfloat16)),
    "no-level-sort": (lambda: triangular(200, 5, unit=True), True, True,
                      dict(level_sort=False)),
    "with-transpose": (lambda: triangular(260, 5, lower=False), False,
                       False, dict(with_transpose=True)),
    "diagonal": (lambda: sps.diags(np.linspace(1, 2, 100)).tocsr().astype(
        np.float32), True, False, {}),
}


@functools.lru_cache(maxsize=None)
def plans(name):
    mk, lower, unit, kw = CASES[name]
    sp = mk()
    A, JA = both(sp)
    return (sp, tfu.trisolve_fused_plan(A, lower=lower, unit_diagonal=unit,
                                        **kw),
            jfu.trisolve_fused_plan(JA, lower=lower, unit_diagonal=unit,
                                    **jax_kw(kw)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax_and_solves(name):
    _, lower, unit, kw = CASES[name]
    sp, plan, jplan = plans(name)
    assert_same_container(plan, jplan)
    b = vec(sp.shape[0], len(name))
    x = tfu.trisolve_fused_apply(plan, torch.from_numpy(b)).numpy()
    tol = BF16_TOL if "dtype" in kw else SOLVE_TOL
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, unit), **tol)
    np.testing.assert_allclose(
        x, np.asarray(jfu.trisolve_fused_apply(jplan, jnp.asarray(b))), **tol)


def test_batched_apply_matches_jax():
    sp, plan, jplan = plans("poisson-ilu-U")
    B = vec(sp.shape[0], 3, k=3)
    X = tfu.trisolve_fused_apply_batched(plan, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X, tri_oracle(sp, B, lower=False), **SOLVE_TOL)
    np.testing.assert_allclose(
        X, np.asarray(jfu.trisolve_fused_apply_batched(jplan,
                                                       jnp.asarray(B))),
        **SOLVE_TOL)


def test_b_and_vals_cotangents_match_jax():
    sp, plan, jplan = plans("with-transpose")
    n = sp.shape[0]
    b, g = vec(n, 6), vec(n, 7)
    vals = plan.vals.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (tfu.trisolve_fused_apply(dataclasses.replace(plan, vals=vals), bt)
     * torch.from_numpy(g)).sum().backward()

    def loss(v, bb):
        return jnp.vdot(jnp.asarray(g), jfu.trisolve_fused_apply(
            dataclasses.replace(jplan, vals=v), bb))

    jgv, jgb = jax.grad(loss, argnums=(0, 1))(jplan.vals, jnp.asarray(b))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), **SOLVE_TOL)
    np.testing.assert_allclose(bt.grad.numpy(),
                               tri_oracle(sp.T.tocsr(), g, lower=True),
                               **SOLVE_TOL)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(jgv),
                               rtol=2e-3, atol=2e-3)
    assert vals.grad.dtype == plan.vals.dtype


def test_backward_without_transpose_raises():
    _, plan, _ = plans("lower")
    bt = torch.from_numpy(vec(300)).requires_grad_()
    with pytest.raises(ValueError, match="with_transpose=True"):
        tfu.trisolve_fused_apply(plan, bt).sum().backward()
