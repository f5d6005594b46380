"""ILU(0) and IC(0) of the port (``ops/ilu.py``, ``ops/ichol.py``) against
the JAX package.

The factors must equal the JAX package's bit for bit, from the port's
native walk (``native/factor.cc``) and from its Python walk alike; every
plan family (level, fixpoint, level-packed, fused, waves) must be
``np.array_equal`` to the JAX plans; ``ilu_apply``/``ic_apply`` on a
vector and on an (n, k) panel must agree with an fp64 oracle
``U⁻¹ L⁻¹ r``, and for one family of each engine with the JAX package
(its Pallas kernels in interpret mode), at the JAX tests' tolerance,
rtol 2e-3 and atol 1e-3.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from test_torch_spmv import assert_same_container
from sparsematrix_tpu_torch.utils.testutils import tri_oracle, triangular
from test_torch_trisolve import SOLVE_TOL, both, one_thread, vec

jilu = importlib.import_module("sparsematrix_tpu.ops.ilu")
jic = importlib.import_module("sparsematrix_tpu.ops.ichol")
tilu = importlib.import_module("sparsematrix_tpu_torch.ops.ilu")
tic = importlib.import_module("sparsematrix_tpu_torch.ops.ichol")


@functools.lru_cache(maxsize=None)
def matrix(name):
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    if name == "poisson":
        return poisson2d(100)[1].astype(np.float32)
    if name == "aniso":
        return poisson2d(100, eps=1000.0)[1].astype(np.float32)
    # diagonally dominant, unsymmetric, scattered pattern
    rng = np.random.default_rng(3)
    sp = sps.random(120, 120, density=0.04, random_state=3, format="csr")
    sp.data = rng.uniform(-1, 1, sp.nnz)
    sp = sp + sps.diags(1.0 + np.asarray(abs(sp).sum(axis=1)).ravel())
    return sp.tocsr().astype(np.float32)


def _host(csr):
    sp = csr.to_scipy().tocsr()
    sp.sort_indices()
    return sp


def assert_same_csr(a, b):
    a, b = _host(a), _host(b)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("name", ["poisson", "aniso", "scattered"])
def test_ilu0_bit_exact_native_and_python(name, monkeypatch):
    sp = matrix(name)
    A, JA = both(sp)
    JL, JU = jilu.ilu0(JA)
    L, U = tilu.ilu0(A)
    assert_same_csr(L, JL)
    assert_same_csr(U, JU)
    monkeypatch.setattr(tilu, "_ilu0_factor_native", lambda *a: False)
    L, U = tilu.ilu0(A)
    assert_same_csr(L, JL)
    assert_same_csr(U, JU)


@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_ic0_bit_exact_native_and_python(name, monkeypatch):
    A, JA = both(matrix(name))
    JL = jic.ic0(JA)
    assert_same_csr(tic.ic0(A), JL)
    monkeypatch.setattr(tic, "_ic0_factor_native", lambda *a: False)
    assert_same_csr(tic.ic0(A), JL)


def test_factor_errors_match_jax(monkeypatch):
    sp = matrix("poisson").tolil()
    sp[5, 5] = 0.0  # drops the entry: a missing diagonal
    A, JA = both(sp.tocsr())
    with pytest.raises(ValueError, match="missing diagonal at row 5"):
        jilu.ilu0(JA)
    with pytest.raises(ValueError, match="missing diagonal at row 5"):
        tilu.ilu0(A)
    monkeypatch.setattr(tilu, "_ilu0_factor_native", lambda *a: False)
    with pytest.raises(ValueError, match="missing diagonal at row 5"):
        tilu.ilu0(A)
    sp2 = matrix("poisson").tolil()
    sp2[3, 3] = -50.0
    A2, JA2 = both(sp2.tocsr())
    with pytest.raises(ZeroDivisionError, match="non-positive pivot at row 3"):
        jic.ic0(JA2)
    with pytest.raises(ZeroDivisionError, match="non-positive pivot at row 3"):
        tic.ic0(A2)


FAMILIES = ["plans", "fixpoint_plans", "level_plans", "fused_plans",
            "waves_plans"]
JAX_APPLIES = {("ilu", "plans", None), ("ilu", "fused_plans", 3),
               ("ic", "waves_plans", 3), ("ic", "level_plans", None),
               ("ilu", "fixpoint_plans", None)}


def _family(mod, prefix, family):
    return getattr(mod, f"{prefix}_{family}")


@functools.lru_cache(maxsize=None)
def family_plans(kind, family, name):
    A, JA = both(matrix(name))
    if kind == "ilu":
        return (_family(tilu, "ilu0", family)(A),
                _family(jilu, "ilu0", family)(JA))
    return _family(tic, "ic0", family)(A), _family(jic, "ic0", family)(JA)


def _precond_oracle(kind, name, r):
    A, JA = both(matrix(name))
    if kind == "ilu":
        L, U = (_host(m) for m in jilu.ilu0(JA))
    else:
        L = _host(jic.ic0(JA))
        U = L.T.tocsr()
    return tri_oracle(U, tri_oracle(L, r, lower=True), lower=False)


@pytest.mark.parametrize("kind", ["ilu", "ic"])
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_families_match_jax_and_apply(kind, family):
    name = "scattered" if kind == "ilu" else "poisson"
    plans, jplans = family_plans(kind, family, name)
    for p, jp in zip(plans, jplans):
        assert_same_container(p, jp)
    apply_ = tilu.ilu_apply if kind == "ilu" else tic.ic_apply
    japply = jilu.ilu_apply if kind == "ilu" else jic.ic_apply
    n = matrix(name).shape[0]
    for k in (None, 3):
        r = vec(n, 11, k=k)
        got = apply_(plans, torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, _precond_oracle(kind, name, r),
                                   **SOLVE_TOL)
        # the JAX applies compile their kernels in interpret mode: one
        # family of each engine is held against them, every family
        # against the oracle (and every plan field-equal, above)
        if (kind, family, k) in JAX_APPLIES:
            np.testing.assert_allclose(
                got, np.asarray(japply(jplans, jnp.asarray(r))),
                **SOLVE_TOL)


def test_truncated_fixpoint_preconditioner_matches_jax():
    """``ilu0_fixpoint_plans(n_iters=2)``: an approximate solve, the same
    linear operator in both packages."""
    A, JA = both(matrix("poisson"))
    plans = tilu.ilu0_fixpoint_plans(A, n_iters=2)
    jplans = jilu.ilu0_fixpoint_plans(JA, n_iters=2)
    for p, jp in zip(plans, jplans):
        assert_same_container(p, jp)
    r = vec(100, 12)
    np.testing.assert_allclose(
        tilu.ilu_apply(plans, torch.from_numpy(r)).numpy(),
        np.asarray(jilu.ilu_apply(jplans, jnp.asarray(r))), rtol=1e-5,
        atol=1e-5)
