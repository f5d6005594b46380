"""The triangular-solve plans of the port (``ops/trisolve.py``) against the
JAX package, and the helpers the other slice-4 test files share.

Plans (level, fixpoint, level-packed) must be ``np.array_equal`` to the
JAX plans field by field with equal statics; solves must agree with the
JAX apply and with an fp64 ``spsolve_triangular`` oracle at the JAX
trisolve tests' tolerance, rtol 2e-3 and atol 1e-3 (values of order 1);
``trisolve(A, b)`` must route to the same engine as the JAX package.
The JAX row-lane kernel runs in interpret mode, so the JAX applies of the
fixpoint and level-packed plans are compared on one small case each.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from threadpoolctl import threadpool_limits

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu_torch.utils.testutils import tri_oracle, triangular
from test_torch_spmv import assert_same_container

jts = importlib.import_module("sparsematrix_tpu.ops.trisolve")
tts = importlib.import_module("sparsematrix_tpu_torch.ops.trisolve")

CPU = "cpu"
SOLVE_TOL = dict(rtol=2e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain solves are long runs of small torch ops and the planners
    many small BLAS calls (block inversions and products); the suite runs
    several workers a machine, and a torch or OpenBLAS pool of a thread a
    core in every one of them oversubscribes the cores many times over
    (a plan then takes ten times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def both(sp):
    return smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)


def vec(n, seed=0, k=None):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_kw(kw):
    """Plan arguments with torch's bf16 swapped for JAX's."""
    return {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
            for k, v in kw.items()}


def carry(ref):
    """The port's container from a JAX container's fields, nested
    containers carried first (``formats/carry.py``)."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        elif dataclasses.is_dataclass(v):
            arrays[f.name] = carry(v)
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return tf.from_numpy_fields(type(ref).__name__, arrays, statics,
                                device=CPU)


def test_compute_levels_matches_jax():
    sp = triangular(400, 4).tocoo()
    off = sp.col < sp.row
    r, c = sp.row[off].astype(np.int64), sp.col[off].astype(np.int64)
    np.testing.assert_array_equal(tts._compute_levels(400, r, c),
                                  jts._compute_levels(400, r, c))


# (n, lower, unit)
LEVEL_CASES = [(16, True, False), (64, False, False), (150, True, True),
               (150, False, False)]


@pytest.mark.parametrize("n,lower,unit", LEVEL_CASES)
def test_level_schedule_plan_and_apply(n, lower, unit):
    sp = triangular(n, max(1, n // 20), unit=unit, lower=lower)
    A, JA = both(sp)
    plan = tts.trisolve_plan(A, lower=lower, unit_diagonal=unit)
    jplan = jts.trisolve_plan(JA, lower=lower, unit_diagonal=unit)
    assert_same_container(plan, jplan)
    b = vec(n, n)
    x = tts.trisolve_apply(plan, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jts.trisolve_apply(jplan, jnp.asarray(b))), **SOLVE_TOL)
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, unit), **SOLVE_TOL)


@pytest.mark.parametrize("n,lower,unit,jax_cmp", [
    (64, True, False, True), (150, False, False, False),
    (150, True, True, False)])
def test_fixpoint_plan_and_apply(n, lower, unit, jax_cmp):
    sp = triangular(n, max(1, n // 20), unit=unit, lower=lower)
    A, JA = both(sp)
    plan = tts.trisolve_fixpoint_plan(A, lower=lower, unit_diagonal=unit)
    jplan = jts.trisolve_fixpoint_plan(JA, lower=lower, unit_diagonal=unit)
    assert_same_container(plan, jplan)
    b = vec(n, n + 1)
    x = tts.trisolve_fixpoint_apply(plan, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, unit), **SOLVE_TOL)
    if jax_cmp:
        np.testing.assert_allclose(
            x, np.asarray(jts.trisolve_fixpoint_apply(jplan, jnp.asarray(b))),
            **SOLVE_TOL)


def test_fixpoint_truncated_matches_jax():
    """A truncated fixpoint solve (n_iters=2) is a fixed linear operator:
    the port's equals the JAX package's, not the exact solve."""
    sp = triangular(200, 5)
    A, JA = both(sp)
    plan = tts.trisolve_fixpoint_plan(A, n_iters=2, group=4)
    jplan = jts.trisolve_fixpoint_plan(JA, n_iters=2, group=4)
    assert_same_container(plan, jplan)
    b = vec(200, 3)
    np.testing.assert_allclose(
        tts.trisolve_fixpoint_apply(plan, torch.from_numpy(b)).numpy(),
        np.asarray(jts.trisolve_fixpoint_apply(jplan, jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,lower,unit,kw,jax_cmp", [
    (64, True, False, dict(), True),
    (150, False, False, dict(), False),
    (150, True, True, dict(group=2), False),
    (150, False, False, dict(dtype=torch.bfloat16), False)])
def test_level_packed_plan_and_apply(n, lower, unit, kw, jax_cmp):
    sp = triangular(n, n // 30, unit=unit, lower=lower)
    A, JA = both(sp)
    plan = tts.trisolve_level_plan(A, lower=lower, unit_diagonal=unit, **kw)
    jplan = jts.trisolve_level_plan(JA, lower=lower, unit_diagonal=unit,
                                    **jax_kw(kw))
    assert_same_container(plan, jplan)
    b = vec(n, n + 2)
    x = tts.trisolve_level_apply(plan, torch.from_numpy(b)).numpy()
    want = tri_oracle(sp, b, lower, unit)
    if "dtype" in kw:  # bf16 off-diagonal values: the storage contract
        sp16 = sp.copy()
        sp16.data = torch.from_numpy(sp.data).to(torch.bfloat16).float(
        ).numpy()
        sp16.setdiag(sp.diagonal())
        want = tri_oracle(sp16, b, lower, unit)
    np.testing.assert_allclose(x, want, **SOLVE_TOL)
    if jax_cmp:
        np.testing.assert_allclose(
            x, np.asarray(jts.trisolve_level_apply(jplan, jnp.asarray(b))),
            **SOLVE_TOL)


def test_diagonal_only_plans():
    sp = sps.diags(np.linspace(1.0, 3.0, 50)).tocsr().astype(np.float32)
    A, JA = both(sp)
    b = vec(50, 5)
    for build, jbuild, apply_ in (
            (tts.trisolve_level_plan, jts.trisolve_level_plan,
             tts.trisolve_level_apply),
            (tts.trisolve_fixpoint_plan, jts.trisolve_fixpoint_plan,
             tts.trisolve_fixpoint_apply)):
        plan = build(A)
        assert_same_container(plan, jbuild(JA))
        np.testing.assert_allclose(apply_(plan, torch.from_numpy(b)).numpy(),
                                   b / sp.diagonal(), rtol=1e-6)


def test_zero_diagonal_raises():
    sp = triangular(40, 2).tolil()
    sp[7, 7] = 0.0
    A = smt.CSR.from_scipy(sp.tocsr(), device=CPU)
    for build in (tts.trisolve_plan, tts.trisolve_fixpoint_plan,
                  tts.trisolve_level_plan):
        with pytest.raises(ValueError, match="row 7"):
            build(A)


@pytest.mark.parametrize("route,multi", [("waves", False), ("waves", True),
                                         ("fused", False), ("level", True)])
def test_trisolve_routes_like_jax(monkeypatch, route, multi):
    """``trisolve`` picks the same engine as the JAX package: waves while
    the inverse blocks fit their budget, else fused, else (a pattern "too
    scattered" for the fused layout) the level plan.  The budget and the
    fused planner's refusal are patched in both packages alike."""
    jtw = importlib.import_module("sparsematrix_tpu.kernels.trisolve_waves")
    jtf = importlib.import_module("sparsematrix_tpu.kernels.trisolve_fused")
    ttw = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.trisolve_waves")
    ttf = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.trisolve_fused")
    used = []
    for mod, pkg in ((jts, "jax"), (tts, "port")):
        if route != "waves":
            monkeypatch.setattr(mod, "_WAVES_MAX_A1_BYTES", 0)
    for mod, pkg, name in ((jtw, "jax", "trisolve_waves_plan"),
                           (ttw, "port", "trisolve_waves_plan"),
                           (jtf, "jax", "trisolve_fused_plan"),
                           (ttf, "port", "trisolve_fused_plan"),
                           (jts, "jax", "trisolve_plan"),
                           (tts, "port", "trisolve_plan")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _tag=(pkg, name), **kw):
            used.append(_tag)
            if route == "level" and _tag[1] == "trisolve_fused_plan":
                raise ValueError("the pattern is too scattered")
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    sp = triangular(200, 3, lower=False)
    A, JA = both(sp)
    b = vec(200, 9, k=3 if multi else None)
    x = smt.trisolve(A, torch.from_numpy(b), lower=False).numpy()
    jx = np.asarray(jts.trisolve(JA, jnp.asarray(b), lower=False))
    np.testing.assert_allclose(x, jx, **SOLVE_TOL)
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower=False), **SOLVE_TOL)
    assert ([n for p, n in used if p == "port"]
            == [n for p, n in used if p == "jax"])
    assert used[-1][1] == {"waves": "trisolve_waves_plan",
                           "fused": "trisolve_fused_plan",
                           "level": "trisolve_plan"}[route]
