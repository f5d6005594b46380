"""SpGEMM of the port (``ops/spgemm.py``) against the JAX package and
scipy.

Plans and packed plans must be field-equal to the JAX package's for every
layout (auto, octet, superblock, rowlane, dualgather); both numeric
phases, CSR and CSC out, must agree with the JAX applies (Pallas in
interpret mode) and with scipy's fp64 product at the JAX tests'
tolerance (rtol 2e-3, atol 0.5; values in ±1000, so the product's scale is
~10⁶·degree and atol matters only near zero); gradients in ``b_data``
must agree with the JAX VJP.  n ≤ 512 keeps the file cheap.
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

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
from test_torch_permute import jax_batched_colorer
from test_torch_spmv import assert_same_container

jg = importlib.import_module("sparsematrix_tpu.ops.spgemm")
tg = importlib.import_module("sparsematrix_tpu_torch.ops.spgemm")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def operands(n, density):
    rng = np.random.default_rng(7)
    sa = sps.random(n, n, density=density, random_state=7, format="csr",
                    dtype=np.float32)
    sb = sps.random(n, n, density=density, random_state=8, format="csr",
                    dtype=np.float32)
    sa.data = rng.uniform(-1000, 1000, sa.nnz).astype(np.float32)
    sb.data = rng.uniform(-1000, 1000, sb.nnz).astype(np.float32)
    return sa, sb


def both(n, density):
    sa, sb = operands(n, density)
    return (smt.CSR.from_scipy(sa, device=CPU),
            smt.CSR.from_scipy(sb, device=CPU), jf.CSR.from_scipy(sa),
            jf.CSR.from_scipy(sb), sa, sb)


def _oracle(sa, sb, transpose=False):
    c = sa.astype(np.float64) @ sb.astype(np.float64)
    c = (c.T if transpose else c).tocsr()
    c.sort_indices()
    return c


def _assert_csr(C, want):
    assert C.shape == want.shape and C.nnz == want.nnz
    np.testing.assert_array_equal(C.indptr.numpy(), want.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz].numpy(), want.indices)
    np.testing.assert_allclose(C.data[: C.nnz].detach().numpy(), want.data,
                               **TOL)


@pytest.mark.parametrize("method,output", [
    ("auto", "csr"), ("sparse", "csr"), ("densify", "csr"), ("auto", "csc"),
    ("sparse", "csc")])
def test_spgemm_matches_jax_and_scipy(method, output):
    A, B, JA, JB, sa, sb = both(300, 0.02)
    C = smt.spgemm(A, B, method=method, output=output)
    _assert_csr(C, _oracle(sa, sb, transpose=output == "csc"))
    JC = jg.spgemm(JA, JB, method=method, output=output)
    np.testing.assert_allclose(C.data.numpy(), np.asarray(JC.data), **TOL)
    for f in ("indptr", "indices", "row_ids"):
        np.testing.assert_array_equal(getattr(C, f).numpy(),
                                      np.asarray(getattr(JC, f)))


def test_spgemm_plan_matches_jax_and_checks():
    A, B, JA, JB, sa, sb = both(300, 0.02)
    plan = tg.spgemm_plan(A, B)
    assert_same_container(plan, jg.spgemm_plan(JA, JB))
    assert_same_container(tg.spgemm_plan(A, B, pair_capacity=plan.n_pairs + 9,
                                         c_capacity=plan.c_nnz + 5),
                          jg.spgemm_plan(JA, JB,
                                         pair_capacity=plan.n_pairs + 9,
                                         c_capacity=plan.c_nnz + 5))
    with pytest.raises(ValueError, match="csc"):
        smt.spgemm(A, B, method="densify", output="csc")
    with pytest.raises(ValueError, match="inner dims"):
        tg.spgemm_plan(A, smt.CSR.from_scipy(sps.random(299, 4, 0.1),
                                             device=CPU))
    # the dense path: densify, then extract
    D = tg.spgemm_densify(A, B)
    np.testing.assert_allclose(D.data.numpy(), _oracle(sa, sb).toarray(),
                               **TOL)
    _assert_csr(tg.spgemm_extract(plan, D), _oracle(sa, sb))


LAYOUTS = {
    # (density, layout): 0.02 gives ~48 k C slots, so the C permutation
    # is a Clos plan; 0.01 ~13 k, a gather plan
    "auto-clos": (0.02, "auto"),
    "octet": (0.01, "octet"),
    "superblock": (0.01, "superblock"),
    "rowlane": (0.01, "rowlane"),
    "dualgather": (0.01, "dualgather"),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_plan_packed_matches_jax(monkeypatch, case):
    jax_batched_colorer(monkeypatch)  # as the port calls it
    density, layout = LAYOUTS[case]
    A, B, JA, JB, sa, sb = both(512, density)
    pp = smt.spgemm_plan_packed(A, B, layout=layout)
    jpp = jg.spgemm_plan_packed(JA, JB, layout=layout)
    assert_same_container(pp, jpp)
    want_kind = {"auto": "Octet", "octet": "Octet",
                 "superblock": "SellSuperblock", "rowlane": "SellRowLane",
                 "dualgather": "DualGather"}[layout]
    assert type(pp.p_packed).__name__ == want_kind
    if case == "auto-clos":
        assert type(pp.c_perm).__name__ == "ClosPermutePlan"
    C = smt.spgemm_apply_packed(pp, B.data)
    Ct = smt.spgemm_apply_packed_csc(pp, B.data)
    _assert_csr(C, _oracle(sa, sb))
    _assert_csr(Ct, _oracle(sa, sb, transpose=True))
    if layout != "dualgather":
        # (the JAX dual-gather kernel at this pack's 256-slab groups takes
        # ~25 s in interpret mode; its planes are held equal above)
        np.testing.assert_allclose(
            C.data.numpy(),
            np.asarray(jax.jit(jg.spgemm_apply_packed)(jpp, JB.data).data),
            **TOL)
        np.testing.assert_allclose(
            Ct.data.numpy(),
            np.asarray(jax.jit(jg.spgemm_apply_packed_csc)(jpp,
                                                            JB.data).data),
            **TOL)


@pytest.mark.parametrize("kw", [dict(cluster=False), dict(stripe="mod"),
                                dict(permute="sort"), dict(permute="gather"),
                                dict(permute="clos"),
                                dict(outputs=("csc",))])
def test_plan_packed_options_match_jax(monkeypatch, kw):
    jax_batched_colorer(monkeypatch)
    A, B, JA, JB, sa, sb = both(300, 0.02)
    pp = smt.spgemm_plan_packed(A, B, **kw)
    assert_same_container(pp, jg.spgemm_plan_packed(JA, JB, **kw))
    if "csr" in kw.get("outputs", ("csr",)):
        _assert_csr(smt.spgemm_apply_packed(pp, B.data), _oracle(sa, sb))
    if kw.get("cluster", True):
        _assert_csr(smt.spgemm_apply_packed_csc(pp, B.data),
                    _oracle(sa, sb, transpose=True))
    else:
        with pytest.raises(ValueError, match="clustered"):
            smt.spgemm_apply_packed_csc(pp, B.data)


@pytest.mark.parametrize("csc", [False, True])
def test_grad_in_b_data_matches_jax(monkeypatch, csc):
    jax_batched_colorer(monkeypatch)
    A, B, JA, JB, sa, sb = both(512, 0.02)
    pp = smt.spgemm_plan_packed(A, B)
    jpp = jg.spgemm_plan_packed(JA, JB)
    apply_t = smt.spgemm_apply_packed_csc if csc else smt.spgemm_apply_packed
    apply_j = (jg.spgemm_apply_packed_csc if csc
               else jg.spgemm_apply_packed)
    w = np.random.default_rng(3).uniform(-1, 1, pp.c_nnz).astype(np.float32)
    b = B.data.clone().requires_grad_()
    (apply_t(pp, b).data[: pp.c_nnz] * torch.from_numpy(w)).sum().backward()
    jgb = jax.jit(jax.grad(lambda v: (apply_j(jpp, v).data[: jpp.c_nnz]
                                      * jnp.asarray(w)).sum()))(JB.data)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jgb), **TOL)
    # the plain numeric phase's gradient: the same function of b_data
    plan = tg.spgemm_plan(A, B)
    b2 = B.data.clone().requires_grad_()
    C2 = tg.spgemm_apply(plan, A.data, b2)
    order = (np.argsort(plan.c_indices.numpy()[: plan.c_nnz].astype(np.int64)
                        * 512 + plan.c_row_ids.numpy()[: plan.c_nnz],
                        kind="stable")
             if csc else np.arange(plan.c_nnz))
    w_plain = np.empty_like(w)
    w_plain[order] = w
    (C2.data[: plan.c_nnz] * torch.from_numpy(w_plain)).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), b2.grad.numpy(), **TOL)


def _carry(ref):
    """The port's container from a JAX container's fields, nested
    containers carried first (``formats/carry.py``)."""
    fields, static = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static", False):
            static[f.name] = v
        elif dataclasses.is_dataclass(v):
            fields[f.name] = _carry(v)
        elif isinstance(v, tuple):
            fields[f.name] = tuple(tuple(np.asarray(a) for a in t)
                                   if isinstance(t, tuple) else np.asarray(t)
                                   for t in v)
        else:
            fields[f.name] = None if v is None else np.asarray(v)
    return smt.from_numpy_fields(type(ref).__name__, fields, static,
                                 device=CPU)


def test_carry_slice3_containers(monkeypatch):
    """A JAX SpGEMM plan (an octet with ``rem``, Clos and gather plans), a
    skew pack and a rowlane pack with a spill tail and a transposed pack
    carry across field by field, and the carried plan computes C."""
    jax_batched_colorer(monkeypatch)
    A, B, JA, JB, sa, sb = both(512, 0.02)
    jpp = jg.spgemm_plan_packed(JA, JB, trim_group=8)
    assert jpp.p_packed.rem is not None
    pp = _carry(jpp)
    assert_same_container(pp, jpp)
    _assert_csr(smt.spgemm_apply_packed(pp, B.data), _oracle(sa, sb))
    from sparsematrix_tpu.ops.skew import pack_skew as jax_pack_skew
    from sparsematrix_tpu_torch.utils.testutils import gen_zipf_csr

    JZ = jf.CSR.from_scipy(gen_zipf_csr(9, 4096, 4096, 4096 * 32,
                                        col_zipf=True))
    jsk = jax_pack_skew(JZ)
    assert_same_container(_carry(jsk), jsk)
    jrl = importlib.import_module("sparsematrix_tpu.kernels.spmv_rowlane")
    d = np.zeros((300, 900), np.float32)
    d[::7, :] = 1.0  # rows deep enough to spill
    jp = jrl.pack_sell_rowlane(jf.CSR.fromdense(d), spill_depth=1,
                               with_transpose=True)
    assert jp.spill_packed is not None
    assert_same_container(_carry(jp), jp)


AUTO_CASES = [(64, 0.3), (300, 0.02), (400, 0.005), (800, 0.002)]


def _auto_picks_dense(A, B):
    """``spgemm(method="auto")``'s choice, from its own constants."""
    m, k = A.shape
    n = B.shape[1]
    return (2.0 * m * k * n / tg._DENSE_FLOPS_PER_S
            < tg._estimate_pairs(A, B) / tg._PACKED_PAIRS_PER_S)


def test_spgemm_auto_cases_cover_both_routes():
    picks = {_auto_picks_dense(*both(n, d)[:2]) for n, d in AUTO_CASES}
    assert picks == {True, False}


@pytest.mark.parametrize("n,density", AUTO_CASES)
def test_spgemm_auto_matches_fp64_on_either_route(monkeypatch, n, density):
    """Whichever route the card-measured crossover constants pick, the
    product is C = A @ B on the plan's pattern."""
    A, B, _, _, sa, sb = both(n, density)
    routes = []
    densify = tg.spgemm_densify
    monkeypatch.setattr(tg, "spgemm_densify",
                        lambda *a: routes.append("dense") or densify(*a))
    C = smt.spgemm(A, B, method="auto")
    assert (routes == ["dense"]) == _auto_picks_dense(A, B)
    _assert_csr(C, _oracle(sa, sb))
