"""The octet SpMV of the port (``kernels/spmv_octet.py``) against the JAX
package.

Packs must be plane-equal to the JAX packer's, with the native slot
assigner and with the numpy repair, with and without the trim section
(``rem``; a ``trim_group`` ≥ ``group`` is ignored by both).  Products and
gradients must agree with the JAX kernel (Pallas in interpret mode) and
with an fp64 oracle at the JAX tests' tolerance (rtol 2e-3, atol 0.5).
The ``rem`` gradient is held against fp64 ``A^T w`` on the 3000×5000,
density-0.0005 matrix, whose trim pack has a ``rem`` section.
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
from sparsematrix_tpu.ops.spmv import prepare_spmv as jax_prepare_spmv
from test_torch_spmv import assert_same_container

jdg = importlib.import_module("sparsematrix_tpu.kernels.spmv_dualgather")
joc = importlib.import_module("sparsematrix_tpu.kernels.spmv_octet")
toc = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_octet")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def matrix(shape, density, seed=2):
    sp = sps.random(*shape, density=density, random_state=seed, format="csr",
                    dtype=np.float32)
    sp.data = np.random.default_rng(seed).uniform(
        -1000, 1000, sp.nnz).astype(np.float32)
    return sp


def both(shape, density):
    sp = matrix(shape, density)
    return smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp), sp


CASES = {
    "multi-window": ((3000, 5000), 0.0005, dict(k_octets=4)),
    "odd-shape": ((1100, 900), 0.001, dict(k_octets=2)),
    "depth": ((1500, 1000), 0.01, dict(k_octets=1)),
    "trim": ((3000, 5000), 0.0005, dict(group=32, k_octets=4,
                                        trim_group=8)),
    "trim-ge-group": ((3000, 5000), 0.0005, dict(group=8, k_octets=4,
                                                 trim_group=8)),
    "bf16": ((1100, 900), 0.001, dict(k_octets=2, dtype=torch.bfloat16)),
}


def _jax_kw(kw):
    return {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_octet_pack_matches_jax(case):
    shape, density, kw = CASES[case]
    A, JA, _ = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    assert_same_container(packed, joc.pack_octet(JA, **_jax_kw(kw)))
    # the trim quirk: a trim_group at or above group is ignored
    assert (packed.rem is not None) == (case == "trim")


@pytest.mark.parametrize("case", ["multi-window", "depth", "trim"])
def test_octet_numpy_repair_matches_jax(monkeypatch, case):
    """Without the native assigner both sides take the numpy repair
    (other, valid planes)."""
    for mod in (joc, toc):
        monkeypatch.setattr(mod, "_assign_native", lambda *a, **k: None)
    shape, density, kw = CASES[case]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    assert_same_container(packed, joc.pack_octet(JA, **_jax_kw(kw)))
    x = np.random.default_rng(8).standard_normal(sp.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(
        toc.spmv_octet(packed, torch.from_numpy(x)).numpy(),
        sp.astype(np.float64) @ x, **TOL)


@pytest.mark.parametrize("case", ["trim", "bf16"])
def test_octet_product_and_grads_match_jax(case):
    """(The trim case packs the multi-window matrix: both sections.)"""
    shape, density, kw = CASES[case]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    jpacked = joc.pack_octet(JA, **_jax_kw(kw))
    rng = np.random.default_rng(9)
    x = rng.standard_normal(sp.shape[1]).astype(np.float32)
    w = rng.uniform(-1, 1, sp.shape[0]).astype(np.float32)
    sp64 = sp.astype(np.float64)
    if kw.get("dtype") is torch.bfloat16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    xt = torch.from_numpy(x).requires_grad_()
    packed.vals.requires_grad_()
    if packed.rem is not None:
        packed.rem.vals.requires_grad_()
    y = toc.spmv_octet(packed, xt)
    (y * torch.from_numpy(w)).sum().backward()

    def fwd(vals, rem_vals, xx):
        rem = (None if jpacked.rem is None
               else dataclasses.replace(jpacked.rem, vals=rem_vals))
        return joc.spmv_octet(dataclasses.replace(jpacked, vals=vals,
                                                  rem=rem), xx)

    # one trace gives the JAX product and its VJP
    jrem = jpacked.rem.vals if jpacked.rem is not None else jnp.zeros(1)
    jy, jvjp = jax.vjp(fwd, jpacked.vals, jrem, jnp.asarray(x))
    jdv, jdr, jgx = jvjp(jnp.asarray(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.detach().numpy(), sp64 @ x, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), sp64.T @ w, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(packed.vals.grad.float().numpy(),
                               np.asarray(jdv.astype(jnp.float32)), **TOL)
    if packed.rem is not None:
        np.testing.assert_allclose(packed.rem.vals.grad.numpy(),
                                   np.asarray(jdr), **TOL)


def test_octet_splits_match_jax(monkeypatch):
    """Under a small prefetch budget the JAX packer cuts its calls at
    superblock boundaries; the port keeps the same ``splits`` (one launch
    covers them all)."""
    monkeypatch.setattr(jdg, "_SMEM_PREFETCH_BUDGET", 320)
    monkeypatch.setattr(toc, "_SMEM_PREFETCH_BUDGET", 320)
    A, JA, sp = both((3000, 5000), 0.0005)
    packed = toc.pack_octet(A, group=4, k_octets=1)
    assert packed.splits
    assert_same_container(packed, joc.pack_octet(JA, group=4, k_octets=1))
    x = np.random.default_rng(10).standard_normal(5000).astype(np.float32)
    np.testing.assert_allclose(
        toc.spmv_octet(packed, torch.from_numpy(x)).numpy(),
        sp.astype(np.float64) @ x, **TOL)


def test_prepare_spmv_auto_clustered_octet():
    """The clustered generator of the JAX bench's ``spmv_clustered`` row
    (~1.2 entries a row, all in one 1024-column window), at 64 tiles: the
    auto route packs it as an octet, equal to the JAX pack."""
    g = np.random.default_rng(0)
    n = 64 * 128
    rows_ = g.integers(0, n, size=10_000)
    cols_ = g.integers(0, 1024, size=rows_.size)
    vals_ = g.uniform(-1000, 1000, rows_.size).astype(np.float32)
    sp = sps.coo_matrix((vals_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    P = smt.prepare_spmv(A)
    assert isinstance(P, smt.Octet)
    assert_same_container(P, jax_prepare_spmv(JA))
    x = g.standard_normal(n).astype(np.float32)
    want = sp.astype(np.float64) @ x
    np.testing.assert_allclose(smt.spmv(P, torch.from_numpy(x)).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(smt.spmv(A, torch.from_numpy(x)).numpy(),
                               want, **TOL)


def test_octet_empty_and_spmm_raises():
    """An empty pack: zero products through both wrappers; ``spmm_octet``
    raises on an X whose rows are not the matrix's columns."""
    A = smt.CSR.fromdense(np.zeros((64, 64), np.float32), device=CPU)
    packed = toc.pack_octet(A)
    assert_same_container(
        packed, joc.pack_octet(jf.CSR.fromdense(np.zeros((64, 64),
                                                         np.float32))))
    assert (toc.spmv_octet(packed, torch.ones(64)) == 0).all()
    Y = toc.spmm_octet(packed, torch.ones((64, 2)))
    assert Y.shape == (64, 2) and (Y == 0).all()
    with pytest.raises(ValueError, match="X must be fp32"):
        toc.spmm_octet(packed, torch.ones((63, 2)))


def _spmm_fixture(shape, density, seed, **kw):
    """The JAX tests' SpMM fixture: ``sps.random`` pattern, values in
    ±10 (``tests/test_octet.py:181-198``)."""
    sp = sps.random(*shape, density=density, random_state=seed,
                    format="csr", dtype=np.float32)
    sp.data = np.random.default_rng(seed).uniform(
        -10, 10, sp.nnz).astype(np.float32)
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    return toc.pack_octet(A, **kw), joc.pack_octet(JA, **_jax_kw(kw)), sp


@pytest.mark.parametrize("k", [1, 5, 8, 13, 40])
def test_spmm_octet_matches_jax(k):
    """test_spmm_octet at each k (and k = 1 and k > 32): through the
    kernel wrapper and the ``spmm`` pack dispatch, against the JAX
    ``spmm_octet`` and fp64 (rtol 2e-3, atol 0.5)."""
    packed, jpacked, sp = _spmm_fixture((2048, 2048), 0.002, 1, k_octets=2)
    X = np.random.default_rng(k).uniform(-1, 1, (2048, k)).astype(np.float32)
    want = np.asarray(joc.spmm_octet(jpacked, jnp.asarray(X)))
    for fn in (toc.spmm_octet, smt.spmm, toc.spmm_octet_reference):
        got = fn(packed, torch.from_numpy(X))
        assert got.dtype == torch.float32 and got.shape == (2048, k)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), sp.astype(np.float64) @ X,
                                   **TOL)


def test_spmm_octet_trim_rem_and_vjp_match_jax():
    """The trim pack of the 3000×5000, density-0.0005 fixture has a
    ``rem`` section: the product against the JAX ``spmm_octet`` and fp64,
    the X cotangent against fp64 ``A^T G`` and JAX, and the value
    cotangents of both sections against JAX's (rtol 2e-3, atol 0.5; the
    value cotangents to atol 1e-4)."""
    shape, density, kw = CASES["trim"]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    jpacked = joc.pack_octet(JA, **kw)
    assert packed.rem is not None
    rng = np.random.default_rng(12)
    X = rng.uniform(-1, 1, (shape[1], 4)).astype(np.float32)
    G = rng.uniform(-1, 1, (shape[0], 4)).astype(np.float32)

    def fwd(vals, rem_vals, xx):
        return joc.spmm_octet(dataclasses.replace(
            jpacked, vals=vals,
            rem=dataclasses.replace(jpacked.rem, vals=rem_vals)), xx)

    jy, jvjp = jax.vjp(fwd, jpacked.vals, jpacked.rem.vals, jnp.asarray(X))
    jdv, jdr, jgX = (np.asarray(a) for a in jvjp(jnp.asarray(G)))
    v = packed.vals.clone().requires_grad_()
    rv = packed.rem.vals.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    pk = dataclasses.replace(packed, vals=v,
                             rem=dataclasses.replace(packed.rem, vals=rv))
    Y = smt.spmm(pk, Xt)
    Y.backward(torch.from_numpy(G))
    sp64 = sp.astype(np.float64)
    np.testing.assert_allclose(Y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(Y.detach().numpy(), sp64 @ X, **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), sp64.T @ G, **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), jgX, **TOL)
    np.testing.assert_allclose(v.grad.numpy(), jdv, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(rv.grad.numpy(), jdr, rtol=2e-3, atol=1e-4)
    assert np.abs(rv.grad.numpy()).max() > 0


def test_spmm_octet_bf16_vjp_matches_jax():
    """test_spmm_octet_vjp on bf16 values: X and value cotangents against
    ``jax.vjp`` (rtol 2e-3, atol 0.5), X's against fp64 of the rounded
    values too."""
    packed, jpacked, sp = _spmm_fixture((1500, 1200), 0.002, 9, k_octets=2,
                                        dtype=torch.bfloat16)
    rng = np.random.default_rng(13)
    X = rng.uniform(-1, 1, (1200, 6)).astype(np.float32)
    W = rng.uniform(-1, 1, (1500, 6)).astype(np.float32)
    _, jvjp = jax.vjp(lambda vv, xx: joc.spmm_octet(
        dataclasses.replace(jpacked, vals=vv), xx), jpacked.vals,
        jnp.asarray(X))
    jdv, jgX = jvjp(jnp.asarray(W))
    v = packed.vals.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    toc.spmm_octet(dataclasses.replace(packed, vals=v), Xt).backward(
        torch.from_numpy(W))
    sp64 = sp.astype(np.float64)
    sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(jgX), **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), sp64.T @ W, **TOL)
    assert v.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(v.grad.float().numpy(),
                               np.asarray(jdv.astype(jnp.float32)), **TOL)
    assert (v.grad.float().numpy()[packed.vals.float().numpy() == 0]
            == 0).all()


def test_spmm_prepare_spmv_octet_auto_matches_jax():
    """``spmm(prepare_spmv(A), X)`` on a CSR of ≤ 2 entries a row at
    2048 rows: the auto route packs an octet, and its product equals the
    JAX one and fp64."""
    g = np.random.default_rng(14)
    n = 2048
    rows_ = np.repeat(np.arange(n), 2)
    cols_ = g.integers(0, n, rows_.size)
    sp = sps.coo_matrix((g.uniform(-1000, 1000, rows_.size).astype(
        np.float32), (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    P, JP = smt.prepare_spmv(A), jax_prepare_spmv(JA)
    assert isinstance(P, smt.Octet)
    assert_same_container(P, JP)
    X = g.standard_normal((n, 32)).astype(np.float32)
    got = smt.spmm(P, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(joc.spmm_octet(
        JP, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(got, sp.astype(np.float64) @ X, **TOL)
