"""The skew hybrid of the port (``ops/skew.py``) against the JAX package.

``pack_skew`` must be field-equal to the JAX pack (hub rows, hub columns,
a rectangular matrix, the all-rows-hub case, and a matrix large enough for
a Clos output permutation); ``spmv``/``spmm`` on a power-law CSR must take
the skew route as the JAX package does and agree with it and with an fp64
oracle at the JAX tests' tolerance (rtol 2e-3, atol 0.5), gradients too.
Power-law matrices come from the port's copy of the JAX bench's
generator, held equal to it here.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
from sparsematrix_tpu.bench.suite import gen_zipf_csr as jax_gen_zipf_csr
from sparsematrix_tpu.ops.skew import pack_skew as jax_pack_skew
from sparsematrix_tpu.ops.skew import spmm_skew as jax_spmm_skew
from sparsematrix_tpu.ops.skew import spmv_skew as jax_spmv_skew
from sparsematrix_tpu.ops.spmm import spmm_reference as jax_spmm_reference
from sparsematrix_tpu.ops.spmv import prepare_spmv as jax_prepare_spmv
from sparsematrix_tpu.ops.spmv import spmv_reference as jax_spmv_reference
from sparsematrix_tpu_torch.ops.skew import SkewSpmv, pack_skew
from sparsematrix_tpu_torch.utils.testutils import gen_zipf_csr
from test_torch_permute import jax_batched_colorer
from test_torch_spmv import assert_same_container

jspmm = importlib.import_module("sparsematrix_tpu.ops.spmm")
tspmm = importlib.import_module("sparsematrix_tpu_torch.ops.spmm")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def matrix(name):
    if name == "rowzipf":
        return gen_zipf_csr(9, 4096, 4096, 4096 * 32)
    if name == "hubcols":
        return gen_zipf_csr(9, 4096, 4096, 4096 * 32, col_zipf=True)
    if name == "rect":
        return gen_zipf_csr(6, 5000, 3000, 60_000)
    if name == "all-rows-hub":
        import scipy.sparse as sps

        d = np.random.default_rng(5).uniform(-1000, 1000, (128, 256))
        return sps.csr_matrix(d.astype(np.float32))
    if name == "clos-perm":
        return gen_zipf_csr(3, 16384, 16384, 16384 * 8)
    raise KeyError(name)


def both(name):
    sp = matrix(name)
    return smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp), sp


def test_gen_zipf_csr_matches_jax_bench():
    for col_zipf in (False, True):
        a = gen_zipf_csr(9, 2048, 1500, 2048 * 16, col_zipf=col_zipf)
        b = jax_gen_zipf_csr(9, 2048, 1500, 2048 * 16, col_zipf=col_zipf)
        assert (a != b).nnz == 0 and a.dtype == b.dtype
        assert np.array_equal(a.indptr, b.indptr)


@pytest.mark.parametrize("name", ["rowzipf", "hubcols", "rect",
                                  "all-rows-hub", "clos-perm"])
def test_pack_skew_matches_jax(monkeypatch, name):
    jax_batched_colorer(monkeypatch)  # as the port calls it
    A, JA, sp = both(name)
    P = pack_skew(A)
    assert_same_container(P, jax_pack_skew(JA))
    if name == "clos-perm":
        assert type(P.out_perm).__name__ == "ClosPermutePlan"
    x = np.random.default_rng(11).standard_normal(sp.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(smt.spmv(P, torch.from_numpy(x)).numpy(),
                               sp.astype(np.float64) @ x, **TOL)


@pytest.mark.parametrize("name", ["rowzipf", "hubcols"])
def test_skew_auto_routes_match_jax(name):
    A, JA, sp = both(name)
    P = smt.prepare_spmv(A)
    assert isinstance(P, SkewSpmv)
    assert_same_container(P, jax_prepare_spmv(JA))
    assert_same_container(tspmm._dg_pack_of(A), jspmm._dg_pack_of(JA))
    rng = np.random.default_rng(12)
    x = rng.standard_normal(sp.shape[1]).astype(np.float32)
    X = rng.standard_normal((sp.shape[1], 4)).astype(np.float32)
    sp64 = sp.astype(np.float64)
    y = smt.spmv(A, torch.from_numpy(x)).numpy()  # auto: packs, caches
    Y = smt.spmm(A, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(y, sp64 @ x, **TOL)
    np.testing.assert_allclose(Y, sp64 @ X, **TOL)
    np.testing.assert_allclose(
        y, np.asarray(jax_spmv_reference(JA, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        Y, np.asarray(jax_spmm_reference(JA, jnp.asarray(X))), **TOL)


def test_skew_products_and_vjp_match_jax():
    """The JAX skew products and VJP (its Pallas kernels in interpret
    mode) on a rowlane base, which exercises the per-column multi-RHS
    fallback too; the auto base's 256-slab groups take a minute in
    interpret mode."""
    A, JA, sp = both("hubcols")
    P, JP = pack_skew(A, layout="rowlane"), jax_pack_skew(JA, layout="rowlane")
    assert_same_container(P, JP)
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, sp.shape[1]).astype(np.float32)
    w = rng.uniform(-1, 1, sp.shape[0]).astype(np.float32)
    sp64 = sp.astype(np.float64)
    xt = torch.from_numpy(x).requires_grad_()
    y = smt.spmv(P, xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), sp64 @ x, **TOL)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jax.jit(jax_spmv_skew)(JP, jnp.asarray(x))), **TOL)
    jg = jax.jit(jax.grad(lambda v: (jax_spmv_skew(JP, v)
                                     * jnp.asarray(w)).sum()))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), sp64.T @ w, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)
    X = rng.uniform(-1, 1, (sp.shape[1], 3)).astype(np.float32)
    W = rng.uniform(-1, 1, (sp.shape[0], 3)).astype(np.float32)
    Xt = torch.from_numpy(X).requires_grad_()
    Y = smt.spmm(P, Xt)
    (Y * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(Y.detach().numpy(), sp64 @ X, **TOL)
    np.testing.assert_allclose(
        Y.detach().numpy(),
        np.asarray(jax.jit(jax_spmm_skew)(JP, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), sp64.T @ W, **TOL)


@functools.lru_cache(maxsize=None)
def octet_base_matrix():
    """n = 8192, 1-2 scattered entries a row plus 8 hub columns of ~7000
    entries each (nnz ≥ 65536): the power-law guard fires, and once the
    hub columns leave, the remainder holds ≲ 2 entries a row, which the
    base's auto route packs as an octet."""
    import scipy.sparse as sps

    g = np.random.default_rng(17)
    n = 8192
    r = np.repeat(np.arange(n), g.integers(1, 3, n))
    c = g.integers(0, n, r.size)
    hubs = g.choice(n, 8, replace=False)
    hr = np.concatenate([g.choice(n, 7000, replace=False) for _ in hubs])
    hc = np.repeat(hubs, 7000)
    rows_, cols_ = np.concatenate([r, hr]), np.concatenate([c, hc])
    v = g.uniform(-1000, 1000, rows_.size).astype(np.float32)
    sp = sps.coo_matrix((v, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    return sp


def test_spmm_skew_octet_base_matches_jax(monkeypatch):
    """``spmm(csr, X)`` on a power-law CSR whose skew base is an
    ``Octet``: the walk pack equals the JAX one, and the product (the
    base through ``spmm_octet``) equals the JAX ``spmm`` and fp64."""
    jax_batched_colorer(monkeypatch)  # as the port calls it
    sp = octet_base_matrix()
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    assert sp.nnz >= 65536
    P = tspmm._dg_pack_of(A)
    assert isinstance(P, SkewSpmv) and isinstance(P.base, smt.Octet)
    JP = jspmm._dg_pack_of(JA)
    assert_same_container(P, JP)
    X = np.random.default_rng(18).standard_normal((sp.shape[1], 5)).astype(
        np.float32)
    Y = smt.spmm(A, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, sp.astype(np.float64) @ X, **TOL)
    np.testing.assert_allclose(
        Y, np.asarray(jspmm.spmm(JA, jnp.asarray(X))), **TOL)
    # the JAX skew product on its pack: the base through its spmm_octet
    np.testing.assert_allclose(
        Y, np.asarray(jax.jit(jax_spmm_skew)(JP, jnp.asarray(X))), **TOL)
