"""The CSR SpMV/SpMM routes of the port (``ops/spmv.py``, ``ops/spmm.py``)
against the JAX package.

``prepare_spmv`` and ``spmm``'s walk pack (``_dg_pack_of``) must pick the
same layout as the JAX package on the same matrix (dual-gather, strip,
octet, skew), with the same planes.  ``spmv``/``spmm``
on a CPU CSR through the auto routes must equal the JAX
``spmv_reference``/``spmm_reference`` and an fp64 oracle at the JAX tests'
tolerance (rtol 2e-3, atol 0.5).  The matrices are small, so the file
stays cheap.
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
from sparsematrix_tpu.ops.skew import skew_stats as jax_skew_stats
from sparsematrix_tpu.ops.spmm import spmm_reference as jax_spmm_reference
from sparsematrix_tpu.ops.spmv import prepare_spmv as jax_prepare_spmv
from sparsematrix_tpu.ops.spmv import spmv_reference as jax_spmv_reference
from sparsematrix_tpu_torch.ops.skew import skew_stats

jspmm = importlib.import_module("sparsematrix_tpu.ops.spmm")
tspmm = importlib.import_module("sparsematrix_tpu_torch.ops.spmm")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def uniform(rows, cols, per_row, seed):
    """``per_row`` column draws a row, duplicates merged (the JAX bench's
    ``csr_spmv_xl`` generator at a small size)."""
    g = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), per_row)
    c = g.integers(0, cols, rows * per_row)
    v = g.uniform(-1000, 1000, rows * per_row).astype(np.float32)
    sp = sps.coo_matrix((v, (r, c)), shape=(rows, cols)).tocsr()
    sp.sum_duplicates()
    return sp


@functools.lru_cache(maxsize=None)
def zipf(n, per_row, seed):
    """Column draws with Zipf weights 1/(c+1): a hub column far over the
    auto routes' power-law guard."""
    g = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n + 1)
    r = np.repeat(np.arange(n), per_row)
    c = g.choice(n, n * per_row, p=p / p.sum())
    v = g.uniform(-1000, 1000, n * per_row).astype(np.float32)
    sp = sps.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    return sp


@functools.lru_cache(maxsize=None)
def band(n, half_width, seed):
    g = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 2 * half_width + 1)
    c = r + np.tile(np.arange(-half_width, half_width + 1), n)
    keep = (c >= 0) & (c < n)
    v = g.uniform(-1000, 1000, int(keep.sum())).astype(np.float32)
    return sps.csr_matrix((v, (r[keep], c[keep])), shape=(n, n))


MATRICES = {
    "uniform-8-tiles": lambda: uniform(1024, 1024, 24, 0),
    "uniform-16-tiles": lambda: uniform(2048, 2048, 24, 1),
    "uniform-32-tiles": lambda: uniform(4096, 4096, 64, 6),
    "uniform-128-tiles": lambda: uniform(16384, 2048, 9, 2),
    "banded": lambda: band(1024, 40, 3),
    "2-per-row": lambda: uniform(2048, 2048, 2, 4),
    "zipf": lambda: zipf(4096, 20, 5),
    "8-per-row": lambda: uniform(2048, 2048, 8, 7),
    "small": lambda: uniform(300, 500, 4, 8),
}


def both(name):
    sp = MATRICES[name]()
    return smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp), sp


def _np(a):
    if torch.is_tensor(a):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_value(a, b, name):
    if b is None:
        assert a is None, name
    elif dataclasses.is_dataclass(b):
        assert_same_container(a, b)
    elif isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b), name
        for x, y in zip(a, b):
            _assert_same_value(x, y, name)
    else:
        x, y = _np(a), _np(b)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def jit_vjp(fn, primals, cotangent):
    """``fn(*primals)`` and its VJP at ``cotangent``, as one ``jax.jit``
    program: an eager call compiles each primitive of the JAX wrapper
    apart, which costs about 2.5 times the one compile of an
    interpret-mode Pallas reference (the octet trim case: 15.8 s eager,
    6.0 s jitted, in one process on the CPU)."""
    def value_and_vjp(p, c):
        y, vjp = jax.vjp(fn, *p)
        return y, vjp(c)

    return jax.jit(value_and_vjp)(tuple(primals), cotangent)


def assert_same_container(port, ref):
    """Same class name, equal statics, equal array fields (same dtype and
    values; tuples element by element, nested containers recursively)."""
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.metadata.get("static", False):
            assert a == b, (f.name, a, b)
        else:
            _assert_same_value(a, b, f.name)


@pytest.mark.parametrize("name", ["uniform-8-tiles", "uniform-16-tiles",
                                  "uniform-32-tiles", "uniform-128-tiles",
                                  "banded", "2-per-row", "zipf"])
def test_prepare_spmv_routes_like_jax(name):
    A, JA, _ = both(name)
    assert_same_container(smt.prepare_spmv(A), jax_prepare_spmv(JA))


@pytest.mark.parametrize("name", ["uniform-8-tiles", "8-per-row", "small",
                                  "zipf"])
def test_dg_pack_of_routes_like_jax(name):
    A, JA, _ = both(name)
    ref = jspmm._dg_pack_of(JA)
    got = tspmm._dg_pack_of(A)
    if ref is None:
        assert got is None
    else:
        assert_same_container(got, ref)


@pytest.mark.parametrize("name", ["uniform-8-tiles", "uniform-16-tiles",
                                  "uniform-128-tiles", "banded", "small"])
def test_spmv_auto_matches_jax(name):
    A, JA, sp = both(name)
    x = np.random.default_rng(20).standard_normal(sp.shape[1]).astype(
        np.float32)
    got = smt.spmv(A, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (sp.shape[0],)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_spmv_reference(JA, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), sp.astype(np.float64) @ x, **TOL)
    np.testing.assert_allclose(smt.spmv_reference(A, torch.from_numpy(x)),
                               sp.astype(np.float64) @ x, **TOL)


@pytest.mark.parametrize("name,k", [("uniform-8-tiles", 6), ("8-per-row", 5),
                                    ("banded", 4), ("uniform-16-tiles", 65),
                                    ("small", 3)])
def test_spmm_auto_matches_jax(name, k):
    """The k_tiles=1 walk, the sliced-ELL gather, the strip product, the
    segment-sum product above 64 columns, and below the walk's 4096
    entries."""
    A, JA, sp = both(name)
    X = np.random.default_rng(21).standard_normal((sp.shape[1], k)).astype(
        np.float32)
    got = smt.spmm(A, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_spmm_reference(JA, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(got, sp.astype(np.float64) @ X, **TOL)


def test_spmm_on_prepared_pack():
    """``spmm(prepare_spmv(A), X)``: the superblock pack serves SpMM too."""
    A, _, sp = both("uniform-16-tiles")
    P = smt.prepare_spmv(A)
    assert P.k_tiles == 16 and P.two_win
    X = np.random.default_rng(22).standard_normal((sp.shape[1], 7)).astype(
        np.float32)
    np.testing.assert_allclose(smt.spmm(P, torch.from_numpy(X)).numpy(),
                               sp.astype(np.float64) @ X, **TOL)
    x = X[:, 0].copy()
    np.testing.assert_allclose(smt.spmv(P, torch.from_numpy(x)).numpy(),
                               sp.astype(np.float64) @ x, **TOL)


def test_stripdense_matches_jax():
    A, JA, sp = both("banded")
    S = smt.StripDense.from_csr(A)
    JS = jf.StripDense.from_csr(JA)
    assert_same_container(S, JS)
    assert S.fill_rate == JS.fill_rate
    np.testing.assert_array_equal(S.todense().numpy(), np.asarray(JS.todense()))
    x = np.random.default_rng(23).standard_normal(sp.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(
        smt.spmv_reference(S, torch.from_numpy(x)).numpy(),
        np.asarray(jax_spmv_reference(JS, jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="not band-local"):
        smt.StripDense.from_csr(both("uniform-8-tiles")[0], max_width=256)


@pytest.mark.parametrize("name", ["zipf", "uniform-8-tiles"])
def test_skew_stats_match_jax(name):
    A, JA, _ = both(name)
    assert skew_stats(A) == jax_skew_stats(JA)


def test_csr_from_scipy_matches_jax():
    A, JA, _ = both("small")
    for f in ("indptr", "indices", "data", "row_ids"):
        assert np.array_equal(_np(getattr(A, f)), _np(getattr(JA, f))), f
    assert A.shape == JA.shape and A.nnz == JA.nnz
    assert A.to_scipy() is A.to_scipy()  # the host copy is kept


def test_unported_layouts_raise():
    """Every layout of ``prepare_spmv`` is ported, the pooled spill tail
    and the octet multi-RHS product included: both serve ``spmm`` (against
    fp64, rtol 2e-3, atol 0.5).  What is not ported raises: an unknown
    layout, and a format the port does not have, naming its ROADMAP
    queue."""
    A, _, sp = both("uniform-8-tiles")
    X = np.random.default_rng(21).standard_normal((sp.shape[1], 2)).astype(
        np.float32)
    want = sp.astype(np.float64) @ X
    for P in (smt.prepare_spmv(A, layout="dualgather", k_tiles=2,
                               spill_cap=4),
              smt.prepare_spmv(A, layout="octet")):
        np.testing.assert_allclose(smt.spmm(P, torch.from_numpy(X)).numpy(),
                                   want, **TOL)
    with pytest.raises(ValueError, match="unknown layout"):
        smt.prepare_spmv(A, layout="sell")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        smt.spmv_reference(sp, torch.ones(sp.shape[1]))
