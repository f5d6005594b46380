"""The pooled spill tail of the dual-gather layout (``spill_cap``,
``PooledDG`` in ``kernels/spmv_dualgather.py``) against the JAX package.

``pack_dualgather(spill_cap=8 | 16 | "auto")`` must give planes
``np.array_equal`` to the JAX packer's, field by field, the tail
included, at k_tiles 1 and > 1.  ``spmv`` and ``spmm`` over such packs,
and the VJP in x and in the values of the body and the tail, are held
against the JAX functions (Pallas in interpret mode on the CPU, as
``tests/test_dualgather.py`` runs them) and an fp64 oracle at the JAX
tests' tolerance (rtol 2e-3, atol 0.5; the same against JAX).  The JAX
SpMM backward pass leaves the tail out, so the port's SpMM gradients are
held against fp64 alone.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
from sparsematrix_tpu.ops.spmv import prepare_spmv as jax_prepare_spmv
from sparsematrix_tpu_torch.utils.testutils import gen_random_dense_sparse
from test_torch_spmv import assert_same_container
from test_torch_trisolve import carry

jdg = importlib.import_module("sparsematrix_tpu.kernels.spmv_dualgather")
jmm = importlib.import_module("sparsematrix_tpu.kernels.spmm_dualgather")
tdg = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_dualgather")
tmm = importlib.import_module("sparsematrix_tpu_torch.kernels.spmm_dualgather")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def matrix(rows, cols, density, seed):
    dense = gen_random_dense_sparse(np.random.default_rng(seed), rows, cols,
                                    density=density)
    dense.setflags(write=False)
    return dense


def packs(dense, **kw):
    """(port pack, JAX pack) with the same pack arguments."""
    return (tdg.pack_dualgather(smt.CSR.fromdense(dense, device=CPU), **kw),
            jdg.pack_dualgather(jf.CSR.fromdense(dense), **kw))


# (256, 2048, 0.08): ~20 entries a row-window, the tail of
# test_dualgather_spill_vjp; k_tiles > 1 packs superblocks of 2 tiles
PLANE_CASES = [(cap, kt) for cap in (8, 16, "auto") for kt in (1, 2)]


@pytest.mark.parametrize("cap,k_tiles", PLANE_CASES)
def test_spill_pack_planes_equal(cap, k_tiles):
    port, ref = packs(matrix(256, 2048, 0.08, 1), spill_cap=cap,
                      k_tiles=k_tiles, group=4)
    assert ref.tail is not None
    assert_same_container(port, ref)
    assert port.fill_rate == ref.fill_rate


def test_spill_pack_carries_from_jax():
    """A JAX pack with a tail carries into the port field by field
    (``from_numpy_fields``, the ``PooledDG`` first) and multiplies as the
    port's own pack does."""
    dense = matrix(256, 2048, 0.08, 1)
    port, ref = packs(dense, spill_cap=8, k_tiles=2, group=4)
    carried = carry(ref)
    assert_same_container(carried, ref)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        2048).astype(np.float32))
    torch.testing.assert_close(smt.spmv(carried, x), smt.spmv(port, x))


def test_spill_pack_numpy_repair_and_transpose(monkeypatch):
    """The body's numpy slot repair, and a transposed pack with its own
    tail, both as the JAX packer builds them."""
    monkeypatch.setattr(jdg, "_assign_slots_native", lambda *a, **k: None)
    monkeypatch.setattr(tdg, "_assign_slots_native", lambda *a, **k: None)
    port, ref = packs(matrix(256, 1024, 0.08, 2), spill_cap=8,
                      with_transpose=True)
    assert ref.tail is not None and ref.t_pack.tail is not None
    assert_same_container(port, ref)


def test_spill_auto_below_mean_eight_packs_no_tail():
    """Below a mean row-window degree of 8 ``"auto"`` sets no cap."""
    port, ref = packs(matrix(256, 2048, 0.002, 3), spill_cap="auto")
    assert port.tail is None and ref.tail is None
    assert_same_container(port, ref)


@pytest.mark.parametrize("cap", [8, 16, "auto"])
def test_spill_spmv_matches_jax(cap):
    """The density of test_dualgather_spill_cap (0.06 over 4096 columns,
    ~246 entries a row) on a quarter of its rows: capped body plus pooled
    tail; the tail's own product is what the body leaves.  The JAX kernel
    at caps 16 and auto (one of the two fixed caps: the same kernel and
    shape class), fp64 at every cap."""
    dense = matrix(128, 4096, 0.06, 4)
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    port, ref = packs(dense, spill_cap=cap)
    assert port.tail is not None
    got = smt.spmv(port, torch.from_numpy(x)).numpy()
    if cap != 8:
        np.testing.assert_allclose(
            got, np.asarray(jdg.spmv_dualgather(ref, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got, dense.astype(np.float64) @ x, **TOL)
    body = smt.spmv(dataclasses.replace(port, tail=None),
                    torch.from_numpy(x))
    tail = tdg.pooled_plain(port.tail, torch.from_numpy(x)[:, None])[:, 0]
    np.testing.assert_allclose((body + tail).numpy(), got, rtol=1e-6,
                               atol=1e-3)


@pytest.mark.parametrize("with_transpose", [False, True])
def test_spill_spmv_vjp_matches_jax(with_transpose):
    """test_dualgather_spill_vjp: the x cotangent (the plain scatter, or
    the forward walk over A^T's pack with its own tail) and the value
    cotangents of the body and the tail, against ``jax.vjp``."""
    dense = matrix(128, 2048, 0.08, 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(2048).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    port, ref = packs(dense, spill_cap=8, with_transpose=with_transpose)
    assert port.tail is not None

    def jax_fn(v, tv, xx):
        p = dataclasses.replace(ref, vals=v,
                                tail=dataclasses.replace(ref.tail, vals=tv))
        return jdg.spmv_dualgather(p, xx)

    _, vjp = jax.vjp(jax_fn, ref.vals, ref.tail.vals, jnp.asarray(x))
    want_dv, want_dt, want_gx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    v = port.vals.clone().requires_grad_()
    tv = port.tail.vals.clone().requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    pk = dataclasses.replace(port, vals=v,
                             tail=dataclasses.replace(port.tail, vals=tv))
    smt.spmv_dualgather(pk, xx).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xx.grad.numpy(), want_gx, **TOL)
    np.testing.assert_allclose(xx.grad.numpy(),
                               dense.T.astype(np.float64) @ g, **TOL)
    np.testing.assert_allclose(v.grad.numpy(), want_dv, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(tv.grad.numpy(), want_dt, rtol=2e-3,
                               atol=1e-4)
    assert np.abs(tv.grad.numpy()).max() > 0
    assert (tv.grad.numpy()[port.tail.vals.numpy() == 0] == 0).all()


@pytest.mark.parametrize("k", [1, 9])
def test_spill_spmm_superblock_matches_jax(monkeypatch, k):
    """test_spmm_dualgather_superblock_splits_and_spill with a tail: a
    superblock pack cut into calls by a small prefetch budget, with
    ``spill_cap``, through the multi-RHS walk (the tail one launch for
    all k columns); the JAX kernel at k = 9, fp64 at both."""
    monkeypatch.setattr(jdg, "_SMEM_PREFETCH_BUDGET", 600)
    monkeypatch.setattr(tdg, "_SMEM_PREFETCH_BUDGET", 600)
    dense = matrix(2048, 2048, 0.02, 8)
    port, ref = packs(dense, group=2, k_tiles=2, spill_cap=16)
    assert port.splits and port.tail is not None
    assert_same_container(port, ref)
    X = np.random.default_rng(9).standard_normal((2048, k)).astype(
        np.float32)
    got = smt.spmm(port, torch.from_numpy(X)).numpy()
    if k > 1:
        np.testing.assert_allclose(
            got, np.asarray(jmm.spmm_dualgather(ref, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(got, dense.astype(np.float64) @ X, **TOL)


def test_spill_spmm_grads_match_fp64():
    """The SpMM VJP takes the tail's entries (the JAX one leaves them
    out): the X cotangent against fp64 ``A^T G``, the value cotangents of
    the body and of the tail against the fp64 ``X[col] · G[row]`` sums at
    their stored slots (rtol 2e-3, atol 0.5; values to atol 1e-3).  The
    body's is held against JAX in ``test_torch_spmm_dualgather.py``."""
    dense = matrix(512, 2048, 0.04, 10)
    rng = np.random.default_rng(11)
    X = rng.standard_normal((2048, 3)).astype(np.float32)
    G = rng.standard_normal((512, 3)).astype(np.float32)
    port, _ = packs(dense, group=4, k_tiles=2, spill_cap=8)
    assert port.tail is not None
    v = port.vals.clone().requires_grad_()
    tv = port.tail.vals.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    pk = dataclasses.replace(port, vals=v,
                             tail=dataclasses.replace(port.tail, vals=tv))
    smt.spmm_dualgather(pk, Xt).backward(torch.from_numpy(G))
    np.testing.assert_allclose(Xt.grad.numpy(),
                               dense.T.astype(np.float64) @ G, **TOL)
    Xp = np.zeros((port.n_win * 1024, 3))
    Xp[:2048] = X
    Gp = np.concatenate([G.astype(np.float64), np.zeros((1, 3))])
    for part, coords, grad in ((port, tdg._slot_row_col, v.grad),
                               (port.tail, tdg._slot_row_col_pooled,
                                tv.grad)):
        row, col = (t.numpy() for t in coords(part))
        want = (Xp[col] * Gp[np.minimum(row, 512)]).sum(-1)
        want[part.vals.numpy() == 0] = 0
        np.testing.assert_allclose(grad.numpy(), want, rtol=2e-3,
                                   atol=1e-3)


def test_spill_spmm_kt1_tail_raises_like_jax():
    dense = matrix(256, 2048, 0.08, 1)
    port, ref = packs(dense, spill_cap=8)
    X = np.ones((2048, 2), np.float32)
    with pytest.raises(ValueError, match="no tail"):
        jmm.spmm_dualgather(ref, jnp.asarray(X))
    with pytest.raises(ValueError, match="no tail"):
        tmm.spmm_dualgather(port, torch.from_numpy(X))


def test_prepare_spmv_spill_cap_passes_through():
    """``prepare_spmv(A, spill_cap=...)`` routes the cap to the
    dual-gather packer with JAX's rule: ``two_win`` only without a cap."""
    dense = matrix(2048, 2048, 0.01, 12)
    A, JA = smt.CSR.fromdense(dense, device=CPU), jf.CSR.fromdense(dense)
    P = smt.prepare_spmv(A, spill_cap="auto")
    ref = jax_prepare_spmv(JA, spill_cap="auto")
    assert isinstance(P, smt.DualGather) and not P.two_win
    assert_same_container(P, ref)
    x = np.random.default_rng(13).standard_normal(2048).astype(np.float32)
    np.testing.assert_allclose(smt.spmv(P, torch.from_numpy(x)).numpy(),
                               dense.astype(np.float64) @ x, **TOL)
    P2 = smt.prepare_spmv(A, layout="dualgather", k_tiles=8, spill_cap=8)
    assert P2.tail is not None
    X = np.random.default_rng(14).standard_normal((2048, 4)).astype(
        np.float32)
    np.testing.assert_allclose(smt.spmm(P2, torch.from_numpy(X)).numpy(),
                               dense.astype(np.float64) @ X, **TOL)
