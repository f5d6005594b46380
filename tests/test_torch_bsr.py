"""BSR in the port (``formats/bsr.py``, ``kernels/bsr.py`` and the BSR
routes of ``ops/spmm.py`` and ``ops/spmv.py``) against the JAX package.

The same seeded numpy fixture goes through both packages:

- every container and pack is ``np.array_equal`` to the JAX package's,
  field by field (``BSR`` from ``fromdense`` and ``csr_to_bsr``, with and
  without ``block_capacity``; ``BSRPanels``; ``bsr_to_csr``'s CSR);
- each kernel's plain version against the JAX Pallas kernel run in
  interpret mode, as ``tests/test_pallas_kernels.py`` runs it (one case a
  kernel and shape class: grouped at (8, 128) with an empty block-row and
  at (4, 4), panel at (8, 8)), the rest against fp64, at the JAX test's
  tolerance (rtol 1e-3, atol 1e-2);
- the routes: ``spmm`` on a small-block BSR reaches the panel layout; at
  M > 64 ``spmm`` takes the plain block product and ``spmm_bsr`` the
  grouped layout; the densify route exactly where ``_should_densify``
  says; ``spmv`` on a small-block BSR goes through its CSR;
- ``spmm_bsr``'s backward pass against ``jax.vjp`` of the JAX
  ``spmm_bsr``, padding slots' block gradients zero.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.kernels import bsr_pallas as jbp
from sparsematrix_tpu.ops import spmm_right as jax_spmm_right
from sparsematrix_tpu.ops import spmv_reference as jax_spmv_reference
from sparsematrix_tpu_torch.kernels import _build
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_random_dense_sparse,
                                                    quantized_check)
from test_torch_formats import assert_same_fields, jax_fields
# many small torch ops: one torch and one BLAS thread (autouse fixture)
from test_torch_trisolve import one_thread  # noqa: F401

jspmm = importlib.import_module("sparsematrix_tpu.ops.spmm")
tspmm = importlib.import_module("sparsematrix_tpu_torch.ops.spmm")
tspmv = importlib.import_module("sparsematrix_tpu_torch.ops.spmv")
tbp = importlib.import_module("sparsematrix_tpu_torch.kernels.bsr")

CPU = "cpu"
TOL = dict(rtol=1e-3, atol=1e-2)


def block_dense(seed, shape, block, density, empty_rows=()):
    """Dense blocks at ``density`` of the block slots (the bench's
    ``bench_bsr`` law), ragged edges cut, the given block-rows empty."""
    rng = np.random.default_rng(seed)
    bm, bn = block
    nbr, nbc = -(-shape[0] // bm), -(-shape[1] // bn)
    mask = rng.random((nbr, nbc)) < density
    mask[list(empty_rows)] = False
    full = (np.kron(mask, np.ones(block)).astype(np.float32)
            * gen_matrix_random(rng, nbr * bm, nbc * bn, -5, 5))
    return np.ascontiguousarray(full[: shape[0], : shape[1]])


def both(dense, block, capacity=None, via_csr=True):
    """The port's and the JAX package's BSR of ``dense``."""
    if via_csr:
        return (tf.csr_to_bsr(tf.CSR.fromdense(dense, device=CPU), block,
                              block_capacity=capacity),
                jf.csr_to_bsr(jf.CSR.fromdense(dense), block,
                              block_capacity=capacity))
    return (tf.BSR.fromdense(dense, block, block_capacity=capacity, device=CPU),
            jf.BSR.fromdense(dense, block, block_capacity=capacity))


def rhs(seed, rows, k):
    return np.random.default_rng(seed).uniform(-1, 1, (rows, k)).astype(
        np.float32)


# -- containers and packs ----------------------------------------------------

@pytest.mark.parametrize("via_csr", [False, True], ids=["fromdense", "csr"])
@pytest.mark.parametrize("capacity", [None, 400])
@pytest.mark.parametrize("block", [(4, 4), (8, 8), (3, 5)])
def test_bsr_fields_match_jax(block, capacity, via_csr):
    # scattered entries: csr_to_bsr keeps a block of explicit zeros where
    # fromdense would not, so both conversions see the same law
    dense = gen_random_dense_sparse(np.random.default_rng(1), 61, 75, 0.05)
    port, ref = both(dense, block, capacity, via_csr)
    assert_same_fields(port, ref)
    np.testing.assert_array_equal(port.todense().numpy(), dense)
    assert port.block_capacity == ref.block_capacity
    assert port.num_block_rows == ref.num_block_rows


@pytest.mark.parametrize("capacity", [None, 300])
@pytest.mark.parametrize("block", [(8, 8), (8, 16), (4, 8)])
def test_bsr_panels_match_jax(block, capacity):
    dense = block_dense(2, (120, 136), block, 0.1, empty_rows=(3,))
    port, ref = both(dense, block, capacity)
    assert_same_fields(tbp.pack_bsr_panels(port), jbp.pack_bsr_panels(ref))


@pytest.mark.parametrize("capacity", [None, 2000])
@pytest.mark.parametrize("block", [(4, 4), (8, 8)])
def test_bsr_to_csr_matches_jax(block, capacity):
    """Explicit zeros inside blocks are dropped, columns sorted, the same
    capacity: the CSR the JAX package makes through the dense matrix."""
    dense = gen_random_dense_sparse(np.random.default_rng(3), 50, 70, 0.1)
    port, ref = both(dense, block, 200)
    assert_same_fields(tf.bsr_to_csr(port, capacity=capacity),
                       jf.bsr_to_csr(ref, capacity=capacity))


@pytest.mark.parametrize("kind", ["BSR", "BSRPanels"])
def test_bsr_carry(kind):
    dense = block_dense(4, (64, 96), (8, 8), 0.2)
    port, ref = both(dense, (8, 8), 80)
    if kind == "BSRPanels":
        port, ref = tbp.pack_bsr_panels(port), jbp.pack_bsr_panels(ref)
    arrays, statics = jax_fields(ref)
    carried = tf.from_numpy_fields(kind, arrays, statics, device=CPU)
    assert_same_fields(carried, ref)
    X = rhs(5, 96, 7)
    if kind == "BSR":
        got = smt.spmm_bsr(carried, torch.from_numpy(X))
    else:
        got = tbp.spmm_bsr_panel_reference(carried, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), dense.astype(np.float64) @ X,
                               **TOL)


def test_bsr_without_block_row_ids():
    """A container whose ``block_row_ids`` is None computes them from
    ``indptr`` (padding slots land in block-row nbr), as the JAX one."""
    import dataclasses

    dense = block_dense(6, (40, 40), (4, 4), 0.2)
    port, ref = both(dense, (4, 4), 120)
    port0 = dataclasses.replace(port, block_row_ids=None)
    ref0 = dataclasses.replace(ref, block_row_ids=None)
    np.testing.assert_array_equal(port0._block_row_ids_or_compute().numpy(),
                                  np.asarray(ref0._block_row_ids_or_compute()))
    np.testing.assert_array_equal(port0.todense().numpy(), dense)
    X = torch.from_numpy(rhs(7, 40, 3))
    np.testing.assert_allclose(smt.spmm_bsr(port0, X).numpy(),
                               dense.astype(np.float64) @ X.numpy(), **TOL)


# -- the kernels' plain versions against the JAX Pallas kernels ---------------

def test_grouped_8x128_empty_row_matches_jax_pallas():
    """``jax.jit`` makes the JAX container traced, so its wrapper takes the
    grouped kernel (``test_pallas_kernels.py:84``); the port's grouped
    plain version must agree."""
    dense = gen_random_dense_sparse(np.random.default_rng(0), 96, 300, 0.05)
    dense[8:16] = 0  # an empty block-row
    port, ref = both(dense, (8, 128))
    X = rhs(8, 300, 64)
    want = np.asarray(jax.jit(jbp.spmm_bsr)(ref, jnp.asarray(X)))
    got = tbp.spmm_bsr_grouped_reference(port, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense.astype(np.float64) @ X, **TOL)
    assert np.all(got[8:16] == 0)


def test_grouped_4x4_matches_jax_pallas():
    """bn = 4 is no multiple of 8: both wrappers take the grouped kernel."""
    dense = block_dense(9, (62, 58), (4, 4), 0.15, empty_rows=(2,))
    port, ref = both(dense, (4, 4), 250)
    X = rhs(10, 58, 24)
    want = np.asarray(jbp.spmm_bsr(ref, jnp.asarray(X)))
    tbp._PANEL_CACHE.clear()
    got = smt.spmm_bsr(port, torch.from_numpy(X)).numpy()
    assert not tbp._PANEL_CACHE  # the grouped route packs no panels
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense.astype(np.float64) @ X, **TOL)


def test_panel_8x8_matches_jax_pallas():
    dense = block_dense(11, (128, 160), (8, 8), 0.12, empty_rows=(5,))
    port, ref = both(dense, (8, 8))
    X = rhs(12, 160, 32)
    want = np.asarray(jbp.spmm_bsr(ref, jnp.asarray(X)))  # concrete: panel
    packed = tbp.panel_route(port)
    assert packed is not None and packed.bcols.shape[1] <= 8
    got = tbp.spmm_bsr_panel_reference(packed, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense.astype(np.float64) @ X, **TOL)
    np.testing.assert_array_equal(smt.spmm_bsr(port, torch.from_numpy(X)),
                                  got)


@pytest.mark.parametrize("block,shape,capacity", [
    ((8, 8), (77, 93), None),      # ragged rows and columns
    ((8, 8), (64, 64), 500),       # capacity padding
    ((16, 8), (100, 90), None),
    ((8, 128), (50, 300), 40),
    ((32, 32), (128, 96), None),   # M = 1 where a block-row has one block
    ((6, 10), (60, 70), 100),
])
def test_both_plain_versions_against_fp64(block, shape, capacity):
    dense = block_dense(13, shape, block, 0.3, empty_rows=(1,))
    port, _ = both(dense, block, capacity)
    X = torch.from_numpy(rhs(14, shape[1], 9))
    want = dense.astype(np.float64) @ X.double().numpy()
    np.testing.assert_allclose(
        tbp.spmm_bsr_grouped_reference(port, X).numpy(), want, **TOL)
    np.testing.assert_allclose(
        tbp.spmm_bsr_panel_reference(tbp.pack_bsr_panels(port), X).numpy(),
        want, **TOL)
    np.testing.assert_allclose(smt.spmm_bsr(port, X).numpy(), want, **TOL)


def test_plain_versions_bf16():
    dense = block_dense(15, (64, 80), (8, 8), 0.25)
    port, _ = both(dense, (8, 8))
    port16 = port.astype(torch.bfloat16)
    X = torch.from_numpy(rhs(16, 80, 16)).to(torch.bfloat16)
    oracle = dense.astype(np.float64) @ X.double().numpy()
    for got in (tbp.spmm_bsr_grouped_reference(port16, X),
                tbp.spmm_bsr_panel_reference(tbp.pack_bsr_panels(port16), X),
                smt.spmm_bsr(port16, X)):
        assert got.dtype == torch.bfloat16
        assert quantized_check(got.float().numpy(), oracle)


# -- routes ---------------------------------------------------------------

def test_spmm_dispatch_uses_bsr_panels():
    """The twin of ``test_spmm_dispatch_uses_bsr_panels``: ``spmm`` on a
    small-block BSR packs the panel layout (cached once) and matches the
    oracle."""
    rng = np.random.default_rng(0)
    n = 256
    mask = rng.random((n // 8, n // 8)) < 0.1
    dense = (np.kron(mask, np.ones((8, 8))).astype(np.float32)
             * rng.uniform(-5, 5, (n, n)).astype(np.float32))
    A = tf.csr_to_bsr(tf.CSR.fromdense(dense, device=CPU), (8, 8))
    X = rng.uniform(-1, 1, (n, 16)).astype(np.float32)
    tbp._PANEL_CACHE.clear()
    Y = smt.spmm(A, torch.from_numpy(X), method="sparse")
    smt.spmm(A, torch.from_numpy(X), method="sparse")
    assert len(tbp._PANEL_CACHE) == 1, "panel layout not engaged"
    np.testing.assert_allclose(Y.numpy(), dense @ X, rtol=2e-4, atol=1e-4)


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_more_than_64_blocks_a_row(monkeypatch):
    """At M > 64 ``spmm`` takes the plain block product (``bsr_dispatch``)
    but ``spmm_bsr`` the grouped layout, as in the JAX package."""
    dense = block_dense(17, (16, 8 * 70), (8, 8), 1.0)
    port, ref = both(dense, (8, 8))
    assert tbp.pack_bsr_panels(port).bcols.shape[1] == 70
    X = rhs(18, 8 * 70, 4)
    want = dense.astype(np.float64) @ X
    to_kernel = _spy(monkeypatch, tspmm, "spmm_bsr")
    grouped = _spy(monkeypatch, tbp, "spmm_bsr_grouped_reference")
    panel = _spy(monkeypatch, tbp, "spmm_bsr_panel_reference")
    Y = smt.spmm(port, torch.from_numpy(X), method="sparse")
    assert to_kernel == [] and grouped == [] and panel == []
    np.testing.assert_allclose(Y.numpy(), want, **TOL)
    np.testing.assert_allclose(
        Y.numpy(), np.asarray(jspmm.spmm(ref, jnp.asarray(X),
                                         method="sparse")), **TOL)
    Y2 = smt.spmm_bsr(port, torch.from_numpy(X))
    assert grouped == ["spmm_bsr_grouped_reference"] and panel == []
    np.testing.assert_allclose(Y2.numpy(), want, **TOL)


def test_large_blocks_take_the_grouped_kernel(monkeypatch):
    """bm·bn ≥ 4096: ``spmm`` goes to ``spmm_bsr`` and its grouped layout."""
    dense = block_dense(19, (192, 256), (64, 64), 0.4, empty_rows=(1,))
    port, _ = both(dense, (64, 64))
    to_kernel = _spy(monkeypatch, tspmm, "spmm_bsr")
    grouped = _spy(monkeypatch, tbp, "spmm_bsr_grouped_reference")
    X = rhs(20, 256, 8)
    Y = smt.spmm(port, torch.from_numpy(X))
    assert to_kernel == ["spmm_bsr"] and grouped == ["spmm_bsr_grouped_reference"]
    np.testing.assert_allclose(Y.numpy(), dense.astype(np.float64) @ X, **TOL)


@pytest.mark.parametrize("density", [0.02, 0.05, 0.2])
def test_densify_route_where_should_densify_says(density):
    """``auto`` materializes a small-block BSR exactly where the JAX
    ``_should_densify`` (scalar nnz against 5 % of the matrix) says."""
    dense = block_dense(21, (128, 128), (8, 8), density)
    port, ref = both(dense, (8, 8))
    expect = bool(jspmm._should_densify(ref))
    assert tspmm._should_densify(port) == expect
    tspmm._BSR_DENSE_CACHE.clear()
    X = rhs(22, 128, 8)
    Y = smt.spmm(port, torch.from_numpy(X))
    assert (len(tspmm._BSR_DENSE_CACHE) == 1) == expect
    np.testing.assert_allclose(Y.numpy(), dense.astype(np.float64) @ X, **TOL)
    tspmm._BSR_DENSE_CACHE.clear()
    smt.spmm(port, torch.from_numpy(X), method="sparse")
    assert not tspmm._BSR_DENSE_CACHE


def test_spmv_small_blocks_go_through_csr():
    dense = block_dense(23, (256, 256), (8, 8), 0.2)
    port, ref = both(dense, (8, 8))
    x = rhs(24, 256, 1)[:, 0]
    tspmv._BSR_CSR_CACHE.clear()
    y = smt.spmv(port, torch.from_numpy(x))
    assert len(tspmv._BSR_CSR_CACHE) == 1
    (_, csr), = tspmv._BSR_CSR_CACHE.values()
    assert_same_fields(csr, jf.bsr_to_csr(ref))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_spmv_reference(ref, jnp.asarray(x))),
        rtol=2e-3, atol=0.5)
    np.testing.assert_allclose(y.numpy(), dense.astype(np.float64) @ x,
                               **TOL)


def test_spmv_large_blocks_take_the_plain_matvec():
    dense = block_dense(25, (200, 130), (64, 64), 0.5)
    port, ref = both(dense, (64, 64))
    x = rhs(26, 130, 1)[:, 0]
    tspmv._BSR_CSR_CACHE.clear()
    y = smt.spmv(port, torch.from_numpy(x))
    assert not tspmv._BSR_CSR_CACHE
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_spmv_reference(ref, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("block", [(8, 8), (4, 4)])
def test_spmm_right_matches_jax(block):
    """``X @ A`` through the stored ``Aᵀ``: a BSR and a CSR of ``Aᵀ``."""
    a = block_dense(27, (48, 40), block, 0.2)
    X = rhs(28, 24, 48)
    want = np.asarray(jax_spmm_right(jnp.asarray(X),
                                     jf.csr_to_bsr(jf.CSR.fromdense(a.T),
                                                   block)))
    for at in (tf.csr_to_bsr(tf.CSR.fromdense(a.T, device=CPU), block),
               tf.CSR.fromdense(a.T, device=CPU)):
        got = smt.spmm_right(torch.from_numpy(X), at).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, X.astype(np.float64) @ a, **TOL)


# -- autograd ---------------------------------------------------------------

@pytest.mark.parametrize("capacity", [None, 160])
def test_spmm_bsr_vjp_matches_jax(capacity):
    """The fixture of ``tests/test_autodiff.py:111-127``; with capacity
    padding, the padding slots' block gradients are zero."""
    rng = np.random.default_rng(0)
    dense = gen_random_dense_sparse(rng, 64, 128, density=0.15)
    port, ref = both(dense, (8, 8), capacity)
    X = rng.standard_normal((128, 16)).astype(np.float32)
    g = rng.standard_normal((64, 16)).astype(np.float32)
    _, vjp = jax.vjp(jbp.spmm_bsr, ref, jnp.asarray(X))
    dA, dX = vjp(jnp.asarray(g))
    data = port.data.clone().requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    Y = tbp.spmm_bsr(dataclasses.replace(port, data=data), Xt)
    Y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dX), **TOL)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(dA.data), **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(),
                               dense.T.astype(np.float64) @ g, **TOL)
    assert np.all(data.grad.numpy()[port.num_blocks:] == 0)
    # the bilinear check of the JAX test: <dblocks, blocks> == <g, A@X>
    np.testing.assert_allclose(float((data.grad * port.data).sum()),
                               float(np.sum(g * (dense @ X))),
                               rtol=2e-3, atol=2.0)


def test_spmm_bsr_forward_reads_the_tracked_blocks():
    """The blocks autograd tracks are the blocks the forward multiplies:
    other blocks than the container's are refused."""
    dense = block_dense(29, (64, 64), (8, 8), 0.3)
    port, _ = both(dense, (8, 8))
    with pytest.raises(ValueError, match="A.data"):
        tbp._SpmmBsr.apply(port, port.data.clone().requires_grad_(True),
                           torch.ones((64, 4)))


def test_cpu_bsr_launches_nothing():
    dense = block_dense(29, (64, 64), (8, 8), 0.3)
    port, _ = both(dense, (8, 8))
    _build.launch_counts.clear()
    smt.spmm(port, torch.ones((64, 4)), method="sparse")
    smt.spmm_bsr(port, torch.ones((64, 4)))
    smt.spmv(port, torch.ones(64))
    assert sum(_build.launch_counts.values()) == 0
