"""The rest of the format layer and the small plain ops of the port
against the JAX package: COO, the scalar ELL, ``validate``, every
conversion, ``from_torch``/``to_torch``, the transposes and transposed
products, the elementwise ops, sparse addition and the containers' common
API.

The same seeded numpy fixture goes through both packages; containers and
plans must be ``np.array_equal`` field by field, values must agree with
the JAX result at the JAX tests' tolerance.  The cases are those of
``tests/test_formats_roundtrip.py``, ``test_add_validate.py``,
``test_elementwise_interop.py``, the transpose cases of
``test_gmres_transpose.py`` and the ``csr_to_bsr(…, (4, 4))`` case of
``test_property_sweep.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu.ops as jops
import sparsematrix_tpu_torch as smt
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.formats.interop import from_torch as jax_from_torch
from sparsematrix_tpu.formats.interop import to_torch as jax_to_torch
from sparsematrix_tpu_torch.utils.testutils import (gen_random_dense_sparse,
                                                    gen_sparse_index_matrix)
from test_torch_formats import assert_same_fields, jax_fields
# many small torch ops: one torch and one BLAS thread (autouse fixture)
from test_torch_trisolve import one_thread  # noqa: F401

CPU = "cpu"
SHAPES = [(7, 5), (64, 64), (127, 65), (257, 130)]
TOL = dict(rtol=1e-5, atol=1e-4)


def _rand(seed, shape, density=0.25):
    return gen_random_dense_sparse(np.random.default_rng(seed), *shape,
                                   density=density)


# -- containers ---------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cls", ["COO", "CSR", "ELL"])
def test_dense_roundtrip_matches_jax(cls, shape):
    dense = _rand(sum(shape), shape)
    port = getattr(tf, cls).fromdense(dense, device=CPU)
    ref = getattr(jf, cls).fromdense(dense)
    assert_same_fields(port, ref)
    np.testing.assert_array_equal(port.todense().numpy(), dense)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [(4, 4), (8, 8)])
def test_bsr_roundtrip_matches_jax(shape, block):
    dense = _rand(sum(shape) + 1, shape)
    port = tf.BSR.fromdense(dense, block_shape=block, device=CPU)
    assert_same_fields(port, jf.BSR.fromdense(dense, block_shape=block))
    np.testing.assert_array_equal(port.todense().numpy(), dense)
    np.testing.assert_array_equal(port.to_scipy().toarray(), dense)


def test_ell_capacity_and_truncate():
    dense = _rand(3, (30, 40), 0.3)
    for kw in (dict(row_capacity=40), dict(row_capacity=3, truncate=True)):
        assert_same_fields(tf.ELL.fromdense(dense, device=CPU, **kw),
                           jf.ELL.fromdense(dense, **kw))
    with pytest.raises(ValueError, match="row_capacity"):
        tf.ELL.fromdense(dense, row_capacity=3, device=CPU)


def test_padding_capacity_is_harmless():
    dense = _rand(4, (33, 47))
    nnz = int((dense != 0).sum())
    for cls in ("COO", "CSR"):
        port = getattr(tf, cls).fromdense(dense, capacity=nnz + 100,
                                          device=CPU)
        assert_same_fields(port, getattr(jf, cls).fromdense(
            dense, capacity=nnz + 100))
        np.testing.assert_array_equal(port.todense().numpy(), dense)


def test_coo_from_arrays_and_scipy():
    dense = _rand(5, (20, 30))
    sp = sps.random(20, 30, density=0.2, format="coo",
                    random_state=np.random.default_rng(5)).astype(np.float32)
    assert_same_fields(tf.COO.from_scipy(sp, capacity=200, device=CPU),
                       jf.COO.from_scipy(sp, capacity=200))
    r, c = np.nonzero(dense)
    assert_same_fields(tf.COO.from_arrays(r, c, dense[r, c], dense.shape,
                                          device=CPU),
                       jf.COO.from_arrays(r, c, dense[r, c], dense.shape))
    port = tf.COO.fromdense(dense, device=CPU)
    assert (port.to_scipy() != jf.COO.fromdense(dense).to_scipy()).nnz == 0


@pytest.mark.parametrize("cls", ["COO", "CSR"])
def test_transpose_matches_jax(cls):
    dense = _rand(6, (31, 57))
    port = getattr(tf, cls).fromdense(dense, device=CPU)
    ref = getattr(jf, cls).fromdense(dense)
    assert_same_fields(port.T, ref.T)
    np.testing.assert_array_equal(port.T.todense().numpy(), dense.T)


def test_csc_and_scipy_bridge():
    dense = _rand(7, (40, 30))
    assert_same_fields(tf.CSC.fromdense(dense, device=CPU),
                       jf.CSC.fromdense(dense))
    csr = tf.CSR.fromdense(dense, device=CPU)
    np.testing.assert_array_equal(csr.to_scipy().toarray(), dense)
    again = tf.CSR.from_scipy(sps.csr_matrix(dense), device=CPU)
    assert_same_fields(again, jf.CSR.from_scipy(sps.csr_matrix(dense)))


def test_encode_idempotent():
    dense = _rand(8, (65, 129))
    a = tf.CSR.fromdense(dense, device=CPU)
    b = tf.CSR.fromdense(a.todense().numpy(), device=CPU)
    assert_same_fields(a, jf.CSR.fromdense(dense))
    np.testing.assert_array_equal(a.todense().numpy(), b.todense().numpy())


def test_common_api():
    dense = _rand(9, (12, 20))
    A = tf.CSR.fromdense(dense, device=CPU)
    ref = jf.CSR.fromdense(dense)
    assert (A.nrows, A.ncols, A.ndim) == (ref.nrows, ref.ncols, ref.ndim)
    assert A.dtype == torch.float32
    A16 = A.astype(torch.bfloat16)
    assert A16.dtype == torch.bfloat16 and A16.indices is A.indices
    assert A.allclose(tf.COO.fromdense(dense, device=CPU))
    assert not A.allclose(smt.scale(A, 2.0))
    assert not A.allclose(tf.CSR.fromdense(dense[:, :10], device=CPU))
    assert A.allclose(smt.scale(A, 1.0 + 1e-7), rtol=1e-5)
    assert repr(A) == "CSR({'shape': (12, 20), 'nnz': %d})" % A.nnz
    assert A.block_until_ready() is A
    D = tf.Dense.from_sparse(tf.BSR.fromdense(dense, (4, 4), device=CPU))
    Dj = jf.Dense.from_sparse(jf.BSR.fromdense(dense, (4, 4)))
    assert_same_fields(D, Dj)
    assert_same_fields(D.T, Dj.T)
    assert D.density == Dj.density


# -- conversions -------------------------------------------------------------

def test_conversion_chain_matches_jax():
    dense = _rand(10, (96, 200), 0.1)
    port = tf.CSR.fromdense(dense, device=CPU)
    ref = jf.CSR.fromdense(dense)
    pairs = [
        (tf.csr_to_coo(port), jf.csr_to_coo(ref)),
        (tf.coo_to_csr(tf.csr_to_coo(port)), jf.coo_to_csr(jf.csr_to_coo(ref))),
        (tf.csr_to_ell(port)[0], jf.csr_to_ell(ref)[0]),
        (tf.ell_to_csr(tf.csr_to_ell(port)[0]),
         jf.ell_to_csr(jf.csr_to_ell(ref)[0])),
        (tf.csr_to_bsr(port, block_shape=(8, 8)),
         jf.csr_to_bsr(ref, block_shape=(8, 8))),
        (tf.bsr_to_csr(tf.csr_to_bsr(port, block_shape=(8, 8))),
         jf.bsr_to_csr(jf.csr_to_bsr(ref, block_shape=(8, 8)))),
        (tf.csr_to_blocked_ell(port, block_shape=(8, 64)),
         jf.csr_to_blocked_ell(ref, block_shape=(8, 64))),
    ]
    for got, want in pairs:
        assert_same_fields(got, want)
        np.testing.assert_array_equal(got.todense().numpy(), dense)


@pytest.mark.parametrize("kw", [dict(), dict(sort_rows=True),
                                dict(row_capacity=4, truncate=True),
                                dict(row_capacity=40, sort_rows=True)])
def test_csr_to_ell_matches_jax(kw):
    dense = _rand(11, (50, 80), 0.2)
    port, perm = tf.csr_to_ell(tf.CSR.fromdense(dense, device=CPU), **kw)
    ref, jperm = jf.csr_to_ell(jf.CSR.fromdense(dense), **kw)
    assert_same_fields(port, ref)
    np.testing.assert_array_equal(perm, jperm)
    if "truncate" not in kw:
        out = np.zeros_like(dense)
        out[perm] = port.todense().numpy()
        np.testing.assert_array_equal(out, dense)
    assert_same_fields(tf.ell_to_csr(port, capacity=900),
                       jf.ell_to_csr(ref, capacity=900))


def test_csr_to_ell_rejects_long_rows():
    dense = _rand(12, (20, 30), 0.5)
    with pytest.raises(ValueError, match="row_capacity"):
        tf.csr_to_ell(tf.CSR.fromdense(dense, device=CPU), row_capacity=2)


@pytest.mark.parametrize("seed,shape,density", [(0, (37, 53), 0.1),
                                                (1, (128, 64), 0.05),
                                                (2, (5, 300), 0.3)])
def test_property_sweep_bsr_4x4(seed, shape, density):
    """The block-format case of ``test_property_sweep.py``: the (4, 4)
    conversion is exact and plane-equal to the JAX one."""
    dense = gen_random_dense_sparse(np.random.default_rng(seed), *shape,
                                    density=density)
    A = tf.CSR.fromdense(dense, device=CPU)
    got = tf.csr_to_bsr(A, block_shape=(4, 4))
    assert_same_fields(got, jf.csr_to_bsr(jf.CSR.fromdense(dense), (4, 4)))
    np.testing.assert_array_equal(got.todense().numpy(), dense)


@pytest.mark.parametrize("kind", ["COO", "ELL"])
def test_carry_coo_ell(kind):
    dense = _rand(13, (30, 40))
    ref = getattr(jf, kind).fromdense(dense)
    arrays, statics = jax_fields(ref)
    carried = tf.from_numpy_fields(kind, arrays, statics, device=CPU)
    assert_same_fields(carried, ref)


# -- products of COO and ELL -------------------------------------------------

@pytest.mark.parametrize("kind", ["COO", "ELL"])
def test_coo_ell_products_match_jax(kind):
    dense = _rand(14, (45, 60), 0.2)
    port = getattr(tf, kind).fromdense(dense, device=CPU)
    ref = getattr(jf, kind).fromdense(dense)
    rng = np.random.default_rng(15)
    x = rng.uniform(-1, 1, 60).astype(np.float32)
    X = rng.uniform(-1, 1, (60, 9)).astype(np.float32)
    for method in ("auto", "sparse", "densify"):
        np.testing.assert_allclose(
            smt.spmm(port, torch.from_numpy(X), method=method).numpy(),
            np.asarray(jops.spmm(ref, jnp.asarray(X), method=method)),
            rtol=2e-3, atol=0.5)
    np.testing.assert_allclose(smt.spmv(port, torch.from_numpy(x)).numpy(),
                               np.asarray(jops.spmv(ref, jnp.asarray(x))),
                               rtol=2e-3, atol=0.5)
    np.testing.assert_allclose(smt.spmv(port, torch.from_numpy(x)).numpy(),
                               dense.astype(np.float64) @ x, rtol=2e-3,
                               atol=0.5)


# -- validate ------------------------------------------------------------------

def test_validate_clean():
    rng = np.random.default_rng(16)
    dense = gen_random_dense_sparse(rng, 15, 20, density=0.3)
    assert tf.validate(tf.CSR.fromdense(dense, capacity=200, device=CPU)) == []
    assert tf.validate(tf.COO.fromdense(dense, capacity=200, device=CPU)) == []
    idx, table = gen_sparse_index_matrix(rng, 10, 12, density=0.4,
                                         table_size=7)
    assert tf.validate(tf.CodebookCSR.from_index_matrix(idx, table,
                                                        device=CPU)) == []
    assert tf.validate(tf.BSR.fromdense(dense, block_shape=(4, 4),
                                        block_capacity=40, device=CPU)) == []


def _corrupt(A, name, index, value):
    t = getattr(A, name).clone()
    t[index] = value
    return dataclasses.replace(A, **{name: t})


def test_validate_catches_corruption_as_jax():
    """Each corruption gives the JAX validator's list of problems."""
    dense = gen_random_dense_sparse(np.random.default_rng(17), 10, 10, 0.3)
    csr = tf.CSR.fromdense(dense, capacity=40, device=CPU)
    jcsr = jf.CSR.fromdense(dense, capacity=40)
    coo = tf.COO.fromdense(dense, capacity=40, device=CPU)
    jcoo = jf.COO.fromdense(dense, capacity=40)
    bsr = tf.BSR.fromdense(dense, (4, 4), block_capacity=12, device=CPU)
    jbsr = jf.BSR.fromdense(dense, (4, 4), block_capacity=12)
    cases = [
        (csr, jcsr, "indices", 0, 99), (csr, jcsr, "indptr", 0, 5),
        (csr, jcsr, "indptr", -1, 3), (csr, jcsr, "data", -1, 1.0),
        (csr, jcsr, "row_ids", 0, 4),
        (coo, jcoo, "row", 0, 10), (coo, jcoo, "col", 1, -1),
        (coo, jcoo, "data", -1, 2.0),
        (bsr, jbsr, "indices", 0, 3), (bsr, jbsr, "indptr", 1, 9),
        (bsr, jbsr, "data", -1, 1.0),
    ]
    for port, ref, name, i, v in cases:
        got = tf.validate(_corrupt(port, name, i, v))
        want = jf.validate(dataclasses.replace(
            ref, **{name: getattr(ref, name).at[i].set(v)}))
        assert got == want and got, (name, got, want)


def test_validate_unsupported_type():
    ell = tf.ELL.fromdense(np.eye(3, dtype=np.float32), device=CPU)
    assert tf.validate(ell) == ["validate: unsupported type ELL"]


# -- interop -----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["csr", "coo"])
def test_torch_roundtrip_matches_jax(layout):
    dense = _rand(18, (18, 14), 0.3)
    A = tf.CSR.fromdense(dense, device=CPU)
    t = smt.to_torch(A)
    jt = jax_to_torch(jf.CSR.fromdense(dense))
    assert t.layout == torch.sparse_csr
    np.testing.assert_array_equal(t.to_dense().numpy(), jt.to_dense().numpy())
    if layout == "coo":
        t, jt = t.to_sparse_coo(), jt.to_sparse_coo()
    back = smt.from_torch(t, capacity=100)
    assert back.device.type == "cpu"
    assert_same_fields(back, jax_from_torch(jt, capacity=100))
    np.testing.assert_array_equal(back.todense().numpy(), dense)


# -- transposed products and the transpose on the device ----------------------

@pytest.mark.parametrize("cls", ["CSR", "COO"])
def test_spmv_t_matches_jax(cls):
    dense = _rand(19, (40, 30), 0.2)
    port = getattr(tf, cls).fromdense(dense, device=CPU)
    ref = getattr(jf, cls).fromdense(dense)
    y = np.random.default_rng(20).uniform(-1, 1, 40).astype(np.float32)
    got = smt.spmv_t(port, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.spmv_t(ref, jnp.asarray(y))),
                               **TOL)
    np.testing.assert_allclose(got, dense.T.astype(np.float64) @ y, rtol=1e-3,
                               atol=1e-2)


def test_spmm_t_and_padded_capacity_match_jax():
    dense = _rand(21, (35, 25), 0.2)
    nnz = int((dense != 0).sum())
    rng = np.random.default_rng(22)
    Y = rng.uniform(-1, 1, (35, 6)).astype(np.float32)
    y = Y[:, 0].copy()
    for cap in (None, nnz + 37):
        port = tf.CSR.fromdense(dense, capacity=cap, device=CPU)
        ref = jf.CSR.fromdense(dense, capacity=cap)
        np.testing.assert_allclose(
            smt.spmm_t(port, torch.from_numpy(Y)).numpy(),
            np.asarray(jops.spmm_t(ref, jnp.asarray(Y))), **TOL)
        np.testing.assert_allclose(
            smt.spmv_t(port, torch.from_numpy(y)).numpy(),
            np.asarray(jops.spmv_t(ref, jnp.asarray(y))), **TOL)
    with pytest.raises(ValueError):
        smt.spmv_t(port, torch.ones(3))
    with pytest.raises(TypeError):
        smt.spmv_t(tf.Dense.fromdense(dense, device=CPU), torch.ones(35))


@pytest.mark.parametrize("capacity", [None, 400])
def test_csr_transpose_device_matches_jax(capacity):
    dense = _rand(23, (50, 70), 0.08)
    port = tf.CSR.fromdense(dense, capacity=capacity, device=CPU)
    ref = jf.CSR.fromdense(dense, capacity=capacity)
    At = smt.csr_transpose_device(port)
    assert_same_fields(At, jax.jit(jops.csr_transpose_device)(ref))
    np.testing.assert_array_equal(At.todense().numpy(), dense.T)
    np.testing.assert_array_equal(
        smt.csr_transpose_device(At).todense().numpy(), dense)


# -- elementwise ---------------------------------------------------------------

def test_elementwise_matches_jax():
    dense = _rand(24, (25, 25), 0.3)
    A = tf.CSR.fromdense(dense, capacity=300, device=CPU)
    J = jf.CSR.fromdense(dense, capacity=300)
    assert_same_fields(smt.scale(A, 2.5), jops.scale(J, 2.5))
    B = smt.scale(A, -1.0)
    assert_same_fields(smt.axpy_same_pattern(0.5, A, B),
                       jops.axpy_same_pattern(0.5, J, jops.scale(J, -1.0)))
    np.testing.assert_array_equal(smt.diagonal(A).numpy(),
                                  np.asarray(jops.diagonal(J)))
    np.testing.assert_allclose(float(smt.frobenius_norm(A)),
                               float(jops.frobenius_norm(J)), rtol=1e-6)
    np.testing.assert_allclose(float(smt.frobenius_norm(A)),
                               np.linalg.norm(dense), rtol=1e-5)
    assert_same_fields(smt.with_data(A, A.data * 0),
                       jops.with_data(J, J.data * 0))
    with pytest.raises(ValueError):
        smt.axpy_same_pattern(1.0, A, tf.CSR.fromdense(dense, device=CPU))


# -- sparse addition ----------------------------------------------------------

def test_sparse_add_matches_jax():
    rng = np.random.default_rng(25)
    a = gen_random_dense_sparse(rng, 30, 40, density=0.15)
    b = gen_random_dense_sparse(rng, 30, 40, density=0.15)
    A = tf.CSR.fromdense(a, capacity=250, device=CPU)
    B = tf.CSR.fromdense(b, device=CPU)
    JA, JB = jf.CSR.fromdense(a, capacity=250), jf.CSR.fromdense(b)
    assert_same_fields(smt.sparse_add_plan(A, B), jops.sparse_add_plan(JA, JB))
    C = smt.sparse_add(A, B, alpha=2.0, beta=-1.0)
    assert_same_fields(C, jops.sparse_add(JA, JB, alpha=2.0, beta=-1.0))
    np.testing.assert_allclose(C.todense().numpy(), 2.0 * a - b, rtol=1e-5,
                               atol=1e-3)


def test_sparse_add_plan_reuse_and_explicit_zeros():
    rng = np.random.default_rng(26)
    a = gen_random_dense_sparse(rng, 20, 20, density=0.2)
    b = gen_random_dense_sparse(rng, 20, 20, density=0.2)
    A, B = tf.CSR.fromdense(a, device=CPU), tf.CSR.fromdense(b, device=CPU)
    plan = smt.sparse_add_plan(A, B)
    d2 = smt.sparse_add_apply(plan, 2 * A.data, B.data).data
    want = smt.sparse_add(tf.CSR.fromdense(2 * a, device=CPU), B).data
    np.testing.assert_allclose(d2.numpy(), want.numpy(), rtol=1e-5, atol=1e-3)
    # an explicitly stored zero keeps its slot in the union pattern
    sa = sps.csr_matrix(a)
    sa.data[0] = 0.0
    Az = tf.CSR.from_scipy(sa, device=CPU)
    assert_same_fields(smt.sparse_add_plan(Az, B),
                       jops.sparse_add_plan(jf.CSR.from_scipy(sa),
                                            jf.CSR.fromdense(b)))
    with pytest.raises(ValueError):
        smt.sparse_add(tf.CSR.fromdense(np.eye(3, dtype=np.float32),
                                        device=CPU),
                       tf.CSR.fromdense(np.eye(4, dtype=np.float32),
                                        device=CPU))
