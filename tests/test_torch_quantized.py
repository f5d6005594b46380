"""The quantized containers and products of the port against the JAX
package: ``QuantDense`` (``formats/quantdense.py``) and its ``spmv`` /
``spmm`` entries, ``quantize_codebook``, ``add_mat_mat_int8`` and
``add_mat_mat_int16`` (``ops/quantized.py``).

Quantized planes must be bit-equal (both sides round half to even).
Products are held to the JAX functions at 1e-5 of the output scale: the
integer contractions are exact on both sides, so only the fp32 rescale
differs; on fixtures built by the JAX package and carried across by
``formats/carry.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import sparsematrix_tpu as jsm
import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.ops.quantized import (add_mat_mat_int8 as j_int8,
                                            add_mat_mat_int16 as j_int16,
                                            quantize_codebook as j_qcb)
from sparsematrix_tpu_torch.ops.quantized import int8_matmul
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_random_dense_sparse,
                                                    gen_sparse_index_matrix)

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """Many small torch and BLAS calls: one thread each, so the suite's
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def carry(ref):
    """A JAX container carried into the port through ``from_numpy_fields``."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return tf.from_numpy_fields(type(ref).__name__, arrays, statics,
                                device=CPU)


def close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * scale


def quant_dense_case(seed, rows=37, cols=53, density=0.3):
    rng = np.random.default_rng(seed)
    dense = gen_random_dense_sparse(rng, rows, cols, density=density)
    dense[3] = 0.0  # an all-zero row takes scale 1
    return dense


def codebook_case(seed, m=8, n=64, k=96, table_size=255):
    rng = np.random.default_rng(seed)
    a = gen_matrix_random(rng, m, k)
    c = gen_matrix_random(rng, m, n)
    idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                         table_size=table_size)
    return a, c, idx, table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantdense_planes_match_jax(seed):
    dense = quant_dense_case(seed)
    Q = smt.QuantDense.fromdense(dense, device=CPU)
    J = jf.QuantDense.fromdense(dense)
    assert Q.shape == J.shape and Q.nnz == J.nnz
    np.testing.assert_array_equal(Q.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(Q.scale.numpy(), np.asarray(J.scale))
    np.testing.assert_array_equal(Q.todense().numpy(), np.asarray(J.todense()))
    assert Q.data.dtype == torch.int8 and Q.scale.dtype == torch.float32
    assert Q.density == pytest.approx(J.density)


def test_quantdense_from_sparse_and_carry():
    dense = quant_dense_case(3)
    A = smt.CSR.fromdense(dense, device=CPU)
    Q = smt.QuantDense.from_sparse(A)
    want = smt.QuantDense.fromdense(dense, device=CPU)
    assert torch.equal(Q.data, want.data) and torch.equal(Q.scale, want.scale)
    C = carry(jf.QuantDense.fromdense(dense))
    assert isinstance(C, smt.QuantDense)
    assert torch.equal(C.data, want.data) and torch.equal(C.scale, want.scale)
    assert (C.shape, C.nnz) == (want.shape, want.nnz)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_quantdense_spmm_matches_jax(k):
    dense = quant_dense_case(4)
    J = jf.QuantDense.fromdense(dense)
    Q = carry(J)
    X = gen_matrix_random(np.random.default_rng(5), dense.shape[1], k)
    X[:, 0] = 0.0  # a zero column takes scale 1
    got = smt.spmm(Q, torch.from_numpy(X))
    want = jsm.spmm(J, jnp.asarray(X))
    assert got.dtype == torch.float32
    close(got.numpy(), np.asarray(want))
    close(smt.spmm_reference(Q, torch.from_numpy(X)).numpy(), np.asarray(want))


def test_quantdense_spmv_matches_jax():
    dense = quant_dense_case(6)
    J = jf.QuantDense.fromdense(dense)
    Q = carry(J)
    x = gen_matrix_random(np.random.default_rng(7), dense.shape[1], 1)[:, 0]
    got = smt.spmv(Q, torch.from_numpy(x))
    close(got.numpy(), np.asarray(jsm.spmv(J, jnp.asarray(x))))
    # within the int8 grid of the exact product
    want = dense.astype(np.float64) @ x
    scale = np.abs(want).max()
    assert np.median(np.abs(got.numpy() - want)) < 0.04 * scale


@pytest.mark.parametrize("table_size", [1, 17, 255])
def test_quantize_codebook_planes_match_jax(table_size):
    _, _, idx, table = codebook_case(8, table_size=table_size)
    if table_size == 17:
        # amax 127 makes the scale 1, so these values sit on exact half
        # steps of the int8 grid: both sides round half to even
        table = np.array([127, .5, 1.5, 2.5, -.5, -1.5, -2.5, 3.5, 4.5,
                          -3.5, 10, 11.5, 12.5, -13.5, 0, 1, -127],
                         np.float32)
    tb = smt.CodebookDense.from_index_matrix(idx, table, trans=True,
                                             device=CPU)
    jb = jf.CodebookDense.from_index_matrix(idx, table, trans=True)
    tq, jq = smt.quantize_codebook(tb), j_qcb(jb)
    np.testing.assert_array_equal(tq.q_table.numpy(), np.asarray(jq.q_table))
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    assert tq.scale.dtype == torch.float32 and tq.scale.dim() == 0
    assert float(tq.scale) == float(jq.scale)
    assert (tq.shape, tq.table_size) == (jq.shape, jq.table_size)
    assert int(tq.q_table[-1]) == 0
    np.testing.assert_array_equal(tq.q_dense.numpy(), np.asarray(jq.q_dense))


@pytest.mark.parametrize("which", ["int8", "int16"])
@pytest.mark.parametrize("alpha,beta,with_c", [(1.0, 0.0, False),
                                               (1.0, 1.0, True),
                                               (-0.5, 2.0, True)])
def test_add_mat_mat_quantized_matches_jax(which, alpha, beta, with_c):
    a, c, idx, table = codebook_case(9)
    jq = j_qcb(jf.CodebookDense.from_index_matrix(idx, table, trans=True))
    tq = carry(jq)
    assert isinstance(tq, smt.QuantizedCodebookDense)
    tfn, jfn = ((smt.add_mat_mat_int8, j_int8) if which == "int8"
                else (smt.add_mat_mat_int16, j_int16))
    got = tfn(torch.from_numpy(a), tq,
              torch.from_numpy(c) if with_c else None, alpha, beta)
    want = jfn(jnp.asarray(a), jq, jnp.asarray(c) if with_c else None,
               alpha, beta)
    close(got.numpy(), np.asarray(want))
    # and the quantized product is near the exact one
    dense_b = table_dense(idx, table)
    exact = (beta * c if with_c else 0.0) + alpha * a.astype(np.float64) @ dense_b
    scale = np.abs(exact).max()
    assert np.median(np.abs(got.numpy() - exact)) < 0.04 * scale


def table_dense(idx, table):
    ts = table.shape[0]
    valid = (idx >= 0) & (idx < ts)
    return np.where(valid, table[np.clip(idx, 0, ts - 1)], 0.0).astype(
        np.float64)


def test_add_mat_mat_int16_is_finer_than_int8():
    a, c, idx, table = codebook_case(10, m=24)
    tq = smt.quantize_codebook(smt.CodebookDense.from_index_matrix(
        idx, table, trans=True, device=CPU))
    # the int8 table's own error, with the activations exact
    deq = tq.q_table.double().numpy() * float(tq.scale)
    ts = table.shape[0]
    b_q = np.where((idx >= 0) & (idx < ts), deq[np.clip(idx, 0, ts - 1)],
                   0.0)
    exact_q = a.astype(np.float64) @ b_q
    e16 = np.abs(smt.add_mat_mat_int16(torch.from_numpy(a), tq).numpy()
                 - exact_q).max()
    e8 = np.abs(smt.add_mat_mat_int8(torch.from_numpy(a), tq).numpy()
                - exact_q).max()
    assert e16 < e8 / 16


def test_quantized_beta_needs_c():
    _, _, idx, table = codebook_case(11)
    tq = smt.quantize_codebook(smt.CodebookDense.from_index_matrix(
        idx, table, trans=True, device=CPU))
    a = torch.zeros((2, tq.shape[1]))
    for fn in (smt.add_mat_mat_int8, smt.add_mat_mat_int16):
        with pytest.raises(ValueError):
            fn(a, tq, None, 1.0, 1.0)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 2047, 33), (16, 96, 64),
                                   (17, 8, 8), (117, 2047, 1023)])
def test_int8_matmul_pads_exactly(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_int8_matmul_refuses_other_types():
    with pytest.raises(ValueError):
        int8_matmul(torch.zeros((4, 4), dtype=torch.int16),
                    torch.zeros((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_matmul(torch.zeros((4, 5), dtype=torch.int8),
                    torch.zeros((4, 4), dtype=torch.int8))
