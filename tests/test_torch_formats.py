"""The port's containers against the JAX package's, field by field.

The same numpy input goes through both packages' constructors; every
array field of the port's container must be ``np.array_equal`` to the JAX
container's, and every static field equal.  Containers built by the JAX
package also carry across through ``formats.carry.from_numpy_fields``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.ops import spmm_reference as jax_spmm_reference
from sparsematrix_tpu_torch.ops import spmm
from sparsematrix_tpu_torch.utils.testutils import (
    gen_random_dense_sparse, gen_sparse_index_matrix, triangular)

CPU = "cpu"


def _np(x):
    return None if x is None else (x.numpy() if torch.is_tensor(x)
                                   else np.asarray(x))


def assert_same_fields(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.metadata.get("static", False):
            assert a == b, f.name
        elif b is None:
            assert a is None, f.name
        else:
            a, b = _np(a), np.asarray(b)
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            assert np.array_equal(a, b), f.name


def jax_fields(c):
    """``(arrays, statics)`` of a JAX container, taken per field."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return arrays, statics


def index_matrix(seed, rows=40, cols=70, table_size=31):
    """A codebook index matrix with out-of-table entries (negative and
    ``>= table_size``) that both packages must remap to the sentinel."""
    rng = np.random.default_rng(seed)
    idx, table = gen_sparse_index_matrix(rng, rows, cols, density=0.3,
                                         table_size=table_size)
    idx[rng.random(idx.shape) < 0.05] = -3
    idx[rng.random(idx.shape) < 0.05] = table_size + 7
    return idx, table


@pytest.mark.parametrize("trans", [False, True])
def test_codebook_dense_fields(trans):
    idx, table = index_matrix(1)
    port = tf.CodebookDense.from_index_matrix(idx, table, trans=trans,
                                              device=CPU)
    ref = jf.CodebookDense.from_index_matrix(idx, table, trans=trans)
    assert_same_fields(port, ref)
    # the sentinel slot exists and holds 0; remapped entries point at it
    assert port.val_table[port.table_size].item() == 0.0
    assert int(port.idx.max()) == port.table_size
    np.testing.assert_array_equal(port.todense().numpy(),
                                  np.asarray(ref.todense()))
    assert_same_fields(port.T, ref.T)


@pytest.mark.parametrize("trans", [False, True])
def test_codebook_csr_fields(trans):
    idx, table = index_matrix(2)
    port = tf.CodebookCSR.from_index_matrix(idx, table, trans=trans,
                                            device=CPU)
    ref = jf.CodebookCSR.from_index_matrix(idx, table, trans=trans)
    assert_same_fields(port, ref)
    np.testing.assert_array_equal(port.todense().numpy(),
                                  np.asarray(ref.todense()))
    assert_same_fields(port.to_csr(), ref.to_csr())
    assert_same_fields(port.T, ref.T)


def test_codebook_csr_capacity_padding():
    idx, table = index_matrix(3)
    nnz = int(((idx >= 0) & (idx < table.shape[0])).sum())
    port = tf.CodebookCSR.from_index_matrix(idx, table, capacity=nnz + 13,
                                            device=CPU)
    ref = jf.CodebookCSR.from_index_matrix(idx, table, capacity=nnz + 13)
    assert_same_fields(port, ref)
    # padding entries point at the sentinel and contribute nothing
    assert (port.val_idx[nnz:] == port.table_size).all()


def test_codebook_rejects_bad_table():
    for cls in (tf.CodebookDense, tf.CodebookCSR):
        with pytest.raises(ValueError, match="val_table size"):
            cls.from_index_matrix(np.zeros((2, 2), np.int64),
                                  np.zeros(256, np.float32), device=CPU)


@pytest.mark.parametrize("with_row_ids", [True, False])
def test_csr_fields(with_row_ids):
    dense = gen_random_dense_sparse(np.random.default_rng(4), 30, 50, 0.2)
    port = tf.CSR.fromdense(dense, with_row_ids=with_row_ids, device=CPU)
    ref = jf.CSR.fromdense(dense, with_row_ids=with_row_ids)
    assert_same_fields(port, ref)
    # without row_ids, todense and the product find the rows by search
    np.testing.assert_array_equal(port.todense().numpy(), dense)
    X = np.random.default_rng(4).uniform(-1, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        spmm(port, torch.from_numpy(X), method="sparse").numpy(),
        np.asarray(jax_spmm_reference(ref, jnp.asarray(X))),
        rtol=1e-5, atol=1e-5)
    padded = tf.CSR.fromdense(dense, capacity=port.nnz + 5, device=CPU)
    assert_same_fields(padded, jf.CSR.fromdense(dense, capacity=port.nnz + 5))
    np.testing.assert_array_equal(padded.todense().numpy(), dense)


def test_dense_fields():
    dense = gen_random_dense_sparse(np.random.default_rng(5), 12, 9, 0.5)
    assert_same_fields(tf.Dense.fromdense(dense, device=CPU),
                       jf.Dense.fromdense(dense))


def test_dense_bf16_plane():
    """A half-width plane times fp32 X: fp32 accumulation, so only the
    input rounding remains (``_spmm_dense_jnp``)."""
    rng = np.random.default_rng(5)
    dense = gen_random_dense_sparse(rng, 40, 64, 0.5)
    X = rng.uniform(-1, 1, (64, 8)).astype(np.float32)
    port = tf.Dense.fromdense(dense, dtype=torch.bfloat16, device=CPU)
    ref = jf.Dense.fromdense(dense, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(port.data.float().numpy(),
                                  np.asarray(ref.data, np.float32))
    got = spmm(port, torch.from_numpy(X))
    assert got.dtype == torch.float32
    want = np.asarray(jax_spmm_reference(ref, jnp.asarray(X)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,block", [((64, 256), (8, 128)),
                                         ((120, 300), (8, 128)),
                                         ((200, 300), (128, 128))])
def test_blocked_ell_fields(shape, block):
    dense = gen_random_dense_sparse(np.random.default_rng(6), *shape, 0.05)
    dense[8:16] = 0  # an empty block-row
    port = tf.csr_to_blocked_ell(tf.CSR.fromdense(dense, device=CPU),
                                 block_shape=block, device=CPU)
    ref = jf.csr_to_blocked_ell(jf.CSR.fromdense(dense), block_shape=block)
    assert_same_fields(port, ref)
    np.testing.assert_array_equal(port.todense().numpy(), dense)
    assert_same_fields(tf.BlockedELL.fromdense(dense, block, device=CPU),
                       jf.BlockedELL.fromdense(dense, block))


def test_blocked_ell_todense_masks_padding():
    """Padding slots sit at block-column 0: a nonzero there must not leak
    into the densified matrix (``todense`` masks with ``valid``)."""
    dense = np.zeros((16, 256), np.float32)
    dense[0, 0] = 1.0
    dense[8, 200] = 2.0
    dense[8, 5] = 3.0  # block-row 1 holds 2 blocks, block-row 0 one
    bell = tf.BlockedELL.fromdense(dense, (8, 128), device=CPU)
    assert not bool(bell.valid[0, 1])
    blocks = bell.blocks.clone()
    blocks[0, 1] = 7.0  # garbage in a padding slot
    np.testing.assert_array_equal(
        dataclasses.replace(bell, blocks=blocks).todense().numpy(), dense)


def test_blocked_ell_truncate():
    dense = np.ones((8, 512), np.float32)
    with pytest.raises(ValueError, match="max_blocks_per_row"):
        tf.csr_to_blocked_ell(tf.CSR.fromdense(dense, device=CPU),
                              max_blocks_per_row=2, device=CPU)
    cut = tf.csr_to_blocked_ell(tf.CSR.fromdense(dense, device=CPU),
                                max_blocks_per_row=2, truncate=True,
                                device=CPU)
    ref = jf.csr_to_blocked_ell(jf.CSR.fromdense(dense),
                                max_blocks_per_row=2, truncate=True)
    assert_same_fields(cut, ref)


def _carry_cases():
    idx, table = index_matrix(7, rows=64, cols=96)
    dense = gen_random_dense_sparse(np.random.default_rng(8), 64, 96, 0.1)
    return {
        "CodebookDense": (
            jf.CodebookDense.from_index_matrix(idx, table, trans=True),
            lambda: tf.CodebookDense.from_index_matrix(idx, table, trans=True,
                                                       device=CPU)),
        "CodebookCSR": (
            jf.CodebookCSR.from_index_matrix(idx, table, trans=True),
            lambda: tf.CodebookCSR.from_index_matrix(idx, table, trans=True,
                                                     device=CPU)),
        "CSR": (jf.CSR.fromdense(dense),
                lambda: tf.CSR.fromdense(dense, device=CPU)),
        "Dense": (jf.Dense.fromdense(dense),
                  lambda: tf.Dense.fromdense(dense, device=CPU)),
        "BlockedELL": (
            jf.csr_to_blocked_ell(jf.CSR.fromdense(dense), (8, 32)),
            lambda: tf.csr_to_blocked_ell(tf.CSR.fromdense(dense, device=CPU),
                                          (8, 32), device=CPU)),
    }


@pytest.mark.parametrize("kind", ["CodebookDense", "CodebookCSR", "CSR",
                                  "Dense", "BlockedELL"])
def test_carry_round_trip(kind):
    ref, build_port = _carry_cases()[kind]
    arrays, statics = jax_fields(ref)
    carried = tf.from_numpy_fields(kind, arrays, statics, device=CPU)
    own = build_port()
    # the carried weights are the port's own encoding of the same input
    assert_same_fields(carried, ref)
    assert_same_fields(own, ref)
    # and both packages compute the same product with them
    X = np.random.default_rng(9).uniform(-1, 1, (ref.shape[1], 5)).astype(
        np.float32)
    want = np.asarray(jax_spmm_reference(ref, jnp.asarray(X)))
    got = spmm(carried, torch.from_numpy(X), method="sparse").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_carry_rejects_mismatched_fields():
    ref, _ = _carry_cases()["CSR"]
    arrays, statics = jax_fields(ref)
    with pytest.raises(ValueError, match="unknown container kind"):
        tf.from_numpy_fields("NoSuchFormat", arrays, statics, device=CPU)
    with pytest.raises(ValueError, match="array fields"):
        tf.from_numpy_fields("CSR", {**arrays, "extra": arrays["data"]},
                             statics, device=CPU)
    with pytest.raises(ValueError, match="static fields"):
        tf.from_numpy_fields("CSR", arrays, {"shape": statics["shape"]},
                             device=CPU)


def _tri_plan_cases():
    """(JAX plan builder, port apply, JAX apply, plan arguments) of every
    triangular-solve plan type."""
    import importlib

    jts = importlib.import_module("sparsematrix_tpu.ops.trisolve")
    tts = importlib.import_module("sparsematrix_tpu_torch.ops.trisolve")
    jw = importlib.import_module("sparsematrix_tpu.kernels.trisolve_waves")
    tw = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.trisolve_waves")
    jfu = importlib.import_module("sparsematrix_tpu.kernels.trisolve_fused")
    tfu = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.trisolve_fused")
    return {
        "TriSolvePlan": (jts.trisolve_plan, tts.trisolve_apply,
                         jts.trisolve_apply, {}),
        "TriFixPlan": (jts.trisolve_fixpoint_plan,
                       tts.trisolve_fixpoint_apply,
                       jts.trisolve_fixpoint_apply, dict(group=4)),
        "TriLevelPlan": (jts.trisolve_level_plan, tts.trisolve_level_apply,
                         jts.trisolve_level_apply, {}),
        "TriFusedPlan": (jfu.trisolve_fused_plan, tfu.trisolve_fused_apply,
                         jfu.trisolve_fused_apply,
                         dict(with_transpose=True)),
        "TriWavesPlan": (jw.trisolve_waves_plan, tw.trisolve_waves_apply,
                         jw.trisolve_waves_apply,
                         dict(mode="binv", m=2, with_grads=True)),
    }


@pytest.mark.parametrize("kind", ["TriSolvePlan", "TriFixPlan",
                                  "TriLevelPlan", "TriFusedPlan",
                                  "TriWavesPlan"])
def test_carry_triangular_plans(kind):
    """A JAX plan carried field by field (nested ``t_plan`` and
    ``e_packed``, ``None`` optionals, the ``mode`` string) gives the JAX
    result (rtol 2e-3, atol 1e-3, the JAX trisolve tests')."""
    from test_torch_trisolve import carry
    from test_torch_spmv import assert_same_container

    build, apply_, japply, kw = _tri_plan_cases()[kind]
    sp = triangular(300, 4, lower=False)
    jplan = build(jf.CSR.from_scipy(sp), lower=False, **kw)
    plan = carry(jplan)
    assert_same_container(plan, jplan)
    b = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(
        apply_(plan, torch.from_numpy(b)).numpy(),
        np.asarray(japply(jplan, jnp.asarray(b))), rtol=2e-3, atol=1e-3)
