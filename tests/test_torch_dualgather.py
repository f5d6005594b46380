"""Dual-gather SpMV (``kernels/spmv_dualgather.py``) against the JAX
package.

The packer must give planes ``np.array_equal`` to the JAX packer's, field
by field, with the native slot assigner on both sides and with the numpy
repair on both sides.  Products and gradients are held against the JAX
``spmv_dualgather``, whose Pallas kernel runs in interpret mode on the CPU
as the JAX package's own tests run it (``tests/test_dualgather.py``), and
against an fp64 oracle, at the JAX tests' tolerance (rtol 2e-3, atol 0.5;
bf16 values by ``quantized_check``).  On the CPU the port's wrapper runs
its plain version; the kernel is held against that on the card by
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
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu_torch.utils.testutils import (gen_random_dense_sparse,
                                                    quantized_check)
from test_torch_spmv import jit_vjp

jdg = importlib.import_module("sparsematrix_tpu.kernels.spmv_dualgather")
tdg = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_dualgather")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


def _np(a):
    """numpy view of a port tensor or JAX array; bf16 as its int16 bits."""
    a = a.numpy() if torch.is_tensor(a) and a.dtype != torch.bfloat16 else (
        a.view(torch.int16).numpy() if torch.is_tensor(a) else np.asarray(a))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_planes_equal(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.metadata.get("static", False):
            assert a == b and type(a) is type(b), (f.name, a, b)
        elif b is None:
            assert a is None, f.name
        elif f.name == "t_pack":
            assert_planes_equal(a, b)
        else:
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            assert np.array_equal(a, b), f.name


def carry(ref):
    """The JAX pack carried into the port through ``from_numpy_fields``."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        elif f.name == "t_pack" and v is not None:
            arrays[f.name] = carry(v)
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return tf.from_numpy_fields(type(ref).__name__, arrays, statics,
                                device=CPU)


def packs(dense, **kw):
    """(port pack, JAX pack) of ``dense`` with the same pack arguments;
    ``bf16=True`` stores the values in bf16."""
    bf16 = kw.pop("bf16", False)
    port = tdg.pack_dualgather(tf.CSR.fromdense(dense, device=CPU),
                               dtype=torch.bfloat16 if bf16 else None, **kw)
    ref = jdg.pack_dualgather(jf.CSR.fromdense(dense),
                              dtype=jnp.bfloat16 if bf16 else None, **kw)
    return port, ref


# the shapes of tests/test_dualgather.py: :22-28 (k_tiles=1), :281-282
# (two-window superblocks, even and odd group), :347 (superblocks)
PLANE_CASES = [
    ((64, 256), 0.2, dict(group=4)),
    ((300, 1500), 0.05, dict(group=4)),
    ((129, 1024), 0.1, dict(group=4)),
    ((1000, 3000), 0.02, dict(group=4)),
    ((512, 4096), 0.12, dict(group=4)),
    ((700, 3000), 0.04, dict(k_tiles=4)),
    ((512, 4096), 0.08, dict(group=4, k_tiles=2, two_win=True)),
    ((300, 3000), 0.05, dict(group=3, k_tiles=2, two_win=True)),
    ((1024, 8192), 0.02, dict(group=8, k_tiles=4, two_win=True)),
    ((1100, 1100), 0.02, dict(k_tiles=4, group=8)),
    ((1100, 1100), 0.02, dict(k_tiles=4, group=8, two_win=True)),
    ((1100, 1100), 0.02, dict(k_tiles=8, group=16)),
    ((256, 2048), 0.05, dict(group=4, bf16=True)),
    ((256, 2048), 0.05, dict(group=4, k_tiles=2, bf16=True)),
    ((256, 1024), 0.08, dict(group=2, with_transpose=True)),
]


def _case_id(case):
    (r, c), d, kw = case
    return f"{r}x{c}-" + "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("case", PLANE_CASES, ids=_case_id)
def test_pack_planes_equal_native(case):
    shape, density, kw = case
    dense = gen_random_dense_sparse(np.random.default_rng(3), *shape,
                                    density=density)
    port, ref = packs(dense, **kw)
    assert_planes_equal(port, ref)
    assert port.fill_rate == ref.fill_rate


@pytest.mark.parametrize("case", [PLANE_CASES[1], PLANE_CASES[7],
                                  PLANE_CASES[13]], ids=_case_id)
def test_pack_planes_equal_numpy_repair(monkeypatch, case):
    """With no compiler both packers take the numpy conflict repair."""
    monkeypatch.setattr(jdg, "_assign_slots_native", lambda *a, **k: None)
    monkeypatch.setattr(tdg, "_assign_slots_native", lambda *a, **k: None)
    shape, density, kw = case
    dense = gen_random_dense_sparse(np.random.default_rng(4), *shape,
                                    density=density)
    port, ref = packs(dense, **kw)
    assert_planes_equal(port, ref)


def test_pack_empty_and_bad_arguments():
    port, ref = packs(np.zeros((64, 256), np.float32))
    assert_planes_equal(port, ref)
    x = torch.ones(256)
    assert float(tdg.spmv_dualgather(port, x).abs().max()) == 0.0
    A = tf.CSR.fromdense(np.eye(128, dtype=np.float32), device=CPU)
    with pytest.raises(ValueError):
        tdg.pack_dualgather(A, two_win=True)  # k_tiles=1
    with pytest.raises(ValueError):
        tdg.pack_dualgather(A, k_tiles=2, two_win=True, spill_cap=8)
    # a spill cap above every row-window degree packs no tail
    port, ref = packs(np.eye(128, dtype=np.float32), spill_cap=8)
    assert port.tail is None
    assert_planes_equal(port, ref)


PRODUCT_CASES = [
    ((300, 1500), 0.05, dict(group=4)),                           # row 10
    ((700, 3000), 0.04, dict(group=4, k_tiles=4)),                # row 11
    ((512, 4096), 0.08, dict(group=4, k_tiles=2, two_win=True)),  # nibble
    ((300, 3000), 0.05, dict(group=3, k_tiles=2, two_win=True)),  # byte
    ((256, 2048), 0.05, dict(group=4, k_tiles=2, bf16=True)),
]


@pytest.mark.parametrize("case", PRODUCT_CASES, ids=_case_id)
def test_spmv_matches_jax(case):
    shape, density, kw = case
    rng = np.random.default_rng(5)
    dense = gen_random_dense_sparse(rng, *shape, density=density)
    x = rng.standard_normal(shape[1]).astype(np.float32)
    port, ref = packs(dense, **kw)
    want = np.asarray(jax.jit(jdg.spmv_dualgather)(ref, jnp.asarray(x)))
    oracle = dense.astype(np.float64) @ x
    for pk in (port, carry(ref)):
        got = tdg.spmv_dualgather(pk, torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        got = got.numpy()
        np.testing.assert_allclose(got, want, **TOL)
        if kw.get("bf16"):
            assert quantized_check(got, oracle)
        else:
            np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("case", [
    ((256, 1024), 0.08, dict(group=2, with_transpose=True)),
    ((256, 2048), 0.1, dict(group=4, k_tiles=2, two_win=True)),
], ids=_case_id)
def test_spmv_grads_match_jax(case):
    """d/dx and d/dvals against ``jax.vjp`` of the same function, with the
    transposed pack (grad x from the forward walk over A^T) and without
    it (the plain scatter over the nibble two-window planes)."""
    shape, density, kw = case
    rng = np.random.default_rng(6)
    dense = gen_random_dense_sparse(rng, *shape, density=density)
    x = rng.standard_normal(shape[1]).astype(np.float32)
    g = rng.standard_normal(shape[0]).astype(np.float32)
    port, ref = packs(dense, **kw)
    assert (port.t_pack is not None) == kw.get("with_transpose", False)

    def jax_fn(v, xx):
        return jdg.spmv_dualgather(dataclasses.replace(ref, vals=v), xx)

    _, cot = jit_vjp(jax_fn, (ref.vals, jnp.asarray(x)), jnp.asarray(g))
    want_dv, want_gx = (np.asarray(a) for a in cot)

    v = port.vals.clone().requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    y = tdg.spmv_dualgather(dataclasses.replace(port, vals=v), xx)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xx.grad.numpy(), want_gx, **TOL)
    np.testing.assert_allclose(xx.grad.numpy(),
                               dense.T.astype(np.float64) @ g, **TOL)
    assert v.grad.dtype == port.vals.dtype
    np.testing.assert_allclose(v.grad.numpy(), want_dv, rtol=2e-3, atol=1e-4)
    assert (v.grad.numpy()[port.vals.numpy() == 0] == 0).all()
