"""The rowlane and superblock SpMV of the port
(``kernels/spmv_rowlane.py``, ``kernels/spmv_superblock.py``) against the
JAX package.

Packs must be plane-equal to the JAX packer's, with the native packer and
with the numpy one; products and gradients (in x and in the values) must
agree with an fp64 oracle at the JAX tests' tolerance, rtol 2e-3 and
atol 0.5 (values in ±1000), and, in the cases marked ``jax``, with the
JAX kernels and VJPs (Pallas in interpret mode, whose compile takes
seconds a case).  Small matrices keep the file cheap.
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
from test_torch_spmv import assert_same_container

jrl = importlib.import_module("sparsematrix_tpu.kernels.spmv_rowlane")
trl = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_rowlane")
jsb = importlib.import_module("sparsematrix_tpu.kernels.spmv_superblock")
tsb = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_superblock")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def matrix(name):
    g = np.random.default_rng(len(name))
    if name == "ragged":  # ragged last tile and window
        sp = sps.random(1100, 900, density=0.02, random_state=1,
                        format="csr", dtype=np.float32)
    elif name == "wide":  # several windows, 8 tiles
        sp = sps.random(1000, 3000, density=0.01, random_state=2,
                        format="csr", dtype=np.float32)
    elif name == "deep":  # a few dense rows: deep buckets, a spill tail
        d = (g.random((600, 700)) < 0.01).astype(np.float32)
        d[[3, 200, 599], :] = 1.0
        sp = sps.csr_matrix(d)
    elif name == "empty-rows":
        d = np.zeros((260, 260), np.float32)
        d[0, 5], d[259, 0], d[130, 259] = 2.0, -3.0, 1.0
        sp = sps.csr_matrix(d)
    else:
        raise KeyError(name)
    sp.data = g.uniform(-1000, 1000, sp.nnz).astype(np.float32)
    return sp


def both(name):
    sp = matrix(name)
    return smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp), sp


def _jax_kw(kw):
    return {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
            for k, v in kw.items()}


def _oracle(sp, kw):
    sp64 = sp.astype(np.float64)
    if kw.get("dtype") is torch.bfloat16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    return sp64


def _check_products_and_grads(packed, jpacked, sp, kw, spmv_t, spmv_j,
                              slot_row_col, jax_cmp):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(sp.shape[1]).astype(np.float32)
    w = rng.uniform(-1, 1, sp.shape[0]).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    packed.vals.requires_grad_()
    y = spmv_t(packed, xt)
    assert y.dtype == torch.float32 and y.shape == (sp.shape[0],)
    (y * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), _oracle(sp, kw) @ x, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _oracle(sp, kw).T @ w, **TOL)
    # the value cotangent: x at the slot's column times w at its row, 0
    # on padding slots
    row, col = slot_row_col(packed)
    xpad = np.concatenate([x, np.zeros(col.max().item() + 1, np.float32)])
    wpad = np.concatenate([w, np.zeros(row.max().item() + 1, np.float32)])
    want_dv = np.where(packed.vals.detach().float().numpy() != 0,
                       xpad[col.numpy()] * wpad[row.numpy()], 0)
    np.testing.assert_allclose(packed.vals.grad.float().numpy(), want_dv,
                               **TOL)
    assert packed.vals.grad.dtype == packed.vals.dtype
    if not jax_cmp:
        return

    def fwd(vals, xx):
        return spmv_j(dataclasses.replace(jpacked, vals=vals), xx)

    # one trace gives the JAX product and its VJP
    jy, jvjp = jax.vjp(fwd, jpacked.vals, jnp.asarray(x))
    jdv, jgx = jvjp(jnp.asarray(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    # the JAX x cotangent of a bf16 pack is rounded to bf16 (its scatter
    # runs in the values' type); the port's stays fp32, so against JAX it
    # may differ by one bf16 step
    jtol = (dict(rtol=2.0 ** -7, atol=0.5)
            if kw.get("dtype") is torch.bfloat16 else TOL)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(jgx.astype(jnp.float32)), **jtol)
    np.testing.assert_allclose(packed.vals.grad.float().numpy(),
                               np.asarray(jdv.astype(jnp.float32)), **TOL)


# (matrix, pack arguments, compare with the JAX kernel and VJP)
RL_CASES = {
    "ragged-L1": ("ragged", {}, False),
    "wide-L2-group4": ("wide", dict(lanes_per_row=2, group=4), False),
    "ragged-L4": ("ragged", dict(lanes_per_row=4), True),
    "wide-L8": ("wide", dict(lanes_per_row=8), False),
    "deep-spill": ("deep", dict(spill_depth=1), False),
    "deep-L2-spill": ("deep", dict(lanes_per_row=2, spill_depth=2), True),
    "ragged-bf16": ("ragged", dict(dtype=torch.bfloat16), True),
    "empty-rows": ("empty-rows", dict(group=4), False),
    "wide-transpose": ("wide", dict(with_transpose=True), True),
}


@pytest.mark.parametrize("case", sorted(RL_CASES))
def test_rowlane_matches_jax(case):
    name, kw, jax_cmp = RL_CASES[case]
    A, JA, sp = both(name)
    packed = trl.pack_sell_rowlane(A, **kw)
    jpacked = jrl.pack_sell_rowlane(JA, **_jax_kw(kw))
    assert_same_container(packed, jpacked)
    if "spill_depth" in kw:
        assert packed.spill_packed is not None
    _check_products_and_grads(packed, jpacked, sp, kw,
                              trl.spmv_sell_rowlane, jrl.spmv_sell_rowlane,
                              trl._slot_row_col, jax_cmp)


@pytest.mark.parametrize("case", ["ragged-L4", "deep-L2-spill",
                                  "ragged-bf16"])
def test_rowlane_numpy_packer_matches_jax(monkeypatch, case):
    """Without the native packer both sides take the numpy one."""
    for mod in (jrl, trl):
        monkeypatch.setattr(mod, "_pack_arrays_native", lambda *a, **k: None)
        monkeypatch.setattr(mod, "_spill_mask_native", lambda *a, **k: None)
    name, kw, _ = RL_CASES[case]
    A, JA, _ = both(name)
    assert_same_container(trl.pack_sell_rowlane(A, **kw),
                          jrl.pack_sell_rowlane(JA, **_jax_kw(kw)))


SB_CASES = {
    "ragged-g8-k8": ("ragged", dict(group=8, k_tiles=8), True),
    "wide-g4-k4": ("wide", dict(group=4, k_tiles=4), False),
    "wide-g2-k32": ("wide", dict(group=2, k_tiles=32), False),
    "empty-rows": ("empty-rows", dict(group=4, k_tiles=4), False),
    "ragged-bf16": ("ragged", dict(group=8, k_tiles=8,
                                   dtype=torch.bfloat16), True),
}


@pytest.mark.parametrize("case", sorted(SB_CASES))
def test_superblock_matches_jax(case):
    name, kw, jax_cmp = SB_CASES[case]
    A, JA, sp = both(name)
    packed = tsb.pack_superblock(A, **kw)
    jpacked = jsb.pack_superblock(JA, **_jax_kw(kw))
    assert_same_container(packed, jpacked)
    _check_products_and_grads(packed, jpacked, sp, kw, tsb.spmv_superblock,
                              jsb.spmv_superblock, tsb._slot_row_col,
                              jax_cmp)


@pytest.mark.parametrize("case", ["ragged-g8-k8", "empty-rows"])
def test_superblock_numpy_packer_matches_jax(monkeypatch, case):
    for mod in (jrl, trl, tsb):
        monkeypatch.setattr(mod, "_pack_arrays_native", lambda *a, **k: None)
    name, kw, _ = SB_CASES[case]
    A, JA, _ = both(name)
    assert_same_container(tsb.pack_superblock(A, **kw),
                          jsb.pack_superblock(JA, **_jax_kw(kw)))


def test_prepare_spmv_rowlane_and_superblock_layouts():
    A, JA, sp = both("wide")
    from sparsematrix_tpu.ops.spmv import prepare_spmv as jax_prepare

    for layout in ("rowlane", "superblock"):
        P = smt.prepare_spmv(A, layout=layout)
        assert_same_container(P, jax_prepare(JA, layout=layout))
        x = np.random.default_rng(3).standard_normal(sp.shape[1]).astype(
            np.float32)
        np.testing.assert_allclose(smt.spmv(P, torch.from_numpy(x)).numpy(),
                                   sp.astype(np.float64) @ x, **TOL)
        with pytest.raises(TypeError, match="unsupported"):
            smt.spmm(P, torch.ones((sp.shape[1], 2)))


def test_rowlane_legacy_spill_raises():
    """A spill tail that is neither a rowlane nor a legacy SELL pack
    raises (the SELL one runs: ``test_torch_sell.py``)."""
    A, _, _ = both("ragged")
    P = trl.pack_sell_rowlane(A)
    legacy = dataclasses.replace(P, spill_packed=object())
    with pytest.raises(TypeError, match="spill tail"):
        trl.spmv_sell_rowlane(legacy, torch.zeros(A.shape[1]))
