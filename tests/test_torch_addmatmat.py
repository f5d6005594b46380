"""The slice as a whole: ``add_mat_mat`` through each ported format of
``B^T``, against the JAX package's ``add_mat_mat`` on the CPU and against
the fp64 oracle, plus the entry point and the routing rules around it."""
import gc
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.ops import add_mat_mat as jax_add_mat_mat
from sparsematrix_tpu_torch.entry import entry
from sparsematrix_tpu_torch.ops import add_mat_mat, spmm
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_random_dense_sparse,
                                                    gen_sparse_index_matrix,
                                                    relative_check)

# the module, not the function that ops/__init__ exports under its name
spmm_mod = importlib.import_module("sparsematrix_tpu_torch.ops.spmm")

M, N, K = 32, 256, 512


def _workload(seed=0):
    rng = np.random.default_rng(seed)
    a = gen_matrix_random(rng, M, K)
    c = gen_matrix_random(rng, M, N)
    idx, table = gen_sparse_index_matrix(rng, K, N, density=0.25,
                                         table_size=255)
    return a, c, idx, table


def _b_t(fmt, idx, table):
    """``(port, jax)`` containers of B^T (N x K) in format ``fmt``."""
    if fmt == "BlockedELL":
        cbd = tf.CodebookDense.from_index_matrix(idx, table, trans=True,
                                                 device="cpu")
        bt = cbd.todense().numpy()
        return (tf.csr_to_blocked_ell(tf.CSR.fromdense(bt, device="cpu"),
                                      (8, 128), device="cpu"),
                jf.csr_to_blocked_ell(jf.CSR.fromdense(bt), (8, 128)))
    return (getattr(tf, fmt).from_index_matrix(idx, table, trans=True,
                                               device="cpu"),
            getattr(jf, fmt).from_index_matrix(idx, table, trans=True))


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.5, -2.0)])
@pytest.mark.parametrize("fmt", ["CodebookCSR", "CodebookDense", "BlockedELL"])
def test_add_mat_mat_matches_jax(fmt, alpha, beta):
    a, c, idx, table = _workload()
    port_b, jax_b = _b_t(fmt, idx, table)
    got = add_mat_mat(torch.from_numpy(a), port_b, torch.from_numpy(c),
                      alpha, beta)
    assert got.shape == (M, N) and got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(jax_add_mat_mat(jnp.asarray(a), jax_b, jnp.asarray(c),
                                      alpha, beta))
    bt = port_b.todense().double().numpy()
    oracle = beta * c.astype(np.float64) + alpha * (a.astype(np.float64)
                                                    @ bt.T)
    assert relative_check(got, oracle)
    assert relative_check(want, oracle)
    # fp32 sums of K = 512 terms in another order: ~sqrt(K)·eps of the
    # output scale apart
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(oracle).max())


def test_add_mat_mat_beta_requires_c():
    a, _, idx, table = _workload()
    b_t, _ = _b_t("CodebookDense", idx, table)
    at = torch.from_numpy(a)
    with pytest.raises(ValueError, match="beta != 0 requires c"):
        add_mat_mat(at, b_t, None, 1.0, 1.0)
    with pytest.raises(ValueError, match="beta != 0 requires c"):
        add_mat_mat(at, b_t, None, 1.0, "not a number")
    out = add_mat_mat(at, b_t, None, 2.0, 0.0)
    torch.testing.assert_close(out, 2.0 * add_mat_mat(at, b_t))


def test_entry_runs_on_cpu_and_matches_jax():
    fn, args = entry(device="cpu")
    got = fn(*args)
    assert got.shape == (32, 256) and got.device.type == "cpu"
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jfn(*jargs))
    for t, j in zip((args[0], args[2]), (jargs[0], jargs[2])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert relative_check(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_entry_without_card_raises(monkeypatch):
    """Without a card the code never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    _, _, idx, table = _workload()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.CodebookDense.from_index_matrix(idx, table)


def test_codebook_csr_converts_once_per_container(monkeypatch):
    calls = []
    orig = tf.CodebookDense.from_index_matrix.__func__

    def counting(cls, *args, **kw):
        calls.append(1)
        return orig(cls, *args, **kw)

    monkeypatch.setattr(tf.CodebookDense, "from_index_matrix",
                        classmethod(counting))
    a, c, idx, table = _workload()
    b_t, _ = _b_t("CodebookCSR", idx, table)
    at, ct = torch.from_numpy(a), torch.from_numpy(c)
    first = add_mat_mat(at, b_t, ct, 1.0, 1.0)
    second = add_mat_mat(at, b_t, ct, 1.0, 1.0)
    assert len(calls) == 1
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    key = id(b_t)
    assert spmm_mod._CBD_CACHE[key][0]() is b_t
    # the cached CodebookDense is the container's own encoding
    own = tf.CodebookDense.from_index_matrix(idx, table, trans=True,
                                             device="cpu")
    assert torch.equal(spmm_mod._CBD_CACHE[key][1].idx, own.idx)
    # the entry leaves with its container
    del b_t
    gc.collect()
    assert key not in spmm_mod._CBD_CACHE


def test_spmm_routes_and_refusals():
    rng = np.random.default_rng(5)
    dense = gen_random_dense_sparse(rng, 64, 80, density=0.01)
    A = tf.CSR.fromdense(dense, device="cpu")
    X = torch.from_numpy(rng.uniform(-1, 1, (80, 3)).astype(np.float32))
    # low-density CSR auto-routes to layouts that are not ported yet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmm(A, X)
    np.testing.assert_allclose(spmm(A, X, method="sparse").numpy(),
                               dense @ X.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(spmm(A, X, method="densify").numpy(),
                               dense @ X.numpy(), rtol=1e-5, atol=1e-5)
    # a dense enough CSR densifies, as in the JAX package
    dense = gen_random_dense_sparse(rng, 64, 80, density=0.3)
    np.testing.assert_allclose(
        spmm(tf.CSR.fromdense(dense, device="cpu"), X).numpy(),
        dense @ X.numpy(), rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="unknown method"):
        spmm(A, X, method="pallas")
    with pytest.raises(ValueError, match="incompatible"):
        spmm(A, X.T)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        spmm(object.__new__(type("ELL", (), {"shape": (64, 80)})), X)
