"""The fused codebook product (``kernels/codebook.py``) against the JAX
package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX
``codebook_matmul`` runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it.  The kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrix_tpu.formats import CodebookDense as JaxCodebookDense
from sparsematrix_tpu.kernels.codebook_pallas import \
    codebook_matmul as jax_codebook_matmul
from sparsematrix_tpu_torch.formats import CodebookDense
from sparsematrix_tpu_torch.kernels import (codebook_matmul, codebook_spmm,
                                            codebook_spmm_reference)
from sparsematrix_tpu_torch.ops import spmm, spmm_reference
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_sparse_index_matrix,
                                                    quantized_check,
                                                    relative_check)


def _inputs(seed, m, n, k, table_size=255):
    rng = np.random.default_rng(seed)
    a = gen_matrix_random(rng, m, k)
    idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                         table_size=table_size)
    port = CodebookDense.from_index_matrix(idx, table, trans=True,
                                           device="cpu")
    ref = JaxCodebookDense.from_index_matrix(idx, table, trans=True)
    return a, port, ref


@pytest.mark.parametrize("mnk", [(29, 200, 300), (8, 128, 256)])
def test_codebook_matmul_matches_jax(mnk):
    m, n, k = mnk
    a, port, ref = _inputs(0, m, n, k)
    got = codebook_matmul(torch.from_numpy(a), port).numpy()
    want = np.asarray(jax_codebook_matmul(jnp.asarray(a), ref))
    # values span ±1000 and sums reach ~1e7; the summation order differs
    # (the JAX suite's own policy, tests/test_pallas_kernels.py)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.5)
    oracle = a.astype(np.float64) @ port.todense().double().numpy().T
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=0.5)
    assert relative_check(got, oracle)


def test_codebook_spmm_dispatch_and_layouts():
    """On a CPU tensor the wrapper is its plain version, whatever the
    layout of X (row-major, or the k-major view a.T)."""
    a, port, _ = _inputs(1, 13, 70, 90)
    at = torch.from_numpy(a).T  # (k, m), a stride view
    want = codebook_spmm_reference(port.idx, port.val_table, at)
    for X in (at, at.contiguous()):
        got = codebook_spmm(port.idx, port.val_table, X)
        assert got.dtype == torch.float32 and got.shape == (70, 13)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # spmm routes a CodebookDense to the wrapper; spmm_reference is the
    # twin of the JAX lookup + dot
    torch.testing.assert_close(spmm(port, at), want, rtol=0, atol=0)
    torch.testing.assert_close(spmm_reference(port, at), want,
                               rtol=1e-5, atol=0.5)


def test_codebook_bf16_x():
    m, n, k = 29, 200, 300
    a, port, ref = _inputs(2, m, n, k)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    got = codebook_matmul(a16, port)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_codebook_matmul(jnp.asarray(a, jnp.bfloat16), ref)
                      .astype(jnp.float32))
    got = got.float().numpy()
    # fp32 table times bf16-rounded X, fp32 accumulation, bf16 result
    oracle = a16.double().numpy() @ port.todense().double().numpy().T
    assert quantized_check(got, oracle)
    assert quantized_check(want, oracle)
    assert quantized_check(got, want)


def test_codebook_out_of_table_bytes_are_zero():
    """The kernel pads the table to 256 zero slots, so a byte past the
    sentinel reads 0, as the Pallas kernel's padded table does
    (``codebook_pallas.py:192-193``); so does the plain version."""
    a, port, _ = _inputs(3, 8, 64, 128, table_size=20)
    rng = np.random.default_rng(3)
    raw = port.idx.numpy().copy()
    hit = rng.random(raw.shape) < 0.1
    raw[hit] = rng.integers(21, 256, size=int(hit.sum()))
    got = codebook_matmul(torch.from_numpy(a),
                          dataclasses.replace(port, idx=torch.from_numpy(raw)))
    # the stray bytes contribute what the sentinel does: nothing
    clean = np.where(hit, port.table_size, raw)
    oracle = (a.astype(np.float64)
              @ port.val_table.double().numpy()[clean].T)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=0.5)


def test_codebook_matmul_grad_matches_jax():
    m, n, k = 8, 128, 256
    rng = np.random.default_rng(4)
    a = gen_matrix_random(rng, m, k) / 1000
    idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                         table_size=31)
    port = CodebookDense.from_index_matrix(idx, table, trans=True,
                                           device="cpu")
    ref = JaxCodebookDense.from_index_matrix(idx, table, trans=True)
    at = torch.from_numpy(a).requires_grad_()
    (codebook_matmul(at, port) ** 2).sum().backward()
    want = np.asarray(jax.grad(
        lambda x: jnp.sum(jax_codebook_matmul(x, ref) ** 2))(jnp.asarray(a)))
    np.testing.assert_allclose(at.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # the index plane and the table carry no gradient
    assert port.idx.grad is None and port.val_table.grad is None
