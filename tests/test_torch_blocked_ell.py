"""Blocked-ELL times dense (``kernels/spmm_blocked_ell.py``) against the
JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX
``spmm_blocked_ell`` runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it (``tests/test_pallas_kernels.py``).  The kernel
itself is held against the plain version on the card by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.kernels.spmm_pallas import \
    spmm_blocked_ell as jax_spmm_blocked_ell
from sparsematrix_tpu_torch.kernels import (spmm_blocked_ell,
                                            spmm_blocked_ell_reference)
from sparsematrix_tpu_torch.ops import spmm
from sparsematrix_tpu_torch.utils.testutils import (gen_random_dense_sparse,
                                                    quantized_check)


def _pair(dense, block_shape):
    port = tf.csr_to_blocked_ell(tf.CSR.fromdense(dense, device="cpu"),
                                 block_shape=block_shape, device="cpu")
    ref = jf.csr_to_blocked_ell(jf.CSR.fromdense(dense),
                                block_shape=block_shape)
    return port, ref


@pytest.mark.parametrize("shape,k", [((64, 256), 128), ((120, 300), 64)])
def test_blocked_ell_matches_jax(shape, k):
    rng = np.random.default_rng(0)
    dense = gen_random_dense_sparse(rng, *shape, density=0.1)
    port, ref = _pair(dense, (8, 128))
    X = rng.uniform(-1, 1, size=(shape[1], k)).astype(np.float32)
    got = spmm_blocked_ell(port, torch.from_numpy(X)).numpy()
    want = np.asarray(jax_spmm_blocked_ell(ref, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, dense.astype(np.float64) @ X,
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape,block", [((200, 300), (128, 128)),
                                         ((50, 70), (16, 32))])
def test_blocked_ell_ragged_blocks(shape, block):
    """The last block-row and block-column are ragged: nrows and ncols are
    not multiples of the block shape."""
    rng = np.random.default_rng(1)
    dense = gen_random_dense_sparse(rng, *shape, density=0.1)
    port = tf.csr_to_blocked_ell(tf.CSR.fromdense(dense, device="cpu"),
                                 block_shape=block, device="cpu")
    X = torch.from_numpy(rng.uniform(-1, 1, (shape[1], 24)).astype(np.float32))
    want = dense.astype(np.float64) @ X.double().numpy()
    for x in (X, X.T.contiguous().T):  # row-major and k-major
        got = spmm_blocked_ell(port, x)
        assert got.shape == (shape[0], 24)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(spmm(port, X), spmm_blocked_ell_reference(
        port, X), rtol=0, atol=0)


def test_blocked_ell_bf16():
    rng = np.random.default_rng(2)
    dense = gen_random_dense_sparse(rng, 64, 256, density=0.1)
    port, _ = _pair(dense, (8, 128))
    port16 = dataclasses.replace(port, blocks=port.blocks.to(torch.bfloat16))
    X = torch.from_numpy(rng.uniform(-1, 1, (256, 32)).astype(np.float32))
    got = spmm_blocked_ell(port16, X.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    oracle = dense.astype(np.float64) @ X.double().numpy()
    assert quantized_check(got.float().numpy(), oracle)


def test_blocked_ell_vjp_matches_jax():
    rng = np.random.default_rng(3)
    dense = gen_random_dense_sparse(rng, 64, 256, density=0.1)
    port, ref = _pair(dense, (8, 64))
    X = rng.standard_normal((256, 16)).astype(np.float32)
    g = rng.standard_normal((64, 16)).astype(np.float32)

    blocks = port.blocks.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    y = spmm_blocked_ell(dataclasses.replace(port, blocks=blocks), Xt)
    y.backward(torch.from_numpy(g))

    _, vjp = jax.vjp(jax_spmm_blocked_ell, ref, jnp.asarray(X))
    dA, dX = vjp(jnp.asarray(g))
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dX),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Xt.grad.numpy(),
                               dense.T.astype(np.float64) @ g,
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(dA.blocks),
                               rtol=1e-4, atol=1e-4)
    # padding slots get no gradient
    assert not blocks.grad[~port.valid].any()
