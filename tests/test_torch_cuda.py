"""The hand-written kernels against their plain versions on the card.

Needs an NVIDIA card with ``nvcc``; skipped elsewhere.  The machine with
the card need not have JAX, so run this file without the suite's
conftest (which imports JAX)::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each case launches the kernel through its wrapper and compares it with
the plain PyTorch version on the same CUDA tensors.  fp32 results differ
only in summation order (tolerance 1e-5 of the output scale); bf16 results
are both accumulated in fp32 and rounded once, so they may differ by one
bf16 step (2^-8) of the output scale.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sparsematrix_tpu_torch import add_mat_mat
from sparsematrix_tpu_torch.formats import (CSR, CodebookCSR, CodebookDense,
                                            csr_to_blocked_ell)
from sparsematrix_tpu_torch.kernels import (_build, codebook_matmul,
                                            codebook_spmm,
                                            codebook_spmm_reference,
                                            spmm_blocked_ell,
                                            spmm_blocked_ell_reference)
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_random_dense_sparse,
                                                    gen_sparse_index_matrix)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def assert_kernel_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    step = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-5
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    assert err <= step * scale, (err, scale)


def _layouts(X):
    """X row-major, k-major (a transposed view) and strided."""
    wide = torch.empty((X.shape[0], 2 * X.shape[1]), dtype=X.dtype,
                       device=X.device)
    wide[:, ::2] = X
    return {"row": X, "kmajor": X.T.contiguous().T, "strided": wide[:, ::2]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mnk", [(1, 1, 1), (3, 37, 70), (33, 65, 129),
                                 (117, 1023, 2047), (5, 16, 0)])
def test_codebook_kernel(dev, mnk, dtype):
    m, n, k = mnk
    rng = np.random.default_rng(sum(mnk))
    idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                         table_size=255)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True, device=dev)
    X = torch.from_numpy(gen_matrix_random(rng, k, m)).to(dev, dtype)
    for name, x in _layouts(X).items():
        before = _build.launch_counts["codebook_spmm"]
        got = codebook_spmm(b_t.idx, b_t.val_table, x)
        assert _build.launch_counts["codebook_spmm"] == before + 1, name
        assert_kernel_close(got, codebook_spmm_reference(b_t.idx,
                                                         b_t.val_table, x))


def test_codebook_kernel_stray_bytes(dev):
    """A small table, and index bytes past its sentinel: they read 0."""
    rng = np.random.default_rng(7)
    idx, table = gen_sparse_index_matrix(rng, 300, 90, table_size=9)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True, device=dev)
    raw = b_t.idx.clone()
    raw[torch.rand(raw.shape, device=dev) < 0.1] = 200
    X = torch.from_numpy(gen_matrix_random(rng, 300, 40)).to(dev)
    assert_kernel_close(codebook_spmm(raw, b_t.val_table, X),
                        codebook_spmm_reference(raw, b_t.val_table, X))


def test_codebook_kernel_refuses_bad_input(dev):
    rng = np.random.default_rng(8)
    idx, table = gen_sparse_index_matrix(rng, 64, 32)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True, device=dev)
    X = torch.ones((64, 4), device=dev)
    with pytest.raises(ValueError, match="uint8"):
        codebook_spmm(b_t.idx.to(torch.int32), b_t.val_table, X)
    with pytest.raises(ValueError, match="one CUDA device"):
        codebook_spmm(b_t.idx, b_t.val_table, X.cpu())
    with pytest.raises(ValueError, match="fp32 or bf16"):
        codebook_spmm(b_t.idx, b_t.val_table, X.half())


def _bell(dense, block, dev, dtype=torch.float32):
    A = csr_to_blocked_ell(CSR.fromdense(dense, device=dev), block, device=dev)
    return dataclasses.replace(A, blocks=A.blocks.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block,nrhs", [
    ((64, 256), (8, 128), 128),
    ((120, 300), (8, 128), 64),
    ((200, 300), (128, 128), 117),
    ((50, 70), (16, 32), 5),
    ((100, 130), (48, 64), 33),
    ((9, 40), (1, 8), 3),
])
def test_blocked_ell_kernel(dev, shape, block, nrhs, dtype):
    rng = np.random.default_rng(shape[0] + nrhs)
    dense = gen_random_dense_sparse(rng, *shape, density=0.1)
    dense[: 2 * block[0]] = 0  # empty block-rows: only padding slots
    A = _bell(dense, block, dev, dtype)
    X = torch.from_numpy(gen_matrix_random(rng, shape[1], nrhs)).to(dev, dtype)
    for name, x in _layouts(X).items():
        before = _build.launch_counts["spmm_blocked_ell"]
        got = spmm_blocked_ell(A, x)
        assert _build.launch_counts["spmm_blocked_ell"] == before + 1, name
        assert_kernel_close(got, spmm_blocked_ell_reference(A, x))


def test_blocked_ell_kernel_refuses_mixed_types(dev):
    dense = gen_random_dense_sparse(np.random.default_rng(9), 16, 128, 0.2)
    A = _bell(dense, (8, 128), dev)
    with pytest.raises(ValueError, match="fp32 or both bf16"):
        spmm_blocked_ell(A, torch.ones((128, 4), device=dev,
                                       dtype=torch.bfloat16))


def test_gradients_on_card_match_cpu(dev):
    rng = np.random.default_rng(10)
    a = gen_matrix_random(rng, 8, 256) / 1000
    idx, table = gen_sparse_index_matrix(rng, 256, 128, table_size=31)
    dense = gen_random_dense_sparse(rng, 64, 256, density=0.1)
    X = rng.standard_normal((256, 16)).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        at = torch.from_numpy(a).to(d).requires_grad_()
        b_t = CodebookDense.from_index_matrix(idx, table, trans=True,
                                              device=d)
        (codebook_matmul(at, b_t) ** 2).sum().backward()
        A = _bell(dense, (8, 64), d)
        blocks = A.blocks.clone().requires_grad_()
        Xt = torch.from_numpy(X).to(d).requires_grad_()
        spmm_blocked_ell(dataclasses.replace(A, blocks=blocks), Xt).sum().backward()
        grads[str(d)] = [t.grad.cpu() for t in (at, blocks, Xt)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("fmt", ["CodebookCSR", "CodebookDense", "BlockedELL"])
def test_add_mat_mat_on_card_matches_cpu(dev, fmt):
    rng = np.random.default_rng(11)
    a = gen_matrix_random(rng, 32, 512)
    c = gen_matrix_random(rng, 32, 256)
    idx, table = gen_sparse_index_matrix(rng, 512, 256)
    out = {}
    for d in ("cpu", dev):
        if fmt == "BlockedELL":
            bt = CodebookDense.from_index_matrix(idx, table, trans=True,
                                                 device="cpu").todense()
            b_t = _bell(bt.numpy(), (8, 128), d)
        else:
            cls = CodebookCSR if fmt == "CodebookCSR" else CodebookDense
            b_t = cls.from_index_matrix(idx, table, trans=True, device=d)
        out[str(d)] = add_mat_mat(torch.from_numpy(a).to(d), b_t,
                                  torch.from_numpy(c).to(d), 1.0, 1.0).cpu()
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5,
                               atol=1e-5 * scale)
