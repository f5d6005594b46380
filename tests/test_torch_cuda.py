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
import importlib

import numpy as np
import pytest
import torch

from sparsematrix_tpu_torch import add_mat_mat, spmm, spmv
from sparsematrix_tpu_torch.formats import (CSR, CodebookCSR, CodebookDense,
                                            csr_to_blocked_ell)
from sparsematrix_tpu_torch.kernels import (
    _build, codebook_matmul, codebook_spmm, codebook_spmm_reference,
    pack_dualgather, pack_octet, pack_sell_rowlane, pack_superblock,
    spmm_blocked_ell, spmm_blocked_ell_reference, spmm_dualgather,
    spmm_dualgather_reference, spmv_dualgather, spmv_dualgather_reference,
    spmv_octet, spmv_octet_reference, spmv_sell_rowlane,
    spmv_sell_rowlane_reference, spmv_superblock, spmv_superblock_reference,
    window_permute, window_permute_reference)
from sparsematrix_tpu_torch.ops import (apply_permutation, pack_skew,
                                        plan_clos_permutation, spgemm,
                                        spgemm_apply_packed,
                                        spgemm_apply_packed_csc,
                                        spgemm_plan_packed)
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_random_dense_sparse,
                                                    gen_sparse_index_matrix,
                                                    quantized_check,
                                                    relative_check,
                                                    tri_oracle, triangular)

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


# the row-group path (block heights below 32): several block-rows share
# each staged X chunk; patterns whose unions are dense, banded or
# block-diagonal, a block-row with only padding slots, a ragged last
# block-row and ncols not a multiple of bk
def _band_dense(rng, n, bs, offsets):
    nb = -(-n // bs)
    mask = np.zeros((nb, nb), bool)
    for o in offsets:
        idx = np.arange(max(0, -o), nb - max(0, o))
        mask[idx, idx + o] = True
    full = np.kron(mask, np.ones((bs, bs))).astype(np.float32)
    return full[:n, :n] * gen_matrix_random(rng, n, n)


BELL_ROWS_CARD = [
    ("random", (333, 1000), (4, 128)),
    ("random", (1023, 2047), (8, 128)),
    ("random", (300, 260), (16, 64)),
    ("banded", (1024, 1024), (8, 128)),
    ("blockdiag", (1000, 1000), (8, 64)),
]


def _bell_rows_dense(pattern, shape, block, seed):
    rng = np.random.default_rng(seed)
    if pattern == "random":
        dense = gen_random_dense_sparse(rng, *shape, density=0.1)
    else:
        offsets = (-1, 0, 1) if pattern == "banded" else (0,)
        dense = _band_dense(rng, shape[0], 128, offsets)
    dense[3 * block[0]: 4 * block[0]] = 0  # block-row 3: padding slots only
    return rng, dense


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nrhs", [1, 7, 117, 128, 513])
@pytest.mark.parametrize("case", BELL_ROWS_CARD,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[2]}")
def test_blocked_ell_row_groups(dev, case, nrhs, dtype):
    pattern, shape, block = case
    rng, dense = _bell_rows_dense(pattern, shape, block, shape[0] + nrhs)
    A = _bell(dense, block, dev, dtype)
    X = torch.from_numpy(gen_matrix_random(rng, shape[1], nrhs)).to(dev, dtype)
    blocks64 = A.blocks.double().cpu().numpy()
    for name, x in (("row", X), ("kmajor", X.T.contiguous().T)):
        before = _build.launch_counts["spmm_blocked_ell"]
        got = spmm_blocked_ell(A, x)
        assert _build.launch_counts["spmm_blocked_ell"] == before + 1, name
        assert_kernel_close(got, spmm_blocked_ell_reference(A, x))
        # the fp64 oracle of the stored (rounded) blocks
        dense64 = np.zeros((A.block_cols.shape[0] * block[0],
                            -(-shape[1] // block[1]) * block[1]))
        for i, cols in enumerate(A.block_cols.cpu().numpy()):
            for m_, c in enumerate(cols):
                dense64[i * block[0]:(i + 1) * block[0],
                        c * block[1]:(c + 1) * block[1]] += blocks64[i, m_]
        x64 = x.double().cpu().numpy()
        oracle = dense64[:shape[0], :shape[1]] @ x64
        check = quantized_check if dtype == torch.bfloat16 else relative_check
        assert check(got.double().cpu().numpy(), oracle), name


@pytest.mark.parametrize("split", [1, 3, 16])
def test_blocked_ell_row_group_splits(dev, split):
    """The split knob: blocks that share an output tile sum into it."""
    from sparsematrix_tpu_torch.kernels.spmm_blocked_ell import (
        _spmm_blocked_ell_cuda)

    rng, dense = _bell_rows_dense("random", (500, 777), (8, 128), split)
    A = _bell(dense, (8, 128), dev)
    X = torch.from_numpy(gen_matrix_random(rng, 777, 117)).to(dev)
    for x in (X, X.T.contiguous().T):
        assert_kernel_close(_spmm_blocked_ell_cuda(A, x, split=split),
                            spmm_blocked_ell_reference(A, x))


def test_blocked_ell_row_group_backward(dev):
    """Gradients through the row-group path at (8, 128), card against CPU."""
    rng = np.random.default_rng(21)
    dense = gen_random_dense_sparse(rng, 260, 700, density=0.1)
    X = rng.standard_normal((700, 33)).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        A = _bell(dense, (8, 128), d)
        blocks = A.blocks.clone().requires_grad_()
        Xt = torch.from_numpy(X).to(d).requires_grad_()
        Y = spmm_blocked_ell(dataclasses.replace(A, blocks=blocks), Xt)
        (Y * Y).sum().backward()
        grads[str(d)] = [t.grad.cpu() for t in (blocks, Xt)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


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


def _dg_pack(dense, dev, bf16=False, **kw):
    return pack_dualgather(CSR.fromdense(dense, device=dev),
                           dtype=torch.bfloat16 if bf16 else None, **kw)


# (shape, density, pack arguments): rows not a multiple of 128 and cols not
# of 1024; k_tiles=1 (row 10/14) and superblocks (row 11/13) with an even
# group (nibble idxA) and an odd one (byte idxA); two-window packs over an
# odd window count (the last window pairs with itself); bf16 values
DG_CASES = [
    ((300, 1500), 0.05, dict(group=4)),
    ((129, 1024), 0.1, dict(group=8)),
    ((700, 3000), 0.04, dict(group=4, k_tiles=4)),
    ((300, 3000), 0.05, dict(group=3, k_tiles=2, two_win=True)),
    ((512, 4096), 0.08, dict(group=4, k_tiles=2, two_win=True)),
    ((300, 5000), 0.03, dict(group=5, k_tiles=4, two_win=True)),
    ((1100, 1100), 0.02, dict(k_tiles=8, group=16)),
    ((256, 2048), 0.05, dict(group=4, bf16=True)),
    ((256, 2048), 0.05, dict(group=4, k_tiles=2, two_win=True, bf16=True)),
]


def _dg_id(case):
    (r, c), _, kw = case
    return f"{r}x{c}-" + "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("case", DG_CASES, ids=_dg_id)
def test_dualgather_spmv_kernel(dev, case):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + shape[1])
    dense = gen_random_dense_sparse(rng, *shape, density=density)
    dense[128:256] = 0  # a tile with no entries
    A = _dg_pack(dense, dev, **kw)
    x = torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32)).to(dev)
    name = "spmv_dualgather" + ("_sb" if A.k_tiles > 1 else "")
    before = _build.launch_counts[name]
    got = spmv_dualgather(A, x)
    assert _build.launch_counts[name] == before + 1
    assert_kernel_close(got, spmv_dualgather_reference(A, x))
    oracle = dense.astype(np.float64) @ x.double().cpu().numpy()
    check = quantized_check if kw.get("bf16") else relative_check
    assert check(got.double().cpu().numpy(), oracle)


@pytest.mark.parametrize("k", [1, 33, 64])
@pytest.mark.parametrize("case", DG_CASES, ids=_dg_id)
def test_dualgather_spmm_kernel(dev, case, k):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + k)
    dense = gen_random_dense_sparse(rng, *shape, density=density)
    dense[128:256] = 0
    A = _dg_pack(dense, dev, **kw)
    X = torch.from_numpy(gen_matrix_random(rng, shape[1], k)).to(dev)
    name = "spmm_dualgather" + ("_sb" if A.k_tiles > 1 else "")
    before = _build.launch_counts[name]
    got = spmm_dualgather(A, X)
    assert _build.launch_counts[name] == before + 1
    assert_kernel_close(got, spmm_dualgather_reference(A, X))


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("bf16", [False, True])
def test_kt1_walk_value_writes(dev, bf16, k, step):
    """Row 14's walk (each step) after in-place writes, made after a first
    call built its walk: into an all-zero slab and into a padding slot of
    a slab that holds values; Y follows the writes as the plain version
    does.  Row 13 on a superblock pack of the same matrix beside it."""
    tsm = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")

    rng = np.random.default_rng(40 + k)
    dense = gen_random_dense_sparse(rng, 700, 2500, density=0.03)
    dense[256:384] = 0  # a tile with no entries: no slab
    A = _dg_pack(dense, dev, group=4, bf16=bf16)
    X = torch.from_numpy(gen_matrix_random(rng, 2500, k)).to(dev)
    first = tsm._spmm_dualgather_cuda(A, X, step=step)
    assert_kernel_close(first, spmm_dualgather_reference(A, X))
    v = A.vals.reshape(A.n_slabs, 8, 128)
    zero_slab = int(torch.nonzero(~(v != 0).any(-1).any(-1))[0])
    real = int(torch.nonzero((v != 0).any(-1).any(-1)
                             & (v == 0).any(-1).any(-1))[0])
    u, lane = map(int, torch.nonzero(v[real] == 0)[0])
    g, k0 = divmod(zero_slab, A.group)
    A.vals[g, k0 * 8, 5] = 300.0
    g, k0 = divmod(real, A.group)
    A.vals[g, k0 * 8 + u, lane] = -200.0
    want = spmm_dualgather_reference(A, X)
    assert not torch.equal(want, first)
    before = _build.launch_counts["spmm_dualgather"]
    got = tsm._spmm_dualgather_cuda(A, X, step=step)
    assert _build.launch_counts["spmm_dualgather"] == before + 1
    assert_kernel_close(got, want)
    S = _dg_pack(dense, dev, group=4, k_tiles=2, two_win=True, bf16=bf16)
    assert_kernel_close(spmm_dualgather(S, X),
                        spmm_dualgather_reference(S, X))


# superblock packs for row 13's walk: nibble idxA over one window, byte
# idxA (odd group), two windows with nibble and with byte idxA, bf16
SB_WALK = [
    dict(group=4, k_tiles=4),
    dict(group=3, k_tiles=2),
    dict(group=4, k_tiles=2, two_win=True),
    dict(group=5, k_tiles=4, two_win=True),
    dict(group=4, k_tiles=2, two_win=True, bf16=True),
]


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("kw", SB_WALK, ids=lambda kw: "-".join(
    f"{a}={b}" for a, b in kw.items()))
def test_sb_walk(dev, kw, k, step):
    """Row 13's walk (each step) on superblock packs against the plain
    version and fp64; then a value written into an all-zero slab, after
    the first call built the walk, reaches the kernel."""
    tsm = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")

    # every pack of this matrix has an all-zero slab
    dense = gen_random_dense_sparse(np.random.default_rng(60), 700, 3000,
                                    density=0.03)
    dense[256:384] = 0  # a tile with no entries: no slab
    A = _dg_pack(dense, dev, **kw)
    assert A.k_tiles > 1 and A.nibble == (A.group % 2 == 0)
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(k), 3000,
                                           k)).to(dev)
    before = _build.launch_counts["spmm_dualgather_sb"]
    first = tsm._spmm_dualgather_cuda(A, X, step=step)
    assert _build.launch_counts["spmm_dualgather_sb"] == before + 1
    assert_kernel_close(first, spmm_dualgather_reference(A, X))
    if kw.get("bf16"):  # the oracle of the bf16-rounded values
        dense = torch.from_numpy(dense).to(torch.bfloat16).double().numpy()
    oracle = dense.astype(np.float64) @ X.double().cpu().numpy()
    assert relative_check(first.double().cpu().numpy(), oracle)
    v = A.vals.reshape(A.n_slabs, 8, 128)
    zero_slab = int(torch.nonzero(~(v != 0).any(-1).any(-1))[0])
    g, k0 = divmod(zero_slab, A.group)
    A.vals[g, k0 * 8, 5] = 300.0
    want = spmm_dualgather_reference(A, X)
    assert not torch.equal(want, first)
    got = tsm._spmm_dualgather_cuda(A, X, step=step)
    assert_kernel_close(got, want)


@pytest.mark.parametrize("spb", [1, 3, 200])
def test_sb_walk_block_sizes(dev, spb):
    """Row 13's walk in blocks of one slab, of a few, and of more than a
    window holds, on the auto superblock pack (two windows, nibbles)."""
    from sparsematrix_tpu_torch.ops import prepare_spmv

    tsm = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")
    rng = np.random.default_rng(70 + spb)
    dense = gen_random_dense_sparse(rng, 2048, 4096, density=0.02)
    A = prepare_spmv(CSR.fromdense(dense, device=dev))
    assert A.k_tiles > 1 and A.two_win
    X = torch.from_numpy(gen_matrix_random(rng, 4096, 32)).to(dev)
    want = spmm_dualgather_reference(A, X)
    for step in (1, 2, 3):
        assert_kernel_close(tsm._spmm_dualgather_cuda(A, X, step=step,
                                                       spb=spb), want)


@pytest.mark.parametrize("spb", [1, 3, 200])
def test_kt1_walk_block_sizes(dev, spb):
    """Blocks of one slab, of a few, and of more than a window holds."""
    tsm = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")

    rng = np.random.default_rng(spb)
    dense = gen_random_dense_sparse(rng, 1000, 5000, density=0.02)
    A = _dg_pack(dense, dev, group=4)
    X = torch.from_numpy(gen_matrix_random(rng, 5000, 32)).to(dev)
    want = spmm_dualgather_reference(A, X)
    for step in (1, 2, 3):
        assert_kernel_close(tsm._spmm_dualgather_cuda(A, X, step=step,
                                                       spb=spb), want)


def test_kt1_walk_nan_under_zero_value(dev):
    """An inf or NaN of X under a zero value (a padding slot) gives 0 on
    the card: the walk reads no X row there (the plain version: NaN)."""
    rng = np.random.default_rng(44)
    dense = gen_random_dense_sparse(rng, 300, 1500, density=0.03)
    dense[:, 0] = 0  # a padding slot names column 0
    A = _dg_pack(dense, dev, group=4)
    X = torch.from_numpy(gen_matrix_random(rng, 1500, 4)).to(dev)
    want = spmm_dualgather(A, X)
    X[0] = float("nan")
    assert not bool(torch.isfinite(spmm_dualgather_reference(A, X)).all())
    got = spmm_dualgather(A, X)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert_kernel_close(got, want)


@pytest.mark.parametrize("kw", [dict(group=4), dict(group=4, k_tiles=2,
                                                     two_win=True)])
def test_dualgather_empty_matrix(dev, kw):
    A = _dg_pack(np.zeros((200, 1500), np.float32), dev, **kw)
    assert float(spmv_dualgather(A, torch.ones(1500, device=dev)).abs().max()) == 0
    Y = spmm_dualgather(A, torch.ones((1500, 3), device=dev))
    torch.cuda.synchronize()
    assert Y.shape == (200, 3) and float(Y.abs().max()) == 0


def test_dualgather_kernel_refuses_bad_input(dev):
    dense = gen_random_dense_sparse(np.random.default_rng(12), 256, 1024, 0.05)
    A = _dg_pack(dense, dev, group=4)
    with pytest.raises(ValueError, match="fp32"):
        spmv_dualgather(A, torch.ones(1024, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="fp32"):
        spmm_dualgather(A, torch.ones((1024, 2), device=dev,
                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        spmv_dualgather(dataclasses.replace(A, vals=A.vals.half()),
                        torch.ones(1024, device=dev))


@pytest.mark.parametrize("kw", [dict(group=4, with_transpose=True),
                                dict(group=4, k_tiles=2, two_win=True)])
def test_dualgather_gradients_on_card_match_cpu(dev, kw):
    rng = np.random.default_rng(13)
    dense = gen_random_dense_sparse(rng, 300, 1500, density=0.05)
    x = rng.standard_normal(1500).astype(np.float32)
    X = rng.standard_normal((1500, 5)).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        A = _dg_pack(dense, d, **kw)
        out = []
        for fn, rhs in ((spmv_dualgather, x), (spmm_dualgather, X)):
            v = A.vals.clone().requires_grad_()
            r = torch.from_numpy(rhs).to(d).requires_grad_()
            (fn(dataclasses.replace(A, vals=v), r) ** 2).sum().backward()
            out += [v.grad.cpu(), r.grad.cpu()]
        grads[str(d)] = out
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_spmv_spmm_auto_routes_on_card_match_cpu(dev):
    """``spmv``/``spmm`` on a CSR through the auto routes: the pack
    (superblock for spmv, k_tiles=1 for spmm) launches its kernel."""
    rng = np.random.default_rng(14)
    n = 2048  # 16 tiles: spmv packs superblocks (kt=16, two windows)
    dense = gen_random_dense_sparse(rng, n, n, density=0.03)
    x = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, 8)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        A = CSR.fromdense(dense, device=d)
        _build.launch_counts.clear()
        y, Y = spmv(A, torch.from_numpy(x).to(d)), spmm(A, torch.from_numpy(X).to(d))
        out[str(d)] = (y.cpu(), Y.cpu(), dict(_build.launch_counts))
    assert out["cpu"][2] == {}
    assert out["cuda"][2] == {"spmv_dualgather_sb": 1, "spmm_dualgather": 1}
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


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
        _build.launch_counts.clear()
        out[str(d)] = add_mat_mat(torch.from_numpy(a).to(d), b_t,
                                  torch.from_numpy(c).to(d), 1.0, 1.0).cpu()
        # a codebook container takes the lookup + one product, as in the
        # JAX package: the fused kernel is not launched
        assert _build.launch_counts["codebook_spmm"] == 0
        assert _build.launch_counts["spmm_blocked_ell"] == (
            fmt == "BlockedELL" and d == dev)
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5,
                               atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# slice 3: rowlane, superblock, octet and the window permute


def _sparse(rng, shape, density):
    import scipy.sparse as sps

    sp = sps.random(*shape, density=density, random_state=int(rng.integers(
        1 << 30)), format="csr", dtype=np.float32)
    sp.data = rng.uniform(-1000, 1000, sp.nnz).astype(np.float32)
    return sp


def _spmv_case(dev, sp, pack, spmv_fn, ref_fn, name, n_launch=1, **kw):
    """The kernel against its plain version on the same CUDA tensors, the
    launch counted, and the oracle."""
    A = pack(CSR.from_scipy(sp, device=dev), **kw)
    rng = np.random.default_rng(sp.shape[1])
    x = torch.from_numpy(rng.standard_normal(sp.shape[1]).astype(
        np.float32)).to(dev)
    before = _build.launch_counts[name]
    got = spmv_fn(A, x)
    assert _build.launch_counts[name] == before + n_launch
    assert_kernel_close(got, ref_fn(A, x))
    sp64 = sp.astype(np.float64)
    if kw.get("dtype") is torch.bfloat16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    assert relative_check(got.double().cpu().numpy(),
                          sp64 @ x.double().cpu().numpy())
    return A


# ragged last tile and window (rows not a multiple of 128, cols not of
# 1024), every lanes_per_row, bf16 values, a spill tail (a second launch)
RL_CARD = [
    ((1100, 900), 0.02, dict()),
    ((1000, 3000), 0.01, dict(lanes_per_row=2, group=4)),
    ((1100, 900), 0.02, dict(lanes_per_row=4)),
    ((1000, 3000), 0.01, dict(lanes_per_row=8, dtype=torch.bfloat16)),
    ((1100, 900), 0.02, dict(lanes_per_row=4, dtype=torch.bfloat16)),
    ((4000, 5000), 0.002, dict(group=2)),
]


@pytest.mark.parametrize("case", RL_CARD, ids=_dg_id)
def test_rowlane_kernel(dev, case):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + shape[1])
    _spmv_case(dev, _sparse(rng, shape, density), pack_sell_rowlane,
               spmv_sell_rowlane, spmv_sell_rowlane_reference, "spmv_rowlane",
               **kw)


def test_rowlane_spill_tail_kernel(dev):
    rng = np.random.default_rng(21)
    d = gen_random_dense_sparse(rng, 600, 1700, density=0.01)
    d[[3, 200, 599], :] = rng.uniform(-1000, 1000, (3, 1700))
    import scipy.sparse as sps

    A = _spmv_case(dev, sps.csr_matrix(d), pack_sell_rowlane,
                   spmv_sell_rowlane, spmv_sell_rowlane_reference,
                   "spmv_rowlane", n_launch=2, lanes_per_row=2,
                   spill_depth=1)
    assert A.spill_packed is not None


SB_CARD = [
    ((1100, 900), 0.02, dict(group=8, k_tiles=8)),
    ((1000, 3000), 0.01, dict(group=4, k_tiles=4, dtype=torch.bfloat16)),
    ((4000, 5000), 0.002, dict(group=16, k_tiles=16)),
    ((300, 1500), 0.05, dict(group=2, k_tiles=32)),
]


@pytest.mark.parametrize("case", SB_CARD, ids=_dg_id)
def test_superblock_kernel(dev, case):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] * 3 + shape[1])
    _spmv_case(dev, _sparse(rng, shape, density), pack_superblock,
               spmv_superblock, spmv_superblock_reference, "spmv_superblock",
               **kw)


# multi-window and odd shapes, depth (deg ~15 a window), the trim section
# (rem: in the same launch), bf16 values
OCT_CARD = [
    ((3000, 5000), 0.0005, dict(k_octets=4)),
    ((1100, 900), 0.001, dict(k_octets=2)),
    ((1500, 1000), 0.01, dict(k_octets=1)),
    ((3000, 5000), 0.0005, dict(group=32, k_octets=4, trim_group=8)),
    ((1100, 900), 0.002, dict(k_octets=2, dtype=torch.bfloat16)),
]


@pytest.mark.parametrize("case", OCT_CARD, ids=_dg_id)
def test_octet_kernel(dev, case):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + 7 * shape[1])
    A = _spmv_case(dev, _sparse(rng, shape, density), pack_octet, spmv_octet,
                   spmv_octet_reference, "spmv_octet", **kw)
    assert (A.rem is not None) == ("trim_group" in kw)


def _octet_walk_case(dev, sp, **kw):
    """The walk kernel on ``sp``'s pack: against its plain version, at
    every knob setting (slabs a range, stages, slab groups), in one
    launch, and twice in a row bit for bit (no atomics: each octet is one
    block's, its groups' sums added in group order)."""
    octmod = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_octet")
    A = pack_octet(CSR.from_scipy(sp, device=dev), **kw)
    x = torch.from_numpy(np.random.default_rng(sp.shape[0]).standard_normal(
        sp.shape[1]).astype(np.float32)).to(dev)
    want = spmv_octet_reference(A, x)
    rows = sp.shape[0]
    # what the allocator hands back next holds NaN: rows the kernel left
    # unwritten would show
    stale = torch.full((rows,), float("nan"), device=dev)
    del stale
    before = _build.launch_counts["spmv_octet"]
    got = octmod._spmv_octet_cuda(A, x)
    assert _build.launch_counts["spmv_octet"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert_kernel_close(got, want)
    assert torch.equal(got, octmod._spmv_octet_cuda(A, x))
    for spr, stages, groups in ((1, 0, 1), (2, 2, 1), (0, 1, 1),
                                (0, 16, 1), (1 << 20, 3, 1), (0, 0, 2),
                                (3, 3, 2), (0, 0, 4), (1, 4, 4),
                                (0, 16, 4)):
        assert_kernel_close(octmod._spmv_octet_cuda(
            A, x, spr=spr, stages=stages, groups=groups), want)
    with pytest.raises(RuntimeError):  # fewer stages than groups
        octmod._spmv_octet_cuda(A, x, stages=1, groups=2)
    # the ablation stores every row, zeros
    assert bool((octmod._spmv_octet_cuda(A, x, copies_only=True) == 0).all())
    sp64 = sp.astype(np.float64)
    if kw.get("dtype") is torch.bfloat16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    assert relative_check(got.double().cpu().numpy(),
                          sp64 @ x.double().cpu().numpy())
    return A


@pytest.mark.parametrize("case", OCT_CARD, ids=_dg_id)
def test_octet_walk_kernel(dev, case):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + 11 * shape[1])
    _octet_walk_case(dev, _sparse(rng, shape, density), **kw)


def test_octet_walk_one_slab(dev):
    """A pack of one slab (three entries in one octet of a 2500-row
    matrix): one range holds it, the other octets are stored as zeros."""
    import scipy.sparse as sps

    sp = sps.csr_matrix((np.array([3.0, -2.0, 5.0], np.float32),
                         (np.array([1030, 1031, 2047]),
                          np.array([7, 900, 1000]))), shape=(2500, 1600))
    A = _octet_walk_case(dev, sp, k_octets=2)
    octmod = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_octet")
    items, oct_ptr = octmod.octet_walk(A)
    assert items.shape[0] == 1 and oct_ptr.tolist() == [0, 0, 1, 1]


def test_octet_walk_empty_octets(dev):
    """Most octets have no slab (entries in 3 of 40 octets, rows not a
    multiple of 1024), with a trim section: their rows come back 0."""
    rng = np.random.default_rng(23)
    d = np.zeros((40 * 1024 - 300, 3000), np.float32)
    for o in (0, 17, 39):
        r = rng.integers(o * 1024, min((o + 1) * 1024, d.shape[0]), 400)
        d[r, rng.integers(0, 3000, 400)] = rng.uniform(-1000, 1000, 400)
    import scipy.sparse as sps

    A = _octet_walk_case(dev, sps.csr_matrix(d), group=8, k_octets=4,
                         trim_group=2)
    assert A.rem is not None


def test_octet_columns_past_cols(dev):
    """Padding cells route to a column past ``cols`` in the last window:
    the kernel reads it as 0."""
    rng = np.random.default_rng(22)
    sp = _sparse(rng, (2100, 1030), 0.003)
    A = pack_octet(CSR.from_scipy(sp, device=dev), k_octets=2)
    x = torch.from_numpy(rng.standard_normal(1030).astype(np.float32)).to(dev)
    got = spmv_octet(A, x)
    assert_kernel_close(got, spmv_octet_reference(A, x))
    assert relative_check(got.double().cpu().numpy(),
                          sp.astype(np.float64) @ x.double().cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("n_windows", [1, 3, 2048])
def test_window_permute_kernel(dev, n_windows, dtype):
    rng = np.random.default_rng(n_windows)
    from sparsematrix_tpu_torch.ops.permute_clos import _window_planes

    win = np.repeat(np.arange(n_windows), 1024)
    src = np.concatenate([rng.permutation(1024) for _ in range(n_windows)])
    dst = np.tile(np.arange(1024), n_windows)
    planes = [torch.from_numpy(p).to(dev)
              for p in _window_planes(win, src, dst, n_windows)]
    x = torch.from_numpy(rng.integers(-2**30, 2**30, (n_windows, 8, 128))
                         .astype(np.int32)).to(dev)
    if dtype == torch.float32:
        x = x.float()
    before = _build.launch_counts["window_permute"]
    got = window_permute(x, *planes)
    assert _build.launch_counts["window_permute"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, window_permute_reference(x, *planes))
    flat = x.reshape(n_windows, 1024).cpu()
    want = torch.empty_like(flat)
    want.reshape(-1)[torch.from_numpy(win * 1024 + dst)] = flat.reshape(-1)[
        torch.from_numpy(win * 1024 + src)]
    assert torch.equal(got.reshape(n_windows, 1024).cpu(), want)
    with pytest.raises(ValueError, match="4-byte"):
        window_permute(x.double(), *planes)


@pytest.mark.parametrize("n,q", [(20_000, 1), (1_200_000, 2), (2_200_000, 3)])
def test_clos_permutation_on_card(dev, n, q):
    rng = np.random.default_rng(n)
    g = np.full(n + 100, n + 5, np.int64)  # sentinel slots read 0
    live = rng.choice(n + 100, size=n, replace=False)
    g[live] = rng.permutation(n)
    plan = plan_clos_permutation(g, n_src=n, device=dev)
    assert plan.q == q
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    _build.launch_counts.clear()
    got = apply_permutation(plan, x)
    assert _build.launch_counts["window_permute"] == (3 if q == 1 else 4)
    want = torch.zeros(n + 100)
    want[torch.from_numpy(live)] = x.cpu()[torch.from_numpy(g[live])]
    assert torch.equal(got.cpu(), want)


def test_slice3_gradients_on_card_match_cpu(dev):
    rng = np.random.default_rng(23)
    sp = _sparse(rng, (1100, 900), 0.01)
    x = rng.standard_normal(900).astype(np.float32)
    packs = [(pack_sell_rowlane, spmv_sell_rowlane, dict(lanes_per_row=2)),
             (pack_sell_rowlane, spmv_sell_rowlane,
              dict(with_transpose=True)),
             (pack_superblock, spmv_superblock, dict(group=4, k_tiles=4)),
             (pack_octet, spmv_octet, dict(group=8, k_octets=1,
                                           trim_group=2))]
    for pack, fn, kw in packs:
        grads = {}
        for d in ("cpu", dev):
            A = pack(CSR.from_scipy(sp, device=d), **kw)
            v = A.vals.clone().requires_grad_()
            r = torch.from_numpy(x).to(d).requires_grad_()
            (fn(dataclasses.replace(A, vals=v), r) ** 2).sum().backward()
            grads[str(d)] = [v.grad.cpu(), r.grad.cpu()]
        for got, want in zip(grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))


def test_spgemm_and_skew_on_card_match_cpu(dev):
    """SpGEMM on each pair-program layout and the skew route: the card's
    result equals the CPU's, with the layout's kernel launched."""
    from sparsematrix_tpu_torch.utils.testutils import gen_zipf_csr

    rng = np.random.default_rng(24)
    sa, sb = _sparse(rng, (512, 512), 0.02), _sparse(rng, (512, 512), 0.02)
    expect = {"auto": "spmv_octet", "superblock": "spmv_superblock",
              "rowlane": "spmv_rowlane"}
    for layout, kname in expect.items():
        out = {}
        for d in ("cpu", dev):
            A = CSR.from_scipy(sa, device=d)
            B = CSR.from_scipy(sb, device=d)
            pp = spgemm_plan_packed(A, B, layout=layout)
            _build.launch_counts.clear()
            c = spgemm_apply_packed(pp, B.data).data
            ct = spgemm_apply_packed_csc(pp, B.data).data
            out[str(d)] = (c.cpu(), ct.cpu(), dict(_build.launch_counts))
        assert out["cpu"][2] == {}
        assert out["cuda"][2][kname] == 2
        assert out["cuda"][2]["window_permute"] > 0
        for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
    C = spgemm(CSR.from_scipy(sa, device=dev), CSR.from_scipy(sb, device=dev),
               output="csc")
    want = (sa.astype(np.float64) @ sb.astype(np.float64)).T.tocsr()
    want.sort_indices()
    assert relative_check(C.data[: C.nnz].double().cpu().numpy(), want.data)
    sp = gen_zipf_csr(9, 8192, 8192, 8192 * 32, col_zipf=True)
    x = rng.standard_normal(8192).astype(np.float32)
    A = CSR.from_scipy(sp, device=dev)
    _build.launch_counts.clear()
    y = spmv(A, torch.from_numpy(x).to(dev))
    assert _build.launch_counts["spmv_dualgather_sb"] == 1
    assert relative_check(y.double().cpu().numpy(),
                          sp.astype(np.float64) @ x)
    P = pack_skew(CSR.from_scipy(sp, device="cpu"))
    torch.testing.assert_close(y.cpu(), spmv(P, torch.from_numpy(x)),
                               rtol=1e-5, atol=1e-5 * float(y.abs().max()))


# ---------------------------------------------------------------------------
# slice 4: triangular solves (rows 18-21 of PERF.md's table) and the
# solvers on top of them
# ---------------------------------------------------------------------------

def assert_solve_close(got, want):
    """A solve on the card against its plain version: the fp32 sums run
    in another order, and the (diagonally dominant) recurrence carries
    each difference on, so 1e-4 of the output scale."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got.double() - want.double()).abs().max()) <= 1e-4 * scale


# (n, per_row, band, unit, lower, plan arguments, expected mode, K)
WAVES_CARD = [
    (1000, 4, 100, False, True, dict(), "chain", 1),
    (1300, 4, 200, False, True, dict(), "chain", 2),
    (3000, 3, 380, True, True, dict(), "chain", 3),
    (1300, 4, 200, False, False, dict(dtype=torch.bfloat16), "chain", 2),
    (2100, 4, 250, False, False, dict(), "chain", 2),
    (900, 4, None, False, True, dict(m=2), "binv", None),
    (2500, 4, None, True, True, dict(m=8), "binv", None),
    (2500, 4, None, False, False, dict(m=8, dtype=torch.bfloat16), "binv",
     None),
    (1700, 3, None, True, False, dict(m=4), "binv", None),
    (2000, 3, None, False, True, dict(mode="binv", m=1), "binv", None),
]


def _waves_id(case):
    n, per_row, band, unit, lower, kw, mode, K = case
    return (f"{mode}-n{n}-{'L' if lower else 'U'}{'-unit' if unit else ''}"
            f"-{'-'.join(f'{k}={v}' for k, v in kw.items())}")


@pytest.mark.parametrize("case", WAVES_CARD, ids=_waves_id)
def test_trisolve_waves_kernel(dev, case):
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    n, per_row, band, unit, lower, kw, mode, K = case
    sp = triangular(n, per_row, band, unit, lower, seed=n)
    plan = tw.trisolve_waves_plan(CSR.from_scipy(sp, device=dev),
                                  lower=lower, unit_diagonal=unit, **kw)
    assert plan.mode == mode and (K is None or plan.K == K)
    b = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    name = "trisolve_chain" if mode == "chain" else "trisolve_binv"
    before = _build.launch_counts[name]
    got = tw.trisolve_waves_apply(plan, bd)
    assert _build.launch_counts[name] == before + 1
    assert_solve_close(got, tw.waves_forward_plain(plan, bd))
    if "dtype" not in kw:
        np.testing.assert_allclose(got.cpu().numpy(),
                                   tri_oracle(sp, b, lower, unit),
                                   rtol=2e-3, atol=1e-3)
    # the multi-RHS path: one chain_mm launch per 8 columns (a ragged
    # second pane at k = 12), or one binv launch per column
    for k in (1, 8, 12):
        B = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n, k)).astype(np.float32)).to(dev)
        mm_name = "trisolve_chain_mm" if mode == "chain" else name
        before = _build.launch_counts[mm_name]
        got = tw.trisolve_waves_apply_mm(plan, B)
        assert _build.launch_counts[mm_name] == before + (
            -(-k // 8) if mode == "chain" else k)
        assert_solve_close(got, tw.mm_forward_plain(plan, B))


def test_trisolve_chain_256_waves(dev):
    """n = 262144: 2048 tiles, 256 waves, far more steps than the card
    holds blocks at once."""
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    n = 262144
    sp = triangular(n, 2, 120, False, True, seed=5)
    plan = tw.trisolve_waves_plan(CSR.from_scipy(sp, device=dev))
    assert plan.mode == "chain" and plan.n_waves == 256
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(n).astype(
        np.float32)).to(dev)
    got = tw.trisolve_waves_apply(plan, b)
    assert_solve_close(got, tw.waves_forward_plain(plan, b))
    B = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, 8)).astype(np.float32)).to(dev)
    assert_solve_close(tw.trisolve_waves_apply_mm(plan, B),
                       tw.mm_forward_plain(plan, B))


def _chain_plan(dev, n, K, lower=True, seed=0, **kw):
    """A banded factor whose tile reach is K, and its chain plan."""
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    band = {1: 100, 2: 200, 3: 380}[K]
    sp = triangular(n, 4, band, False, lower, seed=seed or n)
    plan = tw.trisolve_waves_plan(CSR.from_scipy(sp, device=dev),
                                  lower=lower, **kw)
    assert plan.mode == "chain" and plan.K == K
    return sp, plan


def _chain_rhs(dev, n, R, seed):
    shape = (n,) if R == 1 else (n, R)
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dev)


def _chain_solve(plan, b):
    """One solve (R = 1) or one pane (R = 8) through the public wrappers,
    its launch counted, against the plain version."""
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    name = "trisolve_chain" if b.dim() == 1 else "trisolve_chain_mm"
    apply_, plain = ((tw.trisolve_waves_apply, tw.waves_forward_plain)
                     if b.dim() == 1 else
                     (tw.trisolve_waves_apply_mm, tw.mm_forward_plain))
    before = _build.launch_counts[name]
    got = apply_(plan, b)
    assert _build.launch_counts[name] == before + 1
    assert_solve_close(got, plain(plan, b))
    return got


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_trisolve_chain_cluster(dev, K, R):
    """K = 1-3 at one and eight right-hand sides: one launch a solve or
    a pane, against the plain version and the fp64 oracle, and the same
    bits from a second solve (a fixed summation order, no atomics)."""
    n = 3000 + 100 * K
    sp, plan = _chain_plan(dev, n, K)
    b = _chain_rhs(dev, n, R, K)
    got = _chain_solve(plan, b)
    assert torch.equal(got, _chain_solve(plan, b))
    b64 = b.cpu().numpy()
    want = (tri_oracle(sp, b64) if R == 1 else np.stack(
        [tri_oracle(sp, b64[:, j]) for j in range(R)], 1))
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3,
                               atol=1e-3)


@pytest.mark.parametrize("case", ["S=8", "bf16", "reversed", "bf16-reversed"])
def test_trisolve_chain_cluster_plans(dev, case):
    """The smallest plan (one wave, S = 8 tiles, n not a multiple of 128),
    a bf16 plan and an upper (reversed) plan, at R = 1 and R = 8."""
    kw = dict(dtype=torch.bfloat16) if "bf16" in case else {}
    n = 1000 if case == "S=8" else 2100
    sp, plan = _chain_plan(dev, n, 2 if n > 1024 else 1,
                           lower="reversed" not in case, **kw)
    assert plan.reversed == ("reversed" in case)
    if case == "S=8":
        assert plan.S == 8
    for R in (1, 8):
        b = _chain_rhs(dev, n, R, R)
        assert torch.equal(_chain_solve(plan, b), _chain_solve(plan, b))


def test_trisolve_chain_band_2048_tiles(dev):
    """A K = 3 band at n = 262144 (2048 tiles, chip_smoke.py's band): one
    launch for 2048 dependent steps, R = 1 and R = 8."""
    sp = triangular(262144, 3, 380, seed=5)
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    plan = tw.trisolve_waves_plan(CSR.from_scipy(sp, device=dev))
    assert plan.mode == "chain" and plan.K == 3 and plan.S == 2048
    for R in (1, 8):
        b = _chain_rhs(dev, 262144, R, 40 + R)
        assert torch.equal(_chain_solve(plan, b), _chain_solve(plan, b))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("R", [1, 8])
def test_trisolve_chain_knobs(dev, R, K):
    """Every cluster size and every ring depth that fits, fp32 and bf16
    planes: x as the plain version, twice the same bits.  The ablations
    run (their result is not x)."""
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    n = 2600
    for kw in ({}, dict(dtype=torch.bfloat16)):
        _, plan = _chain_plan(dev, n, K, **kw)
        S = plan.S
        b = torch.randn(S * R * 128, device=dev)
        want = tw._chain_plain(plan.a1, plan.a2, b.reshape(S, R, 128), S,
                               K).reshape(-1)
        for cluster in (2, 4, 8, 16):
            for stages in (0, 1, 2, 3, 4):
                try:
                    got = tw._chain_cuda(plan, b, R, cluster=cluster,
                                         stages=stages)
                except RuntimeError:
                    # a ring deeper than the block's shared memory
                    assert stages > 1 and cluster <= 4
                    continue
                assert_solve_close(got, want)
                assert torch.equal(got, tw._chain_cuda(
                    plan, b, R, cluster=cluster, stages=stages))
        for parts in (1, 2):
            assert tw._chain_cuda(plan, b, R, parts=parts).shape == b.shape
    torch.cuda.synchronize()


@pytest.mark.parametrize("R", [1, 8])
def test_trisolve_chain_beside_a_busy_stream(dev, R):
    """The chain's grid is its one cluster, so it waits on no block that
    may not be resident: it finishes, with the same bits, while another
    stream keeps the card's SMs busy with products."""
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    _, plan = _chain_plan(dev, 3200, 2)
    b = torch.randn(plan.S * R * 128, device=dev)
    want = tw._chain_cuda(plan, b, R)
    M = torch.randn(4096, 4096, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(8):
            M = M @ M / 64.0
    got = [tw._chain_cuda(plan, b, R) for _ in range(4)]
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("name", ["sector_mask", "superblock_walk",
                                  "octet_walk"])
def test_value_write_reaches_kernel(dev, name):
    """Rows 7, 9 and 15 after an in-place write of a nonzero into an
    all-zero sector (row 7's mask), a padding slab (row 9's group_real)
    or an all-zero slab (row 15's walk), made after a first call built
    those structures: y follows the write as the plain version does."""
    from test_torch_caches import CASES

    _, _, pack, cell, plain = CASES[name]
    kern = {"sector_mask": spmv_sell_rowlane,
            "superblock_walk": spmv_superblock,
            "octet_walk": spmv_octet}[name]
    P = pack(dev)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        P.shape[1]).astype(np.float32)).to(dev)
    before = kern(P, x)
    assert_kernel_close(before, plain(P, x))
    g, row, lane = cell(P)
    P.vals[g, row, lane] = 500.0
    want = plain(P, x)
    assert not torch.equal(want, before)
    assert_kernel_close(kern(P, x), want)


def _binv_card(dev, sp, **kw):
    """The binv kernel on ``sp`` (lower) against its plain version and
    the fp64 oracle, one launch."""
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    plan = tw.trisolve_waves_plan(CSR.from_scipy(sp, device=dev),
                                  mode="binv", **kw)
    n = sp.shape[0]
    b = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    before = _build.launch_counts["trisolve_binv"]
    got = tw.trisolve_waves_apply(plan, bd)
    assert _build.launch_counts["trisolve_binv"] == before + 1
    assert_solve_close(got, tw.waves_forward_plain(plan, bd))
    np.testing.assert_allclose(got.cpu().numpy(), tri_oracle(sp, b),
                               rtol=2e-3, atol=1e-3)
    return plan


def test_trisolve_binv_256_waves(dev):
    """The scattered factor at n = 262144, m = 8: 256 waves, some 15 000
    work items, far more than the card holds blocks at once."""
    from sparsematrix_tpu_torch.utils.testutils import scattered_lower

    sp, _ = scattered_lower(262144)
    plan = _binv_card(dev, sp, m=8)
    assert plan.n_waves == 256


def test_trisolve_binv_empty_waves(dev):
    """Waves 2, 3 and 5 (m = 1) hold no cross-wave entry: their groups are
    all padding and their products wait on no gather."""
    import scipy.sparse as sps

    sp = triangular(1200, 4, band=300, seed=9).tocoo()
    wave = sp.row // 128
    keep = ~np.isin(wave, (2, 3, 5)) | (sp.col // 128 == wave)
    _binv_card(dev, sps.csr_matrix(
        (sp.data[keep], (sp.row[keep], sp.col[keep])), shape=sp.shape), m=1)


# (n, per_row, band, unit, lower, plan arguments)
FUSED_CARD = [
    (1000, 4, None, False, True, dict()),
    (1300, 4, 200, True, False, dict()),
    (3000, 3, None, False, False, dict(group=2)),
    (1100, 4, 300, False, True, dict(dtype=torch.bfloat16)),
    (1500, 4, None, False, True, dict(level_sort=False)),
]


@pytest.mark.parametrize("case", FUSED_CARD, ids=lambda c: f"n{c[0]}-"
                         f"{'L' if c[4] else 'U'}-{c[5]}")
def test_trisolve_fused_kernel(dev, case):
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf

    n, per_row, band, unit, lower, kw = case
    sp = triangular(n, per_row, band, unit, lower, seed=n + 3)
    plan = tf.trisolve_fused_plan(CSR.from_scipy(sp, device=dev),
                                  lower=lower, unit_diagonal=unit, **kw)
    b = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    before = _build.launch_counts["trisolve_fused"]
    got = tf.trisolve_fused_apply(plan, bd)
    assert _build.launch_counts["trisolve_fused"] == before + 1
    assert_solve_close(got, tf.fused_forward_plain(plan, bd))
    if "dtype" not in kw:
        np.testing.assert_allclose(got.cpu().numpy(),
                                   tri_oracle(sp, b, lower, unit),
                                   rtol=2e-3, atol=1e-3)


def _poisson_ic0_card(dev, side):
    from sparsematrix_tpu_torch.ops import ic0
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    _, sp = poisson2d(side * side)
    return ic0(CSR.from_scipy(sp.astype(np.float32).tocsr(), device=dev))


def _fused_twice(plan, bd, **knobs):
    """Two launches of the fused kernel on one b: both results."""
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf

    out = []
    for _ in range(2):
        before = _build.launch_counts["trisolve_fused"]
        if knobs:
            binv = torch.nn.functional.pad(
                plan.inv_diag * (bd if plan.perm is None
                                 else bd[plan.perm.long()]),
                (0, plan.n_win * 1024 - plan.shape[0]))
            out.append(tf._fused_cuda(plan, binv, **knobs))
        else:
            out.append(tf.trisolve_fused_apply(plan, bd))
        assert _build.launch_counts["trisolve_fused"] == before + 1
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("case", ["256-L", "256-L^T", "256-bf16", "1024-L"])
def test_trisolve_fused_poisson(dev, case):
    """Row 18's wave walk on the IC(0) factors of the 256² and 1024²
    Poisson systems (1024² takes trisolve()'s fused route): against the
    plain version and fp64, and bit-equal from call to call."""
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf

    side = int(case.split("-")[0])
    L = _poisson_ic0_card(dev, side)
    sp = L.to_scipy()
    lower = case != "256-L^T"
    if not lower:
        sp = sp.T.tocsr()
    kw = dict(dtype=torch.bfloat16) if case.endswith("bf16") else {}
    plan = tf.trisolve_fused_plan(CSR.from_scipy(sp, device=dev),
                                  lower=lower, **kw)
    assert tf.fused_walk(plan).n_waves == plan.n_levels - 1
    n = sp.shape[0]
    b = np.random.default_rng(side).standard_normal(n).astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    first, second = _fused_twice(plan, bd)
    assert torch.equal(first, second)
    assert_solve_close(first, tf.fused_forward_plain(plan, bd))
    if not kw:
        np.testing.assert_allclose(first.cpu().numpy(),
                                   tri_oracle(sp, b, lower), rtol=2e-3,
                                   atol=1e-3)


def test_trisolve_fused_route_1024(dev):
    """trisolve() sends n = 1024² to the fused engine: one launch."""
    from sparsematrix_tpu_torch.ops import trisolve

    L = _poisson_ic0_card(dev, 1024)
    b = np.random.default_rng(3).standard_normal(L.shape[0]).astype(
        np.float32)
    before = dict(_build.launch_counts)
    got = trisolve(L, torch.from_numpy(b).to(dev))
    torch.cuda.synchronize()
    assert _build.launch_counts["trisolve_fused"] == before.get(
        "trisolve_fused", 0) + 1
    np.testing.assert_allclose(got.cpu().numpy(), tri_oracle(L.to_scipy(), b),
                               rtol=2e-3, atol=1e-3)


def test_trisolve_fused_shared_tile(dev):
    """Two segments of one tile in one wave: each commits only its own
    rows."""
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf

    n = 200
    r = [1, 2, 3, 3] + list(range(n))
    c = [0, 1, 1, 2] + list(range(n))
    v = [0.5, -0.5, 0.25, 0.0] + [2.0] * n
    sp = sps.csr_matrix((np.asarray(v, np.float32), (r, c)), shape=(n, n))
    plan = tf.trisolve_fused_plan(CSR.from_scipy(sp, device=dev),
                                  level_sort=False)
    seg_wave, _ = tf.segment_waves(plan)
    assert (seg_wave == 2).sum() == 2
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    got, _ = _fused_twice(plan, bd)
    assert_solve_close(got, tf.fused_forward_plain(plan, bd))
    np.testing.assert_allclose(got.cpu().numpy(), tri_oracle(sp, b),
                               rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("lanes", [0, 1, 2, 4, 8, 16, 32])
def test_trisolve_fused_knobs(dev, lanes):
    """Every lanes a row gives the solve, the same bits from call to
    call."""
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf

    sp = triangular(3000, 6, band=700, seed=21)
    plan = tf.trisolve_fused_plan(CSR.from_scipy(sp, device=dev))
    b = np.random.default_rng(5).standard_normal(3000).astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    first, second = _fused_twice(plan, bd, lanes=lanes)
    assert torch.equal(first, second)
    want = torch.nn.functional.pad(
        tf.fused_forward_plain(plan, bd)[plan.perm.long()],
        (0, plan.n_win * 1024 - 3000))
    assert_solve_close(first, want)


def test_trisolve_fused_batched(dev):
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf

    sp = triangular(2000, 4, band=400, seed=22)
    plan = tf.trisolve_fused_plan(CSR.from_scipy(sp, device=dev))
    B = np.random.default_rng(6).standard_normal((2000, 3)).astype(
        np.float32)
    Bd = torch.from_numpy(B).to(dev)
    before = _build.launch_counts["trisolve_fused"]
    got = tf.trisolve_fused_apply_batched(plan, Bd)
    assert _build.launch_counts["trisolve_fused"] == before + 3
    want = torch.stack([tf.fused_forward_plain(plan, Bd[:, j])
                        for j in range(3)], dim=1)
    assert_solve_close(got, want)
    np.testing.assert_allclose(got.cpu().numpy(), tri_oracle(sp, B),
                               rtol=2e-3, atol=1e-3)


def test_trisolve_gradients_on_card_match_cpu(dev):
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    rng = np.random.default_rng(31)
    cases = [(triangular(1300, 4, 200, seed=1), True, False),
             (triangular(900, 4, None, True, False, seed=2), False, True)]
    for sp, lower, unit in cases:
        n = sp.shape[0]
        b = rng.standard_normal(n).astype(np.float32)
        w = rng.standard_normal(n).astype(np.float32)
        grads = {}
        for d in ("cpu", dev):
            A = CSR.from_scipy(sp, device=d)
            wp = tw.trisolve_waves_plan(A, lower=lower, unit_diagonal=unit,
                                        with_grads=True)
            fp = tf.trisolve_fused_plan(A, lower=lower, unit_diagonal=unit,
                                        with_transpose=True)
            out = []
            bt = torch.from_numpy(b).to(d).requires_grad_()
            (tw.trisolve_waves_apply(wp, bt)
             * torch.from_numpy(w).to(d)).sum().backward()
            out.append(bt.grad.cpu())
            bt = torch.from_numpy(b).to(d).requires_grad_()
            v = A.data.clone().requires_grad_()
            (tw.trisolve_waves_solve(wp, v, bt)
             * torch.from_numpy(w).to(d)).sum().backward()
            out += [bt.grad.cpu(), v.grad.cpu()]
            bt = torch.from_numpy(b).to(d).requires_grad_()
            fv = fp.vals.clone().requires_grad_()
            (tf.trisolve_fused_apply(dataclasses.replace(fp, vals=fv), bt)
             * torch.from_numpy(w).to(d)).sum().backward()
            out += [bt.grad.cpu(), fv.grad.cpu()]
            grads[str(d)] = out
        for got, want in zip(grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))


def test_solvers_on_card_match_cpu(dev):
    """cg with IC(0) wave and fused plans and block_cg with IC(0) wave
    plans on the 64×64 Poisson system: the card's iterations and solution
    agree with the CPU's, through the slice's kernels."""
    from sparsematrix_tpu_torch import (block_cg, cg, ic0_fused_plans,
                                        ic0_waves_plans, ic_apply,
                                        prepare_spmv)
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    n, Apo = poisson2d(4096)
    sp = Apo.astype(np.float32)
    rng = np.random.default_rng(8)
    b = rng.standard_normal(n).astype(np.float32)
    B = rng.standard_normal((n, 8)).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        A = CSR.from_scipy(sp, device=d)
        P = prepare_spmv(A)
        _build.launch_counts.clear()
        out = []
        for build in (ic0_waves_plans, ic0_fused_plans):
            plans = build(A)
            r = cg(P, torch.from_numpy(b).to(d), tol=1e-5, maxiter=500,
                   M=lambda v, plans=plans: ic_apply(plans, v))
            out.append((r.iters, r.x.cpu()))
        plans = ic0_waves_plans(A)
        r = block_cg(lambda V, A=A: spmm(A, V), torch.from_numpy(B).to(d),
                     tol=1e-5, maxiter=500,
                     M=lambda R: ic_apply(plans, R))
        out.append((r.iters, r.x.cpu()))
        res[str(d)] = (out, dict(_build.launch_counts))
    assert res["cpu"][1] == {}
    for kn in ("trisolve_chain", "trisolve_fused", "trisolve_chain_mm"):
        assert res["cuda"][1][kn] > 0
    for (it_g, x_g), (it_c, x_c) in zip(res["cuda"][0], res["cpu"][0]):
        assert abs(it_g - it_c) <= 2
        torch.testing.assert_close(x_g, x_c, rtol=1e-3,
                                   atol=1e-3 * float(x_c.abs().max()))


# ---------------------------------------------------------------------------
# slice 5: octet SpMM, the pooled spill tail, the SELL kernels (rows 16,
# 12, 5 and 6 of PERF.md's table), and the direct and BiCGSTAB solvers on
# the card

def _oracle_ok(got, sp, rhs, bf16):
    sp64 = sp.astype(np.float64)
    if bf16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    return relative_check(got.double().cpu().numpy(),
                          sp64 @ rhs.double().cpu().numpy())


@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("case", OCT_CARD, ids=_dg_id)
def test_octet_spmm_kernel(dev, case, k):
    from sparsematrix_tpu_torch.kernels import (spmm_octet,
                                                spmm_octet_reference)

    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + 5 * shape[1] + k)
    sp = _sparse(rng, shape, density)
    A = pack_octet(CSR.from_scipy(sp, device=dev), **kw)
    X = torch.from_numpy(rng.standard_normal((shape[1], k)).astype(
        np.float32)).to(dev)
    before = _build.launch_counts["spmm_octet"]
    got = spmm_octet(A, X)
    assert _build.launch_counts["spmm_octet"] == before + (
        2 if A.rem is not None else 1)
    assert_kernel_close(got, spmm_octet_reference(A, X))
    assert _oracle_ok(got, sp, X, kw.get("dtype") is torch.bfloat16)
    assert_kernel_close(spmm(A, X), got)  # the pack dispatch


# a deep tail (cap 16 at ~246 entries a row), the "auto" cap on
# superblocks, bf16 values, a ragged last tile and window
POOLED_CARD = [
    ((512, 4096), 0.06, dict(spill_cap=16)),
    ((700, 3000), 0.05, dict(spill_cap="auto", k_tiles=4)),
    ((256, 2048), 0.08, dict(spill_cap=8, k_tiles=2, group=4,
                             dtype=torch.bfloat16)),
    ((1100, 2100), 0.02, dict(spill_cap=8, group=4)),
]


@pytest.mark.parametrize("case", POOLED_CARD, ids=_dg_id)
def test_pooled_tail_kernel(dev, case):
    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + 11 * shape[1])
    sp = _sparse(rng, shape, density)
    A = pack_dualgather(CSR.from_scipy(sp, device=dev), **kw)
    assert A.tail is not None
    bf16 = kw.get("dtype") is torch.bfloat16
    x = torch.from_numpy(rng.standard_normal(shape[1]).astype(
        np.float32)).to(dev)
    before = _build.launch_counts["spmv_pooled"]
    got = spmv_dualgather(A, x)
    assert _build.launch_counts["spmv_pooled"] == before + 1
    assert_kernel_close(got, spmv_dualgather_reference(A, x))
    assert _oracle_ok(got, sp, x, bf16)
    if A.k_tiles > 1:  # the multi-RHS walk: the tail in one launch
        for k in (1, 33):
            X = torch.from_numpy(rng.standard_normal((shape[1], k)).astype(
                np.float32)).to(dev)
            before = _build.launch_counts["spmv_pooled"]
            Y = spmm_dualgather(A, X)
            assert _build.launch_counts["spmv_pooled"] == before + 1
            assert_kernel_close(Y, spmm_dualgather_reference(A, X))
            assert _oracle_ok(Y, sp, X, bf16)


# the pooled tail alone, on a Y that already holds a sum (the body's): a
# ragged last tile with several groups a tile, one tile of five groups, a
# tail of one group, bf16 values; every column-pass edge of k; and the
# same planes read as a matrix narrower than their chunks (cells past
# ``cols`` are dropped)
POOLED_ROWS = [
    ((1100, 2100), 0.02, dict(spill_cap=8, group=4)),
    ((120, 1000), 0.05, dict(spill_cap=4, group=8)),
    ((100, 2000), 0.1, dict(spill_cap=8, group=32)),
    ((300, 2500), 0.08, dict(spill_cap=8, dtype=torch.bfloat16)),
]


def _tail_oracle(tail, Y0, X):
    """Y0 + T @ X in fp64 from the tail's cells (row, col, value)."""
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.kernels.spmv_dualgather import (
        _slot_row_col_pooled)

    rows, cols = tail.shape
    row, col = (t.reshape(-1).cpu().numpy()
                for t in _slot_row_col_pooled(tail))
    val = tail.vals.double().reshape(-1).cpu().numpy()
    keep = (val != 0) & (row < rows) & (col < cols)
    T = sps.coo_matrix((val[keep], (row[keep], col[keep])), shape=(rows, cols))
    return Y0.double().cpu().numpy() + T.tocsr() @ X.double().cpu().numpy()


@pytest.mark.parametrize("k", [1, 3, 32, 33, 64])
@pytest.mark.parametrize("case", POOLED_ROWS, ids=_dg_id)
def test_pooled_tail_columns(dev, case, k):
    from sparsematrix_tpu_torch.kernels.spmv_dualgather import (
        launch_pooled, pooled_plain)

    shape, density, kw = case
    rng = np.random.default_rng(shape[0] + 11 * shape[1])
    sp = _sparse(rng, shape, density)
    tail = pack_dualgather(CSR.from_scipy(sp, device=dev), **kw).tail
    if kw.get("group") == 32:
        assert tail.idxB.shape[0] == 1  # a tail of one group
    if shape[0] == 120:
        assert tail.idxB.shape[0] == 5 and int(tail.group_tile.max()) == 0
    X = torch.from_numpy(rng.standard_normal((shape[1], k)).astype(
        np.float32)).to(dev)
    Y0 = torch.from_numpy(rng.standard_normal((shape[0], k)).astype(
        np.float32)).to(dev)
    narrow = dataclasses.replace(tail, shape=(shape[0], shape[1] - 37))
    for T, x in ((tail, X), (narrow, X[: shape[1] - 37].contiguous())):
        Y = Y0.clone()
        before = _build.launch_counts["spmv_pooled"]
        launch_pooled(T, x, Y)
        assert _build.launch_counts["spmv_pooled"] == before + 1
        assert_kernel_close(Y, Y0 + pooled_plain(T, x))
        assert relative_check(Y.double().cpu().numpy(), _tail_oracle(T, Y0, x))


@pytest.mark.parametrize("k_tiles", [1, 8])
def test_pooled_tail_in_spmm(dev, k_tiles):
    """A pack with a tail: the body's walk, then the tail; through
    ``spmm_dualgather`` on superblocks and ``spmv_dualgather`` on either
    (a k_tiles=1 pack with a tail serves SpMV only, as in JAX:
    ``spmm_dualgather.py:258``)."""
    rng = np.random.default_rng(4000 + k_tiles)
    sp = _sparse(rng, (1000, 3000), 0.05)
    A = pack_dualgather(CSR.from_scipy(sp, device=dev), spill_cap="auto",
                        k_tiles=k_tiles)
    assert A.tail is not None and A.k_tiles == k_tiles
    x = torch.from_numpy(rng.standard_normal(3000).astype(np.float32)).to(dev)
    before = _build.launch_counts["spmv_pooled"]
    y = spmv_dualgather(A, x)
    assert _build.launch_counts["spmv_pooled"] == before + 1
    assert_kernel_close(y, spmv_dualgather_reference(A, x))
    assert _oracle_ok(y, sp, x, False)
    if k_tiles == 1:
        with pytest.raises(ValueError, match="superblock pack"):
            spmm_dualgather(A, torch.ones((3000, 2), device=dev))
        return
    for k in (1, 32, 33):
        X = torch.from_numpy(rng.standard_normal((3000, k)).astype(
            np.float32)).to(dev)
        before = _build.launch_counts["spmv_pooled"]
        Y = spmm_dualgather(A, X)
        assert _build.launch_counts["spmv_pooled"] == before + 1
        assert_kernel_close(Y, spmm_dualgather_reference(A, X))
        assert _oracle_ok(Y, sp, X, False)


# ragged tiles and windows, every tr up to 128, a rectangular matrix
SELL_CARD = [((1100, 900), 0.02, 32), ((300, 1500), 0.05, 8),
             ((1000, 3000), 0.01, 64), ((130, 2100), 0.1, 128)]


@pytest.mark.parametrize("case", SELL_CARD, ids=lambda c: f"{c[0]}-tr{c[2]}")
def test_sell_kernel(dev, case):
    from sparsematrix_tpu_torch.kernels import (pack_sell, spmv_sell,
                                                spmv_sell_reference)

    shape, density, tr = case
    rng = np.random.default_rng(shape[0] + 13 * shape[1])
    _spmv_case(dev, _sparse(rng, shape, density), pack_sell, spmv_sell,
               spmv_sell_reference, "spmv_sell", tr=tr)


@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_sell_rowpure_kernel(dev, R):
    from sparsematrix_tpu_torch.kernels import (pack_sell_rowpure,
                                                spmv_sell_rowpure,
                                                spmv_sell_rowpure_reference)

    rng = np.random.default_rng(30 + R)
    _spmv_case(dev, _sparse(rng, (1100, 2100), 0.03), pack_sell_rowpure,
               spmv_sell_rowpure, spmv_sell_rowpure_reference,
               "spmv_sell_rowpure", group=3, rows_per_sublane=R)


def _rowpure_shape(R, name):
    """A dense matrix for the row-pure edge cases: ``empty-tiles`` (tiles
    1-2 and the last one hold nothing, tile 0 is dense in every third
    column: a tile of many groups), ``single-tile`` (8R - 3 rows) and
    ``ragged`` (rows and columns not multiples of 8R or 1024)."""
    rng = np.random.default_rng(50 + R)
    if name == "single-tile":
        return gen_random_dense_sparse(rng, 8 * R - 3, 2500, density=0.05)
    rows = 8 * R * 6 + 5
    d = gen_random_dense_sparse(rng, rows, 3000 if name == "empty-tiles"
                                else 1500, density=0.01)
    if name == "empty-tiles":
        d[8 * R:24 * R] = 0
        d[-8 * R - 5:] = 0
        d[:8 * R, ::3] = rng.uniform(-1000, 1000, (8 * R, 1000))
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["empty-tiles", "single-tile", "ragged"])
@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_sell_rowpure_kernel_shapes(dev, R, name, dtype):
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.kernels import (pack_sell_rowpure,
                                                spmv_sell_rowpure,
                                                spmv_sell_rowpure_reference)

    d = _rowpure_shape(R, name)
    P = pack_sell_rowpure(CSR.fromdense(d, device=dev), group=2,
                          rows_per_sublane=R)
    P = dataclasses.replace(P, vals=P.vals.to(dtype))
    x = torch.from_numpy(np.random.default_rng(R).standard_normal(
        d.shape[1]).astype(np.float32)).to(dev)
    before = _build.launch_counts["spmv_sell_rowpure"]
    got = spmv_sell_rowpure(P, x)
    assert _build.launch_counts["spmv_sell_rowpure"] == before + 1
    assert_kernel_close(got, spmv_sell_rowpure_reference(P, x))
    sp64 = sps.csr_matrix(d).astype(np.float64)
    if dtype == torch.bfloat16:
        sp64.data = torch.from_numpy(sp64.data).to(dtype).double().numpy()
        assert quantized_check(got.double().cpu().numpy(),
                               sp64 @ x.double().cpu().numpy())
    else:
        assert relative_check(got.double().cpu().numpy(),
                              sp64 @ x.double().cpu().numpy())


def test_rowlane_legacy_sell_tail_kernel(dev):
    """A rowlane pack whose spill tail is a masked-slab ``SellSpmv``: the
    body on the rowlane kernel, the tail on the SELL kernel."""
    from sparsematrix_tpu_torch.kernels import pack_sell

    rng = np.random.default_rng(23)
    d = gen_random_dense_sparse(rng, 600, 1700, density=0.01)
    d[[3, 200, 599], :] = rng.uniform(-1000, 1000, (3, 1700))
    import scipy.sparse as sps

    A = pack_sell_rowlane(CSR.fromdense(d, device=dev), spill_depth=1)
    A = dataclasses.replace(A, spill_packed=pack_sell(A.spill, tr=32))
    x = torch.from_numpy(rng.standard_normal(1700).astype(np.float32)).to(dev)
    before = (_build.launch_counts["spmv_rowlane"],
              _build.launch_counts["spmv_sell"])
    got = spmv_sell_rowlane(A, x)
    assert (_build.launch_counts["spmv_rowlane"],
            _build.launch_counts["spmv_sell"]) == (before[0] + 1,
                                                   before[1] + 1)
    assert_kernel_close(got, spmv_sell_rowlane_reference(A, x))
    assert _oracle_ok(got, sps.csr_matrix(d), x, False)


def test_slice5_gradients_on_card_match_cpu(dev):
    """The VJPs of spmm_octet (X and both sections' values), of a pack
    with a pooled tail (x and the tail's values) and of the row-pure SELL
    (x and values) give the same gradients on the card as on the CPU."""
    from sparsematrix_tpu_torch.kernels import (pack_sell_rowpure,
                                                spmm_octet,
                                                spmv_sell_rowpure)

    rng = np.random.default_rng(24)
    sp_o = _sparse(rng, (3000, 5000), 0.0005)
    sp_d = _sparse(rng, (256, 2048), 0.08)
    Xo = rng.standard_normal((5000, 4)).astype(np.float32)
    xd = rng.standard_normal(2048).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        out = []
        O = pack_octet(CSR.from_scipy(sp_o, device=d), group=32,
                       k_octets=4, trim_group=8)
        v, rv = (O.vals.clone().requires_grad_(),
                 O.rem.vals.clone().requires_grad_())
        X = torch.from_numpy(Xo).to(d).requires_grad_()
        spmm_octet(dataclasses.replace(
            O, vals=v, rem=dataclasses.replace(O.rem, vals=rv)), X).sum(
        ).backward()
        out += [X.grad.cpu(), v.grad.cpu(), rv.grad.cpu()]
        D = pack_dualgather(CSR.from_scipy(sp_d, device=d), spill_cap=8,
                            k_tiles=2, group=4)
        tv = D.tail.vals.clone().requires_grad_()
        x = torch.from_numpy(xd).to(d).requires_grad_()
        spmv_dualgather(dataclasses.replace(
            D, tail=dataclasses.replace(D.tail, vals=tv)), x).sum().backward()
        out += [x.grad.cpu(), tv.grad.cpu()]
        R = pack_sell_rowpure(CSR.from_scipy(sp_d, device=d), group=2,
                              rows_per_sublane=4)
        rvals = R.vals.clone().requires_grad_()
        x2 = torch.from_numpy(xd).to(d).requires_grad_()
        spmv_sell_rowpure(dataclasses.replace(R, vals=rvals), x2).sum(
        ).backward()
        out += [x2.grad.cpu(), rvals.grad.cpu()]
        grads[str(d)] = out
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def _convection(side):
    """The unsymmetric convection system of ``test_torch_solvers.py``."""
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    n, sp = poisson2d(side * side)
    sp = sp + 0.5 * sps.kron(sps.eye(side), sps.diags(
        [-1.0, 1.0], [-1, 1], (side, side)))
    return sp.tocsr().astype(np.float32)


@pytest.mark.parametrize("panel", [False, True])
@pytest.mark.parametrize("engine", ["waves", "fused"])
def test_splu_solve_on_card(dev, engine, panel):
    """``splu_solve`` with each engine, a vector and a panel ``b``: the
    card's solution equals the CPU's (its plain solves; 1e-4 of the
    scale) and fp64 ``numpy.linalg.solve`` (``relative_check``), through
    the engine's kernels."""
    from sparsematrix_tpu_torch import splu_plans, splu_solve

    sp = _convection(32)
    rng = np.random.default_rng(25)
    b = rng.standard_normal((1024, 9) if panel else 1024).astype(np.float32)
    xs = {}
    for d in ("cpu", dev):
        solver = splu_plans(CSR.from_scipy(sp, device=d), engine=engine)
        _build.launch_counts.clear()
        xs[str(d)] = splu_solve(solver, torch.from_numpy(b).to(d))
        counts = dict(_build.launch_counts)
    names = (("trisolve_fused",) if engine == "fused" else
             ("trisolve_chain_mm", "trisolve_binv") if panel else
             ("trisolve_chain", "trisolve_binv"))
    assert any(counts.get(kn, 0) > 0 for kn in names), counts
    assert_solve_close(xs["cuda"], xs["cpu"].to(dev))
    want = np.linalg.solve(sp.toarray().astype(np.float64), b)
    assert relative_check(xs["cuda"].double().cpu().numpy(), want)


def test_bicgstab_on_card(dev):
    """``bicgstab`` with ILU(0) wave plans on the convection system: the
    card reaches tol in the CPU's iterations (±2), with a true fp64
    residual within 10·tol·‖b‖."""
    from sparsematrix_tpu_torch import (bicgstab, ilu0_waves_plans,
                                        ilu_apply, prepare_spmv)

    sp = _convection(32)
    b = np.random.default_rng(8).standard_normal(1024).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        A = CSR.from_scipy(sp, device=d)
        plans = ilu0_waves_plans(A)
        _build.launch_counts.clear()
        r = bicgstab(prepare_spmv(A), torch.from_numpy(b).to(d), tol=1e-5,
                     maxiter=2000, M=lambda v, plans=plans: ilu_apply(plans,
                                                                       v))
        res[str(d)] = (r, dict(_build.launch_counts))
    (rg, cg_counts), (rc, _) = res["cuda"], res["cpu"]
    assert cg_counts.get("trisolve_chain", 0) > 0
    assert abs(int(rg.iters) - int(rc.iters)) <= 2
    x = rg.x.double().cpu().numpy()
    assert (np.linalg.norm(sp.astype(np.float64) @ x - b)
            <= 10 * 1e-5 * np.linalg.norm(b))


# -- slice 6: BSR --------------------------------------------------------------

def _bsr_case(seed, shape, block, density, device, capacity=None,
              empty_row=None, M=None):
    """``(dense, BSR)``: dense blocks at ``density`` of the block slots
    (the bench's law), ragged edges cut; ``M`` puts M blocks in block-row
    0 (the other rows stay as drawn)."""
    from sparsematrix_tpu_torch.formats import csr_to_bsr

    rng = np.random.default_rng(seed)
    bm, bn = block
    nbr, nbc = -(-shape[0] // bm), -(-shape[1] // bn)
    mask = rng.random((nbr, nbc)) < density
    if M is not None:
        mask[0] = False
        mask[0, :M] = True
    if empty_row is not None:
        mask[empty_row] = False
    dense = (np.kron(mask, np.ones(block)).astype(np.float32)
             * gen_matrix_random(rng, nbr * bm, nbc * bn, -5, 5))
    dense = np.ascontiguousarray(dense[: shape[0], : shape[1]])
    return dense, csr_to_bsr(CSR.fromdense(dense, device=device), block,
                             block_capacity=capacity)


BSR_CARD = [
    # (shape, block, density, capacity, empty block-row, M)
    ((256, 256), (4, 4), 0.1, None, None, None),
    ((2048, 2048), (8, 8), 0.05, None, None, None),
    ((1000, 777), (8, 8), 0.05, 9000, 3, None),   # ragged, padding, empty row
    ((512, 1024), (8, 128), 0.3, None, 2, None),
    ((512, 512), (128, 128), 0.4, 40, 1, None),
    ((300, 500), (6, 10), 0.2, None, 0, None),    # odd blocks: grouped
    ((64, 8 * 64), (8, 8), 0.0, None, None, 64),  # M = 64: still panels
    ((64, 8 * 65), (8, 8), 0.0, None, None, 65),  # M = 65: grouped
    ((64, 512), (8, 8), 0.0, None, None, 1),      # M = 1
]


def _bsr_id(c):
    return (f"{c[0][0]}x{c[0][1]}-b{c[1][0]}x{c[1][1]}"
            + (f"-cap{c[3]}" if c[3] else "") + (f"-M{c[5]}" if c[5] else ""))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BSR_CARD, ids=_bsr_id)
def test_bsr_kernels(dev, case, dtype):
    """Rows 3 and 4 against their plain versions on the same CUDA tensors
    (both kernels on every case, the panel kernel on the case's panel
    pack), and ``spmm_bsr``'s own route against fp64."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    shape, block, density, capacity, empty, M = case
    dense, A = _bsr_case(sum(shape), shape, block, density, dev, capacity,
                         empty, M)
    A = A.astype(dtype)
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(1),
                                           shape[1], 33)).to(dev, dtype)
    _build.launch_counts.clear()
    assert_kernel_close(kb._spmm_bsr_cuda(A, X),
                        kb.spmm_bsr_grouped_reference(A, X))
    P = kb.pack_bsr_panels(A)
    assert_kernel_close(kb._spmm_bsr_panel_cuda(P, X),
                        kb.spmm_bsr_panel_reference(P, X))
    assert _build.launch_counts["spmm_bsr"] == 1
    assert _build.launch_counts["spmm_bsr_panel"] == 1
    _build.launch_counts.clear()
    Y = kb.spmm_bsr(A, X)
    panel = kb.panel_route(A) is not None
    assert _build.launch_counts["spmm_bsr_panel" if panel else "spmm_bsr"] == 1
    if M is not None:
        assert panel == (M <= 64)
    want = dense.astype(np.float64) @ X.double().cpu().numpy()
    check = quantized_check if dtype == torch.bfloat16 else relative_check
    assert check(Y.double().cpu().numpy(), want)
    if empty is not None:
        bm = block[0]
        assert float(Y[empty * bm: (empty + 1) * bm].abs().max()) == 0.0


@pytest.mark.parametrize("design", ["", "narrow", "wide"])
@pytest.mark.parametrize("k", [1, 8, 13, 32, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_panel_designs(dev, dtype, k, design):
    """Row 4 in each design (and the rule's) at widths of X from 1 to 129,
    on a BSR with an empty block-row, a ragged last block-row and X rows
    past ncols (777 columns: the last block-column's last rows): against
    the plain version and fp64, and bit-equal from call to call."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    dense, A = _bsr_case(11, (1000, 777), (8, 8), 0.05, dev, 9000, 3)
    A = A.astype(dtype)
    P = kb.pack_bsr_panels(A)
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(k), 777,
                                           k)).to(dev, dtype)
    _build.launch_counts.clear()
    Y = kb._spmm_bsr_panel_cuda(P, X, design=design)
    assert _build.launch_counts["spmm_bsr_panel"] == 1
    assert_kernel_close(Y, kb.spmm_bsr_panel_reference(P, X))
    assert torch.equal(Y, kb._spmm_bsr_panel_cuda(P, X, design=design))
    assert float(Y[24:32].abs().max()) == 0.0  # block-row 3
    want = dense.astype(np.float64) @ X.double().cpu().numpy()
    check = quantized_check if dtype == torch.bfloat16 else relative_check
    assert check(Y.double().cpu().numpy(), want)


@pytest.mark.parametrize("design", ["narrow", "wide"])
def test_bsr_panel_nan_past_last_slot(dev, design):
    """Row 4 walks a block-row's slots up to its last nonzero one
    (``panel_counts``): an inf or NaN of X under the padding slots past it
    (block-column 0, which no stored block names here) gives a finite Y on
    the card, where the plain version gives NaN."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    dense, A = _bsr_case(12, (512, 512), (8, 8), 0.05, dev)
    dense[:, :8] = 0
    from sparsematrix_tpu_torch.formats import csr_to_bsr
    A = csr_to_bsr(CSR.fromdense(dense, device=dev), (8, 8))
    P = kb.pack_bsr_panels(A)
    assert int(kb.panel_counts(P).min()) < P.bcols.shape[1]  # padding
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(13), 512,
                                           40)).to(dev)
    want = kb._spmm_bsr_panel_cuda(P, X, design=design)
    X[:8] = float("nan")
    assert not bool(torch.isfinite(kb.spmm_bsr_panel_reference(P, X)).all())
    got = kb._spmm_bsr_panel_cuda(P, X, design=design)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (block, M, k): rows an item 8 (two row chunks at bm = 16), 4 (bm = 3), 2
# and 1; stages of fewer slots than M; a grid that walks several items a
# warp (k = 1024 over 512 block-rows)
PANEL_SHAPES = [((16, 8), 20, 40), ((3, 16), 30, 64), ((2, 8), 64, 36),
                ((1, 32), 40, 33), ((32, 32), 3, 96), ((8, 8), 64, 130),
                ((8, 8), 6, 1024)]


@pytest.mark.parametrize("design", ["narrow", "wide"])
@pytest.mark.parametrize("shape", PANEL_SHAPES,
                         ids=lambda c: f"b{c[0][0]}x{c[0][1]}-M{c[1]}-k{c[2]}")
def test_bsr_panel_shapes(dev, shape, design):
    """Row 4 in both designs over block shapes that give the wide walk
    other rows an item, stages and grids, against the plain version."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    block, M, k = shape
    nbr = 4096 // block[0] if k == 1024 else 64
    dense, A = _bsr_case(sum(block) + M, (nbr * block[0] - 1, 8 * block[1] * M),
                         block, 0.1, dev, M=M)
    P = kb.pack_bsr_panels(A)
    assert P.bcols.shape[1] >= M
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(M),
                                           A.shape[1], k)).to(dev)
    Y = kb._spmm_bsr_panel_cuda(P, X, design=design)
    assert_kernel_close(Y, kb.spmm_bsr_panel_reference(P, X))
    assert relative_check(Y.double().cpu().numpy(),
                          dense.astype(np.float64) @ X.double().cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 33, 128, 129, 256])
@pytest.mark.parametrize("block", [(128, 128), (64, 64), (32, 128)],
                         ids=lambda b: f"b{b[0]}x{b[1]}")
def test_bsr_tile_design(dev, block, k, dtype):
    """Row 3's tile design on a BSR with a ragged last block-row, an empty
    block-row, capacity padding and X rows past ncols, at the plan's split
    and at splits 1 and 2 (every block a chunk: partials summed by the
    second kernel) and 1000 (no split): against the plain version and
    fp64, bit-equal from call to call."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    bm, bn = block
    shape = (5 * bm - 3, 6 * bn - 5)
    dense, A = _bsr_case(sum(block) + k, shape, block, 0.5, dev, None, 1)
    _, A = _bsr_case(sum(block) + k, shape, block, 0.5, dev,
                     A.num_blocks + 7, 1)
    A = A.astype(dtype)
    assert kb.grouped_design(A) == "tile"
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(k),
                                           shape[1], k)).to(dev, dtype)
    want = kb.spmm_bsr_grouped_reference(A, X)
    check = quantized_check if dtype == torch.bfloat16 else relative_check
    want64 = dense.astype(np.float64) @ X.double().cpu().numpy()
    for split in (0, 1, 2, 1000):
        _build.launch_counts.clear()
        Y = kb._spmm_bsr_cuda(A, X, split=split)
        assert _build.launch_counts["spmm_bsr"] == 1
        assert_kernel_close(Y, want)
        assert check(Y.double().cpu().numpy(), want64)
        assert float(Y[bm: 2 * bm].abs().max()) == 0.0
        assert torch.equal(Y, kb._spmm_bsr_cuda(A, X, split=split)), split
    assert_kernel_close(kb._spmm_bsr_cuda(A, X, design="skeleton"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [33, 129])
def test_bsr_tile_knobs(dev, k, dtype):
    """Row 3's measurement knobs on the 128-row tiles: every ring and both
    tile widths give the product (against the plain version, bit-equal
    from call to call); the ablations (the tiles alone, the sums alone)
    launch."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    block = (128, 128)
    shape = (5 * 128 - 3, 6 * 128 - 5)
    _, A = _bsr_case(256 + k, shape, block, 0.5, dev, None, 1)
    A = A.astype(dtype)
    X = torch.from_numpy(gen_matrix_random(np.random.default_rng(k),
                                           shape[1], k)).to(dev, dtype)
    want = kb.spmm_bsr_grouped_reference(A, X)
    for kw in [dict(ring=r) for r in kb.TILE_RINGS] + [
            dict(tc=64), dict(tc=128), dict(tc=64, split=1000)]:
        Y = kb._spmm_bsr_cuda(A, X, **kw)
        assert_kernel_close(Y, want)
        assert torch.equal(Y, kb._spmm_bsr_cuda(A, X, **kw)), kw
    for parts in (1, 2):
        _build.launch_counts.clear()
        assert kb._spmm_bsr_cuda(A, X, split=1, parts=parts).shape == want.shape
        torch.cuda.synchronize()
        assert _build.launch_counts["spmm_bsr"] == 1


def test_bsr_gradients_on_card(dev):
    """``spmm_bsr``'s backward pass on the card: fp64 ``denseᵀ @ g`` and
    ``g @ Xᵀ`` on the stored blocks, padding slots' gradients zero."""
    from sparsematrix_tpu_torch.kernels import bsr as kb

    dense, A = _bsr_case(3, (200, 150), (8, 8), 0.2, dev, capacity=400)
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.standard_normal((150, 12)).astype(np.float32)).to(
        dev).requires_grad_(True)
    g = rng.standard_normal((200, 12))
    data = A.data.clone().requires_grad_(True)
    _build.launch_counts.clear()
    kb.spmm_bsr(dataclasses.replace(A, data=data), X).backward(
        torch.from_numpy(g).float().to(dev))
    assert _build.launch_counts["spmm_bsr_panel"] == 1
    np.testing.assert_allclose(X.grad.double().cpu().numpy(), dense.T @ g,
                               rtol=1e-4, atol=1e-3)
    gx = np.zeros((25 * 8, 19 * 8))
    gx[:200, :150] = g @ X.detach().double().cpu().numpy().T
    nb = A.num_blocks
    rows = A.block_row_ids[:nb].long().cpu().numpy()
    cols = A.indices[:nb].long().cpu().numpy()
    want = gx.reshape(25, 8, 19, 8)[rows, :, cols, :]
    got = data.grad.double().cpu().numpy()
    np.testing.assert_allclose(got[:nb], want, rtol=1e-4, atol=1e-3)
    assert np.all(got[nb:] == 0)


def test_bsr_routes_on_card(dev):
    """``spmm``/``spmv``/``block_cg`` on small BSRs through the routes:
    the panel kernel, the grouped kernel, densify, the CSR route of
    ``spmv``; the card's results equal fp64, and block CG reaches tol in
    the CPU's iterations (±2)."""
    from sparsematrix_tpu_torch import block_cg, csr_to_bsr
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    dense, A = _bsr_case(5, (1024, 1024), (8, 8), 0.02, dev)
    X = gen_matrix_random(np.random.default_rng(6), 1024, 16)
    want = dense.astype(np.float64) @ X
    Xd = torch.from_numpy(X).to(dev)
    for method in ("sparse", "auto"):
        _build.launch_counts.clear()
        Y = spmm(A, Xd, method=method)
        assert _build.launch_counts["spmm_bsr_panel"] == 1, method
        assert relative_check(Y.double().cpu().numpy(), want)
    _, B = _bsr_case(7, (1024, 1024), (128, 128), 0.1, dev)
    _build.launch_counts.clear()
    spmm(B, Xd)
    assert _build.launch_counts["spmm_bsr"] == 1
    dense_c, C = _bsr_case(8, (256, 256), (8, 8), 0.3, dev)
    _build.launch_counts.clear()
    Yc = spmm(C, Xd[:256])  # densify-eligible: one dense product, no kernel
    assert sum(_build.launch_counts.values()) == 0
    assert relative_check(Yc.double().cpu().numpy(),
                          dense_c.astype(np.float64) @ X[:256])
    x = torch.from_numpy(X[:, 0].copy()).to(dev)
    _build.launch_counts.clear()
    y = spmv(A, x)
    assert sum(_build.launch_counts[kn] for kn in (
        "spmv_dualgather", "spmv_dualgather_sb", "spmv_octet")) >= 1
    assert relative_check(y.double().cpu().numpy(), want[:, 0])
    n, sp = poisson2d(4096)
    sp = sp.astype(np.float32)
    Bn = np.random.default_rng(9).standard_normal((n, 8)).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        P = csr_to_bsr(CSR.from_scipy(sp, device=d), (8, 8))
        _build.launch_counts.clear()
        res[str(d)] = block_cg(P, torch.from_numpy(Bn).to(d), tol=1e-5,
                               maxiter=2000)
    assert _build.launch_counts["spmm_bsr_panel"] > 0
    assert abs(res["cuda"].iters - res["cpu"].iters) <= 2
    Xs = res["cuda"].x.double().cpu().numpy()
    assert np.all(np.linalg.norm(sp.astype(np.float64) @ Xs - Bn, axis=0)
                  <= 10 * 1e-5 * np.linalg.norm(Bn, axis=0))


# -- slice 7: the row-lane SpMM (row 8) and the distribution layer --------

def _rowlane_mm_case(name):
    rng = np.random.default_rng(len(name))
    if name == "untouched":  # the middle row tile holds no entry
        dense = gen_random_dense_sparse(rng, 300, 1100, density=0.03)
        dense[128:256] = 0
    elif name == "wide":
        dense = gen_random_dense_sparse(rng, 130, 5000, density=0.03)
    else:
        dense = gen_random_dense_sparse(rng, 96, 1024, density=0.05)
    return dense


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 33, 70])
@pytest.mark.parametrize("name", ["small", "wide", "untouched"])
def test_rowlane_spmm_kernel(dev, name, k, vdt, xdt):
    from sparsematrix_tpu_torch.kernels import (spmm_rowlane,
                                                spmm_rowlane_reference)

    dense = _rowlane_mm_case(name)
    P = pack_sell_rowlane(CSR.fromdense(dense, device=dev), group=4,
                          dtype=vdt)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (dense.shape[1], k)).astype(np.float32)).to(dev, xdt)
    _build.launch_counts.clear()
    got = spmm_rowlane(P, X)
    assert _build.launch_counts["spmm_rowlane"] == 1
    assert_kernel_close(got, spmm_rowlane_reference(P, X))
    if name == "untouched":
        assert not bool(got[128:256].any())


def _rowlane_mm_windows(dev, vdt=torch.float32):
    """A pack of four row tiles (the second untouched) over five column
    windows, and its dense matrix."""
    rng = np.random.default_rng(21)
    dense = gen_random_dense_sparse(rng, 500, 4700, density=0.02)
    dense[128:256] = 0
    return dense, pack_sell_rowlane(CSR.fromdense(dense, device=dev),
                                    group=4, dtype=vdt)


@pytest.mark.parametrize("design", ["window", "gather"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 70])
def test_rowlane_spmm_designs(dev, k, vdt, xdt, design):
    """Row 8's window walk (the product) and the gather walk (its
    measurement variant), each forced, on a pack of several windows and
    tiles: against the plain version, fp64 (of the bf16-rounded values and
    X where they are bf16), and the untouched tile zero."""
    rmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_rowlane")
    dense, P = _rowlane_mm_windows(dev, vdt)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (dense.shape[1], k)).astype(np.float32)).to(dev, xdt)
    _build.launch_counts.clear()
    got = rmod._spmm_rowlane_cuda(P, X, design=design)
    assert _build.launch_counts["spmm_rowlane"] == 1
    assert_kernel_close(got, rmod.spmm_rowlane_reference(P, X))
    assert not bool(got[128:256].any())
    d64 = torch.from_numpy(dense).to(vdt).double().numpy()
    assert relative_check(got.double().cpu().numpy(),
                          d64 @ X.double().cpu().numpy())


@pytest.mark.parametrize("design", ["window", "gather"])
def test_rowlane_spmm_inf_under_zero_value(dev, design):
    """An inf of X under the zero values of padding slots (the X row
    padding slots name, which no stored entry names) gives the product of
    the stored entries on the card, where the plain version gives NaN."""
    rmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_rowlane")
    dense, _ = _rowlane_mm_windows(dev)
    dense[:, 1024 + 128] = 0  # window 1, sublane 1, lane 0: padding's row
    P = pack_sell_rowlane(CSR.fromdense(dense, device=dev), group=4)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (dense.shape[1], 32)).astype(np.float32)).to(dev)
    want = rmod._spmm_rowlane_cuda(P, X, design=design)
    X[1024 + 128] = float("inf")
    assert not bool(torch.isfinite(rmod.spmm_rowlane_reference(P, X)).all())
    got = rmod._spmm_rowlane_cuda(P, X, design=design)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert_kernel_close(got, want)


def test_rowlane_spmm_gather_parts(dev):
    """The gather walk's ablations launch: part 1 (no X read, the panel
    takes the value) is the product with X all ones; parts 2 and 3 store
    nothing."""
    rmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_rowlane")
    dense, P = _rowlane_mm_windows(dev)
    X = torch.randn((dense.shape[1], 40), device=dev)
    assert_kernel_close(rmod._spmm_rowlane_cuda(P, X, design="gather",
                                                parts=1),
                        rmod.spmm_rowlane_reference(P, torch.ones_like(X)))
    for part in (2, 3):
        assert not bool(rmod._spmm_rowlane_cuda(P, X, design="gather",
                                                parts=part).any())
    with pytest.raises(ValueError, match="parts"):
        rmod._spmm_rowlane_cuda(P, X, design="window", parts=1)


@pytest.fixture
def nccl_world1(dev, tmp_path):
    """A world of one rank on NCCL in this process."""
    import torch.distributed as dist

    from sparsematrix_tpu_torch.parallel import (initialize_multihost,
                                                 make_mesh)

    initialize_multihost(f"file://{tmp_path}/store", 1, 0, device=dev)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_dist_world1_on_card(dev, nccl_world1):
    """Every product path of the layer at world size 1 under NCCL against
    fp64, and the kernels each launched."""
    import sparsematrix_tpu_torch.parallel as par

    mesh = nccl_world1
    assert not mesh.staged()
    rng = np.random.default_rng(7)
    dense = gen_random_dense_sparse(rng, 700, 1300, density=0.03)
    A = CSR.fromdense(dense, device="cpu")
    x = rng.standard_normal(1300).astype(np.float32)
    X = rng.standard_normal((1300, 9)).astype(np.float32)
    y64, Y64 = dense.astype(np.float64) @ x, dense.astype(np.float64) @ X
    xd, Xd = torch.from_numpy(x).to(dev), torch.from_numpy(X).to(dev)
    rows = par.shard_partitioned(par.partition_csr_rows(A, 1), mesh)
    cols = par.shard_partitioned(par.partition_csr_cols(A, 1), mesh)
    rl = par.shard_partitioned(par.partition_rowlane(A, 1, group=4), mesh)
    dg = par.shard_partitioned(par.partition_dualgather(A, 1, group=4), mesh)
    cases = [
        (lambda: par.dist_spmv(rows, xd, mesh), y64, None),
        (lambda: par.dist_spmm(cols, Xd, mesh, reduce="psum_scatter"), Y64,
         None),
        (lambda: par.dist_spmv_rowlane(rl, xd, mesh), y64, "spmv_rowlane"),
        (lambda: par.dist_spmm_rowlane(rl, Xd, mesh), Y64, "spmm_rowlane"),
        (lambda: par.dist_spmv_dualgather(dg, xd, mesh), y64,
         "spmv_dualgather"),
        (lambda: par.dist_spmm_dualgather(dg, Xd, mesh), Y64,
         "spmm_dualgather")]
    for run, want, kernel in cases:
        _build.launch_counts.clear()
        got = run().double().cpu().numpy()[: want.shape[0]]
        assert relative_check(got, want)
        if kernel is not None:
            assert _build.launch_counts[kernel] > 0
    band = np.zeros((512, 512), np.float32)
    for off in range(-3, 4):
        i = np.arange(max(0, -off), min(512, 512 - off))
        band[i, i + off] = rng.uniform(-1000, 1000, i.size)
    B = CSR.fromdense(band, device="cpu")
    xb = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).to(dev)
    want = band.astype(np.float64) @ xb.double().cpu().numpy()
    for part, fn in ((par.partition_csr_halo_ring(B, 1, 3),
                      par.dist_spmv_halo_ring),
                     (par.partition_csr_halo_var(B, 1),
                      par.dist_spmv_halo_var)):
        got = fn(par.shard_partitioned(part, mesh), xb, mesh)
        assert relative_check(got.double().cpu().numpy(), want)


def test_dist_local_pack_follows_writes(dev, nccl_world1):
    """``dist_spmv_rowlane`` and ``dist_spmm_dualgather`` on partitions
    whose planes stay on the host (each call's local pack a cached copy
    on the card): after an in-place write into the partition's values,
    made after a first call, the product follows the write as the plain
    version does."""
    import sparsematrix_tpu_torch.parallel as par
    from sparsematrix_tpu_torch.parallel.dist_dualgather import local_dg
    from sparsematrix_tpu_torch.parallel.dist_rowlane import local_sell
    from sparsematrix_tpu_torch.parallel.mesh import Mesh

    mesh = nccl_world1
    host = Mesh(("shard",), (None,), (0,), (1,), torch.device("cpu"))
    rng = np.random.default_rng(9)
    dense = gen_random_dense_sparse(rng, 700, 1300, density=0.03)
    A = CSR.fromdense(dense, device="cpu")
    x = torch.from_numpy(rng.standard_normal(1300).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((1300, 33)).astype(np.float32))
    rl = par.partition_rowlane(A, 1, group=4)
    dg = par.partition_dualgather(A, 1, group=4)
    cases = [
        (rl, lambda: par.dist_spmv_rowlane(rl, x.to(dev), mesh),
         lambda: spmv_sell_rowlane_reference(
             local_sell(rl, par.shard_partitioned(rl, host)), x)),
        (dg, lambda: par.dist_spmm_dualgather(dg, X.to(dev), mesh),
         lambda: spmm_dualgather_reference(
             local_dg(dg, par.shard_partitioned(dg, host)), X))]
    for part, run, plain in cases:
        assert part.vals.device.type == "cpu"
        first = run()
        assert_kernel_close(first.cpu(), plain())
        nz = torch.nonzero(part.vals[0])[0]
        part.vals[(0, *nz.tolist())] += 500.0
        want = plain()
        assert not torch.equal(want, first.cpu())
        assert_kernel_close(run().cpu(), want)


def test_dist_cg_world1_on_card(dev, nccl_world1):
    """dist_cg with the block IC(0) preconditioner (one block: the wave
    kernels) reaches tol with the single-device cg's iterations (± 2)."""
    import sparsematrix_tpu_torch.parallel as par
    from sparsematrix_tpu_torch.ops import ic0_waves_plans, ic_apply
    from sparsematrix_tpu_torch.solvers import cg
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    mesh = nccl_world1
    n, sp = poisson2d(64 * 64)
    A = CSR.from_scipy(sp.astype(np.float32).tocsr(), device=dev)
    b_np = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    part = par.shard_partitioned(par.partition_csr_rows(A, 1), mesh)
    M = par.block_ic0_precond(A, 1, mesh=mesh)
    _build.launch_counts.clear()
    res = par.dist_cg(part, b, mesh, precond=M, tol=1e-5, maxiter=2000)
    assert (_build.launch_counts["trisolve_chain"]
            + _build.launch_counts["trisolve_binv"]) > 0
    plans = ic0_waves_plans(A)
    ref = cg(A, b, tol=1e-5, maxiter=2000, M=lambda r: ic_apply(plans, r))
    assert abs(res.iters - ref.iters) <= 2, (res.iters, ref.iters)
    rel = np.linalg.norm(sp @ res.x.double().cpu().numpy() - b_np) / (
        np.linalg.norm(b_np))
    assert rel < 1e-4


def test_dist_gloo_ranks_on_card(dev, tmp_path):
    """Every dist_* of the slice on 2 ranks (the rank program of the CPU
    tests with ``--device cuda``: gloo ranks sharing one card, or NCCL
    where there is a card a rank) against fp64."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "_torch_dist_ranks",
        pathlib.Path(__file__).resolve().parent / "_torch_dist_ranks.py")
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    _, rep = ranks.spawn(2, tmp_path, device="cuda", timeout=600)
    # one card: gloo, staged through the host; a card a rank: NCCL
    assert rep["staged"] == (rep["backend"] == "gloo")
    assert rep["device"].startswith("cuda")
    bad = {c: r for c, r in rep["cases"].items() if not r["ok"]}
    assert not bad, bad
    assert rep["launches"].get("spmm_rowlane", 0) > 0


# 1-15; one below and one above a 32 KB chunk (8192 fp32) and a ring of
# four; 128 MiB + 3
@pytest.mark.parametrize("n", [*range(1, 16), 4097, 8191, 8193,
                               4 * 8192 - 1, 4 * 8192 + 1, 65536 + 3,
                               1 << 22, (1 << 25) + 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_stream_copy_bit_equal(dev, n, offset):
    """Row 22 against ``x.clone()``, bit for bit, at odd lengths and at
    views that start 0-3 elements past a 16-byte boundary (the scalar
    head, the float4 body and the scalar tail)."""
    from sparsematrix_tpu_torch.kernels import stream_copy, stream_copy_reference

    base = torch.randn(n + offset, device=dev)
    base[0] = float("nan")  # NaN bits must survive the copy too
    x = base[offset:]
    before = _build.launch_counts["stream_copy"]
    y = stream_copy(x)
    torch.cuda.synchronize()
    assert _build.launch_counts["stream_copy"] == before + 1
    want = stream_copy_reference(x)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    assert y.data_ptr() % 16 == x.data_ptr() % 16


@pytest.mark.parametrize("knobs", [dict(chunk=16 * 1024),
                                   dict(chunk=64 * 1024, stages=3),
                                   dict(stages=2), dict(stages=6),
                                   dict(blocks_per_sm=2, stages=3),
                                   dict(chunk=48)])
def test_stream_copy_knobs_bit_equal(dev, knobs):
    """Every knob setting of the bulk path copies bit for bit (a 48-byte
    chunk: thousands of chunks a block)."""
    from sparsematrix_tpu_torch.kernels.stream_copy import _stream_copy_cuda

    for n, offset in ((1 << 20) + 5, 1), (4 * 16384 + 1, 0), (3, 2):
        base = torch.randn(n + offset, device=dev)
        x = base[offset:]
        y = _stream_copy_cuda(x, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(y.view(torch.int32), x.view(torch.int32))


def test_stream_copy_refuses_other_inputs(dev):
    from sparsematrix_tpu_torch.kernels import stream_copy

    with pytest.raises(ValueError):
        stream_copy(torch.zeros(8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        stream_copy(torch.zeros((4, 4), device=dev).T)
    assert stream_copy(torch.zeros(0, device=dev)).numel() == 0


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 2047, 1023), (16, 96, 64),
                                   (17, 2047, 33), (117, 2047, 1023)])
def test_int8_matmul_padding_on_card(dev, m, k, n):
    """``torch._int_mm`` wants more than 16 rows and k, n multiples of 8
    on the card: the zero padding is exact."""
    from sparsematrix_tpu_torch.ops.quantized import int8_matmul

    g = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g)
    got = int8_matmul(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().long(), a.long() @ b.long())


def test_quantized_addmatmat_on_card(dev):
    """The int8/int16 AddMatMat and the QuantDense product on the card
    against the same calls on the CPU (exact integer products; the fp32
    rescale may differ in the last bit)."""
    from sparsematrix_tpu_torch import (QuantDense, add_mat_mat_int8,
                                        add_mat_mat_int16, quantize_codebook)

    rng = np.random.default_rng(4)
    a = gen_matrix_random(rng, 117, 2047)
    idx, table = gen_sparse_index_matrix(rng, 2047, 1023, density=0.25,
                                         table_size=255)
    q_dense = gen_random_dense_sparse(rng, 64, 2047, density=0.1)
    for device in (dev, torch.device("cpu")):
        b = quantize_codebook(CodebookDense.from_index_matrix(
            idx, table, trans=True, device=device))
        a_d = torch.from_numpy(a).to(device)
        out = [add_mat_mat_int8(a_d, b).cpu(), add_mat_mat_int16(a_d, b).cpu()]
        Q = QuantDense.fromdense(q_dense, device=device)
        out.append(spmm(Q, a_d.T.contiguous()).cpu())
        if device == dev:
            on_card = out
    for got, want in zip(on_card, out):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


# -- the probes' kernels (rows 23-28) ----------------------------------------

@pytest.mark.parametrize("step", ["dma-only", "fixed-window",
                                  "slice-no-gather"])
@pytest.mark.parametrize("case", [((1100, 900), 0.02, 1),
                                  ((3000, 5000), 0.01, 8),
                                  ((2048, 2048), 0.008, 128)])
def test_probe_rowlane_kernel(dev, case, step):
    """Each body of the row-lane walk ablation against its plain version,
    ragged last tile and window, one to many slabs a group."""
    from sparsematrix_tpu_torch.kernels.probe_rowlane import (
        pad_x, probe_rowlane, probe_rowlane_reference)

    shape, density, group = case
    rng = np.random.default_rng(shape[0])
    P = pack_sell_rowlane(CSR.from_scipy(_sparse(rng, shape, density),
                                         device=dev), group=group)
    x = torch.from_numpy(rng.standard_normal(shape[1]).astype(
        np.float32)).to(dev)
    xp = pad_x(x, P.n_win)
    name = "probe_rowlane_" + step.replace("-", "_")
    before = _build.launch_counts[name]
    got = probe_rowlane(P, xp, step)
    assert _build.launch_counts[name] == before + 1
    assert got.shape == (P.n_tiles * 8, 128)
    assert_kernel_close(got, probe_rowlane_reference(P, xp, step))


def _gather_planes(rng, S, group, n_groups, wild):
    """The probe scripts' planes; ``wild`` puts bytes outside every index
    range into them (negative int8, chunk >= 8, rows outside [0, S))."""
    d = {"win": rng.integers(0, S // 8, (n_groups, group)),
         "ptr": rng.integers(0, S, (n_groups, group, 8)),
         "idxA": rng.integers(0, 8, (n_groups, group * 8, 128)),
         "idxB": rng.integers(0, 128, (n_groups, group * 8, 128)),
         "vals": rng.normal(size=(n_groups, group * 8, 128))}
    if wild:
        for key, lo, hi in (("idxA", -128, 128), ("idxB", -128, 128),
                            ("win", -2, S // 8 + 2), ("ptr", -3, S + 3)):
            m = rng.random(d[key].shape) < 0.05
            d[key] = np.where(m, rng.integers(lo, hi, d[key].shape), d[key])
    dt = {"win": np.int32, "ptr": np.int32, "idxA": np.int8, "idxB": np.int8,
          "vals": np.float32}
    return {k: torch.from_numpy(v.astype(dt[k])) for k, v in d.items()}


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("size", [(64, 8, 4), (256, 64, 16), (256, 1, 3),
                                  (64, 64, 300)])
@pytest.mark.parametrize("mode", ["single", "dual", "pooled"])
def test_probe_gather_step_kernels(dev, mode, size, wild):
    """Each gather step against its plain version, at the probe scripts'
    sizes and others, with random chunk indices and, ``wild``, indices
    outside their ranges (each adds nothing in both versions)."""
    from sparsematrix_tpu_torch.kernels import probe_gather_step as pg

    S, group, n_groups = size
    t = {k: v.to(dev) for k, v in _gather_planes(
        np.random.default_rng(S + group + n_groups), S, group, n_groups,
        wild).items()}
    t["xp"] = torch.randn((S, 128), device=dev)
    first = t["ptr"] if mode == "pooled" else t["win"]
    args = ((first, t["idxB"], t["vals"], t["xp"]) if mode == "single" else
            (first, t["idxA"], t["idxB"], t["vals"], t["xp"]))
    kern = getattr(pg, f"{mode}_step")
    plain = getattr(pg, f"{mode}_step_reference")
    before = _build.launch_counts[f"probe_gather_{mode}"]
    got = kern(*args)
    assert _build.launch_counts[f"probe_gather_{mode}"] == before + 1
    assert not got[1:].any()
    assert_kernel_close(got, plain(*args))


@pytest.mark.parametrize("shape", [(1, 1), (8, 128), (16, 128), (8, 256),
                                   (32, 128), (3, 1000), (700, 33)])
def test_probe_tile_gather_kernel(dev, shape):
    """The row gather at every tile shape, bit for bit against the plain
    version and torch.gather; out-of-range indices give 0."""
    from sparsematrix_tpu_torch.kernels.probe_tile_gather import (
        tile_gather, tile_gather_reference)

    R, C = shape
    g = torch.Generator(device=dev).manual_seed(R * C)
    tab = torch.randn((R, C), device=dev, generator=g)
    idx = torch.randint(0, C, (R, C), device=dev, generator=g,
                        dtype=torch.int32)
    before = _build.launch_counts["probe_tile_gather"]
    got = tile_gather(tab, idx)
    assert _build.launch_counts["probe_tile_gather"] == before + 1
    assert torch.equal(got, torch.gather(tab, 1, idx.long()))
    wild = idx.clone()
    wild.view(-1)[::3] = -1
    wild.view(-1)[1::5] = C
    got = tile_gather(tab, wild)
    assert torch.equal(got, tile_gather_reference(tab, wild))
    assert not got.view(-1)[::3].any()


@pytest.mark.parametrize("steps", [1, 37, 512])
@pytest.mark.parametrize("layout", ["flat", "2-D", "padded"])
def test_probe_meta_scale_kernel(dev, layout, steps):
    """The last step's scalar wins, for flat, 2-D and row-padded metadata,
    from one step to the repro's 512."""
    from sparsematrix_tpu_torch.kernels.probe_meta_scale import (
        meta_scale, meta_scale_reference)

    flat = torch.arange(steps * 6, dtype=torch.int32, device=dev)
    cols = None
    if layout == "flat":
        meta, cols = flat, 6
    elif layout == "2-D":
        meta = flat.view(steps, 6)
    else:
        meta = torch.zeros((steps, 8), dtype=torch.int32, device=dev)
        meta[:, :6] = flat.view(steps, 6)
        meta = meta[:, :6]
    x = torch.randn((8, 128), device=dev)
    before = _build.launch_counts["probe_meta_scale"]
    got = meta_scale(meta, x, cols)
    assert _build.launch_counts["probe_meta_scale"] == before + 1
    assert torch.equal(got, meta_scale_reference(meta, x, cols))
    assert torch.equal(got, x * float((steps - 1) * 6))


def test_device_trace_names_the_rowlane_kernel(dev, tmp_path):
    """``device_trace`` on the card: the trace file is written and the
    profiler holds the rowlane kernel's device time under its name."""
    from sparsematrix_tpu_torch.utils.profiling import (annotate, device_trace,
                                                       kernel_times)

    rng = np.random.default_rng(5)
    P = pack_sell_rowlane(CSR.from_scipy(_sparse(rng, (4096, 4096), 0.01),
                                         device=dev))
    x = torch.randn(4096, device=dev)
    spmv_sell_rowlane(P, x)
    torch.cuda.synchronize()
    with device_trace(str(tmp_path)) as prof:
        with annotate("rowlane call"):
            spmv_sell_rowlane(P, x)
        torch.cuda.synchronize()
    assert (tmp_path / "trace.json").exists()
    kernels = kernel_times(prof)
    hits = [v for k, v in kernels.items() if "spmv_rowlane" in k]
    assert hits and hits[0]["device_ms"] > 0, kernels


@pytest.mark.parametrize("name,small", [
    ("probe_xl_spmv", lambda m, s: m.run(
        s, *m.build(4096, 64), configs=("fp32-g128", "bf16-g32-sp4"))),
    ("probe_dualgather", lambda m, s: m.run(s, card_groups=8)),
    ("probe_sublane_slice", lambda m, s: m.run(s, card_groups=8)),
    ("repro_dynamic_gather_shapes", None),
    ("repro_smem_lane_padding", None),
    ("probe_calibrate_xcheck", lambda m, s: m.run(s, mib=4))])
def test_probe_modules_on_card(dev, tmp_path, name, small):
    """Each probe module on the card at a small size (the repros through
    their command line, at the script's size): every check passes and
    every timed row has a device time and the card."""
    import importlib
    import json

    from sparsematrix_tpu_torch.probes._common import Session

    mod = importlib.import_module(f"sparsematrix_tpu_torch.probes.{name}")
    out = tmp_path / "rows.json"
    if small is None:
        assert mod.main(["--out", str(out)]) == 0
    else:
        assert small(mod, Session(dev, str(out), quiet=True))
    rows = json.loads(out.read_text())
    assert rows and all(r["card"] and r["device"] == "cuda" for r in rows)
    assert all(r["ms"] > 0 for r in rows if "ms" in r)


# ---------------------------------------------------------------------------
# the masked-slab SELL SpMV walked in runs of one tile's slabs, and the
# superblock SpMV's own walk (a warp a run of slabs, the padding skipped)
# ---------------------------------------------------------------------------

tsell = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_sell")
tsb = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_superblock")


def _sell_dense(name, tr, seed):
    """Dense test matrices for the masked-slab runs: ``one-slab`` (tile 0
    holds a single slab), ``long-tile`` (tile 0 holds many more slabs than
    one run: its rows are dense over three windows), ``ragged`` (rows not
    a multiple of tr, columns not of 1024: the last window's cells past
    ``cols`` are padding)."""
    rng = np.random.default_rng(seed)
    rows, cols = {"one-slab": (5 * tr + 3, 2000),
                  "long-tile": (3 * tr, 3000),
                  "ragged": (4 * tr + 1, 2100)}[name]
    d = gen_random_dense_sparse(rng, rows, cols, density=0.02)
    if name == "one-slab":
        d[:tr] = 0
        d[0, 5] = 7.0
    if name == "long-tile":
        d[:tr, ::2] = rng.uniform(-1000, 1000, (tr, -(-cols // 2)))
    return d.astype(np.float32)


def _sell_check(dev, d, tr, bf16=False, **knobs):
    """The runs kernel (with ``knobs``) against the plain version on the
    same CUDA tensors and the fp64 oracle, the launch counted."""
    import scipy.sparse as sps

    P = tsell.pack_sell(CSR.fromdense(d, device=dev), tr=tr)
    if bf16:
        P = dataclasses.replace(P, vals=P.vals.to(torch.bfloat16))
    rng = np.random.default_rng(d.shape[1])
    x = torch.from_numpy(rng.standard_normal(d.shape[1]).astype(
        np.float32)).to(dev)
    before = _build.launch_counts["spmv_sell"]
    got = tsell._spmv_sell_cuda(P, x, **knobs)
    assert _build.launch_counts["spmv_sell"] == before + 1
    assert_kernel_close(got, tsell.spmv_sell_reference(P, x))
    sp64 = sps.csr_matrix(d.astype(np.float64))
    if bf16:
        sp64.data = torch.from_numpy(sp64.data).to(
            torch.bfloat16).double().numpy()
    assert relative_check(got.double().cpu().numpy(),
                          sp64 @ x.double().cpu().numpy())
    return P


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", ["one-slab", "long-tile", "ragged"])
@pytest.mark.parametrize("tr", [1, 8, 32, 64, 128])
def test_sell_runs_kernel(dev, tr, name, bf16):
    P = _sell_check(dev, _sell_dense(name, tr, tr), tr, bf16)
    st = P.slab_tile.cpu()
    if name == "one-slab":
        assert int((st == 0).sum()) == 1
    if name == "long-tile":  # blocks of 2 slabs split tile 0's slabs
        assert int((st == 0).sum()) > 2
        _sell_check(dev, _sell_dense(name, tr, tr), tr, bf16, run=2)
    if name == "ragged":
        assert P.n_win * 1024 > P.shape[1] and P.shape[0] % tr == (tr > 1)


@pytest.mark.parametrize("warps", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("run", [1, 2, "all", -3])
def test_sell_runs_knobs(dev, run, warps):
    """Forced slabs a block (1, 2 and the most: every slab in one block,
    which then walks every run; -3: runs of at most 3 slabs of one tile, a
    run a block), warps a block, unroll 4, and the ablation that reads
    every meta word: each still A @ x."""
    d = _sell_dense("long-tile", 64, 3)
    if run == "all":
        run = tsell.pack_sell(CSR.fromdense(d, device=dev),
                              tr=64).meta.shape[0]
    _sell_check(dev, d, 64, run=run, warps=warps)
    if run != -3:  # the short-run walk has no other knobs
        _sell_check(dev, d, 64, run=run, warps=warps, mode=2)
        _sell_check(dev, d, 64, run=run, warps=warps, unroll=4)


def test_sell_runs_all_zero_and_nan_x(dev):
    """An all-zero matrix (the packer's single empty slab) gives zeros; a
    NaN of x in a column no entry names stays out of y (zero values read
    no x)."""
    P = tsell.pack_sell(CSR.fromdense(np.zeros((70, 1500), np.float32),
                                      device=dev), tr=32)
    assert P.meta.shape[0] == 1
    x = torch.ones(1500, device=dev)
    before = _build.launch_counts["spmv_sell"]
    y = tsell.spmv_sell(P, x)
    assert _build.launch_counts["spmv_sell"] == before + 1
    assert torch.equal(y.cpu(), torch.zeros(70))
    d = _sell_dense("ragged", 32, 5)
    d[:, 17] = 0
    P = tsell.pack_sell(CSR.fromdense(d, device=dev), tr=32)
    x = torch.randn(d.shape[1], device=dev)
    x_nan = x.clone()
    x_nan[17] = float("nan")
    got = tsell.spmv_sell(P, x_nan)
    assert torch.isfinite(got).all()
    assert_kernel_close(got, tsell.spmv_sell_reference(P, x))


def _sb_dense(seed, rows=1100, cols=2100, deep=True):
    """Ragged rows and columns; with ``deep``, tile 1 (rows 128-255) holds
    rows dense over every other column, so its lanes run many slabs deep
    and the tile spans several slabs in each window."""
    rng = np.random.default_rng(seed)
    d = gen_random_dense_sparse(rng, rows, cols, density=0.01)
    if deep:
        d[128:256, ::2] = rng.uniform(-1000, 1000, (128, -(-cols // 2)))
    return d.astype(np.float32)


def _sb_check(dev, d, bf16=False, **kw):
    """The superblock kernel (``spw``/``mode`` in kw go to the kernel, the
    rest to the packer) against the plain version and fp64."""
    import scipy.sparse as sps

    knobs = {k: kw.pop(k) for k in ("spw", "mode") if k in kw}
    P = pack_superblock(CSR.fromdense(d, device=dev),
                        dtype=torch.bfloat16 if bf16 else None, **kw)
    rng = np.random.default_rng(d.shape[0])
    x = torch.from_numpy(rng.standard_normal(d.shape[1]).astype(
        np.float32)).to(dev)
    before = _build.launch_counts["spmv_superblock"]
    got = tsb._spmv_superblock_cuda(P, x, **knobs)
    assert _build.launch_counts["spmv_superblock"] == before + 1
    assert_kernel_close(got, spmv_superblock_reference(P, x))
    sp64 = sps.csr_matrix(d.astype(np.float64))
    if bf16:
        sp64.data = torch.from_numpy(sp64.data).to(
            torch.bfloat16).double().numpy()
    assert relative_check(got.double().cpu().numpy(),
                          sp64 @ x.double().cpu().numpy())
    return P


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("k_tiles", [1, 4, 16, 32])
def test_superblock_walk_kernel(dev, k_tiles, group):
    P = _sb_check(dev, _sb_dense(k_tiles + group), group=group,
                  k_tiles=k_tiles)
    real = tsb.group_real(P).cpu()
    if group == 1:  # no padding slab anywhere
        assert bool((real == 1).all())
    if group == 16:  # superblocks that end in padding slabs
        assert bool((real < group).any())


@pytest.mark.parametrize("spw", [1, 2, 3, 64])
@pytest.mark.parametrize("mode", [0, 2])
def test_superblock_walk_knobs(dev, spw, mode):
    """Ranges of 1-64 slabs a warp (so cuts split the deep tile, which
    its warps then add into), and the variant that still computes A @ x:
    every slab streamed."""
    _sb_check(dev, _sb_dense(7), group=4, k_tiles=4, spw=spw, mode=mode)


@pytest.mark.parametrize("case", ["bf16", "rows-past", "no-padding"])
def test_superblock_walk_shapes(dev, case):
    if case == "bf16":
        _sb_check(dev, _sb_dense(8), bf16=True, group=8, k_tiles=8)
    elif case == "rows-past":  # the last tile is 3 rows of 128
        _sb_check(dev, _sb_dense(9, rows=643, cols=900), group=2, k_tiles=2,
                  spw=1)
    else:  # every superblock's slab count a multiple of the group
        d = np.zeros((256, 1024), np.float32)
        d[np.arange(256), np.arange(256) % 128] = 1.0 + np.arange(256)
        P = _sb_check(dev, d, group=1, k_tiles=2)
        assert bool((tsb.group_real(P).cpu() == 1).all())


def test_superblock_walk_skips_nan_under_zeros(dev):
    """A NaN of x in a column no entry names stays out of y: zero slots
    read no x and the padding slabs are not read at all."""
    d = _sb_dense(10)
    d[:, [0, 128, 1024]] = 0
    P = pack_superblock(CSR.fromdense(d, device=dev), group=16, k_tiles=16)
    assert bool((tsb.group_real(P).cpu() < 16).any())
    x = torch.randn(d.shape[1], device=dev)
    x_nan = x.clone()
    x_nan[[0, 128, 1024]] = float("nan")
    got = spmv_superblock(P, x_nan)
    assert torch.isfinite(got).all()
    assert_kernel_close(got, spmv_superblock_reference(P, x))


@pytest.mark.parametrize("kw", [dict(group=16, k_tiles=16),
                                dict(group=2, k_tiles=32,
                                     dtype=torch.bfloat16)])
def test_superblock_walk_backward(dev, kw):
    """The autograd twin's gradients (x and the values) on the card
    against the CPU's."""
    d = _sb_dense(11, rows=700, cols=1500)
    x = np.random.default_rng(12).standard_normal(1500).astype(np.float32)
    grads = {}
    for where in ("cpu", dev):
        A = pack_superblock(CSR.fromdense(d, device=where), **kw)
        v = A.vals.clone().requires_grad_()
        r = torch.from_numpy(x).to(where).requires_grad_()
        (spmv_superblock(dataclasses.replace(A, vals=v), r) ** 2).sum(
        ).backward()
        grads[str(where)] = [v.grad.float().cpu(), r.grad.cpu()]
    # fp32 as the other gradient tests; bf16 value gradients are rounded
    # to bf16 on both sides, so one bf16 step (2^-8) apart at most
    tol = 1e-2 if kw.get("dtype") is torch.bfloat16 else 1e-4
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


def test_superblock_walk_in_spgemm(dev):
    """``spgemm_apply_packed_csc`` on the superblock layout against fp64,
    through the superblock kernel."""
    rng = np.random.default_rng(25)
    sa, sb = _sparse(rng, (900, 700), 0.02), _sparse(rng, (700, 1300), 0.02)
    B = CSR.from_scipy(sb, device=dev)
    pp = spgemm_plan_packed(CSR.from_scipy(sa, device=dev), B,
                            layout="superblock")
    before = _build.launch_counts["spmv_superblock"]
    ct = spgemm_apply_packed_csc(pp, B.data)
    assert _build.launch_counts["spmv_superblock"] == before + 1
    want = (sa.astype(np.float64) @ sb.astype(np.float64)).T.tocsr()
    want.sort_indices()
    assert relative_check(ct.data[: ct.nnz].double().cpu().numpy(),
                          want.data)


# -- row 7: the rowlane kernel on the warp walk (csrc/rowlane.cuh) -----------

trl = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_rowlane")


def _rl_dense(seed, rows=1100, cols=2100):
    """Ragged rows and columns, rows 512-767 empty (whole empty tiles at
    every lanes_per_row), and rows 128-255 dense over every other column,
    so that their tiles run many slabs deep and a short range cuts them."""
    rng = np.random.default_rng(seed)
    d = gen_random_dense_sparse(rng, rows, cols, density=0.01)
    d[128:256, ::2] = rng.uniform(-1000, 1000, (128, -(-cols // 2)))
    d[512:768] = 0
    return d.astype(np.float32)


def _rl_check(dev, d, bf16=False, **kw):
    """The rowlane kernel's body (``spw``/``mask``/``equal`` in kw go to the
    kernel, the rest to the packer) against the plain version and fp64."""
    import scipy.sparse as sps

    knobs = {k: kw.pop(k) for k in ("spw", "mask", "equal") if k in kw}
    P = pack_sell_rowlane(CSR.fromdense(d, device=dev),
                          dtype=torch.bfloat16 if bf16 else None, **kw)
    rng = np.random.default_rng(d.shape[0])
    x = torch.from_numpy(rng.standard_normal(d.shape[1]).astype(
        np.float32)).to(dev)
    before = _build.launch_counts["spmv_rowlane"]
    got = trl._body_cuda(P, x, **knobs)
    assert _build.launch_counts["spmv_rowlane"] == before + 1
    assert_kernel_close(got, spmv_sell_rowlane_reference(P, x))
    sp64 = sps.csr_matrix(d.astype(np.float64))
    if bf16:
        sp64.data = torch.from_numpy(sp64.data).to(
            torch.bfloat16).double().numpy()
    assert relative_check(got.double().cpu().numpy(),
                          sp64 @ x.double().cpu().numpy())
    return P


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("spw", [0, 1, 3])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_rowlane_walk_kernel(dev, L, spw, bf16):
    """Every lanes_per_row of the fold, fp32 and bf16 values, empty tiles,
    rows not a multiple of 128, the default ranges (equal ones: these
    packs are small and their deep tiles split) and short ones cut at
    tiles that cut the deep tiles (which the kernel adds into), group 8
    (group_real's skip) with the short ranges of 3."""
    kw = dict(group=8) if spw == 3 else {}
    P = _rl_check(dev, _rl_dense(10 * L + spw), bf16=bf16, lanes_per_row=L,
                  spw=spw, **kw)
    if spw:
        assert trl.rowlane_walk(P, spw)[1].numel() > 0  # a split tile


@pytest.mark.parametrize("equal", [False, True])
@pytest.mark.parametrize("spw", [0, 1, 5])
def test_rowlane_walk_equal_ranges(dev, spw, equal):
    """Equal ranges of 1 or 5 slabs (or the default), their x gathers
    issued together, and the ranges cut at tiles, at two lanes a row with
    group 4 (padding slabs walked in equal ranges, skipped in cut ones)."""
    _rl_check(dev, _rl_dense(40 + spw + equal), lanes_per_row=2, group=4,
              spw=spw, equal=equal)


@pytest.mark.parametrize("spw", [0, 2])
def test_rowlane_walk_mask_off(dev, spw):
    """The knob that reads every value word (no sector mask) gives A @ x
    too."""
    _rl_check(dev, _rl_dense(31), lanes_per_row=2, spw=spw, mask=False)


def test_rowlane_walk_skips_inf_under_zeros(dev):
    """An inf of x in a column no entry names stays out of y: zero slots
    (the padding slots name column 0 of their window's sublane) read no
    x, and the words under a clear mask bit are not loaded, in the equal
    ranges a small pack takes and in ranges cut at tiles."""
    d = _rl_dense(32)
    d[:, [0, 128, 1024]] = 0
    P = pack_sell_rowlane(CSR.fromdense(d, device=dev), group=8)
    x = torch.randn(d.shape[1], device=dev)
    x_inf = x.clone()
    x_inf[[0, 128, 1024]] = float("inf")
    # equal ranges (a small pack, by default and forced), then cuts at
    # tiles
    for kw in ({}, {"equal": True}, {"spw": 3}):
        got = trl._body_cuda(P, x_inf, **kw)
        assert torch.isfinite(got).all()
        assert_kernel_close(got, spmv_sell_rowlane_reference(P, x))


def test_rowlane_one_launch_no_zero_fill(dev):
    """The fixpoint solve's pack of a 128² Poisson ILU(0) factor (one or
    two slabs a tile, so no default range cuts a tile): the wrapper
    zero-fills nothing, and the kernel writes every row of an unzeroed y
    (here a block that held NaN just before), in one launch."""
    from sparsematrix_tpu_torch.ops import ilu0_fixpoint_plans
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    n, sp = poisson2d(16384, 1.0)
    L, _ = ilu0_fixpoint_plans(CSR.from_scipy(sp.astype(np.float32).tocsr(),
                                              device=dev), n_iters=6)
    P = L.e_packed
    x = torch.randn(n, device=dev)
    want = spmv_sell_rowlane_reference(P, x)
    spmv_sell_rowlane(P, x)  # builds the walk's side structures
    assert trl.rowlane_walk(P)[1].numel() == 0
    junk = torch.full((n,), float("nan"), device=dev)
    del junk  # the caching allocator hands this block to the next y
    before = _build.launch_counts["spmv_rowlane"]
    got = spmv_sell_rowlane(P, x)
    assert _build.launch_counts["spmv_rowlane"] == before + 1
    assert torch.isfinite(got).all()
    assert_kernel_close(got, want)


def test_rowlane_walk_refuses_misaligned_planes(dev):
    d = _rl_dense(34)
    P = pack_sell_rowlane(CSR.fromdense(d, device=dev))
    flat = torch.zeros(P.vals.numel() + 1, device=dev)
    odd = dataclasses.replace(P, vals=flat[1:].reshape(P.vals.shape))
    with pytest.raises(ValueError, match="aligned"):
        trl._body_cuda(odd, torch.zeros(d.shape[1], device=dev))


# -- row 1: the fused codebook product, every split --------------------------

@pytest.mark.parametrize("split", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mnk", [(8, 128, 256), (29, 200, 300),
                                 (117, 1023, 2047), (4096, 1023, 2047)])
def test_codebook_kernel_splits(dev, mnk, dtype, split):
    """Each split of k (its partials summed in split order by a second
    kernel), both X layouts: the plain version's product, and two calls
    bit-equal."""
    from sparsematrix_tpu_torch.kernels.codebook import _codebook_spmm_cuda

    m, n, k = mnk
    rng = np.random.default_rng(sum(mnk) + split)
    idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                         table_size=255)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True, device=dev)
    a = torch.from_numpy(gen_matrix_random(rng, m, k)).to(dev, dtype)
    for X in (a.T, a.T.contiguous()):
        want = codebook_spmm_reference(b_t.idx, b_t.val_table, X)
        before = _build.launch_counts["codebook_spmm"]
        got = _codebook_spmm_cuda(b_t.idx, b_t.val_table, X, split=split)
        again = _codebook_spmm_cuda(b_t.idx, b_t.val_table, X, split=split)
        assert _build.launch_counts["codebook_spmm"] == before + 2
        assert_kernel_close(got, want)
        assert torch.equal(got, again)


def test_codebook_kernel_default_split(dev):
    """The default split: 8 at the reference shape's 16 tiles, 1 at 4096
    columns of X (one wave of blocks on a card of 132 SMs)."""
    from sparsematrix_tpu_torch.kernels.codebook import codebook_split

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms < 128:
        pytest.skip(f"a card of {sms} SMs takes other splits")
    assert codebook_split(1023, 2047, 117, dev) == 8
    assert codebook_split(1023, 2047, 4096, dev) == 1


def test_codebook_kernel_unaligned_views(dev):
    """Views that start off 16 bytes (the kernel's copies need 16-byte
    bases) are copied first: the product is the plain version's."""
    rng = np.random.default_rng(36)
    idx, table = gen_sparse_index_matrix(rng, 300, 91, table_size=30)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True, device=dev)
    big = torch.from_numpy(gen_matrix_random(rng, 301, 41)).to(dev)
    X = big[1:]  # row-major, 41 floats past the base
    raw = torch.zeros(b_t.idx.numel() + 3, dtype=torch.uint8, device=dev)
    raw[3:] = b_t.idx.reshape(-1)
    idx_off = raw[3:].reshape(b_t.idx.shape)
    assert X.data_ptr() % 16 and idx_off.data_ptr() % 16
    assert_kernel_close(codebook_spmm(idx_off, b_t.val_table, X),
                        codebook_spmm_reference(b_t.idx, b_t.val_table, X))


def test_codebook_kernel_refuses_bad_split(dev):
    from sparsematrix_tpu_torch.kernels.codebook import _codebook_spmm_cuda

    rng = np.random.default_rng(37)
    idx, table = gen_sparse_index_matrix(rng, 64, 32)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True, device=dev)
    with pytest.raises(ValueError, match="split"):
        _codebook_spmm_cuda(b_t.idx, b_t.val_table,
                            torch.ones((64, 4), device=dev), split=3)
