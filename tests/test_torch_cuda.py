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
                                                    relative_check)

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
        out[str(d)] = add_mat_mat(torch.from_numpy(a).to(d), b_t,
                                  torch.from_numpy(c).to(d), 1.0, 1.0).cpu()
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
# (rem: a second launch), bf16 values
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
                   spmv_octet_reference, "spmv_octet",
                   n_launch=2 if "trim_group" in kw else 1, **kw)
    assert (A.rem is not None) == ("trim_group" in kw)


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
