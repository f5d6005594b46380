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


@pytest.mark.parametrize("case", ["ragged-g8-k8", "wide-g2-k32",
                                  "empty-rows", "ragged-bf16"])
def test_superblock_group_real(case):
    """The slabs the card kernel walks (``group_real``), from the JAX
    packer's planes: each group's count equals a rebuild in numpy, the
    slabs past it hold only zeros (the padding slabs among them), each
    group's walked slabs are its first ones, in order, and the walked
    slabs alone give the plain product."""
    name, kw, _ = SB_CASES[case]
    A, JA, sp = both(name)
    jp = jsb.pack_superblock(JA, **_jax_kw(kw))
    P = tsb.pack_superblock(A, **kw)
    assert_same_container(P, jp)
    real = tsb.group_real(P).numpy()
    vals = np.asarray(jp.vals.astype(jnp.float32)).reshape(
        real.size, P.group, -1)
    want = np.array([max([k + 1 for k in range(P.group) if vals[g, k].any()],
                         default=0) for g in range(real.size)])
    np.testing.assert_array_equal(real, want)
    walked = np.arange(P.group)[None, :] < real[:, None]
    assert not vals[~walked].any()
    # the skipped slabs are the padding: the pack's slabs less those of
    # the group-1 rowlane pack it regroups
    unpadded = trl.pack_sell_rowlane(A, group=1).vals.numel() // 1024
    assert (~walked).sum() == P.n_slabs - unpadded
    x = np.random.default_rng(5).standard_normal(sp.shape[1]).astype(
        np.float32)
    row, col = tsb._slot_row_col(P)
    keep = torch.from_numpy(np.repeat(walked.reshape(-1), 8)).reshape(
        row.shape[0], row.shape[1], 1) & (P.vals != 0)
    xpad = torch.zeros(P.n_win * 1024, dtype=torch.float64)
    xpad[: sp.shape[1]] = torch.from_numpy(x).double()
    y = torch.zeros(P.n_super * P.k_tiles * 128, dtype=torch.float64)
    y.index_add_(0, row[keep], P.vals.double()[keep] * xpad[col[keep]])
    want_y = tsb.spmv_superblock_reference(P, torch.from_numpy(x))
    np.testing.assert_allclose(y[: sp.shape[0]].numpy(),
                               want_y.double().numpy(), rtol=1e-5,
                               atol=1e-5 * float(want_y.abs().max()))


@pytest.mark.parametrize("spw", [1, 3, 10 ** 6])
@pytest.mark.parametrize("case", ["ragged-g8-k8", "empty-rows"])
def test_superblock_walk_covers_rows(case, spw):
    """The warp ranges the card kernel takes (``superblock_walk``), from
    the JAX packer's planes, walked by the kernel's rules in numpy into a
    y of NaN: a range stores the tiles it holds whole and the tiles no slab
    names after its own, adds into the tiles a cut splits (which the
    wrapper zeroes, and which ``split`` lists), and skips the slabs past
    ``group_real``; every row ends written once or zeroed and added, and y
    is the plain product."""
    name, kw, _ = SB_CASES[case]
    A, JA, sp = both(name)
    jp = jsb.pack_superblock(JA, **_jax_kw(kw))
    P = tsb.pack_superblock(A, **kw)
    warp_ptr, split, split_rows = (t.numpy() for t in tsb._walk_build(P,
                                                                        spw))
    tiles = tsb._slab_tiles(P).numpy()
    n, rows = tiles.size, sp.shape[0]
    assert warp_ptr[0] == 0 and warp_ptr[-1] == n
    assert (np.diff(warp_ptr) >= 0).all()
    cuts = warp_ptr[1:-1][(warp_ptr[1:-1] > 0) & (warp_ptr[1:-1] < n)]
    np.testing.assert_array_equal(
        split, np.unique(tiles[cuts][tiles[cuts - 1] == tiles[cuts]]))
    np.testing.assert_array_equal(
        split_rows, [r for t in split for r in range(t * 128, t * 128 + 128)
                     if r < rows])
    x = np.random.default_rng(6).standard_normal(sp.shape[1])
    real = np.asarray(tsb.group_real(P))
    row, col = (t.numpy().reshape(n, 8, 128) for t in tsb._slot_row_col(P))
    vals = np.asarray(jp.vals.astype(jnp.float32)).reshape(n, 8, 128)
    xpad = np.r_[x, np.zeros(P.n_win * 1024)]
    part = np.where(np.arange(n) % P.group < real[np.arange(n) // P.group],
                    1.0, 0.0)[:, None] * (vals * xpad[col]).sum(1)
    y = np.full(rows + 128, np.nan)
    writes = np.zeros(rows + 128)
    y[split_rows] = 0
    n_tiles = -(-rows // 128)
    for s0, s1 in zip(warp_ptr[:-1], warp_ptr[1:]):
        if s0 == s1:
            continue
        shared = {tiles[s0]} if s0 and tiles[s0 - 1] == tiles[s0] else set()
        if s1 < n and tiles[s1 - 1] == tiles[s1]:
            shared.add(tiles[s1])

        def put(t, v):
            if t in shared:
                y[t * 128:(t + 1) * 128] += v
            else:
                y[t * 128:(t + 1) * 128] = v
                writes[t * 128:(t + 1) * 128] += 1

        cur = tiles[s0 - 1] if s0 else -1
        acc = np.zeros(128)
        for s in range(s0, s1):
            if tiles[s] != cur:
                if s > s0:
                    put(cur, acc)
                for e in range(cur + 1, min(tiles[s], n_tiles)):
                    put(e, 0.0)
                acc, cur = np.zeros(128), tiles[s]
            acc = acc + part[s]
        put(cur, acc)
        if s1 == n:
            for e in range(cur + 1, n_tiles):
                put(e, 0.0)
    assert writes[:rows].max() <= 1 and not np.isnan(y[:rows]).any()
    want = tsb.spmv_superblock_reference(P, torch.from_numpy(
        x.astype(np.float32))).double().numpy()
    np.testing.assert_allclose(y[:rows], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("resident,want", [(10, 16), (40, 3), (88, 1)])
def test_superblock_default_spw(monkeypatch, resident, want):
    """The default slabs a warp (``default_spw``) for a card that holds
    ``resident`` warps: one wave (88 slabs over the warps), rounded up to
    whole groups of 8 where that at most doubles it."""
    monkeypatch.setattr(tsb, "_resident_warps", lambda device: resident)
    A, _, _ = both("ragged")
    P = tsb.pack_superblock(A, group=8, k_tiles=8)
    assert P.n_slabs == 88
    assert tsb.default_spw(P) == want


@pytest.mark.parametrize("case", ["ragged-L1", "wide-L2-group4", "ragged-L4",
                                  "ragged-bf16", "empty-rows"])
def test_rowlane_sector_mask(case):
    """The card walk's sector mask (``sector_mask``), from the JAX packer's
    planes: bit j of slab s's sublane u is set exactly where lanes
    8j..8j+7 of the sublane hold a nonzero value (a numpy recount), so the
    value words under a clear bit, which the walk never loads, hold only
    zeros."""
    name, kw, _ = RL_CASES[case]
    A, JA, _ = both(name)
    jp = jrl.pack_sell_rowlane(JA, **_jax_kw(kw))
    P = trl.pack_sell_rowlane(A, **kw)
    assert_same_container(P, jp)
    mask = trl.sector_mask(P)
    assert mask.dtype == torch.int16 and mask.shape == (P.n_slabs, 8)
    vals = np.asarray(jp.vals.astype(jnp.float32)).reshape(-1, 8, 16, 8)
    want = ((vals != 0).any(-1) * (1 << np.arange(16))).sum(-1)
    np.testing.assert_array_equal(mask.numpy().view(np.uint16), want)
    assert trl.sector_mask(P) is mask  # built once a pack


def _walk_emulate(P, warp_ptr, split_rows, x):
    """The card walk (``csrc/rowlane.cuh``) over a rowlane pack in numpy:
    each range walks its slabs, loads only the value words under a set
    mask bit and only the slabs up to ``group_real`` (group > 1), folds the
    L lanes of a row, stores the tiles it holds whole and the tiles no slab
    names after its own, and adds into the tiles a cut splits.  Returns y
    (NaN where nothing was written) and the count of stores a row."""
    L, rows = P.lanes_per_row, P.shape[0]
    T = 128 // L
    tiles = trl._slab_tiles(P).numpy()
    n = tiles.size
    n_tiles = -(-rows // T)
    mask = trl.sector_mask(P).numpy().view(np.uint16)
    bits = (mask[:, :, None] >> np.arange(16)) & 1  # (n, 8, 16)
    lane_on = np.repeat(bits, 8, axis=2).astype(bool)  # (n, 8, 128)
    walked = np.ones(n, bool)
    if P.group > 1:
        real = trl.group_real(P).numpy()
        walked = np.arange(n) % P.group < real[np.arange(n) // P.group]
    vals = P.vals.float().numpy().reshape(n, 8, 128)
    vals = np.where(lane_on & walked[:, None, None], vals, 0.0)
    win = P.slab_win.numpy().reshape(-1).astype(np.int64)
    col = (win[:, None, None] * 1024 + np.arange(8)[None, :, None] * 128
           + (P.s_idx.numpy().reshape(n, 8, 128).astype(np.int64) & 127))
    xpad = np.r_[x, np.zeros(P.n_win * 1024)]
    part = (vals * xpad[col]).sum(1)  # (n, 128) lane sums
    y = np.full(n_tiles * T + T, np.nan)
    writes = np.zeros(y.size)
    y[split_rows] = 0
    for s0, s1 in zip(warp_ptr[:-1], warp_ptr[1:]):
        if s0 == s1:
            continue
        shared = {tiles[s0]} if s0 and tiles[s0 - 1] == tiles[s0] else set()
        if s1 < n and tiles[s1 - 1] == tiles[s1]:
            shared.add(tiles[s1])

        def put(t, v):
            v = v.reshape(L, T).sum(0)
            if t in shared:
                y[t * T:(t + 1) * T] += v
            else:
                y[t * T:(t + 1) * T] = v
                writes[t * T:(t + 1) * T] += 1

        cur = tiles[s0 - 1] if s0 else -1
        acc = np.zeros(128)
        for s in range(s0, s1):
            if tiles[s] != cur:
                if s > s0:
                    put(cur, acc)
                for e in range(cur + 1, min(tiles[s], n_tiles)):
                    put(e, np.zeros(128))
                acc, cur = np.zeros(128), tiles[s]
            acc = acc + part[s]
        put(cur, acc)
        if s1 == n:
            for e in range(cur + 1, n_tiles):
                put(e, np.zeros(128))
    return y[:rows], writes[:rows]


@pytest.mark.parametrize("spw", [1, 3, 10 ** 6])
@pytest.mark.parametrize("case", ["ragged-L1", "wide-L2-group4", "ragged-L4",
                                  "empty-rows"])
def test_rowlane_walk_covers_rows(case, spw):
    """The warp ranges of the card walk (``rowlane_walk``), from the JAX
    packer's planes, at lanes_per_row 1, 2 and 4: they cover each slab
    once, in order; a cut lies at a tile start unless its tile is listed
    as split (the tiles the kernel adds into; their rows, ``split_rows``,
    the wrapper zeroes); and the kernel's rules, walked in numpy into a y
    of NaN, write every row once or zero it and add, giving the plain
    product."""
    name, kw, _ = RL_CASES[case]
    A, JA, sp = both(name)
    P = trl.pack_sell_rowlane(A, **kw)
    assert_same_container(P, jrl.pack_sell_rowlane(JA, **_jax_kw(kw)))
    warp_ptr, split, split_rows = (t.numpy() for t in trl._walk_build(P,
                                                                        spw))
    tiles = trl._slab_tiles(P).numpy()
    n, T = tiles.size, 128 // P.lanes_per_row
    assert warp_ptr[0] == 0 and warp_ptr[-1] == n
    assert (np.diff(warp_ptr) >= 0).all()
    cuts = warp_ptr[1:-1][(warp_ptr[1:-1] > 0) & (warp_ptr[1:-1] < n)]
    inside = cuts[tiles[cuts - 1] == tiles[cuts]]
    np.testing.assert_array_equal(split, np.unique(tiles[inside]))
    np.testing.assert_array_equal(
        split_rows, [r for t in split for r in range(t * T, t * T + T)
                     if r < sp.shape[0]])
    if spw >= 10 ** 6:  # one range: no cut at all
        assert warp_ptr.size == 2 and split.size == 0
    x = np.random.default_rng(6).standard_normal(sp.shape[1])
    y, writes = _walk_emulate(P, warp_ptr, split_rows, x)
    assert writes.max() <= 1 and not np.isnan(y).any()
    want = trl.spmv_sell_rowlane_reference(P, torch.from_numpy(
        x.astype(np.float32))).double().numpy()
    np.testing.assert_allclose(y, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("spw", [1, 2])
def test_rowlane_walk_cuts_at_tile_starts(spw):
    """With tiles of one or two slabs (the fixpoint solve's packs) and one
    or two slabs a warp, every cut moves to a tile start: no tile is
    split, so y needs no zero fill (the card's one launch).  A tile of
    more than twice ``spw`` slabs is cut inside."""
    tiles = np.repeat(np.arange(40), np.where(np.arange(40) % 3, 1, 2))
    ptr, split, rows = trl.walk_ranges(tiles, np.ones(tiles.size, bool),
                                       spw, 128, 40 * 128, torch.device(CPU))
    ptr = ptr.numpy()
    starts = np.flatnonzero(np.r_[True, tiles[1:] != tiles[:-1]])
    assert np.isin(ptr[:-1], starts).all()
    assert split.numel() == 0 and rows.numel() == 0
    long = np.repeat(np.arange(3), [2, 9, 2])
    ptr, split, _ = trl.walk_ranges(long, np.ones(long.size, bool), spw, 128,
                                    3 * 128, torch.device(CPU))
    assert split.tolist() == [1]


def test_rowlane_walk_refuses_decreasing_tiles():
    with pytest.raises(ValueError, match="never decrease"):
        trl.walk_ranges(np.array([0, 2, 1]), np.ones(3, bool), 1, 128, 384,
                        torch.device(CPU))


@pytest.mark.parametrize("n_slabs,resident,want", [
    (34866, 3168, 12), (66080, 3168, 7), (67712, 3168, 8), (638, 3168, 1)])
def test_rowlane_default_spw(n_slabs, resident, want):
    """The rowlane kernel's default slabs a warp: about 8, in whole waves
    of the warps the card holds (``spgemm_xl``'s P takes one wave, the XL
    CSR's packs three, the fixpoint solve's packs a slab a warp)."""
    spw = trl.rowlane_default_spw(n_slabs, resident)
    assert spw == want
    waves = max(1, round(n_slabs / (8 * resident)))
    assert -(-n_slabs // spw) <= waves * resident  # no partial extra wave

