"""The SELL SpMVs of the port (``kernels/spmv_sell.py``) against the JAX
package's ``kernels/spmv_pallas.py``.

Both packers must give planes ``np.array_equal`` to the JAX packers',
field by field: ``pack_sell`` at tr ∈ {8, 32, 64}, ``pack_sell_rowpure``
at every R.  Products are held against the JAX kernels (Pallas in
interpret mode on the CPU, as ``tests/test_sell_spmv.py`` runs them) and
an fp64 oracle at the JAX tests' tolerance (rtol 2e-3, atol 0.5; the same
against JAX), on the cases of ``tests/test_sell_spmv.py``.  The row-pure
VJP is held against ``jax.vjp`` and fp64 at the same tolerance.  A rowlane
pack whose spill tail is a legacy ``SellSpmv`` runs it through
``spmv_sell``, as the JAX package does.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
from sparsematrix_tpu.ops import spmv as jax_spmv
from sparsematrix_tpu_torch.utils.testutils import gen_random_dense_sparse
from test_torch_spmv import assert_same_container

jsell = importlib.import_module("sparsematrix_tpu.kernels.spmv_pallas")
jrl = importlib.import_module("sparsematrix_tpu.kernels.spmv_rowlane")
tsell = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_sell")
trl = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_rowlane")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


def both(dense):
    return (smt.CSR.fromdense(dense, device=CPU), jf.CSR.fromdense(dense))


def random_case(n, cols, d, seed):
    rng = np.random.default_rng(seed)
    dense = gen_random_dense_sparse(rng, n, cols, density=d)
    return dense, rng.uniform(-1, 1, cols).astype(np.float32)


def carry(ref):
    """The JAX pack carried into the port through ``from_numpy_fields``."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return smt.from_numpy_fields(type(ref).__name__, arrays, statics,
                                 device=CPU)


def check(port_pack, jax_pack, dense, x, fn, jfn):
    """The port's product on its own pack and on the carried JAX pack
    against the JAX kernel and fp64 (rtol 2e-3, atol 0.5)."""
    want = np.asarray(jfn(jax_pack, jnp.asarray(x)))
    for pk in (port_pack, carry(jax_pack)):
        got = fn(pk, torch.from_numpy(x))
        assert got.dtype == pk.vals.dtype and got.shape == (dense.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(),
                                   dense.astype(np.float64) @ x, **TOL)


@pytest.mark.parametrize("tr", [8, 32, 64])
def test_pack_sell_planes_equal(tr):
    dense, _ = random_case(700, 3000, 0.03, seed=1)
    A, JA = both(dense)
    assert_same_container(tsell.pack_sell(A, tr=tr), jsell.pack_sell(JA, tr=tr))


@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_pack_rowpure_planes_equal(R):
    dense, _ = random_case(700, 3000, 0.03, seed=2)
    A, JA = both(dense)
    assert_same_container(
        tsell.pack_sell_rowpure(A, group=4, rows_per_sublane=R),
        jsell.pack_sell_rowpure(JA, group=4, rows_per_sublane=R))


# tests/test_sell_spmv.py: random, rectangular
SELL_CASES = {
    "512-0.05-tr32": (512, 512, 0.05, 32),
    "1000-0.02-tr16": (1000, 1000, 0.02, 16),
    "300-0.2-tr8": (300, 300, 0.2, 8),
    "130-0.1-tr64": (130, 130, 0.1, 64),
    "rectangular-100x2500": (100, 2500, 0.01, 32),
}


@pytest.mark.parametrize("case", sorted(SELL_CASES))
def test_spmv_sell_matches_jax(case):
    n, cols, d, tr = SELL_CASES[case]
    dense, x = random_case(n, cols, d, seed=3)
    A, JA = both(dense)
    check(tsell.pack_sell(A, tr=tr), jsell.pack_sell(JA, tr=tr), dense, x,
          tsell.spmv_sell, jsell.spmv_sell)


def _empty_tiles():
    dense = np.zeros((200, 200), dtype=np.float32)
    dense[5, 7] = 3.0
    dense[150, 199] = -2.0  # the tiles in between have no entries
    return dense


def _deep_lanes():
    rng = np.random.default_rng(4)
    dense = np.zeros((16, 256), dtype=np.float32)
    dense[:, 128] = rng.uniform(1, 2, 16)  # lane 0 of window 0, twice
    dense[:, 0] = rng.uniform(1, 2, 16)
    return dense


@pytest.mark.parametrize("name,make,tr", [
    ("empty-tiles", _empty_tiles, 16),
    ("zero-matrix", lambda: np.zeros((32, 32), np.float32), 8),
    ("deep-lane-buckets", _deep_lanes, 16)])
def test_spmv_sell_edge_cases(name, make, tr):
    dense = make()
    A, JA = both(dense)
    x = np.arange(dense.shape[1], dtype=np.float32) / dense.shape[1]
    P = tsell.pack_sell(A, tr=tr)
    assert_same_container(P, jsell.pack_sell(JA, tr=tr))
    check(P, jsell.pack_sell(JA, tr=tr), dense, x, tsell.spmv_sell,
          jsell.spmv_sell)
    if name == "deep-lane-buckets":
        assert P.meta.shape[0] > 1  # 16 entries a lane: two slab levels


# tests/test_sell_spmv.py: random row-pure packs, with every R
ROWPURE_CASES = {
    "512-0.05-g4": (512, 0.05, 4, 1),
    "1024-0.02-g8": (1024, 0.02, 8, 1),
    "300-0.3-g2": (300, 0.3, 2, 1),
    "512-0.05-g2-R2": (512, 0.05, 2, 2),
    "512-0.05-g2-R4": (512, 0.05, 2, 4),
    "512-0.05-g2-R8": (512, 0.05, 2, 8),
    "512-0.05-g2-R16": (512, 0.05, 2, 16),
}


@pytest.mark.parametrize("case", sorted(ROWPURE_CASES))
def test_spmv_rowpure_matches_jax(case):
    n, d, g, R = ROWPURE_CASES[case]
    dense, x = random_case(n, n, d, seed=5)
    A, JA = both(dense)
    check(tsell.pack_sell_rowpure(A, group=g, rows_per_sublane=R),
          jsell.pack_sell_rowpure(JA, group=g, rows_per_sublane=R), dense,
          x, tsell.spmv_sell_rowpure, jsell.spmv_sell_rowpure)


@pytest.mark.parametrize("name", ["lane-collisions", "zero-matrix"])
def test_spmv_rowpure_edge_cases(name):
    if name == "lane-collisions":
        # many same-lane columns in one row: deep collision slabs
        dense = np.zeros((8, 2048), dtype=np.float32)
        dense[3, [0, 128, 256, 384, 1024, 1152]] = np.random.default_rng(
            6).uniform(1, 2, 6)
    else:
        dense = np.zeros((20, 20), np.float32)
    A, JA = both(dense)
    x = np.linspace(-1, 1, dense.shape[1]).astype(np.float32)
    P = tsell.pack_sell_rowpure(A, group=2)
    assert_same_container(P, jsell.pack_sell_rowpure(JA, group=2))
    check(P, jsell.pack_sell_rowpure(JA, group=2), dense, x,
          tsell.spmv_sell_rowpure, jsell.spmv_sell_rowpure)


@pytest.mark.parametrize("R", [1, 4])
def test_rowpure_grads_match_jax(R):
    """d/dx and d/dvals against ``jax.vjp`` and fp64 (rtol 2e-3, atol
    0.5; the value cotangent to atol 1e-4 against JAX)."""
    dense, x = random_case(300, 2100, 0.03, seed=7)
    g = np.random.default_rng(8).standard_normal(300).astype(np.float32)
    A, JA = both(dense)
    port = tsell.pack_sell_rowpure(A, group=2, rows_per_sublane=R)
    ref = jsell.pack_sell_rowpure(JA, group=2, rows_per_sublane=R)

    def jax_fn(v, xx):
        return jsell.spmv_sell_rowpure(dataclasses.replace(ref, vals=v), xx)

    _, vjp = jax.vjp(jax_fn, ref.vals, jnp.asarray(x))
    want_dv, want_gx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    v = port.vals.clone().requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    y = tsell.spmv_sell_rowpure(dataclasses.replace(port, vals=v), xx)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xx.grad.numpy(), want_gx, **TOL)
    np.testing.assert_allclose(xx.grad.numpy(),
                               dense.T.astype(np.float64) @ g, **TOL)
    np.testing.assert_allclose(v.grad.numpy(), want_dv, rtol=2e-3,
                               atol=1e-4)
    assert (v.grad.numpy()[port.vals.numpy() == 0] == 0).all()


def test_spmv_sell_is_not_differentiable():
    dense, x = random_case(64, 96, 0.1, seed=9)
    A, _ = both(dense)
    y = tsell.spmv_sell(tsell.pack_sell(A, tr=16),
                        torch.from_numpy(x).requires_grad_())
    assert not y.requires_grad


def test_spmv_dispatch_accepts_packs():
    """``spmv`` takes both packs (the JAX dispatch,
    ``tests/test_sell_spmv.py``); ``spmm`` refuses them, as in JAX."""
    dense, x = random_case(64, 96, 0.1, seed=10)
    A, JA = both(dense)
    for port, ref in ((tsell.pack_sell(A, tr=16), jsell.pack_sell(JA, tr=16)),
                      (tsell.pack_sell_rowpure(A, group=2,
                                               rows_per_sublane=4),
                       jsell.pack_sell_rowpure(JA, group=2,
                                               rows_per_sublane=4))):
        got = smt.spmv(port, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_spmv(
            ref, jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(got, dense.astype(np.float64) @ x, **TOL)
        with pytest.raises(TypeError, match="unsupported"):
            smt.spmm(port, torch.ones((96, 2)))


def test_rowlane_legacy_sell_tail_matches_jax():
    """A legacy rowlane container whose spill tail was packed as a
    masked-slab ``SellSpmv``: built by hand on both sides from the same
    spill CSR, its product runs the tail through ``spmv_sell``."""
    rng = np.random.default_rng(11)
    dense = gen_random_dense_sparse(rng, 300, 1200, density=0.02)
    dense[::7, :300] = rng.uniform(-1, 1, (43, 300))  # rows deep enough
    A, JA = both(dense)
    port = trl.pack_sell_rowlane(A, spill_depth=1)
    ref = jrl.pack_sell_rowlane(JA, spill_depth=1)
    assert ref.spill_packed is not None
    port = dataclasses.replace(port, spill_packed=tsell.pack_sell(
        port.spill, tr=32))
    ref = dataclasses.replace(ref, spill_packed=jsell.pack_sell(
        ref.spill, tr=32))
    assert_same_container(port.spill_packed, ref.spill_packed)
    x = rng.uniform(-1, 1, 1200).astype(np.float32)
    want = np.asarray(jrl.spmv_sell_rowlane(ref, jnp.asarray(x)))
    for fn in (trl.spmv_sell_rowlane, trl.spmv_sell_rowlane_reference):
        got = fn(port, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, dense.astype(np.float64) @ x, **TOL)


def _tile_heavy_case(R):
    """A row-pure pack with empty tiles (rows 8R..24R-1 and the last
    tiles hold nothing) and one tile of many groups (its rows dense)."""
    rows, cols = 8 * R * 6 + 5, 3000
    rng = np.random.default_rng(40 + R)
    dense = gen_random_dense_sparse(rng, rows, cols, density=0.01)
    dense[8 * R:24 * R] = 0
    dense[-8 * R - 5:] = 0
    dense[:8 * R, ::3] = rng.uniform(-1, 1, (8 * R, -(-cols // 3)))
    return dense, rng.uniform(-1, 1, cols).astype(np.float32)


@pytest.mark.parametrize("wanted", [tsell._RUNS_WANTED, 2])
@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_rowpure_runs_cover_groups_in_order(R, wanted, monkeypatch):
    """The runs the card kernel takes (``rowpure_runs``): every group
    once, in ``group_tile`` order, each run within one tile and at most L
    groups long; summed run by run in plain torch they give the plain
    product."""
    monkeypatch.setattr(tsell, "_RUNS_WANTED", wanted)
    dense, x = _tile_heavy_case(R)
    P = tsell.pack_sell_rowpure(smt.CSR.fromdense(dense, device=CPU),
                                group=2, rows_per_sublane=R)
    run_ptr, run_tile = (t.numpy() for t in tsell.rowpure_runs(P))
    gt = P.group_tile.numpy()
    n_groups = gt.size
    L = max(1, min(-(-n_groups // wanted), tsell._RUN_SLABS // P.group))
    assert run_ptr[0] == 0 and run_ptr[-1] == n_groups
    assert (np.diff(run_ptr) >= 1).all() and (np.diff(run_ptr) <= L).all()
    assert (np.diff(run_tile) >= 0).all()
    for r in range(run_tile.size):
        assert (gt[run_ptr[r]:run_ptr[r + 1]] == run_tile[r]).all()
    tiles = P.tile_nonempty.numpy()
    assert not tiles[1:3].any() and tiles[0]
    assert set(run_tile) == set(np.nonzero(tiles)[0])
    heavy = np.diff(run_ptr)[run_tile == 0].sum()
    assert heavy > 2 and (run_tile == 0).sum() == -(-heavy // L)
    # the kernel's sum, run by run: cells into their tile's rows
    row, col = tsell._rowpure_slot_row_col(P)
    xt = torch.from_numpy(x)
    y = torch.zeros(P.n_tiles * 8 * R, dtype=torch.float64)
    for r in range(run_tile.size):
        g = slice(run_ptr[r], run_ptr[r + 1])
        assert (row[g] // (8 * R) == run_tile[r]).all()
        v = P.vals[g].double()
        ok = (v != 0) & (col[g] < dense.shape[1])
        y.index_add_(0, row[g][ok], v[ok] * xt.double()[col[g][ok]])
    # the plain version sums in fp32: 1e-5 of the output's scale
    want = tsell.spmv_sell_rowpure_reference(P, xt).double().numpy()
    np.testing.assert_allclose(y[:dense.shape[0]].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _runs_numpy(slab_tile, C):
    """The masked-slab blocks and runs rebuilt slab by slab.  C > 0: a
    block takes C slabs, a run starts where the tile changes or a block
    starts; C = -L < 0: a run starts where the tile changes or L slabs
    after the last start, a run a block."""
    block_ptr, starts, tiles = [], [], []
    for s, t in enumerate(slab_tile):
        new_tile = not starts or t != tiles[-1]
        if C > 0 and s % C == 0 or C < 0 and (new_tile
                                              or s - starts[-1] == -C):
            block_ptr.append(len(starts))
            starts.append(s)
            tiles.append(t)
        elif new_tile:
            starts.append(s)
            tiles.append(t)
    return (np.array(block_ptr + [len(starts)]),
            np.array(starts + [len(slab_tile)]), np.array(tiles))


@pytest.mark.parametrize("C", [1, 3, 10 ** 6, -3])
@pytest.mark.parametrize("tr", [8, 64])
def test_sell_runs_cover_slabs_in_order(tr, C):
    """The blocks and runs the card kernel takes (``sell_runs``), from the
    JAX packer's planes: equal to a slab-by-slab rebuild, every slab once
    and in order, each run within one tile and one block's C slabs (or at
    most L of one tile, a run a block); summed run by run in plain torch
    they give the plain product."""
    dense, x = random_case(700, 3000, 0.03, seed=1)
    dense[: 2 * tr, ::3] = 0.5  # tiles 0 and 1 many slabs deep
    A, JA = both(dense)
    jp = jsell.pack_sell(JA, tr=tr)
    P = carry(jp)
    block_ptr, run_ptr, run_tile = (t.numpy() for t in tsell.sell_runs(P, C))
    st = np.asarray(jp.slab_tile)
    for got, want in zip((block_ptr, run_ptr, run_tile), _runs_numpy(st, C)):
        np.testing.assert_array_equal(got, want)
    n = st.size
    assert block_ptr[-1] == run_tile.size
    assert run_ptr[0] == 0 and run_ptr[-1] == n and (np.diff(run_ptr) >= 1).all()
    if C > 0:
        assert block_ptr.size - 1 == -(-n // C)
        for b in range(block_ptr.size - 1):  # a block's runs fill C slabs
            assert run_ptr[block_ptr[b]] == b * C
            assert run_ptr[block_ptr[b + 1]] == min((b + 1) * C, n)
    else:
        np.testing.assert_array_equal(block_ptr, np.arange(run_tile.size + 1))
        assert (np.diff(run_ptr) <= -C).all()
    if abs(C) > 1:
        assert (np.diff(run_ptr) > 1).any()
    row, col = tsell._sell_slot_row_col(P)
    xt = torch.from_numpy(x).double()
    y = torch.zeros(P.n_tiles * tr, dtype=torch.float64)
    for r in range(run_tile.size):
        g = slice(run_ptr[r], run_ptr[r + 1])
        assert (st[g] == run_tile[r]).all()
        v = P.vals[g].double()
        ok = (v != 0) & (col[g] < dense.shape[1])
        y.index_add_(0, row[g][ok], v[ok] * xt[col[g][ok]])
    want = tsell.spmv_sell_reference(P, torch.from_numpy(x)).double().numpy()
    np.testing.assert_allclose(y[: dense.shape[0]].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tr", [8, 128])
def test_sell_meta16_matches_jax_meta(tr):
    """The 16-bit meta copy the card kernel reads (``sell_meta16``), from
    the JAX packer's planes: the meta plane itself, narrowed."""
    dense, _ = random_case(300, 2100, 0.05, seed=4)
    jp = jsell.pack_sell(both(dense)[1], tr=tr)
    got = tsell.sell_meta16(carry(jp))
    want = np.asarray(jp.meta)
    assert got.dtype == torch.int16 and want.max() < 1 << 10
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
