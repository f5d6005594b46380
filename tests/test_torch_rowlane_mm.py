"""The row-lane SpMM of the port (``kernels/spmm_rowlane.py``, table row
8) against the JAX package.

On the CPU the wrapper runs its plain version.  It must agree with an
fp64 oracle at the JAX tests' tolerance (``tests/test_spmm_rowlane.py``:
rtol 2e-3, atol 0.5, values in ±1000) on the JAX test's shapes and
densities at k ∈ {1, 8, 32}, with fp32 and bf16 packs (a bf16 pack against
the oracle of its bf16-rounded values) and fp32 and bf16 X; and, in the
cases marked ``jax`` (one a shape class: the Pallas kernel in interpret
mode compiles for seconds a case), with the JAX ``spmm_rowlane`` at the
same tolerance.

The card kernel's window walk (``rowlane_mm_walk``) is held against a
numpy rebuild: it lists every slab that holds a value once, window by
window and tile by tile, its ranges cover it, its sum equals the
product, and an in-place write into the values builds it anew.  These
make no JAX comparison.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
from sparsematrix_tpu.kernels.spmm_rowlane import spmm_rowlane as jax_spmm
from sparsematrix_tpu.kernels.spmv_rowlane import pack_sell_rowlane as jpack
from sparsematrix_tpu_torch.kernels import _build
from sparsematrix_tpu_torch.kernels.spmm_rowlane import (
    rowlane_mm_walk, rowlane_mm_walk_plain, spmm_rowlane,
    spmm_rowlane_reference)
from sparsematrix_tpu_torch.utils.testutils import gen_random_dense_sparse

TOL = dict(rtol=2e-3, atol=0.5)
# the JAX test's shapes and densities (test_spmm_rowlane.py:11-15)
SHAPES = {"96x1024": ((96, 1024), 0.05), "200x2048": ((200, 2048), 0.02),
          "130x1500": ((130, 1500), 0.03)}


@functools.lru_cache(maxsize=None)
def matrix(name):
    rng = np.random.default_rng(len(name))
    if name == "untouched":
        # three row tiles, the middle one (rows 128..255) empty
        dense = gen_random_dense_sparse(rng, 300, 1100, density=0.03)
        dense[128:256] = 0
    elif name == "windows":
        # four row tiles (the second empty) over five column windows
        dense = gen_random_dense_sparse(rng, 500, 4700, density=0.02)
        dense[128:256] = 0
    else:
        shape, density = SHAPES[name]
        dense = gen_random_dense_sparse(rng, *shape, density=density)
    return sps.csr_matrix(dense)


def rhs(cols, k, seed=1):
    return np.random.default_rng(seed).standard_normal((cols, k)).astype(
        np.float32)


def port_pack(sp, dtype=None, **kw):
    return smt.pack_sell_rowlane(smt.CSR.from_scipy(sp, device="cpu"),
                                 group=4, dtype=dtype, **kw)


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_fp64(name, k):
    sp = matrix(name)
    X = rhs(sp.shape[1], k)
    _build.launch_counts.clear()
    Y = spmm_rowlane(port_pack(sp), torch.from_numpy(X))
    assert Y.dtype == torch.float32 and Y.shape == (sp.shape[0], k)
    np.testing.assert_allclose(Y.numpy(), sp.astype(np.float64) @ X, **TOL)
    assert sum(_build.launch_counts.values()) == 0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_jax(name):
    """jax: one case a shape class, k = 8, fp32."""
    sp = matrix(name)
    X = rhs(sp.shape[1], 8)
    want = np.asarray(jax_spmm(jpack(jf.CSR.from_scipy(sp), group=4),
                               jnp.asarray(X)))
    got = spmm_rowlane(port_pack(sp), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_pack_matches_jax_and_fp64():
    """jax: a bf16 pack with fp32 X; the oracle takes the bf16-rounded
    values (accumulation stays fp32)."""
    sp = matrix("200x2048")
    X = rhs(sp.shape[1], 32)
    got = spmm_rowlane(port_pack(sp, dtype=torch.bfloat16),
                       torch.from_numpy(X)).numpy()
    rounded = sp.astype(np.float64)
    rounded.data = torch.from_numpy(sp.data).bfloat16().double().numpy()
    np.testing.assert_allclose(got, rounded @ X, **TOL)
    want = np.asarray(jax_spmm(
        jpack(jf.CSR.from_scipy(sp), group=4, dtype=jnp.bfloat16),
        jnp.asarray(X)))
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_x_matches_fp64():
    """bf16 X: the products in fp32 from the bf16 values of X."""
    sp = matrix("130x1500")
    X = torch.from_numpy(rhs(sp.shape[1], 8)).bfloat16()
    got = spmm_rowlane(port_pack(sp), X).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, sp.astype(np.float64)
                               @ X.double().numpy(), **TOL)


def test_untouched_tile_is_zero_and_matches_jax():
    """jax: a row tile that no group touches comes out zero."""
    sp = matrix("untouched")
    pk = port_pack(sp)
    assert not bool(pk.tile_nonempty[1])
    assert 1 not in set(pk.group_tile.tolist())
    X = rhs(sp.shape[1], 8)
    got = spmm_rowlane(pk, torch.from_numpy(X)).numpy()
    assert not got[128:256].any()
    np.testing.assert_allclose(got, sp.astype(np.float64) @ X, **TOL)
    want = np.asarray(jax_spmm(jpack(jf.CSR.from_scipy(sp), group=4),
                               jnp.asarray(X)))
    np.testing.assert_allclose(got, want, **TOL)


def test_padding_groups_add_nothing():
    """Zero-valued padding groups pointing at the last tile (the
    ``partition_rowlane`` padding) leave the product unchanged."""
    sp = matrix("96x1024")
    pk = port_pack(sp)
    n_pad = 3
    gh = pk.s_idx.shape[1]
    padded = dataclasses.replace(
        pk,
        s_idx=torch.cat([pk.s_idx, torch.full((n_pad, gh, 128), 77,
                                              dtype=torch.int8)]),
        vals=torch.cat([pk.vals, torch.zeros((n_pad, gh, 128))]),
        group_tile=torch.cat([pk.group_tile,
                              pk.group_tile[-1:].repeat(n_pad)]),
        slab_win=torch.cat([pk.slab_win, torch.zeros((n_pad, pk.group),
                                                     dtype=torch.int32)]))
    X = torch.from_numpy(rhs(sp.shape[1], 8))
    assert torch.equal(spmm_rowlane(padded, X), spmm_rowlane(pk, X))


def test_refuses_multilane_pack():
    sp = matrix("96x1024")
    pk = port_pack(sp, lanes_per_row=2)
    with pytest.raises(ValueError, match="lanes_per_row=1"):
        spmm_rowlane(pk, torch.zeros((sp.shape[1], 4)))
    with pytest.raises(ValueError, match="lanes_per_row=1"):
        spmm_rowlane_reference(pk, torch.zeros((sp.shape[1], 4)))


def test_refuses_spilled_pack():
    d = np.zeros((64, 256), np.float32)
    d[3, :] = 1.0  # one dense row: 256 entries of one row in 2 chunks
    pk = port_pack(sps.csr_matrix(d), spill_depth=1)
    assert pk.spill is not None and pk.spill.nnz
    with pytest.raises(ValueError, match="spilled"):
        spmm_rowlane(pk, torch.zeros((256, 4)))


def walk_rebuild(pk):
    """(slab, tile, window) of the slabs holding a value, ordered by
    window, tile and slab: the walk's items rebuilt in numpy."""
    vals = pk.vals.float().numpy().reshape(pk.n_slabs, -1)
    s = np.flatnonzero((vals != 0).any(1))
    tile = np.repeat(pk.group_tile.numpy(), pk.group)[s]
    win = pk.slab_win.numpy().reshape(-1)[s]
    order = np.lexsort((s, tile, win))
    return np.stack([s[order], tile[order], win[order]], 1)


@pytest.mark.parametrize("name", ["windows", "untouched", "96x1024"])
def test_window_walk_lists_each_held_slab_once(name):
    """The walk lists every slab that holds a value once, window by
    window and tile by tile; its blocks lie inside one window each and its
    team ranges cover it in order; its sum is the product."""
    sp = matrix(name)
    pk = port_pack(sp)
    walk = rowlane_mm_walk(pk)
    items = walk.items.numpy()
    np.testing.assert_array_equal(items[:, :3], walk_rebuild(pk))
    assert not items[:, 3].any()
    ptr = walk.part_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(items)
    assert np.all(np.diff(ptr) >= 0)
    assert len(ptr) == walk.n_blocks * walk.teams + 1
    assert walk.n_blocks <= 132
    for b in range(walk.n_blocks):
        wins = items[ptr[b * walk.teams]: ptr[(b + 1) * walk.teams], 2]
        assert len(wins) and len(set(wins.tolist())) == 1
    assert walk.nnz == sp.nnz
    X = rhs(sp.shape[1], 5)
    got = rowlane_mm_walk_plain(pk, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(
        got, spmm_rowlane_reference(pk, torch.from_numpy(X)).numpy(),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, sp.astype(np.float64) @ X, **TOL)


def test_window_walk_rebuilt_after_value_write():
    """An in-place write of a value into a slab that held none (a padding
    slab) adds it to the walk at the next call; the walk is cached
    until then."""
    sp = matrix("windows")
    pk = port_pack(sp)
    walk = rowlane_mm_walk(pk)
    assert rowlane_mm_walk(pk) is walk
    vals = pk.vals.reshape(pk.n_slabs, -1)
    empty = int(np.flatnonzero(~(vals != 0).any(1).numpy())[0])
    vals[empty, 5] = 3.0
    walk2 = rowlane_mm_walk(pk)
    assert walk2 is not walk
    assert len(walk2.items) == len(walk.items) + 1
    assert empty in set(walk2.items[:, 0].tolist())
    np.testing.assert_array_equal(walk2.items[:, :3].numpy(),
                                  walk_rebuild(pk))
    X = torch.from_numpy(rhs(sp.shape[1], 3))
    np.testing.assert_allclose(rowlane_mm_walk_plain(pk, X).numpy(),
                               spmm_rowlane_reference(pk, X).numpy(),
                               rtol=1e-5, atol=1e-3)


def test_window_walk_without_values():
    """A pack whose values are all zero (written in place) walks no slab:
    no block, one team pointer, and a zero sum."""
    sp = matrix("96x1024")
    pk = port_pack(sp)
    assert rowlane_mm_walk(pk).n_blocks
    pk.vals.zero_()
    walk = rowlane_mm_walk(pk)
    assert walk.n_blocks == 0 and walk.nnz == 0
    assert walk.items.shape == (0, 4)
    np.testing.assert_array_equal(walk.part_ptr.numpy(), [0])
    X = torch.from_numpy(rhs(sp.shape[1], 4))
    got = rowlane_mm_walk_plain(pk, X)
    assert got.shape == (sp.shape[0], 4) and not bool(got.any())
