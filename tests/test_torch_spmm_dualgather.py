"""Dual-gather SpMM (``kernels/spmm_dualgather.py``) against the JAX
package.

The JAX ``spmm_dualgather`` runs its Pallas kernels in interpret mode on
the CPU, as the JAX package's own tests run them
(``tests/test_dualgather.py``); the port's wrapper runs its plain version.
Both are held against an fp64 oracle at the JAX tests' tolerance (rtol
2e-3, atol 0.5), on packs built by the port and on JAX packs carried
across.  The kernels are held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch.formats as tf
from sparsematrix_tpu.kernels.spmm_dualgather import \
    spmm_dualgather as jax_spmm_dualgather
from sparsematrix_tpu_torch.kernels import spmm_dualgather
from sparsematrix_tpu_torch.utils.testutils import (gen_random_dense_sparse,
                                                    quantized_check)

jdg = importlib.import_module("sparsematrix_tpu.kernels.spmv_dualgather")
tdg = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_dualgather")
tsm = importlib.import_module("sparsematrix_tpu_torch.kernels.spmm_dualgather")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


def carry(ref):
    arrays, statics = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return tf.from_numpy_fields("DualGather", arrays, statics, device=CPU)


def packs(dense, **kw):
    bf16 = kw.pop("bf16", False)
    port = tdg.pack_dualgather(tf.CSR.fromdense(dense, device=CPU),
                               dtype=torch.bfloat16 if bf16 else None, **kw)
    ref = jdg.pack_dualgather(jf.CSR.fromdense(dense),
                              dtype=jnp.bfloat16 if bf16 else None, **kw)
    return port, ref


@pytest.mark.parametrize("n,k,kw", [
    (640, 6, dict(group=4, k_tiles=1)),                 # row 14
    (1100, 13, dict(k_tiles=4, group=8, two_win=True)),  # row 13, nibble
    (640, 5, dict(group=4, k_tiles=2, bf16=True)),      # single window
    (640, 5, dict(group=3, k_tiles=2, two_win=True)),   # plain-byte idxA
])
def test_spmm_matches_jax(n, k, kw):
    rng = np.random.default_rng(8)
    dense = gen_random_dense_sparse(rng, n, n, density=0.02)
    X = rng.standard_normal((n, k)).astype(np.float32)
    bf16 = kw.get("bf16", False)
    port, ref = packs(dense, **kw)
    want = np.asarray(jax.jit(jax_spmm_dualgather)(ref, jnp.asarray(X)))
    oracle = dense.astype(np.float64) @ X
    for pk in (port, carry(ref)):
        got = spmm_dualgather(pk, torch.from_numpy(X))
        assert got.dtype == torch.float32 and got.shape == (n, k)
        got = got.numpy()
        np.testing.assert_allclose(got, want, **TOL)
        if bf16:
            assert quantized_check(got, oracle)
        else:
            np.testing.assert_allclose(got, oracle, **TOL)
    # the card's walk (rows 13 and 14), read off on the CPU
    walked = tsm.slab_walk_plain(port, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(walked, want, **TOL)


@pytest.mark.parametrize("kw", [dict(group=4, k_tiles=1),
                                dict(group=4, k_tiles=1, with_transpose=True)])
def test_spmm_grads_match_jax(kw):
    """d/dX and d/dvals against ``jax.grad`` of <W, A X> (the JAX backward
    is the plain scatter whether or not the pack holds A^T)."""
    n, k = 384, 4
    rng = np.random.default_rng(9)
    dense = gen_random_dense_sparse(rng, n, n, density=0.02)
    X = rng.standard_normal((n, k)).astype(np.float32)
    W = rng.standard_normal((n, k)).astype(np.float32)
    port, ref = packs(dense, **kw)

    def loss(v, Xv):
        return jnp.vdot(jnp.asarray(W), jax_spmm_dualgather(
            dataclasses.replace(ref, vals=v), Xv))

    want_dv, want_gX = (np.asarray(a) for a in
                        jax.jit(jax.grad(loss, argnums=(0, 1)))(
                            ref.vals, jnp.asarray(X)))
    v = port.vals.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    Y = spmm_dualgather(dataclasses.replace(port, vals=v), Xt)
    (Y * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(Xt.grad.numpy(), want_gX, **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(),
                               dense.T.astype(np.float64) @ W, **TOL)
    np.testing.assert_allclose(v.grad.numpy(), want_dv, **TOL)
    assert (v.grad.numpy()[port.vals.numpy() == 0] == 0).all()


def test_spmm_rejects_split_kt1_pack():
    dense = gen_random_dense_sparse(np.random.default_rng(1), 256, 256,
                                    density=0.05)
    port, _ = packs(dense, group=4)
    split = dataclasses.replace(port, splits=(1,))
    with pytest.raises(ValueError, match="superblock pack"):
        spmm_dualgather(split, torch.zeros(256, 3))


# ---------------------------------------------------------------------------
# the walk of rows 13 and 14 (``slab_walk``), on the CPU
# ---------------------------------------------------------------------------


def kt1_walk_plain(P, walk, X):
    """Y = A @ X over the walk's slabs only, reading X under nonzero
    values: what the card's walk computes."""
    s, tile, win = (walk.items[:, i].long() for i in range(3))
    iA = P.idxA.reshape(-1, 8, 128).long()[s] & 7
    iB = P.idxB.reshape(-1, 8, 128).long()[s] & 127
    v = P.vals.reshape(-1, 8, 128).float()[s]
    col = win[:, None, None] * 1024 + torch.gather(iA, 2, iB) * 128 + iB
    rows, cols = P.shape
    ok = (v != 0) & (col < cols)
    Xv = X[col.clamp(max=cols - 1)] * (v * ok)[..., None]
    row = tile[:, None, None] * 128 + torch.arange(128)
    Y = torch.zeros((P.n_tiles * 128, X.shape[1]))
    Y.index_add_(0, row.expand_as(v).reshape(-1), Xv.reshape(-1, X.shape[1]))
    return Y[:rows]


@pytest.mark.parametrize("step", tsm.STEPS)
@pytest.mark.parametrize("n,kw", [(700, dict(group=4)),
                                  (1300, dict(group=8, bf16=True))])
def test_kt1_walk_covers_every_slab(n, kw, step):
    """Each slab that holds a value is listed once with its tile and
    window, a window-major block reads one window, and the walk's sum is
    the product."""
    rng = np.random.default_rng(n)
    dense = gen_random_dense_sparse(rng, n, 2 * n, density=0.02)
    dense[128:256] = 0  # a tile with no entries
    port, _ = packs(dense, **kw)
    walk = tsm.slab_walk(port, step)
    items = walk.items.numpy()
    assert (items[:, 3] == 0).all()
    real = np.flatnonzero((port.vals.reshape(port.n_slabs, -1) != 0)
                          .any(1).numpy())
    assert sorted(items[:, 0]) == real.tolist()
    s = items[:, 0]
    assert (items[:, 1] == port.group_tile.numpy()[s // port.group]).all()
    assert (items[:, 2] == port.slab_win.numpy().reshape(-1)[s]).all()
    ptr = walk.part_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(items) and (np.diff(ptr) >= 0).all()
    assert len(ptr) == walk.n_blocks * walk.teams + 1
    if step > 1:
        for b in range(walk.n_blocks):
            w = items[ptr[b * walk.teams]:ptr[(b + 1) * walk.teams], 2]
            assert len(set(w.tolist())) <= 1
    X = rng.standard_normal((2 * n, 5)).astype(np.float32)
    got = kt1_walk_plain(port, walk, torch.from_numpy(X)).numpy()
    want = spmm_dualgather(port, torch.from_numpy(X)).numpy()
    # fp32 sums in another order: 1e-5 of the output's scale
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def expected_items(P):
    """[(slab, tile, window word, 0)] of a pack's walk, rebuilt from its
    planes with numpy in slab order: each slab that holds a nonzero value,
    its superblock's tile times k_tiles plus its tile in the superblock,
    its ``slab_win`` word (a two-window slab's pair)."""
    n = P.n_slabs
    real = np.flatnonzero((P.vals.float().numpy().reshape(n, -1) != 0)
                          .any(1))
    tile = (P.group_tile.numpy().astype(np.int64).repeat(P.group) * P.k_tiles
            + P.slab_tloc.numpy().reshape(-1))
    win = P.slab_win.numpy().reshape(-1).astype(np.int64)
    return [(s, tile[s], win[s], 0) for s in real]


@pytest.mark.parametrize("step", tsm.STEPS)
@pytest.mark.parametrize("kw", [
    dict(group=4, k_tiles=4),                   # nibble idxA, one window
    dict(group=3, k_tiles=2),                   # byte idxA
    dict(group=4, k_tiles=2, two_win=True),     # two windows, nibbles
    dict(group=5, k_tiles=4, two_win=True),     # two windows, bytes
    dict(group=4, k_tiles=2, two_win=True, bf16=True),
], ids=lambda kw: "-".join(f"{a}={b}" for a, b in kw.items()))
def test_sb_walk_covers_every_slab(kw, step):
    """Row 13's walk on a superblock pack lists each slab that holds a
    value once (a numpy rebuild from the planes), in pack order at step 1
    and window by window (pair by pair on a two-window pack), tile by
    tile, from step 2; each block reads one window or pair; the walk's
    sum is the product."""
    rng = np.random.default_rng(7)
    dense = gen_random_dense_sparse(rng, 700, 3000, density=0.03)
    dense[256:384] = 0  # a tile with no entries
    port, _ = packs(dense, **kw)
    walk = tsm.slab_walk(port, step)
    items = walk.items.numpy().astype(np.int64)
    want = expected_items(port)
    if step > 1:  # window (or pair) major, then tile, then slab
        want = sorted(want, key=lambda it: (it[2], it[1], it[0]))
    assert items.tolist() == [list(map(int, it)) for it in want]
    ptr = walk.part_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(items) and (np.diff(ptr) >= 0).all()
    if step > 1:
        for b in range(walk.n_blocks):
            w = items[ptr[b * walk.teams]:ptr[(b + 1) * walk.teams], 2]
            assert len(set(w.tolist())) <= 1
    X = torch.from_numpy(rng.standard_normal((3000, 5)).astype(np.float32))
    got = tsm.slab_walk_plain(port, X, step).numpy()
    want = spmm_dualgather(port, X).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
