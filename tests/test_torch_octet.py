"""The octet SpMV of the port (``kernels/spmv_octet.py``) against the JAX
package.

Packs must be plane-equal to the JAX packer's, with the native slot
assigner and with the numpy repair, with and without the trim section
(``rem``; a ``trim_group`` ≥ ``group`` is ignored by both).  Products and
gradients must agree with the JAX kernel (Pallas in interpret mode) and
with an fp64 oracle at the JAX tests' tolerance (rtol 2e-3, atol 0.5).
The ``rem`` gradient is held against fp64 ``A^T w`` on the 3000×5000,
density-0.0005 matrix, whose trim pack has a ``rem`` section.
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
from sparsematrix_tpu.ops.spmv import prepare_spmv as jax_prepare_spmv
from test_torch_spmv import assert_same_container, jit_vjp

jdg = importlib.import_module("sparsematrix_tpu.kernels.spmv_dualgather")
joc = importlib.import_module("sparsematrix_tpu.kernels.spmv_octet")
toc = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_octet")

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=0.5)


@functools.lru_cache(maxsize=None)
def matrix(shape, density, seed=2):
    sp = sps.random(*shape, density=density, random_state=seed, format="csr",
                    dtype=np.float32)
    sp.data = np.random.default_rng(seed).uniform(
        -1000, 1000, sp.nnz).astype(np.float32)
    return sp


def both(shape, density):
    sp = matrix(shape, density)
    return smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp), sp


CASES = {
    "multi-window": ((3000, 5000), 0.0005, dict(k_octets=4)),
    "odd-shape": ((1100, 900), 0.001, dict(k_octets=2)),
    "depth": ((1500, 1000), 0.01, dict(k_octets=1)),
    "trim": ((3000, 5000), 0.0005, dict(group=32, k_octets=4,
                                        trim_group=8)),
    "trim-ge-group": ((3000, 5000), 0.0005, dict(group=8, k_octets=4,
                                                 trim_group=8)),
    "bf16": ((1100, 900), 0.001, dict(k_octets=2, dtype=torch.bfloat16)),
}


def _jax_kw(kw):
    return {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_octet_pack_matches_jax(case):
    shape, density, kw = CASES[case]
    A, JA, _ = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    assert_same_container(packed, joc.pack_octet(JA, **_jax_kw(kw)))
    # the trim quirk: a trim_group at or above group is ignored
    assert (packed.rem is not None) == (case == "trim")


@pytest.mark.parametrize("case", ["multi-window", "depth", "trim"])
def test_octet_numpy_repair_matches_jax(monkeypatch, case):
    """Without the native assigner both sides take the numpy repair
    (other, valid planes)."""
    for mod in (joc, toc):
        monkeypatch.setattr(mod, "_assign_native", lambda *a, **k: None)
    shape, density, kw = CASES[case]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    assert_same_container(packed, joc.pack_octet(JA, **_jax_kw(kw)))
    x = np.random.default_rng(8).standard_normal(sp.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(
        toc.spmv_octet(packed, torch.from_numpy(x)).numpy(),
        sp.astype(np.float64) @ x, **TOL)


@pytest.mark.parametrize("case", ["trim", "bf16"])
def test_octet_product_and_grads_match_jax(case):
    """(The trim case packs the multi-window matrix: both sections.)"""
    shape, density, kw = CASES[case]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    jpacked = joc.pack_octet(JA, **_jax_kw(kw))
    rng = np.random.default_rng(9)
    x = rng.standard_normal(sp.shape[1]).astype(np.float32)
    w = rng.uniform(-1, 1, sp.shape[0]).astype(np.float32)
    sp64 = sp.astype(np.float64)
    if kw.get("dtype") is torch.bfloat16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    xt = torch.from_numpy(x).requires_grad_()
    packed.vals.requires_grad_()
    if packed.rem is not None:
        packed.rem.vals.requires_grad_()
    y = toc.spmv_octet(packed, xt)
    (y * torch.from_numpy(w)).sum().backward()

    def fwd(vals, rem_vals, xx):
        rem = (None if jpacked.rem is None
               else dataclasses.replace(jpacked.rem, vals=rem_vals))
        return joc.spmv_octet(dataclasses.replace(jpacked, vals=vals,
                                                  rem=rem), xx)

    # one trace gives the JAX product and its VJP
    jrem = jpacked.rem.vals if jpacked.rem is not None else jnp.zeros(1)
    jy, (jdv, jdr, jgx) = jit_vjp(fwd, (jpacked.vals, jrem, jnp.asarray(x)),
                                  jnp.asarray(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.detach().numpy(), sp64 @ x, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), sp64.T @ w, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(packed.vals.grad.float().numpy(),
                               np.asarray(jdv.astype(jnp.float32)), **TOL)
    if packed.rem is not None:
        np.testing.assert_allclose(packed.rem.vals.grad.numpy(),
                                   np.asarray(jdr), **TOL)


def test_octet_splits_match_jax(monkeypatch):
    """Under a small prefetch budget the JAX packer cuts its calls at
    superblock boundaries; the port keeps the same ``splits`` (one launch
    covers them all)."""
    monkeypatch.setattr(jdg, "_SMEM_PREFETCH_BUDGET", 320)
    monkeypatch.setattr(toc, "_SMEM_PREFETCH_BUDGET", 320)
    A, JA, sp = both((3000, 5000), 0.0005)
    packed = toc.pack_octet(A, group=4, k_octets=1)
    assert packed.splits
    assert_same_container(packed, joc.pack_octet(JA, group=4, k_octets=1))
    x = np.random.default_rng(10).standard_normal(5000).astype(np.float32)
    np.testing.assert_allclose(
        toc.spmv_octet(packed, torch.from_numpy(x)).numpy(),
        sp.astype(np.float64) @ x, **TOL)


def test_prepare_spmv_auto_clustered_octet():
    """The clustered generator of the JAX bench's ``spmv_clustered`` row
    (~1.2 entries a row, all in one 1024-column window), at 64 tiles: the
    auto route packs it as an octet, equal to the JAX pack."""
    g = np.random.default_rng(0)
    n = 64 * 128
    rows_ = g.integers(0, n, size=10_000)
    cols_ = g.integers(0, 1024, size=rows_.size)
    vals_ = g.uniform(-1000, 1000, rows_.size).astype(np.float32)
    sp = sps.coo_matrix((vals_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    P = smt.prepare_spmv(A)
    assert isinstance(P, smt.Octet)
    assert_same_container(P, jax_prepare_spmv(JA))
    x = g.standard_normal(n).astype(np.float32)
    want = sp.astype(np.float64) @ x
    np.testing.assert_allclose(smt.spmv(P, torch.from_numpy(x)).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(smt.spmv(A, torch.from_numpy(x)).numpy(),
                               want, **TOL)


def test_octet_empty_and_spmm_raises():
    """An empty pack: zero products through both wrappers; ``spmm_octet``
    raises on an X whose rows are not the matrix's columns."""
    A = smt.CSR.fromdense(np.zeros((64, 64), np.float32), device=CPU)
    packed = toc.pack_octet(A)
    assert_same_container(
        packed, joc.pack_octet(jf.CSR.fromdense(np.zeros((64, 64),
                                                         np.float32))))
    assert (toc.spmv_octet(packed, torch.ones(64)) == 0).all()
    Y = toc.spmm_octet(packed, torch.ones((64, 2)))
    assert Y.shape == (64, 2) and (Y == 0).all()
    with pytest.raises(ValueError, match="X must be fp32"):
        toc.spmm_octet(packed, torch.ones((63, 2)))


def _spmm_fixture(shape, density, seed, **kw):
    """The JAX tests' SpMM fixture: ``sps.random`` pattern, values in
    ±10 (``tests/test_octet.py:181-198``)."""
    sp = sps.random(*shape, density=density, random_state=seed,
                    format="csr", dtype=np.float32)
    sp.data = np.random.default_rng(seed).uniform(
        -10, 10, sp.nnz).astype(np.float32)
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    return toc.pack_octet(A, **kw), joc.pack_octet(JA, **_jax_kw(kw)), sp


@pytest.mark.parametrize("k", [1, 5, 8, 13, 40])
def test_spmm_octet_matches_jax(k):
    """test_spmm_octet at each k (and k = 1 and k > 32): through the
    kernel wrapper and the ``spmm`` pack dispatch, against fp64 and, at
    k = 1, 8 and 40 (one a class of k: a column, a panel of up to 32, two
    panels), the JAX ``spmm_octet`` (rtol 2e-3, atol 0.5)."""
    packed, jpacked, sp = _spmm_fixture((2048, 2048), 0.002, 1, k_octets=2)
    X = np.random.default_rng(k).uniform(-1, 1, (2048, k)).astype(np.float32)
    want = (np.asarray(jax.jit(joc.spmm_octet)(jpacked, jnp.asarray(X)))
            if k in (1, 8, 40) else None)
    for fn in (toc.spmm_octet, smt.spmm, toc.spmm_octet_reference):
        got = fn(packed, torch.from_numpy(X))
        assert got.dtype == torch.float32 and got.shape == (2048, k)
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), sp.astype(np.float64) @ X,
                                   **TOL)


def test_spmm_octet_trim_rem_and_vjp_match_jax():
    """The trim pack of the 3000×5000, density-0.0005 fixture has a
    ``rem`` section: the product against the JAX ``spmm_octet`` and fp64,
    the X cotangent against fp64 ``A^T G`` and JAX, and the value
    cotangents of both sections against JAX's (rtol 2e-3, atol 0.5; the
    value cotangents to atol 1e-4)."""
    shape, density, kw = CASES["trim"]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    jpacked = joc.pack_octet(JA, **kw)
    assert packed.rem is not None
    rng = np.random.default_rng(12)
    X = rng.uniform(-1, 1, (shape[1], 4)).astype(np.float32)
    G = rng.uniform(-1, 1, (shape[0], 4)).astype(np.float32)

    def fwd(vals, rem_vals, xx):
        return joc.spmm_octet(dataclasses.replace(
            jpacked, vals=vals,
            rem=dataclasses.replace(jpacked.rem, vals=rem_vals)), xx)

    jy, jcot = jit_vjp(fwd, (jpacked.vals, jpacked.rem.vals, jnp.asarray(X)),
                       jnp.asarray(G))
    jdv, jdr, jgX = (np.asarray(a) for a in jcot)
    v = packed.vals.clone().requires_grad_()
    rv = packed.rem.vals.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    pk = dataclasses.replace(packed, vals=v,
                             rem=dataclasses.replace(packed.rem, vals=rv))
    Y = smt.spmm(pk, Xt)
    Y.backward(torch.from_numpy(G))
    sp64 = sp.astype(np.float64)
    np.testing.assert_allclose(Y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(Y.detach().numpy(), sp64 @ X, **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), sp64.T @ G, **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), jgX, **TOL)
    np.testing.assert_allclose(v.grad.numpy(), jdv, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(rv.grad.numpy(), jdr, rtol=2e-3, atol=1e-4)
    assert np.abs(rv.grad.numpy()).max() > 0


def test_spmm_octet_bf16_vjp_matches_jax():
    """test_spmm_octet_vjp on bf16 values: X and value cotangents against
    ``jax.vjp`` (rtol 2e-3, atol 0.5), X's against fp64 of the rounded
    values too."""
    packed, jpacked, sp = _spmm_fixture((1500, 1200), 0.002, 9, k_octets=2,
                                        dtype=torch.bfloat16)
    rng = np.random.default_rng(13)
    X = rng.uniform(-1, 1, (1200, 6)).astype(np.float32)
    W = rng.uniform(-1, 1, (1500, 6)).astype(np.float32)
    _, (jdv, jgX) = jit_vjp(lambda vv, xx: joc.spmm_octet(
        dataclasses.replace(jpacked, vals=vv), xx),
        (jpacked.vals, jnp.asarray(X)), jnp.asarray(W))
    v = packed.vals.clone().requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    toc.spmm_octet(dataclasses.replace(packed, vals=v), Xt).backward(
        torch.from_numpy(W))
    sp64 = sp.astype(np.float64)
    sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(jgX), **TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), sp64.T @ W, **TOL)
    assert v.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(v.grad.float().numpy(),
                               np.asarray(jdv.astype(jnp.float32)), **TOL)
    assert (v.grad.float().numpy()[packed.vals.float().numpy() == 0]
            == 0).all()


def test_spmm_prepare_spmv_octet_auto_matches_jax():
    """``spmm(prepare_spmv(A), X)`` on a CSR of ≤ 2 entries a row at
    2048 rows: the auto route packs an octet, and its product equals the
    JAX one and fp64."""
    g = np.random.default_rng(14)
    n = 2048
    rows_ = np.repeat(np.arange(n), 2)
    cols_ = g.integers(0, n, rows_.size)
    sp = sps.coo_matrix((g.uniform(-1000, 1000, rows_.size).astype(
        np.float32), (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A, JA = smt.CSR.from_scipy(sp, device=CPU), jf.CSR.from_scipy(sp)
    P, JP = smt.prepare_spmv(A), jax_prepare_spmv(JA)
    assert isinstance(P, smt.Octet)
    assert_same_container(P, JP)
    X = g.standard_normal((n, 32)).astype(np.float32)
    got = smt.spmm(P, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(joc.spmm_octet)(
        JP, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(got, sp.astype(np.float64) @ X, **TOL)


# ---------------------------------------------------------------------------
# the card walk's side structures (``octet_walk``, ``octet_ranges``) and
# the plain walk over them

WALK_CASES = ["multi-window", "odd-shape", "depth", "trim", "bf16"]


def walk_plain(packed, x, ranges=None):
    """The card walk (``csrc/spmv_octet.cu``) in plain PyTorch, over the
    pack's ``octet_walk`` lists: range by range, octet by octet, each
    listed slab's cells under a nonzero value adding ``vals * x[col]`` (a
    column past ``cols`` read as 0) into the octet's 1024 sums, which are
    stored whole (zeros for an octet with no slab) and cut at ``rows``.
    ``ranges`` (default: one range) must cover the octets."""
    rows, cols = packed.shape
    items, oct_ptr = toc.octet_walk(packed)
    items, oct_ptr = items.long(), oct_ptr.numpy()
    n_oct = oct_ptr.size - 1
    ranges = np.array([0, n_oct]) if ranges is None else ranges
    assert ranges[0] == 0 and ranges[-1] == n_oct
    assert (np.diff(ranges) > 0).all()
    sections = [packed] + ([packed.rem] if packed.rem is not None else [])
    n_main = packed.n_slabs
    planes = [(s.pos.reshape(-1, 8, 128).long() & 127,
               s.chk.reshape(-1, 8, 128).long() & 7,
               s.route.reshape(-1, 8, 128).long() & 127,
               s.vals.reshape(-1, 8, 128).float()) for s in sections]
    y = torch.zeros(n_oct * 1024, dtype=torch.float32)
    u = torch.arange(8)[:, None]
    for r in range(len(ranges) - 1):
        for o in range(ranges[r], ranges[r + 1]):
            acc = torch.zeros(8, 128, dtype=torch.float32)
            for i in range(oct_ptr[o], oct_ptr[o + 1]):
                slab, win = int(items[i, 0]), int(items[i, 1])
                sec = int(slab >= n_main)
                pp, ck, rt, vv = (a[slab - sec * n_main]
                                  for a in planes[sec])
                c = ck[u, rt]
                col = win * 1024 + c * 128 + pp[c, rt]
                ok = (vv != 0) & (col < cols)
                acc = acc + vv * torch.where(
                    ok, x[col.clamp(max=cols - 1)], torch.zeros(()))
            y[o * 1024:(o + 1) * 1024] = acc.reshape(-1)
    return y[:rows]


def _slab_octets(sec):
    """Each slab's octet, from the section's group arrays."""
    sup = sec.group_super.numpy().astype(np.int64)
    n = sec.n_slabs
    return (np.repeat(sup, sec.group)[:n] * sec.k_octets
            + sec.slab_oloc.reshape(-1).numpy()[:n])


@pytest.mark.parametrize("case", WALK_CASES)
def test_octet_walk_lists_each_real_slab_once(case):
    """Every slab of both sections that holds an entry is listed once,
    with its window, under its octet; no padding slab is listed; the
    listed slabs hold all nnz entries."""
    shape, density, kw = CASES[case]
    A, _, sp = both(shape, density)
    assert (sp.data != 0).all()
    packed = toc.pack_octet(A, **kw)
    items, oct_ptr = toc.octet_walk(packed)
    items, oct_ptr = items.numpy(), oct_ptr.numpy()
    assert oct_ptr.shape == (packed.n_octets + 1,) and oct_ptr[0] == 0
    assert (np.diff(oct_ptr) >= 0).all() and oct_ptr[-1] == len(items)
    sections = [packed] + ([packed.rem] if packed.rem is not None else [])
    assert (packed.rem is not None) == (case == "trim")
    real, octet_of, win_of, cells = [], [], [], 0
    base = 0
    for sec in sections:
        nz = (sec.vals.float().reshape(sec.n_slabs, -1) != 0)
        real.append(np.flatnonzero(nz.any(1).numpy()) + base)
        octet_of.append(_slab_octets(sec))
        win_of.append(sec.slab_win.reshape(-1).numpy())
        cells += int(nz.sum())
        base += sec.n_slabs
    real = np.concatenate(real)
    octet_of, win_of = np.concatenate(octet_of), np.concatenate(win_of)
    # each real slab once, nothing else (a padding slab holds only zeros)
    assert np.array_equal(np.sort(items[:, 0]), real)
    assert len(real) < base  # padding slabs to leave out
    assert cells == sp.nnz
    # under its own octet, with its own window
    listed_octet = np.repeat(np.arange(packed.n_octets), np.diff(oct_ptr))
    assert np.array_equal(octet_of[items[:, 0]], listed_octet)
    assert np.array_equal(win_of[items[:, 0]], items[:, 1])


@pytest.mark.parametrize("case", WALK_CASES)
def test_octet_ranges_cover_whole_octets(case):
    """Any slabs a range cuts the octets into ranges that cover
    [0, n_octets) in order, each octet whole, at most one range an octet
    and about the asked slabs a range."""
    shape, density, kw = CASES[case]
    A, _, _ = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    _, oct_ptr = toc.octet_walk(packed)
    oct_ptr = oct_ptr.numpy()
    n_items = int(oct_ptr[-1])
    for spr in (1, 2, 3, 5, 8, n_items, 10 * n_items):
        r = toc.octet_ranges(oct_ptr, spr)
        assert r[0] == 0 and r[-1] == packed.n_octets
        assert (np.diff(r) > 0).all()
        assert len(r) - 1 <= min(packed.n_octets, max(1, -(-n_items // spr)))
    assert len(toc.octet_ranges(oct_ptr, 10 * n_items)) == 2
    assert toc.octet_default_spr(n_items, 1) == max(1, n_items)
    assert toc.octet_default_spr(n_items, 10 ** 6) == 1


def test_octet_ranges_balance():
    """Octets of 0-6 slabs: the ranges' weights (two a slab, one an
    octet) stay within one octet's weight of an equal share."""
    rng = np.random.default_rng(30)
    counts = rng.integers(0, 7, 500)
    oct_ptr = np.r_[0, np.cumsum(counts)]
    r = toc.octet_ranges(oct_ptr, 8)
    cost = np.r_[0, np.cumsum(2 * counts + 1)]
    share = cost[-1] / (len(r) - 1)
    assert len(r) - 1 == -(-int(counts.sum()) // 8)
    assert (np.abs(np.diff(cost[r]) - share) <= 13).all()


@pytest.mark.parametrize("case", WALK_CASES)
def test_octet_walk_plain_matches_reference_and_jax(case):
    """The plain walk over the lists, in one range and in ranges of 2 and
    3 slabs, equals ``spmv_octet_reference``, the JAX ``spmv_octet``
    (Pallas in interpret mode) and fp64 (rtol 2e-3, atol 0.5)."""
    shape, density, kw = CASES[case]
    A, JA, sp = both(shape, density)
    packed = toc.pack_octet(A, **kw)
    jpacked = joc.pack_octet(JA, **_jax_kw(kw))
    x = np.random.default_rng(31).standard_normal(shape[1]).astype(
        np.float32)
    want = toc.spmv_octet_reference(packed, torch.from_numpy(x)).numpy()
    jy = np.asarray(jax.jit(joc.spmv_octet)(jpacked, jnp.asarray(x)))
    sp64 = sp.astype(np.float64)
    if kw.get("dtype") is torch.bfloat16:
        sp64.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    _, oct_ptr = toc.octet_walk(packed)
    for spr in (None, 2, 3):
        ranges = None if spr is None else toc.octet_ranges(oct_ptr.numpy(),
                                                           spr)
        got = walk_plain(packed, torch.from_numpy(x), ranges)
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), jy, **TOL)
        np.testing.assert_allclose(got.numpy(), sp64 @ x, **TOL)


def test_octet_walk_plain_rows_past_the_last_octet_and_no_slab():
    """Octets with no slab come back 0; the ragged last octet is cut at
    ``rows``; a walk of an all-zero pack lists nothing."""
    d = np.zeros((3 * 1024 - 100, 2100), np.float32)
    d[1030, 5], d[1031, 2050], d[3 * 1024 - 101, 7] = 3.0, -2.0, 5.0
    sp = sps.csr_matrix(d)
    packed = toc.pack_octet(smt.CSR.from_scipy(sp, device=CPU), k_octets=2)
    items, oct_ptr = toc.octet_walk(packed)
    assert oct_ptr.tolist() == [0, 0, 2, 3]
    x = np.arange(2100, dtype=np.float32)
    got = walk_plain(packed, torch.from_numpy(x)).numpy()
    assert got.shape == (3 * 1024 - 100,)
    np.testing.assert_array_equal(got, d.astype(np.float64) @ x)
    empty = toc.pack_octet(smt.CSR.fromdense(np.zeros((64, 64), np.float32),
                                             device=CPU))
    items, oct_ptr = toc.octet_walk(empty)
    assert items.shape == (0, 2) and oct_ptr.tolist() == [0, 0]
    assert (walk_plain(empty, torch.ones(64)) == 0).all()


@pytest.mark.parametrize("n_items,n_octets,resident,want", [
    (9365, 4261, 1056, 1),  # enough octets for one-group blocks
    (384, 64, 1056, 4),  # few octets of ~6 slabs
    (128, 64, 1056, 2),
    (64, 64, 1056, 1),  # an octet's one slab needs no second group
    (0, 3, 1056, 1),
])
def test_octet_default_groups(n_items, n_octets, resident, want):
    assert toc.octet_default_groups(n_items, n_octets, resident) == want


def test_rows_script_needs_a_card(monkeypatch):
    """``bench/rows.py`` (rows 15-17 and 22 of one tree against another)
    refuses to run without a CUDA card: it prints no times."""
    rows = importlib.import_module("sparsematrix_tpu_torch.bench.rows")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rows.main(["--no-bench"]) == 2
