"""The fused triangular solve of the port (``kernels/trisolve_fused.py``)
against the JAX package.

Plans must be ``np.array_equal`` to the JAX plans field by field (the
level sort's ``perm``/``rank``, the gate rows, bf16 values bit for bit,
the transposed plan) with equal statics.  ``trisolve_fused_apply`` and
its batched form (the plain segment walk on the CPU) must agree with the
JAX kernel (Pallas in interpret mode) and with an fp64 oracle at the JAX
tests' tolerance, rtol 2e-3 and atol 1e-3 (3e-2 for bf16 values), and so
must the cotangents in ``b`` and in ``plan.vals``.
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

from test_torch_spmv import assert_same_container
from sparsematrix_tpu_torch.formats import CSR
from sparsematrix_tpu_torch.utils.testutils import tri_oracle, triangular
from test_torch_trisolve import SOLVE_TOL, both, jax_kw, one_thread, vec
from test_torch_trisolve_waves import poisson_ilu

jfu = importlib.import_module("sparsematrix_tpu.kernels.trisolve_fused")
tfu = importlib.import_module("sparsematrix_tpu_torch.kernels.trisolve_fused")

BF16_TOL = dict(rtol=3e-2, atol=3e-2)

# name -> (scipy matrix, lower, unit, plan arguments)
CASES = {
    "lower": (lambda: triangular(300, 7), True, False, {}),
    "upper": (lambda: triangular(150, 7, lower=False), False, False, {}),
    "poisson-ilu-L": (lambda: poisson_ilu(16)[0], True, True, {}),
    "poisson-ilu-U": (lambda: poisson_ilu(16)[1], False, False,
                      dict(group=2)),
    "bf16": (lambda: triangular(300, 3, band=60), True, False,
             dict(dtype=torch.bfloat16)),
    "no-level-sort": (lambda: triangular(200, 5, unit=True), True, True,
                      dict(level_sort=False)),
    "with-transpose": (lambda: triangular(260, 5, lower=False), False,
                       False, dict(with_transpose=True)),
    "diagonal": (lambda: sps.diags(np.linspace(1, 2, 100)).tocsr().astype(
        np.float32), True, False, {}),
}


@functools.lru_cache(maxsize=None)
def plans(name):
    mk, lower, unit, kw = CASES[name]
    sp = mk()
    A, JA = both(sp)
    return (sp, tfu.trisolve_fused_plan(A, lower=lower, unit_diagonal=unit,
                                        **kw),
            jfu.trisolve_fused_plan(JA, lower=lower, unit_diagonal=unit,
                                    **jax_kw(kw)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax_and_solves(name):
    _, lower, unit, kw = CASES[name]
    sp, plan, jplan = plans(name)
    assert_same_container(plan, jplan)
    b = vec(sp.shape[0], len(name))
    x = tfu.trisolve_fused_apply(plan, torch.from_numpy(b)).numpy()
    tol = BF16_TOL if "dtype" in kw else SOLVE_TOL
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, unit), **tol)
    np.testing.assert_allclose(
        x, np.asarray(jfu.trisolve_fused_apply(jplan, jnp.asarray(b))), **tol)


def test_batched_apply_matches_jax():
    sp, plan, jplan = plans("poisson-ilu-U")
    B = vec(sp.shape[0], 3, k=3)
    X = tfu.trisolve_fused_apply_batched(plan, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X, tri_oracle(sp, B, lower=False), **SOLVE_TOL)
    np.testing.assert_allclose(
        X, np.asarray(jfu.trisolve_fused_apply_batched(jplan,
                                                       jnp.asarray(B))),
        **SOLVE_TOL)


def test_b_and_vals_cotangents_match_jax():
    sp, plan, jplan = plans("with-transpose")
    n = sp.shape[0]
    b, g = vec(n, 6), vec(n, 7)
    vals = plan.vals.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (tfu.trisolve_fused_apply(dataclasses.replace(plan, vals=vals), bt)
     * torch.from_numpy(g)).sum().backward()

    def loss(v, bb):
        return jnp.vdot(jnp.asarray(g), jfu.trisolve_fused_apply(
            dataclasses.replace(jplan, vals=v), bb))

    jgv, jgb = jax.grad(loss, argnums=(0, 1))(jplan.vals, jnp.asarray(b))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), **SOLVE_TOL)
    np.testing.assert_allclose(bt.grad.numpy(),
                               tri_oracle(sp.T.tocsr(), g, lower=True),
                               **SOLVE_TOL)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(jgv),
                               rtol=2e-3, atol=2e-3)
    assert vals.grad.dtype == plan.vals.dtype


def test_backward_without_transpose_raises():
    _, plan, _ = plans("lower")
    bt = torch.from_numpy(vec(300)).requires_grad_()
    with pytest.raises(ValueError, match="with_transpose=True"):
        tfu.trisolve_fused_apply(plan, bt).sum().backward()


# ---------------------------------------------------------------------------
# the card's wave walk (``segment_waves``, ``fused_walk``), on the CPU
# ---------------------------------------------------------------------------

def _poisson_ic0(side):
    from sparsematrix_tpu_torch.ops import ic0
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    _, sp = poisson2d(side * side)
    L = ic0(CSR.from_scipy(sp.astype(np.float32).tocsr(), device="cpu"))
    return L.to_scipy().astype(np.float32)


def _shared_tile():
    """Rows 1-3 of one tile: x1 reads x0, x2 reads x1, x3 reads x1 and x2,
    but x2 under a stored 0.  So (level 2, tile 0) and (level 3, tile 0)
    both run in wave 2 (a zero adds no dependency)."""
    n = 200
    r = [1, 2, 3, 3] + list(range(n))
    c = [0, 1, 1, 2] + list(range(n))
    v = [0.5, -0.5, 0.25, 0.0] + [2.0] * n
    return sps.csr_matrix((np.asarray(v, np.float32), (r, c)), shape=(n, n))


# name -> (scipy matrix, lower, unit, plan arguments)
WAVE_CASES = {
    "ic0-L": (lambda: _poisson_ic0(32), True, False, {}),
    "ic0-L^T": (lambda: _poisson_ic0(32).T.tocsr(), False, False, {}),
    "ilu0-U": (lambda: poisson_ilu(16)[1], False, False, {}),
    "no-level-sort": (lambda: triangular(500, 4, band=150, seed=2), True,
                      False, dict(level_sort=False)),
    "bf16": (lambda: triangular(400, 3, band=100, seed=3), True, False,
             dict(dtype=torch.bfloat16)),
    "shared-tile": (_shared_tile, True, False, dict(level_sort=False)),
}


@functools.lru_cache(maxsize=None)
def wave_plan(name):
    mk, lower, unit, kw = WAVE_CASES[name]
    sp = mk()
    return sp, tfu.trisolve_fused_plan(CSR.from_scipy(sp, device="cpu"),
                                       lower=lower, unit_diagonal=unit, **kw)


def _binv(plan, b):
    n = plan.shape[0]
    bb = torch.from_numpy(b)
    if plan.perm is not None:
        bb = bb[plan.perm.long()]
    return torch.nn.functional.pad(plan.inv_diag * bb,
                                   (0, plan.n_win * 1024 - n))


def waves_plain(plan, binv, whole_tile=False):
    """The plan walked wave by wave: every segment of a wave gathers x
    before any of them commits, then each commits its tile as the plain
    version does, writing only its gated lanes (or, ``whole_tile``, all
    128 as the first design did)."""
    x = binv.clone()
    seg_wave, n_waves = tfu.segment_waves(plan)
    ptr = tfu._seg_ptr(plan).tolist()
    tiles = plan.group_tile.tolist()
    si = plan.s_idx.reshape(-1, 8, 128)
    vv = plan.vals.reshape(-1, 8, 128)
    for w in range(1, n_waves):
        segs = np.flatnonzero(seg_wave == w).tolist()
        parts = [tfu._segment_part(
            plan, x, slice(ptr[s] * plan.group, ptr[s + 1] * plan.group),
            si, vv) for s in segs]
        seen = x.clone()
        for s, part in zip(segs, parts):
            rows = slice(tiles[ptr[s]] * 128, (tiles[ptr[s]] + 1) * 128)
            xb, bb = seen[rows], binv[rows]
            new = xb + plan.aux[s, 0] * (bb - xb) - part * plan.aux[s, 1]
            x[rows] = new if whole_tile else torch.where(
                plan.aux[s, 0] != 0, new, x[rows])
    return x


def _gated_slots(plan):
    """(row, col, value) of every nonzero slot whose lane its segment
    gates, sorted."""
    seg, lane, col, val = tfu._slots(plan)
    ptr = tfu._seg_ptr(plan).numpy()
    tile = plan.group_tile.numpy().astype(np.int64)[ptr[:-1]][seg]
    keep = (plan.aux[:, 0] != 0).numpy()[seg, lane]
    rows = (tile * 128 + lane)[keep]
    return sorted(zip(rows.tolist(), col[keep].tolist(),
                      val[keep].tolist()))


@pytest.mark.parametrize("name", sorted(WAVE_CASES))
def test_segment_waves(name):
    """Every nonzero slot gathers only rows that no segment commits or
    that a segment of an earlier wave commits; on level-sorted Poisson
    plans the waves are the levels."""
    _, plan = wave_plan(name)
    seg_wave, n_waves = tfu.segment_waves(plan)
    assert seg_wave.min() >= 1 and n_waves == seg_wave.max() + 1
    ptr = tfu._seg_ptr(plan).numpy().astype(np.int64)
    seg_tile = plan.group_tile.numpy().astype(np.int64)[ptr[:-1]]
    wave_of_row = np.zeros(plan.n_win * 1024, np.int64)
    gs, gl = np.nonzero((plan.aux[:, 0] != 0).numpy())
    wave_of_row[seg_tile[gs] * 128 + gl] = seg_wave[gs]
    seg, _, col, _ = tfu._slots(plan)
    assert (wave_of_row[col] < seg_wave[seg]).all()
    if name.startswith("ic0"):
        assert n_waves == plan.n_levels
    if name == "shared-tile":
        tile_of = seg_tile[np.flatnonzero(seg_wave == 2)]
        assert len(tile_of) == 2 and tile_of[0] == tile_of[1]


@pytest.mark.parametrize("name", sorted(WAVE_CASES))
def test_wave_walk_equals_plain(name):
    """The wave walk with commits of the gated lanes gives the plain
    version's bits; the card's walk lists exactly the gated nonzero slots
    and solves within the tolerance."""
    sp, plan = wave_plan(name)
    _, lower, unit, kw = WAVE_CASES[name]
    n = sp.shape[0]
    b = vec(n, 11)
    binv = _binv(plan, b)
    want = tfu._fused_plain(plan, binv)
    assert torch.equal(waves_plain(plan, binv), want)
    walk = tfu.fused_walk(plan)
    assert walk.n_waves == tfu.segment_waves(plan)[1] - 1
    assert walk.entries == len(_gated_slots(plan))
    got = tfu.fused_walk_plain(walk, binv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if "dtype" not in kw:
        x = got[:n]
        if plan.perm is not None:
            x = x[plan.rank.long()]
        np.testing.assert_allclose(x.numpy(), tri_oracle(sp, b, lower, unit),
                                   **SOLVE_TOL)


def test_shared_tile_needs_gated_commits():
    """Two segments of one tile share wave 2: a commit that writes all
    128 lanes puts back the other's row and loses it."""
    _, plan = wave_plan("shared-tile")
    binv = _binv(plan, vec(200, 12))
    want = tfu._fused_plain(plan, binv)
    assert torch.equal(waves_plain(plan, binv), want)
    assert not torch.equal(waves_plain(plan, binv, whole_tile=True), want)


def test_fused_walk_layout():
    """The walk's chunks: each row of one wave, in wave order, every
    committed row once, each entry of its own row's gated slots."""
    _, plan = wave_plan("ilu0-U")
    walk = tfu.fused_walk(plan)
    seg_wave, _ = tfu.segment_waves(plan)
    ptr = tfu._seg_ptr(plan).numpy().astype(np.int64)
    seg_tile = plan.group_tile.numpy().astype(np.int64)[ptr[:-1]]
    gs, gl = np.nonzero((plan.aux[:, 0] != 0).numpy())
    row_wave = dict(zip((seg_tile[gs] * 128 + gl).tolist(),
                        seg_wave[gs].tolist()))
    blob = walk.blob.numpy()
    off = (walk.chunk_off.numpy() // 4).tolist()
    rows, entries, last = [], [], 0
    for c in range(walk.n_chunks):
        w = blob[off[c]:off[c + 1]]
        nr, ne = int(w[0]), int(w[1])
        rec = w[4:4 + 4 * nr].reshape(nr, 4)
        ent = w[4 + 4 * nr:4 + 4 * nr + 2 * ne].reshape(ne, 2)
        waves = {row_wave[int(r)] for r in rec[:, 0]}
        lo, run = w[2], w[3]
        assert (lo, run) == tuple(walk.span[c].tolist())
        if lo >= 0:  # the run of binv holds every row of the chunk
            assert lo % 4 == 0 and run % 4 == 0
            assert lo <= rec[:, 0].min() and rec[:, 0].max() < lo + run
        assert len(waves) == 1 and min(waves) >= last
        last = min(waves)
        assert rec[0, 1] == 0 and rec[-1, 2] == ne
        assert (rec[1:, 1] == rec[:-1, 2]).all()
        for r, e0, e1, _ in rec:
            rows.append(int(r))
            entries += [(int(r), int(cc) & 0x7fffffff, float(np.int32(vb).view(
                np.float32))) for cc, vb in ent[e0:e1]]
    assert sorted(rows) == sorted(row_wave) and len(rows) == walk.rows
    assert sorted(entries) == _gated_slots(plan)
    assert (walk.span[:, 0] >= 0).all()  # a level-sorted plan's waves
