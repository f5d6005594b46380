"""The wave triangular solve of the port (``kernels/trisolve_waves.py``)
against the JAX package.

Plans must be ``np.array_equal`` to the JAX plans field by field (bf16
planes bit for bit, the transposed plan and the gradient pattern
included) with equal statics.  ``trisolve_waves_apply``, ``_apply_mm``
and ``_solve`` (the plain chain and binv programs on the CPU) must agree
with an fp64 oracle, and on a case of each kind with the JAX kernels
(Pallas in interpret mode, a compile each), at the JAX tests' tolerance,
rtol 2e-3 and atol 1e-3 (3e-2 for bf16 plans, the JAX bf16 test's); so
must the cotangents in ``b`` and the values.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from test_torch_spmv import assert_same_container
from sparsematrix_tpu_torch.utils.testutils import tri_oracle, triangular
from test_torch_trisolve import SOLVE_TOL, both, jax_kw, one_thread, vec

jw = importlib.import_module("sparsematrix_tpu.kernels.trisolve_waves")
tw = importlib.import_module("sparsematrix_tpu_torch.kernels.trisolve_waves")
jilu = importlib.import_module("sparsematrix_tpu.ops.ilu")

BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@functools.lru_cache(maxsize=None)
def poisson_ilu(side):
    """The ILU(0) factors of the side×side Poisson system, as scipy."""
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    _, sp = poisson2d(side * side)
    L, U = jilu.ilu0(both(sp.astype(np.float32))[1])
    return L.to_scipy().astype(np.float32), U.to_scipy().astype(np.float32)


# name -> (scipy matrix, lower, unit, plan arguments, expected mode, K)
CASES = {
    "poisson-ilu-L": (lambda: poisson_ilu(32)[0], True, True, {}, "chain", 1),
    "poisson-ilu-U": (lambda: poisson_ilu(32)[1], False, False, {}, "chain",
                      1),
    "band-reach-1": (lambda: triangular(300, 2, band=100), True, False, {},
                     "chain", 1),
    "band-reach-2": (lambda: triangular(1300, 2, band=200), True, False, {},
                     "chain", 2),
    "band-reach-3": (lambda: triangular(1100, 4, band=380), True, False, {},
                     "chain", 3),
    "binv-m2": (lambda: triangular(900, 4), True, False, dict(m=2), "binv",
                None),
    "binv-m8": (lambda: triangular(1100, 5), True, False, dict(m=8), "binv",
                None),
    "binv-upper-unit": (lambda: triangular(640, 5, unit=True,
                                                lower=False),
                        False, True, dict(mode="binv", m=4), "binv", None),
    "bf16": (lambda: triangular(512, 2, band=90), True, False,
             dict(dtype=torch.bfloat16), "chain", 1),
    "with-transpose": (lambda: triangular(1300, 2, band=200), True, False,
                       dict(with_transpose=True), "chain", 2),
    "with-grads-binv": (lambda: triangular(384, 4, lower=False), False,
                        False, dict(mode="binv", m=2, with_grads=True),
                        "binv", None),
    "diagonal": (lambda: sps.diags(np.linspace(1, 2, 200)).tocsr().astype(
        np.float32), True, False, {}, "chain", 1),
}


@functools.lru_cache(maxsize=None)
def plans(name):
    mk, lower, unit, kw, _, _ = CASES[name]
    sp = mk()
    A, JA = both(sp)
    return (sp, tw.trisolve_waves_plan(A, lower=lower, unit_diagonal=unit,
                                       **kw),
            jw.trisolve_waves_plan(JA, lower=lower, unit_diagonal=unit,
                                   **jax_kw(kw)))


# the cases whose solve is also held against the JAX kernel (each JAX
# call compiles an interpret-mode kernel); every plan is compared
JAX_SOLVES = {"band-reach-3", "binv-m2", "binv-upper-unit", "bf16"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax_and_solves(name):
    _, lower, unit, kw, mode, K = CASES[name]
    sp, plan, jplan = plans(name)
    assert plan.mode == mode and (K is None or plan.K == K)
    assert_same_container(plan, jplan)
    b = vec(sp.shape[0], len(name))
    x = tw.trisolve_waves_apply(plan, torch.from_numpy(b)).numpy()
    tol = BF16_TOL if "dtype" in kw else SOLVE_TOL
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, unit), **tol)
    if name in JAX_SOLVES:
        jx = np.asarray(jw.trisolve_waves_apply(jplan, jnp.asarray(b)))
        np.testing.assert_allclose(x, jx, **tol)


@pytest.mark.parametrize("name,k,jax_cmp", [
    ("band-reach-2", 1, False), ("band-reach-2", 12, True),
    ("poisson-ilu-U", 8, False), ("binv-m2", 3, True)])
def test_apply_mm_matches_jax(name, k, jax_cmp):
    """8 RHS a chain pane (a ragged second pane at k = 12), the upper
    solve through the panel reversal, binv a column at a time; the JAX
    kernels (one interpret-mode compile each) on two of the cases."""
    _, lower, unit, _, _, _ = CASES[name]
    sp, plan, jplan = plans(name)
    B = vec(sp.shape[0], k, k=k)
    X = tw.trisolve_waves_apply_mm(plan, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X, tri_oracle(sp, B, lower, unit), **SOLVE_TOL)
    if jax_cmp:
        np.testing.assert_allclose(
            X, np.asarray(jw.trisolve_waves_apply_mm(jplan, jnp.asarray(B))),
            **SOLVE_TOL)


def test_rev_pad_is_the_jax_reversal():
    v = np.arange(1024, dtype=np.float32)
    for n in (1, 700, 1024):
        np.testing.assert_array_equal(
            tw._rev_pad(torch.from_numpy(v), n, 1024).numpy(),
            np.asarray(jw._rev_pad(jnp.asarray(v), n, 1024)))


@pytest.mark.parametrize("mm", [False, True])
def test_b_cotangent_matches_jax(mm):
    sp, plan, jplan = plans("with-transpose")
    n = sp.shape[0]
    b, g = vec(n, 1, k=3 if mm else None), vec(n, 2, k=3 if mm else None)
    fn, jfn = ((tw.trisolve_waves_apply_mm, jw.trisolve_waves_apply_mm) if mm
               else (tw.trisolve_waves_apply, jw.trisolve_waves_apply))
    bt = torch.from_numpy(b).requires_grad_()
    (fn(plan, bt) * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda bb: jfn(jplan, bb), jnp.asarray(b))
    (jgb,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), **SOLVE_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), tri_oracle(sp.T.tocsr(), g,
                                                       lower=False),
                               **SOLVE_TOL)


def test_backward_without_transpose_raises():
    _, plan, _ = plans("band-reach-1")
    bt = torch.from_numpy(vec(300)).requires_grad_()
    with pytest.raises(ValueError, match="with_transpose=True"):
        tw.trisolve_waves_apply(plan, bt).sum().backward()


@pytest.mark.parametrize("case", ["chain-unit", "binv-upper"])
def test_solve_value_and_b_cotangents_match_jax(case):
    if case == "chain-unit":
        sp, lower, unit = poisson_ilu(16)[0], True, True
        kw = dict(with_grads=True)
    else:
        sp, lower, unit = triangular(384, 4, lower=False), False, False
        kw = dict(mode="binv", m=2, with_grads=True)
    A, JA = both(sp)
    plan = tw.trisolve_waves_plan(A, lower=lower, unit_diagonal=unit, **kw)
    jplan = jw.trisolve_waves_plan(JA, lower=lower, unit_diagonal=unit,
                                   **kw)
    assert_same_container(plan, jplan)
    n = sp.shape[0]
    b, w = vec(n, 4), vec(n, 5)
    vals = A.data.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (tw.trisolve_waves_solve(plan, vals, bt)
     * torch.from_numpy(w)).sum().backward()

    def loss(v, bb):
        return jnp.vdot(jnp.asarray(w), jw.trisolve_waves_solve(jplan, v, bb))

    jgv, jgb = jax.grad(loss, argnums=(0, 1))(JA.data, jnp.asarray(b))
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(jgv),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), **SOLVE_TOL)
    np.testing.assert_allclose(bt.grad.numpy(),
                               tri_oracle(sp.T.tocsr(), w, not lower, unit),
                               **SOLVE_TOL)


def test_binv_m_not_dividing_8_raises():
    """The JAX binv commit places wave tiles inside one 8-row block, so a
    plan with m = 3 solves wrongly there (ROADMAP Queue 3); the port's
    planner builds the same plan and its apply refuses it."""
    sp = triangular(1500, 7)
    A, JA = both(sp)
    plan = tw.trisolve_waves_plan(A, mode="binv", m=3)
    assert_same_container(plan, jw.trisolve_waves_plan(JA, mode="binv", m=3))
    with pytest.raises(ValueError, match="m dividing 8"):
        tw.trisolve_waves_apply(plan, torch.from_numpy(vec(1500)))


# ---------------------------------------------------------------------------
# binv's work list (the card kernel's program), held to its invariants and
# walked in ticket order on the CPU

def _empty_waves():
    """A lower factor whose waves 2, 3 and 5 (m = 1) hold no cross-wave
    entry: their groups are the packer's all-zero padding only."""
    sp = triangular(1200, 4, band=300).tocoo()
    wave = sp.row // 128
    keep = ~np.isin(wave, (2, 3, 5)) | (sp.col // 128 == wave)
    return sps.csr_matrix((sp.data[keep], (sp.row[keep], sp.col[keep])),
                          shape=sp.shape)


# name -> (scipy matrix, lower, plan arguments)
ITEM_CASES = {
    "m1": (lambda: triangular(1500, 3), True, dict(mode="binv", m=1)),
    "m2": (lambda: triangular(900, 4), True, dict(m=2)),
    "m4": (lambda: triangular(1700, 3, unit=True), True, dict(m=4)),
    "m8": (lambda: triangular(2500, 4), True, dict(m=8)),
    "empty-waves": (_empty_waves, True, dict(mode="binv", m=1)),
    "no-cross": (lambda: sps.diags(np.linspace(1, 2, 700)).tocsr().astype(
        np.float32), True, dict(mode="binv", m=2)),
    "upper": (lambda: triangular(640, 5, lower=False), False,
              dict(mode="binv", m=4)),
    "bf16": (lambda: triangular(2500, 4), True,
             dict(m=8, dtype=torch.bfloat16)),
    # no late slab folded: every one a gather item of its own
    "m8-unfolded": (lambda: triangular(2500, 4, seed=3), True, dict(m=8)),
    "m1-unfolded": (lambda: triangular(1500, 3, seed=3), True,
                    dict(mode="binv", m=1)),
}


@functools.lru_cache(maxsize=None)
def item_plan(name):
    mk, lower, kw = ITEM_CASES[name]
    sp = mk()
    A, JA = both(sp)
    plan = tw.trisolve_waves_plan(A, lower=lower, **kw)
    assert plan.mode == "binv"
    fold = tw._FOLD_SLABS
    try:  # the work list is built here and cached with the plan
        tw._FOLD_SLABS = 0 if name.endswith("-unfolded") else fold
        tw.binv_items(plan)
    finally:
        tw._FOLD_SLABS = fold
    return sp, lower, plan, JA, kw


def _walk(plan, bp):
    """The kernel's program in plain torch: the items in ticket order,
    each asserting that the counters it waits on have reached their
    targets (so no item ever waits on a later ticket)."""
    items = tw.binv_items(plan).numpy()
    m, L = plan.m, 128
    T = m * (m + 1) // 2
    cnt = np.zeros(1 + plan.n_waves * (1 + m), np.int64)
    x, acc = torch.zeros_like(bp), torch.zeros_like(bp)
    a1 = plan.a1.float()
    for it in items.tolist():
        (kind, tile, tq, i, sa, sb, lo, hi, target, wlo, whi,
         signal) = it
        assert (cnt[lo:hi] >= target).all() and (cnt[wlo:whi] >= T).all()
        g = tw._slab_sums(plan, sa, sb, x).sum(0)
        if kind == tw._PRODUCT:
            qb, p = tq - i * m, tile - i * m
            u = bp[tq * L:(tq + 1) * L] - acc[tq * L:(tq + 1) * L] - g
            x[tile * L:(tile + 1) * L] += u @ a1[i, qb * L:(qb + 1) * L,
                                                 p * L:(p + 1) * L]
        else:
            acc[tile * L:(tile + 1) * L] += g
        cnt[signal] += 1
    return x


@pytest.mark.parametrize("name", sorted(ITEM_CASES))
def test_binv_items_invariants(name):
    _, _, plan, _, _ = item_plan(name)
    items = tw.binv_items(plan).numpy().astype(np.int64)
    m, nw, group = plan.m, plan.n_waves, plan.group
    T = m * (m + 1) // 2
    kind = items[:, tw._KIND]
    g, p = items[kind == tw._GATHER], items[kind == tw._PRODUCT]
    # m(m+1)/2 products a wave, one a block q <= p
    assert len(p) == nw * T
    assert len({(r[tw._TILE_Q], r[tw._TILE]) for r in p}) == len(p)
    assert ((p[:, tw._TILE_Q] <= p[:, tw._TILE])
            & (p[:, tw._TILE_Q] // m == p[:, tw._WAVE])
            & (p[:, tw._TILE] // m == p[:, tw._WAVE])).all()
    # each slab up to its wave's last nonzero one either in exactly one
    # gather, of its own tile, or folded into every product of its tile
    # (at most _FOLD_SLABS of them, all reading the previous wave's
    # window); the trailing all-zero padding in none
    n_slabs = plan.slab_win.shape[0]
    wave = np.repeat(plan.group_wave.numpy(), group)
    tloc = plan.slab_tloc.numpy()
    win = plan.slab_win.numpy()
    nz = (plan.vals.reshape(n_slabs, -1) != 0).any(1).numpy()
    in_gather = np.zeros(n_slabs, np.int64)
    for r in g:
        s = np.arange(r[tw._SLAB_A], r[tw._SLAB_B])
        in_gather[s] += 1
        assert (wave[s] * m + tloc[s] == r[tw._TILE]).all()
        assert 0 < s.size <= tw._ITEM_SLABS
    folded = np.zeros(n_slabs, np.int64)
    for r in p:
        s = np.arange(r[tw._SLAB_A], r[tw._SLAB_B])
        folded[s] += 1
        assert (wave[s] * m + tloc[s] == r[tw._TILE_Q]).all()
        assert s.size <= tw._FOLD_SLABS
        assert (np.minimum((8 // m) * (win[s] + 1), wave[s]) - 1
                == r[tw._WAVE] - 1).all()
    for i in range(nw):
        mine = np.nonzero(wave == i)[0]
        last = mine[nz[mine]].max() if nz[mine].any() else mine[0] - 1
        real, pad = mine[mine <= last], mine[mine > last]
        q = tloc[real]
        assert ((in_gather[real] == 1) & (folded[real] == 0)
                | (in_gather[real] == 0) & (folded[real] == m - q)).all()
        assert (in_gather[pad] == 0).all() and (folded[pad] == 0).all()
    if name == "empty-waves":
        assert {2, 3, 5} <= set(range(nw)) - set(g[:, tw._TILE] // m)
    if name in ("m8", "upper"):
        assert (folded > 0).any()
    if name.endswith("-unfolded"):
        assert not folded.any()
    # a product waits for exactly the gathers of its tile q
    expect = np.bincount(g[:, tw._TILE], minlength=nw * m)
    assert (p[:, tw._TARGET] == expect[p[:, tw._TILE_Q]]).all()
    # every counter an item waits on is raised only by lower tickets, as
    # many times as the target says
    signals = {}
    for t, c in enumerate(items[:, tw._SIGNAL]):
        signals.setdefault(c, []).append(t)
    for t, r in enumerate(items):
        for lo, hi, target in ((r[tw._WAIT_LO], r[tw._WAIT_HI],
                                r[tw._TARGET]),
                               (r[tw._WAVES_LO], r[tw._WAVES_HI], T)):
            for c in range(lo, hi):
                by = signals.get(c, [])
                assert len(by) == target and max(by, default=-1) < t


@pytest.mark.parametrize("name", sorted(ITEM_CASES))
def test_binv_items_walk_matches_plain_and_jax(name):
    """The ticket-order walk gives the plain program's x, and the solve
    the JAX kernel's (interpret mode) and the fp64 oracle's."""
    sp, lower, plan, JA, kw = item_plan(name)
    n, N = sp.shape[0], plan.S * 128
    b = vec(n, 7)
    bp = torch.zeros(N)
    bp[:n] = torch.from_numpy(b)
    if plan.reversed:
        bp = tw._rev_pad(bp, n, N)
    x = _walk(plan, bp)
    tol = BF16_TOL if "dtype" in kw else SOLVE_TOL
    np.testing.assert_allclose(x.numpy(), tw._binv_plain(plan, bp).numpy(),
                               **tol)
    if plan.reversed:
        x = tw._rev_pad(x, n, N)
    x = x[:n].numpy()
    jplan = jw.trisolve_waves_plan(JA, lower=lower, **jax_kw(kw))
    np.testing.assert_allclose(
        x, np.asarray(jw.trisolve_waves_apply(jplan, jnp.asarray(b))), **tol)
    np.testing.assert_allclose(x, tri_oracle(sp, b, lower, False), **(
        BF16_TOL if "dtype" in kw else SOLVE_TOL))


def _walk_any(plan, bp, pick):
    """The kernel's program out of ticket order: at each step ``pick``
    chooses one of the items whose waits are met, any of which may run
    first on the card.  What an item may not read yet is NaN: the x of a
    wave not committed, the acc of a tile whose gathers are not all done.
    Each slab an item reads must lie in a window whose waves its wait
    covers, and so must each cell it reads (value ≠ 0, column in range).
    Returns x."""
    items = tw.binv_items(plan).numpy().astype(np.int64)
    m, L, nw = plan.m, 128, plan.n_waves
    B, T, N = m * L, m * (m + 1) // 2, plan.S * L
    per = 8 // m
    wave = np.repeat(plan.group_wave.numpy(), plan.group)
    win = plan.slab_win.numpy()
    gathers = np.bincount(items[items[:, tw._KIND] == tw._GATHER, tw._TILE],
                          minlength=nw * m)
    row_wave = torch.arange(N) // B
    si = plan.s_idx.reshape(-1, 8, L)
    vv = plan.vals.reshape(-1, 8, L).float()
    a1 = plan.a1.float()
    cnt = np.zeros(1 + nw * (1 + m), np.int64)
    x, acc = torch.zeros_like(bp), torch.zeros_like(bp)
    nan = torch.tensor(float("nan"))
    todo = list(range(len(items)))
    while todo:
        ready = [t for t in todo
                 if (cnt[items[t, tw._WAIT_LO]:items[t, tw._WAIT_HI]]
                     >= items[t, tw._TARGET]).all()
                 and (cnt[items[t, tw._WAVES_LO]:items[t, tw._WAVES_HI]]
                      >= T).all()]
        assert ready, "no item can run: the walk is stuck"
        t = pick(ready)
        todo.remove(t)
        (kind, tile, tq, i, sa, sb, lo, hi, target, wlo, whi,
         signal) = items[t].tolist()
        s = np.arange(sa, sb)
        assert (per * win[s] >= wlo - 1).all()
        assert (np.minimum(per * (win[s] + 1), wave[s]) <= whi - 1).all()
        col, ok = tw._slab_cols(si[sa:sb], plan.slab_win[sa:sb], N)
        live = ok & (vv[sa:sb] != 0)
        w_read = row_wave[col[live]]
        assert ((w_read >= wlo - 1) & (w_read < whi - 1)).all()
        committed = torch.from_numpy(np.append(cnt[1:1 + nw] == T, False))
        seen = torch.where(committed[row_wave.clamp(max=nw)], x, nan)
        g = torch.where(live, vv[sa:sb] * seen[col], 0.0).sum((0, 1))
        if kind == tw._PRODUCT:
            qb, p = tq - i * m, tile - i * m
            done = cnt[1 + nw + tq] == gathers[tq]
            u = (bp[tq * L:(tq + 1) * L] - g
                 - (acc[tq * L:(tq + 1) * L] if done else nan))
            x[tile * L:(tile + 1) * L] += u @ a1[i, qb * L:(qb + 1) * L,
                                                 p * L:(p + 1) * L]
        else:
            acc[tile * L:(tile + 1) * L] += g
        cnt[signal] += 1
    return x


def _picker(order):
    """How the walk picks among the ready items: the latest ticket, or at
    random from a seed."""
    if order == "latest":
        return max
    rng = np.random.default_rng(int(order[len("random"):]))
    return lambda ready: ready[rng.integers(len(ready))]


@pytest.mark.parametrize("order", ["latest", "random0", "random1",
                                   "random2"])
@pytest.mark.parametrize("name", sorted(ITEM_CASES))
def test_binv_items_any_ready_order_matches_plain(name, order):
    """Whatever order the card runs the ready items in, every read waits
    for what it reads (a read too early meets NaN) and x is the plain
    program's."""
    sp, _, plan, _, kw = item_plan(name)
    n, N = sp.shape[0], plan.S * 128
    bp = torch.zeros(N)
    bp[:n] = torch.from_numpy(vec(n, 7))
    if plan.reversed:
        bp = tw._rev_pad(bp, n, N)
    x = _walk_any(plan, bp, _picker(order))
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.numpy(), tw._binv_plain(plan, bp).numpy(),
                               **(BF16_TOL if "dtype" in kw else SOLVE_TOL))


def test_chain_kernel_refuses_cpu_tensors():
    """The chain kernel's wrapper takes CUDA tensors only, at one and
    eight right-hand sides and whatever its knobs (the plain program
    serves the CPU); its default cluster size is one the kernel takes."""
    from sparsematrix_tpu_torch.formats import CSR

    plan = tw.trisolve_waves_plan(CSR.from_scipy(
        triangular(300, 2, band=100), device="cpu"))
    b = torch.zeros(plan.S * 128)
    for rhs in (1, 8):
        for kw in ({}, dict(cluster=8, stages=2), dict(parts=1)):
            with pytest.raises(ValueError, match="CUDA"):
                tw._chain_cuda(plan, b, rhs, **kw)
    assert tw.CHAIN_CLUSTER in (2, 4, 8, 16)


@pytest.mark.parametrize("groups", ["copy,octet", "chain,knobs", "cg", "bsr,sb",
                                    "rl", "tile"])
def test_rows_chain_groups_need_a_card(monkeypatch, groups):
    """``bench/rows.py``'s groups (rows 19 and 21's among them) print no
    times without a CUDA card; an unknown group is refused."""
    rows = importlib.import_module("sparsematrix_tpu_torch.bench.rows")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rows.main(["--groups", groups]) == 2
    with pytest.raises(SystemExit):
        rows.main(["--groups", groups + ",nope"])
