"""The planned permutations of the port (``ops/permute.py``,
``ops/permute_clos.py``, ``kernels/window_permute.py``) against the JAX
package.

Plans must be field-equal to the JAX plans from the same map; applies
must equal ``x[g]`` exactly (sentinel slots read 0) and the JAX apply
(the window-permute Pallas kernel in interpret mode).  The JAX planner
calls its batched edge colourer without declaring the argument types, so
on this ABI the call reads stack garbage and, depending on what the stack
holds, refuses and falls back to the generic colourer (ROADMAP.md
Queue 3).  The plane-equality cases therefore give the JAX planner the
same call with the types declared (``jax_batched_colorer``), which is
what the port does.
"""
import ctypes
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrix_tpu.ops.permute import (apply_permutation as jax_apply,
                                          plan_gather_permutation as jax_gplan,
                                          plan_permutation_auto as jax_auto)
from sparsematrix_tpu.ops.permute_clos import (
    plan_clos_permutation as jax_cplan)
from sparsematrix_tpu_torch.kernels.window_permute import (
    window_permute, window_permute_reference)
from sparsematrix_tpu_torch.ops.permute import (PermutePlan, apply_permutation,
                                                plan_gather_permutation,
                                                plan_permutation_auto)
from sparsematrix_tpu_torch.ops.permute_clos import (ClosPermutePlan,
                                                     plan_clos_permutation)
from test_torch_spmv import assert_same_container

jclos = importlib.import_module("sparsematrix_tpu.ops.permute_clos")
tclos = importlib.import_module("sparsematrix_tpu_torch.ops.permute_clos")
CPU = "cpu"


def _jax_batched_native():
    """The JAX library's batched splitter on a handle of its own, with the
    argument types declared (the JAX package's handle stays as it is)."""
    from sparsematrix_tpu import native

    fn = ctypes.CDLL(native.get_lib()._name).smtpu_edge_color_batched
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_long
    return fn


def jax_batched_colorer(monkeypatch):
    """Makes the JAX planner call its batched colourer with the argument
    types declared: ``_edge_color_grouped`` of the JAX package, line for
    line, but for the declared types."""
    fn = _jax_batched_native()

    def grouped(batch, left_small, right_small, n_batch, nsmall, n_colors):
        l32 = np.ascontiguousarray(left_small, np.int32)
        r32 = np.ascontiguousarray(right_small, np.int32)
        b32 = np.ascontiguousarray(batch, np.int32)
        out = np.empty(len(l32), np.int32)
        if fn(l32.ctypes.data, r32.ctypes.data, b32.ctypes.data, len(l32),
              n_batch, nsmall, nsmall, n_colors, out.ctypes.data) == 0:
            return out.astype(np.int64)
        return jclos._edge_color(batch * nsmall + left_small,
                                 batch * nsmall + right_small,
                                 n_batch * nsmall, n_batch * nsmall, n_colors)

    monkeypatch.setattr(jclos, "_edge_color_grouped", grouped)


@pytest.fixture
def same_colorer(monkeypatch):
    jax_batched_colorer(monkeypatch)


def _partial_map(rng, n_src, n_out, n_live):
    """An injective map with sentinel slots (n_src + 7) reading 0."""
    g = np.full(n_out, n_src + 7, np.int64)
    live = rng.choice(n_out, size=n_live, replace=False)
    g[live] = rng.choice(n_src, size=n_live, replace=False)
    return g, live


def _want(x, g, n_src):
    out = np.zeros((len(g),) + x.shape[1:], x.dtype)
    live = g < n_src
    out[live] = x[g[live]]
    return out


MAPS = {
    "permutation": lambda rng: (rng.permutation(3000), 3000),
    "sentinels-expand": lambda rng: (_partial_map(rng, 600, 900, 600)[0], 600),
    "dropped-sources": lambda rng: (rng.choice(800, 500, replace=False), 800),
    "sentinel-on-live-id": lambda rng: (np.array([5, 9, 2, 0, 1]), 4),
}


@pytest.mark.parametrize("force_sort", [None, True, False])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_gather_plan_matches_jax(name, force_sort):
    rng = np.random.default_rng(0)
    g, n_src = MAPS[name](rng)
    plan = plan_gather_permutation(g, n_src, force_sort=force_sort,
                                   device=CPU)
    ref = jax_gplan(g, n_src, force_sort=force_sort)
    assert isinstance(plan, PermutePlan)
    assert_same_container(plan, ref)
    x = rng.standard_normal(n_src + 3).astype(np.float32)  # tail ignored
    got = apply_permutation(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _want(x[:n_src], g, n_src))
    np.testing.assert_array_equal(got, np.asarray(jax_apply(ref,
                                                            jnp.asarray(x))))
    X = rng.standard_normal((n_src, 3)).astype(np.float32)
    got2 = apply_permutation(plan, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got2, _want(X, g, n_src))
    np.testing.assert_array_equal(got2, np.asarray(jax_apply(ref,
                                                             jnp.asarray(X))))


CLOS = {
    "R8": lambda rng: (rng.permutation(8192), 8192),
    "R32": lambda rng: (rng.permutation(20_000), 20_000),
    "sentinels": lambda rng: (_partial_map(rng, 30_000, 33_000, 25_000)[0],
                              30_000),
    "dropped": lambda rng: (rng.choice(40_000, 30_000, replace=False),
                            40_000),
}


@pytest.mark.parametrize("name", sorted(CLOS))
def test_clos_plan_matches_jax(name, same_colorer):
    rng = np.random.default_rng(1)
    g, n_src = CLOS[name](rng)
    plan = plan_clos_permutation(g, n_src, device=CPU)
    ref = jax_cplan(g, n_src)
    assert isinstance(plan, ClosPermutePlan) and plan.q == 1
    if len(g) >= 1 << 14:  # the auto planner picks the Clos plan
        assert_same_container(plan_permutation_auto(g, n_src, device=CPU),
                              jax_auto(g, n_src))
    assert_same_container(plan, ref)
    x = rng.uniform(-10, 10, n_src).astype(np.float32)
    got = apply_permutation(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _want(x, g, n_src))
    np.testing.assert_array_equal(got, np.asarray(jax_apply(ref,
                                                            jnp.asarray(x))))
    X = rng.standard_normal((n_src, 4)).astype(np.float32)
    got2 = apply_permutation(plan, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got2, _want(X, g, n_src))
    np.testing.assert_array_equal(got2, np.asarray(jax_apply(ref,
                                                             jnp.asarray(X))))


def test_clos_int_payload():
    rng = np.random.default_rng(2)
    n = 20_000
    g = rng.permutation(n)
    plan = plan_clos_permutation(g, n_src=n, device=CPU)
    x = rng.integers(-2**30, 2**30, n).astype(np.int32)
    got = apply_permutation(plan, torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x[g])


def test_edge_colorers_match_jax():
    """The port's copies of the native colourers and of the Python Euler
    split give the JAX package's colours."""
    rng = np.random.default_rng(3)
    R = 32
    p = rng.permutation(R * 1024)
    left, right = p // 1024, np.arange(R * 1024) // 1024
    np.testing.assert_array_equal(
        tclos._edge_color_native(left, right, R, R, 1024),
        jclos._edge_color_native(left, right, R, R, 1024))
    R, C = 16, 32
    p = rng.permutation(R * C)
    left, right = p // C, np.arange(R * C) // C
    np.testing.assert_array_equal(
        tclos._edge_color_py(left, right, R, R, C),
        jclos._edge_color_py(left, right, R, R, C))
    # the batched splitter against the JAX library's, argument types set
    fn = _jax_batched_native()
    win = np.repeat(np.arange(6), 1024)
    src = np.concatenate([rng.permutation(1024) for _ in range(6)])
    dst = np.tile(np.arange(1024), 6)
    l32 = np.ascontiguousarray(dst // 128, np.int32)
    r32 = np.ascontiguousarray(src // 128, np.int32)
    b32 = np.ascontiguousarray(win, np.int32)
    out = np.empty(len(l32), np.int32)
    assert fn(l32.ctypes.data, r32.ctypes.data, b32.ctypes.data, len(l32), 6,
              8, 8, 128, out.ctypes.data) == 0
    got = tclos._edge_color_batched_native(win, dst // 128, src // 128, 6, 8,
                                           128)
    np.testing.assert_array_equal(got, out)


def _assert_valid_planes(trip):
    """Every window's three planes route a bijection of its 1024 cells."""
    pos, chk, rte = (t.long() for t in trip)
    cells = torch.arange(1024, dtype=torch.int32).expand(pos.shape[0], 1024)
    routed = window_permute_reference(cells.reshape(-1, 8, 128).contiguous(),
                                      pos, chk, rte).reshape(-1, 1024)
    assert torch.equal(routed.sort(dim=1).values, cells)


def test_clos_two_level_plan():
    """A q = 2 plan at ~1.2 M elements (the batched native colourer): its
    planes route bijections, and the plain apply equals ``x[g]``."""
    rng = np.random.default_rng(4)
    n = 1_200_000
    g = rng.permutation(n)
    plan = plan_clos_permutation(g, n_src=n, device=CPU)
    assert plan.q == 2 and plan.R == 2048 and len(plan.planes) == 4
    assert plan.sel.shape == (1024, 2, 1024)
    for trip in plan.planes:
        _assert_valid_planes(trip)
    x = rng.uniform(-10, 10, n).astype(np.float32)
    np.testing.assert_array_equal(
        apply_permutation(plan, torch.from_numpy(x)).numpy(), x[g])


def test_clos_vjp_matches_jax(same_colorer):
    rng = np.random.default_rng(5)
    n_src, n_out = 30_000, 33_000
    g, _ = _partial_map(rng, n_src, n_out, 25_000)
    plan = plan_clos_permutation(g, n_src=n_src, device=CPU)
    ref = jax_cplan(g, n_src=n_src)
    x = rng.uniform(-1, 1, n_src + 5).astype(np.float32)  # tail: zero grad
    w = rng.uniform(-1, 1, n_out).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (apply_permutation(plan, xt) * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda v: (jax_apply(ref, v) * jnp.asarray(w)).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    want = np.zeros_like(x)
    live = g < n_src
    want[g[live]] = w[live]
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_window_permute_dispatch_and_checks():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 8, 128)).astype(np.float32))
    planes = [torch.from_numpy(rng.integers(0, 8 if i == 1 else 128,
                                            (3, 8, 128)).astype(np.int8))
              for i in range(3)]
    got = window_permute(x, *planes)
    m = planes[2].long()
    c = torch.gather(planes[1].long(), 2, m)
    p = torch.gather(planes[0].long().reshape(3, 1024), 1,
                     (c * 128 + m).reshape(3, 1024)).reshape(3, 8, 128)
    want = torch.gather(x.reshape(3, 1024), 1,
                        (c * 128 + p).reshape(3, 1024)).reshape(3, 8, 128)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="8, 128"):
        window_permute(x[:, :4], *(pl[:, :4] for pl in planes))
