"""Clos-routed planned permutation: ``out[i] = x[g[i]]`` in a few
bandwidth passes.

Twin of ``sparsematrix_tpu/ops/permute_clos.py``.  View x as an
(R, 1024) grid.  Any bijection factors as row-local ∘ column-local ∘
row-local by König edge colouring: colour each element (source row s,
destination row d) in the R×R bipartite multigraph with 1024 colours; its
colour m is the intermediate column.  Each row-local stage is a batch of
window bijections run by the window-permute kernel
(``kernels/window_permute.py``); the column-local stage becomes row-local
after a transpose of the grid.  For R ≤ 1024 that is three kernel stages
and two transposes; for R = q·1024 the middle row of length q·1024
factors once more (two window stages around a q-way select), giving four
stages.  The transposes and the select are plain torch, as they are XLA
code in the JAX package.

The planes are built once on the host by the port's copies of the JAX
codec's colourers (``native/color.cc``: ``smtpu_edge_color`` and
``smtpu_edge_color_batched``), fed in the same order: the port's plan is
field-equal to the JAX planner's whenever both take the same colourer
(see ``_edge_color_grouped`` for where they do not); without ``g++`` the
Python Euler split (the JAX fallback) runs instead.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..formats.base import sparse_container, static_field
from ..kernels import _build
from ..kernels.window_permute import window_permute
from .permute import _extend_bijection

__all__ = ["ClosPermutePlan", "plan_clos_permutation",
           "apply_clos_permutation"]

_W = 1024
_MAX_Q = 8  # cap = q * 1024 * 1024 ≤ 8 Mi; larger falls back to the sort

_EDGE_COLOR_ARGTYPES = (
    ctypes.c_void_p,  # left (n_edges,) int32
    ctypes.c_void_p,  # right (n_edges,) int32
    ctypes.c_long,  # n_edges
    ctypes.c_long,  # n_left
    ctypes.c_long,  # n_right
    ctypes.c_long,  # n_colors
    ctypes.c_void_p,  # color (n_edges,) int32 out
)
_BATCHED_ARGTYPES = (
    ctypes.c_void_p,  # left (n_edges,) int32
    ctypes.c_void_p,  # right (n_edges,) int32
    ctypes.c_void_p,  # batch (n_edges,) int32
    ctypes.c_long,  # n_edges
    ctypes.c_long,  # n_batch
    ctypes.c_long,  # nL
    ctypes.c_long,  # nR
    ctypes.c_long,  # n_colors
    ctypes.c_void_p,  # color (n_edges,) int32 out
)


def _edge_color_native(left, right, n_left, n_right, n_colors):
    fn = _build.load_host("color", "smtpu_edge_color", _EDGE_COLOR_ARGTYPES)
    if fn is None:
        return None
    l32 = np.ascontiguousarray(left, np.int32)
    r32 = np.ascontiguousarray(right, np.int32)
    out = np.empty(len(l32), np.int32)
    rc = fn(l32.ctypes.data, r32.ctypes.data, len(l32), int(n_left),
            int(n_right), int(n_colors), out.ctypes.data)
    return out if rc == 0 else None


def _edge_color_py(left, right, n_left, n_right, n_colors):
    """Python Euler split (the no-compiler fallback; per-edge Python steps,
    fine for the small plans of the tests)."""
    n_edges = len(left)
    if not n_edges == n_left * n_colors == n_right * n_colors:
        raise ValueError("edge colouring needs a regular bipartite graph")
    color = np.zeros(n_edges, np.int64)
    classes = [np.arange(n_edges)]
    deg = n_colors
    while deg > 1:
        nxt = []
        for idx in classes:
            # adjacency: vertex -> incident edge list (left then right)
            nv = n_left + n_right
            heads = [[] for _ in range(nv)]
            for e in idx:
                heads[left[e]].append(e)
                heads[n_left + right[e]].append(e)
            used = set()
            cursor = [0] * nv
            bit_of = {}
            for e0 in idx:
                if e0 in used:
                    continue
                v = left[e0]
                bit = 0
                while True:
                    e = -1
                    while cursor[v] < len(heads[v]):
                        cand = heads[v][cursor[v]]
                        if cand not in used:
                            e = cand
                            break
                        cursor[v] += 1
                    if e < 0:
                        break
                    used.add(e)
                    bit_of[e] = bit
                    bit ^= 1
                    v = (n_left + right[e]) if v == left[e] else left[e]
            a = np.array([e for e in idx if bit_of[e] == 0], np.int64)
            b = np.array([e for e in idx if bit_of[e] == 1], np.int64)
            color[a] = color[a] << 1
            color[b] = (color[b] << 1) | 1
            nxt += [a, b]
        classes = nxt
        deg >>= 1
    return color


def _edge_color(left, right, n_left, n_right, n_colors):
    out = _edge_color_native(left, right, n_left, n_right, n_colors)
    if out is None:
        out = _edge_color_py(np.asarray(left), np.asarray(right),
                             n_left, n_right, n_colors)
    return np.asarray(out, np.int64)


def _edge_color_batched_native(batch, left_small, right_small, n_batch,
                               nsmall, n_colors):
    """The native count-matrix Euler splitter
    (``smtpu_edge_color_batched``); None where no ``g++`` is found or it
    refuses the input."""
    fn = _build.load_host("color", "smtpu_edge_color_batched",
                          _BATCHED_ARGTYPES)
    if fn is None:
        return None
    l32 = np.ascontiguousarray(left_small, np.int32)
    r32 = np.ascontiguousarray(right_small, np.int32)
    b32 = np.ascontiguousarray(batch, np.int32)
    out = np.empty(len(l32), np.int32)
    rc = fn(l32.ctypes.data, r32.ctypes.data, b32.ctypes.data, len(l32),
            int(n_batch), int(nsmall), int(nsmall), int(n_colors),
            out.ctypes.data)
    return out.astype(np.int64) if rc == 0 else None


def _edge_color_grouped(batch, left_small, right_small, n_batch, nsmall,
                        n_colors):
    """Batched independent small bipartite colourings (each batch an
    nsmall×nsmall multigraph, every degree == n_colors): the native
    batched splitter, else one disjoint-union call of the generic
    colourer.

    The JAX package's call of the batched splitter passes its ``long``
    arguments as 32-bit ints (no ``argtypes``); the ABI passes its seventh
    and eighth on the stack, where the splitter may read garbage in their
    upper halves and refuse, and the JAX planner then takes the generic
    colourer: other, equally valid planes (ROADMAP.md, Queue 3).  The port
    declares the argument types, so its call succeeds."""
    out = _edge_color_batched_native(batch, left_small, right_small,
                                     n_batch, nsmall, n_colors)
    if out is not None:
        return out
    return _edge_color(batch * nsmall + left_small,
                       batch * nsmall + right_small,
                       n_batch * nsmall, n_batch * nsmall, n_colors)


def _window_planes(win, spos, dpos, n_windows):
    """POS/CH/RT planes (int8 numpy, (n_windows, 8, 128)) for a batch of
    window bijections: per element its window, source and destination
    position in [0, 1024); each window's map must be a bijection."""
    su, sl = spos // 128, spos % 128
    du, dl = dpos // 128, dpos % 128
    m = _edge_color_grouped(win, du, su, n_windows, 8, 128)
    pos = np.empty((n_windows, 8, 128), np.int8)
    chk = np.empty((n_windows, 8, 128), np.int8)
    rte = np.empty((n_windows, 8, 128), np.int8)
    pos[win, su, m] = sl
    chk[win, du, m] = su
    rte[win, du, dl] = m
    return pos, chk, rte


@sparse_container
@dataclasses.dataclass(frozen=True)
class ClosPermutePlan:
    """Planes for 3 (q = 1) or 4 (q > 1) window stages and the q-way
    select."""

    planes: Tuple[Tuple[torch.Tensor, ...], ...]  # (pos, chk, rte) int8
    #                                               (W_stage, 8, 128) each
    sel: Optional[torch.Tensor]  # int8 (1024, q, 1024): source t per
    #                              (row, t_d, m2); None when q = 1
    mask_src: Optional[torch.Tensor]  # (n_out,) int32 source ids for
    #                                   sentinel zeroing, or None
    inv: torch.Tensor  # (n_src,) int32 output slot per source (n_out: none)
    cap: int = static_field()
    R: int = static_field()
    q: int = static_field()
    n_out: int = static_field()
    n_src: int = static_field()


def _geometry(n):
    """Smallest supported (R, q): R = 2^k ≤ 1024 rows (powers of two, so
    the transposed grid packs 1024/R segments a window), or R = q·1024
    with any integer q ≤ 8."""
    R = 8
    while R * _W < n and R < _W:
        R *= 2
    if R * _W >= n:
        return R, 1
    q = -(-n // (_W * _W))
    if q > _MAX_Q:
        return None, None
    return q * _W, q


def plan_clos_permutation(g, n_src: int, n_out: int | None = None,
                          device=None) -> Optional[ClosPermutePlan]:
    """Plan ``out[i] = x[g[i]]`` (injective ``g``; entries ≥ n_src read 0)
    on ``device``.  Returns None when the size is out of the supported
    range (the caller falls back to ``ops/permute.py``)."""
    dev = resolve_device(device)
    g = np.asarray(g)
    n_out = len(g) if n_out is None else n_out
    R, q = _geometry(max(n_out, n_src))
    if R is None:
        return None
    cap = R * _W
    g_out, p, _, real, mask_needed = _extend_bijection(g, n_src, n_out)
    mask_src = (np.where(real, g_out, n_src).astype(np.int32)
                if mask_needed else None)
    if len(p) < cap:  # extend to the padded geometry with an identity tail
        p = np.concatenate([p, np.arange(len(p), cap)])
    i = np.arange(cap)
    s_row, s_col = p // _W, p % _W
    d_row, d_col = i // _W, i % _W
    m1 = _edge_color(s_row, d_row, R, R, _W)
    planes = [_window_planes(s_row, s_col, m1, R)]
    sel = None
    if q == 1:
        # the transposed grid (1024, R) packs 1024/R rows a window
        a2 = m1 * R + s_row
        a3 = m1 * R + d_row
        planes.append(_window_planes(a2 // _W, a2 % _W, a3 % _W, cap // _W))
    else:
        s_t, s_j = s_row // _W, s_row % _W
        d_t, d_j = d_row // _W, d_row % _W
        m2 = _edge_color_grouped(m1, s_t, d_t, _W, q, _W)
        planes.append(_window_planes(m1 * q + s_t, s_j, m2, _W * q))
        sel = np.empty((_W, q, _W), np.int8)
        sel[m1, d_t, m2] = s_t
        planes.append(_window_planes(m1 * q + d_t, m2, d_j, _W * q))
    planes.append(_window_planes(d_row, m1, d_col, R))
    # inverse map for the backward pass: output slot of each source
    inv = np.full(n_src, n_out, np.int64)
    live = g_out < n_src
    inv[g_out[live]] = np.flatnonzero(live)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return ClosPermutePlan(
        planes=tuple(tuple(put(a, torch.int8) for a in trip)
                     for trip in planes),
        sel=None if sel is None else put(sel, torch.int8),
        mask_src=None if mask_src is None else put(mask_src, torch.int32),
        inv=put(inv, torch.int32),
        cap=cap, R=R, q=q, n_out=int(n_out), n_src=int(n_src))


def _apply_clos_impl(plan: ClosPermutePlan, x: torch.Tensor,
                     stage=window_permute) -> torch.Tensor:
    """The stages of the plan; ``stage`` runs one window-permute stage
    (the dispatching wrapper, or its plain version to compare with)."""
    R, q, cap = plan.R, plan.q, plan.cap

    def wp(v, trip):
        return stage(v.reshape(-1, 8, 128).contiguous(), *trip)

    xp = x.new_zeros(cap)
    xp[: plan.n_src] = x[: plan.n_src]
    v = wp(xp, plan.planes[0])
    v = v.reshape(R, _W).T  # (1024, R)
    v = wp(v, plan.planes[1])
    if q > 1:
        # the q-way select: out[i, t_d, m] = v[i, sel[i, t_d, m], m]
        v = torch.gather(v.reshape(_W, q, _W), 1, plan.sel.long())
        v = wp(v, plan.planes[2])
    v = v.reshape(_W, R).T  # back to (R, 1024)
    v = wp(v, plan.planes[-1])
    out = v.reshape(-1)[: plan.n_out]
    if plan.mask_src is not None:
        out = torch.where(plan.mask_src < plan.n_src, out, out.new_zeros(()))
    return out


class _ApplyClos(torch.autograd.Function):
    """The JAX wrapper's custom VJP (``_clos_fwd``/``_clos_bwd``): the
    cotangent applies the inverse map as a gather."""

    @staticmethod
    def forward(ctx, plan, x):
        ctx.plan = plan
        ctx.x_len = x.shape[0]
        ctx.x_dtype = x.dtype
        return _apply_clos_impl(plan, x)

    @staticmethod
    def backward(ctx, ct):
        plan = ctx.plan
        ctp = torch.cat([ct, ct.new_zeros(1)])
        ct_x = ctp[plan.inv.long()].to(ctx.x_dtype)
        tail = ctx.x_len - plan.n_src
        if tail > 0:  # the apply ignores x's tail
            ct_x = torch.cat([ct_x, ct_x.new_zeros(tail)])
        return None, ct_x


def apply_clos_permutation(plan: ClosPermutePlan,
                           x: torch.Tensor) -> torch.Tensor:
    """Run the planned permutation (differentiable in ``x``)."""
    return _ApplyClos.apply(plan, x)
