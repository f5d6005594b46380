"""Fused triangular solve — all levels in one launch: the plan and
``csrc/trisolve_fused.cu``.

Twin of ``sparsematrix_tpu/kernels/trisolve_fused.py``.  x lives as
(S, 128), element i at (sublane i // 128, lane i % 128): at once the
row-lane kernel's window view of x and the tile view of the solution.
The plan is a level-ordered run of (level, tile) segments of row-lane
slabs; each segment gathers x at columns of earlier levels (already
final), sums, and commits ``x[r] = (b[r] − Σ E x)·inv_diag[r]`` on the
tile's lanes gated to the segment's level (rows of other levels in the
tile keep their value).  The planner is the JAX planner's algorithm, so
every plane comes out ``np.array_equal`` to the JAX plan; with
``level_sort`` rows are renumbered level-major (``perm``/``rank``).

``trisolve_fused_apply`` runs the plain version (``_fused_plain``, the
segments walked in order in torch) when its inputs lie on the CPU, and
otherwise launches the kernel or raises.  It is differentiable in ``b``
and ``plan.vals`` when the plan was built with ``with_transpose=True``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats.base import sparse_container, static_field
from ..formats.csr import CSR
from . import _build

__all__ = ["TriFusedPlan", "trisolve_fused_plan", "trisolve_fused_apply",
           "trisolve_fused_apply_batched"]

_LANES = 128
_W = 1024


@sparse_container
@dataclasses.dataclass(frozen=True)
class TriFusedPlan:
    """Level-ordered slab program for the single-launch solve."""

    s_idx: torch.Tensor  # (n_groups, group*8, 128) int8
    vals: torch.Tensor  # (n_groups, group*8, 128)
    group_tile: torch.Tensor  # (n_groups,) int32
    slab_win: torch.Tensor  # (n_groups*group,) int32
    seg_id: torch.Tensor  # (n_groups,) int32 — (level, tile) segment
    seg_first: torch.Tensor  # (n_groups,) int32 0/1
    commit: torch.Tensor  # (n_groups,) int32 0/1 — last group of segment
    aux: torch.Tensor  # (n_segs, 8, 128): sublane 0 gate, 1 gate*inv_diag
    inv_diag: torch.Tensor  # (n,) — in permuted order when perm is set
    t_plan: Optional["TriFusedPlan"]  # plan of A^T for the backward pass
    perm: Optional[torch.Tensor]  # (n,) new→old (level sort), or None
    rank: Optional[torch.Tensor]  # (n,) old→new inverse, or None
    shape: Tuple[int, int] = static_field()
    group: int = static_field()
    n_win: int = static_field()
    lower: bool = static_field()
    unit_diagonal: bool = static_field()
    n_levels: int = static_field()


def _put(a, dev, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dt is None else t.to(dev, dt)


def trisolve_fused_plan(A: CSR, lower: bool = True,
                        unit_diagonal: bool = False,
                        group: Optional[int] = None,
                        with_transpose: bool = False,
                        level_sort: bool = True,
                        dtype=None, device=None) -> TriFusedPlan:
    """Stratify rows into levels and splice every level's row-lane slabs
    into one level-ordered program with per-(level, tile) commit points
    (one vectorized numpy pass: the level is the major key of the slab
    bucket).  ``group`` batches slabs a step (auto: the largest of
    8/4/2/1 whose segment padding stays under 15 %).
    ``dtype=torch.bfloat16`` stores values bf16 (fp32 accumulation)."""
    from ..ops.trisolve import _compute_levels, _inv_diag, _split

    dev = A.device if device is None else torch.device(device)
    vdt = torch.float32 if dtype is None else dtype
    n, indptr, indices, data, rid, offd, diag_mask = _split(A, lower)
    inv_d = _inv_diag(n, rid, data, diag_mask, unit_diagonal, np.float32)

    level = _compute_levels(n, rid[offd], indices[offd].astype(np.int64))
    n_levels = int(level.max()) + 1 if n else 1
    n_win = max(-(-n // _W), 1)
    er = rid[offd].astype(np.int64)
    ec = indices[offd].astype(np.int64)
    ev = data[offd]

    perm = rank = None
    if level_sort and n:
        # topological (level-major, index-minor) symmetric permutation:
        # each 128-row tile then spans about one level, so the segment
        # count collapses to ~n_tiles + n_levels
        perm = np.argsort(level, kind="stable")  # new → old
        rank = np.empty(n, np.int64)  # old → new
        rank[perm] = np.arange(n)
        er, ec = rank[er], rank[ec]
        inv_d = inv_d[perm]
        level = level[perm]

    elvl = level[er]  # ≥ 1 by construction (level-0 rows have no deps)
    n_tiles = -(-n // _LANES)
    idt = torch.int32

    if er.size == 0:
        return TriFusedPlan(
            s_idx=torch.zeros((0, 8, _LANES), dtype=torch.int8, device=dev),
            vals=torch.zeros((0, 8, _LANES), dtype=vdt, device=dev),
            group_tile=torch.zeros((0,), dtype=idt, device=dev),
            slab_win=torch.zeros((0,), dtype=idt, device=dev),
            seg_id=torch.zeros((0,), dtype=idt, device=dev),
            seg_first=torch.zeros((0,), dtype=idt, device=dev),
            commit=torch.zeros((0,), dtype=idt, device=dev),
            aux=torch.zeros((0, 8, _LANES), dtype=torch.float32, device=dev),
            inv_diag=_put(inv_d, dev),
            t_plan=None, perm=None, rank=None,
            shape=(n, n), group=1, n_win=n_win,
            lower=lower, unit_diagonal=unit_diagonal, n_levels=n_levels,
        )

    # slab bucketing with the level as the major key — one sorted pass
    t = er // _LANES
    lane = er % _LANES
    w = ec // _W
    u = (ec % _W) // _LANES
    sidx_e = ec % _LANES
    bucket = (((elvl * n_tiles + t) * n_win + w) * 8 + u) * _LANES + lane
    order = np.argsort(bucket, kind="stable")
    bo = bucket[order]
    new = np.empty(len(bo), bool)
    new[0] = True
    new[1:] = bo[1:] != bo[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(len(bo)), 0))
    d = np.arange(len(bo)) - run_start  # occurrence → slab within (j,t,w)
    d_span = int(d.max()) + 1
    jt = (elvl * n_tiles + t)[order]  # segment key (level-major)
    slab_key = (jt * n_win + w[order]) * d_span + d
    uslab, inv = np.unique(slab_key, return_inverse=True)
    # highly scattered patterns (~1 entry a slab) would blow the padded
    # layout up to GBs: that regime belongs to the fixpoint/level plans
    vbytes = 2 if vdt == torch.bfloat16 else 4
    est_bytes = len(uslab) * 8 * _LANES * (1 + vbytes)
    if est_bytes > 2 << 30:
        raise ValueError(
            f"trisolve_fused_plan: slab layout would need ~{est_bytes >> 20}"
            f" MB ({len(uslab)} slabs for {er.size} entries); the pattern "
            "is too scattered for the fused layout — use "
            "trisolve_fixpoint_plan instead")
    slab_seg = uslab // (n_win * d_span)  # == j*n_tiles + t, sorted
    slab_w = (uslab // d_span) % n_win
    useg, seg_start = np.unique(slab_seg, return_index=True)
    n_segs = len(useg)
    sizes = np.diff(np.r_[seg_start, len(uslab)])

    if group is None:
        group = 1
        total = sizes.sum()
        for g in (8, 4, 2):
            waste = ((-(-sizes // g) * g).sum() - total) / max(total, 1)
            if waste <= 0.15:
                group = g
                break

    # pad each segment to a multiple of `group` with zero slabs (repeat
    # the segment's last window id so gathers stay in range)
    seg_groups = -(-sizes // group)
    padded = seg_groups * group
    seg_offset = np.concatenate([[0], np.cumsum(padded)])
    seg_of_slab = np.searchsorted(useg, slab_seg)
    rank_in_seg = np.arange(len(uslab)) - seg_start[seg_of_slab]
    slab_slot = seg_offset[seg_of_slab] + rank_in_seg
    total_slots = int(seg_offset[-1])

    s_idx = np.zeros((total_slots, 8, _LANES), np.int8)
    vals = np.zeros((total_slots, 8, _LANES), np.float32)
    slab_win = np.zeros(total_slots, np.int32)
    entry_slot = slab_slot[inv]
    s_idx[entry_slot, u[order], lane[order]] = sidx_e[order]
    vals[entry_slot, u[order], lane[order]] = ev[order]
    slab_win[slab_slot] = slab_w
    # padding slots: repeat each segment's last real window id
    last_w = slab_w[seg_start + sizes - 1].astype(np.int32)
    pad_mask = np.ones(total_slots, bool)
    pad_mask[slab_slot] = False
    pad_seg = np.searchsorted(seg_offset[1:], np.nonzero(pad_mask)[0],
                              side="right")
    slab_win[pad_mask] = last_w[pad_seg]

    s_idx = s_idx.reshape(-1, group * 8, _LANES)
    vals = vals.reshape(-1, group * 8, _LANES)

    seg_tile_arr = (useg % n_tiles).astype(np.int64)
    seg_level_arr = (useg // n_tiles).astype(np.int64)
    gt = np.repeat(seg_tile_arr, seg_groups)
    sid = np.repeat(np.arange(n_segs), seg_groups)
    pos = np.arange(len(sid)) - np.concatenate(
        [[0], np.cumsum(seg_groups)])[sid]
    sfirst = (pos == 0).astype(np.int32)
    scommit = (pos == seg_groups[sid] - 1).astype(np.int32)

    # per-segment gate masks over the tile's 128 rows
    aux = np.zeros((n_segs, 8, _LANES), np.float32)
    lev_pad = np.full(n_tiles * _LANES, -1, np.int64)
    lev_pad[:n] = level
    inv_pad = np.zeros(lev_pad.shape, np.float32)
    inv_pad[:n] = inv_d
    lev2d = lev_pad.reshape(n_tiles, _LANES)
    inv2d = inv_pad.reshape(n_tiles, _LANES)
    gate = (lev2d[seg_tile_arr] == seg_level_arr[:, None]).astype(np.float32)
    aux[:, 0] = gate
    aux[:, 1] = gate * inv2d[seg_tile_arr]

    t_plan = None
    if with_transpose:
        At = CSR.from_scipy(sps.csr_matrix(A.to_scipy().T), device="cpu")
        t_plan = trisolve_fused_plan(At, lower=not lower,
                                     unit_diagonal=unit_diagonal,
                                     group=group, with_transpose=False,
                                     level_sort=level_sort, dtype=dtype,
                                     device=dev)
    return TriFusedPlan(
        s_idx=_put(s_idx, dev, torch.int8),
        vals=_put(vals, dev, vdt),
        group_tile=_put(gt, dev, idt),
        slab_win=_put(slab_win, dev, idt),
        seg_id=_put(sid, dev, idt),
        seg_first=_put(sfirst, dev, idt),
        commit=_put(scommit, dev, idt),
        aux=_put(aux, dev),
        inv_diag=_put(inv_d, dev),
        t_plan=t_plan,
        perm=None if perm is None else _put(perm, dev, idt),
        rank=None if rank is None else _put(rank, dev, idt),
        shape=(n, n), group=int(group), n_win=n_win,
        lower=lower, unit_diagonal=unit_diagonal, n_levels=n_levels,
    )


# ---------------------------------------------------------------------------
# the plain version and the kernel wrapper
# ---------------------------------------------------------------------------

def _seg_ptr(plan: TriFusedPlan) -> torch.Tensor:
    """(n_segs+1,) int32: the first group of each segment."""
    n_segs = plan.aux.shape[0]
    return torch.searchsorted(
        plan.seg_id,
        torch.arange(n_segs + 1, dtype=torch.int32, device=plan.seg_id.device),
        out_int32=True)


def _fused_plain(plan: TriFusedPlan, binv: torch.Tensor) -> torch.Tensor:
    """The segments in order: gather the solved prefix, sum, commit the
    gated lanes of the segment's tile."""
    x = binv.clone()
    N = x.shape[0]
    si = plan.s_idx.reshape(-1, 8, _LANES)
    vv = plan.vals.reshape(-1, 8, _LANES)
    ptr = _seg_ptr(plan).tolist()
    tiles = plan.group_tile.tolist()
    sub = torch.arange(8, device=x.device)[None, :, None] * _LANES
    for seg in range(plan.aux.shape[0]):
        sl = slice(ptr[seg] * plan.group, ptr[seg + 1] * plan.group)
        col = plan.slab_win[sl].long()[:, None, None] * _W + sub + (
            si[sl].long() & 127)
        ok = col < N
        part = (vv[sl].float() * torch.where(ok, x[col.clamp(max=N - 1)],
                                             0.0)).sum(dim=(0, 1))
        t = tiles[ptr[seg]]
        rows = slice(t * _LANES, (t + 1) * _LANES)
        xb, bb = x[rows], binv[rows]
        x[rows] = xb + plan.aux[seg, 0] * (bb - xb) - part * plan.aux[seg, 1]
    return x


_ARGTYPES = (
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals
    ctypes.c_void_p,  # group_tile int32
    ctypes.c_void_p,  # slab_win int32
    ctypes.c_void_p,  # seg_ptr (n_segs+1,) int32
    ctypes.c_void_p,  # aux fp32
    ctypes.c_void_p,  # binv fp32
    ctypes.c_void_p,  # x fp32, a copy of binv
    ctypes.c_void_p,  # sync (2,) int32, zeroed
    ctypes.c_int,  # n_segs
    ctypes.c_int,  # group
    ctypes.c_int,  # n_win
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)


def _fused_cuda(plan: TriFusedPlan, binv: torch.Tensor) -> torch.Tensor:
    planes = (plan.s_idx, plan.vals, plan.group_tile, plan.slab_win,
              plan.seg_id, plan.aux)
    if not binv.is_cuda or not all(t.device == binv.device
                                   and t.is_contiguous() for t in planes):
        raise ValueError("trisolve_fused: the plan and b must be contiguous "
                         "on one CUDA device")
    n_groups, n_segs = plan.s_idx.shape[0], plan.aux.shape[0]
    if (plan.s_idx.dtype != torch.int8
            or plan.vals.dtype not in (torch.float32, torch.bfloat16)
            or plan.s_idx.shape != (n_groups, plan.group * 8, _LANES)
            or plan.vals.shape != plan.s_idx.shape
            or plan.group_tile.shape != (n_groups,)
            or plan.slab_win.shape != (n_groups * plan.group,)
            or plan.seg_id.shape != (n_groups,)
            or plan.aux.shape != (n_segs, 8, _LANES)
            or plan.aux.dtype != torch.float32
            or binv.shape != (plan.n_win * _W,)
            or binv.dtype != torch.float32):
        raise ValueError("trisolve_fused: inconsistent plan planes or b")
    seg_ptr = _seg_ptr(plan)
    x = binv.clone()
    sync = torch.zeros(2, dtype=torch.int32, device=binv.device)
    fn = _build.load("trisolve_fused", _ARGTYPES)
    with torch.cuda.device(binv.device):
        err = fn(plan.s_idx.data_ptr(), plan.vals.data_ptr(),
                 plan.group_tile.data_ptr(), plan.slab_win.data_ptr(),
                 seg_ptr.data_ptr(), plan.aux.data_ptr(), binv.data_ptr(),
                 x.data_ptr(), sync.data_ptr(), n_segs, plan.group,
                 plan.n_win, int(plan.vals.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"trisolve_fused: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["trisolve_fused"] += 1
    return x


def _fused_forward(plan: TriFusedPlan, b: torch.Tensor,
                   plain: Optional[bool] = None) -> torch.Tensor:
    n = plan.shape[0]
    if plain is None:
        plain = b.device.type == "cpu" and plan.vals.device.type == "cpu"
    if plan.perm is not None:
        b = b[plan.perm.long()]  # into the level-sorted coordinates
    x0 = plan.inv_diag * b
    if plan.s_idx.shape[0] == 0:
        x = x0
    else:
        binv = torch.zeros(plan.n_win * _W, dtype=torch.float32,
                           device=b.device)
        binv[:n] = x0
        x = (_fused_plain if plain else _fused_cuda)(plan, binv)[:n]
    if plan.perm is not None:
        x = x[plan.rank.long()]  # back to the caller's coordinates
    return x


def fused_forward_plain(plan: TriFusedPlan, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``trisolve_fused_apply`` on the plan's device (the
    card's kernel is compared with it)."""
    return _fused_forward(plan, b, plain=True)


def _slot_row_col(plan: TriFusedPlan):
    """Per-slot (row, col) in the plan's (level-sorted) coordinates, each
    (n_groups, group*8, 128) int64."""
    n_groups, GH, _ = plan.s_idx.shape
    dev = plan.s_idx.device
    lane = torch.arange(_LANES, device=dev)[None, None, :]
    row = plan.group_tile.long()[:, None, None] * _LANES + lane
    subl = (torch.arange(GH, device=dev) % 8)[None, :, None]
    winb = plan.slab_win.reshape(n_groups, plan.group).long(
    ).repeat_interleave(8, dim=1)[:, :, None]
    col = winb * _W + subl * _LANES + (plan.s_idx.long() & 127)
    return row.expand_as(col), col


class _FusedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, vals, b):
        # ``vals`` is ``plan.vals``, passed so autograd tracks it
        x = _fused_forward(plan, b)
        ctx.plan = plan
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        if plan.s_idx.shape[0] == 0:
            # a diagonal solve is its own transpose
            return None, None, _fused_forward(plan, g)
        if plan.t_plan is None:
            raise ValueError(
                "trisolve_fused_apply backward pass needs the transposed "
                "plan — build with trisolve_fused_plan(..., "
                "with_transpose=True)")
        gbar = _fused_forward(plan.t_plan, g)  # T⁻ᵀ g, caller coordinates
        dvals = None
        if ctx.needs_input_grad[1]:
            if plan.perm is not None:
                # slot coordinates live in the plan's level-sorted space
                xs, gs = x[plan.perm.long()], gbar[plan.perm.long()]
            else:
                xs, gs = x, gbar
            n = plan.shape[0]
            pad = plan.n_win * _W
            gpad = torch.zeros(pad, dtype=torch.float32, device=g.device)
            gpad[:n] = gs
            xpad = torch.zeros(pad, dtype=torch.float32, device=g.device)
            xpad[:n] = xs
            row, col = _slot_row_col(plan)
            zero = torch.zeros((), dtype=torch.float32, device=g.device)
            dvals = torch.where(plan.vals != 0, -gpad[row] * xpad[col],
                                zero).to(plan.vals.dtype)
        return None, dvals, gbar


def trisolve_fused_apply(plan: TriFusedPlan, b: torch.Tensor) -> torch.Tensor:
    """Solve ``x = T⁻¹ b`` (fp32) in one launch for all levels.
    Differentiable in ``b`` and ``plan.vals`` when the plan was built with
    ``with_transpose=True``: ``ḡ_b = T⁻ᵀ g`` and ``ḡ_vals[slot (r, c)] =
    −(T⁻ᵀ g)_r · x_c`` at the stored slots."""
    return _FusedApply.apply(plan, plan.vals, b)


def trisolve_fused_apply_batched(plan: TriFusedPlan,
                                 B: torch.Tensor) -> torch.Tensor:
    """Multi-RHS solve ``X = T⁻¹ B`` for B (n, k): one fused solve a column
    (the JAX package scans the columns the same way)."""
    if B.dim() == 1:
        return trisolve_fused_apply(plan, B)
    return torch.stack([trisolve_fused_apply(plan, B[:, j])
                        for j in range(B.shape[1])], dim=1)
