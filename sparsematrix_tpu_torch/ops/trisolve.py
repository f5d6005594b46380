"""Sparse triangular solve ``L x = b`` / ``U x = b``.

Twin of ``sparsematrix_tpu/ops/trisolve.py``: the host plans are the JAX
planners' algorithms, so every plan comes out ``np.array_equal`` to the
JAX plan, field by field.  Three plan families live here:

* ``TriSolvePlan`` — level scheduling: the dependency DAG is stratified
  on the host into levels of mutually independent rows, and the apply
  walks the levels (a plain torch gather / sum / divide a level; the JAX
  version is plain XLA too).
* ``TriFixPlan`` — the nilpotent fixed point ``x ← D⁻¹(b − E x)``: one
  row-lane SpMV a step (``spmv_sell_rowlane``, kernel row 7).
* ``TriLevelPlan`` — one row-lane SpMV a level over that level's rows.

``trisolve(A, b)`` routes as the JAX package does: the wave engine
(``kernels/trisolve_waves.py``) when its inverse blocks fit 1 GiB, else
the fused engine (``kernels/trisolve_fused.py``), else, for patterns too
scattered for the fused slab layout, the level plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats.base import (cached_on, default_index_dtype, sparse_container,
                            static_field)
from ..formats.csr import CSR

__all__ = [
    "TriSolvePlan", "trisolve_plan", "trisolve_apply", "trisolve",
    "TriFixPlan", "trisolve_fixpoint_plan", "trisolve_fixpoint_apply",
    "TriLevelPlan", "trisolve_level_plan", "trisolve_level_apply",
]


@sparse_container
@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Level-scheduled triangular structure for a fixed sparsity pattern.

    Per level l and slot s: ``rows[l, s]`` is the row solved there (or n
    for padding).  Off-diagonal entries of each row are padded to
    ``max_row_nnz`` with (col=0, value 0).
    """

    rows: torch.Tensor  # (n_levels, max_width) int32, pad = n
    offdiag_cols: torch.Tensor  # (n_levels, max_width, max_row_nnz) int32
    offdiag_vals: torch.Tensor  # (n_levels, max_width, max_row_nnz)
    diag_vals: torch.Tensor  # (n_levels, max_width), pad rows 1.0
    shape: Tuple[int, int] = static_field()
    lower: bool = static_field()
    unit_diagonal: bool = static_field()


def _compute_levels(n: int, dep_rows: np.ndarray,
                    dep_cols: np.ndarray) -> np.ndarray:
    """level(i) = 1 + max level of off-diag deps — Kahn-style peeling, each
    round retires the dependency-free frontier (total work O(nnz))."""
    remaining = np.bincount(dep_rows, minlength=n)
    rev_order = np.argsort(dep_cols, kind="stable")
    rev_rows = dep_rows[rev_order]
    rev_ptr = np.zeros(n + 1, np.int64)
    np.add.at(rev_ptr[1:], dep_cols, 1)
    rev_ptr = np.cumsum(rev_ptr)
    level = np.zeros(n, dtype=np.int64)
    frontier = np.nonzero(remaining == 0)[0]
    remaining[frontier] = -1  # retired
    lvl = 0
    seen = len(frontier)
    while len(frontier):
        level[frontier] = lvl
        lens = rev_ptr[frontier + 1] - rev_ptr[frontier]
        total = int(lens.sum())
        if total:
            starts = np.cumsum(lens) - lens
            idx = (np.arange(total) - np.repeat(starts, lens)
                   + np.repeat(rev_ptr[frontier], lens))
            targets = rev_rows[idx]
            np.subtract.at(remaining, targets, 1)
            cand = np.unique(targets)
            frontier = cand[remaining[cand] == 0]
            remaining[frontier] = -1
        else:
            frontier = np.empty(0, np.int64)
        lvl += 1
        seen += len(frontier)
    if seen < n:
        raise ValueError("trisolve: cyclic structure (matrix not triangular?)")
    return level


def _split(A: CSR, lower: bool):
    """Host CSR pieces: (n, indptr, indices, data, row id, off-diagonal
    mask, diagonal mask)."""
    sp = A.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("trisolve needs a square matrix")
    indptr, indices, data = sp.indptr.astype(np.int64), sp.indices, sp.data
    rid = np.repeat(np.arange(n), np.diff(indptr))
    offd = (indices < rid) if lower else (indices > rid)
    return n, indptr, indices, data, rid, offd, indices == rid


def _inv_diag(n, rid, data, diag_mask, unit_diagonal, dtype):
    inv_d = np.ones(n, dtype=dtype)
    if not unit_diagonal:
        drows = rid[diag_mask]
        dv = data[diag_mask]
        if len(drows) < n or (dv == 0).any():
            missing = np.setdiff1d(np.arange(n), drows)
            bad = (missing[0] if len(missing)
                   else drows[np.nonzero(dv == 0)[0][0]])
            raise ValueError(f"zero/missing diagonal at row {bad}")
        inv_d[drows] = 1.0 / dv
    return inv_d


def _put(a, dev, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dt is None else t.to(dev, dt)


def trisolve_plan(A: CSR, lower: bool = True,
                  unit_diagonal: bool = False, device=None) -> TriSolvePlan:
    dev = A.device if device is None else torch.device(device)
    n, indptr, indices, data, rid, offd, diag_mask = _split(A, lower)

    level = _compute_levels(n, rid[offd], indices[offd].astype(np.int64))
    n_levels = int(level.max()) + 1 if n else 1

    widths = np.bincount(level, minlength=n_levels) if n else np.array([0])
    max_width = max(int(widths.max()) if n else 0, 1)
    od_counts = np.bincount(rid[offd], minlength=n)
    max_row_nnz = max(int(od_counts.max()) if n else 0, 1)

    # slot of each row within its level (stable order by row id)
    order_r = np.lexsort((np.arange(n), level))
    slot = np.empty(n, np.int64)
    lvl_start = np.cumsum(np.concatenate([[0], widths]))[:-1]
    slot[order_r] = np.arange(n) - lvl_start[level[order_r]]

    rows = np.full((n_levels, max_width), n, dtype=np.int64)
    rows[level, slot] = np.arange(n)
    od_cols = np.zeros((n_levels, max_width, max_row_nnz), dtype=np.int64)
    od_vals = np.zeros((n_levels, max_width, max_row_nnz), dtype=data.dtype)
    dvals = np.ones((n_levels, max_width), dtype=data.dtype)
    # scatter off-diag entries: kk = within-row off-diag rank
    csum = np.cumsum(offd)
    row_base = np.concatenate([[0], csum])[indptr[:-1]]
    kk = (csum - 1 - np.repeat(row_base, np.diff(indptr)))[offd]
    er = rid[offd]
    od_cols[level[er], slot[er], kk] = indices[offd]
    od_vals[level[er], slot[er], kk] = data[offd]
    if not unit_diagonal:
        _inv_diag(n, rid, data, diag_mask, False, data.dtype)  # validates
        drows = rid[diag_mask]
        dvals[level[drows], slot[drows]] = data[diag_mask]

    idt = default_index_dtype
    return TriSolvePlan(
        rows=_put(rows, dev, idt),
        offdiag_cols=_put(od_cols, dev, idt),
        offdiag_vals=_put(od_vals, dev),
        diag_vals=_put(dvals, dev),
        shape=(n, n),
        lower=lower,
        unit_diagonal=unit_diagonal,
    )


def trisolve_apply(plan: TriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """Numeric solve: walk the levels (plain torch; JAX: ``lax.scan``)."""
    n = plan.shape[0]
    x = torch.zeros(n + 1, dtype=b.dtype, device=b.device)  # n = padding
    bp = torch.cat([b, torch.zeros(1, dtype=b.dtype, device=b.device)])
    for lvl in range(plan.rows.shape[0]):
        rows = plan.rows[lvl].long()
        contrib = (plan.offdiag_vals[lvl]
                   * x[plan.offdiag_cols[lvl].long()]).sum(dim=1)
        # padding rows write slot n
        x = x.index_copy(0, rows, (bp[rows] - contrib) / plan.diag_vals[lvl])
    return x[:n]


# the wave plans trade device memory for steps (n·128·4 B chain, n·m·128·4
# B binv); above this a1 footprint the fused slab engine is the better deal
_WAVES_MAX_A1_BYTES = 1 << 30


def trisolve(A: CSR, b: torch.Tensor, lower: bool = True,
             unit_diagonal: bool = False) -> torch.Tensor:
    """One-shot triangular solve (host plan + device apply), routed as the
    JAX package routes it: the wave engine, else the fused engine, else —
    for patterns too scattered for the fused slab layout — the level
    plan.  ``b`` is (n,) or an (n, k) panel."""
    from ..kernels.trisolve_fused import (trisolve_fused_apply,
                                          trisolve_fused_apply_batched,
                                          trisolve_fused_plan)
    from ..kernels.trisolve_waves import (trisolve_waves_apply,
                                          trisolve_waves_apply_mm,
                                          trisolve_waves_plan)

    n = A.shape[0]
    multi = b.dim() == 2
    if n * 128 * 4 * 4 <= _WAVES_MAX_A1_BYTES:
        plan = trisolve_waves_plan(A, lower=lower,
                                   unit_diagonal=unit_diagonal,
                                   device=b.device)
        if multi:
            return trisolve_waves_apply_mm(plan, b)
        return trisolve_waves_apply(plan, b)
    try:
        plan = trisolve_fused_plan(A, lower=lower,
                                   unit_diagonal=unit_diagonal,
                                   device=b.device)
    except ValueError as e:
        if "too scattered" not in str(e):
            raise
        lplan = trisolve_plan(A, lower=lower, unit_diagonal=unit_diagonal,
                              device=b.device)
        if multi:
            return torch.stack([trisolve_apply(lplan, c) for c in b.T], 1)
        return trisolve_apply(lplan, b)
    if multi:
        return trisolve_fused_apply_batched(plan, b)
    return trisolve_fused_apply(plan, b)


# ---------------------------------------------------------------------------
# Fixed-point (Jacobi/Neumann) triangular solve — the SpMV formulation
# ---------------------------------------------------------------------------

@sparse_container
@dataclasses.dataclass(frozen=True)
class TriFixPlan:
    """Triangular solve as a nilpotent fixed-point iteration.

    With ``A = D + E`` (D diagonal, E strictly triangular), the update
    ``x ← D⁻¹(b − E x)`` from ``x₀ = D⁻¹ b`` is exact after ``n_iters =
    levels − 1`` steps, since ``(D⁻¹E)^levels = 0``.  Each step is one
    row-lane SpMV; a smaller ``n_iters`` gives the truncated-Neumann
    approximate solve (a fixed linear operator: a valid preconditioner).
    """

    e_packed: object  # SellRowLane of strictly-triangular E
    inv_diag: torch.Tensor  # (n,) — 1/diag (ones for unit_diagonal)
    shape: Tuple[int, int] = static_field()
    n_iters: int = static_field()
    lower: bool = static_field()
    unit_diagonal: bool = static_field()


def trisolve_fixpoint_plan(A: CSR, lower: bool = True,
                           unit_diagonal: bool = False,
                           n_iters: Optional[int] = None, device=None,
                           **pack_kwargs) -> TriFixPlan:
    """Pack E row-lane, invert D, count levels.  ``n_iters=None`` → exact
    (levels − 1 updates)."""
    from ..kernels.spmv_rowlane import pack_sell_rowlane

    dev = A.device if device is None else torch.device(device)
    n, indptr, indices, data, rid, offd, diag_mask = _split(A, lower)
    inv_d = _inv_diag(n, rid, data, diag_mask, unit_diagonal, data.dtype)
    if n_iters is None:
        level = _compute_levels(n, rid[offd], indices[offd].astype(np.int64))
        n_iters = max(int(level.max()) if n else 0, 0)
    E = sps.coo_matrix(
        (data[offd], (rid[offd], indices[offd])), shape=(n, n)).tocsr()
    e_packed = pack_sell_rowlane(CSR.from_scipy(E, device="cpu"),
                                 device=dev, **pack_kwargs)
    return TriFixPlan(
        e_packed=e_packed,
        inv_diag=_put(inv_d, dev),
        shape=(n, n),
        n_iters=int(n_iters),
        lower=lower,
        unit_diagonal=unit_diagonal,
    )


def trisolve_fixpoint_apply(plan: TriFixPlan, b: torch.Tensor) -> torch.Tensor:
    """Numeric solve: ``n_iters`` row-lane SpMVs (the rowlane kernel on a
    CUDA plan)."""
    from ..kernels.spmv_rowlane import spmv_sell_rowlane

    x = plan.inv_diag * b
    for _ in range(plan.n_iters):
        x = plan.inv_diag * (b - spmv_sell_rowlane(plan.e_packed, x))
    return x


# ---------------------------------------------------------------------------
# Level-packed solve — one row-lane kernel call per level, total work = nnz
# ---------------------------------------------------------------------------

@sparse_container
@dataclasses.dataclass(frozen=True)
class TriLevelPlan:
    """Level-scheduled solve on the row-lane kernel: each level's rows
    form their own row-lane slab program, all padded to a common
    ``(n_groups, group)``; padding slabs carry zero values and repeat the
    level's last tile."""

    s_idx: torch.Tensor  # (n_levels-1, n_groups, group*8, 128) int8
    vals: torch.Tensor  # (n_levels-1, n_groups, group*8, 128)
    group_tile: torch.Tensor  # (n_levels-1, n_groups) int32
    slab_win: torch.Tensor  # (n_levels-1, n_groups, group) int32
    level_of: torch.Tensor  # (n,) int32
    inv_diag: torch.Tensor  # (n,)
    shape: Tuple[int, int] = static_field()
    group: int = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    lower: bool = static_field()
    unit_diagonal: bool = static_field()


def trisolve_level_plan(A: CSR, lower: bool = True,
                        unit_diagonal: bool = False,
                        group: Optional[int] = None,
                        dtype=None, device=None) -> TriLevelPlan:
    """Stratify + pack each level's rows row-lane, padded to a common
    shape.  ``dtype=torch.bfloat16`` stores the off-diagonal values bf16
    (fp32 accumulation)."""
    from ..kernels.spmv_rowlane import pack_sell_rowlane

    dev = A.device if device is None else torch.device(device)
    n, indptr, indices, data, rid, offd, diag_mask = _split(A, lower)
    inv_d = _inv_diag(n, rid, data, diag_mask, unit_diagonal, np.float32)
    level = _compute_levels(n, rid[offd], indices[offd].astype(np.int64))
    n_levels = int(level.max()) + 1 if n else 1

    er, ec, ev = rid[offd], indices[offd], data[offd]
    elvl = level[er]

    def pack(j, g):
        m = elvl == j
        Ej = sps.coo_matrix((ev[m], (er[m], ec[m])), shape=(n, n)).tocsr()
        return pack_sell_rowlane(CSR.from_scipy(Ej, device="cpu"), group=g,
                                 lanes_per_row=1, dtype=dtype, device="cpu")

    packs = [pack(j, group) for j in range(1, n_levels)]
    if packs:
        # common group: the largest level knows the right batch size
        sel = max(packs, key=lambda p: p.s_idx.shape[0] * p.group)
        g_sel = sel.group
        packs = [p if p.group == g_sel else pack(j + 1, g_sel)
                 for j, p in enumerate(packs)]
        ng_max = max(p.s_idx.shape[0] for p in packs)

        def padded(p):
            pad = ng_max - p.s_idx.shape[0]
            if pad == 0:
                return p.s_idx, p.vals, p.group_tile, p.slab_win
            return (
                torch.cat([p.s_idx, torch.zeros((pad, g_sel * 8, 128),
                                                dtype=torch.int8)]),
                torch.cat([p.vals, torch.zeros((pad, g_sel * 8, 128),
                                               dtype=p.vals.dtype)]),
                torch.cat([p.group_tile,
                           p.group_tile[-1:].expand(pad)]),
                torch.cat([p.slab_win,
                           torch.zeros((pad, g_sel), dtype=torch.int32)]),
            )

        parts = [padded(p) for p in packs]
        s_idx, vals, group_tile, slab_win = (
            torch.stack([q[i] for q in parts]).to(dev) for i in range(4))
        n_tiles, n_win = packs[0].n_tiles, packs[0].n_win
    else:
        g_sel, n_tiles, n_win = 8, max(-(-n // 128), 1), max(-(-n // 1024), 1)
        vdt = torch.float32 if dtype is None else dtype
        s_idx = torch.zeros((0, 1, g_sel * 8, 128), dtype=torch.int8,
                            device=dev)
        vals = torch.zeros((0, 1, g_sel * 8, 128), dtype=vdt, device=dev)
        group_tile = torch.zeros((0, 1), dtype=torch.int32, device=dev)
        slab_win = torch.zeros((0, 1, g_sel), dtype=torch.int32, device=dev)

    return TriLevelPlan(
        s_idx=s_idx,
        vals=vals,
        group_tile=group_tile,
        slab_win=slab_win,
        level_of=_put(level, dev, default_index_dtype),
        inv_diag=_put(inv_d, dev),
        shape=(n, n),
        group=g_sel,
        n_tiles=n_tiles,
        n_win=n_win,
        lower=lower,
        unit_diagonal=unit_diagonal,
    )


def _level_pack(plan: TriLevelPlan, j: int):
    """Level j+1's slab program as a rowlane pack (views of the plan)."""
    from ..kernels.spmv_rowlane import SellRowLane

    n = plan.shape[0]
    return SellRowLane(
        s_idx=plan.s_idx[j], vals=plan.vals[j],
        group_tile=plan.group_tile[j], slab_win=plan.slab_win[j],
        tile_nonempty=torch.ones(plan.n_tiles, dtype=torch.bool,
                                 device=plan.s_idx.device),
        spill=None, spill_packed=None, t_pack=None, shape=(n, n),
        n_tiles=plan.n_tiles, n_win=plan.n_win, group=plan.group,
        lanes_per_row=1, nnz=0)


_LEVEL_PACKS: dict = {}


def _level_packs(plan: TriLevelPlan):
    """Every level's ``_level_pack``, made once per plan, so that the
    rowlane kernel's side structures (built once a pack) are too."""
    return cached_on(_LEVEL_PACKS, plan, lambda p: [
        _level_pack(p, j) for j in range(p.s_idx.shape[0])])


def trisolve_level_apply(plan: TriLevelPlan, b: torch.Tensor) -> torch.Tensor:
    """Numeric solve: one row-lane SpMV a level (the rowlane kernel on a
    CUDA plan, the JAX package's ``_rowlane_call`` a level)."""
    from ..kernels.spmv_rowlane import _rowlane_forward

    x = plan.inv_diag * b
    for j, pack in enumerate(_level_packs(plan)):
        y = _rowlane_forward(pack, x)
        x = torch.where(plan.level_of == j + 1, (b - y) * plan.inv_diag, x)
    return x
