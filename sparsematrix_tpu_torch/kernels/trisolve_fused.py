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
otherwise launches the kernel or raises.  The kernel walks the plan's
waves (``segment_waves``: a segment runs one wave after the segments whose
commits its nonzero slots read) over a list of the committed rows and
their nonzero slots (``fused_walk``), both built once a plan and keyed on
the state of its values and gates; it syncs once a wave instead of once a
segment.  It is differentiable in ``b``
and ``plan.vals`` when the plan was built with ``with_transpose=True``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats.base import (cached_on, sparse_container, static_field,
                            values_version)
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
# the plain version, the card's wave walk and the kernel wrapper
# ---------------------------------------------------------------------------

_SEG_PTRS: dict = {}
_WAVES: dict = {}
_WALKS: dict = {}


def _seg_ptr(plan: TriFusedPlan) -> torch.Tensor:
    """(n_segs+1,) int32: the first group of each segment (built once a
    plan)."""
    def build(p):
        n_segs = p.aux.shape[0]
        return torch.searchsorted(
            p.seg_id, torch.arange(n_segs + 1, dtype=torch.int32,
                                   device=p.seg_id.device), out_int32=True)
    return cached_on(_SEG_PTRS, plan, build)


def _plan_version(plan: TriFusedPlan):
    # the waves and the walk read which slots hold a value and the gates
    return values_version(plan.vals, plan.aux)


def _slots(plan: TriFusedPlan):
    """The slots that hold a nonzero value, in program order (slab,
    sublane, lane): their segment, lane, column (int64) and value (fp32),
    as numpy arrays."""
    nz = (plan.vals != 0).nonzero().cpu().numpy()  # (g, gh, l), ordered
    g, gh, lane = nz[:, 0], nz[:, 1], nz[:, 2]
    slab = g * plan.group + gh // 8
    sidx = plan.s_idx.cpu().numpy()[g, gh, lane].astype(np.int64) & 127
    win = plan.slab_win.cpu().numpy().astype(np.int64)[slab]
    col = win * _W + (gh % 8) * _LANES + sidx
    seg = plan.seg_id.cpu().numpy().astype(np.int64)[g]
    val = plan.vals.float().cpu().numpy()[g, gh, lane]
    return seg, lane.astype(np.int64), col, val


def _waves_build(plan: TriFusedPlan):
    """(seg_wave, n_waves) from the plan's planes alone.  Wave 0 is x's
    initial value (the rows no segment commits); a segment's wave is one
    more than the largest wave among the segments that commit a (tile,
    lane) its nonzero slots gather, counting only segments earlier in
    program order.  The committing segment of (tile t, lane l) is the one
    whose ``group_tile`` is t and whose gate ``aux[seg, 0, l]`` is
    nonzero.  A slot of value 0 (padding) adds no dependency."""
    n_segs = plan.aux.shape[0]
    if n_segs == 0:
        return np.zeros(0, np.int64), 1
    gate = (plan.aux[:, 0] != 0).cpu().numpy()
    ptr = _seg_ptr(plan).cpu().numpy().astype(np.int64)
    seg_tile = plan.group_tile.cpu().numpy().astype(np.int64)[ptr[:-1]]
    commit = np.full(plan.n_win * _W, -1, np.int64)
    gs, gl = np.nonzero(gate)
    np.maximum.at(commit, seg_tile[gs] * _LANES + gl, gs)
    seg, _, col, _ = _slots(plan)
    dep = commit[col]
    keep = (dep >= 0) & (dep < seg)
    edge = np.unique(seg[keep] * n_segs + dep[keep])
    eseg, edep = edge // n_segs, (edge % n_segs).tolist()
    eptr = np.searchsorted(eseg, np.arange(n_segs + 1)).tolist()
    wave = [0] * n_segs
    for s in range(n_segs):  # deps point to earlier segments only
        w = 0
        for d in edep[eptr[s]:eptr[s + 1]]:
            if wave[d] > w:
                w = wave[d]
        wave[s] = w + 1
    seg_wave = np.asarray(wave, np.int64)
    return seg_wave, int(seg_wave.max()) + 1


def segment_waves(plan: TriFusedPlan):
    """``_waves_build`` of the plan, built once a plan and state of its
    values and gates (an in-place write builds it anew)."""
    return cached_on(_WAVES, plan, _waves_build, _plan_version(plan))


@dataclasses.dataclass(frozen=True)
class FusedWalk:
    """The card's walk of a fused plan (``csrc/trisolve_fused.cu``): the
    committed rows in wave order, cut into chunks that each hold rows of
    one wave only.  A chunk is a run of 32-bit words: a header (rows,
    entries, and the first row and length of the run of x that holds its
    rows, ``span``), a record a row (its index in x, its first and end
    entry within the chunk, gate·inv_diag as fp32 bits), then an entry
    (column, fp32 value bits) a nonzero slot of the row, in the plan's
    slot order; each chunk starts on 16 bytes.  Only slots of nonzero
    value whose lane the segment gates are listed: a gated lane's commit
    ``x = binv − Σ v·x[col] · ginv`` is all that the plan's commit changes
    (an ungated lane keeps its value).  An entry's column has its top bit
    set where the block's cache of x in shared memory (``cache`` rows,
    row r at slot r mod ``cache``, written at every commit) still holds
    it when the entry is read: the row was committed in an earlier wave
    and no other row of its slot is committed from then up to and with
    the reader's wave.  The kernel copies that run of binv with the chunk
    (a multiple of 4 rows from a multiple of 4; a level-sorted plan's rows
    of a wave are contiguous); a chunk whose rows are spread wider has
    none (first row -1) and reads each row's binv from x."""

    blob: torch.Tensor  # (words,) int32, on the plan's device
    chunk_off: torch.Tensor  # (n_chunks + 1,) int64 byte offsets
    span: torch.Tensor  # (n_chunks, 2) int32: the run's first row, rows
    n_chunks: int
    n_waves: int  # waves walked, wave 0 (the initial x) not counted
    stage_bytes: int  # the largest chunk
    span_bytes: int  # the largest run of binv
    lanes: int  # threads that share a row (1, 2, 4, ..., 32)
    rows: int
    entries: int
    cache: int  # rows of the x cache the column flags assume
    cached: int  # entries read from the cache


_CHUNK_BYTES = 32 << 10  # a wave is cut into chunks of at most this size
_X_CACHE = 8192  # rows of x the walk's block keeps in shared memory
_CACHED = np.int64(1) << 31  # a column's flag: read from the cache


def _cache_flags(crow, cwave, n, cache):
    """For the committed rows ``crow`` (committed in waves ``cwave``):
    (wave_of_row, the first wave that overwrites the row's cache slot or
    takes it in its own wave), each (n,); 0 and -1 for a row that no
    segment commits."""
    wave_of = np.zeros(n, np.int64)
    wave_of[crow] = cwave
    slot = crow % cache
    order = np.lexsort((cwave, slot))
    ss, ww = slot[order], cwave[order]
    same = ss[1:] == ss[:-1]
    big = np.iinfo(np.int64).max
    nxt = np.full(len(order), big, np.int64)
    nxt[:-1] = np.where(same, ww[1:], big)
    # two rows of one slot committed in one wave: neither stays readable
    clash = np.r_[False, same & (ww[1:] == ww[:-1])]
    nxt = np.where(clash, ww, nxt)
    nxt_of = np.full(n, -1, np.int64)
    nxt_of[crow[order]] = nxt
    return wave_of, nxt_of


def _walk_build(plan: TriFusedPlan) -> FusedWalk:
    dev = plan.vals.device
    n_segs = plan.aux.shape[0]
    seg_wave, n_waves = segment_waves(plan)
    gate = (plan.aux[:, 0] != 0).cpu().numpy()
    ginv_all = plan.aux[:, 1].cpu().numpy()
    ptr = _seg_ptr(plan).cpu().numpy().astype(np.int64)
    seg_tile = plan.group_tile.cpu().numpy().astype(np.int64)[ptr[:-1]]
    # the committed rows, by (wave, segment, lane)
    rs, rl = np.nonzero(gate)
    order = np.argsort(seg_wave[rs], kind="stable")
    rs, rl = rs[order], rl[order]
    n_rows = len(rs)
    pos = np.full((n_segs, _LANES), -1, np.int64)
    pos[rs, rl] = np.arange(n_rows)
    seg, lane, col, val = _slots(plan)
    srow = pos[seg, lane] if n_segs else np.zeros(0, np.int64)
    keep = srow >= 0
    order = np.argsort(srow[keep], kind="stable")
    ecol = col[keep][order]
    eval_ = val[keep][order].astype(np.float32)
    eptr = np.searchsorted(srow[keep][order], np.arange(n_rows + 1))
    n_ent = np.diff(eptr)
    # the entries that the cache of x still holds when they are read
    crow = seg_tile[rs] * _LANES + rl
    rwave = seg_wave[rs]
    wave_of, nxt_of = _cache_flags(crow, rwave, plan.n_win * _W, _X_CACHE)
    ewave = np.repeat(rwave, n_ent)
    hit = ((wave_of[ecol] > 0) & (wave_of[ecol] < ewave)
           & (ewave < nxt_of[ecol]))
    ecol = np.where(hit, ecol | _CACHED, ecol).astype(np.uint32).view(
        np.int32)
    # chunks: rows of one wave, at most _CHUNK_BYTES (a longer row alone)
    cost = 16 + 8 * n_ent  # bytes of a row's record and entries
    ccum = np.r_[0, np.cumsum(cost)]
    wbound = np.r_[0, np.flatnonzero(np.diff(rwave)) + 1, n_rows]
    cuts = [0]
    for a, b in zip(wbound[:-1], wbound[1:]):
        r = a
        while r < b:
            end = np.searchsorted(ccum, ccum[r] + _CHUNK_BYTES - 16,
                                  side="right") - 1
            end = min(max(end, r + 1), b)
            cuts.append(end)
            r = end
    cuts = np.asarray(cuts, np.int64)
    n_chunks = len(cuts) - 1
    c_rows = np.diff(cuts)
    c_ent = eptr[cuts[1:]] - eptr[cuts[:-1]]
    words = 4 + 4 * c_rows + 2 * c_ent
    words = (words + 3) // 4 * 4
    woff = np.r_[0, np.cumsum(words)]
    blob = np.zeros(int(woff[-1]), np.int32)
    # each chunk's run of x (binv), where it is no wider than 4 rows a
    # committed row and 32 KB
    lo = np.full(n_chunks, -1, np.int64)
    run = np.zeros(n_chunks, np.int64)
    if n_chunks:
        first = np.minimum.reduceat(crow, cuts[:-1]) & ~3
        last = np.maximum.reduceat(crow, cuts[:-1])
        width = (last + 4 - first) & ~3
        tight = (width <= 4 * c_rows + 64) & (width <= 8192)
        lo = np.where(tight, first, -1)
        run = np.where(tight, width, 0)
    blob[woff[:-1]] = c_rows
    blob[woff[:-1] + 1] = c_ent
    blob[woff[:-1] + 2] = lo
    blob[woff[:-1] + 3] = run
    chunk_of_row = np.repeat(np.arange(n_chunks), c_rows)
    ri = np.arange(n_rows) - cuts[chunk_of_row]
    rbase = woff[chunk_of_row] + 4 + 4 * ri
    e0 = eptr[:-1] - eptr[cuts[chunk_of_row]]
    blob[rbase] = crow
    blob[rbase + 1] = e0
    blob[rbase + 2] = e0 + n_ent
    blob[rbase + 3] = ginv_all[rs, rl].astype(np.float32).view(np.int32)
    chunk_of_ent = np.repeat(chunk_of_row, n_ent)
    ei = np.arange(len(ecol)) - eptr[cuts[chunk_of_ent]]
    ebase = woff[chunk_of_ent] + 4 + 4 * c_rows[chunk_of_ent] + 2 * ei
    blob[ebase] = ecol
    blob[ebase + 1] = eval_.view(np.int32)
    mean = len(ecol) / max(n_rows, 1)
    lanes = 1
    while lanes < 32 and lanes * 4 < mean:
        lanes *= 2
    return FusedWalk(
        blob=torch.from_numpy(blob).to(dev),
        chunk_off=torch.from_numpy(woff * 4).to(dev),
        span=torch.from_numpy(np.stack([lo, run], 1).astype(np.int32)).to(
            dev),
        n_chunks=n_chunks, n_waves=n_waves - 1,
        stage_bytes=int(words.max()) * 4 if n_chunks else 0,
        span_bytes=int(run.max()) * 4 if n_chunks else 0,
        lanes=lanes, rows=n_rows, entries=len(ecol), cache=_X_CACHE,
        cached=int(hit.sum()))


def fused_walk(plan: TriFusedPlan) -> FusedWalk:
    """``_walk_build`` of the plan, built once a plan and state of its
    values and gates (an in-place write builds it anew)."""
    return cached_on(_WALKS, plan, _walk_build, _plan_version(plan))


def fused_walk_plain(walk: FusedWalk, binv: torch.Tensor) -> torch.Tensor:
    """The walk on the CPU (tests): chunk by chunk, every row of a chunk
    gathers x before any commits, ``x[row] -= Σ v·x[col] · ginv``."""
    x = binv.clone()
    blob = walk.blob.cpu()
    off = (walk.chunk_off // 4).tolist()
    for c in range(walk.n_chunks):
        w = blob[off[c]:off[c + 1]]
        nr, ne = int(w[0]), int(w[1])
        rec = w[4:4 + 4 * nr].reshape(nr, 4)
        ent = w[4 + 4 * nr:4 + 4 * nr + 2 * ne].reshape(ne, 2)
        v = ent[:, 1].contiguous().view(torch.float32).to(x.device)
        prod = v * x[(ent[:, 0].long() & (_CACHED - 1)).to(x.device)]
        row_of = torch.repeat_interleave(torch.arange(nr),
                                         (rec[:, 2] - rec[:, 1]).long())
        acc = torch.zeros(nr, dtype=torch.float32, device=x.device)
        acc.index_add_(0, row_of.to(x.device), prod)
        rows = rec[:, 0].long().to(x.device)
        ginv = rec[:, 3].contiguous().view(torch.float32).to(x.device)
        x[rows] = x[rows] - acc * ginv
    return x


def _segment_part(plan: TriFusedPlan, x: torch.Tensor, sl: slice,
                  si: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """Σ over slabs ``sl`` and their sublanes of vals · x[column], per
    lane (128,)."""
    N = x.shape[0]
    sub = torch.arange(8, device=x.device)[None, :, None] * _LANES
    col = plan.slab_win[sl].long()[:, None, None] * _W + sub + (
        si[sl].long() & 127)
    ok = col < N
    return (vv[sl].float() * torch.where(ok, x[col.clamp(max=N - 1)],
                                         0.0)).sum(dim=(0, 1))


def _fused_plain(plan: TriFusedPlan, binv: torch.Tensor) -> torch.Tensor:
    """The segments in order: gather the solved prefix, sum, commit the
    gated lanes of the segment's tile."""
    x = binv.clone()
    si = plan.s_idx.reshape(-1, 8, _LANES)
    vv = plan.vals.reshape(-1, 8, _LANES)
    ptr = _seg_ptr(plan).tolist()
    tiles = plan.group_tile.tolist()
    for seg in range(plan.aux.shape[0]):
        sl = slice(ptr[seg] * plan.group, ptr[seg + 1] * plan.group)
        part = _segment_part(plan, x, sl, si, vv)
        t = tiles[ptr[seg]]
        rows = slice(t * _LANES, (t + 1) * _LANES)
        xb, bb = x[rows], binv[rows]
        x[rows] = xb + plan.aux[seg, 0] * (bb - xb) - part * plan.aux[seg, 1]
    return x


_ARGTYPES = (
    ctypes.c_void_p,  # blob int32
    ctypes.c_void_p,  # chunk_off (n_chunks+1,) int64
    ctypes.c_void_p,  # span (n_chunks, 2) int32
    ctypes.c_int,  # n_chunks
    ctypes.c_void_p,  # x fp32: binv, solved in place
    ctypes.c_int,  # stage bytes
    ctypes.c_int,  # span bytes
    ctypes.c_int,  # rows of the x cache
    ctypes.c_int,  # lanes a row
    ctypes.c_int,  # ablate (measurements only)
    ctypes.c_void_p,  # stream
)


def _fused_cuda(plan: TriFusedPlan, binv: torch.Tensor, *, lanes: int = 0,
                ablate: int = 0) -> torch.Tensor:
    """The wave walk on the card; solves ``binv`` (padded, (n_win·1024,)
    fp32) in place and returns it.  ``lanes`` (threads a row, 1-32; 0 the
    walk's choice) is a knob for measurements only; so is ``ablate``
    (1: no store of x to global memory; 2: no row's work, the waits,
    refills and barriers alone; 3: the barriers alone; 4: the solve
    without the runs of binv, each row's read from x), whose result is not
    the solve but for 4."""
    if not binv.is_cuda or plan.vals.device != binv.device:
        raise ValueError("trisolve_fused: the plan and b must lie on one "
                         "CUDA device")
    if (binv.shape != (plan.n_win * _W,) or binv.dtype != torch.float32
            or not binv.is_contiguous()):
        raise ValueError("trisolve_fused: b must be contiguous fp32 of the "
                         "plan's padded length")
    walk = fused_walk(plan)
    lanes = lanes or walk.lanes
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError("trisolve_fused: lanes must be 1-32, a power of "
                         "two")
    if walk.n_chunks == 0:
        return binv
    fn = _build.load("trisolve_fused", _ARGTYPES)
    with torch.cuda.device(binv.device):
        err = fn(walk.blob.data_ptr(), walk.chunk_off.data_ptr(),
                 walk.span.data_ptr(), walk.n_chunks, binv.data_ptr(),
                 walk.stage_bytes, walk.span_bytes, walk.cache, lanes,
                 ablate, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"trisolve_fused: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["trisolve_fused"] += 1
    return binv


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
        binv = torch.nn.functional.pad(x0.float(), (0, plan.n_win * _W - n))
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
