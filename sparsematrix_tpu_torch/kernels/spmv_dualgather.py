"""Dual-gather SpMV: the packer and ``csrc/spmv_dualgather.cu``.

Twin of ``sparsematrix_tpu/kernels/spmv_dualgather.py``.  A slab is an
(8, 128) block over a 1024-column window w of a 128-row tile t with three
planes: ``vals``, ``idxB`` (per slot (u, l): its column's lane
``cl = c % 128``) and ``idxA`` (per (u, cl): which of the window's 8
128-column chunks feeds that lane).  The product of one slab is

    t1[u, cl] = xw[idxA[u, cl], cl]      # chunk select
    out[u, l] = t1[u, idxB[u, l]]        # lane route
    y[t*128 + l] += sum_u vals[u, l] * out[u, l]

An entry (r, c) may sit at any sublane u of lane l = r % 128 of any slab of
its (t, w), subject to (C1) one entry per (slab, u, row) and (C2) within
(slab, u), equal ``cl`` implies equal chunk.  ``k_tiles > 1`` packs
superblocks: a group's slabs span ``k_tiles`` tiles and ``slab_tloc``
names the tile within the superblock; ``nibble`` stores two slabs' idxA
in one byte plane (low nibble: even slab, high: odd); ``two_win`` gives
each slab two windows (``slab_win = wa | wb << 16``) and bit 3 of idxA
picks one per cell.

The host packer is the JAX packer's algorithm line for line, so every
plane comes out ``np.array_equal`` to it: slot assignment by the native
first-fit (``native/assign.cc``, built by ``g++`` at first use), or by
the numpy conflict repair where no compiler is found.  Padding slots hold
value 0 with in-range pack indices; their column may lie past ``cols``
in the last window, where x reads as 0.

``spill_cap`` caps the entries a (tile, window, row) keeps in the body;
the rest go to a pooled tail (``PooledDG``): slabs of one tile whose 8
sublanes each point at any 128-column chunk of x, so deep rows of many
windows share slabs.  Its packer is the JAX packer's greedy loop, so its
planes come out equal too.

``spmv_dualgather(packed, x)`` runs ``spmv_dualgather_reference`` when all
its inputs lie on the CPU, and otherwise launches the body's kernel and,
for a pack with a tail, ``csrc/spmv_pooled.cu`` on the same output, or
raises.  It is differentiable in x and in the values of the body and the
tail (the JAX wrapper's custom VJP, ``spmv_dualgather.py:1240-1273``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.base import sparse_container, static_field
from ..formats.csr import CSR
from . import _build

__all__ = ["DualGather", "PooledDG", "pack_dualgather", "spmv_dualgather",
           "spmv_dualgather_reference", "pooled_plain"]

_W = 1024
_LANES = 128
_T = 128  # rows per tile (lane = row slot, no lane sharing)

@sparse_container
@dataclasses.dataclass(frozen=True)
class PooledDG:
    """Cross-window pooled spill slabs: each sublane of a slab carries its
    own global 128-column chunk pointer, so deep-row tail entries of
    different windows share slabs.  The dual-gather planes otherwise; idxA
    picks one of the slab's 8 pointers (plain int8, never nibble-packed)."""

    ptr: torch.Tensor  # (n_groups, group, 8) int32: global chunk per sublane
    idxA: torch.Tensor  # (n_groups, group*8, 128) int8: pointer per (u, cl)
    idxB: torch.Tensor  # (n_groups, group*8, 128) int8: cl per (u, l)
    vals: torch.Tensor  # (n_groups, group*8, 128)
    group_tile: torch.Tensor  # (n_groups,) int32, ascending
    shape: Tuple[int, int] = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    nnz: int = static_field()


@sparse_container
@dataclasses.dataclass(frozen=True)
class DualGather:
    idxA: torch.Tensor  # (n_groups, group*8 or group/2*8, 128) int8
    idxB: torch.Tensor  # (n_groups, group*8, 128) int8: cl per (u, l)
    vals: torch.Tensor  # (n_groups, group*8, 128) fp32 or bf16
    group_tile: torch.Tensor  # (n_groups,) int32: tile (k_tiles=1) or
    #                           superblock id (k_tiles>1), ascending
    slab_win: torch.Tensor  # (n_groups, group) int32
    slab_tloc: Optional[torch.Tensor]  # (n_groups, group) int32 (k_tiles>1)
    commit: Optional[torch.Tensor]  # (n_groups,) int32 (k_tiles>1)
    tail: Optional[PooledDG]  # pooled spill slabs (spill_cap packs)
    t_pack: Optional["DualGather"]  # packed A^T for the backward pass
    shape: Tuple[int, int] = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    k_tiles: int = static_field()
    nnz: int = static_field()
    # superblock-aligned call boundaries of the JAX kernel's prefetch
    # budget, kept so the planes stay equal; one launch covers all groups
    splits: Tuple[int, ...] = dataclasses.field(
        default=(), metadata={"static": True})
    nibble: bool = dataclasses.field(default=False, metadata={"static": True})
    two_win: bool = dataclasses.field(default=False,
                                      metadata={"static": True})

    @property
    def fill_rate(self) -> float:
        slots = self.vals.numel() + (self.tail.vals.numel() if self.tail
                                     else 0)
        return self.nnz / max(slots, 1)

    @property
    def n_slabs(self) -> int:
        return self.idxB.shape[0] * self.group


# ---------------------------------------------------------------------------
# host packer (numpy; the JAX packer's algorithm)
# ---------------------------------------------------------------------------

def _spill_mask(r, c, rows, cols, cap):
    """True for entries whose occurrence rank within (tile, window, row)
    is >= cap: the deep-row tail that window-scoped slabs cannot pack."""
    t = r // _T
    l = r % _T
    w = c // _W
    n_win = max(-(-cols // _W), 1)
    key = (t * n_win + w) * np.int64(_T) + l
    order = np.argsort(key, kind="stable")
    ko = key[order]
    n = r.size
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = ko[1:] != ko[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    d = np.empty(n, np.int64)
    d[order] = np.arange(n) - run_start
    return d >= cap


def _pack_pooled(r, c, v, rows, cols, group, dtype):
    """Greedy pooled-slab packer for the spill tail: per tile, take the 8
    chunks with the most entries left, fill one slab (each entry at the
    first free sublane from ``(l + cl) % 8`` whose (u, cl) cell is free or
    already points at its chunk), repeat.  The JAX packer's loop, on
    Python lists; the same planes."""
    n_tiles = -(-rows // _T)
    n_win = max(-(-cols // _W), 1)
    t = (r // _T).astype(np.int64)
    l_of = (r % _T).tolist()
    chunk_of = (c // _LANES).tolist()
    cl_of = (c % _LANES).tolist()

    slab_tile, slab_ptr, placed_slabs = [], [], []
    order = np.argsort(t, kind="stable")
    bounds = np.searchsorted(t[order], np.arange(n_tiles + 1))
    for ti in range(n_tiles):
        sel = order[bounds[ti]:bounds[ti + 1]].tolist()
        if not sel:
            continue
        by_chunk: dict = {}
        for e in sel:
            by_chunk.setdefault(chunk_of[e], []).append(e)
        while by_chunk:
            top = sorted(by_chunk, key=lambda k: -len(by_chunk[k]))[:8]
            ptr = (top + [top[0]] * (8 - len(top)))
            rowused = bytearray(8 * _T)
            cellslot = [-1] * (8 * _LANES)
            placed = []  # (u, l, cl, k, entry)
            for k, ck in enumerate(top):
                left = []
                for e in by_chunk[ck]:
                    le, cle = l_of[e], cl_of[e]
                    u0 = (le + cle) % 8
                    for uu in range(u0, u0 + 8):
                        u = uu & 7
                        if rowused[u * _T + le]:
                            continue
                        cs = cellslot[u * _LANES + cle]
                        if cs == -1 or cs == k:
                            rowused[u * _T + le] = 1
                            cellslot[u * _LANES + cle] = k
                            placed.append((u, le, cle, k, e))
                            break
                    else:
                        left.append(e)
                if left:
                    by_chunk[ck] = left
                else:
                    del by_chunk[ck]
            slab_tile.append(ti)
            slab_ptr.append(ptr)
            placed_slabs.append(placed)

    n_slabs = max(len(slab_tile), 1)
    if not slab_tile:
        slab_tile = [0]
        slab_ptr = [[0] * 8]
        placed_slabs = [[]]
    stile = np.asarray(slab_tile, np.int64)
    counts = np.bincount(stile, minlength=n_tiles)
    if group is None:
        group = 1
        for g in (32, 16, 8, 4, 2):
            waste = ((-(-counts // g) * g).sum() - n_slabs) / max(n_slabs, 1)
            if waste <= 0.15:
                group = g
                break
    tile_groups = -(-counts // group)
    padded = tile_groups * group
    tile_offset = np.concatenate([[0], np.cumsum(padded)])
    first_of_tile = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(n_slabs) - first_of_tile[stile]
    slot = tile_offset[stile] + rank
    total = int(tile_offset[-1])
    n_groups = total // group
    iA = np.zeros((total, 8, _LANES), np.int8)
    iB = np.zeros((total, 8, _LANES), np.int8)
    vv = np.zeros((total, 8, _LANES), dtype)
    pt = np.zeros((total, 8), np.int64)
    pt[slot] = np.asarray(slab_ptr, np.int64)
    n_placed = sum(len(p) for p in placed_slabs)
    if n_placed:
        s_of = np.repeat(slot, [len(p) for p in placed_slabs])
        u, le, cle, k, e = np.asarray(
            [q for p in placed_slabs for q in p], np.int64).T
        iA[s_of, u, cle] = k
        iB[s_of, u, le] = cle
        vv[s_of, u, le] = v[e]
    group_tile = np.repeat(np.arange(n_tiles), tile_groups)
    return dict(
        ptr=pt.reshape(n_groups, group, 8),
        idxA=iA.reshape(n_groups, group * 8, _LANES),
        idxB=iB.reshape(n_groups, group * 8, _LANES),
        vals=vv.reshape(n_groups, group * 8, _LANES),
        group_tile=group_tile,
        n_tiles=n_tiles, n_win=n_win, group=group,
    )


def _pair_windows(deg):
    """Per-tile greedy matching of windows into pairs minimizing the joint
    slab count ceil(max_row(deg_a + deg_b) / 8).

    deg: (n_tiles, n_win, _T) per-(tile, window, row-lane) degree counts.
    Returns pairs (n_tiles, n_pairs, 2); an odd window count pairs the
    last window with itself.
    """
    n_tiles, n_win, _ = deg.shape
    n_pairs = (n_win + 1) // 2
    pairs = np.zeros((n_tiles, n_pairs, 2), np.int64)
    for ti in range(n_tiles):
        d = deg[ti]
        order = np.argsort(-d.max(axis=1))
        used = np.zeros(n_win, bool)
        out = []
        for wi in order:
            if used[wi]:
                continue
            used[wi] = True
            cand = np.nonzero(~used)[0]
            if cand.size == 0:
                out.append((wi, wi))
                continue
            joint = d[wi][None, :] + d[cand]
            cost = -(-joint.max(axis=1) // 8)
            best = cand[int(np.argmin(cost))]
            used[best] = True
            out.append((wi, best))
        pairs[ti] = np.asarray(out)
    return pairs


def _two_win_ids(r, c, rows, cols):
    """Per-entry (pair-id, synthetic-chunk) for the two-window layout.

    Returns (w_ids, ch_ids, pairtab): w_ids = tile-local pair index,
    ch_ids = chunk 0-7 + 8·side, pairtab (n_tiles, n_pairs, 2) windows.
    """
    t = r // _T
    l = r % _T
    w = c // _W
    n_tiles = max(-(-rows // _T), 1)
    n_win = max(-(-cols // _W), 1)
    deg = np.zeros((n_tiles, n_win, _T), np.int32)
    np.add.at(deg, (t, w, l), 1)
    pairtab = _pair_windows(deg)
    pid_of = np.zeros((n_tiles, n_win), np.int64)
    side_of = np.zeros((n_tiles, n_win), np.int64)
    ar = np.arange(pairtab.shape[1])
    for ti in range(n_tiles):
        pid_of[ti, pairtab[ti, :, 0]] = ar
        side_of[ti, pairtab[ti, :, 0]] = 0
        pid_of[ti, pairtab[ti, :, 1]] = ar
        side_of[ti, pairtab[ti, :, 1]] = 1
        # self-paired windows keep side 0
        selfp = pairtab[ti, :, 0] == pairtab[ti, :, 1]
        side_of[ti, pairtab[ti, selfp, 0]] = 0
    w_ids = pid_of[t, w]
    ch_ids = (c % _W) // _LANES + 8 * side_of[t, w]
    return w_ids, ch_ids, pairtab


_ASSIGN_ARGTYPES = (
    ctypes.c_void_p,  # cell (n,) int64
    ctypes.c_void_p,  # l (n,) int32
    ctypes.c_void_p,  # cl (n,) int32
    ctypes.c_void_p,  # ch (n,) int32
    ctypes.c_long,  # n
    ctypes.c_long,  # n_cells
    ctypes.c_void_p,  # out_s (n,) int32
    ctypes.c_void_p,  # out_u (n,) int8
)


def _assign_slots_native(r, c, rows, cols, w_ids=None, ch_ids=None):
    """Native sequential first-fit assignment (``native/assign.cc``).
    Returns the assigned tuple, or None where no ``g++`` is found."""
    fn = _build.load_host("assign", "smtpu_assign_dualgather",
                          _ASSIGN_ARGTYPES)
    if fn is None or r.size == 0:
        return None
    t = (r // _T).astype(np.int64)
    l = np.ascontiguousarray((r % _T).astype(np.int32))
    w = (c // _W if w_ids is None else w_ids).astype(np.int64)
    cl = np.ascontiguousarray((c % _LANES).astype(np.int32))
    ch = np.ascontiguousarray(
        ((c % _W) // _LANES if ch_ids is None else ch_ids).astype(np.int32))
    n_win = max(-(-cols // _W), 1)
    cellid = np.ascontiguousarray(t * n_win + w)
    n_cells = int(cellid.max()) + 1
    out_s = np.empty(r.size, np.int32)
    out_u = np.empty(r.size, np.int8)
    rc = fn(cellid.ctypes.data, l.ctypes.data, cl.ctypes.data, ch.ctypes.data,
            r.size, n_cells, out_s.ctypes.data, out_u.ctypes.data)
    if rc < 0:
        return None
    return (t, w, out_s.astype(np.int64), out_u.astype(np.int64),
            l.astype(np.int64), cl.astype(np.int64), ch.astype(np.int64))


def _assign_slots(r, c, rows, cols, max_rounds=2000, w_ids=None,
                  ch_ids=None):
    """Vectorized conflict-repair assignment (active-set formulation).

    Returns (t, w, s, u, l, cl, ch) numpy arrays, one per entry, satisfying
    C1/C2.  Seeds s/u from each entry's occurrence rank within its
    (t, w, row) group, then iterates on the unsettled set: an entry
    settles when its (t,w,s,u,l) row slot is free and its (t,w,s,u,cl)
    chunk cell is free or already carries its chunk; losers advance to the
    next sublane, and after all 8, to the next slab.  Two compaction
    passes then re-sweep entries parked above their cell's bound.

    ``w_ids``/``ch_ids`` override the default window/chunk coordinates
    (two-window layout: pair index + 4-bit synthetic chunk).  The native
    first-fit (``_assign_slots_native``) is tried first; this numpy
    machine runs only where no compiler is found.
    """
    native = _assign_slots_native(r, c, rows, cols, w_ids=w_ids,
                                  ch_ids=ch_ids)
    if native is not None:
        return native
    t = r // _T
    l = r % _T
    w = c // _W if w_ids is None else w_ids
    cl = c % _LANES
    ch = (c % _W) // _LANES if ch_ids is None else ch_ids
    n = r.size
    n_win = max(-(-cols // _W), 1)

    # occurrence rank within (t, w, row)
    key_row = (t * n_win + w) * np.int64(_T) + l
    order = np.argsort(key_row, kind="stable")
    ko = key_row[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = ko[1:] != ko[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    d = np.empty(n, np.int64)
    d[order] = np.arange(n) - run_start

    s = d // 8
    u = d % 8
    tries = np.zeros(n, np.int8)  # sublanes tried at current slab level
    twk = (t.astype(np.int64) * n_win + w)

    # settled occupancy: sorted row-slot keys; sorted chunk-cell keys with
    # their winning chunk (same-key same-ch entries share a cell freely)
    occ_row = np.empty(0, np.int64)
    occ_cell = np.empty(0, np.int64)
    occ_cell_ch = np.empty(0, np.int8)
    active = np.arange(n)
    # key spans are fixed up-front so settled keys stay comparable across
    # rounds (s can only grow; give it generous headroom)
    s_span = np.int64(max(int(s.max()) + 64, 256) * 16)

    def _k(idx):
        base = (twk[idx] * s_span + s[idx]) * 8 + u[idx]
        return base * _T + l[idx], base * _LANES + cl[idx]

    def _sweep(active):
        nonlocal occ_row, occ_cell, occ_cell_ch, s_span
        stall = 0
        prev_size = -1
        for _ in range(max_rounds):
            if active.size == 0:
                return
            if active.size == prev_size:
                stall += 1
            else:
                stall, prev_size = 0, active.size
            k1a, k2a = _k(active)
            cha = ch[active].astype(np.int8)
            # conflicts with settled occupancy
            p1 = np.searchsorted(occ_row, k1a)
            bad = (p1 < occ_row.size) & (occ_row[p1 % max(occ_row.size, 1)]
                                         == k1a) if occ_row.size else \
                np.zeros(active.size, bool)
            p2 = np.searchsorted(occ_cell, k2a)
            if occ_cell.size:
                hit = (p2 < occ_cell.size) & (
                    occ_cell[np.minimum(p2, occ_cell.size - 1)] == k2a)
                bad |= hit & (occ_cell_ch[np.minimum(p2, occ_cell.size - 1)]
                              != cha)
            # conflicts among the active set itself: first of each (k1)
            # group wins; within a (k2) group the first DISTINCT ch wins
            o1 = np.argsort(k1a, kind="stable")
            k1o = k1a[o1]
            f1 = np.empty(active.size, bool)
            f1[0] = True
            f1[1:] = k1o[1:] != k1o[:-1]
            b1 = np.zeros(active.size, bool)
            b1[o1] = ~f1
            bad |= b1
            # winner of a (k2) cell group: smallest ch first, except after
            # a stall, where the index rule guarantees progress
            if stall >= 50:
                o2 = np.argsort(k2a, kind="stable")
            else:
                o2 = np.lexsort((cha, k2a))
            k2o = k2a[o2]
            f2 = np.empty(active.size, bool)
            f2[0] = True
            f2[1:] = k2o[1:] != k2o[:-1]
            grp_start = np.maximum.accumulate(
                np.where(f2, np.arange(active.size), 0))
            b2 = np.zeros(active.size, bool)
            b2[o2] = cha[o2] != cha[o2][grp_start]
            bad |= b2

            # settle the winners: fold their keys into the occupancy
            win = active[~bad]
            if win.size:
                wk1, wk2 = _k(win)
                wk1.sort()
                occ_row = np.insert(occ_row, np.searchsorted(occ_row, wk1),
                                    wk1)
                ord2 = np.argsort(wk2, kind="stable")
                wk2s = wk2[ord2]
                wch = ch[win][ord2].astype(np.int8)
                # dedupe new cells (same-column entries share one)
                keep = np.empty(wk2s.size, bool)
                keep[0] = True
                keep[1:] = wk2s[1:] != wk2s[:-1]
                wk2s, wch = wk2s[keep], wch[keep]
                pos = np.searchsorted(occ_cell, wk2s)
                occ_cell = np.insert(occ_cell, pos, wk2s)
                occ_cell_ch = np.insert(occ_cell_ch, pos, wch)

            active = active[bad]
            if active.size:
                u[active] = (u[active] + 1) % 8
                tries[active] += 1
                promote = active[tries[active] >= 8]
                s[promote] += 1
                tries[promote] = 0
                if s.max() * 16 >= s_span:  # headroom exceeded: rebase
                    s_span = np.int64(int(s.max()) * 64)
                    # settled keys used the old span — recompute
                    settled_mask = np.ones(n, bool)
                    settled_mask[active] = False
                    sk1, sk2 = _k(np.nonzero(settled_mask)[0])
                    occ_row = np.sort(sk1)
                    so = np.argsort(sk2, kind="stable")
                    occ_cell = sk2[so]
                    occ_cell_ch = ch[np.nonzero(settled_mask)[0]][so].astype(
                        np.int8)
                    keep = np.empty(occ_cell.size, bool)
                    if occ_cell.size:
                        keep[0] = True
                        keep[1:] = occ_cell[1:] != occ_cell[:-1]
                        occ_cell = occ_cell[keep]
                        occ_cell_ch = occ_cell_ch[keep]
        raise RuntimeError("dualgather packer failed to converge")

    _sweep(active)

    # compaction: re-sweep every entry parked at s >= its cell's bound from
    # s=0 against the final occupancy; keep the result only if it packs
    # fewer slabs
    def _n_slabs():
        kk = twk * np.int64(s.max() + 1) + s
        return np.unique(kk).size

    for _compact in range(2):
        deg = np.zeros((twk.max() + 1, _T), np.int32)
        np.add.at(deg, (twk, l), 1)
        bound_cell = -(-deg.max(axis=1) // 8)
        excess = np.nonzero(s >= bound_cell[twk])[0]
        if excess.size == 0:
            break
        before = _n_slabs()
        save_s, save_u = s.copy(), u.copy()
        keep_mask = np.ones(n, bool)
        keep_mask[excess] = False
        kept = np.nonzero(keep_mask)[0]
        kk1, kk2 = _k(kept)
        occ_row = np.sort(kk1)
        so = np.argsort(kk2, kind="stable")
        occ_cell = kk2[so]
        occ_cell_ch = ch[kept][so].astype(np.int8)
        if occ_cell.size:
            keep = np.empty(occ_cell.size, bool)
            keep[0] = True
            keep[1:] = occ_cell[1:] != occ_cell[:-1]
            occ_cell = occ_cell[keep]
            occ_cell_ch = occ_cell_ch[keep]
        # reseed by occurrence rank within (cell, row): same-row resets
        # get distinct (s, u) so the sweep never livelocks in lockstep
        keyx = twk[excess] * np.int64(_T) + l[excess]
        ox = np.argsort(keyx, kind="stable")
        kxo = keyx[ox]
        newx = np.empty(excess.size, bool)
        newx[0] = True
        newx[1:] = kxo[1:] != kxo[:-1]
        rsx = np.maximum.accumulate(np.where(newx, np.arange(excess.size),
                                             0))
        dx = np.empty(excess.size, np.int64)
        dx[ox] = np.arange(excess.size) - rsx
        s[excess] = dx // 8
        u[excess] = (dx + l[excess] + cl[excess]) % 8
        tries[excess] = 0
        _sweep(excess.copy())
        if _n_slabs() >= before:  # not an improvement: keep the original
            s, u = save_s, save_u
            break
    return t, w, s, u, l, cl, ch


def _pack_arrays(r, c, v, rows, cols, group, dtype, k_tiles=1, assigned=None):
    n_tiles = -(-rows // _T)
    n_win = max(-(-cols // _W), 1)
    if r.size == 0:
        group = group or 8
        return dict(
            idxA=np.zeros((1, group * 8, _LANES), np.int8),
            idxB=np.zeros((1, group * 8, _LANES), np.int8),
            vals=np.zeros((1, group * 8, _LANES), dtype),
            group_tile=np.zeros((1,), np.int64),
            slab_win=np.zeros((1, group), np.int64),
            slab_tloc=np.zeros((1, group), np.int64),
            commit=np.ones((1,), np.int64),
            n_tiles=n_tiles, n_win=n_win, group=group, k_tiles=k_tiles,
        )
    if assigned is None:
        assigned = _assign_slots(r, c, rows, cols)
    t, w, s, u, l, cl, ch = assigned

    # slab identity (t, w, s) → contiguous slots, t-major; with
    # k_tiles > 1 group padding quantizes per superblock of k_tiles tiles
    d_span = int(s.max()) + 1
    skey = (t.astype(np.int64) * n_win + w) * d_span + s
    uskey, inv = np.unique(skey, return_inverse=True)
    slab_t = uskey // (n_win * d_span)
    slab_w = (uskey // d_span) % n_win
    n_slabs = len(uskey)
    slab_sb = slab_t // k_tiles
    n_super = -(-n_tiles // k_tiles)
    counts = np.bincount(slab_sb, minlength=n_super)
    if group is None:
        group = 1
        for g in (256, 128, 64, 32, 16, 8, 4, 2):
            waste = ((-(-counts // g) * g).sum() - n_slabs) / max(n_slabs, 1)
            if waste <= 0.15:
                group = g
                break
    sb_groups = -(-counts // group)
    padded = sb_groups * group
    sb_offset = np.concatenate([[0], np.cumsum(padded)])
    first_of_sb = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(n_slabs) - first_of_sb[slab_sb]
    slab_slot = sb_offset[slab_sb] + rank
    total_slots = int(sb_offset[-1])
    n_groups = total_slots // group

    idxA = np.zeros((total_slots, 8, _LANES), np.int8)
    idxB = np.zeros((total_slots, 8, _LANES), np.int8)
    vals = np.zeros((total_slots, 8, _LANES), dtype)
    win = np.zeros(total_slots, np.int64)
    tloc = np.zeros(total_slots, np.int64)
    entry_slot = slab_slot[inv]
    idxB[entry_slot, u, l] = cl
    idxA[entry_slot, u, cl] = ch
    vals[entry_slot, u, l] = v
    win[slab_slot] = slab_w
    tloc[slab_slot] = slab_t % k_tiles
    group_tile = np.repeat(np.arange(n_super), sb_groups)
    pos = np.arange(len(group_tile)) - np.concatenate(
        [[0], np.cumsum(sb_groups)])[group_tile]
    commit = (pos == sb_groups[group_tile] - 1).astype(np.int64)
    return dict(
        idxA=idxA.reshape(n_groups, group * 8, _LANES),
        idxB=idxB.reshape(n_groups, group * 8, _LANES),
        vals=vals.reshape(n_groups, group * 8, _LANES),
        group_tile=group_tile,
        slab_win=win.reshape(n_groups, group),
        slab_tloc=tloc.reshape(n_groups, group),
        commit=commit,
        n_tiles=n_tiles, n_win=n_win, group=group, k_tiles=k_tiles,
    )


# slot assignments per (CSR container, two_win): the assignment depends on
# (r, c) only, so re-packs at other (group, k_tiles, dtype) are nearly
# free.  Entries leave with their container.
_ASSIGN_CACHE: dict = {}


def pack_dualgather(csr: CSR, group: int | None = None,
                    with_transpose: bool = False,
                    spill_cap: int | str | None = None,
                    k_tiles: int = 1,
                    dtype=None,
                    two_win: bool = False,
                    device=None) -> DualGather:
    """Pack a CSR into dual-gather slabs, on ``device`` (default: the
    CSR's).

    ``group``: slabs per group (None → the ≤15 % padding-waste rule,
    largest of 256..2).  ``with_transpose`` also packs A^T for the
    backward pass.  ``dtype=torch.bfloat16`` stores the values in bf16
    (accumulation stays fp32).  ``k_tiles > 1`` packs superblocks of
    ``k_tiles`` tiles; ``two_win`` (superblocks only) gives each slab two
    windows.  ``spill_cap`` caps the entries a (tile, window, row) keeps in
    the body and pools the rest in the tail (``PooledDG``); ``"auto"``
    takes 8·round(mean / 8) of the mean row-window degree, or no cap below
    a mean of 8.  It excludes ``two_win``.
    """
    if two_win and k_tiles <= 1:
        raise ValueError("two_win requires the superblock path (k_tiles>1)")
    if two_win and spill_cap is not None:
        raise ValueError("two_win is incompatible with spill_cap")
    dev = csr.device if device is None else torch.device(device)
    sp = csr.to_scipy().tocoo()
    rows, cols = sp.shape
    r = sp.row.astype(np.int64)
    c = sp.col.astype(np.int64)
    v = sp.data
    tail = None
    if spill_cap == "auto" and r.size:
        n_win = max(-(-cols // _W), 1)
        # mean entries a (row, window), rounded to the slab capacity
        mean_deg = r.size / max(-(-rows // _T) * _T * n_win, 1)
        cap = 8 * max(1, int(round(mean_deg / 8)))
        spill_cap = cap if mean_deg >= 8 else None
    if spill_cap is not None and r.size:
        sm = _spill_mask(r, c, rows, cols, int(spill_cap))
        if sm.any():
            parrs = _pack_pooled(r[sm], c[sm], v[sm], rows, cols, None,
                                 v.dtype)
            tvals = torch.from_numpy(parrs["vals"]).to(dev)
            tail = PooledDG(
                ptr=_put(parrs["ptr"], torch.int32, dev),
                idxA=_put(parrs["idxA"], torch.int8, dev),
                idxB=_put(parrs["idxB"], torch.int8, dev),
                vals=tvals if dtype is None else tvals.to(dtype),
                group_tile=_put(parrs["group_tile"], torch.int32, dev),
                shape=(rows, cols), n_tiles=parrs["n_tiles"],
                n_win=parrs["n_win"], group=parrs["group"],
                nnz=int(sm.sum()))
            r, c, v = r[~sm], c[~sm], v[~sm]
    assigned = None
    pairtab = None
    if two_win and r.size:
        w_ids, ch_ids, pairtab = _two_win_ids(r, c, rows, cols)
    if tail is None and r.size:
        # the assignment depends on (r, c) only: cached per container, so
        # re-packs at other (group, k_tiles, dtype) are nearly free
        key = (id(csr), two_win)
        ent = _ASSIGN_CACHE.get(key)
        if ent is not None and ent[0]() is csr:
            assigned = ent[1]
        else:
            if two_win:
                assigned = _assign_slots(r, c, rows, cols, w_ids=w_ids,
                                         ch_ids=ch_ids)
            else:
                assigned = _assign_slots(r, c, rows, cols)
            ref = weakref.ref(csr,
                              lambda _u, k=key: _ASSIGN_CACHE.pop(k, None))
            _ASSIGN_CACHE[key] = (ref, assigned)
    arrs = _pack_arrays(r, c, v, rows, cols, group, v.dtype,
                        k_tiles=k_tiles, assigned=assigned)
    if two_win:
        # slab_win holds the tile-local pair index; repack it as
        # (wa | wb << 16) physical window pointers for the kernel
        gsup = np.asarray(arrs["group_tile"])[:, None]
        tile = np.minimum(gsup * k_tiles + np.asarray(arrs["slab_tloc"]),
                          arrs["n_tiles"] - 1)
        pid = np.asarray(arrs["slab_win"])
        if pairtab is None:  # empty matrix
            pairtab = np.zeros((arrs["n_tiles"], 1, 2), np.int64)
        pid = np.minimum(pid, pairtab.shape[1] - 1)
        wa = pairtab[tile, pid, 0]
        wb = pairtab[tile, pid, 1]
        arrs["slab_win"] = wa | (wb << 16)
    t_pack = None
    if with_transpose:
        t_pack = pack_dualgather(
            CSR.from_scipy(csr.to_scipy().T.tocsr(), device="cpu"),
            group=group, spill_cap=spill_cap, k_tiles=k_tiles,
            with_transpose=False, dtype=dtype, two_win=two_win, device=dev)
    idxA_np = np.asarray(arrs["idxA"], np.int8)
    nibble = k_tiles > 1 and arrs["group"] % 2 == 0 and idxA_np.size > 0
    if nibble:
        ngq = idxA_np.shape[0]
        ia4 = idxA_np.reshape(ngq, arrs["group"], 8, _LANES)
        idxA_np = (ia4[:, 0::2] | (ia4[:, 1::2] << 4)).reshape(
            ngq, (arrs["group"] // 2) * 8, _LANES).astype(np.int8)

    vals = torch.from_numpy(arrs["vals"]).to(dev)
    return DualGather(
        idxA=_put(idxA_np, torch.int8, dev),
        idxB=_put(arrs["idxB"], torch.int8, dev),
        vals=vals if dtype is None else vals.to(dtype),
        group_tile=_put(arrs["group_tile"], torch.int32, dev),
        slab_win=_put(arrs["slab_win"], torch.int32, dev),
        slab_tloc=(_put(arrs["slab_tloc"], torch.int32, dev)
                   if k_tiles > 1 else None),
        commit=(_put(arrs["commit"], torch.int32, dev)
                if k_tiles > 1 else None),
        tail=tail,
        t_pack=t_pack,
        shape=(rows, cols),
        n_tiles=arrs["n_tiles"],
        n_win=arrs["n_win"],
        group=arrs["group"],
        k_tiles=k_tiles,
        nnz=csr.nnz,
        splits=(tuple(_sb_splits(arrs["group_tile"], arrs["group"]))
                if k_tiles > 1 else ()),
        nibble=bool(nibble),
        two_win=two_win,
    )


def _put(a, dt, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)


# the JAX kernel's scalar-prefetch budget, which sets ``splits``
_SMEM_PREFETCH_BUDGET = 800_000  # bytes


def _sb_splits(group_super, group):
    """Superblock-aligned call boundaries under the JAX kernel's prefetch
    budget (kept in the pack for plane equality; the CUDA kernel covers
    every group in one launch)."""
    n_groups = len(group_super)
    budget = max(1, _SMEM_PREFETCH_BUDGET // (8 * group + 8))
    if n_groups <= budget:
        return []
    cuts = []
    pos = 0
    while n_groups - pos > budget:
        cut = pos + budget
        while cut > pos and group_super[cut] == group_super[cut - 1]:
            cut -= 1
        if cut == pos:  # one superblock larger than the budget
            raise ValueError("superblock exceeds the SMEM prefetch budget; "
                             "use a smaller group or k_tiles")
        cuts.append(int(cut))
        pos = cut
    return cuts


# ---------------------------------------------------------------------------
# plain versions (the kernels' twins) and slot coordinates
# ---------------------------------------------------------------------------

def _idxA_slabs(packed: DualGather) -> torch.Tensor:
    """idxA as (n_slabs, 8, 128) int64 in 0..15, nibbles unpacked (the
    bytes read unsigned)."""
    n_groups, group = packed.idxB.shape[0], packed.group
    if packed.nibble:
        pk = packed.idxA.reshape(n_groups, group // 2, 8,
                                 _LANES).long() & 0xFF
        return torch.stack([pk & 15, pk >> 4], dim=2).reshape(-1, 8, _LANES)
    return packed.idxA.reshape(-1, 8, _LANES).long()


def _slab_tiles(packed: DualGather) -> torch.Tensor:
    """(n_slabs,) int64 tile of every slab."""
    tile = packed.group_tile.long().repeat_interleave(packed.group)
    if packed.k_tiles > 1:
        tile = tile * packed.k_tiles + packed.slab_tloc.reshape(-1).long()
    return tile


def _slab_windows(packed: DualGather):
    """(wa, wb) int64 per slab; wb is None for single-window packs."""
    win = packed.slab_win.reshape(-1).long()
    if packed.two_win:
        return win & 0xFFFF, win >> 16
    return win, None


def _check_pack(packed: DualGather, fn: str) -> None:
    for t in (packed.vals,) + ((packed.tail.vals,) if packed.tail else ()):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{fn}: values must be fp32 or bf16, not "
                             f"{t.dtype}")


# slabs per step of the plain walk: bounds its gathered temporaries
_PLAIN_ELEMS = 1 << 24


def _walk_plain(packed: DualGather, X: torch.Tensor) -> torch.Tensor:
    """The two-gather walk for a (cols, k) fp32 right-hand side: per slab
    ``t1 = xw[idxA]`` (dim 1), ``out = t1[idxB]`` (dim 2), times vals,
    summed over sublanes, added per tile; then the pooled tail's cells.
    Returns (rows, k) fp32."""
    rows, cols = packed.shape
    k = X.shape[1]
    dev = X.device
    Xp = torch.zeros((packed.n_win * _W, k), dtype=torch.float32, device=dev)
    Xp[:cols] = X
    Xw = Xp.reshape(packed.n_win, 8, _LANES, k)
    iA = _idxA_slabs(packed)
    iB = packed.idxB.reshape(-1, 8, _LANES).long()
    vals = packed.vals.reshape(-1, 8, _LANES)
    tiles = _slab_tiles(packed).clamp(max=packed.n_tiles)  # spare tile
    wa, wb = _slab_windows(packed)
    y = torch.zeros((packed.n_tiles + 1, _LANES, k), dtype=torch.float32,
                    device=dev)
    step = max(1, _PLAIN_ELEMS // (8 * _LANES * k))
    for s0 in range(0, packed.n_slabs, step):
        sl = slice(s0, s0 + step)
        ia = iA[sl, :, :, None].expand(-1, -1, -1, k)
        if wb is not None:
            ch = ia & 7
            t1 = torch.where(ia >= 8, torch.gather(Xw[wb[sl]], 1, ch),
                             torch.gather(Xw[wa[sl]], 1, ch))
        else:
            t1 = torch.gather(Xw[wa[sl]], 1, ia)
        out = torch.gather(t1, 2, iB[sl, :, :, None].expand(-1, -1, -1, k))
        part = (vals[sl].float()[..., None] * out).sum(dim=1)  # (n, 128, k)
        y.index_add_(0, tiles[sl], part)
    y = y[: packed.n_tiles].reshape(-1, k)[:rows]
    if packed.tail is not None:
        y = y + pooled_plain(packed.tail, X)
    return y


def _slot_row_col_pooled(tail: PooledDG):
    """Per-slot (row, col) of pooled slabs, each (n_groups, group*8, 128)
    int64: the chunk is the slab's pointer at ``idxA[u, idxB[u, l]]``."""
    n_groups, GH, _ = tail.idxB.shape
    iB = tail.idxB.reshape(n_groups, tail.group, 8, _LANES).long() & 127
    iA = tail.idxA.reshape(n_groups, tail.group, 8, _LANES).long() & 7
    slot = torch.gather(iA, 3, iB)
    chunk = torch.gather(tail.ptr.long()[..., None].expand_as(slot), 2, slot)
    col = chunk * _LANES + iB
    lane = torch.arange(_LANES, device=col.device)
    row = tail.group_tile.long()[:, None, None, None] * _T + lane
    return (row.expand_as(col).reshape(n_groups, GH, _LANES),
            col.reshape(n_groups, GH, _LANES))


def pooled_plain(tail: PooledDG, X: torch.Tensor) -> torch.Tensor:
    """Plain version of the pooled tail's ``T @ X`` for a (cols, k) fp32
    X (the JAX ``_pooled_forward``): (rows, k) fp32."""
    rows, cols = tail.shape
    k = X.shape[1]
    row, col = _slot_row_col_pooled(tail)
    # rows past ``rows`` (the ragged last tile) land in the spare row
    row = row.clamp(max=rows)
    Xp = torch.zeros((tail.n_win * _W, k), dtype=torch.float32,
                     device=X.device)
    Xp[:cols] = X
    y = torch.zeros((rows + 1, k), dtype=torch.float32, device=X.device)
    step = max(1, _PLAIN_ELEMS // (tail.group * _W * k))
    for g0 in range(0, row.shape[0], step):
        sl = slice(g0, g0 + step)
        prod = tail.vals[sl].float()[..., None] * Xp[col[sl]]
        y.index_add_(0, row[sl].reshape(-1), prod.reshape(-1, k))
    return y[:rows]


def spmv_dualgather_reference(packed: DualGather,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``y = A @ x``: fp32 x, fp32 or bf16 values, fp32
    accumulation and result (as the Pallas kernel)."""
    _check_pack(packed, "spmv_dualgather")
    if x.dtype != torch.float32:
        raise ValueError(f"spmv_dualgather: x must be fp32, not {x.dtype}")
    return _walk_plain(packed, x[:, None])[:, 0]


def _slot_row_col(packed: DualGather):
    """Per-slot (row, col), each (n_groups, group*8, 128) int64: cl from
    idxB at the slot, its chunk from idxA at (u, cl)."""
    n_groups, GH, _ = packed.idxB.shape
    iB = packed.idxB.reshape(-1, 8, _LANES).long()
    ch = torch.gather(_idxA_slabs(packed), 2, iB)
    wa, wb = _slab_windows(packed)
    win = wa[:, None, None]
    if wb is not None:
        # win packs (wa | wb<<16); idxA's 4th bit picks the window
        win = torch.where(ch >= 8, wb[:, None, None], win)
        ch = ch & 7
    col = win * _W + ch * _LANES + iB
    lane = torch.arange(_LANES, device=col.device)
    row = _slab_tiles(packed)[:, None, None] * _T + lane
    return (row.expand_as(col).reshape(n_groups, GH, _LANES),
            col.reshape(n_groups, GH, _LANES))


def _dualgather_matvec_t(packed: DualGather, g: torch.Tensor) -> torch.Tensor:
    """``A^T @ g`` from the slab planes alone, tail included (the plain
    scatter for the backward pass when no transposed pack was built)."""
    rows, cols = packed.shape
    row, col = _slot_row_col(packed)
    gpad = torch.cat([g.float(), g.new_zeros(1, dtype=torch.float32)])
    gv = gpad[row.clamp(max=rows)] * packed.vals.float()
    out = torch.zeros(cols + 1, dtype=torch.float32, device=g.device)
    # padding slots past ``cols`` land in the spare slot and are dropped
    out.index_add_(0, col.clamp(max=cols).reshape(-1), gv.reshape(-1))
    if packed.tail is not None:
        trow, tcol = _slot_row_col_pooled(packed.tail)
        tgv = gpad[trow.clamp(max=rows)] * packed.tail.vals.float()
        out.index_add_(0, tcol.clamp(max=cols).reshape(-1), tgv.reshape(-1))
    return out[:cols]


def _dvals(packed, xg: torch.Tensor) -> torch.Tensor:
    """Masked value cotangent of a body or tail: ``xg`` at stored slots, 0
    at padding slots (``vals == 0``), in the values' type."""
    zero = torch.zeros((), dtype=xg.dtype, device=xg.device)
    return torch.where(packed.vals != 0, xg, zero).to(packed.vals.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_ARGTYPES = (
    ctypes.c_void_p,  # idxA int8
    ctypes.c_void_p,  # idxB int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # group_tile (n_groups,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # slab_tloc (n_slabs,) int32 or null
    ctypes.c_void_p,  # X (cols, k) fp32
    ctypes.c_void_p,  # Y (rows, k) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # k (1 for SpMV)
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # group
    ctypes.c_int,  # k_tiles
    ctypes.c_int,  # nibble
    ctypes.c_int,  # two_win
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)


def launch_walk(source: str, packed: DualGather, X: torch.Tensor,
                Y: torch.Tensor) -> None:
    """Launches ``csrc/<source>.cu`` over every slab of ``packed``:
    ``Y += A @ X`` with X (cols, k) and Y (rows, k) fp32, both contiguous
    on the pack's CUDA device.  Checks the planes and raises on what the
    kernel does not take; counts the launch under the source's name, with
    ``_sb`` for a superblock pack."""
    n_groups, group = packed.idxB.shape[0], packed.group
    planes = [packed.idxA, packed.idxB, packed.vals, packed.group_tile,
              packed.slab_win]
    if packed.k_tiles > 1:
        planes.append(packed.slab_tloc)
    if not all(t.device == X.device and t.is_contiguous()
               for t in planes + [X, Y]):
        raise ValueError(f"{source}: the pack, X and Y must be contiguous on "
                         "one CUDA device")
    if (packed.idxA.dtype != torch.int8 or packed.idxB.dtype != torch.int8
            or any(t.dtype != torch.int32 for t in planes[3:])):
        raise ValueError(f"{source}: idxA/idxB must be int8 and the slab "
                         "tables int32")
    ga = group // 2 if packed.nibble else group
    if (packed.idxB.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.idxB.shape
            or packed.idxA.shape != (n_groups, ga * 8, _LANES)
            or packed.group_tile.shape != (n_groups,)
            or packed.slab_win.numel() != n_groups * group
            or (packed.k_tiles > 1
                and packed.slab_tloc.numel() != n_groups * group)
            or (packed.nibble and (packed.k_tiles <= 1 or group % 2))):
        raise ValueError(f"{source}: inconsistent pack planes")
    rows, cols = packed.shape
    k = X.shape[1]
    if rows == 0 or cols == 0 or k == 0:
        return
    fn = _build.load(source, _ARGTYPES)
    with torch.cuda.device(X.device):
        err = fn(packed.idxA.data_ptr(), packed.idxB.data_ptr(),
                 packed.vals.data_ptr(), packed.group_tile.data_ptr(),
                 packed.slab_win.data_ptr(),
                 packed.slab_tloc.data_ptr() if packed.k_tiles > 1 else None,
                 X.data_ptr(), Y.data_ptr(), rows, cols, k, packed.n_slabs,
                 group, packed.k_tiles, int(packed.nibble),
                 int(packed.two_win), int(packed.vals.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{source}: launch failed with CUDA error {err}")
    _build.launch_counts[source + ("_sb" if packed.k_tiles > 1 else "")] += 1


_POOLED_ARGTYPES = (
    ctypes.c_void_p,  # ptr (n_groups, group, 8) int32
    ctypes.c_void_p,  # idxA int8
    ctypes.c_void_p,  # idxB int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # group_tile (n_groups,) int32
    ctypes.c_void_p,  # X (cols, k) fp32
    ctypes.c_void_p,  # Y (rows, k) fp32, holding the body's sum
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # k
    ctypes.c_longlong,  # n_groups
    ctypes.c_int,  # group
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)
# spmv_pooled_tuned: the same, then work and mode before the stream
_POOLED_TUNED_ARGTYPES = (_POOLED_ARGTYPES[:-1]
                          + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def launch_pooled(tail: PooledDG, X: torch.Tensor, Y: torch.Tensor, *,
                  work: int = 0, mode: int = 0) -> None:
    """Launches ``csrc/spmv_pooled.cu``: ``Y += T @ X`` over the pooled
    tail, all k columns of X (cols, k) at once, Y (rows, k) fp32, both
    contiguous on the tail's CUDA device.  ``work`` (rows a warp at k = 1,
    blocks a tile at k > 1; 0: the kernel's choice) and ``mode`` (1: read
    1 for every X element; 2, k > 1: decode only; Y is then not T @ X)
    are knobs for measurements only."""
    planes = (tail.ptr, tail.idxA, tail.idxB, tail.vals, tail.group_tile)
    if not all(t.device == X.device and t.is_contiguous()
               for t in planes + (X, Y)):
        raise ValueError("spmv_pooled: the tail, X and Y must be contiguous "
                         "on one CUDA device")
    n_groups, group = tail.idxB.shape[0], tail.group
    if (tail.idxA.dtype != torch.int8 or tail.idxB.dtype != torch.int8
            or tail.ptr.dtype != torch.int32
            or tail.group_tile.dtype != torch.int32
            or tail.idxA.shape != (n_groups, group * 8, _LANES)
            or tail.idxB.shape != tail.idxA.shape
            or tail.vals.shape != tail.idxA.shape
            or tail.ptr.shape != (n_groups, group, 8)
            or tail.group_tile.shape != (n_groups,)):
        raise ValueError("spmv_pooled: inconsistent tail planes")
    # the kernel reads a row's values as 16-byte words, its index bytes as
    # 4-byte words
    if any(t.data_ptr() % 16 for t in planes[:4]):
        raise ValueError("spmv_pooled: the tail's planes must be 16-byte "
                         "aligned")
    rows, cols = tail.shape
    k = X.shape[1]
    if rows == 0 or cols == 0 or k == 0:
        return
    tuned = work != 0 or mode != 0
    fn = _build.load("spmv_pooled",
                     _POOLED_TUNED_ARGTYPES if tuned else _POOLED_ARGTYPES,
                     "spmv_pooled_tuned" if tuned else None)
    knobs = (int(work), int(mode)) if tuned else ()
    with torch.cuda.device(X.device):
        err = fn(*(t.data_ptr() for t in planes), X.data_ptr(), Y.data_ptr(),
                 rows, cols, k, n_groups, group,
                 int(tail.vals.dtype == torch.bfloat16), *knobs,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_pooled: launch failed with CUDA error {err}")
    _build.launch_counts["spmv_pooled"] += 1


def _spmv_dualgather_cuda(packed: DualGather, x: torch.Tensor) -> torch.Tensor:
    _check_pack(packed, "spmv_dualgather")
    rows, cols = packed.shape
    if not x.is_cuda or x.dtype != torch.float32 or x.shape != (cols,):
        raise ValueError("spmv_dualgather: x must be a CUDA fp32 vector of "
                         f"length {cols}, not {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    y = torch.zeros(rows, dtype=torch.float32, device=x.device)
    X = x.contiguous()[:, None]
    launch_walk("spmv_dualgather", packed, X, y[:, None])
    if packed.tail is not None:
        launch_pooled(packed.tail, X, y[:, None])
    return y


def _dualgather_forward(packed: DualGather, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmv_dualgather_reference(packed, x)
    return _spmv_dualgather_cuda(packed, x)


def _tail_vals(packed: DualGather) -> Optional[torch.Tensor]:
    return packed.tail.vals if packed.tail is not None else None


class _SpmvDualGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, tail_vals, x):
        # ``vals`` and ``tail_vals`` are the body's and the tail's values,
        # passed so autograd tracks them
        ctx.packed = packed
        ctx.save_for_backward(x)
        return _dualgather_forward(packed, x)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        (x,) = ctx.saved_tensors
        gx = dvals = dtail = None
        g = g.contiguous()
        if ctx.needs_input_grad[3]:
            if packed.t_pack is not None:
                gx = _dualgather_forward(packed.t_pack, g)
            else:
                gx = _dualgather_matvec_t(packed, g)
            gx = gx.to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            rows, cols = packed.shape
            xpad = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                               device=x.device)
            xpad[:cols] = x
            gpad = torch.cat([g.float(), g.new_zeros(1, dtype=torch.float32)])
            if ctx.needs_input_grad[1]:
                row, col = _slot_row_col(packed)
                dvals = _dvals(packed, xpad[col] * gpad[row.clamp(max=rows)])
            if ctx.needs_input_grad[2]:
                trow, tcol = _slot_row_col_pooled(packed.tail)
                dtail = _dvals(packed.tail,
                               xpad[tcol] * gpad[trow.clamp(max=rows)])
        return None, dvals, dtail, gx


def spmv_dualgather(packed: DualGather, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the dual-gather layout (fp32 result), the
    pooled tail included; differentiable in x and in the values of the
    body and the tail."""
    return _SpmvDualGather.apply(packed, packed.vals, _tail_vals(packed), x)
