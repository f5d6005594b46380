"""Host cuts shared by the kernels that walk a list of work items: the SM
count a walk is cut for, and the window-by-window cut of a slab list
(rows 13 and 14, ``spmm_dualgather.slab_walk``; row 8,
``spmm_rowlane.rowlane_mm_walk``)."""
from __future__ import annotations

import numpy as np
import torch

SMS_CPU = 132  # the H100's SMs: the count a plan is cut for on the CPU


def sms(dev: torch.device) -> int:
    """The SMs that a walk is cut for: the card's own count, or
    ``SMS_CPU`` for a pack on the CPU."""
    if dev.type != "cuda":
        return SMS_CPU
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _share(wlen: np.ndarray, total: int) -> np.ndarray:
    """Blocks of each window: about ``total`` in all, at least one and at
    most its slabs a window, in proportion to the windows' slabs (the
    largest remainders take the rest)."""
    exact = wlen * (max(total, len(wlen)) / wlen.sum())
    per = np.maximum(np.floor(exact).astype(np.int64), 1)
    left = max(total, len(wlen)) - int(per.sum())
    if left > 0:
        per[np.argsort(per - exact, kind="stable")[:left]] += 1
    return np.minimum(per, wlen)


def window_cut(s: np.ndarray, tile: np.ndarray, win: np.ndarray,
               teams: int, n_sms: int, spb: int = 0):
    """A walk window by window: the slabs ``s`` (with their ``tile`` and
    window word ``win``, int64) ordered by window, then tile, then slab,
    and cut into blocks each inside one window: about ``spb`` slabs a
    block, or (``spb`` 0) about ``n_sms`` blocks shared among the windows
    by their slabs (``_share``); each block's slabs cut into ``teams``
    parts of equal counts.  Returns (items (n, 4) int32 of (slab, tile,
    window, 0), part_ptr (n_blocks·teams + 1,) int32, n_blocks)."""
    n = len(s)
    if n == 0:
        block_of = s
    else:
        order = np.lexsort((s, tile, win))
        s, tile, win = s[order], tile[order], win[order]
        wstart = np.r_[0, np.flatnonzero(np.diff(win)) + 1]
        wlen = np.diff(np.r_[wstart, n])
        wid = np.repeat(np.arange(len(wlen)), wlen)
        first = wstart[wid]
        per = -(-wlen // spb) if spb else _share(wlen, n_sms)
        sz = -(-wlen // per)
        block_of = (np.r_[0, np.cumsum(per)][wid]
                    + (np.arange(n) - first) // sz[wid])
    return team_parts(s, tile, win, block_of, teams)


def team_parts(s, tile, win, block_of, teams):
    """The items (slab, tile, window, 0) int32 of slabs already in walk
    order, ``block_of`` each slab's block (non-decreasing), and each
    block's slabs cut into ``teams`` parts of equal counts: (items,
    part_ptr (n_blocks·teams + 1,) int32, n_blocks)."""
    n = len(s)
    n_blocks = int(block_of[-1]) + 1 if n else 0
    bstart = np.searchsorted(block_of, np.arange(n_blocks + 1))
    q = np.arange(teams + 1)
    cnt = np.diff(bstart)
    part = (bstart[:-1, None] + (cnt[:, None] * q[None, :]) // teams)
    part_ptr = np.r_[part[:, :-1].reshape(-1), n].astype(np.int32)
    items = np.stack([s, tile, win, np.zeros_like(s)], 1).astype(np.int32)
    return items, part_ptr, n_blocks
