"""Lane-bucketed SELL SpMV: the packers and ``csrc/spmv_sell.cu``.

Twin of ``sparsematrix_tpu/kernels/spmv_pallas.py`` (the port names
kernels after what they compute).  x is viewed in 1024-column windows
(8 sublanes × 128 lanes).  Two layouts:

* ``SellSpmv`` (``pack_sell``): rows in tiles of ``tr`` ≤ 128; each
  (tile, window) bucket's entries fill (8, 128) slabs, an entry of column
  c at lane ``c % 128``, depth by its occurrence among same-lane entries;
  ``meta = (c % 1024) // 128 | row_local << 3``.  Cell (u, l) of a slab
  over window w of tile t reads column ``w*1024 + (meta & 7)*128 + l``
  into row ``t*tr + (meta >> 3)``.
* ``SellRowPure`` (``pack_sell_rowpure``): one row a sublane.  Tiles of
  8R rows (R = ``rows_per_sublane`` ∈ {1, 2, 4, 8, 16}); sublane u serves
  rows ``t*8R + j*8 + u`` with j in the spare bits of the int8 ``s_idx``
  (``sub | j << 3``); lane collisions within a row go one slab deeper;
  ``group`` slabs of a tile a group.

The packers are the JAX packers line for line, so every plane comes out
``np.array_equal`` to theirs; the values keep the CSR's type.

``spmv_sell`` and ``spmv_sell_rowpure`` run their plain versions when all
inputs lie on the CPU, and otherwise launch their kernel or raise.  Both
kernels walk runs of one tile's slabs (``sell_runs``, ``rowpure_runs``),
cut on the host from the pack's tile plane once a pack and cached; the
masked-slab kernel reads its meta plane narrowed to int16
(``sell_meta16``, made once a pack and cached).  Both
return the values' type, as the JAX kernels do.  ``spmv_sell`` is not
differentiable (the JAX function has no VJP): its result carries no
gradient.  ``spmv_sell_rowpure`` is differentiable in x and in ``vals``
(the JAX custom VJP, ``spmv_pallas.py:477-507``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats.base import cached_on, sparse_container, static_field
from ..formats.csr import CSR
from . import _build
from .spmv_dualgather import _put

__all__ = ["SellSpmv", "pack_sell", "spmv_sell", "spmv_sell_reference",
           "SellRowPure", "pack_sell_rowpure", "spmv_sell_rowpure",
           "spmv_sell_rowpure_reference"]

_W = 1024  # x window (8 sublanes × 128 lanes)
_LANES = 128


@sparse_container
@dataclasses.dataclass(frozen=True)
class SellSpmv:
    meta: torch.Tensor  # (n_slabs, 8, 128) int32: s_idx | row_local << 3
    vals: torch.Tensor  # (n_slabs, 8, 128)
    slab_tile: torch.Tensor  # (n_slabs,) int32, ascending
    slab_win: torch.Tensor  # (n_slabs,) int32
    tile_nonempty: torch.Tensor  # (n_tiles,) bool
    shape: Tuple[int, int] = static_field()
    tr: int = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    nnz: int = static_field()

    @property
    def fill_rate(self) -> float:
        """Fraction of slab slots holding real entries."""
        return self.nnz / max(self.vals.numel(), 1)


@sparse_container
@dataclasses.dataclass(frozen=True)
class SellRowPure:
    s_idx: torch.Tensor  # (n_groups, group*8, 128) int8: sub | j << 3
    vals: torch.Tensor  # (n_groups, group*8, 128)
    group_tile: torch.Tensor  # (n_groups,) int32, ascending
    slab_win: torch.Tensor  # (n_groups, group) int32
    tile_nonempty: torch.Tensor  # (n_tiles,) bool
    shape: Tuple[int, int] = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    nnz: int = static_field()
    rows_per_sublane: int = dataclasses.field(default=1,
                                              metadata={"static": True})

    @property
    def fill_rate(self) -> float:
        return self.nnz / max(self.vals.numel(), 1)


# ---------------------------------------------------------------------------
# host packers (the JAX packers' algorithms)
# ---------------------------------------------------------------------------

def pack_sell(csr: CSR, tr: int = 32, device=None) -> SellSpmv:
    """Pack a CSR into masked-slab SELL slabs of ``tr`` rows a tile, on
    ``device`` (default: the CSR's).  ``tr`` ≤ 128 (the row sums of a
    tile sit in the lanes of one output row); pick roughly
    ``tr * nnz_per_row ≳ 2048``.  One Python step a (tile, window)
    bucket."""
    if not 1 <= tr <= 128:
        raise ValueError("tr must be in [1, 128]")
    dev = csr.device if device is None else torch.device(device)
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    n_tiles = -(-rows // tr)
    n_win = max(-(-cols // _W), 1)
    slabs_meta = []
    slabs_vals = []
    slab_tile = []
    slab_win = []
    tile_nonempty = np.zeros(n_tiles, dtype=bool)
    coo = sp.tocoo()
    # bucket entries by (tile, window)
    order = np.lexsort((coo.col, coo.col // _W, coo.row // tr))
    r = coo.row[order]
    c = coo.col[order]
    v = coo.data[order]
    t_ids = r // tr
    w_ids = c // _W
    keys = t_ids.astype(np.int64) * n_win + w_ids
    boundaries = np.nonzero(np.diff(keys))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(keys)]])
    for s0, e0 in zip(starts, ends):
        if e0 == s0:
            continue
        t = int(t_ids[s0])
        w = int(w_ids[s0])
        tile_nonempty[t] = True
        # lane buckets; depth = occurrence among same-lane entries
        lanes = c[s0:e0] % _LANES
        subl = (c[s0:e0] % _W) // _LANES
        rloc = r[s0:e0] - t * tr
        vv = v[s0:e0]
        depth = np.bincount(lanes, minlength=_LANES)
        n_slabs = max(int(-(-depth.max() // 8)), 1)
        meta = np.zeros((n_slabs, 8, _LANES), dtype=np.int64)
        vals = np.zeros((n_slabs, 8, _LANES), dtype=v.dtype)
        lorder = np.argsort(lanes, kind="stable")
        lsort = lanes[lorder]
        newl = np.empty(len(lsort), bool)
        if len(lsort):
            newl[0] = True
            newl[1:] = lsort[1:] != lsort[:-1]
        rstart = np.maximum.accumulate(
            np.where(newl, np.arange(len(lsort)), 0))
        pos = np.arange(len(lsort)) - rstart
        meta[pos // 8, pos % 8, lsort] = subl[lorder] | (rloc[lorder] << 3)
        vals[pos // 8, pos % 8, lsort] = vv[lorder]
        for k in range(n_slabs):
            slabs_meta.append(meta[k])
            slabs_vals.append(vals[k])
            slab_tile.append(t)
            slab_win.append(w)
    if not slabs_meta:  # all-zero matrix
        slabs_meta.append(np.zeros((8, _LANES), np.int64))
        slabs_vals.append(np.zeros((8, _LANES), sp.data.dtype))
        slab_tile.append(0)
        slab_win.append(0)
    return SellSpmv(
        meta=_put(np.stack(slabs_meta), torch.int32, dev),
        vals=torch.from_numpy(np.stack(slabs_vals)).to(dev),
        slab_tile=_put(np.asarray(slab_tile), torch.int32, dev),
        slab_win=_put(np.asarray(slab_win), torch.int32, dev),
        tile_nonempty=_put(tile_nonempty, torch.bool, dev),
        shape=(rows, cols), tr=tr, n_tiles=n_tiles, n_win=n_win,
        nnz=csr.nnz)


def pack_sell_rowpure(csr: CSR, group: int = 4, rows_per_sublane: int = 1,
                      device=None) -> SellRowPure:
    """Pack a CSR into row-pure slabs, ``group`` slabs a group, on
    ``device`` (default: the CSR's).  ``rows_per_sublane`` (R ∈
    {1, 2, 4, 8, 16}): sublane u serves rows u + 8j of an 8R-row tile;
    pick R so that ``8R · nnz_per_row ≳ 2 · 1024 · n_windows``."""
    R = rows_per_sublane
    if R not in (1, 2, 4, 8, 16):
        raise ValueError("rows_per_sublane must be 1/2/4/8/16")
    dev = csr.device if device is None else torch.device(device)
    sp = csr.to_scipy().tocoo()
    rows, cols = sp.shape
    n_tiles = -(-rows // (8 * R))
    n_win = max(-(-cols // _W), 1)
    r = sp.row.astype(np.int64)
    c = sp.col.astype(np.int64)
    v = sp.data
    if r.size == 0:
        # all-zero matrix: one empty group
        return SellRowPure(
            s_idx=torch.zeros((1, group * 8, _LANES), dtype=torch.int8,
                              device=dev),
            vals=torch.from_numpy(np.zeros((1, group * 8, _LANES),
                                           sp.data.dtype)).to(dev),
            group_tile=torch.zeros((1,), dtype=torch.int32, device=dev),
            slab_win=torch.zeros((1, group), dtype=torch.int32, device=dev),
            tile_nonempty=torch.zeros((n_tiles,), dtype=torch.bool,
                                      device=dev),
            shape=(rows, cols), n_tiles=n_tiles, n_win=n_win, group=group,
            nnz=0, rows_per_sublane=R)
    t = r // (8 * R)
    u = r % 8
    j = (r % (8 * R)) // 8  # which of the R rows this sublane serves
    w = c // _W
    lane = c % _LANES
    subl = (c % _W) // _LANES
    # depth = occurrence index among duplicates of (t, w, u, lane)
    order = np.lexsort((lane, u, w, t))
    tt, ww, uu, ll = t[order], w[order], u[order], lane[order]
    ss, vv, jj = subl[order], v[order], j[order]
    key = ((tt * n_win + ww) * 8 + uu) * _LANES + ll
    new = np.empty(len(key), bool)
    new[0] = True
    new[1:] = key[1:] != key[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(len(key)), 0))
    d = np.arange(len(key)) - run_start
    # slab identity = (t, w, d); unique keys sort t-major
    d_span = int(d.max()) + 1
    skey = (tt * n_win + ww) * d_span + d
    uskey, inv = np.unique(skey, return_inverse=True)
    inv = inv.reshape(-1)
    slab_t = uskey // (n_win * d_span)
    slab_w = (uskey // d_span) % n_win
    n_slabs = len(uskey)
    # pad each non-empty tile's slab list to a multiple of ``group``
    counts = np.bincount(slab_t, minlength=n_tiles)
    tile_groups = -(-counts // group)  # 0 for empty tiles
    padded = tile_groups * group
    tile_offset = np.concatenate([[0], np.cumsum(padded)])
    first_of_tile = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(n_slabs) - first_of_tile[slab_t]
    slab_slot = tile_offset[slab_t] + rank
    total_slots = int(tile_offset[-1])
    n_groups = total_slots // group

    sidx = np.zeros((total_slots, 8, _LANES), np.int8)
    vals = np.zeros((total_slots, 8, _LANES), v.dtype)
    win = np.zeros(total_slots, np.int64)
    entry_slot = slab_slot[inv]
    sidx[entry_slot, uu, ll] = ss | (jj << 3)  # j in the spare bits
    vals[entry_slot, uu, ll] = vv
    win[slab_slot] = slab_w
    group_tile = np.repeat(np.arange(n_tiles), tile_groups)
    return SellRowPure(
        s_idx=_put(sidx.reshape(n_groups, group * 8, _LANES), torch.int8,
                   dev),
        vals=torch.from_numpy(vals.reshape(n_groups, group * 8,
                                           _LANES)).to(dev),
        group_tile=_put(group_tile, torch.int32, dev),
        slab_win=_put(win.reshape(n_groups, group), torch.int32, dev),
        tile_nonempty=_put(counts > 0, torch.bool, dev),
        shape=(rows, cols), n_tiles=n_tiles, n_win=n_win, group=group,
        nnz=csr.nnz, rows_per_sublane=R)


# ---------------------------------------------------------------------------
# slot coordinates and plain versions
# ---------------------------------------------------------------------------

def _sell_slot_row_col(packed: SellSpmv):
    """Per-cell (row, col), each (n_slabs, 8, 128) int64."""
    meta = packed.meta.long()
    lane = torch.arange(_LANES, device=meta.device)
    col = (packed.slab_win.long()[:, None, None] * _W
           + (meta & 7) * _LANES + lane)
    row = packed.slab_tile.long()[:, None, None] * packed.tr + (meta >> 3)
    return row, col


def _rowpure_slot_row_col(packed: SellRowPure):
    """Per-cell (row, col), each (n_groups, group*8, 128) int64."""
    R = packed.rows_per_sublane
    n_groups, GH, _ = packed.s_idx.shape
    meta = packed.s_idx.long() & 127
    dev = meta.device
    lane = torch.arange(_LANES, device=dev)[None, None, :]
    subl = (torch.arange(GH, device=dev) % 8)[None, :, None]
    winb = packed.slab_win.long().repeat_interleave(8, dim=1)[:, :, None]
    col = winb * _W + (meta & 7) * _LANES + lane
    row = (packed.group_tile.long()[:, None, None] * 8 * R
           + (meta >> 3) * 8 + subl)
    return row, col


def _acc_type(vals: torch.Tensor) -> torch.dtype:
    return torch.promote_types(vals.dtype, torch.float32)


def _cell_sum(packed, row, col, x, n_rows_pad):
    """``sum vals·x[col]`` into ``row`` (rows past ``rows`` dropped), in
    the values' type."""
    rows, cols = packed.shape
    vals = packed.vals
    acc = _acc_type(vals)
    xpad = torch.zeros(packed.n_win * _W, dtype=acc, device=x.device)
    xpad[:cols] = x
    prod = vals.to(acc) * xpad[col]
    y = torch.zeros(n_rows_pad, dtype=acc, device=x.device)
    y.index_add_(0, row.reshape(-1), prod.reshape(-1))
    return y[:rows].to(vals.dtype)


def _check_x(x: torch.Tensor, cols: int, fn: str) -> None:
    if not x.is_floating_point() or x.shape != (cols,):
        raise ValueError(f"{fn}: x must be a float vector of length {cols}, "
                         f"not {x.dtype} {tuple(x.shape)}")


def spmv_sell_reference(packed: SellSpmv, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``y = A @ x`` over a masked-slab pack, in the
    values' type (accumulated in at least fp32)."""
    _check_x(x, packed.shape[1], "spmv_sell")
    row, col = _sell_slot_row_col(packed)
    return _cell_sum(packed, row, col, x, packed.n_tiles * packed.tr)


def spmv_sell_rowpure_reference(packed: SellRowPure,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``y = A @ x`` over a row-pure pack, in the values'
    type (accumulated in at least fp32)."""
    _check_x(x, packed.shape[1], "spmv_sell_rowpure")
    row, col = _rowpure_slot_row_col(packed)
    return _cell_sum(packed, row, col, x,
                     packed.n_tiles * 8 * packed.rows_per_sublane)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_SELL_ARGTYPES = (
    ctypes.c_void_p,  # meta16 (n_slabs, 8, 128) int16 (sell_meta16)
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # block_ptr (n_blocks+1,) int32
    ctypes.c_void_p,  # run_ptr (n_runs+1,) int32
    ctypes.c_void_p,  # run_tile (n_runs,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # x (cols,) fp32
    ctypes.c_void_p,  # y (rows,) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_longlong,  # n_blocks
    ctypes.c_int,  # tr
    ctypes.c_int,  # short runs (a run a block)
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)
# spmv_sell_tuned: warps a block, mode and unroll after the bf16 flag
_SELL_TUNED_ARGTYPES = _SELL_ARGTYPES[:-1] + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
_ROWPURE_ARGTYPES = (
    ctypes.c_void_p,  # s_idx (n_groups, group*8, 128) int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # run_ptr (n_runs+1,) int32
    ctypes.c_void_p,  # run_tile (n_runs,) int32
    ctypes.c_void_p,  # slab_win (n_groups, group) int32
    ctypes.c_void_p,  # x (cols,) fp32
    ctypes.c_void_p,  # y (rows,) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_longlong,  # n_runs
    ctypes.c_int,  # group
    ctypes.c_int,  # rows_per_sublane
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)


_ARGTYPES = {"spmv_sell": _SELL_ARGTYPES,
             "spmv_sell_tuned": _SELL_TUNED_ARGTYPES,
             "spmv_sell_rowpure": _ROWPURE_ARGTYPES}


def _launch(symbol: str, planes, x: torch.Tensor, rows: int, cols: int,
            count: int, arg: Tuple[int, ...], knobs: Tuple[int, ...] = (),
            entry: str = "") -> torch.Tensor:
    """Launches the C function ``entry`` (default ``symbol``) of
    ``csrc/spmv_sell.cu``, counts a launch of ``symbol``, and returns y in
    the values' type.  ``planes`` = (index plane, vals, then the int32
    tables the kernel takes); ``knobs`` follow the bf16 flag."""
    vals = planes[1]
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{symbol}: values must be fp32 or bf16 on the "
                         f"card, not {vals.dtype}")
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"{symbol}: x must be a CUDA fp32 vector, not "
                         f"{x.dtype} on {x.device}")
    if not all(t.device == x.device and t.is_contiguous() for t in planes):
        raise ValueError(f"{symbol}: the pack and x must be contiguous on "
                         "one CUDA device")
    y = torch.zeros(rows, dtype=torch.float32, device=x.device)
    if rows == 0 or cols == 0:
        return y.to(vals.dtype)
    entry = entry or symbol
    fn = _build.load("spmv_sell", _ARGTYPES[entry], entry)
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in planes), x.contiguous().data_ptr(),
                 y.data_ptr(), rows, cols, count, *arg,
                 int(vals.dtype == torch.bfloat16), *knobs,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: launch failed with CUDA error {err}")
    _build.launch_counts[symbol] += 1
    return y.to(vals.dtype)


_RESIDENT: dict = {}


def _resident_blocks(device: torch.device, tr: int, short: bool) -> int:
    """The blocks of the masked-slab kernel (its long- or short-run walk)
    the card holds at once, asked of the card once."""
    key = (device.index, tr, short)
    if key not in _RESIDENT:
        fn = _build.load("spmv_sell", (ctypes.c_int, ctypes.c_int),
                         "spmv_sell_blocks")
        with torch.cuda.device(device):
            n = fn(tr, int(short))
        if n <= 0:
            raise RuntimeError("spmv_sell: the card's occupancy query failed")
        _RESIDENT[key] = n
    return _RESIDENT[key]


# below this many slabs a block, the kernel is bound by one block's chain
# of dependent loads, not by bytes: each block then takes one short run
_SELL_SHORT = 4


def sell_default_run(packed: SellSpmv) -> int:
    """The default ``run`` of ``sell_runs``, so that one wave of blocks
    (the blocks the card holds at once) covers the pack: chunks of C =
    n_slabs / blocks slabs (C > 0), or, where C would be at most
    ``_SELL_SHORT``, runs of one tile of at most L slabs, a run a block
    (the kernel's short-run walk), L the least that needs no second wave
    (returned as -L)."""
    st = packed.slab_tile.cpu().numpy()
    n = st.size
    dev = packed.slab_tile.device
    C = -(-n // _resident_blocks(dev, packed.tr, False))
    if C > _SELL_SHORT:
        return C
    G = _resident_blocks(dev, packed.tr, True)
    tile_len = np.diff(np.flatnonzero(np.r_[True, st[1:] != st[:-1], True]))
    L = 1
    while L < _SELL_SHORT and (-(-tile_len // L)).sum() > G:
        L += 1
    return -L


def _sell_runs_build(packed: SellSpmv, run: int):
    """(block_ptr (n_blocks+1,), run_ptr (n_runs+1,), run_tile (n_runs,))
    int32 on the pack's device.  ``run`` = C > 0: the slabs cut into
    chunks of C consecutive slabs, one a block, and each chunk into runs of
    one tile (a run starts where the tile changes and where a chunk
    starts).  ``run`` = -L < 0: each tile's slabs cut into runs of at most
    L, one run a block.  ``block_ptr`` gives each block's first run and
    ends with n_runs; ``run_ptr`` each run's first slab and ends with
    n_slabs."""
    st = packed.slab_tile.cpu().numpy().astype(np.int64)
    n = st.size
    new_tile = np.r_[True, st[1:] != st[:-1]]
    if run > 0:
        cut = new_tile.copy()
        cut[::run] = True
        starts = np.flatnonzero(cut)
        block_ptr = np.searchsorted(starts, np.arange(0, n, run))
    else:
        first = np.maximum.accumulate(np.where(new_tile, np.arange(n), 0))
        starts = np.flatnonzero((np.arange(n) - first) % -run == 0)
        block_ptr = np.arange(starts.size)
    dev = packed.slab_tile.device
    return (_put(np.append(block_ptr, starts.size), torch.int32, dev),
            _put(np.append(starts, n), torch.int32, dev),
            _put(st[starts], torch.int32, dev))


_SELL_RUNS: dict = {}


def _sell_meta16_build(packed: SellSpmv) -> torch.Tensor:
    """The meta plane narrowed to int16 on the pack's device (meta =
    sub | r << 3 < 1024): the kernel reads 2 bytes a cell, not 4."""
    if packed.meta.numel() and int(packed.meta.max()) >= 1 << 10:
        raise ValueError("spmv_sell: meta past sub | (tr - 1) << 3")
    return packed.meta.to(torch.int16).contiguous()


_SELL_META16: dict = {}


def sell_meta16(packed: SellSpmv) -> torch.Tensor:
    """The pack's ``_sell_meta16_build``, built once per pack."""
    return cached_on(_SELL_META16, packed, _sell_meta16_build)


def _resolved(packed: SellSpmv, run: int) -> int:
    runs = cached_on(_SELL_RUNS, packed, lambda _: {})
    if run == 0:
        if 0 not in runs:
            runs[0] = sell_default_run(packed)
        run = runs[0]
    return run


def sell_runs(packed: SellSpmv, run: int = 0):
    """The pack's blocks and runs (``_sell_runs_build``) for ``run`` (0:
    ``sell_default_run``, which asks the card), built once per pack and
    ``run``."""
    run = _resolved(packed, run)
    runs = cached_on(_SELL_RUNS, packed, lambda _: {})
    if run not in runs:
        runs[run] = _sell_runs_build(packed, run)
    return runs[run]


def _spmv_sell_cuda(packed: SellSpmv, x: torch.Tensor, *, run: int = 0,
                    warps: int = 0, mode: int = 0,
                    unroll: int = 0) -> torch.Tensor:
    """The kernel.  ``run`` (``sell_runs``; 0: ``sell_default_run``), ``warps``
    (a block), ``unroll`` (sublanes a warp's batch) and ``mode`` (an
    ablation; 1 and 3 do not compute A @ x), 0 each for the kernel's
    choice, are knobs for measurements only."""
    rows, cols = packed.shape
    _check_x(x, cols, "spmv_sell")
    n = packed.meta.shape[0]
    if (packed.meta.dtype != torch.int32
            or packed.meta.shape != (n, 8, _LANES)
            or packed.vals.shape != packed.meta.shape
            or packed.slab_tile.dtype != torch.int32
            or packed.slab_win.dtype != torch.int32
            or packed.slab_tile.shape != (n,)
            or packed.slab_win.shape != (n,)):
        raise ValueError("spmv_sell: inconsistent pack planes")
    bf16 = packed.vals.dtype == torch.bfloat16
    meta16 = sell_meta16(packed)
    if packed.vals.data_ptr() % (8 if bf16 else 16) or meta16.data_ptr() % 8:
        raise ValueError("spmv_sell: the planes must be aligned for 4-cell "
                         "loads")
    run = _resolved(packed, run)
    block_ptr, run_ptr, run_tile = sell_runs(packed, run)
    short = run < 0  # a short run a block
    tuned = warps != 0 or mode != 0 or unroll != 0
    return _launch("spmv_sell", (meta16, packed.vals, block_ptr,
                                 run_ptr, run_tile, packed.slab_win),
                   x, rows, cols, block_ptr.numel() - 1,
                   (packed.tr, int(short)),
                   knobs=(int(warps), int(mode), int(unroll)) if tuned else (),
                   entry="spmv_sell_tuned" if tuned else "")


# a run holds at most this many slabs, and enough runs fill the card and
# balance its SMs
_RUN_SLABS = 16
_RUNS_WANTED = 4096


def _rowpure_runs_build(packed: SellRowPure):
    """(run_ptr (n_runs+1,), run_tile (n_runs,)) int32 on the pack's
    device: the groups cut into runs of consecutive groups of one tile, in
    ``group_tile`` order, each of at most ``L`` groups, ``L`` the smallest
    that keeps the runs near ``_RUNS_WANTED`` (at most ``_RUN_SLABS`` slabs
    a run).  ``run_ptr`` ends with n_groups."""
    gt = packed.group_tile.cpu().numpy().astype(np.int64)
    n_groups = gt.size
    L = max(1, min(-(-n_groups // _RUNS_WANTED),
                   _RUN_SLABS // packed.group))
    tile_ptr = np.searchsorted(gt, np.arange(packed.n_tiles + 1))
    n_runs = -(-np.diff(tile_ptr) // L)
    run_tile = np.repeat(np.arange(packed.n_tiles), n_runs)
    first = np.concatenate([[0], np.cumsum(n_runs)])[:-1]
    run_start = (tile_ptr[run_tile]
                 + L * (np.arange(run_tile.size) - first[run_tile]))
    dev = packed.group_tile.device
    return (_put(np.append(run_start, n_groups), torch.int32, dev),
            _put(run_tile, torch.int32, dev))


_RUNS: dict = {}


def rowpure_runs(packed: SellRowPure):
    """The pack's runs (``_rowpure_runs_build``), built once per pack."""
    return cached_on(_RUNS, packed, _rowpure_runs_build)


def _spmv_sell_rowpure_cuda(packed: SellRowPure,
                            x: torch.Tensor) -> torch.Tensor:
    rows, cols = packed.shape
    _check_x(x, cols, "spmv_sell_rowpure")
    n_groups, group = packed.s_idx.shape[0], packed.group
    if (packed.s_idx.dtype != torch.int8
            or packed.s_idx.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.s_idx.shape
            or packed.group_tile.dtype != torch.int32
            or packed.slab_win.dtype != torch.int32
            or packed.group_tile.shape != (n_groups,)
            or packed.slab_win.numel() != n_groups * group):
        raise ValueError("spmv_sell_rowpure: inconsistent pack planes")
    bf16 = packed.vals.dtype == torch.bfloat16
    if (packed.vals.data_ptr() % (8 if bf16 else 16)
            or packed.s_idx.data_ptr() % 4):
        raise ValueError("spmv_sell_rowpure: the planes must be aligned "
                         "for 4-cell loads")
    run_ptr, run_tile = rowpure_runs(packed)
    return _launch("spmv_sell_rowpure",
                   (packed.s_idx, packed.vals, run_ptr, run_tile,
                    packed.slab_win), x, rows, cols, run_tile.numel(),
                   (packed.group, packed.rows_per_sublane))


def _on_cpu(packed, x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and packed.vals.device.type == "cpu"


def spmv_sell(packed: SellSpmv, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a masked-slab SELL pack, in the values' type.
    Not differentiable: the result carries no gradient."""
    with torch.no_grad():
        if _on_cpu(packed, x):
            return spmv_sell_reference(packed, x)
        return _spmv_sell_cuda(packed, x)


def _rowpure_forward(packed: SellRowPure, x: torch.Tensor) -> torch.Tensor:
    if _on_cpu(packed, x):
        return spmv_sell_rowpure_reference(packed, x)
    return _spmv_sell_rowpure_cuda(packed, x)


class _SpmvRowPure(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, x):
        # ``vals`` is ``packed.vals``, passed so autograd tracks it
        ctx.packed = packed
        ctx.save_for_backward(x)
        return _rowpure_forward(packed, x)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        (x,) = ctx.saved_tensors
        rows, cols = packed.shape
        row, col = _rowpure_slot_row_col(packed)
        acc = _acc_type(packed.vals)
        gpad = torch.zeros(packed.n_tiles * 8 * packed.rows_per_sublane,
                           dtype=acc, device=g.device)
        gpad[:rows] = g
        gx = dvals = None
        if ctx.needs_input_grad[2]:
            gv = gpad[row] * packed.vals.to(acc)
            # padding cells past ``cols`` carry value 0: clip them in range
            gx = torch.zeros(cols, dtype=acc, device=g.device)
            gx.index_add_(0, col.clamp(max=cols - 1).reshape(-1),
                          gv.reshape(-1))
            gx = gx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            xpad = torch.zeros(packed.n_win * _W, dtype=acc, device=x.device)
            xpad[:cols] = x
            zero = torch.zeros((), dtype=acc, device=x.device)
            dvals = torch.where(packed.vals != 0, xpad[col] * gpad[row],
                                zero).to(packed.vals.dtype)
        return None, dvals, gx


def spmv_sell_rowpure(packed: SellRowPure, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a row-pure SELL pack, in the values' type;
    differentiable in x and in ``packed.vals``."""
    return _SpmvRowPure.apply(packed, packed.vals, x)
