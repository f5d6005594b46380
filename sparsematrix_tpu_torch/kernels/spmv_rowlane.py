"""Row-lane SpMV: the packer and ``csrc/spmv_rowlane.cu``.

Twin of ``sparsematrix_tpu/kernels/spmv_rowlane.py``.  x is viewed
(S, 128); a 1024-column window is an (8, 128) tile whose sublane u holds
columns ``[w*1024 + u*128, w*1024 + (u+1)*128)``.  An entry (r, c, v) sits
at sublane ``u = (c % 1024) // 128`` and stores ``s_idx = c % 128``; the
lane is the row slot: lane l serves row ``t*T + l % T`` of row tile t
(T = 128 // lanes_per_row).  The product of a slab is

    g[u, l] = xw[u, s_idx[u, l]]
    y[t*T + l % T] += sum_u vals[u, l] * g[u, l]

Entries of one row in one 128-column chunk of one window compete for one
(u, l) slot a slab; occurrence d lands in slab ``d // L``.

The host packer is the JAX packer's algorithm line for line, so every
plane comes out ``np.array_equal`` to it: the native packer
(``native/rowlane.cc``, built by ``g++`` at first use) or, where no
compiler is found, the numpy one.  ``spill_depth`` sends the entries past
``L * spill_depth`` in their bucket to a second rowlane pack (the
``spill_packed`` tail), which runs on the same kernel; a legacy container
whose tail is a masked-slab ``SellSpmv`` runs it through ``spmv_sell``
(``csrc/spmv_sell.cu``), as the JAX package does.

``spmv_sell_rowlane(packed, x)`` runs ``spmv_sell_rowlane_reference``
when all its inputs lie on the CPU, and otherwise launches the kernel or
raises.  The kernel is the warp walk of ``csrc/rowlane.cuh``; its side
structures are built from the planes once a pack and cached: the sector
mask (``sector_mask``: no all-zero 32-byte value sector is read), the
slabs each group walks (``group_real``, for groups of more than one slab)
and the warps' ranges of slabs, cut at tile starts (``rowlane_walk``), so
that each warp stores its own tiles and y needs no zero fill.  It is
differentiable in x and in ``vals`` (the JAX wrapper's custom VJP,
``spmv_rowlane.py:487-529``); with a ``t_pack`` the x cotangent runs the
kernel on the transposed pack.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..formats.base import cached_on, sparse_container, static_field
from ..formats.csr import CSR
from . import _build
from .spmv_sell import SellSpmv, _spmv_sell_cuda, spmv_sell_reference

__all__ = ["SellRowLane", "pack_sell_rowlane", "spmv_sell_rowlane",
           "spmv_sell_rowlane_reference"]

_W = 1024
_LANES = 128


@sparse_container
@dataclasses.dataclass(frozen=True)
class SellRowLane:
    s_idx: torch.Tensor  # (n_groups, group*8, 128) int8: c % 128
    vals: torch.Tensor  # (n_groups, group*8, 128) fp32 or bf16
    group_tile: torch.Tensor  # (n_groups,) int32, ascending
    slab_win: torch.Tensor  # (n_groups, group) int32
    tile_nonempty: torch.Tensor  # (n_tiles,) bool
    spill: Optional[CSR]  # tail entries beyond spill_depth (or None)
    spill_packed: Optional[object]  # rowlane pack (or legacy SellSpmv) of
    #                                 the tail
    t_pack: Optional["SellRowLane"]  # packed A^T for the backward pass
    shape: Tuple[int, int] = static_field()
    n_tiles: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    lanes_per_row: int = static_field()
    nnz: int = static_field()

    @property
    def fill_rate(self) -> float:
        spill_nnz = self.spill.nnz if self.spill is not None else 0
        return (self.nnz - spill_nnz) / max(self.vals.numel(), 1)

    @property
    def n_slabs(self) -> int:
        return self.s_idx.shape[0] * self.group


# ---------------------------------------------------------------------------
# host packer (the JAX packer's algorithm)
# ---------------------------------------------------------------------------

_PLAN_ARGTYPES = (
    ctypes.c_void_p,  # r (nnz,) int32
    ctypes.c_void_p,  # c (nnz,) int32
    ctypes.c_long,  # nnz
    ctypes.c_long,  # rows
    ctypes.c_long,  # cols
    ctypes.c_int32,  # group (0: auto)
    ctypes.c_int32,  # L
    ctypes.c_void_p,  # meta (6,) int64 out
)
_FILL_ARGTYPES = (
    ctypes.c_void_p,  # r
    ctypes.c_void_p,  # c
    ctypes.c_void_p,  # v bytes
    ctypes.c_long,  # value size
    ctypes.c_void_p,  # s_idx out
    ctypes.c_void_p,  # vals out
    ctypes.c_void_p,  # win out int32
    ctypes.c_void_p,  # group_tile out int32
    ctypes.c_void_p,  # tile_nonempty out uint8
)
_SPILL_ARGTYPES = (
    ctypes.c_void_p,  # r
    ctypes.c_void_p,  # c
    ctypes.c_long,  # nnz
    ctypes.c_long,  # rows
    ctypes.c_long,  # cols
    ctypes.c_int32,  # L
    ctypes.c_int32,  # depth cap (L * spill_depth)
    ctypes.c_void_p,  # keep (nnz,) uint8 out
)

# the native packer keeps its sort state between its plan and fill calls
_NATIVE_PACK_LOCK = threading.Lock()


def _pack_arrays_native(r, c, v, rows, cols, group, L):
    """The native packer (``native/rowlane.cc``: plan, then fill); the same
    outputs as ``_pack_arrays``.  None where no ``g++`` is found."""
    plan = _build.load_host("rowlane", "smtpu_rowlane_plan", _PLAN_ARGTYPES)
    fill = _build.load_host("rowlane", "smtpu_rowlane_fill", _FILL_ARGTYPES)
    if (plan is None or fill is None or rows >= 2**31 or cols >= 2**31
            or r.size >= 2**31):
        return None
    r32 = np.ascontiguousarray(r, np.int32)
    c32 = np.ascontiguousarray(c, np.int32)
    vv = np.ascontiguousarray(v)
    meta = np.zeros(6, np.int64)
    with _NATIVE_PACK_LOCK:
        rc = plan(r32.ctypes.data, c32.ctypes.data, r32.size, rows, cols,
                  group or 0, L, meta.ctypes.data)
        if rc != 0:
            return None
        total_slots, n_groups, g_sel, n_tiles, n_win, _ = map(int, meta)
        s_idx = np.zeros((total_slots, 8, _LANES), np.int8)
        vals = np.zeros((total_slots, 8, _LANES), vv.dtype)
        win = np.zeros(total_slots, np.int32)
        group_tile = np.zeros(n_groups, np.int32)
        tne = np.zeros(n_tiles, np.uint8)
        rc = fill(r32.ctypes.data, c32.ctypes.data, vv.ctypes.data,
                  vv.dtype.itemsize, s_idx.ctypes.data, vals.ctypes.data,
                  win.ctypes.data, group_tile.ctypes.data, tne.ctypes.data)
        if rc != 0:
            return None
    return dict(
        s_idx=s_idx.reshape(n_groups, g_sel * 8, _LANES),
        vals=vals.reshape(n_groups, g_sel * 8, _LANES),
        group_tile=group_tile,
        slab_win=win.reshape(n_groups, g_sel),
        tile_nonempty=tne.astype(bool),
        n_tiles=n_tiles, n_win=n_win, group=g_sel,
    )


def _pack_arrays(r, c, v, rows, cols, group, L, dtype):
    """Vectorized slab assignment (numpy); returns the host arrays."""
    T = _LANES // L
    n_tiles = -(-rows // T)
    n_win = max(-(-cols // _W), 1)
    if r.size == 0:
        group = group or 8
        return dict(
            s_idx=np.zeros((1, group * 8, _LANES), np.int8),
            vals=np.zeros((1, group * 8, _LANES), dtype),
            group_tile=np.zeros((1,), np.int64),
            slab_win=np.zeros((1, group), np.int64),
            tile_nonempty=np.zeros((n_tiles,), bool),
            n_tiles=n_tiles, n_win=n_win, group=group,
        )
    t = r // T
    rloc = r % T
    w = c // _W
    u = (c % _W) // _LANES
    sidx = c % _LANES
    # occurrence index d within bucket (t, w, u, rloc)
    key = (((t * n_win + w) * 8 + u) * T + rloc).astype(np.int64)
    order = np.argsort(key, kind="stable")
    ko = key[order]
    new = np.empty(len(ko), bool)
    new[0] = True
    new[1:] = ko[1:] != ko[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(len(ko)), 0))
    d = np.arange(len(ko)) - run_start
    tt, ww, uu = t[order], w[order], u[order]
    rr, ss, vv = rloc[order], sidx[order], v[order]
    m = d % L
    s = d // L  # slab index within (t, w)
    lane = rr + m * T
    # slab identity (t, w, s) → contiguous ids, sorted t-major
    d_span = int(s.max()) + 1
    skey = (tt * n_win + ww) * d_span + s
    uskey, inv = np.unique(skey, return_inverse=True)
    slab_t = uskey // (n_win * d_span)
    slab_w = (uskey // d_span) % n_win
    n_slabs = len(uskey)
    counts = np.bincount(slab_t, minlength=n_tiles)
    if group is None:
        # auto: the largest group whose per-tile padding waste stays under
        # 15 %
        group = 1
        for g in (256, 128, 64, 32, 16, 8, 4, 2):
            waste = ((-(-counts // g) * g).sum() - n_slabs) / max(n_slabs, 1)
            if waste <= 0.15:
                group = g
                break
    tile_groups = -(-counts // group)
    padded = tile_groups * group
    tile_offset = np.concatenate([[0], np.cumsum(padded)])
    first_of_tile = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(n_slabs) - first_of_tile[slab_t]
    slab_slot = tile_offset[slab_t] + rank
    total_slots = int(tile_offset[-1])
    n_groups = total_slots // group

    s_idx_arr = np.zeros((total_slots, 8, _LANES), np.int8)
    vals_arr = np.zeros((total_slots, 8, _LANES), dtype)
    win = np.zeros(total_slots, np.int64)
    entry_slot = slab_slot[inv]
    s_idx_arr[entry_slot, uu, lane] = ss
    vals_arr[entry_slot, uu, lane] = vv
    win[slab_slot] = slab_w
    group_tile = np.repeat(np.arange(n_tiles), tile_groups)
    return dict(
        s_idx=s_idx_arr.reshape(n_groups, group * 8, _LANES),
        vals=vals_arr.reshape(n_groups, group * 8, _LANES),
        group_tile=group_tile,
        slab_win=win.reshape(n_groups, group),
        tile_nonempty=counts > 0,
        n_tiles=n_tiles, n_win=n_win, group=group,
    )


def _spill_mask_native(r, c, rows, cols, L, spill_depth):
    """keep[i] = bucket occurrence of entry i < L*spill_depth, by the
    native sorter (``native/rowlane.cc``); None where no ``g++`` is
    found."""
    fn = _build.load_host("rowlane", "smtpu_rowlane_spill_mask",
                          _SPILL_ARGTYPES)
    if fn is None or rows >= 2**31 or cols >= 2**31 or r.size >= 2**31:
        return None
    r32 = np.ascontiguousarray(r, np.int32)
    c32 = np.ascontiguousarray(c, np.int32)
    keep = np.zeros(r32.size, np.uint8)
    rc = fn(r32.ctypes.data, c32.ctypes.data, r32.size, rows, cols, L,
            L * spill_depth, keep.ctypes.data)
    if rc != 0:
        return None
    return keep.astype(bool)


def _spill_mask_numpy(r, c, cols, L, spill_depth):
    """The numpy twin of ``_spill_mask_native``."""
    T = _LANES // L
    key = ((((r // T) * max(-(-cols // _W), 1) + c // _W) * 8
            + (c % _W) // _LANES) * T + r % T)
    order = np.argsort(key, kind="stable")
    ko = key[order]
    new = np.empty(len(ko), bool)
    new[0] = True
    new[1:] = ko[1:] != ko[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(len(ko)), 0))
    d = np.arange(len(ko)) - run_start
    keep = np.zeros(len(r), bool)
    keep[order] = d < L * spill_depth
    return keep


def _put(a, dev, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dt is None else t.to(dev, dt)


def pack_sell_rowlane(csr: CSR, group: int | None = None,
                      lanes_per_row: int = 1,
                      spill_depth: int | None = None,
                      with_transpose: bool = False,
                      dtype=None, device=None) -> SellRowLane:
    """Pack a CSR into row-lane slabs on ``device`` (default: the CSR's).

    ``lanes_per_row`` L ∈ {1, 2, 4, 8}: lane slots a row (the tile shrinks
    to 128/L rows).  ``spill_depth``: entries whose bucket occurrence is
    ≥ L*spill_depth go to a second rowlane pack (``spill_packed``).
    ``with_transpose`` also packs A^T for the backward pass.
    ``dtype=torch.bfloat16`` stores the values in bf16 (accumulation stays
    fp32).
    """
    L = lanes_per_row
    if L not in (1, 2, 4, 8):
        raise ValueError("lanes_per_row must be 1/2/4/8")
    dev = csr.device if device is None else torch.device(device)
    sp = csr.to_scipy().tocoo()
    rows, cols = sp.shape
    r = sp.row.astype(np.int64)
    c = sp.col.astype(np.int64)
    v = sp.data
    spill = None
    spill_packed = None
    if spill_depth is not None and r.size:
        keep = _spill_mask_native(r, c, rows, cols, L, spill_depth)
        if keep is None:
            keep = _spill_mask_numpy(r, c, cols, L, spill_depth)
        if not keep.all():
            tail = sps.coo_matrix((v[~keep], (r[~keep], c[~keep])),
                                  shape=(rows, cols))
            spill = CSR.from_scipy(tail.tocsr(), device=dev)
            # the tail's buckets are shallow: a second rowlane pack, with
            # its own (smaller) auto group, runs it on the same kernel
            spill_packed = pack_sell_rowlane(
                spill, group=None, lanes_per_row=L, spill_depth=None,
                with_transpose=False, dtype=dtype, device=dev)
            r, c, v = r[keep], c[keep], v[keep]
    arrs = None
    if r.size:
        arrs = _pack_arrays_native(r, c, v, rows, cols, group, L)
    if arrs is None:
        arrs = _pack_arrays(r, c, v, rows, cols, group, L, v.dtype)
    t_pack = None
    if with_transpose:
        t_pack = pack_sell_rowlane(
            CSR.from_scipy(csr.to_scipy().T.tocsr(), device="cpu"),
            group=group, lanes_per_row=L, spill_depth=spill_depth,
            with_transpose=False, dtype=dtype, device=dev)
    vals = _put(arrs["vals"], dev)
    return SellRowLane(
        s_idx=_put(arrs["s_idx"], dev, torch.int8),
        vals=vals if dtype is None else vals.to(dtype),
        group_tile=_put(arrs["group_tile"], dev, torch.int32),
        slab_win=_put(arrs["slab_win"], dev, torch.int32),
        tile_nonempty=_put(arrs["tile_nonempty"], dev, torch.bool),
        spill=spill,
        spill_packed=spill_packed,
        t_pack=t_pack,
        shape=(rows, cols),
        n_tiles=arrs["n_tiles"],
        n_win=arrs["n_win"],
        group=arrs["group"],
        lanes_per_row=L,
        nnz=csr.nnz,
    )


# ---------------------------------------------------------------------------
# plain versions and slot coordinates (shared with spmv_superblock.py)
# ---------------------------------------------------------------------------

# slabs a step of the plain walk: bounds its gathered temporaries
_PLAIN_SLABS = 1 << 14


def slab_walk_plain(s_idx, vals, slab_win, slab_tile, n_win, n_tiles,
                    x) -> torch.Tensor:
    """The plain row-lane walk: per slab ``g = xw[u, s_idx]``, times vals,
    summed over sublanes, added to the slab's tile.  Returns the per-lane
    sums (n_tiles, 128) fp32."""
    cols = x.shape[0]
    xp = torch.zeros(n_win * _W, dtype=torch.float32, device=x.device)
    xp[:cols] = x
    xw = xp.reshape(n_win, 8, _LANES)
    si = s_idx.reshape(-1, 8, _LANES)
    vv = vals.reshape(-1, 8, _LANES)
    win = slab_win.reshape(-1).long()
    tiles = slab_tile.clamp(max=n_tiles)  # a spare tile for strays
    out = torch.zeros((n_tiles + 1, _LANES), dtype=torch.float32,
                      device=x.device)
    for s0 in range(0, si.shape[0], _PLAIN_SLABS):
        sl = slice(s0, s0 + _PLAIN_SLABS)
        g = torch.gather(xw[win[sl]], 2, si[sl].long() & 127)
        part = (vv[sl].float() * g).sum(dim=1)  # (n, 128)
        out.index_add_(0, tiles[sl], part)
    return out[:n_tiles]


def _slab_tiles(packed: SellRowLane) -> torch.Tensor:
    return packed.group_tile.long().repeat_interleave(packed.group)


def _check_pack(packed: SellRowLane, fn: str) -> None:
    if packed.vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: values must be fp32 or bf16, not "
                         f"{packed.vals.dtype}")
    if packed.spill_packed is not None and not isinstance(
            packed.spill_packed, (SellRowLane, SellSpmv)):
        raise TypeError(f"{fn}: a spill tail must be a SellRowLane or a "
                        f"SellSpmv, not {type(packed.spill_packed).__name__}")


def _check_x(x: torch.Tensor, cols: int, fn: str) -> None:
    if x.dtype != torch.float32 or x.shape != (cols,):
        raise ValueError(f"{fn}: x must be an fp32 vector of length {cols}, "
                         f"not {x.dtype} {tuple(x.shape)}")


def _body_plain(packed: SellRowLane, x: torch.Tensor) -> torch.Tensor:
    rows = packed.shape[0]
    L = packed.lanes_per_row
    T = _LANES // L
    out = slab_walk_plain(packed.s_idx, packed.vals, packed.slab_win,
                          _slab_tiles(packed), packed.n_win, packed.n_tiles,
                          x)
    # fold the L lane replicas of each row
    return out.reshape(packed.n_tiles, L, T).sum(dim=1).reshape(-1)[:rows]


# ---------------------------------------------------------------------------
# the card walk (csrc/rowlane.cuh): its side structures, built once a pack
# ---------------------------------------------------------------------------

def _group_real_build(packed) -> torch.Tensor:
    """(n_groups,) int32 on the pack's device: the count of each group's
    slabs up to its last that holds a nonzero value (0 if none).  The
    walk skips the slabs after it unread: a group's padding slabs hold
    only zeros."""
    n_groups, group = packed.s_idx.shape[0], packed.group
    nz = (packed.vals.reshape(n_groups, group, 8 * _LANES) != 0).any(-1)
    pos = torch.arange(1, group + 1, dtype=torch.int32,
                       device=nz.device)
    return (nz * pos).amax(1).to(torch.int32)


_REAL: dict = {}


def group_real(packed) -> torch.Tensor:
    """The pack's ``_group_real_build`` (a rowlane or superblock pack),
    built once per pack."""
    return cached_on(_REAL, packed, _group_real_build)


def _sector_mask_build(packed) -> torch.Tensor:
    """(n_slabs, 8) int16 on the pack's device: bit j of slab s's sublane u
    is set where lanes 8j..8j+7 of ``vals[s, u]`` hold a nonzero value (a
    32-byte sector of an fp32 value row).  The walk loads a value word and
    its s_idx word only under a set bit."""
    nz = (packed.vals.reshape(-1, 8, 16, 8) != 0).any(-1)
    weight = 1 << torch.arange(16, dtype=torch.int32, device=nz.device)
    word = (nz.to(torch.int32) * weight).sum(-1, dtype=torch.int32)
    # the low 16 bits as int16 (the kernel reads them unsigned)
    return (word - (word >= 1 << 15).to(torch.int32) * (1 << 16)).to(
        torch.int16).contiguous()


_MASKS: dict = {}


def sector_mask(packed) -> torch.Tensor:
    """The pack's ``_sector_mask_build``, built once per pack."""
    return cached_on(_MASKS, packed, _sector_mask_build)


def walk_ranges(tiles: np.ndarray, walked: np.ndarray, spw: int, T: int,
                rows: int, dev: torch.device):
    """The walk's warp ranges over slabs whose tiles are ``tiles`` (one a
    slab, non-decreasing), ``walked`` marking the slabs it reads: (warp_ptr
    (n_warps+1,) int32, split (k,) int64, split_rows (m,) int64) on
    ``dev``.  The slabs cut into ranges of about ``spw``, one a warp: each
    cut moves to the nearest tile start (or the end) where that is at most
    ``max(1, spw // 2)`` walked slabs away or the tile holds at most
    ``2 * spw`` walked slabs (the skipped slabs cost a warp nothing), so
    that a tile is one warp's unless it is long; ``split`` lists the tiles
    a cut still splits (those the kernel adds into) and ``split_rows``
    their rows (``T`` a tile) below ``rows`` (which the wrapper zeroes)."""
    n = tiles.size
    if n and (np.diff(tiles) < 0).any():
        raise ValueError("the walk needs slab tiles that never decrease")
    done = np.r_[0, np.cumsum(walked)]
    n_warps = max(1, -(-n // spw))
    want = np.arange(1, n_warps, dtype=np.int64) * n // n_warps
    starts = np.flatnonzero(np.r_[True, tiles[1:] != tiles[:-1]])
    i = np.searchsorted(starts, want, side="right")
    lo = starts[np.maximum(i - 1, 0)]  # the start of want's tile
    hi = np.r_[starts, n][i]  # the next tile's start, or the end
    near = np.where(want - lo <= hi - want, lo, hi)
    move = ((np.abs(done[near] - done[want]) <= max(1, spw // 2))
            | (done[hi] - done[lo] <= 2 * spw))
    cut = np.maximum.accumulate(np.where(move, near, want))
    inner = cut[(cut > 0) & (cut < n)]
    split = np.unique(tiles[inner][tiles[inner - 1] == tiles[inner]])
    split_rows = (split[:, None] * T + np.arange(T)).reshape(-1)
    return (_put(np.r_[0, cut, n], dev, torch.int32),
            torch.from_numpy(split.astype(np.int64)).to(dev),
            torch.from_numpy(split_rows[split_rows < rows]
                             .astype(np.int64)).to(dev))


_WARPS: dict = {}


def resident_warps(source: str, device: torch.device) -> int:
    """The warps of ``source``'s walk kernel the card holds at once (its C
    function ``<source>_warps``), asked once a card."""
    key = (source, device.index)
    if key not in _WARPS:
        fn = _build.load(source, (), f"{source}_warps")
        with torch.cuda.device(device):
            n = fn()
        if n <= 0:
            raise RuntimeError(f"{source}: the card's occupancy query failed")
        _WARPS[key] = n
    return _WARPS[key]


def _walk_build(packed: SellRowLane, spw: int):
    tiles = _slab_tiles(packed).cpu().numpy()
    walked = np.ones(tiles.size, bool)
    if packed.group > 1:
        real = group_real(packed).cpu().numpy()
        slab = np.arange(tiles.size)
        walked = slab % packed.group < real[slab // packed.group]
    return walk_ranges(tiles, walked, spw, _LANES // packed.lanes_per_row,
                       packed.shape[0], packed.s_idx.device)


def rowlane_default_spw(n_slabs: int, resident: int) -> int:
    """The rowlane kernel's default slabs a warp: about 8, in a whole
    number of waves of the ``resident`` warps the card holds.  A partial
    last wave idles most of the card, and on packs of long tiles several
    short waves balance the warps' ranges better than one long one
    (``chip_smoke.py``'s variant lines time the neighbours)."""
    waves = max(1, round(n_slabs / (8 * resident)))
    return -(-n_slabs // (waves * resident))


_WALKS: dict = {}


def rowlane_walk(packed: SellRowLane, spw: int = 0):
    """The pack's walk ranges (``walk_ranges``) at ``spw`` slabs a warp (0:
    ``rowlane_default_spw`` over the rowlane kernel's resident warps),
    built once per pack and ``spw``."""
    walks = cached_on(_WALKS, packed, lambda _: {})
    if spw == 0:
        if 0 not in walks:
            walks[0] = rowlane_default_spw(
                packed.n_slabs, resident_warps("spmv_rowlane",
                                               packed.s_idx.device))
        spw = walks[0]
    if spw not in walks:
        walks[spw] = _walk_build(packed, spw)
    return walks[spw]


# a small pack (at most this many slabs a warp in one wave) whose tiles the
# walk's cuts split anyway takes equal ranges into a zeroed y by default:
# its time is the latency of a few dependent reads, not bytes
_EQUAL_SLABS = 4


def _check_planes(packed: SellRowLane) -> None:
    planes = (packed.s_idx, packed.vals, packed.group_tile, packed.slab_win)
    dev = packed.vals.device
    if not all(t.device == dev and t.is_contiguous() for t in planes):
        raise ValueError("spmv_sell_rowlane: the pack and x must be "
                         "contiguous on one CUDA device")
    n_groups, group = packed.s_idx.shape[0], packed.group
    if (packed.s_idx.dtype != torch.int8
            or any(t.dtype != torch.int32 for t in planes[2:])
            or packed.s_idx.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.s_idx.shape
            or packed.group_tile.shape != (n_groups,)
            or packed.slab_win.numel() != n_groups * group):
        raise ValueError("spmv_sell_rowlane: inconsistent pack planes")
    bf16 = packed.vals.dtype == torch.bfloat16
    if (packed.vals.data_ptr() % (8 if bf16 else 16)
            or packed.s_idx.data_ptr() % 4):
        raise ValueError("spmv_sell_rowlane: the planes must be aligned for "
                         "4-slot loads")


def _launch_build(packed: SellRowLane, spw: int, mask: bool, equal):
    """What a launch on the pack passes besides x, y and the stream, at one
    setting of the knobs: (the arguments before x, those after y, whether
    y is zeroed first, the side tensors the pointers name)."""
    _check_planes(packed)
    warp_ptr, split, _ = rowlane_walk(packed, spw)
    resident = resident_warps("spmv_rowlane", packed.vals.device)
    if equal is None:
        equal = bool(spw == 0 and split.numel()
                     and packed.n_slabs <= _EQUAL_SLABS * resident)
    if equal:  # equal ranges, every tile added into a zeroed y
        real = sm = warp_ptr = None
        step = spw or -(-packed.n_slabs // resident)
        n_warps, zero = -(-packed.n_slabs // step), True
    else:  # the cut ranges: a zero fill only where a cut splits a tile
        real = group_real(packed) if packed.group > 1 else None
        sm = sector_mask(packed) if mask else None
        step, n_warps, zero = 0, warp_ptr.numel() - 1, bool(split.numel())
    side = (real, sm, warp_ptr)
    before = (packed.s_idx.data_ptr(), packed.vals.data_ptr(),
              packed.group_tile.data_ptr(), packed.slab_win.data_ptr(),
              *(None if t is None else t.data_ptr() for t in side))
    after = (*packed.shape, packed.n_slabs, packed.group,
             packed.lanes_per_row, n_warps, step,
             int(packed.vals.dtype == torch.bfloat16))
    return before, after, zero, side


_LAUNCHES: dict = {}


def _body_cuda(packed: SellRowLane, x: torch.Tensor, *, spw: int = 0,
               mask: bool = True, equal=None) -> torch.Tensor:
    """The kernel on the pack's body.  ``spw`` (slabs a warp; 0: the
    default), ``mask`` (False: every value word read) and ``equal`` (True:
    equal ranges into a zeroed y; False: the ranges cut at tile starts;
    None: equal ranges for a small pack that the cuts split) are knobs for
    measurements only; each gives A @ x.  The launch's arguments are built
    once a pack and setting, so a call makes one lookup."""
    rows, cols = packed.shape
    if not x.is_cuda or x.device != packed.vals.device:
        raise ValueError(f"spmv_sell_rowlane: x must lie on the pack's CUDA "
                         f"device, not {x.device}")
    if rows == 0 or cols == 0:
        return torch.zeros(rows, dtype=torch.float32, device=x.device)
    launches = cached_on(_LAUNCHES, packed, lambda _: {})
    key = (spw, mask, equal)
    entry = launches.get(key)
    if entry is None:
        entry = launches[key] = _launch_build(packed, spw, mask, equal)
    before, after, zero, _ = entry
    # the kernel writes every row but those of the tiles a cut splits,
    # into which it adds
    y = (torch.zeros if zero else torch.empty)(
        rows, dtype=torch.float32, device=x.device)
    fn = _build.load("spmv_rowlane", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(*before, x.contiguous().data_ptr(), y.data_ptr(), *after,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_rowlane: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["spmv_rowlane"] += 1
    return y


_ARGTYPES = (
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # group_tile (n_groups,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # group_real (n_groups,) int32, or null
    ctypes.c_void_p,  # sector mask (n_slabs, 8) int16, or null
    ctypes.c_void_p,  # warp_ptr (n_warps+1,) int32, or null
    ctypes.c_void_p,  # x (cols,) fp32
    ctypes.c_void_p,  # y (rows,) fp32, zero in the split tiles
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # group
    ctypes.c_int,  # lanes_per_row
    ctypes.c_int,  # n_warps
    ctypes.c_int,  # slabs a warp without warp_ptr
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)


def _on_cpu(packed: SellRowLane, x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and packed.vals.device.type == "cpu"


def _rowlane_apply(packed: SellRowLane, x: torch.Tensor,
                   plain: bool) -> torch.Tensor:
    """``y = A @ x``, spill tail included, by the plain walk or the
    kernel."""
    _check_pack(packed, "spmv_sell_rowlane")
    _check_x(x, packed.shape[1], "spmv_sell_rowlane")
    y = (_body_plain if plain else _body_cuda)(packed, x)
    if isinstance(packed.spill_packed, SellSpmv):
        # legacy containers packed with the masked-slab kernel
        y = y + (spmv_sell_reference if plain else _spmv_sell_cuda)(
            packed.spill_packed, x)
    elif packed.spill_packed is not None:
        y = y + _rowlane_apply(packed.spill_packed, x, plain)
    elif packed.spill is not None:
        from ..ops.spmv import spmv_reference

        y = y + spmv_reference(packed.spill, x)
    return y


def _rowlane_forward(packed: SellRowLane, x: torch.Tensor) -> torch.Tensor:
    return _rowlane_apply(packed, x, _on_cpu(packed, x))


def spmv_sell_rowlane_reference(packed: SellRowLane,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``y = A @ x``: fp32 x, fp32 or bf16 values, fp32
    accumulation and result (as the Pallas kernel), spill tail included."""
    return _rowlane_apply(packed, x, plain=True)


def _slot_row_col(packed: SellRowLane):
    """Per-slot (row, col), each (n_groups, group*8, 128) int64."""
    L = packed.lanes_per_row
    T = _LANES // L
    n_groups, GH, _ = packed.s_idx.shape
    dev = packed.s_idx.device
    lane = torch.arange(_LANES, device=dev)[None, None, :]
    row = packed.group_tile.long()[:, None, None] * T + (lane % T)
    subl = (torch.arange(GH, device=dev) % 8)[None, :, None]
    winb = packed.slab_win.long().repeat_interleave(8, dim=1)[:, :, None]
    col = winb * _W + subl * _LANES + (packed.s_idx.long() & 127)
    return row.expand_as(col), col


def _rowlane_matvec_t(packed: SellRowLane, g: torch.Tensor) -> torch.Tensor:
    """``A^T @ g`` from the slab planes alone (the plain scatter for the
    backward pass when no transposed pack was built), spill included."""
    rows, cols = packed.shape
    L = packed.lanes_per_row
    T = _LANES // L
    row, col = _slot_row_col(packed)
    gpad = torch.zeros(packed.n_tiles * T, dtype=torch.float32,
                       device=g.device)
    gpad[:rows] = g
    gv = gpad[row] * packed.vals.float()
    out = torch.zeros(packed.n_win * _W, dtype=torch.float32, device=g.device)
    # padding slots past ``cols`` land past the cut and are dropped
    out.index_add_(0, col.reshape(-1), gv.reshape(-1))
    out = out[:cols]
    if packed.spill is not None:
        sp = packed.spill
        rid = sp._row_ids_or_compute().long().clamp(max=rows - 1)
        contrib = sp.data.float() * g.float()[rid]
        out = out.index_add(0, sp.indices.long(), contrib)
    return out


class _SpmvRowLane(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, x):
        # ``vals`` is ``packed.vals``, passed so autograd tracks it
        ctx.packed = packed
        ctx.save_for_backward(x)
        return _rowlane_forward(packed, x)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        gx = dvals = None
        if ctx.needs_input_grad[2]:
            if packed.t_pack is not None:
                gx = _rowlane_forward(packed.t_pack, g.float())
            else:
                gx = _rowlane_matvec_t(packed, g)
            gx = gx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            rows, cols = packed.shape
            T = _LANES // packed.lanes_per_row
            row, col = _slot_row_col(packed)
            xpad = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                               device=x.device)
            xpad[:cols] = x
            gpad = torch.zeros(packed.n_tiles * T, dtype=torch.float32,
                               device=g.device)
            gpad[:rows] = g
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            dvals = torch.where(packed.vals != 0, xpad[col] * gpad[row],
                                zero).to(packed.vals.dtype)
        return None, dvals, gx


def spmv_sell_rowlane(packed: SellRowLane, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the row-lane layout (fp32 result),
    differentiable in x and in ``packed.vals``."""
    return _SpmvRowLane.apply(packed, packed.vals, x)
