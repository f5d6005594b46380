"""Dual-gather SpMM: ``csrc/spmm_dualgather.cu``.

Twin of ``sparsematrix_tpu/kernels/spmm_dualgather.py``: the dual-gather
SpMV slab walk (``spmv_dualgather.py``) per right-hand-side column,
``Y = A @ X`` for a dense X of shape (cols, k).  It takes a k_tiles=1 pack
without tail or splits (the walk ``ops.spmm`` builds for low-density CSR)
or a superblock pack (``spmm(prepare_spmv(A), X)``), whose pooled spill
tail (``spill_cap``) is then a second launch, ``csrc/spmv_pooled.cu`` on
all k columns at once (the JAX package runs its tail kernel once a
column; the sum is the same).

Both kinds of pack run one kernel, ``spmm_dualgather_walk`` in the same
source (row 14 on a k_tiles=1 pack, row 13 on a superblock pack): it
walks a list of the pack's slabs that hold a value (``slab_walk``, built
once a pack and state of its values), window by window (pair by pair on a
two-window pack), with the window's (or both windows') rows of X staged in
shared memory, the slab planes streamed ahead by ``cp.async``, and reads
no X row under a zero value.  One deliberate difference: an
inf or NaN of X under a zero value (a padding slot) gives 0 on the card,
where the plain version gives NaN (as rows 7, 9 and 15 do).

``spmm_dualgather(packed, X)`` runs ``spmm_dualgather_reference`` when all
its inputs lie on the CPU, and otherwise launches the kernels or raises.
It is differentiable in X and in the values, with the JAX wrapper's
backward math (``spmm_dualgather.py:300-334``): the X cotangent is the
plain scatter ``A^T @ G``, the values' the masked ``X[col] · G[row]``
summed over the columns.  Unlike the JAX backward pass, which leaves the
tail out, both take the tail's entries too.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..formats.base import cached_on, values_version
from . import _build
from ._walk import sms, team_parts, window_cut
from .spmv_dualgather import (_LANES, _W, DualGather, _check_pack, _dvals,
                              _idxA_slabs, _slab_tiles, _slab_windows,
                              _slot_row_col, _slot_row_col_pooled,
                              _tail_vals, _walk_plain, launch_pooled)

__all__ = ["spmm_dualgather", "spmm_dualgather_reference",
           "slab_walk", "slab_walk_plain"]


def _check(packed: DualGather, X: torch.Tensor) -> None:
    if packed.k_tiles == 1 and (packed.tail is not None or packed.splits):
        raise ValueError("spmm_dualgather needs a superblock pack or a "
                         "plain k_tiles=1 pack (no tail, no splits)")
    _check_pack(packed, "spmm_dualgather")
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != packed.shape[1]:
        raise ValueError(f"spmm_dualgather: X must be fp32 of shape "
                         f"({packed.shape[1]}, k), not {X.dtype} "
                         f"{tuple(X.shape)}")


def spmm_dualgather_reference(packed: DualGather,
                              X: torch.Tensor) -> torch.Tensor:
    """Plain version: the SpMV kernel's two-gather walk with a trailing
    column dimension, the pooled tail included; fp32 accumulation and
    result."""
    _check(packed, X)
    return _walk_plain(packed, X)


# ---------------------------------------------------------------------------
# rows 13 and 14: the walk (csrc/spmm_dualgather.cu spmm_dualgather_walk)
# ---------------------------------------------------------------------------

# the walk's steps, each a kernel variant measured on its own: 1 reads no
# X row under a zero value (slabs in pack order, X gathered from L2); 2
# also stages X's window in shared memory (slabs window by window, four
# teams of four warps a block); 3 also streams the slab planes ahead
STEPS = (1, 2, 3)
WALK_STEP = 3  # the default
_TEAMS = {1: 1, 2: 4, 3: 4}  # teams of four warps a block
_ITEM_CHUNK = 8192  # items a step of slab_walk_plain


@dataclasses.dataclass(frozen=True)
class SlabWalk:
    """A pack's walk: ``items`` (n_items, 4) int32, (slab, tile, window,
    0) of every slab that holds a nonzero value, each slab once, with its
    tile (a superblock pack's ``group_tile · k_tiles + slab_tloc``) and its
    ``slab_win`` word (on a two-window pack the pair ``wa | wb << 16``);
    ``part_ptr`` (n_blocks · teams + 1,) int32: the items of block b's team
    q at part b·teams + q.  In pack order (step 1) a block is one team
    walking about 16 slabs; window by window (steps 2-3; pair by pair on a
    two-window pack), ordered by tile within a window, all of a block's
    items read one window or pair, which it stages, and there is about one
    block an SM (the card holds one at a time: 512 threads of ~100
    registers), shared among the windows by their items, so that no
    second round of blocks runs a few stragglers."""

    items: torch.Tensor
    part_ptr: torch.Tensor
    n_blocks: int
    teams: int


def _walk_items(packed: DualGather):
    """(slab, tile, window word) int64 of the slabs that hold a nonzero
    value, in pack order."""
    n = packed.n_slabs
    s = torch.nonzero((packed.vals.reshape(n, -1) != 0).any(1)).flatten()
    tile = _slab_tiles(packed)[s]
    win = packed.slab_win.reshape(-1)[s].long()
    return tuple(t.cpu().numpy().astype(np.int64) for t in (s, tile, win))


def _slab_walk_build(packed: DualGather, step: int,
                     spb: int = 0) -> SlabWalk:
    s, tile, win = _walk_items(packed)
    teams = _TEAMS[step]
    n_sms = sms(packed.vals.device)
    if step == 1:
        # contiguous slabs a block, as the first design cut them
        spb = spb or int(np.clip(-(-len(s) // (8 * n_sms)), 1, 16))
        items, part_ptr, n_blocks = team_parts(
            s, tile, win, np.arange(len(s)) // spb, teams)
    else:
        # blocks within one window each: about spb slabs a block, or one
        # block an SM shared among the windows
        items, part_ptr, n_blocks = window_cut(s, tile, win, teams, n_sms,
                                               spb)
    dev = packed.vals.device
    return SlabWalk(items=torch.from_numpy(items).to(dev),
                    part_ptr=torch.from_numpy(part_ptr).to(dev),
                    n_blocks=n_blocks, teams=teams)


_WALKS: dict = {}


def slab_walk(packed: DualGather, step: int = WALK_STEP,
              spb: int = 0) -> SlabWalk:
    """``_slab_walk_build`` of the pack at ``step`` and ``spb`` (slabs a
    block, 0: the default), built once a pack and state of its values (an
    in-place write into ``vals`` builds it anew)."""
    walks = cached_on(_WALKS, packed, lambda _: {},
                      values_version(packed.vals))
    key = (step, spb)
    if key not in walks:
        walks[key] = _slab_walk_build(packed, step, spb)
    return walks[key]


def slab_walk_plain(packed: DualGather, X: torch.Tensor,
                    step: int = WALK_STEP) -> torch.Tensor:
    """The kernel's sum read off its walk on any device: every item's
    cells times X's rows (a two-window slab's cell in the pair's first or
    second window by idxA bit 3), added into the item's tile; the pooled
    tail left out.  Equal to the body of ``spmm_dualgather_reference``
    wherever X is finite."""
    walk = slab_walk(packed, step)
    s, tile, word, _ = walk.items.long().T
    rows, cols = packed.shape
    k = X.shape[1]
    dev = X.device
    n_win = max(packed.n_win, int((word & 0xFFFF).max()) + 1 if len(s) else 1,
                int((word >> 16).max()) + 1 if len(s) else 1)
    Xp = torch.zeros((n_win * _W, k), dtype=torch.float32, device=dev)
    Xp[:cols] = X
    y = torch.zeros((rows + 1, k), dtype=torch.float32, device=dev)
    iB_all = packed.idxB.reshape(-1, 8, _LANES)
    vals_all = packed.vals.reshape(-1, 8, _LANES)
    lane = torch.arange(_LANES, device=dev)
    for i0 in range(0, len(s), _ITEM_CHUNK):
        sl = slice(i0, i0 + _ITEM_CHUNK)
        si = s[sl]
        iB = iB_all[si].long() & 127
        ch = torch.gather(_idxA_slabs(packed)[si], 2, iB)
        w = word[sl, None, None]
        if packed.two_win:
            w = torch.where(ch >= 8, w >> 16, w & 0xFFFF)
        col = w * _W + (ch & 7) * _LANES + iB
        row = (tile[sl, None, None] * _LANES + lane).expand_as(col)
        prod = vals_all[si].float()[..., None] * Xp[col]
        y.index_add_(0, row.clamp(max=rows).reshape(-1), prod.reshape(-1, k))
    return y[:rows]


_WALK_ARGTYPES = (
    ctypes.c_void_p,  # idxA int8
    ctypes.c_void_p,  # idxB int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # items (n_items, 4) int32
    ctypes.c_void_p,  # part_ptr int32
    ctypes.c_int,  # blocks
    ctypes.c_void_p,  # X (cols, k) fp32
    ctypes.c_void_p,  # Y (rows, k) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # k
    ctypes.c_int,  # step
    ctypes.c_int,  # bf16 values
    ctypes.c_int,  # nibble-packed idxA
    ctypes.c_int,  # two windows a slab
    ctypes.c_void_p,  # stream
)


def _launch_walk(packed: DualGather, X: torch.Tensor, Y: torch.Tensor,
                 step: int, spb: int) -> None:
    """The walk: ``Y += A @ X`` (Y zeroed by the caller); counted as
    ``spmm_dualgather`` on a k_tiles = 1 pack (row 14), else
    ``spmm_dualgather_sb`` (row 13)."""
    n_groups, group = packed.idxB.shape[0], packed.group
    planes = (packed.idxA, packed.idxB, packed.vals)
    if not all(t.device == X.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in planes + (X, Y)):
        raise ValueError("spmm_dualgather: the pack, X and Y must be "
                         "contiguous and 16-byte aligned on one CUDA device")
    ga = group // 2 if packed.nibble else group
    if (packed.idxA.dtype != torch.int8 or packed.idxB.dtype != torch.int8
            or packed.idxB.shape != (n_groups, group * 8, _LANES)
            or packed.vals.shape != packed.idxB.shape
            or packed.idxA.shape != (n_groups, ga * 8, _LANES)
            or packed.slab_win.numel() != n_groups * group
            or (packed.k_tiles == 1 and (packed.nibble or packed.two_win))
            or (packed.nibble and group % 2)):
        raise ValueError("spmm_dualgather: inconsistent pack planes")
    if step not in STEPS:
        raise ValueError(f"spmm_dualgather: step must be one of {STEPS}")
    rows, cols = packed.shape
    k = X.shape[1]
    walk = slab_walk(packed, step, spb)
    if rows == 0 or cols == 0 or k == 0 or walk.n_blocks == 0:
        return
    fn = _build.load("spmm_dualgather", _WALK_ARGTYPES,
                     "spmm_dualgather_walk")
    with torch.cuda.device(X.device):
        err = fn(packed.idxA.data_ptr(), packed.idxB.data_ptr(),
                 packed.vals.data_ptr(), walk.items.data_ptr(),
                 walk.part_ptr.data_ptr(), walk.n_blocks, X.data_ptr(),
                 Y.data_ptr(), rows, cols, k, step,
                 int(packed.vals.dtype == torch.bfloat16),
                 int(packed.nibble), int(packed.two_win),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_dualgather: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["spmm_dualgather"
                         + ("_sb" if packed.k_tiles > 1 else "")] += 1


def _spmm_dualgather_cuda(packed: DualGather, X: torch.Tensor, *,
                          step: int = 0, spb: int = 0) -> torch.Tensor:
    """The kernel on the card.  ``step`` (1-3, 0 the default
    ``WALK_STEP``) and ``spb`` (slabs a block, 0 the walk's choice) pick
    the walk's variant, for measurements only."""
    _check(packed, X)
    if not X.is_cuda:
        raise ValueError("spmm_dualgather: X must lie on the pack's CUDA "
                         "device")
    Y = torch.zeros((packed.shape[0], X.shape[1]), dtype=torch.float32,
                    device=X.device)
    X = X.contiguous()
    if X.data_ptr() % 16:
        X = X.clone()  # a fresh allocation: the window is staged by 16 bytes
    _launch_walk(packed, X, Y, step or WALK_STEP, spb)
    if packed.tail is not None:
        launch_pooled(packed.tail, X, Y)
    return Y


def _spmm_dg_forward(packed: DualGather, X: torch.Tensor) -> torch.Tensor:
    if X.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmm_dualgather_reference(packed, X)
    return _spmm_dualgather_cuda(packed, X)


class _SpmmDualGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, tail_vals, X):
        # ``vals`` and ``tail_vals`` are the body's and the tail's values,
        # passed so autograd tracks them
        ctx.packed = packed
        ctx.save_for_backward(X)
        return _spmm_dg_forward(packed, X)

    @staticmethod
    def backward(ctx, G):
        packed = ctx.packed
        (X,) = ctx.saved_tensors
        rows, cols = packed.shape
        k = X.shape[1]
        Gpad = torch.cat([G.float(), G.new_zeros((1, k), dtype=torch.float32)])
        Xpad = torch.zeros((packed.n_win * _W, k), dtype=torch.float32,
                           device=X.device)
        Xpad[:cols] = X
        gX = out = None
        if ctx.needs_input_grad[3]:
            # padding slots past ``cols`` land in the spare row (dropped)
            out = torch.zeros((cols + 1, k), dtype=torch.float32,
                              device=X.device)
        grads = [None, None]
        parts = [(packed, _slot_row_col, 1)]
        if packed.tail is not None:
            parts.append((packed.tail, _slot_row_col_pooled, 2))
        for part, coords, slot in parts:
            row, col = coords(part)  # (n_groups, group*8, 128)
            Grow = Gpad[row.clamp(max=rows)]  # (n_groups, GH, 128, k)
            if out is not None:
                gv = Grow * part.vals.float()[..., None]
                out.index_add_(0, col.clamp(max=cols).reshape(-1),
                               gv.reshape(-1, k))
            if ctx.needs_input_grad[slot]:
                grads[slot - 1] = _dvals(part, (Xpad[col] * Grow).sum(dim=-1))
        if out is not None:
            gX = out[:cols].to(X.dtype)
        return None, grads[0], grads[1], gX


def spmm_dualgather(packed: DualGather, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over a dual-gather pack (fp32 result), the pooled tail
    included; X is (cols, k) fp32.  Differentiable in X and in the values
    of the body and the tail."""
    return _SpmmDualGather.apply(packed, packed.vals, _tail_vals(packed), X)
