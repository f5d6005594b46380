"""Octet-slab SpMV: the packer and ``csrc/spmv_octet.cu``.

Twin of ``sparsematrix_tpu/kernels/spmv_octet.py``, the low-degree layout.
An octet slab spans EIGHT consecutive 128-row tiles: cell (u, l) is row
``octet*1024 + u*128 + l``.  Its columns come from one 1024-column window
through three chained gathers (``csrc/clos3.cuh``)::

    t1[c, m] = xw[c, POS[c, m]]     (pos plane)
    t2[u, m] = t1[CH[u, m], m]      (chunk plane)
    y [u, l] = t2[u, RT[u, l]]      (lane route)

Each entry (u, l) ← window cell (c, p) needs a middle slot m with
CH[u, m] = c and POS[c, m] = p; m is free per entry, so the packer
assigns slots, and entries sharing a (u, l) cell go one slab deeper.
Slabs are grouped ``group`` at a time by superblocks of ``k_octets``
octets; with ``trim_group`` the remainder slabs of every superblock run
form a second section (``rem``) at the finer granularity.

The host packer is the JAX packer's algorithm line for line, so every
plane comes out ``np.array_equal`` to it: the native slot assigner
(``native/octet.cc``, built by ``g++`` at first use) or, where no compiler
is found, the numpy repair (other, valid planes, equal to the JAX numpy
path's).  Like the JAX packer it ignores a ``trim_group`` ≥ ``group``.

``spmv_octet(packed, x)`` runs ``spmv_octet_reference`` when all its
inputs lie on the CPU, and otherwise launches ``csrc/spmv_octet.cu`` once
over both sections, along a walk built once a pack (``octet_walk``: the
slabs holding a value, octet by octet; ``octet_ranges``: whole octets cut
into ranges of about equal work, a block each), or raises.  The multi-RHS
product ``spmm_octet(packed, X)`` does the same with
``spmm_octet_reference`` and ``csrc/spmm_octet.cu`` (a second launch for
``rem``).  Both are differentiable in their right-hand side
and in the values of both sections (the JAX wrappers' custom VJPs,
``spmv_octet.py:526-571`` and ``:698-735``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.base import (cached_on, sparse_container, static_field,
                            values_version)
from ..formats.csr import CSR
from . import _build
from .spmv_dualgather import _SMEM_PREFETCH_BUDGET

__all__ = ["Octet", "pack_octet", "spmv_octet", "spmv_octet_reference",
           "spmm_octet", "spmm_octet_reference"]

_LANES = 128
_ROWS_PER_OCTET = 1024
_W = 1024  # window width (8 chunks × 128)


@sparse_container
@dataclasses.dataclass(frozen=True)
class Octet:
    pos: torch.Tensor  # (n_groups, group*8, 128) int8: POS per (chunk, m)
    chk: torch.Tensor  # (n_groups, group*8, 128) int8: CH per (u, m)
    route: torch.Tensor  # (n_groups, group*8, 128) int8: m per (u, l)
    vals: torch.Tensor  # (n_groups, group*8, 128) fp32 or bf16
    group_super: torch.Tensor  # (n_groups,) int32: superblock id, sorted
    slab_win: torch.Tensor  # (n_groups, group) int32
    slab_oloc: torch.Tensor  # (n_groups, group) int32: octet within super
    commit: torch.Tensor  # (n_groups,) int32: last group of its super
    shape: Tuple[int, int] = static_field()
    n_octets: int = static_field()
    n_win: int = static_field()
    group: int = static_field()
    k_octets: int = static_field()
    nnz: int = static_field()
    # the JAX kernel's call boundaries under its prefetch budget, kept so
    # the planes stay equal; one launch covers every group
    splits: Tuple[int, ...] = dataclasses.field(
        default=(), metadata={"static": True})
    # the trim section: the remainder slabs of every superblock run,
    # grouped finer (its own Octet, rem None)
    rem: Optional["Octet"] = None

    @property
    def fill_rate(self) -> float:
        sz = self.vals.numel() + (self.rem.vals.numel()
                                  if self.rem is not None else 0)
        return self.nnz / max(sz, 1)

    @property
    def n_slabs(self) -> int:
        return self.route.shape[0] * self.group


# ---------------------------------------------------------------------------
# host packer (the JAX packer's algorithm)
# ---------------------------------------------------------------------------

_ASSIGN_ARGTYPES = (
    ctypes.c_void_p,  # ow (n,) int64
    ctypes.c_void_p,  # u (n,) int32
    ctypes.c_void_p,  # lane (n,) int32
    ctypes.c_void_p,  # chunk (n,) int32
    ctypes.c_void_p,  # pos (n,) int32
    ctypes.c_long,  # n
    ctypes.c_long,  # n_ow
    ctypes.c_void_p,  # out_d (n,) int32
    ctypes.c_void_p,  # out_m (n,) int8
)


def _assign_native(ow, u, chunk, pos, lane):
    """Native one-pass depth + slot assignment (``native/octet.cc``);
    (d, m), or None where no ``g++`` is found."""
    fn = _build.load_host("octet", "smtpu_assign_octet", _ASSIGN_ARGTYPES)
    if fn is None or not len(ow):
        return None
    ow_c = np.ascontiguousarray(ow, np.int64)
    u_c = np.ascontiguousarray(u, np.int32)
    l_c = np.ascontiguousarray(lane, np.int32)
    c_c = np.ascontiguousarray(chunk, np.int32)
    p_c = np.ascontiguousarray(pos, np.int32)
    out_d = np.empty(len(ow), np.int32)
    out_m = np.empty(len(ow), np.int8)
    rc = fn(ow_c.ctypes.data, u_c.ctypes.data, l_c.ctypes.data,
            c_c.ctypes.data, p_c.ctypes.data, len(ow), int(ow_c.max()) + 1,
            out_d.ctypes.data, out_m.ctypes.data)
    if rc < 0:
        return None
    return out_d.astype(np.int64), out_m.astype(np.int64)


def _assign_slots(ow, d, u, chunk, pos, lane, n_rounds=200):
    """Per-entry middle slot ``m``: distinct within (slab, u), and the
    (slab, chunk, m) pos-plane cell must agree on ``pos``.  Direct-address
    repair over flat occupancy tables; losers re-propose rotated slots.
    Returns (m, overflow): entries that could not place after
    ``n_rounds`` must go one depth deeper."""
    nnz = len(ow)
    slab_key, slab_of = np.unique(
        np.stack([ow, d]), axis=1, return_inverse=True)
    slab_of = slab_of.reshape(-1)
    n_slabs = slab_key.shape[1]
    cellU = np.zeros(n_slabs * 8 * _LANES, np.uint8)
    posT = np.zeros(n_slabs * 8 * _LANES, np.int16)  # pos+1, 0 = empty
    # seed each entry at its lane: distinct within (slab, u)
    m = lane.astype(np.int64).copy()
    placed = np.zeros(nnz, bool)
    pending = np.arange(nnz)
    rng_off = 0
    for _rnd in range(n_rounds):
        if len(pending) == 0:
            break
        cand = (m[pending] + rng_off) % _LANES
        ku = slab_of[pending] * (8 * _LANES) + u[pending] * _LANES + cand
        kc = (slab_of[pending] * (8 * _LANES)
              + chunk[pending] * _LANES + cand)
        ok = (cellU[ku] == 0) & (
            (posT[kc] == 0) | (posT[kc] == pos[pending] + 1))
        idx = pending[ok]
        ku_ok, kc_ok = ku[ok], kc[ok]
        cnd_ok = cand[ok]
        # first-by-index winner among same-round collisions on ku
        o1 = np.lexsort((idx, ku_ok))
        k1s = ku_ok[o1]
        w1 = np.concatenate([[True], k1s[1:] != k1s[:-1]])
        keep1 = np.zeros(len(idx), bool)
        keep1[o1] = w1
        sel = keep1
        idx2 = idx[sel]
        if len(idx2) == 0:
            m[pending] = (m[pending] + 1) % _LANES
            rng_off = (rng_off * 5 + 1) % _LANES
            continue
        # among the ku winners, one kc cell must share pos: the first by
        # index leads, same-pos followers stay
        kc2 = kc_ok[sel]
        p2 = pos[idx2]
        o2 = np.lexsort((idx2, kc2))
        k2s, p2s = kc2[o2], p2[o2]
        first2 = np.concatenate([[True], k2s[1:] != k2s[:-1]])
        gseg = np.cumsum(first2) - 1
        lead = p2s[np.flatnonzero(first2)][gseg]
        keep2 = np.zeros(len(idx2), bool)
        keep2[o2] = p2s == lead
        final_idx = idx2[keep2]
        final_m = cnd_ok[sel][keep2]
        m[final_idx] = final_m
        placed[final_idx] = True
        fku = (slab_of[final_idx] * (8 * _LANES)
               + u[final_idx] * _LANES + final_m)
        fkc = (slab_of[final_idx] * (8 * _LANES)
               + chunk[final_idx] * _LANES + final_m)
        cellU[fku] = 1
        posT[fkc] = pos[final_idx] + 1
        pending = pending[~placed[pending]]
        m[pending] = (m[pending] + 1) % _LANES
        rng_off = (rng_off * 5 + 1) % _LANES
    return m, ~placed


def pack_octet(csr: CSR, group: int = 8, k_octets: int = 32,
               dtype=None, trim_group: int | None = None,
               device=None) -> Octet:
    """Pack a CSR for the octet kernel, on ``device`` (default: the
    CSR's).  Right for low row degrees (≲ 2-3 a window).

    ``trim_group``: when set below ``group``, the remainder slabs of each
    superblock run are regrouped at this granularity in a second section
    (``Octet.rem``).  ``dtype=torch.bfloat16`` stores the values in
    bf16."""
    dev = csr.device if device is None else torch.device(device)
    sp = csr.to_scipy().tocsr(copy=True)
    sp.sum_duplicates()
    sp.sort_indices()
    rows, cols = sp.shape
    r = np.repeat(np.arange(rows), np.diff(sp.indptr)).astype(np.int64)
    c = sp.indices.astype(np.int64)
    v = sp.data
    nnz = len(r)
    n_octets = max(-(-rows // _ROWS_PER_OCTET), 1)
    n_win = max(-(-cols // _W), 1)
    vnp = v.dtype  # numpy has no bf16: ``dtype`` is applied to the tensor

    def vals_tensor(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    if nnz == 0:
        z3 = np.zeros((1, group * 8, _LANES), np.int8)
        return Octet(
            pos=put(z3, torch.int8), chk=put(z3, torch.int8),
            route=put(z3, torch.int8),
            vals=vals_tensor(np.zeros((1, group * 8, _LANES), vnp)),
            group_super=put(np.zeros(1), torch.int32),
            slab_win=put(np.zeros((1, group)), torch.int32),
            slab_oloc=put(np.zeros((1, group)), torch.int32),
            commit=put(np.ones(1), torch.int32),
            shape=(rows, cols), n_octets=n_octets, n_win=n_win,
            group=group, k_octets=k_octets, nnz=0)

    octet = r // _ROWS_PER_OCTET
    u = (r // _LANES) % 8
    lane = r % _LANES
    w = c // _W
    chunk = (c % _W) // _LANES
    pos = c % _LANES
    ow = octet * n_win + w

    # depth: occurrence rank within the (ow, u, l) cell; then slot
    # assignment, bumping unplaceable entries one depth deeper
    native = _assign_native(ow, u, chunk, pos, lane)
    if native is not None:
        d, m = native
    else:
        key_cell = (ow * 8 + u) * _LANES + lane
        order = np.argsort(key_cell, kind="stable")
        base = np.zeros(nnz, np.int64)
        ks = key_cell[order]
        newgrp = np.concatenate([[True], ks[1:] != ks[:-1]])
        gid = np.cumsum(newgrp) - 1
        first_idx = np.zeros(gid[-1] + 1, np.int64)
        first_idx[gid[newgrp]] = np.flatnonzero(newgrp)
        base[order] = np.arange(nnz) - first_idx[gid]
        # bump unit > any cell rank, so stuck entries move to strictly
        # deeper slabs without colliding with a cell-mate's depth
        big = int(base.max()) + 1
        extra = np.zeros(nnz, np.int64)
        for _attempt in range(64):
            d = base + extra
            m, overflow = _assign_slots(ow, d, u, chunk, pos, lane)
            if not overflow.any():
                break
            extra = extra + big * overflow
        else:
            raise RuntimeError("octet slot assignment did not converge")

    # slab ids ordered by (octet, w, d)
    dmax = int(d.max()) + 1
    slab_key = (octet * n_win + w) * dmax + d
    uslab, slab_of = np.unique(slab_key, return_inverse=True)
    slab_of = slab_of.reshape(-1)
    n_slabs = len(uslab)
    s_oct = (uslab // dmax) // n_win
    s_win = (uslab // dmax) % n_win
    s_super = s_oct // k_octets

    # trim: with trim_group set (below group), the remainder slabs of every
    # superblock run form a second section grouped at the finer
    # granularity
    section = np.zeros(n_slabs, np.int8)
    if trim_group and trim_group < group:
        i = 0
        while i < n_slabs:
            j = i
            while j < n_slabs and s_super[j] == s_super[i]:
                j += 1
            full = ((j - i) // group) * group
            section[i + full:j] = 1
            i = j
        if not section.any() or not (section == 0).any():
            section[:] = 0  # nothing to trim / no full group anywhere

    def _group_section(sel, grp):
        """Group the selected slabs (ascending ids) at granularity ``grp``,
        padding each superblock run to a multiple of ``grp``; returns the
        per-slab slot and the group-level arrays."""
        idxs = np.flatnonzero(sel)
        n_sel = len(idxs)
        slot_of = np.full(n_slabs, -1, np.int64)
        n_g = 0
        g_super, g_win, g_oloc = [], [], []
        i = 0
        while i < n_sel:
            j = i
            while j < n_sel and s_super[idxs[j]] == s_super[idxs[i]]:
                j += 1
            for t in range(i, j):
                slot_of[idxs[t]] = ((n_g + (t - i) // grp) * grp
                                    + (t - i) % grp)
            for gg in range(-(-(j - i) // grp)):
                lo = i + gg * grp
                hi = min(lo + grp, j)
                g_super.append(int(s_super[idxs[i]]))
                wrow = np.zeros(grp, np.int64)
                orow = np.zeros(grp, np.int64)
                wrow[: hi - lo] = s_win[idxs[lo:hi]]
                orow[: hi - lo] = s_oct[idxs[lo:hi]] % k_octets
                if hi - lo < grp:  # padding slabs repeat the last
                    wrow[hi - lo:] = s_win[idxs[hi - 1]]
                    orow[hi - lo:] = s_oct[idxs[hi - 1]] % k_octets
                g_win.append(wrow)
                g_oloc.append(orow)
                n_g += 1
            i = j
        group_super = np.asarray(g_super, np.int64)
        commit = np.zeros(n_g, np.int64)
        commit[np.concatenate([group_super[1:] != group_super[:-1],
                               [True]])] = 1
        return (slot_of, group_super, np.stack(g_win), np.stack(g_oloc),
                commit, n_g)

    def _build_section(sel, grp, total_nnz, rem):
        slot_of_slab, group_super, slab_win, slab_oloc, commit, n_g = \
            _group_section(sel, grp)
        posP = np.zeros((n_g, grp * 8, _LANES), np.int8)
        chkP = np.zeros((n_g, grp * 8, _LANES), np.int8)
        rteP = np.zeros((n_g, grp * 8, _LANES), np.int8)
        vals = np.zeros((n_g, grp * 8, _LANES), vnp)
        emask = sel[slab_of]
        slot = slot_of_slab[slab_of[emask]]
        gi, bi = slot // grp, slot % grp
        posP[gi, bi * 8 + chunk[emask], m[emask]] = \
            pos[emask].astype(np.int8)
        chkP[gi, bi * 8 + u[emask], m[emask]] = \
            chunk[emask].astype(np.int8)
        rteP[gi, bi * 8 + u[emask], lane[emask]] = m[emask].astype(np.int8)
        vals[gi, bi * 8 + u[emask], lane[emask]] = v[emask].astype(vnp)

        # the JAX kernel's call boundaries (kept for plane equality)
        per_group_scalars = 2 * grp + 2
        max_groups = max(1,
                         _SMEM_PREFETCH_BUDGET // (4 * per_group_scalars))
        splits = []
        if n_g > max_groups:
            start = 0
            while n_g - start > max_groups:
                cut = start + max_groups
                while cut > start and \
                        group_super[cut] == group_super[cut - 1]:
                    cut -= 1
                if cut == start:
                    raise ValueError(
                        "octet superblock exceeds the SMEM prefetch "
                        "budget; use a smaller k_octets (fewer octets "
                        "per accumulator)")
                splits.append(cut)
                start = cut
        return Octet(
            pos=put(posP, torch.int8), chk=put(chkP, torch.int8),
            route=put(rteP, torch.int8), vals=vals_tensor(vals),
            group_super=put(group_super, torch.int32),
            slab_win=put(slab_win, torch.int32),
            slab_oloc=put(slab_oloc, torch.int32),
            commit=put(commit, torch.int32),
            shape=(rows, cols), n_octets=n_octets, n_win=n_win,
            group=grp, k_octets=k_octets, nnz=int(total_nnz),
            splits=tuple(int(s) for s in splits), rem=rem)

    if section.any():
        rem = _build_section(section == 1, trim_group,
                             int((section[slab_of] == 1).sum()), None)
        return _build_section(section == 0, group, nnz, rem)
    return _build_section(section == 0, group, nnz, None)


# ---------------------------------------------------------------------------
# plain version and slot coordinates
# ---------------------------------------------------------------------------

def _slot_row_col(packed: Octet):
    """Per-cell (row, col), each (n_groups, group, 8, 128) int64."""
    n_groups, group = packed.route.shape[0], packed.group
    dev = packed.route.device
    rt = packed.route.reshape(n_groups, group, 8, _LANES).long() & 127
    ck = packed.chk.reshape(n_groups, group, 8, _LANES).long() & 7
    pp = packed.pos.reshape(n_groups, group, 8 * _LANES).long() & 127
    ch = torch.gather(ck, 3, rt)  # chunk per (u, l)
    # pos per (u, l) = POS[ch[u, l], rt[u, l]]
    idx = (ch * _LANES + rt).reshape(n_groups, group, 8 * _LANES)
    pUL = torch.gather(pp, 2, idx).reshape(n_groups, group, 8, _LANES)
    win = packed.slab_win.long()[:, :, None, None]
    col = win * _W + ch * _LANES + pUL
    octt = (packed.group_super.long()[:, None] * packed.k_octets
            + packed.slab_oloc.long())[:, :, None, None]
    sub = torch.arange(8, device=dev)[None, None, :, None]
    lane = torch.arange(_LANES, device=dev)[None, None, None, :]
    row = octt * _ROWS_PER_OCTET + sub * _LANES + lane
    return row.expand_as(col), col


def _check(packed: Octet, x: torch.Tensor) -> None:
    if packed.vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("spmv_octet: values must be fp32 or bf16, not "
                         f"{packed.vals.dtype}")
    cols = packed.shape[1]
    if x.dtype != torch.float32 or x.shape != (cols,):
        raise ValueError(f"spmv_octet: x must be an fp32 vector of length "
                         f"{cols}, not {x.dtype} {tuple(x.shape)}")


def _section_plain(packed: Octet, x: torch.Tensor) -> torch.Tensor:
    rows, cols = packed.shape
    row, col = _slot_row_col(packed)
    xpad = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                       device=x.device)
    xpad[:cols] = x
    prod = packed.vals.reshape(row.shape).float() * xpad[col]
    y = torch.zeros(rows + 1, dtype=torch.float32, device=x.device)
    # rows past ``rows`` (padding cells, the ragged last octet) land in
    # the spare slot and are dropped
    y.index_add_(0, row.clamp(max=rows).reshape(-1), prod.reshape(-1))
    return y[:rows]


def spmv_octet_reference(packed: Octet, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``y = A @ x``: fp32 x, fp32 or bf16 values, fp32
    accumulation and result, ``rem`` included."""
    _check(packed, x)
    y = _section_plain(packed, x)
    if packed.rem is not None:
        y = y + spmv_octet_reference(packed.rem, x)
    return y


_MM_ARGTYPES = (
    ctypes.c_void_p,  # pos int8
    ctypes.c_void_p,  # chk int8
    ctypes.c_void_p,  # route int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # group_super (n_groups,) int32
    ctypes.c_void_p,  # slab_win (n_slabs,) int32
    ctypes.c_void_p,  # slab_oloc (n_slabs,) int32
    ctypes.c_void_p,  # X (cols, k) fp32
    ctypes.c_void_p,  # Y (rows, k) fp32, zeroed
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # k
    ctypes.c_longlong,  # n_slabs
    ctypes.c_int,  # group
    ctypes.c_int,  # k_octets
    ctypes.c_int,  # bf16 values
    ctypes.c_void_p,  # stream
)


def _launch_mm(packed: Octet, X: torch.Tensor, Y: torch.Tensor) -> None:
    """``Y += A @ X`` over one section on the card by
    ``csrc/spmm_octet.cu`` (X a (cols, k) matrix)."""
    planes = _planes(packed, "spmm_octet")
    if X.device != packed.vals.device:
        raise ValueError("spmm_octet: the pack and X must be contiguous on "
                         "one CUDA device")
    rows, cols = packed.shape
    fn = _build.load("spmm_octet", _MM_ARGTYPES)
    with torch.cuda.device(X.device):
        err = fn(*(t.data_ptr() for t in planes), X.data_ptr(), Y.data_ptr(),
                 rows, cols, X.shape[1], packed.n_slabs, packed.group,
                 packed.k_octets, int(packed.vals.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_octet: launch failed with CUDA error {err}")
    _build.launch_counts["spmm_octet"] += 1


def _planes(packed: Octet, source: str):
    """One section's seven tensors, checked: contiguous on one device,
    their types and shapes consistent."""
    planes = (packed.pos, packed.chk, packed.route, packed.vals,
              packed.group_super, packed.slab_win, packed.slab_oloc)
    dev = packed.vals.device
    if not all(t.device == dev and t.is_contiguous() for t in planes):
        raise ValueError(f"{source}: the pack and x must be contiguous on "
                         "one CUDA device")
    n_groups, group = packed.route.shape[0], packed.group
    if (any(t.dtype != torch.int8 for t in planes[:3])
            or any(t.dtype != torch.int32 for t in planes[4:])
            or any(t.shape != (n_groups, group * 8, _LANES)
                   for t in planes[:4])
            or packed.group_super.shape != (n_groups,)
            or packed.slab_win.numel() != n_groups * group
            or packed.slab_oloc.numel() != n_groups * group):
        raise ValueError(f"{source}: inconsistent pack planes")
    return planes


# ---------------------------------------------------------------------------
# the card walk of the SpMV (csrc/spmv_octet.cu): its side structures,
# built once a pack
# ---------------------------------------------------------------------------

def _sections(packed: Octet):
    return [packed] + ([packed.rem] if packed.rem is not None else [])


def _vals_version(packed: Octet):
    return values_version(*(sec.vals for sec in _sections(packed)))


def _walk_build(packed: Octet):
    """(items, oct_ptr) on the pack's device.  ``items`` (n_items, 2)
    int32 lists (slab id, window) of every slab of both sections that
    holds a nonzero value, octet by octet, the main section's before the
    trim section's, each in slab order; a trim slab's id is the main
    section's slab count plus its own.  ``oct_ptr`` (n_octets + 1,) int32
    gives each octet's items.  A group's padding slabs hold only zeros and
    are left out (so is a slab of explicit zeros: it adds nothing); the
    value gradient keeps zero cells zero, so the list stays whole while
    the values train."""
    octs, ids, wins = [], [], []
    base = 0
    for sec in _sections(packed):
        n = sec.n_slabs
        nz = (sec.vals.reshape(n, _W) != 0).any(1).cpu().numpy()
        s = np.flatnonzero(nz)
        sup = sec.group_super.cpu().numpy().astype(np.int64)
        octs.append(sup[s // sec.group] * sec.k_octets
                    + sec.slab_oloc.reshape(-1).cpu().numpy()[s])
        ids.append(s + base)
        wins.append(sec.slab_win.reshape(-1).cpu().numpy()[s])
        base += n
    octet = np.concatenate(octs)
    if octet.size and octet.max() >= packed.n_octets:
        raise ValueError("spmv_octet: a slab's octet lies past the matrix")
    order = np.argsort(octet, kind="stable")
    items = np.stack([np.concatenate(ids)[order],
                      np.concatenate(wins)[order]], axis=1)
    oct_ptr = np.r_[0, np.cumsum(np.bincount(octet,
                                             minlength=packed.n_octets))]
    dev = packed.vals.device
    return (torch.from_numpy(items.astype(np.int32)).to(dev),
            torch.from_numpy(oct_ptr.astype(np.int32)).to(dev))


def octet_ranges(oct_ptr: np.ndarray, spr: int) -> np.ndarray:
    """(n_ranges + 1,) int64: the octets cut into contiguous ranges of
    about ``spr`` walked slabs each, every octet whole.  An octet weighs
    two units a slab and one for its store (an octet with no slab still
    writes its 1024 zeros); the cuts go to the octet boundaries nearest
    equal shares of the weight."""
    n_oct = oct_ptr.size - 1
    n_items = int(oct_ptr[-1])
    n_ranges = min(max(1, -(-n_items // max(spr, 1))), n_oct)
    cost = np.cumsum(2 * np.diff(oct_ptr) + 1)  # through each octet
    want = np.arange(1, n_ranges) * (cost[-1] / n_ranges)
    o = np.searchsorted(cost, want)  # the octet that crosses each share
    before = np.where(o > 0, cost[np.maximum(o - 1, 0)], 0)
    cut = np.where(want - before <= cost[o] - want, o, o + 1)
    return np.unique(np.r_[0, np.clip(cut, 1, n_oct - 1), n_oct])


_WALKS: dict = {}


def octet_walk(packed: Octet):
    """The pack's ``_walk_build``, built once per pack and state of its
    sections' values (an in-place write into ``vals`` builds it anew)."""
    return cached_on(_WALKS, packed, _walk_build, _vals_version(packed))


_BLOCKS: dict = {}


def resident_blocks(device: torch.device, stages: int, groups: int,
                    bf16: bool) -> int:
    """The blocks of the walk kernel the card holds at once, at ``stages``
    slab stages (0: the kernel's default) and ``groups`` slab groups a
    block, asked once a card and setting."""
    key = (device.index, stages, groups, bf16)
    if key not in _BLOCKS:
        fn = _build.load("spmv_octet", (ctypes.c_int,) * 3,
                         "spmv_octet_blocks")
        with torch.cuda.device(device):
            n = fn(stages, groups, int(bf16))
        if n <= 0:
            raise RuntimeError("spmv_octet: the card's occupancy query "
                               "failed")
        _BLOCKS[key] = n
    return _BLOCKS[key]


def octet_default_groups(n_items: int, n_octets: int, resident: int) -> int:
    """The walk's default slab groups a block: 1 where the octets alone
    fill the ``resident`` one-group blocks the card holds; else as many
    (2 or 4) as the octets' mean slab count asks, so that a pack of few
    octets of many slabs does not walk each octet as one chain."""
    if n_octets >= resident:
        return 1
    mean = -(-n_items // max(n_octets, 1))
    return 1 if mean <= 1 else 2 if mean <= 2 else 4


def octet_default_spr(n_items: int, resident: int) -> int:
    """The walk's default slabs a range: the walked slabs over one wave of
    the ``resident`` blocks the card holds (a small pack then takes an
    octet a block)."""
    return max(1, -(-n_items // max(resident, 1)))


def octet_knobs(packed: Octet, spr: int = 0, stages: int = 0,
                groups: int = 0):
    """(spr, stages, groups) of a launch on the card, each 0 resolved to
    its default: ``octet_default_groups``, two stages a group, and
    ``octet_default_spr`` over the blocks the card then holds."""
    items, _ = octet_walk(packed)
    dev = packed.vals.device
    bf16 = packed.vals.dtype == torch.bfloat16
    if groups == 0:
        groups = octet_default_groups(items.shape[0], packed.n_octets,
                                      resident_blocks(dev, 2, 1, bf16))
    stages = stages or 2 * groups
    if spr == 0:
        spr = octet_default_spr(items.shape[0],
                                resident_blocks(dev, stages, groups, bf16))
    return spr, stages, groups


def _launch_build(packed: Octet, spr: int, stages: int, groups: int):
    """What a launch on the pack passes besides x, y and the stream, at one
    setting of the knobs: (the arguments before x, those after y, the side
    tensors the pointers name)."""
    sections = _sections(packed)
    bf16 = packed.vals.dtype == torch.bfloat16
    planes = []
    for sec in sections:
        p = _planes(sec, "spmv_octet")
        if sec.vals.dtype != packed.vals.dtype or sec.shape != packed.shape:
            raise ValueError("spmv_octet: the sections differ in value type "
                             "or shape")
        if any(t.data_ptr() % 16 for t in p[:4]):
            raise ValueError("spmv_octet: the planes must be 16-byte "
                             "aligned for the bulk copies")
        planes.append(p[:4])
    rem = planes[1] if len(planes) > 1 else (None,) * 4
    items, oct_ptr = octet_walk(packed)
    spr, stages, groups = octet_knobs(packed, spr, stages, groups)
    dev = packed.vals.device
    ranges = torch.from_numpy(octet_ranges(oct_ptr.cpu().numpy(), spr)
                              .astype(np.int32)).to(dev)
    before = (*(t.data_ptr() for t in planes[0]),
              *(None if t is None else t.data_ptr() for t in rem),
              packed.n_slabs, items.data_ptr(), oct_ptr.data_ptr(),
              ranges.data_ptr(), ranges.numel() - 1)
    after = (*packed.shape, stages, groups, int(bf16))
    return before, after, (items, oct_ptr, ranges)


_WALK_ARGTYPES = (
    ctypes.c_void_p,  # pos int8
    ctypes.c_void_p,  # chk int8
    ctypes.c_void_p,  # route int8
    ctypes.c_void_p,  # vals fp32 or bf16
    ctypes.c_void_p,  # rem pos, or null
    ctypes.c_void_p,  # rem chk, or null
    ctypes.c_void_p,  # rem route, or null
    ctypes.c_void_p,  # rem vals, or null
    ctypes.c_int,  # the main section's slabs
    ctypes.c_void_p,  # items (n_items, 2) int32
    ctypes.c_void_p,  # oct_ptr (n_octets + 1,) int32
    ctypes.c_void_p,  # range_ptr (n_ranges + 1,) int32
    ctypes.c_int,  # n_ranges
    ctypes.c_void_p,  # x (cols,) fp32
    ctypes.c_void_p,  # y (rows,) fp32, every row written
    ctypes.c_int,  # rows
    ctypes.c_int,  # cols
    ctypes.c_int,  # stages (0: the default)
    ctypes.c_int,  # slab groups a block: 1, 2 or 4
    ctypes.c_int,  # bf16 values
    ctypes.c_int,  # copies only (an ablation: zeros stored)
    ctypes.c_void_p,  # stream
)

_LAUNCHES: dict = {}


def _spmv_octet_cuda(packed: Octet, x: torch.Tensor, *, spr: int = 0,
                     stages: int = 0, groups: int = 0,
                     copies_only: bool = False) -> torch.Tensor:
    """The walk kernel, one launch over both sections.  ``spr`` (walked
    slabs a range; 0: ``octet_default_spr``), ``stages`` (slab stages a
    block, at least ``groups``; 0: two a group) and ``groups`` (slab
    groups a block, 1, 2 or 4; 0: ``octet_default_groups``) are knobs for
    measurements only; each gives A @ x.  ``copies_only`` is an ablation
    (the slabs' copies and y's stores alone): its result is zeros, not
    the product.  The launch's arguments are built once a pack and
    setting, so a call makes one lookup."""
    _check(packed, x)
    if not x.is_cuda or x.device != packed.vals.device:
        raise ValueError(f"spmv_octet: x must lie on the pack's CUDA device, "
                         f"not {x.device}")
    rows, cols = packed.shape
    if rows == 0 or cols == 0:
        return torch.zeros(rows, dtype=torch.float32, device=x.device)
    launches = cached_on(_LAUNCHES, packed, lambda _: {},
                         _vals_version(packed))
    key = (spr, stages, groups)
    entry = launches.get(key)
    if entry is None:
        entry = launches[key] = _launch_build(packed, spr, stages, groups)
    before, after, _ = entry
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = _build.load("spmv_octet", _WALK_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(*before, x.contiguous().data_ptr(), y.data_ptr(), *after,
                 int(copies_only), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_octet: launch failed with CUDA error {err}")
    _build.launch_counts["spmv_octet"] += 1
    return y


def _octet_forward(packed: Octet, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmv_octet_reference(packed, x)
    return _spmv_octet_cuda(packed, x)


def _section_grads(packed: Octet, x, g, want_x, want_vals):
    """(gx, dvals) of one section: the scatter ``A^T g`` and the masked
    value cotangent ``x[col] * g[row]``."""
    rows, cols = packed.shape
    row, col = _slot_row_col(packed)
    gpad = torch.cat([g.float(), g.new_zeros(1, dtype=torch.float32)])
    row_cl = row.clamp(max=rows)  # padding cells (vals 0) → the sink
    vals4 = packed.vals.reshape(row.shape)
    gx = dvals = None
    if want_x:
        gx = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                         device=g.device)
        gx.index_add_(0, col.reshape(-1),
                      (gpad[row_cl] * vals4.float()).reshape(-1))
        gx = gx[:cols]
    if want_vals:
        xpad = torch.zeros(packed.n_win * _W, dtype=torch.float32,
                           device=x.device)
        xpad[:cols] = x
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        dvals = torch.where(vals4 != 0, xpad[col] * gpad[row_cl], zero)
        dvals = dvals.to(packed.vals.dtype).reshape(packed.vals.shape)
    return gx, dvals


class _SpmvOctet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, rem_vals, x):
        # ``vals`` and ``rem_vals`` are the sections' values, passed so
        # autograd tracks them
        ctx.packed = packed
        ctx.save_for_backward(x)
        return _octet_forward(packed, x)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        (x,) = ctx.saved_tensors
        want_x = ctx.needs_input_grad[3]
        gx, dvals = _section_grads(packed, x, g, want_x,
                                   ctx.needs_input_grad[1])
        drem = None
        if packed.rem is not None:
            gx_rem, drem = _section_grads(packed.rem, x, g, want_x,
                                          ctx.needs_input_grad[2])
            if want_x:
                gx = gx + gx_rem
        return None, dvals, drem, (gx.to(x.dtype) if want_x else None)


def spmv_octet(packed: Octet, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over an octet pack (fp32 result), differentiable in x
    and in the values of both sections."""
    rem_vals = packed.rem.vals if packed.rem is not None else None
    return _SpmvOctet.apply(packed, packed.vals, rem_vals, x)


# ---------------------------------------------------------------------------
# the multi-RHS product (kernel row 16)
# ---------------------------------------------------------------------------

# cells per step of the plain SpMM: bounds its gathered temporaries
_PLAIN_ELEMS = 1 << 24


def _check_mm(packed: Octet, X: torch.Tensor) -> None:
    if packed.vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("spmm_octet: values must be fp32 or bf16, not "
                         f"{packed.vals.dtype}")
    cols = packed.shape[1]
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != cols:
        raise ValueError(f"spmm_octet: X must be fp32 of shape ({cols}, k), "
                         f"not {X.dtype} {tuple(X.shape)}")


def _section_plain_mm(packed: Octet, X: torch.Tensor) -> torch.Tensor:
    rows, cols = packed.shape
    k = X.shape[1]
    row, col = _slot_row_col(packed)  # (n_groups, group, 8, 128)
    Xpad = torch.zeros((packed.n_win * _W, k), dtype=torch.float32,
                       device=X.device)
    Xpad[:cols] = X
    vals = packed.vals.reshape(row.shape)
    # rows past ``rows`` (padding cells, the ragged last octet) land in
    # the spare row and are dropped
    row = row.clamp(max=rows)
    Y = torch.zeros((rows + 1, k), dtype=torch.float32, device=X.device)
    step = max(1, _PLAIN_ELEMS // (packed.group * _W * k))
    for g0 in range(0, row.shape[0], step):
        sl = slice(g0, g0 + step)
        prod = vals[sl].float()[..., None] * Xpad[col[sl]]
        Y.index_add_(0, row[sl].reshape(-1), prod.reshape(-1, k))
    return Y[:rows]


def spmm_octet_reference(packed: Octet, X: torch.Tensor) -> torch.Tensor:
    """Plain version of ``Y = A @ X`` (the JAX ``_octet_mm_forward``): fp32
    X of shape (cols, k), fp32 or bf16 values, fp32 accumulation and
    result, ``rem`` included."""
    _check_mm(packed, X)
    Y = _section_plain_mm(packed, X)
    if packed.rem is not None:
        Y = Y + spmm_octet_reference(packed.rem, X)
    return Y


def _spmm_octet_cuda(packed: Octet, X: torch.Tensor) -> torch.Tensor:
    _check_mm(packed, X)
    if not X.is_cuda:
        raise ValueError(f"spmm_octet: X must lie on the pack's CUDA device, "
                         f"not {X.device}")
    rows, cols = packed.shape
    Y = torch.zeros((rows, X.shape[1]), dtype=torch.float32, device=X.device)
    if rows == 0 or cols == 0 or X.shape[1] == 0:
        return Y
    X = X.contiguous()
    section = packed
    while section is not None:
        _launch_mm(section, X, Y)
        section = section.rem
    return Y


def _octet_mm_forward(packed: Octet, X: torch.Tensor) -> torch.Tensor:
    if X.device.type == "cpu" and packed.vals.device.type == "cpu":
        return spmm_octet_reference(packed, X)
    return _spmm_octet_cuda(packed, X)


def _section_grads_mm(packed: Octet, X, G, want_x, want_vals):
    """(gX, dvals) of one section (the JAX ``_oct_mm_bwd``): the scatter
    ``A^T G`` and the masked value cotangent ``sum_j X[col, j] G[row, j]``."""
    rows, cols = packed.shape
    k = X.shape[1]
    row, col = _slot_row_col(packed)
    Gpad = torch.cat([G.float(), G.new_zeros((1, k), dtype=torch.float32)])
    Grow = Gpad[row.clamp(max=rows)]  # padding cells (vals 0) → the sink
    vals4 = packed.vals.reshape(row.shape)
    gX = dvals = None
    if want_x:
        gX = torch.zeros((packed.n_win * _W, k), dtype=torch.float32,
                         device=G.device)
        gX.index_add_(0, col.reshape(-1),
                      (Grow * vals4.float()[..., None]).reshape(-1, k))
        gX = gX[:cols]
    if want_vals:
        Xpad = torch.zeros((packed.n_win * _W, k), dtype=torch.float32,
                           device=X.device)
        Xpad[:cols] = X
        zero = torch.zeros((), dtype=torch.float32, device=X.device)
        dvals = torch.where(vals4 != 0, (Xpad[col] * Grow).sum(dim=-1), zero)
        dvals = dvals.to(packed.vals.dtype).reshape(packed.vals.shape)
    return gX, dvals


class _SpmmOctet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, vals, rem_vals, X):
        # ``vals`` and ``rem_vals`` are the sections' values, passed so
        # autograd tracks them
        ctx.packed = packed
        ctx.save_for_backward(X)
        return _octet_mm_forward(packed, X)

    @staticmethod
    def backward(ctx, G):
        packed = ctx.packed
        (X,) = ctx.saved_tensors
        want_x = ctx.needs_input_grad[3]
        gX, dvals = _section_grads_mm(packed, X, G, want_x,
                                      ctx.needs_input_grad[1])
        drem = None
        if packed.rem is not None:
            gX_rem, drem = _section_grads_mm(packed.rem, X, G, want_x,
                                             ctx.needs_input_grad[2])
            if want_x:
                gX = gX + gX_rem
        return None, dvals, drem, (gX.to(X.dtype) if want_x else None)


def spmm_octet(packed: Octet, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over an octet pack (fp32 result); X is (cols, k) fp32.
    Differentiable in X and in the values of both sections."""
    rem_vals = packed.rem.vals if packed.rem is not None else None
    return _SpmmOctet.apply(packed, packed.vals, rem_vals, X)
