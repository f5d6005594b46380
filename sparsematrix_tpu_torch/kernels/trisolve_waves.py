"""Wave triangular solve on host-inverted blocks: the plan and
``csrc/trisolve_waves.cu``.

Twin of ``sparsematrix_tpu/kernels/trisolve_waves.py``.  Rows are cut into
128-row tiles and the diagonal blocks are inverted on the host at plan
time, so the device solve is a short chain of dense products:

  chain mode (tile reach K ≤ 3 — banded factors, Poisson ILU/IC):
      x_t = b_t · A1_t − Σ_{k=1..K} x_{t−k} · A2ᵏ_t
    with A1_t = inv(D_t)ᵀ and A2ᵏ_t = C_{t,k}ᵀ · inv(D_t)ᵀ (D_t = T[t, t],
    C_{t,k} = T[t, t−k]).

  binv mode (general patterns): waves of ``m`` tiles; the (128·m)² wave
  diagonal block is inverted on the host, cross-wave entries are packed
  into row-lane slabs gathered from the solved prefix of x, and the
  commit applies the dense inverse.

The planner is the JAX planner's algorithm, so every plane comes out
``np.array_equal`` to the JAX plan.  An upper system is solved as a lower
one through the index reversal (``_rev_pad``).

``trisolve_waves_apply``/``_apply_mm``/``_solve`` run the plain versions
(``_chain_plain``, ``_binv_plain``, the same programs walked step by step
in torch) when their inputs lie on the CPU, and otherwise launch the
kernels or raise.  Each is differentiable as its JAX twin is: in ``b``
through the transposed plan (``with_transpose=True``), and ``_solve`` in
the matrix values too (``with_grads=True``).
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

__all__ = ["TriWavesPlan", "trisolve_waves_plan", "trisolve_waves_apply",
           "trisolve_waves_apply_mm", "trisolve_waves_solve"]

_LANES = 128
_W = 1024


@sparse_container
@dataclasses.dataclass(frozen=True)
class TriWavesPlan:
    """Host-inverted block program for the wave solve."""

    a1: torch.Tensor  # chain: (n_waves, 1024, 128) per-tile inv(D)^T
    #                   binv: (n_waves, m*128, m*128) per-wave inv^T
    a2: Optional[torch.Tensor]  # chain only: (n_waves, K*1024, 128),
    #                   tile-major ([t][k] at row (t*K + k-1)*128)
    s_idx: Optional[torch.Tensor]  # binv: (n_groups, group*8, 128) int8
    vals: Optional[torch.Tensor]  # binv: (n_groups, group*8, 128)
    group_wave: Optional[torch.Tensor]  # binv: (n_groups,) int32
    seg_first: Optional[torch.Tensor]  # binv: (n_groups,) int32 0/1
    commit: Optional[torch.Tensor]  # binv: (n_groups,) int32 0/1
    slab_win: Optional[torch.Tensor]  # binv: (n_groups*group,) int32
    slab_tloc: Optional[torch.Tensor]  # binv: (n_groups*group,) int32
    t_plan: Optional["TriWavesPlan"]  # plan of T^T for the backward pass
    shape: Tuple[int, int] = static_field()
    mode: str = static_field()  # chain | binv
    m: int = static_field()  # tiles a wave
    n_waves: int = static_field()
    S: int = static_field()  # x sublanes (tiles)
    group: int = static_field()
    n_win: int = static_field()
    lower: bool = static_field()
    K: int = dataclasses.field(default=1, metadata={"static": True})
    reversed: bool = dataclasses.field(default=False,
                                       metadata={"static": True})
    # value-gradient pattern, aligned to the planned CSR's capacity-padded
    # ``data`` slots (with_grads=True)
    pat_rows: Optional[torch.Tensor] = None  # (capacity,) int32
    pat_cols: Optional[torch.Tensor] = None  # (capacity,) int32
    pat_scale: Optional[torch.Tensor] = None  # (capacity,) 0/1 fp32


# ---------------------------------------------------------------------------
# host planner (the JAX planner's algorithm)
# ---------------------------------------------------------------------------

def _dense_block(sp, r0, r1, c0, c1):
    out = np.zeros((r1 - r0, c1 - c0), np.float64)
    blk = sp[r0:min(r1, sp.shape[0]), c0:min(c1, sp.shape[1])].tocoo()
    out[blk.row, blk.col] = blk.data
    return out


def _diag_blocks(r, c, v, B, n_blocks):
    """All (B, B) diagonal blocks in one vectorized scatter."""
    out = np.zeros((n_blocks, B, B), np.float64)
    blk = r // B
    sel = (c // B) == blk
    out[blk[sel], r[sel] % B, c[sel] % B] = v[sel]
    return out


def _sub_blocks(r, c, v, B, n_blocks, K):
    """All (B, B) sub-diagonal blocks at reach 1..K, one scatter."""
    out = np.zeros((n_blocks, K, B, B), np.float64)
    bd = r // B - c // B
    sel = (bd >= 1) & (bd <= K)
    out[(r[sel] // B), bd[sel] - 1, r[sel] % B, c[sel] % B] = v[sel]
    return out


def _invert_lower(D, n_real):
    """inv of a dense lower-triangular block; padding rows → identity."""
    import scipy.linalg as sla

    B = D.shape[0]
    for j in range(n_real, B):
        D[j, j] = 1.0
    return sla.solve_triangular(D, np.eye(B), lower=True, check_finite=False)


def _pack_wave_slabs(r, c, v, m, n_tiles, n_win, group):
    """Row-lane slabs for cross-wave entries, segmented per wave: entries
    keyed (wave, tile, window, chunk, lane), occurrence rank d choosing the
    slab.  Every wave gets ≥ 1 (possibly all-zero) group."""
    n_waves = -(-n_tiles // m)
    t = r // _LANES
    lane = r % _LANES
    w = c // _W
    u = (c % _W) // _LANES
    sidx = c % _LANES

    if r.size:
        bucket = (((t * n_win + w) * 8 + u) * _LANES + lane)
        order = np.argsort(bucket, kind="stable")
        bo = bucket[order]
        new = np.empty(len(bo), bool)
        new[0] = True
        new[1:] = bo[1:] != bo[:-1]
        run_start = np.maximum.accumulate(
            np.where(new, np.arange(len(bo)), 0))
        d = np.arange(len(bo)) - run_start
        d_span = int(d.max()) + 1
        slab_key = ((t[order] * n_win + w[order]) * d_span + d)
        uslab, inv = np.unique(slab_key, return_inverse=True)
        slab_t = uslab // (n_win * d_span)
        slab_w = (uslab // d_span) % n_win
        slab_wave = slab_t // m
    else:
        order = np.zeros(0, np.int64)
        uslab = np.zeros(0, np.int64)
        inv = np.zeros(0, np.int64)
        slab_t = np.zeros(0, np.int64)
        slab_w = np.zeros(0, np.int64)
        slab_wave = np.zeros(0, np.int64)

    counts = np.bincount(slab_wave, minlength=n_waves)
    if group is None:
        group = 1
        total = max(counts.sum(), 1)
        for gq in (8, 4, 2):
            padded = np.maximum(-(-counts // gq), 1) * gq
            if (padded.sum() - total) / total <= 0.5:
                group = gq
                break
    wave_groups = np.maximum(-(-counts // group), 1)  # ≥1: commit exists
    padded = wave_groups * group
    wave_offset = np.concatenate([[0], np.cumsum(padded)])
    first_of_wave = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(len(uslab)) - first_of_wave[slab_wave]
    slot = wave_offset[slab_wave] + rank
    total_slots = int(wave_offset[-1])
    n_groups = total_slots // group

    s_idx = np.zeros((total_slots, 8, _LANES), np.int8)
    vals = np.zeros((total_slots, 8, _LANES), v.dtype)
    win_arr = np.zeros(total_slots, np.int32)
    tloc_arr = np.zeros(total_slots, np.int32)
    entry_slot = slot[inv]
    s_idx[entry_slot, u[order], lane[order]] = sidx[order]
    vals[entry_slot, u[order], lane[order]] = v[order]
    win_arr[slot] = slab_w
    tloc_arr[slot] = slab_t % m

    gw = np.repeat(np.arange(n_waves), wave_groups).astype(np.int32)
    pos = np.arange(len(gw)) - np.concatenate(
        [[0], np.cumsum(wave_groups)])[gw]
    sfirst = (pos == 0).astype(np.int32)
    scommit = (pos == wave_groups[gw] - 1).astype(np.int32)
    return dict(
        s_idx=s_idx.reshape(n_groups, group * 8, _LANES),
        vals=vals.reshape(n_groups, group * 8, _LANES),
        group_wave=gw, seg_first=sfirst, commit=scommit,
        slab_win=win_arr, slab_tloc=tloc_arr, group=int(group),
    )


def _put(a, dev, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dt is None else t.to(dev, dt)


def trisolve_waves_plan(A: CSR, lower: bool = True,
                        unit_diagonal: bool = False,
                        mode: str = "auto", m: int = 8,
                        with_transpose: bool = False,
                        with_grads: bool = False,
                        dtype=None, device=None) -> TriWavesPlan:
    """Invert diagonal blocks on the host, pack the rest for the device
    (default: the CSR's device).

    ``mode``: "chain" (every off-diagonal entry within 3 tiles of the
    diagonal), "binv" (general), or "auto" (chain when the tile reach
    allows, else binv).  ``m``: tiles a binv wave.
    ``dtype=torch.bfloat16`` stores the inverse blocks and slab values
    bf16 (fp32 accumulation) — preconditioner grade only.
    """
    dev = A.device if device is None else torch.device(device)
    vdt = torch.float32 if dtype is None else dtype
    sp = A.to_scipy().tocsr()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("trisolve needs a square matrix")
    perm = None
    if not lower:
        # the reversal permutation turns an upper system into a lower one
        perm = np.arange(n - 1, -1, -1)
        sp = sp[perm][:, perm].tocsr()
    sp.sort_indices()
    coo = sp.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data
    if (c > r).any():
        raise ValueError("matrix is not triangular in the requested "
                         "orientation")
    if not unit_diagonal:
        dmask = r == c
        drows = np.zeros(n, bool)
        drows[r[dmask]] = v[dmask] != 0
        if not drows.all():
            bad = int(np.nonzero(~drows)[0][0])
            raise ValueError(f"zero/missing diagonal at row {bad}")

    offd = c < r
    reach = int((r[offd] // _LANES - c[offd] // _LANES).max()) if \
        offd.any() else 0
    if mode == "auto":
        mode = "chain" if reach <= 3 else "binv"
    if mode == "chain" and reach > 3:
        raise ValueError(f"chain mode needs tile reach ≤ 3, got {reach}")
    if mode not in ("chain", "binv"):
        raise ValueError(f"unknown mode {mode!r}")
    K = max(reach, 1)

    n_tiles = max(-(-n // _LANES), 1)
    if unit_diagonal:
        # force stored diagonal entries to 1 and append any missing ones
        dmask = r == c
        v = v.copy()
        v[dmask] = 1.0
        have = np.zeros(n, bool)
        have[r[dmask]] = True
        missing = np.nonzero(~have)[0]
        if missing.size:
            r = np.concatenate([r, missing])
            c = np.concatenate([c, missing])
            v = np.concatenate([v, np.ones(missing.size, v.dtype)])

    if mode == "chain":
        n_waves = -(-n_tiles // 8)
        S = n_waves * 8
        D = _diag_blocks(r, c, v, _LANES, S)
        # padding: identity rows past n (whole tiles and the ragged tail)
        tiles_r0 = np.arange(S) * _LANES
        pad_from = np.clip(n - tiles_r0, 0, _LANES)
        rows_iota = np.arange(_LANES)
        pad_mask = rows_iota[None, :] >= pad_from[:, None]  # (S, 128)
        D[np.nonzero(pad_mask)[0], np.nonzero(pad_mask)[1],
          np.nonzero(pad_mask)[1]] = 1.0
        # batched inversion: LAPACK LU over the whole stack
        invD = np.linalg.solve(D, np.broadcast_to(
            np.eye(_LANES), D.shape).copy())
        a1 = invD.transpose(0, 2, 1).copy()  # inv^T
        C = _sub_blocks(r, c, v, _LANES, S, K)
        # a2[t, k-1] = C^T · inv^T = (inv · C)^T, batched
        a2 = np.matmul(invD[:, None], C).transpose(0, 1, 3, 2)
        plan_kwargs = dict(
            a1=_put(a1.reshape(n_waves, 8 * _LANES, _LANES), dev, vdt),
            a2=_put(a2.reshape(n_waves, 8 * K * _LANES, _LANES), dev, vdt),
            s_idx=None, vals=None, group_wave=None, seg_first=None,
            commit=None, slab_win=None, slab_tloc=None,
            m=8, K=K, n_waves=n_waves, S=S, group=1,
            n_win=max(-(-n // _W), 1),
        )
    else:
        import scipy.linalg as sla

        n_waves = -(-n_tiles // m)
        S = 8 * (-(-(n_waves * m) // 8))
        B = m * _LANES
        D = _diag_blocks(r, c, v, B, n_waves)
        waves_r0 = np.arange(n_waves) * B
        pad_from = np.clip(n - waves_r0, 0, B)
        rows_iota = np.arange(B)
        pad_mask = rows_iota[None, :] >= pad_from[:, None]
        D[np.nonzero(pad_mask)[0], np.nonzero(pad_mask)[1],
          np.nonzero(pad_mask)[1]] = 1.0
        a1 = np.empty((n_waves, B, B), np.float64)
        eye = np.eye(B)
        for i in range(n_waves):  # per-wave O(B³/3) triangular solves
            a1[i] = sla.solve_triangular(D[i], eye, lower=True,
                                         check_finite=False).T
        cross = c < (r // B) * B
        # the slab values in fp32; a bf16 plan rounds them (and a1) below
        packed = _pack_wave_slabs(r[cross], c[cross],
                                  v[cross].astype(np.float32), m, n_tiles,
                                  max(-(-n // _W), 1), None)
        plan_kwargs = dict(
            a1=_put(a1, dev, vdt), a2=None,
            s_idx=_put(packed["s_idx"], dev, torch.int8),
            vals=_put(packed["vals"], dev, vdt),
            group_wave=_put(packed["group_wave"], dev, torch.int32),
            seg_first=_put(packed["seg_first"], dev, torch.int32),
            commit=_put(packed["commit"], dev, torch.int32),
            slab_win=_put(packed["slab_win"], dev, torch.int32),
            slab_tloc=_put(packed["slab_tloc"], dev, torch.int32),
            m=m, n_waves=n_waves, S=S, group=packed["group"],
            n_win=max(-(-n // _W), 1),
        )

    t_plan = None
    if with_transpose or with_grads:
        At = CSR.from_scipy(sps.csr_matrix(A.to_scipy().T), device="cpu")
        t_plan = trisolve_waves_plan(At, lower=not lower,
                                     unit_diagonal=unit_diagonal,
                                     mode=mode, m=m, with_transpose=False,
                                     dtype=dtype, device=dev)
    if with_grads:
        # pattern slots aligned to A.data (capacity-padded) for the
        # implicit-function value cotangent v̄_ij = −(T⁻ᵀg)_i · x_j
        cap = A.indices.shape[0]
        counts = np.diff(A.indptr.cpu().numpy())
        rws = np.repeat(np.arange(A.shape[0], dtype=np.int64), counts)
        prow = np.zeros(cap, np.int32)
        prow[: len(rws)] = rws
        pcol = A.indices.cpu().numpy().astype(np.int32)
        scale = np.zeros(cap, np.float32)
        scale[: len(rws)] = 1.0
        if unit_diagonal:  # stored diagonal is inert under unit_diagonal
            scale[: len(rws)][rws == pcol[: len(rws)].astype(np.int64)] = 0.0
        plan_kwargs.update(pat_rows=_put(prow, dev),
                           pat_cols=_put(pcol, dev),
                           pat_scale=_put(scale, dev))
    return TriWavesPlan(
        t_plan=t_plan,
        shape=(n, n), mode=mode, lower=lower, reversed=perm is not None,
        **plan_kwargs,
    )


# ---------------------------------------------------------------------------
# plain versions: the kernels' programs walked step by step in torch
# ---------------------------------------------------------------------------

def _chain_plain(a1, a2, b2, S, K):
    """x_g = b_g · A1_g − Σ_k x_{g−k} · A2ᵏ_g, tile by tile; b2 (S, R,
    128) fp32, returns x (S, R, 128)."""
    A1 = a1.reshape(S, _LANES, _LANES).float()
    A2 = a2.reshape(S, K, _LANES, _LANES).float()
    pre = torch.bmm(b2, A1)  # the independent half
    x = torch.zeros_like(pre)
    for g in range(S):
        xg = pre[g]
        for k in range(1, K + 1):
            if g - k >= 0:
                xg = xg - x[g - k] @ A2[g, k - 1]
        x[g] = xg
    return x


def _ptr(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(n+1,) int32 first index of each key 0..n in the sorted ``keys``."""
    return torch.searchsorted(
        keys, torch.arange(n + 1, dtype=torch.int32, device=keys.device),
        out_int32=True)


def _slab_cols(s_idx, slab_win, n_x):
    """Per-slot column (n, 8, 128) int64 of slabs, and the in-range mask."""
    col = (slab_win.long()[:, None, None] * _W
           + torch.arange(8, device=s_idx.device)[None, :, None] * _LANES
           + (s_idx.long() & 127))
    return col.clamp(max=n_x - 1), col < n_x


def _binv_plain(plan: TriWavesPlan, bp: torch.Tensor) -> torch.Tensor:
    """Wave by wave: u = b_wave − (cross-wave slab gather of the solved
    prefix, per tile), x_wave = u · a1[wave]."""
    m, B = plan.m, plan.m * _LANES
    N = plan.S * _LANES
    x = torch.zeros(N, dtype=torch.float32, device=bp.device)
    si = plan.s_idx.reshape(-1, 8, _LANES)
    vv = plan.vals.reshape(-1, 8, _LANES)
    ptr = _ptr(plan.group_wave, plan.n_waves).tolist()
    for i in range(plan.n_waves):
        sl = slice(ptr[i] * plan.group, ptr[i + 1] * plan.group)
        col, ok = _slab_cols(si[sl], plan.slab_win[sl], N)
        contrib = (vv[sl].float() * torch.where(ok, x[col], 0.0)).sum(1)
        acc = torch.zeros(m, _LANES, dtype=torch.float32, device=bp.device)
        acc.index_add_(0, plan.slab_tloc[sl].long(), contrib)
        u = bp[i * B:(i + 1) * B] - acc.reshape(-1)
        x[i * B:(i + 1) * B] = u @ plan.a1[i].float()
    return x


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_CHAIN_ARGTYPES = (
    ctypes.c_void_p,  # a1
    ctypes.c_void_p,  # a2
    ctypes.c_void_p,  # b fp32
    ctypes.c_void_p,  # x fp32 out
    ctypes.c_void_p,  # sync (2,) int32, zeroed
    ctypes.c_int,  # S
    ctypes.c_int,  # K
    ctypes.c_int,  # bf16 planes
    ctypes.c_void_p,  # stream
)
_BINV_ARGTYPES = (
    ctypes.c_void_p,  # a1
    ctypes.c_void_p,  # s_idx int8
    ctypes.c_void_p,  # vals
    ctypes.c_void_p,  # slab_win int32
    ctypes.c_void_p,  # slab_tloc int32
    ctypes.c_void_p,  # wave_ptr (n_waves+1,) int32
    ctypes.c_void_p,  # b fp32
    ctypes.c_void_p,  # x fp32 out, zeroed
    ctypes.c_void_p,  # u fp32 scratch
    ctypes.c_void_p,  # sync (2 + n_waves*m,) int32, zeroed
    ctypes.c_int,  # n_waves
    ctypes.c_int,  # m
    ctypes.c_int,  # group
    ctypes.c_int,  # S
    ctypes.c_int,  # bf16 planes
    ctypes.c_void_p,  # stream
)


def _check_planes(plan: TriWavesPlan, b: torch.Tensor, fn: str):
    planes = [plan.a1] + ([plan.a2] if plan.mode == "chain" else
                          [plan.s_idx, plan.vals, plan.group_wave,
                           plan.slab_win, plan.slab_tloc])
    if not b.is_cuda or not all(t.device == b.device and t.is_contiguous()
                                for t in planes):
        raise ValueError(f"{fn}: the plan and b must be contiguous on one "
                         f"CUDA device")
    if plan.a1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: planes must be fp32 or bf16, not "
                         f"{plan.a1.dtype}")


def _chain_cuda(plan: TriWavesPlan, b: torch.Tensor, rhs: int) -> torch.Tensor:
    """One launch of the chain kernel on ``b`` (S*rhs*128,) fp32, rhs 1
    or 8 (the tile-major pane)."""
    fn_name = "trisolve_chain" if rhs == 1 else "trisolve_chain_mm"
    _check_planes(plan, b, fn_name)
    S, K = plan.S, plan.K
    if (plan.a1.shape != (plan.n_waves, 8 * _LANES, _LANES)
            or plan.a2.shape != (plan.n_waves, 8 * K * _LANES, _LANES)
            or plan.a2.dtype != plan.a1.dtype or S != 8 * plan.n_waves
            or not 1 <= K <= 3 or b.dtype != torch.float32
            or b.shape != (S * rhs * _LANES,) or not b.is_contiguous()):
        raise ValueError(f"{fn_name}: inconsistent plan planes or b")
    x = torch.empty_like(b)
    sync = torch.zeros(2, dtype=torch.int32, device=b.device)
    fn = _build.load("trisolve_waves", _CHAIN_ARGTYPES, fn_name)
    with torch.cuda.device(b.device):
        err = fn(plan.a1.data_ptr(), plan.a2.data_ptr(), b.data_ptr(),
                 x.data_ptr(), sync.data_ptr(), S, K,
                 int(plan.a1.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: launch failed with CUDA error {err}")
    _build.launch_counts[fn_name] += 1
    return x


def _binv_cuda(plan: TriWavesPlan, bp: torch.Tensor) -> torch.Tensor:
    _check_planes(plan, bp, "trisolve_binv")
    S, m, B = plan.S, plan.m, plan.m * _LANES
    n_groups = plan.s_idx.shape[0]
    if (plan.a1.shape != (plan.n_waves, B, B) or 8 % m
            or plan.vals.dtype != plan.a1.dtype
            or plan.s_idx.dtype != torch.int8
            or plan.s_idx.shape != (n_groups, plan.group * 8, _LANES)
            or plan.vals.shape != plan.s_idx.shape
            or plan.group_wave.shape != (n_groups,)
            or plan.slab_win.shape != (n_groups * plan.group,)
            or plan.slab_tloc.shape != plan.slab_win.shape
            or S < plan.n_waves * m or bp.dtype != torch.float32
            or bp.shape != (S * _LANES,) or not bp.is_contiguous()):
        raise ValueError("trisolve_binv: inconsistent plan planes or b")
    wave_ptr = _ptr(plan.group_wave, plan.n_waves)
    x = torch.zeros_like(bp)
    u = torch.empty_like(bp)
    sync = torch.zeros(2 + plan.n_waves * m, dtype=torch.int32,
                       device=bp.device)
    fn = _build.load("trisolve_waves", _BINV_ARGTYPES, "trisolve_binv")
    with torch.cuda.device(bp.device):
        err = fn(plan.a1.data_ptr(), plan.s_idx.data_ptr(),
                 plan.vals.data_ptr(), plan.slab_win.data_ptr(),
                 plan.slab_tloc.data_ptr(), wave_ptr.data_ptr(),
                 bp.data_ptr(), x.data_ptr(), u.data_ptr(), sync.data_ptr(),
                 plan.n_waves, m, plan.group, S,
                 int(plan.a1.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"trisolve_binv: launch failed with CUDA error "
                           f"{err}")
    _build.launch_counts["trisolve_binv"] += 1
    return x


def _on_cpu(plan: TriWavesPlan, b: torch.Tensor) -> bool:
    return b.device.type == "cpu" and plan.a1.device.type == "cpu"


def _solve_padded(plan: TriWavesPlan, bp: torch.Tensor,
                  plain: bool) -> torch.Tensor:
    """x (S*128,) of the padded, already reversed b: the plain program or
    the kernel."""
    if plan.mode == "binv" and 8 % plan.m:
        raise ValueError(f"binv plans need m dividing 8 (the wave commit "
                         f"of the JAX kernel), got m={plan.m}")
    if plan.mode == "chain":
        if plain:
            return _chain_plain(plan.a1, plan.a2,
                                bp.reshape(plan.S, 1, _LANES), plan.S,
                                plan.K).reshape(-1)
        return _chain_cuda(plan, bp, 1)
    return _binv_plain(plan, bp) if plain else _binv_cuda(plan, bp)


def _rev_pad(v: torch.Tensor, n: int, N: int) -> torch.Tensor:
    """The reversal of the padded vector: ``out[i] = v_padded[n−1−i]`` by
    a flip and a roll (self-inverse on the first n entries).  Reverses the
    leading dimension of a panel."""
    return torch.roll(torch.flip(v, [0]), n - N, 0)


def _waves_forward(plan: TriWavesPlan, b: torch.Tensor,
                   plain: Optional[bool] = None) -> torch.Tensor:
    """``x = T⁻¹ b``: the plain program when the inputs lie on the CPU
    (or ``plain``), else the kernel."""
    n = plan.shape[0]
    N = plan.S * _LANES
    if plain is None:
        plain = _on_cpu(plan, b)
    bp = torch.zeros(N, dtype=torch.float32, device=b.device)
    bp[:n] = b
    if plan.reversed:
        bp = _rev_pad(bp, n, N)
    x = _solve_padded(plan, bp, plain)
    if plan.reversed:
        x = _rev_pad(x, n, N)
    return x[:n]


def waves_forward_plain(plan: TriWavesPlan, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``trisolve_waves_apply`` on the plan's device (the
    card's kernels are compared with it)."""
    return _waves_forward(plan, b, plain=True)


class _WavesApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, b):
        ctx.plan = plan
        return _waves_forward(plan, b)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        if plan.t_plan is None:
            raise ValueError(
                "trisolve_waves_apply backward pass needs the transposed "
                "plan — build with trisolve_waves_plan(..., "
                "with_transpose=True)")
        return None, _waves_forward(plan.t_plan, g.contiguous())


def trisolve_waves_apply(plan: TriWavesPlan, b: torch.Tensor) -> torch.Tensor:
    """Device solve ``x = T⁻¹ b`` (fp32), wave-batched.  Differentiable in
    ``b`` when the plan was built with ``with_transpose=True``; not in the
    matrix values (use ``trisolve_waves_solve`` or the fused engine)."""
    return _WavesApply.apply(plan, b)


# ---------------------------------------------------------------------------
# multi-RHS: X = T⁻¹ B for B (n, k)
# ---------------------------------------------------------------------------

def _panes_in(Bt: torch.Tensor, S: int, c: int) -> torch.Tensor:
    """Columns c*8..c*8+7 of the padded panel as the tile-major pane:
    rows [t*8, t*8+8) are the 8 RHS of tile t."""
    return (Bt[:, c * 8:(c + 1) * 8].T.reshape(8, S, _LANES)
            .transpose(0, 1).reshape(-1).contiguous())


def _panes_out(o: torch.Tensor, S: int) -> torch.Tensor:
    return o.reshape(S, 8, _LANES).transpose(0, 1).reshape(8, -1).T


def _mm_forward(plan: TriWavesPlan, B: torch.Tensor,
                plain: Optional[bool] = None) -> torch.Tensor:
    n, k = B.shape
    N = plan.S * _LANES
    if plain is None:
        plain = _on_cpu(plan, B)
    Bp = torch.zeros((N, k), dtype=torch.float32, device=B.device)
    Bp[:n] = B
    if plan.reversed:
        Bp = _rev_pad(Bp, n, N)
    if plan.mode != "chain":
        # binv: a column at a time through the single-RHS engine (the
        # reversal is applied to the whole panel already)
        flat = dataclasses.replace(plan, reversed=False)
        Xp = torch.zeros((N, k), dtype=torch.float32, device=B.device)
        for j in range(k):
            Xp[:n, j] = _waves_forward(flat, Bp[:n, j], plain)
    else:
        kc = -(-k // 8)
        Bt = torch.zeros((N, kc * 8), dtype=torch.float32, device=B.device)
        Bt[:, :k] = Bp
        outs = []
        for c in range(kc):
            b3 = _panes_in(Bt, plan.S, c)
            if plain:
                o = _chain_plain(plan.a1, plan.a2,
                                 b3.reshape(plan.S, 8, _LANES), plan.S,
                                 plan.K).reshape(-1)
            else:
                o = _chain_cuda(plan, b3, 8)
            outs.append(_panes_out(o, plan.S))
        Xp = torch.cat(outs, dim=1)[:, :k]
    if plan.reversed:
        Xp = _rev_pad(Xp, n, N)
    return Xp[:n]


def mm_forward_plain(plan: TriWavesPlan, B: torch.Tensor) -> torch.Tensor:
    """Plain version of ``trisolve_waves_apply_mm`` on the plan's device."""
    return _mm_forward(plan, B, plain=True)


class _WavesApplyMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, B):
        ctx.plan = plan
        return _mm_forward(plan, B)

    @staticmethod
    def backward(ctx, G):
        plan = ctx.plan
        if plan.t_plan is None:
            raise ValueError(
                "trisolve_waves_apply_mm backward pass needs the transposed "
                "plan — build with trisolve_waves_plan(..., "
                "with_transpose=True)")
        return None, _mm_forward(plan.t_plan, G)


def trisolve_waves_apply_mm(plan: TriWavesPlan,
                            B: torch.Tensor) -> torch.Tensor:
    """Multi-RHS solve ``X = T⁻¹ B``, B (n, k): chain plans run the 8-RHS
    kernel once per 8 columns; binv plans solve column by column.
    Differentiable in ``B`` through the transposed plan."""
    return _WavesApplyMM.apply(plan, B)


# ---------------------------------------------------------------------------
# parameter gradients: x = T(vals)⁻¹ b differentiable in vals and b
# ---------------------------------------------------------------------------

class _WavesSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, vals, b):
        # vals is baked into the plan; it routes the gradient only
        x = _waves_forward(plan, b)
        ctx.plan = plan
        ctx.vdtype = vals.dtype
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        (x,) = ctx.saved_tensors
        if plan.t_plan is None or plan.pat_rows is None:
            raise ValueError(
                "trisolve_waves_solve backward pass needs "
                "trisolve_waves_plan(..., with_grads=True)")
        w = _waves_forward(plan.t_plan, g.contiguous())  # T⁻ᵀ g
        dvals = (-(w[plan.pat_rows.long()] * x[plan.pat_cols.long()])
                 * plan.pat_scale).to(ctx.vdtype)
        return None, dvals, w


def trisolve_waves_solve(plan: TriWavesPlan, vals: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """``x = T⁻¹ b`` differentiable in the matrix values and in ``b``.
    ``vals`` is the capacity-padded ``A.data`` the plan was built from
    (``trisolve_waves_plan(A, with_grads=True)``); the forward pass solves
    with the plan's inverse blocks.  Backward: one solve on the transposed
    plan and two pattern gathers (``v̄_ij = −(T⁻ᵀ g)_i · x_j``)."""
    return _WavesSolve.apply(plan, vals, b)
