"""SpGEMM: ``C = A @ B`` with both operands sparse.

Twin of ``sparsematrix_tpu/ops/spgemm.py``: a symbolic / numeric split.
The host enumerates once every contraction pair (a_entry, b_entry) and
the output slot it adds to (``spgemm_plan``):

    C.data[slot] = Σ_{pairs p: target(p)=slot} A.data[pa[p]] * B.data[pb[p]]

and the numeric phase multiplies any values with the same patterns.  The
plain numeric phase (``spgemm_apply``) is a gather-multiply-``index_add``
in plain torch.

The packed numeric phase: the pair program is itself a sparse matrix P
(c_nnz × b_cap, value ``A.data[pa]`` at (target, pb)), so
``C.data = P @ B.data`` is an SpMV.  ``spgemm_plan_packed`` builds P once
per (pattern, A values), clusters it (rows in C's CSC order, columns by
B's CSC rank, coloured onto sublanes so that each row's references in a
window land on distinct sublanes) and packs it as an octet, superblock,
rowlane or dual-gather pack; ``spgemm_apply_packed[_csc]`` permutes B's
values in (a planned permutation), runs the pack's SpMV kernel, and, for
CSR output, permutes the result out.  A CSC result is the kernel's own
order.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from ..config import resolve_device
from ..formats import CSR, Dense
from ..formats.base import default_index_dtype, sparse_container, static_field
from ..kernels import _build
from .permute import apply_permutation, plan_gather_permutation

__all__ = ["SpGEMMPlan", "spgemm_plan", "spgemm_apply", "spgemm",
           "SpGEMMPacked", "spgemm_plan_packed", "spgemm_apply_packed",
           "spgemm_apply_packed_csc", "spgemm_densify", "spgemm_extract"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Precomputed multiply program for a fixed (A, B) sparsity pattern."""

    pa: torch.Tensor  # (n_pairs_cap,) index into A.data
    pb: torch.Tensor  # (n_pairs_cap,) index into B.data
    target: torch.Tensor  # (n_pairs_cap,) index into C.data (pad: out of range)
    c_indptr: torch.Tensor  # (m+1,)
    c_indices: torch.Tensor  # (c_nnz_cap,)
    c_row_ids: torch.Tensor  # (c_nnz_cap,)
    shape: Tuple[int, int] = static_field()
    n_pairs: int = static_field()
    c_nnz: int = static_field()

    @property
    def nnz(self) -> int:
        return self.c_nnz


def _host_csr(A: CSR):
    """A sorted host copy of A (the container's own copy is not mutated)."""
    s = A.to_scipy().tocsr(copy=True)
    s.sort_indices()
    return s


def spgemm_plan(A: CSR, B: CSR, pair_capacity: int | None = None,
                c_capacity: int | None = None, device=None) -> SpGEMMPlan:
    """Symbolic phase (host), on ``device`` (default: A's)."""
    dev = A.device if device is None else resolve_device(device)
    sa = _host_csr(A)
    sb = _host_csr(B)
    m, ka = sa.shape
    kb, n = sb.shape
    if ka != kb:
        raise ValueError(f"spgemm: inner dims {ka} != {kb}")
    # the output structure from the structural boolean product (explicitly
    # stored zeros are stored slots)
    ind = lambda s: sps.csr_matrix(  # noqa: E731
        (np.ones(len(s.indices), np.int8), s.indices, s.indptr),
        shape=s.shape)
    pattern = (ind(sa) @ ind(sb)).tocsr()
    pattern.sort_indices()
    c_nnz = int(pattern.nnz)

    # pair enumeration: A entry ai (row i, col k) pairs with B row k
    b_indptr, b_indices = sb.indptr.astype(np.int64), sb.indices
    c_indptr, c_indices = pattern.indptr, pattern.indices
    a_nnz = len(sa.indices)
    a_rows = np.repeat(np.arange(m), np.diff(sa.indptr))
    ka_ = sa.indices.astype(np.int64)
    cnt = b_indptr[ka_ + 1] - b_indptr[ka_]  # B-row length per A entry
    n_pairs = int(cnt.sum())
    pa_v = np.repeat(np.arange(a_nnz), cnt)
    starts = np.cumsum(cnt) - cnt
    off = np.arange(n_pairs) - np.repeat(starts, cnt)
    pb_v = b_indptr[ka_[pa_v]] + off
    # target slot: row-major, column-sorted C keys are globally sorted
    c_rows = np.repeat(np.arange(m), np.diff(c_indptr))
    key_c = c_rows.astype(np.int64) * n + c_indices.astype(np.int64)
    key_p = (a_rows[pa_v].astype(np.int64) * n
             + b_indices[pb_v].astype(np.int64))
    tgt_v = np.searchsorted(key_c, key_p)

    pcap = max(n_pairs, 1) if pair_capacity is None else int(pair_capacity)
    ccap = max(c_nnz, 1) if c_capacity is None else int(c_capacity)
    pa = np.zeros(pcap, dtype=np.int64)
    pb = np.zeros(pcap, dtype=np.int64)
    tgt = np.full(pcap, ccap, dtype=np.int64)  # padding targets out of range
    pa[:n_pairs] = pa_v
    pb[:n_pairs] = pb_v
    tgt[:n_pairs] = tgt_v
    ci = np.zeros(ccap, dtype=np.int64)
    ci[:c_nnz] = c_indices
    crow = np.full(ccap, m, dtype=np.int64)
    crow[:c_nnz] = c_rows

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, default_index_dtype)

    return SpGEMMPlan(pa=put(pa), pb=put(pb), target=put(tgt),
                      c_indptr=put(c_indptr), c_indices=put(ci),
                      c_row_ids=put(crow), shape=(m, n), n_pairs=n_pairs,
                      c_nnz=c_nnz)


def spgemm_apply(plan: SpGEMMPlan, a_data: torch.Tensor,
                 b_data: torch.Tensor) -> CSR:
    """Plain numeric phase: gather-multiply-``index_add`` (differentiable
    in both value arrays)."""
    prod = a_data[plan.pa.long()] * b_data[plan.pb.long()]
    # padding pairs gather real values but add to the dropped slot
    c_data = prod.new_zeros(plan.c_indices.shape[0] + 1).index_add(
        0, plan.target.long(), prod)[:-1]
    return CSR(indptr=plan.c_indptr, indices=plan.c_indices, data=c_data,
               row_ids=plan.c_row_ids, shape=plan.shape, nnz=plan.c_nnz)


# The density-adaptive routing rates, measured on an NVIDIA H100 80GB HBM3
# at 700 W by the bench suite (``python -m sparsematrix_tpu_torch.bench
# 117 1023 2047 1 spgemm``): the dense product from the
# ``spgemm_crossover/densify-mxu`` rows (2n³ over the device time: 44.7
# TFLOP/s at n = 4096, 50.4 at 8192; the lower kept), the pair program
# from the packed rows (``spgemm_crossover/packed`` 6.24 Gpairs/s at
# n = 4096 and 8.56 at 8192, ``spgemm/numeric-packed`` 8.84; the lowest
# kept).
_DENSE_FLOPS_PER_S = 44.7e12
_PACKED_PAIRS_PER_S = 6.24e9
_DENSIFY_MAX_DENSE_ELEMS = 512 * 1024 * 1024  # 2 GB fp32 product cap


def _estimate_pairs(A: CSR, B: CSR) -> int:
    """Exact pair count Σ_k deg_A-col(k)·deg_B-row(k) from host arrays."""
    brow = np.diff(B.indptr.cpu().numpy())
    acol = np.bincount(A.indices[: A.nnz].cpu().numpy(),
                       minlength=B.shape[0])
    return int((acol[: len(brow)] * brow).sum())


def spgemm(A: CSR, B: CSR, method: str = "auto",
           output: str = "csr") -> CSR:
    """One-shot SpGEMM (symbolic on the host, numeric on A's device).

    method: "auto" (the dense product below the crossover measured on the
    card, the pair program above), "sparse" or "densify".
    output: "csr" (C as CSR) or "csc" (C^T as CSR, through the packed
    clustered pair program, whose kernel output is in that order).
    """
    if method not in ("auto", "sparse", "densify"):
        raise ValueError(f"unknown method {method!r}")
    if output not in ("csr", "csc"):
        raise ValueError(f"unknown output {output!r}")
    if output == "csc":
        if method == "densify":
            raise ValueError(
                'output="csc" implies the packed sparse path; '
                'method="densify" cannot be honored (use output="csr")')
        pp = spgemm_plan_packed(A, B, outputs=("csc",))
        return spgemm_apply_packed_csc(pp, B.data)
    m, k = A.shape
    _, n = B.shape
    if method != "sparse":
        dense_ok = (m * n <= _DENSIFY_MAX_DENSE_ELEMS
                    and m * k <= _DENSIFY_MAX_DENSE_ELEMS
                    and k * n <= _DENSIFY_MAX_DENSE_ELEMS)
        pick_dense = method == "densify"
        if method == "auto" and dense_ok:
            t_dense = 2.0 * m * k * n / _DENSE_FLOPS_PER_S
            t_sparse = _estimate_pairs(A, B) / _PACKED_PAIRS_PER_S
            pick_dense = t_dense < t_sparse
        if pick_dense and dense_ok:
            plan = spgemm_plan(A, B)
            return spgemm_extract(plan, spgemm_densify(A, B))
    plan = spgemm_plan(A, B)
    return spgemm_apply(plan, A.data, B.data)


def spgemm_densify(A, B) -> Dense:
    """``C = A @ B`` through densified operands: one dense product
    (``torch.matmul``, fp32 with TF32 off).  Returns a ``Dense``."""
    ad = A.data if isinstance(A, Dense) else A.todense()
    bd = B.data if isinstance(B, Dense) else B.todense()
    cd = ad @ bd
    return Dense(data=cd, shape=(ad.shape[0], bd.shape[1]),
                 nnz=cd.shape[0] * cd.shape[1])


def spgemm_extract(plan: SpGEMMPlan, dense) -> CSR:
    """Gather a dense product down to the plan's C pattern."""
    cd = dense.data if isinstance(dense, Dense) else dense
    m, n = plan.shape
    rid = plan.c_row_ids.long()
    data = cd[rid.clamp(max=m - 1), plan.c_indices.long()]
    # padding slots (row_ids == m) carry zero
    data = torch.where(rid < m, data, data.new_zeros(()))
    return CSR(indptr=plan.c_indptr, indices=plan.c_indices, data=data,
               row_ids=plan.c_row_ids, shape=plan.shape, nnz=plan.c_nnz)


# ---------------------------------------------------------------------------
# the packed numeric phase: the pair program IS a sparse matrix
# ---------------------------------------------------------------------------

@sparse_container
@dataclasses.dataclass(frozen=True)
class SpGEMMPacked:
    """Pair program packed for an SpMV over b_data."""

    p_packed: object  # the pack of P (c_slots × b_cols)
    c_indptr: torch.Tensor
    c_indices: torch.Tensor
    c_row_ids: torch.Tensor
    # the clustering permutations as gather indices (None: identity)
    b_gather: Optional[torch.Tensor]  # (p_cols,) int32: B.data index of x[q]
    c_gather: Optional[torch.Tensor]  # (cap,) int32: output index of C.data[i]
    # C^T structure (clustered plans only): the kernel output is in
    # CSC-of-C == CSR-of-C^T order already
    ct_indptr: Optional[torch.Tensor]
    ct_indices: Optional[torch.Tensor]
    ct_row_ids: Optional[torch.Tensor]
    shape: Tuple[int, int] = static_field()
    c_nnz: int = static_field()
    # the same maps as planned permutations (None: apply the gathers)
    b_perm: object = None
    c_perm: object = None


_COLOR_RANKS_ARGTYPES = (
    ctypes.c_void_p,  # q (n_pairs,) int32
    ctypes.c_void_p,  # row (n_pairs,) int32
    ctypes.c_long,  # n_pairs
    ctypes.c_long,  # n_ranks
    ctypes.c_long,  # n_rows
    ctypes.c_void_p,  # alloc (n_ranks,) int64 out
)


def _color_b_ranks_native(row_of: np.ndarray, q: np.ndarray, n_ranks: int):
    """``smtpu_color_ranks`` (``native/color.cc``); None where no ``g++``
    is found."""
    fn = _build.load_host("color", "smtpu_color_ranks",
                          _COLOR_RANKS_ARGTYPES)
    if fn is None or n_ranks >= 2**31 or len(q) >= 2**31:
        return None
    q32 = np.ascontiguousarray(q, np.int32)
    r32 = np.ascontiguousarray(row_of, np.int32)
    alloc = np.zeros(n_ranks, np.int64)
    n_rows = int(row_of.max()) + 1 if len(row_of) else 1
    rc = fn(q32.ctypes.data, r32.ctypes.data, len(q32), n_ranks, n_rows,
            alloc.ctypes.data)
    return alloc if rc == 0 else None


def _color_b_ranks(row_of: np.ndarray, q: np.ndarray, n_ranks: int):
    """Assign each B-entry rank a (sublane, slot) inside its 1024-rank
    window so that every P-row's references within a window land on
    distinct sublanes: a greedy capacity-respecting 8-colouring of the
    per-window rank-conflict graph.  Returns the window-relative position
    ``w*1024 + color*128 + slot`` per rank; None for a large plan without
    the native colourer (the caller then stripes round-robin)."""
    native_alloc = _color_b_ranks_native(row_of, q, n_ranks)
    if native_alloc is not None:
        return native_alloc
    if n_ranks > 200_000:
        return None
    order = np.argsort(q, kind="stable")
    q_s, row_s = q[order], row_of[order]
    starts = np.searchsorted(q_s, np.arange(n_ranks))
    ends = np.searchsorted(q_s, np.arange(n_ranks) + 1)
    n_rows = int(row_of.max()) + 1 if len(row_of) else 1
    used = np.zeros(n_rows, np.uint16)  # per-row colour bitmask (window)
    stamp = np.full(n_rows, -1, np.int64)
    capc = np.zeros(8, np.int64)
    color = np.zeros(n_ranks, np.int8)
    slot_in = np.zeros(n_ranks, np.int64)
    cur_w = -1
    for qq in range(n_ranks):
        w = qq >> 10
        if w != cur_w:
            cur_w = w
            capc[:] = 0
        rows = row_s[starts[qq]:ends[qq]]
        if len(rows):
            fresh = stamp[rows] != w
            if fresh.any():
                used[rows[fresh]] = 0
            stamp[rows] = w
            forbid = int(np.bitwise_or.reduce(used[rows]))
        else:
            forbid = 0
        best, bestload = 0, 1 << 30
        for c in range(8):
            if capc[c] >= 128:
                continue
            load = capc[c] + (100000 if (forbid >> c) & 1 else 0)
            if load < bestload:
                best, bestload = c, load
        color[qq] = best
        slot_in[qq] = capc[best]
        capc[best] += 1
        if len(rows):
            used[rows] |= np.uint16(1 << best)
    return ((np.arange(n_ranks) // 1024) * 1024
            + color.astype(np.int64) * 128 + slot_in)


def spgemm_plan_packed(A: CSR, B: CSR, cluster: bool = True,
                       layout: str = "auto", stripe: str = "color",
                       permute: str = "auto",
                       outputs: tuple = ("csr", "csc"),
                       device=None, **pack_kwargs) -> SpGEMMPacked:
    """Symbolic phase + pack, on ``device`` (default: A's): fixes A's
    pattern and values (and B's pattern); ``spgemm_apply_packed`` then
    multiplies any B values.

    ``cluster`` reorders P into its CSC-of-C × CSC-of-B block-diagonal
    form with sublane-coloured block columns.  ``layout``: ``"octet"``,
    ``"superblock"``, ``"rowlane"``, ``"dualgather"``, or ``"auto"``
    (octet for a clustered program of ≤2 pairs a C slot, else superblock
    when clustering, rowlane otherwise).  ``permute``: how the B and C
    permutations are planned (``"auto"``: Clos where the size allows).
    ``outputs``: the results the plan must serve; a plan without
    ``"csr"`` skips planning the C permutation.
    """
    from ..kernels.spmv_dualgather import pack_dualgather
    from ..kernels.spmv_octet import pack_octet
    from ..kernels.spmv_rowlane import pack_sell_rowlane
    from ..kernels.spmv_superblock import pack_superblock

    if permute not in ("auto", "sort", "gather", "clos"):
        raise ValueError(f"unknown permute {permute!r}")
    if stripe not in ("color", "mod"):
        raise ValueError(f"unknown stripe {stripe!r}")
    if layout not in ("auto", "superblock", "rowlane", "dualgather",
                      "octet"):
        raise ValueError(f"unknown layout {layout!r}")
    dev = A.device if device is None else resolve_device(device)
    force_sort = {"auto": None, "sort": True, "gather": False,
                  "clos": None}[permute]

    def _plan_perm(gmap, n_src):
        if permute == "auto":
            from .permute import plan_permutation_auto

            return plan_permutation_auto(gmap, n_src=n_src, device=dev)
        if permute == "clos":
            from .permute_clos import plan_clos_permutation

            p = plan_clos_permutation(gmap, n_src=n_src, device=dev)
            if p is not None:
                return p
        return plan_gather_permutation(gmap, n_src=n_src,
                                       force_sort=force_sort, device=dev)

    plan = spgemm_plan(A, B, device="cpu")
    pa = plan.pa.numpy()[: plan.n_pairs]
    pb = plan.pb.numpy()[: plan.n_pairs]
    tgt = plan.target.numpy()[: plan.n_pairs].astype(np.int64)
    a_host = A.data.cpu().numpy()
    b_cap = int(B.capacity)
    b_gather = c_gather = b_perm = c_perm = None
    ct_indptr = ct_indices = ct_row_ids = None
    p_rows = max(plan.c_nnz, 1)
    p_cols = b_cap
    row_of = tgt
    col_of = pb

    def put(a, dt=default_index_dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    if cluster and plan.c_nnz and plan.n_pairs:
        # columns: the CSC rank of each stored B entry
        sb = _host_csr(B)
        b_row = np.repeat(np.arange(sb.shape[0]), np.diff(sb.indptr))
        b_key = sb.indices.astype(np.int64) * sb.shape[0] + b_row
        rank = np.empty(len(b_key), np.int64)
        rank[np.argsort(b_key, kind="stable")] = np.arange(len(b_key))
        # rows: C slots in CSC order (P-rows grouped by the block they hit)
        c_rows = plan.c_row_ids.numpy()[: plan.c_nnz].astype(np.int64)
        c_cols = plan.c_indices.numpy()[: plan.c_nnz].astype(np.int64)
        order_r = np.argsort(c_cols * plan.shape[0] + c_rows, kind="stable")
        rank_r = np.empty(plan.c_nnz, np.int64)
        rank_r[order_r] = np.arange(plan.c_nnz)
        # C.data[i] = y[rank_r[i]], padded with a sentinel
        cap = int(plan.c_indices.shape[0])
        cg = np.full(cap, max(plan.c_nnz, 1), np.int64)
        cg[: plan.c_nnz] = rank_r
        c_gather = put(cg, torch.int32)
        # a csc-only plan skips planning the output permutation
        c_perm = (_plan_perm(cg, max(plan.c_nnz, 1))
                  if "csr" in outputs else None)
        row_of = rank_r[tgt]
        # the sublane position of each rank within its 1024-rank window:
        # the conflict-graph colouring, or the round-robin stripe
        alloc_r = (_color_b_ranks(row_of, rank[pb], len(b_key))
                   if stripe == "color" else None)
        if alloc_r is not None:
            alloc = alloc_r[rank]  # rank-indexed → entry-indexed
        else:
            qq = rank % 1024
            alloc = (rank // 1024) * 1024 + (qq % 8) * 128 + qq // 8
        p_cols = int(-(-len(b_key) // 1024)) * 1024
        # the inverse map as a gather: x[q] = b_data[src[q]], sentinel b_cap
        src = np.full(p_cols, b_cap, np.int64)
        src[alloc] = np.arange(len(b_key))
        b_gather = put(src, torch.int32)
        b_perm = _plan_perm(src, b_cap)
        col_of = alloc[pb]
        # C^T CSR structure over the CSC-ordered slots
        ct_counts = np.bincount(c_cols, minlength=plan.shape[1])
        ct_indptr = put(np.concatenate([[0], np.cumsum(ct_counts)]))
        ct_indices = put(c_rows[order_r])
        ct_row_ids = put(c_cols[order_r])
    P = CSR.from_scipy(
        sps.coo_matrix((a_host[pa], (row_of, col_of)),
                       shape=(p_rows, p_cols)).tocsr(),
        device="cpu")
    if layout == "octet" or (layout == "auto" and cluster
                             and plan.n_pairs <= 2 * p_rows):
        # ~1 pair a C slot: the octet layout packs 8 tiles a slab
        pk = dict(pack_kwargs)
        pk.setdefault("group", 32)
        pk.setdefault("k_octets", 64)
        packed = pack_octet(P, device=dev, **pk)
    elif layout == "dualgather":
        pk = dict(pack_kwargs)
        pk.setdefault("k_tiles", 32)
        pk.setdefault("group", 256)
        packed = pack_dualgather(P, device=dev, **pk)
    elif layout == "superblock" or (layout == "auto" and cluster):
        packed = pack_superblock(P, device=dev, **pack_kwargs)
    else:
        packed = pack_sell_rowlane(P, device=dev, **pack_kwargs)
    return SpGEMMPacked(
        p_packed=packed,
        c_indptr=plan.c_indptr.to(dev),
        c_indices=plan.c_indices.to(dev),
        c_row_ids=plan.c_row_ids.to(dev),
        b_gather=b_gather,
        c_gather=c_gather,
        ct_indptr=ct_indptr,
        ct_indices=ct_indices,
        ct_row_ids=ct_row_ids,
        shape=plan.shape,
        c_nnz=plan.c_nnz,
        b_perm=b_perm,
        c_perm=c_perm,
    )


def _p_spmv(p_packed, x: torch.Tensor) -> torch.Tensor:
    """The pair-program SpMV on the layout it was packed for."""
    from ..kernels.spmv_dualgather import DualGather, spmv_dualgather
    from ..kernels.spmv_octet import Octet, spmv_octet
    from ..kernels.spmv_rowlane import spmv_sell_rowlane
    from ..kernels.spmv_superblock import SellSuperblock, spmv_superblock

    if isinstance(p_packed, Octet):
        return spmv_octet(p_packed, x)
    if isinstance(p_packed, SellSuperblock):
        return spmv_superblock(p_packed, x)
    if isinstance(p_packed, DualGather):
        return spmv_dualgather(p_packed, x)
    return spmv_sell_rowlane(p_packed, x)


def _permute_b(pp: SpGEMMPacked, b_data: torch.Tensor) -> torch.Tensor:
    """B's values in the packed program's column order."""
    if pp.b_perm is not None:
        return apply_permutation(pp.b_perm, b_data)
    if pp.b_gather is not None:
        return torch.cat([b_data, b_data.new_zeros(1)])[pp.b_gather.long()]
    return b_data


def spgemm_apply_packed(pp: SpGEMMPacked, b_data: torch.Tensor) -> CSR:
    """Numeric phase on the pack's SpMV kernel, C as CSR (differentiable
    in ``b_data``)."""
    y = _p_spmv(pp.p_packed, _permute_b(pp, b_data))
    cap = pp.c_indices.shape[0]
    if pp.c_perm is not None:
        c_data = apply_permutation(pp.c_perm, y)
    elif pp.c_gather is not None:
        c_data = torch.cat([y, y.new_zeros(1)])[pp.c_gather.long()]
    else:
        c_data = torch.cat([y[: pp.c_nnz], y.new_zeros(cap - pp.c_nnz)])
    return CSR(indptr=pp.c_indptr, indices=pp.c_indices, data=c_data,
               row_ids=pp.c_row_ids, shape=pp.shape, nnz=pp.c_nnz)


def spgemm_apply_packed_csc(pp: SpGEMMPacked, b_data: torch.Tensor) -> CSR:
    """Numeric phase emitting ``C^T`` as CSR (C in CSC): clustered plans
    order the kernel output by C's column already, so no output
    permutation runs (differentiable in ``b_data``)."""
    if pp.ct_indptr is None:
        raise ValueError("CSC output needs a clustered plan "
                         "(spgemm_plan_packed(..., cluster=True))")
    y = _p_spmv(pp.p_packed, _permute_b(pp, b_data))
    cap = pp.ct_indices.shape[0]
    c_data = torch.cat([y[: pp.c_nnz], y.new_zeros(cap - pp.c_nnz)])
    return CSR(indptr=pp.ct_indptr, indices=pp.ct_indices, data=c_data,
               row_ids=pp.ct_row_ids, shape=(pp.shape[1], pp.shape[0]),
               nnz=pp.c_nnz)
