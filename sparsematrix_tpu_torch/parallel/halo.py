"""Halo-exchange distributed SpMV for banded / local structure.

Twin of ``sparsematrix_tpu/parallel/halo.py``.  When each shard's rows
touch only columns within ``halo`` of its own x band, the all-gather of x
is wasteful: each rank needs its band plus a halo from its two ring
neighbours, exchanged point to point (``Mesh.ppermute``), O(halo) a rank
instead of O(n).  The partitioners check the locality at build time and
rebase column ids into the (halo | own band | halo) frame.  Three forms:

* the fixed halo (``partition_csr_halo``, ``dist_spmv_halo``): exchange,
  then the local product;
* the ring halo (``partition_csr_halo_ring``, ``dist_spmv_halo_ring``):
  the matrix split at pack time into the owned-column block and the
  halo-column block; the exchange is posted first and the owned partial
  product does not depend on it;
* the variable halo (``partition_csr_halo_var``, ``dist_spmv_halo_var``):
  per-shard widths (h_l, h_r) measured from the columns the shard
  reaches, exchanged with ``Mesh.ragged_all_to_all`` so that each link
  carries what its receiver needs, or, with ``use_ragged=False``, with
  two ``ppermute``s padded to the widest halo (the JAX CPU path; the same
  frame).  ``ragged_bytes``/``padded_bytes`` count the two.

The local products are plain gathers and segment-sums, as in JAX.
Calling convention (``mesh.py``): x's band of ceil(cols / n) values in,
this rank's ``local_rows`` rows of y out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.base import default_index_dtype, sparse_container, static_field
from ..formats.csr import CSR
from .dist_ops import local_product
from .mesh import Mesh, shard_partitioned

__all__ = ["HaloPartitionedCSR", "partition_csr_halo", "dist_spmv_halo",
           "shard_halo", "RingHaloCSR", "partition_csr_halo_ring",
           "dist_spmv_halo_ring", "shard_halo_ring",
           "VarHaloPartitionedCSR", "partition_csr_halo_var",
           "dist_spmv_halo_var"]


@sparse_container
@dataclasses.dataclass(frozen=True)
class HaloPartitionedCSR:
    indices: torch.Tensor  # (n_shards, cap) local col ids in the halo frame
    data: torch.Tensor  # (n_shards, cap)
    row_ids: torch.Tensor  # (n_shards, cap) local rows (pad: local_rows)
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    local_rows: int = static_field()
    band: int = static_field()  # x values a shard
    halo: int = static_field()
    nnz: int = static_field()


def _bands(csr: CSR, n_shards: int):
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    return sp, rows, cols, -(-rows // n_shards), -(-cols // n_shards)


def _check_local(s, cmin, cmax, lo, hi, halo):
    if cmin < lo or cmax >= hi:
        raise ValueError(f"shard {s}: columns [{cmin}, {cmax}] exceed halo "
                         f"window [{lo}, {hi}) — matrix is not "
                         f"{halo}-local")


def _stack(parts, n_shards, cap, pad_row, dtype):
    """(indices, data, row ids) of [(rows, cols, vals)], padded to
    ``cap`` (pad entries: column 0, value 0, row ``pad_row``)."""
    idx = np.zeros((n_shards, cap), np.int64)
    dat = np.zeros((n_shards, cap), dtype)
    rid = np.full((n_shards, cap), pad_row, np.int64)
    for s, (rr, cc, vv) in enumerate(parts):
        k = len(rr)
        idx[s, :k] = cc
        dat[s, :k] = vv
        rid[s, :k] = rr
    return (torch.from_numpy(idx).to(default_index_dtype),
            torch.from_numpy(dat),
            torch.from_numpy(rid).to(default_index_dtype))


def partition_csr_halo(csr: CSR, n_shards: int,
                       halo: int) -> HaloPartitionedCSR:
    """Row-partition with halo-local column ids; raises if an entry
    reaches past ``halo`` columns outside its shard's x band (host)."""
    sp, rows, cols, local_rows, band = _bands(csr, n_shards)
    if halo > band:
        raise ValueError(f"halo {halo} larger than band {band}")
    parts = []
    for s in range(n_shards):
        sub = sp[s * local_rows: min((s + 1) * local_rows, rows)]
        lo, hi = s * band - halo, s * band + band + halo
        if sub.nnz:
            _check_local(s, int(sub.indices.min()), int(sub.indices.max()),
                         lo, hi, halo)
        parts.append((np.repeat(np.arange(sub.shape[0]), np.diff(sub.indptr)),
                      sub.indices - lo, sub.data))
    cap = max(max(len(p[0]) for p in parts), 1)
    idx, dat, rid = _stack(parts, n_shards, cap, local_rows, sp.data.dtype)
    return HaloPartitionedCSR(indices=idx, data=dat, row_ids=rid,
                              shape=(rows, cols), n_shards=n_shards,
                              local_rows=local_rows, band=band, halo=halo,
                              nnz=csr.nnz)


def shard_halo(part, mesh: Mesh, axis_name: str = "shard"):
    """This rank's slice on its device (``shard_partitioned``)."""
    return shard_partitioned(part, mesh, axis_name)


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)], [(i, (i - 1) % n)
                                                  for i in range(n)]


def dist_spmv_halo(part: HaloPartitionedCSR, x, mesh: Mesh,
                   axis_name: str = "shard"):
    """``y = A @ x`` exchanging only ``halo`` values with each ring
    neighbour (the wrap links carry values no entry reads)."""
    h = part.halo
    fwd, bwd = _ring(part.n_shards)
    p = shard_partitioned(part, mesh, axis_name)
    from_left = mesh.ppermute(x[-h:], fwd, axis_name)
    from_right = mesh.ppermute(x[:h], bwd, axis_name)
    frame = torch.cat([from_left, x, from_right])
    return local_product(p.indices[0], p.data[0], p.row_ids[0], frame,
                         part.local_rows)


@sparse_container
@dataclasses.dataclass(frozen=True)
class RingHaloCSR:
    own_indices: torch.Tensor  # (n_shards, cap_o) band-local col ids
    own_data: torch.Tensor  # (n_shards, cap_o)
    own_rows: torch.Tensor  # (n_shards, cap_o) local rows (pad: local_rows)
    halo_indices: torch.Tensor  # (n_shards, cap_h) ids in the (2h,) frame
    halo_data: torch.Tensor  # (n_shards, cap_h)
    halo_rows: torch.Tensor  # (n_shards, cap_h)
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    local_rows: int = static_field()
    band: int = static_field()
    halo: int = static_field()
    nnz: int = static_field()


def partition_csr_halo_ring(csr: CSR, n_shards: int,
                            halo: int) -> RingHaloCSR:
    """Row partition split into the owned-column and halo-column blocks;
    the locality contract of ``partition_csr_halo`` (host)."""
    sp, rows, cols, local_rows, band = _bands(csr, n_shards)
    if halo > band:
        raise ValueError(f"halo {halo} larger than band {band}")
    own, hal = [], []
    for s in range(n_shards):
        sub = sp[s * local_rows: min((s + 1) * local_rows, rows)].tocoo()
        c0 = s * band
        if sub.nnz:
            _check_local(s, int(sub.col.min()), int(sub.col.max()),
                         c0 - halo, c0 + band + halo, halo)
        in_band = (sub.col >= c0) & (sub.col < c0 + band)
        own.append((sub.row[in_band], sub.col[in_band] - c0,
                    sub.data[in_band]))
        hc = sub.col[~in_band]
        # frame = (left halo | right halo), width 2*halo
        hf = np.where(hc < c0, hc - (c0 - halo), halo + hc - (c0 + band))
        hal.append((sub.row[~in_band], hf, sub.data[~in_band]))
    cap_o = max(max(len(o[0]) for o in own), 1)
    cap_h = max(max(len(h[0]) for h in hal), 1)
    oi, od, orr = _stack(own, n_shards, cap_o, local_rows, sp.data.dtype)
    hi_, hd, hr = _stack(hal, n_shards, cap_h, local_rows, sp.data.dtype)
    return RingHaloCSR(own_indices=oi, own_data=od, own_rows=orr,
                       halo_indices=hi_, halo_data=hd, halo_rows=hr,
                       shape=(rows, cols), n_shards=n_shards,
                       local_rows=local_rows, band=band, halo=halo,
                       nnz=csr.nnz)


def shard_halo_ring(part: RingHaloCSR, mesh: Mesh,
                    axis_name: str = "shard") -> RingHaloCSR:
    """This rank's slice on its device (``shard_partitioned``)."""
    return shard_partitioned(part, mesh, axis_name)


def dist_spmv_halo_ring(part: RingHaloCSR, x, mesh: Mesh,
                        axis_name: str = "shard"):
    """``y = A @ x``: the exchange first, then the owned partial product
    (which does not read the halos), then the halo partial."""
    h = part.halo
    fwd, bwd = _ring(part.n_shards)
    p = shard_partitioned(part, mesh, axis_name)
    from_left = mesh.ppermute(x[-h:], fwd, axis_name)
    from_right = mesh.ppermute(x[:h], bwd, axis_name)
    y = local_product(p.own_indices[0], p.own_data[0], p.own_rows[0], x,
                      part.local_rows)
    frame = torch.cat([from_left, from_right])
    return y + local_product(p.halo_indices[0], p.halo_data[0],
                             p.halo_rows[0], frame, part.local_rows)


@sparse_container
@dataclasses.dataclass(frozen=True)
class VarHaloPartitionedCSR:
    indices: torch.Tensor  # (n_shards, cap) frame-local col ids
    data: torch.Tensor  # (n_shards, cap)
    row_ids: torch.Tensor  # (n_shards, cap)
    h_l: torch.Tensor  # (n_shards,) left-halo widths
    h_r: torch.Tensor  # (n_shards,)
    in_off: torch.Tensor  # (n_shards, n_shards) send offsets
    send_sz: torch.Tensor  # (n_shards, n_shards)
    out_off: torch.Tensor  # (n_shards, n_shards) receiver-frame offsets
    recv_sz: torch.Tensor  # (n_shards, n_shards)
    shape: Tuple[int, int] = static_field()
    n_shards: int = static_field()
    local_rows: int = static_field()
    band: int = static_field()
    hmax_l: int = static_field()
    hmax_r: int = static_field()
    nnz: int = static_field()

    @property
    def ragged_bytes(self) -> int:
        """Halo bytes moved an exchange with the ragged collective."""
        return int((int(self.h_l.sum()) + int(self.h_r.sum()))
                   * self.data.element_size())

    @property
    def padded_bytes(self) -> int:
        """Halo bytes if every link is padded to the widest halo."""
        return int(self.n_shards * (self.hmax_l + self.hmax_r)
                   * self.data.element_size())


def partition_csr_halo_var(csr: CSR, n_shards: int) -> VarHaloPartitionedCSR:
    """Row partition with per-shard halo widths measured from the columns
    each shard reaches; raises if a shard reaches past its ring neighbours
    (host)."""
    sp, rows, cols, local_rows, band = _bands(csr, n_shards)
    h_l = np.zeros(n_shards, np.int64)
    h_r = np.zeros(n_shards, np.int64)
    subs = []
    for s in range(n_shards):
        sub = sp[s * local_rows: min((s + 1) * local_rows, rows)]
        c0 = s * band
        if sub.nnz:
            cmin, cmax = int(sub.indices.min()), int(sub.indices.max())
            h_l[s] = max(c0 - cmin, 0)
            h_r[s] = max(cmax + 1 - (c0 + band), 0)
            if h_l[s] > band or h_r[s] > band:
                raise ValueError(
                    f"shard {s}: halo ({h_l[s]}, {h_r[s]}) exceeds band "
                    f"{band} — columns reach beyond ring neighbors")
        subs.append(sub)
    hmax_l = max(int(h_l.max()), 1)  # >= 1 keeps the frame shapes nonzero
    hmax_r = max(int(h_r.max()), 1)
    parts = [(np.repeat(np.arange(sub.shape[0]), np.diff(sub.indptr)),
              sub.indices - (s * band - hmax_l), sub.data)
             for s, sub in enumerate(subs)]
    cap = max(max(int(sub.nnz) for sub in subs), 1)
    idx, dat, rid = _stack(parts, n_shards, cap, local_rows, sp.data.dtype)
    # the ragged tables: shard s sends its right edge to s+1's left halo,
    # its left edge to s-1's right halo, and its band to itself
    io = np.zeros((n_shards, n_shards), np.int64)
    ss = np.zeros((n_shards, n_shards), np.int64)
    oo = np.zeros((n_shards, n_shards), np.int64)
    rs = np.zeros((n_shards, n_shards), np.int64)
    for s in range(n_shards):
        ss[s, s] = band
        oo[s, s] = hmax_l
        rs[s, s] = band
        if s + 1 < n_shards and h_l[s + 1] > 0:
            ss[s, s + 1] = h_l[s + 1]
            io[s, s + 1] = band - h_l[s + 1]
            oo[s, s + 1] = hmax_l - h_l[s + 1]
            rs[s + 1, s] = h_l[s + 1]
        if s - 1 >= 0 and h_r[s - 1] > 0:
            ss[s, s - 1] = h_r[s - 1]
            oo[s, s - 1] = hmax_l + band
            rs[s - 1, s] = h_r[s - 1]
    i32 = lambda a: torch.from_numpy(a).to(torch.int32)  # noqa: E731
    return VarHaloPartitionedCSR(
        indices=idx, data=dat, row_ids=rid, h_l=i32(h_l), h_r=i32(h_r),
        in_off=i32(io), send_sz=i32(ss), out_off=i32(oo), recv_sz=i32(rs),
        shape=(rows, cols), n_shards=n_shards, local_rows=local_rows,
        band=band, hmax_l=hmax_l, hmax_r=hmax_r, nnz=csr.nnz)


def dist_spmv_halo_var(part: VarHaloPartitionedCSR, x, mesh: Mesh,
                       axis_name: str = "shard",
                       use_ragged: Optional[bool] = None):
    """``y = A @ x`` with per-shard halos.  ``use_ragged`` (default True,
    on every backend: gloo and NCCL both run ``all_to_all_single``) moves
    each link's own width; False pads every link to the widest halo with
    two ``ppermute``s, the JAX package's path where XLA has no ragged
    collective."""
    if use_ragged is None:
        use_ragged = True
    n = part.n_shards
    band, hmax_l, hmax_r = part.band, part.hmax_l, part.hmax_r
    p = shard_partitioned(part, mesh, axis_name)
    if use_ragged:
        me = mesh.axis_index(axis_name)
        h_l = int(p.h_l[0])
        # where each sender's chunk lands in this rank's frame: the column
        # ``out_off[:, me]`` of the senders' table, known from this rank's
        # own widths
        recv_off = [0] * n
        recv_off[me] = hmax_l
        if me > 0:
            recv_off[me - 1] = hmax_l - h_l
        if me + 1 < n:
            recv_off[me + 1] = hmax_l + band
        frame = torch.zeros(hmax_l + band + hmax_r, dtype=x.dtype,
                            device=x.device)
        frame = mesh.ragged_all_to_all(
            x, frame, p.in_off[0].tolist(), p.send_sz[0].tolist(), recv_off,
            p.recv_sz[0].tolist(), axis_name)
    else:
        fwd, bwd = _ring(n)
        from_left = mesh.ppermute(x[-hmax_l:], fwd, axis_name)
        from_right = mesh.ppermute(x[:hmax_r], bwd, axis_name)
        frame = torch.cat([from_left, x, from_right])
    return local_product(p.indices[0], p.data[0], p.row_ids[0], frame,
                         part.local_rows)
