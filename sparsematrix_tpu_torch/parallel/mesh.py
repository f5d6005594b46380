"""The device mesh of the distribution layer, on ``torch.distributed``.

Twin of ``jax.sharding.Mesh`` and of the ``jax.lax`` collectives that
``sparsematrix_tpu/parallel`` uses.  JAX's ``shard_map`` is one
controller over global arrays; ``torch.distributed`` runs one process a
rank.  A ``Mesh`` is one process's view: the process group of each mesh
axis, its index and the group's size on each axis, its device, the axis
names.  The collectives take an axis name, as the ``jax.lax`` ones do:

* ``all_gather(x, axis)``: ``jax.lax.all_gather(tiled=True)``, by
  ``dist.all_gather_into_tensor``;
* ``psum(x, axis)``: ``jax.lax.psum``, by ``dist.all_reduce``;
* ``psum_scatter(x, axis)``: ``jax.lax.psum_scatter(tiled=True)``, by
  ``dist.reduce_scatter_tensor``;
* ``ppermute(x, perm, axis)``: ``jax.lax.ppermute``, by
  ``dist.batch_isend_irecv``;
* ``ragged_all_to_all(...)``: ``jax.lax.ragged_all_to_all``, by
  ``dist.all_to_all_single`` with split sizes;
* ``axis_index(axis)``: ``jax.lax.axis_index``, this rank's index.

The calling convention follows the ``shard_map`` body: every ``dist_*``
takes this rank's band of x (or X) and returns this rank's band of y (a
replicated output stays replicated).  ``shard_partitioned`` keeps this
rank's slice of a partition's stacked planes on its device;
``shard_vector``/``gather_vector`` cut a global tensor into this rank's
band by the JAX padding rules (``dist_ops.py:201-214``: zero-padded to
n · ceil(len / n)) and put the bands back together.

Host staging: on a ``gloo`` group a collective's CUDA operands are copied
to the host, exchanged there and copied back.  gloo takes CUDA tensors
for only some collectives, and one rule keeps every collective on one
path.  The rule is read from the group's backend, never from a failed
call; NCCL exchanges CUDA tensors in place.  The compute stays on the
card either way (several ranks on one card run on gloo, since NCCL
refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "shard_partitioned",
           "shard_vector", "gather_vector", "band"]


def band(total: int, n: int) -> int:
    """The JAX band rule: ceil(total / n) (``dist_ops._band``)."""
    return -(-total // n)


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a device mesh (see the module docstring)."""

    axis_names: Tuple[str, ...]
    groups: Tuple[object, ...]  # a ProcessGroup an axis
    ranks: Tuple[int, ...]  # this process's index on each axis
    sizes: Tuple[int, ...]  # the group's size on each axis
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out

    def _axis(self, axis: Optional[str]) -> int:
        if axis is None:
            if len(self.axis_names) != 1:
                raise ValueError(f"name an axis of {self.axis_names}")
            return 0
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        return self.axis_names.index(axis)

    def axis_index(self, axis: Optional[str] = None) -> int:
        return self.ranks[self._axis(axis)]

    def axis_size(self, axis: Optional[str] = None) -> int:
        return self.sizes[self._axis(axis)]

    def staged(self, axis: Optional[str] = None) -> bool:
        """Whether this axis's collectives go through the host: a gloo
        group with CUDA operands (module docstring)."""
        return (self.device.type == "cuda"
                and dist.get_backend(self.groups[self._axis(axis)]) == "gloo")

    def _run(self, axis, fn, *tensors):
        """``fn(group, *tensors)`` with the operands staged through the host
        where this axis needs it; returns fn's tensor on the operands'
        device."""
        i = self._axis(axis)
        dev = tensors[0].device
        if self.staged(axis):
            tensors = tuple(t.cpu() for t in tensors)
        with warnings.catch_warnings():
            # the *_into_tensor / *_tensor names warn on newer torch
            warnings.simplefilter("ignore", FutureWarning)
            out = fn(self.groups[i], *tensors)
        return out.to(dev)

    # -- collectives --------------------------------------------------------
    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None):
        """The bands of every rank of ``axis`` stacked along dim 0
        (``jax.lax.all_gather(tiled=True)``)."""
        n = self.axis_size(axis)

        def run(group, xs):
            out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                              dtype=xs.dtype, device=xs.device)
            dist.all_gather_into_tensor(out, xs.contiguous(), group=group)
            return out

        return self._run(axis, run, x)

    def psum(self, x: torch.Tensor, axis: Optional[str] = None):
        """The sum over the ranks of ``axis``, on every rank."""
        def run(group, xs):
            out = xs.clone()
            dist.all_reduce(out, group=group)
            return out

        return self._run(axis, run, x)

    def psum_scatter(self, x: torch.Tensor, axis: Optional[str] = None):
        """The sum over the ranks of ``axis``, this rank keeping band i of
        dim 0 (``jax.lax.psum_scatter(scatter_dimension=0, tiled=True)``)."""
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split "
                             f"into {n} bands")

        def run(group, xs):
            out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                              dtype=xs.dtype, device=xs.device)
            dist.reduce_scatter_tensor(out, xs.contiguous(), group=group)
            return out

        return self._run(axis, run, x)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 axis: Optional[str] = None):
        """``jax.lax.ppermute``: each (src, dst) pair sends src's ``x`` to
        dst; a rank that no pair sends to gets zeros."""
        me = self.axis_index(axis)

        def run(group, xs):
            out = torch.zeros_like(xs)
            ops = []
            for src, dst in perm:
                if src == me and dst == me:
                    out.copy_(xs)
                elif src == me:
                    ops.append(dist.P2POp(dist.isend, xs.contiguous(),
                                          dist.get_global_rank(group, dst),
                                          group))
                elif dst == me:
                    ops.append(dist.P2POp(dist.irecv, out,
                                          dist.get_global_rank(group, src),
                                          group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return out

        return self._run(axis, run, x)

    def ragged_all_to_all(self, x: torch.Tensor, out: torch.Tensor,
                          input_offsets: Sequence[int],
                          send_sizes: Sequence[int],
                          recv_offsets: Sequence[int],
                          recv_sizes: Sequence[int],
                          axis: Optional[str] = None):
        """``jax.lax.ragged_all_to_all`` by ``dist.all_to_all_single`` with
        split sizes: ``x[input_offsets[j]:+send_sizes[j]]`` goes to rank j,
        and the ``recv_sizes[i]`` values from rank i land at
        ``recv_offsets[i]`` of a copy of ``out``.  JAX passes the senders'
        output offsets with the data; here the receiver gives where each
        chunk lands (the column of the senders' table).  Offsets and sizes
        are host integers."""
        send_sizes = [int(s) for s in send_sizes]
        recv_sizes = [int(s) for s in recv_sizes]

        def run(group, xs, outs):
            send = torch.cat([xs[int(o): int(o) + s]
                              for o, s in zip(input_offsets, send_sizes)])
            recv = torch.empty(sum(recv_sizes), dtype=xs.dtype,
                               device=xs.device)
            dist.all_to_all_single(recv, send, output_split_sizes=recv_sizes,
                                   input_split_sizes=send_sizes, group=group)
            frame = outs.clone()
            pos = 0
            for o, s in zip(recv_offsets, recv_sizes):
                frame[int(o): int(o) + s] = recv[pos: pos + s]
                pos += s
            return frame

        return self._run(axis, run, x, out)


def _require_initialized():
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "initialize_multihost (or init_process_group) first")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shard",
              device=None) -> Mesh:
    """A 1-D mesh over every rank of the default process group, on this
    rank's device (default: the current CUDA device; ``device="cpu"`` for
    the plain versions)."""
    _require_initialized()
    n = dist.get_world_size()
    if n_devices not in (None, n):
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{n} ranks, one a mesh device")
    return Mesh((axis_name,), (dist.group.WORLD,), (dist.get_rank(),), (n,),
                _rank_device(device))


def make_mesh_2d(n_row: int, n_col: int, axis_names=("row", "col"),
                 device=None) -> Mesh:
    """A 2-D mesh (``init_device_mesh``, a subgroup an axis) over the
    n_row × n_col ranks of the default group, row-major as the JAX
    ``make_mesh_2d`` reshapes its devices."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_initialized()
    dev = _rank_device(device)
    dm = init_device_mesh(dev.type, (n_row, n_col),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names),
                tuple(dm.get_group(a) for a in axis_names),
                tuple(dm.get_local_rank(a) for a in axis_names),
                (n_row, n_col), dev)


def shard_partitioned(part, mesh: Mesh, axis_name: Optional[str] = None):
    """This rank's slice of a partition: every tensor field's leading shard
    axis cut to this rank's entry (kept as a leading axis of 1, as the
    ``shard_map`` body sees it) and put on the mesh's device.  A slice
    made already passes through unchanged."""
    i = mesh.axis_index(axis_name)
    changes = {}
    for name in part._data_fields:
        t = getattr(part, name)
        if t.shape[0] == part.n_shards:
            t = t[i: i + 1]
        elif t.shape[0] != 1:
            raise ValueError(f"{type(part).__name__}.{name}: leading axis "
                             f"{t.shape[0]} is neither {part.n_shards} "
                             f"shards nor one")
        changes[name] = t.to(mesh.device)
    return dataclasses.replace(part, **changes)


def shard_vector(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None,
                 length: Optional[int] = None, dim: int = 0) -> torch.Tensor:
    """This rank's band of ``x`` along ``dim``: x zero-padded to
    n · ceil(length / n) (``length`` defaults to x's size), cut into n
    bands; on the mesh's device."""
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    b = band(x.shape[dim] if length is None else length, n)
    x = x.to(mesh.device)
    pad = list(x.shape)
    pad[dim] = n * b
    full = torch.zeros(pad, dtype=x.dtype, device=x.device)
    take = min(x.shape[dim], n * b)
    full.narrow(dim, 0, take).copy_(x.narrow(dim, 0, take))
    return full.narrow(dim, i * b, b).contiguous()


def gather_vector(y: torch.Tensor, mesh: Mesh, length: int,
                  axis: Optional[str] = None, dim: int = 0) -> torch.Tensor:
    """The bands of every rank of ``axis`` put back together along
    ``dim`` and cut to ``length``."""
    if dim == 0:
        return mesh.all_gather(y, axis)[:length]
    moved = y.movedim(dim, 0).contiguous()
    return mesh.all_gather(moved, axis)[:length].movedim(0, dim)
