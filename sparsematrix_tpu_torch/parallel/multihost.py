"""Multi-process initialization of the distribution layer.

Twin of ``sparsematrix_tpu/parallel/multihost.py``.  Every rank runs the
same program; ``initialize_multihost`` starts ``torch.distributed`` (the
twin of ``jax.distributed.initialize``) and ``global_mesh`` returns the
mesh over every rank, so the same ``dist_*`` code runs on one card, one
host or several hosts: only the mesh differs.  Nothing on a machine tells
a program of a cluster, so give the coordinator's address, the world size
and this process's rank, or launch under ``torchrun`` (its environment:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import resolve_device
from .mesh import Mesh, make_mesh, make_mesh_2d

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> None:
    """``init_process_group`` for this process.

    ``coordinator_address``: ``"host:port"`` (a TCP store on rank 0) or any
    ``init_method`` URL (``"tcp://..."``, ``"file://..."``); with it,
    ``num_processes`` and ``process_id`` are required.  Without it the
    rendezvous comes from torchrun's environment.  ``backend`` defaults to
    ``"nccl"`` on the card and ``"gloo"`` for ``device="cpu"``.  On the
    card the rank's device is set first: ``LOCAL_RANK``, else the rank
    modulo the cards of the host.
    """
    dev = resolve_device(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("num_processes and process_id are required "
                             "with a coordinator_address")
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    else:
        method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=method, rank=rank, world_size=world)


def global_mesh(axis_names: Sequence[str] = ("shard",),
                shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """The mesh over every rank: 1-D with no ``shape``, else the ranks
    reshaped to a 2-D ``shape``."""
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        return make_mesh(axis_name=axis_names[0], device=device)
    if len(shape) == 1:
        return make_mesh(int(shape[0]), axis_names[0], device)
    if len(shape) != 2:
        raise ValueError("global_mesh builds 1-D and 2-D meshes")
    return make_mesh_2d(int(shape[0]), int(shape[1]), tuple(axis_names),
                        device)
