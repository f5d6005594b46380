"""Repro twin: the row gather ``take_along_axis(tab, idx, axis=1)`` at the
tile shapes the TPU compiler refused, on the card.

Twin of ``docs/repro_dynamic_gather_shapes.py``, whose Pallas
``gather_kernel`` compiled on a TPU v5e only at the native (8, 128) tile;
(16, 128), (8, 256) and (32, 128) crashed its compiler.  Here
``kernels/probe_tile_gather.py``'s ``tile_gather``
(``csrc/probe_tile_gather.cu``) runs at every one of those shapes:

* with the repro's inputs (``tab = arange`` of the shape, ``idx = 0``),
  held to its exact result (column 0 of each row);
* with indices drawn from ``default_rng(0)`` in [0, C), held to the plain
  version and to numpy's ``take_along_axis`` (bit for bit: a gather does
  no arithmetic), then timed beside the plain version and the one
  PyTorch call that computes it, ``torch.gather(tab, 1, idx)``.

The ``ptxas`` row carries the kernel's ``-Xptxas -v`` report (registers,
shared memory, spills).  Times are ``utils/timer.timed_ms`` (the median
device time of one call, the L2 flushed before it).  Every row is one
JSON line with the card's ``nvidia-smi`` name and power limit; ``--out``
also writes them to a file.

    python -m sparsematrix_tpu_torch.probes.repro_dynamic_gather_shapes [--device cpu] [--out rows.json]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels.probe_tile_gather import tile_gather, tile_gather_reference
from ._common import Session, bound, parser

__all__ = ["SHAPES", "main", "ptxas_lines", "run"]

# the repro's good shape, then the three that crashed Mosaic
SHAPES = ((8, 128), (16, 128), (8, 256), (32, 128))


def ptxas_lines(source: str):
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of
    ``csrc/<source>.cu``, built if it is not."""
    log = str(_build.build([source])[source]["log"])
    return [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]


def run(sess: Session) -> bool:
    """Every shape, the repro's inputs and random ones; returns whether
    every check passed."""
    ok_all = True
    if sess.cuda:
        sess.emit({"name": "repro_dynamic_gather_shapes/ptxas",
                   "kernel": "probe_tile_gather",
                   "ptxas": ptxas_lines("probe_tile_gather")})
    rng = np.random.default_rng(0)
    for R, C in SHAPES:
        tab = torch.arange(R * C, dtype=torch.float32,
                           device=sess.dev).reshape(R, C)
        zero = torch.zeros((R, C), dtype=torch.int32, device=sess.dev)
        got = tile_gather(tab, zero)
        sess.sync()
        want = np.repeat(np.arange(R, dtype=np.float32)[:, None] * C, C, 1)
        exact = bool(np.array_equal(got.cpu().numpy(), want))
        idx_np = rng.integers(0, C, (R, C)).astype(np.int32)
        idx = torch.from_numpy(idx_np).to(sess.dev)
        got = tile_gather(tab, idx)
        plain = tile_gather_reference(tab, idx)
        sess.sync()
        want = np.take_along_axis(tab.cpu().numpy(), idx_np, axis=1)
        got_np = got.cpu().numpy()
        err = float(np.abs(got_np - plain.cpu().numpy()).max())
        ok = exact and err == 0.0 and bool(np.array_equal(got_np, want))
        ok_all &= ok
        bms, by = bound(0.0, 12.0 * R * C)
        row = {"name": f"repro_dynamic_gather_shapes/({R},{C})",
               "kernel": "probe_tile_gather", "shape": [R, C],
               "repro_inputs_exact": exact, "max_abs_err": err, "ok": ok,
               "bound_ms": bms, "bound_by": by, "bytes": 12.0 * R * C,
               "library": "torch.gather(tab, 1, idx)"}
        if ok:
            idx64 = idx.long()
            row.update(ms=sess.ms(lambda: tile_gather(tab, idx)),
                       plain_ms=sess.ms(
                           lambda: tile_gather_reference(tab, idx)),
                       library_ms=sess.ms(
                           lambda: torch.gather(tab, 1, idx64)))
        sess.emit(row)
    return ok_all


def main(argv=None) -> int:
    p = parser("The row gather at the tile shapes Mosaic refused.")
    args = p.parse_args(argv)
    return 0 if run(Session(args.device, args.out)) else 1


if __name__ == "__main__":
    sys.exit(main())
