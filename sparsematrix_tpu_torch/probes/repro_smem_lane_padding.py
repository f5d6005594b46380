"""Repro twin: per-step scalar metadata, flat or 2-D, read by a run of
sequential steps, on the card.

Twin of ``docs/repro_smem_lane_padding.py``, whose Pallas kernels read a
step's scalar from a scalar-prefetch operand: ``kernel_1d`` from a flat
array (``meta[i * 6]``), ``kernel_2d`` from a (512, 6) array
(``meta[i, 0]``), which the TPU lane-pads and the repro records as
unreliable.  512 steps write one (8, 128) block of ``x * meta_i``; the
last step wins, so both give ``x * 3066``.  (The repro's own ``run()``
fails before any kernel runs: its index maps take one argument where the
grid spec passes two.)

Here ``kernels/probe_meta_scale.py``'s ``meta_scale``
(``csrc/probe_meta_scale.cu``) runs three layouts: the flat array, the
(512, 6) array, and the same (512, 6) metadata as a view into a (512, 8)
array (rows padded to 8, read through the row stride).  Each result is
held to the plain version and to ``x * 3066`` exactly, then timed beside
the plain version and the one PyTorch call that computes it,
``x * meta[-6]`` (flat) or ``x * meta[-1, 0]`` (2-D).

The ``ptxas`` row carries the kernel's ``-Xptxas -v`` report.  Times are
``utils/timer.timed_ms`` (the median device time of one call, the L2
flushed before it).  Every row is one JSON line with the card's
``nvidia-smi`` name and power limit; ``--out`` also writes them to a
file.

    python -m sparsematrix_tpu_torch.probes.repro_smem_lane_padding [--device cpu] [--out rows.json]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels.probe_meta_scale import meta_scale, meta_scale_reference
from ._common import Session, bound, parser
from .repro_dynamic_gather_shapes import ptxas_lines

__all__ = ["COLS", "ROWS", "main", "run"]

ROWS, COLS = 512, 6  # the repro's steps and metadata a step


def layouts(dev):
    """(label, meta, cols, library call's scalar) of each layout."""
    flat = torch.arange(ROWS * COLS, dtype=torch.int32, device=dev)
    padded = torch.zeros((ROWS, 8), dtype=torch.int32, device=dev)
    padded[:, :COLS] = flat.view(ROWS, COLS)
    return [("1-D", flat, COLS, lambda m: m[-COLS]),
            ("2-D", flat.view(ROWS, COLS).clone(), None,
             lambda m: m[-1, 0]),
            ("2-D rows padded to 8", padded[:, :COLS], None,
             lambda m: m[-1, 0])]


def run(sess: Session) -> bool:
    """Every layout; returns whether every check passed."""
    if sess.cuda:
        sess.emit({"name": "repro_smem_lane_padding/ptxas",
                   "kernel": "probe_meta_scale",
                   "ptxas": ptxas_lines("probe_meta_scale")})
    x = torch.ones((8, 128), dtype=torch.float32, device=sess.dev)
    want = np.full((8, 128), float((ROWS - 1) * COLS), np.float32)
    ok_all = True
    for label, meta, cols, last in layouts(sess.dev):
        got = meta_scale(meta, x, cols)
        plain = meta_scale_reference(meta, x, cols)
        sess.sync()
        got_np = got.cpu().numpy()
        err = float(np.abs(got_np - plain.cpu().numpy()).max())
        ok = err == 0.0 and bool(np.array_equal(got_np, want))
        ok_all &= ok
        # each input read once (the whole metadata array), out written once
        nbytes = float(meta.numel() * 4 + 2 * x.numel() * 4)
        bms, by = bound(0.0, nbytes)
        row = {"name": f"repro_smem_lane_padding/{label}",
               "kernel": "probe_meta_scale", "steps": ROWS,
               "row_stride": meta.stride(0) if meta.dim() == 2 else COLS,
               "value": float(got_np.flat[0]), "max_abs_err": err,
               "ok": ok, "bound_ms": bms, "bound_by": by, "bytes": nbytes,
               "library": ("x * meta[-6]" if meta.dim() == 1
                           else "x * meta[-1, 0]")}
        if ok:
            row.update(
                ms=sess.ms(lambda: meta_scale(meta, x, cols)),
                plain_ms=sess.ms(lambda: meta_scale_reference(meta, x, cols)),
                library_ms=sess.ms(lambda: x * last(meta)))
        sess.emit(row)
    return ok_all


def main(argv=None) -> int:
    p = parser("Per-step metadata, flat or 2-D, over sequential steps.")
    args = p.parse_args(argv)
    return 0 if run(Session(args.device, args.out)) else 1


if __name__ == "__main__":
    sys.exit(main())
