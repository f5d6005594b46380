"""Probe: the dual-gather step with each sublane on its own chunk of x
(the "pooled" slab), on the card.

Twin of ``benchmarks/probe_sublane_slice.py``.  A pooled slab takes its
window row by row, ``xw[r] = xp[ptr[g, b, r]]`` for arbitrary chunk rows,
then routes it as the dual-gather step does.  The kernel is
``kernels/probe_gather_step.py``'s ``pooled_step``
(``csrc/probe_gather_step.cu``).

* P1: the pooled step builds and runs (seconds of the first call, the
  kernel's build included).
* P2: its result against the script's fp64 oracle (max error over max
  |oracle| < 1e-4) and against its plain version, at the script's size
  (S = 256, group 8, 4 groups, ``default_rng(0)``, the script's draws).
* P3, which the script's docstring names and its ``main`` never runs: ns
  a slab of the pooled step beside the aligned-window dual step on the
  same planes, at the script's size and at one that fills the card
  (group 64, 512 groups: 32768 slabs, x the XL vector of the bench's
  ``csr_spmv_xl`` point, S = 256), each checked as in P2 before its time
  is printed.

Times are ``utils/timer.timed_ms``: the median device time of one call,
CUDA events, the L2 flushed before each call (the port's method, not the
JAX in-graph slope).  Every row is one JSON line with the card's
``nvidia-smi`` name and power limit; ``--out`` also writes them to a
file.  No single PyTorch call computes the step: no library time.

    python -m sparsematrix_tpu_torch.probes.probe_sublane_slice [--device cpu] [--out rows.json]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..kernels.probe_gather_step import pooled_step
from ._common import Session, parser
from .probe_dualgather import LANES, inputs, time_step, xl_vector

__all__ = ["main", "run"]


def run(sess: Session, card_groups: int = 512) -> bool:
    """P1-P3 (the card size with ``card_groups`` groups of 64); returns
    whether every check passed."""
    rng = np.random.default_rng(0)
    S, group, n_groups = 256, 8, 4
    d = {"ptr": rng.integers(0, S, (n_groups, group, 8)).astype(np.int32),
         "idxA": rng.integers(0, 8, (n_groups, group * 8, LANES)).astype(
             np.int8),
         "idxB": rng.integers(0, LANES, (n_groups, group * 8, LANES)).astype(
             np.int8),
         "vals": rng.normal(size=(n_groups, group * 8, LANES)).astype(
             np.float32),
         "xp": rng.normal(size=(S, LANES)).astype(np.float32)}
    t = {k: torch.from_numpy(v).to(sess.dev) for k, v in d.items()}
    t0 = time.perf_counter()
    pooled_step(t["ptr"], t["idxA"], t["idxB"], t["vals"], t["xp"])
    sess.sync()
    del t
    sess.emit({"name": "probe_sublane_slice/P1",
               "kernel": "probe_gather_pooled",
               "first_call_s": time.perf_counter() - t0, "ok": True})
    ok = time_step(sess, "pooled", d, "probe_sublane_slice/P2",
                   "script")["ok"]
    d["win"] = rng.integers(0, S // 8, (n_groups, group)).astype(np.int32)
    for size in ("script", "card"):
        if size == "card":
            d = inputs(rng, S=256, group=64, n_groups=card_groups,
                       xp=xl_vector())
            d["ptr"] = rng.integers(0, 256, (card_groups, 64, 8)).astype(
                np.int32)
        ms = {}
        for mode in ("pooled", "dual"):
            row = time_step(sess, mode, d, f"probe_sublane_slice/P3-{mode}",
                            size)
            ok &= row["ok"]
            ms[mode] = row.get("ms")
        n_slabs = d["idxB"].shape[0] * d["idxB"].shape[1] // 8
        summary = {"name": "probe_sublane_slice/P3", "size": size,
                   "n_slabs": n_slabs}
        if None not in ms.values():
            summary.update(pooled_ns_per_slab=ms["pooled"] * 1e6 / n_slabs,
                           dual_ns_per_slab=ms["dual"] * 1e6 / n_slabs,
                           ratio=ms["pooled"] / max(ms["dual"], 1e-12))
        sess.emit(summary)
    return ok


def main(argv=None) -> int:
    p = parser("The pooled (per-sublane chunk) dual-gather step.")
    args = p.parse_args(argv)
    return 0 if run(Session(args.device, args.out)) else 1


if __name__ == "__main__":
    sys.exit(main())
