"""Probe: the calibrate row's copy at two sizes, the timer's linearity.

Twin of ``benchmarks/probe_calibrate_xcheck.py``, which timed its Pallas
copy of 128 MiB (and a 256 MiB twin) with two timers to find the one that
lied.  The port has one timer, ``utils/timer.timed_ms`` (the median device
time of one call, CUDA events, the L2 flushed before each call), so the
cross-check is the time ratio of the two sizes on the same kernel: the
stream copy of kernel row 22 (``kernels/stream_copy.py``'s
``stream_copy``, ``csrc/stream_copy.cu``), held bit for bit to
``x.clone()`` before it is timed.  Each row also times the plain version
(``x.clone()``) and the library's device copy, ``y.copy_(x)``.

Every row is one JSON line with the card's ``nvidia-smi`` name and power
limit; ``--out`` also writes them to a file.

    python -m sparsematrix_tpu_torch.probes.probe_calibrate_xcheck [--device cpu] [--out rows.json]
"""
from __future__ import annotations

import sys

import torch

from ..kernels.stream_copy import stream_copy, stream_copy_reference
from ._common import Session, bound, parser

__all__ = ["main", "run"]


def run(sess: Session, mib: int = 128) -> bool:
    """The copy at ``mib`` and twice ``mib`` MiB of fp32; returns whether
    both copies were exact."""
    ms = {}
    ok_all = True
    g = torch.Generator(device=sess.dev).manual_seed(0)
    for scale in (1, 2):
        n = scale * mib * (1 << 20) // 4
        x = torch.randn(n, generator=g, device=sess.dev)
        got = stream_copy(x)
        sess.sync()
        ok = bool(torch.equal(got, x))
        ok_all &= ok
        del got
        nbytes = 8.0 * n
        bms, by = bound(0.0, nbytes)
        row = {"name": f"probe_calibrate_xcheck/copy-{scale * mib}MiB",
               "kernel": "stream_copy", "bytes": nbytes, "bit_equal": ok,
               "ok": ok, "bound_ms": bms, "bound_by": by,
               "library": "y.copy_(x) (cudaMemcpyAsync)"}
        if ok:
            y = torch.empty_like(x)
            row.update(ms=sess.ms(lambda: stream_copy(x)),
                       plain_ms=sess.ms(lambda: stream_copy_reference(x)),
                       library_ms=sess.ms(lambda: y.copy_(x)))
            if row["ms"] is not None:
                row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
            ms[scale] = row["ms"]
            del y
        sess.emit(row)
        del x
    if ms.get(1) is not None and ms.get(2) is not None:
        sess.emit({"name": "probe_calibrate_xcheck/ratio",
                   "ratio_2x_over_1x": ms[2] / ms[1]})
    return ok_all


def main(argv=None) -> int:
    p = parser("The calibrate row's copy at two sizes.")
    args = p.parse_args(argv)
    return 0 if run(Session(args.device, args.out)) else 1


if __name__ == "__main__":
    sys.exit(main())
