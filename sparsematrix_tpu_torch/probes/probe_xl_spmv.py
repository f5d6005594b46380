"""Probe: what sets the pace of the rowlane SpMV (kernel row 7) on the XL
CSR, on the card.

Twin of ``benchmarks/probe_xl_spmv.py``.  The XL CSR is the bench's
``csr_spmv_xl`` point (n = 32768, 512 column draws a row from
``default_rng(9)``, values uniform in ±1000; x from ``default_rng(9)``).
Rows, under the script's names:

* ``calibrate/matmul-2048`` (fp32 ``a @ a``) and ``calibrate/hbm-stream``
  (``a * 1.0001`` over 64 Mi fp32): the card's rates in this run, plain
  PyTorch as the script's rows are plain XLA (card runs only).
* ``probe_xl/<config>`` for the script's five packs (fp32-g128, fp32-g32,
  fp32-g128-sp4, fp32-g32-sp4, bf16-g32-sp4): host seconds of the pack,
  fill, the script's check against the fp64 product (99.9 % of rows
  within 10 %; for bf16 values the product of the values rounded to bf16,
  the storage contract, since rounding alone moves a row whose sum nearly
  cancels by more than 10 % of the fp32 product; ``ok_vs_fp32`` reports
  the script's check as it was), then ms, ns a slab and the planes' GB/s of
  ``spmv_sell_rowlane``; with a spill tail, the body alone (``main_ms``)
  and the tail alone (``tail_ms``).
* ``probe_xl/variant-<body>`` after fp32-g128, for each body of
  ``kernels/probe_rowlane.py`` (``dma-only``, ``fixed-window``,
  ``slice-no-gather``) on the pack without its tail: checked against its
  plain version (1e-5 of the output's scale), then ms, ns a slab and GB/s,
  beside the real kernel on the same pack in the same run
  (``rowlane_ms``) and the planes' bytes at 3.35 TB/s (``planes_ms``).
* ``probe_xl/trace``: ``utils.profiling.device_trace`` around one call of
  the real kernel on that pack: each kernel it launched and its device
  time (the trace goes to ``--trace DIR``, else to a temporary directory
  that is removed).

Times are ``utils/timer.timed_ms``: the median device time of one call,
CUDA events, the L2 flushed before each call (the port's method, not the
script's in-graph slope of many calls).  Every row is one JSON line with
the card's ``nvidia-smi`` name and power limit; ``--out`` writes the rows
to a file (the script wrote into ``benchmarks/``; this never does).

    python -m sparsematrix_tpu_torch.probes.probe_xl_spmv [--device cpu] [--out rows.json] [--trace DIR]
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from ..formats.csr import CSR
from ..kernels.probe_rowlane import (STEPS, pad_x, probe_rowlane,
                                     probe_rowlane_reference)
from ..kernels.spmv_rowlane import pack_sell_rowlane, spmv_sell_rowlane
from ..utils.profiling import device_trace, kernel_times
from ..utils.roofline import PEAK_BYTES
from ._common import Session, bound, parser

__all__ = ["CONFIGS", "build", "main", "run", "strip_spill"]

# the script's five packs (probe_xl_spmv.py:169-176)
CONFIGS = {
    "fp32-g128": dict(group=128),
    "fp32-g32": dict(group=32),
    "fp32-g128-sp4": dict(group=128, spill_depth=4),
    "fp32-g32-sp4": dict(group=32, spill_depth=4),
    "bf16-g32-sp4": dict(group=32, spill_depth=4, dtype=torch.bfloat16),
}


def build(n: int = 32768, nnz_row: int = 512):
    """The XL CSR and x (the script's ``build()`` and x): (scipy CSR, x)."""
    g = np.random.default_rng(9)
    rows = np.repeat(np.arange(n), nnz_row)
    cols = g.integers(0, n, n * nnz_row)
    data = g.uniform(-1000, 1000, n * nnz_row).astype(np.float32)
    sp = sps.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    return sp, x


def strip_spill(p):
    """The pack without its spill tail."""
    return dataclasses.replace(p, spill=None, spill_packed=None)


def _planes(p):
    """(slabs, bytes of the value and s_idx planes)."""
    n_slabs = p.s_idx.shape[0] * p.group
    return n_slabs, p.vals.numel() * (p.vals.element_size() + 1)


def _script_check(got: np.ndarray, want: np.ndarray) -> bool:
    """The script's check: 99.9 % of rows within 10 % of ``want``."""
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    return bool(np.mean(rel < 0.1) > 0.999)


def calibrate(sess: Session) -> None:
    a = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2048, 2048)).astype(np.float32)).to(sess.dev)
    ms = sess.ms(lambda: a @ a)
    sess.emit({"name": "calibrate/matmul-2048", "ms": ms,
               "tflops": 2 * 2048 ** 3 / (ms * 1e-3) / 1e12})
    big = torch.arange(64 * 2 ** 20, dtype=torch.float32, device=sess.dev)
    ms = sess.ms(lambda: big * 1.0001)
    sess.emit({"name": "calibrate/hbm-stream", "ms": ms,
               "gb_s": 2 * big.numel() * 4 / (ms * 1e-3) / 1e9})


def variants(sess: Session, packed, x: torch.Tensor) -> bool:
    """The three bodies beside the real kernel on ``packed`` (no tail)."""
    body = strip_spill(packed)
    xp = pad_x(x, body.n_win)
    n_slabs, main_bytes = _planes(body)
    real_ms = sess.ms(lambda: spmv_sell_rowlane(body, x))
    ok_all = True
    for step in STEPS:
        got = probe_rowlane(body, xp, step)
        want = probe_rowlane_reference(body, xp, step)
        sess.sync()
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        ok = err <= 1e-5 * scale and bool(torch.isfinite(got).all())
        ok_all &= ok
        reads_x = step != "dma-only"
        flops = (2.0 if reads_x else 1.0) * body.vals.numel()
        nbytes = float(main_bytes + 4 * (body.group_tile.numel()
                                         + body.slab_win.numel())
                       + (4 * xp.numel() if reads_x else 0)
                       + 4 * got.numel())
        bms, by = bound(flops, nbytes)
        row = {"name": f"probe_xl/variant-{step}",
               "kernel": "probe_rowlane_" + step.replace("-", "_"),
               "n_slabs": n_slabs, "group": body.group,
               "max_abs_err": err, "tol": 1e-5 * scale, "ok": ok,
               "bound_ms": bms, "bound_by": by, "flops": flops,
               "bytes": nbytes, "planes_ms": main_bytes / PEAK_BYTES * 1e3,
               "library_ms": None,
               "library": "none: no single PyTorch call computes the body",
               "rowlane_ms": real_ms}
        if ok:
            ms = sess.ms(lambda: probe_rowlane(body, xp, step))
            row["ms"] = ms
            row["plain_ms"] = sess.ms(
                lambda: probe_rowlane_reference(body, xp, step))
            if ms is not None:
                row.update(ns_per_slab=ms * 1e6 / n_slabs,
                           gb_s=main_bytes / (ms * 1e-3) / 1e9,
                           over_rowlane=ms / real_ms)
        sess.emit(row)
    return ok_all


def trace(sess: Session, packed, x: torch.Tensor,
          trace_dir: Optional[str]) -> Dict:
    body = strip_spill(packed)
    spmv_sell_rowlane(body, x)  # warm
    sess.sync()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(trace_dir or tmp) as prof:
            spmv_sell_rowlane(body, x)
            sess.sync()
        kernels = kernel_times(prof)
    return sess.emit({"name": "probe_xl/trace", "kernels": kernels,
                      "trace_dir": trace_dir,
                      "rowlane_kernel": any("spmv_rowlane" in k
                                            for k in kernels)})


def run(sess: Session, sp=None, x_np: Optional[np.ndarray] = None,
        configs: Sequence[str] = tuple(CONFIGS),
        trace_dir: Optional[str] = None, A: Optional[CSR] = None,
        packs: Optional[Dict[str, object]] = None) -> bool:
    """The rows above for ``configs`` on ``sp`` and ``x_np`` (default: the
    XL CSR); ``A`` is ``sp`` as a CSR on the session's device and
    ``packs`` its packs by config, where the caller has them (a row then
    has no ``pack_s``).  Returns whether every check passed (on the card,
    the trace must name the rowlane kernel)."""
    if sp is None:
        sp, x_np = build()
    if sess.cuda:
        calibrate(sess)
    if A is None:
        A = CSR.from_scipy(sp, device=sess.dev)
    x = torch.from_numpy(x_np).to(sess.dev)
    x64 = x_np.astype(np.float64)
    want32 = sp.astype(np.float64) @ x64
    want16 = None
    ok_all = True
    for tag in configs:
        t0 = time.perf_counter()
        packed = (packs or {}).get(tag)
        pack_s = None
        if packed is None:
            packed = pack_sell_rowlane(A, **CONFIGS[tag])
            sess.sync()
            pack_s = time.perf_counter() - t0
        got = spmv_sell_rowlane(packed, x).cpu().numpy().astype(np.float64)
        ok32 = _script_check(got, want32)
        ok = ok32
        if packed.vals.dtype == torch.bfloat16:
            if want16 is None:
                v16 = torch.from_numpy(sp.data.astype(np.float32)).to(
                    torch.bfloat16).double().numpy()
                want16 = sps.csr_matrix((v16, sp.indices, sp.indptr),
                                        shape=sp.shape) @ x64
            ok = _script_check(got, want16)
        ok_all &= ok
        n_slabs, main_bytes = _planes(packed)
        row = {"name": f"probe_xl/{tag}", "kernel": "spmv_rowlane", "ok": ok,
               "ok_vs_fp32": ok32,
               "fill": round(packed.fill_rate, 4), "group": packed.group,
               "pack_s": pack_s, "n_slabs": n_slabs,
               "planes_ms": main_bytes / PEAK_BYTES * 1e3}
        if ok:
            ms = sess.ms(lambda: spmv_sell_rowlane(packed, x))
            row["ms"] = ms
            if ms is not None:
                row.update(ns_per_slab=ms * 1e6 / n_slabs,
                           gb_s=main_bytes / (ms * 1e-3) / 1e9)
            if packed.spill_packed is not None:
                spk = packed.spill_packed
                body = strip_spill(packed)
                row.update(
                    main_ms=sess.ms(lambda: spmv_sell_rowlane(body, x)),
                    tail_ms=sess.ms(lambda: spmv_sell_rowlane(spk, x)),
                    tail_slabs=spk.s_idx.shape[0] * spk.group,
                    tail_group=spk.group, tail_fill=round(spk.fill_rate, 4),
                    spill_nnz=packed.spill.nnz)
        sess.emit(row)
        if tag == "fp32-g128" and ok:
            ok_all &= variants(sess, packed, x)
            if sess.cuda:
                ok_all &= trace(sess, packed, x, trace_dir)["rowlane_kernel"]
        del packed
    return ok_all


def main(argv=None) -> int:
    p = parser("What sets the pace of the XL rowlane SpMV.")
    p.add_argument("--trace", default=None,
                   help="write the trace of the real kernel into this "
                        "directory")
    args = p.parse_args(argv)
    return 0 if run(Session(args.device, args.out),
                    trace_dir=args.trace) else 1


if __name__ == "__main__":
    sys.exit(main())
