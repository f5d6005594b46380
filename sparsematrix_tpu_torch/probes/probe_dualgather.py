"""Probe: one dual-gather step against one single-gather step, on the card.

Twin of ``benchmarks/probe_dualgather.py``.  A slab's dual-gather step
routes x twice, ``t1[u, c] = xw[idxA[u, c], c]`` (the chunk select), then
``g[u, l] = t1[u, idxB[u, l]]`` (the lane route), and adds
``vals * g``; the single-gather step routes once, ``g[u, l] =
xw[u, idxB[u, l]]``.  The kernels are ``kernels/probe_gather_step.py``'s
``dual_step`` and ``single_step`` (``csrc/probe_gather_step.cu``).

* P1: the dual step builds and runs (seconds of the first call, the
  kernel's build included).
* P2: its result against the script's fp64 oracle (max error over max
  |oracle| < 1e-4, the script's check) and against its plain version, at
  the script's size (S = 64, group 8, 4 groups, ``default_rng(0)``).
* P3: ns a slab of each step and their ratio, at two sizes: the script's
  (group 64, 16 groups, S = 64: 1024 slabs, which leaves an H100
  launch-bound; x all ones, as the script's timing loop passes it) and
  one that fills the card (group 64, 512 groups: 32768 slabs, with x the
  XL vector of the bench's ``csr_spmv_xl`` point, ``default_rng(9)``,
  S = 256 rows of 128).  Each result is checked as in P2 before its time
  is printed.

Times are ``utils/timer.timed_ms``: the median device time of one call,
CUDA events, the L2 flushed before each call.  That is the port's method,
not the script's in-graph slope of many calls.  Every row is one JSON
line with the card's ``nvidia-smi`` name and power limit; ``--out`` also
writes them to a file.  No single PyTorch call computes a step, so a row
has no library time.

    python -m sparsematrix_tpu_torch.probes.probe_dualgather [--device cpu] [--out rows.json]
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.probe_gather_step import (dual_step, dual_step_reference,
                                         pooled_step, pooled_step_reference,
                                         single_step, single_step_reference)
from ._common import Session, bound, parser, rel_err

__all__ = ["LANES", "TOL", "inputs", "main", "oracle", "run", "time_step",
           "xl_vector"]

LANES = 128
TOL = 1e-4  # the script's check: max error over max |oracle|
_ORACLE_SLABS = 1 << 11  # slabs a step of the oracle

STEPS = {"single": (single_step, single_step_reference),
         "dual": (dual_step, dual_step_reference),
         "pooled": (pooled_step, pooled_step_reference)}


def xl_vector() -> np.ndarray:
    """x of the bench's ``csr_spmv_xl`` point as (256, 128) fp32."""
    x = np.random.default_rng(9).standard_normal(32768).astype(np.float32)
    return x.reshape(256, LANES)


def inputs(rng: np.random.Generator, S: int, group: int, n_groups: int,
           xp: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """The script's planes, drawn in its order: win, idxA, idxB, vals, then
    xp unless given."""
    d = {"win": rng.integers(0, S // 8, (n_groups, group)).astype(np.int32),
         "idxA": rng.integers(0, 8, (n_groups, group * 8, LANES)).astype(
             np.int8),
         "idxB": rng.integers(0, LANES, (n_groups, group * 8, LANES)).astype(
             np.int8),
         "vals": rng.normal(size=(n_groups, group * 8, LANES)).astype(
             np.float32)}
    d["xp"] = (rng.normal(size=(S, LANES)).astype(np.float32) if xp is None
               else xp)
    return d


def oracle(mode: str, d: Dict[str, np.ndarray]) -> np.ndarray:
    """The scripts' fp64 oracle (``probe_dualgather.py``'s ``oracle``, and
    ``probe_sublane_slice.py``'s for ``pooled``), over slabs in chunks:
    (128,) sums.  ``single`` is the dual step with ``idxA[u, c] = u``."""
    xp = d["xp"].astype(np.float64)
    B = d["idxB"].reshape(-1, 8, LANES).astype(np.int64)
    V = d["vals"].reshape(-1, 8, LANES).astype(np.float64)
    out = np.zeros(LANES, np.float64)
    for s0 in range(0, B.shape[0], _ORACLE_SLABS):
        sl = slice(s0, s0 + _ORACLE_SLABS)
        if mode == "pooled":
            rows = d["ptr"].reshape(-1, 8)[sl]  # (n, 8) chunk rows
        else:
            w = d["win"].reshape(-1)[sl].astype(np.int64)
            rows = w[:, None] * 8 + np.arange(8)
        xw = xp[rows]  # (n, 8, 128)
        if mode == "single":
            t1 = xw
        else:
            A = d["idxA"].reshape(-1, 8, LANES)[sl].astype(np.int64)
            t1 = np.take_along_axis(xw, A, axis=1)
        g = np.take_along_axis(t1, B[sl], axis=2)
        out += (V[sl] * g).sum(axis=(0, 1))
    return out


def _args(mode: str, t: Dict[str, torch.Tensor]):
    if mode == "single":
        return (t["win"], t["idxB"], t["vals"], t["xp"])
    if mode == "dual":
        return (t["win"], t["idxA"], t["idxB"], t["vals"], t["xp"])
    return (t["ptr"], t["idxA"], t["idxB"], t["vals"], t["xp"])


def _work(mode: str, d: Dict[str, np.ndarray]):
    """(operations, bytes): an FMA a slot; each plane the step reads, x,
    the window indices and the (8, 128) output once."""
    slots = d["vals"].size
    planes = d["vals"].nbytes + d["idxB"].nbytes
    if mode != "single":
        planes += d["idxA"].nbytes
    index = d["ptr"].nbytes if mode == "pooled" else d["win"].nbytes
    return 2.0 * slots, float(planes + d["xp"].nbytes + index + 8 * 512)


def time_step(sess: Session, mode: str, d: Dict[str, np.ndarray],
              name: str, size: str) -> Dict:
    """Checks ``mode``'s step on ``d`` against the oracle and the plain
    version, then times both; emits and returns the row."""
    kern, plain = STEPS[mode]
    t = {k: torch.from_numpy(v).to(sess.dev) for k, v in d.items()}
    args = _args(mode, t)
    del t
    got = kern(*args)
    want = plain(*args)
    sess.sync()
    ref = oracle(mode, d)
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    err_oracle = rel_err(got_np[0], ref)
    err_plain = float(np.abs(got_np - want_np).max())
    n_slabs = d["idxB"].shape[0] * d["idxB"].shape[1] // 8
    flops, nbytes = _work(mode, d)
    bms, by = bound(flops, nbytes)
    ok = bool(err_oracle < TOL and not got_np[1:].any()
              and err_plain <= 1e-5 * max(float(np.abs(ref).max()), 1e-30))
    row = {"name": name, "size": size, "kernel": f"probe_gather_{mode}",
           "n_slabs": n_slabs, "S": d["xp"].shape[0],
           "group": d["idxB"].shape[1] // 8, "rel_err_oracle": err_oracle,
           "max_abs_err_plain": err_plain, "tol": TOL, "ok": ok,
           "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
           "library_ms": None,
           "library": "none: no single PyTorch call computes the step"}
    if ok:
        row["ms"] = sess.ms(lambda: kern(*args))
        row["plain_ms"] = sess.ms(lambda: plain(*args))
        if row["ms"] is not None:
            row["ns_per_slab"] = row["ms"] * 1e6 / n_slabs
    return sess.emit(row)


def run(sess: Session, card_groups: int = 512) -> bool:
    """P1-P3 (the card size with ``card_groups`` groups of 64); returns
    whether every check passed."""
    rng = np.random.default_rng(0)
    d = inputs(rng, S=64, group=8, n_groups=4)
    t = {k: torch.from_numpy(v).to(sess.dev) for k, v in d.items()}
    t0 = time.perf_counter()
    dual_step(*_args("dual", t))
    sess.sync()
    sess.emit({"name": "probe_dualgather/P1", "kernel": "probe_gather_dual",
               "first_call_s": time.perf_counter() - t0, "ok": True})
    row = time_step(sess, "dual", d, "probe_dualgather/P2", "script P1")
    ok = row["ok"]
    for size, S, n_groups, xp in (("script", 64, 16,
                                   np.ones((64, LANES), np.float32)),
                                  ("card", 256, card_groups, xl_vector())):
        d = inputs(rng, S=S, group=64, n_groups=n_groups, xp=xp)
        ms = {}
        for mode in ("dual", "single"):
            row = time_step(sess, mode, d, f"probe_dualgather/P3-{mode}",
                            size)
            ok &= row["ok"]
            ms[mode] = row.get("ms")
        n_slabs = 64 * n_groups
        summary = {"name": "probe_dualgather/P3", "size": size,
                   "n_slabs": n_slabs}
        if None not in ms.values():
            summary.update(dual_ns_per_slab=ms["dual"] * 1e6 / n_slabs,
                           single_ns_per_slab=ms["single"] * 1e6 / n_slabs,
                           ratio=ms["dual"] / max(ms["single"], 1e-12))
        sess.emit(summary)
    return ok


def main(argv=None) -> int:
    p = parser("The dual-gather step against the single-gather step.")
    args = p.parse_args(argv)
    return 0 if run(Session(args.device, args.out)) else 1


if __name__ == "__main__":
    sys.exit(main())
