"""Benchmark harness with the reference CLI's ergonomics.

Twin of ``sparsematrix_tpu/bench/harness.py``, which replicates the
capability set of the reference's ``blas_test``: a named benchmark
registry, regex include/exclude filters (``-pattern`` excludes),
``begin:end`` doubling shape sweeps (``StepList``), an oracle-check
toggle, and a timing table with nnz/s and roofline % columns.

``BenchRegistry.run`` keeps the JAX behaviour on a failing group: it
prints the traceback and goes on to the next group.  It also records the
group's name in ``registry.failed`` (and a group may record a variant it
dropped there), so that a caller can refuse the run.
"""
from __future__ import annotations

import re
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.timer import BenchResult

__all__ = ["StepList", "BenchFilter", "BenchRegistry", "Row"]


class StepList:
    """Parse ``"begin:end"`` into a doubling sweep, or a single value."""

    def __init__(self, spec: str | int):
        if isinstance(spec, int):
            self.values = [spec]
            return
        if ":" in spec:
            b, e = spec.split(":")
            b, e = int(b), int(e)
            vals = []
            v = b
            while v <= e:
                vals.append(v)
                v *= 2
            self.values = vals
        else:
            self.values = [int(spec)]

    def __iter__(self):
        return iter(self.values)


class BenchFilter:
    """Regex include/exclude: ``-pat`` excludes, ``pat`` includes."""

    def __init__(self, patterns: Optional[str] = None):
        self.includes: List[re.Pattern] = []
        self.excludes: List[re.Pattern] = []
        if patterns:
            for p in patterns.split(","):
                p = p.strip()
                if not p:
                    continue
                if p.startswith("-"):
                    self.excludes.append(re.compile(p[1:]))
                else:
                    self.includes.append(re.compile(p))

    def accept(self, name: str) -> bool:
        if any(p.search(name) for p in self.excludes):
            return False
        if self.includes:
            return any(p.search(name) for p in self.includes)
        return True


@dataclass
class Row:
    name: str
    shape: str
    result: BenchResult
    nnz: int = 0
    checked: Optional[bool] = None
    sol_frac: Optional[float] = None  # fraction of speed-of-light
    extras: Dict = field(default_factory=dict)

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / (self.result.min_ms * 1e-3) if self.nnz else 0.0


class BenchRegistry:
    def __init__(self):
        self._benches: Dict[str, Callable] = {}
        self.rows: List[Row] = []
        # names of the groups that raised, and of variants a group dropped
        self.failed: List[str] = []
        # rows dropped as unreliable
        self.dropped: List[str] = []

    def register(self, name: str):
        def deco(fn):
            self._benches[name] = fn
            return fn

        return deco

    def run(self, filt: BenchFilter, skip=None, deadline=None,
            **kwargs) -> List[Row]:
        """``deadline`` (a ``time.monotonic()`` stamp) stops cleanly
        BEFORE the next group starts, so an outer time limit never kills
        the process mid-group and the partial JSON still gets written."""
        for name, fn in self._benches.items():
            if not filt.accept(name) or (skip and name in skip):
                continue
            if deadline is not None and time.monotonic() > deadline:
                print(f"[budget] BENCH_BUDGET exhausted — skipping {name} "
                      "and the rest of this sweep", flush=True)
                break
            t0 = time.perf_counter()
            try:
                rows = fn(**kwargs)
            except Exception:
                print(f"[bench] {name} FAILED:", file=sys.stderr)
                traceback.print_exc()
                self.failed.append(name)
                continue
            finally:
                # the group's wall seconds, its packs and checks included
                print(f"[group] {name} {time.perf_counter() - t0:.1f}s",
                      flush=True)
            self.extend(rows if isinstance(rows, list) else [rows])
        return self.rows

    def extend(self, rows: List[Row]) -> None:
        """Print and keep ``rows``; a row whose timing is flagged
        ``unreliable`` is printed as dropped and not kept."""
        for r in rows:
            sol = f"{100*r.sol_frac:.1f}%" if r.sol_frac is not None else "-"
            if r.result.extras.get("unreliable"):
                print(f"[drop] {r.name} {r.shape} UNRELIABLE "
                      f"(above the card's spec sheet)", flush=True)
                self.dropped.append(r.name)
                continue
            print(f"[row] {r.name} {r.shape} min={r.result.min_ms:.4f}ms "
                  f"gnnz/s={r.nnz_per_s/1e9:.2f} sol={sol} "
                  f"check={r.checked}", flush=True)
            self.rows.append(r)

    def print_table(self):
        hdr = f"{'bench':<34} {'shape':<22} {'min ms':>9} {'mean ms':>9} {'Gnnz/s':>8} {'SoL%':>6} {'check':>6}"
        print(hdr)
        print("-" * len(hdr))
        for r in self.rows:
            sol = f"{100*r.sol_frac:.1f}" if r.sol_frac is not None else "-"
            chk = {True: "ok", False: "FAIL", None: "-"}[r.checked]
            print(
                f"{r.name:<34} {r.shape:<22} {r.result.min_ms:>9.3f} "
                f"{r.result.mean_ms:>9.3f} {r.nnz_per_s/1e9:>8.2f} {sol:>6} {chk:>6}"
            )
