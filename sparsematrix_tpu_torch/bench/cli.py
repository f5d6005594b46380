"""Benchmark CLI with the reference ``blas_test``'s ergonomics.

Twin of ``sparsematrix_tpu/bench/cli.py``::

    python -m sparsematrix_tpu_torch.bench [m] [n] [k] [check] [filter] [json_path]

``m/n/k`` accept ``begin:end`` doubling sweeps; ``check`` toggles oracle
verification; ``filter`` is a comma-separated regex list, ``-pat``
excludes; ``json_path`` receives the rows (the JAX keys).  The
``BENCH_BUDGET`` environment variable (seconds) stops the sweep before
the next group once it is spent.  The command line runs on the card;
``main(argv, device="cpu")`` runs the plain versions on the host (the
tests).  The JAX CLI's compilation-cache settings have no twin: the
kernels' builds are cached by ``kernels/_build.py``.
"""
from __future__ import annotations

import json
import os
import sys
import time

from ..config import resolve_device
from .harness import BenchFilter, StepList
from .suite import REF_K, REF_M, REF_N, registry

__all__ = ["main"]


def main(argv=None, device=None):
    argv = argv if argv is not None else sys.argv[1:]
    dev = resolve_device(device)
    budget = os.environ.get("BENCH_BUDGET")
    deadline = time.monotonic() + float(budget) if budget else None
    m = StepList(argv[0]) if len(argv) > 0 else StepList(REF_M)
    n = StepList(argv[1]) if len(argv) > 1 else StepList(REF_N)
    k = StepList(argv[2]) if len(argv) > 2 else StepList(REF_K)
    check = bool(int(argv[3])) if len(argv) > 3 else True
    filt = BenchFilter(argv[4] if len(argv) > 4 else None)

    # the run's calibration first, on the card: the fixed-artifact rows that
    # let two result files be normalized against each other (SoL
    # denominators stay on the spec sheet)
    if dev.type == "cuda" and filt.accept("calibrate"):
        registry.run(BenchFilter("^calibrate$"), check=check, device=dev)

    for mi in m:
        for ni in n:
            for ki in k:
                registry.run(filt, check=check, ref_m=mi, ref_n=ni, ref_k=ki,
                             skip={"calibrate"}, deadline=deadline,
                             device=dev)
    registry.print_table()

    json_path = argv[5] if len(argv) > 5 else None
    if json_path:
        # the JAX keys; ``extras`` also carries the timer's (the median)
        rows = [
            {
                "name": r.name,
                "shape": r.shape,
                "min_ms": r.result.min_ms,
                "mean_ms": r.result.mean_ms,
                "gnnz_per_s": r.nnz_per_s / 1e9,
                "sol_frac": r.sol_frac,
                "checked": r.checked,
                "nnz": r.nnz,
                "extras": {**r.result.extras, **r.extras},
            }
            for r in registry.rows
        ]
        with open(json_path, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
