"""Rows 15, 16, 17 and 22 of PERF.md's kernel table at ``chip_smoke.py``'s
shapes, the ``spgemm_xl`` numeric phase end to end and three bench groups,
one JSON line a result: the tool that holds one tree of the port against
another inside one call on the card (parent, change, change, parent)::

    python -m sparsematrix_tpu_torch.bench.rows [--label L] [--out rows.json]
    python sparsematrix_tpu_torch/bench/rows.py --tree DIR [--label L] ...

``--tree`` times the port of the checkout in DIR (another commit, unpacked
with ``git archive``) with this file's cases; the operands come from the
``chip_smoke.py`` generators, from seeds, so every tree sees the same
ones.  The rows: the octet SpMV (row 15) on the ``spgemm_xl`` pair
program's auto and trim packs and on the clustered CSR's octet pack; the
octet SpMM (row 16) on the ``spmm_xl/octet-mm`` matrix at k = 32; stage 0
of the window permute (row 17) of the auto plan's C permutation; the
stream copy (row 22) at 128 and 256 MiB beside ``y.copy_(x)``; then
``spgemm_apply_packed`` and ``_csc`` on the auto plan (device and wall
ms); then the bench suite's ``calibrate``, ``spmv_clustered`` and
``spgemm_xl`` groups (``--no-bench`` skips them).  Device times as
``chip_smoke.py`` takes them (``utils.timer.timed_ms``: L2 flushed, each
call behind a spin).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

MIB128 = 128 * 1024 * 1024 // 4  # fp32 elements of the 128 MiB stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="written into every line")
    ap.add_argument("--out", help="also write the lines here, as a list")
    ap.add_argument("--no-bench", action="store_true",
                    help="skip the bench groups")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    # chip_smoke.py's generators, from this checkout where the tree has none
    sys.path.append(str(Path(__file__).resolve().parents[2]))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rows: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.ops import (apply_permutation, prepare_spmv,
                                            spgemm_apply_packed,
                                            spgemm_apply_packed_csc,
                                            spgemm_plan_packed)
    from sparsematrix_tpu_torch.utils.timer import (spin_cycles_per_s,
                                                    timed_ms, wall_ms)

    octmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_octet")
    copymod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.stream_copy")
    wpmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.window_permute")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    rate = spin_cycles_per_s()
    lines = []

    def emit(row):
        row = {"tree": args.label, **row}
        print(json.dumps(row), flush=True)
        lines.append(row)

    def ms(fn):
        return timed_ms(fn, flush, rate)

    for n in (MIB128, 2 * MIB128):
        x = torch.randn(n, device=dev)
        y = torch.empty_like(x)
        emit({"row": 22, "case": f"{n * 4 >> 20} MiB fp32",
              "ms": ms(lambda: copymod._stream_copy_cuda(x)),
              "library_ms": ms(lambda: y.copy_(x))})
        del x, y

    sa, sb = cs.spgemm_xl_operands()
    A = CSR.from_scipy(sa, device=dev)
    B = CSR.from_scipy(sb, device=dev)
    pp = spgemm_plan_packed(A, B)
    pt = spgemm_plan_packed(A, B, layout="octet", outputs=("csc",),
                            trim_group=8)
    sp_clu, x_clu = cs.clustered_matrix()
    cases = [("spgemm_xl P auto octet", pp.p_packed,
              apply_permutation(pp.b_perm, B.data)),
             ("spgemm_xl P octet trim_group=8 (rem)", pt.p_packed,
              apply_permutation(pt.b_perm, B.data)),
             ("clustered octet (auto)",
              prepare_spmv(CSR.from_scipy(sp_clu, device=dev),
                           layout="octet"),
              torch.from_numpy(x_clu).to(dev))]
    for case, P, x in cases:
        emit({"row": 15, "case": case,
              "ms": ms(lambda: octmod._spmv_octet_cuda(P, x))})

    sp_omm, X_omm = cs.octet_mm_matrix()
    P_omm = octmod.pack_octet(CSR.from_scipy(sp_omm, device=dev))
    X = torch.from_numpy(X_omm).to(dev)
    emit({"row": 16, "case": "spmm_xl octet-mm k=32",
          "ms": ms(lambda: octmod._spmm_octet_cuda(P_omm, X))})

    trip = pp.c_perm.planes[0]
    v = torch.randn((trip[0].shape[0], 8, 128), device=dev)
    emit({"row": 17, "case": f"spgemm_xl c_perm q={pp.c_perm.q} stage 0",
          "ms": ms(lambda: wpmod._window_permute_cuda(v, *trip))})

    for label, run in (
            ("spgemm_apply_packed XL auto (octet), CSR out",
             lambda: spgemm_apply_packed(pp, B.data)),
            ("spgemm_apply_packed_csc XL auto (octet)",
             lambda: spgemm_apply_packed_csc(pp, B.data))):
        emit({"e2e": label, "device_ms": ms(run), "wall_ms": wall_ms(run)})

    if not args.no_bench:
        from sparsematrix_tpu_torch.bench import cli, suite

        cli.main(["117", "1023", "2047", "1",
                  "^calibrate$,^spmv_clustered$,^spgemm_xl$"], device=dev)
        for r in suite.registry.rows:
            emit({"bench": r.name, "shape": r.shape,
                  "min_ms": r.result.min_ms,
                  "median_ms": r.result.extras.get("median_ms"),
                  "checked": r.checked})
        if suite.registry.failed:
            emit({"bench_failed": [str(f) for f in suite.registry.failed]})

    if args.out:
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
