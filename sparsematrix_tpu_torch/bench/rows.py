"""Rows of PERF.md's kernel table at ``chip_smoke.py``'s shapes, their
knobs and the solver iterations they serve, one JSON line a result: the
tool that holds one tree of the port against another inside one call on
the card (parent, change, change, parent)::

    python -m sparsematrix_tpu_torch.bench.rows [--groups G,...] [--label L]
        [--out rows.json]
    python sparsematrix_tpu_torch/bench/rows.py --tree DIR [--groups ...] ...

``--tree`` times the port of the checkout in DIR (another commit, unpacked
with ``git archive``) with this file's cases; the operands come from the
``chip_smoke.py`` generators and ``utils.testutils``, from seeds, so every
tree sees the same ones.  The groups (all by default):

- ``copy``: the stream copy (row 22) at 128 and 256 MiB beside
  ``y.copy_(x)``;
- ``octet``: the octet SpMV (row 15) on the ``spgemm_xl`` pair program's
  auto and trim packs and on the clustered CSR's octet pack; the octet
  SpMM (row 16) on ``spmm_xl/octet-mm`` at k = 32; stage 0 of the window
  permute (row 17) of the auto plan's C permutation; then
  ``spgemm_apply_packed`` and ``_csc`` on the auto plan (device and wall);
- ``chain``: rows 19 and 21 through ``trisolve_waves_apply`` /
  ``_apply_mm`` (and the kernel's launch alone) at ``chip_smoke.py``'s
  plans: IC(0) L and L^T of the 256² Poisson (K = 2), its bf16 plan, the
  K = 3 band of 2048 tiles, each at one and eight right-hand sides, with
  µs a dependent step;
- ``knobs``: the cluster chain's knobs (cluster size, ring stages) and
  its hop parts at the 256² L plan and the band;
- ``cg``: an iteration of ``ilu_cg_xl`` and ``block_cg_xl`` with IC(0)
  waves (device and wall ms, of a tol = 0 run of 25 iterations) and the
  preconditioner's apply alone;
- ``bench``: the bench suite's ``calibrate``, ``spmv_clustered`` and
  ``spgemm_xl`` groups (``--no-bench`` leaves them out).

Device times as ``chip_smoke.py`` takes them (``utils.timer.timed_ms``:
L2 flushed, each call behind a spin), after every kernel of the tree is
built.  A group the tree's port cannot run
(its chain has no knobs) prints a ``skipped`` line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import sys
from pathlib import Path

MIB128 = 128 * 1024 * 1024 // 4  # fp32 elements of the 128 MiB stream
GROUPS = ("copy", "octet", "chain", "knobs", "cg", "bench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="written into every line")
    ap.add_argument("--out", help="also write the lines here, as a list")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated, of " + ", ".join(GROUPS))
    ap.add_argument("--no-bench", action="store_true",
                    help="leave the bench group out")
    args = ap.parse_args(argv)
    groups = [g for g in args.groups.split(",")
              if g and not (args.no_bench and g == "bench")]
    unknown = set(groups) - set(GROUPS)
    if unknown:
        ap.error(f"unknown groups {sorted(unknown)}")
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    # chip_smoke.py's generators, from this checkout where the tree has none
    sys.path.append(str(Path(__file__).resolve().parents[2]))

    import torch

    if not torch.cuda.is_available():
        print("rows: needs a CUDA card", file=sys.stderr)
        return 2
    from sparsematrix_tpu_torch.kernels import _build
    from sparsematrix_tpu_torch.utils.timer import (spin_cycles_per_s,
                                                    timed_ms, wall_ms)

    # every kernel built first: the timer sizes its spin from the warm-up
    # calls' issue time, which a build at the first call would swell
    _build.build()
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

    ctx = dict(dev=dev, emit=emit, ms=ms, wall_ms=wall_ms)
    for group in groups:
        _RUNS[group](**ctx)

    if args.out:
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


def _copy(dev, emit, ms, **_):
    import torch

    copymod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.stream_copy")
    for n in (MIB128, 2 * MIB128):
        x = torch.randn(n, device=dev)
        y = torch.empty_like(x)
        emit({"row": 22, "case": f"{n * 4 >> 20} MiB fp32",
              "ms": ms(lambda: copymod._stream_copy_cuda(x)),
              "library_ms": ms(lambda: y.copy_(x))})
        del x, y


def _octet(dev, emit, ms, wall_ms, **_):
    import chip_smoke as cs
    import torch
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.ops import (apply_permutation, prepare_spmv,
                                            spgemm_apply_packed,
                                            spgemm_apply_packed_csc,
                                            spgemm_plan_packed)

    octmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_octet")
    wpmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.window_permute")
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


def _chain_plans(dev, names=None):
    """The chain plans of ``chip_smoke.py``'s slice 4 (those of ``names``,
    default all): name -> plan, the 256² Poisson IC(0) L and L^T, L in
    bf16, the K = 3 band."""
    import numpy as np
    import torch
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw
    from sparsematrix_tpu_torch.ops import ic0
    from sparsematrix_tpu_torch.utils.testutils import poisson2d, triangular

    _, po_sp = poisson2d(65536)
    L = ic0(CSR.from_scipy(po_sp.astype(np.float32).tocsr(), device=dev))
    build = {
        "ic0 L Poisson 256^2 (K=2)": lambda: tw.trisolve_waves_plan(L),
        "ic0 L^T Poisson 256^2 (upper, reversed)":
            lambda: tw.trisolve_waves_plan(CSR.from_scipy(
                L.to_scipy().T.tocsr(), device=dev), lower=False),
        "ic0 L Poisson 256^2 bf16 plan":
            lambda: tw.trisolve_waves_plan(L, dtype=torch.bfloat16),
        "band n=262144 (K=3, 2048 tiles)":
            lambda: tw.trisolve_waves_plan(CSR.from_scipy(
                triangular(512 * 512, 3, band=380, seed=5), device=dev))}
    return {name: make() for name, make in build.items()
            if names is None or name in names}


def _chain(dev, emit, ms, **_):
    import torch
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    for case, plan in _chain_plans(dev).items():
        n = plan.shape[0]
        for R in (1, 8):
            b = torch.randn((n,) if R == 1 else (n, R), device=dev)
            bk = torch.randn(plan.S * R * 128, device=dev)
            run = ((lambda: tw.trisolve_waves_apply(plan, b)) if R == 1 else
                   (lambda: tw.trisolve_waves_apply_mm(plan, b)))
            t = ms(run)
            emit({"row": 19 if R == 1 else 21, "case": case, "rhs": R,
                  "ms": t, "kernel_ms": ms(lambda: tw._chain_cuda(plan, bk,
                                                                  R)),
                  "dependent_steps": plan.S, "us_a_step": 1e3 * t / plan.S})


def _knobs(dev, emit, ms, **_):
    import torch
    from sparsematrix_tpu_torch.kernels import trisolve_waves as tw

    if "cluster" not in inspect.signature(tw._chain_cuda).parameters:
        emit({"group": "knobs", "skipped": "this tree's chain has no "
              "knobs"})
        return
    cases = ("ic0 L Poisson 256^2 (K=2)", "band n=262144 (K=3, 2048 tiles)")
    for case, plan in _chain_plans(dev, cases).items():
        for R in (1, 8):
            b = torch.randn(plan.S * R * 128, device=dev)
            base = ms(lambda: tw._chain_cuda(plan, b, R))
            row = {"row": 19 if R == 1 else 21, "case": case, "rhs": R,
                   "default_ms": base}
            for kw in [dict(cluster=c) for c in (2, 4, 8, 16)] + [
                    dict(stages=s) for s in (1, 2, 3, 4)] + [
                    dict(parts=1), dict(parts=2)]:
                try:
                    t = ms(lambda: tw._chain_cuda(plan, b, R, **kw))
                except RuntimeError as e:  # a ring that does not fit
                    emit({**row, "knobs": kw, "refused": str(e)})
                    continue
                emit({**row, "knobs": kw, "ms": t,
                      "us_a_step": 1e3 * t / plan.S})


def _cg(dev, emit, ms, wall_ms, **_):
    import numpy as np
    import torch
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.kernels import (pack_dualgather,
                                                spmm_dualgather)
    from sparsematrix_tpu_torch.ops import (ic0_waves_plans, ic_apply,
                                            prepare_spmv)
    from sparsematrix_tpu_torch.solvers import block_cg, cg
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    n, sp = poisson2d(65536, 1.0)
    A = CSR.from_scipy(sp.astype(np.float32).tocsr(), device=dev)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(n).astype(
        np.float32)).to(dev)
    Ap = prepare_spmv(A)
    plans = ic0_waves_plans(A)
    M = lambda r: ic_apply(plans, r)  # noqa: E731
    run = lambda: cg(Ap, b, tol=0.0, maxiter=25, M=M)  # noqa: E731
    emit({"e2e": "cg ilu_cg_xl/ic0-waves", "per_iter_device_ms":
          ms(run) / 25, "per_iter_wall_ms": wall_ms(run) / 25,
          "precond_device_ms": ms(lambda: M(b))})
    B = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n, 8)).astype(np.float32)).to(dev)
    S_bc = pack_dualgather(A, k_tiles=1)
    mm = lambda V: spmm_dualgather(S_bc, V)  # noqa: E731
    Mb = lambda R: ic_apply(plans, R)  # noqa: E731
    run = lambda: block_cg(mm, B, tol=0.0, maxiter=25, M=Mb)  # noqa: E731
    emit({"e2e": "block_cg_xl/block-ic0-waves", "per_iter_device_ms":
          ms(run) / 25, "per_iter_wall_ms": wall_ms(run) / 25,
          "precond_device_ms": ms(lambda: Mb(B))})


def _bench(dev, emit, **_):
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


_RUNS = {"copy": _copy, "octet": _octet, "chain": _chain, "knobs": _knobs,
         "cg": _cg, "bench": _bench}


if __name__ == "__main__":
    sys.exit(main())
