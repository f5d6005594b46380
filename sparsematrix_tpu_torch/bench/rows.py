"""Rows of PERF.md's kernel table at ``chip_smoke.py``'s shapes, their
knobs and the solver iterations they serve, one JSON line a result: the
tool that holds one tree of the port against another inside one call on
the card (parent, change, change, parent)::

    python -m sparsematrix_tpu_torch.bench.rows [--groups G,...] [--label L]
        [--out rows.json] [--quick]
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
- ``fused``: row 18 through ``trisolve_fused_apply`` (and the wrapper's
  launch alone) on the IC(0) L and L^T of the 256² Poisson and its L at
  1024² (the plan ``trisolve()`` takes there), with µs a wave (the waves
  of a level-sorted Poisson plan are its levels less the first); both
  triangular solves of ``splu_solve``'s fused engine on the convection
  system at n = 16384, and ``splu_solve`` itself; an iteration of
  ``ilu_cg_xl`` with IC(0) fused plans (device and wall ms, of a tol = 0
  run of 25 iterations); where the tree's walk has knobs, its cluster
  sizes, lanes a row and ablations at the Poisson plans;
- ``walk``: rows 14 and 13 at k = 32 on the XL CSR (its k_tiles = 1
  pack and ``prepare_spmv``'s), beside cuSPARSE; row 14 at k = 1, 8, 33
  and 64 and with bf16 values there, on the ``spmm_xl`` matrices of 64
  and 2 a row, and on ``block_cg_xl``'s Poisson system at k = 8; where
  the tree's walk has steps, each step alone in every case and slabs a
  block at the XL and block CG cases;
- ``bsr``: the panel BSR product (row 4) on ``block_cg_xl``'s Poisson
  system as a (8, 8) BSR at k = 8, the XL (8, 8) BSR and the bench's
  (8, 8) BSR at k = 128 (and bf16), beside its plain version and
  ``torch.sparse_bsr_tensor @ X``; where the tree has designs, each forced,
  and at k = 8 and 32 on the XL and bench BSRs; the grouped kernel (row 3)
  at (128, 128), (64, 64) and (32, 128), n = 16384 (10 % of the block
  slots), k = 128 (and bf16 at (128, 128)), and the bench (8, 8); where
  the tree has its designs, each forced and the tile plan's splits; an
  iteration of plain ``block_cg`` on the (8, 8) BSR Poisson (device and
  wall ms, and to tol 1e-5);
- ``tile``: row 3's tile design at (128, 128), n = 16384, k = 128, fp32
  and bf16: the default, each ``ring``, splits, 64-column tiles, and the
  ablations (the tiles alone, the partials' sums alone), where the tree
  has them;
- ``rl``: the row-lane SpMM (row 8) on the XL CSR as
  ``partition_rowlane`` packs it for one rank (fp32 and bf16 values; k =
  8, 32, 64) beside cuSPARSE at fp32 k = 32, and at the bench's
  ``spmm_csr/rowlane`` point (n = 2048, d = 0.05, k = 32) and at d =
  0.002 (a sparse pack: few slabs a window); where the tree has them,
  each walk forced and the gather walk's parts; row 14 (the
  k_tiles = 1 dual-gather walk) on the same CSR at k = 32; then
  ``dist_spmm_rowlane`` at world size 1 (NCCL) on the XL partition, beside
  its local kernel alone;
- ``sb``: the dual-gather SpMM on superblock packs (row 13) of the XL CSR:
  ``prepare_spmv``'s at k = 1, 8, 32, 33 and 64 (cuSPARSE beside k = 32),
  the bench's two-window ``group=128, k_tiles=8``, the nibble pack of
  ``k_tiles=8`` and the bf16 ``group=512, k_tiles=32``; row 14 on the
  k_tiles = 1 pack at k = 32; where the tree walks row 13's slabs, its
  steps and slabs a block at the auto pack;
- ``bench``: the bench suite's ``calibrate``, ``spmv_clustered`` and
  ``spgemm_xl`` groups (``--no-bench`` leaves them out).

``--quick`` times only each case's default call in ``rl`` and ``bsr`` (no
plain versions, library calls, knob sweeps or block CG), so that four
trees fit one call.

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
GROUPS = ("copy", "octet", "chain", "knobs", "cg", "fused", "walk", "bsr",
          "tile", "sb", "rl", "bench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="written into every line")
    ap.add_argument("--out", help="also write the lines here, as a list")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated, of " + ", ".join(GROUPS))
    ap.add_argument("--no-bench", action="store_true",
                    help="leave the bench group out")
    ap.add_argument("--quick", action="store_true",
                    help="rl and bsr: each case's default call only (no "
                         "plain versions, library calls or knobs)")
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

    ctx = dict(dev=dev, emit=emit, ms=ms, wall_ms=wall_ms, quick=args.quick)
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


def _fused(dev, emit, ms, wall_ms, **_):
    import chip_smoke as cs
    import numpy as np
    import torch
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tf
    from sparsematrix_tpu_torch.ops import (ic0, ic0_fused_plans, ic_apply,
                                            prepare_spmv, splu_plans,
                                            splu_solve)
    from sparsematrix_tpu_torch.solvers import cg
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    new = "lanes" in inspect.signature(tf._fused_cuda).parameters

    def launch_alone(plan, b, **knobs):
        # the wrapper's launch on a padded b in the plan's order
        bp = b if plan.perm is None else b[plan.perm.long()]
        binv = torch.nn.functional.pad(plan.inv_diag * bp,
                                       (0, plan.n_win * 1024 - plan.shape[0]))
        if new:  # solves in place: a fresh copy a call
            return lambda: tf._fused_cuda(plan, binv.clone(), **knobs)
        return lambda: tf._fused_cuda(plan, binv)

    def row(case, plan, waves):
        n = plan.shape[0]
        b = torch.randn(n, device=dev)
        t = ms(lambda: tf.trisolve_fused_apply(plan, b))
        emit({"row": 18, "case": case, "ms": t,
              "kernel_ms": ms(launch_alone(plan, b)),
              "segments": int(plan.aux.shape[0]), "waves": waves,
              "us_a_wave": 1e3 * t / waves})
        if not new:
            return
        # the walk's knobs and ablations (an ablation's x is not the solve)
        for kw in [dict(lanes=w) for w in (2, 8)] + [
                dict(ablate=a) for a in (1, 2, 3, 4)]:
            t = ms(launch_alone(plan, b, **kw))
            emit({"row": 18, "case": case, "knobs": kw, "kernel_ms": t,
                  "us_a_wave": 1e3 * t / waves})

    for side in (256, 1024):
        _, sp = poisson2d(side * side)
        A = CSR.from_scipy(sp.astype(np.float32).tocsr(), device=dev)
        L = ic0(A)
        plans = [(f"ic0 L Poisson {side}^2", tf.trisolve_fused_plan(L))]
        if side == 256:
            plans.append((f"ic0 L^T Poisson {side}^2 (upper)",
                          tf.trisolve_fused_plan(CSR.from_scipy(
                              L.to_scipy().T.tocsr(), device=dev),
                              lower=False)))
        for case, plan in plans:
            row(case, plan, plan.n_levels - 1)
        del plans, L, A

    n_cv, sp_cv = cs.convection_system(128)
    solver = splu_plans(CSR.from_scipy(sp_cv, device=dev), engine="fused")
    for name, plan in (("L", solver.l_plan), ("U", solver.u_plan)):
        b = torch.randn(n_cv, device=dev)
        emit({"row": 18, "case": f"splu fused convection n={n_cv} {name}",
              "ms": ms(lambda: tf.trisolve_fused_apply(plan, b)),
              "segments": int(plan.aux.shape[0]),
              "levels": plan.n_levels})
    b = torch.randn(n_cv, device=dev)
    emit({"e2e": f"splu_solve fused convection n={n_cv}",
          "device_ms": ms(lambda: splu_solve(solver, b))})

    n, sp = poisson2d(65536, 1.0)
    A = CSR.from_scipy(sp.astype(np.float32).tocsr(), device=dev)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(n).astype(
        np.float32)).to(dev)
    Ap = prepare_spmv(A)
    plans = ic0_fused_plans(A)
    M = lambda r: ic_apply(plans, r)  # noqa: E731
    run = lambda: cg(Ap, b, tol=0.0, maxiter=25, M=M)  # noqa: E731
    emit({"e2e": "cg ilu_cg_xl/ic0-fused", "per_iter_device_ms":
          ms(run) / 25, "per_iter_wall_ms": wall_ms(run) / 25,
          "precond_device_ms": ms(lambda: M(b))})


def _walk(dev, emit, ms, **_):
    import chip_smoke as cs
    import numpy as np
    import scipy.sparse as sps
    import torch
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.kernels import pack_dualgather
    from sparsematrix_tpu_torch.ops import prepare_spmv
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    # the module: the package exports its function under the same name
    smd = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")
    kern = smd._spmm_dualgather_cuda
    steps = "step" in inspect.signature(kern).parameters

    def lib(sp):
        return torch.sparse_csr_tensor(
            torch.from_numpy(sp.indptr.astype(np.int64)),
            torch.from_numpy(sp.indices.astype(np.int64)),
            torch.from_numpy(sp.data.astype(np.float32)),
            size=sp.shape).to(dev)

    def row14(case, P, X, S=None, spbs=()):
        r = {"row": 14, "case": case, "ms": ms(lambda: kern(P, X))}
        if S is not None:
            r["library_ms"] = ms(lambda: S @ X)
        if steps:
            r["steps_ms"] = [ms(lambda st=st: kern(P, X, step=st))
                             for st in smd.STEPS]
            r["spb_ms"] = {sp: ms(lambda sp=sp: kern(P, X, spb=sp))
                           for sp in spbs}
        emit(r)

    sp_xl, _ = cs.xl_matrix()
    A = CSR.from_scipy(sp_xl, device=dev)
    S = lib(sp_xl)
    X = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (sp_xl.shape[1], 32)).astype(np.float32)).to(dev)
    P = pack_dualgather(A, k_tiles=1)
    P_sb = prepare_spmv(A)
    row14("XL k=32 k_tiles=1", P, X, S, spbs=(16, 32, 64, 128, 256))
    emit({"row": 13, "case": "XL k=32 auto", "ms": ms(lambda: kern(P_sb, X))})
    for k in (1, 8, 33, 64):
        Xk = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (sp_xl.shape[1], k)).astype(np.float32)).to(dev)
        row14(f"XL k={k} k_tiles=1", P, Xk, S)
    del P_sb
    P16 = pack_dualgather(A, k_tiles=1, dtype=torch.bfloat16)
    row14("XL k=32 k_tiles=1 bf16", P16, X)
    del P16, P, S, A

    n = 32768
    sp64 = sps.random(n, n, density=64 / n, random_state=5, format="csr",
                      dtype=np.float32)
    sp64.data = np.random.default_rng(6).uniform(-1, 1, sp64.nnz).astype(
        np.float32)
    sp2, X2 = cs.octet_mm_matrix()
    for name, sp in (("spmm_xl walk-kt1 64/row k=32", sp64),
                     ("spmm_xl walk-kt1 2/row k=32", sp2)):
        Pw = pack_dualgather(CSR.from_scipy(sp, device=dev), k_tiles=1)
        row14(name, Pw, torch.from_numpy(X2).to(dev), lib(sp))

    npo, po = poisson2d(65536)
    Pp = pack_dualgather(CSR.from_scipy(po.astype(np.float32).tocsr(),
                                        device=dev), k_tiles=1)
    row14("block_cg_xl Poisson 256^2 k=8", Pp,
          torch.randn((npo, 8), device=dev), spbs=(4, 8, 16, 32))


def _bsr(dev, emit, ms, wall_ms, quick=False, **_):
    import chip_smoke as cs
    import numpy as np
    import torch
    from sparsematrix_tpu_torch.formats import CSR, csr_to_bsr
    from sparsematrix_tpu_torch.solvers import block_cg
    from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                        poisson2d)

    kb = importlib.import_module("sparsematrix_tpu_torch.kernels.bsr")
    kern = kb._spmm_bsr_panel_cuda
    designs = "design" in inspect.signature(kern).parameters

    def err(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max().clamp(min=1e-30))

    def library(A, X):
        bm, bn = A.block_shape
        nb = A.num_blocks
        S = torch.sparse_bsr_tensor(
            A.indptr.long(), A.indices[:nb].long(), A.data[:nb].to(X.dtype),
            size=(A.num_block_rows * bm, -(-A.shape[1] // bn) * bn))
        return lambda: S @ X

    def row4(case, A, X, ks=()):
        P = kb.pack_bsr_panels(A)
        if quick:
            emit({"row": 4, "case": case, "ms": ms(lambda: kern(P, X))})
            return
        r = {"row": 4, "case": case, "M": P.bcols.shape[1],
             "ms": ms(lambda: kern(P, X)),
             "plain_ms": ms(lambda: kb.spmm_bsr_panel_reference(P, X)),
             "err": err(kern(P, X), kb.spmm_bsr_panel_reference(P, X))}
        try:
            r["library_ms"] = ms(library(A, X))
        except RuntimeError as e:  # the library refuses some shapes
            r["library_ms"] = None
            r["library_error"] = str(e)[:120]
        if designs:
            r["design"] = kb.panel_plan(P, X.shape[1]).design
            r["design_ms"] = {d: ms(lambda d=d: kern(P, X, design=d))
                              for d in kb.DESIGNS}
        for k in ks:  # the designs at other widths of X
            Xk = X[:, :k].contiguous()
            r[f"k{k}_ms"] = (
                {d: ms(lambda d=d: kern(P, Xk, design=d)) for d in kb.DESIGNS}
                if designs else ms(lambda: kern(P, Xk)))
        if designs:  # the wide design at each vector width
            for k in (X.shape[1],) + tuple(ks):
                Xk = X[:, :k].contiguous()
                r[f"k{k}_wide_vec_ms"] = {
                    v: ms(lambda v=v: kern(P, Xk, design="wide", vec=v))
                    for v in (1, 2, 4) if k % v == 0}
        emit(r)

    tiles = hasattr(kb, "tile_plan")  # the grouped kernel's designs

    def row3(case, A, X, knobs=False):
        knobs = knobs and not quick
        r = {"row": 3, "case": case,
             "ms": ms(lambda: kb._spmm_bsr_cuda(A, X)),
             "err": err(kb._spmm_bsr_cuda(A, X),
                        kb.spmm_bsr_grouped_reference(A, X))}
        if tiles:
            r["design"] = kb.grouped_design(A)
            r["bit_equal"] = bool(torch.equal(kb._spmm_bsr_cuda(A, X),
                                              kb._spmm_bsr_cuda(A, X)))
        if knobs:
            r["plain_ms"] = ms(lambda: kb.spmm_bsr_grouped_reference(A, X))
            try:
                r["library_ms"] = ms(library(A, X))
            except (RuntimeError, NotImplementedError) as e:
                r["library_ms"] = None
                r["library_error"] = str(e)[:120]
        if knobs and tiles:
            r["design_ms"] = {d: ms(lambda d=d: kb._spmm_bsr_cuda(
                A, X, design=d)) for d in kb.GROUPED_DESIGNS}
            plan = kb.tile_plan(A, X.shape[1])
            r["plan"] = {"TR": plan.TR, "TC": plan.TC, "split": plan.split,
                         "items": int(plan.items.shape[0]),
                         "partials": plan.n_partials, "grid": plan.grid}
            r["split_ms"] = {sp: ms(lambda sp=sp: kb._spmm_bsr_cuda(
                A, X, split=sp)) for sp in (1, 2, 3, 4, 6, 8, 12, 1000)}
        emit(r)

    n_po, po = poisson2d(65536)
    A_po = csr_to_bsr(CSR.from_scipy(po.astype(np.float32).tocsr(),
                                     device=dev), (8, 8))
    B = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n_po, 8)).astype(np.float32)).to(dev)
    row4("block_cg_xl Poisson (8,8) k=8", A_po, B)
    if not quick:
        res = block_cg(A_po, B, tol=1e-5, maxiter=4000)
        run = lambda: block_cg(A_po, B, tol=0.0, maxiter=25)  # noqa: E731
        dms, wms = ms(run) / 25, wall_ms(run) / 25
        emit({"e2e": "block_cg_xl/block-plain BSR (8,8)",
              "per_iter_device_ms": dms, "per_iter_wall_ms": wms,
              "iters_to_tol": res.iters,
              "device_ms_to_tol": dms * res.iters,
              "ms_to_tol": wms * res.iters})
        del res
    A_xb = csr_to_bsr(CSR.from_scipy(cs.block_sparse_scipy(
        32768, (8, 8), 0.0078, 32), device=dev), (8, 8))
    X_xb = torch.from_numpy(gen_matrix_random(
        np.random.default_rng(33), 32768, 128)).to(dev)
    row4("XL (8,8) k=128", A_xb, X_xb, ks=(8, 32))
    dense_bb, Xbb = cs.bench_bsr_dense()
    A_bb = csr_to_bsr(CSR.fromdense(dense_bb, device=dev), (8, 8))
    X_bb = torch.from_numpy(Xbb).to(dev)
    row4("bench (8,8) k=128", A_bb, X_bb, ks=(8, 32))
    if not quick:
        row4("bench (8,8) bf16 k=128", A_bb.astype(torch.bfloat16),
             X_bb.to(torch.bfloat16))
    row3("bench (8,8) k=128", A_bb, X_bb)
    X_big = torch.from_numpy(gen_matrix_random(
        np.random.default_rng(31), 16384, 128)).to(dev)
    for block, seed in (((128, 128), 30), ((64, 64), 34), ((32, 128), 35)):
        A_big = csr_to_bsr(CSR.from_scipy(cs.block_sparse_scipy(
            16384, block, 0.1, seed), device=dev), block)
        name = f"({block[0]},{block[1]}) n=16384 k=128"
        row3(name, A_big, X_big, knobs=True)
        if block == (128, 128):
            row3(name + " bf16", A_big.astype(torch.bfloat16),
                 X_big.to(torch.bfloat16), knobs=True)
        del A_big


def _tile(dev, emit, ms, **_):
    import chip_smoke as cs
    import numpy as np
    import torch
    from sparsematrix_tpu_torch.formats import CSR, csr_to_bsr
    from sparsematrix_tpu_torch.utils.testutils import gen_matrix_random

    kb = importlib.import_module("sparsematrix_tpu_torch.kernels.bsr")
    kern = kb._spmm_bsr_cuda
    if "ring" not in inspect.signature(kern).parameters:
        emit({"group": "tile", "skipped": "the tree's row 3 has no ring"})
        return
    X = torch.from_numpy(gen_matrix_random(
        np.random.default_rng(31), 16384, 128)).to(dev)
    A = csr_to_bsr(CSR.from_scipy(cs.block_sparse_scipy(
        16384, (128, 128), 0.1, 30), device=dev), (128, 128))
    for dt in (torch.float32, torch.bfloat16):
        A_c, X_c = A.astype(dt), X.to(dt)
        want = kb.spmm_bsr_grouped_reference(A_c, X_c).float()
        case = f"(128,128) n=16384 k=128 {str(dt)[6:]}"

        def timed(knob, **kw):
            got = kern(A_c, X_c, **kw).float()
            plan = kb.tile_plan(A_c, 128, kw.get("split", 0),
                                kw.get("ring"), kw.get("tc", 0))
            emit({"row": 3, "case": case, "knob": knob,
                  "ms": ms(lambda: kern(A_c, X_c, **kw)),
                  "err": float((got - want).abs().max()
                               / want.abs().max()),
                  "plan": {"TC": plan.TC, "ring": plan.ring,
                           "split": plan.split,
                           "items": int(plan.items.shape[0]),
                           "partials": plan.n_partials, "grid": plan.grid}})

        timed("default")
        for ring in kb.tile_rings(128)[1:]:
            timed(f"ring={ring}", ring=ring)
        for split in (1, 2, 4, 6, 8, 1000):
            timed(f"split={split}", split=split)
        for split in (0, 2, 1000):
            timed(f"tc=64 split={split}", tc=64, split=split)
        for parts, name in ((1, "tiles alone"), (2, "sums alone")):
            emit({"row": 3, "case": case, "knob": name,
                  "ms": ms(lambda parts=parts: kern(A_c, X_c,
                                                    parts=parts))})
        del A_c, X_c, want


def _sb(dev, emit, ms, **_):
    import chip_smoke as cs
    import numpy as np
    import torch
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.kernels import pack_dualgather
    from sparsematrix_tpu_torch.ops import prepare_spmv

    smd = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")
    kern = smd._spmm_dualgather_cuda
    walked = hasattr(smd, "slab_walk")  # row 13 walks its slabs

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    sp_xl, _ = cs.xl_matrix()
    A = CSR.from_scipy(sp_xl, device=dev)
    S = torch.sparse_csr_tensor(
        torch.from_numpy(sp_xl.indptr.astype(np.int64)),
        torch.from_numpy(sp_xl.indices.astype(np.int64)),
        torch.from_numpy(sp_xl.data.astype(np.float32)),
        size=sp_xl.shape).to(dev)
    Xs = {k: torch.from_numpy(np.random.default_rng(
        10 if k == 32 else k).standard_normal(
            (sp_xl.shape[1], k)).astype(np.float32)).to(dev)
        for k in (1, 8, 32, 33, 64)}

    def row(n, case, P, X, knobs=False):
        r = {"row": n, "case": case, "ms": ms(lambda: kern(P, X)),
             "err": err(kern(P, X), smd.spmm_dualgather_reference(P, X)),
             "nibble": P.nibble, "two_win": P.two_win, "k_tiles": P.k_tiles,
             "group": P.group, "n_slabs": P.n_slabs}
        if walked:
            walk = smd.slab_walk(P)
            r["items"] = int(walk.items.shape[0])
            r["blocks"] = walk.n_blocks
            r["windows"] = len(set(walk.items[:, 2].tolist()))
        if knobs:
            r["library_ms"] = ms(lambda: S @ X)
        if knobs and (walked or n == 14):
            r["steps_ms"] = [ms(lambda st=st: kern(P, X, step=st))
                             for st in smd.STEPS]
            r["spb_ms"] = {sp: ms(lambda sp=sp: kern(P, X, spb=sp))
                           for sp in (16, 32, 64)}
        emit(r)

    P_kt1 = pack_dualgather(A, k_tiles=1)
    row(14, "XL k=32 k_tiles=1", P_kt1, Xs[32])
    del P_kt1
    P_sb = prepare_spmv(A)
    row(13, "XL k=32 auto", P_sb, Xs[32], knobs=True)
    for k in (1, 8, 33, 64):
        row(13, f"XL k={k} auto", P_sb, Xs[k])
    del P_sb
    for case, kw in (
            ("XL k=32 group=128 k_tiles=8 two_win",
             dict(group=128, k_tiles=8, two_win=True)),
            ("XL k=32 k_tiles=8 (nibble, one window)", dict(k_tiles=8)),
            ("XL k=32 bf16 group=512 k_tiles=32",
             dict(group=512, k_tiles=32, dtype=torch.bfloat16))):
        P = pack_dualgather(A, **kw)
        row(13, case, P, Xs[32])
        del P


def _rl(dev, emit, ms, wall_ms, quick=False, **_):
    import dataclasses
    import tempfile

    import chip_smoke as cs
    import numpy as np
    import torch
    import torch.distributed as dist
    from sparsematrix_tpu_torch import parallel as par
    from sparsematrix_tpu_torch.formats import CSR
    from sparsematrix_tpu_torch.kernels import (pack_dualgather,
                                                pack_sell_rowlane)
    from sparsematrix_tpu_torch.parallel import dist_rowlane as drl
    from sparsematrix_tpu_torch.utils.testutils import (
        gen_matrix_random, gen_random_dense_sparse)

    rmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_rowlane")
    kern = rmod._spmm_rowlane_cuda
    knobs = inspect.signature(kern).parameters
    designs = "design" in knobs

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def row(case, P, X, S=None, plain=False):
        r = {"row": 8, "case": case, "ms": ms(lambda: kern(P, X)),
             "n_slabs": P.n_slabs}
        if quick:
            emit(r)
            return
        if plain:
            r["err"] = err(kern(P, X), rmod.spmm_rowlane_reference(P, X))
        if S is not None:
            r["library_ms"] = ms(lambda: S @ X)
        if designs:
            walk = rmod.rowlane_mm_walk(P)
            r["walk"] = {"items": int(walk.items.shape[0]),
                         "blocks": walk.n_blocks}
            r["design_ms"] = {d: ms(lambda d=d: kern(P, X, design=d))
                              for d in rmod.DESIGNS}
        if "parts" in knobs:
            r["gather_parts_ms"] = {
                p: ms(lambda p=p: kern(P, X, design="gather", parts=p))
                for p in (1, 2, 3)}
        emit(r)

    sp_xl, _ = cs.xl_matrix()
    A = CSR.from_scipy(sp_xl, device=dev)
    part = par.partition_rowlane(A, 1)
    part = dataclasses.replace(part, **{
        f: getattr(part, f).to(dev) for f in part._data_fields})
    P = drl.local_sell(part, part)
    P16 = dataclasses.replace(P, vals=P.vals.to(torch.bfloat16))
    S = torch.sparse_csr_tensor(
        torch.from_numpy(sp_xl.indptr.astype(np.int64)),
        torch.from_numpy(sp_xl.indices.astype(np.int64)),
        torch.from_numpy(sp_xl.data.astype(np.float32)),
        size=sp_xl.shape).to(dev)
    Xs = {k: torch.from_numpy(np.random.default_rng(
        10 if k == 32 else k).standard_normal(
            (sp_xl.shape[1], k)).astype(np.float32)).to(dev)
        for k in (8, 32, 64)}
    for k, X in Xs.items():
        row(f"XL partition_rowlane k={k}", P, X, S if k == 32 else None,
            plain=k == 32)
        row(f"XL partition_rowlane k={k} bf16 values", P16, X)
    del P16
    smd = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmm_dualgather")
    P14 = pack_dualgather(A, k_tiles=1)
    emit({"row": 14, "case": "XL k=32 k_tiles=1",
          "ms": ms(lambda: smd._spmm_dualgather_cuda(P14, Xs[32]))})
    del P14

    rng = np.random.default_rng(1)
    dense = gen_random_dense_sparse(rng, 2048, 2048, density=0.05)
    Xb = torch.from_numpy(gen_matrix_random(rng, 2048, 32)).to(dev)
    Pb = pack_sell_rowlane(CSR.fromdense(dense, device=dev))
    sp_b = CSR.fromdense(dense, device="cpu").to_scipy()
    Sb = torch.sparse_csr_tensor(
        torch.from_numpy(sp_b.indptr.astype(np.int64)),
        torch.from_numpy(sp_b.indices.astype(np.int64)),
        torch.from_numpy(sp_b.data.astype(np.float32)),
        size=sp_b.shape).to(dev)
    row("bench spmm_csr/rowlane n=2048 d=0.05 k=32", Pb, Xb, Sb, plain=True)
    # a sparse pack: few slabs a window, each block staging a window for
    # a handful of slabs
    sparse = gen_random_dense_sparse(np.random.default_rng(2), 2048, 2048,
                                     density=0.002)
    row("n=2048 d=0.002 k=32", pack_sell_rowlane(
        CSR.fromdense(sparse, device=dev)), Xb, plain=True)

    rdv = tempfile.mkdtemp(prefix="rows_rl_")
    par.initialize_multihost(f"file://{rdv}/store", 1, 0, device=dev)
    try:
        mesh = par.make_mesh()
        Xd = par.shard_vector(Xs[32], mesh)
        run = lambda: par.dist_spmm_rowlane(part, Xd, mesh)  # noqa: E731
        run()
        emit({"e2e": "dist_spmm_rowlane XL k=32 world 1",
              "device_ms": ms(run), "wall_ms": wall_ms(run),
              "local_kernel_ms": ms(lambda: kern(P, Xs[32]))})
    finally:
        dist.destroy_process_group()


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
         "cg": _cg, "fused": _fused, "walk": _walk, "bsr": _bsr,
         "tile": _tile, "sb": _sb, "rl": _rl, "bench": _bench}


if __name__ == "__main__":
    sys.exit(main())
