"""Rank program of the distribution-layer checks: every ``dist_*`` of
``sparsematrix_tpu_torch.parallel`` on a few small fixtures, in one
process a rank.

    python tests/_torch_dist_ranks.py --world W --rank R --init URL --out DIR [--device cpu|cuda]

Every rank joins a group at ``URL`` (a ``file://`` or ``tcp://``
rendezvous), builds the fixtures of ``inputs()`` from fixed seeds, runs
every case of ``CASES`` on this rank's bands and gathers the global
result.  Rank 0 writes ``DIR/results.npz`` (one array a case) and
``DIR/results.json`` (per case: the fp64 check, solver iterations and
residual; the backend; the kernels' launch counts; the seconds).  On the
CPU the group is gloo.  With ``--device cuda`` and a card for every rank
it is NCCL, rank r on card r; with fewer cards every rank computes on
``cuda:0`` in a gloo group (NCCL refuses two ranks on one card), whose
collectives stage through the host (``parallel/mesh.py``).

It imports neither JAX nor the JAX package nor a test module: the tests
run it in fresh processes (``tests/test_torch_parallel.py``) and hold its
results against the JAX package on the same ``inputs()``;
``chip_smoke.py`` runs it on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sps

# one torch thread and one BLAS thread a rank (set before torch loads)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = Path(__file__).resolve().parent.parent

# the tolerance of the JAX package's dist tests (``test_distributed.py``,
# ``test_dist_fastlocal.py``): values of ±1000, fp32 sums
RTOL, ATOL = 2e-3, 0.5
# solvers: the relative true residual the JAX precond tests ask of a run
# to tol 1e-5 (``test_dist_precond.py``)
SOLVE_RES = 5e-5


def _poisson(side):
    eye = sps.eye(side)
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (side, side))
    return (sps.kron(eye, T) + sps.kron(
        sps.diags([-1.0, -1.0], [-1, 1], (side, side)), eye)).tocsr()


def _banded(rng, n, bw):
    dense = np.zeros((n, n), np.float32)
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.uniform(-1000, 1000, idx.shape[0])
    return dense


def inputs():
    """The fixtures, from fixed seeds: name -> dict of numpy/scipy
    arrays (``A`` a scipy CSR fp32, ``x``/``X``/``b`` fp32)."""
    from sparsematrix_tpu_torch.utils.testutils import (
        gen_matrix_random, gen_random_dense_sparse)

    rng = np.random.default_rng(11)
    out = {}
    out["rect"] = dict(A=sps.csr_matrix(
        gen_random_dense_sparse(rng, 250, 130, density=0.1)))
    out["rect"]["x"] = gen_matrix_random(rng, 130, 1)[:, 0]
    out["rect"]["X"] = gen_matrix_random(rng, 130, 8)
    out["wide"] = dict(A=sps.csr_matrix(
        gen_random_dense_sparse(rng, 130, 250, density=0.1)))
    out["wide"]["x"] = gen_matrix_random(rng, 250, 1)[:, 0]
    out["wide"]["X"] = gen_matrix_random(rng, 250, 5)
    # the rowlane fixture of the JAX test (test_distributed.py:276-295):
    # 1100 rows pad to 128-row bands; at 4 shards the last band is empty
    g = np.random.default_rng(17)
    A = sps.random(1100, 1100, density=0.03, format="csr",
                   random_state=np.random.RandomState(2), dtype=np.float32)
    A.data = g.uniform(-10, 10, A.nnz).astype(np.float32)
    out["rowlane"] = dict(A=A, x=g.uniform(-1, 1, 1100).astype(np.float32),
                          X=g.standard_normal((1100, 8)).astype(np.float32))
    out["dg"] = dict(A=sps.csr_matrix(
        gen_random_dense_sparse(rng, 700, 1300, density=0.03)))
    out["dg"]["x"] = rng.standard_normal(1300).astype(np.float32)
    out["dg"]["X"] = rng.standard_normal((1300, 7)).astype(np.float32)
    out["dense"] = dict(A=sps.csr_matrix(
        gen_random_dense_sparse(rng, 200, 180, density=0.08)))
    out["dense"]["X"] = rng.standard_normal((180, 12)).astype(np.float32)
    out["bell"] = dict(A=sps.csr_matrix(
        gen_random_dense_sparse(rng, 128, 256, density=0.05)),
        X=gen_matrix_random(rng, 256, 32))
    out["d2"] = dict(A=sps.csr_matrix(
        gen_random_dense_sparse(rng, 96, 120, density=0.2)),
        X=gen_matrix_random(rng, 120, 10))
    out["halo"] = dict(A=sps.csr_matrix(_banded(rng, 256, 4)),
                       x=rng.standard_normal(256).astype(np.float32))
    out["ring"] = dict(A=sps.csr_matrix(_banded(rng, 512, 24)),
                       x=rng.standard_normal(512).astype(np.float32))
    var = np.zeros((128, 128), np.float32)
    for i in range(128):
        w = 3 if i < 64 else 9  # a wider band in the lower half
        lo, hi = max(0, i - w), min(128, i + w + 1)
        var[i, lo:hi] = rng.standard_normal(hi - lo)
    out["var"] = dict(A=sps.csr_matrix(var),
                      x=rng.standard_normal(128).astype(np.float32))
    P = _poisson(12).astype(np.float32)
    out["poisson"] = dict(A=P, b=rng.uniform(-1, 1, P.shape[0]).astype(
        np.float32))
    s = 1.0 + 9.0 * rng.random(256)
    Ps = (sps.diags(s) @ _poisson(16) @ sps.diags(s)).tocsr().astype(
        np.float32)
    out["scaled"] = dict(A=Ps, b=rng.uniform(-1, 1, 256).astype(np.float32))
    P16 = _poisson(16).astype(np.float32)
    out["poisson16"] = dict(A=P16, b=rng.standard_normal(256).astype(
        np.float32))
    C = (_poisson(12) + sps.diags([0.4, -0.4], [1, -1], (144, 144))).tocsr()
    out["convdiff"] = dict(A=C.astype(np.float32),
                           b=rng.uniform(-1, 1, 144).astype(np.float32))
    return out


# case -> the fixture of ``inputs()`` it runs on (``_run`` runs it)
CASES = {
    "spmv_rows": "rect",
    "spmm_rows": "rect",
    "spmv_cols_psum": "wide",
    "spmv_cols_psum_scatter": "wide",
    "spmm_cols_psum": "wide",
    "spmm_cols_psum_scatter": "wide",
    "spmv_rowlane": "rowlane",
    "spmm_rowlane": "rowlane",
    "spmv_dualgather": "dg",
    "spmm_dualgather": "dg",
    "spmm_dense": "dense",
    "spmm_dense_2d": "dense",
    "spmm_2d": "d2",
    "spmm_bell": "bell",
    "spmv_halo": "halo",
    "spmv_halo_ring": "ring",
    "spmv_halo_var_ragged": "var",
    "spmv_halo_var_padded": "var",
    "cg": "poisson",
    "cg_jacobi": "scaled",
    "cg_block_ic0_waves": "poisson16",
    "cg_block_ic0_fixpoint": "poisson16",
    "bicgstab": "convdiff",
    "bicgstab_block_ilu0_waves": "convdiff",
    "gmres": "convdiff",
}

# the arguments the solver cases share with their JAX twins
SOLVE_KW = {"cg": dict(tol=1e-6, maxiter=500),
            "cg_jacobi": dict(tol=1e-5, maxiter=800),
            "cg_block_ic0_waves": dict(tol=1e-5, maxiter=500),
            "cg_block_ic0_fixpoint": dict(tol=1e-5, maxiter=400),
            "bicgstab": dict(tol=1e-5, maxiter=400),
            "bicgstab_block_ilu0_waves": dict(tol=1e-5, maxiter=400),
            "gmres": dict(tol=1e-5, restart=20, maxiter=20)}
HALO = {"spmv_halo": 8, "spmv_halo_ring": 32}


def mesh_2d_shape(world: int):
    """The 2-D mesh of the 2-D cases: 2 rows × world/2 columns."""
    return 2, world // 2


def oracle(case: str, fx) -> np.ndarray:
    """The fp64 result of a product case (``A @ x`` / ``A @ X``)."""
    A = fx["A"].astype(np.float64)
    rhs = fx["x"] if case.startswith("spmv") else fx["X"]
    return A @ rhs.astype(np.float64)


def _run(case, fx, mesh, mesh2, world, dev):
    """This case on this rank: returns (global result, extra dict)."""
    import torch

    import sparsematrix_tpu_torch.parallel as par
    from sparsematrix_tpu_torch.formats import CSR, csr_to_blocked_ell

    A = CSR.from_scipy(fx["A"], device="cpu")
    rows, cols = fx["A"].shape
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sv = lambda a, **kw: par.shard_vector(t(a), mesh, **kw)  # noqa: E731
    gv = lambda y, n: par.gather_vector(y, mesh, n).cpu()  # noqa: E731
    if case.startswith(("spmv_rows", "spmm_rows", "spmv_cols", "spmm_cols")):
        axis, reduce = ("rows", "psum") if "rows" in case else (
            "cols", case.split("cols_")[1])
        part = (par.partition_csr_rows if axis == "rows"
                else par.partition_csr_cols)(A, world)
        part = par.shard_partitioned(part, mesh)
        rhs = fx["x"] if case.startswith("spmv") else fx["X"]
        fn = par.dist_spmv if case.startswith("spmv") else par.dist_spmm
        y = fn(part, sv(rhs), mesh, reduce=reduce)
        if axis == "cols" and reduce == "psum":
            return y.cpu(), {}
        return gv(y, rows), {}
    if case in ("spmv_rowlane", "spmm_rowlane"):
        part = par.shard_partitioned(par.partition_rowlane(A, world, group=8),
                                     mesh)
        if case == "spmv_rowlane":
            return gv(par.dist_spmv_rowlane(part, sv(fx["x"]), mesh),
                      rows), {}
        return gv(par.dist_spmm_rowlane(part, sv(fx["X"]), mesh), rows), {}
    if case in ("spmv_dualgather", "spmm_dualgather"):
        part = par.shard_partitioned(
            par.partition_dualgather(A, world, group=4), mesh)
        if case == "spmv_dualgather":
            return gv(par.dist_spmv_dualgather(part, sv(fx["x"]), mesh),
                      rows), {}
        return gv(par.dist_spmm_dualgather(part, sv(fx["X"]), mesh),
                  rows), {}
    if case == "spmm_dense":
        part = par.shard_dense(par.partition_dense_rows(A, world), mesh)
        return gv(par.dist_spmm_dense(part, sv(fx["X"]), mesh), rows), {}
    if case in ("spmm_dense_2d", "spmm_2d"):
        n_row, _ = mesh_2d_shape(world)
        Xb = par.shard_vector(t(fx["X"]), mesh2, axis="row")
        Xb = par.shard_vector(Xb, mesh2, axis="col", dim=1)
        if case == "spmm_2d":
            Y = par.dist_spmm_2d(par.partition_csr_rows(A, n_row), Xb, mesh2)
        else:
            Y = par.dist_spmm_dense_2d(par.partition_dense_rows(A, n_row),
                                       Xb, mesh2)
        Y = par.gather_vector(Y, mesh2, fx["X"].shape[1], axis="col", dim=1)
        return par.gather_vector(Y, mesh2, rows, axis="row").cpu(), {}
    if case == "spmm_bell":
        bell = csr_to_blocked_ell(A, block_shape=(8, 64), device="cpu")
        part = par.shard_bell(par.partition_bell_rows(bell, world), mesh)
        nbc = -(-cols // 64)
        Y = par.dist_spmm_bell(part, sv(fx["X"], length=nbc * 64), mesh)
        return gv(Y, rows), {}
    if case == "spmv_halo":
        part = par.shard_halo(par.partition_csr_halo(A, world, HALO[case]),
                              mesh)
        return gv(par.dist_spmv_halo(part, sv(fx["x"]), mesh), rows), {}
    if case == "spmv_halo_ring":
        part = par.shard_halo_ring(
            par.partition_csr_halo_ring(A, world, HALO[case]), mesh)
        return gv(par.dist_spmv_halo_ring(part, sv(fx["x"]), mesh), rows), {}
    if case.startswith("spmv_halo_var"):
        full = par.partition_csr_halo_var(A, world)
        part = par.shard_partitioned(full, mesh)
        y = par.dist_spmv_halo_var(part, sv(fx["x"]), mesh,
                                   use_ragged=case.endswith("ragged"))
        return gv(y, rows), {"ragged_bytes": full.ragged_bytes,
                             "padded_bytes": full.padded_bytes}
    # the solvers
    part = par.shard_partitioned(par.partition_csr_rows(A, world), mesh)
    b = sv(fx["b"], length=world * part.local_rows)
    kw = dict(SOLVE_KW[case])
    precond = None
    if case == "cg_jacobi":
        precond = "jacobi"
    elif case.startswith(("cg_block_ic0", "bicgstab_block_ilu0")):
        Ad = CSR.from_scipy(fx["A"], device=dev)
        build = (par.block_ic0_precond if case.startswith("cg")
                 else par.block_ilu0_precond)
        extra = {"n_iters": 6} if case.endswith("fixpoint") else {}
        precond = build(Ad, world, engine=case.rsplit("_", 1)[1], mesh=mesh,
                        **extra)
    solver = (par.dist_gmres if case == "gmres" else par.dist_bicgstab
              if case.startswith("bicgstab") else par.dist_cg)
    res = solver(part, b, mesh, precond=precond, **kw)
    x = gv(res.x, rows)
    A64 = fx["A"].astype(np.float64)
    rel = float(np.linalg.norm(A64 @ x.double().numpy() - fx["b"])
                / np.linalg.norm(fx["b"]))
    return x, {"iters": int(res.iters), "residual": float(res.residual),
               "true_rel_residual": rel}


def check(case: str, fx, got: np.ndarray, extra) -> bool:
    """The fp64 check of a case's global result."""
    if not np.isfinite(got).all():
        return False
    if case in SOLVE_KW:
        return extra["true_rel_residual"] < SOLVE_RES
    return bool(np.allclose(got, oracle(case, fx), rtol=RTOL, atol=ATOL))


def spawn(world: int, out: Path, device: str = "cpu", cases=None,
          timeout: float = 600.0):
    """Runs this program on ``world`` fresh ranks (a ``file://``
    rendezvous in ``out``) and returns rank 0's (arrays, report).  Raises
    if a rank fails or the run outlasts ``timeout``; every rank is ended
    before it returns."""
    import subprocess

    out = Path(out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    rdv = out / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    cmd = [sys.executable, str(Path(__file__).resolve()), "--world",
           str(world), "--init", f"file://{rdv}", "--out", str(out),
           "--device", device]
    if cases:
        cmd += ["--cases", ",".join(cases)]
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    logs = [out / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(cmd + ["--rank", str(r)],
                                              env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        # wait for every rank; one that fails ends the others at once (they
        # would wait for it in their next collective)
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if (any(p.returncode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank failed or timed out:\n" + "\n".join(
            f"rank {r} (exit {p.returncode}):\n{logs[r].read_text()[-4000:]}"
            for r, p in enumerate(procs)))
    with np.load(out / "results.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((out / "results.json").read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    import sparsematrix_tpu_torch.parallel as par
    from sparsematrix_tpu_torch.kernels import _build

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    dev = torch.device(args.device)
    backend = "gloo"
    if dev.type == "cuda":
        # a card a rank under NCCL where there are enough, else all on
        # card 0 under gloo
        nccl = torch.cuda.device_count() >= args.world
        backend = "nccl" if nccl else "gloo"
        dev = torch.device("cuda", args.rank if nccl else 0)
        torch.cuda.set_device(dev)
    # initialize_multihost sets the card from LOCAL_RANK
    os.environ["LOCAL_RANK"] = str(dev.index or 0)
    par.initialize_multihost(args.init, args.world, args.rank,
                             backend=backend, device=dev)
    mesh = par.make_mesh(device=dev)
    n_row, n_col = mesh_2d_shape(args.world)
    mesh2 = par.make_mesh_2d(n_row, n_col, device=dev)
    fixtures = inputs()
    arrays, report = {}, {"world": args.world, "device": str(dev),
                          "backend": backend, "staged": mesh.staged(),
                          "cases": {}}
    _build.launch_counts.clear()
    for case in args.cases.split(","):
        fx = fixtures[CASES[case]]
        t = time.perf_counter()
        got, extra = _run(case, fx, mesh, mesh2, args.world, dev)
        got = got.double().numpy()
        arrays[case] = got
        report["cases"][case] = dict(extra, ok=check(case, fx, got, extra),
                                     seconds=time.perf_counter() - t)
    report["launches"] = {k: v for k, v in _build.launch_counts.items() if v}
    report["seconds"] = time.perf_counter() - t0
    dist.barrier()
    if args.rank == 0:
        out = Path(args.out)
        np.savez(out / "results.npz", **arrays)
        (out / "results.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
