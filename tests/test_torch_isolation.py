"""The port stands alone: it imports neither JAX nor the JAX package, and
a call on CPU tensors launches no kernel."""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
from threadpoolctl import threadpool_limits

import sparsematrix_tpu_torch as smt
from sparsematrix_tpu_torch.kernels import _build
from sparsematrix_tpu_torch.utils.testutils import (gen_matrix_random,
                                                    gen_random_dense_sparse,
                                                    gen_sparse_index_matrix)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sparsematrix_tpu_torch"
FORBIDDEN = ("jax", "sparsematrix_tpu")


def _forbidden(name: str) -> bool:
    # match the name or its dotted prefix: "sparsematrix_tpu_torch" itself
    # starts with "sparsematrix_tpu"
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_in_fresh_process_pulls_in_no_jax():
    """A subprocess, because this test process (tests/conftest.py)
    imports JAX already."""
    code = (
        "import importlib, json, sys\n"
        f"for name in {list(_modules())!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "sparsematrix_tpu_torch.kernels.codebook" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_jax_import_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert len(files) > 10 and bad == []


def test_cpu_calls_launch_no_kernel():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(gen_matrix_random(rng, 8, 96))
    idx, table = gen_sparse_index_matrix(rng, 96, 40)
    cbd = smt.CodebookDense.from_index_matrix(idx, table, trans=True,
                                              device="cpu")
    csr = smt.CodebookCSR.from_index_matrix(idx, table, trans=True,
                                            device="cpu")
    bell = smt.csr_to_blocked_ell(
        smt.CSR.fromdense(cbd.todense().numpy(), device="cpu"), (8, 32),
        device="cpu")
    _build.launch_counts.clear()
    for b_t in (cbd, csr, bell):
        smt.add_mat_mat(a, b_t)
    smt.codebook_matmul(a, cbd)
    smt.spmm_blocked_ell(bell, a.T)
    # the dual-gather routes: a superblock spmv pack, the k_tiles=1 walk
    A = smt.CSR.fromdense(gen_random_dense_sparse(rng, 2048, 2048, 0.01),
                          device="cpu")
    smt.spmv(A, torch.ones(2048))
    smt.spmm(A, torch.ones((2048, 3)))
    # slice 3: SpGEMM through an octet pack and Clos permutations, the
    # superblock and rowlane layouts
    B = smt.CSR.fromdense(gen_random_dense_sparse(rng, 512, 512, 0.02),
                          device="cpu")
    pp = smt.spgemm_plan_packed(B, B)
    smt.spgemm_apply_packed(pp, B.data)
    smt.spgemm_apply_packed_csc(pp, B.data)
    for layout in ("superblock", "rowlane"):
        smt.spmv(smt.prepare_spmv(A, layout=layout), torch.ones(2048))
    # slice 5: spmm over an octet pack, the pooled spill tail in spmv and
    # spmm, the two SELL layouts
    O = smt.CSR.fromdense(gen_random_dense_sparse(rng, 2048, 2048, 0.0005),
                          device="cpu")
    smt.spmm(smt.prepare_spmv(O), torch.ones((2048, 3)))
    D = smt.CSR.fromdense(gen_random_dense_sparse(rng, 256, 1024, 0.05),
                          device="cpu")
    Pd = smt.pack_dualgather(D, k_tiles=2, spill_cap=8)
    assert Pd.tail is not None
    smt.spmv(Pd, torch.ones(1024))
    smt.spmm(Pd, torch.ones((1024, 3)))
    smt.spmv(smt.pack_sell(D, tr=16), torch.ones(1024))
    smt.spmv(smt.pack_sell_rowpure(D, rows_per_sublane=2), torch.ones(1024))
    # slice 6: BSR through the panel, grouped and densify routes, its spmv
    # through CSR, and the format layer's plain ops
    for block in ((8, 8), (4, 4), (64, 64)):
        Bs = smt.csr_to_bsr(D, block)
        smt.spmm(Bs, torch.ones((1024, 3)), method="sparse")
        smt.spmm(Bs, torch.ones((1024, 3)))
        smt.spmv(Bs, torch.ones(1024))
    smt.spmm_bsr(smt.csr_to_bsr(D, (8, 8)), torch.ones((1024, 3)))
    smt.spmm(smt.csr_to_ell(D)[0], torch.ones((1024, 3)))
    smt.spmv(smt.csr_to_coo(D), torch.ones(1024))
    smt.spmm_t(D, torch.ones((256, 3)))
    smt.sparse_add(D, D)
    # slice 4: every triangular-solve engine under the solvers (one BLAS
    # thread: the wave planner's many small inversions crawl when every
    # worker of a parallel run keeps a thread a core)
    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    P = smt.CSR.from_scipy(poisson2d(256)[1].astype(np.float32),
                           device="cpu")
    with threadpool_limits(limits=1, user_api="blas"):
        for plans in (smt.ic0_waves_plans(P), smt.ic0_fused_plans(P),
                      smt.ilu0_fixpoint_plans(P, n_iters=2),
                      smt.ilu0_level_plans(P)):
            smt.cg(P, torch.ones(256), tol=1e-4, maxiter=5,
                   M=lambda r, plans=plans: smt.ic_apply(plans, r))
        smt.block_cg(lambda V: smt.spmm(P, V), torch.ones((256, 8)),
                     maxiter=2,
                     M=lambda R: smt.ic_apply(smt.ic0_waves_plans(P), R))
        smt.trisolve(smt.ilu0(P)[1], torch.ones(256), lower=False)
    assert sum(_build.launch_counts.values()) == 0


def test_package_data_lists_every_native_source():
    """Every source that ``kernels/_build.py`` compiles at first use
    (``csrc/*.cu``, their headers, ``native/*.cc``) ships with the
    package."""
    import fnmatch
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["sparsematrix_tpu_torch"]
    sources = [p.relative_to(PKG).as_posix()
               for p in sorted(PKG.glob("csrc/*")) + sorted(PKG.glob("native/*"))]
    assert any(s.endswith(".cc") for s in sources)
    assert [s for s in sources
            if not any(fnmatch.fnmatch(s, g) for g in globs)] == []
    assert set(_build.SOURCES) == {p.stem for p in PKG.glob("csrc/*.cu")}
    assert {"spmm_octet", "spmv_pooled", "spmv_sell"} <= set(_build.SOURCES)
    assert {"spmm_octet", "spmv_pooled", "spmv_sell",
            "spmv_sell_rowpure", "spmm_bsr", "spmm_bsr_panel"} <= set(
                _build.KERNELS)
    assert "spmm_bsr" in _build.SOURCES
    assert set(_build.HOST_SOURCES) == {p.stem for p in PKG.glob("native/*.cc")}
