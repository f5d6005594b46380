"""The distribution layer of the port (``sparsematrix_tpu_torch.parallel``)
against the JAX package's.

* Every partitioner emits the JAX partitioner's planes, ``np.array_equal``
  field by field, at n_shards ∈ {1, 2, 4, 8} (host code, no ranks), the
  rowlane fixture's last band empty at 4 and 8 shards.
* Every ``dist_*`` runs on 2 and 4 ``gloo`` ranks on the CPU, each rank a
  fresh process running ``tests/_torch_dist_ranks.py`` (one spawn a world
  size for the whole module, both started by a module fixture), and is
  held to fp64 (checked inside the ranks, ``_torch_dist_ranks.check``)
  and to the JAX call, under ``jax.jit``, on the conftest's 8-device CPU
  mesh (the first 2 or 4 devices) with the same inputs, at the JAX dist
  tests' tolerance (rtol 2e-3, atol 0.5 on values in ±1000).  The
  variable halo's JAX side runs its padded exchange (XLA:CPU has no
  ragged all-to-all), once for the port's two exchanges.
* The dist solvers reach the JAX solvers' solutions (rtol 2e-3, atol
  2e-3 on solutions of order 1: both stop at the same tol in fp32) with
  iteration counts within max(2, 10 %) of JAX's (fp32 sums in another
  order), GMRES within one restart cycle.
* ``scaling.py``'s byte counts equal the JAX model's; its rates are the
  card's.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_dist_ranks as ranks
import sparsematrix_tpu.formats as jf
import sparsematrix_tpu.parallel as jpar
import sparsematrix_tpu_torch as smt
import sparsematrix_tpu_torch.parallel as tpar
from sparsematrix_tpu_torch.parallel.mesh import Mesh

TOL = dict(rtol=ranks.RTOL, atol=ranks.ATOL)
WORLDS = (2, 4)


@functools.lru_cache(maxsize=None)
def fixtures():
    return ranks.inputs()


def _fx(case):
    return fixtures()[ranks.CASES[case]]


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("shard",))


def _tcsr(sp):
    return smt.CSR.from_scipy(sp, device="cpu")


def _np(t):
    """A plane as numpy, bf16 compared by its bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_planes(port, ref):
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        a, b = getattr(port, name), getattr(ref, name)
        if isinstance(a, torch.Tensor):
            assert np.array_equal(_np(a), _np(b)), name
            assert _np(a).dtype == _np(b).dtype, name
        else:
            assert a == b, name


# -- plane equality -----------------------------------------------------------

def _partitioners():
    fx = fixtures()
    return {
        "csr_rows": (fx["rect"]["A"], lambda A, n: tpar.partition_csr_rows(
            _tcsr(A), n), lambda A, n: jpar.partition_csr_rows(
                jf.CSR.from_scipy(A), n)),
        "csr_cols": (fx["wide"]["A"], lambda A, n: tpar.partition_csr_cols(
            _tcsr(A), n), lambda A, n: jpar.partition_csr_cols(
                jf.CSR.from_scipy(A), n)),
        "rowlane": (fx["rowlane"]["A"], lambda A, n: tpar.partition_rowlane(
            _tcsr(A), n, group=8), lambda A, n: jpar.partition_rowlane(
                jf.CSR.from_scipy(A), n, group=8)),
        "rowlane_bf16": (fx["rowlane"]["A"],
                         lambda A, n: tpar.partition_rowlane(
                             _tcsr(A), n, group=8, dtype=torch.bfloat16),
                         lambda A, n: jpar.partition_rowlane(
                             jf.CSR.from_scipy(A), n, group=8,
                             dtype=jnp.bfloat16)),
        "dualgather": (fx["dg"]["A"], lambda A, n: tpar.partition_dualgather(
            _tcsr(A), n, group=4), lambda A, n: jpar.partition_dualgather(
                jf.CSR.from_scipy(A), n, group=4)),
        "dense": (fx["dense"]["A"], lambda A, n: tpar.partition_dense_rows(
            _tcsr(A), n), lambda A, n: jpar.partition_dense_rows(
                jf.CSR.from_scipy(A), n)),
        "bell": (fx["bell"]["A"], lambda A, n: tpar.partition_bell_rows(
            smt.csr_to_blocked_ell(_tcsr(A), block_shape=(8, 64),
                                   device="cpu"), n),
            lambda A, n: jpar.partition_bell_rows(jf.csr_to_blocked_ell(
                jf.CSR.from_scipy(A), block_shape=(8, 64)), n)),
        "halo": (fx["halo"]["A"], lambda A, n: tpar.partition_csr_halo(
            _tcsr(A), n, 8), lambda A, n: jpar.partition_csr_halo(
                jf.CSR.from_scipy(A), n, 8)),
        "halo_ring": (fx["ring"]["A"],
                      lambda A, n: tpar.partition_csr_halo_ring(
                          _tcsr(A), n, 32),
                      lambda A, n: jpar.partition_csr_halo_ring(
                          jf.CSR.from_scipy(A), n, 32)),
        "halo_var": (fx["var"]["A"], lambda A, n: tpar.partition_csr_halo_var(
            _tcsr(A), n), lambda A, n: jpar.partition_csr_halo_var(
                jf.CSR.from_scipy(A), n)),
    }


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["csr_rows", "csr_cols", "rowlane",
                                  "rowlane_bf16", "dualgather", "dense",
                                  "bell", "halo", "halo_ring", "halo_var"])
def test_partition_planes_match_jax(kind, n_shards):
    A, port, ref = _partitioners()[kind]
    got, want = port(A, n_shards), ref(A, n_shards)
    assert_same_planes(got, want)
    if kind == "rowlane" and n_shards >= 4:
        # rows < n·128: the last band holds no row and packs empty
        assert got.band_rows * (n_shards - 1) >= A.shape[0]
        assert not got.tile_nonempty[-1].any()
    if kind == "halo_var":
        assert (got.ragged_bytes, got.padded_bytes) == (
            want.ragged_bytes, want.padded_bytes)


def test_partitioners_refuse_nonlocal_matrices():
    d = np.zeros((64, 64), np.float32)
    d[0, 63] = 1.0  # reaches across the whole matrix
    d[np.arange(64), np.arange(64)] = 1.0
    A = _tcsr(sps.csr_matrix(d))
    for part in (lambda: tpar.partition_csr_halo(A, 8, halo=2),
                 lambda: tpar.partition_csr_halo_ring(A, 8, halo=2),
                 lambda: tpar.partition_csr_halo_var(A, 8)):
        with pytest.raises(ValueError):
            part()


# -- the dist_* on gloo ranks, against JAX and fp64 ---------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns at once: rank 0's (arrays, report) a world size."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(ranks.spawn, w,
                                  tmp_path_factory.mktemp(f"ranks{w}"),
                                  timeout=300) for w in WORLDS}
        return {w: f.result() for w, f in futures.items()}


def _jax_solve(case, fx, w):
    A = jf.CSR.from_scipy(fx["A"])
    mesh = _jmesh(w)
    part = jpar.shard_partitioned(jpar.partition_csr_rows(A, w), mesh)
    kw = dict(ranks.SOLVE_KW[case])
    precond = None
    if case == "cg_jacobi":
        precond = "jacobi"
    elif case == "cg_block_ic0_waves":
        precond = jpar.block_ic0_precond(A, w)
    elif case == "cg_block_ic0_fixpoint":
        precond = jpar.block_ic0_precond(A, w, engine="fixpoint", n_iters=6)
    elif case.startswith("bicgstab_block_ilu0"):
        precond = jpar.block_ilu0_precond(A, w)
    solver = (jpar.dist_gmres if case == "gmres" else jpar.dist_bicgstab
              if case.startswith("bicgstab") else jpar.dist_cg)
    res = jax.jit(lambda bb: solver(part, bb, mesh, precond=precond,
                                    **kw))(jnp.asarray(fx["b"]))
    return np.asarray(res.x), int(res.iters)


@functools.lru_cache(maxsize=None)
def _jax_product(case, w):
    """The JAX call's global result, under ``jax.jit`` (an eager
    ``shard_map`` call takes ~10× its compile here); one padded exchange
    serves both variable-halo cases."""
    fx = _fx(case)
    if case.startswith("spmv_halo_var"):
        case = "spmv_halo_var"
    fn, part = _jax_call(case, fx, w)
    rhs = fx["x"] if case.startswith("spmv") else fx["X"]
    return np.asarray(jax.jit(fn)(part, jnp.asarray(rhs)))


def _jax_call(case, fx, w):
    """(fn(part, rhs), part) of a product case."""
    A = jf.CSR.from_scipy(fx["A"])
    mesh = _jmesh(w)
    if case in ("spmv_rows", "spmm_rows") or "_cols_" in case:
        fn = jpar.dist_spmv if case.startswith("spmv") else jpar.dist_spmm
        split = (jpar.partition_csr_rows if "_rows" in case
                 else jpar.partition_csr_cols)
        reduce = case.split("_cols_")[1] if "_cols_" in case else "psum"
        return (lambda p, r: fn(p, r, mesh, reduce=reduce),
                jpar.shard_partitioned(split(A, w), mesh))
    if case in ("spmv_rowlane", "spmm_rowlane"):
        fn = (jpar.dist_spmv_rowlane if case == "spmv_rowlane"
              else jpar.dist_spmm_rowlane)
        return (lambda p, r: fn(p, r, mesh),
                jpar.partition_rowlane(A, w, group=8))
    if case in ("spmv_dualgather", "spmm_dualgather"):
        fn = (jpar.dist_spmv_dualgather if case == "spmv_dualgather"
              else jpar.dist_spmm_dualgather)
        return (lambda p, r: fn(p, r, mesh),
                jpar.partition_dualgather(A, w, group=4))
    if case == "spmm_dense":
        return (lambda p, r: jpar.dist_spmm_dense(p, r, mesh),
                jpar.shard_dense(jpar.partition_dense_rows(A, w), mesh))
    if case in ("spmm_dense_2d", "spmm_2d"):
        n_row, n_col = ranks.mesh_2d_shape(w)
        mesh2 = jpar.make_mesh_2d(n_row, n_col)
        if case == "spmm_dense_2d":
            return (lambda p, r: jpar.dist_spmm_dense_2d(p, r, mesh2),
                    jpar.partition_dense_rows(A, n_row))
        part = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, NamedSharding(mesh2, P("row"))),
            jpar.partition_csr_rows(A, n_row))
        return lambda p, r: jpar.dist_spmm_2d(p, r, mesh2), part
    if case == "spmm_bell":
        bell = jf.csr_to_blocked_ell(A, block_shape=(8, 64))
        return (lambda p, r: jpar.dist_spmm_bell(p, r, mesh),
                jpar.shard_bell(jpar.partition_bell_rows(bell, w), mesh))
    if case == "spmv_halo":
        return (lambda p, r: jpar.dist_spmv_halo(p, r, mesh),
                jpar.shard_halo(jpar.partition_csr_halo(A, w, ranks.HALO[case]),
                                mesh))
    if case == "spmv_halo_ring":
        return (lambda p, r: jpar.dist_spmv_halo_ring(p, r, mesh),
                jpar.shard_halo_ring(jpar.partition_csr_halo_ring(
                    A, w, ranks.HALO[case]), mesh))
    if case == "spmv_halo_var":
        return (lambda p, r: jpar.dist_spmv_halo_var(p, r, mesh,
                                                     use_ragged=False),
                jpar.partition_csr_halo_var(A, w))
    raise KeyError(case)


PRODUCTS = [c for c in ranks.CASES if c not in ranks.SOLVE_KW]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", PRODUCTS)
def test_dist_product_matches_jax_and_fp64(runs, case, world):
    arrays, report = runs[world]
    assert report["cases"][case]["ok"], report["cases"][case]
    got = arrays[case]
    np.testing.assert_allclose(got, ranks.oracle(case, _fx(case)), **TOL)
    want = _jax_product(
        "spmv_halo_var_ragged" if case.startswith("spmv_halo_var") else case,
        world)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(ranks.SOLVE_KW))
def test_dist_solver_matches_jax(runs, case, world):
    arrays, report = runs[world]
    rep = report["cases"][case]
    assert rep["ok"], rep  # true residual < 5e-5 in fp64
    want_x, want_iters = _jax_solve(case, _fx(case), world)
    np.testing.assert_allclose(arrays[case], want_x, rtol=2e-3, atol=2e-3)
    if case == "gmres":
        assert abs(rep["iters"] - want_iters) <= ranks.SOLVE_KW[case][
            "restart"]
    else:
        assert abs(rep["iters"] - want_iters) <= max(2, 0.1 * want_iters), (
            rep["iters"], want_iters)


def test_ranks_launch_no_kernel_on_cpu(runs):
    for w in WORLDS:
        assert runs[w][1]["launches"] == {}
        assert runs[w][1]["backend"] == "gloo"
        assert runs[w][1]["staged"] is False


# -- host-side pieces ------------------------------------------------------------

def _fake_mesh(n, rank):
    return Mesh(("shard",), (None,), (rank,), (n,), torch.device("cpu"))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_shard_vector_follows_jax_padding(n):
    """The bands of ``shard_vector`` are the JAX ``_pad_vec`` bands."""
    x = torch.arange(1, 11, dtype=torch.float32)
    b = -(-10 // n)
    want = np.zeros(n * b, np.float32)
    want[:10] = x.numpy()
    for r in range(n):
        got = tpar.shard_vector(x, _fake_mesh(n, r))
        assert np.array_equal(got.numpy(), want[r * b:(r + 1) * b])
    X = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    got = tpar.shard_vector(X, _fake_mesh(n, n - 1), dim=1)
    assert np.array_equal(got.numpy(), np.pad(X.numpy(), (
        (0, 0), (0, n * b - 10)))[:, (n - 1) * b:])


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="not initialized"):
        tpar.make_mesh(device="cpu")


def test_solvers_refuse_column_and_rectangular_partitions():
    mesh = _fake_mesh(1, 0)
    fx = fixtures()
    cols = tpar.partition_csr_cols(_tcsr(fx["poisson"]["A"]), 1)
    rect = tpar.partition_csr_rows(_tcsr(fx["rect"]["A"]), 1)
    b = torch.zeros(144)
    for solver in (tpar.dist_cg, tpar.dist_bicgstab, tpar.dist_gmres):
        with pytest.raises(ValueError, match="row-partitioned"):
            solver(cols, b, mesh)
        with pytest.raises(ValueError, match="square"):
            solver(rect, b, mesh)


def test_scaling_bytes_match_jax():
    jsc = importlib.import_module("sparsematrix_tpu.parallel.scaling")
    tsc = importlib.import_module("sparsematrix_tpu_torch.parallel.scaling")
    for n in (1, 2, 4, 8):
        pairs = [(tsc.spmv_row_cost(4096, 4096, 65536, n),
                  jsc.spmv_row_cost(4096, 4096, 65536, n)),
                 (tsc.spmm_row_cost(4096, 3000, 65536, 32, n,
                                    dtype=np.float16),
                  jsc.spmm_row_cost(4096, 3000, 65536, 32, n,
                                    dtype=np.float16))]
        for reduce in ("psum", "psum_scatter"):
            pairs += [(tsc.spmv_col_cost(1000, 4096, 9999, n, reduce=reduce),
                       jsc.spmv_col_cost(1000, 4096, 9999, n, reduce=reduce)),
                      (tsc.spmm_col_cost(1000, 4096, 9999, 8, n,
                                         reduce=reduce),
                       jsc.spmm_col_cost(1000, 4096, 9999, 8, n,
                                         reduce=reduce))]
        fx = fixtures()["var"]["A"]
        pairs.append((tsc.halo_cost(tpar.partition_csr_halo_var(_tcsr(fx), n)),
                      jsc.halo_cost(jpar.partition_csr_halo_var(
                          jf.CSR.from_scipy(fx), n))))
        for got, want in pairs:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    got = tsc.weak_scaling_table(4096, 64, k=16)
    want = jsc.weak_scaling_table(4096, 64, k=16)
    for g, w in zip(got, want):
        for key in ("n_devices", "rows", "nnz", "comm_bytes_per_device",
                    "local_compute_bytes"):
            assert g[key] == w[key], key
        assert 0 < g["weak_scaling_efficiency"] <= 1.0
    assert got[0]["weak_scaling_efficiency"] == 1.0
    # the card's rates (H100 SXM HBM3, NVLink 4 a direction), not the TPU's
    assert (tsc.HBM_GBPS, tsc.LINK_GBPS) == (3350.0, 450.0)
    assert not hasattr(tsc, "ICI_GBPS")
