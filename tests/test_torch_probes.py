"""The probes' kernels (``sparsematrix_tpu_torch/probes``) against the JAX
probe and repro scripts, and the port's ``utils/profiling``.

Each plain version of the port (what a CPU tensor runs) is held against
the script's Pallas kernel, run under ``pltpu.force_tpu_interpret_mode()``
on the CPU, and against an fp64 oracle (the script's own where it has
one), with the scripts' own check: max error over max |oracle| < 1e-4
(``benchmarks/probe_dualgather.py:130``).  The scripts are loaded from
``benchmarks/`` and ``docs/`` with ``importlib``; nothing of them changes.

* rows 24-26 at the scripts' P1 sizes, with random chunk indices ``idxA``
  (an ``idxA`` constant along lanes would hide reading it at the wrong
  lane); the single step's Pallas kernel is the one ``main`` defines,
  taken from the script's source;
* row 23's three bodies on a 2048² pack with 16 nonzeros a row, group 8,
  the JAX pack carried by ``formats/carry.py``; only tiles that a group
  visits are compared (the JAX kernel leaves the others unwritten);
* row 27 at (8, 128), (16, 128) and (8, 256), with the repro's inputs
  through its own ``run`` and with random indices;
* row 28 through a ``pallas_call`` built here around the repro's own
  ``kernel_1d``/``kernel_2d`` with two-argument index maps, since the
  repro's ``run`` raises (``test_smem_repro_run_raises``).

The card runs the kernels themselves (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import ast
import dataclasses
import importlib
import importlib.util
import inspect
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

from sparsematrix_tpu.formats import CSR as JCSR
from sparsematrix_tpu_torch.formats import from_numpy_fields
from sparsematrix_tpu_torch.kernels import _build
from sparsematrix_tpu_torch.kernels import probe_gather_step as pg
from sparsematrix_tpu_torch.kernels.probe_meta_scale import meta_scale
from sparsematrix_tpu_torch.kernels.probe_rowlane import (STEPS, pad_x,
                                                          probe_rowlane)
from sparsematrix_tpu_torch.kernels.probe_tile_gather import tile_gather
from sparsematrix_tpu_torch.probes._common import Session
from sparsematrix_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4  # the scripts' check: max error over max |oracle|
PROBES = ("probe_xl_spmv", "probe_dualgather", "probe_sublane_slice",
          "repro_dynamic_gather_shapes", "repro_smem_lane_padding",
          "probe_calibrate_xcheck")


@pytest.fixture(autouse=True)
def one_thread():
    """Many small torch and BLAS calls: one thread each, so the suite's
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _load(rel: str):
    name = "jaxprobe_" + pathlib.Path(rel).stem
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {"dg": _load("benchmarks/probe_dualgather.py"),
            "ss": _load("benchmarks/probe_sublane_slice.py"),
            "xl": _load("benchmarks/probe_xl_spmv.py"),
            "gather": _load("docs/repro_dynamic_gather_shapes.py"),
            "smem": _load("docs/repro_smem_lane_padding.py")}


def _inner(mod, outer: str, names):
    """Functions that ``mod.<outer>`` defines in its body, compiled in the
    module's namespace (the script's single-gather kernel lives in its
    ``main``)."""
    tree = ast.parse(inspect.getsource(getattr(mod, outer)))
    defs = [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = dict(vars(mod))
    exec(compile(ast.Module(body=defs, type_ignores=[]), mod.__file__,
                 "exec"), ns)
    return [ns[n] for n in names]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _planes(seed, S, group=8, n_groups=4):
    """The scripts' planes at their P1 sizes (random ``idxA``)."""
    rng = np.random.default_rng(seed)
    return {"win": rng.integers(0, S // 8, (n_groups, group)).astype(np.int32),
            "ptr": rng.integers(0, S, (n_groups, group, 8)).astype(np.int32),
            "idxA": rng.integers(0, 8, (n_groups, group * 8, 128)).astype(
                np.int8),
            "idxB": rng.integers(0, 128, (n_groups, group * 8, 128)).astype(
                np.int8),
            "vals": rng.normal(size=(n_groups, group * 8, 128)).astype(
                np.float32),
            "xp": rng.normal(size=(S, 128)).astype(np.float32)}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


# -- rows 24-26: the gather steps --------------------------------------------

def test_dual_step_matches_jax_and_oracle(scripts):
    dg = scripts["dg"]
    d = _planes(0, 64)
    t = _t(d)
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(dg.dual_call(d["win"], d["idxA"], d["idxB"],
                                       d["vals"], d["xp"], group=8))
    got = pg.dual_step(t["win"], t["idxA"], t["idxB"], t["vals"],
                       t["xp"]).numpy()
    ref = dg.oracle(d["win"], d["idxA"], d["idxB"], d["vals"], d["xp"])
    assert rel_err(got[0], ref) < TOL and rel_err(jout[0], ref) < TOL
    assert rel_err(got, jout) < TOL and not got[1:].any()


def test_single_step_matches_jax_and_oracle(scripts):
    dg = scripts["dg"]
    (single_call,) = _inner(dg, "main", ["single_kernel", "single_call"])[1:]
    d = _planes(1, 64)
    t = _t(d)
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(single_call(d["win"], d["idxB"], d["vals"],
                                      d["xp"], group=8))
    got = pg.single_step(t["win"], t["idxB"], t["vals"], t["xp"]).numpy()
    # the single step is the dual step with idxA[u, c] = u
    ident = np.broadcast_to(np.arange(8, dtype=np.int8)[:, None],
                            (8, 128))
    ref = dg.oracle(d["win"], np.tile(ident, (4, 8, 1)), d["idxB"],
                    d["vals"], d["xp"])
    assert rel_err(got[0], ref) < TOL and rel_err(jout[0], ref) < TOL
    assert rel_err(got, jout) < TOL and not got[1:].any()


def test_pooled_step_matches_jax_and_oracle(scripts):
    ss = scripts["ss"]
    d = _planes(2, 256)
    t = _t(d)
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(ss.pooled_call(d["ptr"], d["idxA"], d["idxB"],
                                         d["vals"], d["xp"], group=8))
    got = pg.pooled_step(t["ptr"], t["idxA"], t["idxB"], t["vals"],
                         t["xp"]).numpy()
    ref = ss.oracle(d["ptr"], d["idxA"], d["idxB"], d["vals"], d["xp"])
    assert rel_err(got[0], ref) < TOL and rel_err(jout[0], ref) < TOL
    assert rel_err(got, jout) < TOL and not got[1:].any()


@pytest.mark.parametrize("mode", ["single", "dual", "pooled"])
def test_step_oracles_agree(scripts, mode):
    """The port probe's chunked fp64 oracle is the scripts' loop oracle."""
    from sparsematrix_tpu_torch.probes.probe_dualgather import oracle

    d = _planes(3, 256, group=5, n_groups=3)
    if mode == "single":
        d["idxA"] = np.tile(np.broadcast_to(
            np.arange(8, dtype=np.int8)[:, None], (8, 128)), (3, 5, 1))
    want = (scripts["ss"].oracle(d["ptr"], d["idxA"], d["idxB"], d["vals"],
                                 d["xp"]) if mode == "pooled" else
            scripts["dg"].oracle(d["win"], d["idxA"], d["idxB"], d["vals"],
                                 d["xp"]))
    assert rel_err(oracle(mode, d), want) < 1e-12


# -- row 23: the rowlane walk's ablations -------------------------------------

@pytest.fixture(scope="module")
def xl_small(scripts):
    """A 2048² CSR with 16 draws a row (the script's ``build`` law), its
    JAX rowlane pack at group 8 without the tail, the pack carried into
    the port, and x."""
    xl = scripts["xl"]
    g = np.random.default_rng(9)
    n, per = 2048, 16
    rows = np.repeat(np.arange(n), per)
    cols = g.integers(0, n, n * per)
    data = g.uniform(-1000, 1000, n * per).astype(np.float32)
    sp = sps.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    jp = xl.strip_spill(xl.pack_sell_rowlane(JCSR.from_scipy(sp), group=8))
    arrays, statics = {}, {}
    for f in dataclasses.fields(jp):
        v = getattr(jp, f.name)
        if f.metadata.get("static", False):
            statics[f.name] = v
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    tp = from_numpy_fields("SellRowLane", arrays, statics, device="cpu")
    x = g.standard_normal(n).astype(np.float32)
    return jp, tp, x


def _variant_oracle(jp, xp, step):
    """fp64: each slab's body summed into row 8t of its tile."""
    s_idx = np.asarray(jp.s_idx).reshape(-1, 8, 128).astype(np.int64) & 127
    vals = np.asarray(jp.vals).reshape(-1, 8, 128).astype(np.float64)
    win = np.asarray(jp.slab_win).reshape(-1)
    tile = np.repeat(np.asarray(jp.group_tile), jp.group)
    xf = xp.reshape(-1).astype(np.float64)
    base = (np.arange(8) * 128)[None, :, None]
    if step == "dma-only":
        part = vals.sum(axis=1)
    else:
        col = (base + s_idx if step == "fixed-window" else
               win[:, None, None] * 1024 + base + np.arange(128))
        part = (vals * np.where(col < xf.size,
                                xf[np.minimum(col, xf.size - 1)],
                                0.0)).sum(axis=1)
    out = np.zeros((jp.n_tiles * 8, 128))
    np.add.at(out, tile * 8, part)
    return out


@pytest.mark.parametrize("step", STEPS)
def test_rowlane_variant_matches_jax_and_oracle(scripts, xl_small, step):
    jp, tp, x = xl_small
    xp = pad_x(torch.from_numpy(x), tp.n_win)
    S = jp.n_win * 8
    jxp = jnp.zeros((S * 128,), jnp.float32).at[:x.shape[0]].set(
        x).reshape(S, 128)
    assert np.array_equal(np.asarray(jxp), xp.numpy())
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(scripts["xl"].variant_kernels(jp)[step](jp, jxp))
    got = probe_rowlane(tp, xp, step).numpy()
    ref = _variant_oracle(jp, xp.numpy(), step)
    visited = (np.unique(np.asarray(jp.group_tile))[:, None] * 8
               + np.arange(8)).ravel()
    assert rel_err(got, ref) < TOL
    assert rel_err(jout[visited], ref[visited]) < TOL
    assert rel_err(got[visited], jout[visited]) < TOL
    assert not np.delete(got, np.arange(0, got.shape[0], 8), axis=0).any()


def test_rowlane_variant_refuses_bf16_values(xl_small):
    """The probe walks fp32 packs only."""
    _, tp, x = xl_small
    bf = dataclasses.replace(tp, vals=tp.vals.to(torch.bfloat16))
    with pytest.raises(ValueError, match="fp32"):
        probe_rowlane(bf, pad_x(torch.from_numpy(x), tp.n_win), "dma-only")


# -- row 27: the row gather at any tile shape ---------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (16, 128), (8, 256)])
def test_tile_gather_matches_jax(scripts, shape):
    rep = scripts["gather"]
    R, C = shape
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(rep.run(shape, shape))  # arange table, index 0
        tab = np.random.default_rng(R + C).normal(size=shape).astype(
            np.float32)
        idx = np.random.default_rng(R * C).integers(0, C, shape).astype(
            np.int32)
        jrand = np.asarray(pl.pallas_call(
            rep.gather_kernel,
            out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))(tab, idx))
    got = tile_gather(torch.arange(R * C, dtype=torch.float32).reshape(R, C),
                      torch.zeros(shape, dtype=torch.int32)).numpy()
    assert np.array_equal(got, jout)
    got = tile_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    want = np.take_along_axis(tab.astype(np.float64), idx, axis=1)
    assert rel_err(got, want) < TOL and rel_err(jrand, want) < TOL
    assert np.array_equal(got, jrand)


# -- row 28: per-step metadata ----------------------------------------------

def test_smem_repro_run_raises(scripts):
    """The reference fault: the repro's index maps take one argument and
    its grid spec passes two, so ``run`` fails before a kernel runs."""
    with pltpu.force_tpu_interpret_mode():
        for two_d in (False, True):
            with pytest.raises(TypeError, match="positional argument"):
                scripts["smem"].run(two_d=two_d)


@pytest.mark.parametrize("two_d", [False, True])
def test_meta_scale_matches_jax(scripts, two_d):
    rep = scripts["smem"]
    rows, cols = rep.ROWS, rep.COLS
    meta = np.arange(rows * cols, dtype=np.int32)
    if two_d:
        meta = meta.reshape(rows, cols)
    x = np.random.default_rng(7).normal(size=(8, 128)).astype(np.float32)
    grid = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(rows,),
        in_specs=[pl.BlockSpec((8, 128), lambda i, m: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda i, m: (0, 0),
                               memory_space=pltpu.VMEM))
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(pl.pallas_call(
            rep.kernel_2d if two_d else rep.kernel_1d,
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            grid_spec=grid)(meta, x))
    got = meta_scale(torch.from_numpy(meta), torch.from_numpy(x),
                     None if two_d else cols).numpy()
    want = x.astype(np.float64) * ((rows - 1) * cols)
    assert rel_err(got, want) < TOL and rel_err(jout, want) < TOL
    assert np.array_equal(got, jout)


def test_meta_scale_refuses_more_steps_than_the_repro():
    """At most the repro's 512 steps: the kernel stages them all at once."""
    x = torch.zeros((8, 128))
    meta_scale(torch.zeros(512 * 6, dtype=torch.int32), x, 6)
    with pytest.raises(ValueError, match="512 steps"):
        meta_scale(torch.zeros(513 * 6, dtype=torch.int32), x, 6)
    with pytest.raises(ValueError, match="512 steps"):
        meta_scale(torch.zeros((0, 6), dtype=torch.int32), x)


# -- utils/profiling ------------------------------------------------------------

def test_time_probe():
    """Twin of ``tests/test_utils.py::test_time_probe``."""
    profiling.reset_probes()
    with profiling.time_probe("x"):
        time.sleep(0.005)
    with profiling.time_probe("x"):
        pass
    totals = profiling.probe_totals()
    assert totals["x"][1] == 2
    assert totals["x"][0] >= 5


def test_time_probe_matches_jax_semantics():
    """The same spans give the same counts and keys as the JAX module, and
    a span that raises still counts."""
    from sparsematrix_tpu.utils import profiling as jprof

    for mod in (profiling, jprof):
        mod.reset_probes()
        for name in ("a", "b", "a"):
            with mod.time_probe(name):
                pass
        with pytest.raises(ValueError):
            with mod.time_probe("c"):
                raise ValueError
    got, want = profiling.probe_totals(), jprof.probe_totals()
    assert {k: v[1] for k, v in got.items()} == {k: v[1]
                                                 for k, v in want.items()}
    profiling.reset_probes()
    assert profiling.probe_totals() == {}
    # the port adds ``kernel_times``, the reader of ``device_trace``'s
    # profiler; the JAX module's names are all there
    assert set(profiling.__all__) == set(jprof.__all__) | {"kernel_times"}


def test_device_trace_on_cpu(tmp_path):
    """The trace of a CPU region: written as Chrome JSON with the
    annotation, and the yielded profiler holds the ops."""
    a = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("probe span"):
            (a @ a).sum()
    keys = {e.key for e in prof.key_averages()}
    assert "probe span" in keys and "aten::matmul" in keys
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "probe span" for e in events)
    assert profiling.kernel_times(prof) == {}  # no CUDA kernel ran


# -- the probe modules ------------------------------------------------------------

# each module's ``run`` at a tiny size (None: its command line, which
# runs at the script's size, small enough for the CPU)
TINY = {"probe_xl_spmv": lambda m, s: m.run(s, *m.build(2048, 16)),
        "probe_dualgather": lambda m, s: m.run(s, card_groups=2),
        "probe_sublane_slice": lambda m, s: m.run(s, card_groups=2),
        "repro_dynamic_gather_shapes": None,
        "repro_smem_lane_padding": None,
        "probe_calibrate_xcheck": lambda m, s: m.run(s, mib=1)}


@pytest.mark.parametrize("name", PROBES)
def test_probe_module_on_cpu(name, tmp_path, capsys):
    """Each module on the CPU at a tiny size (the repros through their
    command line with ``--device cpu``): every check passes, every row is
    a JSON line (no device time, no card) and the ``--out`` file holds the
    same rows; no kernel launches."""
    mod = importlib.import_module(f"sparsematrix_tpu_torch.probes.{name}")
    out = tmp_path / "rows.json"
    _build.launch_counts.clear()
    if TINY[name] is None:
        assert mod.main(["--device", "cpu", "--out", str(out)]) == 0
    else:
        assert TINY[name](mod, Session("cpu", str(out)))
    assert sum(_build.launch_counts.values()) == 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    rows = json.loads(out.read_text())
    assert printed == rows and rows
    assert all(r["device"] == "cpu" and r["card"] is None for r in rows)
    assert all(r.get("ms") is None for r in rows)
    assert all(r["ok"] for r in rows if "ok" in r)


def test_probe_xl_names_are_the_scripts(scripts, xl_small):
    """The XL probe's configurations and bodies carry the script's names."""
    from sparsematrix_tpu_torch.probes import probe_xl_spmv as txl

    src = inspect.getsource(scripts["xl"].main)
    assert all(f'"{tag}"' in src for tag in txl.CONFIGS)
    assert set(scripts["xl"].variant_kernels(xl_small[0])) == set(STEPS)


@pytest.mark.parametrize("name", PROBES)
def test_probe_module_needs_a_card(name):
    """Without ``--device cpu`` a module runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"sparsematrix_tpu_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
