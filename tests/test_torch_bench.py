"""The port's bench suite (``sparsematrix_tpu_torch/bench``), its timer and
roofline against the JAX package's.

On the CPU every group runs its plain paths at a tiny size, with every
check true; the names, shapes and checks of three groups are held to
the JAX group's at the same arguments (the JAX side with its timers
replaced by one call, since only the rows' names and checks are
compared).  The card runs the suite through ``chip_smoke.py``.
"""
import json

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import sparsematrix_tpu.bench.suite as jsuite
import sparsematrix_tpu.utils.roofline as jroof
from sparsematrix_tpu.bench.harness import BenchFilter as JFilter
from sparsematrix_tpu.bench.harness import StepList as JStepList
from sparsematrix_tpu.utils.timer import BenchResult as JBenchResult
from sparsematrix_tpu_torch.bench import cli, harness, headline, suite
from sparsematrix_tpu_torch.bench.harness import (BenchFilter, BenchRegistry,
                                                  Row, StepList)
from sparsematrix_tpu_torch.utils import roofline, timer

CPU = "cpu"
JSON_KEYS = {"name", "shape", "min_ms", "mean_ms", "gnnz_per_s", "sol_frac",
             "checked", "nnz"}

# every registered group at a tiny size (the defaults are the card's)
TINY = {
    "calibrate": dict(n=64, stream_rows=64),
    "csr_spmv": dict(sizes=(256,)),
    "csr_spmv_large": dict(n=512, nnz_row=32),
    "spmm_csr": dict(n=256, ks=(8,)),
    "spmm_bell": dict(n=512, density=0.3, ks=(8,)),
    "spmm_banded": dict(n=512, k=8),
    "bsr": dict(n=256, k=8),
    "csr_spmv_xl": dict(n=1024, nnz_row=16),
    "spmv_clustered": dict(n=4096, nnz=2000),
    "spmv_skew": dict(n=1024, nnz_row=8),
    "spgemm_skew": dict(n=1024, density=0.002),
    "weak_scaling": dict(),
    "spgemm": dict(n=256, density=0.02),
    "spgemm_xl": dict(n=512, density=0.004),
    "spgemm_crossover": dict(points=((256, 0.02),)),
    "trisolve": dict(n=256, nnz_row=4),
    "ilu_cg": dict(n=64, iters=5, maxiter=300),
    "ilu_cg_xl": dict(n=256, iters=5, maxiter=600),
    "spmm_xl": dict(n=1024, k=8),
    "block_cg_xl": dict(n=256, iters=5),
    "ilu_cg_aniso": dict(n=256, iters=5),
    "codebook_gemm": dict(ref_m=8, ref_n=64, ref_k=96),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small torch and BLAS calls: one thread each, so the suite's
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_registry(monkeypatch):
    """The suite's registry with no rows or failures of earlier tests."""
    reg = BenchRegistry()
    reg._benches = dict(suite.registry._benches)
    monkeypatch.setattr(suite, "registry", reg)
    monkeypatch.setattr(cli, "registry", reg)
    return reg


@pytest.fixture
def jax_one_call(monkeypatch):
    """The JAX suite's timers replaced by one call of the function: only
    the rows' names, shapes and checks are compared."""
    def once(fn, *args, **_kw):
        fn(*args)
        return JBenchResult(mean_ms=1.0, min_ms=1.0, compile_ms=0.0,
                            iters=1)

    def chain_once(step, x0, *extra, **_kw):
        step(x0, *extra)
        return JBenchResult(mean_ms=1.0, min_ms=1.0, compile_ms=0.0,
                            iters=1)

    monkeypatch.setattr(jsuite, "bench_fn_slope", once)
    monkeypatch.setattr(jsuite, "bench_chain_slope", chain_once)


def test_registry_has_the_jax_groups_in_order():
    names = list(suite.registry._benches)
    assert names == list(jsuite.registry._benches)
    assert len(names) == 22 and set(TINY) == set(names)


@pytest.mark.parametrize("spec", ["8", "4:64", "117", "1:1", "3:40", 117])
def test_steplist_matches_jax(spec):
    assert list(StepList(spec)) == list(JStepList(spec))


@pytest.mark.parametrize("patterns", [None, "", "codebook", "codebook,-fused",
                                      "^csr_spmv$,spgemm", "-xl", " a , -b ,"])
def test_filter_matches_jax(patterns):
    names = ["codebook_gemm/csr-auto", "codebook_gemm/fused-pallas",
             "csr_spmv", "csr_spmv_xl", "spgemm_xl", "spgemm", "calibrate",
             "a", "b", "ab"]
    ours, theirs = BenchFilter(patterns), JFilter(patterns)
    assert [ours.accept(n) for n in names] == [theirs.accept(n) for n in names]


@pytest.mark.parametrize("args", [(1000, 64, 64), (16_600_000, 32768, 32768),
                                  (5, 3, 7, 2, 0), (12, 8, 9, 4, 4)])
def test_roofline_bytes_match_jax(args):
    assert roofline.spmv_csr_bytes(*args[:3], *args[3:]) == \
        jroof.spmv_csr_bytes(*args[:3], *args[3:])
    nnz, rows, cols = args[:3]
    for k in (1, 32):
        for waste in (1.0, 1.7):
            assert roofline.spmm_bytes(nnz, rows, cols, k,
                                       stored_block_waste=waste) == \
                jroof.spmm_bytes(nnz, rows, cols, k, stored_block_waste=waste)
    assert roofline.spmm_bytes(nnz, rows, cols, 8, idx_bytes=0) == \
        jroof.spmm_bytes(nnz, rows, cols, 8, idx_bytes=0)


def test_roofline_chip_is_the_h100():
    chip = roofline.active_chip()
    assert (chip.hbm_gbps, chip.bf16_tflops, chip.fp32_tflops) == (
        3350.0, 989.0, 67.0)
    assert roofline.PEAK_BYTES == 3.35e12 and roofline.PEAK_FP32 == 67e12
    assert roofline.speed_of_light_nnz_s(100, 3350) == pytest.approx(1e11)
    # the same law as the JAX function at the same bandwidth
    assert roofline.speed_of_light_nnz_s(10, 4096, jroof.V5E) == \
        jroof.speed_of_light_nnz_s(10, 4096, jroof.V5E)
    m = roofline.set_measured_chip(3000.0)
    assert roofline.measured_chip() == m and m.fp32_tflops == 67.0


def test_timer_on_cpu_tensors():
    calls = []

    def f(x):
        calls.append(1)
        return x + 1

    x = torch.ones(4)
    res = timer.bench_fn_slope(f, x, iters=5, warmup=2)
    assert isinstance(res, timer.BenchResult)
    assert len(calls) == 1 + 2 + 5
    assert res.iters == 5 and res.extras["clock"] == "host"
    assert 0 <= res.min_ms <= res.extras["median_ms"]
    assert res.min_ms <= res.mean_ms and res.compile_ms >= 0
    res = timer.bench_fn(f, x, iters=3, warmup=1)
    assert isinstance(res, timer.BenchResult) and res.min_ms <= res.mean_ms


def test_chain_timer_feeds_each_output_back():
    seen = []

    def step(y, s):
        seen.append(float(y[0]))
        return y * s

    res = timer.bench_chain_slope(step, torch.ones(3), 2.0, iters=4,
                                  warmup=1)
    assert seen == [2.0 ** i for i in range(1 + 1 + 4)]
    assert res.extras["clock"] == "host"


def test_timer_finds_the_device_of_containers():
    assert timer._cuda_device((torch.ones(2), [None, {"a": 1}])) is None
    A = suite.CSR.fromdense(np.eye(4, dtype=np.float32), device=CPU)
    assert timer._cuda_device((A,)) is None


def test_timer_class():
    t = timer.Timer().start()
    assert t.elapsed_ms >= 0
    t.pause()
    paused = t.elapsed_ms
    assert t.elapsed_ms == paused
    t.resume()
    assert t.stop() >= paused


def test_registry_records_failures_and_drops(fresh_registry, capsys):
    reg = BenchRegistry()

    @reg.register("good")
    def good(**kw):
        ok = Row("good/row", "s", timer.BenchResult(1.0, 1.0, 0.0, 1), nnz=10,
                 checked=True)
        bad = Row("good/unreliable", "s",
                  timer.BenchResult(1.0, 1.0, 0.0, 1, {"unreliable": True}))
        return [ok, bad]

    @reg.register("broken")
    def broken(**kw):
        raise RuntimeError("boom")

    @reg.register("after")
    def after(**kw):
        return Row("after/row", "s", timer.BenchResult(2.0, 2.0, 0.0, 1))

    rows = reg.run(BenchFilter(None))
    assert [r.name for r in rows] == ["good/row", "after/row"]
    assert reg.failed == ["broken"] and reg.dropped == ["good/unreliable"]
    out = capsys.readouterr()
    assert "[row] good/row" in out.out and "[drop] good/unreliable" in out.out
    assert "[bench] broken FAILED" in out.err
    reg.print_table()
    assert "good/row" in capsys.readouterr().out


def test_registry_stops_at_the_deadline(capsys):
    reg = BenchRegistry()
    reg.register("one")(lambda **kw: [])
    reg.run(BenchFilter(None), deadline=0.0)
    assert "BENCH_BUDGET exhausted" in capsys.readouterr().out


@pytest.mark.parametrize("group", list(TINY))
def test_every_group_runs_and_checks_at_a_tiny_size(group, fresh_registry):
    rows = suite.registry._benches[group](check=True, device=CPU,
                                          **TINY[group])
    assert rows and all(isinstance(r, Row) for r in rows)
    assert all(r.name.startswith(group + "/") for r in rows)
    # every row that has an oracle passes it
    assert [r.name for r in rows if r.checked is False] == []
    assert any(r.checked for r in rows) or group in ("calibrate",
                                                     "weak_scaling")
    for r in rows:
        assert np.isfinite(r.result.min_ms) and r.result.min_ms > 0
        if r.sol_frac is not None:
            assert np.isfinite(r.sol_frac) and r.sol_frac >= 0
    assert fresh_registry.failed == []


@pytest.mark.parametrize("group,kw", [
    ("codebook_gemm", dict(ref_m=8, ref_n=64, ref_k=96,
                           variants=("csr-auto", "dense-dequant"))),
    ("csr_spmv", dict(sizes=(128,))),
    ("spmv_skew", dict(n=1024, nnz_row=8)),
])
def test_rows_match_the_jax_group(group, kw, jax_one_call, fresh_registry):
    ours = suite.registry._benches[group](check=True, device=CPU, **kw)
    theirs = jsuite.registry._benches[group](check=True, **kw)
    assert [(r.name, r.shape.replace("cuBLAS", "on-MXU"), r.checked, r.nnz)
            for r in ours] == [(r.name, r.shape, r.checked, r.nnz)
                               for r in theirs]


def test_cli_writes_the_jax_keys(tmp_path, fresh_registry, capsys):
    out = tmp_path / "rows.json"
    cli.main(["8", "64", "96", "1", "codebook", str(out)], device=CPU)
    assert "codebook_gemm" in capsys.readouterr().out
    rows = json.loads(out.read_text())
    names = [r["name"] for r in rows]
    assert names == [f"codebook_gemm/{v}" for v in (
        "csr-auto", "dense-dequant", "dense-dequant-bf16", "fused-pallas",
        "fused-pallas-bf16", "int8-gemm", "int16-gemm", "dense-race-fp32",
        "dense-race-bf16", "dense-race-pre")]
    for r in rows:
        assert JSON_KEYS <= set(r) <= JSON_KEYS | {"extras"}
        assert r["extras"]["vs_baseline"] > 0
    assert all(r["checked"] for r in rows if r["checked"] is not None)
    # calibrate runs only on the card
    assert not any(n.startswith("calibrate") for n in names)
    assert fresh_registry.failed == []


def test_cli_sweeps_and_budget(tmp_path, fresh_registry, monkeypatch,
                               capsys):
    monkeypatch.setenv("BENCH_BUDGET", "1e9")
    cli.main(["8:16", "64", "96", "0", "^codebook"], device=CPU)
    rows = fresh_registry.rows
    shapes = {r.shape.split(",")[0] for r in rows}
    assert shapes == {"m=8", "m=16"}
    assert all(r.checked is None for r in rows)


def test_codebook_variant_failure_is_recorded(fresh_registry, monkeypatch,
                                              capsys):
    def broken(*a, **k):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(suite, "add_mat_mat_int8", broken)
    rows = suite.bench_codebook_gemm(check=True, device=CPU, ref_m=8,
                                     ref_n=64, ref_k=96,
                                     variants=("csr-auto", "int8-gemm"))
    assert "codebook_gemm/int8-gemm" not in [r.name for r in rows]
    assert fresh_registry.failed == ["codebook_gemm/int8-gemm"]
    assert "variant codebook_gemm/int8-gemm failed" in capsys.readouterr().err


def test_headline_has_the_bench_py_keys(fresh_registry):
    out = headline.headline(device=CPU, m=8, n=64, k=96)
    assert set(out) == {"metric", "path", "value", "unit", "vs_baseline",
                        "checked", "nnz", "gnnz_per_s", "mean_ms",
                        "compile_ms", "dense_race_fp32_ms",
                        "dense_race_bf16_ms"}
    assert out["metric"] == "codebook_sparse_gemm_8x64x96_ms"
    assert out["checked"] is True and out["unit"] == "ms"
    assert out["path"] in [f"codebook_gemm/{v}" for v in headline.VARIANTS]
    assert headline.VARIANTS == ("fused-pallas", "dense-dequant",
                                 "dense-dequant-bf16", "fused-pallas-bf16",
                                 "int8-gemm", "int16-gemm")
    assert json.loads(json.dumps(out)) == out
