"""Benchmark suite: the JAX package's groups, on the port.

Twin of ``sparsematrix_tpu/bench/suite.py``: the same 22 groups in the
same order, with the same defaults, row names, oracles and check
policies, and SoL % against the H100's spec sheet (``utils/roofline.py``).
Every group takes ``device`` through ``**kw`` and runs on the card unless
given ``device="cpu"``.

How the twins differ, each for a reason the JAX suite does not have:

- Timing (``utils/timer.py``): one call at a time, CUDA events behind a
  spin kernel with the L2 flushed, where the JAX timers slope many calls
  inside one device program.  The JAX value chains (``y ← A·y·2⁻²⁰``, the
  calibrate matmul chain) stay chains: each timed call takes the previous
  output, and the rescale keeps the values bounded.
- Tracing: PyTorch has none.  Where a JAX row passes a container into
  ``jax.jit`` as a traced argument, the JAX dispatch sees no concrete
  container and takes its plain path (no auto-pack, no panel pack); the
  twin calls that plain path by name (``spmv_reference``,
  ``spmm_bsr_grouped_reference``).  Where a JAX row closes over the
  container, the twin calls the public op, which packs once and caches.
- Dense races are ``torch.matmul``: fp32 at full precision (TF32 is off,
  ``config.py``), bf16 as the second race.  A shape string that named the
  TPU's matrix unit names cuBLAS instead.
- ``codebook_gemm/fused-pallas`` and ``-bf16`` run the port's fused
  codebook kernel (table row 1, ``csrc/codebook_spmm.cu``) under the JAX
  row names; ``calibrate/hbm-stream`` runs row 22 (``csrc/stream_copy.cu``).
- ``spgemm``'s ``dist-packed-1shard`` row needs ``parallel/dist_spgemm``,
  which the port does not have yet (ROADMAP Queue 1 item 4): the group
  has every other row.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from ..config import resolve_device
from ..formats import (CSR, CodebookCSR, CodebookDense, Dense, QuantDense,
                       StripDense, csr_to_blocked_ell, csr_to_bsr)
from ..formats.base import host_values
from ..kernels.bsr import spmm_bsr_grouped_reference
from ..kernels.codebook import codebook_matmul
from ..kernels.spmm_blocked_ell import spmm_blocked_ell
from ..kernels.spmm_dualgather import spmm_dualgather
from ..kernels.spmm_rowlane import spmm_rowlane
from ..kernels.spmv_dualgather import pack_dualgather, spmv_dualgather
from ..kernels.spmv_octet import pack_octet, spmm_octet, spmv_octet
from ..kernels.spmv_rowlane import pack_sell_rowlane, spmv_sell_rowlane
from ..kernels.spmv_sell import (pack_sell, pack_sell_rowpure, spmv_sell,
                                 spmv_sell_rowpure)
from ..kernels.stream_copy import stream_copy
from ..kernels.trisolve_fused import trisolve_fused_apply, trisolve_fused_plan
from ..kernels.trisolve_waves import (trisolve_waves_apply,
                                      trisolve_waves_apply_mm,
                                      trisolve_waves_plan)
from ..ops import (add_mat_mat, add_mat_mat_int8, add_mat_mat_int16,
                   quantize_codebook, spmm, spmm_densify, spmm_reference,
                   spmv, spmv_reference)
from ..ops.ichol import ic0_fused_plans, ic0_waves_plans, ic_apply
from ..ops.ilu import (ilu0, ilu0_fixpoint_plans, ilu0_waves_plans,
                       ilu_apply)
from ..ops.skew import SkewSpmv
from ..ops.spgemm import (spgemm_apply, spgemm_apply_packed,
                          spgemm_apply_packed_csc, spgemm_densify,
                          spgemm_extract, spgemm_plan, spgemm_plan_packed)
from ..ops.spmm_lowdeg import pack_sliced_ell, spmm_sliced_ell
from ..ops.spmv import prepare_spmv
from ..ops.trisolve import (trisolve_apply, trisolve_fixpoint_apply,
                            trisolve_fixpoint_plan, trisolve_level_apply,
                            trisolve_level_plan, trisolve_plan)
from ..parallel.scaling import weak_scaling_table
from ..solvers import block_cg, cg
from ..utils.roofline import (active_chip, speed_of_light_nnz_s, spmm_bytes,
                              spmv_csr_bytes)
from ..utils.testutils import (gen_matrix_random, gen_random_dense_sparse,
                               gen_sparse_index_matrix, gen_zipf_csr,
                               poisson2d, quantized_check, relative_check)
from ..utils.timer import BenchResult, bench_chain_slope, bench_fn_slope
from .harness import BenchRegistry, Row

__all__ = ["registry", "REF_M", "REF_N", "REF_K", "REF_BASELINE_MS",
           "gen_zipf_csr"] + [f"bench_{g}" for g in (
               "calibrate", "csr_spmv", "csr_spmv_large", "spmm_csr",
               "spmm_bell", "spmm_banded", "bsr", "csr_spmv_xl",
               "spmv_clustered", "spmv_skew", "spgemm_skew", "weak_scaling",
               "spgemm", "spgemm_xl", "spgemm_crossover", "trisolve",
               "ilu_cg", "ilu_cg_xl", "spmm_xl", "block_cg_xl",
               "ilu_cg_aniso", "codebook_gemm")]

registry = BenchRegistry()

REF_M, REF_N, REF_K = 117, 1023, 2047  # the reference's blas_test defaults
REF_BASELINE_MS = 7.5  # the reference's x86 AVX2 figure (kernel.cc:381)


def _device(kw) -> torch.device:
    return resolve_device(kw.get("device"))


def _t(arr, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return host_values(t)


def _bf16_round(arr: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
        torch.bfloat16).double().numpy()


def _bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 result (the JAX ``preferred_element_type=f32``
    product): ``torch.mm(..., out_dtype=torch.float32)`` on the card; the
    CPU build has no such kernel, and there the operands' fp32 product
    gives the same sums."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _dense_race_row(tag, dense_np, rhs, nnz):
    """The on-card dense baseline the reference harness always races
    against: same shape, one dense product.  nnz/s here is *effective*
    (sparse-equivalent work per second) so rows are directly comparable."""
    dd = _t(dense_np, rhs.device)
    res = bench_fn_slope(lambda m, v: m @ v, dd, rhs)
    n, m = dense_np.shape
    # include the RHS width so per-k races stay distinct rows in merges
    k_str = f",k={rhs.shape[1]}" if rhs.ndim == 2 else ""
    r = Row(f"{tag}/dense-race", f"{n}x{m}{k_str} dense cuBLAS", res,
            nnz=nnz)
    r.sol_frac = None  # roofline basis differs; Gnnz/s column is the race
    return r


@registry.register("calibrate")
def bench_calibrate(check=True, n=2048, stream_rows=2048 * 128, **kw):
    """Calibration rows: a fixed matmul and a fixed HBM stream, measured
    so that two result files can be normalized against each other.  Each
    is a self-dependent chain; a row above the spec sheet (×1.05) is a
    timing artifact and is flagged unreliable, so the registry drops it.
    ``n`` and ``stream_rows`` size the two (the defaults are the JAX
    rows'; the CPU tests shrink them)."""
    dev = _device(kw)
    chip = active_chip()
    rows = []
    rng0 = np.random.default_rng(0)
    d = _t(rng0.uniform(-1, 1, (n, n)).astype(np.float32), dev)
    for tag, mm in (("fp32", d), ("bf16", d.to(torch.bfloat16))):
        scale = 2.0 ** -11  # keep the chain O(1)

        def step(y, _a=mm, _s=scale):
            return (y @ _a) * _s

        res = bench_chain_slope(step, mm)
        r = Row(f"calibrate/matmul-{tag}", f"{n}^3 chained", res,
                nnz=2 * n**3)  # nnz/s column reads as FLOP/s
        r.sol_frac = None
        tflops = 2 * n**3 / (res.min_ms * 1e-3) / 1e12
        spec = chip.bf16_tflops if tag == "bf16" else chip.fp32_tflops
        if tflops > spec * 1.05:
            res.extras["unreliable"] = True
        r.extras = {"tflops": tflops, **res.extras}
        rows.append(r)
    # HBM stream: a copy chain through the hand-written copy kernel (table
    # row 22), 128 MB at the default size
    big = _t(rng0.standard_normal((stream_rows, 128)).astype(np.float32), dev)
    res = bench_chain_slope(stream_copy, big)
    mb = big.numel() * 4 // (1 << 20)
    r = Row("calibrate/hbm-stream", f"{mb}MB cuda copy chained", res,
            nnz=big.numel())
    r.sol_frac = None
    gbps = 2 * big.numel() * 4 / (res.min_ms * 1e-3) / 1e9
    if gbps > chip.hbm_gbps * 1.05:  # same spec cap as matmul rows
        res.extras["unreliable"] = True
    r.extras = {"gb_per_s": gbps, **res.extras}
    rows.append(r)
    return rows


def _banded(rng, n, bandwidth):
    dense = np.zeros((n, n), dtype=np.float32)
    for off in range(-bandwidth // 2, bandwidth // 2 + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.uniform(-1, 1, idx.shape[0])
    return dense


@registry.register("csr_spmv")
def bench_csr_spmv(check=True, sizes=(4096,), **kw):
    dev = _device(kw)
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        for nnz_row in (4, 16, 64, 128):
            density = nnz_row / n
            dense = gen_random_dense_sparse(rng, n, n, density=density)
            A = CSR.fromdense(dense, device=dev)
            x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
            # the JAX row hands A to jit as a traced argument, where no
            # auto-pack runs: the plain CSR product
            f = spmv_reference
            res = bench_fn_slope(f, A, x)
            checked = None
            if check:
                checked = relative_check(_np(f(A, x)), dense @ _np(x))
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/random", f"n={n},nnz/row={nnz_row}", res,
                    nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        # encode-once convention: the public spmv packs the concrete
        # container at its first call and caches the pack
        dense = gen_random_dense_sparse(rng, n, n, density=128 / n)
        A = CSR.fromdense(dense, device=dev)
        x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
        fa = lambda v: spmv(A, v)  # noqa: E731
        res = bench_fn_slope(fa, x)
        checked = None
        if check:
            checked = relative_check(_np(fa(x)), dense @ _np(x))
        sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
        r = Row("csr_spmv/auto", f"n={n},nnz/row=128 (auto-pack dispatch)",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        rows.append(r)
        # SELL kernel rows (the packed fast paths)
        for nnz_row, tr in ((128, 64),):
            dense = gen_random_dense_sparse(rng, n, n, density=nnz_row / n)
            A = CSR.fromdense(dense, device=dev)
            packed = pack_sell(A, tr=tr)
            x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
            f = spmv_sell
            res = bench_fn_slope(f, packed, x)
            checked = (relative_check(_np(f(packed, x)), dense @ _np(x))
                       if check else None)
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/sell-pallas",
                    f"n={n},nnz/row={nnz_row},tr={tr},fill={packed.fill_rate:.2f}",
                    res, nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        for nnz_row, R in ((64, 16), (128, 8)):
            dense = gen_random_dense_sparse(rng, n, n, density=nnz_row / n)
            A = CSR.fromdense(dense, device=dev)
            packed = pack_sell_rowpure(A, group=4, rows_per_sublane=R)
            x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
            f = spmv_sell_rowpure
            res = bench_fn_slope(f, packed, x)
            checked = (relative_check(_np(f(packed, x)), dense @ _np(x))
                       if check else None)
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/rowpure-pallas",
                    f"n={n},nnz/row={nnz_row},R={R},fill={packed.fill_rate:.2f}",
                    res, nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        # row-lane kernel
        for nnz_row in (64, 128):
            dense = gen_random_dense_sparse(rng, n, n, density=nnz_row / n)
            A = CSR.fromdense(dense, device=dev)
            packed = pack_sell_rowlane(A)
            x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
            f = spmv_sell_rowlane
            res = bench_fn_slope(f, packed, x)
            checked = (relative_check(_np(f(packed, x)), dense @ _np(x))
                       if check else None)
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/rowlane-pallas",
                    f"n={n},nnz/row={nnz_row},g={packed.group},"
                    f"fill={packed.fill_rate:.2f}",
                    res, nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        # on-card dense race at the densest config
        rows.append(_dense_race_row("csr_spmv", dense, x, A.nnz))
        for bw in (9, 65):
            dense = _banded(rng, n, bw)
            A = CSR.fromdense(dense, device=dev)
            x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
            f = spmv_reference  # traced A in the JAX row, as above
            res = bench_fn_slope(f, A, x)
            checked = (relative_check(_np(f(A, x)), dense @ _np(x))
                       if check else None)
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/banded", f"n={n},band={bw}", res, nnz=A.nnz,
                    checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
            # the band-local layout: strip-dense batched matvec
            S = StripDense.from_csr(A)
            fs = spmv_reference
            res = bench_fn_slope(fs, S, x)
            checked = (relative_check(_np(fs(S, x)), dense @ _np(x))
                       if check else None)
            sol = speed_of_light_nnz_s(
                A.nnz, spmv_csr_bytes(S.strips.numel(), n, n, idx_bytes=0))
            r = Row("csr_spmv/banded-strip",
                    f"n={n},band={bw},width={S.width}", res, nnz=A.nnz,
                    checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
    return rows


@registry.register("csr_spmv_large")
def bench_csr_spmv_large(check=True, n=8192, nnz_row=256, **kw):
    """The ≥2 M-nnz scale point: row-lane kernel fp32 + bf16, raced
    against the on-card dense matvec."""
    dev = _device(kw)
    rng = np.random.default_rng(7)
    dense = gen_random_dense_sparse(rng, n, n, density=nnz_row / n)
    A = CSR.fromdense(dense, device=dev)
    x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
    rows = []
    for dt, tag in ((None, "fp32"), (torch.bfloat16, "bf16")):
        packed = pack_sell_rowlane(A, dtype=dt)
        # a bf16-stored matrix is checked against the bf16-rounded values
        # (its storage contract), in fp64
        dref = (dense.astype(np.float64) if dt is None
                else _bf16_round(dense))
        want = dref @ _np(x).astype(np.float64)
        f = spmv_sell_rowlane
        # value chain (y ← A·y rescaled)
        res = bench_chain_slope(
            lambda y, p_: f(p_, y) * 2.0 ** -16, x, packed)
        checked = relative_check(_np(f(packed, x)), want) if check else None
        sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
        r = Row(f"csr_spmv_large/rowlane-{tag}",
                f"n={n},nnz/row={nnz_row},g={packed.group},"
                f"fill={packed.fill_rate:.2f}",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        slab_bytes = (packed.vals.numel() * packed.vals.element_size()
                      + packed.s_idx.numel())
        r.extras = {"bw_util": slab_bytes / (res.min_ms * 1e-3) / 1e9
                    / active_chip().hbm_gbps, **res.extras}
        rows.append(r)
    # no dual-gather rows here, as in the JAX group: the XL group is the
    # scale point for that layout
    rows.append(_dense_race_row("csr_spmv_large", dense, x, A.nnz))
    return rows


@registry.register("spmm_csr")
def bench_spmm_csr(check=True, n=2048, density=0.05, ks=(32, 128, 512),
                   **kw):
    dev = _device(kw)
    rng = np.random.default_rng(1)
    dense = gen_random_dense_sparse(rng, n, n, density=density)
    A = CSR.fromdense(dense, device=dev)
    D = Dense.from_sparse(A)  # build-time materialization (dense regime)
    # quantized pre-dense containers: bf16 halves the dominant A plane,
    # int8 halves it again (per-row scales), checked against the fp64
    # oracle with the scale-floored policy
    Dbf = Dense.from_sparse(A, dtype=torch.bfloat16)
    Q = QuantDense.from_sparse(A)
    rows = []
    for k in ks:
        X = _t(gen_matrix_random(rng, n, k), dev)
        for label, f, op in (
            ("spmm_csr/segsum", spmm_reference, A),
            ("spmm_csr/densify", spmm_densify, A),
            ("spmm_csr/pre-dense", spmm, D),
            ("spmm_csr/pre-dense-bf16", spmm, Dbf),
            ("spmm_csr/pre-dense-int8", spmm, Q),
        ):
            res = bench_fn_slope(f, op, X)
            checked = None
            if check:
                got = _np(f(op, X))
                want = dense.astype(np.float64) @ _np(X)
                if label.endswith(("bf16", "int8")):
                    checked = quantized_check(
                        got, want,
                        med_tol=0.04 if label.endswith("int8") else 0.02,
                        q99_tol=0.2 if label.endswith("int8") else 0.1)
                else:
                    checked = relative_check(got, want)
            sol = speed_of_light_nnz_s(A.nnz, spmm_bytes(A.nnz, n, n, k))
            r = Row(label, f"n={n},k={k},d={density}", res, nnz=A.nnz,
                    checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        if k <= 64:
            # low-density multi-RHS kernel (row 8)
            packed = pack_sell_rowlane(A)
            fr = spmm_rowlane
            res = bench_fn_slope(fr, packed, X)
            checked = None
            if check:
                checked = relative_check(
                    _np(fr(packed, X)), dense.astype(np.float64) @ _np(X))
            sol = speed_of_light_nnz_s(A.nnz, spmm_bytes(A.nnz, n, n, k))
            r = Row("spmm_csr/rowlane", f"n={n},k={k},d={density}", res,
                    nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
            # the dual-gather walk (k_tiles = 1)
            dpk = pack_dualgather(A, k_tiles=1)
            fd = spmm_dualgather
            res = bench_fn_slope(fd, dpk, X)
            checked = None
            if check:
                checked = relative_check(
                    _np(fd(dpk, X)), dense.astype(np.float64) @ _np(X))
            r = Row("spmm_csr/dualgather-walk", f"n={n},k={k},d={density}",
                    res, nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        rows.append(_dense_race_row("spmm_csr", dense, X, A.nnz))
    return rows


@registry.register("spmm_bell")
def bench_spmm_bell(check=True, n=2048, density=0.05, ks=(128, 512), **kw):
    """Blocked-ELL on two inputs: unstructured sparsity forced into (8,128)
    blocks (the layout-mismatch case) and block-structured sparsity at
    (128,128) blocks, every stored block a full tile."""
    dev = _device(kw)
    rng = np.random.default_rng(2)
    rows = []

    # (a) unstructured → (8,128) blocks: mostly block padding
    dense_u = gen_random_dense_sparse(rng, n, n, density=density)
    bell_u = csr_to_blocked_ell(CSR.fromdense(dense_u, device=dev),
                                block_shape=(8, 128))
    # (b) block-structured → (128,128) blocks, density of BLOCK slots
    bm = bk = 128
    mask = rng.random((n // bm, n // bk)) < density
    dense_b = (np.kron(mask, np.ones((bm, bk))).astype(np.float32)
               * gen_matrix_random(rng, n, n))
    bell_b = csr_to_blocked_ell(CSR.fromdense(dense_b, device=dev),
                                block_shape=(bm, bk))
    for tag, dense, bell in (("unstructured-8x128", dense_u, bell_u),
                             ("blockstruct-128x128", dense_b, bell_b)):
        nnz = int((dense != 0).sum())
        for k in ks:
            X = _t(gen_matrix_random(rng, n, k), dev)
            f = spmm_blocked_ell
            res = bench_fn_slope(f, bell, X)
            checked = None
            if check:
                checked = relative_check(
                    _np(f(bell, X)), dense.astype(np.float64) @ _np(X))
            # roofline accounts the padded blocks actually streamed
            bbm, bbk = bell.block_shape
            eff_nnz = bell.num_block_rows * bell.max_blocks_per_row * bbm * bbk
            sol = speed_of_light_nnz_s(
                nnz, spmm_bytes(eff_nnz, n, n, k, idx_bytes=0))
            r = Row(f"spmm_bell/{tag}", f"n={n},k={k},d={density}", res,
                    nnz=nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        # race each input against a plain dense product
        rows.append(_dense_race_row(f"spmm_bell/{tag}", dense, X, nnz))
    return rows


@registry.register("spmm_banded")
def bench_spmm_banded(check=True, n=4096, k=128, **kw):
    """Band-local structure (block-tridiagonal, the FEM/stencil shape):
    StripDense densifies each 128-row strip locally and batch-multiplies
    it, against the (8,128) Blocked-ELL kernel on the same matrix and
    the dense race."""
    dev = _device(kw)
    rng = np.random.default_rng(12)
    bs = 128  # block size: block-tridiagonal -> strips span <= 3 blocks
    nb = n // bs
    mask = np.zeros((nb, nb), bool)
    for o in (-1, 0, 1):
        idx = np.arange(max(0, -o), nb - max(0, o))
        mask[idx, idx + o] = True
    dense = (np.kron(mask, np.ones((bs, bs))).astype(np.float32)
             * gen_matrix_random(rng, n, n))
    csr = CSR.fromdense(dense, device=dev)
    nnz = csr.nnz
    S = StripDense.from_csr(csr)
    bell = csr_to_blocked_ell(csr, block_shape=(8, 128))
    X = _t(gen_matrix_random(rng, n, k), dev)
    x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
    oracle = dense.astype(np.float64) @ _np(X)
    rows = []
    for tag, f, args, eff, idxb in (
        ("strip-spmm", spmm_reference, (S, X), S.strips.numel(), 0),
        ("bell-spmm", spmm_blocked_ell, (bell, X),
         bell.num_block_rows * bell.max_blocks_per_row * 8 * 128, 0),
    ):
        res = bench_fn_slope(f, *args)
        checked = relative_check(_np(f(*args)), oracle) if check else None
        sol = speed_of_light_nnz_s(nnz, spmm_bytes(eff, n, n, k,
                                                   idx_bytes=idxb))
        r = Row(f"spmm_banded/{tag}",
                f"n={n},k={k},band=3x{bs},width={S.width}", res, nnz=nnz,
                checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        rows.append(r)
    # spmv on the same structure (strip matvec)
    fv = spmv_reference
    res = bench_fn_slope(fv, S, x)
    checked = (relative_check(_np(fv(S, x)),
                              dense.astype(np.float64) @ _np(x))
               if check else None)
    sol = speed_of_light_nnz_s(
        nnz, spmv_csr_bytes(S.strips.numel(), n, n, idx_bytes=0))
    r = Row("spmm_banded/strip-spmv", f"n={n},band=3x{bs},width={S.width}",
            res, nnz=nnz, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    rows.append(_dense_race_row("spmm_banded", dense, X, nnz))
    return rows


@registry.register("bsr")
def bench_bsr(check=True, n=2048, block=(8, 8), density=0.05, k=128, **kw):
    dev = _device(kw)
    rng = np.random.default_rng(3)
    # block-structured sparsity: dense blocks at `density` of block slots
    nb = n // block[0]
    mask = rng.random((nb, n // block[1])) < density
    dense = (
        np.kron(mask, np.ones(block)).astype(np.float32)
        * gen_matrix_random(rng, n, n)
    )
    A = csr_to_bsr(CSR.fromdense(dense, device=dev), block_shape=block)
    x = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
    X = _t(gen_matrix_random(rng, n, k), dev)
    rows = []
    # encode-once convention: the public op on the concrete container
    # (build-time conversions cached)
    f1 = lambda v: spmv(A, v)  # noqa: E731
    res = bench_fn_slope(f1, x)
    chk = relative_check(_np(f1(x)), dense @ _np(x)) if check else None
    sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(
        A.nnz, n, n, idx_bytes=4 / (block[0] * block[1])))
    r = Row("bsr/spmv", f"n={n},b={block},d={density}", res, nnz=A.nnz,
            checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    # the JAX row hands A to jit as a traced argument: no panel pack, so a
    # small-block BSR takes the plain block product
    f2 = spmm_bsr_grouped_reference
    res = bench_fn_slope(f2, A, X)
    chk = (relative_check(_np(f2(A, X)), dense.astype(np.float64) @ _np(X))
           if check else None)
    sol = speed_of_light_nnz_s(A.nnz, spmm_bytes(A.nnz, n, n, k, idx_bytes=0))
    r = Row("bsr/spmm", f"n={n},b={block},k={k}", res, nnz=A.nnz, checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    # auto dispatch: small dense-enough blocks reroute to one dense product
    f2a = lambda m: spmm(A, m, method="auto")  # noqa: E731
    res = bench_fn_slope(f2a, X)
    chk = (relative_check(_np(f2a(X)), dense.astype(np.float64) @ _np(X))
           if check else None)
    r = Row("bsr/spmm-auto", f"n={n},b={block},k={k}", res, nnz=A.nnz,
            checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    # the concrete BSR packs the panel layout (the panel kernel, row 4)
    f3 = lambda m: spmm(A, m, method="sparse")  # noqa: E731
    res = bench_fn_slope(f3, X)
    chk = (relative_check(_np(f3(X)), dense.astype(np.float64) @ _np(X))
           if check else None)
    r = Row("bsr/spmm-panel", f"n={n},b={block},k={k}", res, nnz=A.nnz,
            checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    return rows


@registry.register("csr_spmv_xl")
def bench_csr_spmv_xl(check=True, n=32768, nnz_row=512, **kw):
    """The 10⁷-nnz scale point: built sparse end to end (no dense
    temporaries), oracle via scipy."""
    dev = _device(kw)
    # direct generation: fixed draws per row, duplicates merged by the
    # COO→CSR conversion
    g = np.random.default_rng(9)
    rows_ = np.repeat(np.arange(n), nnz_row)
    cols_ = g.integers(0, n, n * nnz_row)
    data_ = g.uniform(-1000, 1000, n * nnz_row).astype(np.float32)
    sp = sps.coo_matrix((data_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A = CSR.from_scipy(sp, device=dev)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n).astype(np.float32)
    xj = _t(x, dev)
    want = sp.astype(np.float64) @ x if check else None
    # bf16 oracle: the bf16-rounded stored values in fp64
    want_bf16 = None
    if check:
        spq = sp.copy().astype(np.float64)
        spq.data = _bf16_round(sp.data)
        want_bf16 = spq @ x
    sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
    f = spmv_sell_rowlane
    chain_scale = 2.0 ** -20
    rows = []
    for tag, kws in (("fp32", dict(group=256)),
                     ("bf16", dict(group=256, dtype=torch.bfloat16))):
        t0 = time.time()
        packed = pack_sell_rowlane(A, **kws)
        pack_s = time.time() - t0
        res = bench_chain_slope(
            lambda y, p_: f(p_, y) * chain_scale, xj, packed)
        checked = None
        if check:
            checked = relative_check(
                _np(f(packed, xj)),
                want_bf16 if kws.get("dtype") is not None else want)
        r = Row(f"csr_spmv_xl/rowlane-{tag}",
                f"n={n},nnz={A.nnz/1e6:.1f}M,g={packed.group},"
                f"fill={packed.fill_rate:.2f}",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        # the SoL gap split: the kernel's HBM utilization (slab bytes
        # streamed / time / spec bandwidth) against the packing fill
        slab_bytes = (packed.vals.numel() * packed.vals.element_size()
                      + packed.s_idx.numel())
        r.extras = {"pack_seconds": pack_s,
                    "bw_util": slab_bytes / (res.min_ms * 1e-3) / 1e9
                    / active_chip().hbm_gbps,
                    **res.extras}
        rows.append(r)
    # dual-gather superblocks: fp32 on two-window slabs of 8-tile
    # superblocks, bf16 on single-window g512/kt32 (the JAX configs)
    fdg = spmv_dualgather
    for tag, pack_kw in (
            ("fp32", dict(group=128, k_tiles=8, two_win=True)),
            ("bf16", dict(group=512, k_tiles=32, dtype=torch.bfloat16))):
        t0 = time.time()
        packed = pack_dualgather(A, **pack_kw)
        dg_pack_s = time.time() - t0
        res = bench_chain_slope(
            lambda y, p_: fdg(p_, y) * chain_scale, xj, packed)
        checked = None
        if check:
            checked = relative_check(
                _np(fdg(packed, xj)),
                want_bf16 if tag == "bf16" else want)
        r = Row(f"csr_spmv_xl/dualgather-{tag}",
                f"n={n},nnz={A.nnz/1e6:.1f}M,g={packed.group},"
                f"kt={packed.k_tiles},tw={int(packed.two_win)},"
                f"fill={packed.fill_rate:.2f}",
                res, nnz=A.nnz, checked=checked)
        nb = packed.vals.element_size()
        sol_dg = speed_of_light_nnz_s(
            A.nnz, spmv_csr_bytes(A.nnz, n, n, val_bytes=nb))
        r.sol_frac = r.nnz_per_s / sol_dg
        slab_bytes = (packed.vals.numel() * nb + packed.idxA.numel()
                      + packed.idxB.numel())
        r.extras = {"pack_seconds": dg_pack_s,
                    "bw_util": slab_bytes / (res.min_ms * 1e-3) / 1e9
                    / active_chip().hbm_gbps,
                    **res.extras}
        rows.append(r)
    return rows


@registry.register("spmv_clustered")
def bench_spmv_clustered(check=True, n=512 * 128, nnz=80_000, **kw):
    """The routing-contract point: clustered low-degree structure — 512
    row tiles whose ~1.2 entries a row all land in one 1024-column
    window.  Races the octet pack against the two-window dual-gather so
    the ``prepare_spmv`` auto rule (nnz ≤ 2·rows → octet) stays pinned
    to a measured winner."""
    dev = _device(kw)
    g = np.random.default_rng(0)
    rows_ = g.integers(0, n, size=nnz)
    cols_ = g.integers(0, 1024, size=nnz)
    vals_ = g.uniform(-1000, 1000, nnz).astype(np.float32)
    sp = sps.coo_matrix((vals_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A = CSR.from_scipy(sp, device=dev)
    x = g.standard_normal(n).astype(np.float32)
    xj = _t(x, dev)
    want = sp.astype(np.float64) @ x if check else None
    sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
    rows = []
    for tag, packer, run in (
            ("octet", lambda: pack_octet(A), spmv_octet),
            ("dualgather", lambda: pack_dualgather(A, k_tiles=8,
                                                   two_win=True),
             spmv_dualgather)):
        t0 = time.time()
        packed = packer()
        pack_s = time.time() - t0
        res = bench_fn_slope(run, packed, xj)
        checked = (relative_check(_np(run(packed, xj)), want)
                   if check else None)
        r = Row(f"spmv_clustered/{tag}",
                f"n={n},nnz={A.nnz},1win,fill={packed.fill_rate:.2f}",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"pack_seconds": pack_s}
        rows.append(r)
    return rows


@registry.register("spmv_skew")
def bench_spmv_skew(check=True, n=32768, nnz_row=512, **kw):
    """SpMV on power-law structure: the csr_spmv_xl size and nnz budget
    with Zipf row degrees and, in the second variant, Zipf column
    popularity (hub columns)."""
    dev = _device(kw)
    fdg = spmv_dualgather
    chain_scale = 2.0 ** -20
    rows = []
    for tag, col_zipf in (("rowzipf", False), ("hubcols", True)):
        sp = gen_zipf_csr(9, n, n, n * nnz_row, col_zipf=col_zipf)
        A = CSR.from_scipy(sp, device=dev)
        x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
        xj = _t(x, dev)
        want = sp.astype(np.float64) @ x if check else None
        sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
        dmax = int(np.diff(sp.indptr).max())
        t0 = time.time()
        packed = pack_dualgather(A, group=128, k_tiles=8, two_win=True)
        pack_s = time.time() - t0
        res = bench_chain_slope(
            lambda y, p_: fdg(p_, y) * chain_scale, xj, packed)
        checked = (relative_check(_np(fdg(packed, xj)), want)
                   if check else None)
        r = Row(f"spmv_skew/dualgather-{tag}",
                f"n={n},nnz={A.nnz/1e6:.1f}M,degmax={dmax},"
                f"fill={packed.fill_rate:.2f}",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"pack_seconds": pack_s, **res.extras}
        rows.append(r)
        # auto routes to the hybrid skew layout (ops/skew.py: hub rows and
        # columns dense-blocked, the rest degree-sorted)
        t0 = time.time()
        sk = prepare_spmv(A)
        sk_pack_s = time.time() - t0
        res = bench_chain_slope(
            lambda y, p_: spmv(p_, y) * chain_scale, xj, sk)
        checked = (relative_check(_np(spmv(sk, xj)), want)
                   if check else None)
        hr = int(sk.hub_rows.shape[0]) if isinstance(sk, SkewSpmv) else 0
        hc = int(sk.hub_cols.shape[0]) if isinstance(sk, SkewSpmv) else 0
        r = Row(f"spmv_skew/auto-skew-{tag}",
                f"n={n},nnz={A.nnz/1e6:.1f}M,degmax={dmax},hub_r={hr},"
                f"hub_c={hc},fill={sk.fill_rate:.2f}",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"pack_seconds": sk_pack_s, **res.extras}
        rows.append(r)
    return rows


@registry.register("spgemm_skew")
def bench_spgemm_skew(check=True, n=16384, density=0.001, **kw):
    """SpGEMM on power-law operands: the spgemm_xl nnz budget with Zipf
    row degrees on both A and B (columns uniform, so the pair count
    stays comparable)."""
    dev = _device(kw)
    total = int(n * n * density)
    sa = gen_zipf_csr(7, n, n, total)
    sb = gen_zipf_csr(8, n, n, total)
    A, B = CSR.from_scipy(sa, device=dev), CSR.from_scipy(sb, device=dev)
    want = None
    if check:
        want = (sa.astype(np.float64) @ sb.astype(np.float64)).T.tocsr()
        want.sort_indices()
    t0 = time.time()
    pp = spgemm_plan_packed(A, B, layout="octet")
    pack_s = time.time() - t0
    f = lambda q, bd: spgemm_apply_packed_csc(q, bd).data  # noqa: E731
    got = _np(f(pp, B.data))
    checked = (relative_check(got[: pp.c_nnz], want.data)
               if check else None)
    res = bench_fn_slope(f, pp, B.data)
    pairs = pp.p_packed.nnz
    sol_pairs = speed_of_light_nnz_s(
        pairs, pairs * (2 * 4 + 3 * 4) + pp.c_nnz * 4)
    r = Row("spgemm_skew/octet-csc",
            f"n={n},pairs={pairs},degmax={int(np.diff(sa.indptr).max())},"
            f"fill={pp.p_packed.fill_rate:.2f}",
            res, nnz=pairs, checked=checked)
    r.sol_frac = r.nnz_per_s / sol_pairs
    r.extras = {"pack_seconds": pack_s}
    return [r]


@registry.register("weak_scaling")
def bench_weak_scaling(check=True, **kw):
    """MODELED weak scaling: per-device collective bytes from the
    partition geometry (``parallel/scaling.py``) plus the measured
    single-card SpMV throughput from this run when there is one."""
    # calibrate the local-compute term to the fastest measured kernel in
    # this run: the dual-gather XL row when present (the layout the
    # distributed SpMV inherits), else rowlane-large
    measured = None
    basis = "HBM roofline"
    for name in ("csr_spmv_xl/dualgather-fp32", "csr_spmv_large/rowlane-fp32"):
        for r in registry.rows:
            if r.name == name:
                measured = r.nnz_per_s / 1e9
                basis = f"measured single-chip {name.split('/')[1]}"
                break
        if measured is not None:
            break
    table = weak_scaling_table(8192, 256, ns=[1, 2, 4, 8],
                               measured_single_chip_gnnz=measured)
    rows = []
    for row in table:
        res = BenchResult(mean_ms=row["modeled_step_s"] * 1e3,
                          min_ms=row["modeled_step_s"] * 1e3,
                          compile_ms=0.0, iters=0,
                          extras={"modeled": True})
        r = Row(f"weak_scaling/modeled-{row['n_devices']}dev",
                f"rows={row['rows']},comm={row['comm_bytes_per_device']}B",
                res, nnz=row["nnz"])
        r.extras = {
            "weak_scaling_efficiency": row["weak_scaling_efficiency"],
            "modeled": True,
            "basis": basis,
        }
        rows.append(r)
    return rows


@registry.register("spgemm")
def bench_spgemm(check=True, n=2048, density=0.01, **kw):
    """SpGEMM symbolic (host, seconds) + numeric (device, pairs/s)."""
    dev = _device(kw)
    rng = np.random.default_rng(5)
    da = gen_random_dense_sparse(rng, n, n, density=density)
    db = gen_random_dense_sparse(rng, n, n, density=density)
    A, B = CSR.fromdense(da, device=dev), CSR.fromdense(db, device=dev)
    t0 = time.time()
    plan = spgemm_plan(A, B)
    plan_s = time.time() - t0
    f = lambda p, ad, bd: spgemm_apply(p, ad, bd).data  # noqa: E731
    res = bench_fn_slope(f, plan, A.data, B.data)
    want = (sps.csr_matrix(da.astype(np.float64))
            @ sps.csr_matrix(db.astype(np.float64))).tocsr()
    want.sort_indices()
    checked = None
    if check:
        got = _np(f(plan, A.data, B.data))
        checked = relative_check(got[: plan.c_nnz], want.data)
    # traffic: read both operand data planes + pair indices, write C
    bytes_moved = plan.n_pairs * (2 * 4 + 3 * 4) + plan.c_nnz * 4
    sol = speed_of_light_nnz_s(plan.n_pairs, bytes_moved)
    r = Row("spgemm/numeric", f"n={n},d={density},pairs={plan.n_pairs}",
            res, nnz=plan.n_pairs, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    r.extras = {"plan_seconds": plan_s, "c_nnz": plan.c_nnz}
    rows = [r]
    # packed numeric phase: the pair program run as an SpMV
    t0 = time.time()
    pp = spgemm_plan_packed(A, B)
    pack_s = time.time() - t0
    fp = lambda q, bd: spgemm_apply_packed(q, bd).data  # noqa: E731
    res = bench_fn_slope(fp, pp, B.data)
    checked = None
    if check:
        got = _np(fp(pp, B.data))
        checked = relative_check(got[: pp.c_nnz], want.data)
    r2 = Row("spgemm/numeric-packed",
             f"n={n},d={density},pairs={plan.n_pairs},"
             f"fill={pp.p_packed.fill_rate:.2f}",
             res, nnz=plan.n_pairs, checked=checked)
    r2.sol_frac = r2.nnz_per_s / sol
    r2.extras = {"pack_seconds": pack_s}
    rows.append(r2)
    # CSC-native output (no c_nnz permutation)
    fpc = lambda q, bd: spgemm_apply_packed_csc(q, bd).data  # noqa: E731
    res = bench_fn_slope(fpc, pp, B.data)
    checked = None
    if check:
        wantT = want.T.tocsr()
        wantT.sort_indices()
        got = _np(fpc(pp, B.data))
        checked = relative_check(got[: pp.c_nnz], wantT.data)
    r2c = Row("spgemm/numeric-packed-csc",
              f"n={n},d={density},pairs={plan.n_pairs},"
              f"fill={pp.p_packed.fill_rate:.2f}",
              res, nnz=plan.n_pairs, checked=checked)
    r2c.sol_frac = r2c.nnz_per_s / sol
    r2c.extras = {"pack_seconds": pack_s}
    rows.append(r2c)

    # density-adaptive dense path: the full dense product (+ optional
    # pattern extraction)
    Ad, Bd = Dense.from_sparse(A), Dense.from_sparse(B)
    fd = lambda a, b: spgemm_densify(a, b).data  # noqa: E731
    res = bench_fn_slope(fd, Ad, Bd)
    checked = None
    if check:
        got = _np(fd(Ad, Bd))
        wr, wc = want.nonzero()
        checked = relative_check(got[wr, wc], np.asarray(want[wr, wc]).ravel())
    r3 = Row("spgemm/densify-mxu", f"n={n},d={density},pairs={plan.n_pairs}",
             res, nnz=plan.n_pairs, checked=checked)
    r3.sol_frac = r3.nnz_per_s / sol
    rows.append(r3)

    fe = lambda a, b, p: spgemm_extract(p, spgemm_densify(a, b)).data  # noqa: E731
    res = bench_fn_slope(fe, Ad, Bd, plan)
    checked = None
    if check:
        got = _np(fe(Ad, Bd, plan))
        checked = relative_check(got[: plan.c_nnz], want.data)
    r4 = Row("spgemm/densify-extract",
             f"n={n},d={density},pairs={plan.n_pairs}",
             res, nnz=plan.n_pairs, checked=checked)
    r4.sol_frac = r4.nnz_per_s / sol
    rows.append(r4)
    # (the JAX group's dist-packed-1shard row needs parallel/dist_spgemm,
    # not ported yet: ROADMAP Queue 1 item 4)
    return rows


@registry.register("spgemm_xl")
def bench_spgemm_xl(check=True, n=16384, density=0.001, **kw):
    """SpGEMM at a scale where densify is a 1 GB fp32 product: the packed
    pair program on the superblock, octet and rowlane layouts, raced
    against the dense product."""
    dev = _device(kw)
    rng = np.random.default_rng(7)
    sa = sps.random(n, n, density=density, random_state=7, format="csr",
                    dtype=np.float32)
    sb = sps.random(n, n, density=density, random_state=8, format="csr",
                    dtype=np.float32)
    sa.data = rng.uniform(-1000, 1000, sa.nnz).astype(np.float32)
    sb.data = rng.uniform(-1000, 1000, sb.nnz).astype(np.float32)
    A, B = CSR.from_scipy(sa, device=dev), CSR.from_scipy(sb, device=dev)
    rows = []
    want = None
    if check:
        want = (sa.astype(np.float64) @ sb.astype(np.float64)).tocsr()
        want.sort_indices()
    fp = lambda q, bd: spgemm_apply_packed(q, bd).data  # noqa: E731
    fpc = lambda q, bd: spgemm_apply_packed_csc(q, bd).data  # noqa: E731
    for label, layout in (("superblock", "superblock"),
                          ("octet", "octet"),
                          ("rowlane", "rowlane")):
        t0 = time.time()
        pp = spgemm_plan_packed(A, B, layout=layout)
        pack_s = time.time() - t0
        res = bench_fn_slope(fp, pp, B.data)
        checked = None
        if check:
            got = _np(fp(pp, B.data))
            checked = relative_check(got[: pp.c_nnz], want.data)
        n_pairs = pp.p_packed.nnz
        bytes_moved = n_pairs * (2 * 4 + 3 * 4) + pp.c_nnz * 4
        sol = speed_of_light_nnz_s(n_pairs, bytes_moved)
        r = Row(f"spgemm_xl/{label}",
                f"n={n},d={density},pairs={n_pairs},"
                f"fill={pp.p_packed.fill_rate:.2f}",
                res, nnz=n_pairs, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"pack_seconds": pack_s, "c_nnz": pp.c_nnz}
        rows.append(r)
        if label in ("superblock", "octet"):
            # CSC-native output (C^T as CSR): skips the c_nnz-element
            # output permutation of the CSR row
            res = bench_fn_slope(fpc, pp, B.data)
            checked = None
            if check:
                wantT = want.T.tocsr()
                wantT.sort_indices()
                got = _np(fpc(pp, B.data))
                checked = relative_check(got[: pp.c_nnz], wantT.data)
            r = Row(f"spgemm_xl/{label}-csc",
                    f"n={n},d={density},pairs={n_pairs},"
                    f"fill={pp.p_packed.fill_rate:.2f}",
                    res, nnz=n_pairs, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            r.extras = {"pack_seconds": pack_s, "c_nnz": pp.c_nnz}
            rows.append(r)
        del pp
    # the dense race at XL: n² fp32 operands of 1 GB each fit; the steps
    # are long, so three timed calls suffice
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        ad = _t(sa.toarray(), dev)
        bd = _t(sb.toarray(), dev)
        if dt is not None:
            ad, bd = ad.to(dt), bd.to(dt)
        fd = lambda a, b: a @ b  # noqa: E731
        res = bench_fn_slope(fd, ad, bd, iters=3, warmup=1)
        checked = None
        if check:
            # compare on C's sparse pattern (the dense zeros are trivial)
            got = _np(fd(ad, bd)).astype(np.float64)
            checked = relative_check(got[want.nonzero()], want.data)
        r = Row(f"spgemm_xl/dense-race-{tag}", f"n={n},2n^3 cuBLAS", res,
                nnz=n_pairs, checked=checked)
        r.sol_frac = None
        rows.append(r)
        del ad, bd
    return rows


@registry.register("spgemm_crossover")
def bench_spgemm_crossover(check=True, points=((4096, 0.004), (8192, 0.002)),
                           **kw):
    """Density-crossover study: the best sparse numeric path against the
    dense product across (n, d) points between the spgemm (n=2048) and
    spgemm_xl (n=16384) anchors.  ``spgemm(method='auto')``'s constants
    (``ops/spgemm.py``: ``_DENSE_FLOPS_PER_S``, ``_PACKED_PAIRS_PER_S``)
    come from these rows and the spgemm group's."""
    dev = _device(kw)
    rows = []
    fp = lambda q, bd: spgemm_apply_packed(q, bd).data  # noqa: E731
    fpc = lambda q, bd: spgemm_apply_packed_csc(q, bd).data  # noqa: E731
    fdn = lambda a, b: spgemm_densify(a, b).data  # noqa: E731
    for n, density in points:
        rng = np.random.default_rng(11)
        sa = sps.random(n, n, density=density, random_state=11,
                        format="csr", dtype=np.float32)
        sb = sps.random(n, n, density=density, random_state=12,
                        format="csr", dtype=np.float32)
        sa.data = rng.uniform(-1000, 1000, sa.nnz).astype(np.float32)
        sb.data = rng.uniform(-1000, 1000, sb.nnz).astype(np.float32)
        A, B = CSR.from_scipy(sa, device=dev), CSR.from_scipy(sb, device=dev)
        want = None
        if check:
            want = (sa.astype(np.float64) @ sb.astype(np.float64)).tocsr()
            want.sort_indices()
        t0 = time.time()
        pp = spgemm_plan_packed(A, B, layout="superblock")
        pack_s = time.time() - t0
        res = bench_fn_slope(fp, pp, B.data)
        checked = None
        if check:
            got = _np(fp(pp, B.data))
            checked = relative_check(got[: pp.c_nnz], want.data)
        n_pairs = pp.p_packed.nnz
        sol = speed_of_light_nnz_s(
            n_pairs, n_pairs * (2 * 4 + 3 * 4) + pp.c_nnz * 4)
        r = Row("spgemm_crossover/packed",
                f"n={n},d={density},pairs={n_pairs}", res, nnz=n_pairs,
                checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"pack_seconds": pack_s}
        rows.append(r)
        # CSC-native output: no c_nnz output permutation
        res = bench_fn_slope(fpc, pp, B.data)
        checked = None
        if check:
            wantT = want.T.tocsr()
            wantT.sort_indices()
            got = _np(fpc(pp, B.data))
            checked = relative_check(got[: pp.c_nnz], wantT.data)
        r = Row("spgemm_crossover/packed-csc",
                f"n={n},d={density},pairs={n_pairs}", res, nnz=n_pairs,
                checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"pack_seconds": pack_s}
        rows.append(r)
        res = bench_fn_slope(fdn, A, B)
        checked = None
        if check:
            got = _np(fdn(A, B))
            checked = relative_check(got[want.nonzero()], want.data)
        r = Row("spgemm_crossover/densify-mxu",
                f"n={n},d={density},pairs={n_pairs}", res, nnz=n_pairs,
                checked=checked)
        r.sol_frac = None
        rows.append(r)
    return rows


@registry.register("trisolve")
def bench_trisolve(check=True, n=4096, nnz_row=8, **kw):
    """Triangular solves on a scattered factor and on the Poisson ILU(0)
    factor, through every plan family (rows/s through the levels)."""
    dev = _device(kw)
    rng = np.random.default_rng(6)
    # lower-triangular with short dependency chains (random DAG depth)
    d = sps.random(n, n, density=nnz_row / n, random_state=6,
                   format="csr", dtype=np.float32)
    L = sps.tril(d, k=-1).tocsr() + sps.eye(n, format="csr", dtype=np.float32) * 4.0
    A = CSR.from_scipy(L.tocsr(), device=dev)
    plan = trisolve_plan(A, lower=True)
    b = _t(gen_matrix_random(rng, n, 1)[:, 0], dev)
    f = trisolve_apply
    res = bench_fn_slope(f, plan, b)
    want = None
    checked = None
    if check:
        want = spla.spsolve_triangular(L.tocsr().astype(np.float64),
                                       _np(b), lower=True)
        checked = relative_check(_np(f(plan, b)), want)
    nnz = int(L.nnz)
    sol = speed_of_light_nnz_s(nnz, spmv_csr_bytes(nnz, n, n))
    r = Row("trisolve/level-sched",
            f"n={n},nnz={nnz},levels={plan.rows.shape[0]}",
            res, nnz=nnz, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    rows = [r]

    # fixed-point formulation: n_levels-1 row-lane SpMVs
    fplan = trisolve_fixpoint_plan(A, lower=True)
    ff = trisolve_fixpoint_apply
    res2 = bench_fn_slope(ff, fplan, b)
    checked2 = relative_check(_np(ff(fplan, b)), want) if check else None
    r2 = Row("trisolve/fixpoint",
             f"n={n},nnz={nnz},iters={fplan.n_iters},"
             f"fill={fplan.e_packed.fill_rate:.2f}",
             res2, nnz=nnz, checked=checked2)
    r2.sol_frac = r2.nnz_per_s / sol
    rows.append(r2)

    # level-packed: one row-lane call a level, total slab work = one SpMV
    lplan = trisolve_level_plan(A, lower=True)
    lf = trisolve_level_apply
    res3 = bench_fn_slope(lf, lplan, b)
    checked3 = relative_check(_np(lf(lplan, b)), want) if check else None
    r3 = Row("trisolve/level-packed",
             f"n={n},nnz={nnz},levels={lplan.s_idx.shape[0] + 1},"
             f"g={lplan.group}",
             res3, nnz=nnz, checked=checked3)
    r3.sol_frac = r3.nnz_per_s / sol
    rows.append(r3)

    # fused: all levels in one kernel (row 18)
    fplan = trisolve_fused_plan(A, lower=True)
    ff = trisolve_fused_apply
    res4 = bench_fn_slope(ff, fplan, b)
    checked4 = relative_check(_np(ff(fplan, b)), want) if check else None
    r4 = Row("trisolve/fused",
             f"n={n},nnz={nnz},levels={fplan.n_levels},"
             f"groups={fplan.s_idx.shape[0]},g={fplan.group}",
             res4, nnz=nnz, checked=checked4)
    r4.sol_frac = r4.nnz_per_s / sol
    rows.append(r4)

    # waves: host-inverted diagonal blocks; the random pattern has
    # unbounded tile reach, so this exercises binv mode (row 20); the
    # banded regime (chain mode) follows
    t0 = time.time()
    wplan = trisolve_waves_plan(A, lower=True)
    pack_s = time.time() - t0
    wf = trisolve_waves_apply
    res5 = bench_fn_slope(wf, wplan, b)
    checked5 = relative_check(_np(wf(wplan, b)), want) if check else None
    r5 = Row("trisolve/waves",
             f"n={n},nnz={nnz},mode={wplan.mode},m={wplan.m},"
             f"waves={wplan.n_waves}",
             res5, nnz=nnz, checked=checked5)
    r5.sol_frac = r5.nnz_per_s / sol
    r5.extras = {"pack_seconds": pack_s}
    rows.append(r5)

    # the banded regime (Poisson ILU(0) L factor — every preconditioned
    # solver's inner loop): tile reach 1 → the chain path (row 19)
    side = int(np.sqrt(n))
    Iq = sps.eye(side)
    Tq = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (side, side))
    Apo = (sps.kron(Iq, Tq) + sps.kron(
        sps.diags([-1.0, -1.0], [-1, 1], (side, side)), Iq)).tocsr()
    Lf, _ = ilu0(CSR.from_scipy(Apo.astype(np.float32), device=dev))
    nnz_l = Lf.nnz
    bl = _t(gen_matrix_random(rng, side * side, 1)[:, 0], dev)
    Ld = Lf.to_scipy().astype(np.float64).tolil()
    Ld.setdiag(1.0)
    want_l = None
    if check:
        want_l = spla.spsolve_triangular(Ld.tocsr(), _np(bl), lower=True)
    sol_l = speed_of_light_nnz_s(nnz_l, spmv_csr_bytes(nnz_l, n, n))
    waves_ilu_min_ms = None
    for label, mk, ap in (
            ("waves-ilu", lambda: trisolve_waves_plan(
                Lf, lower=True, unit_diagonal=True), wf),
            ("fused-ilu", lambda: trisolve_fused_plan(
                Lf, lower=True, unit_diagonal=True), trisolve_fused_apply)):
        t0 = time.time()
        plan = mk()
        pack_s = time.time() - t0
        res6 = bench_fn_slope(ap, plan, bl)
        checked6 = (relative_check(_np(ap(plan, bl)), want_l)
                    if check else None)
        mode = (f"mode={plan.mode},K={plan.K}" if hasattr(plan, "mode")
                else f"levels={plan.n_levels}")
        r6 = Row(f"trisolve/{label}", f"n={n},nnz={nnz_l},{mode}",
                 res6, nnz=nnz_l, checked=checked6)
        r6.sol_frac = r6.nnz_per_s / sol_l
        r6.extras = {"pack_seconds": pack_s}
        rows.append(r6)
        if label == "waves-ilu":
            waves_ilu_min_ms = res6.min_ms

    # multi-RHS chain solve: 8 RHS a pass (row 21), the block-solver /
    # preconditioned-panel regime
    k_mm = 8
    wplan_l = trisolve_waves_plan(Lf, lower=True, unit_diagonal=True)
    Bl = _t(gen_matrix_random(rng, side * side, k_mm), dev)
    fmm = trisolve_waves_apply_mm
    res7 = bench_fn_slope(fmm, wplan_l, Bl)
    checked7 = None
    if check:
        want_mm = spla.spsolve_triangular(Ld.tocsr(), _np(Bl), lower=True)
        checked7 = relative_check(_np(fmm(wplan_l, Bl)), want_mm)
    r7 = Row(f"trisolve/waves-ilu-mm{k_mm}",
             f"n={n},nnz={nnz_l},k={k_mm},mode={wplan_l.mode}",
             res7, nnz=nnz_l * k_mm, checked=checked7)
    # SoL: plan bytes stream once for all k RHS, plus k in/out vectors
    r7.sol_frac = r7.nnz_per_s / speed_of_light_nnz_s(
        nnz_l * k_mm, spmv_csr_bytes(nnz_l, n, n) + 2 * k_mm * n * 4)
    r7.extras = {"per_rhs_ms": res7.min_ms / k_mm,
                 "single_rhs_ms": waves_ilu_min_ms,
                 "vs_single_per_rhs": waves_ilu_min_ms
                 / max(res7.min_ms / k_mm, 1e-9)}
    rows.append(r7)
    return rows


def _bench_cg_to_tol(check, n, iters, tol, maxiter, group_name, dev,
                     eps=1.0, variant_names=None):
    """Preconditioned CG on the 2-D Poisson system: the time of a fixed
    ``iters``-iteration solve (tol = 0) ÷ iters × the iterations to
    ‖r‖/‖b‖ ≤ tol = the time to tolerance (the number that decides
    whether preconditioning wins end to end).

    ``eps``: anisotropy ratio of the 5-point operator (−u_xx − eps·u_yy);
    stiff anisotropy multiplies plain CG's iteration count while IC(0)'s
    stays flat."""
    n, Apo = poisson2d(n, eps)
    A = CSR.from_scipy(Apo.astype(np.float32).tocsr(), device=dev)
    rng = np.random.default_rng(8)
    b = _t(rng.standard_normal(n).astype(np.float32), dev)
    b_norm = float(np.linalg.norm(_np(b)))
    Ap = prepare_spmv(A)

    def _mk(builder, apply_):
        t0 = time.time()
        plans = builder()
        return (lambda r: apply_(plans, r)), time.time() - t0

    builders = {
        # truncated Neumann on the row-lane SpMV layout (approximate)
        "ilu0-fix6": (lambda: ilu0_fixpoint_plans(A, n_iters=6), ilu_apply),
        # exact solves on host-inverted wave plans
        "ilu0-waves": (lambda: ilu0_waves_plans(A), ilu_apply),
        "ic0-waves": (lambda: ic0_waves_plans(A), ic_apply),
        # bf16 inverse-block planes: halves the dominant plan stream
        "ic0-waves-bf16": (lambda: ic0_waves_plans(A, dtype=torch.bfloat16),
                           ic_apply),
        # the fused level engine, the race for the waves
        "ic0-fused": (lambda: ic0_fused_plans(A), ic_apply),
    }
    if variant_names is None:
        variant_names = ("ilu0-fix6", "ilu0-waves", "ic0-waves",
                         "ic0-fused")
    variants = [("plain", None, 0.0)]
    for name in variant_names:
        bld, apply_ = builders[name]
        M, s = _mk(bld, apply_)
        variants.append((name, M, s))

    rows = []
    plain_iters = None
    plain_ms_to_tol = None
    for label, precond, pack_s in variants:
        # the time of an iteration: a fixed-work solve (tol=0 → exactly
        # `iters`, no residual read)
        f = lambda bb, M=precond: cg(Ap, bb, maxiter=iters, M=M,  # noqa: E731
                                     tol=0.0).x
        res = bench_fn_slope(f, b)
        per_iter_ms = res.min_ms / iters
        # iterations to tolerance (recurrence residual)
        sol_res = cg(Ap, b, maxiter=maxiter, M=precond, tol=tol)
        iters_tol = int(sol_res.iters)
        reached = bool(float(sol_res.residual) <= tol * b_norm * 1.001
                       and iters_tol < maxiter)
        ms_to_tol = per_iter_ms * iters_tol
        checked = None
        true_res = None
        if check:
            x = _np(sol_res.x).astype(np.float64)
            true_res = float(np.linalg.norm(Apo @ x - _np(b)))
            # the tol run must reach tol (recurrence) and the TRUE residual
            # must confirm within a 10x fp32 margin; preconditioned runs
            # must converge in ≤ 0.6x plain's iterations
            checked = bool(reached and true_res <= 10 * tol * b_norm)
            if label != "plain" and plain_iters is not None:
                checked = checked and iters_tol <= 0.6 * plain_iters
        if label == "plain":
            plain_iters = iters_tol
            plain_ms_to_tol = ms_to_tol
        nnz = A.nnz * iters
        r = Row(f"{group_name}/{label}",
                f"n={n},iters={iters},tol={tol:g}", res, nnz=nnz,
                checked=checked)
        sol = speed_of_light_nnz_s(nnz, spmv_csr_bytes(nnz, n, n))
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"per_iter_ms": per_iter_ms, "iters_to_tol": iters_tol,
                    "ms_to_tol": ms_to_tol, "reached_tol": reached,
                    "pack_seconds": pack_s}
        if label != "plain" and plain_ms_to_tol is not None:
            # how many solves of this system pay back the setup
            saved_s = (plain_ms_to_tol - ms_to_tol) / 1e3
            r.extras["solves_to_amortize"] = (
                round(pack_s / saved_s, 1) if saved_s > 0 else float("inf"))
        if true_res is not None:
            r.extras["true_rel_residual"] = true_res / b_norm
        rows.append(r)
    return rows


@registry.register("ilu_cg")
def bench_ilu_cg(check=True, n=4096, iters=25, tol=1e-6, maxiter=3000,
                 **kw):
    """End-to-end preconditioned solve at n=4096: the time of an
    iteration + the time to ‖r‖/‖b‖ ≤ 1e-6 for plain/fixpoint/wave/fused
    CG."""
    return _bench_cg_to_tol(check, n, iters, tol, maxiter, "ilu_cg",
                            _device(kw))


@registry.register("ilu_cg_xl")
def bench_ilu_cg_xl(check=True, n=65536, iters=25, tol=1e-5,
                    maxiter=6000, **kw):
    """The 65k Poisson point (side 256 → ILU tile reach 2: the wave solves
    ride the chain-K path).  tol=1e-5: at this size the fp32 recurrence
    reaches 1e-6, but the true residual cannot certify it, so the bench
    pins the tightest tolerance fp32 can certify."""
    return _bench_cg_to_tol(check, n, iters, tol, maxiter, "ilu_cg_xl",
                            _device(kw))


@registry.register("spmm_xl")
def bench_spmm_xl(check=True, n=32768, k=32, **kw):
    """XL multi-RHS regime map: the dual-gather walk against the bf16
    pre-dense product (n²·2 bytes of A an apply) at two densities, and
    the low-degree point (~2 entries a row): octet SpMM, sliced-ELL and
    the walk."""
    dev = _device(kw)
    rng = np.random.default_rng(6)
    rows = []
    fw = lambda x, q: spmm_dualgather(q, x)  # noqa: E731
    for nnz_row in (64, 507):
        d = nnz_row / n
        sp = sps.random(n, n, density=d, random_state=5, format="csr",
                        dtype=np.float32)
        sp.data = rng.uniform(-1, 1, sp.nnz).astype(np.float32)
        A = CSR.from_scipy(sp, device=dev)
        X = _t(rng.uniform(-1, 1, (n, k)).astype(np.float32), dev)
        want = None
        if check:
            want = sp.astype(np.float64) @ _np(X).astype(np.float64)
        pk = pack_dualgather(A, k_tiles=1)
        res = bench_fn_slope(fw, X, pk)
        checked = relative_check(_np(fw(X, pk)), want) if check else None
        r = Row("spmm_xl/walk-kt1",
                f"n={n},k={k},nnz/row={nnz_row},fill={pk.fill_rate:.2f}",
                res, nnz=sp.nnz, checked=checked)
        bytes_moved = (sp.nnz * (1 + 1 + 4) / max(pk.fill_rate, 1e-6)
                       + n * k * 8)
        r.sol_frac = r.nnz_per_s / speed_of_light_nnz_s(sp.nnz, bytes_moved)
        rows.append(r)
        del pk
        # pre-dense bf16 race: the streaming-bound alternative
        ad = _t(sp.toarray(), dev).to(torch.bfloat16)
        fd = lambda a, x: (a @ x.to(torch.bfloat16)).float()  # noqa: E731
        res = bench_fn_slope(fd, ad, X)
        checked = None
        if check:
            checked = quantized_check(_np(fd(ad, X)), want)  # bf16 operands
        r = Row("spmm_xl/pre-dense-bf16", f"n={n},k={k},nnz/row={nnz_row}",
                res, nnz=sp.nnz, checked=checked)
        r.sol_frac = None
        rows.append(r)
        del ad
    # low-degree XL point: ~2 entries a row
    nnz_row = 2
    g2 = np.random.default_rng(12)
    rows_ = np.repeat(np.arange(n), nnz_row)
    cols_ = g2.integers(0, n, rows_.size)
    data_ = g2.uniform(-1, 1, rows_.size).astype(np.float32)
    sp = sps.coo_matrix((data_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A = CSR.from_scipy(sp, device=dev)
    X = _t(g2.uniform(-1, 1, (n, k)).astype(np.float32), dev)
    want = (sp.astype(np.float64) @ _np(X).astype(np.float64) if check
            else None)
    pk_o = pack_octet(A)
    fo = lambda x, q: spmm_octet(q, x)  # noqa: E731
    res = bench_fn_slope(fo, X, pk_o)
    checked = relative_check(_np(fo(X, pk_o)), want) if check else None
    r = Row("spmm_xl/octet-mm",
            f"n={n},k={k},nnz/row={nnz_row},fill={pk_o.fill_rate:.2f}",
            res, nnz=sp.nnz, checked=checked)
    bytes_moved = (sp.nnz * (3 + 4) / max(pk_o.fill_rate, 1e-6)
                   + n * k * 8)
    r.sol_frac = r.nnz_per_s / speed_of_light_nnz_s(sp.nnz, bytes_moved)
    rows.append(r)
    pk_s = pack_sliced_ell(A)
    fse = spmm_sliced_ell
    res = bench_fn_slope(fse, pk_s, X)
    checked = relative_check(_np(fse(pk_s, X)), want) if check else None
    r = Row("spmm_xl/sliced-ell",
            f"n={n},k={k},nnz/row={nnz_row},segs={len(pk_s.vals)},"
            f"fill={pk_s.fill_rate:.2f}",
            res, nnz=sp.nnz, checked=checked)
    # bytes of the row-gather algorithm: each entry drags a k-float X row
    # (÷ fill for segment padding) + X read + Y write
    bytes_moved = sp.nnz * k * 4 / max(pk_s.fill_rate, 1e-6) + n * k * 8
    r.sol_frac = r.nnz_per_s / speed_of_light_nnz_s(sp.nnz, bytes_moved)
    rows.append(r)
    pk_w = pack_dualgather(A, k_tiles=1)
    res = bench_fn_slope(fw, X, pk_w)
    checked = relative_check(_np(fw(X, pk_w)), want) if check else None
    r = Row("spmm_xl/walk-kt1",
            f"n={n},k={k},nnz/row={nnz_row},fill={pk_w.fill_rate:.2f}",
            res, nnz=sp.nnz, checked=checked)
    bytes_moved = (sp.nnz * (1 + 1 + 4) / max(pk_w.fill_rate, 1e-6)
                   + n * k * 8)
    r.sol_frac = r.nnz_per_s / speed_of_light_nnz_s(sp.nnz, bytes_moved)
    rows.append(r)
    return rows


@registry.register("block_cg_xl")
def bench_block_cg_xl(check=True, n=65536, k=8, iters=25, tol=1e-5,
                      maxiter=4000, **kw):
    """Multi-RHS XL regime: does preconditioning pay when k systems solve
    at once?  Plain block CG turns the SpMV into an SpMM (one matrix
    stream serves k columns), and ic0-waves turns the wave solve into
    k-RHS passes (``trisolve_waves_apply_mm``), so the time-to-tol race
    decides.  The seq-plain-x{k} row is the do-nothing baseline: k
    independent single-RHS plain CG solves."""
    dev = _device(kw)
    n, Apo = poisson2d(n)
    A = CSR.from_scipy(Apo.astype(np.float32).tocsr(), device=dev)
    rng = np.random.default_rng(9)
    B = _t(rng.standard_normal((n, k)).astype(np.float32), dev)
    bnorm = np.linalg.norm(_np(B), axis=0)
    # matmat: the dual-gather multi-RHS walk (Poisson's window locality
    # gives it near-perfect fill)
    S = pack_dualgather(A, k_tiles=1)

    rows = []
    # seq-plain baseline: single-RHS plain CG on the auto pack, scaled ×k
    Ap = prepare_spmv(A)
    b0 = B[:, 0].contiguous()
    f1 = lambda bb, q: cg(q, bb, maxiter=iters, tol=0.0).x  # noqa: E731
    res1 = bench_fn_slope(f1, b0, Ap)
    sol1 = cg(Ap, b0, maxiter=maxiter, tol=tol)
    it1 = int(sol1.iters)
    per1 = res1.min_ms / iters
    r = Row(f"block_cg_xl/seq-plain-x{k}", f"n={n},k={k},tol={tol:g}",
            BenchResult(mean_ms=per1 * iters * k, min_ms=per1 * iters * k,
                        compile_ms=0.0, iters=res1.iters, extras={}),
            nnz=A.nnz * iters * k,
            checked=bool(float(sol1.residual) <= tol * bnorm[0] * 1.001)
            if check else None)
    r.sol_frac = None
    r.extras = {"per_iter_ms": per1 * k, "iters_to_tol": it1,
                "ms_to_tol": per1 * it1 * k}
    rows.append(r)

    t0 = time.time()
    plans = ic0_waves_plans(A)
    pack_s = time.time() - t0
    for label, use_M, ps in (("block-plain", False, 0.0),
                             ("block-ic0-waves", True, pack_s)):

        def run(bb, maxit, tl, use_M=use_M):
            Mf = (lambda R: ic_apply(plans, R)) if use_M else None
            return block_cg(lambda V: spmm_dualgather(S, V), bb,
                            maxiter=maxit, tol=tl, M=Mf)

        res = bench_fn_slope(lambda bb: run(bb, iters, 0.0).x, B)
        per_iter_ms = res.min_ms / iters
        sol = run(B, maxiter, tol)
        iters_tol = int(sol.iters)
        reached = bool(
            np.all(_np(sol.residuals) <= tol * bnorm * 1.001)
            and iters_tol < maxiter)
        checked = None
        if check:
            X = _np(sol.x).astype(np.float64)
            true_res = np.linalg.norm(Apo @ X - _np(B), axis=0)
            checked = bool(reached and np.all(true_res <= 10 * tol * bnorm))
        r = Row(f"block_cg_xl/{label}", f"n={n},k={k},tol={tol:g}", res,
                nnz=A.nnz * iters * k, checked=checked)
        r.sol_frac = None
        r.extras = {"per_iter_ms": per_iter_ms, "iters_to_tol": iters_tol,
                    "ms_to_tol": per_iter_ms * iters_tol,
                    "reached_tol": reached, "pack_seconds": ps}
        rows.append(r)
    return rows


@registry.register("ilu_cg_aniso")
def bench_ilu_cg_aniso(check=True, n=65536, iters=25, tol=1e-5,
                       maxiter=12000, eps=1000.0, **kw):
    """The preconditioner win case: stiff anisotropic Poisson
    (−u_xx − 1000·u_yy).  Plain CG's iteration count blows up while
    IC(0)'s stays flat; isotropic Poisson (ilu_cg, ilu_cg_xl) is where
    plain CG wins."""
    return _bench_cg_to_tol(check, n, iters, tol, maxiter, "ilu_cg_aniso",
                            _device(kw), eps=eps,
                            variant_names=("ic0-waves", "ic0-waves-bf16"))


@registry.register("codebook_gemm")
def bench_codebook_gemm(check=True, density=0.25, **kw):
    """The reference's own benchmark: sparse AddMatMat at its default shape
    (117×1023×2047, 25 % dense, 255 values), at the CLI-provided
    ref_m/n/k.  Variants: CodebookCSR auto (density-adaptive), forced
    segment-sum, dequantize + dense product, the fused codebook kernel
    (table row 1, under the JAX row name ``fused-pallas``), bf16 and the
    quantized int8/int16 products; then the dense races."""
    dev = _device(kw)
    m = kw.get("ref_m", REF_M)
    n = kw.get("ref_n", REF_N)
    k = kw.get("ref_k", REF_K)

    rng = np.random.default_rng(4)
    a = _t(gen_matrix_random(rng, m, k), dev)
    c = _t(gen_matrix_random(rng, m, n), dev)
    idx_mtx, table = gen_sparse_index_matrix(rng, k, n, density=density,
                                             table_size=255)
    b_csr = CodebookCSR.from_index_matrix(idx_mtx, table, trans=True,
                                          device=dev)
    b_dns = CodebookDense.from_index_matrix(idx_mtx, table, trans=True,
                                            device=dev)
    b_dense_np = _np(b_csr.todense()).T.astype(np.float64)
    oracle = _np(c).astype(np.float64) + _np(a).astype(np.float64) @ b_dense_np

    # the bf16 variant is a quantized path: its error is ~0.4 % of the
    # OUTPUT SCALE (operand rounding), which a per-element relative policy
    # cannot express at cancellation points — judge it against the fp64
    # oracle with a scale-floored denominator instead
    def _bf16_check(got):
        scale = np.abs(oracle).max()
        rel = np.abs(got - oracle) / (np.abs(oracle) + 0.02 * scale)
        return bool(np.median(rel) < 0.02 and np.quantile(rel, 0.99) < 0.1)

    def _int8_check(got):
        # per-tensor symmetric int8 on both operands: ~0.8 % per-operand
        # grid error, judged on the same scale-floored basis
        scale = np.abs(oracle).max()
        rel = np.abs(got - oracle) / (np.abs(oracle) + 0.02 * scale)
        return bool(np.median(rel) < 0.04 and np.quantile(rel, 0.99) < 0.2)

    rows = []
    # the weights are encode-once constants: each variant closes over its
    # container, so conversions and packs are cached on it
    all_variants = {
        "csr-auto": lambda aa, cc: add_mat_mat(aa, b_csr, cc, 1.0, 1.0),
        "csr-segsum":
            lambda aa, cc: cc + spmm(b_csr, aa.T, method="sparse").T,
        "dense-dequant": lambda aa, cc: cc + spmm_densify(b_dns, aa.T).T,
        "fused-pallas": lambda aa, cc: cc + codebook_matmul(aa, b_dns),
        # bf16 X: checked against the both-operands-bf16 policy
        "fused-pallas-bf16": lambda aa, cc: cc + codebook_matmul(
            aa.to(torch.bfloat16), b_dns).float(),
        # bf16 dequant: the table cast to bf16 before the lookup halves the
        # materialized B
        "dense-dequant-bf16": lambda aa, cc: cc + (
            aa.to(torch.bfloat16)
            @ b_dns.val_table.to(torch.bfloat16)[b_dns.idx.long()].T
        ).float(),
    }

    def _int8_variant():
        # int8 activations × int8 codebook on the integer path (the
        # fork-only cblas_wgemm_plus analogue); quantized lazily so
        # unrelated runs do not pay the encode
        b_q = quantize_codebook(b_dns)
        return lambda aa, cc: add_mat_mat_int8(aa, b_q, cc, 1.0, 1.0)

    all_variants["int8-gemm"] = _int8_variant

    def _int16_variant():
        # int16 activations, the exact cblas_wgemm_plus signature: a hi/lo
        # byte split over two int8 products; the residual error is the
        # int8 table's, so it is judged at the bf16-grade tolerance
        b_q = quantize_codebook(b_dns)
        return lambda aa, cc: add_mat_mat_int16(aa, b_q, cc, 1.0, 1.0)

    all_variants["int16-gemm"] = _int16_variant
    names = kw.get("variants") or ("csr-auto", "dense-dequant",
                                   "dense-dequant-bf16", "fused-pallas",
                                   "fused-pallas-bf16", "int8-gemm",
                                   "int16-gemm")
    for vname in names:
        f = all_variants[vname]
        name = f"codebook_gemm/{vname}"
        try:
            if vname in ("int8-gemm", "int16-gemm"):
                f = f()  # lazy factory
            res = bench_fn_slope(f, a, c)
            if not check:
                checked = None
            elif vname.endswith("bf16"):
                checked = _bf16_check(_np(f(a, c)))
            elif vname == "int8-gemm":
                checked = _int8_check(_np(f(a, c)))
            elif vname == "int16-gemm":
                checked = _bf16_check(_np(f(a, c)))
            else:
                checked = relative_check(_np(f(a, c)), oracle)
        except Exception as e:  # a failing variant must not take down the
            # whole group; the registry records it, and a caller can
            # refuse the run
            print(f"[bench] variant {name} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            registry.failed.append(name)
            continue
        r = Row(name, f"m={m},n={n},k={k},d={density}", res, nnz=b_csr.nnz,
                checked=checked)
        r.extras = {"vs_baseline": REF_BASELINE_MS / res.min_ms}
        rows.append(r)
    if not rows:
        raise RuntimeError("all codebook_gemm variants failed")
    # the race the reference always runs: a plain dense GEMM of the same
    # problem on the same card, fp32 (full precision) and bf16
    b_dense32 = _t(b_dense_np.astype(np.float32), dev)
    for tag, fd in (
            ("fp32", lambda aa, bb, cc: cc + aa @ bb),
            ("bf16", lambda aa, bb, cc: cc + _bf16_mm_f32(
                aa.to(torch.bfloat16), bb.to(torch.bfloat16)))):
        res = bench_fn_slope(fd, a, b_dense32, c)
        r = Row(f"codebook_gemm/dense-race-{tag}",
                f"m={m},n={n},k={k} dense cuBLAS", res, nnz=b_csr.nnz)
        r.extras = {"vs_baseline": REF_BASELINE_MS / res.min_ms}
        rows.append(r)
    # the reference harness's third lane: PREPACKED dense GEMM (operand
    # layout paid once at encode time): operands cast to bf16 once, the
    # timed call one bf16 product with an fp32 result
    a_pre = a.to(torch.bfloat16)
    b_pre = b_dense32.to(torch.bfloat16)
    fp = lambda aa, bb, cc: cc + _bf16_mm_f32(aa, bb)  # noqa: E731
    res = bench_fn_slope(fp, a_pre, b_pre, c)
    checked = _bf16_check(_np(fp(a_pre, b_pre, c))) if check else None
    r = Row("codebook_gemm/dense-race-pre",
            f"m={m},n={n},k={k} prepacked bf16 cuBLAS", res, nnz=b_csr.nnz,
            checked=checked)
    r.extras = {"vs_baseline": REF_BASELINE_MS / res.min_ms}
    rows.append(r)
    return rows
