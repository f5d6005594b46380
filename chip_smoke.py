#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``sparsematrix_tpu_torch``) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each printing
JSON lines; a failure in any of them exits non-zero and prints no result:

1. device — the card's name and ``nvidia-smi`` name and power limit.
2. build — compiles every kernel from ``sparsematrix_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together, and the host slot assigner
   (``native/assign.cc``) with ``g++``.
3. check — each kernel against its plain PyTorch version on the card, and
   both against an fp64 host oracle, at the main path's shapes and the
   bench's: codebook 117×1023×2047 (fp32 and bf16 X), (29,200,300),
   (8,128,256); Blocked-ELL at n=2048, d=0.05, (8,128) and (128,128)
   blocks, k ∈ {128, 512}.  Then the dual-gather packs, each with its
   host seconds (``pack`` lines), and the four dual-gather kernels on
   them: the 16.6 M-nnz XL CSR (n = 32768, the JAX bench's
   ``csr_spmv_xl`` point) packed as the auto routes pack it (superblocks
   of 8 tiles with two windows; k_tiles = 1 for ``spmm``) and as the
   bench's two packs (fp32 group 128 on 8 tiles with two windows, bf16
   group 512 on 32 tiles); n = 4096 at 128 entries a
   row (``csr_spmv/auto``); n = 1024 at 64 a row (k_tiles = 1); ``spmm``
   at k = 32 on both XL packs.
4. main path — ``entry()``, then ``add_mat_mat`` at 117×1023×2047 with a
   CodebookCSR, a CodebookDense and a BlockedELL ``b_t``, and a batch of
   4096 rows through the same weight; then ``spmv`` and ``spmm`` (k = 32)
   on the XL CSR through the auto routes, ``spmm`` on ``prepare_spmv``'s
   pack, and ``spmv`` at n = 4096 and n = 1024.  Every launch counter is
   set to 0 just before each path and read just after, and each kernel
   must have launched.
5. timings — device time of one call, from CUDA events around each of 30
   calls, each queued behind its own spin kernel (so the host's cost of
   issuing a call does not show) with the 50 MB L2 flushed before it,
   median after warm-up: kernel, plain version and one PyTorch yardstick
   call per
   kernel and shape (cuSPARSE through ``torch.sparse_csr_tensor`` for the
   dual-gather kernels), beside the least time the card could take
   (``bound_ms``).  Then ``add_mat_mat``, ``spmv`` and ``spmm`` end to
   end: latency as the caller waits for it (host clock) and device time.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): non-tensor
# fp32 FLOP/s and HBM3 bytes/s
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

ITERS = 30
WARMUP = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, flush: torch.Tensor, spin_rate: float) -> float:
    """Median device time of one call of ``fn``, with the L2 flushed before
    it.  Each timed call starts from a drained queue behind a spin kernel
    twice as long as the host took to issue one call in the warm-up, so
    the events see the device's time and not the host's cost of issuing
    the call (``wall_ms`` measures that).  A call of more launches than
    the stream's queue holds blocks the host until the card frees slots:
    the card is busy then, so the events still see no gap."""
    issue = []
    for _ in range(WARMUP):
        torch.cuda.synchronize()
        flush.zero_()
        t0 = time.perf_counter()
        fn()
        issue.append(time.perf_counter() - t0)
    spin = int((2.0 * max(issue) + 1e-4) * spin_rate)
    times = []
    for _ in range(ITERS):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def wall_ms(fn) -> float:
    """Median latency of one call as its caller sees it: issued, then
    waited for (host clock, warm L2)."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def spin_cycles_per_s() -> float:
    """Clock cycles per second of ``torch.cuda._sleep`` on this card."""
    torch.cuda._sleep(1_000_000)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / (start.elapsed_time(end) * 1e-3)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def xl_matrix(n: int = 32768, nnz_row: int = 512):
    """The JAX bench's 10⁷-nnz point (``bench/suite.py:601-620``): 512
    column draws a row from ``default_rng(9)``, values uniform in ±1000,
    duplicates merged by the COO→CSR conversion; x from
    ``default_rng(9)``.  Returns (scipy CSR, x)."""
    import scipy.sparse as sps

    g = np.random.default_rng(9)
    rows = np.repeat(np.arange(n), nnz_row)
    cols = g.integers(0, n, n * nnz_row)
    data = g.uniform(-1000, 1000, n * nnz_row).astype(np.float32)
    sp = sps.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    return sp, x


def random_matrix(n: int, nnz_row: int, seed: int):
    """Uniform random n×n at ``nnz_row`` expected entries a row, as the
    JAX bench's ``csr_spmv/auto`` row builds it (``suite.py:167-170``).
    Returns (scipy CSR, x)."""
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.utils.testutils import gen_random_dense_sparse

    rng = np.random.default_rng(seed)
    sp = sps.csr_matrix(gen_random_dense_sparse(rng, n, n,
                                                density=nnz_row / n))
    return sp, rng.standard_normal(n).astype(np.float32)


def bf16_rounded(sp):
    """``sp`` with its values rounded to bf16, in fp64: the oracle of a
    bf16-valued pack (the storage contract; accumulation stays fp32)."""
    out = sp.astype(np.float64)
    out.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    return out


def plane_bytes(packed) -> int:
    return sum(t.numel() * t.element_size()
               for t in (packed.idxA, packed.idxB, packed.vals,
                         packed.group_tile, packed.slab_win)
               + ((packed.slab_tloc,) if packed.slab_tloc is not None
                  else ()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from sparsematrix_tpu_torch.entry import entry
    from sparsematrix_tpu_torch.formats import (CSR, CodebookCSR, CodebookDense,
                                                csr_to_blocked_ell)
    from sparsematrix_tpu_torch.kernels import _build
    # the module: the package exports its function under the same name
    dgmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_dualgather")
    from sparsematrix_tpu_torch.kernels.codebook import (
        _codebook_spmm_cuda, codebook_spmm_reference)
    from sparsematrix_tpu_torch.kernels.spmm_blocked_ell import (
        _spmm_blocked_ell_cuda, spmm_blocked_ell_reference)
    from sparsematrix_tpu_torch.kernels.spmm_dualgather import (
        _spmm_dualgather_cuda, spmm_dualgather_reference)
    from sparsematrix_tpu_torch.ops import (add_mat_mat, prepare_spmv, spmm,
                                            spmv)
    from sparsematrix_tpu_torch.utils.testutils import (
        gen_matrix_random, gen_random_dense_sparse, gen_sparse_index_matrix,
        quantized_check, relative_check)

    dev = torch.device("cuda")
    failures = []

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    host = {}

    def build_host():
        t = time.perf_counter()
        try:
            host["fn"] = _build.load_host("assign", "smtpu_assign_dualgather",
                                          dgmod._ASSIGN_ARGTYPES)
        except RuntimeError as e:  # g++ failed: reported below
            host["error"] = str(e)
        host["seconds"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    built = _build.build()
    host_thread.join()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "host_assigner": {"built": host.get("fn") is not None,
                            "seconds": host.get("seconds"),
                            "error": host.get("error")},
          "kernels": {name: {
              "seconds": info["seconds"],
              "ptxas": [ln.strip() for ln in str(info["log"]).splitlines()
                        if "Used" in ln or "spill" in ln]}
              for name, info in built.items()}})
    if host.get("fn") is None:
        print("chip_smoke: FAILED: the host slot assigner did not build: "
              f"{host.get('error', 'no g++')}", file=sys.stderr)
        return 1

    # -- inputs -----------------------------------------------------------
    def codebook_case(m, n, k, seed):
        rng = np.random.default_rng(seed)
        a = gen_matrix_random(rng, m, k)
        idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                             table_size=255)
        return a, CodebookDense.from_index_matrix(idx, table, trans=True,
                                                  device=dev)

    def check(kernel, case, got, plain, oracle, quantized):
        got64 = got.double().cpu().numpy()
        plain64 = plain.double().cpu().numpy()
        scale = float(np.abs(oracle).max())
        err = float(np.abs(got64 - plain64).max())
        # fp32: summation order only (≈ eps·sqrt(k) of the output scale);
        # bf16: both accumulate in fp32 and round once to bf16 (8 bits), so
        # they may differ by one bf16 step of the largest output
        tol = (2.0 ** -7 if quantized else 1e-5) * scale
        policy = quantized_check if quantized else relative_check
        oracle_ok = bool(policy(got64, oracle))
        ok = err <= tol and oracle_ok and bool(np.isfinite(got64).all())
        emit({"phase": "check", "kernel": kernel, "case": case,
              "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
              "tol": tol, "oracle_check": oracle_ok, "ok": ok})
        if not ok:
            failures.append(f"check {kernel} {case}")
        return err

    # -- 3. kernel vs plain -------------------------------------------------
    errs = {}
    cb_cases = [((117, 1023, 2047), torch.float32, True),
                ((117, 1023, 2047), torch.bfloat16, True),
                ((29, 200, 300), torch.float32, False),
                ((8, 128, 256), torch.float32, True)]
    for (m, n, k), dt, kmajor in cb_cases:
        a, b_t = codebook_case(m, n, k, seed=4)
        a_dev = torch.from_numpy(a).to(dev, dt)
        X = a_dev.T if kmajor else a_dev.T.contiguous()
        got = _codebook_spmm_cuda(b_t.idx, b_t.val_table, X)
        plain = codebook_spmm_reference(b_t.idx, b_t.val_table, X)
        torch.cuda.synchronize()
        oracle = (b_t.todense().double().cpu().numpy()
                  @ X.double().cpu().numpy())
        case = (f"{m}x{n}x{k} {str(dt)[6:]} X={'a.T' if kmajor else 'row-major'}")
        errs[("codebook_spmm", case)] = check(
            "codebook_spmm", case, got, plain, oracle, dt == torch.bfloat16)

    rng = np.random.default_rng(2)  # the bench's seed (bench_spmm_bell)
    nb, dens = 2048, 0.05
    dense_u = gen_random_dense_sparse(rng, nb, nb, density=dens)
    bell_u = csr_to_blocked_ell(CSR.fromdense(dense_u, device=dev),
                                block_shape=(8, 128), device=dev)
    mask = rng.random((nb // 128, nb // 128)) < dens
    dense_b = (np.kron(mask, np.ones((128, 128))).astype(np.float32)
               * gen_matrix_random(rng, nb, nb))
    bell_b = csr_to_blocked_ell(CSR.fromdense(dense_b, device=dev),
                                block_shape=(128, 128), device=dev)
    bell_inputs = []
    for tag, dense, bell in (("unstructured-8x128", dense_u, bell_u),
                             ("blockstruct-128x128", dense_b, bell_b)):
        for kx in (128, 512):
            X = torch.from_numpy(gen_matrix_random(rng, nb, kx)).to(dev)
            case = f"{tag} n={nb} k={kx}"
            got = _spmm_blocked_ell_cuda(bell, X)
            plain = spmm_blocked_ell_reference(bell, X)
            torch.cuda.synchronize()
            oracle = dense.astype(np.float64) @ X.double().cpu().numpy()
            errs[("spmm_blocked_ell", case)] = check(
                "spmm_blocked_ell", case, got, plain, oracle, False)
            bell_inputs.append((case, dense, bell, X))

    # the main path's weight: B^T (1023×2047) of the reference workload
    m, n, k = 117, 1023, 2047
    rng = np.random.default_rng(4)
    a_np = gen_matrix_random(rng, m, k)
    c_np = gen_matrix_random(rng, m, n)
    idx_mtx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                             table_size=255)
    a = torch.from_numpy(a_np).to(dev)
    c = torch.from_numpy(c_np).to(dev)
    b_csr = CodebookCSR.from_index_matrix(idx_mtx, table, trans=True, device=dev)
    b_dns = CodebookDense.from_index_matrix(idx_mtx, table, trans=True,
                                            device=dev)
    bt_dense = b_dns.todense().cpu().numpy()  # (n, k) fp32
    b_bell = csr_to_blocked_ell(CSR.fromdense(bt_dense, device=dev),
                                block_shape=(8, 128), device=dev)
    case = f"main-path B^T {n}x{k} (8,128) X=a.T ({k}x{m})"
    got = _spmm_blocked_ell_cuda(b_bell, a.T)
    plain = spmm_blocked_ell_reference(b_bell, a.T)
    torch.cuda.synchronize()
    errs[("spmm_blocked_ell", case)] = check(
        "spmm_blocked_ell", case, got, plain,
        bt_dense.astype(np.float64) @ a_np.T.astype(np.float64), False)
    main_bell_case = case

    # the dual-gather packs of the slice-2 matrices, each with its host
    # seconds
    def timed_pack(label, build):
        t = time.perf_counter()
        packed = build()
        torch.cuda.synchronize()
        emit({"phase": "pack", "pack": label,
              "seconds": time.perf_counter() - t, "group": packed.group,
              "k_tiles": packed.k_tiles, "two_win": packed.two_win,
              "nibble": packed.nibble, "n_slabs": packed.n_slabs,
              "nnz": packed.nnz, "fill": packed.fill_rate,
              "plane_bytes": plane_bytes(packed)})
        return packed

    t = time.perf_counter()
    sp_xl, x_xl_np = xl_matrix()
    X_xl_np = np.random.default_rng(10).standard_normal(
        (sp_xl.shape[1], 32)).astype(np.float32)
    A_xl = CSR.from_scipy(sp_xl, device=dev)
    emit({"phase": "inputs", "matrix": "XL", "shape": list(sp_xl.shape),
          "nnz": int(sp_xl.nnz), "seconds": time.perf_counter() - t})
    x_xl = torch.from_numpy(x_xl_np).to(dev)
    X_xl = torch.from_numpy(X_xl_np).to(dev)
    sp64_xl = sp_xl.astype(np.float64)
    y_xl_want = sp64_xl @ x_xl_np.astype(np.float64)
    Y_xl_want = sp64_xl @ X_xl_np.astype(np.float64)
    P_sb = timed_pack("XL prepare_spmv (auto)", lambda: prepare_spmv(A_xl))
    # the JAX bench's two XL packs (suite.py:684-686)
    P_128 = timed_pack("XL fp32 group=128 k_tiles=8 two_win",
                       lambda: dgmod.pack_dualgather(A_xl, group=128,
                                                     k_tiles=8, two_win=True))
    P_bf = timed_pack("XL bf16 group=512 k_tiles=32",
                      lambda: dgmod.pack_dualgather(A_xl, group=512,
                                                    k_tiles=32,
                                                    dtype=torch.bfloat16))
    P_kt1 = timed_pack("XL spmm walk k_tiles=1",
                       lambda: dgmod.pack_dualgather(A_xl, k_tiles=1))
    sp_4k, x_4k_np = random_matrix(4096, 128, seed=0)
    A_4k = CSR.from_scipy(sp_4k, device=dev)
    P_4k = timed_pack("n=4096 prepare_spmv (auto)", lambda: prepare_spmv(A_4k))
    sp_1k, x_1k_np = random_matrix(1024, 64, seed=1)
    A_1k = CSR.from_scipy(sp_1k, device=dev)
    P_1k = timed_pack("n=1024 prepare_spmv (auto)", lambda: prepare_spmv(A_1k))
    if not (isinstance(P_sb, dgmod.DualGather) and P_sb.k_tiles == 8
            and P_sb.two_win and P_4k.k_tiles == 32
            and P_4k.two_win and P_1k.k_tiles == 1):
        failures.append("auto routes picked another dual-gather layout")

    dg_cases = {}  # kernel name -> [(case, pack, rhs, scipy CSR, values bytes)]
    for kname, case, P, sp, rhs_np in [
            ("spmv_dualgather_sb", "XL fp32 auto", P_sb, sp_xl, x_xl_np),
            ("spmv_dualgather_sb", "XL fp32 two_win kt8 g128", P_128, sp_xl,
             x_xl_np),
            ("spmv_dualgather_sb", "XL bf16 kt32 g512", P_bf, sp_xl, x_xl_np),
            ("spmv_dualgather_sb", "n=4096 128/row auto", P_4k, sp_4k,
             x_4k_np),
            ("spmv_dualgather", "n=1024 64/row auto", P_1k, sp_1k, x_1k_np),
            ("spmv_dualgather", "XL fp32 k_tiles=1", P_kt1, sp_xl, x_xl_np),
            ("spmm_dualgather", "XL k=32 k_tiles=1", P_kt1, sp_xl, X_xl_np),
            ("spmm_dualgather_sb", "XL k=32 auto", P_sb, sp_xl, X_xl_np)]:
        rhs = (x_xl if rhs_np is x_xl_np else X_xl if rhs_np is X_xl_np
               else torch.from_numpy(rhs_np).to(dev))
        if kname.startswith("spmv"):
            got = dgmod._spmv_dualgather_cuda(P, rhs)
            plain = dgmod.spmv_dualgather_reference(P, rhs)
        else:
            got = _spmm_dualgather_cuda(P, rhs)
            plain = spmm_dualgather_reference(P, rhs)
        torch.cuda.synchronize()
        bf16 = P.vals.dtype == torch.bfloat16
        if sp is sp_xl:
            oracle = (y_xl_want if rhs_np is x_xl_np else Y_xl_want)
            if bf16:
                oracle = bf16_rounded(sp_xl) @ rhs_np.astype(np.float64)
        else:
            oracle = sp.astype(np.float64) @ rhs_np.astype(np.float64)
        # fp32 outputs whatever the values' type: the kernel and the plain
        # version differ in summation order only
        errs[(kname, case)] = check(kname, case, got, plain, oracle, False)
        dg_cases.setdefault(kname, []).append(
            (case, P, rhs, sp, 2 if bf16 else 4))
        del got, plain

    # -- 4. main path -------------------------------------------------------
    oracle = (c_np.astype(np.float64)
              + a_np.astype(np.float64) @ bt_dense.T.astype(np.float64))
    a4 = torch.from_numpy(gen_matrix_random(rng, 4096, k)).to(dev)
    c4 = torch.from_numpy(gen_matrix_random(rng, 4096, n)).to(dev)
    fn, args = entry()
    e_a, e_b, e_c = (t.cpu() if torch.is_tensor(t) else t for t in args)
    entry_oracle = (e_c.double().numpy() + e_a.double().numpy()
                    @ e_b.todense().double().cpu().numpy().T)
    paths = [
        ("entry 32x256x512 CodebookDense", lambda: fn(*args), entry_oracle),
        (f"add_mat_mat {m}x{n}x{k} CodebookCSR",
         lambda: add_mat_mat(a, b_csr, c, 1.0, 1.0), oracle),
        (f"add_mat_mat {m}x{n}x{k} CodebookDense",
         lambda: add_mat_mat(a, b_dns, c, 1.0, 1.0), oracle),
        (f"add_mat_mat {m}x{n}x{k} BlockedELL(8,128)",
         lambda: add_mat_mat(a, b_bell, c, 1.0, 1.0), oracle),
        (f"add_mat_mat 4096x{n}x{k} CodebookCSR",
         lambda: add_mat_mat(a4, b_csr, c4, 1.0, 1.0), None),
    ]
    main_launches = {name: 0 for name in _build.KERNELS}
    for name, run, want in paths:
        _build.launch_counts.clear()
        y = run()
        torch.cuda.synchronize()
        counts = {kn: _build.launch_counts[kn] for kn in _build.KERNELS}
        for kn, v in counts.items():
            main_launches[kn] += v
        y64 = y.double().cpu().numpy()
        ok = bool(np.isfinite(y64).all())
        if want is not None:
            ok = ok and y64.shape == want.shape and relative_check(y64, want)
        else:
            want4 = (c4.double() + a4.double()
                     @ torch.from_numpy(bt_dense).to(dev).double().T)
            ok = ok and relative_check(y64, want4.cpu().numpy())
        expect = "spmm_blocked_ell" if "BlockedELL" in name else "codebook_spmm"
        ok = ok and counts[expect] > 0
        emit({"phase": "main_path", "path": name, "shape": list(y.shape),
              "launches": counts, "oracle_check": ok, "ok": ok})
        if not ok:
            failures.append(f"main path {name}")

    # slice 2: CSR SpMV/SpMM through the auto routes; a first call packs
    # (``seconds`` is its host time, the pack included)
    dg_paths = [
        ("spmv XL CSR (auto)", lambda: spmv(A_xl, x_xl), y_xl_want,
         "spmv_dualgather_sb"),
        ("spmm XL CSR k=32 (auto)", lambda: spmm(A_xl, X_xl), Y_xl_want,
         "spmm_dualgather"),
        ("spmm prepare_spmv(XL) k=32", lambda: spmm(P_sb, X_xl), Y_xl_want,
         "spmm_dualgather_sb"),
        ("spmv n=4096 CSR (auto)", lambda: spmv(A_4k, torch.from_numpy(
            x_4k_np).to(dev)), sp_4k.astype(np.float64) @ x_4k_np,
         "spmv_dualgather_sb"),
        ("spmv n=1024 CSR (auto)", lambda: spmv(A_1k, torch.from_numpy(
            x_1k_np).to(dev)), sp_1k.astype(np.float64) @ x_1k_np,
         "spmv_dualgather"),
    ]
    for name, run, want, expect in dg_paths:
        _build.launch_counts.clear()
        t = time.perf_counter()
        y = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = {kn: _build.launch_counts[kn] for kn in _build.KERNELS}
        for kn, v in counts.items():
            main_launches[kn] += v
        y64 = y.double().cpu().numpy()
        ok = (y64.shape == want.shape and bool(np.isfinite(y64).all())
              and relative_check(y64, want) and counts[expect] > 0)
        emit({"phase": "main_path", "path": name, "shape": list(y.shape),
              "seconds": seconds, "launches": counts, "oracle_check": ok,
              "ok": ok})
        if not ok:
            failures.append(f"main path {name}")
        del y
    for kn, v in main_launches.items():
        if v == 0:
            failures.append(f"kernel {kn} was not launched on the main path")

    # -- 5. timings ---------------------------------------------------------
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    spin_rate = spin_cycles_per_s()

    def dev_ms(fn):
        return timed_ms(fn, flush, spin_rate)

    def time_codebook(label, b_t, X):
        # the operations of the nonzero entries; each input read once and
        # the output written once
        nb_x = X.element_size()
        mm = X.shape[1]

        def library():
            # the dequantized plane, then one dense product
            return b_t.val_table[b_t.idx.long()].to(X.dtype) @ X

        flops = 2.0 * b_t.nnz * mm
        nbytes = (b_t.idx.numel() + 4 * b_t.val_table.numel()
                  + nb_x * X.numel() + nb_x * b_t.shape[0] * mm)
        bms, by = bound(flops, nbytes)
        row = {"kernel": "codebook_spmm", "case": label,
               "ms": dev_ms(lambda: _codebook_spmm_cuda(
                   b_t.idx, b_t.val_table, X)),
               "plain_ms": dev_ms(lambda: codebook_spmm_reference(
                   b_t.idx, b_t.val_table, X)),
               "library_ms": dev_ms(library),
               "launches": main_launches["codebook_spmm"],
               "bound_ms": bms, "bound_by": by, "flops": flops,
               "bytes": nbytes}
        emit({"phase": "timing", **row})
        return row

    def time_bell(label, bell, dense, X):
        # the operations this matrix needs (its nonzeros); the bytes of
        # every real block, which must be read to find them
        nvalid = int(bell.valid.sum())
        bm, bk = bell.block_shape
        flops = 2.0 * bell.nnz * X.shape[1]
        nbytes = (4 * nvalid * bm * bk + 4 * bell.block_cols.numel()
                  + 4 * X.numel() + 4 * bell.shape[0] * X.shape[1])
        bms, by = bound(flops, nbytes)
        A = torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(dev)
        row = {"kernel": "spmm_blocked_ell", "case": label,
               "ms": dev_ms(lambda: _spmm_blocked_ell_cuda(bell, X)),
               "plain_ms": dev_ms(lambda: spmm_blocked_ell_reference(bell, X)),
               "library_ms": dev_ms(lambda: A @ X),
               "launches": main_launches["spmm_blocked_ell"],
               "bound_ms": bms, "bound_by": by, "flops": flops,
               "bytes": nbytes}
        emit({"phase": "timing", **row})
        return row

    cb_main = time_codebook(f"{m}x{n}x{k} float32 X=a.T", b_dns, a.T)
    time_codebook(f"{m}x{n}x{k} bfloat16 X=a.T", b_dns,
                  a.to(torch.bfloat16).T)
    time_codebook(f"4096x{n}x{k} float32 X=a.T", b_dns, a4.T)
    bell_main = time_bell(main_bell_case, b_bell, bt_dense, a.T)
    for label, dense, bell, X in bell_inputs:
        time_bell(label, bell, dense, X)

    def cusparse(sp):
        # the same CSR in fp32 as a torch sparse tensor: the yardstick
        return torch.sparse_csr_tensor(
            torch.from_numpy(sp.indptr.astype(np.int64)),
            torch.from_numpy(sp.indices.astype(np.int64)),
            torch.from_numpy(sp.data.astype(np.float32)),
            size=sp.shape).to(dev)

    yardsticks = {}

    def time_dg(kname, case, P, rhs, sp, val_bytes):
        # the JAX package's minimum traffic (utils/roofline.py:59-75): each
        # stored value and its 4-byte column index once, x/X read once,
        # y/Y written once; the operations of the nonzeros
        k = 1 if rhs.dim() == 1 else rhs.shape[1]
        rows, cols = sp.shape
        flops = 2.0 * sp.nnz * k
        nbytes = sp.nnz * (val_bytes + 4) + 4 * cols * k + 4 * rows * k
        bms, by = bound(flops, nbytes)
        if id(sp) not in yardsticks:
            yardsticks[id(sp)] = cusparse(sp)
        S = yardsticks[id(sp)]
        if kname.startswith("spmv"):
            kern, plain = dgmod._spmv_dualgather_cuda, dgmod.spmv_dualgather_reference
        else:
            kern, plain = _spmm_dualgather_cuda, spmm_dualgather_reference
        row = {"kernel": kname, "case": case,
               "ms": dev_ms(lambda: kern(P, rhs)),
               "plain_ms": dev_ms(lambda: plain(P, rhs)),
               "library_ms": dev_ms(lambda: S @ rhs),
               "launches": main_launches[kname],
               "bound_ms": bms, "bound_by": by, "flops": flops,
               "bytes": nbytes, "slab_bytes": plane_bytes(P)}
        emit({"phase": "timing", **row})
        return row

    dg_rows = {}
    for kname, cases in dg_cases.items():
        for case, P, rhs, sp, vb in cases:
            dg_rows[(kname, case)] = time_dg(kname, case, P, rhs, sp, vb)

    # the slice's end-to-end metric: AddMatMat through the public API, as
    # its caller waits for it (wall_ms) and as the card spends it
    # (device_ms), beside one dense fp32 product of the same shape
    bt_dev = torch.from_numpy(bt_dense).to(dev)
    for label, run, dense_run in [
            (f"add_mat_mat {m}x{n}x{k} CodebookCSR",
             lambda: add_mat_mat(a, b_csr, c, 1.0, 1.0),
             lambda: c + a @ bt_dev.T),
            (f"add_mat_mat {m}x{n}x{k} CodebookDense",
             lambda: add_mat_mat(a, b_dns, c, 1.0, 1.0),
             lambda: c + a @ bt_dev.T),
            (f"add_mat_mat {m}x{n}x{k} BlockedELL(8,128)",
             lambda: add_mat_mat(a, b_bell, c, 1.0, 1.0),
             lambda: c + a @ bt_dev.T),
            (f"add_mat_mat 4096x{n}x{k} CodebookCSR",
             lambda: add_mat_mat(a4, b_csr, c4, 1.0, 1.0),
             lambda: c4 + a4 @ bt_dev.T)]:
        emit({"phase": "e2e", "path": label, "wall_ms": wall_ms(run),
              "device_ms": dev_ms(run),
              "dense_fp32_wall_ms": wall_ms(dense_run),
              "dense_fp32_device_ms": dev_ms(dense_run)})

    # spmv/spmm through the public API on the XL CSR (packs cached by the
    # main path), beside cuSPARSE on the same CSR
    S_xl = yardsticks[id(sp_xl)]
    for label, run, lib_run in [
            ("spmv XL CSR (auto)", lambda: spmv(A_xl, x_xl),
             lambda: S_xl @ x_xl),
            ("spmm XL CSR k=32 (auto)", lambda: spmm(A_xl, X_xl),
             lambda: S_xl @ X_xl)]:
        emit({"phase": "e2e", "path": label, "wall_ms": wall_ms(run),
              "device_ms": dev_ms(run),
              "cusparse_wall_ms": wall_ms(lib_run),
              "cusparse_device_ms": dev_ms(lib_run)})

    if failures:
        print("chip_smoke: FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    kernels = []
    for name, src, replaces, row, case in [
            ("codebook_spmm", "sparsematrix_tpu_torch/csrc/codebook_spmm.cu",
             "sparsematrix_tpu/kernels/codebook_pallas.py:141", cb_main,
             f"{m}x{n}x{k} float32 X=a.T"),
            ("spmm_blocked_ell",
             "sparsematrix_tpu_torch/csrc/spmm_blocked_ell.cu",
             "sparsematrix_tpu/kernels/spmm_pallas.py:90", bell_main,
             main_bell_case)]:
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": errs[(name, case)], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": case})
    for name, src, replaces, case in [
            ("spmv_dualgather", "spmv_dualgather.cu",
             "spmv_dualgather.py:876", "n=1024 64/row auto"),
            ("spmv_dualgather_sb", "spmv_dualgather.cu",
             "spmv_dualgather.py:1017", "XL fp32 auto"),
            ("spmm_dualgather", "spmm_dualgather.cu",
             "spmm_dualgather.py:247", "XL k=32 k_tiles=1"),
            ("spmm_dualgather_sb", "spmm_dualgather.cu",
             "spmm_dualgather.py:127", "XL k=32 auto")]:
        row = dg_rows[(name, case)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sparsematrix_tpu_torch/csrc/{src}",
            "replaces": f"sparsematrix_tpu/kernels/{replaces}",
            "launches": main_launches[name],
            "max_abs_err": errs[(name, case)], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": case})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
