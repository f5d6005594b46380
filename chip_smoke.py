#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``sparsematrix_tpu_torch``) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each printing
JSON lines; a failure in any of them exits non-zero and prints no result:

1. device — the card's name and ``nvidia-smi`` name and power limit.
2. build — compiles every kernel from ``sparsematrix_tpu_torch/csrc``.
3. check — each kernel against its plain PyTorch version on the card, and
   both against an fp64 host oracle, at the main path's shapes and the
   bench's: codebook 117×1023×2047 (fp32 and bf16 X), (29,200,300),
   (8,128,256); Blocked-ELL at n=2048, d=0.05, (8,128) and (128,128)
   blocks, k ∈ {128, 512}.
4. main path — ``entry()``, then ``add_mat_mat`` at 117×1023×2047 with a
   CodebookCSR, a CodebookDense and a BlockedELL ``b_t``, and a batch of
   4096 rows through the same weight; every launch counter is set to 0
   just before each path and read just after, and each kernel must have
   launched.
5. timings — device time of one call, from CUDA events around each of 30
   calls queued behind a spin kernel (so the host's cost of issuing a call
   does not show) with the 50 MB L2 flushed before each, median after
   warm-up: kernel, plain version and one PyTorch yardstick call per
   kernel and shape, beside the least time the card could take
   (``bound_ms``).  Then ``add_mat_mat`` end to end: its latency as the
   caller waits for it (host clock) and its device time.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
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
    it.  A spin kernel queued first keeps the card busy while the host
    queues the timed calls, so the events see the device's time and not
    the host's cost of issuing each call (``wall_ms`` measures that)."""
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        flush.zero_()
        fn()
    issue_s = (time.perf_counter() - t0) / WARMUP
    torch.cuda.synchronize()
    spin_s = 2.0 * ITERS * issue_s + 1e-3
    spin_start = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    spin_start.record()
    torch.cuda._sleep(int(spin_s * spin_rate))
    spin_end.record()
    pairs = []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queue_ms >= spin_start.elapsed_time(spin_end):
        raise RuntimeError("timed_ms: the card drained its queue while the "
                           "host issued the timed calls")
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from sparsematrix_tpu_torch.entry import entry
    from sparsematrix_tpu_torch.formats import (CSR, CodebookCSR, CodebookDense,
                                                csr_to_blocked_ell)
    from sparsematrix_tpu_torch.kernels import _build
    from sparsematrix_tpu_torch.kernels.codebook import (
        _codebook_spmm_cuda, codebook_spmm_reference)
    from sparsematrix_tpu_torch.kernels.spmm_blocked_ell import (
        _spmm_blocked_ell_cuda, spmm_blocked_ell_reference)
    from sparsematrix_tpu_torch.ops import add_mat_mat
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
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {
              "seconds": info["seconds"],
              "ptxas": [ln.strip() for ln in str(info["log"]).splitlines()
                        if "Used" in ln or "spill" in ln]}
              for name, info in built.items()}})

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
    main_launches = {name: 0 for name in _build.SOURCES}
    for name, run, want in paths:
        _build.launch_counts.clear()
        y = run()
        torch.cuda.synchronize()
        counts = {kn: _build.launch_counts[kn] for kn in _build.SOURCES}
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
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
