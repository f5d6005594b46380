#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``sparsematrix_tpu_torch``) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each printing
JSON lines; a failure in any of them exits non-zero and prints no result:

1. device — the card's name and ``nvidia-smi`` name and power limit.
2. build — compiles every kernel from ``sparsematrix_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together, and the host libraries
   (``native/*.cc``: the slot assigners, the rowlane packer, the colourers)
   with ``g++``, one process each, beside them.
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
   at k = 32 on both XL packs; the superblock SpMM (row 13) also at k =
   1, 8, 33 and 64 on the auto pack and at k = 32 on the bench's two packs
   and on ``pack_dualgather(A, k_tiles=8)`` (nibble idxA, one window a
   slab).  Then slice 3: the JAX bench's
   ``spgemm_xl`` operands (n = 16384, d = 0.001) planned by
   ``spgemm_plan_packed`` as the auto route packs them (octet, both
   outputs), as superblock and rowlane (CSC out) and as an octet with a
   ``rem`` section (host seconds each); the octet, superblock and rowlane
   kernels on the pair program, the rowlane kernel at L = 4 and both at
   bf16 on the A operand, and every window-permute stage of the B (q = 1)
   and C (q > 1) permutations.  Then slice 4: IC(0)/ILU(0) of the JAX
   bench's 2-D Poisson systems (256² and 512²) with host seconds, the
   wave plans (chain K = 2 at 256², binv m = 8 at 512², a 256-wave chain
   of a K = 3 band at n = 262144, binv for ``bench_trisolve``'s scattered
   factor at n = 65536 and its upper twin, a bf16 plan) and the fused
   plans (also of the 1024² IC(0) L, n = 2^20, which ``trisolve()`` sends
   to the fused engine); the chain, binv, 8-RHS chain (k = 8 and 12) and
   fused kernels
   against their plain versions (1e-4 of the output scale) and a float64
   ``spsolve_triangular`` oracle.  Then slice 5: the SELL kernels on the
   JAX bench's ``csr_spmv`` sell row (n = 4096, 128 a row, tr = 64) and
   rowpure rows (64 a row at R = 16, 128 a row at R = 8) and on the XL CSR
   (``pack_sell(tr=64)``, ``pack_sell_rowpure(group=4, R=16)``); the
   pooled-tail kernel on the XL CSR's ``spill_cap="auto"`` packs (k_tiles
   1 and 8) at k = 1 and 32, and those packs whole against the XL oracle;
   the octet SpMM at k = 32 on the bench's ``spmm_xl/octet-mm`` matrix
   (n = 32768, 2 a row), the clustered CSR's octet pack and the
   ``spgemm_xl`` pair program's trim pack (``rem``).  Then slice 6: the
   BSR grouped and panel kernels on the JAX bench's ``bsr`` point
   (n = 2048, (8, 8), block density 0.05, k = 128; also at bf16 and with
   capacity padding and an empty block-row), the grouped kernel at
   (4, 4) and at (128, 128), (64, 64) and (32, 128) on n = 16384 (its
   tile design), the panel kernel on the XL BSR
   (n = 32768, (8, 8), block density 0.0078, k = 8, 32 and 128) and at
   the shape block CG gives it (``block_cg_xl``'s Poisson system as a
   (8, 8) BSR, k = 8), each BSR built by ``csr_to_bsr`` with its host
   seconds.  Then
   slice 7: the row-lane SpMM (row 8) at the JAX bench's
   ``spmm_csr/rowlane`` point (n = 2048, d = 0.05, k = 32) and on the XL
   CSR as ``partition_rowlane`` packs it for one rank (k = 8, 32 and 64
   with fp32 values, k = 32 with bf16 values).  Then slice 8: the stream copy (row 22) bit for bit
   against ``x.clone()`` at 1, 3, 4097 elements, 128 MiB and 256 MiB,
   each also as a view one element past a 16-byte boundary.
4. main path — ``entry()``, then ``add_mat_mat`` at 117×1023×2047 with a
   CodebookCSR, a CodebookDense and a BlockedELL ``b_t``, and a batch of
   4096 rows through the same weight (a codebook container takes the
   table lookup and one product, as the JAX package routes it: these
   paths must launch no ``codebook_spmm``; the fused kernel, row 1,
   launches in the bench phase's ``fused-pallas`` rows); then ``spmv``
   and ``spmm`` (k = 32)
   on the XL CSR through the auto routes, ``spmm`` on ``prepare_spmv``'s
   pack, and ``spmv`` at n = 4096 and n = 1024; then the SpGEMM numeric
   phase on each packed plan (CSR and CSC out) and one-shot
   ``spgemm(A, B, output="csc")``, ``spmv``/``spmm`` (k = 32) on the JAX
   bench's two ``spmv_skew`` power-law CSRs (14.4 M and 11.7 M nnz)
   through the skew route, and ``spmv`` on the ``spmv_clustered`` CSR
   through ``prepare_spmv``'s auto (octet), superblock and rowlane
   layouts; then the JAX bench's solver rows: ``cg`` to tol 1e-5 at
   ``ilu_cg_xl`` (n = 65536: plain, ilu0-fix6, ilu0-waves, ic0-waves,
   ic0-fused) and ``ilu_cg_aniso`` (eps = 1000: plain, ic0-waves,
   ic0-waves-bf16), ``block_cg`` with k = 8 (plain and ic0-waves) and the
   one-shot ``trisolve`` on the scattered factor and on the 1024² IC(0)
   factor (the fused route), each held to the
   bench's checks (tol reached, true residual within 10·tol·‖b‖,
   preconditioned CG in at most 0.6× plain's iterations); then slice 5:
   ``spmm(prepare_spmv(A), X)`` on the octet-mm and clustered CSRs (the
   octet auto route), ``spmv``/``spmm`` on the XL spill-cap packs,
   ``spmv`` on the four SELL packs, ``spmm(csr, X)`` on a power-law CSR
   (n = 131072) whose skew base is an octet, ``splu_solve`` (waves at
   n = 65536, fused at n = 16384, a vector and a panel each, against the
   engines' plain solves and fp64 SuperLU) and ``bicgstab`` (plain and
   ILU(0) waves) on the convection system at n = 65536; then slice 6:
   ``spmm`` on the XL BSR (panel kernel), on the (128, 128) BSR (grouped
   kernel) and on the bench's BSR with ``method="sparse"`` and
   ``"auto"`` (the route each took is printed), ``spmv`` on the XL BSR
   through its CSR (host arrays traced: no dense matrix), ``block_cg``
   and ``cg`` on ``block_cg_xl``'s Poisson system as a (8, 8) BSR (the
   CSR operator's iterations ±2), and ``spmm_bsr`` forward and backward
   against fp64; then slice 7, the distribution layer: at world size 1
   under NCCL in this process, ``dist_spmm_rowlane`` (row 8) and
   ``dist_spmv_rowlane`` (row 7) on the XL CSR, ``dist_spmv``/``dist_spmm``
   on its row and column partitions (``psum`` and ``psum_scatter``),
   ``dist_spmv_dualgather``/``dist_spmm_dualgather`` (rows 10/11, 13/14),
   ``dist_spmv_halo_ring``/``_var`` on a banded matrix (n = 2^20) and
   ``dist_cg`` on ``ilu_cg_xl``'s system with Jacobi and with
   ``block_ic0_precond`` (rows 19/20), its iterations against the
   single-device ``cg``'s; then ``tests/_torch_dist_ranks.py`` on 2 and on
   4 gloo ranks sharing the card (every ``dist_*`` of the slice on small
   fixtures against fp64, with the kernels each rank launched); then
   slice 8, the bench suite: ``bench.headline`` (the twin of
   ``bench.py``, its JSON line printed) and the suite's CLI on each group
   of ``BENCH_GROUPS`` at its default size, failing on a failed group, a
   dropped variant or row, a false check, a SoL above 105 % or a group
   that did not launch the kernels ``BENCH_KERNELS`` names; the calibrate
   rows against the spec sheet.  Every
   launch counter is set to 0 just before each path and read just after,
   and each kernel must have launched.  ``seconds`` lines give each
   phase's time.
5. timings — device time of one call, from CUDA events around each of 30
   calls, each queued behind its own spin kernel (so the host's cost of
   issuing a call does not show) with the 50 MB L2 flushed before it,
   median after warm-up: kernel, plain version and one PyTorch yardstick
   call per kernel and shape (cuSPARSE through ``torch.sparse_csr_tensor``
   for the SpMV kernels, one ``torch.gather`` of the composed window
   index for the window permute), beside the least time the card could
   take (``bound_ms``).  Then the paths end to end: latency as the caller
   waits for it (host clock) and device time, beside cuBLAS, cuSPARSE
   (``torch.sparse.mm`` of the two CSR operands for SpGEMM, its symbolic
   phase included) or one ``torch.gather``.  For the trisolve kernels
   the yardstick is cuSPARSE's triangular solve through
   ``torch.triangular_solve`` with a CSR matrix (its analysis runs in
   every call), and the count of dependent steps is printed (binv also
   at the 512² IC(0) factor, 256 waves); for each
   solver cell the time of an iteration (a tol=0 run of 25 iterations,
   device and wall), iterations and ms to tol.  For the slice-5 kernels
   the yardstick is cuSPARSE SpMV/SpMM of the same CSR (for the pooled
   tail, of the tail's own entries; its line also gives the tail's
   groups, cells, fill and layout floor, the plane bytes at HBM's rate)
   and, for the octet SpMM, also the
   port's k_tiles=1 dual-gather walk on the same matrix
   (``kt1_walk_ms``).  For the BSR kernels the yardstick is torch's BSR
   product, ``torch.sparse_bsr_tensor @ X`` (or cuSPARSE CSR where that
   is refused, named in ``library``) and, on the bench's point,
   cuBLAS of the densified matrix; then the BSR paths end to end and
   block CG's and CG's iteration on the BSR operator.  For row 8 the
   yardstick is cuSPARSE SpMM of the same CSR; the world-size-1 dist paths
   are timed end to end, each beside its local kernel alone.  Row 22 at
   128 MiB and 256 MiB beside ``x.clone()`` and ``y.copy_(x)``.
   For rows 2, 12, 5, 9, 7, 1, 15, 22, 19, 21, 18, 14, 13, 4, 3 and 8,
   ``variant`` lines time
   each knob setting and ablation beside the default in the same call: the
   Blocked-ELL split over blocks, staging alone, no zero-row skip, FMAs
   alone; the tail's kernel alone, its rows a warp (k = 1) or blocks a
   tile (k = 32), no X gather, decode alone; the SELL kernel's slabs a
   block, warps a block and sublanes a batch, no x gather, meta read
   under every value, the values alone; the superblock kernel's slabs a
   warp, no x gather, no padding skip and a zero fill of y alone; the
   rowlane kernel's slabs a warp and the sector mask off; the codebook
   kernel's split of k (1, 2, 4, 8); the octet walk's slabs a range,
   slab stages and slab groups and its copies and stores alone, on both
   ``spgemm_xl`` packs and the clustered CSR's octet pack; the stream
   copy's chunk,
   stages and blocks an SM at 128 and 256 MiB; the cluster chain's
   cluster size and ring stages, its hop alone and hop with x's read, at
   the 256² IC(0) L plan, each with µs a dependent step (an ablation's
   result is not the product); the fused walk's lanes a row and
   ablations at the 256² and 1024² IC(0) L plans, with µs a wave; the
   k_tiles = 1 SpMM walk's steps alone and slabs a block at the XL k = 32
   case, and the superblock walk's at the auto pack's; the panel BSR
   kernel's narrow and wide designs, each forced, at block CG's k = 8 and
   the XL BSR's k = 8, 32 and 128 (each held against the plain version);
   the grouped BSR kernel's tile and skeleton designs, each forced, at
   (128, 128), (64, 64) and (32, 128), n = 16384 (each held against the
   plain version); the row-lane SpMM's window and gather walks, each
   forced (held against the plain version), and the gather walk's parts
   (no X read, no panel update, the planes and compaction alone: not the
   product), at the XL pack's k = 8, 32 and 64 and the bench point.  The trisolve timing lines give µs a dependent step too (the
   fused kernel's steps are its plan's segments, and its lines give its
   waves and µs a wave beside them; the 1024² plan's plain time is one
   call on the host's clock).  The timing lines of rows 5, 9, 7 and 15
   also give each pack's slabs, cells, fill and two layout floors: every plane
   byte, and the bytes the kernel reads after its skips, at HBM's rate
   (row 15's with x and y); row 7 is also
   timed at the ``ilu_cg_xl`` fixpoint solve's two packs and at two small
   packs the cuts split, the bench ``trisolve/fixpoint`` pack and an n =
   4096, 64-a-row pack (each checked against its plain version first;
   the small ones beside their equal and their cut ranges, at the
   default and at 1-8 slabs a warp each way),
   a ``host`` line gives the µs the host spends to issue one fixpoint
   SpMV (entry, wrapper, bare launch, sweep), and row 1's lines give the
   default split and the dense FMA floor.  The codebook routes side by side at 117 and
   4096 rows: the lookup, the fused kernel and ``add_mat_mat`` as
   routed.
   ``timed_ms``, ``wall_ms`` and the peaks come from the package
   (``utils/timer.py``, ``utils/roofline.py``), so the bench suite and
   this script time the same way.
6. probes (slice 9) — the kernels of the JAX repository's probe and repro
   scripts (``probes/``): first each against its plain version at the
   probes' card shapes (the three row-lane ablations on the XL CSR's
   group-128 rowlane pack, the single, dual and pooled gather steps on
   32768 slabs with x the XL vector, the row gather at the four repro
   shapes, the metadata scale on flat, 2-D and row-padded metadata), the
   gather steps also against the scripts' fp64 oracle; then, every launch
   counter set to 0, the six modules' ``run`` (their main path: each
   checks its results, then times kernel, plain version and the one-call
   yardstick where there is one), ``probe_xl_spmv`` on this script's XL
   CSR with one ``utils.profiling.device_trace`` around the rowlane call,
   which must name the ``spmv_rowlane`` kernel; the counters are read just
   after and each probe kernel must have launched.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sparsematrix_tpu_torch.utils import roofline
from sparsematrix_tpu_torch.utils.roofline import (PEAK_BF16, PEAK_BYTES,
                                                   PEAK_FP32)
from sparsematrix_tpu_torch.utils.timer import (spin_cycles_per_s, timed_ms,
                                                wall_ms)


# fp32 elements of the calibrate row's stream (bench/suite.py): 128 MiB
MIB128 = 128 * 1024 * 1024 // 4
# the bench groups the bench phase runs at their default (card) sizes; the
# XL groups repeat paths the earlier phases drive at full size
BENCH_GROUPS = ("calibrate", "csr_spmv", "csr_spmv_large", "spmm_csr",
                "spmm_bell", "spmm_banded", "bsr", "spmv_clustered",
                "weak_scaling", "spgemm", "trisolve", "ilu_cg",
                "codebook_gemm")
# the kernels each bench group must launch (from the launch counters of
# the first run on the card, checked against PERF.md's kernel table)
BENCH_KERNELS = {
    "calibrate": ("stream_copy",),
    "csr_spmv": ("spmv_dualgather_sb", "spmv_sell", "spmv_sell_rowpure",
                 "spmv_rowlane"),
    "csr_spmv_large": ("spmv_rowlane",),
    "spmm_csr": ("spmm_rowlane", "spmm_dualgather"),
    "spmm_bell": ("spmm_blocked_ell",),
    "spmm_banded": ("spmm_blocked_ell",),
    "bsr": ("spmv_dualgather_sb", "spmm_bsr_panel"),
    "spmv_clustered": ("spmv_octet", "spmv_dualgather_sb"),
    "weak_scaling": (),
    "spgemm": ("spmv_octet", "window_permute"),
    "trisolve": ("spmv_rowlane", "trisolve_fused", "trisolve_binv",
                 "trisolve_chain", "trisolve_chain_mm"),
    "ilu_cg": ("spmv_dualgather_sb", "spmv_rowlane", "trisolve_chain",
               "trisolve_fused"),
    "codebook_gemm": ("codebook_spmm",),
}


# the kernels of the probes phase (phase 6), launched by probes/ only
PROBE_KERNELS = ("probe_rowlane_dma_only", "probe_rowlane_fixed_window",
                 "probe_rowlane_slice_no_gather", "probe_gather_single",
                 "probe_gather_dual", "probe_gather_pooled",
                 "probe_tile_gather", "probe_meta_scale")


# row 18's case on the 1024² IC(0) factor (trisolve()'s fused route)
FUSED_1024 = "fused ic0 L Poisson 1024^2"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32):
    """(bound_ms, bound_by): the larger of the operations at ``peak`` (the
    card's rate for the operands' type) and the bytes at HBM's rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sparse_work(sp, k: int, val_bytes: int):
    """(operations, bytes) of ``sp @ X`` with X of ``k`` columns (k = 1: a
    vector): each stored value and its 4-byte column once, the rows of X
    that a stored column names read once (a row no entry names is never
    read), Y written once in full."""
    rows, _ = sp.shape
    used = np.unique(sp.indices).size
    return (2.0 * sp.nnz * k,
            sp.nnz * (val_bytes + 4.0) + 4.0 * used * k + 4.0 * rows * k)


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


def spgemm_xl_operands(n: int = 16384, density: float = 0.001):
    """The JAX bench's ``spgemm_xl`` point (``bench/suite.py:1077-1096``):
    ``sps.random`` patterns from ``random_state`` 7 and 8, values uniform
    in ±1000 from ``default_rng(7)``, A's then B's.  Returns (A, B) as
    scipy CSR."""
    import scipy.sparse as sps

    rng = np.random.default_rng(7)
    sa = sps.random(n, n, density=density, random_state=7, format="csr",
                    dtype=np.float32)
    sb = sps.random(n, n, density=density, random_state=8, format="csr",
                    dtype=np.float32)
    sa.data = rng.uniform(-1000, 1000, sa.nnz).astype(np.float32)
    sb.data = rng.uniform(-1000, 1000, sb.nnz).astype(np.float32)
    return sa, sb


def clustered_matrix(n: int = 512 * 128, nnz: int = 80_000):
    """The JAX bench's ``spmv_clustered`` point (``bench/suite.py:744-791``):
    512 row tiles whose ~1.2 entries a row all land in one 1024-column
    window, from ``default_rng(0)``.  Returns (scipy CSR, x)."""
    import scipy.sparse as sps

    g = np.random.default_rng(0)
    rows = g.integers(0, n, size=nnz)
    cols = g.integers(0, 1024, size=nnz)
    vals = g.uniform(-1000, 1000, nnz).astype(np.float32)
    sp = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    return sp, g.standard_normal(n).astype(np.float32)


def octet_mm_matrix(n: int = 32768, k: int = 32):
    """The JAX bench's ``spmm_xl/octet-mm`` point
    (``bench/suite.py:1655-1667``): 2 column draws a row from
    ``default_rng(12)``, values uniform in ±1, duplicates merged; X
    (n, k) uniform in ±1 from the same generator.  Returns (scipy CSR,
    X)."""
    import scipy.sparse as sps

    g = np.random.default_rng(12)
    rows = np.repeat(np.arange(n), 2)
    cols = g.integers(0, n, rows.size)
    data = g.uniform(-1, 1, rows.size).astype(np.float32)
    sp = sps.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    return sp, g.uniform(-1, 1, (n, k)).astype(np.float32)


def octet_skew_matrix(n: int = 131072, hubs: int = 16):
    """A power-law CSR whose skew base packs to an octet: 1-2 scattered
    column draws a row plus ``hubs`` hub columns that each hold a quarter
    of the rows (a citation-style pattern: most rows cite one or two
    papers, every row may cite a few classics), values uniform in ±1000,
    from ``default_rng(17)``.  Once the hub columns leave, the remainder
    holds ≲ 2 entries a row.  Returns a scipy CSR."""
    import scipy.sparse as sps

    g = np.random.default_rng(17)
    r = np.repeat(np.arange(n), g.integers(1, 3, n))
    c = g.integers(0, n, r.size)
    hub = g.choice(n, hubs, replace=False)
    hr = np.concatenate([g.choice(n, n // 4, replace=False) for _ in hub])
    rows = np.concatenate([r, hr])
    cols = np.concatenate([c, np.repeat(hub, n // 4)])
    data = g.uniform(-1000, 1000, rows.size).astype(np.float32)
    sp = sps.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    return sp


def convection_system(side: int):
    """The unsymmetric system of the port's solver tests: the side×side
    2-D Poisson matrix plus 0.5 × a central convection term along x.
    Returns (n, scipy CSR fp32)."""
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.utils.testutils import poisson2d

    n, sp = poisson2d(side * side)
    sp = sp + 0.5 * sps.kron(sps.eye(side), sps.diags(
        [-1.0, 1.0], [-1, 1], (side, side)))
    return n, sp.tocsr().astype(np.float32)


def banded_matrix(n: int = 1 << 20, half: int = 4):
    """An n×n band of 2·half + 1 diagonals (a 1-D stencil's pattern, the
    case of the halo exchanges), values uniform in ±1000 from
    ``default_rng(40)``; x from the same generator.  Returns (scipy CSR
    fp32, x)."""
    import scipy.sparse as sps

    g = np.random.default_rng(40)
    offsets = list(range(-half, half + 1))
    diags = [g.uniform(-1000, 1000, n - abs(o)).astype(np.float32)
             for o in offsets]
    sp = sps.diags(diags, offsets, shape=(n, n), format="csr",
                   dtype=np.float32)
    return sp, g.standard_normal(n).astype(np.float32)


def bench_bsr_dense(n: int = 2048, block=(8, 8), density: float = 0.05,
                    k: int = 128):
    """The JAX bench's ``bsr`` point (``bench/suite.py:534-547``): dense
    blocks at ``density`` of the block slots from ``default_rng(3)``,
    values from ``gen_matrix_random``; then its x and X.  Returns (dense,
    X)."""
    from sparsematrix_tpu_torch.utils.testutils import gen_matrix_random

    rng = np.random.default_rng(3)
    mask = rng.random((n // block[0], n // block[1])) < density
    dense = (np.kron(mask, np.ones(block)).astype(np.float32)
             * gen_matrix_random(rng, n, n))
    gen_matrix_random(rng, n, 1)  # the bench's x
    return dense, gen_matrix_random(rng, n, k)


def block_sparse_scipy(n: int, block, density: float, seed: int):
    """An n×n matrix of dense (bm × bn) blocks at ``density`` of the block
    slots, values uniform in ±1000, from ``default_rng(seed)``, built as a
    scipy CSR without a dense matrix."""
    import scipy.sparse as sps

    from sparsematrix_tpu_torch.utils.testutils import gen_matrix_random

    rng = np.random.default_rng(seed)
    bm, bn = block
    mask = rng.random((n // bm, n // bn)) < density
    bi, bj = np.nonzero(mask)
    data = gen_matrix_random(rng, bi.size * bm, bn).reshape(-1, bm, bn)
    indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
    return sps.bsr_matrix((data, bj, indptr), shape=(n, n)).tocsr()


def bsr_host(A):
    """(indptr, indices, data) of a BSR's stored blocks on the host; data
    in fp64."""
    nb = A.num_blocks
    return (A.indptr.long().cpu().numpy(), A.indices[:nb].long().cpu().numpy(),
            A.data[:nb].double().cpu().numpy())


def bsr_oracle(A, X64: np.ndarray) -> np.ndarray:
    """``A @ X`` in fp64 on the host, block by block (batched products
    summed into the block-rows), 8192 blocks at a time."""
    indptr, indices, data = bsr_host(A)
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    nbc = -(-A.shape[1] // bn)
    Xb = np.zeros((nbc * bn, X64.shape[1]))
    Xb[: X64.shape[0]] = X64
    Xb = Xb.reshape(nbc, bn, -1)
    brow = np.repeat(np.arange(nbr), np.diff(indptr))
    out = np.zeros((nbr, bm, X64.shape[1]))
    for s in range(0, data.shape[0], 8192):
        e = min(s + 8192, data.shape[0])
        r = brow[s:e]  # sorted: sum each block-row's run of products
        starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
        out[r[starts]] += np.add.reduceat(
            np.matmul(data[s:e], Xb[indices[s:e]]), starts, axis=0)
    return out.reshape(nbr * bm, -1)[: A.shape[0]]


def bsr_work(A, k: int, val_bytes: int, x_bytes: int):
    """(operations, bytes) of ``A @ X`` for a BSR A and X of ``k``
    columns: 2·bm·bn·k operations a stored block; each stored block and
    its 4-byte block column once, the X rows a stored block names read
    once, Y written once.  Panel padding counts against the kernel."""
    bm, bn = A.block_shape
    nb = A.num_blocks
    cols = np.unique(A.indices[:nb].long().cpu().numpy())
    x_rows = np.minimum(cols * bn + bn, A.shape[1]) - cols * bn
    return (2.0 * nb * bm * bn * k,
            nb * (bm * bn * val_bytes + 4.0) + x_bytes * k * float(x_rows.sum())
            + x_bytes * k * A.shape[0])


def container_bytes(obj) -> int:
    """Bytes of every tensor of a pack or plan, nested ones included."""
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(container_bytes(o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return sum(container_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def pack_to_scipy(packed, slot_row_col):
    """The entries an octet/superblock/rowlane pack stores, as a host scipy
    CSR (``slot_row_col`` is its module's slot decode); an octet's ``rem``
    section included."""
    import scipy.sparse as sps

    row, col = slot_row_col(packed)
    vals = packed.vals.reshape(row.shape)
    keep = vals != 0
    out = sps.coo_matrix(
        (vals[keep].float().cpu().numpy(),
         (row[keep].cpu().numpy(), col[keep].cpu().numpy())),
        shape=packed.shape).tocsr()
    rem = getattr(packed, "rem", None)
    return out if rem is None else (out + pack_to_scipy(rem, slot_row_col))


def solve_plan_bytes(plan) -> int:
    """Bytes of the planes a solve plan holds (the transposed plan and the
    gradient pattern excluded): its size, not what a solve must read."""
    names = ("a1", "a2", "s_idx", "vals", "slab_win", "slab_tloc",
             "group_wave", "group_tile", "seg_id", "aux", "inv_diag",
             "perm", "rank")
    return sum(container_bytes(getattr(plan, f)) for f in names
               if getattr(plan, f, None) is not None)


def trisolve_work(kname: str, plan, n: int, R: int):
    """(operations, bytes) that a triangular solve of ``R`` right-hand
    sides on ``plan`` must do and move: a dense block that can hold a
    nonzero is read once (chain: A1 and the K A2 blocks of every tile;
    binv: the blocks q <= p of each wave's block upper triangular a1), a
    stored slab entry once as its value and a 4-byte column (plane padding
    counts against the kernel), the fused plan's gate and gate·inv_diag
    rows of ``aux`` (2 of its 8), inv_diag and the level permutation
    once, b read and x written once.  Counted from this run's plan."""
    B2 = 128 * 128
    vec = 8.0 * n * R
    if kname == "trisolve_fused":
        nnz = int((plan.vals != 0).sum())
        extra = sum(container_bytes(getattr(plan, f))
                    for f in ("inv_diag", "perm", "rank")
                    if getattr(plan, f, None) is not None)
        return (2.0 * nnz + 4.0 * n,
                nnz * (plan.vals.element_size() + 4)
                + plan.aux.shape[0] * 2 * 128 * 4 + extra + vec)
    if plan.mode == "chain":
        blocks = plan.S * (1 + plan.K)
        return (2.0 * blocks * B2 * R,
                blocks * B2 * plan.a1.element_size() + vec)
    nnz = int((plan.vals != 0).sum())
    blocks = plan.n_waves * plan.m * (plan.m + 1) // 2
    return ((2.0 * nnz + 2.0 * blocks * B2) * R,
            blocks * B2 * plan.a1.element_size()
            + nnz * (plan.vals.element_size() + 4) + vec)


def plane_bytes(packed) -> int:
    return sum(t.numel() * t.element_size()
               for t in (packed.idxA, packed.idxB, packed.vals,
                         packed.group_tile, packed.slab_win)
               + ((packed.slab_tloc,) if packed.slab_tloc is not None
                  else ()))


def tail_stats(tail) -> dict:
    """The pooled tail's shape and its layout floor: every plane byte
    (values, idxA, idxB, the chunk pointers) read once at HBM's rate."""
    cells = tail.vals.numel()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (tail.vals, tail.idxA, tail.idxB, tail.ptr,
                           tail.group_tile))
    return {"n_groups": tail.idxB.shape[0], "group": tail.group,
            "cells": cells, "fill": tail.nnz / cells, "plane_bytes": nbytes,
            "layout_floor_ms": nbytes / PEAK_BYTES * 1e3}


def sell_stats(P) -> dict:
    """Row 5's pack and its two layout floors at HBM's rate: every plane
    byte (values, meta, the slab tables) read once, and the bytes the
    kernel reads: the values, the slab tables, and the 32-byte sectors of
    its 16-bit copy of meta that hold a nonzero value (meta is read only
    under one)."""
    cells = P.vals.numel()
    tables = 4 * (P.slab_tile.numel() + P.slab_win.numel())
    vals = P.vals.numel() * P.vals.element_size()
    every = vals + 4 * cells + tables
    sectors = int((P.vals.reshape(-1, 16) != 0).any(1).sum())
    read = vals + 32 * sectors + tables
    return {"n_slabs": P.meta.shape[0], "cells": cells,
            "fill": P.nnz / cells, "plane_bytes": every,
            "layout_floor_ms": every / PEAK_BYTES * 1e3,
            "read_bytes": read, "read_floor_ms": read / PEAK_BYTES * 1e3}


def superblock_stats(P, walked: int) -> dict:
    """Row 9's pack and its two layout floors at HBM's rate: every plane
    byte (s_idx, values, the slab and group tables) read once, and the
    planes of the ``walked`` slabs only (the kernel skips the rest)."""
    slots = P.vals.numel()
    slot_bytes = P.s_idx.element_size() + P.vals.element_size()
    tables = 4 * (P.group_super.numel() + P.slab_win.numel()
                  + P.slab_tloc.numel())
    every = slots * slot_bytes + tables
    read = walked * 1024 * slot_bytes + tables
    return {"n_slabs": P.n_slabs, "slots": slots, "fill": P.nnz / slots,
            "walked_slabs": walked, "plane_bytes": every,
            "layout_floor_ms": every / PEAK_BYTES * 1e3,
            "read_bytes": read, "read_floor_ms": read / PEAK_BYTES * 1e3}


def rowlane_stats(P, mask) -> dict:
    """Row 7's pack and its two layout floors at HBM's rate: every plane
    byte (s_idx, values, the group and slab tables) read once, and the
    bytes the kernel reads under its sector ``mask``: the 32-byte sectors
    of the value and s_idx planes that hold a set bit, the mask and the
    tables."""
    n = P.n_slabs
    vb = P.vals.element_size()
    tables = 4 * (P.group_tile.numel() + P.slab_win.numel())
    every = P.vals.numel() * (1 + vb) + tables
    bits = ((mask.to(torch.int32) & 0xFFFF)[..., None] >> torch.arange(
        16, device=mask.device)) & 1  # (n, 8, 16): a bit a 8 lanes
    per = 4 // vb  # bits a 32-byte value sector: 1 (fp32), 2 (bf16)
    val_sectors = int(bits.reshape(n, 8, 16 // per, per).amax(-1).sum())
    idx_sectors = int(bits.reshape(n, 8, 4, 4).amax(-1).sum())
    read = 32 * (val_sectors + idx_sectors) + 16 * n + tables
    return {"n_slabs": n, "group": P.group, "slots": P.vals.numel(),
            "fill": P.fill_rate, "plane_bytes": every,
            "layout_floor_ms": every / PEAK_BYTES * 1e3,
            "value_sectors_set": val_sectors / (n * 8 * 16 // per),
            "read_bytes": read, "read_floor_ms": read / PEAK_BYTES * 1e3}


def octet_stats(P, items: int) -> dict:
    """Row 15's pack (both sections) and its two layout floors at HBM's
    rate, each with x read once and y written once: every slab's planes
    (values, RT, CH and POS) read once, and the planes of the ``items``
    slabs the walk lists only (it leaves the padding slabs unread)."""
    sections = [P] + ([P.rem] if P.rem is not None else [])
    n = sum(sec.n_slabs for sec in sections)
    per_slab = 1024 * (P.vals.element_size() + 3)
    xy = 4 * (P.shape[0] + P.shape[1])
    return {"n_slabs": n, "walked_slabs": items, "cells": 1024 * n,
            "fill": P.nnz / (1024 * n), "plane_bytes": n * per_slab,
            "layout_floor_ms": (n * per_slab + xy) / PEAK_BYTES * 1e3,
            "read_bytes": items * per_slab,
            "read_floor_ms": (items * per_slab + xy) / PEAK_BYTES * 1e3}


# the probe kernels' entries of the kernels line: (kernel, source,
# replaces, the probe row (name, size) it takes its times from, the case
# of phase 6's check)
PROBE_LINE = [
    *[(f"probe_rowlane_{b.replace('-', '_')}", "probe_rowlane.cu",
       "benchmarks/probe_xl_spmv.py:115", (f"probe_xl/variant-{b}", None),
       "XL fp32 group=128") for b in ("dma-only", "fixed-window",
                                      "slice-no-gather")],
    ("probe_gather_single", "probe_gather_step.cu",
     "benchmarks/probe_dualgather.py:179",
     ("probe_dualgather/P3-single", "card"), "32768 slabs S=256"),
    ("probe_gather_dual", "probe_gather_step.cu",
     "benchmarks/probe_dualgather.py:67",
     ("probe_dualgather/P3-dual", "card"), "32768 slabs S=256"),
    ("probe_gather_pooled", "probe_gather_step.cu",
     "benchmarks/probe_sublane_slice.py:66",
     ("probe_sublane_slice/P3-pooled", "card"), "32768 slabs S=256"),
    ("probe_tile_gather", "probe_tile_gather.cu",
     "docs/repro_dynamic_gather_shapes.py:27",
     ("repro_dynamic_gather_shapes/(32,128)", None), "(32,128)"),
    ("probe_meta_scale", "probe_meta_scale.cu",
     "docs/repro_smem_lane_padding.py:51",
     ("repro_smem_lane_padding/2-D", None), "2-D"),
]


def run_probes(dev, sp_xl, x_xl_np, A_xl, x_xl, errs, failures,
               main_launches):
    """Phase 6: each probe kernel against its plain version at the probes'
    card shapes, then the six probe modules with the launch counters set
    to 0 just before and read just after.  Records the checks' errors in
    ``errs``, the launches in ``main_launches`` and every fault in
    ``failures``; returns the modules' rows by (name, size)."""
    from sparsematrix_tpu_torch.kernels import _build
    from sparsematrix_tpu_torch.kernels import probe_gather_step as pgmod
    from sparsematrix_tpu_torch.kernels.probe_meta_scale import (
        _meta_scale_cuda, meta_scale_reference)
    from sparsematrix_tpu_torch.kernels.probe_rowlane import (
        STEPS, _probe_rowlane_cuda, pad_x, probe_rowlane_reference)
    from sparsematrix_tpu_torch.kernels.probe_tile_gather import (
        _tile_gather_cuda, tile_gather_reference)
    from sparsematrix_tpu_torch.kernels.spmv_rowlane import pack_sell_rowlane
    from sparsematrix_tpu_torch.probes import (probe_calibrate_xcheck,
                                               probe_dualgather,
                                               probe_sublane_slice,
                                               probe_xl_spmv,
                                               repro_dynamic_gather_shapes,
                                               repro_smem_lane_padding)
    from sparsematrix_tpu_torch.probes._common import Session

    def check(kernel, case, got, plain, rel_tol, oracle=None):
        """The kernel against its plain version within ``rel_tol`` of the
        plain result's scale (0: bit for bit) and, given an fp64 oracle,
        within the scripts' 1e-4 of its scale."""
        torch.cuda.synchronize()
        scale = max(float(plain.abs().max()), 1e-30)
        err = float((got - plain).abs().max())
        ok = (torch.equal(got, plain) if rel_tol == 0 else
              err <= rel_tol * scale) and bool(torch.isfinite(got).all())
        row = {"phase": "check", "kernel": kernel, "case": case,
               "max_abs_err": err, "tol": rel_tol * scale}
        if oracle is not None:
            row["rel_err_oracle"] = float(
                np.abs(got.double().cpu().numpy()[0] - oracle).max()
                / max(np.abs(oracle).max(), 1e-30))
            ok = ok and row["rel_err_oracle"] < probe_dualgather.TOL
        emit({**row, "ok": ok})
        errs[(kernel, case)] = err
        if not ok:
            failures.append(f"check {kernel} {case}")

    # fp32: summation order only (1e-5 of the output's scale); the gather
    # and the metadata scale do no sums: bit for bit
    t = time.perf_counter()
    P_g128 = pack_sell_rowlane(A_xl, group=128)
    torch.cuda.synchronize()
    emit({"phase": "pack", "pack": "XL rowlane fp32 group=128",
          "seconds": time.perf_counter() - t, "n_slabs": P_g128.n_slabs,
          "fill": P_g128.fill_rate})
    body = probe_xl_spmv.strip_spill(P_g128)
    xp = pad_x(x_xl, body.n_win)
    for step in STEPS:
        check(f"probe_rowlane_{step.replace('-', '_')}", "XL fp32 group=128",
              _probe_rowlane_cuda(body, xp, step),
              probe_rowlane_reference(body, xp, step), 1e-5)
    d = probe_dualgather.inputs(np.random.default_rng(11), S=256, group=64,
                                n_groups=512,
                                xp=probe_dualgather.xl_vector())
    d["ptr"] = np.random.default_rng(12).integers(
        0, 256, d["win"].shape + (8,)).astype(np.int32)
    tg = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    for mode in ("single", "dual", "pooled"):
        args = (tg["ptr"] if mode == "pooled" else tg["win"],
                None if mode == "single" else tg["idxA"], tg["idxB"],
                tg["vals"], tg["xp"])
        check(f"probe_gather_{mode}", "32768 slabs S=256",
              pgmod._step_cuda(mode, *args), pgmod._step_plain(mode, *args),
              1e-5, probe_dualgather.oracle(mode, d))
    del tg, d
    for R, C in repro_dynamic_gather_shapes.SHAPES:
        g = torch.Generator(device=dev).manual_seed(R * C)
        tab = torch.randn((R, C), device=dev, generator=g)
        idx = torch.randint(0, C, (R, C), device=dev, generator=g,
                            dtype=torch.int32)
        check("probe_tile_gather", f"({R},{C})", _tile_gather_cuda(tab, idx),
              tile_gather_reference(tab, idx), 0.0)
    xm = torch.randn((8, 128), device=dev)
    for label, meta, cols, _ in repro_smem_lane_padding.layouts(dev):
        check("probe_meta_scale", label, _meta_scale_cuda(meta, xm, cols),
              meta_scale_reference(meta, xm, cols), 0.0)

    # the main path: the six modules as a user runs them
    sess = Session(dev, quiet=True)
    _build.launch_counts.clear()
    t = time.perf_counter()
    ran = {
        "probe_xl_spmv": probe_xl_spmv.run(
            sess, sp_xl, x_xl_np, configs=("fp32-g128",), A=A_xl,
            packs={"fp32-g128": P_g128}),
        "probe_dualgather": probe_dualgather.run(sess),
        "probe_sublane_slice": probe_sublane_slice.run(sess),
        "repro_dynamic_gather_shapes": repro_dynamic_gather_shapes.run(sess),
        "repro_smem_lane_padding": repro_smem_lane_padding.run(sess),
        "probe_calibrate_xcheck": probe_calibrate_xcheck.run(sess)}
    torch.cuda.synchronize()
    counts = {kn: _build.launch_counts[kn] for kn in PROBE_KERNELS}
    for row in sess.rows:
        emit({"phase": "probes", **row})
    emit({"phase": "probes", "seconds": time.perf_counter() - t,
          "launches": counts, "passed": ran})
    failures += [f"probes {name}" for name, ok in ran.items() if not ok]
    for kn, v in counts.items():
        main_launches[kn] = v
        if v == 0:
            failures.append(f"kernel {kn} was not launched by the probes")
    return {(r["name"], r.get("size")): r for r in sess.rows}


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
        _codebook_spmm_cuda, codebook_split, codebook_spmm_reference)
    from sparsematrix_tpu_torch.kernels.spmm_blocked_ell import (
        _spmm_blocked_ell_cuda, spmm_blocked_ell_reference)
    from sparsematrix_tpu_torch.kernels.spmm_dualgather import (
        _spmm_dualgather_cuda, spmm_dualgather_reference)
    from sparsematrix_tpu_torch.kernels.stream_copy import (
        _stream_copy_cuda, stream_copy_reference)
    from sparsematrix_tpu_torch.kernels.window_permute import (
        _window_permute_cuda, window_permute_reference)
    from sparsematrix_tpu_torch.ops import (ClosPermutePlan, add_mat_mat,
                                            apply_permutation, pack_skew,
                                            prepare_spmv,
                                            spgemm, spgemm_apply_packed,
                                            spgemm_apply_packed_csc,
                                            spgemm_plan_packed, spmm, spmv)
    from sparsematrix_tpu_torch.ops.permute_clos import (
        _apply_clos_impl as clos_apply)
    from sparsematrix_tpu_torch.utils.testutils import (
        gen_matrix_random, gen_random_dense_sparse, gen_sparse_index_matrix,
        gen_zipf_csr, quantized_check, relative_check)
    octmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_octet")
    sbmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_superblock")
    rlmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_rowlane")
    tspmm = importlib.import_module("sparsematrix_tpu_torch.ops.spmm")

    dev = torch.device("cuda")
    failures = []
    t_start = time.perf_counter()
    t_mark = [t_start]

    def mark(section):
        """Prints the seconds since the last mark (the script's phases
        share one time limit)."""
        now = time.perf_counter()
        emit({"phase": "seconds", "section": section,
              "seconds": now - t_mark[0]})
        t_mark[0] = now

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
            host["libs"] = _build.build_host()
        except RuntimeError as e:  # no g++, or it failed: reported below
            host["error"] = str(e)
        host["seconds"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    # the spgemm_xl operands (scipy's sampler, ~16 s an operand on the
    # host) are drawn beside the build, which mostly waits on nvcc
    xl_operands = {}
    xl_thread = threading.Thread(
        target=lambda: xl_operands.update(AB=spgemm_xl_operands()))
    xl_thread.start()
    built = _build.build()
    host_thread.join()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "host_libraries": {"built": sorted(host.get("libs", {})),
                             "seconds": host.get("seconds"),
                             "error": host.get("error")},
          "kernels": {name: {
              "seconds": info["seconds"],
              "ptxas": [ln.strip() for ln in str(info["log"]).splitlines()
                        if "Used" in ln or "spill" in ln]}
              for name, info in built.items()}})
    mark("build")
    if "libs" not in host:
        print("chip_smoke: FAILED: the host libraries did not build: "
              f"{host.get('error')}", file=sys.stderr)
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
    # row 13 on a superblock pack with nibble idxA over one window each
    P_nib = timed_pack("XL fp32 k_tiles=8 (nibble, one window)",
                       lambda: dgmod.pack_dualgather(A_xl, k_tiles=8))
    P_kt1_bf = timed_pack("XL bf16 spmm walk k_tiles=1",
                          lambda: dgmod.pack_dualgather(
                              A_xl, k_tiles=1, dtype=torch.bfloat16))
    # row 14's second X panel (k = 33 and 64: the window restaged)
    X64_xl_np = np.random.default_rng(11).standard_normal(
        (sp_xl.shape[1], 64)).astype(np.float32)
    X33_xl_np = np.ascontiguousarray(X64_xl_np[:, :33])
    # row 13's narrow panels (k = 1 and 8)
    X1_xl_np = np.ascontiguousarray(X64_xl_np[:, :1])
    X8_xl_np = np.ascontiguousarray(X64_xl_np[:, :8])
    Y64_xl_want = sp64_xl @ X64_xl_np.astype(np.float64)
    xl_want = {id(x_xl_np): y_xl_want, id(X_xl_np): Y_xl_want,
               id(X64_xl_np): Y64_xl_want,
               id(X33_xl_np): Y64_xl_want[:, :33],
               id(X1_xl_np): Y64_xl_want[:, :1],
               id(X8_xl_np): Y64_xl_want[:, :8]}
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
    if not (P_nib.nibble and not P_nib.two_win and P_sb.nibble
            and P_128.two_win and P_bf.vals.dtype == torch.bfloat16):
        failures.append("row 13's packs are not the nibble, two-window and "
                        "bf16 packs named")

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
            ("spmm_dualgather", "XL k=33 k_tiles=1", P_kt1, sp_xl,
             X33_xl_np),
            ("spmm_dualgather", "XL k=64 k_tiles=1", P_kt1, sp_xl,
             X64_xl_np),
            ("spmm_dualgather", "XL bf16 k=32 k_tiles=1", P_kt1_bf, sp_xl,
             X_xl_np),
            ("spmm_dualgather_sb", "XL k=32 auto", P_sb, sp_xl, X_xl_np),
            ("spmm_dualgather_sb", "XL k=1 auto", P_sb, sp_xl, X1_xl_np),
            ("spmm_dualgather_sb", "XL k=8 auto", P_sb, sp_xl, X8_xl_np),
            ("spmm_dualgather_sb", "XL k=33 auto", P_sb, sp_xl, X33_xl_np),
            ("spmm_dualgather_sb", "XL k=64 auto", P_sb, sp_xl, X64_xl_np),
            ("spmm_dualgather_sb", "XL k=32 two_win kt8 g128", P_128, sp_xl,
             X_xl_np),
            ("spmm_dualgather_sb", "XL k=32 nibble kt8", P_nib, sp_xl,
             X_xl_np),
            ("spmm_dualgather_sb", "XL k=32 bf16 kt32 g512", P_bf, sp_xl,
             X_xl_np)]:
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
            oracle = xl_want[id(rhs_np)]
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

    # slice 3: SpGEMM through the packed pair program, the skew route and
    # the octet/superblock/rowlane layouts of prepare_spmv
    def s3_pack(label, build):
        t = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        inner = getattr(out, "p_packed", getattr(out, "base", out))
        emit({"phase": "pack", "pack": label,
              "seconds": time.perf_counter() - t,
              "kind": type(out).__name__, "layout": type(inner).__name__,
              "fill": getattr(inner, "fill_rate", None),
              "bytes": container_bytes(out),
              "hub_rows_cols": ([int(out.hub_rows.numel()),
                                 int(out.hub_cols.numel())]
                                if hasattr(out, "hub_rows") else None)})
        return out

    t = time.perf_counter()
    xl_thread.join()  # drawn beside the build: ``seconds`` is the rest
    sa, sb = xl_operands["AB"]
    A_g = CSR.from_scipy(sa, device=dev)
    B_g = CSR.from_scipy(sb, device=dev)
    want_c = (sa.astype(np.float64) @ sb.astype(np.float64)).tocsr()
    want_c.sort_indices()
    want_ct = want_c.T.tocsr()
    want_ct.sort_indices()
    emit({"phase": "inputs", "matrix": "spgemm_xl", "shape": list(sa.shape),
          "nnz_a": int(sa.nnz), "nnz_b": int(sb.nnz), "c_nnz": int(want_c.nnz),
          "seconds": time.perf_counter() - t})
    pp_auto = s3_pack("spgemm_plan_packed XL auto, outputs csr+csc",
                      lambda: spgemm_plan_packed(A_g, B_g))
    pp_sb = s3_pack("spgemm_plan_packed XL superblock, outputs csc",
                    lambda: spgemm_plan_packed(A_g, B_g, layout="superblock",
                                               outputs=("csc",)))
    pp_rl = s3_pack("spgemm_plan_packed XL rowlane, outputs csc",
                    lambda: spgemm_plan_packed(A_g, B_g, layout="rowlane",
                                               outputs=("csc",)))
    pp_trim = s3_pack("spgemm_plan_packed XL octet trim_group=8, outputs csc",
                      lambda: spgemm_plan_packed(A_g, B_g, layout="octet",
                                                 outputs=("csc",),
                                                 trim_group=8))
    plans = {"b_perm": pp_auto.b_perm, "c_perm": pp_auto.c_perm}
    emit({"phase": "inputs", "plan": "spgemm_xl auto",
          "p_packed": type(pp_auto.p_packed).__name__,
          "vals": list(pp_auto.p_packed.vals.shape),
          "rem": pp_auto.p_packed.rem is not None,
          "trim_rem": pp_trim.p_packed.rem is not None,
          **{k: {"kind": type(v).__name__, "q": getattr(v, "q", None),
                 "R": getattr(v, "R", None)} for k, v in plans.items()}})
    if not (isinstance(pp_auto.p_packed, octmod.Octet)
            and isinstance(pp_sb.p_packed, sbmod.SellSuperblock)
            and isinstance(pp_rl.p_packed, rlmod.SellRowLane)
            and pp_trim.p_packed.rem is not None
            and all(isinstance(v, ClosPermutePlan) for v in plans.values())
            and want_c.nnz == pp_auto.c_nnz):
        failures.append("spgemm_xl plans are not the expected layouts")
    # the pair program P (the same for every layout) on the host, for the
    # oracle of its SpMV and the cuSPARSE yardstick
    sp_p = pack_to_scipy(pp_rl.p_packed, rlmod._slot_row_col)
    xb = {}  # B's values in each plan's column order
    for key, pp in (("auto", pp_auto), ("sb", pp_sb), ("rl", pp_rl),
                    ("trim", pp_trim)):
        xb[key] = apply_permutation(pp.b_perm, B_g.data)

    s3_cases = {}  # kernel -> [(case, run kernel, run plain, scipy matrix,
    #                            value bytes, x)]

    def s3_check(kname, case, pk, kern, plain, sp, x_dev, oracle):
        got = kern(pk, x_dev)
        want_plain = plain(pk, x_dev)
        torch.cuda.synchronize()
        errs[(kname, case)] = check(kname, case, got, want_plain, oracle,
                                    False)
        bf16 = pk.vals.dtype == torch.bfloat16
        s3_cases.setdefault(kname, []).append(
            (case, lambda: kern(pk, x_dev), lambda: plain(pk, x_dev), sp,
             2 if bf16 else 4, x_dev))
        del got, want_plain

    for kname, case, pk, key, kern, plain in [
            ("spmv_octet", "spgemm_xl P auto octet", pp_auto.p_packed, "auto",
             octmod._spmv_octet_cuda, octmod.spmv_octet_reference),
            ("spmv_octet", "spgemm_xl P octet trim_group=8 (rem)",
             pp_trim.p_packed, "trim", octmod._spmv_octet_cuda,
             octmod.spmv_octet_reference),
            ("spmv_superblock", "spgemm_xl P superblock", pp_sb.p_packed,
             "sb", sbmod._spmv_superblock_cuda,
             sbmod.spmv_superblock_reference),
            ("spmv_rowlane", "spgemm_xl P rowlane L=1", pp_rl.p_packed, "rl",
             rlmod._rowlane_forward, rlmod.spmv_sell_rowlane_reference)]:
        # C^T's values in CSC order are P @ x, row for row
        s3_check(kname, case, pk, kern, plain, sp_p, xb[key], want_ct.data)

    # bf16 values and L = 4 on the spgemm_xl A operand (16 entries a row)
    x_a = torch.from_numpy(np.random.default_rng(11).standard_normal(
        sa.shape[1]).astype(np.float32)).to(dev)
    oracle_a = bf16_rounded(sa) @ x_a.double().cpu().numpy()
    s3_check("spmv_rowlane", "spgemm_xl A rowlane L=4 bf16",
             rlmod.pack_sell_rowlane(A_g, lanes_per_row=4,
                                     dtype=torch.bfloat16),
             rlmod._rowlane_forward, rlmod.spmv_sell_rowlane_reference, sa,
             x_a, oracle_a)
    s3_check("spmv_superblock", "spgemm_xl A superblock bf16",
             sbmod.pack_superblock(A_g, dtype=torch.bfloat16),
             sbmod._spmv_superblock_cuda, sbmod.spmv_superblock_reference,
             sa, x_a, oracle_a)

    # the window permute on both Clos geometries of the main path: every
    # stage, kernel against plain, and the whole apply against x[g]
    wp_stage_inputs = {}
    for key, plan, gmap, n_src in [
            ("b_perm", pp_auto.b_perm, pp_auto.b_gather, B_g.capacity),
            ("c_perm", pp_auto.c_perm, pp_auto.c_gather, pp_auto.c_nnz)]:
        x_src = torch.from_numpy(np.random.default_rng(12).standard_normal(
            n_src).astype(np.float32)).to(dev)
        case = f"spgemm_xl {key} q={plan.q} R={plan.R}"
        got = clos_apply(plan, x_src)
        want_plain = clos_apply(plan, x_src, stage=window_permute_reference)
        torch.cuda.synchronize()
        xpad = np.concatenate([x_src.double().cpu().numpy(), [0.0]])
        oracle = xpad[np.minimum(gmap.long().cpu().numpy(), n_src)]
        errs[("window_permute", case)] = check(
            "window_permute", case, got, want_plain, oracle, False)
        if not torch.equal(got, want_plain):
            failures.append(f"check window_permute {case}: not bit-exact")
        wp_stage_inputs[key] = (case, plan)
        del got, want_plain

    # the skew route's matrices (bench/suite.py:794-813) and the clustered
    # low-degree one (suite.py:744-791)
    skew = {}
    for tag, col_zipf in (("rowzipf", False), ("hubcols", True)):
        t = time.perf_counter()
        sp_z = gen_zipf_csr(9, 32768, 32768, 32768 * 512, col_zipf=col_zipf)
        x_z = np.random.default_rng(9).standard_normal(32768).astype(
            np.float32)
        X_z = np.random.default_rng(10).standard_normal((32768, 32)).astype(
            np.float32)
        A_z = CSR.from_scipy(sp_z, device=dev)
        emit({"phase": "inputs", "matrix": f"spmv_skew {tag}",
              "shape": list(sp_z.shape), "nnz": int(sp_z.nnz),
              "max_row_deg": int(np.diff(sp_z.indptr).max()),
              "seconds": time.perf_counter() - t})
        # the skew pack alone, as the auto route builds it (the main path
        # packs again at its first call: ``seconds`` there includes it)
        s3_pack(f"spmv_skew {tag} pack_skew", lambda A_z=A_z: pack_skew(A_z))
        sp64 = sp_z.astype(np.float64)
        skew[tag] = (sp_z, A_z, torch.from_numpy(x_z).to(dev),
                     torch.from_numpy(X_z).to(dev), sp64 @ x_z, sp64 @ X_z)
    sp_clu, x_clu_np = clustered_matrix()
    A_clu = CSR.from_scipy(sp_clu, device=dev)
    x_clu = torch.from_numpy(x_clu_np).to(dev)
    y_clu = sp_clu.astype(np.float64) @ x_clu_np
    P_clu = {layout: s3_pack(f"clustered prepare_spmv layout={layout}",
                             lambda layout=layout: prepare_spmv(
                                 A_clu, layout=layout))
             for layout in ("octet", "superblock", "rowlane")}
    # row 15 on its octet pack too: a small pack (64 octets of ~6 slabs),
    # the bench row spmv_clustered/octet's
    s3_check("spmv_octet", "clustered octet (auto)", P_clu["octet"],
             octmod._spmv_octet_cuda, octmod.spmv_octet_reference, sp_clu,
             x_clu, y_clu)

    # slice 4: triangular solves.  The factors and plans of the JAX
    # bench's solver rows, each with its host seconds; each kernel against
    # its plain version (1e-4 of the output scale: the fp32 sums run in
    # another order and the recurrence carries each difference on) and a
    # float64 oracle
    from sparsematrix_tpu_torch.kernels import trisolve_fused as tfmod
    from sparsematrix_tpu_torch.kernels import trisolve_waves as twmod
    from sparsematrix_tpu_torch.ops import (ic0, ic0_fused_plans,
                                            ic0_waves_plans, ic_apply, ilu0,
                                            ilu0_fixpoint_plans,
                                            ilu0_waves_plans, ilu_apply,
                                            trisolve)
    from sparsematrix_tpu_torch.kernels import spmm_dualgather
    from sparsematrix_tpu_torch.solvers import block_cg, cg
    from sparsematrix_tpu_torch.utils.testutils import (poisson2d,
                                                        scattered_lower,
                                                        tri_oracle,
                                                        triangular)

    def s4_pack(label, build):
        t = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        first = out[0] if isinstance(out, tuple) else out
        emit({"phase": "pack", "pack": label,
              "seconds": time.perf_counter() - t,
              "kind": type(first).__name__,
              **{f: getattr(first, f) for f in ("mode", "K", "m", "n_waves",
                                                "S", "group", "n_levels",
                                                "nnz")
                 if hasattr(first, f)},
              "bytes": sum(solve_plan_bytes(p) if hasattr(p, "a1")
                           or hasattr(p, "aux") else container_bytes(p)
                           for p in (out if isinstance(out, tuple)
                                     else (out,)))})
        return out

    t = time.perf_counter()
    n_po, po_sp = poisson2d(65536)
    po32 = po_sp.astype(np.float32).tocsr()
    A_po = CSR.from_scipy(po32, device=dev)
    n_po2, po2_sp = poisson2d(512 * 512)
    A_po2 = CSR.from_scipy(po2_sp.astype(np.float32).tocsr(), device=dev)
    sc_sp, sc_b = scattered_lower()
    A_sc = CSR.from_scipy(sc_sp, device=dev)
    U_sc_sp = sc_sp.T.tocsr()
    band_sp = triangular(512 * 512, 3, band=380, seed=5)
    emit({"phase": "inputs", "matrix": "slice 4", "seconds":
          time.perf_counter() - t, "poisson_n": n_po, "poisson2_n": n_po2,
          "scattered_nnz": int(sc_sp.nnz), "band_nnz": int(band_sp.nnz)})
    L_ic = s4_pack("ic0 Poisson 256^2", lambda: ic0(A_po))
    L_ilu, U_ilu = s4_pack("ilu0 Poisson 256^2", lambda: ilu0(A_po))
    L_ic2 = s4_pack("ic0 Poisson 512^2", lambda: ic0(A_po2))
    Lic_sp = L_ic.to_scipy()
    Lic2_sp = L_ic2.to_scipy()
    LicT = CSR.from_scipy(Lic_sp.T.tocsr(), device=dev)
    Lic2T = CSR.from_scipy(Lic2_sp.T.tocsr(), device=dev)
    wp = twmod.trisolve_waves_plan
    fp = tfmod.trisolve_fused_plan
    P_icL = s4_pack("waves ic0 L 256^2", lambda: wp(L_ic))
    P_icU = s4_pack("waves ic0 L^T 256^2", lambda: wp(LicT, lower=False))
    P_iluL = s4_pack("waves ilu0 L 256^2 (unit)",
                     lambda: wp(L_ilu, unit_diagonal=True))
    P_iluU = s4_pack("waves ilu0 U 256^2", lambda: wp(U_ilu, lower=False))
    P_icL16 = s4_pack("waves ic0 L 256^2 bf16",
                      lambda: wp(L_ic, dtype=torch.bfloat16))
    P_ic2L = s4_pack("waves ic0 L 512^2", lambda: wp(L_ic2))
    P_ic2U = s4_pack("waves ic0 L^T 512^2", lambda: wp(Lic2T, lower=False))
    P_band = s4_pack("waves band n=262144",
                     lambda: wp(CSR.from_scipy(band_sp, device=dev)))
    P_scL = s4_pack("waves scattered L n=65536", lambda: wp(A_sc))
    P_scU = s4_pack("waves scattered L^T n=65536 (upper)",
                    lambda: wp(CSR.from_scipy(U_sc_sp, device=dev),
                               lower=False))
    F_icL = s4_pack("fused ic0 L 256^2", lambda: fp(L_ic))
    F_icU = s4_pack("fused ic0 L^T 256^2", lambda: fp(LicT, lower=False))
    if not (P_icL.mode == "chain" and P_icL.K == 2 and P_ic2L.mode == "binv"
            and P_ic2L.m == 8 and P_band.mode == "chain"
            and P_band.n_waves == 256 and P_scL.mode == "binv"
            and P_scU.reversed):
        failures.append("slice 4 plans are not the expected modes")

    tri_cases = {}  # kernel -> [(case, run, run plain, plan, sp, lower, rhs)]

    def tri_check(kname, case, plan, sp, lower, unit, k=0, quantized=False,
                  b_np=None):
        n = sp.shape[0]
        rng = np.random.default_rng(n + len(case))
        if b_np is None:
            b_np = rng.standard_normal((n, k) if k else n).astype(np.float32)
        b_dev = torch.from_numpy(b_np).to(dev)
        if kname == "trisolve_fused":
            kern, plain = tfmod.trisolve_fused_apply, tfmod.fused_forward_plain
        elif k:
            kern, plain = twmod.trisolve_waves_apply_mm, twmod.mm_forward_plain
        else:
            kern, plain = twmod.trisolve_waves_apply, twmod.waves_forward_plain
        got = kern(plan, b_dev)
        want = plain(plan, b_dev)
        torch.cuda.synchronize()
        got64 = got.double().cpu().numpy()
        err = float(np.abs(got64 - want.double().cpu().numpy()).max())
        scale = float(want.abs().max())
        oracle = tri_oracle(sp, b_np, lower, unit)
        policy = quantized_check if quantized else relative_check
        oracle_ok = bool(policy(got64, oracle))
        ok = (err <= 1e-4 * scale and oracle_ok
              and bool(np.isfinite(got64).all()))
        steps = (plan.aux.shape[0] if kname == "trisolve_fused"
                 else plan.n_waves if kname == "trisolve_binv" else plan.S)
        extra = ({"waves": tfmod.fused_walk(plan).n_waves}
                 if kname == "trisolve_fused" else {})
        emit({"phase": "check", "kernel": kname, "case": case,
              "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
              "tol": 1e-4 * scale, "oracle_check": oracle_ok,
              "dependent_steps": int(steps), **extra, "ok": ok})
        if not ok:
            failures.append(f"check {kname} {case}")
        errs[(kname, case)] = err
        tri_cases.setdefault(kname, []).append(
            (case, lambda: kern(plan, b_dev), lambda: plain(plan, b_dev),
             plan, sp, lower, unit, b_dev))
        del got, want

    ch, bv = "trisolve_chain", "trisolve_binv"
    for kname, case, plan, sp, lower, unit, q in [
            (ch, "ic0 L Poisson 256^2 (K=2)", P_icL, Lic_sp, True, False,
             False),
            (ch, "ic0 L^T Poisson 256^2 (upper, reversed)", P_icU,
             Lic_sp.T.tocsr(), False, False, False),
            (ch, "ilu0 L Poisson 256^2 (unit)", P_iluL, L_ilu.to_scipy(),
             True, True, False),
            (ch, "ilu0 U Poisson 256^2", P_iluU, U_ilu.to_scipy(), False,
             False, False),
            (ch, "ic0 L Poisson 256^2 bf16 plan", P_icL16, Lic_sp, True,
             False, True),
            (bv, "ic0 L Poisson 512^2 (K=4, m=8)", P_ic2L, Lic2_sp, True,
             False, False),
            (bv, "ic0 L^T Poisson 512^2 (upper, reversed)", P_ic2U,
             Lic2_sp.T.tocsr(), False, False, False),
            (ch, "band n=262144 (K=3, 256 waves)", P_band, band_sp, True,
             False, False),
            (bv, "scattered L n=65536 8/row (m=8)", P_scL, sc_sp, True,
             False, False),
            (bv, "scattered L^T n=65536 (upper, reversed)", P_scU, U_sc_sp,
             False, False, False)]:
        tri_check(kname, case, plan, sp, lower, unit, quantized=q,
                  b_np=sc_b if plan is P_scL else None)
    for k_mm in (8, 12):
        tri_check("trisolve_chain_mm", f"ic0 L Poisson 256^2 k={k_mm}",
                  P_icL, Lic_sp, True, False, k=k_mm)
    tri_check("trisolve_fused", "fused ic0 L Poisson 256^2", F_icL, Lic_sp,
              True, False)
    tri_check("trisolve_fused", "fused ic0 L^T Poisson 256^2 (upper)", F_icU,
              Lic_sp.T.tocsr(), False, False)
    # the 1024² IC(0) factor: n = 2^20 > 524288, where trisolve() takes the
    # fused engine (its main path below); row 18 on its plan (2047 waves)
    t = time.perf_counter()
    n_po3, po3_sp = poisson2d(1024 * 1024)
    A_po3 = CSR.from_scipy(po3_sp.astype(np.float32).tocsr(), device=dev)
    emit({"phase": "inputs", "matrix": "Poisson 1024^2", "n": n_po3,
          "seconds": time.perf_counter() - t})
    L_ic3 = s4_pack("ic0 Poisson 1024^2", lambda: ic0(A_po3))
    Lic3_sp = L_ic3.to_scipy()
    F_ic3 = s4_pack("fused ic0 L 1024^2", lambda: fp(L_ic3))
    tri_check("trisolve_fused", FUSED_1024, F_ic3, Lic3_sp, True, False)
    del P_ic2U, P_band  # 2 GB of plans; the timings keep the rest
    tri_cases[bv] = [c for c in tri_cases[bv] if "512^2 (upper" not in c[0]]
    tri_cases[ch] = [c for c in tri_cases[ch] if "band" not in c[0]]

    # slice 5: octet SpMM (row 16), the pooled spill tail (row 12) and the
    # SELL kernels (rows 5 and 6) at the JAX bench's shapes, each pack
    # with its host seconds; each kernel against its plain version and a
    # float64 oracle
    selmod = importlib.import_module(
        "sparsematrix_tpu_torch.kernels.spmv_sell")
    mark("check, slices 1-4")
    s5_cases = {}  # kernel -> [(case, run, run plain, scipy matrix,
    #                            right-hand side, extras); fp32 values

    def s5_pack(label, build):
        t = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        tail = getattr(out, "tail", None)
        emit({"phase": "pack", "pack": label,
              "seconds": time.perf_counter() - t, "kind": type(out).__name__,
              "fill": out.fill_rate, "bytes": container_bytes(out),
              "tail_nnz": tail.nnz if tail is not None else None,
              "rem": getattr(out, "rem", None) is not None})
        return out

    def s5_check(kname, case, kern, plain, sp, rhs, **extra):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        oracle = sp.astype(np.float64) @ rhs.double().cpu().numpy()
        errs[(kname, case)] = check(kname, case, got, want, oracle, False)
        s5_cases.setdefault(kname, []).append(
            (case, kern, plain, sp, rhs, extra))
        del got, want

    # rows 5 and 6: the bench's csr_spmv sell and rowpure rows at n = 4096
    # (suite.py:184-222) and the XL CSR
    sell_in = {}
    for tag, per_row, seed in (("128/row", 128, 13), ("64/row", 64, 14)):
        sp_s, x_s = random_matrix(4096, per_row, seed=seed)
        sell_in[tag] = (sp_s, CSR.from_scipy(sp_s, device=dev),
                        torch.from_numpy(x_s).to(dev))
    S_packs = {
        "sell n=4096 128/row tr=64": (
            "spmv_sell", sell_in["128/row"],
            lambda: selmod.pack_sell(sell_in["128/row"][1], tr=64)),
        "rowpure n=4096 64/row R=16": (
            "spmv_sell_rowpure", sell_in["64/row"],
            lambda: selmod.pack_sell_rowpure(sell_in["64/row"][1], group=4,
                                             rows_per_sublane=16)),
        "rowpure n=4096 128/row R=8": (
            "spmv_sell_rowpure", sell_in["128/row"],
            lambda: selmod.pack_sell_rowpure(sell_in["128/row"][1], group=4,
                                             rows_per_sublane=8)),
        "sell XL tr=64": ("spmv_sell", (sp_xl, A_xl, x_xl),
                          lambda: selmod.pack_sell(A_xl, tr=64)),
        "rowpure XL group=4 R=16": (
            "spmv_sell_rowpure", (sp_xl, A_xl, x_xl),
            lambda: selmod.pack_sell_rowpure(A_xl, group=4,
                                             rows_per_sublane=16)),
    }
    sell_main = []  # (case, pack, x, scipy, kernel)
    for case, (kname, (sp_s, A_s, x_s), build) in S_packs.items():
        P = s5_pack(case, build)
        kern = (selmod._spmv_sell_cuda if kname == "spmv_sell"
                else selmod._spmv_sell_rowpure_cuda)
        plain = (selmod.spmv_sell_reference if kname == "spmv_sell"
                 else selmod.spmv_sell_rowpure_reference)
        s5_check(kname, case, lambda P=P, x=x_s, f=kern: f(P, x),
                 lambda P=P, x=x_s, f=plain: f(P, x), sp_s, x_s,
                 sell=P if kname == "spmv_sell" else None)
        sell_main.append((case, P, x_s, sp_s, kname))

    # row 12: the XL CSR with the "auto" spill cap (mean row-window
    # degree ~16: cap 16) at k_tiles 1 and 8; the tail kernel alone at
    # k = 1 and 32 against the tail's own entries, and the whole packs
    # (body kernel, then the tail) against the XL oracle
    P_sp1 = s5_pack("XL prepare_spmv(dualgather, spill_cap=auto) k_tiles=1",
                    lambda: prepare_spmv(A_xl, layout="dualgather",
                                         spill_cap="auto"))
    P_sp8 = s5_pack("XL prepare_spmv(dualgather, spill_cap=auto) k_tiles=8",
                    lambda: prepare_spmv(A_xl, layout="dualgather",
                                         spill_cap="auto", k_tiles=8))
    if P_sp1.tail is None or P_sp8.tail is None:
        failures.append("the XL spill_cap=auto packs formed no tail")
    tail8 = P_sp8.tail
    sp_tail = pack_to_scipy(tail8, dgmod._slot_row_col_pooled)

    def run_tail(X, tail=tail8):
        Y = torch.zeros((tail.shape[0], X.shape[1]), dtype=torch.float32,
                        device=X.device)
        dgmod.launch_pooled(tail, X, Y)
        return Y

    for k_rhs, rhs in ((1, x_xl[:, None]), (32, X_xl)):
        s5_check("spmv_pooled",
                 f"XL tail (spill_cap=auto) k_tiles=8 k={k_rhs}",
                 lambda rhs=rhs: run_tail(rhs),
                 lambda rhs=rhs: dgmod.pooled_plain(tail8, rhs), sp_tail, rhs,
                 tail=tail8)
    for case, got_fn, plain_fn, want in [
            ("XL spill k_tiles=1 spmv (body + tail)",
             lambda: dgmod._spmv_dualgather_cuda(P_sp1, x_xl),
             lambda: dgmod.spmv_dualgather_reference(P_sp1, x_xl),
             y_xl_want),
            ("XL spill k_tiles=8 spmv (body + tail)",
             lambda: dgmod._spmv_dualgather_cuda(P_sp8, x_xl),
             lambda: dgmod.spmv_dualgather_reference(P_sp8, x_xl),
             y_xl_want),
            ("XL spill k_tiles=8 spmm k=32 (body + tail)",
             lambda: _spmm_dualgather_cuda(P_sp8, X_xl),
             lambda: spmm_dualgather_reference(P_sp8, X_xl), Y_xl_want)]:
        got, want_plain = got_fn(), plain_fn()
        torch.cuda.synchronize()
        errs[("spmv_pooled", case)] = check("spmv_pooled", case, got,
                                            want_plain, want, False)
        del got, want_plain

    # row 16: the bench's spmm_xl/octet-mm matrix, the clustered CSR's
    # octet pack and the spgemm_xl pair program's trim pack (rem), k = 32;
    # the k_tiles=1 dual-gather walk on the same matrix beside it
    t = time.perf_counter()
    sp_omm, X_omm_np = octet_mm_matrix()
    A_omm = CSR.from_scipy(sp_omm, device=dev)
    X_omm = torch.from_numpy(X_omm_np).to(dev)
    X_clu = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (sp_clu.shape[1], 32)).astype(np.float32)).to(dev)
    X_p = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (sp_p.shape[1], 32)).astype(np.float32)).to(dev)
    emit({"phase": "inputs", "matrix": "spmm_xl octet-mm",
          "shape": list(sp_omm.shape), "nnz": int(sp_omm.nnz),
          "seconds": time.perf_counter() - t})
    P_omm = s5_pack("spmm_xl octet-mm pack_octet", lambda: octmod.pack_octet(
        A_omm))
    W_omm = s5_pack("spmm_xl octet-mm pack_dualgather k_tiles=1",
                    lambda: dgmod.pack_dualgather(A_omm, k_tiles=1))
    W_clu = s5_pack("clustered pack_dualgather k_tiles=1",
                    lambda: dgmod.pack_dualgather(A_clu, k_tiles=1))
    for case, P, X, sp_o, walk in [
            ("spmm_xl octet-mm k=32", P_omm, X_omm, sp_omm, W_omm),
            ("clustered octet (auto) k=32", P_clu["octet"], X_clu, sp_clu,
             W_clu),
            ("spgemm_xl P octet trim_group=8 (rem) k=32", pp_trim.p_packed,
             X_p, sp_p, None)]:
        s5_check("spmm_octet", case,
                 lambda P=P, X=X: octmod._spmm_octet_cuda(P, X),
                 lambda P=P, X=X: octmod.spmm_octet_reference(P, X), sp_o, X,
                 walk=walk)
    if pp_trim.p_packed.rem is None:
        failures.append("the spgemm_xl trim pack has no rem section")
    mark("check, slice 5")

    # slice 6: the BSR kernels.  Row 3 (grouped) and row 4 (panel) against
    # their plain versions on the card (1e-5 of the output scale; bf16: one
    # bf16 step) and an fp64 host oracle, at the JAX bench's bsr point
    # (n = 2048, (8, 8), d = 0.05, k = 128), at (4, 4), at (128, 128) on
    # n = 16384 (10 % of the block slots), on a BSR with capacity padding
    # and an empty block-row, on the XL BSR (n = 32768, (8, 8), block
    # density 0.0078, k = 128), at bf16, and row 4 at the shape block CG
    # gives it on the main path (block_cg_xl's Poisson system as a (8, 8)
    # BSR, 5 blocks a block-row, k = 8)
    from sparsematrix_tpu_torch.formats import csr_to_bsr
    from sparsematrix_tpu_torch.kernels import bsr as kb

    def s6_bsr(label, build):
        t = time.perf_counter()
        A = build()
        torch.cuda.synchronize()
        emit({"phase": "pack", "pack": label,
              "seconds": time.perf_counter() - t, "kind": "BSR",
              "block_shape": list(A.block_shape), "num_blocks": A.num_blocks,
              "block_capacity": A.block_capacity, "nnz": A.nnz})
        return A

    dense_bb, Xbb_np = bench_bsr_dense()
    A_bb = s6_bsr("bsr bench (8,8) csr_to_bsr", lambda: csr_to_bsr(
        CSR.fromdense(dense_bb, device=dev), (8, 8)))
    X_bb = torch.from_numpy(Xbb_np).to(dev)
    dense_b4, Xb4_np = bench_bsr_dense(block=(4, 4))
    A_b4 = s6_bsr("bsr bench (4,4) csr_to_bsr", lambda: csr_to_bsr(
        CSR.fromdense(dense_b4, device=dev), (4, 4)))
    X_b4 = torch.from_numpy(Xb4_np).to(dev)
    dense_pad = dense_bb.copy()
    dense_pad[8:16] = 0  # an empty block-row
    A_pad = s6_bsr("bsr bench (8,8) empty row, capacity +1000",
                   lambda: csr_to_bsr(CSR.fromdense(dense_pad, device=dev),
                                      (8, 8), block_capacity=A_bb.num_blocks
                                      + 1000))
    A_big = s6_bsr("bsr (128,128) n=16384 d=0.1 csr_to_bsr", lambda: csr_to_bsr(
        CSR.from_scipy(block_sparse_scipy(16384, (128, 128), 0.1, 30),
                       device=dev), (128, 128)))
    X_big = torch.from_numpy(gen_matrix_random(
        np.random.default_rng(31), 16384, 128)).to(dev)
    # row 3's tile design at other block shapes, the same n and density
    A_64 = s6_bsr("bsr (64,64) n=16384 d=0.1 csr_to_bsr", lambda: csr_to_bsr(
        CSR.from_scipy(block_sparse_scipy(16384, (64, 64), 0.1, 34),
                       device=dev), (64, 64)))
    A_32 = s6_bsr("bsr (32,128) n=16384 d=0.1 csr_to_bsr", lambda: csr_to_bsr(
        CSR.from_scipy(block_sparse_scipy(16384, (32, 128), 0.1, 35),
                       device=dev), (32, 128)))
    A_xb = s6_bsr("bsr XL (8,8) n=32768 d=0.0078 csr_to_bsr", lambda:
                  csr_to_bsr(CSR.from_scipy(block_sparse_scipy(
                      32768, (8, 8), 0.0078, 32), device=dev), (8, 8)))
    X_xb = torch.from_numpy(gen_matrix_random(
        np.random.default_rng(33), 32768, 128)).to(dev)
    X_xb8 = X_xb[:, :8].contiguous()  # row 4's narrow design on the XL
    X_xb32 = X_xb[:, :32].contiguous()
    P_bb = kb.pack_bsr_panels(A_bb)
    P_pad = kb.pack_bsr_panels(A_pad)
    t = time.perf_counter()
    P_xb = kb.pack_bsr_panels(A_xb)
    torch.cuda.synchronize()
    emit({"phase": "pack", "pack": "bsr XL pack_bsr_panels",
          "seconds": time.perf_counter() - t, "M": P_xb.bcols.shape[1],
          "panel_fill": A_xb.num_blocks / P_xb.bcols.numel()})
    A_pob = s6_bsr("block_cg_xl Poisson 256^2 (8,8) csr_to_bsr",
                   lambda: csr_to_bsr(A_po, (8, 8)))
    # block_cg_xl's right-hand sides (the main path's B_bc)
    X_pob = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n_po, 8)).astype(np.float32)).to(dev)
    P_pob = kb.pack_bsr_panels(A_pob)
    A_bb16 = A_bb.astype(torch.bfloat16)
    X_bb16 = X_bb.to(torch.bfloat16)
    P_bb16 = kb.pack_bsr_panels(A_bb16)
    s6_cases = {"spmm_bsr": [], "spmm_bsr_panel": []}
    for kname, case, A_c, P_c, X_c in [
            ("spmm_bsr", "bench (8,8) k=128", A_bb, None, X_bb),
            ("spmm_bsr", "bench (4,4) k=128", A_b4, None, X_b4),
            ("spmm_bsr", "(128,128) n=16384 k=128", A_big, None, X_big),
            ("spmm_bsr", "(64,64) n=16384 k=128", A_64, None, X_big),
            ("spmm_bsr", "(32,128) n=16384 k=128", A_32, None, X_big),
            ("spmm_bsr", "bench (8,8) empty row, capacity +1000", A_pad,
             None, X_bb),
            ("spmm_bsr", "bench (8,8) bf16 k=128", A_bb16, None, X_bb16),
            ("spmm_bsr_panel", "bench (8,8) k=128", A_bb, P_bb, X_bb),
            ("spmm_bsr_panel", "bench (8,8) empty row, capacity +1000",
             A_pad, P_pad, X_bb),
            ("spmm_bsr_panel", "XL (8,8) k=128", A_xb, P_xb, X_xb),
            ("spmm_bsr_panel", "XL (8,8) k=8", A_xb, P_xb, X_xb8),
            ("spmm_bsr_panel", "XL (8,8) k=32", A_xb, P_xb, X_xb32),
            ("spmm_bsr_panel", "bench (8,8) bf16 k=128", A_bb16, P_bb16,
             X_bb16),
            ("spmm_bsr_panel", "block_cg_xl Poisson (8,8) k=8", A_pob, P_pob,
             X_pob)]:
        if P_c is None:
            kern = (lambda A_c=A_c, X_c=X_c: kb._spmm_bsr_cuda(A_c, X_c))
            plain = (lambda A_c=A_c, X_c=X_c:
                     kb.spmm_bsr_grouped_reference(A_c, X_c))
        else:
            kern = (lambda P_c=P_c, X_c=X_c: kb._spmm_bsr_panel_cuda(P_c, X_c))
            plain = (lambda P_c=P_c, X_c=X_c:
                     kb.spmm_bsr_panel_reference(P_c, X_c))
        got, want_plain = kern(), plain()
        torch.cuda.synchronize()
        oracle_b = bsr_oracle(A_c, X_c.double().cpu().numpy())
        errs[(kname, case)] = check(kname, case, got, want_plain, oracle_b,
                                    X_c.dtype == torch.bfloat16)
        s6_cases[kname].append((case, kern, plain, A_c, X_c))
        del got, want_plain, oracle_b
    mark("check, slice 6")

    # slice 7: row 8 (the row-lane SpMM) against its plain version on the
    # card (1e-5 of the output scale) and an fp64 oracle, at the JAX
    # bench's spmm_csr/rowlane point (n = 2048, d = 0.05, k = 32,
    # default_rng(1), its auto-group pack; suite.py:337-342, :386-405) and
    # at the shape the main path gives it: the XL CSR packed by
    # partition_rowlane for one rank (group 32), k = 32, with fp32 values
    # and with bf16 values (against the oracle of the bf16-rounded values)
    par = importlib.import_module("sparsematrix_tpu_torch.parallel")
    drl = importlib.import_module(
        "sparsematrix_tpu_torch.parallel.dist_rowlane")
    from sparsematrix_tpu_torch.kernels.spmm_rowlane import (
        _spmm_rowlane_cuda, spmm_rowlane_reference)

    rng_rl = np.random.default_rng(1)
    dense_rl = gen_random_dense_sparse(rng_rl, 2048, 2048, density=0.05)
    X_rl = torch.from_numpy(gen_matrix_random(rng_rl, 2048, 32)).to(dev)
    A_rl = CSR.fromdense(dense_rl, device=dev)
    P_rl = s4_pack("spmm_csr/rowlane bench pack_sell_rowlane",
                   lambda: rlmod.pack_sell_rowlane(A_rl))
    part_xl = s4_pack("XL partition_rowlane(1 rank, group 32)",
                      lambda: par.partition_rowlane(A_xl, 1))
    part_xl = dataclasses.replace(part_xl, **{
        f: getattr(part_xl, f).to(dev) for f in part_xl._data_fields})
    P_rlx = drl.local_sell(part_xl, part_xl)
    P_rlx16 = dataclasses.replace(P_rlx, vals=P_rlx.vals.to(torch.bfloat16))
    for label, P_c in (("bench", P_rl), ("XL", P_rlx)):
        emit({"phase": "pack", "pack": f"rowlane {label} planes",
              "n_slabs": P_c.n_slabs, "group": P_c.group,
              "fill_rate": P_c.fill_rate if label == "bench"
              else A_xl.nnz / P_c.vals.numel(),
              "plane_bytes": container_bytes(P_c)})
    sp_rl = A_rl.to_scipy()
    # row 8 at XL k = 8 and 64: the window walk's narrow panel and its
    # two passes
    X_xl8, X_xl64 = (torch.from_numpy(np.random.default_rng(k).standard_normal(
        (sp_xl.shape[1], k)).astype(np.float32)).to(dev) for k in (8, 64))
    s7_cases = []
    for case, P_c, sp_c, X_c, bf in [
            ("bench n=2048 d=0.05 k=32", P_rl, sp_rl, X_rl, False),
            ("XL k=32 (partition_rowlane, 1 rank)", P_rlx, sp_xl, X_xl,
             False),
            ("XL k=32 bf16 values", P_rlx16, sp_xl, X_xl, True),
            ("XL k=8 (partition_rowlane, 1 rank)", P_rlx, sp_xl, X_xl8,
             False),
            ("XL k=64 (partition_rowlane, 1 rank)", P_rlx, sp_xl, X_xl64,
             False)]:
        got = _spmm_rowlane_cuda(P_c, X_c)
        want_plain = spmm_rowlane_reference(P_c, X_c)
        torch.cuda.synchronize()
        X64 = X_c.double().cpu().numpy()
        oracle_rl = (Y_xl_want if sp_c is sp_xl and not bf and X_c is X_xl
                     else
                     (bf16_rounded(sp_c) if bf else sp_c.astype(np.float64))
                     @ X64)
        errs[("spmm_rowlane", case)] = check("spmm_rowlane", case, got,
                                             want_plain, oracle_rl, False)
        s7_cases.append((case, P_c, X_c, sp_c, 2 if bf else 4))
        del got, want_plain, oracle_rl
    mark("check, slice 7")

    # slice 8: row 22 (the stream copy) against its plain version, bit for
    # bit, at odd lengths, the calibrate row's 128 MiB and the cross-check
    # probe's 256 MiB, each also as a view that starts one element past a
    # 16-byte boundary
    for n_el in (1, 3, 4097, MIB128, 2 * MIB128):
        base = torch.randn(n_el + 1, device=dev)
        for label, x_c in (("aligned", base[:n_el]), ("view at +1", base[1:])):
            got = _stream_copy_cuda(x_c)
            want_plain = stream_copy_reference(x_c)
            torch.cuda.synchronize()
            eq = bool(torch.equal(got, want_plain))
            err = float((got - want_plain).abs().max())
            case = f"n={n_el} {label}"
            errs[("stream_copy", case)] = err
            emit({"phase": "check", "kernel": "stream_copy", "case": case,
                  "max_abs_err": err, "bit_equal": eq, "ok": eq})
            if not eq:
                failures.append(f"check stream_copy {case}")
        del base, got, want_plain
    mark("check, slice 8")

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
        # a codebook container takes the lookup + one product (the JAX
        # route): the fused kernel (row 1) must not launch there
        ok = ok and counts["codebook_spmm"] == 0 and (
            counts["spmm_blocked_ell"] > 0) == ("BlockedELL" in name)
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
    # slice 3: the SpGEMM numeric phase on each pair-program layout, the
    # one-shot spgemm (its planning included in ``seconds``), spmv/spmm on
    # the power-law matrices and spmv on the clustered one (first calls
    # pack)
    s3_paths = [
        ("spgemm_apply_packed XL auto (octet), CSR out",
         lambda: spgemm_apply_packed(pp_auto, B_g.data).data, want_c.data,
         ("spmv_octet", "window_permute")),
        ("spgemm_apply_packed_csc XL auto (octet)",
         lambda: spgemm_apply_packed_csc(pp_auto, B_g.data).data,
         want_ct.data, ("spmv_octet", "window_permute")),
        ("spgemm_apply_packed_csc XL superblock",
         lambda: spgemm_apply_packed_csc(pp_sb, B_g.data).data, want_ct.data,
         ("spmv_superblock", "window_permute")),
        ("spgemm_apply_packed_csc XL rowlane",
         lambda: spgemm_apply_packed_csc(pp_rl, B_g.data).data, want_ct.data,
         ("spmv_rowlane", "window_permute")),
        ("spgemm(A, B, output='csc') XL",
         lambda: spgemm(A_g, B_g, output="csc").data, want_ct.data,
         ("spmv_octet", "window_permute")),
    ]
    for tag, (sp_z, A_z, x_z, X_z, y_want, Y_want) in skew.items():
        s3_paths += [
            (f"spmv spmv_skew {tag} (auto)",
             lambda A_z=A_z, x_z=x_z: spmv(A_z, x_z), y_want,
             ("spmv_dualgather_sb", "window_permute")),
            (f"spmm spmv_skew {tag} k=32 (auto)",
             lambda A_z=A_z, X_z=X_z: spmm(A_z, X_z), Y_want,
             ("spmm_dualgather_sb",))]
    s3_paths += [
        ("spmv(prepare_spmv(clustered)) (auto: octet)",
         lambda: spmv(prepare_spmv(A_clu), x_clu), y_clu, ("spmv_octet",))]
    s3_paths += [
        (f"spmv prepare_spmv(clustered, layout={layout})",
         lambda P=P: spmv(P, x_clu), y_clu, (kname,))
        for layout, P, kname in (
            ("octet", P_clu["octet"], "spmv_octet"),
            ("superblock", P_clu["superblock"], "spmv_superblock"),
            ("rowlane", P_clu["rowlane"], "spmv_rowlane"))]
    for name, run, want, expect in s3_paths:
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
              and relative_check(y64, want)
              and all(counts[kn] > 0 for kn in expect))
        emit({"phase": "main_path", "path": name, "shape": list(y.shape),
              "seconds": seconds, "launches": counts, "oracle_check": ok,
              "ok": ok})
        if not ok:
            failures.append(f"main path {name}")
        del y
    # slice 4: the JAX bench's solver rows (suite.py:1463-1566, 1719-1830)
    # through cg / block_cg with the preconditioners, and the one-shot
    # trisolve; each run must reach tol with a true residual within
    # 10·tol·‖b‖, and each preconditioned CG run must take at most 0.6×
    # plain CG's iterations (the bench's checks, suite.py:1526-1535)
    cg_cells = {}  # (cell, variant) -> (operator, b, M, maxiter)

    def s4_run(name, run, expect):
        _build.launch_counts.clear()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = {kn: _build.launch_counts[kn] for kn in _build.KERNELS}
        for kn, v in counts.items():
            main_launches[kn] += v
        launched = all(any(counts[kn] > 0 for kn in alt) for alt in expect)
        return out, seconds, counts, launched

    dg_spmv = ("spmv_dualgather", "spmv_dualgather_sb")
    fix_plans = None
    for cell, eps, maxiter, variants in [
            ("ilu_cg_xl", 1.0, 6000,
             ("ilu0-fix6", "ilu0-waves", "ic0-waves", "ic0-fused")),
            ("ilu_cg_aniso", 1000.0, 12000, ("ic0-waves", "ic0-waves-bf16"))]:
        n_c, sp_c = poisson2d(65536, eps)
        A_c = CSR.from_scipy(sp_c.astype(np.float32).tocsr(), device=dev)
        b_np = np.random.default_rng(8).standard_normal(n_c).astype(
            np.float32)
        b_c = torch.from_numpy(b_np).to(dev)
        b_norm = float(np.linalg.norm(b_np))
        Ap = s4_pack(f"{cell} prepare_spmv", lambda: prepare_spmv(A_c))
        builders = {
            "ilu0-fix6": (lambda: ilu0_fixpoint_plans(A_c, n_iters=6),
                          ilu_apply, ("spmv_rowlane",)),
            "ilu0-waves": (lambda: ilu0_waves_plans(A_c), ilu_apply,
                           ("trisolve_chain",)),
            "ic0-waves": (lambda: ic0_waves_plans(A_c), ic_apply,
                          ("trisolve_chain",)),
            "ic0-waves-bf16": (lambda: ic0_waves_plans(
                A_c, dtype=torch.bfloat16), ic_apply, ("trisolve_chain",)),
            "ic0-fused": (lambda: ic0_fused_plans(A_c), ic_apply,
                          ("trisolve_fused",))}
        plain_iters = None
        for label in ("plain",) + variants:
            M, expect = None, ()
            if label != "plain":
                build, apply_, expect = builders[label]
                plans = s4_pack(f"{cell} {label} plans", build)
                M = (lambda r, plans=plans, apply_=apply_: apply_(plans, r))
                if (cell, label) == ("ilu_cg_xl", "ilu0-fix6"):
                    fix_plans = plans  # row 7's packs in phase 5
            cg_cells[(cell, label)] = (Ap, b_c, M, maxiter)
            res, seconds, counts, launched = s4_run(
                f"{cell}/{label}",
                lambda: cg(Ap, b_c, tol=1e-5, maxiter=maxiter, M=M),
                (dg_spmv,) + ((expect,) if expect else ()))
            x64 = res.x.double().cpu().numpy()
            true_res = float(np.linalg.norm(sp_c @ x64 - b_np))
            reached = (float(res.residual) <= 1e-5 * b_norm * 1.001
                       and res.iters < maxiter)
            certified = true_res <= 10 * 1e-5 * b_norm
            # fp32 plain CG on the stiff ilu_cg_aniso system reaches tol
            # by its recurrence, but its true residual drifts above
            # 10·tol (the JAX bench's plain row there reads
            # checked=False): that run is the iteration baseline, and its
            # certification is reported
            baseline_only = label == "plain" and cell == "ilu_cg_aniso"
            ok = (reached and (certified or baseline_only) and launched
                  and bool(np.isfinite(x64).all()))
            if label == "plain":
                plain_iters = res.iters
            else:
                ok = ok and res.iters <= 0.6 * plain_iters
            cg_cells[(cell, label)] += (res.iters,)
            emit({"phase": "main_path", "path": f"cg {cell}/{label}",
                  "n": n_c, "eps": eps, "iters_to_tol": res.iters,
                  "plain_iters": plain_iters, "reached_tol": reached,
                  "true_rel_residual": true_res / b_norm,
                  "certified": certified,
                  "seconds": seconds, "launches": counts, "ok": ok})
            if not ok:
                failures.append(f"main path cg {cell}/{label}")
            del res

    # block_cg_xl: k = 8 right-hand sides, the k_tiles=1 dual-gather walk
    # as the operator (suite.py:1719-1784)
    B_np = np.random.default_rng(9).standard_normal((n_po, 8)).astype(
        np.float32)
    B_bc = torch.from_numpy(B_np).to(dev)
    bn_bc = np.linalg.norm(B_np, axis=0)
    S_bc = s4_pack("block_cg_xl pack_dualgather k_tiles=1",
                   lambda: dgmod.pack_dualgather(A_po, k_tiles=1))
    plans_bc = s4_pack("block_cg_xl ic0-waves plans",
                       lambda: ic0_waves_plans(A_po))
    block_cells = {}
    for label, M in (("block-plain", None),
                     ("block-ic0-waves",
                      lambda R: ic_apply(plans_bc, R))):
        mm = lambda V: spmm_dualgather(S_bc, V)  # noqa: E731
        block_cells[label] = (mm, M)
        expect = (("spmm_dualgather",),) + (
            (("trisolve_chain_mm",),) if M is not None else ())
        res, seconds, counts, launched = s4_run(
            f"block_cg_xl/{label}",
            lambda: block_cg(mm, B_bc, tol=1e-5, maxiter=4000, M=M), expect)
        X64 = res.x.double().cpu().numpy()
        true_res = np.linalg.norm(po_sp @ X64 - B_np, axis=0)
        reached = bool(np.all(res.residuals.cpu().numpy()
                              <= 1e-5 * bn_bc * 1.001) and res.iters < 4000)
        ok = (reached and bool(np.all(true_res <= 10 * 1e-5 * bn_bc))
              and launched)
        block_cells[label] += (res.iters,)
        emit({"phase": "main_path", "path": f"block_cg_xl/{label}",
              "n": n_po, "k": 8, "iters_to_tol": res.iters,
              "reached_tol": reached,
              "true_rel_residual_max": float((true_res / bn_bc).max()),
              "seconds": seconds, "launches": counts, "ok": ok})
        if not ok:
            failures.append(f"main path block_cg_xl/{label}")
        del res

    # the one-shot trisolve on bench_trisolve's scattered factor (its plan,
    # binv m=8, included in ``seconds``)
    sc_b_dev = torch.from_numpy(sc_b).to(dev)
    x_sc, seconds, counts, launched = s4_run(
        "trisolve scattered", lambda: trisolve(A_sc, sc_b_dev),
        (("trisolve_binv",),))
    ok = launched and relative_check(x_sc.double().cpu().numpy(),
                                     tri_oracle(sc_sp, sc_b, True, False))
    emit({"phase": "main_path", "path": "trisolve(A, b) scattered L "
          "n=65536", "seconds": seconds, "launches": counts, "ok": ok})
    if not ok:
        failures.append("main path trisolve scattered")
    # and on the 1024² IC(0) factor, the fused route (its plan and walk
    # included in ``seconds``)
    b3_np = np.random.default_rng(23).standard_normal(n_po3).astype(
        np.float32)
    x3, seconds, counts, launched = s4_run(
        "trisolve 1024^2", lambda: trisolve(L_ic3, torch.from_numpy(
            b3_np).to(dev)), (("trisolve_fused",),))
    ok = launched and relative_check(x3.double().cpu().numpy(),
                                     tri_oracle(Lic3_sp, b3_np, True, False))
    emit({"phase": "main_path", "path": "trisolve(A, b) ic0 L Poisson "
          "1024^2 (fused route)", "n": n_po3, "seconds": seconds,
          "launches": counts, "ok": ok})
    if not ok:
        failures.append("main path trisolve 1024^2")
    del x3

    # slice 5: spmm over octet packs, spmv/spmm over the spill-cap packs,
    # spmv over both SELL packs, spmm on a power-law CSR with an octet
    # skew base (first calls pack), then the direct solver and BiCGSTAB
    t = time.perf_counter()
    sp_pl = octet_skew_matrix()
    A_pl = CSR.from_scipy(sp_pl, device=dev)
    X_pl_np = np.random.default_rng(19).standard_normal(
        (sp_pl.shape[1], 32)).astype(np.float32)
    X_pl = torch.from_numpy(X_pl_np).to(dev)
    emit({"phase": "inputs", "matrix": "power-law CSR, octet skew base",
          "shape": list(sp_pl.shape), "nnz": int(sp_pl.nnz),
          "max_col_deg": int(np.bincount(sp_pl.indices).max()),
          "seconds": time.perf_counter() - t})
    s5_paths = [
        ("spmm(prepare_spmv(spmm_xl octet-mm)) k=32 (auto: octet)",
         lambda: spmm(prepare_spmv(A_omm), X_omm),
         sp_omm.astype(np.float64) @ X_omm_np, ("spmm_octet",)),
        ("spmm(prepare_spmv(clustered)) k=32 (auto: octet)",
         lambda: spmm(prepare_spmv(A_clu), X_clu),
         sp_clu.astype(np.float64) @ X_clu.double().cpu().numpy(),
         ("spmm_octet",)),
        ("spmv prepare_spmv(XL, spill_cap=auto) k_tiles=1",
         lambda: spmv(P_sp1, x_xl), y_xl_want,
         ("spmv_dualgather", "spmv_pooled")),
        ("spmv prepare_spmv(XL, spill_cap=auto, k_tiles=8)",
         lambda: spmv(P_sp8, x_xl), y_xl_want,
         ("spmv_dualgather_sb", "spmv_pooled")),
        ("spmm prepare_spmv(XL, spill_cap=auto, k_tiles=8) k=32",
         lambda: spmm(P_sp8, X_xl), Y_xl_want,
         ("spmm_dualgather_sb", "spmv_pooled"))]
    s5_paths += [(f"spmv {case}", lambda P=P, x=x_s: spmv(P, x),
                  sp_s.astype(np.float64) @ x_s.double().cpu().numpy(),
                  (kname,))
                 for case, P, x_s, sp_s, kname in sell_main]
    s5_paths += [
        ("spmm power-law CSR (octet skew base) k=32 (auto)",
         lambda: spmm(A_pl, X_pl), sp_pl.astype(np.float64) @ X_pl_np,
         ("spmm_octet",))]
    for name, run, want, expect in s5_paths:
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
              and relative_check(y64, want)
              and all(counts[kn] > 0 for kn in expect))
        emit({"phase": "main_path", "path": name, "shape": list(y.shape),
              "seconds": seconds, "launches": counts, "oracle_check": ok,
              "ok": ok})
        if not ok:
            failures.append(f"main path {name}")
        del y
    from sparsematrix_tpu_torch.ops.spmm import _dg_pack_of
    pl_pack = _dg_pack_of(A_pl)
    if not isinstance(getattr(pl_pack, "base", None), octmod.Octet):
        failures.append("the power-law CSR's skew base is not an octet")

    # splu_solve: the waves engine at the bench's n = 65536 (the fused
    # engine refuses that fill as too scattered) and the fused engine at
    # n = 16384, a vector and a panel each (8 columns, one chain pane; 4
    # for the fused engine, whose plain walk is long); against the same
    # solve through the engines' plain versions on the card (1e-4 of the
    # output scale) and fp64 SuperLU
    import scipy.sparse.linalg as spla

    from sparsematrix_tpu_torch.ops import splu_plans, splu_solve
    from sparsematrix_tpu_torch.solvers import bicgstab
    for engine, side in (("waves", 256), ("fused", 128)):
        n_cv, sp_cv = convection_system(side)
        A_cv = CSR.from_scipy(sp_cv, device=dev)
        lu64 = spla.splu(sp_cv.astype(np.float64).tocsc())
        solver = s4_pack(f"splu_plans {engine} convection n={n_cv}",
                         lambda: splu_plans(A_cv, engine=engine))
        if engine == "waves":
            one, many = twmod.waves_forward_plain, twmod.mm_forward_plain
            expect = (("trisolve_binv", "trisolve_chain",
                       "trisolve_chain_mm"),)
        else:
            one = tfmod.fused_forward_plain
            many = (lambda p, B: torch.stack(
                [tfmod.fused_forward_plain(p, B[:, j])
                 for j in range(B.shape[1])], dim=1))
            expect = (("trisolve_fused",),)
        for panel in (False, True):
            width = 8 if engine == "waves" else 4
            b_np = np.random.default_rng(20 + panel).standard_normal(
                (n_cv, width) if panel else n_cv).astype(np.float32)
            b_dev = torch.from_numpy(b_np).to(dev)
            x_s, seconds, counts, launched = s4_run(
                f"splu_solve {engine}", lambda: splu_solve(solver, b_dev),
                expect)
            f = many if panel else one
            y = b_dev[solver.inv_perm_r.long()]
            want_plain = f(solver.u_plan, f(solver.l_plan, y))[
                solver.perm_c.long()]
            torch.cuda.synchronize()
            err = float((x_s.double() - want_plain.double()).abs().max())
            scale = float(want_plain.abs().max())
            oracle_ok = relative_check(x_s.double().cpu().numpy(),
                                       lu64.solve(b_np.astype(np.float64)))
            ok = launched and oracle_ok and err <= 1e-4 * scale
            case = (f"splu_solve {engine} n={n_cv} "
                    + (f"panel k={width}" if panel else "vector"))
            errs[("splu_solve", case)] = err
            emit({"phase": "main_path", "path": case, "seconds": seconds,
                  "max_abs_err_vs_plain": err, "tol": 1e-4 * scale,
                  "oracle_check": oracle_ok, "launches": counts, "ok": ok})
            if not ok:
                failures.append(f"main path {case}")
            del x_s, want_plain
        del solver

    # bicgstab on the convection system at n = 65536: plain and with
    # ILU(0) wave plans; the bench's checks (tol reached, true residual
    # within 10·tol·‖b‖, the preconditioned run in at most 0.6× plain's
    # iterations)
    n_cv, sp_cv = convection_system(256)
    A_cv = CSR.from_scipy(sp_cv, device=dev)
    b_cv_np = np.random.default_rng(8).standard_normal(n_cv).astype(
        np.float32)
    b_cv = torch.from_numpy(b_cv_np).to(dev)
    bn_cv = float(np.linalg.norm(b_cv_np))
    Ap_cv = s4_pack("bicgstab convection n=65536 prepare_spmv",
                    lambda: prepare_spmv(A_cv))
    plans_cv = s4_pack("bicgstab convection n=65536 ilu0-waves plans",
                       lambda: ilu0_waves_plans(A_cv))
    plain_iters = None
    bicg_cells = {}
    for label, M, expect in (
            ("plain", None, (dg_spmv,)),
            ("ilu0-waves", lambda r: ilu_apply(plans_cv, r),
             (dg_spmv, ("trisolve_chain",)))):
        res, seconds, counts, launched = s4_run(
            f"bicgstab {label}",
            lambda: bicgstab(Ap_cv, b_cv, tol=1e-5, maxiter=4000, M=M),
            expect)
        x64 = res.x.double().cpu().numpy()
        true_res = float(np.linalg.norm(sp_cv @ x64 - b_cv_np))
        reached = (float(res.residual) <= 1e-5 * bn_cv * 1.001
                   and res.iters < 4000)
        ok = (reached and true_res <= 10 * 1e-5 * bn_cv and launched
              and bool(np.isfinite(x64).all()))
        if label == "plain":
            plain_iters = res.iters
        else:
            ok = ok and res.iters <= 0.6 * plain_iters
            # the same solve through the plain versions on the card (the
            # operator's walk and the chain solves): the iterations agree
            # within 2 (fp32 sums run in another order) and it reaches tol
            ref = bicgstab(
                lambda v: dgmod.spmv_dualgather_reference(Ap_cv, v), b_cv,
                tol=1e-5, maxiter=4000,
                M=lambda r: twmod.waves_forward_plain(
                    plans_cv[1], twmod.waves_forward_plain(plans_cv[0], r)))
            ref_true = float(np.linalg.norm(
                sp_cv @ ref.x.double().cpu().numpy() - b_cv_np))
            ok = (ok and abs(ref.iters - res.iters) <= 2
                  and ref_true <= 10 * 1e-5 * bn_cv)
            emit({"phase": "check", "kernel": "bicgstab ilu0-waves",
                  "case": f"convection n={n_cv} against its plain version",
                  "iters": res.iters, "plain_version_iters": ref.iters,
                  "plain_version_true_rel_residual": ref_true / bn_cv,
                  "ok": ok})
            del ref
        bicg_cells[label] = (M, res.iters)
        emit({"phase": "main_path", "path": f"bicgstab convection n={n_cv} "
              f"{label}", "iters_to_tol": res.iters,
              "plain_iters": plain_iters, "reached_tol": reached,
              "true_rel_residual": true_res / bn_cv, "seconds": seconds,
              "launches": counts, "ok": ok})
        if not ok:
            failures.append(f"main path bicgstab {label}")
        del res

    # slice 6: BSR through the public API.  spmm on the XL BSR (the panel
    # kernel) and the (128, 128) BSR (the grouped kernel); spmm on the
    # bench's bsr point with method "sparse" and "auto" (the route each
    # took, by the counters: auto densifies where _should_densify says);
    # spmv on the XL BSR through its CSR (rows 10/11; the conversion must
    # not densify: its host arrays, traced, stay under half the dense fp32
    # matrix); block_cg and cg at block_cg_xl's Poisson system
    # with the operator as csr_to_bsr(A, (8, 8)), held to the bench's
    # checks and to the CSR operator's iterations (±2); spmm_bsr forward
    # and backward against fp64
    bsr_paths = [
        ("spmm XL BSR (8,8) k=128", lambda: spmm(A_xb, X_xb), A_xb, X_xb,
         ("spmm_bsr_panel",)),
        ("spmm BSR (128,128) n=16384 k=128", lambda: spmm(A_big, X_big),
         A_big, X_big, ("spmm_bsr",)),
        ("spmm bench BSR (8,8) method=sparse", lambda: spmm(
            A_bb, X_bb, method="sparse"), A_bb, X_bb, ("spmm_bsr_panel",)),
        ("spmm bench BSR (8,8) method=auto", lambda: spmm(A_bb, X_bb),
         A_bb, X_bb, ()),
    ]
    for name, run, A_c, X_c, expect in bsr_paths:
        y, seconds, counts, launched = s4_run(name, run, (expect,) if expect
                                              else ())
        y64 = y.double().cpu().numpy()
        ok = (launched and y64.shape == (A_c.shape[0], X_c.shape[1])
              and relative_check(y64, bsr_oracle(A_c, X_c.double().cpu()
                                                 .numpy())))
        route = ("panel kernel" if counts["spmm_bsr_panel"] else
                 "grouped kernel" if counts["spmm_bsr"] else
                 "densify (one dense product)" if
                 tspmm._should_densify(A_c) else "plain block product")
        emit({"phase": "main_path", "path": name, "route": route,
              "should_densify": tspmm._should_densify(A_c),
              "seconds": seconds, "launches": counts, "oracle_check": ok,
              "ok": ok})
        if not ok:
            failures.append(f"main path {name}")
        del y
    x_xb = torch.from_numpy(np.random.default_rng(34).standard_normal(
        32768).astype(np.float32)).to(dev)
    tracemalloc.start()  # numpy's and scipy's host arrays are traced
    y, seconds, counts, launched = s4_run(
        "spmv XL BSR", lambda: spmv(A_xb, x_xb), (dg_spmv,))
    host_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    dense_bytes = 4 * 32768 ** 2
    ok = (launched and host_peak < 0.5 * dense_bytes
          and relative_check(y.double().cpu().numpy(), bsr_oracle(
              A_xb, x_xb.double().cpu().numpy()[:, None])[:, 0]))
    emit({"phase": "main_path", "path": "spmv XL BSR (8,8) (CSR route, "
          "first call converts and packs)", "seconds": seconds,
          "host_peak_bytes": host_peak, "dense_fp32_bytes": dense_bytes,
          "launches": counts, "ok": ok})
    if not ok:
        failures.append("main path spmv XL BSR")
    del y
    emit({"phase": "inputs", "matrix": "block_cg_xl Poisson as BSR (8,8)",
          "num_blocks": A_pob.num_blocks,
          "max_blocks_a_row": int(A_pob.indptr.diff().max())})
    res, seconds, counts, launched = s4_run(
        "block_cg_xl BSR", lambda: block_cg(A_pob, B_bc, tol=1e-5,
                                            maxiter=4000),
        (("spmm_bsr_panel",),))
    X64 = res.x.double().cpu().numpy()
    true_res = np.linalg.norm(po_sp @ X64 - B_np, axis=0)
    reached = bool(np.all(res.residuals.cpu().numpy()
                          <= 1e-5 * bn_bc * 1.001) and res.iters < 4000)
    csr_iters = block_cells["block-plain"][2]
    ok = (reached and bool(np.all(true_res <= 10 * 1e-5 * bn_bc))
          and launched and abs(res.iters - csr_iters) <= 2)
    bsr_block_iters = res.iters
    emit({"phase": "main_path", "path": "block_cg_xl/block-plain BSR (8,8)",
          "n": n_po, "k": 8, "iters_to_tol": res.iters,
          "csr_operator_iters": csr_iters, "reached_tol": reached,
          "true_rel_residual_max": float((true_res / bn_bc).max()),
          "seconds": seconds, "launches": counts, "ok": ok})
    if not ok:
        failures.append("main path block_cg_xl BSR")
    del res
    b_pob_np = np.random.default_rng(8).standard_normal(n_po).astype(
        np.float32)
    b_pob = torch.from_numpy(b_pob_np).to(dev)
    # its spmv takes the BSR's CSR, which at 5 entries a row the JAX
    # package's rule leaves unpacked: the plain CSR product, no kernel
    res, seconds, counts, launched = s4_run(
        "cg BSR", lambda: cg(A_pob, b_pob, tol=1e-5, maxiter=6000), ())
    true_res = float(np.linalg.norm(po_sp @ res.x.double().cpu().numpy()
                                    - b_pob_np))
    bn_pob = float(np.linalg.norm(b_pob_np))
    csr_iters = cg_cells[("ilu_cg_xl", "plain")][4]
    ok = (float(res.residual) <= 1e-5 * bn_pob * 1.001 and res.iters < 6000
          and true_res <= 10 * 1e-5 * bn_pob and launched
          and abs(res.iters - csr_iters) <= 2)
    bsr_cg_iters = res.iters
    emit({"phase": "main_path", "path": "cg ilu_cg_xl/plain BSR (8,8)",
          "iters_to_tol": res.iters, "csr_operator_iters": csr_iters,
          "true_rel_residual": true_res / bn_pob, "seconds": seconds,
          "launches": counts, "ok": ok})
    if not ok:
        failures.append("main path cg BSR")
    del res
    # spmm_bsr forward and backward on the bench's bsr point: dX against
    # fp64 denseᵀ @ g, the block gradients against fp64 g @ Xᵀ on the
    # stored blocks
    g_np = np.random.default_rng(35).standard_normal(
        (2048, 128)).astype(np.float32)
    data_g = A_bb.data.clone().requires_grad_(True)
    A_g = dataclasses.replace(A_bb, data=data_g)
    X_g = X_bb.clone().requires_grad_(True)

    def bsr_grad():
        y = kb.spmm_bsr(A_g, X_g)
        y.backward(torch.from_numpy(g_np).to(dev))
        return y

    y, seconds, counts, launched = s4_run("spmm_bsr backward", bsr_grad,
                                          (("spmm_bsr_panel",),))
    dX64 = dense_bb.T.astype(np.float64) @ g_np.astype(np.float64)
    gx = g_np.astype(np.float64) @ Xbb_np.astype(np.float64).T
    _, ind_g, _ = bsr_host(A_bb)
    brow_g = np.repeat(np.arange(256), np.diff(bsr_host(A_bb)[0]))
    ddata64 = gx.reshape(256, 8, 256, 8)[brow_g, :, ind_g, :]
    ok = (launched
          and relative_check(X_g.grad.double().cpu().numpy(), dX64)
          and relative_check(data_g.grad[: A_bb.num_blocks].double().cpu()
                             .numpy().reshape(-1), ddata64.reshape(-1)))
    emit({"phase": "main_path", "path": "spmm_bsr forward and backward "
          "bench (8,8) k=128", "seconds": seconds, "launches": counts,
          "oracle_check": ok, "ok": ok})
    if not ok:
        failures.append("main path spmm_bsr backward")
    del y, data_g, A_g, X_g
    mark("main path")

    # slice 7: the distribution layer (parallel/) at world size 1 under
    # NCCL in this process.  Every collective is then a copy, so these
    # paths time the local kernels and the host, not an exchange.  Each
    # path against fp64, the launch counters set to 0 before it and read
    # after: the XL CSR through dist_spmm_rowlane (row 8) and
    # dist_spmv_rowlane (row 7), the plain dist_spmv/dist_spmm on row and
    # column partitions (psum, psum_scatter), the dual-gather paths (rows
    # 10/11, 13/14); the halo exchanges on a banded matrix (n = 2^20, 9
    # diagonals); dist_cg on ilu_cg_xl's Poisson system with Jacobi and
    # with block_ic0_precond (waves: rows 19/20), held to the bench's
    # checks and to the single-device cg's iterations (max(3, 2 %): fp32
    # sums in another order)
    ddg = importlib.import_module(
        "sparsematrix_tpu_torch.parallel.dist_dualgather")
    rdv_dir = tempfile.mkdtemp(prefix="smt_dist_")
    par.initialize_multihost(f"file://{rdv_dir}/store", 1, 0, device=dev)
    mesh = par.make_mesh()
    emit({"phase": "dist", "backend": dist.get_backend(),
          "world_size": dist.get_world_size(), "device": str(mesh.device),
          "host_staged": mesh.staged()})
    part_r = par.shard_partitioned(s4_pack(
        "XL partition_csr_rows(1)", lambda: par.partition_csr_rows(A_xl, 1)),
        mesh)
    part_c = par.shard_partitioned(s4_pack(
        "XL partition_csr_cols(1)", lambda: par.partition_csr_cols(A_xl, 1)),
        mesh)
    part_dg_full = s4_pack("XL partition_dualgather(1, group 32)",
                           lambda: par.partition_dualgather(A_xl, 1))
    part_dg = par.shard_partitioned(part_dg_full, mesh)
    sp_band, x_band_np = banded_matrix()
    A_band = CSR.from_scipy(sp_band, device=dev)
    part_ring = par.shard_partitioned(s4_pack(
        "banded partition_csr_halo_ring(1, halo 4)",
        lambda: par.partition_csr_halo_ring(A_band, 1, 4)), mesh)
    part_var = par.shard_partitioned(s4_pack(
        "banded partition_csr_halo_var(1)",
        lambda: par.partition_csr_halo_var(A_band, 1)), mesh)
    y_band_want = sp_band.astype(np.float64) @ x_band_np.astype(np.float64)
    xb_xl = par.shard_vector(x_xl, mesh)  # one rank: the whole vector
    Xb_xl = par.shard_vector(X_xl, mesh)
    xb_band = par.shard_vector(torch.from_numpy(x_band_np), mesh)
    s7_paths = {}
    for name, run, want, expect in [
            ("dist_spmm_rowlane XL k=32",
             lambda: par.dist_spmm_rowlane(part_xl, Xb_xl, mesh), Y_xl_want,
             ("spmm_rowlane",)),
            ("dist_spmv_rowlane XL",
             lambda: par.dist_spmv_rowlane(part_xl, xb_xl, mesh), y_xl_want,
             ("spmv_rowlane",)),
            ("dist_spmv rows XL", lambda: par.dist_spmv(part_r, xb_xl, mesh),
             y_xl_want, ()),
            ("dist_spmm rows XL k=32",
             lambda: par.dist_spmm(part_r, Xb_xl, mesh), Y_xl_want, ()),
            ("dist_spmv cols psum XL",
             lambda: par.dist_spmv(part_c, xb_xl, mesh), y_xl_want, ()),
            ("dist_spmv cols psum_scatter XL",
             lambda: par.dist_spmv(part_c, xb_xl, mesh,
                                   reduce="psum_scatter"), y_xl_want, ()),
            ("dist_spmm cols psum XL k=32",
             lambda: par.dist_spmm(part_c, Xb_xl, mesh), Y_xl_want, ()),
            ("dist_spmm cols psum_scatter XL k=32",
             lambda: par.dist_spmm(part_c, Xb_xl, mesh,
                                   reduce="psum_scatter"), Y_xl_want, ()),
            ("dist_spmv_dualgather XL",
             lambda: par.dist_spmv_dualgather(part_dg, xb_xl, mesh),
             y_xl_want, ("spmv_dualgather",)),
            ("dist_spmm_dualgather XL k=32",
             lambda: par.dist_spmm_dualgather(part_dg, Xb_xl, mesh),
             Y_xl_want, ("spmm_dualgather",)),
            ("dist_spmv_halo_ring banded n=2^20",
             lambda: par.dist_spmv_halo_ring(part_ring, xb_band, mesh),
             y_band_want, ()),
            ("dist_spmv_halo_var banded n=2^20 (ragged)",
             lambda: par.dist_spmv_halo_var(part_var, xb_band, mesh),
             y_band_want, ())]:
        y, seconds, counts, launched = s4_run(name, run, (expect,) if expect
                                              else ())
        y64 = y.double().cpu().numpy()[: want.shape[0]]
        ok = (launched and y64.shape == want.shape
              and bool(np.isfinite(y64).all()) and relative_check(y64, want))
        emit({"phase": "main_path", "path": name, "world_size": 1,
              "seconds": seconds, "launches": counts, "oracle_check": ok,
              "ok": ok})
        if not ok:
            failures.append(f"main path {name}")
        s7_paths[name] = run
        del y
    part_po = par.shard_partitioned(par.partition_csr_rows(A_po, 1), mesh)
    M_blk = s4_pack("ilu_cg_xl block_ic0_precond(1 rank, waves)",
                    lambda: par.block_ic0_precond(A_po, 1, mesh=mesh))
    s7_cg = {}
    for label, precond, expect, ref in [
            ("jacobi", "jacobi", (), ("ilu_cg_xl", "plain")),
            ("block_ic0 waves", M_blk, (("trisolve_chain", "trisolve_binv"),),
             ("ilu_cg_xl", "ic0-waves"))]:
        res, seconds, counts, launched = s4_run(
            f"dist_cg {label}", lambda precond=precond: par.dist_cg(
                part_po, b_pob, mesh, precond=precond, tol=1e-5,
                maxiter=6000), expect)
        true_res = float(np.linalg.norm(
            po_sp @ res.x.double().cpu().numpy() - b_pob_np))
        ref_iters = cg_cells[ref][4]
        reached = (float(res.residual) <= 1e-5 * bn_pob * 1.001
                   and res.iters < 6000)
        ok = (reached and true_res <= 10 * 1e-5 * bn_pob and launched
              and abs(res.iters - ref_iters) <= max(3, 0.02 * ref_iters))
        emit({"phase": "main_path", "path": f"dist_cg ilu_cg_xl {label}",
              "world_size": 1, "iters_to_tol": res.iters,
              "single_device_cg_iters": ref_iters, "reached_tol": reached,
              "true_rel_residual": true_res / bn_pob, "seconds": seconds,
              "launches": counts, "ok": ok})
        if not ok:
            failures.append(f"main path dist_cg {label}")
        s7_cg[label] = (precond, res.iters)
        del res
    mark("main path, slice 7 (world size 1)")

    # the multi-rank phase: tests/_torch_dist_ranks.py on 2 and on 4 gloo
    # ranks sharing cuda:0 (NCCL refuses two ranks on one card; gloo's
    # collectives stage through the host, the compute stays on the card),
    # both spawns at once: every dist_* of the slice on small fixtures
    # (the halo exchanges, psum_scatter, a 2 × (n/2) mesh, dist_cg with
    # the block preconditioners) against fp64, and the kernels each rank
    # launched
    spec = importlib.util.spec_from_file_location(
        "_torch_dist_ranks",
        Path(__file__).resolve().parent / "tests" / "_torch_dist_ranks.py")
    ranks_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks_mod)
    want_kernels = (("spmm_rowlane",), ("spmv_rowlane",),
                    ("spmv_dualgather",), ("spmm_dualgather",),
                    ("trisolve_chain", "trisolve_binv"))
    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(ranks_mod.spawn, w, Path(tempfile.mkdtemp(
            prefix=f"smt_ranks{w}_")), "cuda", None, 400) for w in (2, 4)}
        for w, fut in futures.items():
            try:
                _, rep = fut.result()
            except RuntimeError as e:
                emit({"phase": "main_path", "path": f"gloo x{w} on cuda:0",
                      "error": str(e)[-2000:], "ok": False})
                failures.append(f"multi-rank gloo x{w}")
                continue
            launched = all(any(rep["launches"].get(kn, 0) > 0 for kn in alt)
                           for alt in want_kernels)
            # one card: gloo, its collectives staged through the host
            ok = (launched and rep["staged"] == (rep["backend"] == "gloo")
                  and all(c["ok"] for c in rep["cases"].values()))
            emit({"phase": "main_path", "path": f"gloo x{w} on cuda:0",
                  "world_size": w, "device": rep["device"],
                  "backend": rep["backend"], "host_staged": rep["staged"],
                  "seconds": rep["seconds"],
                  "cases": rep["cases"], "launches": rep["launches"],
                  "ok": ok})
            if not ok:
                failures.append(f"multi-rank gloo x{w}")
    mark("main path, slice 7 (gloo ranks)")

    # slice 8, the bench suite: the headline (bench.py's twin), then the
    # suite's CLI on each bench-size group at its default size, every
    # launch counter set to 0 just before a group and read just after.
    # The run fails on a failed group, a dropped variant or row, a check
    # that is false, a SoL above 105 % (a byte model that can be beaten is
    # a timing artifact) or a group that did not launch its kernels.
    from sparsematrix_tpu_torch.bench import cli as bench_cli
    from sparsematrix_tpu_torch.bench.headline import headline
    from sparsematrix_tpu_torch.bench.suite import (REF_K, REF_M, REF_N,
                                                    registry as bench_reg)

    _build.launch_counts.clear()
    t = time.perf_counter()
    head = headline(device=dev)
    torch.cuda.synchronize()
    counts = {kn: v for kn, v in _build.launch_counts.items() if v}
    for kn, v in counts.items():
        main_launches[kn] += v
    emit({"phase": "bench", "group": "headline", "line": head,
          "seconds": time.perf_counter() - t, "launches": counts})
    # the headline is checked, and its fused-pallas rows launched row 1
    if not (head["checked"] and counts.get("codebook_spmm")):
        failures.append("bench headline")
    bench_rows = {}
    for group in BENCH_GROUPS:
        n_rows, n_failed = len(bench_reg.rows), len(bench_reg.failed)
        n_dropped = len(bench_reg.dropped)
        _build.launch_counts.clear()
        t = time.perf_counter()
        bench_cli.main([str(REF_M), str(REF_N), str(REF_K), "1",
                        f"^{group}$"], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = {kn: v for kn, v in _build.launch_counts.items() if v}
        for kn, v in counts.items():
            main_launches[kn] += v
        rows = bench_reg.rows[n_rows:]
        problems = [f"failed {x}" for x in bench_reg.failed[n_failed:]]
        problems += [f"dropped {x}" for x in bench_reg.dropped[n_dropped:]]
        problems += [f"check false {r.name} {r.shape}" for r in rows
                     if r.checked is False]
        problems += [f"SoL {r.sol_frac:.3f} {r.name} {r.shape}" for r in rows
                     if r.sol_frac is not None and r.sol_frac > 1.05]
        problems += [f"{kn} not launched" for kn in BENCH_KERNELS[group]
                     if not counts.get(kn)]
        if not rows:
            problems.append("no rows")
        emit({"phase": "bench", "group": group, "seconds": seconds,
              "launches": counts, "problems": problems,
              "rows": [{"name": r.name, "shape": r.shape,
                        "min_ms": r.result.min_ms,
                        "median_ms": r.result.extras.get("median_ms"),
                        "sol_frac": r.sol_frac, "checked": r.checked,
                        **{kx: vx for kx, vx in r.extras.items()
                           if kx in ("tflops", "gb_per_s", "iters_to_tol",
                                     "per_iter_ms", "vs_baseline")}}
                       for r in rows]})
        for r in rows:
            bench_rows[r.name] = r
        if problems:
            failures.append(f"bench {group}: {problems}")
    chip = roofline.active_chip()
    emit({"phase": "bench", "group": "calibrate vs spec",
          "matmul_fp32_tflops": bench_rows["calibrate/matmul-fp32"].extras[
              "tflops"], "fp32_spec_tflops": chip.fp32_tflops,
          "matmul_bf16_tflops": bench_rows["calibrate/matmul-bf16"].extras[
              "tflops"], "bf16_spec_tflops": chip.bf16_tflops,
          "hbm_stream_gb_per_s": bench_rows["calibrate/hbm-stream"].extras[
              "gb_per_s"], "hbm_spec_gb_per_s": chip.hbm_gbps})
    mark("main path, slice 8 (bench suite)")

    for kn, v in main_launches.items():
        if v == 0 and kn not in PROBE_KERNELS:
            failures.append(f"kernel {kn} was not launched on the main path")

    # -- 5. timings ---------------------------------------------------------
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    spin_rate = spin_cycles_per_s()

    def dev_ms(fn):
        return timed_ms(fn, flush, spin_rate)

    def wall_once_ms(fn):
        fn()  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

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
               "bytes": nbytes, "library": "table[idx.long()] @ X",
               "split": codebook_split(b_t.shape[0], b_t.shape[1], mm, dev),
               "dense_fma_floor_ms": 2.0 * b_t.shape[0] * b_t.shape[1] * mm
               / PEAK_FP32 * 1e3}
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

    def variant(kernel, case, name, ms, base, **extra):
        """A knob setting or an ablation of a kernel beside its default
        (``base``, this run's timing line), in the same call."""
        emit({"phase": "variant", "kernel": kernel, "case": case,
              "variant": name, "ms": ms, "default_ms": base["ms"],
              "ratio": ms / base["ms"], **extra})

    def bell_variants(label, bell, X, row, splits):
        # row 2's split over blocks (the knob), then what sets its pace:
        # staging alone (no FMA), no skip of zero rows, FMAs alone (no
        # staging); the ablations' results are not A @ X
        for sp in splits:
            variant("spmm_blocked_ell", label, f"split={sp}",
                    dev_ms(lambda sp=sp: _spmm_blocked_ell_cuda(
                        bell, X, split=sp)), row)
        for mode, name in ((1, "staging only (no FMA)"),
                           (2, "no zero-row skip"),
                           (6, "FMA only (no staging), no zero-row skip")):
            variant("spmm_blocked_ell", label, name,
                    dev_ms(lambda mode=mode: _spmm_blocked_ell_cuda(
                        bell, X, mode=mode)), row)

    def tail_variants(label, tail, rhs, row):
        # row 12's work knob (rows a warp at k = 1, blocks a tile at
        # k > 1), then what sets its pace: no X gather, decode only; the
        # ablations' results are not T @ X.  Each call zeroes its Y first,
        # as the timing line's does
        k_rhs = rhs.shape[1]

        def run(**kw):
            Y = torch.zeros((tail.shape[0], k_rhs), dtype=torch.float32,
                            device=rhs.device)
            dgmod.launch_pooled(tail, rhs, Y, **kw)
            return Y

        Yk = torch.zeros((tail.shape[0], k_rhs), dtype=torch.float32,
                         device=rhs.device)
        # the kernel alone, into a Y that is already there (its values
        # grow over the calls; only the time is read)
        variant("spmv_pooled", label, "kernel alone (no zeroed Y)",
                dev_ms(lambda: dgmod.launch_pooled(tail, rhs, Yk)), row)
        works = (8, 16, 32, 64) if k_rhs == 1 else (1, 2, 4)
        for wk in works:
            variant("spmv_pooled", label,
                    f"work={wk} ({'rows a warp' if k_rhs == 1 else 'blocks a tile'})",
                    dev_ms(lambda wk=wk: run(work=wk)), row)
        modes = ((1, "no X gather"),) + (((2, "decode only"),)
                                         if k_rhs > 1 else ())
        for mode, name in modes:
            variant("spmv_pooled", label, name,
                    dev_ms(lambda mode=mode: run(mode=mode)), row)

    def sell_variants(label, P, x_s, row):
        # row 5's knobs beside the default (slabs a block: chunks of C, or
        # -L for runs of at most L slabs of one tile, a run a block; warps
        # a block; sublanes a batch), then what sets its pace: no x
        # gather, meta read under every value, the values alone (the
        # ablations' results are not A @ x)
        run = selmod.sell_default_run(P)
        runs = ((run // 2, 2 * run) if run > 0 else (-1, -4, 4))
        for r in runs:
            variant("spmv_sell", label, f"run={r}",
                    dev_ms(lambda r=r: selmod._spmv_sell_cuda(P, x_s, run=r)),
                    row)
        if run > 0:
            variant("spmv_sell", label, "warps=4",
                    dev_ms(lambda: selmod._spmv_sell_cuda(P, x_s, warps=4)),
                    row)
            variant("spmv_sell", label, "unroll=4",
                    dev_ms(lambda: selmod._spmv_sell_cuda(P, x_s, unroll=4)),
                    row)
            for mode, name in ((1, "no x gather"),
                               (2, "meta read under every value"),
                               (3, "values alone")):
                variant("spmv_sell", label, name,
                        dev_ms(lambda mode=mode: selmod._spmv_sell_cuda(
                            P, x_s, mode=mode)), row)

    def superblock_variants(label, P, x_s, row):
        # row 9's knob beside the default (slabs a warp: one wave of the
        # warps the card holds, rounded up to whole groups), then
        # what sets its pace: no x gather, every slab streamed (no skip),
        # and the zero fill of y that the first version needed (the kernel
        # now writes y itself)
        one = -(-P.n_slabs // sbmod._resident_warps(P.s_idx.device))
        for spw in sorted({8, one, 12, 19, 32}):
            variant("spmv_superblock", label, f"spw={spw}",
                    dev_ms(lambda spw=spw: sbmod._spmv_superblock_cuda(
                        P, x_s, spw=spw)), row)
        for mode, name in ((1, "no x gather"), (2, "every slab streamed")):
            variant("spmv_superblock", label, name,
                    dev_ms(lambda mode=mode: sbmod._spmv_superblock_cuda(
                        P, x_s, mode=mode)), row)
        variant("spmv_superblock", label, "zero fill of y alone",
                dev_ms(lambda: torch.zeros(P.shape[0], device=dev)), row)

    def rowlane_variants(label, P, x_s, row):
        # row 7's knob beside the default (slabs a warp: about 8 in whole
        # waves of the warps the card holds), then the sector mask off
        # (every value word read); each gives A @ x
        one = rlmod.rowlane_default_spw(P.n_slabs, rlmod.resident_warps(
            "spmv_rowlane", P.s_idx.device))
        for spw in sorted({max(1, one // 2), 2 * one, 4 * one} - {one}):
            variant("spmv_rowlane", label, f"spw={spw}",
                    dev_ms(lambda spw=spw: rlmod._body_cuda(P, x_s,
                                                            spw=spw)), row)
        variant("spmv_rowlane", label, "sector mask off",
                dev_ms(lambda: rlmod._body_cuda(P, x_s, mask=False)), row)

    def octet_variants(label, P, x_s, row):
        # row 15's knobs beside the default (``octet_knobs``): slabs a
        # range (the walked slabs over one wave of the blocks the card
        # holds), slab stages a block (two a group) and slab groups a
        # block; each gives A @ x
        spr0, st0, g0 = octmod.octet_knobs(P)
        for spr in sorted({max(1, spr0 // 2), 2 * spr0, 4 * spr0} - {spr0}):
            variant("spmv_octet", label, f"spr={spr}",
                    dev_ms(lambda spr=spr: octmod._spmv_octet_cuda(
                        P, x_s, spr=spr)), row)
        for st in sorted({g0, 3 * g0, 4 * g0} - {st0}):
            variant("spmv_octet", label, f"stages={st}",
                    dev_ms(lambda st=st: octmod._spmv_octet_cuda(
                        P, x_s, stages=st, groups=g0)), row)
        for g in sorted({1, 2, 4} - {g0}):
            variant("spmv_octet", label, f"groups={g}",
                    dev_ms(lambda g=g: octmod._spmv_octet_cuda(
                        P, x_s, groups=g)), row)
        variant("spmv_octet", label, "copies and stores only",
                dev_ms(lambda: octmod._spmv_octet_cuda(
                    P, x_s, copies_only=True)), row)

    def copy_variants(label, x_s, row):
        # row 22's knobs beside the default (32 KB chunks, 4 stages, one
        # block an SM); each gives a copy
        for name, kw in (("chunk=16KB", dict(chunk=16 << 10)),
                         ("chunk=64KB stages=3", dict(chunk=64 << 10,
                                                      stages=3)),
                         ("stages=2", dict(stages=2)),
                         ("stages=6", dict(stages=6)),
                         ("blocks_per_sm=2 stages=3",
                          dict(blocks_per_sm=2, stages=3))):
            variant("stream_copy", label, name,
                    dev_ms(lambda kw=kw: _stream_copy_cuda(x_s, **kw)), row)

    def chain_variants(kname, label, plan, R, row):
        # rows 19 and 21: the cluster chain's knobs beside the default
        # (cluster size, ``CHAIN_CLUSTER``, and ring stages; each gives x)
        # and its hop parts (ablations, not x), each with µs a dependent
        # step
        bk = torch.randn(plan.S * R * 128, device=dev)
        knobs = ([("default knobs, the launch alone", {})]
                 + [(f"cluster={c}", dict(cluster=c)) for c in (2, 4, 8, 16)
                    if c != twmod.CHAIN_CLUSTER]
                 + [(f"stages={st}", dict(stages=st)) for st in (1, 2, 3)]
                 + [("hop alone (no x read, no product)", dict(parts=1)),
                    ("hop and x's read (no product)", dict(parts=2))])
        for name, kw in knobs:
            ms = dev_ms(lambda kw=kw: twmod._chain_cuda(plan, bk, R, **kw))
            variant(kname, label, name, ms, row, us_a_step=1e3 * ms / plan.S)

    def fused_variants(label, plan, b, row):
        # row 18: the walk at other lanes a row, each with µs a wave and
        # giving x; its ablations (not x): no store of x, the waits and
        # barriers
        waves = tfmod.fused_walk(plan).n_waves
        bp = b if plan.perm is None else b[plan.perm.long()]
        binv = torch.nn.functional.pad(plan.inv_diag * bp,
                                       (0, plan.n_win * 1024 - plan.shape[0]))
        knobs = ([(f"lanes={w}", dict(lanes=w)) for w in (2, 8)]
                 + [("no store of x (ablation)", dict(ablate=1)),
                    ("waits, refills and barriers alone (ablation)",
                     dict(ablate=2)),
                    ("barriers alone (ablation)", dict(ablate=3))])
        for name, kw in knobs:
            ms = dev_ms(lambda kw=kw: tfmod._fused_cuda(plan, binv.clone(),
                                                        **kw))
            variant("trisolve_fused", label, name, ms, row,
                    us_a_wave=1e3 * ms / waves)

    def kt1_variants(label, P, X, row, kname="spmm_dualgather"):
        # rows 14 and 13: the walk's steps alone (1: no X read under a
        # zero value; 2: and X's window staged; 3, the default: and the
        # planes streamed) and slabs a block; each gives the product
        for name, kw in [("step=1", dict(step=1)), ("step=2", dict(step=2)),
                         ("spb=64", dict(spb=64)), ("spb=256", dict(spb=256))]:
            variant(kname, label, name,
                    dev_ms(lambda kw=kw: _spmm_dualgather_cuda(P, X, **kw)),
                    row)

    def codebook_variants(label, b_t, X, row):
        # row 1's split of k beside the default (``codebook_split``), the
        # partials of a split above 1 summed by a second kernel; each
        # gives the product
        for S in (1, 2, 4, 8):
            variant("codebook_spmm", label, f"split={S}",
                    dev_ms(lambda S=S: _codebook_spmm_cuda(
                        b_t.idx, b_t.val_table, X, split=S)), row)

    cb_main = time_codebook(f"{m}x{n}x{k} float32 X=a.T", b_dns, a.T)
    codebook_variants(cb_main["case"], b_dns, a.T, cb_main)
    time_codebook(f"{m}x{n}x{k} bfloat16 X=a.T", b_dns,
                  a.to(torch.bfloat16).T)
    cb_4096 = time_codebook(f"4096x{n}x{k} float32 X=a.T", b_dns, a4.T)
    codebook_variants(cb_4096["case"], b_dns, a4.T, cb_4096)
    bell_main = time_bell(main_bell_case, b_bell, bt_dense, a.T)
    bell_variants(main_bell_case, b_bell, a.T, bell_main, (4, 8, 16, 32))
    for label, dense, bell, X in bell_inputs:
        row = time_bell(label, bell, dense, X)
        if bell.block_shape[0] < 32:
            bell_variants(label, bell, X, row, (1, 2, 4, 8))

    def cusparse(sp):
        # the same CSR in fp32 as a torch sparse tensor: the yardstick
        return torch.sparse_csr_tensor(
            torch.from_numpy(sp.indptr.astype(np.int64)),
            torch.from_numpy(sp.indices.astype(np.int64)),
            torch.from_numpy(sp.data.astype(np.float32)),
            size=sp.shape).to(dev)

    yardsticks = {}

    def time_dg(kname, case, P, rhs, sp, val_bytes):
        # the JAX package's minimum traffic (utils/roofline.py:59-75),
        # counting only the rows of x/X that an entry names
        k = 1 if rhs.dim() == 1 else rhs.shape[1]
        flops, nbytes = sparse_work(sp, k, val_bytes)
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
    kt1_variants("XL k=32 k_tiles=1", P_kt1, X_xl,
                 dg_rows[("spmm_dualgather", "XL k=32 k_tiles=1")])
    kt1_variants("XL k=32 auto", P_sb, X_xl,
                 dg_rows[("spmm_dualgather_sb", "XL k=32 auto")],
                 "spmm_dualgather_sb")

    # slice 3: the pair-program SpMV kernels (and the bf16 / L=4 cases),
    # with cuSPARSE on the same matrix; the window permute one stage at a
    # time, with one torch.gather of the composed window index
    s3_rows = {}
    octet_packs = {  # case -> (pack, x)
        "spgemm_xl P auto octet": (pp_auto.p_packed, xb["auto"]),
        "spgemm_xl P octet trim_group=8 (rem)": (pp_trim.p_packed,
                                                 xb["trim"]),
        "clustered octet (auto)": (P_clu["octet"], x_clu)}
    for kname, cases in s3_cases.items():
        for case, kern, plain, sp, vb, x_dev in cases:
            flops, nbytes = sparse_work(sp, 1, vb)
            bms, by = bound(flops, nbytes)
            if id(sp) not in yardsticks:
                yardsticks[id(sp)] = cusparse(sp)
            S = yardsticks[id(sp)]
            row = {"kernel": kname, "case": case, "ms": dev_ms(kern),
                   "plain_ms": dev_ms(plain),
                   "library_ms": dev_ms(lambda S=S, x_dev=x_dev: S @ x_dev),
                   "launches": main_launches[kname], "bound_ms": bms,
                   "bound_by": by, "flops": flops, "bytes": nbytes}
            if (kname, case) == ("spmv_superblock", "spgemm_xl P superblock"):
                row.update(superblock_stats(pp_sb.p_packed, int(
                    sbmod.group_real(pp_sb.p_packed).sum())))
            if (kname, case) == ("spmv_rowlane", "spgemm_xl P rowlane L=1"):
                row.update(rowlane_stats(pp_rl.p_packed,
                                         rlmod.sector_mask(pp_rl.p_packed)))
            if case in octet_packs:
                P_o = octet_packs[case][0]
                row.update(octet_stats(P_o,
                                       octmod.octet_walk(P_o)[0].shape[0]))
            emit({"phase": "timing", **row})
            s3_rows[(kname, case)] = row
    for case, (P_o, x_o) in octet_packs.items():
        octet_variants(case, P_o, x_o, s3_rows[("spmv_octet", case)])
    superblock_variants("spgemm_xl P superblock", pp_sb.p_packed, xb["sb"],
                        s3_rows[("spmv_superblock", "spgemm_xl P superblock")])
    rowlane_variants("spgemm_xl P rowlane L=1", pp_rl.p_packed, xb["rl"],
                     s3_rows[("spmv_rowlane", "spgemm_xl P rowlane L=1")])
    # row 7 at the ilu_cg_xl fixpoint's packs (the strict triangles of the
    # 256² Poisson ILU(0) factors: six sweeps a solve launch it twelve
    # times a CG iteration), beside its plain version and cuSPARSE
    for tag, plan in zip(("L", "U"), fix_plans):
        pk = plan.e_packed
        sp_e = pack_to_scipy(pk, rlmod._slot_row_col)
        x_e = torch.from_numpy(np.random.default_rng(13).standard_normal(
            pk.shape[1]).astype(np.float32)).to(dev)
        case = f"ilu_cg_xl ilu0-fix6 {tag} e_packed"
        got = rlmod._rowlane_forward(pk, x_e)
        want_plain = rlmod.spmv_sell_rowlane_reference(pk, x_e)
        torch.cuda.synchronize()
        errs[("spmv_rowlane", case)] = check(
            "spmv_rowlane", case, got, want_plain,
            sp_e.astype(np.float64) @ x_e.double().cpu().numpy(), False)
        flops, nbytes = sparse_work(sp_e, 1, 4)
        bms, by = bound(flops, nbytes)
        S_e = cusparse(sp_e)
        row = {"kernel": "spmv_rowlane", "case": case,
               "ms": dev_ms(lambda pk=pk, x_e=x_e: rlmod._rowlane_forward(
                   pk, x_e)),
               "plain_ms": dev_ms(
                   lambda pk=pk, x_e=x_e:
                   rlmod.spmv_sell_rowlane_reference(pk, x_e)),
               "library_ms": dev_ms(lambda S_e=S_e, x_e=x_e: S_e @ x_e),
               "launches": main_launches["spmv_rowlane"], "bound_ms": bms,
               "bound_by": by, "flops": flops, "bytes": nbytes,
               "split_tiles": int(rlmod.rowlane_walk(pk)[1].numel()),
               **rowlane_stats(pk, rlmod.sector_mask(pk))}
        emit({"phase": "timing", **row})
        s3_rows[("spmv_rowlane", case)] = row
        del got, want_plain, S_e
    # the host's side of a fixpoint sweep's SpMV at the L pack: µs to issue
    # one call, queued behind a spin so that the card never waits (the
    # public entry, the wrapper's body, the bare launch of its cached
    # arguments, and a whole sweep: the SpMV, a subtraction, a product),
    # beside the kernel's device time
    pk, b_h = fix_plans[0].e_packed, x_e
    x_h = x_e.clone()
    inv_h = torch.full_like(x_h, 0.25)
    fn_h = _build.load("spmv_rowlane", rlmod._ARGTYPES)
    pre_h, post_h, _, _ = rlmod._launch_build(pk, 0, True, None)
    y_h = torch.empty(pk.shape[0], device=dev)
    st_h = torch.cuda.current_stream().cuda_stream

    def host_us(fn, calls=100):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.05 * spin_rate))  # 50 ms of spin
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / calls * 1e6

    emit({"phase": "host", "path": "ilu_cg_xl ilu0-fix6 L e_packed",
          "entry_us": host_us(lambda: rlmod.spmv_sell_rowlane(pk, x_h)),
          "body_us": host_us(lambda: rlmod._body_cuda(pk, x_h)),
          "launch_us": host_us(lambda: fn_h(
              *pre_h, x_h.data_ptr(), y_h.data_ptr(), *post_h, st_h)),
          "sweep_us": host_us(lambda: inv_h * (
              b_h - rlmod.spmv_sell_rowlane(pk, x_h))),
          "kernel_ms": s3_rows[("spmv_rowlane",
                                "ilu_cg_xl ilu0-fix6 L e_packed")]["ms"]})
    # row 7 on small packs that the cuts split: the bench's
    # trisolve/fixpoint pack (``bench_trisolve``: n = 4096, 8 a row
    # scattered, its strict lower triangle) and a csr_spmv/rowlane-pallas
    # pack (n = 4096, 64 a row), by default, in equal ranges, in ranges cut
    # at tile starts, and at 1-8 slabs a warp each way; each gives A @ x
    import scipy.sparse as sps
    from sparsematrix_tpu_torch.ops.trisolve import trisolve_fixpoint_plan

    resident = rlmod.resident_warps("spmv_rowlane", dev)

    def time_small_rowlane(case, pk, seed):
        sp_e = pack_to_scipy(pk, rlmod._slot_row_col)
        x_e = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            pk.shape[1]).astype(np.float32)).to(dev)
        got = rlmod._rowlane_forward(pk, x_e)
        want_plain = rlmod.spmv_sell_rowlane_reference(pk, x_e)
        torch.cuda.synchronize()
        errs[("spmv_rowlane", case)] = check(
            "spmv_rowlane", case, got, want_plain,
            sp_e.astype(np.float64) @ x_e.double().cpu().numpy(), False)
        flops, nbytes = sparse_work(sp_e, 1, 4)
        bms, by = bound(flops, nbytes)
        S_e = cusparse(sp_e)
        n_warps, spw_equal = rlmod._launch_build(pk, 0, True, None)[1][5:7]
        row = {"kernel": "spmv_rowlane", "case": case,
               "ms": dev_ms(lambda: rlmod._rowlane_forward(pk, x_e)),
               "plain_ms": dev_ms(
                   lambda: rlmod.spmv_sell_rowlane_reference(pk, x_e)),
               "library_ms": dev_ms(lambda: S_e @ x_e),
               "launches": main_launches["spmv_rowlane"], "bound_ms": bms,
               "bound_by": by, "flops": flops, "bytes": nbytes,
               "split_tiles": int(rlmod.rowlane_walk(pk)[1].numel()),
               "resident_warps": resident, "n_warps": n_warps,
               "equal_ranges": spw_equal > 0,
               **rowlane_stats(pk, rlmod.sector_mask(pk))}
        emit({"phase": "timing", **row})
        s3_rows[("spmv_rowlane", case)] = row
        for equal in (True, False):
            name = "equal ranges" if equal else "cut ranges"
            variant("spmv_rowlane", case, name,
                    dev_ms(lambda equal=equal: rlmod._body_cuda(
                        pk, x_e, equal=equal)), row)
            for spw in (1, 2, 4, 8):
                variant("spmv_rowlane", case, f"{name} spw={spw}",
                        dev_ms(lambda spw=spw, equal=equal: rlmod._body_cuda(
                            pk, x_e, spw=spw, equal=equal)), row)

    d_fx = sps.random(4096, 4096, density=8 / 4096, random_state=6,
                      format="csr", dtype=np.float32)
    L_fx = (sps.tril(d_fx, k=-1).tocsr()
            + sps.eye(4096, format="csr", dtype=np.float32) * 4.0)
    time_small_rowlane("trisolve/fixpoint bench pack", trisolve_fixpoint_plan(
        CSR.from_scipy(L_fx.tocsr(), device=dev), lower=True).e_packed, 14)
    time_small_rowlane("n=4096 64 a row", rlmod.pack_sell_rowlane(
        CSR.fromdense(gen_random_dense_sparse(
            np.random.default_rng(15), 4096, 4096, density=64 / 4096),
            device=dev)), 16)
    for key, (case, plan) in wp_stage_inputs.items():
        for st, trip in enumerate(plan.planes):
            W = trip[0].shape[0]
            v = torch.randn((W, 8, 128), device=dev)
            slot = trip[2].long()
            chunk = torch.gather(trip[1].long(), 2, slot)
            posn = torch.gather(trip[0].long().reshape(W, 1024), 1,
                                (chunk * 128 + slot).reshape(W, 1024))
            src = (torch.arange(W, device=dev)[:, None] * 1024
                   + chunk.reshape(W, 1024) * 128 + posn).reshape(-1)
            flat = v.reshape(-1)
            nbytes = 11.0 * v.numel()  # 4 B in, 4 B out, 3 B of planes
            bms, by = bound(0.0, nbytes)
            row = {"kernel": "window_permute", "case": f"{case} stage {st}",
                   "ms": dev_ms(lambda v=v, t=trip: _window_permute_cuda(v, *t)),
                   "plain_ms": dev_ms(
                       lambda v=v, t=trip: window_permute_reference(v, *t)),
                   "library_ms": dev_ms(
                       lambda f=flat, i=src: torch.gather(f, 0, i)),
                   "launches": main_launches["window_permute"],
                   "bound_ms": bms, "bound_by": by, "flops": 0.0,
                   "bytes": nbytes}
            emit({"phase": "timing", **row})
            s3_rows[("window_permute", row["case"])] = row
            del v, slot, chunk, posn, src, flat

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
    # the two routes of a CodebookDense beside each other at both shapes:
    # the JAX package's table lookup + one product, and the fused kernel
    # (row 1), in the same arithmetic; add_mat_mat as the port routes it;
    # the lookup's index widening alone
    for rows_, a_, c_ in ((m, a, c), (4096, a4, c4)):
        def lookup_run(a_=a_, c_=c_):
            return (1.0 * tspmm._spmm_codebook_dense_plain(b_dns, a_.T).T
                    + 1.0 * c_)

        def fused_run(a_=a_, c_=c_):
            return (1.0 * _codebook_spmm_cuda(b_dns.idx, b_dns.val_table,
                                              a_.T).T + 1.0 * c_)

        def routed_run(a_=a_, c_=c_):
            return add_mat_mat(a_, b_dns, c_, 1.0, 1.0)

        emit({"phase": "e2e", "path": f"add_mat_mat {rows_}x{n}x{k} "
              "CodebookDense lookup vs fused kernel",
              "wall_ms": wall_ms(lookup_run), "device_ms": dev_ms(lookup_run),
              "fused_wall_ms": wall_ms(fused_run),
              "fused_device_ms": dev_ms(fused_run),
              "add_mat_mat_wall_ms": wall_ms(routed_run),
              "add_mat_mat_device_ms": dev_ms(routed_run),
              "index_long_device_ms": dev_ms(lambda: b_dns.idx.long())})

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

    # slice 3 end to end: the SpGEMM numeric phase (packs cached), beside
    # torch.sparse.mm of the two CSR operands (cuSPARSE, its symbolic phase
    # included); the Clos apply of C's permutation beside one torch.gather
    # of the map; spmv/spmm on the power-law CSR beside cuSPARSE
    SA, SB = cusparse(sa), cusparse(sb)
    lib_mm = lambda: torch.sparse.mm(SA, SB)  # noqa: E731
    for label, run in [
            ("spgemm_apply_packed XL auto (octet), CSR out",
             lambda: spgemm_apply_packed(pp_auto, B_g.data)),
            ("spgemm_apply_packed_csc XL auto (octet)",
             lambda: spgemm_apply_packed_csc(pp_auto, B_g.data)),
            ("spgemm_apply_packed_csc XL superblock",
             lambda: spgemm_apply_packed_csc(pp_sb, B_g.data)),
            ("spgemm_apply_packed_csc XL rowlane",
             lambda: spgemm_apply_packed_csc(pp_rl, B_g.data))]:
        emit({"phase": "e2e", "path": label, "wall_ms": wall_ms(run),
              "device_ms": dev_ms(run),
              "cusparse_spgemm_wall_ms": wall_ms(lib_mm),
              "cusparse_spgemm_device_ms": dev_ms(lib_mm)})
    y_c = torch.randn(pp_auto.c_nnz, device=dev)
    g_c = pp_auto.c_gather.long().clamp(max=pp_auto.c_nnz - 1)
    emit({"phase": "e2e", "path": "apply_permutation spgemm_xl c_perm "
          f"(q={pp_auto.c_perm.q})",
          "wall_ms": wall_ms(lambda: apply_permutation(pp_auto.c_perm, y_c)),
          "device_ms": dev_ms(lambda: apply_permutation(pp_auto.c_perm, y_c)),
          "gather_device_ms": dev_ms(lambda: torch.gather(y_c, 0, g_c))})
    for tag, (sp_z, A_z, x_z, X_z, _, _) in skew.items():
        S_z = cusparse(sp_z)
        for label, run, lib_run in [
                (f"spmv spmv_skew {tag} (auto)",
                 lambda A_z=A_z, x_z=x_z: spmv(A_z, x_z),
                 lambda S_z=S_z, x_z=x_z: S_z @ x_z),
                (f"spmm spmv_skew {tag} k=32 (auto)",
                 lambda A_z=A_z, X_z=X_z: spmm(A_z, X_z),
                 lambda S_z=S_z, X_z=X_z: S_z @ X_z)]:
            emit({"phase": "e2e", "path": label, "wall_ms": wall_ms(run),
                  "device_ms": dev_ms(run),
                  "cusparse_wall_ms": wall_ms(lib_run),
                  "cusparse_device_ms": dev_ms(lib_run)})
        del S_z

    # slice 4: the trisolve kernels on the checked plans, beside
    # cuSPARSE's triangular solve through torch.triangular_solve with a CSR
    # matrix on the card (its analysis phase runs in every call); the
    # bound is what the solve must move and do (``trisolve_work``)
    lib_note = None

    def tri_library(sp, lower, unit, rhs):
        nonlocal lib_note
        S_t = cusparse(sp)
        B2 = rhs if rhs.dim() == 2 else rhs[:, None]
        try:
            out = torch.triangular_solve(B2, S_t, upper=not lower,
                                         unitriangular=unit)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            lib_note = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            return None
        del out
        return dev_ms(lambda: torch.triangular_solve(
            B2, S_t, upper=not lower, unitriangular=unit))

    s4_rows = {}
    for kname, cases in tri_cases.items():
        for case, kern, plain, plan, sp, lower, unit, rhs in cases:
            R = rhs.shape[1] if rhs.dim() == 2 else 1
            n_t = sp.shape[0]
            # the fused kernel's plan steps are its segments; the walk
            # syncs once a wave (``waves``, ``us_a_wave``)
            steps = (plan.aux.shape[0] if kname == "trisolve_fused"
                     else plan.S if plan.mode == "chain" else plan.n_waves)
            flops, nbytes = trisolve_work(kname, plan, n_t, R)
            bms, by = bound(flops, nbytes)
            row = {"kernel": kname, "case": case, "ms": dev_ms(kern),
                   # the plain walk of 10 223 segments takes seconds: one
                   # call on the host's clock
                   "plain_ms": (wall_once_ms(plain) if case == FUSED_1024
                                else dev_ms(plain)),
                   "library_ms": tri_library(sp, lower, unit, rhs),
                   "launches": main_launches[kname], "bound_ms": bms,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "dependent_steps": int(steps)}
            row["us_a_step"] = 1e3 * row["ms"] / int(steps)
            if kname == "trisolve_fused":
                walk = tfmod.fused_walk(plan)
                row.update(waves=walk.n_waves,
                           us_a_wave=1e3 * row["ms"] / walk.n_waves,
                           chunks=walk.n_chunks, rows=walk.rows,
                           entries=walk.entries,
                           entries_from_cache=walk.cached, lanes=walk.lanes)
            emit({"phase": "timing", **row})
            s4_rows[(kname, case)] = row
            if case in ("ic0 L Poisson 256^2 (K=2)",
                        "ic0 L Poisson 256^2 k=8"):
                chain_variants(kname, case, plan, R, row)
            if case in ("fused ic0 L Poisson 256^2", FUSED_1024):
                fused_variants(case, plan, rhs, row)
    emit({"phase": "library_note", "call": "torch.triangular_solve(B, "
          "A_csr)", "absent_because": lib_note})

    # the solver cells end to end: the time of an iteration from a tol=0
    # run of 25 iterations (device and wall), iterations to tol (main
    # path), wall ms to tol; and where an ic0-waves iteration spends its
    # time (one SpMV and one preconditioner apply, device)
    for (cell, label), (op, b_c, M, maxiter, iters) in cg_cells.items():
        run = (lambda op=op, b_c=b_c, M=M:
               cg(op, b_c, tol=0.0, maxiter=25, M=M))
        dms, wms = dev_ms(run) / 25, wall_ms(run) / 25
        emit({"phase": "e2e", "path": f"cg {cell}/{label}",
              "per_iter_device_ms": dms, "per_iter_wall_ms": wms,
              "iters_to_tol": iters, "ms_to_tol": wms * iters,
              "device_ms_to_tol": dms * iters})
        if label == "ic0-waves" and cell == "ilu_cg_xl":
            r_c = torch.randn_like(b_c)
            emit({"phase": "breakdown", "path": f"cg {cell}/{label}",
                  "spmv_device_ms": dev_ms(lambda: spmv(op, r_c)),
                  "precond_device_ms": dev_ms(lambda: M(r_c)),
                  "per_iter_device_ms": dms, "per_iter_wall_ms": wms})
    for label, (mm, M, iters) in block_cells.items():
        run = (lambda mm=mm, M=M:
               block_cg(mm, B_bc, tol=0.0, maxiter=25, M=M))
        dms, wms = dev_ms(run) / 25, wall_ms(run) / 25
        emit({"phase": "e2e", "path": f"block_cg_xl/{label}",
              "per_iter_device_ms": dms, "per_iter_wall_ms": wms,
              "iters_to_tol": iters, "ms_to_tol": wms * iters,
              "device_ms_to_tol": dms * iters})

    # slice 5: each new kernel and shape beside its plain version, cuSPARSE
    # on the same CSR (SpMV, or SpMM for a matrix right-hand side) and, for
    # the octet SpMM, the port's k_tiles=1 dual-gather walk on the same
    # matrix; the bound is ``sparse_work``'s (plane padding counts against
    # the kernel)
    s5_rows = {}
    for kname, cases in s5_cases.items():
        for case, kern, plain, sp_c, rhs, extra in cases:
            k_rhs = 1 if rhs.dim() == 1 else rhs.shape[1]
            flops, nbytes = sparse_work(sp_c, k_rhs, 4)
            bms, by = bound(flops, nbytes)
            if id(sp_c) not in yardsticks:
                yardsticks[id(sp_c)] = cusparse(sp_c)
            S = yardsticks[id(sp_c)]
            row = {"kernel": kname, "case": case, "ms": dev_ms(kern),
                   "plain_ms": dev_ms(plain),
                   "library_ms": dev_ms(lambda S=S, rhs=rhs: S @ rhs),
                   "launches": main_launches[kname], "bound_ms": bms,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "nnz": int(sp_c.nnz)}
            if extra.get("walk") is not None:
                row["kt1_walk_ms"] = dev_ms(
                    lambda W=extra["walk"], rhs=rhs:
                    _spmm_dualgather_cuda(W, rhs))
            if extra.get("tail") is not None:
                row.update(tail_stats(extra["tail"]))
            if extra.get("sell") is not None:
                row.update(sell_stats(extra["sell"]))
            emit({"phase": "timing", **row})
            s5_rows[(kname, case)] = row
            if extra.get("tail") is not None:
                tail_variants(case, extra["tail"], rhs, row)
            if extra.get("sell") is not None:
                sell_variants(case, extra["sell"], rhs, row)
    # the spill-cap packs and the SELL packs through the public spmv,
    # beside the auto pack of the same XL CSR; BiCGSTAB's iteration
    for label, run in [
            ("spmv XL spill_cap=auto k_tiles=1", lambda: spmv(P_sp1, x_xl)),
            ("spmv XL spill_cap=auto k_tiles=8", lambda: spmv(P_sp8, x_xl)),
            ("spmm XL spill_cap=auto k_tiles=8 k=32",
             lambda: spmm(P_sp8, X_xl)),
            ("spmv XL auto pack (no cap)", lambda: spmv(P_sb, x_xl)),
            ("spmm XL auto pack (no cap) k=32", lambda: spmm(P_sb, X_xl))]:
        emit({"phase": "e2e", "path": label, "wall_ms": wall_ms(run),
              "device_ms": dev_ms(run)})
    for label, (M, iters) in bicg_cells.items():
        run = (lambda M=M: bicgstab(Ap_cv, b_cv, tol=0.0, maxiter=25, M=M))
        dms, wms = dev_ms(run) / 25, wall_ms(run) / 25
        emit({"phase": "e2e", "path": f"bicgstab convection n={n_cv}/{label}",
              "per_iter_device_ms": dms, "per_iter_wall_ms": wms,
              "iters_to_tol": iters, "ms_to_tol": wms * iters,
              "device_ms_to_tol": dms * iters})

    # slice 6: each BSR kernel and shape beside its plain version, the
    # library's BSR product (torch.sparse_bsr_tensor @ X,
    # where this torch takes it; else cuSPARSE CSR of the same matrix,
    # named in ``library``) and, on the bench's bsr point, cuBLAS of the
    # densified matrix (the densify route's own product); then the BSR
    # paths end to end and block CG's iteration on the BSR operator
    lib_mats = {}

    def bsr_library(A_c, X_c):
        """(label, call) of the library's product of A_c and X_c."""
        key = (id(A_c), X_c.dtype)
        if key in lib_mats:
            return lib_mats[key]
        bm, bn = A_c.block_shape
        nb = A_c.num_blocks
        size = (A_c.num_block_rows * bm, -(-A_c.shape[1] // bn) * bn)
        def csr():
            sp_c = A_c.to_scipy()
            return torch.sparse_csr_tensor(
                torch.from_numpy(sp_c.indptr.astype(np.int64)),
                torch.from_numpy(sp_c.indices.astype(np.int64)),
                torch.from_numpy(sp_c.data.astype(np.float32)),
                size=sp_c.shape).to(dev)

        notes = []
        for label, make in [
                ("torch.sparse_bsr_tensor @ X",
                 lambda: (torch.sparse_bsr_tensor(
                     A_c.indptr.long(), A_c.indices[:nb].long(),
                     A_c.data[:nb].to(X_c.dtype), size=size), X_c)),
                ("cuSPARSE CSR", lambda: (csr().to(X_c.dtype), X_c)),
                ("cuSPARSE CSR fp32", lambda: (csr(), X_c.float()))]:
            try:
                S, Xl = make()
                torch.matmul(S, Xl)
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError) as e:
                notes.append(f"{label}: {type(e).__name__}: "
                             f"{str(e).splitlines()[0][:100]}")
                continue
            lib_mats[key] = (label + (f" (refused: {notes})" if notes
                                      else ""),
                             lambda S=S, Xl=Xl: S @ Xl)
            return lib_mats[key]
        raise RuntimeError(f"no library product of the BSR: {notes}")

    s6_rows = {}
    for kname, cases in s6_cases.items():
        for case, kern, plain, A_c, X_c in cases:
            flops, nbytes = bsr_work(A_c, X_c.shape[1],
                                     A_c.data.element_size(),
                                     X_c.element_size())
            # bf16 blocks and X: the operations at the card's bf16 rate
            bf16 = (A_c.data.dtype == X_c.dtype == torch.bfloat16)
            bms, by = bound(flops, nbytes, PEAK_BF16 if bf16 else PEAK_FP32)
            lib_name, lib = bsr_library(A_c, X_c)
            row = {"kernel": kname, "case": case, "ms": dev_ms(kern),
                   "plain_ms": dev_ms(plain), "library_ms": dev_ms(lib),
                   "library": lib_name,
                   "launches": main_launches[kname], "bound_ms": bms,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "num_blocks": A_c.num_blocks}
            if case.startswith("bench (8,8) k=128"):
                D = A_c.todense()
                row["cublas_dense_ms"] = dev_ms(lambda D=D, X_c=X_c: D @ X_c)
                del D
            emit({"phase": "timing", **row})
            s6_rows[(kname, case)] = row
    del lib_mats
    # row 4's two designs forced both ways (kernels/bsr.py panel_plan):
    # each gives the product, held against the plain version at the
    # check's tolerance (1e-5 of its scale)
    for case, P_c, X_c in [("block_cg_xl Poisson (8,8) k=8", P_pob, X_pob),
                           ("XL (8,8) k=8", P_xb, X_xb8),
                           ("XL (8,8) k=32", P_xb, X_xb32),
                           ("XL (8,8) k=128", P_xb, X_xb)]:
        plain_c = kb.spmm_bsr_panel_reference(P_c, X_c)
        tol = 1e-5 * max(float(plain_c.abs().max()), 1e-30)
        for design in kb.DESIGNS:
            def run(P_c=P_c, X_c=X_c, design=design):
                return kb._spmm_bsr_panel_cuda(P_c, X_c, design=design)
            err = float((run() - plain_c).abs().max())
            variant("spmm_bsr_panel", case, f"design={design}", dev_ms(run),
                    s6_rows[("spmm_bsr_panel", case)], max_abs_err=err,
                    tol=tol, default=kb.panel_plan(P_c, X_c.shape[1]).design)
            if not err <= tol:
                failures.append(f"variant spmm_bsr_panel {case} {design}")
        del plain_c
    # row 3's two designs forced both ways (kernels/bsr.py grouped_design):
    # each gives the product, held against the plain version at the
    # check's tolerance
    for case, A_c in [("(128,128) n=16384 k=128", A_big),
                      ("(64,64) n=16384 k=128", A_64),
                      ("(32,128) n=16384 k=128", A_32)]:
        plain_c = kb.spmm_bsr_grouped_reference(A_c, X_big)
        tol = 1e-5 * max(float(plain_c.abs().max()), 1e-30)
        for design in kb.GROUPED_DESIGNS:
            def run(A_c=A_c, design=design):
                return kb._spmm_bsr_cuda(A_c, X_big, design=design)
            err = float((run() - plain_c).abs().max())
            variant("spmm_bsr", case, f"design={design}", dev_ms(run),
                    s6_rows[("spmm_bsr", case)], max_abs_err=err, tol=tol,
                    default=kb.grouped_design(A_c))
            if not err <= tol:
                failures.append(f"variant spmm_bsr {case} {design}")
        del plain_c
    # row 3 at (128,128): bf16 blocks and X (within one bf16 step of the
    # plain version's largest output), the tile kernel's other rings and
    # 64-column tiles (the product, at the fp32 tolerance), and the
    # ablations (the tiles alone, the partials' sums alone: not the
    # product)
    case = "(128,128) n=16384 k=128"
    base = s6_rows[("spmm_bsr", case)]
    A16, X16 = A_big.astype(torch.bfloat16), X_big.to(torch.bfloat16)
    plain_c = kb.spmm_bsr_grouped_reference(A16, X16).float()
    tol = 2.0 ** -7 * max(float(plain_c.abs().max()), 1e-30)
    err = float((kb._spmm_bsr_cuda(A16, X16).float() - plain_c).abs().max())
    variant("spmm_bsr", case, "bf16 blocks and X",
            dev_ms(lambda: kb._spmm_bsr_cuda(A16, X16)), base,
            max_abs_err=err, tol=tol)
    if not err <= tol:
        failures.append(f"variant spmm_bsr {case} bf16")
    del A16, X16
    plain_c = kb.spmm_bsr_grouped_reference(A_big, X_big)
    tol = 1e-5 * max(float(plain_c.abs().max()), 1e-30)
    knobs = [(f"ring={r}", dict(ring=r)) for r in kb.tile_rings(128)[1:]]
    knobs += [("tc=64", dict(tc=64)),
              ("tc=64 split=1000", dict(tc=64, split=1000))]
    for name, kw in knobs:
        err = float((kb._spmm_bsr_cuda(A_big, X_big, **kw) - plain_c)
                    .abs().max())
        variant("spmm_bsr", case, name, dev_ms(
            lambda kw=kw: kb._spmm_bsr_cuda(A_big, X_big, **kw)), base,
            max_abs_err=err, tol=tol)
        if not err <= tol:
            failures.append(f"variant spmm_bsr {case} {name}")
    for parts, name in ((1, "tiles alone (no sums)"), (2, "sums alone")):
        variant("spmm_bsr", case, name, dev_ms(
            lambda parts=parts: kb._spmm_bsr_cuda(A_big, X_big,
                                                  parts=parts)), base)
    del plain_c
    for label, run in [
            ("spmm XL BSR (8,8) k=128", lambda: spmm(A_xb, X_xb)),
            ("spmm BSR (128,128) n=16384 k=128", lambda: spmm(A_big, X_big)),
            ("spmm bench BSR (8,8) method=sparse",
             lambda: spmm(A_bb, X_bb, method="sparse")),
            ("spmm bench BSR (8,8) method=auto", lambda: spmm(A_bb, X_bb)),
            ("spmv XL BSR (8,8)", lambda: spmv(A_xb, x_xb))]:
        emit({"phase": "e2e", "path": label, "wall_ms": wall_ms(run),
              "device_ms": dev_ms(run)})
    for label, run, iters in [
            ("block_cg_xl/block-plain BSR (8,8)",
             lambda: block_cg(A_pob, B_bc, tol=0.0, maxiter=25),
             bsr_block_iters),
            ("cg ilu_cg_xl/plain BSR (8,8)",
             lambda: cg(A_pob, b_pob, tol=0.0, maxiter=25), bsr_cg_iters)]:
        dms, wms = dev_ms(run) / 25, wall_ms(run) / 25
        emit({"phase": "e2e", "path": label, "per_iter_device_ms": dms,
              "per_iter_wall_ms": wms, "iters_to_tol": iters,
              "ms_to_tol": wms * iters, "device_ms_to_tol": dms * iters})
    mark("timings, slices 1-6")

    # slice 7: row 8 beside its bound, its plain version and cuSPARSE
    # (torch.sparse.mm of the same CSR); then the world-size-1 dist paths
    # end to end (device and wall), each beside its local kernel alone
    # where it has one (the rest of the device time is the NCCL copy and
    # the slicing), and dist_cg's iteration
    s7_rows = {}
    for case, P_c, X_c, sp_c, vb in s7_cases:
        flops, nbytes = sparse_work(sp_c, X_c.shape[1], vb)
        bms, by = bound(flops, nbytes)
        if id(sp_c) not in yardsticks:
            yardsticks[id(sp_c)] = cusparse(sp_c)
        S = yardsticks[id(sp_c)]
        row = {"kernel": "spmm_rowlane", "case": case,
               "ms": dev_ms(lambda: _spmm_rowlane_cuda(P_c, X_c)),
               "plain_ms": dev_ms(lambda: spmm_rowlane_reference(P_c, X_c)),
               "library_ms": dev_ms(lambda: S @ X_c),
               "library": "cuSPARSE SpMM (torch.sparse.mm)",
               "launches": main_launches["spmm_rowlane"], "bound_ms": bms,
               "bound_by": by, "flops": flops, "bytes": nbytes,
               "plane_bytes": container_bytes(P_c), "n_slabs": P_c.n_slabs}
        emit({"phase": "timing", **row})
        s7_rows[case] = row
    # row 8's window walk (the product) and the first design's gather
    # walk (a measurement variant), each held against the plain version,
    # and the gather walk's parts (ablations: not the product)
    rlm = importlib.import_module("sparsematrix_tpu_torch.kernels.spmm_rowlane")
    for case, P_c, X_c, _, _ in s7_cases:
        plain_c = spmm_rowlane_reference(P_c, X_c)
        tol = 1e-5 * max(float(plain_c.abs().max()), 1e-30)
        base = s7_rows[case]
        for design in rlm.DESIGNS:
            def run(P_c=P_c, X_c=X_c, design=design):
                return _spmm_rowlane_cuda(P_c, X_c, design=design)
            err = float((run() - plain_c).abs().max())
            variant("spmm_rowlane", case, f"design={design}", dev_ms(run),
                    base, max_abs_err=err, tol=tol,
                    default="window")
            if not err <= tol:
                failures.append(f"variant spmm_rowlane {case} {design}")
        for part, name in ((1, "gather walk, no X read"),
                           (2, "gather walk, no panel update"),
                           (3, "gather walk, planes and compaction alone")):
            variant("spmm_rowlane", case, name, dev_ms(
                lambda P_c=P_c, X_c=X_c, part=part: _spmm_rowlane_cuda(
                    P_c, X_c, design="gather", parts=part)), base)
        del plain_c
    dg_local = ddg.local_dg(part_dg_full, part_dg)
    local_kernels = {
        "dist_spmm_rowlane XL k=32": lambda: _spmm_rowlane_cuda(P_rlx, X_xl),
        "dist_spmv_rowlane XL": lambda: rlmod.spmv_sell_rowlane(P_rlx, x_xl),
        "dist_spmv_dualgather XL":
            lambda: dgmod._spmv_dualgather_cuda(dg_local, x_xl),
        "dist_spmm_dualgather XL k=32":
            lambda: _spmm_dualgather_cuda(dg_local, X_xl)}
    for name, run in s7_paths.items():
        row = {"phase": "e2e", "path": name, "world_size": 1,
               "wall_ms": wall_ms(run), "device_ms": dev_ms(run)}
        if name in local_kernels:
            row["local_kernel_ms"] = dev_ms(local_kernels[name])
            row["local_share"] = row["local_kernel_ms"] / row["device_ms"]
        emit(row)
    for label, (precond, iters) in s7_cg.items():
        run = (lambda precond=precond: par.dist_cg(
            part_po, b_pob, mesh, precond=precond, tol=0.0, maxiter=25))
        dms, wms = dev_ms(run) / 25, wall_ms(run) / 25
        emit({"phase": "e2e", "path": f"dist_cg ilu_cg_xl {label}",
              "world_size": 1, "per_iter_device_ms": dms,
              "per_iter_wall_ms": wms, "iters_to_tol": iters,
              "ms_to_tol": wms * iters, "device_ms_to_tol": dms * iters})
    dist.destroy_process_group()
    mark("timings, slice 7")

    # slice 8: row 22 at the calibrate row's 128 MiB and the cross-check
    # probe's 256 MiB (the timer's linearity), beside its plain version
    # (``x.clone()``) and the library's device copy (``y.copy_(x)`` into a
    # preallocated y, a cudaMemcpyAsync); the bound is each byte read once
    # and written once at HBM's rate
    s8_rows = {}
    for n_el in (MIB128, 2 * MIB128):
        x_s = torch.randn(n_el, device=dev)
        y_s = torch.empty_like(x_s)
        bms, by = bound(0.0, 8.0 * n_el)
        case = f"{n_el * 4 >> 20} MiB fp32"
        row = {"kernel": "stream_copy", "case": case,
               "ms": dev_ms(lambda x_s=x_s: _stream_copy_cuda(x_s)),
               "plain_ms": dev_ms(lambda x_s=x_s: stream_copy_reference(x_s)),
               "library_ms": dev_ms(lambda x_s=x_s, y_s=y_s: y_s.copy_(x_s)),
               "library": "y.copy_(x) (cudaMemcpyAsync)",
               "launches": main_launches["stream_copy"], "bound_ms": bms,
               "bound_by": by, "flops": 0.0, "bytes": 8.0 * n_el}
        row["gb_per_s"] = 8.0 * n_el / (row["ms"] * 1e-3) / 1e9
        emit({"phase": "timing", **row})
        s8_rows[case] = row
        copy_variants(case, x_s, row)
        del x_s, y_s
    emit({"phase": "timing", "kernel": "stream_copy",
          "case": "256 MiB / 128 MiB time ratio",
          "ratio": s8_rows["256 MiB fp32"]["ms"] / s8_rows["128 MiB fp32"]["ms"]})
    mark("timings, slice 8")

    # -- 6. probes ------------------------------------------------------------
    probe_rows = run_probes(dev, sp_xl, x_xl_np, A_xl, x_xl, errs, failures,
                            main_launches)
    mark("probes")

    if failures:
        print("chip_smoke: FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
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
    for name, src, replaces, case in [
            ("window_permute", "window_permute.cu", "permute_pallas.py:61",
             f"{wp_stage_inputs['c_perm'][0]} stage 0"),
            ("spmv_octet", "spmv_octet.cu", "spmv_octet.py:452",
             "spgemm_xl P auto octet"),
            ("spmv_rowlane", "spmv_rowlane.cu", "spmv_rowlane.py:397",
             "spgemm_xl P rowlane L=1"),
            ("spmv_superblock", "spmv_superblock.cu", "spmv_superblock.py:179",
             "spgemm_xl P superblock")]:
        row = s3_rows[(name, case)]
        err_case = case.rsplit(" stage ", 1)[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sparsematrix_tpu_torch/csrc/{src}",
            "replaces": f"sparsematrix_tpu/kernels/{replaces}",
            "launches": main_launches[name],
            "max_abs_err": errs[(name, err_case)], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": case})
    for name, replaces, case in [
            ("trisolve_fused", "trisolve_fused.py:354",
             "fused ic0 L Poisson 256^2"),
            ("trisolve_chain", "trisolve_waves.py:419",
             "ic0 L Poisson 256^2 (K=2)"),
            ("trisolve_binv", "trisolve_waves.py:521",
             "scattered L n=65536 8/row (m=8)"),
            ("trisolve_chain_mm", "trisolve_waves.py:636",
             "ic0 L Poisson 256^2 k=8")]:
        row = s4_rows[(name, case)]
        src = "trisolve_fused.cu" if name == "trisolve_fused" else \
            "trisolve_waves.cu"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sparsematrix_tpu_torch/csrc/{src}",
            "replaces": f"sparsematrix_tpu/kernels/{replaces}",
            "launches": main_launches[name],
            "max_abs_err": errs[(name, case)], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": case})
    for name, src, replaces, case in [
            ("spmm_octet", "spmm_octet.cu", "spmv_octet.py:632",
             "spmm_xl octet-mm k=32"),
            ("spmv_pooled", "spmv_pooled.cu", "spmv_dualgather.py:1070",
             "XL tail (spill_cap=auto) k_tiles=8 k=1"),
            ("spmv_sell", "spmv_sell.cu", "spmv_pallas.py:197",
             "sell XL tr=64"),
            ("spmv_sell_rowpure", "spmv_sell.cu", "spmv_pallas.py:401",
             "rowpure XL group=4 R=16")]:
        row = s5_rows[(name, case)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sparsematrix_tpu_torch/csrc/{src}",
            "replaces": f"sparsematrix_tpu/kernels/{replaces}",
            "launches": main_launches[name],
            "max_abs_err": errs[(name, case)], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": case})
    case = "XL k=32 (partition_rowlane, 1 rank)"
    row = s7_rows[case]
    kernels.append({
        "name": "spmm_rowlane", "route": "cuda",
        "source": "sparsematrix_tpu_torch/csrc/spmm_rowlane.cu",
        "replaces": "sparsematrix_tpu/kernels/spmm_rowlane.py:71",
        "launches": main_launches["spmm_rowlane"],
        "max_abs_err": errs[("spmm_rowlane", case)], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "case": case})
    for name, case in [("spmm_bsr", "(128,128) n=16384 k=128"),
                       ("spmm_bsr_panel", "XL (8,8) k=128")]:
        row = s6_rows[(name, case)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sparsematrix_tpu_torch/csrc/spmm_bsr.cu",
            "replaces": "sparsematrix_tpu/kernels/bsr_pallas.py:" + (
                "62" if name == "spmm_bsr" else "159"),
            "launches": main_launches[name],
            "max_abs_err": errs[(name, case)], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": case})
    case = "128 MiB fp32"
    row = s8_rows[case]
    kernels.append({
        "name": "stream_copy", "route": "cuda",
        "source": "sparsematrix_tpu_torch/csrc/stream_copy.cu",
        "replaces": "sparsematrix_tpu/bench/suite.py:112",
        "launches": main_launches["stream_copy"],
        "max_abs_err": errs[("stream_copy", f"n={MIB128} aligned")],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "case": case})
    for name, src, replaces, key, case in PROBE_LINE:
        row = probe_rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sparsematrix_tpu_torch/csrc/{src}",
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
