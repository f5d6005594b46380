"""The port's headline benchmark: prints ONE JSON line.

Twin of the repository's ``bench.py``: the reference's own benchmark
workload (sparse AddMatMat, m×n×k = 117×1023×2047, 25 %-dense
codebook-quantized B, fp32) through the port's paths on the card::

    python -m sparsematrix_tpu_torch.bench.headline

``vs_baseline`` is the reference's published AVX2 figure (7.5 ms,
``kernel.cc:381``) divided by the measured min time.  The headline is
the fastest sparse row that passed its check.
"""
from __future__ import annotations

import json

from .suite import REF_K, REF_M, REF_N, bench_codebook_gemm

__all__ = ["VARIANTS", "headline", "main"]

# bench.py's variants: the recommended paths for this workload (the full
# comparison matrix lives in the suite CLI)
VARIANTS = ("fused-pallas", "dense-dequant", "dense-dequant-bf16",
            "fused-pallas-bf16", "int8-gemm", "int16-gemm")


def headline(device=None, m=REF_M, n=REF_N, k=REF_K) -> dict:
    """The headline record (``bench.py``'s keys) from one
    ``bench_codebook_gemm`` run."""
    rows = bench_codebook_gemm(check=True, variants=VARIANTS, device=device,
                               ref_m=m, ref_n=n, ref_k=k)
    # the dense-race rows are the races, not the headline
    sparse = [r for r in rows if "dense-race" not in r.name]
    ok = [r for r in sparse if r.checked] or sparse
    r = min(ok, key=lambda r: r.result.min_ms)
    out = {
        "metric": f"codebook_sparse_gemm_{m}x{n}x{k}_ms",
        "path": r.name,
        "value": round(r.result.min_ms, 4),
        "unit": "ms",
        "vs_baseline": round(r.extras["vs_baseline"], 2),
        "checked": r.checked,
        "nnz": r.nnz,
        "gnnz_per_s": round(r.nnz_per_s / 1e9, 3),
        "mean_ms": round(r.result.mean_ms, 4),
        "compile_ms": round(r.result.compile_ms, 1),
    }
    for rr in rows:
        if rr.name == "codebook_gemm/dense-race-fp32":
            out["dense_race_fp32_ms"] = round(rr.result.min_ms, 4)
        elif rr.name == "codebook_gemm/dense-race-bf16":
            out["dense_race_bf16_ms"] = round(rr.result.min_ms, 4)
    return out


def main():
    print(json.dumps(headline()))


if __name__ == "__main__":
    main()
