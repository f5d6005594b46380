// Fused triangular solve x = T^-1 b over a level-ordered slab program: the
// device half of kernels/trisolve_fused.py.
//
// Replaces the Pallas kernel _fused_kernel of
// sparsematrix_tpu/kernels/trisolve_fused.py (_fused_call, pallas_call at
// :354).  x is an (S, 128) vector, S = n_win*8, that starts as inv_diag*b
// (binv, padded).  The plan is a run of (level, tile) segments in
// level-major order; a segment's slabs gather x at columns of earlier
// levels, and it commits the lanes of its tile that its gate row selects:
//     x_r = binv_r - (sum over the segment's slots of row r: vals * x[col])
//                    * inv_diag_r.
//
// What bounds it: latency.  The commits form a chain of dependent steps;
// the bytes (the nonzero slots' values and columns, read once) are small.
//
// The first design walked the segments in program order, one block a
// segment drawn from a global ticket, each block spinning on a global
// counter of committed segments and reading x back through L2: two L2
// round trips and a device-scope fence a segment, 1.8 us.  But the
// segments of one level are independent.  Here the host
// (kernels/trisolve_fused.py fused_walk, built once a plan) numbers each
// segment's wave from the plan's planes, the segments whose commits its
// nonzero slots read plus one, and lists the committed rows wave by wave
// in chunks: a row's record (its index, its entries, gate*inv_diag) and its
// nonzero slots' (column, value).  Zero slots are gone (5.9 % of a slab's
// slots hold a value on the 256^2 IC(0) factor), and a commit writes only
// its own rows, so two segments of one tile may share a wave.
//
// One launch walks the chunks in order on one block of 31 consumer warps
// and a producer warp:
//   - the producer streams the chunks through a ring of shared-memory
//     stages by 1-D TMA copies (bulk.cuh), each with the run of binv that
//     spans its rows (a level-sorted plan's rows of a wave are one run),
//     and refills a stage when the consumers' `empty` barrier says they
//     are done with it;
//   - `lanes` consumer threads share a row: each loads its stride of the
//     row's entries four at a time, then sums them in order, and a
//     shuffle tree sums the lanes, so a row's partials meet in a fixed
//     order and x's bits repeat from call to call;
//   - the block keeps the last rows it committed in shared memory (a
//     direct-mapped cache of 8192 rows, written at every commit), and an
//     entry whose column the host found still there when it is read
//     (kernels/trisolve_fused.py _cache_flags) reads it from there; the
//     rest read x through L1, which the block's barrier keeps coherent
//     with its own stores;
//   - lane 0 writes x_r; thread 0 waits until the next chunk has landed,
//     then one named barrier of the consumers, which the producer never
//     joins.  So a wave costs one barrier and one wait of one thread, and
//     no global load but of rows the cache does not hold.
// A wave whose chunk outgrows the cut size is several chunks, a barrier
// each.  x stays in global memory: trisolve() sends this kernel every
// n > 524288, where x outgrows shared memory.  No block waits on another.
// The first cut had every thread wait on each chunk's barrier and a
// consumer thread refill the ring between two barriers: 0.65 us a wave in
// those waits and refills alone, 1.0 us in all.  A cluster of 2-16 blocks
// that split each chunk's rows, with a cluster barrier a chunk and x read
// with L1 bypassed, took 1.4-1.6 us a wave (PERF.md §6).
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCons = kThreads - 32;  // the consumers; the last warp streams
constexpr int kMaxStages = 16;
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full, then empty
constexpr size_t kSmemMax = 232448;  // a block's shared memory, sm_90
constexpr int kCached = 1 << 31;     // a column's flag: read from the cache
constexpr int kBatch = 4;            // a thread's entries loaded together

// x at an entry's column: from the cache where the flag says it holds the
// row, else from global memory (written by this block: coherent in L1
// after its barrier).
__device__ __forceinline__ float entry_x(const float* x, const float* xc,
                                         int col, int cmask) {
  if (col & kCached) return xc[col & cmask];
  return x[col & ~kCached];
}

// The consumers' barrier (named barrier 1; the producer warp never joins).
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCons) : "memory");
}

// chunk_off: (n_chunks + 1) byte offsets into blob; span (n_chunks, 2)
// int32: the first row (a multiple of 4, or -1) and the rows (a multiple
// of 4) of x's run that the chunk's binv lies in; x: binv, solved in place
// (a row's own x is binv until its commit); stage: bytes of a stage's
// chunk, then xbb of its run of binv; nst stages (<= n_chunks); cache: rows
// of x kept in shared memory (a power of two); lanes: threads a row (a
// power of two); ablate (a measurement, not x but for 4): 1 stores
// no x to global memory, 2 does no row's work (the waits, refills and
// barriers alone), 3 only the barriers, 4 the solve without the runs of
// binv (each row's read from x).
__global__ void __launch_bounds__(kThreads, 1)
    wave_walk(const unsigned char* __restrict__ blob,
              const long long* __restrict__ chunk_off,
              const int2* __restrict__ span, int n_chunks, float* x,
              int stage, int xbb, int nst, int cache, int lanes,
              int ablate) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kMaxStages;
  float* xc = reinterpret_cast<float*>(sm + kBarBytes);
  unsigned char* ring = sm + kBarBytes + (size_t)cache * 4;
  const int sb = stage + xbb;  // a stage's bytes
  const int tid = threadIdx.x;
  const int cmask = cache - 1;
  auto fetch = [&](int i) {  // chunk i and its run of binv into stage i
    const int s = i % nst;
    const long long o = __ldg(chunk_off + i);
    const uint32_t bytes = (uint32_t)(__ldg(chunk_off + i + 1) - o);
    const int2 run = ablate == 4 ? make_int2(-1, 0) : __ldg(span + i);
    unsigned char* st = ring + (size_t)s * sb;
    bulk::expect_tx(full + s, bytes + (run.x >= 0 ? 4u * run.y : 0u));
    bulk::load(st, blob + o, bytes, full + s);
    if (run.x >= 0) bulk::load(st + stage, x + run.x, 4u * run.y, full + s);
  };
  if (tid == kCons) {
    for (int s = 0; s < nst; ++s) {
      bulk::init(full + s, 1);
      bulk::init(empty + s, 1);
    }
    bulk::fence_init();
    for (int i = 0; i < nst; ++i) fetch(i);
    bulk::wait(full, 0);  // chunk 0, before the consumers start
  }
  if (ablate == 3) {
    if (tid == kCons)  // no copy is left in flight at the exit
      for (int s = 1; s < nst; ++s) bulk::wait(full + s, 0);
    for (int i = 0; i < n_chunks; ++i) __syncthreads();
    return;
  }
  __syncthreads();
  if (tid >= kCons) {  // the producer warp
    if (tid == kCons)
      for (int i = 0; i + nst < n_chunks; ++i) {
        bulk::wait(empty + i % nst, (i / nst) & 1);
        fetch(i + nst);
      }
    return;
  }
  const int W = lanes, g = tid / W, j = tid % W;
  const int groups = kCons / W;
  const unsigned mask =
      W == 32 ? 0xffffffffu : ((1u << W) - 1) << ((tid & 31) & ~(W - 1));
  for (int i = 0; i < n_chunks; ++i) {
    const unsigned char* st = ring + (size_t)(i % nst) * sb;
    const int* hd = reinterpret_cast<const int*>(st);
    const int nr = ablate == 2 ? 0 : hd[0];
    const int lo = ablate == 4 ? -1 : hd[2];  // the run's first row, or -1
    const float* xb_run = reinterpret_cast<const float*>(st + stage);
    const int4* rows = reinterpret_cast<const int4*>(hd + 4);
    const int2* ent = reinterpret_cast<const int2*>(hd + 4 + 4 * hd[0]);
    for (int r = g; r < nr; r += groups) {
      const int4 rec = rows[r];
      float acc = 0.f;
      for (int e0 = rec.y + j; e0 < rec.z; e0 += kBatch * W) {
        float v[kBatch], xv[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = e0 + q * W;
          v[q] = 0.f;
          xv[q] = 0.f;
          if (e < rec.z) {
            const int2 en = ent[e];
            v[q] = __int_as_float(en.y);
            xv[q] = entry_x(x, xc, en.x, cmask);
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (e0 + q * W < rec.z) acc = fmaf(v[q], xv[q], acc);
      }
      for (int off = W >> 1; off > 0; off >>= 1)
        acc += __shfl_down_sync(mask, acc, off, W);
      if (j == 0) {
        const float xb = lo >= 0 ? xb_run[rec.x - lo] : x[rec.x];
        const float xr = xb - __fmul_rn(acc, __int_as_float(rec.w));
        if (ablate != 1) x[rec.x] = xr;
        xc[rec.x & cmask] = xr;
      }
    }
    // the next chunk has landed (thread 0 waits; the barrier tells the
    // rest), and every commit of this one is made
    if (tid == 0 && i + 1 < n_chunks)
      bulk::wait(full + (i + 1) % nst, ((i + 1) / nst) & 1);
    consumer_barrier();
    if (tid == 0) bulk::arrive(empty + i % nst);  // the stage is free
  }
}

cudaError_t launch(const unsigned char* blob, const long long* off,
                   const int2* span, int n_chunks, float* x, int stage,
                   int xbb, int nst, int cache, int lanes, int ablate,
                   cudaStream_t st) {
  static thread_local bool ready = false;  // the function's attribute, once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        wave_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const size_t smem =
      kBarBytes + (size_t)cache * 4 + (size_t)nst * (stage + xbb);
  wave_walk<<<1, kThreads, smem, st>>>(blob, off, span, n_chunks, x, stage,
                                       xbb, nst, cache, lanes, ablate);
  return cudaGetLastError();
}

}  // namespace

// blob/chunk_off/span: the plan's walk (kernels/trisolve_fused.py
// FusedWalk), chunk_off (n_chunks + 1,) int64 byte offsets, each a
// multiple of 16, span (n_chunks, 2) int32; x (S*128) fp32 holds binv and
// is solved in place; stage_bytes: the largest chunk; span_bytes: the
// largest run of binv; cache: the rows of x the walk's column flags assume
// in shared memory (a power of two); lanes: threads a row (1-32, a power
// of two); ablate: 0 (1-4 are measurements, see wave_walk).  Returns the
// cudaError_t of the launch.
extern "C" int trisolve_fused(const void* blob, const void* chunk_off,
                              const void* span, int n_chunks, void* x,
                              int stage_bytes, int span_bytes, int cache,
                              int lanes, int ablate, void* stream) {
  if (n_chunks <= 0 || stage_bytes <= 0 || span_bytes < 0 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)) || cache < 1 ||
      (cache & (cache - 1)) || ablate < 0 || ablate > 4)
    return (int)cudaErrorInvalidValue;
  const int stage = (stage_bytes + 127) / 128 * 128;
  const int xbb = (span_bytes + 127) / 128 * 128;
  const size_t fixed = kBarBytes + (size_t)cache * 4;
  if (fixed >= kSmemMax) return (int)cudaErrorInvalidValue;
  const int fit = (int)((kSmemMax - fixed) / (stage + xbb));
  int nst = fit < kMaxStages ? fit : kMaxStages;
  if (nst > n_chunks) nst = n_chunks;
  // the next chunk must land while this one is walked: two stages at least
  if (nst < 1 || (n_chunks > 1 && nst < 2)) return (int)cudaErrorInvalidValue;
  return (int)launch(static_cast<const unsigned char*>(blob),
                     static_cast<const long long*>(chunk_off),
                     static_cast<const int2*>(span), n_chunks,
                     static_cast<float*>(x), stage, xbb, nst, cache, lanes,
                     ablate, static_cast<cudaStream_t>(stream));
}
