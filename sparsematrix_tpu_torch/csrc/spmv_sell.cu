// The lane-bucketed SELL SpMVs, y = A @ x: the masked-slab layout
// (spmv_sell) and the row-pure layout (spmv_sell_rowpure).  y is fp32,
// zeroed by the wrapper; x fp32; values fp32 or bf16, summed in fp32.
//
// Replaces the two Pallas kernels of sparsematrix_tpu/kernels/spmv_pallas.py.
//
// spmv_sell replaces _sell_kernel (_sell_call, pallas_call at :197).  A
// slab is (8, 128) over one 1024-column window w of a tr-row tile t; cell
// (u, l) holds meta = sub | r << 3: its column is w*1024 + sub*128 + l and
// its row t*tr + r.  The TPU kernel gathers the window along sublanes by
// sub and forms tr masked sums a slab.
//
// spmv_sell_rowpure replaces _rowpure_kernel (_rowpure_call, pallas_call
// at :401).  A group of slabs shares one 8R-row tile t; sublane u of a slab
// holds rows t*8R + j*8 + u, j = s_idx >> 3 in [0, R), and column
// w*1024 + (s_idx & 7)*128 + l.  The TPU kernel sums each sublane over its
// 128 lanes into lane j of the tile, a slab at a time.
//
// What bounds both: bytes.  Each cell reads 4 (fp32) or 2 (bf16) bytes of
// value and 4 (meta; 2 from its 16-bit copy, below) or 1 (s_idx) byte of
// index, and does one FMA; x is
// gathered from L1/L2 (a slab's columns lie in one 1024-column window).
// Padding cells have value 0; they are skipped, so none reads x past
// cols.  Rows >= rows are dropped.
//
// Masked-slab design.  The first version (a 256-thread block a slab, a
// chain of value -> meta -> x loads a cell, a shared atomic a cell, tr
// global atomics a slab) moved only 1.4-1.7 TB/s: a thread had a few bytes
// in flight, and the ~75 slabs of a tile flushed onto the same tr rows of
// y at once.  Now:
//  * The wrapper cuts the slabs into one chunk a block, so that one wave
//    of the blocks the card holds covers the pack (no tail), and each
//    chunk into runs of one tile (block_ptr / run_ptr / run_tile, built on
//    the host from slab_tile once a pack and cached).  A small pack, where
//    a chunk would be a few slabs, instead takes runs of at most L slabs
//    of one tile, a run a block (the short-run walk below).
//  * The meta plane is read narrowed to 16 bits (meta < 1024), from a copy
//    the wrapper makes once a pack and caches: 2 bytes a cell, not 4.
//  * Its W warps take a run's sublanes in turn (the sublanes of a run are
//    one contiguous stretch of the planes), lane l the 4 adjacent cells
//    4l..4l+3: one 16-byte value load (8 bytes bf16) with the streaming
//    hint, and the 8-byte meta load only where one of the 4 values is
//    nonzero.  A warp works in batches of U sublanes, three batches at
//    once: the values of one are in flight, the meta words of the next
//    (issued once its values are in) are in flight, and the third is
//    summed; so the value -> meta dependence costs no wait.
//  * Lane l of warp v adds each cell into acc[v][r][l] in shared memory
//    (W x tr x 32 floats): no atomics, no bank conflicts, whatever the rows.
//    The row sums are reduced once a run, by all the block's threads
//    (16-byte reads, zeroing what they read), and each nonzero one is
//    atomicAdded into y once a run instead of once a slab.
//  * Short runs: a batch's meta words load beside its values (one DRAM
//    round trip, not two), and the block's tr sums take shared atomics, so
//    a block needs tr floats of shared memory and the card holds more of
//    them.
//
// Row-pure design: bytes should set the pace, not instructions.
//  * A block takes a run of one tile's groups (run_ptr/run_tile, derived
//    on the host from the sorted group_tile and cached on the pack; runs
//    of at most 16 slabs, ~4000 blocks at XL, balance the SMs).
//  * Warp u takes sublane u of every slab of the run, and lane l its 4
//    adjacent cells 4l..4l+3: one 16-byte vals load (8 bytes bf16) and one
//    4-byte s_idx load, kUnroll slabs' loads issued before any is used.
//  * Lane l of warp u adds each cell into acc[u][j][l] in shared memory
//    (8 x 16 x 32 floats; a warp's lanes hit distinct banks whatever their
//    j).  No reduction runs per slab: the 8R row sums are formed once, at
//    the run's end, and each nonzero one is atomicAdded into y once.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kWindow = 8 * kLanes;

// What spmv_sell_tuned's mode takes out (an ablation's result is not the
// product, except kSellEveryMeta's).
enum SellMode {
  kSellFull = 0,
  kSellNoGather = 1,   // x read as 1: no x gather
  kSellEveryMeta = 2,  // the meta word read under every value word
  kSellValsOnly = 3,   // the value plane streamed and summed, nothing else
};

// A warp's sublanes in batches of U: batch q holds sublanes q + k*W,
// k < U (slab s sublane u is sublane s*8 + u of the planes).  Long runs:
// three batches are live at once: the values of q + 2 batches are in
// flight, the meta words of q + 1 (issued where its values, loaded a stage
// earlier, are nonzero) are in flight, and batch q is summed.  Short runs
// (kShort): a batch's meta words are read beside its values, and the
// block's tr row sums take shared atomics.
template <bool BF16, int kMode, int U, bool kShort>
struct SellPipe {
  const uint16_t* __restrict__ meta;  // the meta plane narrowed to 16 bits
  const void* vals;
  const int32_t* __restrict__ slab_win;
  const float* __restrict__ x;
  float* mine;  // kShort: the block's sums; else this lane's, row r at
                // mine[32 * r]
  long long q1;
  int W, l0, cols, tr;
  float total;  // kSellValsOnly

  __device__ __forceinline__ void fetch_vals(long long q, float4 (&v)[U]) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long qq = q + (long long)k * W;
      v[k] = qq < q1 ? common::stream_val4<BF16>(vals, qq * kLanes + l0)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void fetch_meta(long long q,
                                             const float4 (&v)[U],
                                             uint2 (&m)[U], int (&w)[U]) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long qq = q + (long long)k * W;
      m[k] = make_uint2(0u, 0u);
      w[k] = 0;
      if (kMode != kSellValsOnly && qq < q1) {
        w[k] = __ldg(slab_win + (qq >> 3));
        if (kShort || kMode == kSellEveryMeta || v[k].x != 0.f ||
            v[k].y != 0.f || v[k].z != 0.f || v[k].w != 0.f)
          m[k] = __ldcs(reinterpret_cast<const uint2*>(meta + qq * kLanes +
                                                       l0));
      }
    }
  }

  __device__ __forceinline__ void sum(const float4 (&v)[U],
                                      const uint2 (&m)[U],
                                      const int (&w)[U]) {
    float xs[U][4];
    bool on[U][4];
#pragma unroll
    for (int k = 0; k < U; ++k) {  // every gather first, then the adds
      const float vc[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      const int mc[4] = {(int)(m[k].x & 0xffffu), (int)(m[k].x >> 16),
                         (int)(m[k].y & 0xffffu), (int)(m[k].y >> 16)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long col =
            (long long)w[k] * kWindow + (mc[c] & 7) * kLanes + l0 + c;
        on[k][c] = kMode != kSellValsOnly && vc[c] != 0.f && col < cols &&
                   ((mc[c] >> 3) & (kLanes - 1)) < tr;
        xs[k][c] = on[k][c] && kMode != kSellNoGather ? __ldg(x + col) : 1.f;
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float vc[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      const int mc[4] = {(int)(m[k].x & 0xffffu), (int)(m[k].x >> 16),
                         (int)(m[k].y & 0xffffu), (int)(m[k].y >> 16)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kMode == kSellValsOnly) total += vc[c];
        if (!on[k][c]) continue;
        const int r = (mc[c] >> 3) & (kLanes - 1);
        if (kShort)
          atomicAdd(mine + r, vc[c] * xs[k][c]);
        else
          mine[32 * r] += vc[c] * xs[k][c];
      }
    }
  }
};

template <bool BF16, int kMode, int U, bool kShort>
__global__ void __launch_bounds__(kThreads)
    sell_run(const uint16_t* __restrict__ meta, const void* vals,
             const int32_t* __restrict__ block_ptr,
             const int32_t* __restrict__ run_ptr,
             const int32_t* __restrict__ run_tile,
             const int32_t* __restrict__ slab_win,
             const float* __restrict__ x, float* __restrict__ y, int rows,
             int cols, int tr) {
  // the row sums: kShort [tr], else [W][tr][32] (16-byte aligned)
  extern __shared__ float4 acc4[];
  float* const acc = reinterpret_cast<float*>(acc4);
  const int W = blockDim.x / 32;
  const int wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_acc = kShort ? tr : W * tr * 32;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  SellPipe<BF16, kMode, U, kShort> p{
      meta, vals, slab_win, x, kShort ? acc : acc + wp * tr * 32 + lane,
      0, W, 4 * lane, cols, tr, 0.f};
  const long long step = (long long)W * U;
  // the reduction of long runs: k threads a row (a power of two, at most
  // 32), each summing (and zeroing) every k-th of the row's W*8 float4
  // words, then the k lanes' shuffle sum and one atomicAdd
  int k = 32;
  while (k > 1 && k * tr > (int)blockDim.x) k >>= 1;
  const int per = (int)blockDim.x / k;  // rows a pass
  const int part = threadIdx.x % k;
  const int r1 = __ldg(block_ptr + blockIdx.x + 1);
  for (int run = __ldg(block_ptr + blockIdx.x); run < r1; ++run) {
    const long long q0 = (long long)__ldg(run_ptr + run) * 8 + wp;
    p.q1 = (long long)__ldg(run_ptr + run + 1) * 8;
    float4 va[U];
    uint2 ma[U];
    int wa[U];
    if constexpr (kShort) {
      for (long long q = q0; q < p.q1; q += step) {
        p.fetch_vals(q, va);
        p.fetch_meta(q, va, ma, wa);
        p.sum(va, ma, wa);
      }
    } else {
      float4 vb[U], vc[U];
      uint2 mb[U], mc[U];
      int wb[U], wc[U];
      p.fetch_vals(q0, va);
      p.fetch_vals(q0 + step, vb);
      p.fetch_meta(q0, va, ma, wa);
      for (long long q = q0; q < p.q1; q += 3 * step) {
        p.fetch_vals(q + 2 * step, vc);
        p.fetch_meta(q + step, vb, mb, wb);
        p.sum(va, ma, wa);
        p.fetch_vals(q + 3 * step, va);
        p.fetch_meta(q + 2 * step, vc, mc, wc);
        p.sum(vb, mb, wb);
        p.fetch_vals(q + 4 * step, vb);
        p.fetch_meta(q + 3 * step, va, ma, wa);
        p.sum(vc, mc, wc);
      }
    }
    if (kMode == kSellValsOnly) {
      if (kShort)
        atomicAdd(p.mine, p.total);
      else
        p.mine[0] += p.total;
      p.total = 0.f;
    }
    __syncthreads();
    const long long row0 = (long long)__ldg(run_tile + run) * tr;
    if constexpr (kShort) {
      for (int r = threadIdx.x; r < tr; r += blockDim.x) {
        const float sum = acc[r];
        acc[r] = 0.f;
        if (row0 + r < rows && sum != 0.f) atomicAdd(y + row0 + r, sum);
      }
    } else {
      for (int base = 0; base < tr; base += per) {  // uniform in the block
        const int r = base + (int)threadIdx.x / k;
        float sum = 0.f;
        if (r < tr)
          for (int c = part; c < W * 8; c += k) {
            float4& a = acc4[((c >> 3) * tr + r) * 8 + (c & 7)];
            sum += (a.x + a.y) + (a.z + a.w);
            a = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        for (int o = k / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(~0u, sum, o);
        if (part == 0 && r < tr && row0 + r < rows && sum != 0.f)
          atomicAdd(y + row0 + r, sum);
      }
    }
    __syncthreads();
  }
}

// Lets ``kernel`` take ``smem`` bytes of dynamic shared memory.
template <class Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <bool BF16, int kMode, int U, bool kShort>
cudaError_t launch_sell(const uint16_t* meta, const void* vals,
                        const int32_t* block_ptr, const int32_t* run_ptr,
                        const int32_t* run_tile, const int32_t* slab_win,
                        const float* x, float* y, int rows, int cols,
                        long long n_blocks, int tr, int warps,
                        cudaStream_t st) {
  const int smem = (kShort ? tr : warps * tr * 32) * (int)sizeof(float);
  const cudaError_t e = set_smem(sell_run<BF16, kMode, U, kShort>, smem);
  if (e != cudaSuccess) return e;
  sell_run<BF16, kMode, U, kShort>
      <<<(unsigned)n_blocks, warps * 32, smem, st>>>(
          meta, vals, block_ptr, run_ptr, run_tile, slab_win, x, y, rows,
          cols, tr);
  return cudaGetLastError();
}

constexpr int kRowsMax = 16;  // R <= 16
constexpr int kUnroll = 4;    // slabs whose loads are in flight at once

// The 4 cells 4l..4l+3 of a value plane as fp32.
template <bool BF16>
__device__ __forceinline__ float4 load_val4(const void* v, long long i) {
  if (BF16) {
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const unsigned short*>(v) + i));
    return make_float4(__uint_as_float(h.x << 16),
                       __uint_as_float(h.x & 0xffff0000u),
                       __uint_as_float(h.y << 16),
                       __uint_as_float(h.y & 0xffff0000u));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(v) +
                                               i));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    sell_rowpure(const uint8_t* __restrict__ s_idx, const void* vals,
                 const int32_t* __restrict__ run_ptr,
                 const int32_t* __restrict__ run_tile,
                 const int32_t* __restrict__ slab_win,
                 const float* __restrict__ x, float* __restrict__ y,
                 int rows, int cols, int group, int R) {
  __shared__ float acc[8][kRowsMax][32];
  const int u = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* const mine = &acc[u][0][lane];  // row j at mine[32 * j]
  for (int j = 0; j < R; ++j) mine[32 * j] = 0.f;
  const long long s0 = (long long)__ldg(run_ptr + blockIdx.x) * group;
  const long long s1 = (long long)__ldg(run_ptr + blockIdx.x + 1) * group;
  const int l0 = 4 * lane;
  for (long long s = s0; s < s1; s += kUnroll) {
    float4 v[kUnroll];
    uint32_t m[kUnroll];
    long long w0[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);  // past the run: no cell
      m[k] = 0;
      w0[k] = 0;
      if (s + k < s1) {
        const long long at = (s + k) * kWindow + u * kLanes + l0;
        v[k] = load_val4<BF16>(vals, at);
        m[k] = __ldg(reinterpret_cast<const uint32_t*>(s_idx + at));
        w0[k] = (long long)__ldg(slab_win + s + k) * kWindow;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const float vc[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t mc = (m[k] >> (8 * c)) & 0xffu;
        const long long col = w0[k] + (mc & 7) * kLanes + l0 + c;
        if (vc[c] != 0.f && col < cols)
          mine[32 * ((mc >> 3) & 15)] += vc[c] * __ldg(x + col);
      }
    }
  }
  __syncthreads();
  // row r = j*8 + u of the tile: the sum of acc[u][j][.], read from a
  // rotated start so that a warp's threads hit distinct banks
  const long long row0 = (long long)__ldg(run_tile + blockIdx.x) * 8 * R;
  for (int r = threadIdx.x; r < 8 * R; r += kThreads) {
    const float* a = &acc[r % 8][r / 8][0];
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) sum += a[(k + r) & 31];
    if (row0 + r < rows && sum != 0.f) atomicAdd(y + row0 + r, sum);
  }
}

int default_warps(int tr, int short_runs) {
  return short_runs || tr <= 64 ? 8 : 4;
}

}  // namespace

// The blocks of spmv_sell (at its default warps and unroll; short_runs as
// its argument) that the card holds at once: the wrapper plans one wave.
extern "C" int spmv_sell_blocks(int tr, int short_runs) {
  if (tr < 1 || tr > kLanes) return -1;
  const int warps = default_warps(tr, short_runs);
  const int smem =
      (short_runs ? tr : warps * tr * 32) * (int)sizeof(float);
  auto* kernel = short_runs ? sell_run<false, kSellFull, 2, true>
                            : sell_run<false, kSellFull, 2, false>;
  if (set_smem(kernel, smem) != cudaSuccess) return -1;
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, warps * 32,
                                                    smem) != cudaSuccess)
    return -1;
  return sms * (per > 0 ? per : 1);
}

// spmv_sell with its knobs: ``warps`` a block (1, 2, 4 or 8; 0: the
// kernel's choice: 8, or 4 for long runs above tr = 64, so that a block's
// sums take at most 64 KB), ``mode`` (SellMode; 0 the product; long runs
// only) and ``unroll`` (sublanes a batch of long runs, 2 or 4; 0: 2).
// meta16 (n_slabs, 8, 128) uint16, the pack's meta plane narrowed, 8-byte
// aligned; vals (n_slabs, 8, 128) fp32 or bf16, 16-byte aligned (8 for
// bf16); block_ptr (n_blocks+1,) int32, the first run of each block and
// then n_runs; run_ptr (n_runs+1,) int32, the first slab of each run and
// then n_slabs; run_tile (n_runs,) int32, the tile of each run (all of a
// run's slabs lie in it); slab_win (n_slabs,) int32; x (cols,) fp32; y
// (rows,) fp32, zeroed by the caller; 1 <= tr <= 128; short_runs 1 where
// every block takes one run of a few slabs (the short-run walk), else 0.
// Returns the cudaError_t of the launch.
extern "C" int spmv_sell_tuned(const void* meta, const void* vals,
                               const void* block_ptr, const void* run_ptr,
                               const void* run_tile, const void* slab_win,
                               const void* x, void* y, int rows, int cols,
                               long long n_blocks, int tr, int short_runs,
                               int bf16, int warps, int mode, int unroll,
                               void* stream) {
  if (n_blocks <= 0 || n_blocks > 0x7fffffffLL || tr < 1 || tr > kLanes ||
      (warps != 0 && warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      mode < 0 || mode > kSellValsOnly ||
      (unroll != 0 && unroll != 2 && unroll != 4) ||
      (short_runs && (mode != kSellFull || unroll == 4)))
    return (int)cudaErrorInvalidValue;
  if (warps == 0) warps = default_warps(tr, short_runs);
  if (unroll == 0) unroll = 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint16_t*>(meta);
  const auto* bp = static_cast<const int32_t*>(block_ptr);
  const auto* rp = static_cast<const int32_t*>(run_ptr);
  const auto* rt = static_cast<const int32_t*>(run_tile);
  const auto* w = static_cast<const int32_t*>(slab_win);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
#define SELL_LAUNCH(M, U, S)                                                \
  (bf16 ? launch_sell<true, M, U, S>(m, vals, bp, rp, rt, w, xf, yf, rows, \
                                     cols, n_blocks, tr, warps, st)        \
        : launch_sell<false, M, U, S>(m, vals, bp, rp, rt, w, xf, yf,      \
                                      rows, cols, n_blocks, tr, warps, st))
  cudaError_t e;
  if (short_runs)
    e = SELL_LAUNCH(kSellFull, 2, true);
  else if (mode == kSellFull)
    e = unroll == 4 ? SELL_LAUNCH(kSellFull, 4, false)
                    : SELL_LAUNCH(kSellFull, 2, false);
  else if (unroll == 4)
    return (int)cudaErrorInvalidValue;  // the ablations run at unroll 2
  else if (mode == kSellNoGather)
    e = SELL_LAUNCH(kSellNoGather, 2, false);
  else if (mode == kSellEveryMeta)
    e = SELL_LAUNCH(kSellEveryMeta, 2, false);
  else
    e = SELL_LAUNCH(kSellValsOnly, 2, false);
#undef SELL_LAUNCH
  return (int)e;
}

// y = A @ x over the masked-slab pack, walked in runs: spmv_sell_tuned at
// the kernel's choices.
extern "C" int spmv_sell(const void* meta, const void* vals,
                         const void* block_ptr, const void* run_ptr,
                         const void* run_tile, const void* slab_win,
                         const void* x, void* y, int rows, int cols,
                         long long n_blocks, int tr, int short_runs, int bf16,
                         void* stream) {
  return spmv_sell_tuned(meta, vals, block_ptr, run_ptr, run_tile, slab_win,
                         x, y, rows, cols, n_blocks, tr, short_runs, bf16, 0,
                         0, 0, stream);
}

// s_idx (n_groups, group*8, 128) int8; vals the same in fp32 or bf16
// (16-byte aligned; 8 for bf16), s_idx 4-byte aligned; run_ptr
// (n_runs+1,) int32, the first group of each run and then n_groups;
// run_tile (n_runs,) int32, the tile of each run (all of a run's groups
// lie in it); slab_win (n_groups*group,) int32; x (cols,) fp32; y (rows,)
// fp32, zeroed by the caller; R in {1, 2, 4, 8, 16}.  Returns the
// cudaError_t of the launch.
extern "C" int spmv_sell_rowpure(const void* s_idx, const void* vals,
                                 const void* run_ptr, const void* run_tile,
                                 const void* slab_win, const void* x, void* y,
                                 int rows, int cols, long long n_runs,
                                 int group, int R, int bf16, void* stream) {
  if (n_runs <= 0 || n_runs > 0x7fffffffLL || group <= 0 || R < 1 ||
      R > kRowsMax || 8 * R > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* si = static_cast<const uint8_t*>(s_idx);
  const auto* rp = static_cast<const int32_t*>(run_ptr);
  const auto* rt = static_cast<const int32_t*>(run_tile);
  const auto* w = static_cast<const int32_t*>(slab_win);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  if (bf16)
    sell_rowpure<true><<<(unsigned)n_runs, kThreads, 0, st>>>(
        si, vals, rp, rt, w, xf, yf, rows, cols, group, R);
  else
    sell_rowpure<false><<<(unsigned)n_runs, kThreads, 0, st>>>(
        si, vals, rp, rt, w, xf, yf, rows, cols, group, R);
  return (int)cudaGetLastError();
}
