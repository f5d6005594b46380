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
// sub and forms tr masked sums a slab.  Here a block takes one slab: each
// cell adds v·x into a shared array of tr <= 128 row sums (a shared-memory
// atomic), and the block then atomicAdds each nonzero sum once into y.
//
// spmv_sell_rowpure replaces _rowpure_kernel (_rowpure_call, pallas_call
// at :401).  A group of slabs shares one 8R-row tile t; sublane u of a slab
// holds rows t*8R + j*8 + u, j = s_idx >> 3 in [0, R), and column
// w*1024 + (s_idx & 7)*128 + l.  The TPU kernel sums each sublane over its
// 128 lanes into lane j of the tile, a slab at a time.
//
// What bounds both: bytes.  Each cell reads 4 (fp32) or 2 (bf16) bytes of
// value and 4 (meta) or 1 (s_idx) byte of index, and does one FMA; x is
// gathered from L1/L2 (a slab's columns lie in one 1024-column window).
// Padding cells have value 0; they are skipped, so none reads x past
// cols.  Rows >= rows are dropped.
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

using common::load_val;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    sell_slab(const int32_t* __restrict__ meta, const void* vals,
              const int32_t* __restrict__ slab_tile,
              const int32_t* __restrict__ slab_win,
              const float* __restrict__ x, float* __restrict__ y, int rows,
              int cols, int tr) {
  __shared__ float sums[kLanes];
  const long long s = blockIdx.x;
  for (int r = threadIdx.x; r < tr; r += kThreads) sums[r] = 0.f;
  __syncthreads();
  const long long w0 = (long long)__ldg(slab_win + s) * kWindow;
  for (int cell = threadIdx.x; cell < kWindow; cell += kThreads) {
    const long long i = s * kWindow + cell;
    const float v = load_val<BF16>(vals, i);
    if (v == 0.f) continue;
    const int m = __ldg(meta + i);
    const long long col = w0 + (m & 7) * kLanes + cell % kLanes;
    const int r = (m >> 3) & (kLanes - 1);
    if (col < cols && r < tr) atomicAdd(sums + r, v * __ldg(x + col));
  }
  __syncthreads();
  const long long row0 = (long long)__ldg(slab_tile + s) * tr;
  for (int r = threadIdx.x; r < tr; r += kThreads)
    if (row0 + r < rows && sums[r] != 0.f) atomicAdd(y + row0 + r, sums[r]);
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

}  // namespace

// meta (n_slabs, 8, 128) int32; vals the same in fp32 or bf16;
// slab_tile, slab_win (n_slabs,) int32; x (cols,) fp32; y (rows,) fp32,
// zeroed by the caller; 1 <= tr <= 128.  Returns the cudaError_t of the
// launch.
extern "C" int spmv_sell(const void* meta, const void* vals,
                         const void* slab_tile, const void* slab_win,
                         const void* x, void* y, int rows, int cols,
                         long long n_slabs, int tr, int bf16, void* stream) {
  if (n_slabs <= 0 || n_slabs > 0x7fffffffLL || tr < 1 || tr > kLanes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int32_t*>(meta);
  const auto* t = static_cast<const int32_t*>(slab_tile);
  const auto* w = static_cast<const int32_t*>(slab_win);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  if (bf16)
    sell_slab<true><<<(unsigned)n_slabs, kThreads, 0, st>>>(
        m, vals, t, w, xf, yf, rows, cols, tr);
  else
    sell_slab<false><<<(unsigned)n_slabs, kThreads, 0, st>>>(
        m, vals, t, w, xf, yf, rows, cols, tr);
  return (int)cudaGetLastError();
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
