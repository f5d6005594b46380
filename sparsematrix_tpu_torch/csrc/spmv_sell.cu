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
// 128 lanes into lane j of the tile.  Here a block takes one group and
// warp u its sublane u of every slab: the lanes hold 4 cells each, and for
// each j the warp reduces its cells of that j by shuffles; lane 0 adds the
// sum into a shared array of the tile's 8R rows (warp u alone writes row
// j*8 + u, so no atomic is needed there).  At the group's end the block
// atomicAdds each nonzero row sum once into y.
//
// What bounds both: bytes.  Each cell reads 4 (fp32) or 2 (bf16) bytes of
// value and 4 (meta) or 1 (s_idx) byte of index, and does one FMA; x is
// gathered from L1/L2 (a slab's columns lie in one 1024-column window).
// Padding cells have value 0 and local row 0; they are skipped, so none
// reads x past cols.  Rows >= rows are dropped.
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

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    sell_rowpure(const uint8_t* __restrict__ s_idx, const void* vals,
                 const int32_t* __restrict__ group_tile,
                 const int32_t* __restrict__ slab_win,
                 const float* __restrict__ x, float* __restrict__ y,
                 int rows, int cols, int group, int R) {
  __shared__ float sums[kLanes];  // 8R <= 128 rows of the tile
  const long long g = blockIdx.x;
  const int u = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = threadIdx.x; r < 8 * R; r += kThreads) sums[r] = 0.f;
  __syncthreads();
  for (int b = 0; b < group; ++b) {
    const long long slab = g * group + b;
    const long long w0 = (long long)__ldg(slab_win + slab) * kWindow;
    const long long base = slab * kWindow + u * kLanes;
    float c[4];
    int jj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = i * 32 + lane;
      const float v = load_val<BF16>(vals, base + l);
      const int m = __ldg(s_idx + base + l);
      const long long col = w0 + (m & 7) * kLanes + l;
      c[i] = (v != 0.f && col < cols) ? v * __ldg(x + col) : 0.f;
      jj[i] = (m >> 3) & 15;
    }
    for (int j = 0; j < R; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (jj[i] == j) part += c[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) sums[j * 8 + u] += part;
    }
  }
  __syncthreads();
  const long long row0 = (long long)__ldg(group_tile + g) * 8 * R;
  for (int r = threadIdx.x; r < 8 * R; r += kThreads)
    if (row0 + r < rows && sums[r] != 0.f) atomicAdd(y + row0 + r, sums[r]);
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

// s_idx (n_groups, group*8, 128) int8; vals the same in fp32 or bf16;
// group_tile (n_groups,), slab_win (n_groups*group,) int32; x (cols,)
// fp32; y (rows,) fp32, zeroed by the caller; R in {1, 2, 4, 8, 16}.
// Returns the cudaError_t of the launch.
extern "C" int spmv_sell_rowpure(const void* s_idx, const void* vals,
                                 const void* group_tile, const void* slab_win,
                                 const void* x, void* y, int rows, int cols,
                                 long long n_groups, int group, int R,
                                 int bf16, void* stream) {
  if (n_groups <= 0 || n_groups > 0x7fffffffLL || group <= 0 || R < 1 ||
      R > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* si = static_cast<const uint8_t*>(s_idx);
  const auto* t = static_cast<const int32_t*>(group_tile);
  const auto* w = static_cast<const int32_t*>(slab_win);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  if (bf16)
    sell_rowpure<true><<<(unsigned)n_groups, kThreads, 0, st>>>(
        si, vals, t, w, xf, yf, rows, cols, group, R);
  else
    sell_rowpure<false><<<(unsigned)n_groups, kThreads, 0, st>>>(
        si, vals, t, w, xf, yf, rows, cols, group, R);
  return (int)cudaGetLastError();
}
