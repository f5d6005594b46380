// The pooled spill tail of a dual-gather pack, Y += T @ X with X (cols, k)
// and Y (rows, k) row-major fp32 (k = 1 for SpMV).
//
// Replaces the Pallas kernel _pooled_kernel of
// sparsematrix_tpu/kernels/spmv_dualgather.py (_pooled_call, pallas_call
// at :1070).  A pooled slab belongs to one 128-row tile and carries 8
// global 128-column chunk pointers ``ptr``, one a sublane: cell (u, l)
// holds row tile*128 + l and column ptr[idxA[u, idxB[u, l]]]*128 +
// idxB[u, l].  The TPU kernel loads the 8 pointed x rows, gathers them
// along sublanes by idxA and along lanes by idxB, and sums the group's
// slabs into the tile's output row; its SpMM caller runs it once a column.
// Here one launch takes all k columns.  idxA and idxB are plain int8
// (never nibble-packed, even when the body's idxA is).
//
// What bounds it: bytes.  Each cell reads 4 (fp32) or 2 (bf16) bytes of
// value, two index bytes, and an X element per column from L1/L2.
//
// Design: a block per group (the group's slabs share one tile); its
// threads take the (lane l, column j) pairs of the tile, j fastest, so a
// warp reads the same plane bytes (a broadcast) and neighbouring X
// columns.  Each thread sums its pair over the group's slabs and 8
// sublanes in a register, then atomicAdds once into Y.  The body kernel
// has run before on the same Y, which the wrapper zeroed.  Rows >= rows
// and columns >= cols are dropped and read as 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

struct Pack {
  const int32_t* ptr;
  const uint8_t* idxA;
  const uint8_t* idxB;
  const void* vals;
  const int32_t* group_tile;
  int rows, cols, k, group;
};

using common::load_val;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    pooled_walk(Pack p, const float* __restrict__ X, float* __restrict__ Y) {
  const long long g = blockIdx.x;
  const long long tile = __ldg(p.group_tile + g);
  const long long cells = (long long)p.group * 8 * kLanes;
  const uint8_t* iA = p.idxA + g * cells;
  const uint8_t* iB = p.idxB + g * cells;
  const int32_t* ptr = p.ptr + g * p.group * 8;
  for (int t = threadIdx.x; t < kLanes * p.k; t += kThreads) {
    const int l = t / p.k, j = t % p.k;
    float acc = 0.f;
    for (int b = 0; b < p.group; ++b) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long cell = (long long)(b * 8 + u) * kLanes;
        const float v = load_val<BF16>(p.vals, g * cells + cell + l);
        if (v == 0.f) continue;
        const int cl = __ldg(iB + cell + l) & 127;
        const int slot = __ldg(iA + cell + cl) & 7;
        const long long col =
            (long long)__ldg(ptr + b * 8 + slot) * kLanes + cl;
        if (col < p.cols) acc = fmaf(v, __ldg(X + col * p.k + j), acc);
      }
    }
    const long long row = tile * kLanes + l;
    if (row < p.rows && acc != 0.f) atomicAdd(Y + row * p.k + j, acc);
  }
}

}  // namespace

// ptr (n_groups, group, 8) int32; idxA, idxB (n_groups, group*8, 128)
// int8; vals the same in fp32 or bf16; group_tile (n_groups,) int32.
// X (cols, k) fp32; Y (rows, k) fp32 holding the body's sum.  Returns the
// cudaError_t of the launch.
extern "C" int spmv_pooled(const void* ptr, const void* idxA,
                           const void* idxB, const void* vals,
                           const void* group_tile, const void* X, void* Y,
                           int rows, int cols, int k, long long n_groups,
                           int group, int bf16, void* stream) {
  if (group <= 0 || n_groups <= 0 || k <= 0 || n_groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Pack p{static_cast<const int32_t*>(ptr),
               static_cast<const uint8_t*>(idxA),
               static_cast<const uint8_t*>(idxB),
               vals,
               static_cast<const int32_t*>(group_tile),
               rows, cols, k, group};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(X);
  float* yf = static_cast<float*>(Y);
  if (bf16)
    pooled_walk<true><<<(unsigned)n_groups, kThreads, 0, st>>>(p, xf, yf);
  else
    pooled_walk<false><<<(unsigned)n_groups, kThreads, 0, st>>>(p, xf, yf);
  return (int)cudaGetLastError();
}
