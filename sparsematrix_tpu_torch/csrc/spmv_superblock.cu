// Superblock row-lane SpMV, y = A @ x over a superblock pack (a group's
// slabs span a superblock of k_tiles 128-row tiles).
//
// Replaces the Pallas kernel _superblock_kernel of
// sparsematrix_tpu/kernels/spmv_superblock.py (_superblock_call,
// pallas_call at :179), which gathers as the rowlane kernel does and adds
// each slab's sublane sum into row block 8 * slab_tloc of a (8·K, 128)
// superblock accumulator.
//
// What bounds it: bytes, as the rowlane kernel (one byte of s_idx and 4
// or 2 bytes of value a slot).
//
// Design: rl::walk (rowlane.cuh) in the kernel spmv_superblock_walk, with
// the tile group_super * k_tiles + slab_tloc and lanes_per_row 1.  Padding
// slabs repeat the last real slab's window and tile and carry value 0.
#include "rowlane.cuh"

template <bool BF16>
__global__ void __launch_bounds__(rl::kThreads)
    spmv_superblock_walk(rl::Pack p, const float* __restrict__ x,
                         float* __restrict__ y, int spb) {
  rl::walk<BF16, true, rl::Step::kFull>(p, x, y, spb);
}

// x (cols,) fp32; y (rows,) fp32, zeroed by the caller.  Returns the
// cudaError_t of the launch.
extern "C" int spmv_superblock(const void* s_idx, const void* vals,
                               const void* group_super, const void* slab_win,
                               const void* slab_tloc, const void* x, void* y,
                               int rows, int cols, long long n_slabs,
                               int group, int k_tiles, int bf16,
                               void* stream) {
  if (group <= 0 || n_slabs <= 0 || k_tiles <= 0 || !slab_tloc)
    return (int)cudaErrorInvalidValue;
  const rl::Pack p{static_cast<const uint8_t*>(s_idx),
                   vals,
                   static_cast<const int32_t*>(group_super),
                   static_cast<const int32_t*>(slab_win),
                   static_cast<const int32_t*>(slab_tloc),
                   n_slabs, rows, cols, group, k_tiles, rl::kLanes};
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rl::launch(spmv_superblock_walk<true>, p, xf, yf, st)
                    : rl::launch(spmv_superblock_walk<false>, p, xf, yf, st));
}
