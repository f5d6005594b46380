// Row-lane SpMV, y = A @ x over a rowlane pack (one 128/L-row tile a
// group, L lanes a row).
//
// Replaces the Pallas kernel _rowlane_kernel of
// sparsematrix_tpu/kernels/spmv_rowlane.py (_rowlane_call, pallas_call at
// :397), which gathers g[u, l] = xw[u, s_idx[u, l]] per slab, sums the
// group's slabs over sublanes into one 128-row tile and folds the L lanes
// of a row on the host side.  A spill tail packed as a second rowlane
// pack is a second launch of this kernel.
//
// What bounds it: bytes.  Each slot reads 4 (fp32) or 2 (bf16) bytes of
// value and one byte of s_idx and does one FMA; x is gathered from L1/L2.
//
// Design: rl::walk (rowlane.cuh) in the kernel spmv_rowlane_walk.  The TPU
// kernel's SMEM-budget chunking of the groups into several calls is not
// needed: one launch covers every group.
#include "rowlane.cuh"

template <bool BF16>
__global__ void __launch_bounds__(rl::kThreads)
    spmv_rowlane_walk(rl::Pack p, const float* __restrict__ x,
                      float* __restrict__ y, int spb) {
  rl::walk<BF16, false, rl::Step::kFull>(p, x, y, spb);
}

// x (cols,) fp32; y (rows,) fp32, zeroed by the caller.  Returns the
// cudaError_t of the launch.
extern "C" int spmv_rowlane(const void* s_idx, const void* vals,
                            const void* group_tile, const void* slab_win,
                            const void* x, void* y, int rows, int cols,
                            long long n_slabs, int group, int lanes_per_row,
                            int bf16, void* stream) {
  if (group <= 0 || n_slabs <= 0 || lanes_per_row <= 0 ||
      rl::kLanes % lanes_per_row)
    return (int)cudaErrorInvalidValue;
  const rl::Pack p{static_cast<const uint8_t*>(s_idx),
                   vals,
                   static_cast<const int32_t*>(group_tile),
                   static_cast<const int32_t*>(slab_win),
                   nullptr,
                   n_slabs, rows, cols, group, 1,
                   rl::kLanes / lanes_per_row};
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? rl::launch(spmv_rowlane_walk<true>, p, xf, yf, st)
                    : rl::launch(spmv_rowlane_walk<false>, p, xf, yf, st));
}
