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
// What bounds it: bytes.  Each slot holds 4 (fp32) or 2 (bf16) bytes of
// value and one byte of s_idx and needs at most one FMA; x is gathered
// from L1/L2.  The packs are sparse (12 % full at spgemm_xl's P, where
// 36 % of the 32-byte value sectors are all zero), so the planes' bytes,
// not the products, set the floor.
//
// Design: the warp walk of rowlane.cuh (rl::walk with the rowlane tile
// rule) in the kernel spmv_rowlane_walk: a warp a range of slabs cut at
// tile starts on the host, 16-byte words, the sector mask (no all-zero
// value sector is fetched), the L lanes of a row folded by shuffles, each
// tile stored whole by its warp, so y needs no zero fill.  A small pack
// whose tiles the cuts split anyway (a few slabs a warp) takes equal
// ranges into a zeroed y with no mask: its time is a few dependent reads,
// so the equal ranges read no table before the planes and issue a slab's
// x gathers together.  The first version (a thread a lane, 1-byte s_idx
// loads, an atomicAdd a tile into a zero-filled y) moved its planes at
// about 1.5 TB/s.  The TPU kernel's SMEM-budget chunking of the groups
// into several calls is not needed: one launch covers every group.
#include "rowlane.cuh"

template <bool BF16, bool MASK, bool EQUAL>
__global__ void __launch_bounds__(rl::kWarps * 32)
    spmv_rowlane_walk(rl::Walk p, rl::RowlaneTiles tiles,
                      const float* __restrict__ x, float* __restrict__ y) {
  rl::walk<BF16, rl::Step::kFull, MASK, EQUAL>(p, tiles, x, y);
}

// The warps of spmv_rowlane_walk that the card holds at once: the wrapper
// cuts the slabs into that many ranges (one wave).
extern "C" int spmv_rowlane_warps() {
  return rl::resident_warps(spmv_rowlane_walk<false, true, false>);
}

// s_idx (n_slabs, 8, 128) int8, 4-byte aligned; vals the same in fp32 or
// bf16, 16-byte aligned (8 for bf16); group_tile (n_slabs / group,) int32,
// non-decreasing; slab_win (n_slabs,) int32; group_real (n_groups,) int32
// in [0, group], or null (every slab read); mask (n_slabs, 8) uint16,
// 16-byte aligned, or null (every value word read); warp_ptr
// (n_warps+1,) int32, non-decreasing from 0 to n_slabs, or null (warp w
// takes slabs [w*spw, (w+1)*spw) and adds into every tile; mask and
// group_real must then be null); x (cols,) fp32; y (rows,) fp32, 16-byte
// aligned, zero in the tiles that a cut of warp_ptr splits, or everywhere
// without warp_ptr (the kernel writes every other row).  Returns the
// cudaError_t of the launch.
extern "C" int spmv_rowlane(const void* s_idx, const void* vals,
                            const void* group_tile, const void* slab_win,
                            const void* group_real, const void* mask,
                            const void* warp_ptr, const void* x, void* y,
                            int rows, int cols, long long n_slabs, int group,
                            int lanes_per_row, int n_warps, int spw,
                            int bf16, void* stream) {
  if (lanes_per_row <= 0 || rl::kLanes % lanes_per_row || !group_tile ||
      (!warp_ptr && (mask || group_real)))
    return (int)cudaErrorInvalidValue;
  const int T = rl::kLanes / lanes_per_row;
  const rl::Walk p{static_cast<const uint8_t*>(s_idx),
                   vals,
                   static_cast<const int32_t*>(slab_win),
                   static_cast<const int32_t*>(group_real),
                   static_cast<const uint16_t*>(mask),
                   static_cast<const int32_t*>(warp_ptr),
                   n_slabs, rows, cols, group, n_warps, spw, T, T};
  if (!rl::valid(p)) return (int)cudaErrorInvalidValue;
  const rl::RowlaneTiles tiles{static_cast<const int32_t*>(group_tile),
                               group};
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!warp_ptr)
    return (int)(bf16 ? rl::launch(spmv_rowlane_walk<true, false, true>, p,
                                   tiles, xf, yf, st)
                      : rl::launch(spmv_rowlane_walk<false, false, true>, p,
                                   tiles, xf, yf, st));
  if (mask)
    return (int)(bf16 ? rl::launch(spmv_rowlane_walk<true, true, false>, p,
                                   tiles, xf, yf, st)
                      : rl::launch(spmv_rowlane_walk<false, true, false>, p,
                                   tiles, xf, yf, st));
  return (int)(bf16 ? rl::launch(spmv_rowlane_walk<true, false, false>, p,
                                 tiles, xf, yf, st)
                    : rl::launch(spmv_rowlane_walk<false, false, false>, p,
                                 tiles, xf, yf, st));
}
