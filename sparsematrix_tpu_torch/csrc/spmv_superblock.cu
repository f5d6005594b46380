// Superblock row-lane SpMV, y = A @ x over a superblock pack (a group's
// slabs span a superblock of k_tiles 128-row tiles).
//
// Replaces the Pallas kernel _superblock_kernel of
// sparsematrix_tpu/kernels/spmv_superblock.py (_superblock_call,
// pallas_call at :179), which gathers as the rowlane kernel does and adds
// each slab's sublane sum into row block 8 * slab_tloc of a (8·K, 128)
// superblock accumulator.
//
// Slot (u, l) of slab s reads column slab_win[s]*1024 + u*128 +
// s_idx[u][l] and adds into row (group_super[s / group] * k_tiles +
// slab_tloc[s]) * 128 + l.  Padding slots and padding slabs hold value 0;
// padding slabs sit at the end of each superblock and repeat its last
// slab's window and tile, so the slabs' tiles never decrease.
//
// What bounds it: bytes.  A slot is one byte of s_idx and 4 (or 2) of
// value; x (4 B a column) and y stay in L2.  At spgemm_xl's P the planes
// are 11 % full, so their bytes, not the 4.4 M products, set the floor.
// The first version ran a thread a lane with scalar loads and an
// atomicAdd a tile into a zero-filled y (~1.55 TB/s).
//
// Design: the warp walk of rowlane.cuh (rl::walk with the superblock tile
// rule) in the kernel spmv_superblock_walk: a warp a range of slabs cut at
// tile starts on the host, 16-byte words, group_real's skip of the
// padding slabs, each tile stored whole by its warp (no zero fill), and
// no sector mask.  The shared walk timed as this kernel's own walk had
// (PERF.md, kernel row 9), so the superblock keeps no walk of its own.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "rowlane.cuh"

namespace {

constexpr int kLanes = rl::kLanes;
constexpr int kSub = rl::kSub;
constexpr int kSlab = rl::kSlab;
constexpr int kWindow = rl::kWindow;
constexpr int kWarps = rl::kWarps;

// What spmv_superblock_tuned's mode changes (kSbNoGather's result is not
// the product; the others' are).
enum SbMode {
  kSbFull = 0,
  kSbNoGather = 1,  // x read as 1: no x gather
  kSbAllSlabs = 2,  // no skip: every slab streamed, padding included
};

template <bool BF16, rl::Step kStep>
__global__ void __launch_bounds__(kWarps * 32)
    spmv_superblock_walk(rl::Walk p, rl::SuperTiles tiles,
                         const float* __restrict__ x, float* __restrict__ y) {
  rl::walk<BF16, kStep, false>(p, tiles, x, y);
}

}  // namespace

// The warps of spmv_superblock_walk that the card holds at once: the
// wrapper cuts the slabs into that many ranges (one wave).
extern "C" int spmv_superblock_warps() {
  return rl::resident_warps(spmv_superblock_walk<false, rl::Step::kFull>);
}

// spmv_superblock with its ``mode`` (SbMode; 0 the product).  s_idx
// (n_slabs, 8, 128) int8, 4-byte aligned; vals the same in fp32 or bf16,
// 16-byte aligned (8 for bf16); group_super (n_groups,) int32; slab_win,
// slab_tloc (n_slabs,) int32; group_real (n_groups,) int32, each in [0,
// group]; warp_ptr (n_warps+1,) int32, non-decreasing from 0 to n_slabs;
// x (cols,) fp32; y (rows,) fp32, 16-byte aligned, zero in the tiles that
// a cut of warp_ptr splits (the kernel writes every other row).  Returns
// the cudaError_t of the launch.
extern "C" int spmv_superblock_tuned(
    const void* s_idx, const void* vals, const void* group_super,
    const void* slab_win, const void* slab_tloc, const void* group_real,
    const void* warp_ptr, const void* x, void* y, int rows, int cols,
    long long n_slabs, int group, int k_tiles, int n_warps, int bf16,
    int mode, void* stream) {
  if (k_tiles <= 0 || !slab_tloc || !group_real || mode < 0 ||
      mode > kSbAllSlabs)
    return (int)cudaErrorInvalidValue;
  const rl::Walk p{static_cast<const uint8_t*>(s_idx),
                   vals,
                   static_cast<const int32_t*>(slab_win),
                   mode == kSbAllSlabs
                       ? nullptr
                       : static_cast<const int32_t*>(group_real),
                   nullptr,
                   static_cast<const int32_t*>(warp_ptr),
                   n_slabs, rows, cols, group, n_warps, 0, kLanes, kLanes};
  if (!rl::valid(p)) return (int)cudaErrorInvalidValue;
  const rl::SuperTiles tiles{static_cast<const int32_t*>(group_super),
                             static_cast<const int32_t*>(slab_tloc), group,
                             k_tiles};
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kSbNoGather)
    e = bf16 ? rl::launch(spmv_superblock_walk<true, rl::Step::kNoGather>, p,
                          tiles, xf, yf, st)
             : rl::launch(spmv_superblock_walk<false, rl::Step::kNoGather>, p,
                          tiles, xf, yf, st);
  else
    e = bf16 ? rl::launch(spmv_superblock_walk<true, rl::Step::kFull>, p,
                          tiles, xf, yf, st)
             : rl::launch(spmv_superblock_walk<false, rl::Step::kFull>, p,
                          tiles, xf, yf, st);
  return (int)e;
}

// y = A @ x over the superblock pack: spmv_superblock_tuned's product.
extern "C" int spmv_superblock(const void* s_idx, const void* vals,
                               const void* group_super, const void* slab_win,
                               const void* slab_tloc, const void* group_real,
                               const void* warp_ptr, const void* x, void* y,
                               int rows, int cols, long long n_slabs,
                               int group, int k_tiles, int n_warps, int bf16,
                               void* stream) {
  return spmv_superblock_tuned(s_idx, vals, group_super, slab_win, slab_tloc,
                               group_real, warp_ptr, x, y, rows, cols,
                               n_slabs, group, k_tiles, n_warps, bf16, 0,
                               stream);
}
