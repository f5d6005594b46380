// Row-lane walk ablation: the rowlane SpMV's walk with one piece of the
// slab step taken out, to tell which piece sets the kernel's pace.
//
// Replaces the three Pallas kernels of variant_kernels in
// benchmarks/probe_xl_spmv.py (mk(body), pallas_call at :115), which run
// the rowlane kernel's grid and blocks with these bodies:
//  * dma-only:        acc += vals[u, l]
//  * fixed-window:    acc += vals[u, l] * xp[u, s_idx[u, l]]   (window 0)
//  * slice-no-gather: acc += vals[u, l] * xp[8w + u, l]        (w = slab_win)
// and add each group's sublane sum to row 8t of its tile's (8, 128) output
// block (rows 8t+1 .. 8t+7 stay 0): out[8t, l] = sum over the tile's
// groups, slabs and sublanes.
//
// What bounds it: bytes.  Each variant streams both planes (4 bytes of
// value and one of s_idx a slot) and does at most one FMA a slot; x (one
// padded vector of n_win*1024 floats) is read from L1/L2.
//
// Design: rl::walk (rowlane.cuh), the row-7 kernel's walk and block
// geometry (128 threads, one a lane; slabs_per_block contiguous slabs a
// block; a register sum a lane flushed with one atomicAdd a tile), with
// its Step parameter naming the piece taken out.  The output is the flat
// (n_tiles*8, 128) array: rows = n_tiles*1024 and T = 1024, so that a
// lane's sum goes to out[tile*1024 + l], row 8·tile.  The TPU kernel
// zeroes a tile's block at its first group and leaves blocks no group
// visits unwritten; here the wrapper zeroes the whole output.
#include "rowlane.cuh"

template <rl::Step kStep>
__global__ void __launch_bounds__(rl::kThreads)
    probe_rowlane_walk(rl::Pack p, const float* __restrict__ x,
                       float* __restrict__ y, int spb) {
  rl::walk<false, false, kStep>(p, x, y, spb);
}

// step: 1 dma-only, 2 fixed-window, 3 slice-no-gather.  vals fp32 (the
// probe walks fp32 packs only); xp (S*128,) fp32, the zero-padded x; out
// (n_tiles*1024,) fp32, zeroed by the caller.
// Returns the cudaError_t of the launch.
extern "C" int probe_rowlane(int step, const void* s_idx, const void* vals,
                             const void* group_tile, const void* slab_win,
                             const void* xp, void* out, int n_tiles, int S,
                             long long n_slabs, int group, void* stream) {
  if (group <= 0 || n_slabs <= 0 || n_tiles <= 0 || S <= 0 ||
      (long long)n_tiles * 1024 > 0x7FFFFFFFLL ||
      (long long)S * rl::kLanes > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const rl::Pack p{static_cast<const uint8_t*>(s_idx),
                   vals,
                   static_cast<const int32_t*>(group_tile),
                   static_cast<const int32_t*>(slab_win),
                   nullptr,
                   n_slabs, n_tiles * 1024, S * rl::kLanes, group, 1,
                   rl::kSlab};
  const float* xf = static_cast<const float*>(xp);
  float* yf = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 1: return (int)rl::launch(probe_rowlane_walk<rl::Step::kDmaOnly>, p,
                                   xf, yf, st);
    case 2: return (int)rl::launch(probe_rowlane_walk<rl::Step::kFixedWindow>,
                                   p, xf, yf, st);
    case 3:
      return (int)rl::launch(probe_rowlane_walk<rl::Step::kSliceNoGather>, p,
                             xf, yf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
