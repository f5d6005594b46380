// Slab decode and walk of the row-lane layout, shared by the rowlane SpMV
// (spmv_rowlane.cu) and the superblock SpMV (spmv_superblock.cu).
//
// A pack is a run of n_slabs slabs, each an (8, 128) block of two planes:
// vals[u][l] and s_idx[u][l] (int8, the column's lane c % 128).  Slab s
// reads the 1024-column window slab_win[s]; its sublane u holds columns
// [w*1024 + u*128, w*1024 + (u+1)*128), so slot (u, l) is column
// w*1024 + u*128 + s_idx[u][l].  The lane is the row slot: slot (u, l)
// adds to row tile * T + l % T, T = 128 / lanes_per_row, where the tile is
//  * rowlane:    group_tile[s / group]                       (T = 128 / L)
//  * superblock: group_super[s / group] * k_tiles + slab_tloc[s]  (T = 128)
// A padding slot holds value 0; its column may lie past cols in the last
// window (the JAX wrapper zero-pads x to whole windows).  Every column and
// row is bounds-checked, so no pack can make a kernel read or write out
// of range.
//
// The walk: one thread per lane l (128 threads); a block walks spb
// contiguous slabs (slabs_per_block below).  Per slab the thread sums its
// 8 sublanes (unrolled: 8 independent s_idx/vals -> x load chains), adds
// the sum to a register, and keeps summing while the slabs' tile stays
// the same (slabs are tile-major); it flushes the register to y with an
// atomicAdd when the tile changes and at the end of its run.  y is zeroed
// by the wrapper.  That takes the place of the TPU kernel's sequential
// revisits of one output block, its per-group sublane sum and its
// "touched" mask; with L > 1 the L lanes of a row fold in the atomics.
// Only the fp32 summation order varies, from run to run.
//
// The walk is a __device__ function; each source wraps it in a
// __global__ kernel of its own name (spmv_rowlane_walk,
// spmv_superblock_walk, probe_rowlane_walk), so that a profiler trace
// names the kernel.  Its Step parameter is Step::kFull for the SpMV; the
// probe of benchmarks/probe_xl_spmv.py (probe_rowlane.cu) takes out one
// piece of the slab step at a time, on the same walk and block geometry:
//  * kDmaOnly:       sum vals[u][l] (no x read at all);
//  * kFixedWindow:   vals[u][l] * x[u*128 + s_idx[u][l]]: the lane gather
//                    in window 0, no slab_win read;
//  * kSliceNoGather: vals[u][l] * x[w*1024 + u*128 + l]: the slab's window,
//                    no lane gather.
// Each variant still streams both planes: its s_idx bytes that no
// arithmetic needs go into an integer checksum that is flushed only if it
// equals a value no run reaches, so the compiler cannot drop the loads.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace rl {

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kSlab = kSub * kLanes;  // slots per slab
constexpr int kWindow = 1024;
constexpr int kThreads = 128;          // one thread per lane
constexpr int kMaxSlabsPerBlock = 16;  // contiguous slabs a block walks

struct Pack {
  const uint8_t* s_idx;
  const void* vals;
  const int32_t* group_tile;  // group_super for a superblock pack
  const int32_t* slab_win;
  const int32_t* slab_tloc;   // null unless superblock
  long long n_slabs;
  int rows, cols, group, k_tiles, T;
};

using common::load_val;

template <bool SB>
__device__ __forceinline__ long long slab_tile(const Pack& p, long long s) {
  long long t = __ldg(p.group_tile + s / p.group);
  if (SB) t = t * p.k_tiles + __ldg(p.slab_tloc + s);
  return t;
}

enum class Step { kFull, kDmaOnly, kFixedWindow, kSliceNoGather };

template <bool BF16, bool SB, Step kStep>
__device__ __forceinline__ void walk(const Pack& p,
                                     const float* __restrict__ x,
                                     float* __restrict__ y, int spb) {
  const int l = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, p.n_slabs);
  long long cur = -1;
  float acc = 0.f;
  unsigned chk = 0;  // s_idx bytes the variant's arithmetic does not need
  auto flush = [&]() {
    const long long row = cur * p.T + l % p.T;
    if (cur >= 0 && row < p.rows) atomicAdd(y + row, acc);
  };
  for (long long s = s0; s < s1; ++s) {
    const long long tile = slab_tile<SB>(p, s);
    if (tile != cur) {
      flush();
      acc = 0.f;
      cur = tile;
    }
    const long long w0 =
        kStep == Step::kFull || kStep == Step::kSliceNoGather
            ? (long long)__ldg(p.slab_win + s) * kWindow
            : 0;
    const long long pb = s * kSlab;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const long long at = pb + u * kLanes + l;
      const unsigned lane = __ldg(p.s_idx + at);
      const float v = load_val<BF16>(p.vals, at);
      if (kStep == Step::kDmaOnly) {
        chk += lane;
        part += v;
        continue;
      }
      long long col = w0 + u * kLanes;
      if (kStep == Step::kSliceNoGather) {
        chk += lane;
        col += l;
      } else {
        col += lane & 127;
      }
      part = fmaf(v, (col < p.cols) ? __ldg(x + col) : 0.f, part);
    }
    acc += part;
  }
  flush();
  if (kStep != Step::kFull && chk == 0xFFFFFFFFu) atomicAdd(y, 0.f);
}

// Contiguous slabs a block walks: up to kMaxSlabsPerBlock, but no more
// than leaves about 8 blocks per SM, so that a small pack still spreads
// over the whole card.
inline int slabs_per_block(long long n_slabs) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = 8LL * sms;
  const long long spb = (n_slabs + blocks - 1) / blocks;
  return (int)(spb < 1 ? 1 : spb > kMaxSlabsPerBlock ? kMaxSlabsPerBlock
                                                      : spb);
}

// Launches ``kernel`` (a __global__ wrapper of walk) over the pack.
template <class Kernel>
cudaError_t launch(Kernel kernel, const Pack& p, const float* x, float* y,
                   cudaStream_t st) {
  const int spb = slabs_per_block(p.n_slabs);
  const unsigned blocks = (unsigned)((p.n_slabs + spb - 1) / spb);
  kernel<<<blocks, kThreads, 0, st>>>(p, x, y, spb);
  return cudaGetLastError();
}

}  // namespace rl
