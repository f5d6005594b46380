// The row-lane slab layout and the warp walk over it, run by the rowlane
// SpMV (spmv_rowlane.cu), the superblock SpMV (spmv_superblock.cu) and
// the probe of the rowlane walk (probe_rowlane.cu).  The gather-step
// probes (probe_gather_step.cu) and the row-lane SpMM (spmm_rowlane.cu)
// take only the layout's constants and slabs_per_block.
//
// A pack is a run of n_slabs slabs, each an (8, 128) block of two planes:
// vals[u][l] and s_idx[u][l] (int8, the column's lane c % 128).  Slab s
// reads the 1024-column window slab_win[s]; its sublane u holds columns
// [w*1024 + u*128, w*1024 + (u+1)*128), so slot (u, l) is column
// w*1024 + u*128 + s_idx[u][l].  The lane is the row slot: slot (u, l)
// adds to row tile * stride + l % T, T = 128 / lanes_per_row, where the
// tile of slab s is the pack's rule (a Tiles functor below):
//  * rowlane:    group_tile[s / group]                          (T = 128 / L)
//  * superblock: group_super[s / group] * k_tiles + slab_tloc[s]  (T = 128)
// and stride is T (the probe's (8, 128) output blocks take 1024).  Tiles
// never decrease along the slabs (the packers emit them tile-major; the
// wrappers check it once a pack).  A padding slot holds value 0; its
// column may lie past cols in the last window.  Every column and row is
// bounds-checked, so no pack can make the walk read or write out of
// range.
//
// The walk (walk below), a warp a range of slabs:
//  * Warp w walks the slabs [warp_ptr[w], warp_ptr[w+1]), cut on the host
//    once a pack into whole waves of warps, each cut moved to a tile start
//    where one lies near.  Small packs whose tiles a cut must split
//    anyway take equal ranges of spw slabs instead (warp_ptr null: no
//    table read before the first slab) and add every tile into a zeroed
//    y; they are latency-bound, so they also skip the mask and group_real
//    (the wrapper's choice), and issue all of a slab's x gathers before
//    the first FMA, so that a warp waits on one gather, not on 32 in
//    turn.
//  * Thread t takes lanes 4t..4t+3 of all 8 sublanes: eight 4-byte s_idx
//    words and eight 16-byte value words (8-byte bf16) a slab, coalesced,
//    all issued before any is used, read with the streaming hint so that
//    x and y stay in L2.  A zero value reads no x, so an inf or NaN of x
//    under a zero slot gives 0.
//  * A slab's tables (its tile, window, group_real test and masks) are
//    read 32 slabs at a time, a slab a lane, and passed along by
//    shuffles, so that no slab's loads wait on a table read.
//  * The sector mask (the MASK parameter): 16 bits a slab sublane, bit j
//    set where lanes 8j..8j+7 (a 32-byte sector of an fp32 value row)
//    hold a nonzero.  A thread loads its value and s_idx words only under
//    a set bit, so the card fetches no all-zero sector.
//  * group_real (optional) counts group g's slabs up to its last that
//    holds a nonzero value; the slabs after it (a group's padding slabs)
//    are not read at all, only their tile is.
//  * The four row sums of a thread stay in registers while the tile stays
//    the same.  With L lanes a row, the L lanes of a row sit in threads
//    T/4 apart and fold by warp shuffles.  A tile whose slabs all lie in
//    one warp's range is that warp's: it stores the tile's T sums (zeros
//    where nothing adds), one 16-byte store a thread, and stores zeros
//    into the tiles no slab names between its own (before slab 0 by the
//    first range, after the last slab by the range that ends there).  So
//    y needs no zero fill.  Only a tile that a cut splits is zeroed first
//    by the wrapper and taken with float4 atomicAdds
//    (red.global.add.v4.f32); only its fp32 summation order varies.
//
// Each source wraps the walk in a __global__ kernel of its own name
// (spmv_rowlane_walk, spmv_superblock_walk, probe_rowlane_walk), so that a
// profiler trace names the kernel.  Its Step parameter is Step::kFull for
// the SpMV; the other steps take one piece of the slab step out, on the
// same walk and geometry:
//  * kNoGather:      x read as 1 (no x gather);
//  * kDmaOnly:       sum vals[u][l] (no x read at all);
//  * kFixedWindow:   vals[u][l] * x[u*128 + s_idx[u][l]]: the lane gather
//                    in window 0, no slab_win read;
//  * kSliceNoGather: vals[u][l] * x[w*1024 + u*128 + l]: the slab's window,
//                    no lane gather.
// The probe's steps still stream both planes: the s_idx bytes that no
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
constexpr int kThreads = 128;          // a thread a lane (rows 24-26)
constexpr int kMaxSlabsPerBlock = 16;  // contiguous slabs a block walks
constexpr int kWarps = 4;              // the walk's warps a block

// Contiguous slabs a block of kThreads walks (the gather-step probes): up
// to kMaxSlabsPerBlock, but no more than leaves about 8 blocks per SM, so
// that a small pack still spreads over the whole card.
inline int slabs_per_block(long long n_slabs) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = 8LL * sms;
  const long long spb = (n_slabs + blocks - 1) / blocks;
  return (int)(spb < 1 ? 1 : spb > kMaxSlabsPerBlock ? kMaxSlabsPerBlock
                                                      : spb);
}

// The tile of slab s in a rowlane pack.
struct RowlaneTiles {
  const int32_t* group_tile;
  int group;
  __device__ __forceinline__ long long operator()(long long s) const {
    return __ldg(group_tile + s / group);
  }
};

// The tile of slab s in a superblock pack.
struct SuperTiles {
  const int32_t* group_super;
  const int32_t* slab_tloc;
  int group, k_tiles;
  __device__ __forceinline__ long long operator()(long long s) const {
    return (long long)__ldg(group_super + s / group) * k_tiles +
           __ldg(slab_tloc + s);
  }
};

struct Walk {
  const uint8_t* s_idx;
  const void* vals;
  const int32_t* slab_win;
  const int32_t* group_real;  // null: every slab read
  const uint16_t* mask;       // (n_slabs, 8) sector masks; null: none
  const int32_t* warp_ptr;    // (n_warps + 1,) slab ranges; null: spw a warp
  long long n_slabs;
  int rows, cols, group, n_warps;
  int spw;     // slabs a warp where warp_ptr is null
  int T;       // rows a tile's lanes serve: 128 / lanes_per_row
  int stride;  // rows from one tile to the next
};

enum class Step { kFull, kNoGather, kDmaOnly, kFixedWindow, kSliceNoGather };

// MASK: read the sector mask (p.mask must then be set).  EQUAL: equal
// ranges of p.spw slabs (p.warp_ptr, p.mask and p.group_real unused),
// every tile added into a zeroed y, a slab's planes read before its
// tables and its x gathers issued together.
template <bool BF16, Step kStep, bool MASK, bool EQUAL = false, class Tiles>
__device__ __forceinline__ void walk(const Walk& p, const Tiles& tile_of,
                                     const float* __restrict__ x,
                                     float* __restrict__ y) {
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (wid >= p.n_warps) return;
  constexpr bool equal = EQUAL;
  static_assert(!(EQUAL && MASK), "equal ranges read no mask");
  const long long s0 = equal ? wid * p.spw : __ldg(p.warp_ptr + wid);
  const long long s1 = equal ? min(s0 + p.spw, p.n_slabs)
                             : __ldg(p.warp_ptr + wid + 1);
  if (s0 >= s1) return;
  const long long n_tiles = (p.rows + p.stride - 1) / p.stride;
  const int fold = p.T / 4;  // threads that hold a tile's rows
  // a cut inside a tile shares it with the neighbouring range
  const long long shared0 =
      !equal && s0 > 0 && tile_of(s0 - 1) == tile_of(s0) ? tile_of(s0) : -1;
  const long long shared1 =
      !equal && s1 < p.n_slabs && tile_of(s1 - 1) == tile_of(s1)
          ? tile_of(s1) : -1;
  // rows t*stride + 4*lane .. +3 of tile t get v (lane < fold): stored,
  // or added where the tile is shared
  auto store = [&](long long t, const float (&v)[4]) {
    if (lane >= fold) return;
    const long long rb = t * p.stride + 4 * lane;
    const bool add = equal || t == shared0 || t == shared1;
    if (add && v[0] == 0.f && v[1] == 0.f && v[2] == 0.f && v[3] == 0.f)
      return;
    if (rb + 3 < p.rows) {
      const float4 q = make_float4(v[0], v[1], v[2], v[3]);
      if (add)
        atomicAdd(reinterpret_cast<float4*>(y + rb), q);
      else
        *reinterpret_cast<float4*>(y + rb) = q;
      return;
    }
    for (int k = 0; k < 4 && rb + k < p.rows; ++k) {
      if (add)
        atomicAdd(y + rb + k, v[k]);
      else
        y[rb + k] = v[k];
    }
  };
  // the L lanes of a row fold into the threads below ``fold`` (warp-wide)
  auto put = [&](long long t, float (&v)[4]) {
    for (int off = fold; off < 32; off <<= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
    store(t, v);
  };
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  const int bit = lane >> 1;  // this thread's 32-byte sector of a row
  unsigned chk = 0;  // s_idx bytes the step's arithmetic does not need
  // the tables of the next 32 slabs, a slab a lane (its tile, window,
  // whether it is read, its masks), read at once and passed to the walk
  // by shuffles, so that no slab waits on a table read
  long long base = s0;
  int tq = 0, wq = 0, rq = 0;
  uint4 mq = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](long long b) {
    base = b;
    const long long q = b + lane;
    if (q < s1) {
      tq = (int)tile_of(q);
      wq = __ldg(p.slab_win + q);
      const long long g = q / p.group;
      rq = EQUAL || !p.group_real ||
           q - g * p.group < __ldg(p.group_real + g);
      if (MASK) mq = __ldg(reinterpret_cast<const uint4*>(p.mask) + q);
    }
  };
  fetch(s0);
  // the tile of the previous slab; the tiles between it and the next
  // slab's hold no slab and are zeroed here (equal ranges: y is zero)
  long long cur = !equal && s0 > 0 ? tile_of(s0 - 1) : -1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long s = s0; s < s1; ++s) {
    if (s - base == 32) fetch(s);
    const int j = (int)(s - base);
    unsigned h[4] = {~0u, ~0u, ~0u, ~0u};  // the slab's masks, 2 a word
    uint32_t idx[kSub];
    float4 v[kSub];
    auto load = [&]() {  // the slab's plane words, under its masks
      if (MASK) {
        h[0] = __shfl_sync(0xffffffffu, mq.x, j);
        h[1] = __shfl_sync(0xffffffffu, mq.y, j);
        h[2] = __shfl_sync(0xffffffffu, mq.z, j);
        h[3] = __shfl_sync(0xffffffffu, mq.w, j);
      }
      const long long at = s * kSlab + 4 * lane;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        idx[u] = 0u;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!MASK || (h[u / 2] >> (16 * (u % 2) + bit)) & 1u) {
          idx[u] = __ldcs(reinterpret_cast<const unsigned*>(p.s_idx + at +
                                                            u * kLanes));
          v[u] = common::stream_val4<BF16>(p.vals, at + u * kLanes);
        }
      }
    };
    if (EQUAL) load();  // waits on no table read
    const long long t = __shfl_sync(0xffffffffu, tq, j);
    if (t != cur) {
      if (s > s0) put(cur, acc);
      for (long long e = cur + 1; !equal && e < t && e < n_tiles; ++e)
        store(e, zero);
      acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      cur = t;
    }
    if (!__shfl_sync(0xffffffffu, rq, j)) continue;
    if (!EQUAL) load();
    const long long w0 =
        kStep == Step::kFull || kStep == Step::kNoGather ||
                kStep == Step::kSliceNoGather
            ? (long long)__shfl_sync(0xffffffffu, wq, j) * kWindow
            : 0;
    if constexpr (EQUAL && kStep == Step::kFull) {
      // every gather first (a zero value's reads 0), then the FMAs: the
      // loop below waits on each gather before the next is issued
      float xv[kSub][4];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float vc[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long col =
              w0 + u * kLanes + (long long)((idx[u] >> (8 * c)) & (kLanes - 1));
          xv[u][c] = vc[c] != 0.f && col < p.cols ? __ldg(x + col) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float vc[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += vc[c] * xv[u][c];
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const float vc[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (kStep == Step::kDmaOnly || kStep == Step::kSliceNoGather)
        chk += idx[u];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kStep == Step::kDmaOnly) {
          acc[c] += vc[c];
          continue;
        }
        if (vc[c] == 0.f) continue;
        long long col = w0 + u * kLanes;
        col += kStep == Step::kSliceNoGather
                   ? 4 * lane + c
                   : (long long)((idx[u] >> (8 * c)) & (kLanes - 1));
        if (col < p.cols)
          acc[c] += vc[c] * (kStep == Step::kNoGather ? 1.f : __ldg(x + col));
      }
    }
  }
  put(cur, acc);
  if (!equal && s1 == p.n_slabs)
    for (long long e = cur + 1; e < n_tiles; ++e) store(e, zero);
  if ((kStep == Step::kDmaOnly || kStep == Step::kSliceNoGather) &&
      chk == 0xFFFFFFFFu)
    atomicAdd(y, 0.f);
}

// The warps of ``kernel`` (a __global__ wrapper of walk) the card holds at
// once; -1 if the card cannot be asked.
template <class Kernel>
int resident_warps(Kernel kernel) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                    kWarps * 32, 0) !=
          cudaSuccess)
    return -1;
  return sms * (per > 0 ? per : 1) * kWarps;
}

// Launches ``kernel`` over the walk's warps.
template <class Kernel, class Tiles>
cudaError_t launch(Kernel kernel, const Walk& p, const Tiles& tiles,
                   const float* x, float* y, cudaStream_t st) {
  const unsigned blocks = (unsigned)((p.n_warps + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, 0, st>>>(p, tiles, x, y);
  return cudaGetLastError();
}

// The checks every entry makes of a walk's arguments.
inline bool valid(const Walk& p) {
  return p.group > 0 && p.n_slabs > 0 && p.n_warps > 0 &&
         (p.warp_ptr || (p.spw > 0 &&
                         (long long)p.n_warps * p.spw >= p.n_slabs)) &&
         p.T >= 16 && p.T <= kLanes && kLanes % p.T == 0 &&
         p.stride >= p.T && p.stride % 4 == 0;
}

}  // namespace rl
