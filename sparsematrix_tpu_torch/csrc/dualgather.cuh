// Slot decode of the dual-gather layout, shared by the SpMV and SpMM
// kernels (spmv_dualgather.cu, spmm_dualgather.cu).
//
// A pack is a run of n_slabs slabs, each an (8, 128) block of three
// planes: vals[u][l], idxB[u][l] (the column's lane cl = c % 128) and
// idxA[u][cl] (the column's 128-wide chunk within its 1024-column
// window).  Slab s belongs to group s / group; its tile is
// group_tile[g] (k_tiles = 1) or group_tile[g] * k_tiles + slab_tloc[s]
// (superblock packs), and slot (u, l) adds to row tile * 128 + l.
//  * nibble: idxA holds two slabs per byte plane, slab 2b in the low and
//    2b+1 in the high nibble; plane row (s / 2) * 8 + u.
//  * two_win: slab_win = wa | wb << 16, and bit 3 of the 4-bit idxA
//    picks wb for that cell.
// A padding slot holds value 0 with in-range pack indices; its column may
// lie past cols in the last window, where x reads as 0 (the JAX wrapper
// zero-pads x to whole windows).  Every column and row is bounds-checked,
// so no pack can make a kernel read or write out of range.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace dg {

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kSlab = kSub * kLanes;  // slots per slab
constexpr int kWindow = 1024;
constexpr int kThreads = 128;         // one thread per row lane
constexpr int kMaxSlabsPerBlock = 16;  // contiguous slabs a block walks

struct Pack {
  const uint8_t* idxA;
  const uint8_t* idxB;
  const void* vals;
  const int32_t* group_tile;
  const int32_t* slab_win;
  const int32_t* slab_tloc;  // null unless superblock
  long long n_slabs;
  int rows, cols, group, k_tiles;
};

using common::load_val;

template <bool SB>
__device__ __forceinline__ long long slab_tile(const Pack& p, long long s) {
  long long t = __ldg(p.group_tile + s / p.group);
  if (SB) t = t * p.k_tiles + __ldg(p.slab_tloc + s);
  return t;
}

// Column of the slot of slab s at sublane u whose lane is cl, in window
// word w; -1 where it lies outside [0, cols) (a padding slot).
template <bool NIBBLE, bool TWO_WIN>
__device__ __forceinline__ long long slot_col(const Pack& p, long long s,
                                              int w, int u, int cl) {
  const long long ab = (NIBBLE ? (s >> 1) : s) * kSlab;
  int ch = __ldg(p.idxA + ab + u * kLanes + cl);
  if (NIBBLE) ch = (ch >> ((s & 1) * 4)) & 15;
  long long win = w;
  if (TWO_WIN) {
    win = (ch & 8) ? (long long)((unsigned)w >> 16) : (long long)(w & 0xFFFF);
    ch &= 7;
  }
  const long long col = win * kWindow + (long long)ch * kLanes + cl;
  return (col >= 0 && col < p.cols) ? col : -1;
}

// Calls K<BF16, SB, NIBBLE, TWO_WIN>::run(args...) for the pack's flags;
// nibble and two_win exist on superblock packs only.
template <template <bool, bool, bool, bool> class K, class... A>
cudaError_t dispatch(bool bf16, bool sb, bool nibble, bool two_win,
                     A... args) {
  if (!sb) {
    if (nibble || two_win) return cudaErrorInvalidValue;
    return bf16 ? K<true, false, false, false>::run(args...)
                : K<false, false, false, false>::run(args...);
  }
  if (bf16) {
    if (nibble)
      return two_win ? K<true, true, true, true>::run(args...)
                     : K<true, true, true, false>::run(args...);
    return two_win ? K<true, true, false, true>::run(args...)
                   : K<true, true, false, false>::run(args...);
  }
  if (nibble)
    return two_win ? K<false, true, true, true>::run(args...)
                   : K<false, true, true, false>::run(args...);
  return two_win ? K<false, true, false, true>::run(args...)
                 : K<false, true, false, false>::run(args...);
}

// Contiguous slabs a block walks: up to kMaxSlabsPerBlock, which keeps
// the atomic flushes per slab few on a large pack, but no more than
// leaves about 8 blocks per SM, so that a small pack, whose slabs each
// cost a chain of dependent loads, still spreads over the whole card.
inline int slabs_per_block(long long n_slabs) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = 8LL * sms;
  const long long spb = (n_slabs + blocks - 1) / blocks;
  return (int)(spb < 1 ? 1 : spb > kMaxSlabsPerBlock ? kMaxSlabsPerBlock
                                                      : spb);
}

inline unsigned n_blocks(long long n_slabs, int spb) {
  return (unsigned)((n_slabs + spb - 1) / spb);
}

}  // namespace dg
