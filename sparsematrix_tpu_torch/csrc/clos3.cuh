// The three-stage route of one 1024-element window, shared by the window
// permute (window_permute.cu) and the octet SpMV (spmv_octet.cu).
//
// A window is viewed (8, 128): sublane c, lane p.  Three int8 planes of
// the same shape, each value in [0, 128), route it:
//
//     t1[c, m] = xw[c, POS[c, m]]     (pos plane)
//     t2[u, m] = t1[CH[u, m], m]      (chunk plane)
//     y [u, l] = t2[u, RT[u, l]]      (lane route)
//
// so out cell (u, l) reads window cell (c, p) with m = RT[u, l],
// c = CH[u, m] and p = POS[c, m].  The chunk is masked to 0..7 and the
// slots to 0..127, so no plane byte can address outside its window.
#pragma once

#include <cstdint>

namespace clos3 {

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kWindow = kSub * kLanes;

// Window cell (c * 128 + p) read by out cell (u, l) of a window whose
// planes start at pos, chk and rte (each 1024 bytes, (8, 128) row-major).
__device__ __forceinline__ int source_cell(const uint8_t* pos,
                                           const uint8_t* chk,
                                           const uint8_t* rte, int u, int l) {
  const int m = rte[u * kLanes + l] & 127;
  const int c = chk[u * kLanes + m] & 7;
  const int p = pos[c * kLanes + m] & 127;
  return c * kLanes + p;
}

}  // namespace clos3
