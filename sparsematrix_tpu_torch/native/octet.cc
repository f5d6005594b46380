// Octet-layout slot assignment, the host half of the octet packer
// (kernels/spmv_octet.py::_assign_native).
//
// A copy of smtpu_assign_octet from the JAX package's host codec
// (sparsematrix_tpu/native/codec.cc), kept here so that the port builds
// it from its own sources: the packed planes must come out equal to the
// JAX packer's, so the algorithm is the same line for line.
//
// Built with g++ -O3 -shared -fPIC at first use (kernels/_build.py) and
// loaded with ctypes.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Octet-layout slot assignment (kernels/spmv_octet.py): entries grouped
// by ow = octet*n_win + window; per entry (u 0..7, lane 0..127,
// chunk 0..7, pos 0..127) pick depth d and middle slot m such that
//  * the (d, u, lane) cell is unique            (row degree rule)
//  * m is unique within (d, u)                  (route plane)
//  * the (d, chunk, m) pos cell agrees on pos   (pos plane)
// Sequential first-fit (depth-then-slot, slot scan seeded at the lane)
// -- one pass vs the numpy parallel repair's ~15 rounds of full-array
// sorts.  Returns max depth or -1 on error.
long smtpu_assign_octet(const int64_t* ow, const int32_t* u,
                        const int32_t* lane, const int32_t* chunk,
                        const int32_t* pos, long n, long n_ow,
                        int32_t* out_d, int8_t* out_m) {
  if (n <= 0) return 0;
  if (n_ow <= 0) return -1;
  std::vector<int64_t> start(n_ow + 1, 0);
  for (long i = 0; i < n; ++i) {
    if (ow[i] < 0 || ow[i] >= n_ow) return -1;
    ++start[ow[i] + 1];
  }
  for (long k = 0; k < n_ow; ++k) start[k + 1] += start[k];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    for (long i = 0; i < n; ++i) order[cur[ow[i]]++] = i;
  }
  struct Level {
    uint64_t cellL[8][2];   // (u, lane) occupancy
    uint64_t slotU[8][2];   // (u, m) occupancy
    int16_t posT[8][128];   // pos+1 per (chunk, m); 0 = empty
  };
  std::vector<Level> lv;
  long global_max_d = 0;
  for (long g = 0; g < n_ow; ++g) {
    const int64_t b0 = start[g], b1 = start[g + 1];
    if (b0 == b1) continue;
    long used_d = 0;
    for (int64_t j = b0; j < b1; ++j) {
      const long e = order[j];
      const int ui = u[e], li = lane[e], ci = chunk[e], pi = pos[e];
      long d = 0;
      int placed_m = -1;
      for (;; ++d) {
        if ((long)lv.size() <= d) lv.emplace_back();
        if (d >= used_d) {
          std::memset(&lv[d], 0, sizeof(Level));
          used_d = d + 1;
        }
        Level& L = lv[d];
        const int lw = li >> 6, lb = li & 63;
        if ((L.cellL[ui][lw] >> lb) & 1ull) continue;  // cell taken
        for (int t = 0; t < 128; ++t) {
          const int m = (li + t) & 127;
          const int mw = m >> 6, mb = m & 63;
          if ((L.slotU[ui][mw] >> mb) & 1ull) continue;
          const int16_t pv = L.posT[ci][m];
          if (pv != 0 && pv != (int16_t)(pi + 1)) continue;
          L.cellL[ui][lw] |= 1ull << lb;
          L.slotU[ui][mw] |= 1ull << mb;
          L.posT[ci][m] = (int16_t)(pi + 1);
          placed_m = m;
          break;
        }
        if (placed_m >= 0) break;
      }
      out_d[e] = (int32_t)d;
      out_m[e] = (int8_t)placed_m;
      if (d > global_max_d) global_max_d = d;
    }
  }
  return global_max_d;
}

}  // extern "C"
