// Dual-gather slot assignment, the host half of the dual-gather packer
// (kernels/spmv_dualgather.py::_assign_slots_native).
//
// A copy of smtpu_assign_dualgather from the JAX package's host codec
// (sparsematrix_tpu/native/codec.cc), kept here so that the port builds
// it from its own sources: the packed planes must come out equal to the
// JAX packer's, so the algorithm is the same line for line.
//
// Sequential first-fit: per (tile, window) cell, each entry probes (s, u)
// from s=0 upward (u starting at (l+cl)&7) for the first slot satisfying
//   C1: one entry per (s, u, row-lane l), and
//   C2: the (s, u, cl) chunk cell is empty or already carries this chunk.
// Supports the two-window layout via caller-provided ch in 0..15.
//
// Built with g++ -O3 -shared -fPIC at first use (kernels/_build.py) and
// loaded with ctypes.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// cell[i] in [0, n_cells); l/cl in 0..127; ch in 0..15.
// out_s int32, out_u int8.  Returns max slab depth (>=0) or -1 on error.
long smtpu_assign_dualgather(const int64_t* cell, const int32_t* l,
                             const int32_t* cl, const int32_t* ch,
                             long n, long n_cells,
                             int32_t* out_s, int8_t* out_u) {
  if (n <= 0) return 0;
  if (n_cells <= 0) return -1;
  // counting-sort entry ids by cell (stable)
  std::vector<int64_t> start(n_cells + 1, 0);
  for (long i = 0; i < n; ++i) {
    if (cell[i] < 0 || cell[i] >= n_cells) return -1;
    ++start[cell[i] + 1];
  }
  for (long k = 0; k < n_cells; ++k) start[k + 1] += start[k];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    for (long i = 0; i < n; ++i) order[cur[cell[i]]++] = i;
  }
  // per-level occupancy, reused across cells (cleared per cell up to the
  // depth the cell actually used)
  struct Level {
    uint64_t rows[8][2];   // 128-bit row-lane bitset per sublane
    int8_t chv[8][128];    // chunk per (sublane, cl); -1 = empty
  };
  std::vector<Level> lv;
  long global_max_s = 0;
  for (long c = 0; c < n_cells; ++c) {
    const int64_t b0 = start[c], b1 = start[c + 1];
    if (b0 == b1) continue;
    long used_s = 0;
    for (int64_t j = b0; j < b1; ++j) {
      const long e = order[j];
      const int li = l[e], cli = cl[e];
      const int8_t chi = (int8_t)ch[e];
      const int tries0 = (li + cli) & 7;
      long s = 0;
      int placed_u = -1;
      for (;; ++s) {
        if ((long)lv.size() <= s) {
          lv.emplace_back();
          std::memset(&lv[s], -1, sizeof(Level));
          std::memset(lv[s].rows, 0, sizeof(lv[s].rows));
        } else if (s >= used_s) {
          std::memset(&lv[s], -1, sizeof(Level));
          std::memset(lv[s].rows, 0, sizeof(lv[s].rows));
        }
        if (s >= used_s) used_s = s + 1;
        Level& L = lv[s];
        for (int t = 0; t < 8; ++t) {
          const int u = (tries0 + t) & 7;
          const int word = li >> 6, bit = li & 63;
          if ((L.rows[u][word] >> bit) & 1ull) continue;
          const int8_t cv = L.chv[u][cli];
          if (cv != -1 && cv != chi) continue;
          L.rows[u][word] |= 1ull << bit;
          L.chv[u][cli] = chi;
          placed_u = u;
          break;
        }
        if (placed_u >= 0) break;
      }
      out_s[e] = (int32_t)s;
      out_u[e] = (int8_t)placed_u;
      if (s > global_max_s) global_max_s = s;
    }
  }
  return global_max_s;
}

}  // extern "C"
