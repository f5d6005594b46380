// Row-lane SELL packer, the host half of kernels/spmv_rowlane.py
// (_pack_arrays_native, _spill_mask_native) and of the superblock packer.
//
// A copy of smtpu_rowlane_plan, smtpu_rowlane_spill_mask and
// smtpu_rowlane_fill from the JAX package's host codec
// (sparsematrix_tpu/native/codec.cc), kept here so that the port builds
// them from its own sources: the packed planes must come out equal to the
// JAX packer's, so the algorithm is the same line for line.
//
// Built with g++ -O3 -shared -fPIC at first use (kernels/_build.py) and
// loaded with ctypes.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

// ---------------------------------------------------------------------------
// Row-lane SELL packer (kernels/spmv_rowlane.py: _pack_arrays).
//
// The numpy packer is algorithmically vectorized but allocates ~20 large
// temporaries; on hosts with expensive first-touch faults (lazy VM memory
// backing) that dominates pack time at the 10^7-nnz scale.  This native
// version sorts once, walks twice, and keeps its scratch in persistent
// buffers (never shrunk), so fault cost is paid once per process.
//
// Two-phase C ABI (output sizes are data-dependent):
//   smtpu_rowlane_plan(...)  -> total_slots / n_groups / group chosen
//   smtpu_rowlane_fill(...)  -> scatter into caller-allocated arrays
// State persists between the two calls (single-threaded use; the Python
// wrapper holds a lock).
// ---------------------------------------------------------------------------

namespace rowlane {
constexpr long kW = 1024;   // window columns
constexpr long kLanes = 128;

struct State {
  std::vector<uint64_t> skey;     // (key << idx_bits) | idx when packable
  std::vector<int64_t> key;       // fallback: plain keys
  std::vector<int64_t> order;     // fallback: sorted permutation
  std::vector<int32_t> slabcnt;   // per (t, w): ceil(max bucket / L)
  std::vector<int64_t> slab_start;  // per (t, w): start rank within tile
  std::vector<int64_t> tile_offset; // per tile: first padded slab slot
  std::vector<int32_t> tile_groups;
  std::vector<int64_t> counts;    // per tile: real slab count
  long n_tiles = 0, n_win = 0, total_slots = 0, n_groups = 0, nnz = 0;
  long rows = 0, cols = 0;
  int32_t group = 0, L = 1, T = kLanes;
  bool packed_sort = false;
};
State g;

inline int64_t entry_key(int32_t r, int32_t c, long n_win, long T) {
  const long t = r / T, rloc = r % T;
  const long w = c / kW, u = (c % kW) / kLanes;
  return ((t * n_win + w) * 8 + u) * T + rloc;
}
}  // namespace rowlane

extern "C" {

// Phase 1: sort + size.  group_req == 0 selects automatically (largest of
// 64/32/16/8/4/2 whose per-tile padding waste stays under 15%, else 1 —
// mirrors the numpy packer).  Outputs: meta[0]=total_slots, meta[1]=n_groups,
// meta[2]=group, meta[3]=n_tiles, meta[4]=n_win, meta[5]=n_slabs.
long smtpu_rowlane_plan(const int32_t* r, const int32_t* c, long nnz,
                        long rows, long cols, int32_t group_req, int32_t L,
                        int64_t* meta) {
  using namespace rowlane;
  if (nnz <= 0 || L <= 0 || kLanes % L) return -1;
  State& s = g;
  s.L = L;
  s.T = kLanes / L;
  s.nnz = nnz;
  s.rows = rows;
  s.cols = cols;
  s.n_tiles = (rows + s.T - 1) / s.T;
  s.n_win = std::max((cols + kW - 1) / kW, 1L);
  const long T = s.T, n_win = s.n_win;

  // sort entries by bucket key; pack (key, idx) into one uint64 when both
  // fit (stability comes free from the idx low bits)
  const int idx_bits = 64 - __builtin_clzll((unsigned long long)nnz);
  const int64_t max_key = ((s.n_tiles * n_win) * 8 + 7) * T + (T - 1);
  const int key_bits = 64 - __builtin_clzll((unsigned long long)max_key + 1);
  s.packed_sort = key_bits + idx_bits <= 64;
  if (s.packed_sort) {
    s.skey.resize(nnz);
    for (long i = 0; i < nnz; ++i)
      s.skey[i] = ((uint64_t)entry_key(r[i], c[i], n_win, T) << idx_bits) |
                  (uint64_t)i;
    std::sort(s.skey.begin(), s.skey.begin() + nnz);
  } else {
    s.key.resize(nnz);
    s.order.resize(nnz);
    for (long i = 0; i < nnz; ++i) {
      s.key[i] = entry_key(r[i], c[i], n_win, T);
      s.order[i] = i;
    }
    std::stable_sort(s.order.begin(), s.order.begin() + nnz,
                     [&](int64_t a, int64_t b) { return s.key[a] < s.key[b]; });
  }
  const int ib = idx_bits;
  auto sorted_key = [&](long i) -> int64_t {
    return s.packed_sort ? (int64_t)(s.skey[i] >> ib) : s.key[s.order[i]];
  };

  // pass 1: per-(t, w) slab count = ceil(max bucket depth / L)
  s.slabcnt.assign(s.n_tiles * n_win, 0);
  for (long i = 0; i < nnz;) {
    long j = i + 1;
    const int64_t k0 = sorted_key(i);
    while (j < nnz && sorted_key(j) == k0) ++j;
    const long tw = k0 / (8 * T);
    const int32_t cnt = (int32_t)((j - i + L - 1) / L);
    if (cnt > s.slabcnt[tw]) s.slabcnt[tw] = cnt;
    i = j;
  }

  // per-tile totals, in-tile slab ranks, group selection, padded offsets
  s.counts.assign(s.n_tiles, 0);
  s.slab_start.resize(s.n_tiles * n_win);
  long n_slabs = 0;
  for (long t = 0; t < s.n_tiles; ++t) {
    long acc = 0;
    for (long w = 0; w < n_win; ++w) {
      s.slab_start[t * n_win + w] = acc;
      acc += s.slabcnt[t * n_win + w];
    }
    s.counts[t] = acc;
    n_slabs += acc;
  }
  int32_t group = group_req;
  if (group <= 0) {
    group = 1;
    for (int32_t cand : {256, 128, 64, 32, 16, 8, 4, 2}) {
      long padded = 0;
      for (long t = 0; t < s.n_tiles; ++t)
        padded += (s.counts[t] + cand - 1) / cand * cand;
      if (n_slabs > 0 &&
          (double)(padded - n_slabs) / (double)n_slabs <= 0.15) {
        group = cand;
        break;
      }
    }
  }
  s.group = group;
  s.tile_groups.resize(s.n_tiles);
  s.tile_offset.assign(s.n_tiles + 1, 0);
  for (long t = 0; t < s.n_tiles; ++t) {
    s.tile_groups[t] = (int32_t)((s.counts[t] + group - 1) / group);
    s.tile_offset[t + 1] =
        s.tile_offset[t] + (int64_t)s.tile_groups[t] * group;
  }
  s.total_slots = s.tile_offset[s.n_tiles];
  s.n_groups = s.total_slots / group;
  meta[0] = s.total_slots;
  meta[1] = s.n_groups;
  meta[2] = group;
  meta[3] = s.n_tiles;
  meta[4] = s.n_win;
  meta[5] = n_slabs;
  return 0;
}

// Spill mask: keep[i] = occurrence-of-entry-i-within-its-bucket < depth.
// Same sort as the plan (separate state; callable before plan).
long smtpu_rowlane_spill_mask(const int32_t* r, const int32_t* c, long nnz,
                              long rows, long cols, int32_t L,
                              int32_t depth, uint8_t* keep) {
  using namespace rowlane;
  if (nnz <= 0 || L <= 0 || kLanes % L) return -1;
  const long T = kLanes / L;
  const long n_win = std::max((cols + kW - 1) / kW, 1L);
  const int idx_bits = 64 - __builtin_clzll((unsigned long long)nnz);
  const long n_tiles = (rows + T - 1) / T;
  const int64_t max_key = ((n_tiles * n_win) * 8 + 7) * T + (T - 1);
  const int key_bits = 64 - __builtin_clzll((unsigned long long)max_key + 1);
  if (key_bits + idx_bits <= 64) {
    std::vector<uint64_t> sk(nnz);
    for (long i = 0; i < nnz; ++i)
      sk[i] = ((uint64_t)entry_key(r[i], c[i], n_win, T) << idx_bits) |
              (uint64_t)i;
    std::sort(sk.begin(), sk.end());
    const uint64_t mask = (((uint64_t)1) << idx_bits) - 1;
    for (long i = 0; i < nnz;) {
      long j = i + 1;
      while (j < nnz && (sk[j] >> idx_bits) == (sk[i] >> idx_bits)) ++j;
      for (long q = i; q < j; ++q)
        keep[sk[q] & mask] = (q - i) < (long)depth;
      i = j;
    }
  } else {
    std::vector<int64_t> key(nnz), order(nnz);
    for (long i = 0; i < nnz; ++i) {
      key[i] = entry_key(r[i], c[i], n_win, T);
      order[i] = i;
    }
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return key[a] < key[b]; });
    for (long i = 0; i < nnz;) {
      long j = i + 1;
      while (j < nnz && key[order[j]] == key[order[i]]) ++j;
      for (long q = i; q < j; ++q) keep[order[q]] = (q - i) < (long)depth;
      i = j;
    }
  }
  return 0;
}

// Phase 2: scatter into caller-allocated (and zero-filled) outputs.
//   s_idx: int8 [total_slots * 8 * 128]; vals: esize bytes per slot;
//   win: int32 [total_slots]; group_tile: int32 [n_groups];
//   tile_nonempty: uint8 [n_tiles].  v is the entry values (esize bytes
//   each, any dtype — copied opaquely).
long smtpu_rowlane_fill(const int32_t* r, const int32_t* c, const uint8_t* v,
                        long esize, int8_t* s_idx, uint8_t* vals,
                        int32_t* win, int32_t* group_tile,
                        uint8_t* tile_nonempty) {
  using namespace rowlane;
  State& s = g;
  if (s.nnz <= 0) return -1;
  const long T = s.T, n_win = s.n_win, nnz = s.nnz;
  const int idx_bits = 64 - __builtin_clzll((unsigned long long)nnz);
  auto sorted_pair = [&](long i, int64_t* k, long* e) {
    if (s.packed_sort) {
      *k = (int64_t)(s.skey[i] >> idx_bits);
      *e = (long)(s.skey[i] & (((uint64_t)1 << idx_bits) - 1));
    } else {
      *e = s.order[i];
      *k = s.key[*e];
    }
  };
  for (long i = 0; i < nnz;) {
    int64_t k0;
    long e0;
    sorted_pair(i, &k0, &e0);
    long j = i;
    // walk the bucket: occurrence d = j - i
    const long tw = k0 / (8 * T);
    const long t = tw / n_win;
    const int64_t base = s.tile_offset[t] + s.slab_start[tw];
    for (;;) {
      int64_t kj;
      long ej;
      if (j < nnz) sorted_pair(j, &kj, &ej);
      if (j >= nnz || kj != k0) break;
      const long d = j - i;
      const int32_t rr = r[ej], cc = c[ej];
      const long u = (cc % kW) / kLanes;
      const long lane = (rr % T) + (d % s.L) * T;
      const int64_t slot = base + d / s.L;
      const int64_t off = slot * 8 * kLanes + u * kLanes + lane;
      s_idx[off] = (int8_t)(cc % kLanes);
      std::memcpy(vals + off * esize, v + (long)ej * esize, esize);
      ++j;
    }
    i = j;
  }
  // window ids for every real slab; padded slots stay 0 (harmless: their
  // values are zero)
  for (long t = 0; t < s.n_tiles; ++t) {
    tile_nonempty[t] = s.counts[t] > 0;
    for (long w = 0; w < n_win; ++w) {
      const int64_t b = s.tile_offset[t] + s.slab_start[t * n_win + w];
      for (int32_t q = 0; q < s.slabcnt[t * n_win + w]; ++q)
        win[b + q] = (int32_t)w;
    }
  }
  long gidx = 0;
  for (long t = 0; t < s.n_tiles; ++t)
    for (int32_t q = 0; q < s.tile_groups[t]; ++q) group_tile[gidx++] = t;
  return 0;
}

}  // extern "C"
