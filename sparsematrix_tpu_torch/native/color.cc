// Host colorers: the sublane coloring of packed-SpGEMM pair programs
// (ops/spgemm.py::_color_b_ranks) and the Euler-split edge colorings of
// the Clos-routed permutation planner (ops/permute_clos.py).
//
// A copy of smtpu_color_ranks, smtpu_edge_color and
// smtpu_edge_color_batched from the JAX package's host codec
// (sparsematrix_tpu/native/codec.cc), kept here so that the port builds
// them from its own sources: the plans must come out equal to the JAX
// planner's, so the algorithms are the same line for line.
//
// Built with g++ -O3 -shared -fPIC -pthread at first use
// (kernels/_build.py) and loaded with ctypes.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Sublane coloring for packed-SpGEMM pair programs
// (ops/spgemm.py::_color_b_ranks — bit-identical greedy).
//
// Each B-entry rank inside its 1024-rank window gets a (sublane, slot) so
// that every output slot's references land on distinct sublanes: greedy
// over ranks in order; a rank's forbidden set is the OR of the colors
// already used by the rows (output slots) referencing it within the
// current window; pick the least-loaded non-full color, +100000 penalty
// when forbidden; ties break to the lowest color index.
// ---------------------------------------------------------------------------

extern "C" {

// pair arrays: q[i] = B-entry rank of pair i, row[i] = P-row of pair i.
// alloc (out, n_ranks int64): window-absolute position per rank.
long smtpu_color_ranks(const int32_t* q, const int32_t* row, long n_pairs,
                       long n_ranks, long n_rows, int64_t* alloc) {
  if (n_ranks <= 0) return 0;
  // counting-sort pairs by rank (stable) -> per-rank row lists
  std::vector<int64_t> start(n_ranks + 1, 0);
  for (long i = 0; i < n_pairs; ++i) ++start[(int64_t)q[i] + 1];
  for (long k = 0; k < n_ranks; ++k) start[k + 1] += start[k];
  std::vector<int32_t> rows_s(n_pairs);
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    for (long i = 0; i < n_pairs; ++i) rows_s[cur[q[i]]++] = row[i];
  }
  std::vector<uint16_t> used(n_rows, 0);
  std::vector<int64_t> stamp(n_rows, -1);
  int64_t capc[8];
  int64_t cur_w = -1;
  for (long qq = 0; qq < n_ranks; ++qq) {
    const int64_t w = qq >> 10;
    if (w != cur_w) {
      cur_w = w;
      for (int c = 0; c < 8; ++c) capc[c] = 0;
    }
    unsigned forbid = 0;
    for (int64_t j = start[qq]; j < start[qq + 1]; ++j) {
      const int32_t rr = rows_s[j];
      if (stamp[rr] != w) { used[rr] = 0; stamp[rr] = w; }
      forbid |= used[rr];
    }
    int best = 0;
    int64_t bestload = (int64_t)1 << 30;
    for (int c = 0; c < 8; ++c) {
      if (capc[c] >= 128) continue;
      const int64_t load = capc[c] + (((forbid >> c) & 1u) ? 100000 : 0);
      if (load < bestload) { best = c; bestload = load; }
    }
    alloc[qq] = (qq >> 10 << 10) + (int64_t)best * 128 + capc[best];
    ++capc[best];
    const uint16_t bit = (uint16_t)(1u << best);
    for (int64_t j = start[qq]; j < start[qq + 1]; ++j) used[rows_s[j]] |= bit;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Euler-split edge coloring for the Clos-routed planned permutation
// (ops/permute_clos.py).
//
// A REGULAR bipartite multigraph with all degrees == n_colors (a power
// of two) is n_colors-edge-colorable (König); the Euler-split
// construction halves the graph log2(n_colors) times: all degrees are
// even at every level, so each connected edge subset decomposes into
// closed walks, and taking alternate edges of each walk splits every
// vertex's degree exactly in half.  Each level is O(E); total
// O(E log n_colors).
//
// Used twice by the permutation planner: (1) the grid-level routing —
// left = source row, right = destination row, n_colors = 1024 — whose
// color is the intermediate column of the row-local/column-local/
// row-local (Clos) decomposition; (2) the window-level middle-slot
// assignment — left = dest sublane u, right = source sublane c,
// n_colors = 128 — giving the POS/CH/RT planes of the 3-gather kernel
// (kernels/permute_pallas.py), same addressing as the octet SpMV
// (kernels/spmv_octet.py).  No reference analogue: the reference
// permutes on the host (sparse-matrix.cc CopyTo scatter); on TPU the
// planned device permutation is the engineered capability.
// ---------------------------------------------------------------------------


extern "C" {

// left[e] in [0, n_left), right[e] in [0, n_right); every left vertex
// must have degree exactly n_colors and every right vertex likewise
// (n_edges == n_left*n_colors == n_right*n_colors); n_colors a power of
// two.  Writes color[e] in [0, n_colors).  Returns 0, or -1 on invalid
// input (non-regular / not a power of two).
long smtpu_edge_color(const int32_t* left, const int32_t* right,
                      long n_edges, long n_left, long n_right,
                      long n_colors, int32_t* color) {
  if (n_colors <= 0 || (n_colors & (n_colors - 1)) != 0) return -1;
  if (n_edges != n_left * n_colors || n_edges != n_right * n_colors)
    return -1;
  const long n_vert = n_left + n_right;
  if (n_colors == 1) {
    for (long e = 0; e < n_edges; ++e) color[e] = 0;
    return 0;
  }
  // adjacency: per vertex, the incident edge ids (each edge listed at
  // its left vertex and at its right vertex).  Rebuilt per level over
  // the level's edge order (bucketed by current color prefix).
  std::vector<int32_t> cur_color(n_edges, 0);
  std::vector<int64_t> adj_start(n_vert + 1);
  std::vector<int32_t> adj_edge(2 * n_edges);
  std::vector<int64_t> cursor(n_vert);
  std::vector<uint8_t> used(n_edges);
  // edge ids bucketed by color class, rebuilt per level
  std::vector<int32_t> bucket(n_edges), bucket_next(n_edges);
  std::vector<int64_t> class_start, class_cnt;
  for (long e = 0; e < n_edges; ++e) bucket[e] = (int32_t)e;
  long n_classes = 1;
  long deg = n_colors;  // degree of every vertex within each class
  std::vector<int64_t> cls_off(2);
  cls_off[0] = 0; cls_off[1] = n_edges;
  // per-class splitter (classes hold disjoint edge sets, so threads
  // share `used`/`cur_color` without contention; each thread carries its
  // own adjacency scratch)
  auto split_classes = [&](long cls_lo, long cls_hi,
                           std::vector<int64_t>& t_adj_start,
                           std::vector<int32_t>& t_adj_edge,
                           std::vector<int64_t>& t_cursor) {
    for (long cls = cls_lo; cls < cls_hi; ++cls) {
      const int64_t lo = cls_off[cls], hi = cls_off[cls + 1];
      // build adjacency for this class
      std::fill(t_adj_start.begin(), t_adj_start.end(), 0);
      for (int64_t i = lo; i < hi; ++i) {
        const int32_t e = bucket[i];
        t_adj_start[left[e] + 1]++;
        t_adj_start[n_left + right[e] + 1]++;
      }
      for (long v = 0; v < n_vert; ++v)
        t_adj_start[v + 1] += t_adj_start[v];
      for (long v = 0; v < n_vert; ++v) t_cursor[v] = t_adj_start[v];
      for (int64_t i = lo; i < hi; ++i) {
        const int32_t e = bucket[i];
        t_adj_edge[t_cursor[left[e]]++] = e;
        t_adj_edge[t_cursor[n_left + right[e]]++] = e;
      }
      for (long v = 0; v < n_vert; ++v) t_cursor[v] = t_adj_start[v];
      // closed-trail decomposition: from any vertex with an unused
      // edge, greedily walk until stuck (even degrees => stuck only at
      // the start), alternating the split bit along the trail.  Each
      // visit to a vertex consumes one in-edge and one out-edge with
      // opposite bits, so every vertex's class degree splits evenly.
      for (int64_t i = lo; i < hi; ++i) {
        const int32_t e0 = bucket[i];
        if (used[e0]) continue;
        long v = left[e0];  // start of a new closed trail
        int bit = 0;
        while (true) {
          // next unused incident edge of v in this class
          int32_t e = -1;
          while (t_cursor[v] < t_adj_start[v + 1]) {
            const int32_t cand = t_adj_edge[t_cursor[v]];
            if (!used[cand]) { e = cand; break; }
            t_cursor[v]++;
          }
          if (e < 0) break;  // trail closed
          used[e] = 1;
          cur_color[e] = (int32_t)((cur_color[e] << 1) | bit);
          bit ^= 1;
          v = (v == left[e]) ? (long)(n_left + right[e]) : (long)left[e];
        }
      }
    }
  };
  while (deg > 1) {
    // split every class: walk closed trails, alternate edges
    std::fill(used.begin(), used.end(), 0);
    long n_thr = (long)std::thread::hardware_concurrency();
    if (n_thr < 1) n_thr = 1;
    if (n_thr > n_classes) n_thr = n_classes;
    if (n_thr <= 1) {
      split_classes(0, n_classes, adj_start, adj_edge, cursor);
    } else {
      std::vector<std::thread> thr;
      std::vector<std::vector<int64_t>> as(n_thr), cu(n_thr);
      std::vector<std::vector<int32_t>> ae(n_thr);
      for (long t = 0; t < n_thr; ++t) {
        as[t].resize(n_vert + 1);
        cu[t].resize(n_vert);
        ae[t].resize(2 * (n_edges / n_classes) + 2);
        const long c0 = t * n_classes / n_thr;
        const long c1 = (t + 1) * n_classes / n_thr;
        thr.emplace_back([&, t, c0, c1]() {
          split_classes(c0, c1, as[t], ae[t], cu[t]);
        });
      }
      for (auto& th : thr) th.join();
    }
    // re-bucket by the new (doubled) class count via counting sort
    deg >>= 1;
    n_classes <<= 1;
    cls_off.assign(n_classes + 1, 0);
    for (long e = 0; e < n_edges; ++e) cls_off[cur_color[e] + 1]++;
    for (long c = 0; c < n_classes; ++c) cls_off[c + 1] += cls_off[c];
    std::vector<int64_t> pos(cls_off.begin(), cls_off.end() - 1);
    for (long e = 0; e < n_edges; ++e)
      bucket_next[pos[cur_color[e]]++] = (int32_t)e;
    bucket.swap(bucket_next);
  }
  for (long e = 0; e < n_edges; ++e) color[e] = cur_color[e];
  return 0;
}

}  // extern "C"

extern "C" {

// Batched small-bipartite edge coloring (the window / q-block colorings
// of the Clos permutation planner): many INDEPENDENT nL×nR bipartite
// multigraphs (nL, nR ≤ 16), each with all left/right degrees exactly
// n_colors (a power of two).  The generic colorer above walks global
// edge lists (cache-hostile at 4M edges: measured ~6 s/call); here each
// batch's multigraph is an L1-resident count matrix and the Euler split
// recurses on counts, then colors are dealt to each cell's edges in
// order — ~40× faster at the planner's sizes.
//
// Edges arrive in ARBITRARY order; batch[e] in [0, n_batch).  Writes
// color[e] in [0, n_colors).  Returns 0, -1 on invalid input.
long smtpu_edge_color_batched(const int32_t* left, const int32_t* right,
                              const int32_t* batch, long n_edges,
                              long n_batch, long nL, long nR,
                              long n_colors, int32_t* color) {
  if (n_colors <= 0 || (n_colors & (n_colors - 1)) != 0) return -1;
  if (nL > 16 || nR > 16 || nL <= 0 || nR <= 0) return -1;
  // bucket edges by batch (counting sort)
  std::vector<int64_t> boff(n_batch + 1, 0);
  for (long e = 0; e < n_edges; ++e) {
    if (batch[e] < 0 || batch[e] >= n_batch) return -1;
    boff[batch[e] + 1]++;
  }
  for (long b = 0; b < n_batch; ++b) boff[b + 1] += boff[b];
  std::vector<int64_t> cur(boff.begin(), boff.end() - 1);
  std::vector<int32_t> eid(n_edges);
  for (long e = 0; e < n_edges; ++e) eid[cur[batch[e]]++] = (int32_t)e;

  const int cells = (int)(nL * nR);
  // iterative split with explicit stack of (count-matrix, base, d)
  const int max_depth = 20;
  std::vector<int32_t> mats((max_depth + 2) * cells * 2);
  std::vector<int32_t> pair_cell(n_edges < (long)(nL * n_colors)
                                 ? nL * n_colors : 0);
  for (long b = 0; b < n_batch; ++b) {
    const int64_t lo = boff[b], hi = boff[b + 1];
    if (lo == hi) continue;
    if (hi - lo != (long)(nL * n_colors)) return -2;  // not regular
    // build count matrix
    std::vector<int32_t> orig(cells, 0);
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t e = eid[i];
      orig[left[e] * nR + right[e]]++;
    }
    // (cell, color) leaves
    std::vector<int32_t> leaves(2 * (hi - lo));
    long n_leaves = 0;
    // explicit recursion
    struct Frame { long d; int32_t base; int32_t* cnt; };
    std::vector<std::vector<int32_t>> pool;
    std::vector<Frame> stack;
    pool.emplace_back(orig);
    stack.push_back({n_colors, 0, pool.back().data()});
    std::vector<std::vector<int32_t>> keep;  // keep pool storage alive
    while (!stack.empty()) {
      Frame f = stack.back();
      stack.pop_back();
      if (f.d == 1) {
        for (int i = 0; i < cells; ++i)
          if (f.cnt[i]) {
            leaves[2 * n_leaves] = i;
            leaves[2 * n_leaves + 1] = f.base;
            n_leaves++;
          }
        continue;
      }
      // split f.cnt into A/B via count-matrix Euler walk
      keep.emplace_back(cells, 0);
      int32_t* A = keep.back().data();
      keep.emplace_back(f.cnt, f.cnt + cells);
      int32_t* W = keep.back().data();  // working copy to consume
      int curL[16] = {0}, curR[16] = {0};
      long degL[16];
      for (int u = 0; u < nL; ++u) {
        long s = 0;
        for (int c = 0; c < nR; ++c) s += W[u * nR + c];
        degL[u] = s;
      }
      int start = 0;
      long remaining = f.d * nL;
      while (remaining > 0) {
        while (start < nL && degL[start] == 0) start++;
        int v = start, side = 0, bit = 0;
        while (true) {
          int found = -1;
          if (side == 0) {
            for (int k = 0; k < (int)nR; ++k) {
              int c = (curL[v] + k) % (int)nR;
              if (W[v * nR + c] > 0) { found = c; curL[v] = c; break; }
            }
            if (found < 0) break;
            W[v * nR + found]--;
            degL[v]--;
            if (bit == 0) A[v * nR + found]++;
            bit ^= 1;
            remaining--;
            v = found; side = 1;
          } else {
            for (int k = 0; k < (int)nL; ++k) {
              int u = (curR[v] + k) % (int)nL;
              if (W[u * nR + v] > 0) { found = u; curR[v] = u; break; }
            }
            if (found < 0) break;
            W[found * nR + v]--;
            degL[found]--;
            if (bit == 0) A[found * nR + v]++;
            bit ^= 1;
            remaining--;
            v = found; side = 0;
          }
        }
      }
      // B = f.cnt - A (in place into f.cnt's storage)
      for (int i = 0; i < cells; ++i) f.cnt[i] -= A[i];
      stack.push_back({f.d / 2, f.base, A});
      stack.push_back({f.d / 2, (int32_t)(f.base + f.d / 2), f.cnt});
    }
    // deal colors to edges: bucket leaves by cell, then walk edges
    // bucketed by cell in arrival order
    std::vector<int32_t> cell_off(cells + 1, 0);
    for (long i = 0; i < n_leaves; ++i) cell_off[leaves[2 * i] + 1]++;
    for (int i = 0; i < cells; ++i) cell_off[i + 1] += cell_off[i];
    std::vector<int32_t> cell_colors(n_leaves);
    std::vector<int32_t> ccur(cell_off.begin(), cell_off.end() - 1);
    for (long i = 0; i < n_leaves; ++i)
      cell_colors[ccur[leaves[2 * i]]++] = leaves[2 * i + 1];
    std::vector<int32_t> take(cell_off.begin(), cell_off.end() - 1);
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t e = eid[i];
      const int cell = left[e] * (int)nR + right[e];
      color[e] = cell_colors[take[cell]++];
    }
  }
  return 0;
}

}  // extern "C"
