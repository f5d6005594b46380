// Row-lane SpMM, Y = A @ X over a rowlane pack with one lane a row
// (lanes_per_row = 1: each group serves one 128-row tile).
//
// Replaces the Pallas kernel _rowlane_mm_kernel of
// sparsematrix_tpu/kernels/spmm_rowlane.py (_rowlane_mm_call, pallas_call
// at :71).  That kernel walks every slab of a group once per RHS column (a
// fori_loop over the k columns, X staged transposed as (k*S, 128) panes so
// that a (column, window) pane is one (8, 128) tile), sums the slabs over
// sublanes and adds each column's 128 row sums into its (k, 128) output
// tile, cleared at a tile's first group; the wrapper masks the tiles no
// group touches and chunks the groups by the scalar-prefetch budget.
//
// What bounds it: bytes.  Each slot's value (4 or 2 bytes) and s_idx (1)
// are read once, each X row a stored entry names feeds k FMAs, Y is
// written once.  On the padded planes of a pack (the XL CSR as
// partition_rowlane packs it: 66 080 slabs, ~25 % full) the plane stream
// itself is the layout floor: 66 080 x 1024 slots x 5 bytes, 338 MB.
//
// Two walks, picked on the host (kernels/spmm_rowlane.py mm_design):
//
// window (window_walk, C entry spmm_rowlane_window), the default: the
// host lists the slabs that hold a nonzero value window by window, each
// window's slabs by tile (rowlane_mm_walk), and cuts the list into about
// one block an SM, every block inside one window.  A block of four teams
// of four warps first stages its window's 1024 rows of X's current
// column panel (32 columns; 16 or 8 where k is that narrow) in shared
// memory by cp.async, then each team walks a contiguous share of the
// block's slabs, warp w of a team serving the slab's row lanes
// 32w..32w+31.  Per slab a thread loads its row's 8 slots (value and
// s_idx, one slab ahead, streamed) and appends the ones that add
// something (a nonzero value at a column below cols) to its row's list in
// shared memory: (value, the staged row's offset).  The warp then walks
// the lists G rows at a time: the C = panel/4 lanes of a row group read 4
// columns each of an entry's staged X row (16 bytes a lane: a group reads
// one whole row, so a warp's read has no bank conflict) and add value x
// row into their registers.  So no X row is read from L2 per slot (the
// block reads its window once a panel), a slot costs one broadcast read
// of its entry and one of its X row, and the sums stay in registers while
// the tile stays the same; they are added into the zeroed Y with float4
// atomicAdd (red.global.add.v4.f32) where the tile changes, so the fp32
// summation order of Y varies from run to run.
//
// gather (spmm_walk, C entry spmm_rowlane), the first design, kept for
// packs whose walk would gather fewer X bytes than the window walk would
// stage (small packs: each block stages a whole window).  A warp owns 32
// lanes of a tile and covers the columns in chunks of 32, thread t
// holding column j0 + t of all 32 rows in a private column of a
// shared-memory panel.  Per slab a ballot a sublane compacts the slots
// whose value is nonzero into a shared list, and the warp reads each kept
// slot's X row from L2 as one 128-byte line, 8 lines in flight, adding it
// into the panel; the panel is added into Y with atomicAdd where the tile
// changes.  Its `parts` (measurement only; the result is then not the
// product): 1 reads no X row (the panel takes the value), 2 reads the X
// rows but updates no panel, 3 walks and compacts the planes alone.
//
// Both walks read no X row under a zero value: padding and stored zeros
// add exactly 0, where the TPU kernel multiplies them in (an inf or NaN
// of X under a zero value gives NaN there, 0 here).  Columns past cols
// and rows past rows are masked; X is never padded.  A tile that no group
// touches keeps its zeros (the TPU kernel's "touched" mask).  One launch
// covers every group: the TPU's chunking by its prefetch budget is not
// needed.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "bulk.cuh"
#include "common.cuh"
#include "rowlane.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = rl::kLanes / kWarp;  // 4 warps cover a tile's lanes
constexpr int kBatch = 8;  // kept slots whose X lines load together
constexpr int kList = rl::kSub * kWarp;  // a slab's slots a warp
constexpr unsigned kAll = 0xffffffffu;

struct MmPack {
  const uint8_t* s_idx;
  const void* vals;
  const int32_t* group_tile;
  const int32_t* slab_win;
  long long n_slabs;
  int rows, cols, k, group;
};

// ---------------------------------------------------------------------------
// the gather walk (the first design)
// ---------------------------------------------------------------------------

template <bool VBF16, bool XBF16, int PARTS>
__global__ void __launch_bounds__(rl::kLanes)
    spmm_walk(MmPack p, const void* __restrict__ X, float* __restrict__ Y,
              int spb) {
  // panel[warp][row r][column t]: thread t owns column t of its warp's
  // panel, so no other thread touches its words
  __shared__ float panel[kWarps][kWarp * kWarp];
  // a slab's kept slots, compacted a warp: value, column, row in the warp
  __shared__ float list_v[kWarps][kList];
  __shared__ int list_c[kWarps][kList];
  __shared__ unsigned char list_r[kWarps][kList];
  const int t = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int l = threadIdx.x;  // the lane whose slots this thread loads
  const unsigned below = (1u << t) - 1u;  // the warp's lanes before t
  float* acc = panel[w];
  float* lv = list_v[w];
  int* lc = list_c[w];
  unsigned char* lr = list_r[w];
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, p.n_slabs);
  float chk = 0.f;  // what an ablation does not store (parts 2 and 3)
  for (int j0 = 0; j0 < p.k; j0 += kWarp) {
    const bool live = j0 + t < p.k;
    for (int r = 0; r < kWarp; ++r) acc[r * kWarp + t] = 0.f;
    long long cur = -1;
    auto flush = [&]() {
      for (int r = 0; r < kWarp; ++r) {
        const long long row = cur * rl::kLanes + w * kWarp + r;
        if (cur >= 0 && live && row < p.rows)
          atomicAdd(Y + row * p.k + j0 + t, acc[r * kWarp + t]);
        acc[r * kWarp + t] = 0.f;
      }
    };
    // this thread's slots of slab s: values and columns, loaded one slab
    // ahead so that their latency hides behind the previous slab's walk
    float v_u[rl::kSub];
    long long col_u[rl::kSub];
    auto load_slab = [&](long long s) {
      const long long w0 = (long long)__ldg(p.slab_win + s) * rl::kWindow;
      const long long pb = s * rl::kSlab;
#pragma unroll
      for (int u = 0; u < rl::kSub; ++u) {
        const long long at = pb + u * rl::kLanes + l;
        v_u[u] = common::load_val<VBF16>(p.vals, at);
        col_u[u] = w0 + u * rl::kLanes + (__ldg(p.s_idx + at) & 127);
      }
    };
    if (s0 < s1) load_slab(s0);
    for (long long s = s0; s < s1; ++s) {
      const long long tile = __ldg(p.group_tile + s / p.group);
      if (tile != cur) {
        if (PARTS < 2) flush();
        cur = tile;
      }
      float v_s[rl::kSub];
      long long col_s[rl::kSub];
#pragma unroll
      for (int u = 0; u < rl::kSub; ++u) {
        v_s[u] = v_u[u];
        col_s[u] = col_u[u];
      }
      if (s + 1 < s1) load_slab(s + 1);
      // compact the slab's slots that add something (a nonzero value
      // inside the matrix) into the warp's list, sublane by sublane
      int n = 0;
#pragma unroll
      for (int u = 0; u < rl::kSub; ++u) {
        const float v = v_s[u];
        const long long col = col_s[u];
        const bool keep = v != 0.f && col < p.cols;
        const unsigned kept = __ballot_sync(kAll, keep);
        if (keep) {
          const int e = n + __popc(kept & below);
          lv[e] = v;
          lc[e] = (int)col;
          lr[e] = (unsigned char)t;
        }
        n += __popc(kept);
      }
      __syncwarp();
      if (PARTS == 3) {
        chk += n > 0 ? lv[n - 1] : 0.f;
        __syncwarp();
        continue;
      }
      // the warp reads each kept slot's X row as one line, kBatch lines
      // in flight before the first is added
      for (int i0 = 0; i0 < n; i0 += kBatch) {
        float x_b[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          x_b[i] = PARTS == 1 ? 1.f
                   : (i0 + i < n && live)
                       ? common::load_val<XBF16>(
                             X, (long long)lc[i0 + i] * p.k + j0 + t)
                       : 0.f;
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (i0 + i < n) {
            if (PARTS == 2) {
              chk = fmaf(lv[i0 + i], x_b[i], chk);
            } else {
              float* a = acc + lr[i0 + i] * kWarp + t;
              *a = fmaf(lv[i0 + i], x_b[i], *a);
            }
          }
      }
      __syncwarp();
    }
    if (PARTS < 2) flush();
  }
  // an ablation's sums are stored only if they reach a value no run
  // reaches, so the compiler keeps the loads and arithmetic it times
  if (PARTS >= 2 && chk == 1.2345e30f) Y[0] = chk;
}

template <bool VBF16, bool XBF16, int PARTS>
cudaError_t launch_gather(const MmPack& p, const void* X, float* Y,
                          cudaStream_t st) {
  const int spb = rl::slabs_per_block(p.n_slabs);
  const unsigned blocks = (unsigned)((p.n_slabs + spb - 1) / spb);
  spmm_walk<VBF16, XBF16, PARTS><<<blocks, rl::kLanes, 0, st>>>(p, X, Y,
                                                                spb);
  return cudaGetLastError();
}

template <bool VBF16, bool XBF16>
cudaError_t gather_parts(int parts, const MmPack& p, const void* X, float* Y,
                         cudaStream_t st) {
  switch (parts) {
    case 0: return launch_gather<VBF16, XBF16, 0>(p, X, Y, st);
    case 1: return launch_gather<VBF16, XBF16, 1>(p, X, Y, st);
    case 2: return launch_gather<VBF16, XBF16, 2>(p, X, Y, st);
    case 3: return launch_gather<VBF16, XBF16, 3>(p, X, Y, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the window walk
// ---------------------------------------------------------------------------

constexpr int kTeamWarps = 4;  // a team covers a slab's 128 row lanes
constexpr int kTeams = 4;
constexpr int kWinThreads = kTeams * kTeamWarps * kWarp;
constexpr int kRowList = rl::kSub + 1;  // entries a row (+1: bank spread)
constexpr int kSmemMax = 232448;

// a row's list entry: the slot's value and the element offset of its
// column's row in the staged window (each reader adds its columns)
struct __align__(8) Entry {
  float v;
  int off;
};

template <bool XBF16>
struct XStage {
  using T = typename std::conditional<XBF16, uint16_t, float>::type;
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   bulk::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// 4 consecutive staged elements as fp32 (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 lds4(const uint16_t* p) {
  const uint2 h = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(h.x << 16),
                     __uint_as_float(h.x & 0xffff0000u),
                     __uint_as_float(h.y << 16),
                     __uint_as_float(h.y & 0xffff0000u));
}

// KP: columns of X a pass (32, 16 or 8).  items (slab, tile, window, 0)
// int4 of the slabs that hold a value, a block's all in one window;
// part_ptr: block b's team q walks items [part_ptr[4b+q], part_ptr[4b+q+1]).
template <int KP, bool VBF16, bool XBF16>
__global__ void __launch_bounds__(kWinThreads, 1)
    window_walk(MmPack p, const int4* __restrict__ items,
                const int* __restrict__ part_ptr, const void* __restrict__ X,
                float* __restrict__ Y) {
  using XT = typename XStage<XBF16>::T;
  constexpr int VEC = XStage<XBF16>::kVec;
  constexpr int C = KP / 4;    // lanes a row: 4 columns each
  constexpr int G = kWarp / C; // rows a warp step
  constexpr int S = kWarp / G; // steps over the warp's 32 rows
  extern __shared__ __align__(128) unsigned char sm[];
  XT* xs = reinterpret_cast<XT*>(sm);  // [1024][KP]
  Entry* lists = reinterpret_cast<Entry*>(
      sm + (size_t)rl::kWindow * KP * sizeof(XT));
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wq = warp % kTeamWarps;   // the warp within its team
  const int l = wq * kWarp + lane;    // the row lane this thread loads
  const int g = lane / C;             // its row within a step
  const int cq = (lane % C) * 4;      // its 4 columns of the panel
  Entry* list = lists + warp * kWarp * kRowList;  // the warp's 32 rows
  Entry* mine = list + lane * kRowList;           // this thread's row
  const int tq = blockIdx.x * kTeams + warp / kTeamWarps;
  const int i0 = __ldg(part_ptr + tq), i1 = __ldg(part_ptr + tq + 1);
  const int b0 = __ldg(part_ptr + blockIdx.x * kTeams);
  if (b0 == __ldg(part_ptr + (blockIdx.x + 1) * kTeams)) return;  // empty
  const long long r0 = (long long)__ldg(&items[b0].z) * rl::kWindow;
  const XT* Xt = static_cast<const XT*>(X);
  const bool vec16 = p.k % VEC == 0;
  for (int j0 = 0; j0 < p.k; j0 += KP) {
    // the window's rows of the panel by cp.async, 16 bytes a copy where
    // the columns allow it; rows past cols and columns past k read 0
    if (j0 > 0) __syncthreads();  // every team is done with the panel
    constexpr int q_row = KP / VEC;  // copies a staged row
    for (int e = threadIdx.x; e < rl::kWindow * q_row; e += kWinThreads) {
      const int r = e / q_row, c = (e - r * q_row) * VEC;
      XT* dst = xs + r * KP + c;
      const long long row = r0 + r;
      if (vec16 && row < p.cols && j0 + c + VEC <= p.k) {
        cp16(dst, Xt + row * p.k + j0 + c);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          dst[i] = row < p.cols && j0 + c + i < p.k
                       ? Xt[row * p.k + j0 + c + i] : XT(0);
      }
    }
    cp_commit_wait();
    __syncthreads();
    float acc[S][4];
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    long long cur = -1;
    auto flush = [&]() {
      if (cur < 0) return;
      const int col = j0 + cq;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const long long row = cur * rl::kLanes + wq * kWarp + i * G + g;
        const float* a = acc[i];
        if (row < p.rows && col < p.k &&
            (a[0] != 0.f || a[1] != 0.f || a[2] != 0.f || a[3] != 0.f)) {
          float* y = Y + row * p.k + col;
          if (p.k % 4 == 0) {
            atomicAdd(reinterpret_cast<float4*>(y),
                      make_float4(a[0], a[1], a[2], a[3]));
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (col + c < p.k) atomicAdd(y + c, a[c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    };
    // this thread's row's 8 slots of the next slab, loaded a slab ahead
    // (streamed: each plane byte is read once a pass)
    float v_n[rl::kSub];
    int c_n[rl::kSub];
    auto load_slab = [&](long long s) {
      const long long pb = s * rl::kSlab + l;
#pragma unroll
      for (int u = 0; u < rl::kSub; ++u) {
        const long long at = pb + u * rl::kLanes;
        v_n[u] = VBF16 ? __uint_as_float(
                             (unsigned)__ldcs(static_cast<const unsigned short*>(
                                                  p.vals) + at)
                             << 16)
                       : __ldcs(static_cast<const float*>(p.vals) + at);
        c_n[u] = __ldcs(p.s_idx + at);
      }
    };
    if (i0 < i1) load_slab(__ldg(&items[i0].x));
    for (int it = i0; it < i1; ++it) {
      const int4 item = __ldg(items + it);  // slab, tile, window, 0
      if (item.y != cur) {
        flush();
        cur = item.y;
      }
      float v_s[rl::kSub];
      int c_s[rl::kSub];
#pragma unroll
      for (int u = 0; u < rl::kSub; ++u) {
        v_s[u] = v_n[u];
        c_s[u] = c_n[u];
      }
      if (it + 1 < i1) load_slab(__ldg(&items[it + 1].x));
      // this row's slots that add something, appended to its list
      int n = 0;
#pragma unroll
      for (int u = 0; u < rl::kSub; ++u) {
        const int cw = u * rl::kLanes + (c_s[u] & 127);  // in the window
        if (v_s[u] != 0.f && r0 + cw < p.cols) {
          mine[n] = Entry{v_s[u], cw * KP};
          ++n;
        }
      }
      __syncwarp();
      // the warp's rows G at a time: the C lanes of row group g read 4
      // columns each of every entry's staged row
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int r = i * G + g;
        const int nr = __shfl_sync(kAll, n, r);
        const int nmax = __reduce_max_sync(kAll, nr);
        const Entry* row = list + r * kRowList;
        for (int e = 0; e < nmax; ++e) {
          if (e < nr) {
            const Entry en = row[e];
            const float4 x = lds4(xs + en.off + cq);
            acc[i][0] = fmaf(en.v, x.x, acc[i][0]);
            acc[i][1] = fmaf(en.v, x.y, acc[i][1]);
            acc[i][2] = fmaf(en.v, x.z, acc[i][2]);
            acc[i][3] = fmaf(en.v, x.w, acc[i][3]);
          }
        }
      }
      __syncwarp();  // the lists are read before the next slab's
    }
    flush();
  }
}

template <int KP, bool VBF16, bool XBF16>
cudaError_t launch_window(const MmPack& p, const int4* items,
                          const int* part_ptr, int n_blocks, const void* X,
                          float* Y, cudaStream_t st) {
  using XT = typename XStage<XBF16>::T;
  const size_t smem = (size_t)rl::kWindow * KP * sizeof(XT) +
                      (size_t)kTeams * kTeamWarps * kWarp * kRowList *
                          sizeof(Entry);
  auto kern = window_walk<KP, VBF16, XBF16>;
  static thread_local bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  kern<<<(unsigned)n_blocks, kWinThreads, smem, st>>>(p, items, part_ptr, X,
                                                      Y);
  return cudaGetLastError();
}

template <bool VBF16, bool XBF16>
cudaError_t window_panel(int kp, const MmPack& p, const int4* items,
                         const int* part_ptr, int n_blocks, const void* X,
                         float* Y, cudaStream_t st) {
  switch (kp) {
    case 8: return launch_window<8, VBF16, XBF16>(p, items, part_ptr,
                                                  n_blocks, X, Y, st);
    case 16: return launch_window<16, VBF16, XBF16>(p, items, part_ptr,
                                                    n_blocks, X, Y, st);
    case 32: return launch_window<32, VBF16, XBF16>(p, items, part_ptr,
                                                    n_blocks, X, Y, st);
    default: return cudaErrorInvalidValue;
  }
}

MmPack make_pack(const void* s_idx, const void* vals, const void* group_tile,
                 const void* slab_win, int rows, int cols, int k,
                 long long n_slabs, int group) {
  return MmPack{static_cast<const uint8_t*>(s_idx),
                vals,
                static_cast<const int32_t*>(group_tile),
                static_cast<const int32_t*>(slab_win),
                n_slabs, rows, cols, k, group};
}

}  // namespace

// The gather walk.  X (cols, k) row-major fp32 or bf16; Y (rows, k)
// row-major fp32, zeroed by the caller; parts 0 (the product) or an
// ablation 1-3 (header).  Returns the cudaError_t of the launch.
extern "C" int spmm_rowlane(const void* s_idx, const void* vals,
                            const void* group_tile, const void* slab_win,
                            const void* X, void* Y, int rows, int cols, int k,
                            long long n_slabs, int group, int vals_bf16,
                            int x_bf16, int parts, void* stream) {
  if (group <= 0 || n_slabs <= 0 || k <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const MmPack p = make_pack(s_idx, vals, group_tile, slab_win, rows, cols,
                             k, n_slabs, group);
  float* y = static_cast<float*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return (int)(x_bf16 ? gather_parts<true, true>(parts, p, X, y, st)
                        : gather_parts<true, false>(parts, p, X, y, st));
  return (int)(x_bf16 ? gather_parts<false, true>(parts, p, X, y, st)
                      : gather_parts<false, false>(parts, p, X, y, st));
}

// The window walk: items and part_ptr of kernels/spmm_rowlane.py
// rowlane_mm_walk, n_blocks blocks; kp the columns a pass (8, 16 or 32);
// X 16-byte aligned; the rest as spmm_rowlane.
extern "C" int spmm_rowlane_window(const void* s_idx, const void* vals,
                                   const void* items, const void* part_ptr,
                                   int n_blocks, const void* X, void* Y,
                                   int rows, int cols, int k, int kp,
                                   int vals_bf16, int x_bf16, void* stream) {
  if (n_blocks <= 0 || k <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const MmPack p = make_pack(s_idx, vals, nullptr, nullptr, rows, cols, k,
                             0, 1);
  const auto it = static_cast<const int4*>(items);
  const auto pp = static_cast<const int*>(part_ptr);
  float* y = static_cast<float*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return (int)(x_bf16
                     ? window_panel<true, true>(kp, p, it, pp, n_blocks, X, y,
                                                st)
                     : window_panel<true, false>(kp, p, it, pp, n_blocks, X,
                                                 y, st));
  return (int)(x_bf16 ? window_panel<false, true>(kp, p, it, pp, n_blocks, X,
                                                  y, st)
                      : window_panel<false, false>(kp, p, it, pp, n_blocks,
                                                   X, y, st));
}
