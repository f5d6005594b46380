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
// written once; at k = 32 the X rows gathered from L2 (a 128-byte line a
// stored entry) are most of the traffic.  As written it is held by the
// work a slot of the padded planes costs, not by X: its time hardly
// changes from k = 8 to k = 32 on the card.
//
// Design: a warp owns 32 lanes (rows) of a tile and covers the columns in
// chunks of 32, thread t holding column j0 + t of all 32 rows in a private
// column of a shared-memory panel (32 × 32 fp32 a warp, no bank
// conflicts, no synchronization).  A block of 4 warps covers the 128
// lanes and walks spb contiguous slabs.  Per slab the warp loads its
// slots' values and s_idx once, coalesced (one slab ahead, so that the
// loads wait behind the previous slab's work), and a ballot a sublane
// keeps the slots whose value is nonzero (the packs are about 3/4 padding
// at the XL CSR), compacted into a shared-memory list with their column
// and row.  The warp then walks the list and reads each kept slot's X row
// as one coalesced line (32 fp32 columns, 128 bytes), in place, row-major,
// 8 lines in flight at once.  So the planes are streamed once for all k
// columns, not once a column as on the TPU, and every X row read is one
// line (a thread a lane, reading its own X row, would send each warp load
// to 32 rows: bound by the L1's request rate).  Columns past k and rows
// past cols are masked; X is never padded.  A slot whose value is 0 reads
// no X row: padding and stored zeros add exactly 0, where the TPU kernel
// multiplies them in (an inf or NaN of X under a zero value gives NaN
// there, 0 here).  The panel keeps the sums while the slabs' tile is the
// same (slabs are tile-major) and is added into the zeroed Y with
// atomicAdd, coalesced, when the tile changes and at the end of the run.
// Atomics rather than one block a tile: a tile's run can be hundreds of
// slabs (the XL CSR: ~256 a tile) and a small matrix has few tiles
// (n = 2048: 16), so one block a tile would leave most of the 132 SMs
// idle.  The fp32 summation order varies from run to run.  A tile that no
// group touches keeps its zeros (the TPU kernel's "touched" mask).  One
// launch covers every group: the TPU's chunking by its prefetch budget is
// not needed.
#include <cstdint>
#include <cuda_runtime.h>

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

template <bool VBF16, bool XBF16>
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
        flush();
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
      // the warp reads each kept slot's X row as one line, kBatch lines
      // in flight before the first is added
      for (int i0 = 0; i0 < n; i0 += kBatch) {
        float x_b[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          x_b[i] = (i0 + i < n && live)
                       ? common::load_val<XBF16>(
                             X, (long long)lc[i0 + i] * p.k + j0 + t)
                       : 0.f;
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (i0 + i < n) {
            float* a = acc + lr[i0 + i] * kWarp + t;
            *a = fmaf(lv[i0 + i], x_b[i], *a);
          }
      }
      __syncwarp();
    }
    flush();
  }
}

template <bool VBF16, bool XBF16>
cudaError_t launch(const MmPack& p, const void* X, float* Y,
                   cudaStream_t st) {
  const int spb = rl::slabs_per_block(p.n_slabs);
  const unsigned blocks = (unsigned)((p.n_slabs + spb - 1) / spb);
  spmm_walk<VBF16, XBF16><<<blocks, rl::kLanes, 0, st>>>(p, X, Y, spb);
  return cudaGetLastError();
}

}  // namespace

// X (cols, k) row-major fp32 or bf16; Y (rows, k) row-major fp32, zeroed
// by the caller.  Returns the cudaError_t of the launch.
extern "C" int spmm_rowlane(const void* s_idx, const void* vals,
                            const void* group_tile, const void* slab_win,
                            const void* X, void* Y, int rows, int cols, int k,
                            long long n_slabs, int group, int vals_bf16,
                            int x_bf16, void* stream) {
  if (group <= 0 || n_slabs <= 0 || k <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const MmPack p{static_cast<const uint8_t*>(s_idx),
                 vals,
                 static_cast<const int32_t*>(group_tile),
                 static_cast<const int32_t*>(slab_win),
                 n_slabs, rows, cols, k, group};
  float* y = static_cast<float*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return (int)(x_bf16 ? launch<true, true>(p, X, y, st)
                        : launch<true, false>(p, X, y, st));
  return (int)(x_bf16 ? launch<false, true>(p, X, y, st)
                      : launch<false, false>(p, X, y, st));
}
