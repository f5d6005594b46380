// Dual-gather SpMM, Y = A @ X over a dual-gather pack, X (cols, k) and Y
// (rows, k) row-major fp32.
//
// Replaces two Pallas kernels of sparsematrix_tpu/kernels/spmm_dualgather.py:
//   * _dg_mm_kernel (pallas_call at :247): a k_tiles = 1 pack walked per
//     right-hand-side column;
//   * _dg_sb_mm_kernel (pallas_call at :127): the same over a superblock
//     pack (slab_tloc, nibble and two-window idxA), in panels of columns.
// Both are instantiations of dg_spmm below (SB = false / true); the
// launch counters name them spmm_dualgather and spmm_dualgather_sb.
//
// What bounds it: at k = 32 the slab planes (~6 bytes a slot) are read
// once per 32 columns, so the bytes that must move are those of X and Y;
// the walk itself re-reads one X row (k floats, contiguous) per slot from
// L2, and that gather traffic is what the kernel spends its time on.
//
// Design: a block of 4 warps walks spb contiguous slabs
// (dg::slabs_per_block: 16 on a large pack, down to 1 on a small one);
// warp w owns the row lanes 32w..32w+31, and its lane j the right-hand-side
// column j0 + j of the current 32-column panel.  Per slab and sublane
// each thread decodes the slot of its own row lane (coalesced vals/idxB
// loads, one idxA gather), then the warp walks its 32 slots: value and
// column come by shuffle, and the 32 lanes read the slot's X row as one
// coalesced 128-byte run and add it into 32 register accumulators (one
// per row lane).  Accumulation into Y: atomicAdd of the 32 x 32 register
// block when the slabs' tile changes and at the end of the block's run,
// into a Y the wrapper zeroes (as in spmv_dualgather.cu), so the result
// does not depend on where groups, blocks or panels end.  Rows >= rows
// are dropped; columns past cols read 0.
#include "dualgather.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <bool BF16, bool SB, bool NIBBLE, bool TWO_WIN>
__global__ void __launch_bounds__(dg::kThreads)
    dg_spmm(dg::Pack p, const float* __restrict__ X, float* __restrict__ Y,
            int k, int spb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = warp * 32 + lane;  // the row lane this thread decodes
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, p.n_slabs);
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool jok = j < k;
    float acc[32];  // acc[i]: row lane 32 * warp + i, column j
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    long long cur = -1;
    auto flush = [&]() {
      if (cur < 0 || !jok) return;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long row = cur * dg::kLanes + warp * 32 + i;
        if (row < p.rows) atomicAdd(Y + row * k + j, acc[i]);
      }
    };
    for (long long s = s0; s < s1; ++s) {
      const long long tile = dg::slab_tile<SB>(p, s);
      if (tile != cur) {
        flush();
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        cur = tile;
      }
      const int w = __ldg(p.slab_win + s);
      const long long pb = s * dg::kSlab;
#pragma unroll 2
      for (int u = 0; u < dg::kSub; ++u) {
        const long long at = pb + u * dg::kLanes + l;
        const int cl = __ldg(p.idxB + at) & 127;
        const float v = dg::load_val<BF16>(p.vals, at);
        const int col = (int)dg::slot_col<NIBBLE, TWO_WIN>(p, s, w, u, cl);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float vi = __shfl_sync(kFull, v, i);
          const int ci = __shfl_sync(kFull, col, i);
          const float xv =
              (ci >= 0 && jok) ? __ldg(X + (long long)ci * k + j) : 0.f;
          acc[i] = fmaf(vi, xv, acc[i]);
        }
      }
    }
    flush();
  }
}

template <bool BF16, bool SB, bool NIBBLE, bool TWO_WIN>
struct Spmm {
  static cudaError_t run(dg::Pack p, const float* X, float* Y, int k,
                         cudaStream_t st) {
    const int spb = dg::slabs_per_block(p.n_slabs);
    dg_spmm<BF16, SB, NIBBLE, TWO_WIN>
        <<<dg::n_blocks(p.n_slabs, spb), dg::kThreads, 0, st>>>(p, X, Y, k,
                                                               spb);
    return cudaGetLastError();
  }
};

}  // namespace

// Y (rows, k) is zeroed by the caller.  Returns the cudaError_t of the
// launch.
extern "C" int spmm_dualgather(const void* idxA, const void* idxB,
                               const void* vals, const void* group_tile,
                               const void* slab_win, const void* slab_tloc,
                               const void* X, void* Y, int rows, int cols,
                               int k, long long n_slabs, int group,
                               int k_tiles, int nibble, int two_win, int bf16,
                               void* stream) {
  const bool sb = k_tiles > 1;
  if (k <= 0 || group <= 0 || n_slabs <= 0 || (sb && !slab_tloc))
    return (int)cudaErrorInvalidValue;
  const dg::Pack p{static_cast<const uint8_t*>(idxA),
                   static_cast<const uint8_t*>(idxB),
                   vals,
                   static_cast<const int32_t*>(group_tile),
                   static_cast<const int32_t*>(slab_win),
                   static_cast<const int32_t*>(slab_tloc),
                   n_slabs, rows, cols, group, k_tiles};
  return (int)dg::dispatch<Spmm>(bf16 != 0, sb, nibble != 0, two_win != 0, p,
                                 static_cast<const float*>(X),
                                 static_cast<float*>(Y), k,
                                 static_cast<cudaStream_t>(stream));
}
