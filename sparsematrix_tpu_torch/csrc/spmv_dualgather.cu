// Dual-gather SpMV, y = A @ x over a dual-gather pack.
//
// Replaces two Pallas kernels of sparsematrix_tpu/kernels/spmv_dualgather.py:
//   * _dualgather_kernel (pallas_call at :876, k_tiles = 1): per-tile
//     groups of slabs over 1024-column windows;
//   * _dualgather_sb_kernel (pallas_call at :1017, k_tiles > 1): groups
//     span a superblock of k_tiles tiles (slab_tloc), with the nibble and
//     two-window idxA forms.
// Both are instantiations of dg_spmv below (SB = false / true); the
// launch counters name them spmv_dualgather and spmv_dualgather_sb.
//
// What bounds it: bytes.  Each slot reads 4 (fp32) or 2 (bf16) bytes of
// value, one byte of idxB and one of idxA (half a byte when nibbled) and
// does one FMA; x (4 bytes a column) is gathered from L1/L2.  At a fill
// of ~0.6 the slab planes are ~9.5 bytes per nonzero against CSR's 8.
//
// Design: one thread per row lane l (128 threads), a block walks spb
// contiguous slabs (dg::slabs_per_block: 16 on a large pack, down to 1
// on a small one).  Per slab the thread decodes its 8 sublanes
// (unrolled, so the 8 independent idxB/vals -> idxA -> x load chains
// overlap), adds sum_u vals * x[col] to a register, and keeps summing
// while the slabs' tile stays the same (slabs are tile-major).
// Accumulation into y: atomicAdd of the register when the tile changes
// and at the end of the block's run, into a y the wrapper zeroes.  That
// replaces the TPU's sequential revisits of one output block and its
// "touched" mask, covers all groups in one launch whatever the JAX
// pack's call splits, and makes the result independent of where groups
// or blocks end (only the fp32 summation order varies, from run to run).
// Rows >= rows (padding tiles, the ragged last tile) are dropped; columns
// past cols read 0.
#include "dualgather.cuh"

namespace {

template <bool BF16, bool SB, bool NIBBLE, bool TWO_WIN>
__global__ void __launch_bounds__(dg::kThreads)
    dg_spmv(dg::Pack p, const float* __restrict__ x, float* __restrict__ y,
            int spb) {
  const int l = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, p.n_slabs);
  long long cur = -1;
  float acc = 0.f;
  auto flush = [&]() {
    const long long row = cur * dg::kLanes + l;
    if (cur >= 0 && row < p.rows) atomicAdd(y + row, acc);
  };
  for (long long s = s0; s < s1; ++s) {
    const long long tile = dg::slab_tile<SB>(p, s);
    if (tile != cur) {
      flush();
      acc = 0.f;
      cur = tile;
    }
    const int w = __ldg(p.slab_win + s);
    const long long pb = s * dg::kSlab;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < dg::kSub; ++u) {
      const long long at = pb + u * dg::kLanes + l;
      const int cl = __ldg(p.idxB + at) & 127;
      const float v = dg::load_val<BF16>(p.vals, at);
      const long long col = dg::slot_col<NIBBLE, TWO_WIN>(p, s, w, u, cl);
      part = fmaf(v, col >= 0 ? __ldg(x + col) : 0.f, part);
    }
    acc += part;
  }
  flush();
}

template <bool BF16, bool SB, bool NIBBLE, bool TWO_WIN>
struct Spmv {
  static cudaError_t run(dg::Pack p, const float* x, float* y,
                         cudaStream_t st) {
    const int spb = dg::slabs_per_block(p.n_slabs);
    dg_spmv<BF16, SB, NIBBLE, TWO_WIN>
        <<<dg::n_blocks(p.n_slabs, spb), dg::kThreads, 0, st>>>(p, x, y,
                                                               spb);
    return cudaGetLastError();
  }
};

}  // namespace

// X is x (cols, 1) and Y is y (rows, 1), zeroed by the caller; k must be 1.
// Returns the cudaError_t of the launch.
extern "C" int spmv_dualgather(const void* idxA, const void* idxB,
                               const void* vals, const void* group_tile,
                               const void* slab_win, const void* slab_tloc,
                               const void* X, void* Y, int rows, int cols,
                               int k, long long n_slabs, int group,
                               int k_tiles, int nibble, int two_win, int bf16,
                               void* stream) {
  const bool sb = k_tiles > 1;
  if (k != 1 || group <= 0 || n_slabs <= 0 || (sb && !slab_tloc))
    return (int)cudaErrorInvalidValue;
  const dg::Pack p{static_cast<const uint8_t*>(idxA),
                   static_cast<const uint8_t*>(idxB),
                   vals,
                   static_cast<const int32_t*>(group_tile),
                   static_cast<const int32_t*>(slab_win),
                   static_cast<const int32_t*>(slab_tloc),
                   n_slabs, rows, cols, group, k_tiles};
  return (int)dg::dispatch<Spmv>(bf16 != 0, sb, nibble != 0, two_win != 0, p,
                                 static_cast<const float*>(X),
                                 static_cast<float*>(Y),
                                 static_cast<cudaStream_t>(stream));
}
