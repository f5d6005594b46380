// spmm_bsr.cu — BSR times dense for sm_90a: the grouped and the panel
// kernel.
//
// Replaces: sparsematrix_tpu/kernels/bsr_pallas.py, _bsr_kernel behind
// _spmm_bsr_call (the pallas_call at :62; exported here as spmm_bsr) and
// _bsr_panel_kernel behind _spmm_bsr_panel_call (the pallas_call at :159;
// exported as spmm_bsr_panel).  Both serve spmm_bsr.
//
// Computes Y(nrows, nrhs) = A @ X for a BSR A of (bm x bn) blocks and a
// row-major X (ncols, nrhs), both fp32 or both bf16, with fp32 sums; Y has
// X's type.  Block-row i of Y is the product of block-row i's stored blocks
// laid side by side, a (bm x nb*bn) matrix, with the nb X row-blocks they
// name stacked, a (nb*bn x nrhs) matrix:
//   grouped: the blocks indptr[i] .. indptr[i+1] of data (cap, bm, bn),
//            X row-block indices[s] for block s.  An empty block-row walks
//            nothing and writes zeros; capacity padding slots (past
//            indptr[nbr]) are never visited.
//   panel:   panels (nbr, bm, M*bn) are those matrices already side by
//            side (pack_bsr_panels), X row-block bcols[i, m] for slot m.
//            Padding slots are zero panel columns at block-column 0 and
//            add exactly 0.
// X rows at or past ncols read as 0 (the JAX wrapper pads X to nbc * bn
// rows on every call; these kernels mask instead), and the ragged last
// block-row writes only rows below nrows.
//
// What bounds them: 2 * num_blocks * bm * bn * nrhs fp32 operations
// against num_blocks * (bm * bn * value bytes + 4) bytes of blocks, the X
// rows the stored blocks name (read once) and Y written once.  At the
// bench's (8, 8) blocks and nrhs = 128 the intensity is nrhs / 2 = 64
// operations a block byte, above the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the FMA rate bounds them; TF32 tensor cores are ruled
// out because the reference computes fp32 at Precision.HIGHEST.  As
// written, a block-row's output tile re-reads from L2 the X rows its blocks
// name, once for each block-row that names them (up to ~55 times at the XL
// shape), and the inner loop issues a 64- and a 128-bit shared load per 8
// FMAs: L2 and shared-memory traffic, not the FMA rate, set their time.
//
// Design: the Blocked-ELL skeleton (gather_gemm.cuh).  One block of threads
// per (row tile of a block-row, column tile of Y) walks the contraction
// q = slot * bn + c of its block-row in KC = 64 steps, so that 8 blocks of
// an (8, 8) BSR fill one step (a step per block would leave 7/8 of it
// zero), stages the (KC x TR) A chunk and the KC gathered X rows in shared
// memory, and accumulates an (RT x 4) register tile with fp32 FMA.  The
// division q / bn and the block-column lookup happen once a step and
// column q, in a shared table, not once an element.  It
// writes its tile once, with no atomics, so the result is deterministic.
// Block-rows of at least 32 rows take 32 x 32 tiles, of at least 8 rows
// 8 x 64 tiles, smaller ones 4 x 64 tiles, so no thread computes rows the
// block does not have.
#include "gather_gemm.cuh"

namespace {

constexpr int KG = 4, KC = 64, CT = 4;

template <typename T, bool PANEL, int TR, int TC, int RT>
__global__ void __launch_bounds__(gg::Layout<TR, TC, RT, CT, KG, KC>::NT)
bsr_kernel(const int* __restrict__ rows_or_cols, const int* __restrict__ indices,
           const T* __restrict__ A, const T* __restrict__ X, T* __restrict__ out,
           int nrows, int ncols, int M, int bm, int bn, int nrhs, int row_tiles) {
  using L = gg::Layout<TR, TC, RT, CT, KG, KC>;
  constexpr int PX = KC * TC / L::NT;
  static_assert(PX >= 1 && (KC * TC) % L::NT == 0, "X tile");
  __shared__ __align__(16) float smem[L::SMEM];
  float* As = smem;                // [KC][TRP] A chunk, transposed
  float* Xs = smem + KC * L::TRP;  // [KC][TC] gathered X rows, swizzled

  const int tid = threadIdx.x;
  const L lay(tid);
  const int i = blockIdx.x / row_tiles;          // block-row
  const int r0 = (blockIdx.x % row_tiles) * TR;  // row tile inside it
  const int c0 = blockIdx.y * TC;

  // A(r, q) = a[slot * slot_stride + r * row_stride + c] for q = slot*bn + c;
  // the X row-block of slot is idx[slot]
  int nslots;
  const T* a;
  long long slot_stride, row_stride;
  const int* idx;
  if constexpr (PANEL) {
    nslots = M;
    a = A + (long long)i * bm * M * bn;
    slot_stride = bn;
    row_stride = (long long)M * bn;
    idx = rows_or_cols + (long long)i * M;
  } else {
    const int s0 = rows_or_cols[i];
    nslots = rows_or_cols[i + 1] - s0;
    a = A + (long long)s0 * bm * bn;
    slot_stride = (long long)bm * bn;
    row_stride = bn;
    idx = indices + s0;
  }
  const int len = nslots * bn;
  const int steps = (len + KC - 1) / KC;

  // Per step, the first KC threads resolve its contraction indices once:
  // the offset of column q in a and the X row it multiplies (-1: past the
  // block-row's blocks or past ncols).  Two buffers, so that step s + 1's
  // table is written while step s's loads may still read theirs.
  __shared__ long long aoff_s[2][KC], xrow_s[2][KC];
  auto resolve = [&](int s) {
    if (tid < KC) {
      const int q = s * KC + tid;
      long long ao = -1, xr = -1;
      if (q < len) {
        const int slot = q / bn, c = q - slot * bn;
        ao = slot * slot_stride + c;
        xr = (long long)idx[slot] * bn + c;
        if (xr >= ncols) xr = -1;
      }
      aoff_s[s & 1][tid] = ao;
      xrow_s[s & 1][tid] = xr;
    }
  };

  float av[L::PER_A];
  float xv[PX];
  auto load = [&](int s) {
    const long long* aoff = aoff_s[s & 1];
    const long long* xrow = xrow_s[s & 1];
#pragma unroll
    for (int j = 0; j < L::PER_A; ++j) {
      int kk, r;
      L::a_coords(tid + j * L::NT, kk, r);
      const int row = r0 + r;
      const long long ao = aoff[kk];
      av[j] = (row < bm && ao >= 0) ? gg::to_f32(a[ao + row * row_stride]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int e = tid + j * L::NT;
      const int kk = e / TC, c = e % TC;
      const int col = c0 + c;
      const long long xr = xrow[kk];
      xv[j] = (xr >= 0 && col < nrhs) ? gg::to_f32(X[xr * nrhs + col]) : 0.f;
    }
  };

  float acc[RT][CT] = {};
  if (steps > 0) {
    resolve(0);
    __syncthreads();
    load(0);
  }
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // the last step's reads are done
#pragma unroll
    for (int j = 0; j < L::PER_A; ++j) {
      int kk, r;
      L::a_coords(tid + j * L::NT, kk, r);
      As[L::a_slot(kk, r)] = av[j];
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int e = tid + j * L::NT;
      const int kk = e / TC, c = e % TC;
      Xs[kk * TC + gg::swz(kk, c)] = xv[j];
    }
    if (s + 1 < steps) resolve(s + 1);
    __syncthreads();
    if (s + 1 < steps) load(s + 1);
    lay.fma_step(As, Xs, acc);
  }
  __syncthreads();
  const long long row0 = (long long)i * bm + r0;
  const long long rend_blk = (long long)i * bm + bm;
  const long long row_end = rend_blk < nrows ? rend_blk : (long long)nrows;
  lay.reduce_store(smem, acc, tid, out, nrhs, row0, row_end, c0, nrhs);
}

template <typename T, bool PANEL, int TR, int TC, int RT>
cudaError_t launch(const int* rows_or_cols, const int* indices, const void* A,
                   const void* X, void* out, int nrows, int ncols, int nbr,
                   int M, int bm, int bn, int nrhs, cudaStream_t stream) {
  using L = gg::Layout<TR, TC, RT, CT, KG, KC>;
  const int row_tiles = (bm + TR - 1) / TR;
  const dim3 grid((unsigned)nbr * row_tiles, (nrhs + TC - 1) / TC);
  bsr_kernel<T, PANEL, TR, TC, RT><<<grid, L::NT, 0, stream>>>(
      rows_or_cols, indices, static_cast<const T*>(A), static_cast<const T*>(X),
      static_cast<T*>(out), nrows, ncols, M, bm, bn, nrhs, row_tiles);
  return cudaGetLastError();
}

template <typename T, bool PANEL>
cudaError_t dispatch_tile(const int* rc, const int* ind, const void* A,
                          const void* X, void* out, int nrows, int ncols,
                          int nbr, int M, int bm, int bn, int nrhs,
                          cudaStream_t s) {
  if (bm >= 32)
    return launch<T, PANEL, 32, 32, 4>(rc, ind, A, X, out, nrows, ncols, nbr,
                                       M, bm, bn, nrhs, s);
  if (bm > 4)
    return launch<T, PANEL, 8, 64, 2>(rc, ind, A, X, out, nrows, ncols, nbr, M,
                                      bm, bn, nrhs, s);
  return launch<T, PANEL, 4, 64, 2>(rc, ind, A, X, out, nrows, ncols, nbr, M,
                                    bm, bn, nrhs, s);
}

template <bool PANEL>
int run(const void* rows_or_cols, const void* indices, const void* A,
        const void* X, int bf16, void* out, int nrows, int ncols, int nbr,
        int M, int bm, int bn, int nrhs, void* stream) {
  if (nrows <= 0 || nrhs <= 0 || nbr <= 0 || M < 0 || bm <= 0 || bn <= 0 ||
      (long long)nbr * bm < nrows || (nrhs + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* rc = static_cast<const int*>(rows_or_cols);
  const auto* ind = static_cast<const int*>(indices);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch_tile<__nv_bfloat16, PANEL>(rc, ind, A, X, out, nrows,
                                                    ncols, nbr, M, bm, bn, nrhs, s);
  return (int)dispatch_tile<float, PANEL>(rc, ind, A, X, out, nrows, ncols, nbr,
                                          M, bm, bn, nrhs, s);
}

}  // namespace

// The grouped kernel (row 3).  indptr (nbr + 1) and indices (cap) int32,
// data (cap, bm, bn), X (ncols, nrhs) row-major, out (nrows, nrhs)
// row-major in X's type; bf16 selects bf16 data, X and out, else fp32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int spmm_bsr(const void* indptr, const void* indices,
                        const void* data, const void* X, int bf16, void* out,
                        int nrows, int ncols, int nbr, int bm, int bn, int nrhs,
                        void* stream) {
  return run<false>(indptr, indices, data, X, bf16, out, nrows, ncols, nbr, 0,
                    bm, bn, nrhs, stream);
}

// The panel kernel (row 4).  bcols (nbr, M) int32, panels (nbr, bm, M*bn),
// the rest as above.
extern "C" int spmm_bsr_panel(const void* bcols, const void* panels,
                              const void* X, int bf16, void* out, int nrows,
                              int ncols, int nbr, int M, int bm, int bn,
                              int nrhs, void* stream) {
  return run<true>(bcols, nullptr, panels, X, bf16, out, nrows, ncols, nbr, M,
                   bm, bn, nrhs, stream);
}
