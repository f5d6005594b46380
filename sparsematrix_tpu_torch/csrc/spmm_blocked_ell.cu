// spmm_blocked_ell.cu — Blocked-ELL times dense for sm_90a.
//
// Replaces: sparsematrix_tpu/kernels/spmm_pallas.py, _bell_kernel behind
// _spmm_bell_call / spmm_blocked_ell (the pallas_call at :90).
//
// Computes Y(nrows, nrhs) with  Y[rowblock i] = sum_m blocks[i, m] @
// X[block_cols[i, m] * bk : + bk]  for blocks (nbr, M, bm, bk) and X
// (ncols, nrhs), both fp32 or both bf16; Y has X's type.  Padding slots are
// zero blocks at block-column 0 and contribute exactly 0 with no masking,
// as on the TPU.  X rows at or past ncols read as 0 (the JAX wrapper pads X
// to nbc * bk rows on every call; this kernel masks instead), and the
// ragged last block-row writes only rows below nrows.
//
// What bounds it: each stored block costs 2 * bm * bk * nrhs fp32
// operations against bm * bk * 4 bytes of block, an intensity of nrhs / 2
// operations per byte: above the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20) from nrhs = 40 on, which every shape of the bench
// (nrhs 117, 128, 512) exceeds.  TF32 tensor cores are ruled out because
// the reference computes fp32 at Precision.HIGHEST.  As written, an 8-row
// output tile re-reads its X rows for every block-row, and the inner loop
// issues a 64- and a 128-bit shared load per 8 FMAs, so at (8, 128)
// blocks shared-memory and L2 traffic, not the FMA rate, set its time.
//
// Design: one block of 256 threads per (row tile of a block-row, column
// tile of X); it walks the M slots, reads block_cols[i, m] itself and
// stages the block in KC = 64-column chunks with the matching X rows, so a
// (128, 128) fp32 block (64 KB) never has to sit whole in shared memory
// (static shared memory stays under 48 KB at every block shape).  Block
// rows of at least 32 use 32 x 32 output tiles (4 x 4 per thread); smaller
// ones, such as the (8, 128) layout, 8 x 64 tiles (2 x 4 per thread), so
// no thread computes rows that the block does not have.  The fp32 tile
// arithmetic is shared with the codebook kernel (gather_gemm.cuh).
#include "gather_gemm.cuh"

namespace {

constexpr int KG = 4, KC = 64, CT = 4;

template <typename T, bool KMAJOR, int TR, int TC, int RT>
__global__ void __launch_bounds__(gg::Layout<TR, TC, RT, CT, KG, KC>::NT)
bell_kernel(const int* __restrict__ block_cols, const T* __restrict__ blocks,
            const T* __restrict__ X, long long ldx, T* __restrict__ out,
            int nrows, int ncols, int M, int bm, int bk, int nrhs,
            int row_tiles) {
  using L = gg::Layout<TR, TC, RT, CT, KG, KC>;
  __shared__ __align__(16) float smem[L::SMEM];
  float* As = smem;                // [KC][TRP] block chunk, transposed
  float* Xs = smem + KC * L::TRP;  // [KC][TC] X rows, swizzled

  const int tid = threadIdx.x;
  const L lay(tid);
  const int i = blockIdx.x / row_tiles;             // block-row
  const int r0 = (blockIdx.x % row_tiles) * TR;     // row tile inside it
  const int c0 = blockIdx.y * TC;
  const int nkc = (bk + KC - 1) / KC;
  const int steps = M * nkc;

  float av[L::PER_A];
  gg::XStage<T, KMAJOR, KC, TC, L::NT> xs;
  auto load = [&](int s) {
    const int m = s / nkc, kc = (s % nkc) * KC;
    const long long slot = (long long)i * M + m;
    const long long bc = block_cols[slot];
    const T* blk = blocks + slot * bm * bk;
#pragma unroll
    for (int j = 0; j < L::PER_A; ++j) {
      int kk, r;
      L::a_coords(tid + j * L::NT, kk, r);
      const int row = r0 + r, col = kc + kk;
      av[j] = (row < bm && col < bk) ? gg::to_f32(blk[(long long)row * bk + col]) : 0.f;
    }
    const long long xrow = bc * bk;
    const long long xend = xrow + bk < ncols ? xrow + bk : (long long)ncols;
    xs.load(X, ldx, xrow + kc, xend, c0, nrhs, tid);
  };

  float acc[RT][CT] = {};
  if (steps > 0) load(0);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // the last step's reads are done
#pragma unroll
    for (int j = 0; j < L::PER_A; ++j) {
      int kk, r;
      L::a_coords(tid + j * L::NT, kk, r);
      As[L::a_slot(kk, r)] = av[j];
    }
    xs.store(Xs, tid);
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

template <typename T, bool KMAJOR, int TR, int TC, int RT>
cudaError_t launch(const int* block_cols, const void* blocks, const void* X,
                   long long ldx, void* out, int nrows, int ncols, int nbr,
                   int M, int bm, int bk, int nrhs, cudaStream_t stream) {
  using L = gg::Layout<TR, TC, RT, CT, KG, KC>;
  const int row_tiles = (bm + TR - 1) / TR;
  const dim3 grid((unsigned)nbr * row_tiles, (nrhs + TC - 1) / TC);
  bell_kernel<T, KMAJOR, TR, TC, RT><<<grid, L::NT, 0, stream>>>(
      block_cols, static_cast<const T*>(blocks), static_cast<const T*>(X), ldx,
      static_cast<T*>(out), nrows, ncols, M, bm, bk, nrhs, row_tiles);
  return cudaGetLastError();
}

template <typename T, bool KMAJOR>
cudaError_t dispatch_tile(const int* bc, const void* blocks, const void* X,
                          long long ldx, void* out, int nrows, int ncols,
                          int nbr, int M, int bm, int bk, int nrhs,
                          cudaStream_t s) {
  if (bm >= 32)
    return launch<T, KMAJOR, 32, 32, 4>(bc, blocks, X, ldx, out, nrows, ncols,
                                        nbr, M, bm, bk, nrhs, s);
  return launch<T, KMAJOR, 8, 64, 2>(bc, blocks, X, ldx, out, nrows, ncols,
                                     nbr, M, bm, bk, nrhs, s);
}

}  // namespace

// out (nrows, nrhs), row-major, X's type.  X(r, c) = X[r * ldx + c], or
// X[r + c * ldx] when x_kmajor.  bf16 selects bf16 blocks, X and out, else
// fp32.  Returns the launch's cudaError_t (0 on success).
extern "C" int spmm_blocked_ell(const void* block_cols, const void* blocks,
                                const void* X, long long ldx, int x_kmajor,
                                int bf16, void* out, int nrows, int ncols,
                                int nbr, int M, int bm, int bk, int nrhs,
                                void* stream) {
  if (nrows <= 0 || nrhs <= 0 || nbr <= 0 || M < 0 || bm <= 0 || bk <= 0 ||
      (long long)nbr * bm < nrows)
    return (int)cudaErrorInvalidValue;
  const auto* bc = static_cast<const int*>(block_cols);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = x_kmajor ? dispatch_tile<__nv_bfloat16, true>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, s)
                   : dispatch_tile<__nv_bfloat16, false>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, s);
  else
    err = x_kmajor ? dispatch_tile<float, true>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, s)
                   : dispatch_tile<float, false>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, s);
  return (int)err;
}
