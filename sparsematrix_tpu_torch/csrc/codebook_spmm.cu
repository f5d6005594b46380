// codebook_spmm.cu — fused codebook dequantize + product for sm_90a.
//
// Replaces: sparsematrix_tpu/kernels/codebook_pallas.py, _cb_kernel behind
// _cb_call / codebook_matmul (the pallas_call at :141).
//
// Computes out(n, m) = table[idx](n, k) @ X(k, m): idx is the uint8 index
// plane of a CodebookDense, table holds at most 256 fp32 values (the
// sentinel slot table[table_size] = 0 included; slots past the table read
// 0, so any byte is safe), X is fp32 or bf16 and out has X's type.  The
// reference's AddMatMat (117 x 1023 x 2047) reaches it as
// spmm(b_t, a.T).T, so X is the k-major view a.T: the kernel reads either
// layout through its stride and never copies X.
//
// What bounds it: at the reference shape the index plane is 2.1 MB and X
// 0.96 MB (about 1 us of HBM traffic at 3.35 TB/s); the 25 % of the plane
// that is nonzero needs 0.12 GFLOP (1.8 us at the 67 TFLOP/s non-tensor
// fp32 rate), and this kernel multiplies the whole plane, zeros included
// (0.49 GFLOP, 7.3 us).  TF32 tensor cores are ruled out because the
// reference computes fp32 at Precision.HIGHEST.  As written, the inner
// loop issues two 128-bit shared loads per 16 FMAs and the grid holds one
// block of 8 warps per SM, so shared-memory bandwidth and latency, not
// the FMA rate, set its time (PERF.md has the card's numbers).
//
// Design: the 1 KB table sits in shared memory, so dequantizing costs one
// shared load per element and the dense B plane never exists in device
// memory (the plain version writes all of it, 8.4 MB at the reference
// shape).  One block of 256 threads owns a 32 x 32 output tile (grid
// 32 x 4 = 128 blocks at the reference shape, about one per SM); the k
// loop runs in steps of 64 with four thread groups splitting each step
// (gather_gemm.cuh).  Ragged edges (n = 1023, k = 2047, m = 117) are masked
// in the kernel; nothing is padded in device memory.
#include "gather_gemm.cuh"

namespace {

constexpr int TR = 32, TC = 32, RT = 4, CT = 4, KG = 4, KC = 64;
using L = gg::Layout<TR, TC, RT, CT, KG, KC>;
static_assert(L::NT == 256, "one thread per table slot");

template <typename TX, bool KMAJOR>
__global__ void __launch_bounds__(L::NT)
codebook_spmm_kernel(const uint8_t* __restrict__ idx, const float* __restrict__ table,
                     int table_len, const TX* __restrict__ X, long long ldx,
                     TX* __restrict__ out, int n, int k, int m) {
  __shared__ float tab[256];
  __shared__ __align__(16) float smem[L::SMEM];
  float* As = smem;                 // [KC][TRP] dequantized index tile
  float* Xs = smem + KC * L::TRP;   // [KC][TC] X tile, swizzled

  const int tid = threadIdx.x;
  const L lay(tid);
  const int n0 = blockIdx.x * TR;
  const int m0 = blockIdx.y * TC;
  tab[tid] = tid < table_len ? table[tid] : 0.f;

  int ia[L::PER_A];  // raw indices of the next step; -1 outside the matrix
  gg::XStage<TX, KMAJOR, KC, TC, L::NT> xs;
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < L::PER_A; ++j) {
      int kk, r;
      L::a_coords(tid + j * L::NT, kk, r);
      const int row = n0 + r, col = k0 + kk;
      ia[j] = (row < n && col < k) ? (int)idx[(long long)row * k + col] : -1;
    }
    xs.load(X, ldx, k0, k, m0, m, tid);
  };

  float acc[RT][CT] = {};
  load(0);
  for (int k0 = 0; k0 < k; k0 += KC) {
    __syncthreads();  // the table is written / the last step's reads are done
#pragma unroll
    for (int j = 0; j < L::PER_A; ++j) {
      int kk, r;
      L::a_coords(tid + j * L::NT, kk, r);
      As[L::a_slot(kk, r)] = ia[j] >= 0 ? tab[ia[j]] : 0.f;
    }
    xs.store(Xs, tid);
    __syncthreads();
    if (k0 + KC < k) load(k0 + KC);
    lay.fma_step(As, Xs, acc);
  }
  __syncthreads();
  lay.reduce_store(smem, acc, tid, out, m, n0, n, m0, m);
}

template <typename TX, bool KMAJOR>
cudaError_t launch(const uint8_t* idx, const float* table, int table_len,
                   const void* X, long long ldx, void* out, int n, int k, int m,
                   cudaStream_t stream) {
  const dim3 grid((n + TR - 1) / TR, (m + TC - 1) / TC);
  codebook_spmm_kernel<TX, KMAJOR><<<grid, L::NT, 0, stream>>>(
      idx, table, table_len, static_cast<const TX*>(X), ldx,
      static_cast<TX*>(out), n, k, m);
  return cudaGetLastError();
}

}  // namespace

// out (n, m), row-major, X's type.  X(r, c) = X[r * ldx + c], or
// X[r + c * ldx] when x_kmajor.  x_bf16 selects bf16 X and out, else fp32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int codebook_spmm(const void* idx, const void* table, int table_len,
                             const void* X, long long ldx, int x_kmajor,
                             int x_bf16, void* out, int n, int k, int m,
                             void* stream) {
  if (table_len < 1 || table_len > 256 || n <= 0 || m <= 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  const auto* i8 = static_cast<const uint8_t*>(idx);
  const auto* t = static_cast<const float*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = x_kmajor ? launch<__nv_bfloat16, true>(i8, t, table_len, X, ldx, out, n, k, m, s)
                   : launch<__nv_bfloat16, false>(i8, t, table_len, X, ldx, out, n, k, m, s);
  else
    err = x_kmajor ? launch<float, true>(i8, t, table_len, X, ldx, out, n, k, m, s)
                   : launch<float, false>(i8, t, table_len, X, ldx, out, n, k, m, s);
  return (int)err;
}
