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
// What bounds it: the FMAs.  At the reference shape the index plane is
// 2.1 MB and X 0.96 MB (about 1 us of HBM traffic at 3.35 TB/s); the
// kernel multiplies the whole plane, zeros included (0.49 GFLOP, 7.3 us
// at the 67 TFLOP/s non-tensor fp32 rate).  TF32 tensor cores are ruled
// out because the reference computes fp32 at Precision.HIGHEST.  The
// first version (32 x 32 tiles, 4 x 4 a thread, two 128-bit shared loads
// per 16 FMAs) was held back by its shared-memory loads, not the FMAs.
//
// Design:
//  * A block of 128 threads owns a 64 x 128 output tile; a thread an 8 x 8
//    register tile: rows ty*4 + {0..3} and 32 + ty*4 + {0..3}, columns
//    tx*4 + {0..3} and 64 + tx*4 + {0..3}, read as float4s from k-major
//    shared tiles, so a step of k is 64 FMAs per four 128-bit loads.
//  * Staging: each step of KC = 32 along k, the index rows and X come in
//    by cp.async 16-byte copies into a ring of three stages.  Rows of idx
//    and of X need not start on 16 bytes (k = 2047), so a row's copy is the
//    16-byte-aligned window that covers it, and a conversion pass reads it
//    with 128-bit loads and shifts it into place: the index bytes through
//    the 1 KB table (in shared memory) into the fp32 A tile, X (widened
//    from bf16) into the fp32 X tile.  The fp32 plane never exists in
//    device memory.  The conversion costs about as much shared-memory
//    traffic as the FMA loop's loads (PERF.md, kernel row 1).
//  * One wave of blocks: k is split S ways (split below: the most of 1, 2,
//    4, 8 that keeps the blocks within one a SM and each split at least two
//    steps; S = 8 at the reference shape's 16 tiles, 1 at 4096 columns
//    of X).  The S partial tiles go to a workspace and a second kernel
//    (codebook_reduce) sums them in split order, so two calls give
//    bit-equal outputs.  A thread-block cluster summing the partials
//    through distributed shared memory was measured and dropped: at S = 8
//    it was slower than the second pass, and no shape takes S = 2 or 4 by
//    default (PERF.md, kernel row 1).
//  * Ragged edges (n = 1023, k = 2047, m = 117) are masked in the
//    conversion; nothing is padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128, BM = 64, BN = 128, KC = 32, STAGES = 3;
static_assert(NT == 2 * BM && NT == BN && KC == 32, "thread layout");
constexpr int ARAW = KC + 16;  // bytes of a staged index row
constexpr int MAX_SPLIT = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// X's staged window: k-major, a column's KC values (and the 16 bytes
// around them); row-major, a row's BN values.
template <typename TX, bool KMAJOR>
struct XRaw {
  static constexpr int V = 16 / (int)sizeof(TX);  // values a chunk
  static constexpr int LINE = KMAJOR ? KC + V : BN + V;  // values a line
  static constexpr int LINES = KMAJOR ? BN : KC;
  static constexpr int CHUNKS = LINE / V;  // chunks a line
  static constexpr int BYTES = LINES * LINE * (int)sizeof(TX);
};

constexpr int smem_bytes(int xraw) {
  return 256 * 4 + KC * BM * 4 + KC * BN * 4 + STAGES * (BM * ARAW + xraw);
}

// copies the first `bytes` of 16 and zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the 16-byte copy ``j`` of the aligned window over the bytes
// [start, ...) of an array of ``total`` bytes at ``base``.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* base,
                                           long long start, int j,
                                           long long total) {
  const long long o = (start & ~15LL) + 16LL * j;
  const long long left = total - o;
  cp_async16(dst, left > 0 ? base + o : base,
             left >= 16 ? 16 : left > 0 ? (int)left : 0);
}

__device__ __forceinline__ void store4(float* out, long long at, int left,
                                       const float (&v)[4], bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int c = 0; c < 4 && c < left; ++c) out[at + c] = v[c];
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, long long at,
                                       int left, const float (&v)[4],
                                       bool vec) {
  if (vec && left >= 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<unsigned*>(&lo);
    w.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(out + at) = w;
    return;
  }
  for (int c = 0; c < 4 && c < left; ++c) out[at + c] = __float2bfloat16(v[c]);
}

// Bytes [s, s + 16) of a staged index row (s in [0, 32)), read as two
// aligned 16-byte words and shifted into place.
template <int W>
__device__ __forceinline__ void shift4(const uint32_t (&w)[8], int sh,
                                       uint32_t (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __funnelshift_r(w[W + j], w[W + j + 1], sh);
}
__device__ __forceinline__ void row_bytes16(const uint8_t* row, int s,
                                            uint32_t (&out)[4]) {
  const uint4 q0 = *reinterpret_cast<const uint4*>(row + (s & ~15));
  const uint4 q1 = *reinterpret_cast<const uint4*>(row + (s & ~15) + 16);
  const uint32_t w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  const int b = s & 15, sh = 8 * (b & 3);
  switch (b >> 2) {
    case 0: shift4<0>(w, sh, out); break;
    case 1: shift4<1>(w, sh, out); break;
    case 2: shift4<2>(w, sh, out); break;
    default: shift4<3>(w, sh, out); break;
  }
}

// A staged k-major X column (its 16-byte-aligned line, read with 128-bit
// loads) into column c of the fp32 X tile: value kk is the line's value
// off + kk; those at kk >= n (past the split, or a column past m) are 0.
template <int O>
__device__ __forceinline__ void put_at(const float (&f)[KC + 8], int n,
                                       float* xs) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) xs[kk * BN] = kk < n ? f[O + kk] : 0.f;
}
template <typename TX>
__device__ __forceinline__ void put_column(const uint8_t* line, int off,
                                           int n, float* xs) {
  float f[KC + 8];  // fp32: the line's KC + 4 values; bf16: KC + 8
  const uint4* q = reinterpret_cast<const uint4*>(line);
  if constexpr (sizeof(TX) == 4) {
#pragma unroll
    for (int i = 0; i < (KC + 4) / 4; ++i) {
      const uint4 v = q[i];
      f[4 * i] = __uint_as_float(v.x);
      f[4 * i + 1] = __uint_as_float(v.y);
      f[4 * i + 2] = __uint_as_float(v.z);
      f[4 * i + 3] = __uint_as_float(v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < (KC + 8) / 8; ++i) {
      const uint4 v = q[i];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
        f[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
  if constexpr (sizeof(TX) == 4) {  // off in [0, 4)
    switch (off) {
      case 0: put_at<0>(f, n, xs); break;
      case 1: put_at<1>(f, n, xs); break;
      case 2: put_at<2>(f, n, xs); break;
      default: put_at<3>(f, n, xs); break;
    }
  } else {  // off in [0, 8)
    switch (off) {
      case 0: put_at<0>(f, n, xs); break;
      case 1: put_at<1>(f, n, xs); break;
      case 2: put_at<2>(f, n, xs); break;
      case 3: put_at<3>(f, n, xs); break;
      case 4: put_at<4>(f, n, xs); break;
      case 5: put_at<5>(f, n, xs); break;
      case 6: put_at<6>(f, n, xs); break;
      default: put_at<7>(f, n, xs); break;
    }
  }
}

struct Args {
  const uint8_t* idx;
  const float* table;
  const void* X;
  void* out;     // (n, m), X's type
  float* work;   // S > 1: (S, n, m) fp32 partials; else null
  long long ldx;
  int table_len, n, k, m, kper;  // kper: k a split (a multiple of KC)
};

// The block (split q, row tile, column tile) of the product: S = 1
// stores the tile, S > 1 writes its partial to ``work``.
template <typename TX, bool KMAJOR>
__global__ void __launch_bounds__(NT, 2)
    codebook_spmm_kernel(Args a) {
  using XR = XRaw<TX, KMAJOR>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem);
  float* As = tab + 256;             // [KC][BM]
  float* Xs = As + KC * BM;          // [KC][BN]
  uint8_t* ring = reinterpret_cast<uint8_t*>(Xs + KC * BN);
  constexpr int STAGE = BM * ARAW + XR::BYTES;

  const int tid = threadIdx.x;
  // rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, columns tx*4 + {0..3} and
  // BN/2 + tx*4 + {0..3}; a warp takes 4 ty by 8 tx, so that a step's
  // four 128-bit loads read 4 and 8 distinct float4s a warp
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp % 2) * 4 + lane / 8, tx = (warp / 2) * 8 + lane % 8;
  const int S = gridDim.x, q = blockIdx.x;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.z * BN;
  const int kb = q * a.kper;
  const int ke = min(a.k, kb + a.kper);
  const int nsteps = ke > kb ? (ke - kb + KC - 1) / KC : 0;
  const long long idx_total = (long long)a.n * a.k;
  const long long x_total =
      (KMAJOR ? (long long)(a.m - 1) * a.ldx + a.k
              : (long long)(a.k - 1) * a.ldx + a.m) * (long long)sizeof(TX);
  const uint8_t* xb = static_cast<const uint8_t*>(a.X);

  for (int i = tid; i < 256; i += NT) tab[i] = i < a.table_len ? a.table[i] : 0.f;

  // the copies of step j into its stage
  auto issue = [&](int j) {
    uint8_t* st = ring + (j % STAGES) * STAGE;
    const int k0 = kb + j * KC;
    for (int e = tid; e < BM * (ARAW / 16); e += NT) {
      const int r = e / (ARAW / 16), c = e % (ARAW / 16);
      if (n0 + r < a.n)
        copy_chunk(st + r * ARAW + 16 * c, a.idx,
                   (long long)(n0 + r) * a.k + k0, c, idx_total);
    }
    uint8_t* xr = st + BM * ARAW;
    for (int e = tid; e < XR::LINES * XR::CHUNKS; e += NT) {
      const int ln = e / XR::CHUNKS, c = e % XR::CHUNKS;
      const bool in = KMAJOR ? m0 + ln < a.m : k0 + ln < a.k;
      const long long first = KMAJOR ? (long long)(m0 + ln) * a.ldx + k0
                                     : (long long)(k0 + ln) * a.ldx + m0;
      if (in)
        copy_chunk(xr + ln * XR::LINE * (int)sizeof(TX) + 16 * c, xb,
                   first * (long long)sizeof(TX), c, x_total);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nsteps) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < nsteps; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step j is staged; step j-1's FMAs are done
    if (j + STAGES - 1 < nsteps) issue(j + STAGES - 1);
    cp_async_commit();
    const uint8_t* st = ring + (j % STAGES) * STAGE;
    const int k0 = kb + j * KC;
    {  // the index bytes through the table: thread tid takes 16 bytes of
       // row tid % BM
      const int r = tid % BM, h = tid / BM;
      const long long first = (long long)(n0 + r) * a.k + k0;
      uint32_t b4[4];
      row_bytes16(st + r * ARAW, (int)(first & 15) + 16 * h, b4);
      const bool in = n0 + r < a.n;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int kk = 16 * h + i;
        As[kk * BM + r] = in && k0 + kk < ke
                              ? tab[(b4[i / 4] >> (8 * (i % 4))) & 255]
                              : 0.f;
      }
    }
    {
      const uint8_t* xr = st + BM * ARAW;
      if (KMAJOR) {  // thread tid takes column tid
        const int c = tid;
        const long long first = (long long)(m0 + c) * a.ldx + k0;
        put_column<TX>(xr + c * XR::LINE * (int)sizeof(TX),
                       (int)(first % XR::V),
                       m0 + c < a.m ? ke - k0 : 0, Xs + c);
      } else {  // a warp takes 32 columns of a row
        const TX* xt = reinterpret_cast<const TX*>(xr);
#pragma unroll 4
        for (int e = tid; e < KC * BN; e += NT) {
          const int kk = e / BN, c = e % BN;
          const long long first = (long long)(k0 + kk) * a.ldx + m0;
          const TX* row = xt + kk * XR::LINE + (int)(first % XR::V);
          Xs[kk * BN + c] =
              k0 + kk < ke && m0 + c < a.m ? to_f32(row[c]) : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * BM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * BM + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Xs + kk * BN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Xs + kk * BN + BN / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j2 = 0; j2 < 8; ++j2) acc[i][j2] = fmaf(av[i], bv[j2], acc[i][j2]);
    }
  }
  cp_async_wait<0>();

  auto row_of = [&](int i) { return ty * 4 + (i & 3) + (i >= 4 ? BM / 2 : 0); };
  auto col_of = [&](int h) { return tx * 4 + (h ? BN / 2 : 0); };
  const bool vec = (a.m & 3) == 0;
  TX* out = static_cast<TX*>(a.out);

  float* w = S > 1 ? a.work + (long long)q * a.n * a.m : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = n0 + row_of(i);
    if (r >= a.n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = m0 + col_of(h);
      if (c >= a.m) continue;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      const long long at = (long long)r * a.m + c;
      if (w)
        store4(w, at, a.m - c, v, vec);
      else
        store4(out, at, a.m - c, v, vec);
    }
  }
}

// out = sum over the S splits of work, in split order.
template <typename TX>
__global__ void codebook_reduce(const float* __restrict__ work,
                                TX* __restrict__ out, long long total,
                                int S) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += work[q * total + i];
    if constexpr (sizeof(TX) == 4)
      out[i] = s;
    else
      out[i] = __float2bfloat16(s);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename TX, bool KMAJOR>
cudaError_t launch(const Args& a0, int S, cudaStream_t stream) {
  Args a = a0;
  const int per = (a.k + S - 1) / S;
  a.kper = (per + KC - 1) / KC * KC;
  const dim3 grid(S, (a.n + BM - 1) / BM, (a.m + BN - 1) / BN);
  const int bytes = smem_bytes(XRaw<TX, KMAJOR>::BYTES);
  auto kern = codebook_spmm_kernel<TX, KMAJOR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  const long long total = (long long)a.n * a.m;
  const int blocks = (int)((total + 255) / 256 < 4LL * sm_count()
                               ? (total + 255) / 256
                               : 4LL * sm_count());
  codebook_reduce<TX><<<blocks, 256, 0, stream>>>(
      a.work, static_cast<TX*>(a.out), total, S);
  return cudaGetLastError();
}

}  // namespace

// The split of k the kernel takes by default for an (n, k) index plane and
// m columns of X: the most of 1, 2, 4, 8 that keeps the blocks within one
// a SM and each split at least two steps of KC.
extern "C" int codebook_spmm_split(int n, int k, int m) {
  const long long tiles =
      (long long)((n + BM - 1) / BM) * ((m + BN - 1) / BN);
  const int sms = sm_count();
  int S = 1;
  while (S < MAX_SPLIT && tiles * S * 2 <= sms &&
         (k + 2 * S - 1) / (2 * S) >= 2 * KC)
    S *= 2;
  return S;
}

// out = table[idx] @ X, k cut ``split`` ways (0: codebook_spmm_split),
// the splits' partials summed in split order from ``work``, (split, n, m)
// fp32 (needed when the split is above 1).  out (n, m), row-major, X's
// type.  X(r, c) = X[r * ldx + c], or X[r + c * ldx] when x_kmajor; idx
// and X 16-byte aligned.  x_bf16 selects bf16 X and out, else fp32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int codebook_spmm(const void* idx, const void* table,
                             int table_len, const void* X, long long ldx,
                             int x_kmajor, int x_bf16, void* out, int n, int k,
                             int m, int split, void* work, void* stream) {
  if (table_len < 1 || table_len > 256 || n <= 0 || m <= 0 || k < 0 ||
      split < 0 || split > MAX_SPLIT || (split & (split - 1)) ||
      ((uintptr_t)idx | (uintptr_t)X) % 16 ||
      (k > 0 && ldx < (x_kmajor ? (long long)k : (long long)m)))
    return (int)cudaErrorInvalidValue;
  const int S = split ? split : codebook_spmm_split(n, k, m);
  if (S > 1 && !work) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(idx),
               static_cast<const float*>(table),
               X, out, static_cast<float*>(work), ldx, table_len, n, k, m, 0};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = x_kmajor ? launch<__nv_bfloat16, true>(a, S, s)
                   : launch<__nv_bfloat16, false>(a, S, s);
  else
    err = x_kmajor ? launch<float, true>(a, S, s)
                   : launch<float, false>(a, S, s);
  return (int)err;
}
