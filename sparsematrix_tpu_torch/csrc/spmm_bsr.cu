// spmm_bsr.cu — BSR times dense for sm_90a: the grouped and the panel
// kernels.
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
// block-row writes only rows below nrows.  Each element of Y is written
// once, with no atomics: two calls give the same bits.
//
// What bounds them: 2 * num_blocks * bm * bn * nrhs fp32 operations
// against num_blocks * (bm * bn * value bytes + 4) bytes of blocks, the X
// rows the stored blocks name (read once) and Y written once.  At (8, 8)
// blocks and nrhs = 128 the intensity is nrhs / 2 = 64 operations a block
// byte, above the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// the FMA rate bounds them; TF32 tensor cores are ruled out because the
// reference computes fp32 at Precision.HIGHEST.  At block CG's nrhs = 8
// the blocks' bytes bound them.
//
// The grouped kernel (row 3) is the Blocked-ELL skeleton
// (gather_gemm.cuh): one block of threads per (row tile of a block-row,
// column tile of Y) walks the contraction q = slot * bn + c of its
// block-row in KC = 64 steps, so that 8 blocks of an (8, 8) BSR fill one
// step, stages the (KC x TR) A chunk and the KC gathered X rows in shared
// memory, and accumulates an (RT x 4) register tile with fp32 FMA.  The
// division q / bn and the block-column lookup happen once a step and
// column q, in a shared table.  Block-rows of at least 32 rows take
// 32 x 32 tiles, of at least 8 rows 8 x 64 tiles, smaller ones 4 x 64.
//
// The panel kernel (row 4) has two designs; the wrapper picks one and its
// vector width (kernels/bsr.py panel_plan).  Its first design was the
// skeleton above: at block CG's nrhs = 8 and M = 5, 56 of a 64-column
// tile were dead and 8192 blocks each ran one 40-wide step between two
// barriers (0.1001 ms, launch and barrier latency); at the XL (8, 8) BSR,
// nrhs = 128, M = 53, every block-row re-read its X rows through shared
// memory with a 64- and a 128-bit shared load per 8 FMAs (0.4109 ms, 13x
// the FMA bound).  Both designs walk each block-row's slots up to its last
// one that holds a nonzero value (counts, kernels/bsr.py panel_counts):
// the panel layout pads every block-row to the longest one's M slots (40 %
// of the XL BSR's slots, 129982 blocks in 4096 x 53).
//   narrow (panel_narrow, nrhs < 32): one thread a (row of Y, V-column
//     vector), V the widest of 4 fp32 / 8 bf16 that divides nrhs, so no
//     lane is idle at nrhs = 8 (8 rows x 2 lanes of 4 columns a block-row).
//     It reads its panel row as contiguous 16-byte vectors (streamed: each
//     row is read once) and the X rows bcols names through the read-only
//     path (the lanes of one block-row read the same X rows, so L1 serves
//     all but the first), with no shared memory and no barrier; the next
//     8 contraction rows' loads go out before this step's FMAs.
//   wide (panel_wide, nrhs >= 32, bn % 8 == 0): each warp walks
//     (block-row, row chunk of RT rows, column panel of 32 V) items,
//     persistent over the grid.  The item's panel rows and the slots'
//     block-columns are staged in shared memory by cp.async a stage (SC
//     slots) ahead, double-buffered per warp, with no block barrier.
//     Lane j owns the V columns of Y at 32 V p + V j for all RT rows: it
//     gathers each X row into registers (16-byte loads at fp32 V = 4) and
//     spends it on RT rows, reading the panel values as shared-memory
//     broadcasts (one 16-byte load a row and 4 contraction steps).  Per
//     contraction step a warp issues one global and RT/4 shared loads for
//     32 RT V FMAs; the floor is the gathered X traffic from L2 (every
//     block's X rows once per block), then the FMA rate.  A narrower V
//     gives more warps where block-rows are few (the bench's 256 take
//     V = 2 at nrhs = 128) and idles no lane at nrhs = 32 (V = 1).
#include "bulk.cuh"
#include "gather_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// row 3: the grouped kernel
// ---------------------------------------------------------------------------

constexpr int KG = 4, KC = 64, CT = 4;

template <typename T, int TR, int TC, int RT>
__global__ void __launch_bounds__(gg::Layout<TR, TC, RT, CT, KG, KC>::NT)
bsr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
           const T* __restrict__ A, const T* __restrict__ X, T* __restrict__ out,
           int nrows, int ncols, int bm, int bn, int nrhs, int row_tiles) {
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

  // A(r, q) = a[slot * bm * bn + r * bn + c] for q = slot*bn + c; the X
  // row-block of slot is idx[slot]
  const int s0 = indptr[i];
  const int nslots = indptr[i + 1] - s0;
  const T* a = A + (long long)s0 * bm * bn;
  const long long slot_stride = (long long)bm * bn;
  const long long row_stride = bn;
  const int* idx = indices + s0;
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

template <typename T, int TR, int TC, int RT>
cudaError_t launch(const int* indptr, const int* indices, const void* A,
                   const void* X, void* out, int nrows, int ncols, int nbr,
                   int bm, int bn, int nrhs, cudaStream_t stream) {
  using L = gg::Layout<TR, TC, RT, CT, KG, KC>;
  const int row_tiles = (bm + TR - 1) / TR;
  const dim3 grid((unsigned)nbr * row_tiles, (nrhs + TC - 1) / TC);
  bsr_kernel<T, TR, TC, RT><<<grid, L::NT, 0, stream>>>(
      indptr, indices, static_cast<const T*>(A), static_cast<const T*>(X),
      static_cast<T*>(out), nrows, ncols, bm, bn, nrhs, row_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tile(const int* rc, const int* ind, const void* A,
                          const void* X, void* out, int nrows, int ncols,
                          int nbr, int bm, int bn, int nrhs, cudaStream_t s) {
  if (bm >= 32)
    return launch<T, 32, 32, 4>(rc, ind, A, X, out, nrows, ncols, nbr, bm, bn,
                                nrhs, s);
  if (bm > 4)
    return launch<T, 8, 64, 2>(rc, ind, A, X, out, nrows, ncols, nbr, bm, bn,
                               nrhs, s);
  return launch<T, 4, 64, 2>(rc, ind, A, X, out, nrows, ncols, nbr, bm, bn,
                             nrhs, s);
}

// ---------------------------------------------------------------------------
// row 4: the panel kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bf16x2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// V consecutive elements at p (aligned to their size) as fp32, through the
// read-only path; STREAM marks data read once (evict-first).
template <int V, bool STREAM = false>
__device__ __forceinline__ void ldv(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = STREAM ? __ldcs(q) : __ldg(q);
    const float4 b = STREAM ? __ldcs(q + 1) : __ldg(q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = STREAM ? __ldcs(q) : __ldg(q);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V, bool STREAM = false>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 a = STREAM ? __ldcs(q) : __ldg(q);
    bf16x2(a.x, v[0], v[1]); bf16x2(a.y, v[2], v[3]);
    bf16x2(a.z, v[4], v[5]); bf16x2(a.w, v[6], v[7]);
  } else if constexpr (V == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    bf16x2(a.x, v[0], v[1]); bf16x2(a.y, v[2], v[3]);
  } else if constexpr (V == 2) {
    bf16x2(__ldg(reinterpret_cast<const unsigned*>(p)), v[0], v[1]);
  } else {
    v[0] = __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

// 4 elements of a shared-memory stage as fp32 (a broadcast: every lane of
// the warp reads the same address)
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  bf16x2(a.x, v[0], v[1]);
  bf16x2(a.y, v[2], v[3]);
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <int V>
__device__ __forceinline__ void stv(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                   bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned*>(p) = bf16_pair(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// narrow: thread t is row t / G of Y (row i * bm + r of block-row i) and
// its columns V (t % G) .. + V; rows at or past nrows do nothing.  VEC
// (bn % 8 == 0, every panel row 16-byte aligned) reads the panel row 8
// values a load; else one a load.  Step t is C contraction rows; the panel
// values and X rows of step t + 1 are loaded while step t's FMAs run (the
// first step's before the slot count is known: slot 0 always exists).
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(128)
    panel_narrow(const int* __restrict__ bcols, const int* __restrict__ counts,
                 const T* __restrict__ panels, const T* __restrict__ X,
                 T* __restrict__ out, int nrows, int ncols, int M, int bm,
                 int bn, int nrhs, int G) {
  constexpr int C = VEC ? 8 : 1;  // contraction rows a step
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t0 / G;
  if (row >= nrows) return;
  const int c0 = (int)(t0 - row * G) * V;
  const long long i = row / bm;
  const long long len = (long long)M * bn;
  const T* a = panels + row * len;  // panels (nbr, bm, len): row-major rows
  const int* bc = bcols + i * M;
  const T* x = X + c0;
  const int cps = bn / C;  // steps a slot
  auto gather = [&](int t, float (&av)[C], float (&xv)[C][V]) {
    const int mm = t / cps;
    const int c = (t - mm * cps) * C;
    ldv<C, true>(a + (long long)mm * bn + c, av);
    const long long xr0 = (long long)__ldg(bc + mm) * bn + c;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const long long xr = xr0 + j;
      if (xr < ncols) {
        ldv<V>(x + xr * nrhs, xv[j]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[j][v] = 0.f;
      }
    }
  };
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  auto fma = [&](const float (&av)[C], const float (&xv)[C][V]) {
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(av[j], xv[j][v], acc[v]);
  };
  float aa[C], ab[C], xa[C][V], xb[C][V];
  gather(0, aa, xa);
  // the slots up to the block-row's last nonzero one
  const int nsteps = __ldg(counts + i) * cps;
  for (int t = 0; t < nsteps; t += 2) {
    if (t + 1 < nsteps) gather(t + 1, ab, xb);
    fma(aa, xa);
    if (t + 1 < nsteps) {
      if (t + 2 < nsteps) gather(t + 2, aa, xa);
      fma(ab, xb);
    }
  }
  stv<V>(out + row * nrhs + c0, acc);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   bulk::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   bulk::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The wide walk's shape: item (block-row i, row chunk rc, column panel p)
// is i * RC * P + rc * P + p; each item's contraction, its block-row's
// first counts[i] slots, is cut into stages of SC slots: SC * bn columns
// of RT panel rows (`ld` = SC * bn apart) and, after them, the SC slots'
// block-columns; an item of no slot takes one empty stage and writes
// zeros.  stage: bytes a stage, panel: the bytes of its panel rows.
struct Wide {
  int M, bm, bn, nrhs, ncols, nrows;
  int RT, RC, P, SC, stage, panel;
  long long n_items;
};

// warp's copy of stage (item, ch) into dst: the item's rows (at most RT,
// those below bm) and the stage's slots, 16 bytes a copy, then the
// slots' block-columns, 4 bytes a copy
template <typename T>
__device__ __forceinline__ void wide_fetch(unsigned char* dst,
                                           const int* __restrict__ bcols,
                                           const T* __restrict__ panels,
                                           const Wide& w, long long item,
                                           int cnt, int ch, int lane) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
  const long long i = item / (w.RC * w.P);
  const int r0 = (int)((item / w.P) % w.RC) * w.RT;
  const int nr = min(w.RT, w.bm - r0);
  const int m0 = ch * w.SC, ns = min(w.SC, cnt - m0);
  if (ns <= 0) return;
  const int per = ns * w.bn / E;  // copies a row
  const long long len = (long long)w.M * w.bn;
  const T* src = panels + (i * w.bm + r0) * len + (long long)m0 * w.bn;
  T* rows = reinterpret_cast<T*>(dst);
  const int ld = w.SC * w.bn;
  for (int e = lane; e < nr * per; e += 32) {
    const int r = e / per, q = e - r * per;
    cp16(rows + r * ld + q * E, src + r * len + q * E);
  }
  int* cols = reinterpret_cast<int*>(dst + w.panel);
  for (int e = lane; e < ns; e += 32) cp4(cols + e, bcols + i * w.M + m0 + e);
}

template <typename T, int V, int RT>
__global__ void __launch_bounds__(128)
    panel_wide(const int* __restrict__ bcols, const int* __restrict__ counts,
               const T* __restrict__ panels, const T* __restrict__ X,
               T* __restrict__ out, Wide w) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  unsigned char* stages = sm + (size_t)warp * 2 * w.stage;
  const long long step = (long long)gridDim.x * wpb;
  long long it = (long long)blockIdx.x * wpb + warp;
  if (it >= w.n_items) return;
  const int ld = w.SC * w.bn;
  const int cps = w.bn / 8;  // 8-row steps a slot
  float acc[RT][V];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  auto count = [&](long long item) {
    return __ldg(counts + item / (w.RC * w.P));
  };
  auto n_stages = [&](int cnt) {
    return cnt > 0 ? (cnt + w.SC - 1) / w.SC : 1;
  };
  int ch = 0, buf = 0, cnt = count(it);
  wide_fetch(stages, bcols, panels, w, it, cnt, 0, lane);
  cp_commit();
  for (;;) {
    long long nit = it;
    int nch = ch + 1, ncnt = cnt;
    if (nch == n_stages(cnt)) {
      nit = it + step;
      nch = 0;
      if (nit < w.n_items) ncnt = count(nit);
    }
    const bool more = nit < w.n_items;
    if (more)
      wide_fetch(stages + (buf ^ 1) * w.stage, bcols, panels, w, nit, ncnt,
                 nch, lane);
    cp_commit();
    cp_wait<1>();
    __syncwarp();

    const long long i = it / (w.RC * w.P);
    const int rc = (int)((it / w.P) % w.RC);
    const int col0 = ((int)(it % w.P) * 32 + lane) * V;
    const bool cok = col0 < w.nrhs;
    const int ns = min(w.SC, cnt - ch * w.SC);
    const unsigned char* st = stages + buf * w.stage;
    const T* as = reinterpret_cast<const T*>(st);
    const int* bcs = reinterpret_cast<const int*>(st + w.panel);
    const T* x = X + col0;
    // step t: the 8 contraction rows 8 t .. 8 t + 7 of the stage; below
    // 4 columns a lane, the X rows of step t + 1 are gathered while step
    // t's FMAs run
    auto gather = [&](int t, float (&xv)[8][V]) {
      const int mm = t / cps;
      const long long xr0 = (long long)bcs[mm] * w.bn + (t - mm * cps) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long xr = xr0 + j;
        if (cok && xr < w.ncols) {
          ldv<V>(x + xr * w.nrhs, xv[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) xv[j][v] = 0.f;
        }
      }
    };
    auto fma = [&](int t, const float (&xv)[8][V]) {
      const T* am = as + t * 8;  // slot t / cps, rows (t % cps) * 8 ..
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float a0[4], a1[4];
        lds4(am + r * ld, a0);
        lds4(am + r * ld + 4, a1);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float s = acc[r][v];
#pragma unroll
          for (int j = 0; j < 4; ++j) s = fmaf(a0[j], xv[j][v], s);
#pragma unroll
          for (int j = 0; j < 4; ++j) s = fmaf(a1[j], xv[4 + j][v], s);
          acc[r][v] = s;
        }
      }
    };
    const int nsteps = ns > 0 ? ns * cps : 0;
    if constexpr (V == 4) {
      // 4 columns a lane: the registers of a second step in flight would
      // cost a quarter of the warps an SM holds (152 against 96)
      for (int t = 0; t < nsteps; ++t) {
        float xv[8][V];
        gather(t, xv);
        fma(t, xv);
      }
    } else {
      float xa[8][V], xb[8][V];
      if (nsteps > 0) gather(0, xa);
      for (int t = 0; t < nsteps; t += 2) {
        if (t + 1 < nsteps) gather(t + 1, xb);
        fma(t, xa);
        if (t + 1 < nsteps) {
          if (t + 2 < nsteps) gather(t + 2, xa);
          fma(t + 1, xb);
        }
      }
    }
    __syncwarp();  // the stage is read before its refill

    if (ch == n_stages(cnt) - 1) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int rb = rc * RT + r;
        const long long row = i * w.bm + rb;
        if (cok && rb < w.bm && row < w.nrows)
          stv<V>(out + row * w.nrhs + col0, acc[r]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
      }
    }
    if (!more) break;
    it = nit;
    ch = nch;
    cnt = ncnt;
    buf ^= 1;
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, int V>
cudaError_t run_narrow(const int* bcols, const int* counts, const void* panels,
                       const void* X, void* out, int nrows, int ncols, int M,
                       int bm, int bn, int nrhs, cudaStream_t s) {
  const int G = nrhs / V;
  const long long blocks = ((long long)nrows * G + 127) / 128;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = bn % 8 == 0 ? panel_narrow<T, V, true> : panel_narrow<T, V, false>;
  kern<<<(unsigned)blocks, 128, 0, s>>>(
      bcols, counts, static_cast<const T*>(panels), static_cast<const T*>(X),
      static_cast<T*>(out), nrows, ncols, M, bm, bn, nrhs, G);
  return cudaGetLastError();
}

constexpr int kSmemMax = 232448;

template <typename T, int V, int RT>
cudaError_t run_wide(const int* bcols, const int* counts, const void* panels,
                     const void* X, void* out, Wide w, int nbr,
                     cudaStream_t s) {
  w.RT = RT;
  w.RC = (w.bm + RT - 1) / RT;
  w.P = (w.nrhs + 32 * V - 1) / (32 * V);
  w.panel = (RT * w.SC * w.bn * (int)sizeof(T) + 15) / 16 * 16;
  w.stage = w.panel + (w.SC * 4 + 15) / 16 * 16;
  w.n_items = (long long)nbr * w.RC * w.P;
  const size_t stage_bytes = (size_t)w.stage;
  // four warps a block, two where a stage is larger than 16 KB
  const int wpb = 8 * stage_bytes <= 128 * 1024 ? 4 : 2;
  const size_t smem = (size_t)wpb * 2 * stage_bytes;
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto kern = panel_wide<T, V, RT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, wpb * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: as many blocks as are resident at once, or fewer
  const long long need = (w.n_items + wpb - 1) / wpb;
  const long long fit = (long long)sm_count() * per_sm;
  kern<<<(unsigned)(need < fit ? need : fit), wpb * 32, smem, s>>>(
      bcols, counts, static_cast<const T*>(panels), static_cast<const T*>(X),
      static_cast<T*>(out), w);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t wide_rt(int RT, const int* bcols, const int* counts,
                    const void* panels, const void* X, void* out,
                    const Wide& w, int nbr, cudaStream_t s) {
  switch (RT) {
    case 8: return run_wide<T, V, 8>(bcols, counts, panels, X, out, w, nbr, s);
    case 4: return run_wide<T, V, 4>(bcols, counts, panels, X, out, w, nbr, s);
    case 2: return run_wide<T, V, 2>(bcols, counts, panels, X, out, w, nbr, s);
    case 1: return run_wide<T, V, 1>(bcols, counts, panels, X, out, w, nbr, s);
    default: return cudaErrorInvalidValue;
  }
}

// The plan's (design, V, RT, SC) as the wrapper chose them
// (kernels/bsr.py panel_plan).
template <typename T>
cudaError_t panel(const int* bcols, const int* counts, const void* panels,
                  const void* X, void* out, int nrows, int ncols, int nbr,
                  int M, int bm, int bn, int nrhs, int design, int V, int RT,
                  int SC, cudaStream_t s) {
  if (V < 1 || nrhs % V != 0) return cudaErrorInvalidValue;
  if (design == 1) {
    switch (V) {
      case 8:
        if constexpr (sizeof(T) == 2)
          return run_narrow<T, 8>(bcols, counts, panels, X, out, nrows, ncols,
                                  M, bm, bn, nrhs, s);
        return cudaErrorInvalidValue;
      case 4: return run_narrow<T, 4>(bcols, counts, panels, X, out, nrows,
                                      ncols, M, bm, bn, nrhs, s);
      case 2: return run_narrow<T, 2>(bcols, counts, panels, X, out, nrows,
                                      ncols, M, bm, bn, nrhs, s);
      case 1: return run_narrow<T, 1>(bcols, counts, panels, X, out, nrows,
                                      ncols, M, bm, bn, nrhs, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (design != 2 || SC < 1 || bn % 8 != 0) return cudaErrorInvalidValue;
  Wide w{};
  w.M = M; w.bm = bm; w.bn = bn; w.nrhs = nrhs; w.ncols = ncols;
  w.nrows = nrows; w.SC = SC < M ? SC : M;
  switch (V) {
    case 4: return wide_rt<T, 4>(RT, bcols, counts, panels, X, out, w, nbr, s);
    case 2: return wide_rt<T, 2>(RT, bcols, counts, panels, X, out, w, nbr, s);
    case 1: return wide_rt<T, 1>(RT, bcols, counts, panels, X, out, w, nbr, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// row 3: the tile design (blocks of bm >= 32 and bm * bn >= 4096)
// ---------------------------------------------------------------------------

namespace tile {

constexpr int NT = 256;  // threads: 16 (ty) x 16 (tx)
constexpr int ITEM = 8;  // ints an item or a sum of the host plan

// Blocks an SM: the 128 x 128 tile's 64 sums a thread take one block an SM
// (at two, 128 registers a thread, it spilled); smaller tiles two.  The
// host plan (kernels/bsr.py tile_plan) asks spmm_bsr_tile_blocks, which
// reads what the card makes of these bounds, for its grid.
template <int TR, int TC>
constexpr int resident() {
  return TR * TC >= 128 * 128 ? 1 : 2;
}
constexpr int kSmemMax = 232448;

template <typename T>
struct Tile {
  static constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
};

// the ring: KC contraction rows a stage, ST stages of cp.async copies
template <typename T, int TR, int TC, int KC, int ST>
struct Smem {
  static constexpr int AS = KC + Tile<T>::V;  // A row stride, 16 B padded
  static constexpr int A = TR * AS;           // elements of the A chunk
  static constexpr int STAGE = A + KC * TC;   // A chunk and X chunk
  static constexpr size_t BYTES = (size_t)ST * STAGE * sizeof(T);
};

// 16 bytes by cp.async, or 16 zero bytes where `ok` is false (src-size 0:
// nothing is read)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   bulk::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2 consecutive staged elements as fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  float a, b;
  bf16x2(*reinterpret_cast<const unsigned*>(p), a, b);
  return make_float2(a, b);
}

// 4 consecutive staged elements as fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 h = *reinterpret_cast<const uint2*>(p);
  float a, b, c, d;
  bf16x2(h.x, a, b);
  bf16x2(h.y, c, d);
  return make_float4(a, b, c, d);
}

// 4 sums into out[row, col..col+3] (col < nrhs), in out's type
template <typename T>
__device__ __forceinline__ void store4(T* out, long long row, int col,
                                       int nrhs, const float (&v)[4]) {
  T* o = out + row * nrhs + col;
  if (nrhs % 4 == 0) {
    stv<4>(o, v);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < nrhs) gg::put(o + c, v[c]);
  }
}

// Stage `st` of chunk (slot, c0), xblk = indices[slot]: rows row0 ..
// row0+TR of block `slot`'s columns c0 .. c0+KC (As[r][kk]), and the X
// rows xblk*bn + c0 .. +KC at columns col0 .. col0+TC (Xs[kk][c]); what
// lies past the block, ncols or nrhs reads 0.  vec: 16-byte copies (bn and
// nrhs multiples of V, both operands 16-byte aligned), else element by
// element.
template <typename T, int TR, int TC, int KC, int ST>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ A,
                                           const T* __restrict__ X, int xblk,
                                           int slot, int c0, int row0,
                                           int col0, int bm, int bn,
                                           int ncols, int nrhs, bool vec) {
  using S = Smem<T, TR, TC, KC, ST>;
  constexpr int V = Tile<T>::V, AS = S::AS;
  T* As = st;
  T* Xs = st + S::A;
  const long long ab = (long long)slot * bm * bn;
  const long long xr0 = (long long)xblk * bn + c0;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int AQ = KC / V;
    for (int e = tid; e < TR * AQ; e += NT) {
      const int r = e / AQ, kk = (e - r * AQ) * V;
      const bool ok = row0 + r < bm && c0 + kk < bn;
      cp16z(As + r * AS + kk,
            ok ? A + ab + (long long)(row0 + r) * bn + c0 + kk : A, ok);
    }
    constexpr int XQ = TC / V;
    for (int e = tid; e < KC * XQ; e += NT) {
      const int kk = e / XQ, c = (e - kk * XQ) * V;
      const long long xr = xr0 + kk;
      const bool ok = c0 + kk < bn && xr < ncols && col0 + c < nrhs;
      cp16z(Xs + kk * TC + c, ok ? X + xr * nrhs + col0 + c : X, ok);
    }
  } else {
    for (int e = tid; e < TR * KC; e += NT) {
      const int r = e / KC, kk = e - r * KC;
      As[r * AS + kk] = row0 + r < bm && c0 + kk < bn
                            ? A[ab + (long long)(row0 + r) * bn + c0 + kk]
                            : T{};
    }
    for (int e = tid; e < KC * TC; e += NT) {
      const int kk = e / TC, c = e - kk * TC;
      const long long xr = xr0 + kk;
      Xs[kk * TC + c] = c0 + kk < bn && xr < ncols && col0 + c < nrhs
                            ? X[xr * nrhs + col0 + c]
                            : T{};
    }
  }
}

// items (n_items, ITEM) int32: block-row, row0 (in the block), col0 (of
// Y), first slot, end slot, partial tile (-1: the item writes Y).  Block b
// walks items block_ptr[b] .. block_ptr[b+1] (the host balances the
// blocks' work).  Thread (ty, tx) owns rows ty + 16 i
// (i < TR / 16) and columns tx*4 .. +3 (and 64 + tx*4 .. +3 where TC =
// 128) of the item's TR x TC tile.
template <typename T, int TR, int TC, int KC, int ST>
__global__ void __launch_bounds__(NT, (resident<TR, TC>()))
    bsr_tile(const int* __restrict__ indices, const T* __restrict__ A,
             const T* __restrict__ X, T* __restrict__ out,
             float* __restrict__ scratch, const int* __restrict__ items,
             const int* __restrict__ block_ptr, int nrows, int ncols, int bm,
             int bn, int nrhs, int vec) {
  constexpr int RT = TR / 16, CG = TC / 64;  // rows, column groups a thread
  using S = Smem<T, TR, TC, KC, ST>;
  constexpr int AS = S::AS;
  extern __shared__ __align__(128) unsigned char sm_raw[];
  T* sm = reinterpret_cast<T*>(sm_raw);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int cpb = (bn + KC - 1) / KC;  // chunks a block
  const int it1 = __ldg(block_ptr + blockIdx.x + 1);
  for (int it = __ldg(block_ptr + blockIdx.x); it < it1; ++it) {
    const int* item = items + (long long)it * ITEM;
    const int brow = __ldg(item), row0 = __ldg(item + 1),
              col0 = __ldg(item + 2), sa = __ldg(item + 3),
              sb = __ldg(item + 4), dst = __ldg(item + 5);
    const int n_chunks = (sb - sa) * cpb;
    // the next chunk to load: its number, slot, column and X row-block;
    // the row-block of the next slot is read a chunk ahead of its copies
    int lt = 0, ls = sa, lc = 0;
    int lx = sa < sb ? __ldg(indices + sa) : 0;
    auto load_next = [&]() {
      load_stage<T, TR, TC, KC, ST>(sm + (lt % ST) * S::STAGE, A, X, lx, ls,
                                    lc, row0, col0, bm, bn, ncols, nrhs,
                                    vec != 0);
      ++lt;
      if ((lc += KC) >= bn) {
        lc = 0;
        if (++ls < sb) lx = __ldg(indices + ls);
      }
    };
    float acc[RT][CG * 4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CG * 4; ++j) acc[i][j] = 0.f;
    __syncthreads();  // the last item's stages are read
#pragma unroll
    for (int t = 0; t < ST - 1; ++t) {
      if (lt < n_chunks) load_next();
      commit();
    }
    for (int t = 0; t < n_chunks; ++t) {
      wait<ST - 2>();
      __syncthreads();  // chunk t has landed; chunk t - 1 is read
      if (lt < n_chunks) load_next();
      commit();
      const T* As = sm + (t % ST) * S::STAGE;
      const T* Xs = As + S::A;
      // two contraction steps a round: the A values of 2 steps (8-byte
      // loads) and one X row at a time keep the fragments to 2 RT + 4 CG
      // registers beside the RT x 4 CG sums (a 4-step round, 4 RT + 4 CG,
      // held the 128 x 128 tile at 0.256 ms, 38 % of the FMA rate)
#pragma unroll
      for (int k2 = 0; k2 < KC; k2 += 2) {
        float a[RT][2];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float2 q = ld2(As + (ty + 16 * i) * AS + k2);
          a[i][0] = q.x; a[i][1] = q.y;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float x[CG * 4];
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            const float4 v = ld4(Xs + (k2 + q) * TC + g * 64 + tx * 4);
            x[4 * g] = v.x; x[4 * g + 1] = v.y;
            x[4 * g + 2] = v.z; x[4 * g + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CG * 4; ++j)
              acc[i][j] = fmaf(a[i][q], x[j], acc[i][j]);
        }
      }
    }
    wait<0>();
    if (dst < 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = row0 + ty + 16 * i;
        const long long row = (long long)brow * bm + r;
        if (r >= bm || row >= nrows) continue;
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const int col = col0 + g * 64 + tx * 4;
          if (col >= nrhs) continue;
          const float v[4] = {acc[i][4 * g], acc[i][4 * g + 1],
                              acc[i][4 * g + 2], acc[i][4 * g + 3]};
          store4(out, row, col, nrhs, v);
        }
      }
    } else {
      float* P = scratch + (long long)dst * TR * TC;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int g = 0; g < CG; ++g)
          *reinterpret_cast<float4*>(P + (ty + 16 * i) * TC + g * 64 +
                                     tx * 4) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

// sums (n_sums, ITEM) int32: block-row, row0, col0, first partial tile,
// partial count p.  Block (s, y) takes elements y*NT*4 .. of sum s's tile:
// each element's p partials are added in chunk order (p = 0, an empty
// block-row: zeros) and written to Y, so two calls give the same bits.
template <typename T, int TR, int TC>
__global__ void __launch_bounds__(NT)
    bsr_tile_sum(const float* __restrict__ scratch,
                 const int* __restrict__ sums, T* __restrict__ out,
                 int nrows, int bm, int nrhs) {
  const int* s = sums + (long long)blockIdx.x * ITEM;
  const int brow = __ldg(s), row0 = __ldg(s + 1), col0 = __ldg(s + 2),
            base = __ldg(s + 3), p = __ldg(s + 4);
  const int e = (blockIdx.y * NT + threadIdx.x) * 4;
  const int r = e / TC, c = e - r * TC;
  const long long row = (long long)brow * bm + row0 + r;
  const int col = col0 + c;
  if (e >= TR * TC || row0 + r >= bm || row >= nrows || col >= nrhs) return;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = 0; j < p; ++j) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(
        scratch + (long long)(base + j) * TR * TC + e));
    v[0] += q.x; v[1] += q.y; v[2] += q.z; v[3] += q.w;
  }
  store4(out, row, col, nrhs, v);
}

// the attribute for more than 48 KB of shared memory, set once
template <typename T, int TR, int TC, int KC, int ST>
cudaError_t prepare() {
  static thread_local bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsr_tile<T, TR, TC, KC, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  return cudaSuccess;
}

// the blocks of bsr_tile the card holds at once, or -1
template <typename T, int TR, int TC, int KC, int ST>
int blocks() {
  int per = 0;
  if (prepare<T, TR, TC, KC, ST>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, bsr_tile<T, TR, TC, KC, ST>, NT,
          Smem<T, TR, TC, KC, ST>::BYTES) != cudaSuccess ||
      per < 1)
    return -1;
  return sm_count() * per;
}

struct Args {
  const int* indices;
  const void* A;
  const void* X;
  void* out;
  float* scratch;
  const int* items;
  const int* block_ptr;
  int grid;
  const int* sums;
  int n_sums, nrows, ncols, bm, bn, nrhs;
  cudaStream_t st;
};

template <typename T, int TR, int TC, int KC, int ST>
cudaError_t run(const Args& g) {
  const T* a = static_cast<const T*>(g.A);
  const T* x = static_cast<const T*>(g.X);
  T* y = static_cast<T*>(g.out);
  constexpr int V = Tile<T>::V;
  const bool vec = g.bn % V == 0 && g.nrhs % V == 0 &&
                   reinterpret_cast<uintptr_t>(g.A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g.X) % 16 == 0;
  if (g.grid > 0) {
    const cudaError_t e = prepare<T, TR, TC, KC, ST>();
    if (e != cudaSuccess) return e;
    bsr_tile<T, TR, TC, KC, ST>
        <<<(unsigned)g.grid, NT, Smem<T, TR, TC, KC, ST>::BYTES, g.st>>>(
            g.indices, a, x, y, g.scratch, g.items, g.block_ptr, g.nrows,
            g.ncols, g.bm, g.bn, g.nrhs, vec ? 1 : 0);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return e2;
  }
  if (g.n_sums > 0)
    bsr_tile_sum<T, TR, TC>
        <<<dim3((unsigned)g.n_sums, (TR * TC + NT * 4 - 1) / (NT * 4)), NT, 0,
           g.st>>>(g.scratch, g.sums, y, g.nrows, g.bm, g.nrhs);
  return cudaGetLastError();
}

// ring 0: 16-deep chunks in 3 stages, the 32- and 64-row tiles' only
// ring; the 128-row tiles also take 1 (32-deep, 3 stages), 2 (16-deep, 4
// stages) and 3 (32-deep, 4 stages), their default (kernels/bsr.py
// tile_rings).  `query` asks blocks() instead of launching: returns the
// blocks the card holds at once, or -1.
template <typename T, int TR, int TC>
int ring_of(int ring, bool query, const Args& g) {
#define SPMM_BSR_RING(R, K, S)                                        \
  if (ring == R)                                                      \
    return query ? blocks<T, TR, TC, K, S>() : (int)run<T, TR, TC, K, S>(g);
  SPMM_BSR_RING(0, 16, 3)
  if constexpr (TR == 128) {
    SPMM_BSR_RING(1, 32, 3)
    SPMM_BSR_RING(2, 16, 4)
    SPMM_BSR_RING(3, 32, 4)
  }
#undef SPMM_BSR_RING
  return query ? -1 : (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int TR, int TC, int ring, bool query, const Args& g) {
#define SPMM_BSR_TILE(R, C) \
  if (TR == R && TC == C) return ring_of<T, R, C>(ring, query, g);
  SPMM_BSR_TILE(128, 128)
  SPMM_BSR_TILE(128, 64)
  SPMM_BSR_TILE(64, 128)
  SPMM_BSR_TILE(64, 64)
  SPMM_BSR_TILE(32, 128)
  SPMM_BSR_TILE(32, 64)
#undef SPMM_BSR_TILE
  return query ? -1 : (int)cudaErrorInvalidValue;
}

}  // namespace tile

bool bad_shape(int nrows, int nbr, int bm, int bn, int nrhs) {
  return nrows <= 0 || nrhs <= 0 || nbr <= 0 || bm <= 0 || bn <= 0 ||
         (long long)nbr * bm < nrows;
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
  if (bad_shape(nrows, nbr, bm, bn, nrhs) || (nrhs + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* rc = static_cast<const int*>(indptr);
  const auto* ind = static_cast<const int*>(indices);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch_tile<__nv_bfloat16>(rc, ind, data, X, out, nrows,
                                             ncols, nbr, bm, bn, nrhs, s);
  return (int)dispatch_tile<float>(rc, ind, data, X, out, nrows, ncols, nbr,
                                   bm, bn, nrhs, s);
}

// The panel kernel (row 4).  bcols (nbr, M) int32, counts (nbr) int32 (the
// slots of each block-row that are walked: kernels/bsr.py panel_counts),
// panels (nbr, bm, M*bn), panels and X 16-byte aligned, the rest as above;
// the plan of kernels/bsr.py panel_plan: design 1 the narrow kernel with V
// columns a thread (V | nrhs, 8 for bf16 only), 2 the wide one (bn % 8 ==
// 0) with V columns a lane (1, 2 or 4), RT rows an item (1, 2, 4 or 8)
// and SC slots a stage.
extern "C" int spmm_bsr_panel(const void* bcols, const void* counts,
                              const void* panels, const void* X, int bf16,
                              void* out, int nrows, int ncols, int nbr, int M,
                              int bm, int bn, int nrhs, int design, int V,
                              int RT, int SC, void* stream) {
  if (bad_shape(nrows, nbr, bm, bn, nrhs) || M < 1)
    return (int)cudaErrorInvalidValue;
  const auto* bc = static_cast<const int*>(bcols);
  const auto* cn = static_cast<const int*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? panel<__nv_bfloat16>(bc, cn, panels, X, out, nrows,
                                           ncols, nbr, M, bm, bn, nrhs,
                                           design, V, RT, SC, s)
                    : panel<float>(bc, cn, panels, X, out, nrows, ncols, nbr,
                                   M, bm, bn, nrhs, design, V, RT, SC, s));
}

// The grouped product's tile design (row 3, blocks of bm >= 32): items
// (n_items, 8), block_ptr (grid + 1) and sums (n_sums, 8) int32 of
// kernels/bsr.py tile_plan, `grid` blocks each walking its run of items,
// TR x TC tiles (TR 32, 64 or 128; TC 64 or 128), `ring` (0; 0-3 for
// the 128-row tiles: tile::ring_of), scratch
// (n_partials, TR, TC) fp32; the rest as spmm_bsr.  Two launches: the
// items, then the sums (each skipped when empty).  Returns the
// cudaError_t of the launches.
extern "C" int spmm_bsr_tile(const void* indices, const void* data,
                             const void* X, int bf16, void* out,
                             void* scratch, const void* items,
                             const void* block_ptr, int grid,
                             const void* sums, int n_sums, int nrows,
                             int ncols, int bm, int bn, int nrhs, int TR,
                             int TC, int ring, void* stream) {
  if (nrows <= 0 || nrhs <= 0 || bm <= 0 || bn <= 0 || grid < 0 ||
      n_sums < 0)
    return (int)cudaErrorInvalidValue;
  const tile::Args g{static_cast<const int*>(indices),
                     data,
                     X,
                     out,
                     static_cast<float*>(scratch),
                     static_cast<const int*>(items),
                     static_cast<const int*>(block_ptr),
                     grid,
                     static_cast<const int*>(sums),
                     n_sums,
                     nrows,
                     ncols,
                     bm,
                     bn,
                     nrhs,
                     static_cast<cudaStream_t>(stream)};
  return bf16 ? tile::dispatch<__nv_bfloat16>(TR, TC, ring, false, g)
              : tile::dispatch<float>(TR, TC, ring, false, g);
}

// The blocks of the tile design (TR x TC tiles, bf16 or fp32, `ring`) that
// the card holds at once, all SMs together: the grid the host plan cuts
// its items for.  -1 if the card cannot say or the shape is not built.
extern "C" int spmm_bsr_tile_blocks(int TR, int TC, int bf16, int ring) {
  const tile::Args g{};
  return bf16 ? tile::dispatch<__nv_bfloat16>(TR, TC, ring, true, g)
              : tile::dispatch<float>(TR, TC, ring, true, g);
}
