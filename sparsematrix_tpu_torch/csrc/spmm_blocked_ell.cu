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
// the reference computes fp32 at Precision.HIGHEST, so the pace is the
// FFMA rate, and what a kernel spends besides FMAs on shared-memory loads,
// X traffic and barriers.
//
// Block heights of 32 and up (the (128,128) layout): one block of 256
// threads per (32-row tile of a block-row, 32 columns of X); it walks the
// M slots, reads block_cols[i, m] itself and stages the block in KC =
// 64-column chunks with the matching X rows, so a (128, 128) fp32 block
// (64 KB) never has to sit whole in shared memory.  The fp32 tile
// arithmetic is shared with the codebook kernel (gather_gemm.cuh).
//
// Block heights below 32 (the (8,128) layout of the main path): the first
// design gave such a block-row an 8 x 64 tile, so every block-row staged
// its own copy of the X rows it names (at the main shape 128 block-rows
// re-read all of X: ~123 MB of L2 traffic for 490 M operations), and its
// inner loop issued a 64- and a 128-bit shared load per 8 FMAs.  Now:
//
// - Row groups.  A block takes R = 64 / bm block-rows (a 64 x 128 output
//   tile, R <= 32), as the JAX kernel batches
//   4, and walks the union of their block columns: warp 0 merges the R
//   slot lists (a lane a block-row, a warp min and ballot a column), NB
//   union entries at a time, into descriptors in shared memory (column,
//   which block-rows have it, their slots).  Each slot is taken once, in
//   slot order, so the lists need not be sorted for the sum to be right;
//   sorted lists (as csr_to_blocked_ell gives) make the union small.
// - X once.  For each union column the X chunk (32 contraction rows x 128
//   columns) and the 64 x 32 A chunk (zeros for a block-row without the
//   column) are copied once into shared memory by cp.async (16 bytes where
//   the layout allows, else 4), NST stages in flight, and every block-row
//   of the group uses that X chunk.  bf16 goes through registers instead.
//   On a dense-like pattern X traffic falls by R; on a sparse one it is
//   never more than the first design's.
// - A warp takes 8 rows and a thread 8 x 4 outputs, both tiles k-inner in
//   shared memory: a warp reads a row's 4 contraction steps as one 128-bit
//   broadcast and its X fragment with 4 more loads.  Since the warp's rows
//   are the same for all its threads, a row whose 4 steps are all zero (a
//   block-row without the column, or zeros inside a block) is skipped by
//   the whole warp.
// - Splits.  At the main shape the output (1023 x 117) is 16 tiles for
//   132 SMs, so a group's union is split over `split` blocks, an equal
//   count of its entries each (warp 0 counts the union first), which sum
//   with fp32 atomicAdd into the output, zeroed first (no fixed order).  The split gives about as many blocks as the SMs
//   hold at once; bf16 outputs are never split (they would need an fp32
//   scratch).
#include <algorithm>
#include <climits>
#include <cstdint>

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

// ---- block heights below 32: row groups --------------------------------

namespace rg {

constexpr int TC = 128;      // output columns a block
constexpr int TR = 64;       // output rows a block (R block-rows)
constexpr int NT = TR * 4;   // threads: a warp 8 rows, a thread 8 x 4 outputs
constexpr int KS = 32;       // contraction rows a stage
constexpr int KSP = KS + 4;  // row stride of the k-inner tiles
constexpr int TCP = TC + 4;  // row stride of a row-major X tile
constexpr int NB = 32;       // union entries a merge batch
constexpr int RMAX = 32;     // block-rows a group at most (a lane each)
constexpr int BC_CAP = 4096; // block_cols of a group cached in shared memory
constexpr int NST = 3;       // stages in flight (fp32: a cp.async ring)

struct Shared {
  float As[NST][TR * KSP];   // [row][k]
  float Xs[NST][TC * KSP];   // [col][k] (k-major X) or [k][TCP] (row-major)
  int dslot[2][NB][RMAX];    // slot of block-row r, or -1
  int dcol[2][NB];
  unsigned dmask[2][NB];     // block-rows that have the column
  int dn[2];                 // entries in the batch
  int bc[BC_CAP];            // the group's block_cols, when they fit
};
static_assert(KS * TCP <= TC * KSP, "row-major X tile");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// copies the first `bytes` of 16 and zero-fills the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// Warp 0's merge of the group's slot lists: lane r holds block-row i0 + r's
// cursor m and the column of its next slot, or INT_MAX past its last.
// `left` counts the union entries this block still takes.
struct Merge {
  const int* bc;  // the group's (R, M) block_cols, shared or global
  int M, m, cur, left;
  bool live;

  __device__ void start(const int* cols, int lane_m, bool is_live) {
    bc = cols;
    M = lane_m;
    m = 0;
    live = is_live;
    cur = live && M > 0 ? bc[0] : INT_MAX;
  }

  // The next union entry: its column (INT_MAX when done) and, per lane,
  // whether its block-row has it (its slot is then m before the step).
  __device__ int step(bool& mine) {
    const int c = __reduce_min_sync(~0u, cur);
    mine = c != INT_MAX && cur == c;
    if (mine) {
      ++m;
      cur = m < M ? bc[m] : INT_MAX;
    }
    return c;
  }

  // The union's size.
  __device__ int count() {
    int n = 0;
    bool mine;
    while (step(mine) != INT_MAX) ++n;
    return n;
  }

  // Fills descriptor buffer b with the next (up to NB) union entries.
  template <class S>
  __device__ void batch(S& sh, int b, int lane) {
    int n = 0;
    for (; n < NB && left > 0; ++n, --left) {
      const int slot = m;
      bool mine;
      const int c = step(mine);
      if (c == INT_MAX) break;
      const unsigned mask = __ballot_sync(~0u, mine);
      sh.dslot[b][n][lane] = mine ? slot : -1;
      if (lane == 0) {
        sh.dcol[b][n] = c;
        sh.dmask[b][n] = mask;
      }
    }
    if (lane == 0) sh.dn[b] = n;
  }
};

// MODE 0: the product.  The other modes are ablations, bit flags: 1 stages
// every chunk but does no FMA, 2 skips no zeros, 4 stages nothing (the
// FMAs run on what the buffers hold).  Modes 1 and 6 do not give A @ X.
template <typename T, bool KMAJOR, bool ATOMIC, int MODE>
__global__ void __launch_bounds__(NT)
bell_rows(const int* __restrict__ block_cols, const T* __restrict__ blocks,
          const T* __restrict__ X, long long ldx, void* __restrict__ out,
          int nrows, int ncols, int nbr, int M, int bm, int bk, int nrhs,
          int R, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const long long i0 = (long long)blockIdx.x * R;  // first block-row
  const int c0 = blockIdx.y * TC;
  const int s = blockIdx.z;
  const int rows_used = R * bm;
  const int nr = (int)min((long long)R, nbr - i0);  // block-rows present
  const bool cached = (long long)nr * M <= BC_CAP;
  if (cached)
    for (int e = tid; e < nr * M; e += NT) sh.bc[e] = __ldg(block_cols + i0 * M + e);
  __syncthreads();

  // the union entries [u0, u1) of the group are this block's: a count,
  // then the merge again past the first u0
  Merge mg;
  if (w == 0) {
    const int* cols = (cached ? sh.bc : block_cols + i0 * M) + (long long)lane * M;
    int u0 = 0;
    mg.left = INT_MAX;
    if (split > 1) {
      mg.start(cols, M, lane < nr);
      const int total = mg.count();
      u0 = (int)((long long)total * s / split);
      mg.left = (int)((long long)total * (s + 1) / split) - u0;
    }
    mg.start(cols, M, lane < nr);
    bool mine;
    for (int e = 0; e < u0; ++e) mg.step(mine);
    mg.batch(sh, 0, lane);
    mg.batch(sh, 1, lane);
  }
  // the block-rows of this warp's 8 output rows
  unsigned wmask = 0u;
  if (w * 8 < rows_used) {
    const int lo = w * 8 / bm, hi = min(w * 8 + 7, rows_used - 1) / bm;
    wmask = (hi >= 31 ? ~0u : (2u << hi) - 1u) & ~((1u << lo) - 1u);
  }

  float acc[8][4] = {};
  // acc += the stage in As, Xs.  A warp's 8 rows are the same for all its
  // threads, so a row's 4 contraction steps that are all zero (a
  // block-row without the column, or zeros inside a block) are skipped by
  // the whole warp at once.  The kq loop is not unrolled, and a row's A
  // values are loaded as it is reached: the body then stays in the
  // instruction cache and within 128 registers.
  auto fma_stage = [&](const float* As, const float* Xs) {
#pragma unroll 1
    for (int kq = 0; kq < KS; kq += 4) {
      float4 xb[4];  // k-major: 4 k of column lane + 32 j; row-major: the
                     // columns 4 lane .. +3 of k row kq + j
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xb[j] = KMAJOR ? *reinterpret_cast<const float4*>(
                             &Xs[(lane + 32 * j) * KSP + kq])
                       : *reinterpret_cast<const float4*>(
                             &Xs[(kq + j) * TCP + 4 * lane]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(&As[(w * 8 + i) * KSP + kq]);
        if (!(MODE & 2) &&
            ((__float_as_uint(a.x) | __float_as_uint(a.y) |
              __float_as_uint(a.z) | __float_as_uint(a.w)) << 1) == 0u)
          continue;
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (KMAJOR) {
            float t = acc[i][j];
            t = fmaf(a.x, xb[j].x, t);
            t = fmaf(a.y, xb[j].y, t);
            t = fmaf(a.z, xb[j].z, t);
            acc[i][j] = fmaf(a.w, xb[j].w, t);
          } else {
            acc[i][0] = fmaf(av[j], xb[j].x, acc[i][0]);
            acc[i][1] = fmaf(av[j], xb[j].y, acc[i][1]);
            acc[i][2] = fmaf(av[j], xb[j].z, acc[i][2]);
            acc[i][3] = fmaf(av[j], xb[j].w, acc[i][3]);
          }
        }
      }
    }
  };
  __syncthreads();  // the first two batches are merged

  if constexpr (sizeof(T) == 4) {
    // fp32: stage (u, kc) -- union entry u, contraction rows kc..kc+KS of
    // its blocks -- is copied by cp.async into ring buffer `buf`; a missing
    // block, rows past bk or ncols and columns past nrhs are zero-filled
    const float* bl = reinterpret_cast<const float*>(blocks);
    const float* xg = reinterpret_cast<const float*>(X);
    const bool avec = bk % 4 == 0 && reinterpret_cast<uintptr_t>(bl) % 16 == 0;
    const bool xvec = bk % 4 == 0 && ldx % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(xg) % 16 == 0;
    auto issue = [&](int u, int kc, int buf) {
      const int b = (u / NB) & 1, e = u % NB;
      const long long xr0 = (long long)sh.dcol[b][e] * bk + kc;
      float* As = sh.As[buf];
      float* Xs = sh.Xs[buf];
      auto a_src = [&](int r, int k, bool& ok) {
        const int rb = r / bm;
        const int slot = r < rows_used ? sh.dslot[b][e][rb] : -1;
        ok = slot >= 0 && kc + k < bk;
        return ok ? bl + ((i0 + rb) * M + slot) * bm * bk +
                        (long long)(r - rb * bm) * bk + kc + k
                  : bl;
      };
      if (avec) {  // 8 threads a row, 16 bytes each
#pragma unroll
        for (int j = 0; j < TR * KS / (4 * NT); ++j) {
          const int g = tid + j * NT, r = g >> 3, k = (g & 7) * 4;
          bool ok;
          const float* src = a_src(r, k, ok);
          cp_async16(&As[r * KSP + k], src, ok ? 16 : 0);
        }
      } else {  // a warp a row
#pragma unroll
        for (int j = 0; j < TR * KS / NT; ++j) {
          const int r = w + j * (NT / 32);  // NT / 32 rows a pass
          bool ok;
          const float* src = a_src(r, lane, ok);
          cp_async4(&As[r * KSP + lane], src, ok);
        }
      }
      if (KMAJOR) {
        if (xvec) {
#pragma unroll
          for (int j = 0; j < TC * KS / (4 * NT); ++j) {
            const int g = tid + j * NT, c = g >> 3, k = (g & 7) * 4;
            const long long xr = xr0 + k;
            const int cc = c0 + c;
            const long long left = ncols - xr;
            const int n = (cc < nrhs && kc + k < bk && left > 0)
                              ? (left < 4 ? (int)left : 4) : 0;
            cp_async16(&Xs[c * KSP + k], n ? xg + xr + (long long)cc * ldx : xg,
                       4 * n);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TC * KS / NT; ++j) {
            const int c = w + j * (NT / 32);
            const long long xr = xr0 + lane;
            const int cc = c0 + c;
            const bool ok = kc + lane < bk && xr < ncols && cc < nrhs;
            cp_async4(&Xs[c * KSP + lane], ok ? xg + xr + (long long)cc * ldx : xg,
                      ok);
          }
        }
      } else {
        if (xvec) {
#pragma unroll
          for (int j = 0; j < TC * KS / (4 * NT); ++j) {
            const int g = tid + j * NT, k = g >> 5, c = (g & 31) * 4;
            const long long xr = xr0 + k;
            const int cc = c0 + c;
            const int n = (kc + k < bk && xr < ncols && cc < nrhs)
                              ? (nrhs - cc < 4 ? nrhs - cc : 4) : 0;
            cp_async16(&Xs[k * TCP + c], n ? xg + xr * ldx + cc : xg, 4 * n);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TC * KS / NT; ++j) {
            const int k = (tid >> 7) + j * (NT / TC), c = tid & (TC - 1);
            const long long xr = xr0 + k;
            const int cc = c0 + c;
            const bool ok = kc + k < bk && xr < ncols && cc < nrhs;
            cp_async4(&Xs[k * TCP + c], ok ? xg + xr * ldx + cc : xg, ok);
          }
        }
      }
    };
    // the issue cursor runs NST - 1 stages ahead of the compute cursor
    int iu = 0, ik = 0;
    bool ilive = sh.dn[0] > 0;
    auto iadvance = [&]() {
      ik += KS;
      if (ik >= bk) {
        ik = 0;
        ++iu;
      }
      ilive = (iu % NB) < sh.dn[(iu / NB) & 1];
    };
#pragma unroll
    for (int p = 0; p < NST - 1; ++p) {
      if (ilive) {
        if (!(MODE & 4)) issue(iu, ik, p);
        iadvance();
      }
      cp_async_commit();
    }
    int u = 0, kc = 0, buf = 0;
    bool live = sh.dn[0] > 0;
    while (live) {
      cp_async_wait<NST - 2>();  // stage (u, kc) has landed
      __syncthreads();           // ... for every thread; buf - 1 is free
      // entering batch u / NB frees the other buffer for the batch after
      if (w == 0 && kc == 0 && u > 0 && u % NB == 0)
        mg.batch(sh, (u / NB + 1) & 1, lane);
      if (ilive) {
        if (!(MODE & 4)) issue(iu, ik, (buf + NST - 1) % NST);
        iadvance();
      }
      cp_async_commit();
      if (!(MODE & 1) && (sh.dmask[(u / NB) & 1][u % NB] & wmask))
        fma_stage(sh.As[buf], sh.Xs[buf]);
      kc += KS;
      if (kc >= bk) {
        kc = 0;
        ++u;
      }
      live = (u % NB) < sh.dn[(u / NB) & 1];
      buf = (buf + 1) % NST;
    }
  } else {
    // bf16: the stage is loaded into registers one stage ahead, converted
    // to fp32, and stored into buffer 0
    float ra[TR * KS / NT];  // 16
    float rx[TC * KS / NT];  // 16
    auto load = [&](int u, int kc) {
      const int b = (u / NB) & 1, e = u % NB;
      const long long xr0 = (long long)sh.dcol[b][e] * bk + kc;
      const bool kin = kc + lane < bk;
#pragma unroll
      for (int j = 0; j < TR * KS / NT; ++j) {
        const int r = w + j * (NT / 32);  // a warp reads 32 k of one row
        const int rb = r / bm;
        const int slot = r < rows_used ? sh.dslot[b][e][rb] : -1;
        ra[j] = (slot >= 0 && kin)
                    ? gg::to_f32(blocks[((i0 + rb) * M + slot) * bm * bk +
                                        (long long)(r - rb * bm) * bk + kc + lane])
                    : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TC * KS / NT; ++j) {
        int kk, c;
        if (KMAJOR) {  // a warp reads 32 k of one column
          kk = lane;
          c = w + j * (NT / 32);
        } else {  // a warp reads 32 columns of one row
          kk = (tid >> 7) + j * (NT / TC);
          c = tid & (TC - 1);
        }
        const long long xr = xr0 + kk;
        const int cc = c0 + c;
        rx[j] = (kc + kk < bk && xr < ncols && cc < nrhs)
                    ? gg::to_f32(KMAJOR ? X[xr + (long long)cc * ldx]
                                        : X[xr * ldx + cc])
                    : 0.f;
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int j = 0; j < TR * KS / NT; ++j)
        sh.As[0][(w + j * (NT / 32)) * KSP + lane] = ra[j];
#pragma unroll
      for (int j = 0; j < TC * KS / NT; ++j) {
        if (KMAJOR)
          sh.Xs[0][(w + j * (NT / 32)) * KSP + lane] = rx[j];
        else
          sh.Xs[0][((tid >> 7) + j * (NT / TC)) * TCP + (tid & (TC - 1))] = rx[j];
      }
    };
    int u = 0, kc = 0;
    bool live = sh.dn[0] > 0;
    if (live) load(0, 0);
    while (live) {
      __syncthreads();  // the last stage's reads are done
      store();
      if (w == 0 && kc == 0 && u > 0 && u % NB == 0)
        mg.batch(sh, (u / NB + 1) & 1, lane);
      __syncthreads();
      const unsigned mask = sh.dmask[(u / NB) & 1][u % NB];
      int nu = u, nk = kc + KS;
      if (nk >= bk) {
        nk = 0;
        ++nu;
      }
      const bool nlive = (nu % NB) < sh.dn[(nu / NB) & 1];
      if (nlive) load(nu, nk);
      if (!(MODE & 1) && (mask & wmask)) fma_stage(sh.As[0], sh.Xs[0]);
      u = nu;
      kc = nk;
      live = nlive;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = w * 8 + i;
    const long long row = i0 * bm + r;
    if (r >= rows_used || row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + (KMAJOR ? lane + 32 * j : 4 * lane + j);
      if (c >= nrhs) continue;
      if (ATOMIC) {
        if (acc[i][j] != 0.f)
          atomicAdd(static_cast<float*>(out) + row * nrhs + c, acc[i][j]);
      } else {
        gg::put(static_cast<T*>(out) + row * nrhs + c, acc[i][j]);
      }
    }
  }
}

template <typename T, bool KMAJOR, bool ATOMIC, int MODE>
cudaError_t launch_one(dim3 grid, cudaStream_t st, const int* bc,
                       const void* blocks, const void* X, long long ldx,
                       void* out, int nrows, int ncols, int nbr, int M, int bm,
                       int bk, int nrhs, int R, int split) {
  auto kern = bell_rows<T, KMAJOR, ATOMIC, MODE>;
  constexpr int bytes = (int)sizeof(Shared);
  // the opt-in above 48 KB of shared memory (set on the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, bytes, st>>>(
      bc, static_cast<const T*>(blocks), static_cast<const T*>(X), ldx, out,
      nrows, ncols, nbr, M, bm, bk, nrhs, R, split);
  return cudaGetLastError();
}

template <typename T, bool KMAJOR>
cudaError_t launch_rows(const int* bc, const void* blocks, const void* X,
                        long long ldx, void* out, int nrows, int ncols,
                        int nbr, int M, int bm, int bk, int nrhs, int split,
                        int mode, cudaStream_t st) {
  const int R = std::min(TR / bm, RMAX);
  const int groups = (nbr + R - 1) / R, ctiles = (nrhs + TC - 1) / TC;
  const int nbc = (ncols + bk - 1) / bk;
  if (split <= 0) {  // about as many blocks as the SMs hold at once (2)
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    split = (int)(2LL * sms / ((long long)groups * ctiles));
  }
  // a block takes at least one union entry: the union is at most nbc wide
  split = std::max(1, std::min(std::min(split, std::max(std::min(nbc, M * R), 1)), 65535));
  if (sizeof(T) != 4) split = 1;  // a bf16 output is stored, never summed
  if (split > 1) {
    const cudaError_t e = cudaMemsetAsync(
        out, 0, (size_t)nrows * nrhs * sizeof(float), st);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)groups, (unsigned)ctiles, (unsigned)split);
#define RG_LAUNCH(ATOM, MD)                                                  \
  launch_one<T, KMAJOR, ATOM, MD>(grid, st, bc, blocks, X, ldx, out, nrows,  \
                                  ncols, nbr, M, bm, bk, nrhs, R, split)
  if (split > 1) {
    switch (mode) {
      case 1: return RG_LAUNCH(true, 1);
      case 2: return RG_LAUNCH(true, 2);
      case 6: return RG_LAUNCH(true, 6);
      default: return RG_LAUNCH(true, 0);
    }
  }
  switch (mode) {
    case 1: return RG_LAUNCH(false, 1);
    case 2: return RG_LAUNCH(false, 2);
    case 6: return RG_LAUNCH(false, 6);
    default: return RG_LAUNCH(false, 0);
  }
#undef RG_LAUNCH
}

}  // namespace rg

template <typename T, bool KMAJOR>
cudaError_t dispatch_tile(const int* bc, const void* blocks, const void* X,
                          long long ldx, void* out, int nrows, int ncols,
                          int nbr, int M, int bm, int bk, int nrhs, int split,
                          int mode, cudaStream_t s) {
  if (bm < 32)
    return rg::launch_rows<T, KMAJOR>(bc, blocks, X, ldx, out, nrows, ncols,
                                      nbr, M, bm, bk, nrhs, split, mode, s);
  using L = gg::Layout<32, 32, 4, CT, KG, KC>;
  const int row_tiles = (bm + 31) / 32;
  const dim3 grid((unsigned)nbr * row_tiles, (nrhs + 31) / 32);
  bell_kernel<T, KMAJOR, 32, 32, 4><<<grid, L::NT, 0, s>>>(
      bc, static_cast<const T*>(blocks), static_cast<const T*>(X), ldx,
      static_cast<T*>(out), nrows, ncols, M, bm, bk, nrhs, row_tiles);
  return cudaGetLastError();
}

}  // namespace

// spmm_blocked_ell with its knobs, for block heights below 32: ``split``
// blocks a tile (0: about 2 blocks an SM; fp32 only) and ``mode``, the
// ablations of bell_rows (1: stage every chunk, no FMA; 2: skip no zeros;
// 6: stage nothing and skip no zeros; the results of 1 and 6 are not
// A @ X).  chip_smoke.py times them beside the default.
extern "C" int spmm_blocked_ell_tuned(const void* block_cols,
                                      const void* blocks, const void* X,
                                      long long ldx, int x_kmajor, int bf16,
                                      void* out, int nrows, int ncols,
                                      int nbr, int M, int bm, int bk,
                                      int nrhs, int split, int mode,
                                      void* stream) {
  if (nrows <= 0 || nrhs <= 0 || nbr <= 0 || M < 0 || bm <= 0 || bk <= 0 ||
      (long long)nbr * bm < nrows || split < 0 ||
      (mode != 0 && mode != 1 && mode != 2 && mode != 6))
    return (int)cudaErrorInvalidValue;
  const auto* bc = static_cast<const int*>(block_cols);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = x_kmajor ? dispatch_tile<__nv_bfloat16, true>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, split, mode, s)
                   : dispatch_tile<__nv_bfloat16, false>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, split, mode, s);
  else
    err = x_kmajor ? dispatch_tile<float, true>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, split, mode, s)
                   : dispatch_tile<float, false>(bc, blocks, X, ldx, out, nrows, ncols, nbr, M, bm, bk, nrhs, split, mode, s);
  return (int)err;
}

// out (nrows, nrhs), row-major, X's type.  X(r, c) = X[r * ldx + c], or
// X[r + c * ldx] when x_kmajor.  bf16 selects bf16 blocks, X and out, else
// fp32.  Returns the launch's cudaError_t (0 on success).
extern "C" int spmm_blocked_ell(const void* block_cols, const void* blocks,
                                const void* X, long long ldx, int x_kmajor,
                                int bf16, void* out, int nrows, int ncols,
                                int nbr, int M, int bm, int bk, int nrhs,
                                void* stream) {
  return spmm_blocked_ell_tuned(block_cols, blocks, X, ldx, x_kmajor, bf16,
                                out, nrows, ncols, nbr, M, bm, bk, nrhs, 0, 0,
                                stream);
}
