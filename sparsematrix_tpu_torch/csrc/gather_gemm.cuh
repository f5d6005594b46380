// gather_gemm.cuh — the fp32 tile skeleton shared by the codebook and the
// Blocked-ELL kernels.
//
// Both kernels compute a tile of  out = A_gathered @ X  where the A tile is
// produced on the fly (a codebook lookup, or a Blocked-ELL block picked by
// block_cols) and X is a (rows x cols) window of a dense operand.  A thread
// block owns a (TR x TC) output tile and walks the contraction in steps of
// KC: each step stages a (KC x TR) A tile and a (KC x TC) X tile in shared
// memory, converted to fp32, and every thread accumulates an (RT x CT)
// sub-tile with fp32 FMA (no TF32: the reference computes fp32 at
// Precision.HIGHEST).  The KC rows of a step are split over KG thread
// groups, so a small output tile still has 256 threads at work; the KG
// partial sums are added in shared memory at the end.  The next step's
// global loads are issued into registers before the current step's FMAs,
// so their latency overlaps the arithmetic.
//
// Both operands are read along their contiguous axis: a warp reads 8
// consecutive k of 4 rows of A (4 sectors a request), and 32 consecutive
// columns of a row-major X or 8 consecutive k of 4 columns of a k-major X.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gg {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Physical column of logical column c in row kk of a [KC][TC] X tile: the
// float4 groups of a row are XOR-permuted by kk % 8, so that both staging
// layouts below store without bank conflicts while every thread still
// reads its CT = 4 columns as one aligned float4.
__device__ __forceinline__ int swz(int kk, int c) {
  return ((((c >> 2) ^ (kk & 7))) << 2) | (c & 3);
}

// Register stage of the (KC x TC) window X(row0 + kk, col0 + c) of a dense
// operand; rows outside [row0, row_end) and columns >= col_end read as 0.
// X(r, c) = X[r * ldx + c] (row-major) or X[r + c * ldx] (KMAJOR, e.g. the
// view a.T of a row-major a, read without a copy).
template <typename TX, bool KMAJOR, int KC, int TC, int NT>
struct XStage {
  static_assert(TC % 32 == 0 && NT % 32 == 0 && (KC * TC) % NT == 0, "X tile");
  static_assert(!KMAJOR || KC % 8 == 0, "KMAJOR needs KC % 8 == 0");
  static constexpr int PER = KC * TC / NT;
  float v[PER];

  static __device__ __forceinline__ void coords(int e, int& kk, int& c) {
    if constexpr (KMAJOR) {
      // a warp covers 8 rows x 4 columns: four 32-byte runs along k
      const int id = e >> 5, lane = e & 31;
      kk = (id % (KC / 8)) * 8 + (lane & 7);
      c = (id / (KC / 8)) * 4 + (lane >> 3);
    } else {
      // a warp covers 32 consecutive columns of one row
      kk = e / TC;
      c = e % TC;
    }
  }

  __device__ __forceinline__ void load(const TX* __restrict__ X, long long ldx,
                                       long long row0, long long row_end,
                                       int col0, int col_end, int tid) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int kk, c;
      coords(tid + j * NT, kk, c);
      const long long r = row0 + kk;
      const int cc = col0 + c;
      v[j] = (r >= 0 && r < row_end && cc < col_end)
                 ? to_f32(KMAJOR ? X[r + (long long)cc * ldx] : X[r * ldx + cc])
                 : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* Xs, int tid) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int kk, c;
      coords(tid + j * NT, kk, c);
      Xs[kk * TC + swz(kk, c)] = v[j];
    }
  }
};

// Thread layout of a (TR x TC) tile: NT = (TR/RT) * (TC/CT) * KG threads,
// tc fastest, then tr, then the k-group g.
template <int TR, int TC, int RT, int CT, int KG, int KC>
struct Layout {
  static_assert(CT == 4 && (RT == 2 || RT == 4), "sub-tile");
  static_assert(TR % RT == 0 && TR % 4 == 0 && TC % CT == 0 && KC % KG == 0 &&
                    KC % 8 == 0,
                "tile");
  static constexpr int NT = (TR / RT) * (TC / CT) * KG;
  // row stride of the [KC][TRP] A tile: padded by one float4, so that the
  // 8 k x 4 rows a warp stores fall on 32 distinct banks
  static constexpr int TRP = TR + 4;
  static constexpr int PER_A = KC * TR / NT;
  static_assert(PER_A >= 1 && (KC * TR) % NT == 0, "A tile");
  // shared floats: the A and X tiles, reused for the k-group reduction
  static constexpr int SMEM = (KC * (TRP + TC) > KG * TR * TC) ? KC * (TRP + TC)
                                                               : KG * TR * TC;
  int g, tr, tc;
  __device__ __forceinline__ explicit Layout(int tid) {
    constexpr int per_group = (TR / RT) * (TC / CT);
    g = tid / per_group;
    tr = (tid % per_group) / (TC / CT);
    tc = tid % (TC / CT);
  }

  // Element e of the A tile is row r, step column kk: a warp takes 8
  // consecutive kk of 4 consecutive rows.  It is stored at As[a_slot(kk, r)].
  static __device__ __forceinline__ void a_coords(int e, int& kk, int& r) {
    const int w = e >> 5, lane = e & 31;
    kk = (w % (KC / 8)) * 8 + (lane >> 2);
    r = (w / (KC / 8)) * 4 + (lane & 3);
  }
  static __device__ __forceinline__ int a_slot(int kk, int r) { return kk * TRP + r; }

  // acc += As^T-slice @ Xs-slice over this thread's KC/KG rows of the step;
  // As is [KC][TRP], Xs is [KC][TC] swizzled.
  __device__ __forceinline__ void fma_step(const float* As, const float* Xs,
                                           float (&acc)[RT][CT]) const {
#pragma unroll
    for (int q = 0; q < KC / KG; ++q) {
      const int kk = g * (KC / KG) + q;
      float a[RT];
      if constexpr (RT == 4) {
        const float4 t = *reinterpret_cast<const float4*>(As + kk * TRP + tr * 4);
        a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(As + kk * TRP + tr * 2);
        a[0] = t.x; a[1] = t.y;
      }
      const float4 b = *reinterpret_cast<const float4*>(Xs + kk * TC + swz(kk, tc * 4));
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
  }

  // Adds the KG partial tiles in shared memory and writes rows
  // [row0, row_end) x columns [col0, col_end) of out (leading dim ldo).
  // The caller has synchronised after its last fma_step.
  template <typename TO>
  __device__ __forceinline__ void reduce_store(float* red, const float (&acc)[RT][CT],
                                               int tid, TO* __restrict__ out,
                                               long long ldo, long long row0,
                                               long long row_end, int col0,
                                               int col_end) const {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        red[(g * TR + tr * RT + i) * TC + tc * CT + j] = acc[i][j];
    __syncthreads();
    for (int e = tid; e < TR * TC; e += NT) {
      const int r = e / TC, c = e % TC;
      float s = 0.f;
#pragma unroll
      for (int h = 0; h < KG; ++h) s += red[(h * TR + r) * TC + c];
      if (row0 + r < row_end && col0 + c < col_end)
        put(out + (row0 + r) * ldo + col0 + c, s);
    }
  }
};

}  // namespace gg
