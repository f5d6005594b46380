// Wave triangular solve x = T^-1 b on host-inverted diagonal blocks: the
// device half of kernels/trisolve_waves.py.  Three kernels:
//
//  * chain (trisolve_chain, R = 1) replaces _chain_kernel of
//    sparsematrix_tpu/kernels/trisolve_waves.py (_chain_call, pallas_call
//    at :419);
//  * chain for 8 right-hand sides (trisolve_chain_mm, R = 8) replaces
//    _chain_mm_kernel (_chain_mm_call, pallas_call at :636);
//  * binv (trisolve_binv) replaces _binv_kernel (_binv_call, pallas_call
//    at :521).
//
// Chain mode, tile reach K <= 3, 128-row tiles g = 0..S-1:
//     x_g = b_g . A1_g - sum_{k=1..K, g-k >= 0} x_{g-k} . A2^k_g
// with A1_g = a1 viewed (S, 128, 128) [g] (inv(D_g)^T) and A2^k_g = a2
// viewed (S, K, 128, 128) [g][k-1]; b_g and x_g are (R, 128) (R = 8: the
// tile-major pane, rows g*8 .. g*8+7 of an (S*8, 128) panel).  The TPU
// kernel commits a wave of 8 tiles a grid step and seeds its history from
// the previous wave; walked tile by tile the recurrence is the one above.
// Unlike the TPU kernel, the single-RHS chain computes the (1, 128) row
// b_g . A1_g and not an (8, 128) product whose other 7 rows are dropped.
//
// binv mode, waves of m tiles (m divides 8): wave i gathers its rows'
// cross-wave entries (row-lane slabs of earlier columns, slab_tloc = the
// tile in the wave) from the committed prefix of x into u = b_wave - acc,
// then x_wave = u . a1[i], a1[i] = inv(D_i)^T of (128m, 128m).
//
// What bounds them: latency.  Both are a chain of dependent steps (S
// tiles, n_waves waves), each a small dense product; the bytes (the plan,
// read once) would take ~0.03 ms at n = 65536.
//
// Design (trisolve.cuh): blocks of 512 threads (4 quarters of 32 rows x
// 128 lanes) draw their step from a ticket and walk the program in order.
//  * chain: one block a tile.  Before it waits, a block loads its A2
//    rows into registers (32 K floats a thread) and computes the
//    independent half b_g . A1_g; the ~132 resident blocks do this for
//    the next tiles while the chain front advances.  Then it waits until
//    tiles 0..g-1 are done, reads x_{g-1..g-K} through L2, subtracts
//    their products, sums the quarters and publishes x_g.  fp32 FMA on
//    CUDA cores (no TF32: the TPU kernel runs Precision.HIGHEST); bf16
//    planes are widened to fp32 on load.
//  * binv: one block a (wave i, tile p).  It waits until every earlier
//    wave is committed, gathers the slabs of tile p (slab_tloc == p; the
//    block lists them in shared memory first, so their loads overlap),
//    publishes u_p, waits for u_0..u_{p-1} of its wave (lower tickets)
//    and computes x_p = sum_{q <= p} u_q . a1[i][q, p]: a1 = inv(D)^T is
//    block upper triangular (D lower), so blocks q > p are exact zeros
//    and are skipped.  The m blocks of a wave stream a1[i] in parallel.
#include <cstdint>
#include <cuda_runtime.h>

#include "trisolve.cuh"

namespace {

using ts::kLanes;
using ts::kQuarters;
using ts::kThreads;
constexpr int kJ = kLanes / kQuarters;  // rows of a tile per quarter

// sync[0]: ticket, sync[1]: tiles done.  x (S*R*128) fp32.
template <int R, int K, bool BF16>
__global__ void __launch_bounds__(kThreads)
    chain(const void* __restrict__ a1, const void* __restrict__ a2,
          const float* __restrict__ b, float* x, int* sync, int S) {
  __shared__ float bs[R][kLanes];
  __shared__ float hs[K][R][kLanes];
  __shared__ float part[R][kQuarters][kLanes];
  const int g = ts::draw_ticket(sync);
  if (g >= S) return;
  const int tid = threadIdx.x, q = tid / kLanes, l = tid % kLanes;
  const long long tile = (long long)g * R * kLanes;
  for (int o = tid; o < R * kLanes; o += kThreads)
    bs[o / kLanes][o % kLanes] = __ldg(b + tile + o);
  // this quarter's rows of A2^1..A2^K, lane l: independent of x
  float a2r[K][kJ];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      a2r[k][jj] = ts::load_val<BF16>(
          a2, (((long long)g * K + k) * kLanes + q * kJ + jj) * kLanes + l);
  __syncthreads();
  // the independent half: b_g . A1_g over this quarter's rows
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int jj = 0; jj < kJ; ++jj) {
    const int j = q * kJ + jj;
    const float a = ts::load_val<BF16>(a1, ((long long)g * kLanes + j) *
                                               kLanes + l);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(bs[r][j], a, acc[r]);
  }
  // the chain: tiles 0..g-1 are final once g of them are done
  ts::wait_geq(sync + 1, g);
  for (int o = tid; o < K * R * kLanes; o += kThreads) {
    const int k = o / (R * kLanes), rem = o % (R * kLanes);
    const long long gg = (long long)g - 1 - k;
    hs[k][rem / kLanes][rem % kLanes] =
        gg >= 0 ? ts::ld_x(x, gg * R * kLanes + rem) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(-hs[k][r][q * kJ + jj], a2r[k][jj], acc[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) part[r][q][l] = acc[r];
  __syncthreads();
  for (int o = tid; o < R * kLanes; o += kThreads) {
    const int r = o / kLanes, ll = o % kLanes;
    x[tile + o] = part[r][0][ll] + part[r][1][ll] + part[r][2][ll] +
                  part[r][3][ll];
  }
  ts::signal_add(sync + 1, 1);
}

// sync[0]: ticket, sync[1]: (wave, tile) steps committed, sync[2 + t]:
// u of tile t published.  x (S*128) fp32, zeroed; u (S*128) scratch.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    binv(const void* __restrict__ a1, const uint8_t* __restrict__ s_idx,
         const void* __restrict__ vals, const int32_t* __restrict__ slab_win,
         const int32_t* __restrict__ slab_tloc,
         const int32_t* __restrict__ wave_ptr, const float* __restrict__ b,
         float* x, float* u, int* sync, int m, int group, int S) {
  __shared__ float us[8 * kLanes];
  __shared__ float part[kQuarters][kLanes];
  __shared__ int match[kThreads];
  __shared__ int n_match;
  const int t = ts::draw_ticket(sync);
  const int i = t / m, p = t % m;
  const int tid = threadIdx.x, q = tid / kLanes, l = tid % kLanes;
  const long long N = (long long)S * kLanes;
  const long long B = (long long)m * kLanes;
  const long long tile = (long long)i * m + p;
  // every earlier wave committed: i*m steps done
  ts::wait_geq(sync + 1, i * m);
  // the wave's slabs of tile p: the block scans 512 slab tiles at a time
  // and lists the matches in shared memory (in any order), then gathers
  // them with independent loads
  float acc = 0.f;
  const long long s0 = (long long)__ldg(wave_ptr + i) * group;
  const long long s1 = (long long)__ldg(wave_ptr + i + 1) * group;
  for (long long c0 = s0; c0 < s1; c0 += kThreads) {
    if (tid == 0) n_match = 0;
    __syncthreads();
    const long long s = c0 + tid;
    if (s < s1 && __ldg(slab_tloc + s) == p)
      match[atomicAdd(&n_match, 1)] = (int)(s - c0);
    __syncthreads();
    const int nm = n_match;
#pragma unroll 4
    for (int k = 0; k < nm; ++k) {
      const long long ss = c0 + match[k];
      acc += ts::slab_pair<BF16>(
          s_idx, vals, ss, (long long)__ldg(slab_win + ss) * ts::kWindow,
          2 * q, l, x, N);
    }
    __syncthreads();
  }
  const float gathered = ts::quarter_sum(part, q, l, acc);
  if (q == 0) u[tile * kLanes + l] = __ldg(b + tile * kLanes + l) - gathered;
  ts::signal_add(sync + 2 + tile, 1);
  // u of tiles 0..p of this wave (the lower tickets of the wave)
  if (tid == 0) {
    for (int pp = 0; pp < p; ++pp)
      while (ts::ld_acquire(sync + 2 + (long long)i * m + pp) < 1) {
      }
    __threadfence();
  }
  __syncthreads();
  for (int o = tid; o < (p + 1) * kLanes; o += kThreads)
    us[o] = ts::ld_x(u, (long long)i * B + o);
  __syncthreads();
  // x_p = sum over rows jj of blocks 0..p of u[jj] * a1[i][jj][p*128 + l];
  // quarter q takes rows jj = q mod 4, four accumulators deep so that 32
  // row loads a thread are in flight ((p+1)*128 is a multiple of 16)
  float xs4[4] = {0.f, 0.f, 0.f, 0.f};
  const long long col = (long long)i * B * B + (long long)p * kLanes + l;
#pragma unroll 8
  for (int jj = q; jj < (p + 1) * kLanes; jj += 4 * kQuarters)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int j = jj + h * kQuarters;
      xs4[h] = fmaf(us[j], ts::load_val<BF16>(a1, col + j * B), xs4[h]);
    }
  const float xs = (xs4[0] + xs4[1]) + (xs4[2] + xs4[3]);
  const float xp = ts::quarter_sum(part, q, l, xs);
  if (q == 0) x[tile * kLanes + l] = xp;
  ts::signal_add(sync + 1, 1);
}

template <int R, int K>
cudaError_t launch_chain(bool bf16, const void* a1, const void* a2,
                         const float* b, float* x, int* sync, int S,
                         cudaStream_t st) {
  if (bf16)
    chain<R, K, true><<<S, kThreads, 0, st>>>(a1, a2, b, x, sync, S);
  else
    chain<R, K, false><<<S, kThreads, 0, st>>>(a1, a2, b, x, sync, S);
  return cudaGetLastError();
}

template <int R>
int chain_entry(const void* a1, const void* a2, const void* b, void* x,
                void* sync, int S, int K, int bf16, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const auto bb = static_cast<const float*>(b);
  const auto xx = static_cast<float*>(x);
  const auto sy = static_cast<int*>(sync);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch_chain<R, 1>(bf16, a1, a2, bb, xx, sy, S, st);
    case 2: return (int)launch_chain<R, 2>(bf16, a1, a2, bb, xx, sy, S, st);
    case 3: return (int)launch_chain<R, 3>(bf16, a1, a2, bb, xx, sy, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a1 (S, 128, 128), a2 (S, K, 128, 128), fp32 or bf16; b, x (S*128) fp32;
// sync: 2 zeroed ints.  Returns the cudaError_t of the launch.
extern "C" int trisolve_chain(const void* a1, const void* a2, const void* b,
                              void* x, void* sync, int S, int K, int bf16,
                              void* stream) {
  return chain_entry<1>(a1, a2, b, x, sync, S, K, bf16, stream);
}

// As trisolve_chain for one 8-RHS pane: b, x (S*8*128) fp32, tile-major.
extern "C" int trisolve_chain_mm(const void* a1, const void* a2,
                                 const void* b, void* x, void* sync, int S,
                                 int K, int bf16, void* stream) {
  return chain_entry<8>(a1, a2, b, x, sync, S, K, bf16, stream);
}

// a1 (n_waves, 128m, 128m); s_idx/vals (n_groups*group slabs of 8x128);
// slab_win, slab_tloc (n_groups*group,) int32; wave_ptr (n_waves+1,)
// int32, the first group of each wave; b, x (zeroed), u (S*128) fp32;
// sync: 2 + n_waves*m zeroed ints.
extern "C" int trisolve_binv(const void* a1, const void* s_idx,
                             const void* vals, const void* slab_win,
                             const void* slab_tloc, const void* wave_ptr,
                             const void* b, void* x, void* u, void* sync,
                             int n_waves, int m, int group, int S, int bf16,
                             void* stream) {
  if (n_waves <= 0 || m <= 0 || 8 % m || group <= 0 || S < n_waves * m)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s8 = static_cast<const uint8_t*>(s_idx);
  const auto sw = static_cast<const int32_t*>(slab_win);
  const auto tl = static_cast<const int32_t*>(slab_tloc);
  const auto wp = static_cast<const int32_t*>(wave_ptr);
  const auto bb = static_cast<const float*>(b);
  const auto xx = static_cast<float*>(x);
  const auto uu = static_cast<float*>(u);
  const auto sy = static_cast<int*>(sync);
  const unsigned steps = (unsigned)(n_waves * m);
  if (bf16)
    binv<true><<<steps, kThreads, 0, st>>>(a1, s8, vals, sw, tl, wp, bb, xx,
                                           uu, sy, m, group, S);
  else
    binv<false><<<steps, kThreads, 0, st>>>(a1, s8, vals, sw, tl, wp, bb, xx,
                                            uu, sy, m, group, S);
  return (int)cudaGetLastError();
}
