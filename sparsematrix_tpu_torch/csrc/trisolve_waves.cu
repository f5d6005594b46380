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
//  * binv: the first design (one block a (wave, tile)) did all of a
//    wave's work on the chain's critical path: it waited for the previous
//    wave, scanned the wave's slab list, gathered its tile's slabs with
//    dependent loads, exchanged u and only then streamed its (p+1) x 64 KB
//    column block of a1 through one SM: 54-62 us a wave on the scattered
//    factor, ~34 of them the gather and ~17 the a1 stream (ablations of
//    that design), where only 3 % of the slabs read the previous wave's
//    window and none of a1 depends on x.  Here
//    the solve is a work list built on the host (kernels/trisolve_waves.py
//    _binv_items_build), one item a block in ticket order:
//      - a gather adds a run of one tile's slabs into that tile's fp32
//        accumulator (atomicAdd) as soon as the waves its windows read are
//        committed, so a slab of an old window runs waves ahead of the
//        front; it loads its first slabs' planes before it waits;
//      - a product (wave i, blocks q <= p) loads its 128 x 128 block of
//        a1 into registers before it waits (the resident items prefetch
//        a1 for the waves ahead); once tile q's gathers are done and wave
//        i - 1 is committed it gathers tile q's few late slabs (those of
//        wave i - 1's window, folded into each of the tile's products),
//        forms u_q = b_q - acc_q - late itself and adds u_q . a1[i][q, p]
//        into x_p (atomicAdd); blocks q > p are exact zeros and have no
//        item.
//    A wave commits when its m(m+1)/2 products are done, so the critical
//    path of a wave is one hop: the commit signal of wave i - 1, one L2
//    read of its x for the late slabs, and 32 FMAs a thread on a block
//    already on chip.
//    Sums are added in an order that varies from run to run (atomics).
//    One launch a solve.
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

// binv's work list (kernels/trisolve_waves.py _binv_items_build): 12
// ints an item.
enum Item {
  kKind, kTile, kTileQ, kWave, kSlabA, kSlabB, kWaitLo, kWaitHi, kTarget,
  kWavesLo, kWavesHi, kSignal
};
constexpr int kProduct = 0;
constexpr int kPre = 2;  // slabs whose planes load before the item waits

// Waits until every counter of cnt[lo, hi) reaches target and every one
// of cnt[wlo, whi) reaches wtarget (a thread a counter); afterwards every
// thread of the block sees the writes that the items which raised them
// made before.  A short sleep between polls eases the L2 traffic of the
// few hundred resident blocks that spin.
__device__ __forceinline__ void wait_all(const int* cnt, int lo, int hi,
                                         int target, int wlo, int whi,
                                         int wtarget) {
  bool polled = false;
  for (int c = lo + threadIdx.x; c < hi; c += blockDim.x, polled = true)
    while (ts::ld_acquire(cnt + c) < target) __nanosleep(64);
  for (int c = wlo + threadIdx.x; c < whi; c += blockDim.x, polled = true)
    while (ts::ld_acquire(cnt + c) < wtarget) __nanosleep(64);
  if (polled) __threadfence();
  __syncthreads();
}

// cnt[0]: ticket, then the counters of the items' waits.  x (S*128) fp32
// and acc (S*128) fp32 zeroed.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
    binv(const int4* __restrict__ items, const void* __restrict__ a1,
         const uint8_t* __restrict__ s_idx, const void* __restrict__ vals,
         const int32_t* __restrict__ slab_win, const float* __restrict__ b,
         float* x, float* acc, int* cnt, int m, int S) {
  __shared__ float us[kLanes];
  __shared__ float part[kQuarters][kLanes];
  const int t = ts::draw_ticket(cnt);
  int it[12];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int4 v = __ldg(items + 3 * t + k);
    it[4 * k] = v.x;
    it[4 * k + 1] = v.y;
    it[4 * k + 2] = v.z;
    it[4 * k + 3] = v.w;
  }
  const int tid = threadIdx.x, q = tid / kLanes, l = tid % kLanes;
  const bool product = it[kKind] == kProduct;
  const long long tile = it[kTile], tq = it[kTileQ], i = it[kWave];
  const long long B = (long long)m * kLanes;
  const long long N = (long long)S * kLanes;
  // a product's block (qb, p) of a1[i]: this thread's 32 rows of column l
  float a[kJ];
  if (product) {
    const long long at = i * B * B + ((tq - i * m) * kLanes + q * kJ) * B +
                         (tile - i * m) * kLanes + l;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      a[jj] = ts::load_val<BF16>(a1, at + jj * B);
  }
  // slabs [sa, sb) of one tile (a gather's own, or a product's folded
  // late slabs); this thread takes sublanes 2q, 2q+1 at lane l of each
  const long long sa = it[kSlabA], sb = it[kSlabB];
  float v[kPre][2];
  int col[kPre][2];
#pragma unroll
  for (int k = 0; k < kPre; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[k][e] = 0.f;
      col[k][e] = 0;
      if (sa + k < sb) {
        const int u = 2 * q + e;
        const long long o = (sa + k) * ts::kSlab + u * kLanes + l;
        v[k][e] = ts::load_val<BF16>(vals, o);
        col[k][e] = (int)((long long)__ldg(slab_win + sa + k) * ts::kWindow +
                          u * kLanes + (__ldg(s_idx + o) & 127));
      }
    }
  wait_all(cnt, it[kWaitLo], it[kWaitHi], it[kTarget], it[kWavesLo],
           it[kWavesHi], m * (m + 1) / 2);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kPre; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (v[k][e] != 0.f && col[k][e] < N)
        sum = fmaf(v[k][e], ts::ld_x(x, col[k][e]), sum);
#pragma unroll 4
  for (long long sl = sa + kPre; sl < sb; ++sl)
    sum += ts::slab_pair<BF16>(
        s_idx, vals, sl, (long long)__ldg(slab_win + sl) * ts::kWindow,
        2 * q, l, x, N);
  const float g = ts::quarter_sum(part, q, l, sum);
  if (product) {
    // u_q = b_q - acc_q - (the folded slabs), then x_p += u_q . a1[q, p]
    if (q == 0)
      us[l] = __ldg(b + tq * kLanes + l) - ts::ld_x(acc, tq * kLanes + l) - g;
    __syncthreads();
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < kJ; jj += 2) {
      s0 = fmaf(us[q * kJ + jj], a[jj], s0);
      s1 = fmaf(us[q * kJ + jj + 1], a[jj + 1], s1);
    }
    const float xp = ts::quarter_sum(part, q, l, s0 + s1);
    if (q == 0) atomicAdd(x + tile * kLanes + l, xp);
  } else if (q == 0 && g != 0.f) {
    atomicAdd(acc + tile * kLanes + l, g);
  }
  ts::signal_add(cnt + it[kSignal], 1);
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

// items (n_items, 12) int32 in ticket order; a1 (n_waves, 128m, 128m);
// s_idx/vals (n_groups*group slabs of 8x128); slab_win (n_groups*group,)
// int32; b, x (zeroed), acc (zeroed) (S*128) fp32; cnt (1 + n_waves*(1 +
// m),) zeroed ints.  Returns the cudaError_t of the launch.
extern "C" int trisolve_binv(const void* items, int n_items, const void* a1,
                             const void* s_idx, const void* vals,
                             const void* slab_win, const void* b, void* x,
                             void* acc, void* cnt, int m, int S, int bf16,
                             void* stream) {
  if (n_items <= 0 || m <= 0 || 8 % m || S <= 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const int4*>(items);
  const auto s8 = static_cast<const uint8_t*>(s_idx);
  const auto sw = static_cast<const int32_t*>(slab_win);
  const auto bb = static_cast<const float*>(b);
  const auto xx = static_cast<float*>(x);
  const auto aa = static_cast<float*>(acc);
  const auto cc = static_cast<int*>(cnt);
  if (bf16)
    binv<true><<<(unsigned)n_items, kThreads, 0, st>>>(in, a1, s8, vals, sw,
                                                       bb, xx, aa, cc, m, S);
  else
    binv<false><<<(unsigned)n_items, kThreads, 0, st>>>(in, a1, s8, vals, sw,
                                                        bb, xx, aa, cc, m, S);
  return (int)cudaGetLastError();
}
