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
//  * chain: one thread-block cluster of C blocks (2, 4, 8 or 16; the
//    wrapper's default 16, a non-portable size) walks the whole chain,
//    block c owning output lanes [c*L, (c+1)*L), L = 128 / C, of every
//    tile.  The first design (one
//    block a tile, drawn from a ticket) paid each step two L2 round trips
//    (a done-counter, then x), a gpu-scope fence and four block barriers,
//    ~2 us.  Here a step's critical path is:
//      - wait on the block's own mbarrier until every block's slice of
//        x_{g-1} has landed in its shared memory;
//      - x_{g-1} . A2^1_g for R right-hand sides over the block's lanes
//        (A2^1_g already in registers), 256 threads each a run of j;
//      - the j partials summed (warp shuffles, then one barrier of the
//        256 threads through shared memory, in a fixed order, so x's bits
//        repeat from run to run);
//      - x_g's slice stored into every block's shared memory by st.async,
//        which reports its bytes to that block's mbarrier.
//    No global counter, fence or L2 read remains on it; x goes to global
//    memory off it.  Everything else runs on the block's other 256
//    threads (the prep) a step ahead, into the second half of the
//    partial sums: b_t . A1_t and the k >= 2 terms x_{t-k} . A2^k_t (their
//    x is final once x_{t-2} has landed).  The hop threads load A2^1_{t}
//    into registers right after they send x_{t-1}.  A producer warp
//    streams the block's column slices (128 rows x L lanes, 2-D TMA boxes)
//    of A2^1..A2^K (and A1, and b's tile by a 1-D copy) for the tiles ahead
//    through a ring of stages, so the walk never waits on HBM.  The grid
//    is the one cluster: no block waits on a block that may not be
//    resident.  fp32 FMA on CUDA cores (no TF32: the TPU kernel runs
//    Precision.HIGHEST); bf16 planes are widened to fp32 on load.  One
//    launch a solve (a pane).
//  * binv: the first design (one block a (wave, tile)) did all of a
//    wave's work on the chain's critical path: it waited for the previous
//    wave, scanned the wave's slab list, gathered its tile's slabs with
//    dependent loads, exchanged u and only then streamed its (p+1) x 64 KB
//    column block of a1 through one SM: 54-62 us a wave on the scattered
//    factor, ~34 of them the gather and ~17 the a1 stream (ablations of
//    that design), where only 3 % of the slabs read the previous wave's
//    window and none of a1 depends on x.  Here the solve is a work list
//    built on the host (kernels/trisolve_waves.py _binv_items_build), one
//    item a block in ticket order (trisolve.cuh):
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
#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "bulk.cuh"
#include "trisolve.cuh"

namespace {

using ts::kLanes;
using ts::kQuarters;
using ts::kThreads;
using bulk::arrive;
constexpr int kJ = kLanes / kQuarters;  // rows of a tile per quarter

// ---------------------------------------------------------------------------
// the cluster chain
// ---------------------------------------------------------------------------

constexpr int kCons = 256;               // the hop's threads a block
constexpr int kConsWarps = kCons / 32;
constexpr int kBlock = 2 * kCons + 32;   // the prep's as many, a producer
constexpr int kSlots = 4;                // x tiles kept: K <= 3 read, 1 landing
constexpr int kMaxStages = 4;
constexpr size_t kSmemMax = 232448;      // a block's shared memory, sm_90
constexpr uint32_t kBarBytes = 128;      // the barriers' region

// The layout of a block's dynamic shared memory, shared by the kernel and
// its launch: barriers, x slots (kSlots, R, 128) fp32, the partial sums
// (2 tiles, 2 NP: the hop's, then the prep's, R, L) fp32, then the ring's
// stages.  A stage holds the column slices of A2^1..A2^K and A1 (128 x L
// each) and b's tile (R, 128) fp32, all brought by the stage's copies.
template <int R, int K, int L, bool BF16>
struct Layout {
  static constexpr int NG = kCons / L;       // runs of j a tile
  static constexpr int JPT = kLanes / NG;    // j a thread
  static constexpr int NP = L >= 32 ? NG : kConsWarps;  // partials a lane
  static constexpr uint32_t kSlice = kLanes * L * (BF16 ? 2 : 4);
  static constexpr uint32_t kXs = kBarBytes;
  static constexpr uint32_t kRed = kXs + kSlots * R * kLanes * 4;
  static constexpr uint32_t kRing =
      (kRed + 4 * NP * R * L * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t kTile = R * kLanes * 4;  // b's or x's tile
  static constexpr uint32_t kStage = (K + 1) * kSlice + kTile;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of the cluster; shared-memory writes before it are seen
// by every block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of the same shared-memory location in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory, reported to its mbarrier.
__device__ __forceinline__ void send4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed; the
// writes that other blocks of the cluster reported to it are seen after.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = bulk::smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (column c0, row c1) of a 2-D tensor map, reported to `bar`.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(bulk::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(bulk::smem_addr(bar))
      : "memory");
}

// The 256 walk threads (named barrier 1; the producer warp never joins).
__device__ __forceinline__ void walk_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCons) : "memory");
}

// A walk thread's state: its lane li, its run of j [j0, j0+JPT), its
// partial sums acc[r] and, in a hop thread, A2^1 of its tile in registers.
template <int R, int K, int L, bool BF16>
struct Walker {
  using Lay = Layout<R, K, L, BF16>;
  using E = typename std::conditional<BF16, uint16_t, float>::type;
  static constexpr int JPT = Lay::JPT;
  unsigned char* sm;
  uint64_t* full;    // [kMaxStages] the stage's copies landed
  uint64_t* empty;   // [kMaxStages] the walk is done with the stage
  uint64_t* xbar;    // [2] a tile's x slices landed (tiles g, g+1 alternate)
  uint64_t* pready;  // [2] the prep's partials of a tile are written
  uint64_t* rfree;   // [2] the senders have read a tile's partials
  float* xs;         // [kSlots][R][128]
  float* red;        // [2][2 NP][R][L]
  int nst, parts, li, j0;
  float acc[R];
  float a1r[JPT];

  __device__ __forceinline__ unsigned char* stage_of(int t) const {
    return sm + Lay::kRing + (t % nst) * Lay::kStage;
  }
  __device__ __forceinline__ const float* x_of(int t) const {
    return xs + (t % kSlots) * R * kLanes;
  }
  __device__ __forceinline__ float* red_of(int t) const {
    return red + (t & 1) * 2 * Lay::NP * R * L;
  }

  // acc -= x . A over this thread's run of j (A a stage's slice)
  __device__ __forceinline__ void sub_product(const float* x, const E* A) {
#pragma unroll
    for (int m = 0; m < JPT; m += 4) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = widen(A[(j0 + m + i) * L + li]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(x + r * kLanes + j0 + m);
        acc[r] = fmaf(-v.x, a[0], acc[r]);
        acc[r] = fmaf(-v.y, a[1], acc[r]);
        acc[r] = fmaf(-v.z, a[2], acc[r]);
        acc[r] = fmaf(-v.w, a[3], acc[r]);
      }
    }
  }

  // acc summed over the warp's runs of j, written as partial `first` + the
  // warp's (L < 32: one a warp) or the thread's run's (L >= 32) of tile t
  __device__ __forceinline__ void put_partial(int t, int first, int tid) {
    float* rb = red_of(t);
    if constexpr (L < 32) {
#pragma unroll
      for (int off = L; off < 32; off *= 2)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if ((tid & 31) < L)
#pragma unroll
        for (int r = 0; r < R; ++r)
          rb[((first + tid / 32) * R + r) * L + li] = acc[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        rb[((first + tid / L) * R + r) * L + li] = acc[r];
    }
  }

  // A prep thread (index pt of kCons): everything of tile t that does not
  // wait on x_{t-1}, b_t . A1_t and the k >= 2
  // terms, as the second NP partials of tile t; it runs while the hop
  // threads walk tile t-1.
  __device__ __forceinline__ void prep(int t, int pt) {
    const int s = t % nst;
    bulk::wait(full + s, (t / nst) & 1);
    if (t >= 2) {  // the senders of tile t-2 are done with its partials
      bulk::wait(rfree + (t & 1), ((t - 2) >> 1) & 1);
      // x_{t-2} has landed; so has x_{t-3} (before this block sent its
      // slice of x_{t-2})
      if (K >= 2) wait_cluster(xbar + (t & 1), ((t - 2) >> 1) & 1);
    }
    const unsigned char* st = stage_of(t);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (parts == 0) {
      const E* A1 = reinterpret_cast<const E*>(st + K * Lay::kSlice);
      const float* bt =
          reinterpret_cast<const float*>(st + (K + 1) * Lay::kSlice);
      sub_product(bt, A1);  // -(b . A1): negated once below
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = -acc[r];
#pragma unroll
      for (int k = 2; k <= K; ++k)
        if (t - k >= 0)
          sub_product(x_of(t - k),
                      reinterpret_cast<const E*>(st + (k - 1) * Lay::kSlice));
    }
    put_partial(t, Lay::NP, pt);
    __syncwarp();
    if ((pt & 31) == 0) {
      arrive(empty + s);
      arrive(pready + (t & 1));
    }
  }

  // A hop thread: A2^1_t into registers, and the stage back.
  __device__ __forceinline__ void load_a1(int t) {
    const int s = t % nst;
    bulk::wait(full + s, (t / nst) & 1);
    const E* A21 = reinterpret_cast<const E*>(stage_of(t));
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) a1r[jj] = widen(A21[(j0 + jj) * L + li]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) arrive(empty + s);
  }

  // The critical part of tile g >= 1: acc = -x_{g-1} . A2^1_g.
  __device__ __forceinline__ void hop_product(int g) {
    const float* xp = x_of(g - 1);
#pragma unroll
    for (int m = 0; m < JPT; m += 4) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(xp + r * kLanes + j0 + m);
        if (parts == 2) {  // ablation: the read alone
          acc[r] += (v.x + v.y) + (v.z + v.w);
        } else {
          acc[r] = fmaf(-v.x, a1r[m], acc[r]);
          acc[r] = fmaf(-v.y, a1r[m + 1], acc[r]);
          acc[r] = fmaf(-v.z, a1r[m + 2], acc[r]);
          acc[r] = fmaf(-v.w, a1r[m + 3], acc[r]);
        }
      }
    }
  }
};

// a1map / a2map: the planes as 2-D (rows, 128) tensor maps, box (128 rows,
// L lanes).  parts (an ablation, not x): 1 the hop alone (no product, no
// x read), 2 the hop and x's read, 0 the solve.  The grid is one cluster.
template <int R, int K, int L, bool BF16>
__global__ void __launch_bounds__(kBlock, 1)
    chain_cluster(const __grid_constant__ CUtensorMap a1map,
                  const __grid_constant__ CUtensorMap a2map,
                  const float* __restrict__ b, float* __restrict__ x,
                  int S, int nst, int parts) {
  using Lay = Layout<R, K, L, BF16>;
  constexpr int C = kLanes / L;
  extern __shared__ __align__(1024) unsigned char sm[];
  Walker<R, K, L, BF16> w;
  w.sm = sm;
  w.full = reinterpret_cast<uint64_t*>(sm);
  w.empty = w.full + kMaxStages;
  w.xbar = w.empty + kMaxStages;
  w.pready = w.xbar + 2;
  w.rfree = w.pready + 2;
  w.xs = reinterpret_cast<float*>(sm + Lay::kXs);
  w.red = reinterpret_cast<float*>(sm + Lay::kRed);
  w.nst = nst;
  w.parts = parts;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t c = cluster_rank();
  constexpr uint32_t kXTx = R * kLanes * 4;  // bytes of x a tile
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      bulk::init(w.full + s, 1);
      bulk::init(w.empty + s, 2 * kConsWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bulk::init(w.xbar + i, 1);
      bulk::init(w.pready + i, kConsWarps);
      bulk::init(w.rfree + i, R);  // the sender warps
    }
    bulk::fence_init();
    bulk::expect_tx(w.xbar, kXTx);  // tile 0
    if (S > 1) bulk::expect_tx(w.xbar + 1, kXTx);
  }
  cluster_sync();

  if (warp == 2 * kConsWarps) {  // the producer
    for (int t = 0; t < S; ++t) {
      const int s = t % nst;
      if (t >= nst) bulk::wait(w.empty + s, ((t / nst) - 1) & 1);
      unsigned char* st = w.stage_of(t);
      if (lane == 0) {
        bulk::expect_tx(w.full + s, Lay::kStage);
        for (int k = 0; k < K; ++k)
          load_box(st + k * Lay::kSlice, &a2map, c * L, (t * K + k) * kLanes,
                   w.full + s);
        load_box(st + K * Lay::kSlice, &a1map, c * L, t * kLanes, w.full + s);
        bulk::load(st + (K + 1) * Lay::kSlice, b + (long long)t * R * kLanes,
                   Lay::kTile, w.full + s);
      }
      __syncwarp();
    }
  } else if (warp >= kConsWarps) {  // the prep
    const int pt = tid - kCons;
    w.li = pt % L;
    w.j0 = (pt / L) * Lay::JPT;
    for (int t = 0; t < S; ++t) w.prep(t, pt);
  } else {  // the hop
    w.li = tid % L;
    w.j0 = (tid / L) * Lay::JPT;
    // the send: thread (o, dst) of the first 32R carries the sum of lanes
    // 4q..4q+3 of row r of this block's slice to block dst
    const bool sender = tid < 32 * R;
    const int o = tid / C, dst = tid % C;
    const int r_o = o / (L / 4), q_o = o % (L / 4);
    const uint32_t xs_dst = map_rank(bulk::smem_addr(w.xs), dst);
    const uint32_t bar_dst = map_rank(bulk::smem_addr(w.xbar), dst);
    const uint32_t lane_off = (r_o * kLanes + c * L + q_o * 4) * 4;
    w.load_a1(0);
    for (int g = 0; g < S; ++g) {
#pragma unroll
      for (int r = 0; r < R; ++r) w.acc[r] = 0.f;
      if (g > 0) {
        wait_cluster(w.xbar + ((g - 1) & 1), ((g - 1) >> 1) & 1);
        if (tid == 0 && g + 1 < S) bulk::expect_tx(w.xbar + ((g + 1) & 1), kXTx);
        if (parts != 1) w.hop_product(g);
      }
      w.put_partial(g, 0, tid);
      walk_barrier();
      if (sender) {
        // the prep's partials of tile g, then all 2 NP in a fixed order
        bulk::wait(w.pready + (g & 1), (g >> 1) & 1);
        const float* rb = w.red_of(g);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int p = 0; p < 2 * Lay::NP; ++p) {
          const float4 v = *reinterpret_cast<const float4*>(
              rb + (p * R + r_o) * L + q_o * 4);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        send4(xs_dst + (g % kSlots) * kXTx + lane_off, sum,
              bar_dst + (g & 1) * 8);
        if (dst == (int)c)
          *reinterpret_cast<float4*>(x + ((long long)g * R + r_o) * kLanes +
                                     c * L + q_o * 4) = sum;
        __syncwarp();
        if (lane == 0) arrive(w.rfree + (g & 1));
      }
      if (g + 1 < S) w.load_a1(g + 1);
    }
    // every block's last slice has landed here: nothing more arrives
    wait_cluster(w.xbar + ((S - 1) & 1), ((S - 1) >> 1) & 1);
  }
  cluster_sync();
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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A plane (rows, 128) as a tensor map with boxes of 128 rows x L lanes.
cudaError_t plane_map(CUtensorMap* map, const void* base, bool bf16,
                      long long rows, int L) {
  const EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)kLanes, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)kLanes * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)L, (cuuint32_t)kLanes};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dim, stride, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct ChainArgs {
  const void *a1, *a2;
  const float* b;
  float* x;
  int S, stages, parts;
  cudaStream_t st;
};

template <int R, int K, int L, bool BF16>
cudaError_t launch_cluster(const ChainArgs& a) {
  using Lay = Layout<R, K, L, BF16>;
  constexpr int C = kLanes / L;
  // the ring stages that fit a block's shared memory
  const int fit = (int)((kSmemMax - Lay::kRing) / Lay::kStage);
  const int nst = a.stages ? a.stages : std::min(fit, kMaxStages);
  if (nst < 1 || nst > kMaxStages || nst > fit) return cudaErrorInvalidValue;
  const size_t smem = Lay::kRing + (size_t)nst * Lay::kStage;
  CUtensorMap m1, m2;
  cudaError_t e = plane_map(&m1, a.a1, BF16, (long long)a.S * kLanes, L);
  if (e != cudaSuccess) return e;
  e = plane_map(&m2, a.a2, BF16, (long long)a.S * K * kLanes, L);
  if (e != cudaSuccess) return e;
  auto kern = chain_cluster<R, K, L, BF16>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the function's attributes and the check that a cluster fits, once a
  // shared-memory size (a host thread's worth of calls repeats them)
  static thread_local size_t ready_smem = 0;
  if (ready_smem != smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess && C > 8)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int clusters = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    ready_smem = smem;
  }
  e = cudaLaunchKernelEx(&cfg, kern, m1, m2, a.b, a.x, a.S, nst, a.parts);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int R, int L>
cudaError_t cluster_k(const ChainArgs& a, int K, bool bf16) {
  switch (K) {
    case 1:
      return bf16 ? launch_cluster<R, 1, L, true>(a)
                  : launch_cluster<R, 1, L, false>(a);
    case 2:
      return bf16 ? launch_cluster<R, 2, L, true>(a)
                  : launch_cluster<R, 2, L, false>(a);
    case 3:
      return bf16 ? launch_cluster<R, 3, L, true>(a)
                  : launch_cluster<R, 3, L, false>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int R>
int chain_entry(const void* a1, const void* a2, const void* b, void* x, int S,
                int K, int bf16, int cluster, int stages, int parts,
                void* stream) {
  if (S <= 0 || parts < 0 || parts > 2) return (int)cudaErrorInvalidValue;
  const ChainArgs a{a1, a2, static_cast<const float*>(b),
                    static_cast<float*>(x), S, stages, parts,
                    static_cast<cudaStream_t>(stream)};
  switch (cluster) {
    case 2: return (int)cluster_k<R, 64>(a, K, bf16);
    case 4: return (int)cluster_k<R, 32>(a, K, bf16);
    case 8: return (int)cluster_k<R, 16>(a, K, bf16);
    case 16: return (int)cluster_k<R, 8>(a, K, bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a1 (S, 128, 128), a2 (S, K, 128, 128), fp32 or bf16; b, x (S*128) fp32;
// cluster 2, 4, 8 or 16 blocks; stages of the ring (0: as many as fit, at
// most 4); parts an ablation (0: the solve).  Returns the cudaError_t of
// the launch.
extern "C" int trisolve_chain(const void* a1, const void* a2, const void* b,
                              void* x, int S, int K, int bf16, int cluster,
                              int stages, int parts, void* stream) {
  return chain_entry<1>(a1, a2, b, x, S, K, bf16, cluster, stages, parts,
                        stream);
}

// As trisolve_chain for one 8-RHS pane: b, x (S*8*128) fp32, tile-major.
extern "C" int trisolve_chain_mm(const void* a1, const void* a2,
                                 const void* b, void* x, int S, int K,
                                 int bf16, int cluster, int stages, int parts,
                                 void* stream) {
  return chain_entry<8>(a1, a2, b, x, S, K, bf16, cluster, stages, parts,
                        stream);
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
