// Dual-gather SpMM, Y = A @ X over a dual-gather pack, X (cols, k) and Y
// (rows, k) row-major fp32.
//
// Replaces two Pallas kernels of sparsematrix_tpu/kernels/spmm_dualgather.py
// with one kernel, `walk` below (C entry spmm_dualgather_walk):
//   * _dg_mm_kernel (pallas_call at :247): a k_tiles = 1 pack walked per
//     right-hand-side column (row 14, launch counter spmm_dualgather);
//   * _dg_sb_mm_kernel (pallas_call at :127): the same over a superblock
//     pack, whose slab's tile is its superblock's tile * k_tiles +
//     slab_tloc and whose idxA may hold two slabs' nibbles a byte and pick
//     one of a slab's two windows by bit 3 (row 13, launch counter
//     spmm_dualgather_sb).  The Pallas kernel's commit groups order its
//     writes of a superblock's output; here every warp adds into a zeroed
//     Y, so they have no counterpart.
//
// What bounds them: at k = 32 the slab planes (~6 bytes a slot) are read
// once per 32 columns, so the bytes that must move are those of X and Y.
//
// The first design (dg_spmm, rows 13 and 14 until the walk replaced it:
// row 14 in one step, row 13 in the next) walked contiguous slabs, a
// thread a row lane, and read a 128-byte X row from L2 for every slot
// whose column was in range, padding slots and whole padding slabs
// included: 4.44 GB on the XL CSR at k = 32 where 2.13 GB sit under a
// value, at about L2's rate; the X rows of one 1024-column window were
// read ~4 times each per (tile, window), and each sublane's column waited
// on idxB -> idxA.  The walk takes each of these away in a step of its own
// (a template argument, so each is measured alone):
//   1. the warp ballots its sublane's nonzero values and reads X only
//      under them: every slot's value and column still come by shuffle,
//      and the load is predicated on the ballot's bit, so the accumulators
//      stay in registers (a first cut that put the shuffles and the FMA
//      under the bit's branch took 1.77 ms on the XL CSR at k = 32, 2x the
//      first design; this one 1.23); an empty sublane is skipped; the
//      slabs that hold no value are not walked
//      (kernels/spmm_dualgather.py slab_walk, built once a pack and state
//      of its values); the rest keep the pack's order, about 16 a block
//      of 4 warps;
//   2. the slabs are walked window by window: a block of four teams of 4
//      warps takes slabs of one window (teams take contiguous shares) and
//      first stages the window's 1024 rows of X's current 32-column panel
//      in shared memory by cp.async (128 KB at k >= 32), from which the
//      gathers read; on a two-window pack, pair by pair: both windows of
//      the pair in a 16-column panel (walk_pair below);
//   3. each warp streams its slabs' planes (its 32 lanes' values and idxB,
//      and idxA whole) one slab ahead into a ring in shared memory by
//      cp.async, so no global load sits in front of a sublane's gathers.
// Warp w of a team owns the row lanes 32w..32w+31 and keeps their 32 sums
// of lane j's column in registers; Y is zeroed by the wrapper and each
// warp adds its 32 x 32 block by atomicAdd where the item's tile changes
// (every tile takes several windows), so the fp32 order of Y's sums varies
// from run to run.  Rows >= rows are dropped; X rows past cols read 0.  A
// value of 0 reads nothing, so an inf or NaN of X under a padding slot
// gives 0 (the plain version: NaN).
#include "bulk.cuh"
#include "dualgather.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// the walk (rows 13 and 14)
// ---------------------------------------------------------------------------

constexpr int kTeamWarps = 4;  // a team covers a slab's 128 row lanes
constexpr int kMaxTeams = 4;
constexpr int kRing = 2;       // slab stages a warp (step 3)
constexpr int kPanel = 32;     // columns of X a pass
constexpr int kSmemMax = 232448;

// A warp's stage: its 32 lanes' values and idxB of each sublane, and idxA
// whole (a slot names any lane's chunk).
template <bool BF16>
struct WarpStage {
  static constexpr int kVal = dg::kSub * 32 * (BF16 ? 2 : 4);
  static constexpr int kIdxB = dg::kSub * 32;
  static constexpr int kIdxA = dg::kSub * dg::kLanes;
  static constexpr int kBytes = kVal + kIdxB + kIdxA;
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   bulk::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 bytes (any float of X's rows), the cp.async of a ragged panel
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   bulk::smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp wq's planes of slab s into its stage `st` (16-byte copies); a
// nibble pack's idxA plane is slab s / 2's (both slabs' nibbles).
template <bool BF16, bool NIBBLE>
__device__ __forceinline__ void fetch_slab(unsigned char* st,
                                           const dg::Pack& p, long long s,
                                           int wq, int lane) {
  using WS = WarpStage<BF16>;
  constexpr int vb = BF16 ? 2 : 4;
  constexpr int per_u = 32 * vb / 16;  // value copies a sublane
  const long long base = s * dg::kSlab;
  const char* vals = static_cast<const char*>(p.vals);
  for (int c = lane; c < dg::kSub * per_u; c += 32)
    cp16(st + c * 16, vals + (base + (c / per_u) * dg::kLanes + wq * 32) * vb +
                          (c % per_u) * 16);
  if (lane < 2 * dg::kSub)
    cp16(st + WS::kVal + lane * 16,
         p.idxB + base + (lane / 2) * dg::kLanes + wq * 32 + (lane % 2) * 16);
  const long long abase = (NIBBLE ? s >> 1 : s) * dg::kSlab;
  for (int c = lane; c < dg::kSub * 8; c += 32)
    cp16(st + WS::kVal + WS::kIdxB + c * 16, p.idxA + abase + c * 16);
}

// items (n_items) int4 (slab, tile, window, 0): the slabs that hold a
// value, tile the slab's whole tile (a superblock's tile * k_tiles +
// slab_tloc), window the slab's slab_win word (on a two-window pack the
// pair wa | wb << 16); part_ptr: block b's team q walks items
// [part_ptr[b*T+q], part_ptr[b*T+q+1]).  STEP 1: one team a block, X from
// L2; 2: four teams, X's window staged (every item of a block reads one
// window); 3: also the planes streamed.  A two-window pack staged takes
// walk_pair below.
template <bool BF16, int STEP, bool NIBBLE, bool TWO_WIN>
__global__ void __launch_bounds__(kMaxTeams * kTeamWarps * 32, 1)
    walk(dg::Pack p, const int4* __restrict__ items,
         const int* __restrict__ part_ptr, const float* __restrict__ X,
         float* __restrict__ Y, int k) {
  constexpr bool STAGE = STEP >= 2, STREAM = STEP >= 3;
  static_assert(!(TWO_WIN && STAGE), "a staged two-window walk is walk_pair");
  constexpr int T = STAGE ? kMaxTeams : 1;
  using WS = WarpStage<BF16>;
  extern __shared__ __align__(128) unsigned char sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp % kTeamWarps;  // the warp within its team
  const int l = wq * 32 + lane;      // the row lane this thread decodes
  const int b0 = __ldg(part_ptr + blockIdx.x * T);
  if (b0 == __ldg(part_ptr + (blockIdx.x + 1) * T)) return;  // no slab
  const int i0 = __ldg(part_ptr + blockIdx.x * T + warp / kTeamWarps);
  const int i1 = __ldg(part_ptr + blockIdx.x * T + warp / kTeamWarps + 1);
  const int kp_max = k < kPanel ? k : kPanel;
  float* xs = reinterpret_cast<float*>(sm);  // [1024][kp] (STAGE)
  unsigned char* ring = sm + (STAGE ? dg::kWindow * kp_max * 4 : 0) +
                        warp * kRing * WS::kBytes;  // (STREAM)
  const long long r0 = STAGE ? (long long)__ldg(&items[b0].z) * dg::kWindow
                             : 0;
  for (int j0 = 0; j0 < k; j0 += kPanel) {
    const int kp = k - j0 < kPanel ? k - j0 : kPanel;
    const bool jok = lane < kp;
    if (STAGE) {
      // the window's rows of the panel by cp.async, 16 bytes a copy where
      // the rows allow it; rows past cols read 0
      if (j0 > 0) __syncthreads();  // every team is done with the panel
      if (k % 4 == 0 && kp % 4 == 0) {
        const int q4 = kp / 4;
        for (int e = threadIdx.x; e < dg::kWindow * q4; e += blockDim.x) {
          const int r = e / q4, cc = (e - r * q4) * 4;
          float* dst = xs + r * kp + cc;
          if (r0 + r < p.cols)
            cp16(dst, X + (r0 + r) * k + j0 + cc);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int e = threadIdx.x; e < dg::kWindow * kp; e += blockDim.x) {
          const int r = e / kp;
          if (r0 + r < p.cols)
            cp4(xs + e, X + (r0 + r) * k + j0 + (e - r * kp));
          else
            xs[e] = 0.f;
        }
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    long long cur = -1;
    auto flush = [&]() {
      if (cur < 0 || !jok) return;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long row = cur * dg::kLanes + wq * 32 + i;
        if (row < p.rows) atomicAdd(Y + row * k + j0 + lane, acc[i]);
      }
    };
    if (STREAM) {
      if (i0 < i1)
        fetch_slab<BF16, NIBBLE>(ring, p, __ldg(&items[i0].x), wq, lane);
      cp_commit();
    }
    for (int it = i0; it < i1; ++it) {
      const int4 item = __ldg(items + it);  // slab, tile, window, 0
      if (item.y != cur) {
        flush();
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        cur = item.y;
      }
      const long long s = item.x;
      const unsigned char* st = ring + ((it - i0) % kRing) * WS::kBytes;
      if (STREAM) {
        if (it + 1 < i1)
          fetch_slab<BF16, NIBBLE>(
              ring + ((it + 1 - i0) % kRing) * WS::kBytes, p,
              __ldg(&items[it + 1].x), wq, lane);
        cp_commit();
        cp_wait<1>();
        __syncwarp();
      }
      const unsigned ww = (unsigned)item.z;
#pragma unroll 2
      for (int u = 0; u < dg::kSub; ++u) {
        float v;
        int cl, ch;
        if (STREAM) {
          v = BF16 ? __uint_as_float(
                         (uint32_t)reinterpret_cast<const uint16_t*>(
                             st)[u * 32 + lane]
                         << 16)
                   : reinterpret_cast<const float*>(st)[u * 32 + lane];
          cl = st[WS::kVal + u * 32 + lane] & 127;
          ch = st[WS::kVal + WS::kIdxB + u * dg::kLanes + cl];
        } else {
          const long long at = s * dg::kSlab + u * dg::kLanes + l;
          v = dg::load_val<BF16>(p.vals, at);
          cl = __ldg(p.idxB + at) & 127;
          ch = __ldg(p.idxA + (NIBBLE ? s >> 1 : s) * dg::kSlab +
                     u * dg::kLanes + cl);
        }
        if (NIBBLE) ch = (ch >> ((s & 1) * 4)) & 15;
        // the column in the staged window (STAGE) or in X (step 1: on a
        // two-window pack, idxA bit 3 picks the pair's second window)
        int cw = (ch & 7) * dg::kLanes + cl;
        if (!STAGE)
          cw += (int)(TWO_WIN ? ((ch & 8) ? ww >> 16 : ww & 0xFFFFu) : ww) *
                dg::kWindow;
        const unsigned nz = __ballot_sync(kFull, v != 0.f);
        if (nz == 0) continue;
        // every slot's value and column by shuffle; X read only under a
        // nonzero value (a load the compiler predicates, so a sublane's
        // loads still go out together)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float vi = __shfl_sync(kFull, v, i);
          const int ci = __shfl_sync(kFull, cw, i);
          const bool on = jok && ((nz >> i) & 1u);
          float xv = 0.f;
          if (STAGE) {
            if (on) xv = xs[ci * kp + lane];
          } else {
            if (on && ci < p.cols) xv = __ldg(X + (long long)ci * k + j0 + lane);
          }
          acc[i] = fmaf(vi, xv, acc[i]);
        }
      }
      if (STREAM) __syncwarp();  // the stage is read before its refill
    }
    flush();
    if (STREAM) cp_wait<0>();
  }
}

// A two-window pack's walk (rows 13, STEP 2 or 3): a block's items share
// one pair of windows, both staged, 1024 rows each, in 16-column panels
// (128 KB), so each slab is walked once for both its windows.  Lane
// (q, j) of warp wq owns the 4 rows 32 wq + 4 q .. + 3 and the 4 columns
// 4 j .. + 3 of the panel: a sublane takes 4 shuffle steps, each a
// 16-byte read of the staged row (8 rows a warp, of the pair's two
// windows by idxA bit 3) for 16 FMAs.  The staged rows are 16 floats
// apart whatever the panel's width; the columns past it hold zeros.
template <bool BF16, int STEP, bool NIBBLE>
__global__ void __launch_bounds__(kMaxTeams * kTeamWarps * 32, 1)
    walk_pair(dg::Pack p, const int4* __restrict__ items,
              const int* __restrict__ part_ptr, const float* __restrict__ X,
              float* __restrict__ Y, int k) {
  constexpr bool STREAM = STEP >= 3;
  constexpr int T = kMaxTeams, KP = kPanel / 2;
  using WS = WarpStage<BF16>;
  extern __shared__ __align__(128) unsigned char sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp % kTeamWarps;  // the warp within its team
  const int l = wq * 32 + lane;      // the row lane this thread decodes
  const int q = lane >> 2, jc = (lane & 3) * 4;  // its rows and columns
  const int b0 = __ldg(part_ptr + blockIdx.x * T);
  if (b0 == __ldg(part_ptr + (blockIdx.x + 1) * T)) return;  // no slab
  const int i0 = __ldg(part_ptr + blockIdx.x * T + warp / kTeamWarps);
  const int i1 = __ldg(part_ptr + blockIdx.x * T + warp / kTeamWarps + 1);
  float* xs = reinterpret_cast<float*>(sm);  // [2 * 1024][16]
  unsigned char* ring = sm + 2 * dg::kWindow * KP * 4 +
                        warp * kRing * WS::kBytes;  // (STREAM)
  const unsigned pair = (unsigned)__ldg(&items[b0].z);
  for (int j0 = 0; j0 < k; j0 += KP) {
    const int kp = k - j0 < KP ? k - j0 : KP;
    // both windows' rows of the panel by cp.async; rows past cols and
    // columns past the panel read 0
    if (j0 > 0) __syncthreads();  // every team is done with the panel
    for (int w = 0; w < 2; ++w) {
      const long long r0 =
          (long long)(w ? pair >> 16 : pair & 0xFFFFu) * dg::kWindow;
      float* xw = xs + w * dg::kWindow * KP;
      if (k % 4 == 0 && kp == KP) {
        for (int e = threadIdx.x; e < dg::kWindow * 4; e += blockDim.x) {
          const int r = e >> 2, cc = (e & 3) * 4;
          float* dst = xw + r * KP + cc;
          if (r0 + r < p.cols)
            cp16(dst, X + (r0 + r) * k + j0 + cc);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int e = threadIdx.x; e < dg::kWindow * KP; e += blockDim.x) {
          const int r = e / KP, cc = e - r * KP;
          if (r0 + r < p.cols && cc < kp)
            cp4(xw + e, X + (r0 + r) * k + j0 + cc);
          else
            xw[e] = 0.f;
        }
      }
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    long long cur = -1;
    auto flush = [&]() {
      if (cur < 0) return;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = cur * dg::kLanes + wq * 32 + q * 4 + i;
        if (row < p.rows) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (jc + c < kp) atomicAdd(Y + row * k + j0 + jc + c, acc[i][c]);
        }
      }
    };
    if (STREAM) {
      if (i0 < i1)
        fetch_slab<BF16, NIBBLE>(ring, p, __ldg(&items[i0].x), wq, lane);
      cp_commit();
    }
    for (int it = i0; it < i1; ++it) {
      const int4 item = __ldg(items + it);  // slab, tile, pair, 0
      if (item.y != cur) {
        flush();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
        cur = item.y;
      }
      const long long s = item.x;
      const unsigned char* st = ring + ((it - i0) % kRing) * WS::kBytes;
      if (STREAM) {
        if (it + 1 < i1)
          fetch_slab<BF16, NIBBLE>(
              ring + ((it + 1 - i0) % kRing) * WS::kBytes, p,
              __ldg(&items[it + 1].x), wq, lane);
        cp_commit();
        cp_wait<1>();
        __syncwarp();
      }
#pragma unroll 2
      for (int u = 0; u < dg::kSub; ++u) {
        float v;
        int cl, ch;
        if (STREAM) {
          v = BF16 ? __uint_as_float(
                         (uint32_t)reinterpret_cast<const uint16_t*>(
                             st)[u * 32 + lane]
                         << 16)
                   : reinterpret_cast<const float*>(st)[u * 32 + lane];
          cl = st[WS::kVal + u * 32 + lane] & 127;
          ch = st[WS::kVal + WS::kIdxB + u * dg::kLanes + cl];
        } else {
          const long long at = s * dg::kSlab + u * dg::kLanes + l;
          v = dg::load_val<BF16>(p.vals, at);
          cl = __ldg(p.idxB + at) & 127;
          ch = __ldg(p.idxA + (NIBBLE ? s >> 1 : s) * dg::kSlab +
                     u * dg::kLanes + cl);
        }
        if (NIBBLE) ch = (ch >> ((s & 1) * 4)) & 15;
        // the staged row: the pair's second window where idxA bit 3 is set
        const int cw = ((ch & 8) ? dg::kWindow : 0) + (ch & 7) * dg::kLanes + cl;
        const unsigned nz = __ballot_sync(kFull, v != 0.f);
        if (nz == 0) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src = q * 4 + i;
          const float vi = __shfl_sync(kFull, v, src);
          const int ci = __shfl_sync(kFull, cw, src);
          float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
          if ((nz >> src) & 1u)
            xv = *reinterpret_cast<const float4*>(xs + ci * KP + jc);
          acc[i][0] = fmaf(vi, xv.x, acc[i][0]);
          acc[i][1] = fmaf(vi, xv.y, acc[i][1]);
          acc[i][2] = fmaf(vi, xv.z, acc[i][2]);
          acc[i][3] = fmaf(vi, xv.w, acc[i][3]);
        }
      }
      if (STREAM) __syncwarp();  // the stage is read before its refill
    }
    flush();
    if (STREAM) cp_wait<0>();
  }
}

template <bool BF16, int STEP, bool NIBBLE, bool TWO_WIN>
cudaError_t run_walk(const dg::Pack& p, const int4* items,
                     const int* part_ptr, int n_blocks, const float* X,
                     float* Y, int k, cudaStream_t st) {
  constexpr int T = STEP >= 2 ? kMaxTeams : 1;
  constexpr bool PAIR = TWO_WIN && STEP >= 2;
  const int kp = k < kPanel ? k : kPanel;
  const size_t smem =
      (PAIR ? (size_t)2 * dg::kWindow * (kPanel / 2) * 4
            : STEP >= 2 ? (size_t)dg::kWindow * kp * 4 : 0) +
      (STEP >= 3 ? (size_t)T * kTeamWarps * kRing * WarpStage<BF16>::kBytes
                 : 0);
  void (*kern)(dg::Pack, const int4*, const int*, const float*, float*, int);
  if constexpr (PAIR)
    kern = walk_pair<BF16, STEP, NIBBLE>;
  else
    kern = walk<BF16, STEP, NIBBLE, TWO_WIN>;
  static thread_local bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  kern<<<(unsigned)n_blocks, T * kTeamWarps * 32, smem, st>>>(p, items,
                                                             part_ptr, X, Y, k);
  return cudaGetLastError();
}

template <bool BF16, bool NIBBLE, bool TWO_WIN>
cudaError_t walk_step(int step, const dg::Pack& p, const int4* items,
                      const int* part_ptr, int n_blocks, const float* X,
                      float* Y, int k, cudaStream_t st) {
  switch (step) {
    case 1: return run_walk<BF16, 1, NIBBLE, TWO_WIN>(p, items, part_ptr,
                                                      n_blocks, X, Y, k, st);
    case 2: return run_walk<BF16, 2, NIBBLE, TWO_WIN>(p, items, part_ptr,
                                                      n_blocks, X, Y, k, st);
    case 3: return run_walk<BF16, 3, NIBBLE, TWO_WIN>(p, items, part_ptr,
                                                      n_blocks, X, Y, k, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool BF16>
cudaError_t walk_planes(bool nibble, bool two_win, int step,
                        const dg::Pack& p, const int4* items,
                        const int* part_ptr, int n_blocks, const float* X,
                        float* Y, int k, cudaStream_t st) {
  if (nibble)
    return two_win ? walk_step<BF16, true, true>(step, p, items, part_ptr,
                                                 n_blocks, X, Y, k, st)
                   : walk_step<BF16, true, false>(step, p, items, part_ptr,
                                                  n_blocks, X, Y, k, st);
  return two_win ? walk_step<BF16, false, true>(step, p, items, part_ptr,
                                                n_blocks, X, Y, k, st)
                 : walk_step<BF16, false, false>(step, p, items, part_ptr,
                                                 n_blocks, X, Y, k, st);
}

}  // namespace

// Rows 13 and 14 over a dual-gather pack (fp32 or bf16 values, int8 idxB,
// int8 idxA or, with nibble, two slabs' nibbles a byte; two_win slabs
// pick one of two windows by idxA bit 3): items and part_ptr of
// kernels/spmm_dualgather.py SlabWalk at `step` (1, 2 or 3), n_blocks
// blocks; Y (rows, k) is zeroed by the caller.  Returns the cudaError_t of
// the launch.
extern "C" int spmm_dualgather_walk(const void* idxA, const void* idxB,
                                    const void* vals, const void* items,
                                    const void* part_ptr, int n_blocks,
                                    const void* X, void* Y, int rows,
                                    int cols, int k, int step, int bf16,
                                    int nibble, int two_win, void* stream) {
  if (k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const dg::Pack p{static_cast<const uint8_t*>(idxA),
                   static_cast<const uint8_t*>(idxB),
                   vals,
                   nullptr,
                   nullptr,
                   nullptr,
                   0,
                   rows,
                   cols,
                   1,
                   1};
  const auto it = static_cast<const int4*>(items);
  const auto pp = static_cast<const int*>(part_ptr);
  const auto x = static_cast<const float*>(X);
  const auto y = static_cast<float*>(Y);
  const auto st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? walk_planes<true>(nibble != 0, two_win != 0, step, p,
                                        it, pp, n_blocks, x, y, k, st)
                    : walk_planes<false>(nibble != 0, two_win != 0, step, p,
                                         it, pp, n_blocks, x, y, k, st));
}
