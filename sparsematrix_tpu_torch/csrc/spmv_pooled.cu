// The pooled spill tail of a dual-gather pack, Y += T @ X with X (cols, k)
// and Y (rows, k) row-major fp32 (k = 1 for SpMV).
//
// Replaces the Pallas kernel _pooled_kernel of
// sparsematrix_tpu/kernels/spmv_dualgather.py (_pooled_call, pallas_call
// at :1070).  A pooled slab belongs to one 128-row tile and carries 8
// global 128-column chunk pointers ``ptr``, one a sublane: cell (u, l)
// holds row tile*128 + l and column ptr[idxA[u, idxB[u, l]]]*128 +
// idxB[u, l].  The TPU kernel loads the 8 pointed x rows, gathers them
// along sublanes by idxA and along lanes by idxB, and sums the group's
// slabs into the tile's output row; its SpMM caller runs it once a column.
// Here one launch takes all k columns.  idxA and idxB are plain int8
// (never nibble-packed, even when the body's idxA is).
//
// What bounds it.  k = 1: bytes.  Every cell of the planes is streamed (4
// or 2 bytes of value, one of idxA, one of idxB, and the slabs' chunk
// pointers), though on the XL spill tail only a quarter of them hold an
// entry; the layout floor is those plane bytes at the card's 3.35 TB/s.
// k > 1: the X rows that the nonzero cells name, 4k bytes each, read from
// L2 (X fits there), plus the same planes once.
//
// The first design gave a block a group and its threads (lane, column)
// pairs, each walking all the group's cells of its lane in sequence: a
// chain of dependent loads (value, idxB, idxA, ptr, X) per cell, a few
// thousand such chains on the card, so it was bound by latency, not bytes
// (3.2x cuSPARSE on the XL tail at k = 1).  This design streams instead:
//
// - Decode.  A warp takes a sublane row (128 cells) at a time: thread t
//   reads lanes 4t..4t+3 of its values (16 bytes) and idxB bytes, word t
//   of the row's idxA bytes and, t < 8, the slab's pointer t, all
//   coalesced, several rows at once with the next rows in flight (a
//   register double buffer).  idxA[u, cl] and ptr[slot] are then warp
//   shuffles, not dependent loads.
// - k = 1: each warp streams its own run of rows (pooled_k1) and keeps its
//   lanes' row sums in registers, adding them into Y with one atomicAdd a
//   row where the tile changes.
// - k > 1: a block takes a tile (pooled_kn).  Its warps decode their rows
//   and pass each nonzero cell to the warp that owns the cell's lane,
//   through queues in shared memory; the owner reads the cell's X row,
//   thread t column c0 + t (128 bytes a cell, coalesced), and adds it into
//   the block's (128 x 32) tile in shared memory.  Only thread t of the
//   owner ever touches an element, so that needs no atomics.  A tile's
//   rows are split over four blocks (more where few groups would leave
//   SMs idle), and each adds its tile into Y once, with atomicAdd.
//
// The body kernel has run before on the same Y, which the wrapper zeroed;
// the atomicAdds sum in no fixed order.  Rows >= rows are dropped and
// columns >= cols read as 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr int kRB1 = 4;          // rows a warp holds a buffer, k = 1
constexpr int kRBn = 2;          // rows a warp holds a buffer, k > 1
constexpr int kWarpsN = 8;       // warps a block, k > 1
constexpr int kThreadsN = kWarpsN * 32;
constexpr int kOwn = kLanes / kWarpsN;  // lanes a warp owns, k > 1
// a queue holds the owner's lanes of a round's rows
constexpr int kQCap = kOwn * kWarpsN * kRBn;
constexpr int kU = 16;           // cells a warp has in flight, k > 1
static_assert(kOwn % 4 == 0 && kOwn / 4 <= 32, "lanes an owner");

struct Pack {
  const int32_t* ptr;
  const uint32_t* idxA;  // 4 lanes a word
  const uint32_t* idxB;
  const void* vals;
  const int32_t* group_tile;
  long long n_groups;
  int rows, cols, k, group;
  int work;  // k = 1: rows a warp; k > 1: blocks a tile
};

// One sublane row as a warp holds it: thread t has lanes 4t..4t+3 of its
// values and idxB bytes, bytes 4t..4t+3 of its idxA row and, for t < 8,
// pointer t of the row's slab.
struct RowRegs {
  float v[4];
  uint32_t a, b;
  int p;
};

template <bool BF16>
__device__ __forceinline__ void load_row(const Pack& P, long long r, bool live,
                                         int t, RowRegs& R) {
  if (!live) {
    R.v[0] = R.v[1] = R.v[2] = R.v[3] = 0.f;
    R.a = R.b = 0u;
    R.p = 0;
    return;
  }
  const long long w = r * 32 + t;
  if (BF16) {
    // a bf16 value is the upper half of its fp32 word
    const uint2 u = __ldg(static_cast<const uint2*>(P.vals) + w);
    R.v[0] = __uint_as_float(u.x << 16);
    R.v[1] = __uint_as_float(u.x & 0xffff0000u);
    R.v[2] = __uint_as_float(u.y << 16);
    R.v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = __ldg(static_cast<const float4*>(P.vals) + w);
    R.v[0] = f.x; R.v[1] = f.y; R.v[2] = f.z; R.v[3] = f.w;
  }
  R.b = __ldg(P.idxB + w);
  R.a = __ldg(P.idxA + w);
  R.p = t < 8 ? __ldg(P.ptr + (r >> 3) * 8 + t) : 0;
}

// The X row of each of the thread's 4 cells, or -1 where the value is 0 or
// the column lies past cols.  Every thread of the warp must call it.
__device__ __forceinline__ void decode(const RowRegs& R, int cols,
                                       int (&col)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cl = (R.b >> (8 * i)) & 127;
    const uint32_t a4 = __shfl_sync(~0u, R.a, cl >> 2);
    const int slot = (a4 >> (8 * (cl & 3))) & 7;
    const long long c = (long long)__shfl_sync(~0u, R.p, slot) * kLanes + cl;
    col[i] = (R.v[i] != 0.f && c < cols) ? (int)c : -1;
  }
}

// k = 1.  Each warp streams its own P.work rows (a multiple of kRB1, so a
// batch never straddles two groups) of the flattened (group, sublane)
// rows and keeps its lanes' sums in registers, adding them into Y where
// the tile changes and at its end.  MODE 1 (an ablation) reads 1 for
// every X element.
template <bool BF16, int MODE>
__global__ void __launch_bounds__(kThreads)
    pooled_k1(Pack P, const float* __restrict__ X, float* __restrict__ Y) {
  const int t = threadIdx.x & 31;
  const int rows_g = P.group * 8;
  const long long total = P.n_groups * rows_g;
  const long long r0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * P.work;
  if (r0 >= total) return;
  const long long r1 = min(total, r0 + P.work);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  long long tile = -1;  // the tile acc belongs to
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = tile * kLanes + 4 * t + i;
      if (tile >= 0 && row < P.rows && acc[i] != 0.f) atomicAdd(Y + row, acc[i]);
      acc[i] = 0.f;
    }
  };
  RowRegs cur[kRB1], nxt[kRB1];
  long long tcur = __ldg(P.group_tile + r0 / rows_g), tnxt = tcur;
#pragma unroll
  for (int j = 0; j < kRB1; ++j) load_row<BF16>(P, r0 + j, r0 + j < r1, t, cur[j]);
  for (long long r = r0; r < r1; r += kRB1) {
    const long long rn = r + kRB1;
#pragma unroll
    for (int j = 0; j < kRB1; ++j) load_row<BF16>(P, rn + j, rn + j < r1, t, nxt[j]);
    if (rn < r1) tnxt = __ldg(P.group_tile + rn / rows_g);
    if (tcur != tile) {
      flush();
      tile = tcur;
    }
    int col[kRB1][4];
#pragma unroll
    for (int j = 0; j < kRB1; ++j) decode(cur[j], P.cols, col[j]);
    float x[kRB1][4];
#pragma unroll
    for (int j = 0; j < kRB1; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[j][i] = col[j][i] < 0 ? 0.f : (MODE == 0 ? __ldg(X + col[j][i]) : 1.f);
#pragma unroll
    for (int j = 0; j < kRB1; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(cur[j].v[i], x[j][i], acc[i]);
#pragma unroll
    for (int j = 0; j < kRB1; ++j) cur[j] = nxt[j];
    tcur = tnxt;
  }
  flush();
}

// k > 1.  A block takes a tile: the block of the tile's first group walks
// all of the tile's groups (they are consecutive), the blocks of its other
// groups return at once; with P.work > 1 blocks a group, the tile's rows
// are split over P.work blocks.  It runs in rounds.  Each warp decodes
// kRBn rows (as at k = 1: coalesced plane words, idxA and the pointers by
// shuffles) and appends their nonzero cells (value, X row, lane) to the
// queue of the warp that owns the cell's lane (warp w owns lanes kOwn*w ..
// kOwn*w + kOwn-1).  Then each warp adds its queue's cells into the
// block's (128 x 32) tile in shared memory, thread t taking column c0 + t
// of every cell, kU cells' X rows in flight: no other thread ever touches
// that element, so a plain read-add-write does.  The next round's rows
// load meanwhile.  The tile is added into Y once a pass (atomicAdd when
// the tile's rows are split).  k above 32 runs in passes.  MODE 1 (an
// ablation) reads 1 for every X element, MODE 2 stops after the decode.
template <bool BF16, int MODE>
__global__ void __launch_bounds__(kThreadsN)
    pooled_kn(Pack P, const float* __restrict__ X, float* __restrict__ Y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);  // [kLanes][32]
  float* qv = tile + kLanes * 32;                    // [kWarpsN][kQCap]
  int* qc = reinterpret_cast<int*>(qv + kWarpsN * kQCap);
  int* qn = qc + kWarpsN * kQCap;                    // [kWarpsN]
  uint8_t* ql = reinterpret_cast<uint8_t*>(qn + kWarpsN);
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const long long g = blockIdx.x / P.work;
  const int part = blockIdx.x % P.work;
  const long long tile_id = __ldg(P.group_tile + g);
  if (g > 0 && __ldg(P.group_tile + g - 1) == tile_id) return;
  long long ge = g + 1;
  while (ge < P.n_groups && __ldg(P.group_tile + ge) == tile_id) ++ge;
  const int rows_g = P.group * 8;
  const long long rows_t = (ge - g) * rows_g;
  const long long per = (rows_t + P.work - 1) / P.work;
  const long long r0 = part * per, r1 = min(rows_t, r0 + per);
  const long long base = g * rows_g;
  constexpr int step = kWarpsN * kRBn;
  const int rounds = (int)((r1 - r0 + step - 1) / step);
  constexpr int TPO = kOwn / 4;  // threads whose lanes one warp owns
  const int owner = t / TPO;     // the owner of lanes 4t..4t+3
  const float* wv = qv + w * kQCap;
  const int* wc = qc + w * kQCap;
  const uint8_t* wl = ql + w * kQCap;
  for (int c0 = 0; c0 < P.k; c0 += 32) {
    for (int e = threadIdx.x; e < kLanes * 32; e += kThreadsN) tile[e] = 0.f;
    if (threadIdx.x < kWarpsN) qn[threadIdx.x] = 0;
    __syncthreads();
    const bool col_ok = c0 + t < P.k;
    RowRegs cur[kRBn], nxt[kRBn];
    long long r = r0 + w * kRBn;
#pragma unroll
    for (int j = 0; j < kRBn; ++j)
      load_row<BF16>(P, base + r + j, r + j < r1, t, cur[j]);
    for (int it = 0; it < rounds; ++it, r += step) {
#pragma unroll
      for (int j = 0; j < kRBn; ++j)
        load_row<BF16>(P, base + r + step + j, r + step + j < r1, t, nxt[j]);
#pragma unroll
      for (int j = 0; j < kRBn; ++j) {
        int col[4];
        decode(cur[j], P.cols, col);
        int mine = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) mine += col[i] >= 0;
        // the owner's threads reserve their cells with one atomic
        int before = mine;
#pragma unroll
        for (int d = 1; d < TPO; d <<= 1) {
          const int o = __shfl_up_sync(~0u, before, d, TPO);
          if (t % TPO >= d) before += o;
        }
        const int total = __shfl_sync(~0u, before, TPO - 1, TPO);
        before -= mine;
        int pos = 0;
        if (t % TPO == 0 && total) pos = atomicAdd(&qn[owner], total);
        pos = __shfl_sync(~0u, pos, 0, TPO) + before;
        const int q = owner * kQCap;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col[i] >= 0) {
            qv[q + pos] = cur[j].v[i];
            qc[q + pos] = col[i];
            ql[q + pos] = (uint8_t)(4 * t + i);
            ++pos;
          }
      }
      __syncthreads();
      const int n = qn[w];
      for (int e0 = 0; MODE != 2 && e0 < n; e0 += kU) {
        float x[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bool live = e0 + u < n && col_ok;
          const long long xo = (long long)(live ? wc[e0 + u] : 0) * P.k + c0 + t;
          x[u] = live ? (MODE == 0 ? __ldg(X + xo) : 1.f) : 0.f;
        }
        // a cell past n adds 0 to the warp's own first lane: no branch,
        // and still no element that another thread touches
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bool live = e0 + u < n;
          const int l = live ? wl[e0 + u] : kOwn * w;
          tile[l * 32 + t] += (live ? wv[e0 + u] : 0.f) * x[u];
        }
      }
      __syncwarp();
      if (t == 0) qn[w] = 0;  // its one reader is done with it
      __syncthreads();        // ... before any warp appends again
#pragma unroll
      for (int j = 0; j < kRBn; ++j) cur[j] = nxt[j];
    }
    // the flush: this block alone adds into the tile's rows unless the
    // tile is split over blocks
    for (int e = threadIdx.x; e < kLanes * 32; e += kThreadsN) {
      const int l = e >> 5, jj = e & 31;
      const long long row = tile_id * kLanes + l;
      const float s = tile[e];
      if (row >= P.rows || c0 + jj >= P.k || s == 0.f) continue;
      float* y = Y + row * P.k + c0 + jj;
      if (P.work == 1)
        *y += s;
      else
        atomicAdd(y, s);
    }
    __syncthreads();
  }
}

// the shared memory of pooled_kn: the tile, the queues and their lengths
constexpr int kSmemN = kLanes * 32 * 4 + kWarpsN * (kQCap * 9 + 4);

template <bool BF16, int MODE>
cudaError_t launch(const Pack& p, unsigned blocks, const float* X, float* Y,
                   cudaStream_t st) {
  if (p.k == 1)
    pooled_k1<BF16, MODE><<<blocks, kThreads, 0, st>>>(p, X, Y);
  else {
    auto kern = pooled_kn<BF16, MODE>;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemN);
    if (e != cudaSuccess) return e;
    kern<<<blocks, kThreadsN, kSmemN, st>>>(p, X, Y);
  }
  return cudaGetLastError();
}

}  // namespace

// spmv_pooled with its knobs: ``work`` (0: the kernel's choice) is the
// rows a warp streams for k = 1 (rounded up to a multiple of 4; by
// default about 16 warps an SM's worth), and the blocks a tile for k > 1
// (by default 4, or enough to give each SM a block when there are fewer
// groups than SMs; chip_smoke.py times 1, 2 and 4 at the XL tail); ``mode``
// 1 (an ablation) reads 1 for every X element and mode 2 (k > 1) stops
// after the decode; either result is then not T @ X.
extern "C" int spmv_pooled_tuned(const void* ptr, const void* idxA,
                                 const void* idxB, const void* vals,
                                 const void* group_tile, const void* X,
                                 void* Y, int rows, int cols, int k,
                                 long long n_groups, int group, int bf16,
                                 int work, int mode, void* stream) {
  if (group <= 0 || n_groups <= 0 || k <= 0 || work < 0 || mode < 0 ||
      mode > 2 || n_groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long rows_g = group * 8LL;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks;
  if (k == 1) {
    const long long total = n_groups * rows_g;
    long long rw = work ? work : (total + 16LL * sms - 1) / (16LL * sms);
    rw = (rw + kRB1 - 1) / kRB1 * kRB1;
    rw = rw < 2 * kRB1 ? 2 * kRB1 : rw;
    work = (int)(rw > (1 << 30) ? (1 << 30) : rw);
    const long long warps = (total + work - 1) / work;
    blocks = (warps + kWarps - 1) / kWarps;
  } else {
    if (work == 0) {  // four blocks a tile, more if that leaves SMs idle
      long long pp = (sms + n_groups - 1) / n_groups;
      pp = pp < 4 ? 4 : pp;
      const long long most = (rows_g + 15) / 16;
      work = (int)(pp > most ? most : pp);
    }
    blocks = n_groups * work;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Pack p{static_cast<const int32_t*>(ptr),
               static_cast<const uint32_t*>(idxA),
               static_cast<const uint32_t*>(idxB),
               vals,
               static_cast<const int32_t*>(group_tile),
               n_groups, rows, cols, k, group, work};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(X);
  float* yf = static_cast<float*>(Y);
  const unsigned nb = (unsigned)blocks;
  if (bf16)
    return (int)(mode == 0 ? launch<true, 0>(p, nb, xf, yf, st)
                 : mode == 1 ? launch<true, 1>(p, nb, xf, yf, st)
                             : launch<true, 2>(p, nb, xf, yf, st));
  return (int)(mode == 0 ? launch<false, 0>(p, nb, xf, yf, st)
               : mode == 1 ? launch<false, 1>(p, nb, xf, yf, st)
                           : launch<false, 2>(p, nb, xf, yf, st));
}

// ptr (n_groups, group, 8) int32; idxA, idxB (n_groups, group*8, 128)
// int8; vals the same in fp32 or bf16; group_tile (n_groups,) int32.
// X (cols, k) fp32; Y (rows, k) fp32 holding the body's sum.  The planes
// are 16-byte aligned (the wrapper checks).  Returns the cudaError_t of
// the launch.
extern "C" int spmv_pooled(const void* ptr, const void* idxA,
                           const void* idxB, const void* vals,
                           const void* group_tile, const void* X, void* Y,
                           int rows, int cols, int k, long long n_groups,
                           int group, int bf16, void* stream) {
  return spmv_pooled_tuned(ptr, idxA, idxB, vals, group_tile, X, Y, rows,
                           cols, k, n_groups, group, bf16, 0, 0, stream);
}
