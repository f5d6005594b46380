// Octet SpMV, y = A @ x over an octet pack (a slab spans 8 consecutive
// 128-row tiles: cell (u, l) is row octet*1024 + u*128 + l).
//
// Replaces the Pallas kernel _octet_kernel of
// sparsematrix_tpu/kernels/spmv_octet.py (_octet_call, pallas_call at
// :452).  Each cell reads its column through the three-stage route of
// clos3.cuh: m = RT[u, l], c = CH[u, m], p = POS[c, m], column
// w*1024 + c*128 + p, and adds vals[u, l] * x[column] to its row.
//
// What bounds it: bytes.  Each cell of a slab holding a value is read
// once, 4 (fp32) or 2 (bf16) bytes of value and three plane bytes, and
// does one FMA; x (a window's columns land anywhere in it) is read from
// L2, y written once.
//
// Design: a walk built once a pack on the host (kernels/spmv_octet.py,
// ``octet_walk``) lists, octet by octet, the slabs of both sections (the
// main one and the trim section ``rem``) that hold a nonzero value, and
// cuts the octets into contiguous ranges of about equal work, each octet
// whole.  A block walks one range.  Thread 0 keeps a ring of `stages`
// slab stages filled ahead of use with bulk asynchronous copies
// (bulk.cuh: a slab's values and its RT, CH and POS planes lie contiguous
// at slab*1024 in their arrays), one mbarrier a stage; the route then
// resolves in shared memory.  A block holds G groups of 256 threads (G =
// 1, 2 or 4) that take an octet's slabs G at a time, so that an octet of
// many slabs, in a pack of few octets, is not one group's chain.  Each
// thread owns 4 consecutive cells (one 16-byte value word, one 4-byte RT
// word), gathers x only under a nonzero value, a slab's gathers issued
// together before its FMAs, and keeps its 4 row sums in registers across
// the octet's slabs; at the octet's end the groups' sums meet in shared
// memory, in group order.  An octet is stored once, whole, with 16-byte
// stores (zeros where it has no slab), so y needs no zero fill and no
// atomics, the result does not vary from run to run, one launch covers
// both sections, and the padding slabs of a group are never read.  Rows
// >= rows are not stored and columns >= cols read as 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "clos3.cuh"

namespace {

constexpr int kGroup = 256;  // threads of one slab group
constexpr int kPer = clos3::kWindow / kGroup;  // consecutive cells a thread
constexpr int kPlane = clos3::kWindow;  // bytes of one int8 plane of a slab
constexpr int kMaxStages = 16;

template <bool BF16>
struct Stage {
  static constexpr int kVal = kPlane * (BF16 ? 2 : 4);
  // the values, then RT, CH and POS
  static constexpr int kBytes = kVal + 3 * kPlane;
};

struct Walk {
  // the main section's planes, then the trim section's (null if none)
  const uint8_t* pos[2];
  const uint8_t* chk[2];
  const uint8_t* rte[2];
  const uint8_t* vals[2];
  int n_main;  // slab ids from n_main on are the trim section's
  const int2* items;  // (slab id, window) of each walked slab, by octet
  const int* oct_ptr;  // (n_octets + 1,): each octet's items
  const int* range_ptr;  // (n_ranges + 1,): each block's octets
  int rows, cols, stages;
  int copies_only;  // an ablation: the copies and stores, no cell read
};

// The ring, then G - 1 groups' octet sums, then a barrier a stage.
template <bool BF16, int G>
size_t smem_bytes(int stages) {
  return (size_t)stages * (Stage<BF16>::kBytes + sizeof(uint64_t)) +
         (G - 1) * clos3::kWindow * sizeof(float);
}

// Thread 0: item's slab into stage `st`, its bytes reported to `bar`.
template <bool BF16>
__device__ __forceinline__ void issue(const Walk& w, int item, uint8_t* st,
                                      uint64_t* bar) {
  using S = Stage<BF16>;
  const int slab = __ldg(&w.items[item].x);
  const int sec = slab >= w.n_main;
  const long long off = (long long)(slab - (sec ? w.n_main : 0)) * kPlane;
  // selects, not an index, keep the kernel parameters out of local memory
  const uint8_t* vals = sec ? w.vals[1] : w.vals[0];
  const uint8_t* rte = sec ? w.rte[1] : w.rte[0];
  const uint8_t* chk = sec ? w.chk[1] : w.chk[0];
  const uint8_t* pos = sec ? w.pos[1] : w.pos[0];
  bulk::expect_tx(bar, S::kBytes);
  bulk::load(st, vals + off * (BF16 ? 2 : 4), S::kVal, bar);
  bulk::load(st + S::kVal, rte + off, kPlane, bar);
  bulk::load(st + S::kVal + kPlane, chk + off, kPlane, bar);
  bulk::load(st + S::kVal + 2 * kPlane, pos + off, kPlane, bar);
}

// A thread's 4 cells of the slab staged at `st`, added into `acc`.
template <bool BF16>
__device__ __forceinline__ void slab_cells(const uint8_t* st, int cell,
                                           long long w0, int cols,
                                           const float* __restrict__ x,
                                           float acc[kPer]) {
  using S = Stage<BF16>;
  float v[kPer];
  if (BF16) {
    const uint2 h = *reinterpret_cast<const uint2*>(st + 2 * cell);
    v[0] = __uint_as_float(h.x << 16);
    v[1] = __uint_as_float(h.x & 0xffff0000u);
    v[2] = __uint_as_float(h.y << 16);
    v[3] = __uint_as_float(h.y & 0xffff0000u);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(st + 4 * cell);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
  const uint32_t rt = *reinterpret_cast<const uint32_t*>(st + S::kVal + cell);
  const uint8_t* chk = st + S::kVal + kPlane;
  const uint8_t* pos = chk + kPlane;
  const int u = cell / clos3::kLanes;  // the 4 cells share their sublane
  long long col[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    col[j] = -1;
    if (v[j] != 0.f) {
      const int m = (rt >> (8 * j)) & 127;
      const int c = chk[u * clos3::kLanes + m] & 7;
      col[j] = w0 + c * clos3::kLanes + (pos[c * clos3::kLanes + m] & 127);
    }
  }
  float xv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    xv[j] = (col[j] >= 0 && col[j] < cols) ? __ldg(x + col[j]) : 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = fmaf(v[j], xv[j], acc[j]);
}

template <bool BF16, int G>
__global__ void __launch_bounds__(G * kGroup)
    octet_walk(Walk w, const float* __restrict__ x, float* __restrict__ y) {
  using S = Stage<BF16>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem + w.stages * S::kBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(part + (G - 1) * clos3::kWindow);
  const int t = threadIdx.x, g = t / kGroup;
  const int cell = (t % kGroup) * kPer;
  const int o0 = __ldg(w.range_ptr + blockIdx.x);
  const int o1 = __ldg(w.range_ptr + blockIdx.x + 1);
  const int i0 = __ldg(w.oct_ptr + o0), i1 = __ldg(w.oct_ptr + o1);
  if (t == 0) {
    for (int k = 0; k < w.stages; ++k) bulk::init(bar + k, 1);
    bulk::fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int k = 0; k < w.stages && i0 + k < i1; ++k)
      issue<BF16>(w, i0 + k, smem + k * S::kBytes, bar + k);
  int i = i0;
  for (int o = o0; o < o1; ++o) {
    float acc[kPer] = {0.f, 0.f, 0.f, 0.f};
    const int end = __ldg(w.oct_ptr + o + 1);
    while (i < end) {  // a step: the octet's next n <= G slabs, a group each
      const int n = min(G, end - i);
      if (g < n) {
        const int k = i + g - i0, s = k % w.stages;
        const long long w0 =
            (long long)__ldg(&w.items[i + g].y) * clos3::kWindow;
        bulk::wait(bar + s, (k / w.stages) & 1);
        if (!w.copies_only)
          slab_cells<BF16>(smem + s * S::kBytes, cell, w0, w.cols, x, acc);
      }
      __syncthreads();  // every group is done with its stage
      if (t == 0)
        for (int q = 0; q < n && i + q + w.stages < i1; ++q) {
          const int s = (i + q - i0) % w.stages;
          issue<BF16>(w, i + q + w.stages, smem + s * S::kBytes, bar + s);
        }
      i += n;
    }
    if (G > 1) {  // the groups' sums, added in group order
      if (g > 0)
        *reinterpret_cast<float4*>(part + (g - 1) * clos3::kWindow + cell) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      __syncthreads();
      if (g == 0)
#pragma unroll
        for (int q = 0; q < G - 1; ++q) {
          const float4 p = *reinterpret_cast<const float4*>(
              part + q * clos3::kWindow + cell);
          acc[0] += p.x, acc[1] += p.y, acc[2] += p.z, acc[3] += p.w;
        }
    }
    if (g == 0) {
      const long long row = (long long)o * clos3::kWindow + cell;
      if (row + kPer <= w.rows) {
        *reinterpret_cast<float4*>(y + row) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (row + j < w.rows) y[row + j] = acc[j];
      }
    }
    if (G > 1) __syncthreads();  // the sums' buffer is free again
  }
}

// Above 48 KB the launch needs the kernel's dynamic shared memory raised,
// once a card.
template <bool BF16, int G>
cudaError_t allow_smem(int stages) {
  static unsigned long long done = 0;  // a bit a card
  if (smem_bytes<BF16, G>(stages) <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
  err = cudaFuncSetAttribute(octet_walk<BF16, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<BF16, G>(kMaxStages));
  if (err == cudaSuccess && dev < 64) done |= 1ULL << dev;
  return err;
}

template <bool BF16, int G>
cudaError_t launch(const Walk& w, int n_ranges, const float* x, float* y,
                   cudaStream_t st) {
  const cudaError_t err = allow_smem<BF16, G>(w.stages);
  if (err != cudaSuccess) return err;
  octet_walk<BF16, G><<<n_ranges, G * kGroup, smem_bytes<BF16, G>(w.stages),
                        st>>>(w, x, y);
  return cudaGetLastError();
}

template <bool BF16, int G>
int resident(int stages) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      allow_smem<BF16, G>(stages) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, octet_walk<BF16, G>, G * kGroup,
          smem_bytes<BF16, G>(stages)) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// `stages` 0 takes the default, two a group; -1 where the setting is
// refused (stages below the groups or above kMaxStages, groups not 1, 2
// or 4).
int checked_stages(int stages, int groups) {
  if (groups != 1 && groups != 2 && groups != 4) return -1;
  if (stages <= 0) stages = 2 * groups;
  return stages < groups || stages > kMaxStages ? -1 : stages;
}

}  // namespace

// The blocks of the walk kernel the card holds at once, at `stages` slab
// stages (0: the default), `groups` slab groups a block and bf16 or fp32
// values; <= 0 on failure.
extern "C" int spmv_octet_blocks(int stages, int groups, int bf16) {
  stages = checked_stages(stages, groups);
  if (stages < 0) return -1;
  switch (groups * 2 + (bf16 != 0)) {
    case 2: return resident<false, 1>(stages);
    case 3: return resident<true, 1>(stages);
    case 4: return resident<false, 2>(stages);
    case 5: return resident<true, 2>(stages);
    case 8: return resident<false, 4>(stages);
    default: return resident<true, 4>(stages);
  }
}

// The planes of each section are (n_groups, group*8, 128) int8 and its
// vals the same in fp32 or bf16, each 16-byte aligned; the trim
// section's pointers are null when the pack has none.  items
// (n_items, 2) int32, oct_ptr (n_octets + 1,) and range_ptr
// (n_ranges + 1,) int32: the walk.  x (cols,) fp32; y (rows,) fp32, every
// row written.  `stages` 0 takes the default; `groups` is 1, 2 or 4;
// `copies_only` (an ablation for measurements) skips the cells and stores
// zeros.  Returns the cudaError_t of the launch.
extern "C" int spmv_octet(const void* pos, const void* chk, const void* rte,
                          const void* vals, const void* rem_pos,
                          const void* rem_chk, const void* rem_rte,
                          const void* rem_vals, int n_main, const void* items,
                          const void* oct_ptr, const void* range_ptr,
                          int n_ranges, const void* x, void* y, int rows,
                          int cols, int stages, int groups, int bf16,
                          int copies_only, void* stream) {
  stages = checked_stages(stages, groups);
  if (n_ranges <= 0 || stages < 0) return (int)cudaErrorInvalidValue;
  const Walk w{{static_cast<const uint8_t*>(pos),
                static_cast<const uint8_t*>(rem_pos)},
               {static_cast<const uint8_t*>(chk),
                static_cast<const uint8_t*>(rem_chk)},
               {static_cast<const uint8_t*>(rte),
                static_cast<const uint8_t*>(rem_rte)},
               {static_cast<const uint8_t*>(vals),
                static_cast<const uint8_t*>(rem_vals)},
               n_main,
               static_cast<const int2*>(items),
               static_cast<const int*>(oct_ptr),
               static_cast<const int*>(range_ptr),
               rows,
               cols,
               stages,
               copies_only};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  switch (groups * 2 + (bf16 != 0)) {
    case 2: return (int)launch<false, 1>(w, n_ranges, xf, yf, st);
    case 3: return (int)launch<true, 1>(w, n_ranges, xf, yf, st);
    case 4: return (int)launch<false, 2>(w, n_ranges, xf, yf, st);
    case 5: return (int)launch<true, 2>(w, n_ranges, xf, yf, st);
    case 8: return (int)launch<false, 4>(w, n_ranges, xf, yf, st);
    default: return (int)launch<true, 4>(w, n_ranges, xf, yf, st);
  }
}
