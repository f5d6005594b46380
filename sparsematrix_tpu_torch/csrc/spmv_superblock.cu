// Superblock row-lane SpMV, y = A @ x over a superblock pack (a group's
// slabs span a superblock of k_tiles 128-row tiles).
//
// Replaces the Pallas kernel _superblock_kernel of
// sparsematrix_tpu/kernels/spmv_superblock.py (_superblock_call,
// pallas_call at :179), which gathers as the rowlane kernel does and adds
// each slab's sublane sum into row block 8 * slab_tloc of a (8·K, 128)
// superblock accumulator.
//
// Slot (u, l) of slab s reads column slab_win[s]*1024 + u*128 +
// s_idx[u][l] and adds into row (group_super[s / group] * k_tiles +
// slab_tloc[s]) * 128 + l.  Padding slots and padding slabs hold value 0;
// padding slabs sit at the end of each superblock and repeat its last
// slab's window and tile, so the slabs' tiles never decrease.
//
// What bounds it: bytes.  A slot is one byte of s_idx and 4 (or 2) of
// value; x (4 B a column) and y stay in L2.  At spgemm_xl's P the planes
// are 11 % full, so their bytes, not the 4.4 M products, set the floor.
// The first version ran rl::walk (rowlane.cuh): a thread a lane, a 1-byte
// and a 4-byte load a sublane, no slab's loads issued before the previous
// slab's sums were done, a scalar atomicAdd a lane at every tile change
// (~1.1 slabs a tile there) into a y the wrapper zeroed (17 MB there), and
// the padding slabs streamed in full; it moved ~1.55 TB/s.  Now
// (spmv_superblock_walk):
//  * Warp w walks the slabs [warp_ptr[w], warp_ptr[w+1]), cut on the host
//    once a pack so that one wave of the warps the card holds covers the
//    pack, each cut moved to the nearest tile start within half a range.
//  * Thread t takes lanes 4t..4t+3 of all 8 sublanes: eight 4-byte s_idx
//    words and eight 16-byte value words (8-byte bf16) a slab, coalesced,
//    all issued before any is used, read with the streaming hint so that
//    x and y stay in L2.  A zero value reads no x.
//  * group_real[g] (built on the host once a pack) counts group g's slabs
//    up to its last that holds a nonzero value; the slabs after it, the
//    superblock's padding among them, are not read (only their tile is).
//    So an inf or NaN of x under a zero value or a skipped slab gives 0,
//    not NaN.
//  * The four row sums of a thread stay in registers while the tile stays
//    the same.  A tile whose slabs all lie in one warp's range is that
//    warp's: it stores its 128 sums (zeros where nothing adds), one
//    16-byte store a thread, and stores zeros into the tiles no slab names
//    between its own.  So y needs no zero fill.  Only a tile that a cut
//    splits is zeroed first by the wrapper and taken with float4
//    atomicAdds (red.global.add.v4.f32 on sm_90); only its fp32 summation
//    order varies.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kSlab = kSub * kLanes;  // slots a slab
constexpr int kWindow = 1024;
constexpr int kWarps = 4;  // a block's warps, each on its own range

// What spmv_superblock_tuned's mode changes (kSbNoGather's result is not
// the product; kSbAllSlabs's is).
enum SbMode {
  kSbFull = 0,
  kSbNoGather = 1,  // x read as 1: no x gather
  kSbAllSlabs = 2,  // no skip: every slab streamed, padding included
};

struct Pack {
  const uint8_t* s_idx;
  const void* vals;
  const int32_t* group_super;
  const int32_t* slab_win;
  const int32_t* slab_tloc;
  const int32_t* group_real;
  const int32_t* warp_ptr;
  long long n_slabs;
  int rows, cols, group, k_tiles, n_warps;
};

__device__ __forceinline__ long long tile_of(const Pack& p, long long s) {
  return (long long)__ldg(p.group_super + s / p.group) * p.k_tiles +
         __ldg(p.slab_tloc + s);
}

template <bool BF16, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
    spmv_superblock_walk(Pack p, const float* __restrict__ x,
                         float* __restrict__ y) {
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (wid >= p.n_warps) return;
  const long long s0 = __ldg(p.warp_ptr + wid);
  const long long s1 = __ldg(p.warp_ptr + wid + 1);
  if (s0 >= s1) return;
  const long long n_tiles = (p.rows + kLanes - 1) / kLanes;
  // a cut inside a tile shares it with the neighbouring range
  const long long shared0 =
      s0 > 0 && tile_of(p, s0 - 1) == tile_of(p, s0) ? tile_of(p, s0) : -1;
  const long long shared1 =
      s1 < p.n_slabs && tile_of(p, s1 - 1) == tile_of(p, s1)
          ? tile_of(p, s1) : -1;
  // rows t*128 + 4*lane .. +3 of tile t get v: stored, or added where
  // the tile is shared
  auto put = [&](long long t, float4 v) {
    const long long rb = t * kLanes + 4 * lane;
    const bool add = t == shared0 || t == shared1;
    if (add && v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) return;
    if (rb + 3 < p.rows) {
      if (add)
        atomicAdd(reinterpret_cast<float4*>(y + rb), v);
      else
        *reinterpret_cast<float4*>(y + rb) = v;
      return;
    }
    const float c[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < 4 && rb + k < p.rows; ++k) {
      if (add)
        atomicAdd(y + rb + k, c[k]);
      else
        y[rb + k] = c[k];
    }
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // the tile of the previous slab; the tiles between it and the next
  // slab's hold no slab and are zeroed here (before slab 0 by warp 0, after
  // the last slab by the range that ends there)
  long long cur = s0 > 0 ? tile_of(p, s0 - 1) : -1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long s = s0; s < s1; ++s) {
    const long long g = s / p.group;
    const long long t = (long long)__ldg(p.group_super + g) * p.k_tiles +
                        __ldg(p.slab_tloc + s);
    if (t != cur) {
      if (s > s0) put(cur, make_float4(acc[0], acc[1], acc[2], acc[3]));
      for (long long e = cur + 1; e < t && e < n_tiles; ++e) put(e, zero);
      acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      cur = t;
    }
    if (kMode != kSbAllSlabs && s - g * p.group >= __ldg(p.group_real + g))
      continue;
    const long long at = s * kSlab + 4 * lane;
    uint32_t idx[kSub];
    float4 v[kSub];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      idx[u] = __ldcs(reinterpret_cast<const unsigned*>(p.s_idx + at +
                                                        u * kLanes));
      v[u] = common::stream_val4<BF16>(p.vals, at + u * kLanes);
    }
    const long long w0 = (long long)__ldg(p.slab_win + s) * kWindow;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const float vc[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (vc[c] == 0.f) continue;
        const long long col =
            w0 + u * kLanes + ((idx[u] >> (8 * c)) & (kLanes - 1));
        if (col < p.cols)
          acc[c] += vc[c] * (kMode == kSbNoGather ? 1.f : __ldg(x + col));
      }
    }
  }
  put(cur, make_float4(acc[0], acc[1], acc[2], acc[3]));
  if (s1 == p.n_slabs)
    for (long long e = cur + 1; e < n_tiles; ++e) put(e, zero);
}

template <bool BF16, int kMode>
cudaError_t launch(const Pack& p, const float* x, float* y,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)((p.n_warps + kWarps - 1) / kWarps);
  spmv_superblock_walk<BF16, kMode><<<blocks, kWarps * 32, 0, st>>>(p, x, y);
  return cudaGetLastError();
}

}  // namespace

// The warps of spmv_superblock_walk that the card holds at once: the
// wrapper cuts the slabs into that many ranges (one wave).
extern "C" int spmv_superblock_warps() {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, spmv_superblock_walk<false, kSbFull>, kWarps * 32, 0) !=
          cudaSuccess)
    return -1;
  return sms * (per > 0 ? per : 1) * kWarps;
}

// spmv_superblock with its ``mode`` (SbMode; 0 the product).  s_idx
// (n_slabs, 8, 128) int8, 4-byte aligned; vals the same in fp32 or bf16,
// 16-byte aligned (8 for bf16); group_super (n_groups,) int32; slab_win,
// slab_tloc (n_slabs,) int32; group_real (n_groups,) int32, each in
// [0, group]; warp_ptr (n_warps+1,) int32, non-decreasing from 0 to
// n_slabs; x (cols,) fp32; y (rows,) fp32, 16-byte aligned, zero in the
// tiles that a cut of warp_ptr splits (the kernel writes every other
// row).  Returns the cudaError_t of the launch.
extern "C" int spmv_superblock_tuned(
    const void* s_idx, const void* vals, const void* group_super,
    const void* slab_win, const void* slab_tloc, const void* group_real,
    const void* warp_ptr, const void* x, void* y, int rows, int cols,
    long long n_slabs, int group, int k_tiles, int n_warps, int bf16,
    int mode, void* stream) {
  if (group <= 0 || n_slabs <= 0 || k_tiles <= 0 || n_warps <= 0 ||
      !slab_tloc || !group_real || !warp_ptr || mode < 0 ||
      mode > kSbAllSlabs)
    return (int)cudaErrorInvalidValue;
  const Pack p{static_cast<const uint8_t*>(s_idx),
               vals,
               static_cast<const int32_t*>(group_super),
               static_cast<const int32_t*>(slab_win),
               static_cast<const int32_t*>(slab_tloc),
               static_cast<const int32_t*>(group_real),
               static_cast<const int32_t*>(warp_ptr),
               n_slabs, rows, cols, group, k_tiles, n_warps};
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kSbNoGather)
    e = bf16 ? launch<true, kSbNoGather>(p, xf, yf, st)
             : launch<false, kSbNoGather>(p, xf, yf, st);
  else if (mode == kSbAllSlabs)
    e = bf16 ? launch<true, kSbAllSlabs>(p, xf, yf, st)
             : launch<false, kSbAllSlabs>(p, xf, yf, st);
  else
    e = bf16 ? launch<true, kSbFull>(p, xf, yf, st)
             : launch<false, kSbFull>(p, xf, yf, st);
  return (int)e;
}

// y = A @ x over the superblock pack: spmv_superblock_tuned's product.
extern "C" int spmv_superblock(const void* s_idx, const void* vals,
                               const void* group_super, const void* slab_win,
                               const void* slab_tloc, const void* group_real,
                               const void* warp_ptr, const void* x, void* y,
                               int rows, int cols, long long n_slabs,
                               int group, int k_tiles, int n_warps, int bf16,
                               void* stream) {
  return spmv_superblock_tuned(s_idx, vals, group_super, slab_win, slab_tloc,
                               group_real, warp_ptr, x, y, rows, cols,
                               n_slabs, group, k_tiles, n_warps, bf16, 0,
                               stream);
}
