// Octet SpMM, Y = A @ X over an octet pack, X (cols, k) and Y (rows, k)
// row-major fp32 (a slab spans 8 consecutive 128-row tiles: cell (u, l) is
// row octet*1024 + u*128 + l).
//
// Replaces the Pallas kernel _octet_mm_kernel of
// sparsematrix_tpu/kernels/spmv_octet.py (_octet_mm_call, pallas_call at
// :632), which walks panels of kp right-hand-side columns: per slab and
// column it routes Xᵀ's (8,128) window by POS, CH and RT, multiplies by
// the values and adds the result at the slab's octet of an fp32
// superblock that a commit flag writes out.  Here each cell is decoded
// once through the route of clos3.cuh (m = RT[u, l], c = CH[u, m],
// p = POS[c, m]: column w*1024 + c*128 + p), and the RHS columns of its X
// row are then walked by the lanes of a warp.  A pack's trim section
// (``rem``) is a second launch of this kernel.
//
// What bounds it: bytes.  Every cell reads 4 (fp32) or 2 (bf16) bytes of
// value and three plane bytes; every stored entry reads one X row and adds
// one Y row (4k bytes each way) and does k FMAs.  Octet packs hold ≲2
// entries a row, so most cells are padding (value 0) and are skipped
// after their decode.
//
// Design: 256 threads a block, a block walks spb contiguous slabs (as
// spmv_octet.cu sizes it) and warp u takes sublane u of each slab.  The
// lanes decode the sublane's 128 cells, 4 a lane; a ballot finds the
// stored ones, and for each in turn the warp reads its X row (lane j:
// column j, coalesced, 32 columns a pass) and atomicAdds v·X into the Y
// row (coalesced too).  Y is zeroed by the wrapper.  That replaces the TPU
// kernel's superblock accumulator, its commit flags and the JAX pack's
// call splits: one launch covers every group, and only the fp32 summation
// order varies, from run to run.  Rows >= rows and columns >= cols
// (padding cells may name them) are dropped and read as 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "clos3.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: one a sublane
constexpr int kCellsPerLane = clos3::kLanes / 32;
constexpr int kMaxSlabsPerBlock = 16;

struct Pack {
  const uint8_t* pos;
  const uint8_t* chk;
  const uint8_t* rte;
  const void* vals;
  const int32_t* group_super;
  const int32_t* slab_win;
  const int32_t* slab_oloc;
  long long n_slabs;
  int rows, cols, k, group, k_octets;
};

using common::load_val;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    octet_spmm(Pack p, const float* __restrict__ X, float* __restrict__ Y,
               int spb) {
  const int u = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, p.n_slabs);
  for (long long s = s0; s < s1; ++s) {
    const long long oct =
        (long long)__ldg(p.group_super + s / p.group) * p.k_octets +
        __ldg(p.slab_oloc + s);
    const long long w0 = (long long)__ldg(p.slab_win + s) * clos3::kWindow;
    const long long pb = s * clos3::kWindow;
    long long col[kCellsPerLane];
    float val[kCellsPerLane];
#pragma unroll
    for (int i = 0; i < kCellsPerLane; ++i) {
      const int l = i * 32 + lane;
      col[i] = w0 + clos3::source_cell(p.pos + pb, p.chk + pb, p.rte + pb,
                                       u, l);
      val[i] = load_val<BF16>(p.vals, pb + u * clos3::kLanes + l);
    }
    const long long row0 = oct * clos3::kWindow + u * clos3::kLanes;
#pragma unroll
    for (int i = 0; i < kCellsPerLane; ++i) {
      unsigned todo = __ballot_sync(0xffffffffu, val[i] != 0.f);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const long long c = __shfl_sync(0xffffffffu, col[i], src);
        const float v = __shfl_sync(0xffffffffu, val[i], src);
        const long long row = row0 + i * 32 + src;
        if (row >= p.rows || c >= p.cols) continue;  // warp-uniform
        const float* xr = X + c * p.k;
        float* yr = Y + row * p.k;
        for (int j = lane; j < p.k; j += 32)
          atomicAdd(yr + j, v * __ldg(xr + j));
      }
    }
  }
}

int slabs_per_block(long long n_slabs) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = 8LL * sms;
  const long long spb = (n_slabs + blocks - 1) / blocks;
  return (int)(spb < 1 ? 1 : spb > kMaxSlabsPerBlock ? kMaxSlabsPerBlock
                                                      : spb);
}

}  // namespace

// The planes are (n_groups, group*8, 128) int8 and vals the same in fp32
// or bf16; group_super (n_groups,), slab_win and slab_oloc (n_slabs,)
// int32.  X (cols, k) fp32 row-major; Y (rows, k) fp32 row-major, zeroed
// by the caller.  Returns the cudaError_t of the launch.
extern "C" int spmm_octet(const void* pos, const void* chk, const void* rte,
                          const void* vals, const void* group_super,
                          const void* slab_win, const void* slab_oloc,
                          const void* X, void* Y, int rows, int cols, int k,
                          long long n_slabs, int group, int k_octets,
                          int bf16, void* stream) {
  if (group <= 0 || n_slabs <= 0 || k_octets <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  const Pack p{static_cast<const uint8_t*>(pos),
               static_cast<const uint8_t*>(chk),
               static_cast<const uint8_t*>(rte),
               vals,
               static_cast<const int32_t*>(group_super),
               static_cast<const int32_t*>(slab_win),
               static_cast<const int32_t*>(slab_oloc),
               n_slabs, rows, cols, k, group, k_octets};
  const int spb = slabs_per_block(n_slabs);
  const unsigned blocks = (unsigned)((n_slabs + spb - 1) / spb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(X);
  float* yf = static_cast<float*>(Y);
  if (bf16)
    octet_spmm<true><<<blocks, kThreads, 0, st>>>(p, xf, yf, spb);
  else
    octet_spmm<false><<<blocks, kThreads, 0, st>>>(p, xf, yf, spb);
  return (int)cudaGetLastError();
}
