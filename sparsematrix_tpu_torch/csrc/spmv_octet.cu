// Octet SpMV, y = A @ x over an octet pack (a slab spans 8 consecutive
// 128-row tiles: cell (u, l) is row octet*1024 + u*128 + l).
//
// Replaces the Pallas kernel _octet_kernel of
// sparsematrix_tpu/kernels/spmv_octet.py (_octet_call, pallas_call at
// :452).  Each cell reads its column through the three-stage route of
// clos3.cuh: m = RT[u, l], c = CH[u, m], p = POS[c, m], column
// w*1024 + c*128 + p, and adds vals[u, l] * x[column] to its row.  The
// octet of slab s is group_super[s / group] * k_octets + slab_oloc[s].
// A pack's trim section (``rem``) is a second launch of this kernel.
//
// What bounds it: bytes.  Each cell reads 4 (fp32) or 2 (bf16) bytes of
// value and three plane bytes (RT coalesced, CH and POS from the slab's
// 1 KB planes in L1) and does one FMA; x is gathered from L1/L2: the
// columns of one 1024-wide window land anywhere in it.
//
// Design: 256 threads a block, 4 cells a thread (cell j*256 + t, so
// neighbouring threads read neighbouring plane bytes); a block walks spb
// contiguous slabs (as dualgather.cuh sizes it).  Each thread keeps one
// register sum a cell while consecutive slabs share their octet and
// atomicAdds the sums into y when the octet changes and at the end of its
// run; y is zeroed by the wrapper.  That replaces the TPU kernel's
// superblock accumulator, its commit flags and the JAX pack's call
// splits: one launch covers every group, and only the fp32 summation
// order varies, from run to run.  Rows >= rows and columns >= cols
// (padding cells may name them) are dropped and read as 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "clos3.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = clos3::kWindow / kThreads;  // cells a thread
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
  int rows, cols, group, k_octets;
};

using common::load_val;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    octet_spmv(Pack p, const float* __restrict__ x, float* __restrict__ y,
               int spb) {
  const int t = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, p.n_slabs);
  long long cur = -1;
  float acc[kPer];
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long row = cur * clos3::kWindow + j * kThreads + t;
      if (row < p.rows) atomicAdd(y + row, acc[j]);
    }
  };
  for (long long s = s0; s < s1; ++s) {
    const long long oct =
        (long long)__ldg(p.group_super + s / p.group) * p.k_octets +
        __ldg(p.slab_oloc + s);
    if (oct != cur) {
      flush();
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
      cur = oct;
    }
    const long long w0 = (long long)__ldg(p.slab_win + s) * clos3::kWindow;
    const long long pb = s * clos3::kWindow;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int cell = j * kThreads + t;
      const int u = cell / clos3::kLanes, l = cell % clos3::kLanes;
      const int src = clos3::source_cell(p.pos + pb, p.chk + pb, p.rte + pb,
                                         u, l);
      const long long col = w0 + src;
      const float v = load_val<BF16>(p.vals, pb + cell);
      acc[j] = fmaf(v, col < p.cols ? __ldg(x + col) : 0.f, acc[j]);
    }
  }
  flush();
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
// int32.  x (cols,) fp32; y (rows,) fp32, zeroed by the caller.  Returns
// the cudaError_t of the launch.
extern "C" int spmv_octet(const void* pos, const void* chk, const void* rte,
                          const void* vals, const void* group_super,
                          const void* slab_win, const void* slab_oloc,
                          const void* x, void* y, int rows, int cols,
                          long long n_slabs, int group, int k_octets,
                          int bf16, void* stream) {
  if (group <= 0 || n_slabs <= 0 || k_octets <= 0)
    return (int)cudaErrorInvalidValue;
  const Pack p{static_cast<const uint8_t*>(pos),
               static_cast<const uint8_t*>(chk),
               static_cast<const uint8_t*>(rte),
               vals,
               static_cast<const int32_t*>(group_super),
               static_cast<const int32_t*>(slab_win),
               static_cast<const int32_t*>(slab_oloc),
               n_slabs, rows, cols, group, k_octets};
  const int spb = slabs_per_block(n_slabs);
  const unsigned blocks = (unsigned)((n_slabs + spb - 1) / spb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (bf16)
    octet_spmv<true><<<blocks, kThreads, 0, st>>>(p, xf, yf, spb);
  else
    octet_spmv<false><<<blocks, kThreads, 0, st>>>(p, xf, yf, spb);
  return (int)cudaGetLastError();
}
