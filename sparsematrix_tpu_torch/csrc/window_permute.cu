// Window permute: per 1024-element window, an arbitrary bijection routed
// by the three int8 planes POS/CH/RT (clos3.cuh).  The device half of the
// Clos-routed planned permutation (ops/permute_clos.py).
//
// Replaces the Pallas kernel _wperm_kernel of
// sparsematrix_tpu/kernels/permute_pallas.py (window_permute, pallas_call
// at :61).
//
// What bounds it: bytes.  Per element it reads 4 bytes of payload and
// 3 bytes of planes and writes 4 bytes; no arithmetic.
//
// Design: one block of 256 threads per window.  The window's 1024 words
// (4 KB) and its three planes (3 KB) are staged in shared memory with
// coalesced 16- and 4-byte loads; each thread then writes 4 out cells,
// neighbouring threads on neighbouring addresses, each read from shared
// memory through the three-stage decode.  Words are moved by bit
// pattern, so any 4-byte payload works (fp32, int32).  Unlike the TPU
// kernel, which batched `group` windows per grid step to amortize step
// cost, each window is independent here: the grid is one block a window.
#include <cstdint>
#include <cuda_runtime.h>

#include "clos3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = clos3::kWindow / kThreads;  // out cells a thread

__global__ void __launch_bounds__(kThreads)
    wperm(const uint32_t* __restrict__ x, const uint8_t* __restrict__ pos,
          const uint8_t* __restrict__ chk, const uint8_t* __restrict__ rte,
          uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t xw[clos3::kWindow];
  __shared__ __align__(16) uint8_t planes[3][clos3::kWindow];
  const long long base = (long long)blockIdx.x * clos3::kWindow;
  const int t = threadIdx.x;
  reinterpret_cast<uint4*>(xw)[t] =
      __ldg(reinterpret_cast<const uint4*>(x + base) + t);
  reinterpret_cast<uint32_t*>(planes[0])[t] =
      __ldg(reinterpret_cast<const uint32_t*>(pos + base) + t);
  reinterpret_cast<uint32_t*>(planes[1])[t] =
      __ldg(reinterpret_cast<const uint32_t*>(chk + base) + t);
  reinterpret_cast<uint32_t*>(planes[2])[t] =
      __ldg(reinterpret_cast<const uint32_t*>(rte + base) + t);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int cell = j * kThreads + t;
    const int src = clos3::source_cell(planes[0], planes[1], planes[2],
                                       cell / clos3::kLanes,
                                       cell % clos3::kLanes);
    out[base + cell] = xw[src];
  }
}

}  // namespace

// x and out are (n_windows, 8, 128) 4-byte words; pos, chk and rte are
// (n_windows, 8, 128) int8.  All contiguous, 16-byte aligned.  Returns the
// cudaError_t of the launch.
extern "C" int window_permute(const void* x, const void* pos, const void* chk,
                              const void* rte, void* out, long long n_windows,
                              void* stream) {
  if (n_windows <= 0 || n_windows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  wperm<<<(unsigned)n_windows, kThreads, 0,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint8_t*>(pos),
      static_cast<const uint8_t*>(chk), static_cast<const uint8_t*>(rte),
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
