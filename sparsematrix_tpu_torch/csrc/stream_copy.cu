// Stream copy: y = x for a contiguous fp32 array of any length.  The HBM
// bandwidth probe behind the bench suite's calibrate/hbm-stream row.
//
// Replaces the Pallas kernel copy_call of
// sparsematrix_tpu/bench/suite.py (bench_calibrate, pallas_call at :112),
// which copied a (262144, 128) fp32 array in 1 MB blocks of (2048, 128)
// over a grid of 128 steps.
//
// What bounds it: bytes.  Each element is read once and written once
// (8 bytes an element); there is no arithmetic.
//
// Design: the float4 part is cut into tiles of kThreads·kUnroll float4
// (32 KB); a block takes tile after tile (a grid-stride loop over tiles),
// each thread loading its kUnroll float4 of the tile (neighbouring
// threads on neighbouring 16-byte words) before it stores them, so 32 KB
// a block are in flight.  The grid is kBlocksPerSm blocks a streaming
// multiprocessor, from the card's SM count.  A scalar head brings x to a
// 16-byte boundary and a scalar tail takes the last (n - head) % 4
// elements; when x and y differ in their alignment modulo 16 bytes the
// whole copy takes a scalar grid-stride loop.  No cudaMemcpy.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kBlocksPerSm = 16;

__global__ void __launch_bounds__(kThreads)
    copy_vec(const float* __restrict__ x, float* __restrict__ y, long long n,
             long long head) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid < head) y[tid] = x[tid];
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ yv = reinterpret_cast<float4*>(y + head);
  const long long nv = (n - head) / 4;
  constexpr long long kTile = (long long)kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kTile; base < nv;
       base += (long long)gridDim.x * kTile) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      if (i < nv) v[u] = __ldg(xv + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      if (i < nv) yv[i] = v[u];
    }
  }
  const long long j = head + nv * 4 + tid;
  if (j < n) y[j] = x[j];
}

__global__ void __launch_bounds__(kThreads)
    copy_scalar(const float* __restrict__ x, float* __restrict__ y,
                long long n) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = tid;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) y[i] = x[i];
}

}  // namespace

// x and y are contiguous fp32 arrays of n elements, 4-byte aligned, not
// overlapping.  Returns the cudaError_t of the launch.
extern "C" int stream_copy(const void* x, void* y, long long n,
                           void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  if ((xa | ya) & 3) return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool co_aligned = ((xa ^ ya) & 15) == 0;
  long long head = 0;
  long long work = n;  // one block's worth: kThreads·kUnroll of these
  if (co_aligned) {
    head = (long long)((16 - (xa & 15)) & 15) / 4;
    if (head > n) head = n;
    work = (n - head) / 4;
  }
  long long blocks = (work + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (co_aligned)
    copy_vec<<<(unsigned)blocks, kThreads, 0, s>>>(xf, yf, n, head);
  else
    copy_scalar<<<(unsigned)blocks, kThreads, 0, s>>>(xf, yf, n);
  return (int)cudaGetLastError();
}
