// Stream copy: y = x for a contiguous fp32 array of any length.  The HBM
// bandwidth probe behind the bench suite's calibrate/hbm-stream row.
//
// Replaces the Pallas kernel copy_call of
// sparsematrix_tpu/bench/suite.py (bench_calibrate, pallas_call at :112),
// which copied a (262144, 128) fp32 array in 1 MB blocks of (2048, 128)
// over a grid of 128 steps, each block a DMA through on-chip memory.
//
// What bounds it: bytes.  Each element is read once and written once
// (8 bytes an element); there is no arithmetic.
//
// Design: Hopper's counterpart of that DMA, bulk asynchronous copies
// through shared memory (bulk.cuh) that no thread's registers touch.  The
// 16-byte aligned body is cut into chunks (32 KB by default); a
// persistent grid of blocks a streaming multiprocessor (1 by default)
// takes chunk after chunk (chunk b, b + grid, ...), so the blocks move
// neighbouring chunks at any time.  (Cutting the chunks so that every
// block takes as many, or giving each block one contiguous share, was
// slower on the card.)  One thread of a block
// keeps `stages - 1` chunks loading into a ring of `stages` shared
// buffers (one mbarrier each), stores each chunk back as it lands (its
// bulk group), and waits for the store before the last one to have read
// its buffer before it loads the next chunk into it.  A scalar head
// brings x to a 16-byte boundary and a scalar tail takes the last
// (n - head) % 4 elements; when x and y differ in their alignment modulo
// 16 bytes the whole copy takes a scalar grid-stride loop.  No
// cudaMemcpy.  Chunk size, stages and blocks an SM are knobs
// (stream_copy_tuned) for measurements.
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kDefaultChunk = 32 * 1024;
constexpr int kDefaultStages = 4;
constexpr int kDefaultBlocksPerSm = 1;
constexpr int kMaxSmem = 227 * 1024;
// the scalar loop's threads and elements a thread in flight
constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kWarp)
    copy_bulk(const float* __restrict__ x, float* __restrict__ y,
              long long n, long long head, int chunk, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int t = threadIdx.x;
  const long long body = (n - head) / 4 * 4;  // elements, whole 16 bytes
  if (blockIdx.x == 0) {
    if (t < head) y[t] = x[t];
    if (head + body + t < n) y[head + body + t] = x[head + body + t];
  }
  if (t != 0) return;
  const long long bytes = body * 4;
  const long long n_chunks = (bytes + chunk - 1) / chunk;
  if ((long long)blockIdx.x >= n_chunks) return;
  const long long mine =
      (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;  // chunks here
  const char* src = reinterpret_cast<const char*>(x + head);
  char* dst = reinterpret_cast<char*>(y + head);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + (size_t)stages * chunk);
  for (int k = 0; k < stages; ++k) bulk::init(bar + k, 1);
  bulk::fence_init();
  // the j-th chunk of this block: its offset and length in bytes
  auto at = [&](long long j) {
    return (blockIdx.x + j * gridDim.x) * (long long)chunk;
  };
  auto len = [&](long long j) {
    const long long left = bytes - at(j);
    return (uint32_t)(left < chunk ? left : chunk);
  };
  auto fetch = [&](long long j) {
    const int s = (int)(j % stages);
    bulk::expect_tx(bar + s, len(j));
    bulk::load(smem + (size_t)s * chunk, src + at(j), len(j), bar + s);
  };
  const long long ahead = stages - 1;
  for (long long j = 0; j < ahead && j < mine; ++j) fetch(j);
  for (long long j = 0; j < mine; ++j) {
    const int s = (int)(j % stages);
    bulk::wait(bar + s, (uint32_t)((j / stages) & 1));
    bulk::fence_async_smem();
    bulk::store(dst + at(j), smem + (size_t)s * chunk, len(j));
    bulk::commit();
    if (j + ahead < mine) {
      // its buffer last held chunk j - 1: that store must have read it
      bulk::wait_read<1>();
      fetch(j + ahead);
    }
  }
  bulk::wait_all();
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
// overlapping.  `chunk` (bytes, a multiple of 16), `stages` (at least 2)
// and `blocks_per_sm` are the bulk path's knobs, 0 each for its default.
// Returns the cudaError_t of the launch.
extern "C" int stream_copy_tuned(const void* x, void* y, long long n,
                                 int chunk, int stages, int blocks_per_sm,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  chunk = chunk > 0 ? chunk : kDefaultChunk;
  stages = stages > 0 ? stages : kDefaultStages;
  blocks_per_sm = blocks_per_sm > 0 ? blocks_per_sm : kDefaultBlocksPerSm;
  const size_t smem = (size_t)stages * chunk + stages * sizeof(uint64_t);
  if (chunk % 16 || stages < 2 || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  if ((xa | ya) & 3) return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (((xa ^ ya) & 15) == 0) {
    long long head = (long long)((16 - (xa & 15)) & 15) / 4;
    if (head > n) head = n;
    const long long n_chunks = ((n - head) / 4 * 16 + chunk - 1) / chunk;
    long long blocks = (long long)sms * blocks_per_sm;
    if (blocks > n_chunks) blocks = n_chunks;
    if (blocks < 1) blocks = 1;
    // above 48 KB the kernel's dynamic shared memory is raised, once a
    // card and size
    static int raised[64] = {};
    if (smem > 48 * 1024 && (dev >= 64 || raised[dev] < (int)smem)) {
      err = cudaFuncSetAttribute(copy_bulk,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) raised[dev] = (int)smem;
    }
    copy_bulk<<<(unsigned)blocks, kWarp, smem, s>>>(xf, yf, n, head, chunk,
                                                     stages);
  } else {
    long long blocks = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const long long cap = (long long)sms * 16;
    if (blocks > cap) blocks = cap;
    copy_scalar<<<(unsigned)blocks, kThreads, 0, s>>>(xf, yf, n);
  }
  return (int)cudaGetLastError();
}

// y = x at the default knobs.
extern "C" int stream_copy(const void* x, void* y, long long n,
                           void* stream) {
  return stream_copy_tuned(x, y, n, 0, 0, 0, stream);
}
