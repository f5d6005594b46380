// Metadata scale: `steps` steps in order, step i writing
// out = x * meta_i with meta_i = meta[i * stride] (an int32 scalar), so
// that the last step's value is what remains: out = x * meta[(steps-1) *
// stride].
//
// Replaces the Pallas kernels kernel_1d and kernel_2d of
// docs/repro_smem_lane_padding.py (run, pallas_call at :51): a grid of 512
// sequential steps, each reading its scalar from a scalar-prefetch (SMEM)
// operand, flat (meta[i * 6]) or 2-D (meta[i, 0] of a (512, 6) array), and
// writing one (8, 128) output block.  On the TPU the 2-D operand is
// lane-padded in SMEM and the repro records it as unreliable.
//
// What bounds it: launch latency; by bytes, the metadata column (4 bytes a
// step) and x and out (4 bytes an element each).
//
// Design: a step's scalar is addressed as meta[i * stride]: stride 6 for
// the flat array, the row stride of a 2-D array (any padding of its rows,
// read as the array lies in memory).  Each block stages the column into
// shared memory (the scalar prefetch; at most kMaxSteps, the repro's 512),
// and each thread walks the steps in order for its element, so the last
// step wins by program order, as on the TPU's sequential grid; no two
// threads write one element.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 512;  // the repro's grid

__global__ void __launch_bounds__(kThreads)
    probe_meta_scale_kernel(const int32_t* __restrict__ meta,
                            const float* __restrict__ x,
                            float* __restrict__ out, long long n, int steps,
                            long long stride) {
  __shared__ int32_t col[kMaxSteps];
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < steps; i += kThreads)
    col[i] = __ldg(meta + (long long)i * stride);
  __syncthreads();
  const float xe = e < n ? __ldg(x + e) : 0.f;
  float v = 0.f;
  for (int i = 0; i < steps; ++i) v = xe * (float)col[i];
  if (e < n) out[e] = v;
}

}  // namespace

// meta: int32, step i's scalar at meta[i * stride], 1 <= steps <=
// kMaxSteps; x, out: n fp32 elements, contiguous.  Returns the cudaError_t of the launch.
extern "C" int probe_meta_scale(const void* meta, const void* x, void* out,
                                long long n, int steps, long long stride,
                                void* stream) {
  if (n <= 0 || steps <= 0 || steps > kMaxSteps || stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  probe_meta_scale_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(meta), static_cast<const float*>(x),
      static_cast<float*>(out), n, steps, stride);
  return (int)cudaGetLastError();
}
