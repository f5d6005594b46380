// Tile gather: out[r, j] = tab[r, idx[r, j]] for an (R, C) fp32 table and
// an (R, C) int32 index array, at any R and C.
//
// Replaces the Pallas kernel gather_kernel of
// docs/repro_dynamic_gather_shapes.py (run, pallas_call at :27), one
// jnp.take_along_axis(tab, idx, axis=1) over whole arrays in VMEM, which
// Mosaic compiled only at the (8, 128) tile (the repro records (16, 128),
// (8, 256) and (32, 128) crashing the TPU compiler).
//
// What bounds it: bytes (4 of table, 4 of index and 4 of output an
// element; no arithmetic).
//
// Design: one thread an output element over a grid-stride loop; the index
// is read coalesced, the table row from L1/L2.  No tile shape is special:
// R and C are plain arguments.  An index outside [0, C) gives 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    probe_tile_gather_kernel(const float* __restrict__ tab,
                             const int32_t* __restrict__ idx,
                             float* __restrict__ out, long long R, int C) {
  const long long n = R * C;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int i = __ldg(idx + e);
    const long long row = e / C;
    out[e] = (i >= 0 && i < C) ? __ldg(tab + row * C + i) : 0.f;
  }
}

}  // namespace

// tab (R, C) fp32, idx (R, C) int32, out (R, C) fp32, all contiguous.
// Returns the cudaError_t of the launch.
extern "C" int probe_tile_gather(const void* tab, const void* idx, void* out,
                                 long long R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (R * C + kThreads - 1) / kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  probe_tile_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), R, C);
  return (int)cudaGetLastError();
}
