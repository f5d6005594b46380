// Gather-step probes: one slab step of the dual-gather SpMV and two
// neighbours of it, summed over every slab into one (8, 128) block.
//
// Replaces three Pallas kernels:
//  * dual:   dual_kernel of benchmarks/probe_dualgather.py (dual_call,
//            pallas_call at :67)
//  * single: single_kernel of the same script (single_call, pallas_call
//            at :179)
//  * pooled: pooled_kernel of benchmarks/probe_sublane_slice.py
//            (pooled_call, pallas_call at :66)
// Each walks n_groups groups of `group` slabs; slab (g, b) holds planes
// idxA, idxB (int8) and vals (fp32) of (8, 128), and takes an (8, 128)
// window xw of x (xp, S rows of 128):
//  * single, dual: xw = xp[8w : 8w+8], w = win[g, b]
//  * pooled:       xw[r] = xp[ptr[g, b, r]]  (each sublane its own chunk)
// and adds, for every sublane u and lane l,
//  * single:       vals[u, l] * xw[u, idxB[u, l]]
//  * dual, pooled: vals[u, l] * xw[idxA[u, c], c],  c = idxB[u, l]
// into out[0, l]; rows 1..7 of out stay 0.  The chunk index is read at
// the routed lane c, as the TPU kernel's two take_along_axis calls (axis
// 0 by idxA, then axis 1 by idxB) compose.
//
// What bounds it: bytes.  A slot reads 4 bytes of value and one byte of
// each index plane it uses, and does one FMA; x (S*512 bytes) and the
// window indices are read from L1/L2.
//
// Design: the row-lane walk's geometry (rowlane.cuh): 128 threads, one a
// lane; a block takes slabs_per_block contiguous slabs and keeps its
// lane's sum in a register; the 8 sublanes of a slab are unrolled into
// independent load chains.  The TPU grid adds every group into one output
// block in order; here each block adds its sum with one atomicAdd a lane
// into the zeroed output, so only the fp32 summation order varies.  Index
// planes are read as unsigned bytes; a lane index >= 128, a chunk index
// >= 8 or an x row outside [0, S) contributes 0.
#include "rowlane.cuh"

namespace {

enum class Mode { kSingle, kDual, kPooled };

template <Mode kMode>
__global__ void __launch_bounds__(rl::kThreads)
    probe_gather_walk(const int32_t* __restrict__ win,
                      const uint8_t* __restrict__ idxA,
                      const uint8_t* __restrict__ idxB,
                      const float* __restrict__ vals,
                      const float* __restrict__ xp, float* __restrict__ out,
                      long long n_slabs, int S, int spb) {
  const int l = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * spb;
  const long long s1 = min(s0 + spb, n_slabs);
  float acc = 0.f;
  for (long long s = s0; s < s1; ++s) {
    const long long pb = s * rl::kSlab;
    const long long w8 = kMode == Mode::kPooled ? 0 : 8LL * __ldg(win + s);
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < rl::kSub; ++u) {
      const long long at = pb + u * rl::kLanes;
      const unsigned c = __ldg(idxB + at + l);
      long long r;
      if (kMode == Mode::kSingle) {
        r = w8 + u;
      } else {
        const unsigned a = c < rl::kLanes ? __ldg(idxA + at + c) : 8u;
        if (kMode == Mode::kDual)
          r = a < rl::kSub ? w8 + a : -1;
        else
          r = a < rl::kSub ? (long long)__ldg(win + s * rl::kSub + a) : -1;
      }
      const bool ok = c < rl::kLanes && r >= 0 && r < S;
      const float xv = ok ? __ldg(xp + r * rl::kLanes + c) : 0.f;
      part = fmaf(__ldg(vals + at + l), xv, part);
    }
    acc += part;
  }
  if (s0 < s1) atomicAdd(out + l, acc);
}

}  // namespace

// mode: 0 single, 1 dual, 2 pooled.  win: the (n_slabs,) window numbers
// (single, dual) or the (n_slabs * 8,) chunk rows (pooled), int32; idxA
// (ignored by single), idxB: (n_slabs * 1024,) int8; vals (n_slabs * 1024,)
// fp32; xp (S * 128,) fp32; out (1024,) fp32, zeroed by the caller.
// Returns the cudaError_t of the launch.
extern "C" int probe_gather_step(int mode, const void* win, const void* idxA,
                                 const void* idxB, const void* vals,
                                 const void* xp, void* out,
                                 long long n_slabs, int S, void* stream) {
  if (n_slabs <= 0 || S <= 0 || mode < 0 || mode > 2 ||
      (mode != 0 && !idxA))
    return (int)cudaErrorInvalidValue;
  const int spb = rl::slabs_per_block(n_slabs);
  const unsigned blocks = (unsigned)((n_slabs + spb - 1) / spb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(win);
  const uint8_t* a = static_cast<const uint8_t*>(idxA);
  const uint8_t* b = static_cast<const uint8_t*>(idxB);
  const float* v = static_cast<const float*>(vals);
  const float* x = static_cast<const float*>(xp);
  float* o = static_cast<float*>(out);
  if (mode == 0)
    probe_gather_walk<Mode::kSingle><<<blocks, rl::kThreads, 0, st>>>(
        w, a, b, v, x, o, n_slabs, S, spb);
  else if (mode == 1)
    probe_gather_walk<Mode::kDual><<<blocks, rl::kThreads, 0, st>>>(
        w, a, b, v, x, o, n_slabs, S, spb);
  else
    probe_gather_walk<Mode::kPooled><<<blocks, rl::kThreads, 0, st>>>(
        w, a, b, v, x, o, n_slabs, S, spb);
  return (int)cudaGetLastError();
}
