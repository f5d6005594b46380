// Fused triangular solve x = T^-1 b over a level-ordered slab program: the
// device half of kernels/trisolve_fused.py.
//
// Replaces the Pallas kernel _fused_kernel of
// sparsematrix_tpu/kernels/trisolve_fused.py (_fused_call, pallas_call at
// :354).  x is an (S, 128) vector, S = n_win*8, that starts as inv_diag*b
// (binv, padded).  The program is a run of (level, tile) segments in
// level-major order; segment seg owns groups [seg_ptr[seg],
// seg_ptr[seg+1]) of `group` row-lane slabs each, whose entries gather x
// at columns of earlier levels (already final), and commits tile t's
// lanes with the gate aux[seg][0] and gate*inv_diag aux[seg][1]:
//     part = sum over the segment's slabs and sublanes of vals * x[col]
//     x_t  = x_t + gate*(binv_t - x_t) - part*ginv
// so rows of other levels in the same tile keep their value.
//
// What bounds it: latency.  The segments form a chain of dependent
// steps (about n_tiles + n_levels of them); the slab bytes are small.
//
// Design (trisolve.cuh): one block of 512 threads a segment, drawn from
// a ticket, segments in program order.  Before it waits, a block loads
// the planes of its first 8 slabs (each thread: 2 sublanes of its lane)
// and its gate row; then it waits until segments 0..seg-1 are committed,
// gathers x through L2, sums its 4 quarters, commits and publishes.  The
// segments of one level are independent, but the plan stores no level,
// so the walk keeps the TPU kernel's strict order.
#include <cstdint>
#include <cuda_runtime.h>

#include "trisolve.cuh"

namespace {

using ts::kLanes;
using ts::kQuarters;
using ts::kThreads;
constexpr int kPre = 8;  // slabs whose planes are loaded before the wait

// sync[0]: ticket, sync[1]: segments committed.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    fused(const uint8_t* __restrict__ s_idx, const void* __restrict__ vals,
          const int32_t* __restrict__ group_tile,
          const int32_t* __restrict__ slab_win,
          const int32_t* __restrict__ seg_ptr, const float* __restrict__ aux,
          const float* __restrict__ binv, float* x, int* sync, int group,
          int n_win) {
  __shared__ float part[kQuarters][kLanes];
  const int seg = ts::draw_ticket(sync);
  const int tid = threadIdx.x, q = tid / kLanes, l = tid % kLanes;
  const long long N = (long long)n_win * ts::kWindow;
  const int g0 = __ldg(seg_ptr + seg);
  const long long s0 = (long long)g0 * group;
  const long long s1 = (long long)__ldg(seg_ptr + seg + 1) * group;
  float pv[kPre][2];
  long long pc[kPre][2];
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const long long s = s0 + i;
    const long long w0 =
        s < s1 ? (long long)__ldg(slab_win + s) * ts::kWindow : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * q + h;
      const long long at = s * ts::kSlab + u * kLanes + l;
      pv[i][h] = s < s1 ? ts::load_val<BF16>(vals, at) : 0.f;
      pc[i][h] = s < s1 ? w0 + u * kLanes + (__ldg(s_idx + at) & 127) : N;
    }
  }
  const float gate = __ldg(aux + ((long long)seg * ts::kSub) * kLanes + l);
  const float ginv =
      __ldg(aux + ((long long)seg * ts::kSub + 1) * kLanes + l);
  const long long row = (long long)__ldg(group_tile + g0) * kLanes + l;
  // every earlier segment committed
  ts::wait_geq(sync + 1, seg);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPre; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc = fmaf(pv[i][h], pc[i][h] < N ? ts::ld_x(x, pc[i][h]) : 0.f, acc);
  for (long long s = s0 + kPre; s < s1; ++s)
    acc += ts::slab_pair<BF16>(s_idx, vals, s,
                               (long long)__ldg(slab_win + s) * ts::kWindow,
                               2 * q, l, x, N);
  const float total = ts::quarter_sum(part, q, l, acc);
  if (q == 0 && row < N) {
    const float xb = ts::ld_x(x, row);
    x[row] = xb + gate * (__ldg(binv + row) - xb) - total * ginv;
  }
  ts::signal_add(sync + 1, 1);
}

}  // namespace

// s_idx/vals (n_groups, group*8, 128) int8 / fp32|bf16; group_tile
// (n_groups,), slab_win (n_groups*group,), seg_ptr (n_segs+1,) int32; aux
// (n_segs, 8, 128) fp32; binv (S*128) fp32; x (S*128) fp32, a copy of
// binv; sync: 2 zeroed ints.  Returns the cudaError_t of the launch.
extern "C" int trisolve_fused(const void* s_idx, const void* vals,
                              const void* group_tile, const void* slab_win,
                              const void* seg_ptr, const void* aux,
                              const void* binv, void* x, void* sync,
                              int n_segs, int group, int n_win, int bf16,
                              void* stream) {
  if (n_segs <= 0 || group <= 0 || n_win <= 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s8 = static_cast<const uint8_t*>(s_idx);
  const auto gt = static_cast<const int32_t*>(group_tile);
  const auto sw = static_cast<const int32_t*>(slab_win);
  const auto sp = static_cast<const int32_t*>(seg_ptr);
  const auto ax = static_cast<const float*>(aux);
  const auto bv = static_cast<const float*>(binv);
  const auto xx = static_cast<float*>(x);
  const auto sy = static_cast<int*>(sync);
  if (bf16)
    fused<true><<<n_segs, kThreads, 0, st>>>(s8, vals, gt, sw, sp, ax, bv,
                                             xx, sy, group, n_win);
  else
    fused<false><<<n_segs, kThreads, 0, st>>>(s8, vals, gt, sw, sp, ax, bv,
                                              xx, sy, group, n_win);
  return (int)cudaGetLastError();
}
