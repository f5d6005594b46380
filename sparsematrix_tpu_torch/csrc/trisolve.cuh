// Shared pieces of the triangular-solve kernels of trisolve_waves.cu: the
// in-order walk of a sequential program by blocks that draw their step
// from a ticket, the plane loads, and the slab gather.
//
// The TPU kernels rely on the TPU running grid steps in order: a later
// step reads x that an earlier step committed.  CUDA runs blocks in no
// order and gives no co-residency.  Here every block draws its step
// index from a global atomic ticket as its first act, so the order in
// which blocks start is the program order; a block that needs earlier
// steps' results waits on a counter of finished steps (acquire), and a
// block that finishes adds to it (release).  A block only ever waits on
// steps whose tickets were drawn before its own, by blocks that are
// running already, so the walk cannot deadlock however many steps there
// are and however few blocks the card holds at once.  blockIdx is never
// used for the order.
//
// Slab gather: a slab is an (8, 128) block of two planes, s_idx[u][l]
// (int8, c % 128) and vals[u][l]; it reads the 1024-column window w, so
// slot (u, l) is column w*1024 + u*128 + s_idx[u][l] (the column rule of
// rowlane.cuh).  Every column is bounds-checked against the length of x.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ts {

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kSlab = kSub * kLanes;
constexpr int kWindow = 1024;
constexpr int kQuarters = 4;                  // row groups of a block
constexpr int kThreads = kQuarters * kLanes;  // 512: (quarter, lane)

using common::load_val;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The block's ticket: thread 0 draws it, every thread gets it.
__device__ __forceinline__ int draw_ticket(int* counter) {
  __shared__ int t;
  if (threadIdx.x == 0) t = atomicAdd(counter, 1);
  __syncthreads();
  return t;
}

// Adds v to *flag once every thread's writes are visible device-wide.
__device__ __forceinline__ void signal_add(int* flag, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, v);
  }
}

// x written by other blocks in this launch: read through L2, not L1
__device__ __forceinline__ float ld_x(const float* x, long long i) {
  return __ldcg(x + i);
}

// Sum over sublanes u0, u0+1 of slab s at lane l: vals * x[column].
template <bool BF16>
__device__ __forceinline__ float slab_pair(const uint8_t* __restrict__ s_idx,
                                           const void* vals, long long s,
                                           long long w0, int u0, int l,
                                           const float* x, long long nx) {
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = u0 + h;
    const long long at = s * kSlab + u * kLanes + l;
    const long long col = w0 + u * kLanes + (__ldg(s_idx + at) & 127);
    const float v = load_val<BF16>(vals, at);
    acc = fmaf(v, col < nx ? ld_x(x, col) : 0.f, acc);
  }
  return acc;
}

// Sum over the block's 4 quarters of each thread's ``mine`` at its lane
// (``part``: shared, 4 x 128 floats); call with every thread.
__device__ __forceinline__ float quarter_sum(float (*part)[kLanes], int q,
                                             int l, float mine) {
  part[q][l] = mine;
  __syncthreads();
  const float s = part[0][l] + part[1][l] + part[2][l] + part[3][l];
  __syncthreads();
  return s;
}

}  // namespace ts
