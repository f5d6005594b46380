// Device helpers shared by every sparse kernel source.
#pragma once

#include <cuda_runtime.h>

namespace common {

// Stored value i of a value plane as fp32: bf16 planes hold the upper
// 16 bits of the fp32 word.
template <bool BF16>
__device__ __forceinline__ float load_val(const void* v, long long i) {
  if (BF16)
    return __uint_as_float(
        (unsigned)__ldg(static_cast<const unsigned short*>(v) + i) << 16);
  return __ldg(static_cast<const float*>(v) + i);
}

// Stored values i..i+3 of a value plane as fp32, in one 16-byte load (8
// for bf16; i a multiple of 4), read once: the streaming hint (evict-first)
// keeps the plane from pushing x and y out of L1 and L2.
template <bool BF16>
__device__ __forceinline__ float4 stream_val4(const void* v, long long i) {
  if (BF16) {
    const uint2 h = __ldcs(reinterpret_cast<const uint2*>(
        static_cast<const unsigned short*>(v) + i));
    return make_float4(__uint_as_float(h.x << 16),
                       __uint_as_float(h.x & 0xffff0000u),
                       __uint_as_float(h.y << 16),
                       __uint_as_float(h.y & 0xffff0000u));
  }
  return __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(v) +
                                                i));
}

}  // namespace common
