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

}  // namespace common
