// Order keys and the shared-memory bitonic sort of B3's top-k stage
// (`topk_winners` in `mips_fused_topk.cu`). B5 (`bitonic_topk.cu`) keys the
// same order as 32-bit words of its own.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace {

// The float's bits made to sort as a signed integer (a total order on f32:
// -NaN < -inf < ... < -0 < +0 < ... < +inf < NaN), in the high 32 bits of a
// 64-bit key.
__device__ __forceinline__ long long float_order_bits(float v) {
  const int b = __float_as_int(v);
  const int ks = b ^ ((b >> 31) & 0x7FFFFFFF);
  return (long long)((unsigned long long)(unsigned int)ks << 32);
}

// The inverse of float_order_bits on a key's high 32 bits.
__device__ __forceinline__ float key_float(long long key) {
  const int ks = (int)(key >> 32);
  return __int_as_float(ks ^ ((ks >> 31) & 0x7FFFFFFF));
}

// Sort s[0, p) descending, p a power of two, all threads of the block.
__device__ void bitonic_sort_desc(long long* s, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const long long a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace
