// Shared device helpers for the gaplac_tpu_torch kernels.
//
// Every kernel is templated on float and double, so `--precision f64` on the
// card goes through the same code as the default float32.  The overloads
// below pick the single- or double-precision math function explicitly.
#pragma once

#include <cuda_runtime.h>

namespace gaplac {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float pow_(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float nan_(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double nan_(double) { return __longlong_as_double(0x7ff8000000000000LL); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace gaplac
