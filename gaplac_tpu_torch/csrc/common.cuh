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
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
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

// The two steps of a 32-wide Cholesky panel that K1 and K3 share.

// One warp factors a 32 x 32 SPD block held a row a lane: lane r holds
// x[c] = A[r][c] for c <= r (what it holds above the diagonal is ignored and
// comes back undefined).  Column j's pivot and entries reach the other lanes
// by shuffles, with no barrier, and every register index is a compile-time
// constant.  On return lane r holds L[r][c] for c <= r and rdiag =
// 1 / L[r][r]; the result is true (on every lane) if a pivot was not
// positive or was NaN.
template <typename T>
__device__ __forceinline__ bool warp_chol32(T (&x)[32], T& rdiag) {
  const int lane = threadIdx.x & 31;
  bool fail = false;
  T d = __shfl_sync(0xffffffffu, x[0], 0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    fail |= !(d > T(0));
    const T rinv = rsqrt_(d);
    x[j] = lane == j ? d * rinv : x[j] * rinv;
    if (lane == j) rdiag = rinv;
    if (j + 1 < 32) {
      // the next pivot first, off the update below: on lane j + 1 the update
      // of x[j + 1] multiplies its own x[j], so this is the same value
      const T next = x[j + 1] - x[j] * x[j];
      d = __shfl_sync(0xffffffffu, next, j + 1);
    }
    // lane c's x[j] is L[c][j]; above a lane's diagonal the update is dead
#pragma unroll
    for (int c = j + 1; c < 32; ++c) x[c] -= x[j] * __shfl_sync(0xffffffffu, x[j], c);
  }
  return fail;
}

// One row of a panel below its diagonal block: x <- x L^{-T}, L the 32 x 32
// lower factor in shared memory (row stride ldl), rdiag[c] = 1 / L[c][c].
// Forward substitution, right-looking so that one step's updates are
// independent; every thread of a warp reads the same L entry (a broadcast).
template <typename T>
__device__ __forceinline__ void solve_row32(T (&x)[32], const T* L, int ldl, const T* rdiag) {
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    x[c] *= rdiag[c];
#pragma unroll
    for (int k = c + 1; k < 32; ++k) x[k] -= x[c] * L[k * ldl + c];
  }
}

}  // namespace gaplac
