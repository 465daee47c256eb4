// K3: lower Cholesky factor of one SPD tile, the base case of the blocked
// factorization (ops/cholesky.py::blocked_cholesky).
//
// Replaces the Pallas kernel gaplac_tpu/ops/cholesky.py::_chol_tile_kernel
// (launched by _chol_base_pallas).  That kernel keeps one 256 x 256 tile in
// VMEM and runs an unblocked column sweep: per column j, scale the column by
// 1/sqrt(d_j) and subtract the outer product from the trailing submatrix.
//
// What does not carry over: a 256^2 float32 tile is 256 KB, more than the
// 227 KB of shared memory a block can use (float64 twice that), and more
// than a block's registers.  So the port's tile is at most 128 x 128 and the
// port's blocked recursion bottoms out at 128.
//
// What bounds it: neither flops (T^3/3, 0.7 Mflop at T = 128) nor bytes
// (2 T^2 values), but the serial depth of the sweep: T columns, each a
// block-wide barrier apart, on one SM.  Design, correct and simple first,
// with one barrier per column:
//   * one thread block of 32 x 32 threads per tile; thread (ty, tx) holds the
//     4 x 4 block of rows 4ty.., columns 4tx.. in registers for the whole
//     sweep, as the TPU kernel holds the tile in VMEM;
//   * per column j: the threads owning column j publish it to shared memory
//     (double-buffered, so the next column's publish cannot overwrite one
//     still being read); after the barrier every thread forms
//     L[i, j] = A[i, j] / sqrt(A[j, j]) for its 4 rows and 4 columns and
//     applies the rank-1 update A[i, k] -= L[i, j] L[k, j] to its
//     lower-triangle elements with k > j; the owners of column j store it;
//   * warps whose rows all lie above the pivot skip the update;
//   * only the lower triangle of the input is read (as torch.linalg.cholesky);
//     the output has zeros above the diagonal; a ragged tile (n < 128) masks
//     the rows and columns past n;
//   * a non-positive (or NaN) pivot fills the whole factor with NaN, as K1
//     and jnp.linalg.cholesky do; the Pallas kernel clamped it at 1e-30.
// On an H100 a 128-tile takes about 0.1 ms, 0.7 us a column, several times
// one column's chain of barrier, pivot load, square root, reciprocal and
// update; whether issue or latency takes the rest is not measured.  Several
// columns per barrier, several tiles per launch, wgmma and TMA are later work.
#include "common.cuh"

namespace gaplac {
namespace {

constexpr int TILE_MAX = 128;
constexpr int SIDE = 32;             // threads per side; each holds a 4 x 4 block
constexpr int THREADS = SIDE * SIDE;

template <typename T>
__global__ void __launch_bounds__(THREADS) chol_tile_kernel(const T* A, T* L, int n) {
  __shared__ T colbuf[2][TILE_MAX];
  const int tx = threadIdx.x % SIDE, ty = threadIdx.x / SIDE;  // a warp shares ty
  const int r0 = 4 * ty, c0 = 4 * tx;
  T a[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + p, k = c0 + q;
      a[p][q] = i < n && k <= i ? A[i * n + k] : T(0);
    }

  bool bad = false;
  for (int j = 0; j < n; ++j) {
    T* buf = colbuf[j & 1];
    const int jq = j & 3;
    const bool owner = tx == (j >> 2);  // this thread holds column j
    if (owner) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        T v = a[p][0];
#pragma unroll
        for (int q = 1; q < 4; ++q)
          if (q == jq) v = a[p][q];
        buf[r0 + p] = v;
      }
    }
    __syncthreads();
    const T d = buf[j];  // every thread reads the same pivot
    bad |= !(d > T(0));
    if (r0 + 3 < j) continue;  // all of this warp's rows are finished
    const T r = sqrt_(d);
    const T rinv = T(1) / r;
    T li[4], lk[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) li[p] = buf[r0 + p] * rinv;
#pragma unroll
    for (int q = 0; q < 4; ++q) lk[q] = buf[c0 + q] * rinv;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = r0 + p, k = c0 + q;
        if (k > j && i >= k) a[p][q] -= li[p] * lk[q];
      }
    if (owner) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = r0 + p;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q == jq && i >= j) a[p][q] = i == j ? r : li[p];
      }
    }
  }

  const T nan = nan_(T(0));
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + p, k = c0 + q;
      if (i < n && k < n) L[i * n + k] = bad ? nan : (k <= i ? a[p][q] : T(0));
    }
}

template <typename T>
int launch(const void* A, void* L, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (n > TILE_MAX) return static_cast<int>(cudaErrorInvalidValue);
  chol_tile_kernel<T><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gaplac

// A (n, n) row-major, SPD, n <= 128 (lower triangle read) -> L (n, n) row-major
extern "C" int gaplac_chol_tile_f32(const void* A, void* L, int n, int device, void* stream) {
  return gaplac::launch<float>(A, L, n, device, stream);
}

extern "C" int gaplac_chol_tile_f64(const void* A, void* L, int n, int device, void* stream) {
  return gaplac::launch<double>(A, L, n, device, stream);
}
