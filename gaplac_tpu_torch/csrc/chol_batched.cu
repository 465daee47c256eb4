// K1: batched lower Cholesky factorization, one thread block per matrix.
//
// Replaces the Pallas kernel gaplac_tpu/ops/cholesky.py::_chol_batched_kernel
// (launched by _chol_batched_pallas; wrapped by cholesky_small_batched).
// That kernel keeps the whole padded matrix in VMEM and runs an unblocked
// column sweep (scale column j by 1/sqrt(d_j), rank-1 trailing update).
//
// What bounds it here: a block has at most 227 KB of shared memory, so at
// the sampler's n = 500 a float32 matrix (1 MB) cannot stay resident.  The
// work is n^3/3 flops per matrix on a single SM, and the sweep is serial in
// the panels.  Design: blocked right-looking factorization with a 32-wide
// panel.
//   1. The 32x32 diagonal block is loaded into shared memory and factored
//      with the TPU kernel's column sweep.
//   2. Each thread takes panel rows below it and solves them against the
//      diagonal factor (forward substitution, row held in registers).
//   3. The rank-32 update of the trailing lower triangle runs over 64x64
//      tiles, the two panel slices staged in shared memory and each thread
//      holding a 4x4 register tile.  The trailing matrix stays in global
//      memory; at C = 8 chains and n = 500 that is 8 MB, resident in the
//      50 MB L2.
// Arbitrary n, no padding: the kernel masks the ragged edge.  A
// non-positive (or NaN) pivot writes NaN over that matrix's whole factor,
// as jnp.linalg.cholesky does, so a sampler sees a divergence.  Only C of the
// card's 132 SMs are busy; filling the card and wgmma are later work.
#include "common.cuh"

namespace gaplac {
namespace {

constexpr int NB = 32;       // panel width
constexpr int TB = 64;       // trailing-update tile
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(THREADS) chol_batched_kernel(T* A, int n) {
  __shared__ T D[NB][NB + 1];
  __shared__ T Pi[TB][NB + 1];
  __shared__ T Pj[TB][NB + 1];

  T* a = A + static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x;
  bool fail = false;

  for (int k0 = 0; k0 < n && !fail; k0 += NB) {
    const int kb = min(NB, n - k0);

    // 1. factor the diagonal block in shared memory (column sweep)
    for (int idx = tid; idx < kb * kb; idx += THREADS) {
      const int r = idx / kb, c = idx % kb;
      D[r][c] = a[(k0 + r) * n + k0 + c];
    }
    __syncthreads();
    for (int j = 0; j < kb; ++j) {
      const T djj = D[j][j];  // every thread reads the same value: uniform branch
      if (!(djj > T(0))) {
        fail = true;
        break;
      }
      const T s = sqrt_(djj);
      __syncthreads();
      for (int r = j + 1 + tid; r < kb; r += THREADS) D[r][j] = D[r][j] / s;
      if (tid == 0) D[j][j] = s;
      __syncthreads();
      for (int idx = tid; idx < kb * kb; idx += THREADS) {
        const int r = idx / kb, c = idx % kb;
        if (c > j && c <= r) D[r][c] -= D[r][j] * D[c][j];
      }
      __syncthreads();
    }
    if (fail) break;
    for (int idx = tid; idx < kb * kb; idx += THREADS) {
      const int r = idx / kb, c = idx % kb;
      if (c <= r) a[(k0 + r) * n + k0 + c] = D[r][c];
    }

    // 2. panel rows below: L21 = A21 L11^{-T}.  kb < NB only for the last
    //    block, which has no rows below, so here kb == NB.
    const int m0 = k0 + kb;
    for (int r = m0 + tid; r < n; r += THREADS) {
      T* row = a + static_cast<size_t>(r) * n + k0;
      T x[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) x[c] = row[c];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        T v = x[c];
#pragma unroll
        for (int l = 0; l < NB; ++l)
          if (l < c) v -= x[l] * D[c][l];
        x[c] = v / D[c][c];
        row[c] = x[c];
      }
    }
    __syncthreads();

    // 3. trailing update of the lower triangle: A22 -= L21 L21^T
    const int ty = tid / 16, tx = tid % 16;
    for (int ti = m0; ti < n; ti += TB) {
      for (int tj = m0; tj <= ti; tj += TB) {
        for (int idx = tid; idx < TB * NB; idx += THREADS) {
          const int r = idx / NB, c = idx % NB;
          const int gi = ti + r, gj = tj + r;
          Pi[r][c] = gi < n ? a[gi * n + k0 + c] : T(0);
          Pj[r][c] = gj < n ? a[gj * n + k0 + c] : T(0);
        }
        __syncthreads();
        T acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
#pragma unroll 8
        for (int l = 0; l < NB; ++l) {
          T pi[4], pj[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) pi[r] = Pi[ty + 16 * r][l];
#pragma unroll
          for (int c = 0; c < 4; ++c) pj[c] = Pj[tx + 16 * c][l];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += pi[r] * pj[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gi = ti + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gj = tj + tx + 16 * c;
            if (gi < n && gj <= gi) a[gi * n + gj] -= acc[r][c];
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }

  // upper triangle to zero, or the whole factor to NaN on a failed pivot
  const int nn = n * n;
  const T nan = nan_(T(0));
  for (int idx = tid; idx < nn; idx += THREADS) {
    if (fail)
      a[idx] = nan;
    else if (idx % n > idx / n)
      a[idx] = T(0);
  }
}

template <typename T>
int launch(void* A, int batch, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  chol_batched_kernel<T><<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(A), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gaplac

// In-place: A (batch, n, n) row-major holds the input and receives L.
extern "C" int gaplac_chol_batched_f32(void* A, int batch, int n, int device, void* stream) {
  return gaplac::launch<float>(A, batch, n, device, stream);
}

extern "C" int gaplac_chol_batched_f64(void* A, int batch, int n, int device, void* stream) {
  return gaplac::launch<double>(A, batch, n, device, stream);
}

extern "C" const char* gaplac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
