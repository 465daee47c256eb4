// K3: lower Cholesky factor of one SPD tile, the base case of the blocked
// factorization (ops/cholesky.py::blocked_cholesky).
//
// Replaces the Pallas kernel gaplac_tpu/ops/cholesky.py::_chol_tile_kernel
// (launched by _chol_base_pallas).  That kernel keeps one 256 x 256 tile in
// VMEM and runs an unblocked column sweep: per column j, scale the column by
// 1/sqrt(d_j) and subtract the outer product from the trailing submatrix.
// A 256^2 float32 tile is 256 KB, more than the 227 KB of shared memory a
// block can use, so the port's tile is at most 128 x 128 and the port's
// blocked recursion bottoms out at 128.
//
// What bounds it: neither flops (T^3/3, 0.7 Mflop at T = 128) nor bytes
// (2 T^2 values), but the serial depth of the sweep on one SM.  The design
// it replaces swept the 128 columns one at a time, 1024 threads crossing a
// block-wide barrier at every column (about 0.7 us a column on an H100).
// This design is blocked inside the tile, 32-wide panels, so a 128-tile
// crosses 8 block-wide barriers instead of 128:
//   * the tile lives in dynamic shared memory (64 KB float32, 128 KB
//     float64, rows padded to 129 values against bank conflicts), where
//     each step can reach any row; in registers, as before, the diagonal
//     block and the panel would have to be published to shared memory at
//     every panel anyway;
//   * per panel: (b) one thread per row below solves it against the
//     diagonal factor (solve_row32) and writes it back, and transposed into a
//     panel buffer; barrier; (c) each thread applies the rank-32 update to a
//     4 x 4 block of the trailing lower triangle, reading the panel buffer
//     with 16-byte loads; warps 0 and 1 take the blocks of the next diagonal
//     block and meet at a 64-thread barrier, then warp 0 (a) factors it with
//     shuffles only (common.cuh warp_chol32) while the other warps finish
//     the update; barrier.  So the diagonal sweeps after the first overlap
//     the trailing update;
//   * A and L are row-major views with leading dimensions lda and ldl, so
//     the recursion passes blocks of its matrices with no copy in or out;
//     the tile is read whole before anything is written, so L may alias A;
//   * only the lower triangle of the input is read (as torch.linalg.cholesky);
//     the output has zeros above the diagonal; a ragged tile pads itself to a
//     multiple of 32 with an identity tail and stores only its n x n corner;
//   * a non-positive (or NaN) pivot fills the whole factor with NaN, as K1
//     and jnp.linalg.cholesky do; the Pallas kernel clamped it at 1e-30.
// Several tiles per launch, and tensor cores, are later work.
#include "common.cuh"

namespace gaplac {
namespace {

constexpr int TILE_MAX = 128;
constexpr int NB = 32;                 // panel width
constexpr int THREADS = 512;
constexpr int LDS = TILE_MAX + 1;      // row stride of the tile in shared memory
constexpr int PLD = TILE_MAX - NB;     // row stride of the transposed panel buffer
constexpr int SMEM_ELEMS = TILE_MAX * LDS + NB * PLD;
constexpr int LOAD_ITERS = TILE_MAX * TILE_MAX / THREADS;
constexpr int DIAG_BLOCKS = (NB / 4) * (NB / 4 + 1) / 2;  // 4 x 4 blocks of a diagonal block

// warps 0 and 1 wait for each other (barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void named_barrier_64() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

// four consecutive values, 16-byte aligned, from shared memory
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
}

// (a) One warp factors the 32 x 32 diagonal block at k0 of the tile in place
// and sets rdiag, and bad on a failed pivot.
template <typename T>
__device__ __forceinline__ void factor_diagonal(T* S, int k0, T* rdiag, int* bad) {
  const int lane = threadIdx.x & 31;
  T* row = S + (k0 + lane) * LDS + k0;
  T x[NB], rd;
#pragma unroll
  for (int c = 0; c < NB; ++c) x[c] = c <= lane ? row[c] : T(0);
  const bool fail = warp_chol32(x, rd);
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c <= lane) row[c] = x[c];
  rdiag[lane] = rd;
  if (fail && lane == 0) *bad = 1;
}

// (c) One thread subtracts the panel's product from the t-th 4 x 4 block of
// the trailing lower triangle from m0 (numbered row by row), reading the
// transposed panel with 16-byte loads.
template <typename T>
__device__ __forceinline__ void update_block(T* S, const T* P, int m0, int t) {
  int bi = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  T acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
#pragma unroll 8
  for (int k = 0; k < NB; ++k) {
    T u[4], v[4];
    ld4(P + k * PLD + 4 * bi, u);
    ld4(P + k * PLD + 4 * bj, v);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] += u[p] * v[q];
  }
  T* s = S + (m0 + 4 * bi) * LDS + m0 + 4 * bj;  // above the diagonal: dead values
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[p * LDS + q] -= acc[p][q];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    chol_tile_kernel(const T* A, int lda, T* L, int ldl, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);  // the tile, np x np, rows LDS apart
  T* P = S + TILE_MAX * LDS;          // the panel below the diagonal, transposed
  __shared__ T rdiag[NB];
  __shared__ int bad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = (n + NB - 1) / NB * NB;
  constexpr int LOAD_BATCH = 64 / sizeof(T);

  // the lower triangle, then an identity tail up to np; LOAD_BATCH loads in
  // flight a thread before the first is stored
  for (int b = 0; b < LOAD_ITERS; b += LOAD_BATCH) {
    T v[LOAD_BATCH];
#pragma unroll
    for (int s = 0; s < LOAD_BATCH; ++s) {
      const int idx = tid + (b + s) * THREADS, i = idx / TILE_MAX, k = idx % TILE_MAX;
      v[s] = i < n && k <= i ? A[static_cast<size_t>(i) * lda + k] : T(k == i);
    }
#pragma unroll
    for (int s = 0; s < LOAD_BATCH; ++s) {
      const int idx = tid + (b + s) * THREADS, i = idx / TILE_MAX, k = idx % TILE_MAX;
      if (i < np && k <= i) S[i * LDS + k] = v[s];
    }
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  if (warp == 0) factor_diagonal(S, 0, rdiag, &bad);
  __syncthreads();
  for (int k0 = 0;; k0 += NB) {
    const int m0 = k0 + NB;
    if (bad || m0 >= np) break;

    // (b) the panel rows below, one thread a row
    for (int r = m0 + tid; r < np; r += THREADS) {
      T* row = S + r * LDS + k0;
      T x[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) x[c] = row[c];
      solve_row32(x, S + k0 * LDS + k0, LDS, rdiag);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        row[c] = x[c];
        P[c * PLD + r - m0] = x[c];
      }
    }
    __syncthreads();

    // (c) rank-32 update of the trailing lower triangle, a 4 x 4 block a
    //     thread.  Its first DIAG_BLOCKS blocks make up the next diagonal
    //     block: warps 0 and 1 update those, meet at a barrier of their own,
    //     and warp 0 (a) factors that block while the others update the rest.
    const int M = (np - m0) / 4;
    if (warp == 0) {
      update_block(S, P, m0, lane);
      named_barrier_64();  // warp 1 has updated the diagonal block's other blocks
      factor_diagonal(S, m0, rdiag, &bad);
    } else {
      if (warp == 1) {
        if (lane < DIAG_BLOCKS - 32) update_block(S, P, m0, 32 + lane);
        __syncwarp();
        named_barrier_64();
      }
      for (int t = DIAG_BLOCKS + tid - 32; t < M * (M + 1) / 2; t += THREADS - 32)
        update_block(S, P, m0, t);
    }
    __syncthreads();
  }

  const T nan = nan_(T(0));
  for (int i = warp; i < n; i += THREADS / 32)
    for (int k = lane; k < n; k += 32)
      L[static_cast<size_t>(i) * ldl + k] = bad ? nan : (k <= i ? S[i * LDS + k] : T(0));
}

template <typename T>
int launch(const void* A, int lda, void* L, int ldl, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (n > TILE_MAX || lda < n || ldl < n) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = SMEM_ELEMS * static_cast<int>(sizeof(T));
  err = cudaFuncSetAttribute(chol_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_tile_kernel<T><<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, static_cast<T*>(L), ldl, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gaplac

// A: (n, n) row-major with leading dimension lda, SPD, n <= 128 (lower
// triangle read) -> L: (n, n) row-major with leading dimension ldl
extern "C" int gaplac_chol_tile_f32(const void* A, int lda, void* L, int ldl, int n, int device,
                                    void* stream) {
  return gaplac::launch<float>(A, lda, L, ldl, n, device, stream);
}

extern "C" int gaplac_chol_tile_f64(const void* A, int lda, void* L, int ldl, int n, int device,
                                    void* stream) {
  return gaplac::launch<double>(A, lda, L, ldl, n, device, stream);
}
