// K1: batched lower Cholesky factorization, one thread-block cluster per
// matrix.
//
// Replaces the Pallas kernel gaplac_tpu/ops/cholesky.py::_chol_batched_kernel
// (launched by _chol_batched_pallas; wrapped by cholesky_small_batched).
// That kernel keeps the whole padded matrix in VMEM and runs an unblocked
// column sweep (scale column j by 1/sqrt(d_j), rank-1 trailing update).
// At the sampler's n = 500 a float32 matrix (1 MB) cannot stay in one
// block's 227 KB of shared memory, so the port is a blocked right-looking
// factorization with a 32-wide panel, the trailing matrix in global memory
// in place (8 MB at C = 8 chains, resident in the 50 MB L2).
//
// What bounds it: the work is n^3/3 flops a matrix, 0.005 ms for eight at the
// float32 peak, but the panels are serial.  The design it replaces ran one
// block per matrix: at C = 8 eight of the card's 132 SMs were busy, and the
// same 1.6 ms at C = 1; its diagonal sweep crossed three block-wide barriers
// a column and its trailing update walked every tile of the triangle on the
// one SM.  This design spreads each matrix over a cluster of CL blocks
// (16 where the card holds the batch's clusters of 16 at once, else the
// portable 8: at about 200 registers a thread one block fills an SM, so
// eight clusters of 16 do not fit in the card's GPCs together), which the hardware
// schedules together, so they may wait on one another (barrier.cluster,
// release/acquire) and read one another's shared memory.  Per panel:
//   (a) warp 0 of the cluster's rank-0 block factors the 32 x 32 diagonal
//       block with shuffles only (common.cuh warp_chol32), writes it to the
//       output and publishes it, with its inverse diagonal and the pivot
//       test, in its shared memory;
//   (b) every block copies the factor over distributed shared memory and
//       solves its share of the panel rows below, L21 = A21 L11^{-T}, one
//       thread a row, the rows dealt across the cluster;  cluster barrier;
//   (c) the rank-32 update of the trailing lower triangle, dealt a 64 x 64
//       tile at a time across the cluster's blocks: each block stages the
//       tile's two panel slices in shared memory and keeps a 4 x 4 register
//       tile of outputs a thread.  Rank 0 takes the tile that holds the next
//       panel's diagonal block and then runs (a) for the next panel, while
//       the other blocks share the other tiles;  cluster barrier.
// So a panel costs two cluster barriers, and only (b) and the longest
// block's share of (c) lie on the serial path.
// Reads of what another block wrote go through L2 (ld.global.cg).  Arbitrary
// n, no padding: the kernel masks the ragged edge.  A non-positive (or NaN)
// pivot writes NaN over that matrix's whole factor, as jnp.linalg.cholesky
// does, so a sampler sees a divergence.  No tensor cores: TF32 is ruled out
// for this port (reduced precision erred by up to a nat in the marginal).
// Later steps: keep the whole matrix in the cluster's distributed shared
// memory (128 KB a block at n = 500 float32 with CL = 8) instead of L2;
// look further ahead (the next panel's rows, not only its diagonal block).
#include <cooperative_groups.h>

#include "common.cuh"

namespace gaplac {
namespace {

namespace cg = cooperative_groups;

constexpr int NB = 32;        // panel width
constexpr int TB = 64;        // trailing-update tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GRID_Y = 65535;

// (a) One warp factors the diagonal block at k0 (rows past n are identity),
// writes it to the output and publishes it in D, rdiag and bad.
template <typename T>
__device__ __forceinline__ void factor_diagonal(T* a, int n, int k0, T (*D)[NB + 1], T* rdiag,
                                                int* bad) {
  const int lane = threadIdx.x & 31, kb = min(NB, n - k0);
  T* row = a + static_cast<size_t>(k0 + lane) * n + k0;
  T x[NB], rd;
#pragma unroll
  for (int c = 0; c < NB; ++c)
    x[c] = lane < kb ? (c <= lane ? __ldcg(row + c) : T(0)) : T(c == lane);
  const bool f = warp_chol32(x, rd);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    D[lane][c] = c <= lane ? x[c] : T(0);
    if (c <= lane && lane < kb) row[c] = x[c];
  }
  rdiag[lane] = rd;
  if (lane == 0) *bad = f;
}

// (c) One block subtracts L21 L21^T from the 64 x 64 tile t (the t-th of the
// trailing lower triangle from m0, row by row) in place; a 4 x 4 register
// tile of outputs a thread.  Every global load of the tile (its two panel
// slices, its outputs' old values) is in flight before the first is used.
template <typename T>
__device__ __forceinline__ void update_tile(T* a, int n, int k0, int m0, int t,
                                            T (*Pi)[NB + 1], T (*Pj)[NB + 1]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  int bi = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int ti = m0 + TB * bi, tj = m0 + TB * (t - bi * (bi + 1) / 2);
  constexpr int STAGE = TB * NB / THREADS;
  T si[STAGE], sj[STAGE], old[4][4];
#pragma unroll
  for (int s = 0; s < STAGE; ++s) {
    const int idx = tid + s * THREADS, r = idx / NB, c = idx % NB;
    const int gi = ti + r, gj = tj + r;
    si[s] = gi < n ? __ldcg(a + static_cast<size_t>(gi) * n + k0 + c) : T(0);
    sj[s] = gj < n ? __ldcg(a + static_cast<size_t>(gj) * n + k0 + c) : T(0);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gi = ti + ty + 16 * r, gj = tj + tx + 16 * c;
      old[r][c] = gi < n && gj <= gi ? __ldcg(a + static_cast<size_t>(gi) * n + gj) : T(0);
    }
#pragma unroll
  for (int s = 0; s < STAGE; ++s) {
    const int idx = tid + s * THREADS, r = idx / NB, c = idx % NB;
    Pi[r][c] = si[s];
    Pj[r][c] = sj[s];
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
      if (gi < n && gj <= gi) a[static_cast<size_t>(gi) * n + gj] = old[r][c] - acc[r][c];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) chol_batched_kernel(T* A, int n) {
  __shared__ T D[NB][NB + 1];  // the diagonal factor (rank 0's is the original)
  __shared__ T rdiag[NB];      // 1 / its diagonal
  __shared__ T Pi[TB][NB + 1];
  __shared__ T Pj[TB][NB + 1];
  __shared__ int bad;          // rank 0: the pivot test of the current panel

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = static_cast<int>(cluster.num_blocks());
  const T* D0 = cluster.map_shared_rank(&D[0][0], 0);
  const T* rdiag0 = cluster.map_shared_rank(&rdiag[0], 0);
  const int* bad0 = cluster.map_shared_rank(&bad, 0);

  T* a = A + static_cast<size_t>(blockIdx.y) * n * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool fail = false;

  if (rank == 0 && warp == 0) factor_diagonal(a, n, 0, D, rdiag, &bad);
  cluster.sync();
  for (int k0 = 0;; k0 += NB) {
    // the diagonal block at k0 is factored and published by rank 0
    if (*bad0) {
      fail = true;
      break;
    }
    const int m0 = k0 + NB;
    if (m0 >= n) break;

    // (b) panel rows below: L21 = A21 L11^{-T}, rows dealt across the cluster
    if (rank != 0) {
      T v[NB * NB / THREADS];
#pragma unroll
      for (int s = 0; s < NB * NB / THREADS; ++s) {
        const int idx = tid + s * THREADS;
        v[s] = D0[(idx / NB) * (NB + 1) + idx % NB];
      }
#pragma unroll
      for (int s = 0; s < NB * NB / THREADS; ++s) {
        const int idx = tid + s * THREADS;
        D[idx / NB][idx % NB] = v[s];
      }
      if (tid < NB) rdiag[tid] = rdiag0[tid];
    }
    __syncthreads();
    for (int r = m0 + rank + CL * tid; r < n; r += CL * THREADS) {
      T* row = a + static_cast<size_t>(r) * n + k0;
      T x[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) x[c] = __ldcg(row + c);
      solve_row32(x, &D[0][0], NB + 1, rdiag);
#pragma unroll
      for (int c = 0; c < NB; ++c) row[c] = x[c];
    }
    cluster.sync();

    // (c) trailing update of the lower triangle, A22 -= L21 L21^T, 64 x 64
    //     tiles.  Tile 0 holds the next diagonal block: rank 0 updates it and
    //     then (a) factors that block while the other ranks share the other
    //     tiles, so the factorization of the next panel's diagonal block is
    //     off the serial path and a panel costs two cluster barriers.
    const int nt = (n - m0 + TB - 1) / TB;
    const int ntiles = nt * (nt + 1) / 2;
    if (rank == 0) {
      for (int t = 0; t < (CL == 1 ? ntiles : 1); ++t) update_tile(a, n, k0, m0, t, Pi, Pj);
      if (warp == 0) factor_diagonal(a, n, m0, D, rdiag, &bad);
    } else {
      for (int t = rank; t < ntiles; t += CL - 1) update_tile(a, n, k0, m0, t, Pi, Pj);
    }
    cluster.sync();
  }

  // upper triangle to zero, or the whole factor to NaN on a failed pivot;
  // rows dealt across the cluster's warps
  const T nan = nan_(T(0));
  for (int i = rank * WARPS + warp; i < n; i += CL * WARPS)
    for (int j = fail ? lane : i + 1 + lane; j < n; j += 32)
      a[static_cast<size_t>(i) * n + j] = fail ? nan : T(0);
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// How many clusters of `cluster` blocks the card can hold at once, or a
// negative CUDA error; past the portable size of 8 after opting in.
template <typename T>
int max_active_clusters(int cluster) {
  void (*kernel)(T*, int) = chol_batched_kernel<T>;
  cudaError_t err = cudaSuccess;
  if (cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

template <typename T>
int launch(void* A, int batch, int n, int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  if (cluster < 0 || cluster > 16 || device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  // cluster 0: 16 blocks a matrix where `batch` such clusters fit on the card
  // at once, else the portable 8 (asked once per device)
  static int fit16[64];  // 1 + clusters of 16 that fit, 0 before the first ask
  const int wide = fit16[device] ? fit16[device] - 1 : max_active_clusters<T>(16);
  if (wide < 0) return -wide;
  fit16[device] = wide + 1;
  if (cluster == 0) cluster = wide >= batch ? 16 : 8;
  // past 8 blocks the kernel is already opted in, by max_active_clusters<T>(16)
  if (cluster > 8 && wide < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void (*kernel)(T*, int) = chol_batched_kernel<T>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int b0 = 0; b0 < batch; b0 += MAX_GRID_Y) {
    cfg.gridDim = dim3(cluster, min(MAX_GRID_Y, batch - b0));
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<T*>(A) + static_cast<size_t>(b0) * n * n,
                             n);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace
}  // namespace gaplac

// In-place: A (batch, n, n) row-major holds the input and receives L; one
// cluster of `cluster` blocks (8 or 16; 0 lets the launcher choose) per matrix.
extern "C" int gaplac_chol_batched_f32(void* A, int batch, int n, int cluster, int device,
                                       void* stream) {
  return gaplac::launch<float>(A, batch, n, cluster, device, stream);
}

extern "C" int gaplac_chol_batched_f64(void* A, int batch, int n, int cluster, int device,
                                       void* stream) {
  return gaplac::launch<double>(A, batch, n, cluster, device, stream);
}

// How many clusters of `cluster` blocks the card holds at once (a negative
// CUDA error on failure); f64 picks the float64 kernel.
extern "C" int gaplac_chol_batched_clusters(int cluster, int f64, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return f64 ? gaplac::max_active_clusters<double>(cluster)
             : gaplac::max_active_clusters<float>(cluster);
}

extern "C" const char* gaplac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
