// K2: batched gram of a compiled sum-of-products kernel formula, and
// K2b: its backward to the hyperparameters.
//
// K2 replaces the Pallas kernel gaplac_tpu/ops/gram.py::_make_gram_kernel
// (launched by _pallas_gram_padded; wrapped by pallas_gram).  That kernel
// computes one (256, 256) tile of K = sum_terms prod_leaves k_leaf in VMEM,
// with the formula's structure baked in at trace time and the per-leaf
// hyperparameters in SMEM.  It has no VJP; K2b is new.
//
// What bounds them here: the gram is elementwise, a few transcendental
// functions per leaf and one store per element, so it is bound by the
// store of C n^2 values (8 MB at C = 8, n = 500, float32) and by the
// exp/sin throughput, not by any reuse.  Design:
//   * one thread per element, 16 x 16 threads per block, grid
//     (column tiles, row tiles, C) over a batch of C parameter vectors;
//   * the formula comes in as a small int32 descriptor (per leaf: kind,
//     input column, extra slot; per term: its leaves), copied to shared
//     memory with the chain's parameters, so one build serves every formula
//     and no per-formula compile is needed;
//   * shape parameters (Periodic period, RQ alpha) are read from the
//     parameter vector, so they may be inferred;
//   * bare Noise adds p on i == j of a symmetric gram and nothing in a cross
//     gram; bare Constant adds p everywhere (ops/gram.py:113-118);
//   * `diag` (the jitter) is added on i == j of a symmetric gram.
// K2b reads the cotangent gK once and forms
//   dtheta[c, s] = sum_ij gK[c,i,j] dK[c,i,j]/dtheta_s
// with closed-form leaf derivatives.  The sum is taken in a fixed order, so
// every launch gives the same bits (a seeded run repeats on the card): each
// warp reduces by shuffles into its own row of shared memory, the block sums
// its 8 warp rows in warp order into a (C, blocks, P) scratch buffer, and a
// second kernel sums each (c, s) over the blocks, each thread a fixed stride
// of blocks in index order, then a tree over the threads.  No atomics.
#include "common.cuh"

namespace gaplac {
namespace {

constexpr int MAX_LEAVES = 32;
constexpr int MAX_TERMS = 32;
constexpr int MAX_PARAMS = 64;
constexpr int MAX_TERM_LEAVES = 8;
constexpr int TILE = 16;

enum Kind {
  K_SQEXP = 0, K_OU, K_LINEAR, K_CAT, K_NOISE, K_CONST,
  K_MATERN32, K_MATERN52, K_PERIODIC, K_RQ
};

constexpr double SQRT3 = 1.7320508075688772;
constexpr double SQRT5 = 2.23606797749979;
constexpr double PI = 3.141592653589793;

struct Formula {
  int kind[MAX_LEAVES];
  int col[MAX_LEAVES];
  int extra[MAX_LEAVES];
  int term_ptr[MAX_TERMS + 1];
  int term_leaf[MAX_LEAVES];
};

// desc layout (int32): kind[L] col[L] extra[L] term_ptr[NT + 1] term_leaf[L]
template <typename T>
__device__ void load_block_state(Formula& f, T* sp, const int* desc, int L, int NT,
                                 const T* params, int P, int c) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int k = tid; k < L; k += nthr) {
    f.kind[k] = desc[k];
    f.col[k] = desc[L + k];
    f.extra[k] = desc[2 * L + k];
    f.term_leaf[k] = desc[3 * L + NT + 1 + k];
  }
  for (int k = tid; k <= NT; k += nthr) f.term_ptr[k] = desc[3 * L + k];
  for (int k = tid; k < P; k += nthr) sp[k] = params[static_cast<size_t>(c) * P + k];
}

// one leaf's value; bare (col < 0) leaves key on row identity
template <typename T>
__device__ __forceinline__ T leaf_value(int kind, int col, T x1, T x2, T p, T e,
                                        bool diag_elem) {
  if (col < 0) return kind == K_CONST ? p : (diag_elem ? p : T(0));
  const T d = x1 - x2;
  switch (kind) {
    case K_SQEXP: return exp_(-d * d * (T(0.5) / (p * p)));
    case K_OU: return exp_(-abs_(d) / p);
    case K_LINEAR: return x1 * x2 + p;
    case K_CAT: return d == T(0) ? T(1) : T(0);
    case K_NOISE: return d == T(0) ? p : T(0);
    case K_CONST: return p;
    case K_MATERN32: {
      const T r = T(SQRT3) * abs_(d) / p;
      return (T(1) + r) * exp_(-r);
    }
    case K_MATERN52: {
      const T r = T(SQRT5) * abs_(d) / p;
      return (T(1) + r + r * r / T(3)) * exp_(-r);
    }
    case K_PERIODIC: {
      T s = sin_(T(PI) * d / e);
      s = s * s;
      return exp_(T(-2) * s / (p * p));
    }
    case K_RQ: return pow_(T(1) + d * d / (T(2) * e * p * p), -e);
  }
  return T(0);
}

// d leaf / d p and d leaf / d extra, given the leaf's value b
template <typename T>
__device__ __forceinline__ void leaf_grad(int kind, int col, T x1, T x2, T p, T e, T b,
                                          bool diag_elem, T& dp, T& de) {
  de = T(0);
  if (col < 0) {
    dp = kind == K_CONST ? T(1) : (diag_elem ? T(1) : T(0));
    return;
  }
  const T d = x1 - x2;
  switch (kind) {
    case K_SQEXP: dp = b * d * d / (p * p * p); return;
    case K_OU: dp = b * abs_(d) / (p * p); return;
    case K_LINEAR: dp = T(1); return;
    case K_CAT: dp = T(0); return;
    case K_NOISE: dp = d == T(0) ? T(1) : T(0); return;
    case K_CONST: dp = T(1); return;
    case K_MATERN32: {
      const T r = T(SQRT3) * abs_(d) / p;
      dp = r * r * exp_(-r) / p;
      return;
    }
    case K_MATERN52: {
      const T r = T(SQRT5) * abs_(d) / p;
      dp = r * r * (T(1) + r) * exp_(-r) / (T(3) * p);
      return;
    }
    case K_PERIODIC: {
      const T a = T(PI) * d / e;
      const T sn = sin_(a);
      dp = b * T(4) * sn * sn / (p * p * p);
      de = b * (T(2) / (p * p)) * sin_(T(2) * a) * a / e;
      return;
    }
    case K_RQ: {
      const T t = d * d / (T(2) * e * p * p);
      dp = b * T(2) * e * t / (p * (T(1) + t));
      de = b * (t / (T(1) + t) - log1p_(t));
      return;
    }
  }
  dp = T(0);
}

template <typename T>
__global__ void gram_fwd_kernel(const int* desc, int L, int NT, const T* X1, const T* X2,
                                int n1, int n2, int d, const T* params, int P, T diag,
                                int symmetric, T* out) {
  __shared__ Formula f;
  __shared__ T sp[MAX_PARAMS];
  const int c = blockIdx.z;
  load_block_state(f, sp, desc, L, NT, params, P, c);
  __syncthreads();
  const int i = blockIdx.y * TILE + threadIdx.y;
  const int j = blockIdx.x * TILE + threadIdx.x;
  if (i >= n1 || j >= n2) return;
  const bool diag_elem = symmetric && i == j;
  T acc = T(0);
  for (int t = 0; t < NT; ++t) {
    T block = T(1);
    for (int k = f.term_ptr[t]; k < f.term_ptr[t + 1]; ++k) {
      const int li = f.term_leaf[k];
      const int col = f.col[li];
      const T x1 = col >= 0 ? X1[static_cast<size_t>(i) * d + col] : T(0);
      const T x2 = col >= 0 ? X2[static_cast<size_t>(j) * d + col] : T(0);
      const T e = f.extra[li] >= 0 ? sp[f.extra[li]] : T(0);
      block *= leaf_value(f.kind[li], col, x1, x2, sp[li], e, diag_elem);
    }
    acc += block;
  }
  if (diag_elem) acc += diag;
  out[(static_cast<size_t>(c) * n1 + i) * n2 + j] = acc;
}

constexpr int BLOCK_WARPS = TILE * TILE / 32;
constexpr int REDUCE_THREADS = 256;

template <typename T>
__global__ void gram_bwd_kernel(const int* desc, int L, int NT, const T* X1, const T* X2,
                                int n1, int n2, int d, const T* params, int P,
                                int symmetric, const T* gK, T* partial) {
  __shared__ Formula f;
  __shared__ T sp[MAX_PARAMS];
  __shared__ T wacc[BLOCK_WARPS][MAX_PARAMS];  // one row per warp: no races
  const int c = blockIdx.z;
  load_block_state(f, sp, desc, L, NT, params, P, c);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < BLOCK_WARPS * MAX_PARAMS; k += blockDim.x * blockDim.y)
    wacc[k / MAX_PARAMS][k % MAX_PARAMS] = T(0);
  __syncthreads();

  const int i = blockIdx.y * TILE + threadIdx.y;
  const int j = blockIdx.x * TILE + threadIdx.x;
  const bool valid = i < n1 && j < n2;  // no early return: all lanes shuffle
  const bool diag_elem = symmetric && i == j;
  const T g = valid ? gK[(static_cast<size_t>(c) * n1 + i) * n2 + j] : T(0);
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int t = 0; t < NT; ++t) {
    const int k0 = f.term_ptr[t], k1 = f.term_ptr[t + 1];
    T vals[MAX_TERM_LEAVES];
    for (int k = k0; k < k1; ++k) {
      const int li = f.term_leaf[k];
      const int col = f.col[li];
      const T x1 = valid && col >= 0 ? X1[static_cast<size_t>(i) * d + col] : T(0);
      const T x2 = valid && col >= 0 ? X2[static_cast<size_t>(j) * d + col] : T(0);
      const T e = f.extra[li] >= 0 ? sp[f.extra[li]] : T(1);
      vals[k - k0] = valid ? leaf_value(f.kind[li], col, x1, x2, sp[li], e, diag_elem) : T(0);
    }
    for (int k = k0; k < k1; ++k) {
      const int li = f.term_leaf[k];
      const int col = f.col[li];
      T others = T(1);
      for (int m = k0; m < k1; ++m)
        if (m != k) others *= vals[m - k0];
      T dp = T(0), de = T(0);
      if (valid) {
        const T x1 = col >= 0 ? X1[static_cast<size_t>(i) * d + col] : T(0);
        const T x2 = col >= 0 ? X2[static_cast<size_t>(j) * d + col] : T(0);
        const T e = f.extra[li] >= 0 ? sp[f.extra[li]] : T(1);
        leaf_grad(f.kind[li], col, x1, x2, sp[li], e, vals[k - k0], diag_elem, dp, de);
      }
      const T w = g * others;
      const T sum_p = warp_sum(w * dp);
      const T sum_e = warp_sum(w * de);
      if (lane == 0) {
        wacc[warp][li] += sum_p;
        if (f.extra[li] >= 0) wacc[warp][f.extra[li]] += sum_e;
      }
    }
  }
  __syncthreads();
  const size_t blk = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const size_t nblk = static_cast<size_t>(gridDim.x) * gridDim.y;
  for (int k = tid; k < P; k += blockDim.x * blockDim.y) {
    T s = T(0);
    for (int w = 0; w < BLOCK_WARPS; ++w) s += wacc[w][k];
    partial[(static_cast<size_t>(c) * nblk + blk) * P + k] = s;
  }
}

// dparams[c, k] = sum over b of partial[c, b, k], in a fixed order
template <typename T>
__global__ void gram_bwd_reduce_kernel(const T* partial, int nblk, int P, T* dparams) {
  __shared__ T s[REDUCE_THREADS];
  const int k = blockIdx.x, c = blockIdx.y;
  T acc = T(0);
  for (int b = threadIdx.x; b < nblk; b += REDUCE_THREADS)
    acc += partial[(static_cast<size_t>(c) * nblk + b) * P + k];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = REDUCE_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dparams[static_cast<size_t>(c) * P + k] = s[0];
}

dim3 grid_for(int n1, int n2, int C) {
  return dim3((n2 + TILE - 1) / TILE, (n1 + TILE - 1) / TILE, C);
}

template <typename T>
int launch_fwd(const void* desc, int L, int NT, const void* X1, const void* X2, int n1, int n2,
               int d, const void* params, int C, int P, double diag, int symmetric, void* out,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C == 0 || n1 == 0 || n2 == 0) return 0;
  gram_fwd_kernel<T><<<grid_for(n1, n2, C), dim3(TILE, TILE), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(desc), L, NT, static_cast<const T*>(X1),
      static_cast<const T*>(X2), n1, n2, d, static_cast<const T*>(params), P,
      static_cast<T>(diag), symmetric, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* desc, int L, int NT, const void* X1, const void* X2, int n1, int n2,
               int d, const void* params, int C, int P, int symmetric, const void* gK,
               void* partial, void* dparams, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C == 0 || P == 0) return 0;
  const dim3 grid = grid_for(n1, n2, C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 > 0 && n2 > 0) {
    gram_bwd_kernel<T><<<grid, dim3(TILE, TILE), 0, s>>>(
        static_cast<const int*>(desc), L, NT, static_cast<const T*>(X1),
        static_cast<const T*>(X2), n1, n2, d, static_cast<const T*>(params), P, symmetric,
        static_cast<const T*>(gK), static_cast<T*>(partial));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nblk = n1 > 0 && n2 > 0 ? static_cast<int>(grid.x * grid.y) : 0;
  gram_bwd_reduce_kernel<T><<<dim3(P, C), REDUCE_THREADS, 0, s>>>(
      static_cast<const T*>(partial), nblk, P, static_cast<T*>(dparams));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gaplac

// out (C, n1, n2) <- gram; X1 (n1, d), X2 (n2, d) row-major; params (C, P)
extern "C" int gaplac_gram_fwd_f32(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, double diag, int symmetric, void* out,
                                   int device, void* stream) {
  return gaplac::launch_fwd<float>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, diag,
                                   symmetric, out, device, stream);
}

extern "C" int gaplac_gram_fwd_f64(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, double diag, int symmetric, void* out,
                                   int device, void* stream) {
  return gaplac::launch_fwd<double>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, diag,
                                    symmetric, out, device, stream);
}

// dparams (C, P) = sum_ij gK[c,i,j] dK[c,i,j]/dparams[c,:]; partial is scratch
// of (C, blocks, P), blocks = ceil(n1 / 16) * ceil(n2 / 16)
extern "C" int gaplac_gram_bwd_f32(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, int symmetric, const void* gK, void* partial,
                                   void* dparams, int device, void* stream) {
  return gaplac::launch_bwd<float>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, symmetric,
                                   gK, partial, dparams, device, stream);
}

extern "C" int gaplac_gram_bwd_f64(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, int symmetric, const void* gK, void* partial,
                                   void* dparams, int device, void* stream) {
  return gaplac::launch_bwd<double>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, symmetric,
                                    gK, partial, dparams, device, stream);
}
