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
// functions per leaf and one store per element, so K2 is bound by the store
// of C n1 n2 values (8 MB at C = 8, n = 500, float32) and K2b by the read of
// the cotangent of the same size, then by the exp/sin throughput.  Neither
// has reuse to exploit; what costs is the work around each element.  Design:
//   * the formula comes in as a small int32 descriptor (per leaf: kind,
//     input column, extra slot; per term: its leaves), so one build serves
//     every formula.  The launcher passes it to the kernel by value, as a
//     __grid_constant__ parameter: every thread reads the same word through
//     the constant cache, with no load from global memory and no barrier
//     (a copy into shared memory cost a global round trip and a barrier
//     before any element, most of a small launch on the H100);
//   * a group of 64 threads computes a 32 x 32 tile of outputs, 4 x 4 in
//     registers a thread.  The formula is read once a leaf: the thread
//     derives the leaf's constants from the chain's parameters (SqExp's
//     -1/2l^2, 1/l for OU and the Materns, pi/period and -2/l^2 for
//     Periodic, 1/(2 alpha l^2) and -alpha for RQ), so no element divides
//     (but RQ's derivative, t/(1+t)), loads its 4 row and 4 column inputs
//     (the L1 cache serves the tile's threads), runs one switch on the
//     kind, the same for the whole block, then an unrolled loop over its 16
//     elements;
//   * a symmetric gram visits only the tiles on and below the diagonal.  An
//     off-diagonal tile stores itself and, from the same registers, its
//     mirror (each thread writes a column of its 4 x 4 block as a row, 8
//     rows of 64 bytes a warp, every 32-byte sector whole), so the output
//     is symmetric bit for bit and the leaf work halves.  Leaves are
//     evaluated on |x - x'| (and x x'), so a diagonal tile is symmetric bit
//     for bit too;
//   * where n2 % 4 == 0 a thread's row of 4 is one 16-byte access (float4,
//     or two double2); other n2 take a scalar path;
//   * shape parameters (Periodic period, RQ alpha) are read from the
//     parameter vector, so they may be inferred;
//   * bare leaves key on global row ids (gaplac_tpu/ops/gram.py:113-118,
//     gaplac_tpu/kernels/covariance.py::gram_cross_with_rowids): row i of
//     X1 is row r1 + i of the data and column j of X2 row r2 + j.  Bare
//     Noise adds p where r1 + i == r2 + j, and `diag` (the jitter) is added
//     there too; bare Constant adds p everywhere.  A symmetric gram is
//     r1 == r2 == 0; a cross gram without offsets keys on nothing, so bare
//     Noise and `diag` add nothing there.  The left-looking factorization
//     (ops/fused.py) takes a panel K[j0:, j0:j1] as a cross gram at
//     offsets (j0, j0), whose diagonal lies inside it.  A thread's 4 x 4
//     block holds ids that match where r - q == m, m = (r2 - r1) + j0 - i0
//     from its first row i0 and column j0: a block has a match only where
//     |m| < 4, so any tile whose row and column ranges overlap can hold one,
//     and the test is one integer compare an element.
// K2 launches one group a block over a (tiles, C) grid, with no shared
// memory and no barrier: 136 blocks at (1, 500, 500), a wave of the card's
// 132 SMs.
//
// K2b reads the cotangent gK once and forms
//   dtheta[c, s] = sum_ij gK[c,i,j] dK[c,i,j]/dtheta_s
// with closed-form leaf derivatives.  dK/dtheta is symmetric, so a
// symmetric gram sums over the lower tiles only, an off-diagonal tile with
// the weight gK_ij + gK_ji (its mirror read as rows of 4, as K2 writes it),
// a diagonal tile with gK_ij: exactly the full sum, for any gK.  A thread
// sums its 16 elements of each leaf in registers, then one warp reduction
// per leaf per tile; a term of one leaf forms no product of others (longer
// terms multiply the other leaves' values, which avoids dividing by a
// leaf, since Cat gives zeros).  One launch, and a sum in a fixed order: a
// thread-block cluster per chain (16 blocks where the batch's clusters of
// 16 fit on the card at once, else 8) takes the chain's tiles in a fixed
// stride, BWD_GROUPS tiles a block at a time, with no barrier between
// rounds; each warp adds into its own row of shared memory, each block
// sums its warps in order and stores the row into rank 0's shared memory
// (distributed shared memory), and after one cluster barrier rank 0 sums
// the rows in rank order.  No atomics, no scratch in global memory: every
// launch gives the same bits.  A chain's cotangent is read by the
// cluster's 8 or 16 SMs only, so K2b is held by their share of the L2
// bandwidth.
#include <cooperative_groups.h>

#include "common.cuh"

namespace gaplac {
namespace {

namespace cg = cooperative_groups;

constexpr int MAX_LEAVES = 32;
constexpr int MAX_TERMS = 32;
constexpr int MAX_PARAMS = 64;
constexpr int TILE = 32;                          // a group's tile of outputs
constexpr int RB = 4;                             // register block: 4 x 4 a thread
constexpr int GROUP = (TILE / RB) * (TILE / RB);  // 64 threads a tile
// Tiles a K2b block takes at a time: float32 nine (576 threads at up to 112
// registers, one block an SM), so a cluster of 16 takes the 136 lower tiles
// of n = 500 in one round; float64, at about twice the registers, four.
template <typename T>
constexpr int BWD_GROUPS = sizeof(T) == 4 ? 9 : 4;
template <typename T>
constexpr int BWD_THREADS = GROUP * BWD_GROUPS<T>;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 64;

enum Kind {
  K_SQEXP = 0, K_OU, K_LINEAR, K_CAT, K_NOISE, K_CONST,
  K_MATERN32, K_MATERN52, K_PERIODIC, K_RQ
};

constexpr double SQRT3 = 1.7320508075688772;
constexpr double SQRT5 = 2.23606797749979;
constexpr double PI = 3.141592653589793;

// The formula, passed to the kernels by value (a __grid_constant__
// parameter: read through the constant cache, the same word for every
// thread, with no load from global memory and no barrier).
struct Formula {
  int L, NT;
  int kind[MAX_LEAVES];
  int col[MAX_LEAVES];
  int extra[MAX_LEAVES];
  int term_ptr[MAX_TERMS + 1];
  int term_leaf[MAX_LEAVES];
};

// A leaf's hyperparameter p and the constants derived from it and its shape
// parameter e (see leaf_constants), once a leaf a thread.
template <typename T>
struct LeafC {
  T p, c1, c2, c3, c4;
};

template <typename T>
__device__ __forceinline__ LeafC<T> leaf_constants(int kind, T p, T e) {
  LeafC<T> k = {p, T(0), T(0), T(0), T(0)};
  switch (kind) {
    case K_SQEXP: k.c1 = T(-0.5) / (p * p); k.c2 = T(1) / (p * p * p); break;
    case K_OU: k.c1 = T(1) / p; k.c2 = T(1) / (p * p); break;
    case K_MATERN32: k.c1 = T(SQRT3) / p; k.c2 = T(1) / p; break;
    case K_MATERN52: k.c1 = T(SQRT5) / p; k.c2 = T(1) / (T(3) * p); break;
    case K_PERIODIC:
      k.c1 = T(PI) / e;
      k.c2 = T(-2) / (p * p);
      k.c3 = T(4) / (p * p * p);
      k.c4 = T(2) / (p * p * e);
      break;
    case K_RQ: k.c1 = T(1) / (T(2) * e * p * p); k.c2 = -e; k.c3 = T(2) * e / p; break;
    default: break;
  }
  return k;
}

// Leaf K at inputs a (row) and b (column); every kind depends on them only
// through |a - b|, (a - b)^2 or a b, so k(a, b) == k(b, a) bit for bit.
template <int K, typename T>
__device__ __forceinline__ T leaf_val(const LeafC<T>& k, T a, T b) {
  const T d = a - b;
  if constexpr (K == K_SQEXP) return exp_(k.c1 * (d * d));
  if constexpr (K == K_OU) return exp_(-abs_(d) * k.c1);
  if constexpr (K == K_LINEAR) return a * b + k.p;
  if constexpr (K == K_CAT) return d == T(0) ? T(1) : T(0);
  if constexpr (K == K_NOISE) return d == T(0) ? k.p : T(0);
  if constexpr (K == K_CONST) return k.p;
  if constexpr (K == K_MATERN32) {
    const T r = abs_(d) * k.c1;
    return (T(1) + r) * exp_(-r);
  }
  if constexpr (K == K_MATERN52) {
    const T r = abs_(d) * k.c1;
    return (T(1) + r + r * r * T(1.0 / 3.0)) * exp_(-r);
  }
  if constexpr (K == K_PERIODIC) {
    const T s = sin_(abs_(d) * k.c1);
    return exp_(k.c2 * (s * s));
  }
  if constexpr (K == K_RQ) return pow_(T(1) + d * d * k.c1, k.c2);
  return T(0);
}

// d leaf / d p into dp and d leaf / d e into de (0 without a shape parameter)
template <int K, typename T>
__device__ __forceinline__ void leaf_grad(const LeafC<T>& k, T a, T b, T& dp, T& de) {
  const T d = a - b;
  de = T(0);
  if constexpr (K == K_SQEXP) {
    const T dd = d * d;
    dp = exp_(k.c1 * dd) * dd * k.c2;
  } else if constexpr (K == K_OU) {
    const T ad = abs_(d);
    dp = exp_(-ad * k.c1) * ad * k.c2;
  } else if constexpr (K == K_LINEAR || K == K_CONST) {
    dp = T(1);
  } else if constexpr (K == K_CAT) {
    dp = T(0);
  } else if constexpr (K == K_NOISE) {
    dp = d == T(0) ? T(1) : T(0);
  } else if constexpr (K == K_MATERN32) {
    const T r = abs_(d) * k.c1;
    dp = r * r * exp_(-r) * k.c2;
  } else if constexpr (K == K_MATERN52) {
    const T r = abs_(d) * k.c1;
    dp = r * r * (T(1) + r) * exp_(-r) * k.c2;
  } else if constexpr (K == K_PERIODIC) {
    const T ang = abs_(d) * k.c1;  // sin(2a) a is even in a
    const T s = sin_(ang);
    const T v = exp_(k.c2 * (s * s));
    dp = v * k.c3 * (s * s);
    de = v * k.c4 * sin_(T(2) * ang) * ang;
  } else if constexpr (K == K_RQ) {
    const T t = d * d * k.c1;
    const T v = pow_(T(1) + t, k.c2);
    const T q = t / (T(1) + t);
    dp = v * k.c3 * q;
    de = v * (q - log1p_(t));
  } else {
    dp = T(0);
  }
}

// Where in a thread's 4 x 4 block the global row ids match: element (r, q)
// where r - q == m (NO_MATCH: none).
struct Place {
  int m;
};
constexpr int NO_MATCH = RB;  // |r - q| < RB never reaches it

// m of the block at rows i0.., columns j0.. under the id shift r2 - r1, or
// NO_MATCH when bare leaves key on nothing
__device__ __forceinline__ int match_of(int keyed, long long shift, int i0, int j0) {
  const long long m = shift + j0 - i0;
  return keyed && m > -RB && m < RB ? static_cast<int>(m) : NO_MATCH;
}

// A leaf's row inputs a[r] and column inputs b[q] at the thread's rows and
// columns, for input column col, from global memory (the L1 cache serves a
// tile's threads); rows past the end are clamped to the last, and what is
// computed there is neither stored nor summed.  off1[r] and off2[q] are
// row offsets, row * d.
template <typename T>
struct Inputs {
  const T* X1;
  const T* X2;
  int off1[RB], off2[RB];
  __device__ __forceinline__ void operator()(int col, T (&a)[RB], T (&b)[RB]) const {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      a[r] = __ldg(X1 + off1[r] + col);
      b[r] = __ldg(X2 + off2[r] + col);
    }
  }
};

template <int K, typename T>
__device__ __forceinline__ void mul_leaf_k(const LeafC<T>& k, const T (&a)[RB], const T (&b)[RB],
                                           T (&v)[RB][RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int q = 0; q < RB; ++q) v[r][q] *= leaf_val<K>(k, a[r], b[q]);
}

// v *= leaf (kind, col, k) over the thread's block: one switch, then an
// unrolled loop.  Bare leaves (col < 0) key on row identity.
template <typename T>
__device__ __forceinline__ void mul_leaf(int kind, int col, const LeafC<T>& k, const Inputs<T>& in,
                                         Place pl, T (&v)[RB][RB]) {
  if (col < 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < RB; ++q)
        v[r][q] *= kind == K_CONST || r - q == pl.m ? k.p : T(0);
    return;
  }
  T a[RB], b[RB];
  in(col, a, b);
  switch (kind) {
    case K_SQEXP: mul_leaf_k<K_SQEXP>(k, a, b, v); return;
    case K_OU: mul_leaf_k<K_OU>(k, a, b, v); return;
    case K_LINEAR: mul_leaf_k<K_LINEAR>(k, a, b, v); return;
    case K_CAT: mul_leaf_k<K_CAT>(k, a, b, v); return;
    case K_NOISE: mul_leaf_k<K_NOISE>(k, a, b, v); return;
    case K_CONST: mul_leaf_k<K_CONST>(k, a, b, v); return;
    case K_MATERN32: mul_leaf_k<K_MATERN32>(k, a, b, v); return;
    case K_MATERN52: mul_leaf_k<K_MATERN52>(k, a, b, v); return;
    case K_PERIODIC: mul_leaf_k<K_PERIODIC>(k, a, b, v); return;
    case K_RQ: mul_leaf_k<K_RQ>(k, a, b, v); return;
    default: return;
  }
}

// sp += sum of w dleaf/dp, se += sum of w dleaf/de over the thread's block
template <int K, typename T>
__device__ __forceinline__ void grad_leaf_k(const LeafC<T>& k, const T (&a)[RB],
                                            const T (&b)[RB], const T (&w)[RB][RB], T& sp,
                                            T& se) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      T dp, de;
      leaf_grad<K>(k, a[r], b[q], dp, de);
      sp += w[r][q] * dp;
      if constexpr (K == K_PERIODIC || K == K_RQ) se += w[r][q] * de;
    }
}

template <typename T>
__device__ __forceinline__ void grad_leaf(int kind, int col, const LeafC<T>& k, const Inputs<T>& in,
                                          Place pl, const T (&w)[RB][RB], T& sp, T& se) {
  if (col < 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (kind == K_CONST || r - q == pl.m) sp += w[r][q];
    return;
  }
  if (kind == K_CAT) return;
  T a[RB], b[RB];
  in(col, a, b);
  switch (kind) {
    case K_SQEXP: grad_leaf_k<K_SQEXP>(k, a, b, w, sp, se); return;
    case K_OU: grad_leaf_k<K_OU>(k, a, b, w, sp, se); return;
    case K_LINEAR: grad_leaf_k<K_LINEAR>(k, a, b, w, sp, se); return;
    case K_NOISE: grad_leaf_k<K_NOISE>(k, a, b, w, sp, se); return;
    case K_CONST: grad_leaf_k<K_CONST>(k, a, b, w, sp, se); return;
    case K_MATERN32: grad_leaf_k<K_MATERN32>(k, a, b, w, sp, se); return;
    case K_MATERN52: grad_leaf_k<K_MATERN52>(k, a, b, w, sp, se); return;
    case K_PERIODIC: grad_leaf_k<K_PERIODIC>(k, a, b, w, sp, se); return;
    case K_RQ: grad_leaf_k<K_RQ>(k, a, b, w, sp, se); return;
    default: return;
  }
}

// Leaf li's constants from chain parameters pc (per thread: a few divisions
// a leaf, none an element).
template <typename T>
__device__ __forceinline__ LeafC<T> leaf_of(const Formula& f, int li, const T* pc) {
  const int e = f.extra[li];
  return leaf_constants(f.kind[li], __ldg(pc + li), e >= 0 ? __ldg(pc + e) : T(1));
}

// The thread's inputs for a tile block at rows i0.., columns j0..
template <typename T>
__device__ __forceinline__ Inputs<T> inputs_at(const T* X1, const T* X2, int n1, int n2,
                                                      int d, int i0, int j0) {
  Inputs<T> in = {X1, X2, {}, {}};
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    in.off1[r] = min(i0 + r, n1 - 1) * d;
    in.off2[r] = min(j0 + r, n2 - 1) * d;
  }
  return in;
}

// tile t of the lower triangle, row by row: (0,0) (1,0) (1,1) (2,0) ...
__device__ __forceinline__ void tri_tile(int t, int& I, int& J) {
  int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (i > 0 && i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  I = i;
  J = t - i * (i + 1) / 2;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[RB]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[RB]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

__host__ __device__ __forceinline__ int tiles_of(int n) { return (n + TILE - 1) / TILE; }

// K2: one 32 x 32 tile of chain blockIdx.y's gram a block; no shared
// memory and no barrier.
template <typename T>
__global__ void __launch_bounds__(GROUP)
gram_fwd_kernel(const __grid_constant__ Formula f, const T* X1, const T* X2, int n1, int n2,
                int d, const T* params, int P, T diag, int symmetric, int keyed, long long shift,
                T* out) {
  const int c = blockIdx.y, tid = threadIdx.x;
  int I, J;
  if (symmetric) {
    tri_tile(blockIdx.x, I, J);
  } else {
    const int ct = tiles_of(n2);
    I = blockIdx.x / ct;
    J = blockIdx.x - I * ct;
  }
  const int i0 = I * TILE + tid / (TILE / RB) * RB, j0 = J * TILE + tid % (TILE / RB) * RB;
  const Place pl = {match_of(keyed, shift, i0, j0)};
  const Inputs<T> in = inputs_at(X1, X2, n1, n2, d, i0, j0);
  const T* pc = params + static_cast<size_t>(c) * P;
  const bool vec = n2 % 4 == 0;  // a row of 4 is one 16-byte access
  T acc[RB][RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int q = 0; q < RB; ++q) acc[r][q] = T(0);
  for (int t = 0; t < f.NT; ++t) {
    T v[RB][RB];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < RB; ++q) v[r][q] = T(1);
    for (int m = f.term_ptr[t]; m < f.term_ptr[t + 1]; ++m) {
      const int li = f.term_leaf[m];
      mul_leaf(f.kind[li], f.col[li], leaf_of(f, li, pc), in, pl, v);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < RB; ++q) acc[r][q] += v[r][q];
  }
  if (pl.m != NO_MATCH) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (r - q == pl.m) acc[r][q] += diag;
  }

  T* o = out + static_cast<size_t>(c) * n1 * n2;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = i0 + r;
    if (i >= n1) break;
    T* row = o + static_cast<size_t>(i) * n2 + j0;
    if (vec) {
      if (j0 < n2) store4(row, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (j0 + q < n2) row[q] = acc[r][q];
    }
  }
  if (symmetric && I != J) {  // the mirror tile, a column of the block a row
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int j = j0 + q;
      if (j >= n2) break;
      T* row = o + static_cast<size_t>(j) * n2 + i0;
      if (vec) {
        if (i0 < n1) store4(row, acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
      } else {
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (i0 + r < n1) row[r] = acc[r][q];
      }
    }
  }
}

// The two halves of a cluster barrier, split so that the work between them
// hides its latency (relaxed: it orders no memory, only says "started").
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// K2b: one cluster per chain (blockIdx.y); ntiles the chain's tiles (the
// lower triangle's when symmetric).  Group g of block `rank` takes tiles
// (round * CL + rank) * BWD_GROUPS + g, with no barrier between rounds: a
// group reads its inputs from global memory (L1), not from a staged tile.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS<T>)
gram_bwd_kernel(const __grid_constant__ Formula f, const T* X1, const T* X2, int n1, int n2,
                int d, const T* params, int P, int symmetric, int keyed, long long shift,
                int ntiles, const T* gK, T* dparams) {
  constexpr int WARPS = BWD_THREADS<T> / 32;
  __shared__ T wacc[WARPS][MAX_PARAMS];  // a warp's sums, written by its lane 0 only
  __shared__ T gathered[MAX_CLUSTER][MAX_PARAMS];  // rank 0's: a row from each block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = static_cast<int>(cluster.num_blocks());
  const int c = blockIdx.y, tid = threadIdx.x;
  const int group = tid / GROUP, gt = tid % GROUP, warp = tid >> 5, lane = tid & 31;
  cluster_arrive();  // matched by cluster_wait() before the first remote store
  if (lane == 0)
    for (int k = 0; k < P; ++k) wacc[warp][k] = T(0);
  const T* pc = params + static_cast<size_t>(c) * P;
  const T* G = gK + static_cast<size_t>(c) * n1 * n2;
  const bool vec = n2 % 4 == 0;  // a row of 4 is one 16-byte access
  const int ct = tiles_of(n2);
  for (int t = rank * BWD_GROUPS<T> + group; t < ntiles; t += CL * BWD_GROUPS<T>) {
    int I, J;  // the same for both warps of a group
    if (symmetric) {
      tri_tile(t, I, J);
    } else {
      I = t / ct;
      J = t - I * ct;
    }
    const int i0 = I * TILE + gt / (TILE / RB) * RB, j0 = J * TILE + gt % (TILE / RB) * RB;
    const Place pl = {match_of(keyed, shift, i0, j0)};
    const Inputs<T> in = inputs_at(X1, X2, n1, n2, d, i0, j0);
    // the weights: gK, plus its mirror below the diagonal of a symmetric gram
    T w[RB][RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r;
      const T* row = G + static_cast<size_t>(i) * n2 + j0;
      if (vec && i < n1 && j0 < n2) {
        load4(row, w[r]);
      } else {
#pragma unroll
        for (int q = 0; q < RB; ++q) w[r][q] = i < n1 && j0 + q < n2 ? row[q] : T(0);
      }
    }
    if (symmetric && I != J) {
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int j = j0 + q;
        const T* row = G + static_cast<size_t>(j) * n2 + i0;
        T m[RB];
        if (vec && j < n2 && i0 < n1) {
          load4(row, m);
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r) m[r] = j < n2 && i0 + r < n1 ? row[r] : T(0);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) w[r][q] += m[r];
      }
    }
    for (int tt = 0; tt < f.NT; ++tt) {
      const int m0 = f.term_ptr[tt], m1 = f.term_ptr[tt + 1];
      for (int m = m0; m < m1; ++m) {
        const int li = f.term_leaf[m];
        T sp_sum = T(0), se_sum = T(0);
        if (m1 - m0 == 1) {
          grad_leaf(f.kind[li], f.col[li], leaf_of(f, li, pc), in, pl, w, sp_sum, se_sum);
        } else {
          T o[RB][RB];  // w times the term's other leaves
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int q = 0; q < RB; ++q) o[r][q] = w[r][q];
          for (int m2 = m0; m2 < m1; ++m2) {
            if (m2 == m) continue;
            const int l2 = f.term_leaf[m2];
            mul_leaf(f.kind[l2], f.col[l2], leaf_of(f, l2, pc), in, pl, o);
          }
          grad_leaf(f.kind[li], f.col[li], leaf_of(f, li, pc), in, pl, o, sp_sum, se_sum);
        }
        const int e = f.extra[li];  // the same for the whole block
        sp_sum = warp_sum(sp_sum);
        if (e >= 0) se_sum = warp_sum(se_sum);
        if (lane == 0) {
          wacc[warp][li] += sp_sum;
          if (e >= 0) wacc[warp][e] += se_sum;
        }
      }
    }
  }

  // each block sums its warps in order and stores the row into rank 0's
  // shared memory; after the cluster barrier rank 0 sums the rows in rank
  // order, and the other blocks may leave (no one reads their memory)
  __syncthreads();
  cluster_wait();  // every block has started: rank 0's memory may be written
  T* rows = cluster.map_shared_rank(&gathered[0][0], 0);
  for (int k = tid; k < P; k += BWD_THREADS<T>) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += wacc[w][k];
    rows[rank * MAX_PARAMS + k] = s;
  }
  cluster.sync();
  if (rank == 0) {
    for (int k = tid; k < P; k += BWD_THREADS<T>) {
      T s = T(0);
      for (int b = 0; b < CL; ++b) s += gathered[b][k];
      dparams[static_cast<size_t>(c) * P + k] = s;
    }
  }
}

// The formula from the int32 descriptor (host memory), checked so that no
// index in it leaves its arrays or the parameter vector: false if it is bad.
bool read_formula(Formula& f, const int* desc, int L, int NT, int d, int P) {
  if (L < 1 || L > MAX_LEAVES || NT < 1 || NT > MAX_TERMS || P > MAX_PARAMS || L > P)
    return false;
  f.L = L;
  f.NT = NT;
  for (int k = 0; k < L; ++k) {
    f.kind[k] = desc[k];
    f.col[k] = desc[L + k];
    f.extra[k] = desc[2 * L + k];
    if (f.kind[k] < K_SQEXP || f.kind[k] > K_RQ || f.col[k] >= d || f.extra[k] >= P)
      return false;
  }
  for (int k = 0; k <= NT; ++k) {
    f.term_ptr[k] = desc[3 * L + k];
    if (f.term_ptr[k] < 0 || f.term_ptr[k] > L || (k > 0 && f.term_ptr[k] < f.term_ptr[k - 1]))
      return false;
  }
  // the terms' leaf lists hold term_ptr[NT] entries, fewer than L when the
  // terms leave leaves out (fitplot's one-term grams): read no further
  for (int k = 0; k < f.term_ptr[NT]; ++k) {
    f.term_leaf[k] = desc[3 * L + NT + 1 + k];
    if (f.term_leaf[k] < 0 || f.term_leaf[k] >= L) return false;
  }
  return true;
}

// A symmetric gram is keyed at offsets (0, 0); offsets are not negative.
bool offsets_ok(int symmetric, int keyed, int r1, int r2) {
  return r1 >= 0 && r2 >= 0 && (!symmetric || (keyed && r1 == 0 && r2 == 0));
}

template <typename T>
int launch_fwd(const void* desc, int L, int NT, const void* X1, const void* X2, int n1, int n2,
               int d, const void* params, int C, int P, double diag, int symmetric, int keyed,
               int r1, int r2, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C == 0 || n1 == 0 || n2 == 0) return 0;
  Formula f;
  if (!read_formula(f, static_cast<const int*>(desc), L, NT, d, P) || (symmetric && n1 != n2) ||
      !offsets_ok(symmetric, keyed, r1, r2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rt = tiles_of(n1), ct = tiles_of(n2);
  const long long blocks = symmetric ? rt * (rt + 1) / 2 : rt * ct;
  if (blocks > 0x7fffffffLL || C > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  gram_fwd_kernel<T><<<dim3(static_cast<unsigned>(blocks), C), GROUP, 0,
           static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const T*>(X1), static_cast<const T*>(X2), n1, n2, d,
      static_cast<const T*>(params), P, static_cast<T>(diag), symmetric, keyed,
      static_cast<long long>(r2) - r1, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks of `kernel` the card holds at once,
// or a negative CUDA error.
template <int BLOCK, typename K>
int clusters_that_fit(K kernel, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1);
  cfg.blockDim = dim3(BLOCK);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

// The cluster size for a batch of C chains: 16 where C clusters of 16 fit at
// once, else 8 (asked once per device); negative on error.
template <typename T>
int bwd_cluster(int device, int C) {
  static int fit16[MAX_DEVICES];  // 1 + clusters of 16, 0 before the first ask
  if (device < 0 || device >= MAX_DEVICES) return -static_cast<int>(cudaErrorInvalidValue);
  if (!fit16[device]) {
    const int fit = clusters_that_fit<BWD_THREADS<T>>(gram_bwd_kernel<T>, MAX_CLUSTER);
    if (fit < 0) return fit;
    fit16[device] = fit + 1;
  }
  return fit16[device] - 1 >= C ? MAX_CLUSTER : 8;
}

template <typename T>
int launch_bwd(const void* desc, int L, int NT, const void* X1, const void* X2, int n1, int n2,
               int d, const void* params, int C, int P, int symmetric, int keyed, int r1, int r2,
               const void* gK, void* dparams, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C == 0 || P == 0) return 0;
  Formula f;
  if (!read_formula(f, static_cast<const int*>(desc), L, NT, d, P) || (symmetric && n1 != n2) ||
      !offsets_ok(symmetric, keyed, r1, r2) || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rt = tiles_of(n1), ct = tiles_of(n2);
  const long long ntiles = symmetric ? rt * (rt + 1) / 2 : rt * ct;
  if (ntiles > 0x7fffffffLL - MAX_CLUSTER * BWD_GROUPS<T>)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int cluster = bwd_cluster<T>(device, C);
  if (cluster < 0) return -cluster;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, C);
  cfg.blockDim = dim3(BWD_THREADS<T>);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gram_bwd_kernel<T>, f, static_cast<const T*>(X1),
                           static_cast<const T*>(X2), n1, n2, d, static_cast<const T*>(params),
                           P, symmetric, keyed, static_cast<long long>(r2) - r1,
                           static_cast<int>(ntiles), static_cast<const T*>(gK),
                           static_cast<T*>(dparams));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gaplac

// out (C, n1, n2) <- gram; desc the int32 formula descriptor in host memory;
// X1 (n1, d), X2 (n2, d) row-major; params (C, P); a symmetric gram passes
// X2 == X1 and keyed = 1 at offsets (0, 0); keyed = 1 makes bare leaves and
// diag key on the global row ids r1 + i and r2 + j
extern "C" int gaplac_gram_fwd_f32(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, double diag, int symmetric, int keyed, int r1,
                                   int r2, void* out, int device, void* stream) {
  return gaplac::launch_fwd<float>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, diag,
                                   symmetric, keyed, r1, r2, out, device, stream);
}

extern "C" int gaplac_gram_fwd_f64(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, double diag, int symmetric, int keyed, int r1,
                                   int r2, void* out, int device, void* stream) {
  return gaplac::launch_fwd<double>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, diag,
                                    symmetric, keyed, r1, r2, out, device, stream);
}

// dparams (C, P) = sum_ij gK[c,i,j] dK[c,i,j]/dparams[c,:], one launch
extern "C" int gaplac_gram_bwd_f32(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, int symmetric, int keyed, int r1, int r2,
                                   const void* gK, void* dparams, int device, void* stream) {
  return gaplac::launch_bwd<float>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, symmetric,
                                   keyed, r1, r2, gK, dparams, device, stream);
}

extern "C" int gaplac_gram_bwd_f64(const void* desc, int L, int NT, const void* X1,
                                   const void* X2, int n1, int n2, int d, const void* params,
                                   int C, int P, int symmetric, int keyed, int r1, int r2,
                                   const void* gK, void* dparams, int device, void* stream) {
  return gaplac::launch_bwd<double>(desc, L, NT, X1, X2, n1, n2, d, params, C, P, symmetric,
                                    keyed, r1, r2, gK, dparams, device, stream);
}

// The cluster size K2b takes for C chains (8 or 16), or a negative CUDA
// error; f64 picks the float64 kernel.
extern "C" int gaplac_gram_bwd_cluster(int C, int f64, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return f64 ? gaplac::bwd_cluster<double>(device, C) : gaplac::bwd_cluster<float>(device, C);
}
