// Device code shared by the Vecchia block kernels: the bounds, the
// correlation of two block rows (all four kernels), and the per-thread
// column Cholesky that builds each correlation column on the fly with
// forward / backward substitution (cond_weights.cu and
// block_loglik_parts.cu; K1 and K2 use the warp-level versions of
// vecchia_warp.cuh).  Counterpart of `_corr_cols` and `_fwd_pipeline` in
// dgp_tpu/ops/pallas_vecchia.py.
//
// Layout (the JAX package's): blocks are (m1, d, n) with the point axis
// last, coordinates pre-scaled by the lengthscales; diagonals and targets
// are (m1, n).  Invalid neighbour lanes carry sentinel coordinates, a unit
// diagonal and a zero target, which decouples them exactly; the ragged end
// of the point axis is masked by `p < n` in the kernels.
//
// In the per-thread kernels one thread owns one point p, so the threads of
// a warp read neighbouring addresses of every (row, dim) plane.  Each
// thread keeps the packed lower triangle of its factor L in a local
// array of TRI_MAX values, bounded by the compile-time M1_MAX.  At the
// slice's m1 = 26 that is 351 values, more than the 255 registers a thread
// may hold, so the array lives in local memory (L1/L2-cached).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef DGP_M1_MAX
#define DGP_M1_MAX 32
#endif

namespace dgp {

#ifndef DGP_NLEN_MAX
#define DGP_NLEN_MAX 8
#endif

constexpr int M1_MAX = DGP_M1_MAX;
constexpr int TRI_MAX = M1_MAX * (M1_MAX + 1) / 2;
// most log-lengthscale lanes the gradient kernel (K1) differentiates
constexpr int NLEN_MAX = DGP_NLEN_MAX;
constexpr int THREADS = 128;

enum KernelName : int { SEXP = 0, MATERN25 = 1 };

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }

__host__ __device__ __forceinline__ long long at(int i, int t, int d, int n, int p) {
  return ((long long)i * d + t) * n + p;
}

// Coordinates of point p's block rows read straight from a (m1, d, n) array.
template <typename T>
struct PlainCoords {
  const T* __restrict__ X;
  int d, n, p;
  __device__ __forceinline__ T operator()(int i, int t) const { return X[at(i, t, d, n, p)]; }
};

// Correlation of rows i and j over dims [t0, t1).  Both kernels are
// per-dimension products, so partial-dim results multiply together.
template <typename T, int KN, typename Coords>
__device__ __forceinline__ T corr(const Coords& x, int i, int j, int t0, int t1) {
  const T SQRT5 = T(2.23606797749978969);
  if (KN == SEXP) {
    T s = T(0);
    for (int t = t0; t < t1; ++t) {
      const T diff = x(i, t) - x(j, t);
      s += diff * diff;
    }
    return d_exp(-s);
  }
  T coef = T(1);
  T sa = T(0);
  for (int t = t0; t < t1; ++t) {
    const T a = d_abs(x(i, t) - x(j, t));
    coef *= T(1) + SQRT5 * a + (T(5) / T(3)) * a * a;
    sa += a;
  }
  return coef * d_exp(-SQRT5 * sa);
}

// Left-looking column Cholesky of point p's block: column j is built from
// col(i, j) (the correlation of rows i > j with row j) and the diagonal
// diag[j, p].  L is the packed lower triangle.
template <typename T, typename ColFn>
__device__ __forceinline__ void column_cholesky(const ColFn& col, const T* __restrict__ diag,
                                                int n, int p, int m1, T* L) {
  for (int j = 0; j < m1; ++j) {
    T sq = T(0);
    for (int k = 0; k < j; ++k) {
      const T v = L[tri(j, k)];
      sq += v * v;
    }
    const T dj = d_sqrt(diag[(long long)j * n + p] - sq);
    L[tri(j, j)] = dj;
    for (int i = j + 1; i < m1; ++i) {
      T dot = T(0);
      for (int k = 0; k < j; ++k) dot += L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = (col(i, j) - dot) / dj;
    }
  }
}

// Last element of the forward substitution L sol = y[:, p].
template <typename T>
__device__ __forceinline__ T forward_last(const T* L, const T* __restrict__ y, int n, int p,
                                          int m1) {
  T sol[M1_MAX];
  for (int i = 0; i < m1; ++i) {
    T dot = T(0);
    for (int k = 0; k < i; ++k) dot += L[tri(i, k)] * sol[k];
    sol[i] = (y[(long long)i * n + p] - dot) / L[tri(i, i)];
  }
  return sol[m1 - 1];
}

// Backward substitution L_nn^T w = L[m1-1, :m1-1] (L_nn the leading
// (m1-1)-block), written to w_out[i, p].
template <typename T>
__device__ __forceinline__ void backward_last_row(const T* L, T* __restrict__ w_out, int n,
                                                  int p, int m1) {
  const int m = m1 - 1;
  T w[M1_MAX];
  for (int i = m - 1; i >= 0; --i) {
    T acc = L[tri(m1 - 1, i)];
    for (int j = i + 1; j < m; ++j) acc -= L[tri(j, i)] * w[j];
    w[i] = acc / L[tri(i, i)];
    w_out[(long long)i * n + p] = w[i];
  }
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace dgp
