// Device code shared by the Vecchia block kernels: the bounds and the
// correlation of two block rows (all four kernels; the warp-level
// factorisation and substitutions are in vecchia_warp.cuh).  Counterpart of
// `_corr_cols` in dgp_tpu/ops/pallas_vecchia.py.
//
// Layout (the JAX package's): blocks are (m1, d, n) with the point axis
// last, coordinates pre-scaled by the lengthscales; diagonals and targets
// are (m1, n).  Invalid neighbour lanes carry sentinel coordinates, a unit
// diagonal and a zero target, which decouples them exactly; the ragged end
// of the point axis is masked by `p < n` in the kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef DGP_M1_MAX
#define DGP_M1_MAX 64
#endif

namespace dgp {

// most block rows the kernels take: one row per lane of a warp up to 32,
// two rows per lane up to 64 (vecchia_warp.cuh)
constexpr int M1_MAX = DGP_M1_MAX;

enum KernelName : int { SEXP = 0, MATERN25 = 1 };

__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }

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

}  // namespace dgp
