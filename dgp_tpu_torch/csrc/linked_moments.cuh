// The closed-form linked-GP moments' device code shared by K5
// (linked_dense.cu) and K6 (vecchia_pred.cu): the Matern-2.5 terms of
// `ops/moments.py`, `_i_matern_1d` and `_jd_matern_1d`, term for term.
#pragma once

#include "vecchia_common.cuh"

namespace dgp {

__device__ __forceinline__ double d_erf(double x) { return erf(x); }
__device__ __forceinline__ float d_erf(float x) { return erff(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }

template <typename T>
__device__ __forceinline__ T pow4(T x) {
  const T s = x * x;
  return s * s;
}

// One query's constants of one matern dim (z_v > 0): `_jd_matern_1d`'s
// terms that do not depend on the pair.
template <typename T>
struct MaternDim {
  T zm, v, l, l2, l3, inv9l4, sqv, rs2v, muC, muD, mom4C, mom4D, mom4m;

  __device__ __forceinline__ MaternDim(T zm_, T v_, T l_) : zm(zm_), v(v_), l(l_) {
    const T SQRT5 = T(2.23606797749978969);
    l2 = l * l;
    l3 = l2 * l;
    inv9l4 = T(1) / (T(9) * pow4(l));
    sqv = d_sqrt(T(0.5) * v / T(3.14159265358979323846));
    rs2v = T(1) / d_sqrt(T(2) * v);
    muC = zm - T(2) * SQRT5 * v / l;
    muD = zm + T(2) * SQRT5 * v / l;
    mom4C = pow4(muC) + T(6) * v * muC * muC + T(3) * v * v;
    mom4D = pow4(muD) + T(6) * v * muD * muD + T(3) * v * v;
    mom4m = pow4(zm) + T(6) * v * zm * zm + T(3) * v * v;
  }
};

// E_w[k_1d(w, xa) k_1d(w, xb)], w ~ N(z_m, z_v), separable Matern-2.5:
// `moments._jd_matern_1d`'s three pieces, term for term.  Not inlined: 16
// copies of it a thread (one per pair) would only lengthen the build.
template <typename T>
__device__ __noinline__ T jd_matern(T xa, T xb, const MaternDim<T>& q) {
  const T SQRT5 = T(2.23606797749978969);
  const T x1 = xa < xb ? xa : xb;
  const T x2 = xa < xb ? xb : xa;
  const T l = q.l, l2 = q.l2, l3 = q.l3, v = q.v, zm = q.zm, inv9l4 = q.inv9l4;
  const T x11 = x1 * x1, x22 = x2 * x2, x12 = x1 * x2, s12 = x1 + x2;

  // piece 1: w < x1
  const T E30 = T(1) + (T(25) * x11 * x22 - T(3) * SQRT5 * (T(3) * l3 + T(5) * l * x12) * s12
                        + T(15) * l2 * (x11 + x22 + T(3) * x12)) * inv9l4;
  const T E31 = (T(18) * SQRT5 * l3 + T(15) * SQRT5 * l * (x11 + x22)
                 - (T(75) * l2 + T(50) * x12) * s12 + T(60) * SQRT5 * l * x12) * inv9l4;
  const T E32 = T(5) * (T(5) * x11 + T(5) * x22 + T(15) * l2 - T(9) * SQRT5 * l * s12
                        + T(20) * x12) * inv9l4;
  const T E33 = T(10) * (T(3) * SQRT5 * l - T(5) * x1 - T(5) * x2) * inv9l4;
  const T E34 = T(25) * inv9l4;
  const T mC = q.muC;
  const T E3A31 = E30 + mC * E31 + (mC * mC + v) * E32 + (mC * mC * mC + T(3) * v * mC) * E33
                  + q.mom4C * E34;
  const T E3A32 = E31 + (mC + x2) * E32 + (mC * mC + T(2) * v + x22 + mC * x2) * E33
                  + (mC * mC * mC + x22 * x2 + x2 * mC * mC + mC * x22 + T(3) * v * x2
                     + T(5) * v * mC) * E34;
  const T P1 = d_exp((T(10) * v + SQRT5 * l * (s12 - T(2) * zm)) / l2)
               * (T(0.5) * E3A31 * (T(1) + d_erf((mC - x2) * q.rs2v))
                  + E3A32 * q.sqv * d_exp(T(-0.5) * (x2 - mC) * (x2 - mC) / v));

  // piece 2: x1 < w < x2
  const T E40 = T(1) + (T(25) * x11 * x22 + T(3) * SQRT5 * (T(3) * l3 - T(5) * l * x12) * (x2 - x1)
                        + T(15) * l2 * (x11 + x22 - T(3) * x12)) * inv9l4;
  const T E41 = T(5) * (T(3) * SQRT5 * l * (x22 - x11) + T(3) * l2 * s12
                        - T(10) * x12 * s12) * inv9l4;
  const T E42 = T(5) * (T(5) * x11 + T(5) * x22 - T(3) * l2 - T(3) * SQRT5 * l * (x2 - x1)
                        + T(20) * x12) * inv9l4;
  const T E43 = T(-50) * s12 * inv9l4;
  const T E44 = T(25) * inv9l4;
  const T E4A41 = E40 + zm * E41 + (zm * zm + v) * E42 + (zm * zm * zm + T(3) * v * zm) * E43
                  + q.mom4m * E44;
  const T E4A42 = E41 + (zm + x1) * E42 + (zm * zm + T(2) * v + x11 + zm * x1) * E43
                  + (zm * zm * zm + x11 * x1 + x1 * zm * zm + zm * x11 + T(3) * v * x1
                     + T(5) * v * zm) * E44;
  const T E4A43 = E41 + (zm + x2) * E42 + (zm * zm + T(2) * v + x22 + zm * x2) * E43
                  + (zm * zm * zm + x22 * x2 + x2 * zm * zm + zm * x22 + T(3) * v * x2
                     + T(5) * v * zm) * E44;
  const T P2 = d_exp(-SQRT5 * (x2 - x1) / l)
               * (T(0.5) * E4A41 * (d_erf((x2 - zm) * q.rs2v) - d_erf((x1 - zm) * q.rs2v))
                  + E4A42 * q.sqv * d_exp(T(-0.5) * (x1 - zm) * (x1 - zm) / v)
                  - E4A43 * q.sqv * d_exp(T(-0.5) * (x2 - zm) * (x2 - zm) / v));

  // piece 3: w > x2
  const T E50 = T(1) + (T(25) * x11 * x22 + T(3) * SQRT5 * (T(3) * l3 + T(5) * l * x12) * s12
                        + T(15) * l2 * (x11 + x22 + T(3) * x12)) * inv9l4;
  const T E51 = (T(18) * SQRT5 * l3 + T(15) * SQRT5 * l * (x11 + x22)
                 + (T(75) * l2 + T(50) * x12) * s12 + T(60) * SQRT5 * l * x12) * inv9l4;
  const T E52 = T(5) * (T(5) * x11 + T(5) * x22 + T(15) * l2 + T(9) * SQRT5 * l * s12
                        + T(20) * x12) * inv9l4;
  const T E53 = T(10) * (T(3) * SQRT5 * l + T(5) * x1 + T(5) * x2) * inv9l4;
  const T E54 = T(25) * inv9l4;
  const T mD = q.muD;
  const T E5A51 = E50 - mD * E51 + (mD * mD + v) * E52 - (mD * mD * mD + T(3) * v * mD) * E53
                  + q.mom4D * E54;
  const T E5A52 = E51 - (mD + x1) * E52 + (mD * mD + T(2) * v + x11 + mD * x1) * E53
                  - (mD * mD * mD + x11 * x1 + x1 * mD * mD + mD * x11 + T(3) * v * x1
                     + T(5) * v * mD) * E54;
  const T P3 = d_exp((T(10) * v - SQRT5 * l * (s12 - T(2) * zm)) / l2)
               * (T(0.5) * E5A51 * (T(1) + d_erf((x1 - mD) * q.rs2v))
                  + E5A52 * q.sqv * d_exp(T(-0.5) * (x1 - mD) * (x1 - mD) / v));
  return P1 + P2 + P3;
}

// E_w[k_1d(w, x)] for w ~ N(z_m, v) with zX = z_m - x, separable
// Matern-2.5: `moments._i_matern_1d`, term for term; the plain correlation
// where v is not positive (a deterministic input).
template <typename T>
__device__ __forceinline__ T i_matern_1d(T zX, T v, T l) {
  const T SQRT5 = T(2.23606797749978969);
  if (!(v > T(0))) {
    const T a = d_abs(zX) / l;
    return (T(1) + SQRT5 * a + (T(5) / T(3)) * a * a) * d_exp(-SQRT5 * a);
  }
  const T muA = zX - SQRT5 * v / l;
  const T muB = zX + SQRT5 * v / l;
  const T l2 = l * l;
  const T sq = d_sqrt(T(0.5) * v / T(3.14159265358979323846)) / l;
  const T r2v = d_sqrt(T(2) * v);
  const T partA =
      d_exp((T(5) * v - T(2) * SQRT5 * l * zX) / (T(2) * l2))
      * ((T(1) + SQRT5 * muA / l + T(5) * (muA * muA + v) / (T(3) * l2)) * T(0.5)
             * (T(1) + d_erf(muA / r2v))
         + (SQRT5 + T(5) * muA / (T(3) * l)) * sq * d_exp(T(-0.5) * muA * muA / v));
  const T partB =
      d_exp((T(5) * v + T(2) * SQRT5 * l * zX) / (T(2) * l2))
      * ((T(1) - SQRT5 * muB / l + T(5) * (muB * muB + v) / (T(3) * l2)) * T(0.5)
             * (T(1) + d_erf(-muB / r2v))
         + (SQRT5 - T(5) * muB / (T(3) * l)) * sq * d_exp(T(-0.5) * muB * muB / v));
  return partA + partB;
}

}  // namespace dgp
