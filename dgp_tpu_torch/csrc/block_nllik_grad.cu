// K1: Vecchia log-likelihood parts per point and their analytic gradient
// with respect to the log-parameters, for every node of an M-step group.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:block_nllik_grad_parts_t (Pallas
// body _grad_kernel), which JAX vmaps over the G nodes of a group.  For
// group g and point p the kernel factors the block, L L^T = K + nugget diag,
// and forms
//
//   Ly = L^-1 y,   z = L^-T e_last,
//   logdet = 2 log L[-1,-1],   quad = Ly[-1]^2,
//
// and, for each of the n_length log-lengthscale lanes and (if nugget_est)
// the log-nugget lane k,
//
//   w_k = L^-1 (dK_k z),   dlogdet_k = w_k[-1],
//   dquad_k = 2 (Ly . w_k) Ly[-1] - w_k[-1] Ly[-1]^2,
//
// the reference's analytic Vecchia gradient (dgpsi/vecchia.py:182-242).
// Coordinates arrive pre-scaled by the lengthscales, so dK/dlog l_t is
// 2 u_t^2 K (sexp) or K (5/3) a_t^2 (1 + sqrt5 a_t) / c_t (Matern-2.5) with
// u_t, a_t the coordinate difference in dim t and c_t that dim's Matern
// factor; with n_length == 1 the lane is isotropic and sums over all dims.
// The nugget lane's dK is diag(dnug).  Zero-padded dims have zero
// differences and so contribute exactly 0; sentinel lanes have zero
// correlation and dnug = 0.
//
// What bounds it on an H100: per (node, point) it reads m1*d + 3*m1 values
// (1.0 KB at the M-step's m1 = 26, d = 2 in float64) and writes 2 + 2p,
// against the ~3.6k fused multiply-adds of the factorisation and the two
// solves, p more triangular solves of ~m1^2/2 each, and m1^2 exponentials
// (one pass for the factor's columns, one for the derivative blocks).  The
// TPU version keeps K, L and a squared-distance scratch, three (m1, m1)
// arrays per point; one thread per point would need 3 * 676 * 8 = 16 KB
// of local memory here.  Reading and writing that local memory bounds the
// kernel (L1/L2 traffic and latency), not device memory or arithmetic.
//
// What the design does about it: only the packed factor L (351 values) and
// a few m1-vectors (Ly, z, and one derivative row per lane) stay resident.
// K's columns are built on the fly inside the Cholesky, as in K2-K4, and
// the derivative blocks are rebuilt from the coordinates in one pass over
// the pairs (a < j), which accumulates dK_k z for every length lane at once
// (each pair's correlation is computed once for all lanes, and the
// symmetry halves the pairs).  The G nodes of the group are a grid axis,
// so one launch serves one L-BFGS evaluation of every node.  At the
// M-step's G n = 4000 points that is 32 blocks of 128 threads on 132 SMs:
// the card is far from full, which later work may address with several
// threads per point.
#include "vecchia_common.cuh"

namespace dgp {

// Accumulates v[k][a] += dK_k[a, j] z[j] and v[k][j] += dK_k[j, a] z[a] for
// the length lanes k < n_length, over all pairs a < j.
template <typename T, int KN, typename Coords>
__device__ __forceinline__ void dk_times_z(const Coords& x, const T* z, int m1, int d,
                                           int n_length, T (*v)[M1_MAX]) {
  const T SQRT5 = T(2.23606797749978969);
  for (int k = 0; k < n_length; ++k)
    for (int a = 0; a < m1; ++a) v[k][a] = T(0);
  for (int a = 0; a < m1; ++a) {
    for (int j = a + 1; j < m1; ++j) {
      T dd[NLEN_MAX];
      T kij;
      if (KN == SEXP) {
        T s = T(0);
        for (int t = 0; t < d; ++t) {
          const T u = x(a, t) - x(j, t);
          const T sq = u * u;
          s += sq;
          if (t < n_length) dd[t] = T(2) * sq;
        }
        kij = d_exp(-s);
        if (n_length == 1) dd[0] = T(2) * s;
      } else {
        T coef = T(1), sa = T(0), esum = T(0);
        for (int t = 0; t < d; ++t) {
          const T at = d_abs(x(a, t) - x(j, t));
          const T ct = T(1) + SQRT5 * at + (T(5) / T(3)) * at * at;
          const T et = (T(5) / T(3)) * at * at * (T(1) + SQRT5 * at) / ct;
          coef *= ct;
          sa += at;
          esum += et;
          if (t < n_length) dd[t] = et;
        }
        kij = coef * d_exp(-SQRT5 * sa);
        if (n_length == 1) dd[0] = esum;
      }
      for (int k = 0; k < n_length; ++k) {
        const T g = dd[k] * kij;
        v[k][a] += g * z[j];
        v[k][j] += g * z[a];
      }
    }
  }
}

template <typename T, int KN>
__global__ void __launch_bounds__(THREADS)
block_nllik_grad_kernel(const T* __restrict__ Xg, const T* __restrict__ yg,
                        const T* __restrict__ diag, const T* __restrict__ dnug,
                        T* __restrict__ logdet, T* __restrict__ quad,
                        T* __restrict__ dlogdet, T* __restrict__ dquad, int m1, int d, int n,
                        int n_length, int nugget_est) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int g = blockIdx.y;
  const long long blk = (long long)g * m1 * n;
  const T* X = Xg + blk * d;
  const T* y = yg + blk;
  const T* dg = diag + blk;
  const T* dn = dnug + blk;
  const int npar = n_length + nugget_est;

  T L[TRI_MAX];
  const PlainCoords<T> x{X, d, n, p};
  const auto col = [&](int i, int j) { return corr<T, KN>(x, i, j, 0, d); };
  column_cholesky<T>(col, dg, n, p, m1, L);

  T Ly[M1_MAX];
  for (int i = 0; i < m1; ++i) Ly[i] = y[(long long)i * n + p];
  forward_inplace<T>(L, Ly, m1);

  // z = L^-T e_last by backward substitution
  T z[M1_MAX];
  z[m1 - 1] = T(1) / L[tri(m1 - 1, m1 - 1)];
  for (int i = m1 - 2; i >= 0; --i) {
    T acc = T(0);
    for (int j = i + 1; j < m1; ++j) acc += L[tri(j, i)] * z[j];
    z[i] = -acc / L[tri(i, i)];
  }

  const T yl = Ly[m1 - 1];
  logdet[(long long)g * n + p] = T(2) * d_log(L[tri(m1 - 1, m1 - 1)]);
  quad[(long long)g * n + p] = yl * yl;

  T v[NLEN_MAX + 1][M1_MAX];
  dk_times_z<T, KN>(x, z, m1, d, n_length, v);
  if (nugget_est)
    for (int i = 0; i < m1; ++i) v[n_length][i] = dn[(long long)i * n + p] * z[i];
  for (int k = 0; k < npar; ++k) {
    T* w = v[k];
    forward_inplace<T>(L, w, m1);
    T s = T(0);
    for (int i = 0; i < m1; ++i) s += Ly[i] * w[i];
    const T wl = w[m1 - 1];
    const long long o = ((long long)g * npar + k) * n + p;
    dlogdet[o] = wl;
    dquad[o] = T(2) * s * yl - wl * yl * yl;
  }
}

template <typename T>
static void launch(int kname, const void* Xg, const void* yg, const void* diag,
                   const void* dnug, void* logdet, void* quad, void* dlogdet, void* dquad,
                   int m1, int d, int n, int G, int n_length, int nugget_est,
                   cudaStream_t stream) {
  const dim3 grid(blocks_for(n), G);
  const auto* x = static_cast<const T*>(Xg);
  const auto* y = static_cast<const T*>(yg);
  const auto* dg = static_cast<const T*>(diag);
  const auto* dn = static_cast<const T*>(dnug);
  auto* ld = static_cast<T*>(logdet);
  auto* q = static_cast<T*>(quad);
  auto* dld = static_cast<T*>(dlogdet);
  auto* dq = static_cast<T*>(dquad);
  if (kname == SEXP)
    block_nllik_grad_kernel<T, SEXP><<<grid, THREADS, 0, stream>>>(
        x, y, dg, dn, ld, q, dld, dq, m1, d, n, n_length, nugget_est);
  else
    block_nllik_grad_kernel<T, MATERN25><<<grid, THREADS, 0, stream>>>(
        x, y, dg, dn, ld, q, dld, dq, m1, d, n, n_length, nugget_est);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.  Xg is
// (G, m1, d, n); yg, diag and dnug (G, m1, n).  Outputs: logdet and quad
// (G, n), dlogdet and dquad (G, n_length + nugget_est, n).  n_length is 1
// (isotropic) or at most d.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dgp_block_nllik_grad(int dtype, int kname, const void* Xg, const void* yg,
                                    const void* diag, const void* dnug, void* logdet,
                                    void* quad, void* dlogdet, void* dquad, int m1, int d,
                                    int n, int G, int n_length, int nugget_est,
                                    void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || n < 1 || G < 1 || G > 65535 ||
      n_length < 1 || n_length > dgp::NLEN_MAX || (n_length > 1 && n_length > d) ||
      (nugget_est != 0 && nugget_est != 1) || (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dgp::launch<double>(kname, Xg, yg, diag, dnug, logdet, quad, dlogdet, dquad, m1, d, n, G,
                        n_length, nugget_est, s);
  else if (dtype == 0)
    dgp::launch<float>(kname, Xg, yg, diag, dnug, logdet, quad, dlogdet, dquad, m1, d, n, G,
                       n_length, nugget_est, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int dgp_vecchia_nlen_max() { return dgp::NLEN_MAX; }
