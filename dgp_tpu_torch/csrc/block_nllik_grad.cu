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
// solves, p more triangular solves of ~m1^2/2 each, and m1^2/2
// exponentials.  Neither bytes nor operations bound it: the factorisation
// and the substitutions are chains of m1 dependent steps across the lanes,
// and how many such chains an SM keeps in flight (20 warps at 96 registers
// in float64) sets the time.
//
// What the design does about it (vecchia_warp.cuh): one warp per (node,
// point), 4000 warps at the M-step's shapes, lane i owning row i.  K's
// correlations are spread evenly over the 32 lanes; the column Cholesky
// runs across the lanes with Ly's forward substitution fused in, each
// lane's unfactored row in registers; L ends in the warp's shared (m1, LDS)
// array, read transposed for z's backward substitution.  Lane a forms
// (dK_k z)_a for every length lane at once from one pass over its row (the
// correlations from the copy the factorisation leaves above the diagonal,
// no exponential; z from shared memory) and the nugget lane as dnug_a z_a;
// the p forward substitutions run together, one shuffle per step and
// right-hand side, and Ly . w_k is a warp sum.  A thread block stages the
// X, y, diag and dnug tiles of its points (coalesced); the G nodes of the
// group are the grid's y axis, so one launch serves one L-BFGS evaluation
// of every node.
#include "vecchia_warp.cuh"

namespace dgp {

// the warp's shared values: its block, 1 / L[j][j] and z
__host__ __device__ inline int grad_warp_scratch(int m1) {
  return block_scratch(m1) + 2 * M1_MAX;
}

// shared values of one point: its X tile, y, diag, dnug and the warp's scratch
__host__ __device__ inline int grad_per_point(int m1, int d) {
  return m1 * d + 3 * m1 + grad_warp_scratch(m1);
}

template <typename T, int KN>
__global__ void __launch_bounds__(WARP * WARPS_MAX)
block_nllik_grad_kernel(const T* __restrict__ Xg, const T* __restrict__ yg,
                        const T* __restrict__ diag, const T* __restrict__ dnug,
                        T* __restrict__ logdet, T* __restrict__ quad,
                        T* __restrict__ dlogdet, T* __restrict__ dquad, int m1, int d, int n,
                        int n_length, int nugget_est) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int p0 = blockIdx.x * P;
  const int g = blockIdx.y;
  const long long blk = (long long)g * m1 * n;
  T* Xs = sm;
  T* ys = Xs + m1 * d * P;
  T* dgs = ys + m1 * P;
  T* dns = dgs + m1 * P;
  T* ls = dns + m1 * P + warp * grad_warp_scratch(m1);   // (m1, LDS)
  T* invd = ls + block_scratch(m1);
  T* zs = invd + M1_MAX;
  stage(Xg + blk * d, Xs, m1, d, n, p0, P);
  stage(yg + blk, ys, m1, 1, n, p0, P);
  stage(diag + blk, dgs, m1, 1, n, p0, P);
  stage(dnug + blk, dns, m1, 1, n, p0, P);
  __syncthreads();
  const int p = p0 + warp;
  if (p >= n) return;

  const bool live = lane < m1;
  const int me = warp * m1 + lane;
  const TileCoords<T> x{Xs + warp * m1 * d, d};
  warp_build<T, KN>(x, live ? dgs[me] : T(0), ls, m1, d, d, lane);
  T ly = live ? ys[me] : T(0);
  const T lii = warp_cholesky(ls, ls + m1 * LDS, invd, ly, m1, lane);
  const T z = warp_backward(ls, invd, lane == m1 - 1 ? T(1) : T(0), m1, lane);   // L^-T e_last
  const T yl = __shfl_sync(FULL_MASK, ly, m1 - 1);
  if (lane == m1 - 1) {
    logdet[(long long)g * n + p] = T(2) * d_log(lii);
    quad[(long long)g * n + p] = yl * yl;
  }
  zs[lane] = z;
  __syncwarp();

  // lane a's entries of dK_k z, k < n_length, then the nugget lane
  const T SQRT5 = T(2.23606797749978969);
  T v[NLEN_MAX + 1];
#pragma unroll
  for (int k = 0; k <= NLEN_MAX; ++k) v[k] = T(0);
  if (live) {
    for (int j = 0; j < m1; ++j) {
      if (j == lane) continue;         // dK_k has a zero diagonal
      // K[lane][j], from the copy above the diagonal
      const T kij = j < lane ? ls[lane * LDS + j] : ls[j * LDS + lane];
      T dd[NLEN_MAX];
      T iso = T(0);
      if (KN == SEXP) {
#pragma unroll
        for (int t = 0; t < NLEN_MAX; ++t) {
          if (t >= d) break;
          const T u = x(lane, t) - x(j, t);
          dd[t] = T(2) * u * u;
          iso += dd[t];
        }
        for (int t = NLEN_MAX; t < d; ++t) {
          const T u = x(lane, t) - x(j, t);
          iso += T(2) * u * u;
        }
      } else {
        for (int t = 0; t < d; ++t) {
          const T at = d_abs(x(lane, t) - x(j, t));
          const T ct = T(1) + SQRT5 * at + (T(5) / T(3)) * at * at;
          const T et = (T(5) / T(3)) * at * at * (T(1) + SQRT5 * at) / ct;
          iso += et;
#pragma unroll
          for (int k = 0; k < NLEN_MAX; ++k)
            if (k == t) dd[k] = et;
        }
      }
      const T zj = zs[j];
      if (n_length == 1) {
        v[0] += (iso * kij) * zj;
      } else {
#pragma unroll
        for (int k = 0; k < NLEN_MAX; ++k)
          if (k < n_length) v[k] += (dd[k] * kij) * zj;
      }
    }
    if (nugget_est) {
      const T vn = dns[me] * z;
#pragma unroll
      for (int k = 1; k <= NLEN_MAX; ++k)
        if (k == n_length) v[k] = vn;
    }
  }
  const int npar = n_length + nugget_est;
  warp_forward(ls, invd, v, npar, m1, lane);
#pragma unroll
  for (int k = 0; k <= NLEN_MAX; ++k) {
    if (k >= npar) break;
    const T s = warp_sum(live ? ly * v[k] : T(0));
    if (lane == m1 - 1) {
      const T wl = v[k];
      const long long o = ((long long)g * npar + k) * n + p;
      dlogdet[o] = wl;
      dquad[o] = T(2) * s * yl - wl * yl * yl;
    }
  }
}

template <typename T, int KN>
static int launch_kn(const T* x, const T* y, const T* dg, const T* dn, T* ld, T* q, T* dld,
                     T* dq, int m1, int d, int n, int G, int n_length, int nugget_est,
                     cudaStream_t stream) {
  const auto kern = block_nllik_grad_kernel<T, KN>;
  int P;
  size_t bytes;
  const cudaError_t err = plan_block((const void*)kern, sizeof(T) * grad_per_point(m1, d), &P,
                                     &bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + P - 1) / P, G);
  kern<<<grid, P * WARP, bytes, stream>>>(x, y, dg, dn, ld, q, dld, dq, m1, d, n, n_length,
                                          nugget_est);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(int kname, const void* Xg, const void* yg, const void* diag,
                  const void* dnug, void* logdet, void* quad, void* dlogdet, void* dquad,
                  int m1, int d, int n, int G, int n_length, int nugget_est,
                  cudaStream_t stream) {
  const auto* x = static_cast<const T*>(Xg);
  const auto* y = static_cast<const T*>(yg);
  const auto* dg = static_cast<const T*>(diag);
  const auto* dn = static_cast<const T*>(dnug);
  auto* ld = static_cast<T*>(logdet);
  auto* q = static_cast<T*>(quad);
  auto* dld = static_cast<T*>(dlogdet);
  auto* dq = static_cast<T*>(dquad);
  if (kname == SEXP)
    return launch_kn<T, SEXP>(x, y, dg, dn, ld, q, dld, dq, m1, d, n, G, n_length, nugget_est,
                              stream);
  return launch_kn<T, MATERN25>(x, y, dg, dn, ld, q, dld, dq, m1, d, n, G, n_length,
                                nugget_est, stream);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.  Xg is
// (G, m1, d, n); yg, diag and dnug (G, m1, n).  Outputs: logdet and quad
// (G, n), dlogdet and dquad (G, n_length + nugget_est, n).  n_length is 1
// (isotropic) or at most d.
// Returns the launch's cudaError_t (0 on success).
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
    return dgp::launch<double>(kname, Xg, yg, diag, dnug, logdet, quad, dlogdet, dquad, m1, d,
                               n, G, n_length, nugget_est, s);
  if (dtype == 0)
    return dgp::launch<float>(kname, Xg, yg, diag, dnug, logdet, quad, dlogdet, dquad, m1, d,
                              n, G, n_length, nugget_est, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of the sexp kernel at (m1, d): out[0] points (warps) per
// thread block, out[1] its shared bytes, out[2] blocks resident per SM.
extern "C" int dgp_block_nllik_grad_plan(int dtype, int m1, int d, int* out) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)dgp::plan_report((const void*)dgp::block_nllik_grad_kernel<double, dgp::SEXP>,
                                 sizeof(double) * dgp::grad_per_point(m1, d), out);
  if (dtype == 0)
    return (int)dgp::plan_report((const void*)dgp::block_nllik_grad_kernel<float, dgp::SEXP>,
                                 sizeof(float) * dgp::grad_per_point(m1, d), out);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dgp_vecchia_nlen_max() { return dgp::NLEN_MAX; }
