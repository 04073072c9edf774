// K1: Vecchia log-likelihood parts per point and their analytic gradient
// with respect to the log-parameters, for every node of an M-step group.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:block_nllik_grad_parts_t (Pallas
// body _grad_kernel), which JAX vmaps over the G nodes of a group.  For
// group g and point p the kernel factors the block, L L^T = K + nugget diag,
// and forms
//
//   Ly = L^-1 y,   z = L^-T e_last,   a = L^-T Ly (= K^-1 y),
//   logdet = 2 log L[-1,-1],   quad = Ly[-1]^2,
//
// and, for each of the n_length log-lengthscale lanes and (if nugget_est)
// the log-nugget lane k, the reference's analytic Vecchia gradient
// (dgpsi/vecchia.py:182-242), w_k = L^-1 (dK_k z), dlogdet_k = w_k[-1] and
// dquad_k = 2 (Ly . w_k) Ly[-1] - w_k[-1] Ly[-1]^2.  Only w_k[-1] and Ly .
// w_k are read, and with z and a they are quadratic forms:
//
//   dlogdet_k = e_last^T L^-1 dK_k z = z^T dK_k z,
//   Ly . w_k  = Ly^T L^-1 dK_k z     = a^T dK_k z,
//
// so one backward substitution (a, beside z) replaces the p forward
// substitutions of w_k.  A length lane's dK_k has a zero diagonal, so both
// forms are sums over the m1 (m1 - 1) / 2 pairs i < j:
//
//   z^T dK_k z = sum 2 z_i z_j dK_k[i][j],
//   a^T dK_k z = sum (a_i z_j + a_j z_i) dK_k[i][j];
//
// the nugget lane's dK is diag(dnug): sum dnug_i z_i^2 and sum a_i dnug_i
// z_i.  Coordinates arrive pre-scaled by the lengthscales, so dK/dlog l_t
// is 2 u_t^2 K (sexp) or K (5/3) a_t^2 (1 + sqrt5 a_t) / c_t (Matern-2.5)
// with u_t, a_t the coordinate difference in dim t and c_t that dim's
// Matern factor; with n_length == 1 the lane is isotropic and sums over all
// dims.  Zero-padded dims have zero differences and so contribute exactly 0;
// sentinel lanes have zero correlation and dnug = 0.  The plain version
// keeps the forward-substitution form, so the card's comparison holds the
// two against each other.
//
// What bounds it on an H100: per (node, point) it reads m1*d + 3*m1 values
// (1.0 KB at the M-step's m1 = 26, d = 2 in float64) and writes 2 + 2p,
// against the ~3.6k fused multiply-adds of the factorisation and three
// substitutions, m1^2/2 exponentials and 2p multiply-adds a pair.  Neither
// bytes nor operations bound it: the factorisation and the substitutions
// are chains of m1 dependent steps across the lanes (2 m1 - 32 for the
// factorisation of 33 to 64 rows), and how many such chains an SM keeps in
// flight sets the time; at m1 = 64 a point keeps 4.6k shared values in
// float64 (L and a copy of K), so an SM holds 6 such chains.
//
// What the design does about it (vecchia_warp.cuh): one warp per (node,
// point), 4000 warps at the M-step's shapes, lane i owning rows i and i +
// 32.  A thread block stages the X, y, diag and dnug tiles of its points
// (coalesced); the G nodes of the group are the grid's y axis, so one
// launch serves one L-BFGS evaluation of every node.  The X tile is staged
// transposed, (d, m1): lanes reading one dim of consecutive rows read
// consecutive addresses, where the (m1, d) layout's stride of d values put
// them in one bank at d = 16 (0.2252 against 0.0972 ms at p = 17; at d =
// 2 13% faster at n = 1e5, 3% slower at n = 2000; PERF.md).
// `warp_factor` builds K with its correlations spread evenly over the
// lanes and factors it,
// Ly's forward substitution fused in (one row per lane up to 32 rows, two
// panels in registers above), and leaves L and a copy of K's correlations
// in the warp's shared scratch.  z and a then come from one backward
// substitution of two right-hand sides, one chain of m1 steps; z goes to
// the warp's scratch, a over its staged diagonal tile, which nothing reads
// after the diagonals are in registers.  The gradient stage spreads the
// pairs i < j evenly over the 32 lanes, as `warp_build` spreads the
// correlations (about m1^2 / 64 pairs a lane, no idle lane): a pair reads
// K[i][j] from the copy, z and a from shared memory, and adds its two
// terms to every length lane of the pass in registers.  The lanes go in
// passes of GRAD_LANES, only the pair loop redone per pass; lane i adds
// the nugget lane's terms of its rows.  The 2 GRAD_LANES sums of a pass
// are reduced together by interleaved butterflies (`warp_sum_each`), after
// which lane s writes the pass's lane s.
#include "vecchia_warp.cuh"

namespace dgp {

// length lanes a pass over the pairs accumulates in registers: 2 * GRAD_LANES
// sums.  ptxas, float64: 95-100 registers at one row per lane (20 warps an
// SM), 164 at two, no stack frame, no spills.  16 lanes a pass measured
// 1-14% slower in float64 at every shape timed (PERF.md)
constexpr int GRAD_LANES = 8;

// the warp's shared values: its block (at R = 2 with a copy of A21) and, at
// R = 1, 1 / L[j][j] and z (at R = 2 the panels' diagonals hold 1 / L[j][j]
// and z goes to the spare column buffers); a goes over the staged diagonals
template <int R>
__host__ __device__ inline int grad_warp_scratch(int m1) {
  return block_scratch<R>(m1, KEEP_LK) + (R == 1 ? 2 * WARP : 0);
}

// shared values of one point: its X tile, y, diag, dnug and the warp's scratch
template <int R>
__host__ __device__ inline int grad_per_point(int m1, int d) {
  return m1 * d + 3 * m1 + grad_warp_scratch<R>(m1);
}

template <typename T, int KN, int R>
__global__ void __launch_bounds__(WARP * WARPS_MAX)
block_nllik_grad_kernel(const T* __restrict__ Xg, const T* __restrict__ yg,
                        const T* __restrict__ diag, const T* __restrict__ dnug,
                        T* __restrict__ logdet, T* __restrict__ quad,
                        T* __restrict__ dlogdet, T* __restrict__ dquad, int m1, int d, int n,
                        int n_length, int nugget_est) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int S = LDS;
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
  T* ls = dns + m1 * P + warp * grad_warp_scratch<R>(m1);   // the block
  T* invd = ls + block_scratch<R>(m1, KEEP_LK);               // R = 1
  T* zs = R == 1 ? invd + R * WARP : panel_spare(ls, m1);
  stage_transposed(Xg + blk * d, Xs, m1, d, n, p0, P);
  stage(yg + blk, ys, m1, 1, n, p0, P);
  stage(diag + blk, dgs, m1, 1, n, p0, P);
  stage(dnug + blk, dns, m1, 1, n, p0, P);
  __syncthreads();
  const int p = p0 + warp;
  if (p >= n) return;

  const int last = m1 - 1;                // the block's own point, row m1 - 1
  const TileCoordsT<T> x{Xs + warp * m1 * d, m1};
  T dg[R], ly[R], lii[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    dg[r] = row < m1 ? dgs[warp * m1 + row] : T(0);
    ly[r] = row < m1 ? ys[warp * m1 + row] : T(0);
  }
  warp_factor<T, KN, R, KEEP_LK>(x, dg, ls, invd, ly, lii, m1, d, d, lane);
  const T yl = __shfl_sync(FULL_MASK, pick(ly, last / WARP), last);
  if (lane == last % WARP) {
    logdet[(long long)g * n + p] = T(2) * d_log(pick(lii, last / WARP));
    quad[(long long)g * n + p] = yl * yl;
  }
  // z = L^-T e_last and a = L^-T Ly, one backward substitution of both
  T rhs[R][2], za[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rhs[r][0] = lane + r * WARP == last ? T(1) : T(0);
    rhs[r][1] = ly[r];
  }
  warp_backward<T, 2, R>(ls, invd, rhs, za, m1, m1, lane);
  T* as = dgs + warp * m1;               // the staged diagonals, in dg already
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    if (row < m1) {
      zs[row] = za[r][0];
      as[row] = za[r][1];
    }
  }
  __syncwarp();

  // The lanes in passes of GRAD_LANES: v[2 s] and v[2 s + 1] collect z^T dK
  // z and a^T dK z of lane c0 + s, from the pairs and (its pass's slot) the
  // nugget lane.
  const T SQRT5 = T(2.23606797749978969);
  const int npar = n_length + nugget_est;
  const int npairs = m1 * (m1 - 1) / 2;
  for (int c0 = 0; c0 < npar; c0 += GRAD_LANES) {
    T v[2 * GRAD_LANES];
#pragma unroll
    for (int s = 0; s < 2 * GRAD_LANES; ++s) v[s] = T(0);
    const int nl = min(GRAD_LANES, n_length - c0);   // length lanes (dims c0 ..) of the pass
    if (nl > 0) {
      int i = 1, k = lane;                           // pair q = i (i - 1) / 2 + k, k < i
      for (int q = lane; q < npairs; q += WARP) {
        while (k >= i) {
          k -= i;
          ++i;
        }
        // K[i][k], from the copy above the diagonal (and at R = 2 A21's)
        T kik;
        if constexpr (R == 1)
          kik = ls[i * S + k];
        else
          kik = panel_k(ls, m1 - WARP, i, k);
        const T zi = zs[i], zk = zs[k];
        const T czz = T(2) * zi * zk * kik;
        const T caz = (as[i] * zk + as[k] * zi) * kik;
        // dK/dlog l_t over K at dim t
        auto factor = [&](int t) {
          if constexpr (KN == SEXP) {
            const T u = x(i, t) - x(k, t);
            return T(2) * u * u;
          }
          const T at = d_abs(x(i, t) - x(k, t));
          const T ct = T(1) + SQRT5 * at + (T(5) / T(3)) * at * at;
          return (T(5) / T(3)) * at * at * (T(1) + SQRT5 * at) / ct;
        };
        if (n_length == 1) {
          T f = T(0);
          for (int t = 0; t < d; ++t) f += factor(t);
          v[0] += f * czz;
          v[1] += f * caz;
        } else {
#pragma unroll
          for (int s = 0; s < GRAD_LANES; ++s) {
            if (s >= nl) break;
            const T f = factor(c0 + s);
            v[2 * s] += f * czz;
            v[2 * s + 1] += f * caz;
          }
        }
        k += WARP;
      }
    }
    const int sn = n_length - c0;                    // the nugget lane's slot
    if (nugget_est && sn >= 0 && sn < GRAD_LANES) {
      T nzz = T(0), naz = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = lane + r * WARP;
        if (row < m1) {
          const T dz = dns[warp * m1 + row] * za[r][0];
          nzz += dz * za[r][0];
          naz += dz * za[r][1];
        }
      }
#pragma unroll
      for (int s = 0; s < GRAD_LANES; ++s)
        if (s == sn) {
          v[2 * s] += nzz;
          v[2 * s + 1] += naz;
        }
    }
    warp_sum_each<T, 2 * GRAD_LANES>(v);
#pragma unroll
    for (int s = 0; s < GRAD_LANES; ++s)
      if (lane == s && c0 + s < npar) {
        const long long at = ((long long)g * npar + c0 + s) * n + p;
        dlogdet[at] = v[2 * s];
        dquad[at] = T(2) * v[2 * s + 1] * yl - v[2 * s] * yl * yl;
      }
  }
}

template <typename T, int KN, int R>
static int launch_r(const T* x, const T* y, const T* dg, const T* dn, T* ld, T* q, T* dld,
                    T* dq, int m1, int d, int n, int G, int n_length, int nugget_est,
                    cudaStream_t stream) {
  const auto kern = block_nllik_grad_kernel<T, KN, R>;
  int P;
  size_t bytes;
  const cudaError_t err = plan_block((const void*)kern, sizeof(T) * grad_per_point<R>(m1, d),
                                     &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + P - 1) / P, G);
  kern<<<grid, P * WARP, bytes, stream>>>(x, y, dg, dn, ld, q, dld, dq, m1, d, n, n_length,
                                          nugget_est);
  return (int)cudaGetLastError();
}

template <typename T, int KN>
static int launch_kn(const T* x, const T* y, const T* dg, const T* dn, T* ld, T* q, T* dld,
                     T* dq, int m1, int d, int n, int G, int n_length, int nugget_est,
                     cudaStream_t stream) {
  if (rows_per_lane(m1) == 1)
    return launch_r<T, KN, 1>(x, y, dg, dn, ld, q, dld, dq, m1, d, n, G, n_length,
                              nugget_est, stream);
  return launch_r<T, KN, 2>(x, y, dg, dn, ld, q, dld, dq, m1, d, n, G, n_length, nugget_est,
                            stream);
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

// The launch plan of the sexp kernel at (m1, d) (see the extern "C" below).
template <typename T>
static int plan(int m1, int d, int* out) {
  if (rows_per_lane(m1) == 1)
    return (int)plan_report((const void*)block_nllik_grad_kernel<T, SEXP, 1>,
                            sizeof(T) * grad_per_point<1>(m1, d), out);
  return (int)plan_report((const void*)block_nllik_grad_kernel<T, SEXP, 2>,
                          sizeof(T) * grad_per_point<2>(m1, d), out);
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
      n_length < 1 || (n_length > 1 && n_length > d) ||
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
  if (dtype == 1) return dgp::plan<double>(m1, d, out);
  if (dtype == 0) return dgp::plan<float>(m1, d, out);
  return (int)cudaErrorInvalidValue;
}
