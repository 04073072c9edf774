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
// in float64) sets the time.  Blocks of 33 to 64 rows factor in 2 m1 - 32
// steps (vecchia_warp.cuh's two panels) and substitute in m1 each; at m1 =
// 64 a point keeps 4.6k shared values in float64 (L and a copy of K), so an
// SM holds 6 such chains.
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
// Blocks of 33 to 64 rows run the two-panel factorisation (R = 2 in
// vecchia_warp.cuh): every update a multiply-add on a row in registers, one
// __syncwarp a step.  L stays in the panels, whose diagonals hold 1 /
// L[j][j]; z goes to the column buffers the factorisation leaves free.  For
// dK z the correlations come from the copies the factorisation leaves: the
// upper triangles of the panels' arrays and a copy of A21 it writes beside
// L21, (m1 - 32) x 33 more shared values a point.  Computing them again
// from the staged coordinates (one exponential a pair, no copy) measured
// slower on the H100 at m1 = 41, 48 and 64 (PERF.md), so the copy is kept.
// The length lanes go in passes of NLEN_CHUNK = 8, each pass with its own
// register accumulators and forward substitutions over the factor and z
// kept in shared memory, so any number of lanes up to d is taken; up to 8
// lanes (and the nugget lane) are one pass.
#include "vecchia_warp.cuh"

namespace dgp {

// the warp's shared values: its block (at R = 2 with a copy of A21) and, at
// R = 1, 1 / L[j][j] and z (at R = 2 the panels' diagonals hold 1 / L[j][j]
// and z goes to the spare column buffers)
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
  stage(Xg + blk * d, Xs, m1, d, n, p0, P);
  stage(yg + blk, ys, m1, 1, n, p0, P);
  stage(diag + blk, dgs, m1, 1, n, p0, P);
  stage(dnug + blk, dns, m1, 1, n, p0, P);
  __syncthreads();
  const int p = p0 + warp;
  if (p >= n) return;

  const int last = m1 - 1;                // the block's own point, row m1 - 1
  const TileCoords<T> x{Xs + warp * m1 * d, d};
  T dg[R], ly[R], lii[R], e[R], z[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    dg[r] = row < m1 ? dgs[warp * m1 + row] : T(0);
    ly[r] = row < m1 ? ys[warp * m1 + row] : T(0);
    e[r] = row == last ? T(1) : T(0);
  }
  warp_factor<T, KN, R, KEEP_LK>(x, dg, ls, invd, ly, lii, m1, d, d, lane);
  warp_backward<T, R>(ls, invd, e, z, m1, m1, lane);       // z = L^-T e_last
  const T yl = __shfl_sync(FULL_MASK, pick(ly, last / WARP), last);
  if (lane == last % WARP) {
    logdet[(long long)g * n + p] = T(2) * d_log(pick(lii, last / WARP));
    quad[(long long)g * n + p] = yl * yl;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) zs[lane + r * WARP] = z[r];
  __syncwarp();

  // The length lanes in passes of NLEN_CHUNK (one pass up to 8 lanes), the
  // nugget lane with the last pass: row a's entries of dK_k z, their
  // forward substitution and the outputs.  The factor and z stay in shared
  // memory between passes.
  const T SQRT5 = T(2.23606797749978969);
  const int npar = n_length + nugget_est;
  for (int c0 = 0; c0 < n_length; c0 += NLEN_CHUNK) {
    const int nl = min(NLEN_CHUNK, n_length - c0);         // length lanes of the pass
    const int np = nl + (c0 + NLEN_CHUNK >= n_length ? nugget_est : 0);
    T v[R][NLEN_CHUNK + 1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k <= NLEN_CHUNK; ++k) v[r][k] = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      if (row >= m1) continue;
      for (int j = 0; j < m1; ++j) {
        if (j == row) continue;         // dK_k has a zero diagonal
        // K[row][j], from the copy above the diagonal (and at R = 2 A21's)
        T kij;
        if constexpr (R == 1)
          kij = j < row ? ls[row * S + j] : ls[j * S + row];
        else
          kij = panel_k(ls, m1 - WARP, row, j);
        T dd[NLEN_CHUNK];               // dims c0 .. c0 + NLEN_CHUNK - 1
        T iso = T(0);                   // all dims (read when n_length == 1, c0 == 0)
        if (KN == SEXP) {
#pragma unroll
          for (int k = 0; k < NLEN_CHUNK; ++k) {
            const int t = c0 + k;
            if (t >= d) break;
            const T u = x(row, t) - x(j, t);
            dd[k] = T(2) * u * u;
            iso += dd[k];
          }
          for (int t = c0 + NLEN_CHUNK; t < d; ++t) {
            const T u = x(row, t) - x(j, t);
            iso += T(2) * u * u;
          }
        } else {
          for (int t = 0; t < d; ++t) {
            const T at = d_abs(x(row, t) - x(j, t));
            const T ct = T(1) + SQRT5 * at + (T(5) / T(3)) * at * at;
            const T et = (T(5) / T(3)) * at * at * (T(1) + SQRT5 * at) / ct;
            iso += et;
#pragma unroll
            for (int k = 0; k < NLEN_CHUNK; ++k)
              if (k == t - c0) dd[k] = et;
          }
        }
        const T zj = zs[j];
        if (n_length == 1) {
          v[r][0] += (iso * kij) * zj;
        } else {
#pragma unroll
          for (int k = 0; k < NLEN_CHUNK; ++k)
            if (k < nl) v[r][k] += (dd[k] * kij) * zj;
        }
      }
      if (np > nl) {                    // the nugget lane, after the pass's nl
        const T vn = dns[warp * m1 + row] * z[r];
#pragma unroll
        for (int k = 1; k <= NLEN_CHUNK; ++k)
          if (k == nl) v[r][k] = vn;
      }
    }
    warp_forward<T, NLEN_CHUNK + 1, R>(ls, invd, v, np, m1, lane);
#pragma unroll
    for (int k = 0; k <= NLEN_CHUNK; ++k) {
      if (k >= np) break;
      T part = T(0), col[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        col[r] = v[r][k];
        if (lane + r * WARP < m1) part += ly[r] * v[r][k];
      }
      const T s = warp_sum(part);
      if (lane == last % WARP) {
        const T wl = pick(col, last / WARP);
        const long long o = ((long long)g * npar + c0 + k) * n + p;
        dlogdet[o] = wl;
        dquad[o] = T(2) * s * yl - wl * yl * yl;
      }
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
