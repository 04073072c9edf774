// K4: Vecchia log-likelihood parts per point at fixed parameters.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:block_loglik_parts_t (Pallas body
// _kernel, which runs _fwd_pipeline with one candidate).  For point p the
// kernel factors the correlation block of p's (m1, d) coordinates (diagonal
// from diag), forward-solves L sol = y and writes logdet[p] = 2 log
// L[m1-1, m1-1] and quad[p] = sol[m1-1]^2.  A leading candidate axis
// evaluates K blocks of the same shape in one launch: the JAX package vmaps
// the call over the speculative ESS candidates of a node-wise round, and
// here that round is one launch.  The targets and diagonals do not change
// between the candidates of a round, so their candidate stride may be 0
// (one (m1, n) array shared by all).
//
// What bounds it on an H100: per (candidate, point) it reads m1*d + 2*m1
// values (0.8 KB at the node-wise path's m1 = 26, d = 2 in float64) and
// writes two, against about m1^3/6 + m1^2 ~ 3.6k fused multiply-adds and
// m1^2/2 exponentials.  Neither bytes nor operations bound it: the
// factorisation is a chain of m1 dependent column steps (a shuffle, a
// reciprocal square root, a publish and the update), and at n = 2000 one
// candidate is 2000 such chains, fewer than the card holds at once (132
// SMs at 20 warps each in float64), so one call lasts about one chain plus
// the launch.
//
// What the design does about it (vecchia_warp.cuh): K2's body without the
// candidate algebra.  One warp per (candidate, point): the block's
// correlations are spread evenly over the 32 lanes (one product over all d
// dims, as in the TPU kernel), and the column Cholesky runs across the
// lanes with the forward substitution of y fused in; only the last lane's
// L[m1-1, m1-1] and sol[m1-1] are written.  A thread block stages the X, y
// and diag tiles of its P points (coalesced).  Each candidate has its own
// coordinates, so there is no tile for the candidates of a point to share:
// they are the grid's y axis, as K1's nodes are.
// Blocks of 33 to 64 rows run the two-panel factorisation (R = 2 in
// vecchia_warp.cuh), each panel's rows in registers.
#include "vecchia_warp.cuh"

namespace dgp {

// shared values of one point: its X tile, y, diag and the warp's block
template <int R>
__host__ __device__ inline int parts_per_point(int m1, int d) {
  return m1 * d + 2 * m1 + block_scratch<R>(m1, KEEP_NONE);
}

// The minimum of one resident block lets ptxas take the registers the
// factorisation needs (96 in float64 at R = 1); without it ptxas chose 80
// and spilled 16 bytes.
template <typename T, int KN, int R>
__global__ void __launch_bounds__(WARP * WARPS_MAX, 1)
block_loglik_parts_kernel(const T* __restrict__ Xg, const T* __restrict__ yg,
                          const T* __restrict__ diag, T* __restrict__ logdet,
                          T* __restrict__ quad, int m1, int d, int n, long long y_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int p0 = blockIdx.x * P;
  const int c = blockIdx.y;
  T* Xs = sm;
  T* ys = Xs + m1 * d * P;
  T* ds = ys + m1 * P;
  T* ls = ds + m1 * P + warp * block_scratch<R>(m1, KEEP_NONE);   // the block
  stage(Xg + (long long)c * m1 * d * n, Xs, m1, d, n, p0, P);
  stage(yg + c * y_stride, ys, m1, 1, n, p0, P);
  stage(diag + c * y_stride, ds, m1, 1, n, p0, P);
  __syncthreads();
  const int p = p0 + warp;
  if (p >= n) return;

  const TileCoords<T> x{Xs + warp * m1 * d, d};
  T dg[R], b[R], lii[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    dg[r] = row < m1 ? ds[warp * m1 + row] : T(0);
    b[r] = row < m1 ? ys[warp * m1 + row] : T(0);
  }
  warp_factor<T, KN, R, KEEP_NONE>(x, dg, ls, static_cast<T*>(nullptr), b, lii, m1, d, d, lane);
  const int last = m1 - 1;
  if (lane == last % WARP) {
    const long long o = (long long)c * n + p;
    const T sl = pick(b, last / WARP);
    logdet[o] = T(2) * d_log(pick(lii, last / WARP));
    quad[o] = sl * sl;
  }
}

template <typename T, int KN, int R>
static int launch_r(const T* x, const T* y, const T* dg, T* ld, T* q, int m1, int d, int n,
                    int K, long long ys, cudaStream_t stream) {
  const auto kern = block_loglik_parts_kernel<T, KN, R>;
  int P;
  size_t bytes;
  const cudaError_t err = plan_block((const void*)kern, sizeof(T) * parts_per_point<R>(m1, d),
                                     &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + P - 1) / P, K);
  kern<<<grid, P * WARP, bytes, stream>>>(x, y, dg, ld, q, m1, d, n, ys);
  return (int)cudaGetLastError();
}

template <typename T, int KN>
static int launch_kn(const T* x, const T* y, const T* dg, T* ld, T* q, int m1, int d, int n,
                     int K, long long ys, cudaStream_t stream) {
  if (rows_per_lane(m1) == 1)
    return launch_r<T, KN, 1>(x, y, dg, ld, q, m1, d, n, K, ys, stream);
  return launch_r<T, KN, 2>(x, y, dg, ld, q, m1, d, n, K, ys, stream);
}

template <typename T>
static int launch(int kname, const void* Xg, const void* yg, const void* diag, void* logdet,
                  void* quad, int m1, int d, int n, int K, int shared_y, cudaStream_t stream) {
  const auto* x = static_cast<const T*>(Xg);
  const auto* y = static_cast<const T*>(yg);
  const auto* dg = static_cast<const T*>(diag);
  auto* ld = static_cast<T*>(logdet);
  auto* q = static_cast<T*>(quad);
  const long long ys = shared_y ? 0LL : (long long)m1 * n;
  if (kname == SEXP) return launch_kn<T, SEXP>(x, y, dg, ld, q, m1, d, n, K, ys, stream);
  return launch_kn<T, MATERN25>(x, y, dg, ld, q, m1, d, n, K, ys, stream);
}

// The launch plan of the sexp kernel at (m1, d) (see the extern "C" below).
template <typename T>
static int plan(int m1, int d, int* out) {
  if (rows_per_lane(m1) == 1)
    return (int)plan_report((const void*)block_loglik_parts_kernel<T, SEXP, 1>,
                            sizeof(T) * parts_per_point<1>(m1, d), out);
  return (int)plan_report((const void*)block_loglik_parts_kernel<T, SEXP, 2>,
                          sizeof(T) * parts_per_point<2>(m1, d), out);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.  Xg is
// (K, m1, d, n); yg and diag are (K, m1, n), or one (m1, n) array each for
// all K candidates when shared_y is 1.  Outputs (K, n).
// Returns the launch's cudaError_t (0 on success).
extern "C" int dgp_block_loglik_parts(int dtype, int kname, const void* Xg, const void* yg,
                                      const void* diag, void* logdet, void* quad, int m1,
                                      int d, int n, int K, int shared_y, void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || n < 1 || K < 1 || K > 65535 ||
      (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dgp::launch<double>(kname, Xg, yg, diag, logdet, quad, m1, d, n, K, shared_y, s);
  if (dtype == 0)
    return dgp::launch<float>(kname, Xg, yg, diag, logdet, quad, m1, d, n, K, shared_y, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of the sexp kernel at (m1, d): out[0] points (warps) per
// thread block, out[1] its shared bytes, out[2] blocks resident per SM.
extern "C" int dgp_block_loglik_parts_plan(int dtype, int m1, int d, int* out) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return dgp::plan<double>(m1, d, out);
  if (dtype == 0) return dgp::plan<float>(m1, d, out);
  return (int)cudaErrorInvalidValue;
}
