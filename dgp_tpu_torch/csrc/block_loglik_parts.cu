// K4: Vecchia log-likelihood parts per point at fixed parameters.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:block_loglik_parts_t (Pallas body
// _kernel, which runs _fwd_pipeline with one candidate).  For point p the
// kernel factors the correlation block of p's (m1, d) coordinates (diagonal
// from diag), forward-solves L sol = y and writes logdet[p] = 2 log
// L[m1-1, m1-1] and quad[p] = sol[m1-1]^2.  A leading candidate axis
// (blockIdx.y) evaluates K blocks of the same shape in one launch: the JAX
// package vmaps the call over the speculative ESS candidates of a node-wise
// round, and here that round is one launch.  The targets and diagonals do
// not change between the candidates of a round, so their candidate stride
// may be 0 (one (m1, n) array shared by all).
//
// What bounds it on an H100: per (candidate, point) it reads m1*d + 2*m1
// values (0.8 KB at the node-wise path's m1 = 26, d = 2 in float64) and
// writes two, against about m1^3/6 + m1^2 ~ 3.6k fused multiply-adds and
// m1^2/2 exponentials.  As in K2 and K3 the packed factor (351 values)
// lives in per-thread local memory, and the Cholesky updates that read it
// bound the kernel (L1/L2 traffic and latency), not device memory or
// arithmetic.
//
// What the design does about it: it is K2's pipeline (vecchia_common.cuh)
// with plain coordinates, one thread per point, every global read
// coalesced, no block-matrix scratch in device memory, and the candidates on
// a grid axis to put more of the card to work at n = 2000 (16 blocks of
// 128 threads per candidate on 132 SMs).
#include "vecchia_common.cuh"

namespace dgp {

template <typename T, int KN>
__global__ void __launch_bounds__(THREADS)
block_loglik_parts_kernel(const T* __restrict__ Xg, const T* __restrict__ yg,
                          const T* __restrict__ diag, T* __restrict__ logdet,
                          T* __restrict__ quad, int m1, int d, int n, long long y_stride) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int c = blockIdx.y;
  const T* X = Xg + (long long)c * m1 * d * n;
  const T* y = yg + c * y_stride;
  const T* dg = diag + c * y_stride;
  T L[TRI_MAX];
  const PlainCoords<T> x{X, d, n, p};
  const auto col = [&](int i, int j) { return corr<T, KN>(x, i, j, 0, d); };
  column_cholesky<T>(col, dg, n, p, m1, L);
  const T s = forward_last<T>(L, y, n, p, m1);
  const long long o = (long long)c * n + p;
  logdet[o] = T(2) * d_log(L[tri(m1 - 1, m1 - 1)]);
  quad[o] = s * s;
}

template <typename T>
static void launch(int kname, const void* Xg, const void* yg, const void* diag, void* logdet,
                   void* quad, int m1, int d, int n, int K, int shared_y,
                   cudaStream_t stream) {
  const dim3 grid(blocks_for(n), K);
  const auto* x = static_cast<const T*>(Xg);
  const auto* y = static_cast<const T*>(yg);
  const auto* dg = static_cast<const T*>(diag);
  auto* ld = static_cast<T*>(logdet);
  auto* q = static_cast<T*>(quad);
  const long long ys = shared_y ? 0LL : (long long)m1 * n;
  if (kname == SEXP)
    block_loglik_parts_kernel<T, SEXP><<<grid, THREADS, 0, stream>>>(x, y, dg, ld, q, m1, d, n, ys);
  else
    block_loglik_parts_kernel<T, MATERN25>
        <<<grid, THREADS, 0, stream>>>(x, y, dg, ld, q, m1, d, n, ys);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.  Xg is
// (K, m1, d, n); yg and diag are (K, m1, n), or one (m1, n) array each for
// all K candidates when shared_y is 1.  Outputs (K, n).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dgp_block_loglik_parts(int dtype, int kname, const void* Xg, const void* yg,
                                      const void* diag, void* logdet, void* quad, int m1,
                                      int d, int n, int K, int shared_y, void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || n < 1 || K < 1 || K > 65535 ||
      (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dgp::launch<double>(kname, Xg, yg, diag, logdet, quad, m1, d, n, K, shared_y, s);
  else if (dtype == 0)
    dgp::launch<float>(kname, Xg, yg, diag, logdet, quad, m1, d, n, K, shared_y, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
