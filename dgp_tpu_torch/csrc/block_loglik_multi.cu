// K2: Vecchia log-likelihood parts of K elliptical-slice candidates.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:block_loglik_multi_t (Pallas body
// _kernel_multi).  For candidate k and point p the block coordinates are
// cos_k * A + sin_k * B + C; the kernel factors the block's correlation
// matrix (diagonal from diag), forward-solves L sol = y and writes
// logdet[k, p] = 2 log L[m1-1, m1-1] and quad[k, p] = sol[m1-1]^2.  Dims
// >= dl do not depend on the candidate (A and B are zero there and C holds
// the global coordinates); as in the TPU kernel their correlation is a
// separate factor G that multiplies the candidate-dependent one.
//
// What bounds it on an H100: per (candidate, point) it reads 3*m1*d + 2*m1
// values (1.7 KB at the slice's m1 = 26, d = 2 in float64; the K
// candidates of a point re-read the same A/B/C, which stay in L2) against
// about m1^3/6 + m1^2 ~ 3.6k fused multiply-adds and m1^2 exponentials.
// As in K3 the factor's 351 values live in per-thread local memory and the
// Cholesky updates that read them bound the kernel (L1/L2 traffic and
// latency), not device memory or arithmetic.
//
// What the design does about it, and the choice asked of it: the
// candidates are a grid axis (blockIdx.y), not a loop inside the thread.
// At the slice's n = 2000 one thread per point fills 16 blocks of the
// card's 132 SMs; a candidate axis multiplies the threads by K (9 on the
// first ESS round, 8 after), which is the cheapest way to put more of the
// card to work.  The price is that G is rebuilt per candidate instead of
// once per point; for the slice's single static dim that is one
// exponential per pair, the same work as the candidate-dependent factor,
// and it saves a second 351-value local array per thread.
#include "vecchia_common.cuh"

namespace dgp {

template <typename T, int KN>
__global__ void __launch_bounds__(THREADS)
block_loglik_multi_kernel(const T* __restrict__ A, const T* __restrict__ B,
                          const T* __restrict__ C, const T* __restrict__ yg,
                          const T* __restrict__ diag, const T* __restrict__ cosv,
                          const T* __restrict__ sinv, T* __restrict__ logdet,
                          T* __restrict__ quad, int m1, int d, int dl, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int k = blockIdx.y;
  T L[TRI_MAX];
  const AngleCoords<T> x{A, B, C, cosv[k], sinv[k], d, n, p};
  if (dl >= d || dl == 0) {
    const auto col = [&](int i, int j) { return corr<T, KN>(x, i, j, 0, d); };
    column_cholesky<T>(col, diag, n, p, m1, L);
  } else {
    const PlainCoords<T> g{C, d, n, p};
    const auto col = [&](int i, int j) {
      return corr<T, KN>(x, i, j, 0, dl) * corr<T, KN>(g, i, j, dl, d);
    };
    column_cholesky<T>(col, diag, n, p, m1, L);
  }
  const T s = forward_last<T>(L, yg, n, p, m1);
  const long long o = (long long)k * n + p;
  logdet[o] = T(2) * d_log(L[tri(m1 - 1, m1 - 1)]);
  quad[o] = s * s;
}

template <typename T>
static void launch(int kname, const void* A, const void* B, const void* C, const void* yg,
                   const void* diag, const void* cosv, const void* sinv, void* logdet,
                   void* quad, int m1, int d, int dl, int n, int K, cudaStream_t stream) {
  const dim3 grid(blocks_for(n), K);
  const auto* a = static_cast<const T*>(A);
  const auto* b = static_cast<const T*>(B);
  const auto* c = static_cast<const T*>(C);
  const auto* y = static_cast<const T*>(yg);
  const auto* dg = static_cast<const T*>(diag);
  const auto* cs = static_cast<const T*>(cosv);
  const auto* sn = static_cast<const T*>(sinv);
  auto* ld = static_cast<T*>(logdet);
  auto* q = static_cast<T*>(quad);
  if (kname == SEXP)
    block_loglik_multi_kernel<T, SEXP>
        <<<grid, THREADS, 0, stream>>>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl, n);
  else
    block_loglik_multi_kernel<T, MATERN25>
        <<<grid, THREADS, 0, stream>>>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl, n);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dgp_block_loglik_multi(int dtype, int kname, const void* A, const void* B,
                                      const void* C, const void* yg, const void* diag,
                                      const void* cosv, const void* sinv, void* logdet,
                                      void* quad, int m1, int d, int dl, int n, int K,
                                      void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || dl < 0 || n < 1 || K < 1 || K > 65535 ||
      (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dgp::launch<double>(kname, A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl, n, K, s);
  else if (dtype == 0)
    dgp::launch<float>(kname, A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl, n, K, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
