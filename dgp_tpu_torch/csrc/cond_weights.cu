// K3: conditional weights for Vecchia ancestral sampling.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:cond_weights_t (Pallas body
// _kernel_condw).  For each point p the kernel factors the (m1 x m1)
// correlation block of p and its m1-1 ascending neighbours (self last),
// L L^T = K, then solves L_nn^T w = L[m1-1, :m1-1] by backward
// substitution; x_p | x_N(p) ~ N(w . x_N(p), scale * sigma^2) with
// sigma = L[m1-1, m1-1].  Outputs w (m1-1, n) and sigma (n,).
//
// What bounds it on an H100: per point it reads m1*(d+1) values and writes
// m1, about 0.6 KB at the slice's m1 = 26, d = 1 in float64, against about
// m1^3/6 + m1^2 ~ 3.6k fused multiply-adds and m1^2/2 exponentials.  That
// is near the card's float64 ridge for device-memory traffic, but the real
// limit is elsewhere: the factor's 351 values live in per-thread local
// memory, and each of the ~2.9k Cholesky updates reads two of them, so the
// kernel is bound by L1/L2 traffic and latency, and at the slice's n = 2000
// it runs only 2000 threads (16 blocks on 132 SMs).
//
// What the design does about it: one thread per point keeps every global
// read coalesced and needs no synchronisation; the correlation columns are
// built on the fly (no block-matrix scratch in device memory), and only the
// outputs are written.  Keeping L in registers or shared memory, and more
// threads per point, are for the PRs that make this kernel fast.
#include "vecchia_common.cuh"

namespace dgp {

template <typename T, int KN>
__global__ void __launch_bounds__(THREADS)
cond_weights_kernel(const T* __restrict__ Xg, const T* __restrict__ diag, T* __restrict__ w,
                    T* __restrict__ sigma, int m1, int d, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  T L[TRI_MAX];
  const PlainCoords<T> x{Xg, d, n, p};
  const auto col = [&](int i, int j) { return corr<T, KN>(x, i, j, 0, d); };
  column_cholesky<T>(col, diag, n, p, m1, L);
  backward_last_row<T>(L, w, n, p, m1);
  sigma[p] = L[tri(m1 - 1, m1 - 1)];
}

template <typename T>
static void launch(int kname, const void* Xg, const void* diag, void* w, void* sigma, int m1,
                   int d, int n, cudaStream_t stream) {
  const dim3 grid(blocks_for(n));
  const auto* x = static_cast<const T*>(Xg);
  const auto* dg = static_cast<const T*>(diag);
  auto* wo = static_cast<T*>(w);
  auto* so = static_cast<T*>(sigma);
  if (kname == SEXP)
    cond_weights_kernel<T, SEXP><<<grid, THREADS, 0, stream>>>(x, dg, wo, so, m1, d, n);
  else
    cond_weights_kernel<T, MATERN25><<<grid, THREADS, 0, stream>>>(x, dg, wo, so, m1, d, n);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dgp_cond_weights(int dtype, int kname, const void* Xg, const void* diag, void* w,
                                void* sigma, int m1, int d, int n, void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || n < 1 || (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dgp::launch<double>(kname, Xg, diag, w, sigma, m1, d, n, s);
  else if (dtype == 0)
    dgp::launch<float>(kname, Xg, diag, w, sigma, m1, d, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int dgp_vecchia_m1_max() { return dgp::M1_MAX; }
