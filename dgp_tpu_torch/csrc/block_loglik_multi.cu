// K2: Vecchia log-likelihood parts of K elliptical-slice candidates.
//
// Replaces: dgp_tpu/ops/pallas_vecchia.py:block_loglik_multi_t (Pallas body
// _kernel_multi).  For candidate k and point p the block coordinates are
// cos_k * A + sin_k * B + C; the kernel factors the block's correlation
// matrix (diagonal from diag), forward-solves L sol = y and writes
// logdet[k, p] = 2 log L[m1-1, m1-1] and quad[k, p] = sol[m1-1]^2.  Dims
// >= dl do not depend on the candidate (A and B are zero there and C holds
// the global coordinates); as in the TPU kernel and the plain version their
// correlation is a separate factor that multiplies the candidate-dependent
// one.  Keeping the two factors apart matters in float32: at a sentinel
// lane each Matern-2.5 dim contributes a polynomial factor of ~1e14, so a
// product over three dims would overflow to inf and inf * exp(-...) = NaN,
// where each factor alone stays finite and its exponential takes it to 0.
//
// What bounds it on an H100: per (candidate, point) it reads 3*m1*d + 2*m1
// values (1.7 KB at the slice's m1 = 26, d = 2 in float64; the K candidates
// of a point share them) against about m1^3/6 + m1^2 ~ 3.6k fused
// multiply-adds and m1^2/2 exponentials (m1^2 when 0 < dl < d).  Neither
// bytes nor operations bound it: the factorisation is a chain of m1
// dependent column steps (a shuffle, a reciprocal square root, a publish
// and the update), and how many such chains an SM keeps in flight (16
// warps at 97 registers in float64) sets the time.  Blocks of 33 to 64 rows
// are chains of 2 m1 - 32 steps (vecchia_warp.cuh's two panels), at 226
// registers in float64: 8 warps an SM.
//
// What the design does about it (vecchia_warp.cuh): one warp per point,
// factoring the blocks of its K candidates in turn.  A block's
// correlations are spread evenly over the 32 lanes, and the column
// Cholesky runs across the lanes with the forward substitution of y fused
// in; only the last lane's L[m1-1, m1-1] and sol[m1-1] are written.  A
// thread block stages the A, B, C, y and diag tiles of P points once
// (coalesced), and the warp forms each candidate's coordinates from the
// staged tile in its own shared buffer.  PERF.md has the measurements
// against the candidate axis on the grid (one candidate per thread block).
// Blocks of 33 to 64 rows run the two-panel factorisation (R = 2 in
// vecchia_warp.cuh): every update a multiply-add on a row held in
// registers, one __syncwarp a step, and a point keeps panel 2's (32, 33)
// array, panel 1's (m1 - 32, 33) and two column buffers, no copy of the
// block.  Its entry point asks for one resident block, which lets ptxas
// take the registers the two register rows need; a cap of 168 registers
// (10 warps an SM at m1 = 64 in float64 instead of 8) measured slower.
// Two candidates interleaved in one warp were not tried.
#include "vecchia_warp.cuh"

namespace dgp {

// shared values of one point: its A, B, C tiles, y and diag, the warp's
// candidate coordinates and its block
template <int R>
__host__ __device__ inline int multi_per_point(int m1, int d) {
  return 3 * m1 * d + 2 * m1 + d * m1 + block_scratch<R>(m1, KEEP_NONE);
}

// The kernel's body at R rows per lane; the entry points of R = 1 and R = 2
// below differ only in their launch bounds.
template <typename T, int KN, int R>
__device__ __forceinline__ void multi_body(const T* __restrict__ A, const T* __restrict__ B,
                                           const T* __restrict__ C, const T* __restrict__ yg,
                                           const T* __restrict__ diag,
                                           const T* __restrict__ cosv,
                                           const T* __restrict__ sinv, T* __restrict__ logdet,
                                           T* __restrict__ quad, int m1, int d, int dl, int n,
                                           int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int p0 = blockIdx.x * P;
  const int tile = m1 * d * P;
  T* As = sm;
  T* Bs = As + tile;
  T* Cs = Bs + tile;
  T* ys = Cs + tile;
  T* ds = ys + m1 * P;
  T* xw = ds + m1 * P + warp * (d * m1 + block_scratch<R>(m1, KEEP_NONE));   // (m1, d)
  T* ls = xw + d * m1;                                                       // the block
  stage(A, As, m1, d, n, p0, P);
  stage(B, Bs, m1, d, n, p0, P);
  stage(C, Cs, m1, d, n, p0, P);
  stage(yg, ys, m1, 1, n, p0, P);
  stage(diag, ds, m1, 1, n, p0, P);
  __syncthreads();

  const int p = p0 + warp;
  if (p >= n) return;
  const int dlc = dl < d && dl > 0 ? dl : d;   // dims built from the candidate
  const int last = m1 - 1;
  const TileCoords<T> x{xw, d};
  for (int k = 0; k < K; ++k) {
    const T c = cosv[k], s = sinv[k];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      if (row < m1)
        for (int t = 0; t < d; ++t) {
          const int o = (warp * m1 + row) * d + t;
          xw[row * d + t] = t < dlc ? c * As[o] + s * Bs[o] + Cs[o] : Cs[o];
        }
    }
    __syncwarp();
    T dg[R], b[R], lii[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      dg[r] = row < m1 ? ds[warp * m1 + row] : T(0);
      b[r] = row < m1 ? ys[warp * m1 + row] : T(0);
    }
    warp_factor<T, KN, R, KEEP_NONE>(x, dg, ls, static_cast<T*>(nullptr), b, lii, m1, d, dlc,
                                     lane);
    if (lane == last % WARP) {
      const long long o = (long long)k * n + p;
      const T sl = pick(b, last / WARP);
      logdet[o] = T(2) * d_log(pick(lii, last / WARP));
      quad[o] = sl * sl;
    }
  }
}

// R = 1
template <typename T, int KN>
__global__ void __launch_bounds__(WARP * WARPS_MAX)
block_loglik_multi_kernel(const T* __restrict__ A, const T* __restrict__ B,
                          const T* __restrict__ C, const T* __restrict__ yg,
                          const T* __restrict__ diag, const T* __restrict__ cosv,
                          const T* __restrict__ sinv, T* __restrict__ logdet,
                          T* __restrict__ quad, int m1, int d, int dl, int n, int K) {
  multi_body<T, KN, 1>(A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl, n, K);
}

// R = 2: the minimum of one resident block lets ptxas take the registers the
// two register rows of the panel code need (226 in float64, no spills).
template <typename T, int KN>
__global__ void __launch_bounds__(WARP * WARPS_MAX, 1)
block_loglik_multi_kernel_r2(const T* __restrict__ A, const T* __restrict__ B,
                             const T* __restrict__ C, const T* __restrict__ yg,
                             const T* __restrict__ diag, const T* __restrict__ cosv,
                             const T* __restrict__ sinv, T* __restrict__ logdet,
                             T* __restrict__ quad, int m1, int d, int dl, int n, int K) {
  multi_body<T, KN, 2>(A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl, n, K);
}

template <typename T, int KN, int R>
static int launch_r(const T* a, const T* b, const T* c, const T* y, const T* dg, const T* cs,
                    const T* sn, T* ld, T* q, int m1, int d, int dl, int n, int K,
                    cudaStream_t stream) {
  const auto kern =
      R == 1 ? block_loglik_multi_kernel<T, KN> : block_loglik_multi_kernel_r2<T, KN>;
  int P;
  size_t bytes;
  const cudaError_t err = plan_block((const void*)kern, sizeof(T) * multi_per_point<R>(m1, d),
                                     &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + P - 1) / P, P * WARP, bytes, stream>>>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl,
                                                     n, K);
  return (int)cudaGetLastError();
}

template <typename T, int KN>
static int launch_kn(const T* a, const T* b, const T* c, const T* y, const T* dg, const T* cs,
                     const T* sn, T* ld, T* q, int m1, int d, int dl, int n, int K,
                     cudaStream_t stream) {
  if (rows_per_lane(m1) == 1)
    return launch_r<T, KN, 1>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl, n, K, stream);
  return launch_r<T, KN, 2>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl, n, K, stream);
}

template <typename T>
static int launch(int kname, const void* A, const void* B, const void* C, const void* yg,
                  const void* diag, const void* cosv, const void* sinv, void* logdet,
                  void* quad, int m1, int d, int dl, int n, int K, cudaStream_t stream) {
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
    return launch_kn<T, SEXP>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl, n, K, stream);
  return launch_kn<T, MATERN25>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl, n, K, stream);
}

// The launch plan of the sexp kernel at (m1, d) (see the extern "C" below).
template <typename T>
static int plan(int m1, int d, int* out) {
  if (rows_per_lane(m1) == 1)
    return (int)plan_report((const void*)block_loglik_multi_kernel<T, SEXP>,
                            sizeof(T) * multi_per_point<1>(m1, d), out);
  return (int)plan_report((const void*)block_loglik_multi_kernel_r2<T, SEXP>,
                          sizeof(T) * multi_per_point<2>(m1, d), out);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.
// Returns the launch's cudaError_t (0 on success).
extern "C" int dgp_block_loglik_multi(int dtype, int kname, const void* A, const void* B,
                                      const void* C, const void* yg, const void* diag,
                                      const void* cosv, const void* sinv, void* logdet,
                                      void* quad, int m1, int d, int dl, int n, int K,
                                      void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || dl < 0 || n < 1 || K < 1 ||
      (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dgp::launch<double>(kname, A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl,
                               n, K, s);
  if (dtype == 0)
    return dgp::launch<float>(kname, A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl,
                              n, K, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of the sexp kernel at (m1, d): out[0] points (warps) per
// thread block, out[1] its shared bytes, out[2] blocks resident per SM.
extern "C" int dgp_block_loglik_multi_plan(int dtype, int m1, int d, int* out) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return dgp::plan<double>(m1, d, out);
  if (dtype == 0) return dgp::plan<float>(m1, d, out);
  return (int)cudaErrorInvalidValue;
}
