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
// The static factor.  The TPU kernel builds the static dims' factor once a
// slab, at candidate step 0, into a scratch G that every candidate reads
// (`_build_static`).  Here, at one row per lane (m1 <= 32), a warp builds
// it once a point, where 0 < dl < d, above the diagonal of its (m1, LDS)
// block (`warp_build_static`), where it costs no shared memory: K2 keeps no
// copy of the correlations, and the factorisation reads only the lower
// triangle and the diagonal.  Each candidate then computes its correlation
// over the dl latent dims alone and multiplies it by the kept factor below
// the diagonal (`warp_build_lower`; the latent factor first, as before, so
// that every value the factorisation sees is the same bit for bit): one
// exponential a pair instead of two at the main path's d = 2, dl = 1.  Only
// what is read is staged: A's and B's dl leading dims and the whole of C,
// each transposed to (dims, m1) as K1's tile is, and each candidate's dl
// coordinates are formed laid out (dl, m1).
// Blocks of 33 to 64 rows (R = 2) build both factors for each candidate: the
// two panels reuse their arrays, so a kept factor there needs about m1 * LDS
// values a point of its own, which leaves plan_block's warps a block and
// the blocks an SM as they are only at a few (m1, d) in float64 (d = 1: m1
// = 38-41; d = 2: 35-39; d = 3: 33-37), none that a path of the repository
// runs: at the m = 40 models' (41, 2) it halves the warps a block.
//
// What bounds it on an H100: per (candidate, point) about m1^3/6 + m1^2 ~
// 3.6k fused multiply-adds and one exponential a pair at d = 2, dl = 1, the
// K candidates of a point sharing its 3 m1 d + 2 m1 values read (1.7 KB at
// m1 = 26 in float64).  Neither bytes nor operations bound it: the
// factorisation is a chain of m1 dependent column steps (a shuffle, a
// reciprocal square root, a publish and the update).  At n = 2000 the 2000
// warps of a call are resident at once (20 warps an SM in float64, 32 in
// float32), so a call lasts one warp's chain of K candidates; at n = 1e5 it
// is some 40 waves, and the time follows the chains an SM keeps in flight
// and the instructions each issues: 100 registers instead of 96, 16 warps
// an SM instead of 20, measured 12% slower there.
//
// What the design does about it: one warp a point, its K candidates in
// turn, the column Cholesky across the lanes with the forward substitution
// fused in (`warp_cholesky_rhs`): no L written back, and each column
// published shifted, so that the update reads it at fixed offsets and
// checks the block's end every UPDATE_GROUP = 4 entries (a load, a
// multiply-add, and three instructions of the check for every entry
// before).  y and diag are read again from the staged tiles for each
// candidate rather than held: 96 registers in float64, 20 warps an SM; in
// float32 the entry point asks for 4 resident blocks of 256 threads, 64
// registers, 32 warps.
// Two candidates factored together in one warp, their steps issued side by
// side, were measured and left out: in float64 they took 172 registers, 8
// warps an SM in blocks of 4, and at n = 1e5 10.6 ms against 7.7 for one
// candidate a chain at 16 warps; in float32 103 registers, 16 warps, 0.100
// ms against 0.131 at n = 2000 (one wave, each warp's chain halved) but
// 4.5-4.7 ms against 4.0 at n = 1e5.  A second chain in a warp hid less
// latency than a second warp, so no rule by waves was worth a second
// kernel (PERF.md).
// Blocks of 33 to 64 rows run the two-panel factorisation (R = 2 in
// vecchia_warp.cuh): every update a multiply-add on a row held in
// registers, one __syncwarp a step, and a point keeps panel 2's (32, 33)
// array, panel 1's (m1 - 32, 33) and two column buffers, no copy of the
// block, at 226 registers in float64: 8 warps an SM.  Its entry point asks
// for one resident block, which lets ptxas take the registers the two
// register rows need; a cap of 168 registers (10 warps an SM at m1 = 64 in
// float64 instead of 8) measured slower.
#include "vecchia_warp.cuh"

namespace dgp {

// shared values of one point: its A, B, C tiles, y and diag, the warp's
// candidate coordinates and its block
template <int R>
__host__ __device__ inline int multi_per_point(int m1, int d) {
  return 3 * m1 * d + 2 * m1 + d * m1 + block_scratch<R>(m1, KEEP_NONE);
}

// The one-row body.  Shared values of the thread block: A's and B's dims
// [0, dlc) and C (P, dlc or d, m1), y and diag (P, m1), then each warp's xw
// (dlc, m1), block (m1, LDS) and column buffers (2 * WARP): no more than
// multi_per_point<1>(m1, d) a point, which reserves for dlc = d.
template <typename T, int KN>
__device__ __forceinline__ void multi_body_one(const T* __restrict__ A, const T* __restrict__ B,
                                               const T* __restrict__ C,
                                               const T* __restrict__ yg,
                                               const T* __restrict__ diag,
                                               const T* __restrict__ cosv,
                                               const T* __restrict__ sinv,
                                               T* __restrict__ logdet, T* __restrict__ quad,
                                               int m1, int d, int dl, int n, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int p0 = blockIdx.x * P;
  const int dlc = dl < d && dl > 0 ? dl : d;   // dims built from the candidate
  const bool kept = dlc < d;                   // a static factor over [dlc, d)
  T* As = sm;
  T* Bs = As + dlc * m1 * P;
  T* Cs = Bs + dlc * m1 * P;
  T* ys = Cs + d * m1 * P;
  T* ds = ys + m1 * P;
  T* xw = ds + m1 * P + warp * (dlc * m1 + m1 * LDS + 2 * WARP);
  T* ls = xw + dlc * m1;
  stage_lead_transposed(A, As, m1, d, dlc, n, p0, P);
  stage_lead_transposed(B, Bs, m1, d, dlc, n, p0, P);
  stage_transposed(C, Cs, m1, d, n, p0, P);
  stage(yg, ys, m1, 1, n, p0, P);
  stage(diag, ds, m1, 1, n, p0, P);
  __syncthreads();

  const int p = p0 + warp;
  if (p >= n) return;
  const T* aw = As + warp * dlc * m1;
  const T* bw = Bs + warp * dlc * m1;
  const T* cw = Cs + warp * d * m1;
  // the static factor, once for the K candidates, as _build_static does
  if (kept) warp_build_static<T, KN>(TileCoordsT<T>{cw, m1}, ls, m1, dlc, d, lane);
  for (int k = 0; k < K; ++k) {
    const T c = cosv[k], s = sinv[k];
    if (lane < m1)
      for (int t = 0; t < dlc; ++t) {
        const int o = t * m1 + lane;
        xw[o] = c * aw[o] + s * bw[o] + cw[o];
      }
    __syncwarp();
    // y and diag are read again for each candidate: held in registers
    // across the factorisation they would cost a resident warp an SM
    warp_build_lower<T, KN>(TileCoordsT<T>{xw, m1}, lane < m1 ? ds[warp * m1 + lane] : T(0),
                            ls, m1, dlc, kept, lane);
    T a[WARP];
#pragma unroll
    for (int t = 0; t < WARP; ++t) a[t] = t < m1 ? ls[t * LDS + lane] : T(0);
    T b = lane < m1 ? ys[warp * m1 + lane] : T(0), lii;
    warp_cholesky_rhs<T>(a, ls + m1 * LDS, b, lii, m1, lane);
    if (lane == m1 - 1) {
      const long long o = (long long)k * n + p;
      logdet[o] = T(2) * d_log(lii);
      quad[o] = b * b;
    }
  }
}

// Two rows per lane (R = 2): each candidate's whole coordinates in xw, (m1,
// d), and both correlation factors built for each candidate.
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

// R = 1.  In float32 a minimum of 4 resident 256-thread blocks holds ptxas
// to 64 registers, 32 warps an SM.
template <typename T, int KN>
__global__ void __launch_bounds__(WARP * WARPS_MAX, sizeof(T) == 4 ? 4 : 1)
block_loglik_multi_kernel(const T* __restrict__ A, const T* __restrict__ B,
                          const T* __restrict__ C, const T* __restrict__ yg,
                          const T* __restrict__ diag, const T* __restrict__ cosv,
                          const T* __restrict__ sinv, T* __restrict__ logdet,
                          T* __restrict__ quad, int m1, int d, int dl, int n, int K) {
  multi_body_one<T, KN>(A, B, C, yg, diag, cosv, sinv, logdet, quad, m1, d, dl, n, K);
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

// The entry point of a launch at m1.
template <typename T>
using MultiKernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*,
                             const T*, T*, T*, int, int, int, int, int);
template <typename T, int KN>
static MultiKernel<T> multi_kernel(int m1) {
  return rows_per_lane(m1) == 1 ? block_loglik_multi_kernel<T, KN>
                                : block_loglik_multi_kernel_r2<T, KN>;
}

template <typename T>
static size_t multi_bytes(int m1, int d) {
  return sizeof(T) * (rows_per_lane(m1) == 1 ? multi_per_point<1>(m1, d)
                                             : multi_per_point<2>(m1, d));
}

template <typename T, int KN>
static int launch_kn(const T* a, const T* b, const T* c, const T* y, const T* dg, const T* cs,
                     const T* sn, T* ld, T* q, int m1, int d, int dl, int n, int K,
                     cudaStream_t stream) {
  const MultiKernel<T> kern = multi_kernel<T, KN>(m1);
  int P;
  size_t bytes;
  const cudaError_t err = plan_block((const void*)kern, multi_bytes<T>(m1, d), &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + P - 1) / P, P * WARP, bytes, stream>>>(a, b, c, y, dg, cs, sn, ld, q, m1, d, dl,
                                                     n, K);
  return (int)cudaGetLastError();
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
  return (int)plan_report((const void*)multi_kernel<T, SEXP>(m1), multi_bytes<T>(m1, d), out);
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
