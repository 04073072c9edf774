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
// m1^3/6 + m1^2 ~ 3.6k fused multiply-adds and m1^2/2 exponentials.
// Neither bytes nor operations bound it: the factorisation and the backward
// substitution are chains of m1 dependent steps across the lanes (a
// shuffle, a reciprocal square root or a reciprocal multiply, the update),
// and at n = 2000 the 2000 chains fit on the card at once, so one call
// lasts about one point's two chains plus the launch.
//
// What the design does about it (vecchia_warp.cuh): one warp per point.  The
// block's correlations are spread evenly over the 32 lanes (one product
// over all d dims, as in the TPU kernel); the column Cholesky runs across
// the lanes, each lane's unfactored row in registers, and leaves L and
// 1 / L[j][j] in the warp's shared memory; the backward substitution reads
// L transposed, lane i starting from L[m1-1][i], as the TPU kernel solves
// it directly.  A thread block stages the X and diag tiles of its P points
// (coalesced), collects its points' weights in shared memory and writes
// them back with consecutive threads on consecutive points.
// Blocks of 33 to 64 rows run the two-panel factorisation (R = 2 in
// vecchia_warp.cuh), each panel's rows in registers.
#include "vecchia_warp.cuh"

namespace dgp {

// the warp's shared values: its block and, at R = 1, 1 / L[j][j] (at R = 2
// the panels' diagonals hold it)
template <int R>
__host__ __device__ inline int condw_warp_scratch(int m1) {
  return block_scratch<R>(m1, KEEP_L) + (R == 1 ? WARP : 0);
}

// shared values of one point: its X tile, diag, weights and the warp's scratch
template <int R>
__host__ __device__ inline int condw_per_point(int m1, int d) {
  return m1 * d + m1 + (m1 - 1) + condw_warp_scratch<R>(m1);
}

template <typename T, int KN, int R>
__global__ void __launch_bounds__(WARP * WARPS_MAX)
cond_weights_kernel(const T* __restrict__ Xg, const T* __restrict__ diag, T* __restrict__ w,
                    T* __restrict__ sigma, int m1, int d, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int p0 = blockIdx.x * P;
  const int m = m1 - 1;
  T* Xs = sm;
  T* ds = Xs + m1 * d * P;
  T* ws = ds + m1 * P;                                        // (P, m)
  T* ls = ws + m * P + warp * condw_warp_scratch<R>(m1);      // the block
  T* invd = R == 1 ? ls + block_scratch<R>(m1, KEEP_L) : nullptr;
  stage(Xg, Xs, m1, d, n, p0, P);
  stage(diag, ds, m1, 1, n, p0, P);
  __syncthreads();

  const int p = p0 + warp;
  if (p < n) {
    const TileCoords<T> x{Xs + warp * m1 * d, d};
    T dg[R], b[R], lii[R], acc[R], wi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      dg[r] = row < m1 ? ds[warp * m1 + row] : T(0);
      b[r] = T(0);                       // no right-hand side rides along
    }
    warp_factor<T, KN, R, KEEP_L>(x, dg, ls, invd, b, lii, m1, d, d, lane);
    if constexpr (R == 1) {
      // L[m1-1][i] sits at (m1-1, i)
      acc[0] = lane < m ? ls[lane * LDS + m] : T(0);
    } else {
      acc[0] = panel_l(ls, m1 - WARP, m, lane);
      acc[1] = WARP + lane < m ? panel_l(ls, m1 - WARP, m, WARP + lane) : T(0);
    }
    warp_backward<T, R>(ls, invd, acc, wi, m, m1, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      if (row < m) ws[warp * m + row] = wi[r];
      if (row == m) sigma[p] = lii[r];
    }
  }
  __syncthreads();
  unstage(ws, w, m, n, p0, P);
}

template <typename T, int KN, int R>
static int launch_r(const T* x, const T* dg, T* wo, T* so, int m1, int d, int n,
                    cudaStream_t stream) {
  const auto kern = cond_weights_kernel<T, KN, R>;
  int P;
  size_t bytes;
  const cudaError_t err = plan_block((const void*)kern, sizeof(T) * condw_per_point<R>(m1, d),
                                     &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + P - 1) / P, P * WARP, bytes, stream>>>(x, dg, wo, so, m1, d, n);
  return (int)cudaGetLastError();
}

template <typename T, int KN>
static int launch_kn(const T* x, const T* dg, T* wo, T* so, int m1, int d, int n,
                     cudaStream_t stream) {
  if (rows_per_lane(m1) == 1) return launch_r<T, KN, 1>(x, dg, wo, so, m1, d, n, stream);
  return launch_r<T, KN, 2>(x, dg, wo, so, m1, d, n, stream);
}

template <typename T>
static int launch(int kname, const void* Xg, const void* diag, void* w, void* sigma, int m1,
                  int d, int n, cudaStream_t stream) {
  const auto* x = static_cast<const T*>(Xg);
  const auto* dg = static_cast<const T*>(diag);
  auto* wo = static_cast<T*>(w);
  auto* so = static_cast<T*>(sigma);
  if (kname == SEXP) return launch_kn<T, SEXP>(x, dg, wo, so, m1, d, n, stream);
  return launch_kn<T, MATERN25>(x, dg, wo, so, m1, d, n, stream);
}

// The launch plan of the sexp kernel at (m1, d) (see the extern "C" below).
template <typename T>
static int plan(int m1, int d, int* out) {
  if (rows_per_lane(m1) == 1)
    return (int)plan_report((const void*)cond_weights_kernel<T, SEXP, 1>,
                            sizeof(T) * condw_per_point<1>(m1, d), out);
  return (int)plan_report((const void*)cond_weights_kernel<T, SEXP, 2>,
                          sizeof(T) * condw_per_point<2>(m1, d), out);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.
// Returns the launch's cudaError_t (0 on success).
extern "C" int dgp_cond_weights(int dtype, int kname, const void* Xg, const void* diag, void* w,
                                void* sigma, int m1, int d, int n, void* stream) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1 || n < 1 || (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dgp::launch<double>(kname, Xg, diag, w, sigma, m1, d, n, s);
  if (dtype == 0) return dgp::launch<float>(kname, Xg, diag, w, sigma, m1, d, n, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of the sexp kernel at (m1, d): out[0] points (warps) per
// thread block, out[1] its shared bytes, out[2] blocks resident per SM.
extern "C" int dgp_cond_weights_plan(int dtype, int m1, int d, int* out) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return dgp::plan<double>(m1, d, out);
  if (dtype == 0) return dgp::plan<float>(m1, d, out);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dgp_vecchia_m1_max() { return dgp::M1_MAX; }
