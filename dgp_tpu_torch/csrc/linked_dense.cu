// K5: the dense linked-GP moments of M Gaussian queries, one fused
// reduction over the (n, n) training pairs.
//
// Replaces no TPU kernel: dgp_tpu computes these moments in plain JAX
// (`ops/moments.py`'s I and J, then `gp_core.linkgp_predict`), and so does
// the port's plain version (`ops/cuda_linked.py:linked_dense_t_plain`), which
// materialises each query's (n, n) second moments J and two products of them.
// The kernel was added for speed: at n = 2000 those temporaries move about
// 1.5 GB a query through device memory, for about 1e8 operations.
//
// What it computes.  For query q with Gaussian input w ~ N(z_m, diag(z_v))
// over D dims, row weights w_qi (the deterministic global input's
// correlations, or ones), a = Rinv_y and
//   J_q,ij = prod_t E[k_t(w_t, x_it) k_t(w_t, x_jt)]
// (the closed form of `moments.j_sexp`, or `_jd_matern_1d` per dim for
// matern2.5; a matern dim with z_v = 0 contributes a factor of 1 here, its
// deterministic factors being folded into the row weights by the wrapper):
//   tr_q   = sum_ij Rinv_ij w_qi w_qj J_q,ij
//   quad_q = sum_ij a_i a_j w_qi w_qj J_q,ij
//   mu_q   = sum_i a_i Iw_qi            (Iw = I * w, from the wrapper)
// For sexp J carries the per-query factor c_q = prod_t (1 + 4 z_v / l^2)^-1/2,
// which multiplies the sums at the end.
//
// What bounds it on an H100: float64 arithmetic.  A pair of points costs,
// per query, one exp and about 6 operations a dim (sexp) -- at n = 2000,
// M = 250 about 5e8 pair-queries a call -- while the bytes it needs are
// Rinv (32 MB) once a call, the coordinates and the (M, n) weights.
//
// What the design does about it.  A thread block owns one 64 x 64 tile of
// the pairs' upper triangle (J and the pair sum are symmetric, so an
// off-diagonal tile counts Rinv_ij + Rinv_ji and 2 a_i a_j; a diagonal tile
// counts its lower half as 0), keeps those per-pair factors in registers
// (16 pairs a thread, 4 rows by 4 columns), stages the tile's coordinates in
// shared memory once and then loops over all M queries of the call: Rinv is
// read once a call, and no J value leaves registers.  Each pair's exponent
// is summed from squared differences as the plain version does,
// (u_i + u_j)^2 / (2 l^2 + 8 z_v) + (u_i - u_j)^2 / (2 l^2) with u = x - z_m,
// never factored into per-point terms and a bilinear form (which would
// overflow and cancel where this does not).  Reductions are deterministic:
// a query's 16 products a thread go to a fixed shuffle tree, the 8 warps'
// sums add in order in shared memory, each tile writes its per-query
// partial sums to scratch, and a second kernel adds each query's partials
// in a fixed order.  No float atomics: a query's result depends neither on
// M nor on the other queries of its call.
#include "linked_moments.cuh"

namespace dgp {

constexpr int LD_TILE = 64;                       // pairs' tile edge
constexpr int LD_PI = 4, LD_PJ = 4;               // a thread's rows and columns
constexpr int LD_TI = LD_TILE / LD_PI;            // threads along the rows
constexpr int LD_TJ = LD_TILE / LD_PJ;            // threads along the columns
constexpr int LD_THREADS = LD_TI * LD_TJ;
constexpr int LD_WARPS = LD_THREADS / 32;
constexpr int LD_ROUND = 32;                      // queries per reduction round
constexpr int LD_FINISH_WARPS = 8;                // queries a finishing block
// dynamic shared memory a launch gets without opting in
constexpr size_t LD_SMEM_DEFAULT = 48 * 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One thread block per tile (bi <= bj) of the pairs' upper triangle; writes
// part[(q * nblk + tile) * 2 + {0, 1}] = the tile's (tr, quad) sums of
// query q, before the factor c_q.
template <typename T, int KN>
__global__ void __launch_bounds__(LD_THREADS, 1)
linked_dense_kernel(const T* __restrict__ X, const T* __restrict__ zm, const T* __restrict__ zv,
                    const T* __restrict__ len, const T* __restrict__ W,
                    const T* __restrict__ a, const T* __restrict__ Rinv, T* __restrict__ part,
                    int n, int D, int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs_i = reinterpret_cast<T*>(smem_raw);          // (D, LD_TILE)
  T* xs_j = xs_i + D * LD_TILE;                       // (D, LD_TILE)
  T* red = xs_j + D * LD_TILE;                        // (LD_ROUND, LD_WARPS, 2)

  const int nt = (n + LD_TILE - 1) / LD_TILE;
  const int nblk = nt * (nt + 1) / 2;
  int b = blockIdx.x, bi = 0;
  while (b >= nt - bi) {
    b -= nt - bi;
    ++bi;
  }
  const int bj = bi + b;
  const int i0 = bi * LD_TILE, j0 = bj * LD_TILE;
  const int tx = threadIdx.x % LD_TJ, ty = threadIdx.x / LD_TJ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // coordinates of the tile's rows and columns; a point past n takes the
  // last point's (its pairs carry zero factors, and finite J)
  for (int k = threadIdx.x; k < D * LD_TILE; k += LD_THREADS) {
    const int t = k / LD_TILE, p = k % LD_TILE;
    xs_i[k] = X[(size_t)min(i0 + p, n - 1) * D + t];
    xs_j[k] = X[(size_t)min(j0 + p, n - 1) * D + t];
  }

  // per-pair factors of the sums: Rinv_ij + Rinv_ji and 2 a_i a_j off the
  // diagonal, Rinv_ii and a_i^2 on it, 0 below it and past n
  T rs[LD_PI][LD_PJ], af[LD_PI][LD_PJ];
  int ii[LD_PI], jj[LD_PJ];
#pragma unroll
  for (int r = 0; r < LD_PI; ++r) ii[r] = min(i0 + ty + LD_TI * r, n - 1);
#pragma unroll
  for (int c = 0; c < LD_PJ; ++c) jj[c] = min(j0 + tx + LD_TJ * c, n - 1);
#pragma unroll
  for (int r = 0; r < LD_PI; ++r) {
    const int i = i0 + ty + LD_TI * r;
#pragma unroll
    for (int c = 0; c < LD_PJ; ++c) {
      const int j = j0 + tx + LD_TJ * c;
      rs[r][c] = T(0);
      af[r][c] = T(0);
      if (i < n && j < n && i <= j) {
        const T ai = a[i], aj = a[j];
        if (i == j) {
          rs[r][c] = Rinv[(size_t)i * n + i];
          af[r][c] = ai * ai;
        } else {
          rs[r][c] = Rinv[(size_t)i * n + j] + Rinv[(size_t)j * n + i];
          af[r][c] = T(2) * ai * aj;
        }
      }
    }
  }
  __syncthreads();

  for (int q0 = 0; q0 < M; q0 += LD_ROUND) {
    const int nq = min(LD_ROUND, M - q0);
    for (int k = 0; k < nq; ++k) {
      const int q = q0 + k;
      T e[LD_PI][LD_PJ];
#pragma unroll
      for (int r = 0; r < LD_PI; ++r)
#pragma unroll
        for (int c = 0; c < LD_PJ; ++c) e[r][c] = KN == SEXP ? T(0) : T(1);
      for (int t = 0; t < D; ++t) {
        const T m = zm[(size_t)q * D + t], v = zv[(size_t)q * D + t], l = len[t];
        if (KN == SEXP) {
          const T rp = T(1) / (T(2) * l * l + T(8) * v);
          const T rm = T(1) / (T(2) * l * l);
          T ui[LD_PI], uj[LD_PJ];
#pragma unroll
          for (int r = 0; r < LD_PI; ++r) ui[r] = xs_i[t * LD_TILE + ty + LD_TI * r] - m;
#pragma unroll
          for (int c = 0; c < LD_PJ; ++c) uj[c] = xs_j[t * LD_TILE + tx + LD_TJ * c] - m;
#pragma unroll
          for (int r = 0; r < LD_PI; ++r)
#pragma unroll
            for (int c = 0; c < LD_PJ; ++c) {
              const T p = ui[r] + uj[c], d = ui[r] - uj[c];
              e[r][c] += p * p * rp + d * d * rm;
            }
        } else if (v > T(0)) {
          const MaternDim<T> md(m, v, l);
          T xi[LD_PI], xj[LD_PJ];
#pragma unroll
          for (int r = 0; r < LD_PI; ++r) xi[r] = xs_i[t * LD_TILE + ty + LD_TI * r];
#pragma unroll
          for (int c = 0; c < LD_PJ; ++c) xj[c] = xs_j[t * LD_TILE + tx + LD_TJ * c];
#pragma unroll
          for (int r = 0; r < LD_PI; ++r)
#pragma unroll
            for (int c = 0; c < LD_PJ; ++c) e[r][c] *= jd_matern(xi[r], xj[c], md);
        }
      }
      T wi[LD_PI], wj[LD_PJ];
#pragma unroll
      for (int r = 0; r < LD_PI; ++r) wi[r] = W ? W[(size_t)q * n + ii[r]] : T(1);
#pragma unroll
      for (int c = 0; c < LD_PJ; ++c) wj[c] = W ? W[(size_t)q * n + jj[c]] : T(1);
      T st = T(0), sq = T(0);
#pragma unroll
      for (int r = 0; r < LD_PI; ++r) {
        T rt = T(0), rq = T(0);
#pragma unroll
        for (int c = 0; c < LD_PJ; ++c) {
          const T g = (KN == SEXP ? d_exp(-e[r][c]) : e[r][c]) * wj[c];
          rt += rs[r][c] * g;
          rq += af[r][c] * g;
        }
        st += wi[r] * rt;
        sq += wi[r] * rq;
      }
      st = warp_sum(st);
      sq = warp_sum(sq);
      if (lane == 0) {
        red[(k * LD_WARPS + warp) * 2] = st;
        red[(k * LD_WARPS + warp) * 2 + 1] = sq;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * nq) {
      const int k = threadIdx.x / 2, comp = threadIdx.x % 2;
      T s = T(0);
      for (int w = 0; w < LD_WARPS; ++w) s += red[(k * LD_WARPS + w) * 2 + comp];
      part[((size_t)(q0 + k) * nblk + blockIdx.x) * 2 + comp] = s;
    }
    __syncthreads();
  }
}

// One warp per query: its tiles' partial sums in a fixed order (lane k adds
// tiles k, k + 32, ..., then a fixed shuffle tree), times c_q for sexp, and
// mu_q = sum_i a_i Iw_qi the same way.
template <typename T, int KN>
__global__ void __launch_bounds__(LD_FINISH_WARPS * 32)
linked_dense_finish(const T* __restrict__ part, const T* __restrict__ zv,
                    const T* __restrict__ len, const T* __restrict__ Iw,
                    const T* __restrict__ a, T* __restrict__ mu, T* __restrict__ tr,
                    T* __restrict__ quad, int n, int D, int M, int nblk) {
  const int q = blockIdx.x * LD_FINISH_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= M) return;                                  // the whole warp
  T st = T(0), sq = T(0), sm = T(0);
  for (int k = lane; k < nblk; k += 32) {
    st += part[((size_t)q * nblk + k) * 2];
    sq += part[((size_t)q * nblk + k) * 2 + 1];
  }
  for (int i = lane; i < n; i += 32) sm += a[i] * Iw[(size_t)q * n + i];
  st = warp_sum(st);
  sq = warp_sum(sq);
  sm = warp_sum(sm);
  if (lane == 0) {
    T c = T(1);
    if (KN == SEXP)
      for (int t = 0; t < D; ++t)
        c *= T(1) / d_sqrt(T(1) + T(4) * zv[(size_t)q * D + t] / (len[t] * len[t]));
    tr[q] = c * st;
    quad[q] = c * sq;
    mu[q] = sm;
  }
}

inline int linked_tiles(int n) {
  const int nt = (n + LD_TILE - 1) / LD_TILE;
  return nt * (nt + 1) / 2;
}

template <typename T>
inline size_t linked_shared_bytes(int D) {
  return sizeof(T) * (2 * (size_t)D * LD_TILE + 2 * LD_ROUND * LD_WARPS);
}

template <typename T, int KN>
static int linked_launch(const T* X, const T* zm, const T* zv, const T* len, const T* W,
                         const T* Iw, const T* a, const T* Rinv, T* part, T* mu, T* tr,
                         T* quad, int n, int D, int M, cudaStream_t stream) {
  const auto kern = linked_dense_kernel<T, KN>;
  const size_t bytes = linked_shared_bytes<T>(D);
  if (bytes > LD_SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const int nblk = linked_tiles(n);
  kern<<<nblk, LD_THREADS, bytes, stream>>>(X, zm, zv, len, W, a, Rinv, part, n, D, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  linked_dense_finish<T, KN><<<(M + LD_FINISH_WARPS - 1) / LD_FINISH_WARPS,
                               LD_FINISH_WARPS * 32, 0, stream>>>(
      part, zv, len, Iw, a, mu, tr, quad, n, D, M, nblk);
  return (int)cudaGetLastError();
}

template <typename T>
static int linked_launch_t(int kname, const void* X, const void* zm, const void* zv,
                           const void* len, const void* W, const void* Iw, const void* a,
                           const void* Rinv, void* part, void* mu, void* tr, void* quad,
                           int n, int D, int M, cudaStream_t s) {
  const auto c = [](const void* p) { return static_cast<const T*>(p); };
  const auto o = [](void* p) { return static_cast<T*>(p); };
  if (kname == SEXP)
    return linked_launch<T, SEXP>(c(X), c(zm), c(zv), c(len), c(W), c(Iw), c(a), c(Rinv),
                                  o(part), o(mu), o(tr), o(quad), n, D, M, s);
  return linked_launch<T, MATERN25>(c(X), c(zm), c(zv), c(len), c(W), c(Iw), c(a), c(Rinv),
                                    o(part), o(mu), o(tr), o(quad), n, D, M, s);
}

}  // namespace dgp

// The tiles (thread blocks) of a call at n points: the rows of the partial
// sums' scratch per query, which holds (M, tiles, 2) values.
extern "C" int dgp_linked_dense_tiles(int n) { return n < 1 ? 0 : dgp::linked_tiles(n); }

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.  X (n, D);
// zm, zv (M, D); len (D,); W (M, n) or null for unit weights; Iw (M, n);
// a (n,); Rinv (n, n); part (M, tiles, 2) scratch; mu, tr, quad (M,) out.
// Returns the launches' cudaError_t (0 on success).
extern "C" int dgp_linked_dense(int dtype, int kname, const void* X, const void* zm,
                                const void* zv, const void* len, const void* W, const void* Iw,
                                const void* a, const void* Rinv, void* part, void* mu, void* tr,
                                void* quad, int n, int D, int M, void* stream) {
  if (n < 1 || D < 1 || M < 1 || (kname != 0 && kname != 1)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dgp::linked_launch_t<double>(kname, X, zm, zv, len, W, Iw, a, Rinv, part, mu, tr,
                                        quad, n, D, M, s);
  if (dtype == 0)
    return dgp::linked_launch_t<float>(kname, X, zm, zv, len, W, Iw, a, Rinv, part, mu, tr,
                                       quad, n, D, M, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of the kernel at D dims: out[0] threads per block,
// out[1] its shared bytes, out[2] blocks resident per SM.
extern "C" int dgp_linked_dense_plan(int dtype, int kname, int D, int* out) {
  if (D < 1 || (kname != 0 && kname != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* kern;
  size_t bytes;
  if (dtype == 1) {
    kern = kname == 0 ? (const void*)dgp::linked_dense_kernel<double, dgp::SEXP>
                      : (const void*)dgp::linked_dense_kernel<double, dgp::MATERN25>;
    bytes = dgp::linked_shared_bytes<double>(D);
  } else {
    kern = kname == 0 ? (const void*)dgp::linked_dense_kernel<float, dgp::SEXP>
                      : (const void*)dgp::linked_dense_kernel<float, dgp::MATERN25>;
    bytes = dgp::linked_shared_bytes<float>(D);
  }
  if (bytes > dgp::LD_SMEM_DEFAULT) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, dgp::LD_THREADS, bytes);
  out[0] = dgp::LD_THREADS;
  out[1] = (int)bytes;
  out[2] = blocks;
  return (int)err;
}
