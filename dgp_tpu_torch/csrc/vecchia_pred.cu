// K6: a Vecchia node's prediction, every query point of a call in one
// launch.  Two instantiations of one design, chosen by the entry point:
//
//  * kriging (`vecchia.core.gp_vecch`): for query q with the k training
//    points NN[q] (ascending, -1 for an invalid lane), the (k+1)-row block
//    of their correlations with the query last, diagonal 1 + nugget *
//    nugget_diag (the query's 1 + nugget) plus the float32 jitter and the
//    caller's extra diagonal, factored L L^T = K, gives
//        mean = L[k, :k] . L[:k, :k]^-1 y_NN,   var = scale L[k, k]^2;
//  * linked (`vecchia.core.link_gp_vecch`): for a Gaussian query w ~ N(m,
//    diag(v)) over the Dw dims of w1 and an optional deterministic global
//    input z over the Dz dims of global_w1, the k-row block of NN[q]'s
//    correlations over all Dw + Dz dims, with I_i = E[k(w, x_i)] Iz_i and
//    J_ij = E[k(w, x_i) k(w, x_j)] Iz_i Iz_j (the closed forms of
//    `ops/moments.py`, Iz the correlations with z), a = K^-1 y, gives
//        mu = I . a,   var = |a^T J a - mu^2 + scale (1 + nugget - tr(K^-1 J))|.
//
// Replaces no TPU kernel: dgp_tpu predicts these in plain JAX
// (`vecchia/core.py` gp_vecch and link_gp_vecch), and so does the port's
// plain version (`vecchia.core.gp_vecch_plain`, `link_gp_vecch_plain`), a
// chain of some 70 (kriging) and 120 (linked) small library launches a
// call: the gather, the blocks and their masks, `cholesky_ex`, four
// triangular solves, the moments and the reductions.  The kernel was added
// for the host: at the lgp_n2000.predict cell's M = 250 queries and k = 50
// neighbours a call is about 14 (kriging) and 84 (linked) MFLOP, some
// microseconds of the card, for 2-3 ms of host queueing those launches.
//
// What bounds it on an H100: the chains of dependent steps of each query,
// not operations or bytes.  A query reads about k (d + 3) values; its
// factorisation is a chain of k column steps across the lanes, the linked
// variant's K^-1 two more chains of k steps for every group of NR columns,
// and at M = 250 the queries fill about one wave of the card.
//
// What the design does about it (vecchia_warp.cuh): one warp per query.  It
// loads its own neighbour indices (an index past the training points gives
// NaN for the query), gathers their coordinates, scaled by the lengthscales,
// into its shared tile, and keeps a flag per row: an invalid lane is coupled
// to no row (`MaskedCoords`), has a unit diagonal and zero y, I and J, which
// decouples it exactly.  The block is factored by the warp Cholesky of K1-K4
// (one row per lane up to 32 rows, two panels up to 64) with the forward
// substitution of y riding along; kriging then needs only the last row,
// mean = -(L^-1 y)_k L[k, k].  The linked variant solves back for a (one
// more chain), forms I and the rows' weights per lane, then takes K^-1 by
// columns, NR at a time (a forward and a backward substitution of unit
// vectors, from the factor in shared memory), and adds each column's pairs
// K^-1_ic J_ic and a_i a_c J_ic as it goes: J is formed pair by pair from
// the tile and never stored.  The sexp closed forms are `moments.i_sexp`'s
// and `j_sexp`'s (J's constant factor applied to the sums); matern2.5's are
// K5's `jd_matern` and `i_matern_1d` (linked_moments.cuh), a dim of zero
// variance folded into the rows' weights as `moments.j_matern` takes it.  A
// pivot that is not positive gives NaN in that row and every later one, so
// the query's mean and variance come out NaN, as `chol_small` gives them,
// for the callers' retry at a larger diagonal.  Each warp's sums go to fixed
// shuffle trees: a query's values depend neither on M nor on the other
// queries.
#include "linked_moments.cuh"
#include "vecchia_warp.cuh"

namespace dgp {

// columns of K^-1 the linked variant's substitutions carry at once
constexpr int PRED_NR = 4;

// the warp's shared values for its block: KEEP_L's scratch (the linked
// variant reads L after the factorisation) and, at R = 1, 1 / L[j][j]
template <int R>
__host__ __device__ inline int pred_warp_scratch(int m1) {
  return block_scratch<R>(m1, KEEP_L) + (R == 1 ? WARP : 0);
}

// shared values of one query (both variants; d = D for the linked one): the
// scaled tile, the raw tile, the rows' flags, a and weights, the query's
// constants per dim, and the warp's scratch
template <int R>
__host__ __device__ inline int pred_per_point(int m1, int d) {
  return m1 * (2 * d + 3) + 3 * d + pred_warp_scratch<R>(m1);
}

// A query's scale and nugget: from device memory where the caller holds
// them as tensors, else the values given.
template <typename T>
struct PredScalars {
  const T* scale_p;
  const T* nugget_p;
  double scale, nugget, extra, jitter;
  __device__ __forceinline__ T get_scale() const { return scale_p ? *scale_p : T(scale); }
  __device__ __forceinline__ T get_nugget() const { return nugget_p ? *nugget_p : T(nugget); }
};

template <typename T, int KN, int R>
__global__ void __launch_bounds__(WARP * WARPS_MAX)
kriging_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ w, long long sw,
               const long long* __restrict__ nn, long long snn, const T* __restrict__ y,
               long long sy, const T* __restrict__ nd, long long snd,
               const T* __restrict__ len, int slen, PredScalars<T> ps, T* __restrict__ out,
               int M, int k, int d, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int q = blockIdx.x * P + warp;
  if (q >= M) return;                                  // the whole warp
  const int m1 = k + 1;
  T* xs = reinterpret_cast<T*>(smem_raw) + (long long)warp * pred_per_point<R>(m1, d);
  T* ok = xs + 2 * m1 * d;
  T* ls = ok + 3 * m1 + 3 * d;
  const T nugget = ps.get_nugget(), extra = T(ps.extra), jit = T(ps.jitter);

  // lane's rows lane + 32 r: the neighbours, then the query (row k)
  T dg[R], b[R], lii[R];
  bool bad = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    dg[r] = T(0);
    b[r] = T(0);
    if (row > k) continue;
    long long j = -1;
    if (row < k) {
      j = nn[q * snn + row];
      bad |= j >= n;
    }
    const bool valid = row == k || (j >= 0 && j < n);
    const T* src = row == k ? x + q * sx : (valid ? w + j * sw : x);
    for (int t = 0; t < d; ++t) xs[row * d + t] = valid ? src[t] / len[t * slen] : T(0);
    ok[row] = valid ? T(1) : T(0);
    const T nug = row == k ? nugget : (valid ? nugget * nd[j * snd] : T(0));
    dg[r] = (valid ? T(1) + nug + jit : T(1)) + extra;
    b[r] = row < k && valid ? y[j * sy] : T(0);
  }
  bad = __any_sync(FULL_MASK, bad);
  __syncwarp();
  warp_factor<T, KN, R, KEEP_NONE>(MaskedCoords<T>{xs, ok, d}, dg, ls,
                                   static_cast<T*>(nullptr), b, lii, m1, d, d, lane);
  if (lane == k % WARP) {
    const T sl = pick(b, k / WARP), ll = pick(lii, k / WARP);
    out[q] = bad ? nan_value<T>() : -sl * ll;
    out[M + q] = bad ? nan_value<T>() : ps.get_scale() * (ll * ll);
  }
}

template <typename T, int KN, int R>
__global__ void __launch_bounds__(WARP * WARPS_MAX)
linked_vecch_kernel(const T* __restrict__ zm, long long szm, const T* __restrict__ zv,
                    long long szv, const T* __restrict__ z, long long sz,
                    const T* __restrict__ w1, long long sw, const T* __restrict__ gw,
                    long long sg, const long long* __restrict__ nn, long long snn,
                    const T* __restrict__ y, long long sy, const T* __restrict__ nd,
                    long long snd, const T* __restrict__ len, int slen, PredScalars<T> ps,
                    T* __restrict__ out, int M, int k, int Dw, int Dz, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T SQRT5 = T(2.23606797749978969);
  const int P = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int q = blockIdx.x * P + warp;
  if (q >= M) return;                                  // the whole warp
  const int D = Dw + Dz;
  T* xs = reinterpret_cast<T*>(smem_raw) + (long long)warp * pred_per_point<R>(k, D);
  T* xw = xs + k * D;                                  // (k, Dw) raw w coordinates
  T* ok = xs + 2 * k * D;
  T* av = ok + k;                                      // a = K^-1 y
  T* wr = av + k;                                      // J's row weights
  T* qd = wr + k;                                      // (Dw, 3) and Dz values
  T* ls = qd + 3 * D;
  T* invd = R == 1 ? ls + block_scratch<R>(k, KEEP_L) : nullptr;
  const T nugget = ps.get_nugget(), extra = T(ps.extra), jit = T(ps.jitter);

  // the query's constants per w dim, sexp m, 2 l^2 + 8 v and 2 l^2 (J's
  // denominators), matern m, v and l; then z scaled
  for (int t = lane; t < Dw; t += WARP) {
    const T m = zm[q * szm + t], v = zv[q * szv + t], l = len[t * slen];
    qd[3 * t] = m;
    qd[3 * t + 1] = KN == SEXP ? T(2) * (l * l) + T(8) * v : v;
    qd[3 * t + 2] = KN == SEXP ? T(2) * (l * l) : l;
  }
  for (int t = lane; t < Dz; t += WARP) qd[3 * Dw + t] = z[q * sz + t] / len[(Dw + t) * slen];

  T dg[R], b[R], lii[R];
  bool bad = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    dg[r] = T(0);
    b[r] = T(0);
    if (row >= k) continue;
    const long long j = nn[q * snn + row];
    bad |= j >= n;
    const bool valid = j >= 0 && j < n;
    for (int t = 0; t < Dw; ++t) {
      const T wv = valid ? w1[j * sw + t] : T(0);
      xw[row * Dw + t] = wv;
      xs[row * D + t] = wv / len[t * slen];
    }
    for (int t = 0; t < Dz; ++t)
      xs[row * D + Dw + t] = valid ? gw[j * sg + t] / len[(Dw + t) * slen] : T(0);
    ok[row] = valid ? T(1) : T(0);
    dg[r] = valid ? T(1) + (nugget * nd[j * snd] + extra) + jit : T(1);
    b[r] = valid ? y[j * sy] : T(0);
  }
  bad = __any_sync(FULL_MASK, bad);
  __syncwarp();
  warp_factor<T, KN, R, KEEP_L>(MaskedCoords<T>{xs, ok, D}, dg, ls, invd, b, lii, k, D, D,
                                lane);
  T a[R];
  warp_backward<T, R>(ls, invd, b, a, k, k, lane);

  // I, the rows' weights (Iz and matern's dims of zero variance) and mu
  T mu = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    if (row >= k) continue;
    T Iw, det = T(1);
    if (KN == SEXP) {
      T c = T(1), e = T(0);
      for (int t = 0; t < Dw; ++t) {
        const T v = zv[q * szv + t], l = len[t * slen], l2 = l * l;
        c *= T(1) / d_sqrt(T(1) + T(2) * v / l2);
        const T u = xw[row * Dw + t] - qd[3 * t];
        e += u * u / (T(2) * v + l2);
      }
      Iw = c * d_exp(-e);
    } else {
      Iw = T(1);
      for (int t = 0; t < Dw; ++t) {
        const T f = i_matern_1d(qd[3 * t] - xw[row * Dw + t], qd[3 * t + 1], qd[3 * t + 2]);
        Iw *= f;
        if (!(qd[3 * t + 1] > T(0))) det *= f;
      }
    }
    T Iz = T(1);
    if (Dz > 0) {
      if (KN == SEXP) {
        T s = T(0);
        for (int t = 0; t < Dz; ++t) {
          const T diff = xs[row * D + Dw + t] - qd[3 * Dw + t];
          s += diff * diff;
        }
        Iz = d_exp(-s);
      } else {
        T coef = T(1), sa = T(0);
        for (int t = 0; t < Dz; ++t) {
          const T aa = d_abs(xs[row * D + Dw + t] - qd[3 * Dw + t]);
          coef *= T(1) + SQRT5 * aa + (T(5) / T(3)) * aa * aa;
          sa += aa;
        }
        Iz = coef * d_exp(-SQRT5 * sa);
      }
    }
    const bool valid = ok[row] != T(0);
    mu += valid ? Iw * Iz * a[r] : T(0);
    av[row] = a[r];
    wr[row] = valid ? Iz * det : T(0);
  }
  __syncwarp();

  // K^-1 by columns, PRED_NR at a time, and the pairs of each column
  T tr = T(0), quad = T(0);
  for (int c0 = 0; c0 < k; c0 += PRED_NR) {
    T e[R][PRED_NR], f[R][PRED_NR], kinv[R][PRED_NR];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int cq = 0; cq < PRED_NR; ++cq) e[r][cq] = lane + r * WARP == c0 + cq ? T(1) : T(0);
    warp_forward<T, PRED_NR, R>(ls, invd, e, f, k, k, c0, lane);
    warp_backward<T, PRED_NR, R>(ls, invd, f, kinv, k, k, lane);
#pragma unroll
    for (int cq = 0; cq < PRED_NR; ++cq) {
      const int c = c0 + cq;
      if (c >= k) break;
      const T wc = wr[c], ac = av[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = lane + r * WARP;
        if (row >= k) continue;
        T J;
        if (KN == SEXP) {
          T ex = T(0);
          for (int t = 0; t < Dw; ++t) {
            const T m = qd[3 * t];
            const T ui = xw[row * Dw + t] - m, uc = xw[c * Dw + t] - m;
            const T p = ui + uc, dd = ui - uc;
            ex += p * p / qd[3 * t + 1] + dd * dd / qd[3 * t + 2];
          }
          J = d_exp(-ex);
        } else {
          J = T(1);
          for (int t = 0; t < Dw; ++t) {
            if (!(qd[3 * t + 1] > T(0))) continue;
            const MaternDim<T> md(qd[3 * t], qd[3 * t + 1], qd[3 * t + 2]);
            J *= jd_matern(xw[row * Dw + t], xw[c * Dw + t], md);
          }
        }
        J = J * (wr[row] * wc);
        tr += kinv[r][cq] * J;
        quad += a[r] * ac * J;
      }
    }
  }
  T sums[3] = {mu, tr, quad};
  warp_sum_each<T, 3>(sums);
  if (lane == 0) {
    T cj = T(1);
    if (KN == SEXP)
      for (int t = 0; t < Dw; ++t) {
        const T l = len[t * slen];
        cj *= T(1) / d_sqrt(T(1) + T(4) * zv[q * szv + t] / (l * l));
      }
    const T m = sums[0], trq = cj * sums[1], qf = cj * sums[2];
    const T var = d_abs(qf - m * m + ps.get_scale() * (T(1) + nugget - trq));
    out[q] = bad ? nan_value<T>() : m;
    out[M + q] = bad ? nan_value<T>() : var;
  }
}

template <int R, typename Kern>
static cudaError_t pred_plan(Kern kern, size_t value_bytes, int m1, int d, int* P,
                             size_t* bytes) {
  return plan_block((const void*)kern, value_bytes * pred_per_point<R>(m1, d), P, bytes);
}

template <typename T, int KN, int R>
static int kriging_launch_r(const void* const* p, const long long* s, PredScalars<T> ps,
                            void* out, int M, int k, int d, int n, cudaStream_t stream) {
  const auto kern = kriging_kernel<T, KN, R>;
  int P;
  size_t bytes;
  const cudaError_t err = pred_plan<R>(kern, sizeof(T), k + 1, d, &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  const auto c = [p](int i) { return static_cast<const T*>(p[i]); };
  kern<<<(M + P - 1) / P, P * WARP, bytes, stream>>>(
      c(0), s[0], c(1), s[1], static_cast<const long long*>(p[2]), s[2], c(3), s[3], c(4),
      s[4], c(5), (int)s[5], ps, static_cast<T*>(out), M, k, d, n);
  return (int)cudaGetLastError();
}

template <typename T, int KN, int R>
static int linked_launch_r(const void* const* p, const long long* s, PredScalars<T> ps,
                           void* out, int M, int k, int Dw, int Dz, int n,
                           cudaStream_t stream) {
  const auto kern = linked_vecch_kernel<T, KN, R>;
  int P;
  size_t bytes;
  const cudaError_t err = pred_plan<R>(kern, sizeof(T), k, Dw + Dz, &P, &bytes);
  if (err != cudaSuccess) return (int)err;
  const auto c = [p](int i) { return static_cast<const T*>(p[i]); };
  kern<<<(M + P - 1) / P, P * WARP, bytes, stream>>>(
      c(0), s[0], c(1), s[1], c(2), s[2], c(3), s[3], c(4), s[4],
      static_cast<const long long*>(p[5]), s[5], c(6), s[6], c(7), s[7], c(8), (int)s[8], ps,
      static_cast<T*>(out), M, k, Dw, Dz, n);
  return (int)cudaGetLastError();
}

template <typename T>
static PredScalars<T> pred_scalars(const void* scale_p, const void* nugget_p, double scale,
                                   double nugget, double extra, double jitter) {
  return {static_cast<const T*>(scale_p), static_cast<const T*>(nugget_p), scale, nugget,
          extra, jitter};
}

template <typename T, int KN>
static int pred_launch_kn(int linked, const void* const* p, const long long* s,
                          PredScalars<T> ps, void* out, int M, int k, int Dw, int Dz, int n,
                          cudaStream_t stream) {
  if (linked) {
    if (rows_per_lane(k) == 1)
      return linked_launch_r<T, KN, 1>(p, s, ps, out, M, k, Dw, Dz, n, stream);
    return linked_launch_r<T, KN, 2>(p, s, ps, out, M, k, Dw, Dz, n, stream);
  }
  if (rows_per_lane(k + 1) == 1)
    return kriging_launch_r<T, KN, 1>(p, s, ps, out, M, k, Dw, n, stream);
  return kriging_launch_r<T, KN, 2>(p, s, ps, out, M, k, Dw, n, stream);
}

template <typename T>
static int pred_launch(int kname, int linked, const void* const* p, const long long* s,
                       const void* scale_p, const void* nugget_p, double scale,
                       double nugget, double extra, double jitter, void* out, int M, int k,
                       int Dw, int Dz, int n, cudaStream_t stream) {
  const auto ps = pred_scalars<T>(scale_p, nugget_p, scale, nugget, extra, jitter);
  if (kname == SEXP)
    return pred_launch_kn<T, SEXP>(linked, p, s, ps, out, M, k, Dw, Dz, n, stream);
  return pred_launch_kn<T, MATERN25>(linked, p, s, ps, out, M, k, Dw, Dz, n, stream);
}

// The launch plan of the sexp variant at (m1, d) (see the extern "C" below).
template <typename T>
static int pred_plan_report(int linked, int m1, int d, int* out) {
  const size_t per = sizeof(T);
  if (rows_per_lane(m1) == 1)
    return (int)plan_report(linked ? (const void*)linked_vecch_kernel<T, SEXP, 1>
                                   : (const void*)kriging_kernel<T, SEXP, 1>,
                            per * pred_per_point<1>(m1, d), out);
  return (int)plan_report(linked ? (const void*)linked_vecch_kernel<T, SEXP, 2>
                                 : (const void*)kriging_kernel<T, SEXP, 2>,
                          per * pred_per_point<2>(m1, d), out);
}

}  // namespace dgp

// dtype: 0 float32, 1 float64.  kname: 0 sexp, 1 matern2.5.  linked: 0 the
// kriging variant, 1 the linked one.  p and s hold the operands' device
// pointers and their row strides (in values):
//   kriging  x (M, d), w_train (n, d), NN (M, k) int64, y (n,),
//            nugget_diag (n,), length (d,) or (1,) (stride 0);
//   linked   m (M, Dw), v (M, Dw), z (M, Dz) or null, w1 (n, Dw),
//            global_w1 (n, Dz) or null, NN (M, k) int64, y (n,),
//            nugget_diag (n,), length (Dw + Dz,) or (1,) (stride 0).
// scale_p and nugget_p point to the values on the device, or are null for
// the values given; extra is the callers' extra diagonal and jitter the
// float32 blocks' fixed one.  Kriging's d is Dw (Dz 0).  out (2, M): the
// means, then the variances.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int dgp_vecchia_pred(int dtype, int kname, int linked, const void* const* p,
                                const long long* s, const void* scale_p,
                                const void* nugget_p, double scale, double nugget,
                                double extra, double jitter, void* out, int M, int k, int Dw,
                                int Dz, int n, void* stream) {
  const int m1 = linked ? k : k + 1;
  if (m1 > dgp::M1_MAX || k < 0 || Dw < 1 || Dz < 0 || (!linked && Dz != 0) || n < 1 ||
      M < 1 || (kname != 0 && kname != 1))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dgp::pred_launch<double>(kname, linked, p, s, scale_p, nugget_p, scale, nugget,
                                    extra, jitter, out, M, k, Dw, Dz, n, st);
  if (dtype == 0)
    return dgp::pred_launch<float>(kname, linked, p, s, scale_p, nugget_p, scale, nugget,
                                   extra, jitter, out, M, k, Dw, Dz, n, st);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of the sexp variant (linked 0 or 1) at m1 block rows and
// d dims: out[0] queries (warps) per thread block, out[1] its shared bytes,
// out[2] blocks resident per SM.
extern "C" int dgp_vecchia_pred_plan(int dtype, int linked, int m1, int d, int* out) {
  if (m1 < 1 || m1 > dgp::M1_MAX || d < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return dgp::pred_plan_report<double>(linked, m1, d, out);
  if (dtype == 0) return dgp::pred_plan_report<float>(linked, m1, d, out);
  return (int)cudaErrorInvalidValue;
}
