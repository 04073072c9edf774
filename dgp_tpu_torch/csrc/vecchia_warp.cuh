// Warp-level device code of the Vecchia block kernels K1
// (block_nllik_grad.cu), K2 (block_loglik_multi.cu), K3 (cond_weights.cu),
// K4 (block_loglik_parts.cu) and K6 (vecchia_pred.cu, which gathers its
// own blocks, `MaskedCoords`): one warp factors one block of m1 <= M1_MAX
// = 64 rows.  Each lane owns R rows, R = rows_per_lane(m1): lane i
// owns row i (R = 1, m1 <= 32), or rows i and i + 32 (R = 2, 32 < m1 <= 64).
// Every kernel is instantiated for both and its launcher picks R from m1,
// so blocks of up to 32 rows run the one-row code alone.  What a lane
// computes for rows >= m1 is never read.
//
// Staging.  The JAX layout puts the point axis last, so the lanes of a warp
// that each read one row of the same point would read at stride n.  A thread
// block therefore serves P consecutive points (one warp each) and first copies
// their tiles into shared memory, consecutive threads reading consecutive
// points (`stage`); a point's tile keeps its (m1, d) layout there.  An
// output with one value per row (K3's weights) goes back the same way
// (`unstage`).
//
// One row per lane (R = 1).  `warp_build` writes the block into the warp's
// shared (m1, LDS) array, element (r, c) at c * LDS + r: the m1 (m1 - 1) / 2
// correlations below the diagonal are spread evenly over the 32 lanes (about
// m1^2 / 64 pairs each), the diagonals come from diag, and a copy of the
// correlations goes above the diagonal, which the factorisation leaves
// alone.  LDS = 33 keeps both a row and a column free of bank conflicts.
// `warp_cholesky` is a right-looking Cholesky by columns across the lanes:
// each lane's unfactored row lives in registers, an array of 32 values
// shifted one place per step so that entry t always holds column j + t (the
// loop over a row's entries is unrolled over 32 and cut at m1, so the array
// is never indexed at run time; the loop over the steps stays a loop).  At
// step j the pivot and L[i][j] travel by shuffle and a double-buffered
// column in shared memory (one __syncwarp a step), the owners of rows i > j
// subtract L[i][j] L[k][j] from their entries, and a forward substitution
// rides along: row j's owner finishes x_j and rows i > j fold in L[i][j]
// x_j.  Column j of L is written over the block as it is finished, so L
// ends in the shared array for the later substitutions.  K2 builds its
// blocks in two parts, the static dims' correlation factor once a point
// above the diagonal (`warp_build_static`) and each candidate's factor times
// it below (`warp_build_lower`), and factors them with `warp_cholesky_rhs`,
// which writes no L back and publishes each column shifted, so that the
// update reads it at fixed offsets and checks the block's end every
// UPDATE_GROUP entries.
//
// Two rows per lane (R = 2): a right-looking Cholesky over two panels of
// rows, 0 .. p1-1 and p1 .. m1-1 with p1 = m1 - 32, so that panel 2 is a
// full warp and panel 1 as short as the block allows (`panel_cholesky`).
// Two rows of 64 values would take 256 registers a lane in float64, so no
// lane holds more than 32 values of a row at a time:
//  1. Panel 1: A11 is built as above into a (p1, LDS) array and factored by
//     the one-row code, the forward substitution of the right-hand side
//     fused in; L11 stays there, its diagonal holding 1 / L[j][j].
//  2. Panel 2's A22 is built the same way into a (32, LDS) array and lane q
//     reads its row (row p1 + q of the block) into registers; lane q
//     computes its p1 correlations of A21 and reads them back as a second
//     register row.
//  3. The panel solve and the Schur update, in one loop over panel 1's p1
//     columns: at step j lane q finishes L21[q][j] (its A21 entry times 1 /
//     L11[j][j]), publishes it in a double-buffered column (one __syncwarp
//     a step), updates its later A21 entries from L11's column j (broadcast
//     reads) and its 32 A22 entries from the published column, and folds
//     L21[q][j] x_j into its right-hand side.  Every update is an
//     independent multiply-add in registers, the same count on every lane.
//  4. Panel 2: A22 - L21 L21^T, in registers already, is factored by the
//     one-row code again, continuing the substitution.
// Lane q works on row p1 + q in panel 2 while the callers keep rows lane
// and lane + 32, so the right-hand side and the diagonal go round the warp
// by one shuffle before and after.  A pivot that is not positive gives NaN
// in either panel, and NaN spreads to every later row, as a failed library
// factorisation does.  A warp keeps the two arrays and the column buffers;
// a caller that reads L after the factorisation (K1, K3) also keeps L21,
// and substitutes through the panels with `warp_backward`; K1, which also
// reads K's correlations, keeps a copy of A21 (`KEEP_LK`).
// Every kernel calls `warp_factor`, which picks the code for its R.
// PERF.md has the measurements of both instantiations against the
// alternatives.
#pragma once

#include "vecchia_common.cuh"

namespace dgp {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP = 32;
static_assert(M1_MAX <= 2 * WARP, "at most two rows per lane");
// block rows each lane owns
__host__ __device__ constexpr int rows_per_lane(int m1) { return m1 <= WARP ? 1 : 2; }
// stride of a warp's shared arrays: (m1, LDS) at R = 1, the panels' at R = 2
constexpr int LDS = WARP + 1;
// values of one (32, LDS) panel
constexpr int PANEL = WARP * LDS;
// most points (warps) a thread block serves
constexpr int WARPS_MAX = 8;
// dynamic shared memory a launch gets without opting in
constexpr size_t SMEM_DEFAULT = 48 * 1024;
// entries of a row `warp_cholesky_rhs` updates between two checks of the
// block's end (2 measured 7% slower at n = 1e5 in float64, PERF.md)
constexpr int UPDATE_GROUP = 4;

__device__ __forceinline__ double d_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float d_rsqrt(float x) { return rsqrtf(x); }

template <typename T>
__device__ __forceinline__ T nan_value();
template <>
__device__ __forceinline__ double nan_value<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
template <>
__device__ __forceinline__ float nan_value<float>() {
  return __int_as_float(0x7fc00000);
}

// Coordinates of one point's block from its staged (m1, d) tile.
template <typename T>
struct TileCoords {
  const T* x;
  int d;
  __device__ __forceinline__ T operator()(int i, int t) const { return x[i * d + t]; }
};

// The same from a tile staged transposed, (d, m1) (`stage_transposed`):
// lanes that read one dim of consecutive rows read consecutive addresses,
// free of bank conflicts whatever d is.
template <typename T>
struct TileCoordsT {
  const T* x;
  int m1;
  __device__ __forceinline__ T operator()(int i, int t) const { return x[t * m1 + i]; }
};

// The same from a tile with a flag per row, 1 for a neighbour and 0 for
// an invalid lane (K6 gathers its own neighbour sets): an invalid row is
// coupled to no other row, so its correlations are 0 (`coupled`) and a unit
// diagonal decouples it exactly, as the plain versions' masks do.
template <typename T>
struct MaskedCoords {
  const T* x;
  const T* ok;
  int d;
  __device__ __forceinline__ T operator()(int i, int t) const { return x[i * d + t]; }
};

// Whether block rows i and k are coupled: always, but for a MaskedCoords
// tile (and RowShift of one, below).  A constant for the other tiles, so
// their kernels compile as they would without it.
template <typename Coords>
__device__ __forceinline__ bool coupled(const Coords&, int, int) {
  return true;
}

template <typename T>
__device__ __forceinline__ bool coupled(const MaskedCoords<T>& x, int i, int k) {
  return x.ok[i] != T(0) && x.ok[k] != T(0);
}

// What a caller reads of the factorisation besides lii and b: nothing (K2,
// K4), L (K3), or L and K's correlations (K1).
constexpr int KEEP_NONE = 0, KEEP_L = 1, KEEP_LK = 2;

// Shared values of a warp's block.  R = 1: the (m1, LDS) array and two
// 32-value column buffers after it (L and K's correlations stay there).
// R = 2: panel 2's (32, LDS) array, panel 1's (m1 - 32, LDS), the two column
// buffers and, from KEEP_L on, L21's (m1 - 32, LDS) and at KEEP_LK a copy
// of A21 in the same layout.
template <int R>
__host__ __device__ inline int block_scratch(int m1, int keep) {
  return R == 1 ? m1 * LDS + 2 * WARP : PANEL + (1 + keep) * (m1 - WARP) * LDS + 2 * WARP;
}

// v[s] for the lane's slot s (its row lane + 32 s) without indexing the
// registers at run time.
template <typename T, int R>
__device__ __forceinline__ T pick(const T (&v)[R], int s) {
  T out = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q)
    if (q == s) out = v[q];
  return out;
}

// Copies the (nrows, d) tiles of points p0 .. p0+P-1 of a (nrows, d, n) array
// into dst laid out (P, nrows, d), with P = blockDim.x / WARP; points past n
// read as 0.  Thread `tid` copies point tid % P, so consecutive threads read
// consecutive points.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, T* dst, int nrows, int d,
                                      int n, int p0, int P) {
  const int w = threadIdx.x % P;
  const int p = p0 + w;
  const int total = nrows * d;
  for (int rt = threadIdx.x / P; rt < total; rt += WARP)
    dst[w * total + rt] = p < n ? src[(long long)rt * n + p] : T(0);
}

// `stage` with each point's tile transposed: dst laid out (P, d, nrows).
template <typename T>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src, T* dst, int nrows,
                                                 int d, int n, int p0, int P) {
  const int w = threadIdx.x % P;
  const int p = p0 + w;
  const int total = nrows * d;
  for (int rt = threadIdx.x / P; rt < total; rt += WARP) {
    const int r = rt / d;
    dst[w * total + (rt - r * d) * nrows + r] = p < n ? src[(long long)rt * n + p] : T(0);
  }
}

// `stage_transposed` of the `lead` leading dims alone: dst laid out (P,
// lead, nrows), from a (nrows, d, n) array.
template <typename T>
__device__ __forceinline__ void stage_lead_transposed(const T* __restrict__ src, T* dst,
                                                      int nrows, int d, int lead, int n,
                                                      int p0, int P) {
  const int w = threadIdx.x % P;
  const int p = p0 + w;
  const int total = nrows * lead;
  for (int tr = threadIdx.x / P; tr < total; tr += WARP) {
    const int t = tr / nrows;
    const int r = tr - t * nrows;
    dst[w * total + tr] = p < n ? src[((long long)r * d + t) * n + p] : T(0);
  }
}

// The reverse of `stage` for one value per row: copies src laid out
// (P, nrows) to rows 0 .. nrows-1 of points p0 .. p0+P-1 of a (nrows, n)
// array, consecutive threads writing consecutive points; points past n are
// not written.
template <typename T>
__device__ __forceinline__ void unstage(const T* src, T* __restrict__ dst, int nrows, int n,
                                        int p0, int P) {
  const int w = threadIdx.x % P;
  const int p = p0 + w;
  if (p >= n) return;
  for (int r = threadIdx.x / P; r < nrows; r += WARP)
    dst[(long long)r * n + p] = src[w * nrows + r];
}

// Correlation of block rows i and k: the product of two factors, over dims
// [0, split) and [split, d) (one factor if split == d), each of which
// underflows to 0 on its own at a sentinel distance, as in the plain
// versions.
template <typename T, int KN, typename Coords>
__device__ __forceinline__ T pair_corr(const Coords& x, int i, int k, int d, int split) {
  T v = corr<T, KN>(x, i, k, 0, split);
  if (split < d) v *= corr<T, KN>(x, i, k, split, d);
  return coupled(x, i, k) ? v : T(0);
}

// Writes the warp's block of m1 <= 32 rows (R = 1) into its shared (m1,
// LDS) array `ls`: corr(i, k) of rows i > k at (i, k) and at (k, i), pair
// p = i (i - 1) / 2 + k on lane p % 32, and the lane's diagonal dg at its
// row's (i, i).  The correlation is pair_corr's, written out.  Ends with
// __syncwarp.
template <typename T, int KN, int R, typename Coords>
__device__ __forceinline__ void warp_build(const Coords& x, const T (&dg)[R], T* ls, int m1,
                                           int d, int split, int lane) {
  constexpr int S = LDS;
  const int npairs = m1 * (m1 - 1) / 2;
  int i = 1, k = lane;                 // pair p = lane, then p + 32, ...
  for (int p = lane; p < npairs; p += WARP) {
    while (k >= i) {
      k -= i;
      ++i;
    }
    T v = corr<T, KN>(x, i, k, 0, split);
    if (split < d) v *= corr<T, KN>(x, i, k, split, d);
    if (!coupled(x, i, k)) v = T(0);
    ls[k * S + i] = v;
    ls[i * S + k] = v;
    k += WARP;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + r * WARP;
    if (row < m1) ls[row * S + row] = dg[r];
  }
  __syncwarp();
}

// warp_build in two parts, for a block whose dims [split, d) are the same
// for many blocks (K2's static dims).  `warp_build_static` writes their
// correlation factor above the diagonal of `ls`, at (k, i) for rows i > k,
// with warp_build's spread of the pairs over the lanes; it is not synced,
// since each lane reads back only its own pairs.
template <typename T, int KN, typename Coords>
__device__ __forceinline__ void warp_build_static(const Coords& x, T* ls, int m1, int split,
                                                  int d, int lane) {
  constexpr int S = LDS;
  const int npairs = m1 * (m1 - 1) / 2;
  int i = 1, k = lane;
  for (int p = lane; p < npairs; p += WARP) {
    while (k >= i) {
      k -= i;
      ++i;
    }
    ls[i * S + k] = corr<T, KN>(x, i, k, split, d);
    k += WARP;
  }
}

// `warp_build_lower` then writes one block below the diagonal, corr(i, k)
// over dims [0, split) of x times, where `kept`, warp_build_static's factor
// (pair_corr's order of operations), and the lane's diagonal dg; the upper
// triangle is left as it is.  Ends with __syncwarp.
template <typename T, int KN, typename Coords>
__device__ __forceinline__ void warp_build_lower(const Coords& x, T dg, T* ls, int m1,
                                                 int split, bool kept, int lane) {
  constexpr int S = LDS;
  const int npairs = m1 * (m1 - 1) / 2;
  int i = 1, k = lane;
  for (int p = lane; p < npairs; p += WARP) {
    while (k >= i) {
      k -= i;
      ++i;
    }
    const T g = kept ? ls[i * S + k] : T(0);   // loaded ahead of the exponential
    T v = corr<T, KN>(x, i, k, 0, split);
    if (kept) v *= g;
    ls[k * S + i] = v;
    k += WARP;
  }
  if (lane < m1) ls[lane * S + lane] = dg;
  __syncwarp();
}

// Cholesky of the warp's block of m1 <= 32 rows in its shared (m1, LDS)
// array `ls` (entries below the diagonal and the diagonal are read; entries
// above it are neither used nor changed), with the forward substitution of
// one right-hand side: the lane's b[0] becomes (L^-1 b) at its row.  L is
// written over the block's lower triangle and diagonal, and lii[0]
// receives L[lane][lane].  A pivot that is not positive gives NaN, which
// spreads to every later row, as a failed library factorisation does.
// `invd`, if not null, receives 1 / L[j][j].  Ends with __syncwarp.
template <typename T>
__device__ __forceinline__ void warp_cholesky(T* ls, T* invd, T (&b)[1], T (&lii)[1], int m1,
                                              int lane) {
  constexpr int S = LDS;
  T* col = ls + m1 * S;                // two 32-value column buffers
  lii[0] = T(0);
  T a[WARP];                           // a[t]: column j + t of lane's row
#pragma unroll
  for (int t = 0; t < WARP; ++t) a[t] = t < m1 ? ls[t * S + lane] : T(0);
  for (int j = 0; j < m1; ++j) {
    const T aj = a[0];
    const T djj = __shfl_sync(FULL_MASK, aj, j);
    const T inv = djj > T(0) ? d_rsqrt(djj) : nan_value<T>();
    const T piv = djj * inv;
    const T xj = __shfl_sync(FULL_MASK, b[0], j) * inv;
    const T lij = lane == j ? piv : aj * inv;
    if (lane >= j) ls[j * S + lane] = lij;
    if (lane == j) {
      lii[0] = piv;
      b[0] = xj;
    } else if (lane > j) {
      b[0] -= lij * xj;
    }
    if (invd != nullptr && lane == 0) invd[j] = inv;
    T* c = col + (j & 1) * WARP;       // double-buffered: one __syncwarp a step
    c[lane] = lij;
    __syncwarp();
#pragma unroll
    for (int t = 1; t < WARP; ++t) {
      if (j + t >= m1) break;
      a[t - 1] = a[t] - lij * c[j + t];
    }
  }
  __syncwarp();
}

// warp_cholesky for a caller that reads only lii and b (K2), the lane's row
// already in registers (a[t] = column t of row lane): L is not written
// back, and column j goes round the warp shifted, L[i][j] of row i > j at
// entry i - j - 1 of the double buffer col, so that the update reads entry
// t - 1 of it at a fixed offset and checks the block's end only every
// UPDATE_GROUP entries (the entries it computes past the end hold columns
// >= m1, never read, from buffer entries < 32).  Each value goes through
// warp_cholesky's operations in warp_cholesky's order.
template <typename T>
__device__ __forceinline__ void warp_cholesky_rhs(T (&a)[WARP], T* col, T& b, T& lii, int m1,
                                                  int lane) {
  lii = T(0);
  for (int j = 0; j < m1; ++j) {
    const T aj = a[0];
    const T djj = __shfl_sync(FULL_MASK, aj, j);
    const T inv = djj > T(0) ? d_rsqrt(djj) : nan_value<T>();
    const T piv = djj * inv;
    const T xj = __shfl_sync(FULL_MASK, b, j) * inv;
    const T lij = lane == j ? piv : aj * inv;
    if (lane == j) {
      lii = piv;
      b = xj;
    } else if (lane > j) {
      b -= lij * xj;
    }
    T* c = col + (j & 1) * WARP;       // double-buffered: one __syncwarp a step
    if (lane > j && lane < m1) c[lane - j - 1] = lij;
    __syncwarp();
#pragma unroll
    for (int t = 1; t < WARP; t += UPDATE_GROUP) {
      if (j + t >= m1) break;
#pragma unroll
      for (int u = t; u < t + UPDATE_GROUP && u < WARP; ++u) a[u - 1] = a[u] - lij * c[u - 1];
    }
  }
}

// One panel of `rows` <= 32 rows at R = 2, lane i's row in registers (a[t]
// = column t of the panel, shifted one place a step as in warp_cholesky),
// with the forward substitution of b.  Column j of L goes to lp[j * LDS +
// i] if lp is not null, its diagonal as 1 / L[j][j]; lii receives
// L[i][i], invd (if not null) 1 / L[j][j].  Ends with __syncwarp.
template <typename T>
__device__ __forceinline__ void panel_factor(T (&a)[WARP], T* lp, T* col, T* invd, T& b,
                                             T& lii, int rows, int lane) {
  lii = T(0);
  for (int j = 0; j < rows; ++j) {
    const T aj = a[0];
    const T djj = __shfl_sync(FULL_MASK, aj, j);
    const T inv = djj > T(0) ? d_rsqrt(djj) : nan_value<T>();
    const T xj = __shfl_sync(FULL_MASK, b, j) * inv;
    const T lij = aj * inv;
    if (lp != nullptr && lane >= j) lp[j * LDS + lane] = lane == j ? inv : lij;
    if (lane == j) {
      lii = djj * inv;
      b = xj;
    } else if (lane > j) {
      b -= lij * xj;
    }
    if (invd != nullptr && lane == 0) invd[j] = inv;
    T* c = col + (j & 1) * WARP;
    c[lane] = lij;
    __syncwarp();
#pragma unroll
    for (int t = 1; t < WARP; ++t) {
      if (j + t >= rows) break;
      a[t - 1] = a[t] - lij * c[j + t];
    }
  }
  __syncwarp();
}

// Coordinates of block rows off, off + 1, ... as rows 0, 1, ...
template <typename Coords>
struct RowShift {
  Coords x;
  int off;
  __device__ __forceinline__ auto operator()(int i, int t) const { return x(i + off, t); }
};

template <typename Coords>
__device__ __forceinline__ bool coupled(const RowShift<Coords>& x, int i, int k) {
  return coupled(x.x, i + x.off, k + x.off);
}

// Builds and factors the warp's block of 32 < m1 <= 64 rows (R = 2) in two
// panels, rows 0 .. p1-1 and p1 .. m1-1 with p1 = m1 - 32 (see the top of
// this file), with the forward substitution of one right-hand side: the
// lane's b[s] becomes (L^-1 b) at its row lane + 32 s and lii[s] receives
// L[i][i] there.  dg[s] is the diagonal of the lane's row lane + 32 s; the
// correlations are pair_corr's over (d, split).  Lane q factors panel 2's
// row p1 + q, so b and the diagonal go round the warp by one shuffle
// before and after.  ls holds block_scratch<2>(m1, KEEP) values: a (32,
// LDS) array, L11's (p1, LDS) array, the column buffers and, from KEEP_L
// on, L21's (p1, LDS) array and at KEEP_LK A21's; all column-major,
// element (r, c) of a panel at c * LDS + r.  The first array holds A22 and,
// from KEEP_L on, ends as L22.  L11's and L22's diagonals hold 1 /
// L[j][j], their upper triangles the block's correlations (`panel_l`,
// `panel_k`).  Ends with __syncwarp; the column buffers (`panel_spare`)
// are then free.
template <typename T, int KN, int KEEP, typename Coords>
__device__ __forceinline__ void panel_cholesky(const Coords& x, const T (&dg)[2], T* ls,
                                               T (&b)[2], T (&lii)[2], int m1, int d,
                                               int split, int lane) {
  const int p1 = m1 - WARP;            // rows of panel 1
  T* a22 = ls;
  T* l11 = a22 + PANEL;
  T* col = l11 + p1 * LDS;
  T* a21 = KEEP != KEEP_NONE ? col + 2 * WARP : a22;
  T* k21 = a21 + p1 * LDS;             // KEEP_LK
  // panel 2's lane q takes row p1 + q: lane i holds it in slot 0 if i >= p1
  // (row i), in slot 1 if not (row i + 32)
  const int src = (p1 + lane) % WARP;
  const T dg2 = __shfl_sync(FULL_MASK, lane >= p1 ? dg[0] : dg[1], src);
  T b2 = __shfl_sync(FULL_MASK, lane >= p1 ? b[0] : b[1], src);
  // panel 1: A11 spread over the lanes, factored with the lane's row in a
  const T dg1[1] = {dg[0]}, dg2a[1] = {dg2};
  warp_build<T, KN, 1>(x, dg1, l11, p1, d, split, lane);
  T a[WARP];
#pragma unroll
  for (int t = 0; t < WARP; ++t) a[t] = t < p1 && lane < p1 ? l11[t * LDS + lane] : T(0);
  T b1 = b[0], lii1;
  panel_factor(a, l11, col, static_cast<T*>(nullptr), b1, lii1, p1, lane);
  // A22 spread over the lanes, lane q's row of it in s
  warp_build<T, KN, 1>(RowShift<Coords>{x, p1}, dg2a, a22, WARP, d, split, lane);
  T s[WARP];
#pragma unroll
  for (int t = 0; t < WARP; ++t) s[t] = a22[t * LDS + lane];
  // lane q's row of A21 (p1 values), through shared memory into a
  if (KEEP == KEEP_NONE) __syncwarp(); // every lane has read A22
  for (int t = 0; t < p1; ++t) {
    const T v = pair_corr<T, KN>(x, p1 + lane, t, d, split);
    a21[t * LDS + lane] = v;
    if (KEEP == KEEP_LK) k21[t * LDS + lane] = v;
  }
#pragma unroll
  for (int t = 0; t < WARP; ++t) a[t] = t < p1 ? a21[t * LDS + lane] : T(0);
  // the panel solve L21 = A21 L11^-T and the Schur update of A22, by columns
  for (int j = 0; j < p1; ++j) {
    const T l = a[0] * l11[j * (LDS + 1)];        // L21[q][j]; 1 / L11[j][j]
    b2 -= l * __shfl_sync(FULL_MASK, b1, j);
    if (KEEP != KEEP_NONE) a21[j * LDS + lane] = l;
    T* c = col + (j & 1) * WARP;
    c[lane] = l;
    __syncwarp();
#pragma unroll
    for (int t = 1; t < WARP; ++t) {
      if (j + t >= p1) break;
      a[t - 1] = a[t] - l * l11[j * LDS + j + t];  // L11[j + t][j]
    }
#pragma unroll
    for (int t = 0; t < WARP; ++t) s[t] -= l * c[t];   // L21[t][j]
  }
  // panel 2; its first step writes column buffer 0, which the loop's last
  // step read if p1 is odd
  __syncwarp();
  T lii2;
  panel_factor(s, KEEP != KEEP_NONE ? a22 : static_cast<T*>(nullptr), col,
               static_cast<T*>(nullptr), b2, lii2, WARP, lane);
  // back to the lanes' slots: row i (i >= p1) and row i + 32 (i < p1) are
  // panel 2's rows i - p1 and i + 32 - p1
  const int back = (lane + WARP - p1) % WARP;
  const T bb = __shfl_sync(FULL_MASK, b2, back);
  const T lb = __shfl_sync(FULL_MASK, lii2, back);
  b[0] = lane < p1 ? b1 : bb;
  lii[0] = lane < p1 ? lii1 : lb;
  b[1] = lane < p1 ? bb : T(0);
  lii[1] = lane < p1 ? lb : T(0);
}

// L[r][c] (c < r < m1) as panel_cholesky<KEEP_L or KEEP_LK> leaves it in ls,
// p1 = m1 - 32; at c == r, 1 / L[r][r].
template <typename T>
__device__ __forceinline__ T panel_l(const T* ls, int p1, int r, int c) {
  const T* l11 = ls + PANEL;
  const T* l21 = l11 + p1 * LDS + 2 * WARP;
  if (r < p1) return l11[c * LDS + r];
  if (c < p1) return l21[c * LDS + r - p1];
  return ls[(c - p1) * LDS + r - p1];
}

// The block's correlation K[r][c] (r != c) from the copies
// panel_cholesky<KEEP_LK> leaves: the upper triangles of L11's and L22's
// arrays, and A21's (one shared load at a computed offset).
template <typename T>
__device__ __forceinline__ T panel_k(const T* ls, int p1, int r, int c) {
  const int hi = r > c ? r : c, lo = r > c ? c : r;
  const int at = hi < p1    ? PANEL + hi * LDS + lo
                 : lo >= p1 ? (hi - p1) * LDS + lo - p1
                            : PANEL + 2 * p1 * LDS + 2 * WARP + lo * LDS + hi - p1;
  return ls[at];
}

// The column buffers of panel_cholesky's scratch, free after it: 2 * WARP
// values.
template <typename T>
__device__ __forceinline__ T* panel_spare(T* ls, int m1) {
  return ls + PANEL + (m1 - WARP) * LDS;
}

// Builds and factors the warp's block in its block_scratch<R>(m1, KEEP)
// values at ls, with the forward substitution of b: R = 1 warp_build and
// warp_cholesky (invd as there), R = 2 panel_cholesky (invd is not
// written; the panels' diagonals hold 1 / L[j][j]).  Ends with __syncwarp.
template <typename T, int KN, int R, int KEEP, typename Coords>
__device__ __forceinline__ void warp_factor(const Coords& x, const T (&dg)[R], T* ls, T* invd,
                                            T (&b)[R], T (&lii)[R], int m1, int d, int split,
                                            int lane) {
  if constexpr (R == 1) {
    warp_build<T, KN, R>(x, dg, ls, m1, d, split, lane);
    warp_cholesky<T>(ls, invd, b, lii, m1, lane);
  } else {
    panel_cholesky<T, KN, KEEP>(x, dg, ls, b, lii, m1, d, split, lane);
  }
}

// Backward substitution L_m^T z = r for NR right-hand sides at once, with
// L_m the leading (m, m) block of L in the warp's shared scratch, read
// transposed (row i reads L[k][i]): R = 1 the (m1, LDS) array with 1 /
// L[j][j] in invd, R = 2 the panels kept by panel_cholesky, with 1 /
// L[j][j] on their diagonals (invd is not read).  The lane brings r_i of
// its rows i = lane + 32 s < m in acc[s][q] and receives z_i in z[s][q];
// the right-hand sides share one chain of m steps and its reads of L.
template <typename T, int NR, int R>
__device__ __forceinline__ void warp_backward(const T* ls, const T* invd, T (&acc)[R][NR],
                                              T (&z)[R][NR], int m, int m1, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < NR; ++q) z[r][q] = T(0);
  if constexpr (R == 1) {
    constexpr int S = LDS;
    for (int k = m - 1; k >= 0; --k) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const T zk = __shfl_sync(FULL_MASK, k < WARP ? acc[0][q] : acc[R - 1][q], k) * invd[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = lane + r * WARP;
          if (row == k)
            z[r][q] = zk;
          else if (row < k)
            acc[r][q] -= ls[row * S + k] * zk;
        }
      }
    }
  } else {
    const int p1 = m1 - WARP;
    for (int k = m - 1; k >= 0; --k) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const T zk = __shfl_sync(FULL_MASK, k < WARP ? acc[0][q] : acc[1][q], k) *
                     panel_l(ls, p1, k, k);
        if (lane == k)
          z[0][q] = zk;
        else if (lane < k)
          acc[0][q] -= panel_l(ls, p1, k, lane) * zk;
        if (WARP + lane == k)
          z[1][q] = zk;
        else if (WARP + lane < k)
          acc[1][q] -= panel_l(ls, p1, k, WARP + lane) * zk;
      }
    }
  }
}

// Forward substitution L_m z = r for NR right-hand sides at once, L_m and
// the lane's rows as in warp_backward (R = 1 reads L[i][k] at (i, k) of the
// (m1, LDS) array and 1 / L[k][k] in invd; R = 2 the panels).  r is 0 in
// rows below ``start``, and so is z.  Rows >= m are left as they are.
template <typename T, int NR, int R>
__device__ __forceinline__ void warp_forward(const T* ls, const T* invd, T (&acc)[R][NR],
                                             T (&z)[R][NR], int m, int m1, int start,
                                             int lane) {
  const int p1 = m1 - WARP;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < NR; ++q) z[r][q] = T(0);
  for (int k = start; k < m; ++k) {
    const T dk = R == 1 ? invd[k] : panel_l(ls, p1, k, k);
    T lk[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      lk[r] = row > k && row < m ? (R == 1 ? ls[k * LDS + row] : panel_l(ls, p1, row, k))
                                 : T(0);
    }
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const T zk = __shfl_sync(FULL_MASK, k < WARP ? acc[0][q] : acc[R - 1][q], k) * dk;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = lane + r * WARP;
        if (row == k)
          z[r][q] = zk;
        else
          acc[r][q] -= lk[r] * zk;
      }
    }
  }
}

// warp_backward for one right-hand side, acc[s] and z[s].
template <typename T, int R>
__device__ __forceinline__ void warp_backward(const T* ls, const T* invd, T (&acc)[R],
                                              T (&z)[R], int m, int m1, int lane) {
  warp_backward<T, 1, R>(ls, invd, reinterpret_cast<T(&)[R][1]>(acc),
                         reinterpret_cast<T(&)[R][1]>(z), m, m1, lane);
}

// Sums each of V values over the warp: V xor butterflies run step by step
// together (5 V shuffles, V independent at each step), and every lane ends
// with every sum.  A transposing butterfly (V - 1 shuffles, a lane keeping
// half of its values a step) selects among v by lane, which left v in a
// stack frame, and timed 2-16% slower in K1 (PERF.md).
template <typename T, int V>
__device__ __forceinline__ void warp_sum_each(T (&v)[V]) {
#pragma unroll
  for (int w = WARP / 2; w >= 1; w /= 2)
#pragma unroll
    for (int s = 0; s < V; ++s) v[s] += __shfl_xor_sync(FULL_MASK, v[s], w);
}

// Points (warps) per thread block and its dynamic shared bytes, for a kernel
// that needs `per_point` bytes for each: WARPS_MAX points, halved while the
// block would need more than SMEM_DEFAULT; a block that still needs more (a
// large d) opts in, which the launch refuses beyond the SM's 227 KB.
inline cudaError_t plan_block(const void* kernel, size_t per_point, int* warps, size_t* bytes) {
  int w = WARPS_MAX;
  while (w > 1 && w * per_point > SMEM_DEFAULT) w /= 2;
  *warps = w;
  *bytes = w * per_point;
  if (*bytes > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    // a refused opt-in is reported here; it must not stay behind as the
    // error that the next launch's check reads
    if (err != cudaSuccess) cudaGetLastError();
    return err;
  }
  return cudaSuccess;
}

// What plan_block chose, and the thread blocks of that size one SM holds
// (registers, shared memory and warps together): out[0] warps per block,
// out[1] shared bytes per block, out[2] blocks per SM.
inline cudaError_t plan_report(const void* kernel, size_t per_point, int* out) {
  int w;
  size_t bytes;
  cudaError_t err = plan_block(kernel, per_point, &w, &bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, w * WARP, bytes);
  out[0] = w;
  out[1] = (int)bytes;
  out[2] = blocks;
  return err;
}

}  // namespace dgp
