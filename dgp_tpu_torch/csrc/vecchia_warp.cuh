// Warp-level device code of the Vecchia block kernels K1
// (block_nllik_grad.cu), K2 (block_loglik_multi.cu), K3 (cond_weights.cu)
// and K4 (block_loglik_parts.cu): one warp factors one block of m1 <=
// M1_MAX = 64 rows.  Each lane owns R rows, R = rows_per_lane(m1): lane i
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
// The block.  `warp_build` writes it into the warp's shared (m1, LDS<R>)
// array, element (r, c) at c * LDS<R> + r: the m1 (m1 - 1) / 2 correlations
// below the diagonal are spread evenly over the 32 lanes (about m1^2 / 64
// pairs each), the diagonals come from diag, and a copy of the correlations
// goes above the diagonal, which the factorisation leaves alone.  LDS<R> =
// 32 R + 1 keeps both a row (the lanes read (r, c) for r = lane + 32 s) and
// a column (the lanes read (r, c) for c = lane + 32 s) free of bank
// conflicts.
//
// The factor.  Right-looking Cholesky by columns across the lanes
// (`warp_cholesky`): at step j the pivot is broadcast, the owners of rows
// i > j scale their entry to L[i][j] and publish it, and every row i > j
// subtracts L[i][j] L[k][j] from its entries j < k <= i.  A forward
// substitution rides along: row j's owner finishes x_j and rows i > j fold
// in L[i][j] x_j.  Column j of L is written over column j of the block as
// it is finished, so L ends in the shared array for the later
// substitutions.
//  * R = 1: each lane's unfactored row lives in registers, an array of 32
//    values shifted one place per step so that entry t always holds column
//    j + t; the loop over a row's entries is unrolled over 32 and cut at
//    m1, so the array is never indexed at run time, and the loop over the
//    steps stays a loop (small code).  The pivot and L[k][j] travel by
//    shuffle and a double-buffered column in shared memory.
//  * R = 2: two rows of 64 values in registers would take 256 registers in
//    float64 and spill, so the unfactored rows stay in the shared array
//    and are updated there in place; L[k][j] is read from the published
//    column, the pivot from the diagonal.  Two __syncwarp a step order the
//    publish before the update and the update before the next pivot.
// PERF.md has the measurements of both against the alternatives.
#pragma once

#include "vecchia_common.cuh"

namespace dgp {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP = 32;
static_assert(M1_MAX <= 2 * WARP, "at most two rows per lane");
// block rows each lane owns
__host__ __device__ constexpr int rows_per_lane(int m1) { return m1 <= WARP ? 1 : 2; }
// stride of a warp's shared (m1, LDS) array at R rows per lane
template <int R>
constexpr int LDS = R * WARP + 1;
// most points (warps) a thread block serves
constexpr int WARPS_MAX = 8;
// dynamic shared memory a launch gets without opting in
constexpr size_t SMEM_DEFAULT = 48 * 1024;

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

// Shared values of a warp's block: the (m1, LDS<R>) array and, at R = 1,
// two 32-value column buffers after it.
template <int R>
__host__ __device__ inline int block_scratch(int m1) {
  return m1 * LDS<R> + (R == 1 ? 2 * WARP : 0);
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

// Writes the warp's block into its shared (m1, LDS<R>) array `ls`:
// corr(i, k) of rows i > k at (i, k) and at (k, i), pair p = i (i - 1) / 2
// + k on lane p % 32, and the lane's diagonals dg at (i, i) of its rows.
// The correlation is the product of two factors, over dims [0, split) and
// [split, d) (one factor if split == d), each of which underflows to 0 on
// its own at a sentinel distance, as in the plain versions.  Ends with
// __syncwarp.
template <typename T, int KN, int R, typename Coords>
__device__ __forceinline__ void warp_build(const Coords& x, const T (&dg)[R], T* ls, int m1,
                                           int d, int split, int lane) {
  constexpr int S = LDS<R>;
  const int npairs = m1 * (m1 - 1) / 2;
  int i = 1, k = lane;                 // pair p = lane, then p + 32, ...
  for (int p = lane; p < npairs; p += WARP) {
    while (k >= i) {
      k -= i;
      ++i;
    }
    T v = corr<T, KN>(x, i, k, 0, split);
    if (split < d) v *= corr<T, KN>(x, i, k, split, d);
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

// Cholesky of the warp's block in its shared (m1, LDS<R>) array `ls`
// (entries below the diagonal and the diagonal are read; entries above it
// are neither used nor changed), with the forward substitution of one
// right-hand side: the lane's b[s] becomes (L^-1 b) at its row lane + 32 s.
// L is written over the block's lower triangle (its diagonal, which no
// caller reads from `ls`, only at R = 1), and lii[s] receives L[i][i] of
// the lane's rows.  A pivot that is not positive gives NaN, which spreads
// to every later row, as a failed library factorisation does.  `invd`, if
// not null, receives 1 / L[j][j].  Ends with __syncwarp.
template <typename T, int R>
__device__ __forceinline__ void warp_cholesky(T* ls, T* invd, T (&b)[R], T (&lii)[R], int m1,
                                              int lane) {
  constexpr int S = LDS<R>;
  if constexpr (R == 1) {
    T* col = ls + m1 * S;              // two 32-value column buffers
    lii[0] = T(0);
    T a[WARP];                         // a[t]: column j + t of lane's row
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
      T* c = col + (j & 1) * WARP;     // double-buffered: one __syncwarp a step
      c[lane] = lij;
      __syncwarp();
#pragma unroll
      for (int t = 1; t < WARP; ++t) {
        if (j + t >= m1) break;
        a[t - 1] = a[t] - lij * c[j + t];
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) lii[r] = T(0);
    for (int j = 0; j < m1; ++j) {
      const T djj = ls[j * S + j];
      const T inv = djj > T(0) ? d_rsqrt(djj) : nan_value<T>();
      const T piv = djj * inv;
      // lane j % 32 holds row j in its slot j / 32 (the shuffle reads the
      // source lane modulo 32)
      const T xj = __shfl_sync(FULL_MASK, j < WARP ? b[0] : b[R - 1], j) * inv;
      T lij[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = lane + r * WARP;
        lij[r] = row > j && row < m1 ? ls[j * S + row] * inv : T(0);
        if (row > j && row < m1) ls[j * S + row] = lij[r];
        if (row == j) {
          lii[r] = piv;
          b[r] = xj;
        } else if (row > j) {
          b[r] -= lij[r] * xj;
        }
      }
      if (invd != nullptr && lane == 0) invd[j] = inv;
      __syncwarp();                    // column j of L is published
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = lane + r * WARP;
        if (row > j && row < m1)
          for (int k = j + 1; k <= row; ++k) ls[k * S + row] -= lij[r] * ls[j * S + k];
      }
      __syncwarp();                    // the next pivot is updated
    }
  }
}

// Forward substitution L x = b for up to NR right-hand sides at once (the
// first nr), the lane holding entry i of each in b[s] for its rows i = lane
// + 32 s; L is in the warp's shared (m1, LDS<R>) array, 1 / L[j][j] in
// invd.
template <typename T, int NR, int R>
__device__ __forceinline__ void warp_forward(const T* ls, const T* invd, T (&b)[R][NR], int nr,
                                             int m1, int lane) {
  constexpr int S = LDS<R>;
  for (int j = 0; j < m1; ++j) {
    const T inv = invd[j];
    T lij[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lij[r] = ls[j * S + lane + r * WARP];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (q >= nr) break;
      const T xj = __shfl_sync(FULL_MASK, j < WARP ? b[0][q] : b[R - 1][q], j) * inv;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = lane + r * WARP;
        if (row == j)
          b[r][q] = xj;
        else if (row > j)
          b[r][q] -= lij[r] * xj;
      }
    }
  }
}

// Backward substitution L_m^T z = r with L_m the leading (m, m) block of the
// warp's shared (m1, LDS<R>) array, read transposed (row i reads L[k][i]),
// and 1 / L[j][j] in invd: the lane brings r_i of its rows i = lane + 32 s
// < m in acc[s] and receives z_i in z[s].
template <typename T, int R>
__device__ __forceinline__ void warp_backward(const T* ls, const T* invd, T (&acc)[R],
                                              T (&z)[R], int m, int lane) {
  constexpr int S = LDS<R>;
#pragma unroll
  for (int r = 0; r < R; ++r) z[r] = T(0);
  for (int k = m - 1; k >= 0; --k) {
    const T zk = __shfl_sync(FULL_MASK, k < WARP ? acc[0] : acc[R - 1], k) * invd[k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = lane + r * WARP;
      if (row == k)
        z[r] = zk;
      else if (row < k)
        acc[r] -= ls[row * S + k] * zk;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o /= 2) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
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
