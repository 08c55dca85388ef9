// The halving trees of the verify path, one launch per call, with plain C
// launchers (extern "C", bound from Python with ctypes). Each launcher runs
// on the caller's stream, allocates nothing (the caller passes the scratch),
// does not synchronise, and returns cudaGetLastError().
//
// K15 g1_tree_sum_kernel, K16 g2_tree_sum_kernel
//   Replace: lighthouse_tpu/crypto/bls/jax_backend/curve.py:138 `add`
//   (registered curve.add.g1 / .g2) in the use the verify makes of it,
//   jax_backend/api.py:208 `_tree_fold`: the port's `curve.tree_sum`. On
//   the verify path K15 sums each set's K public keys (S columns of K
//   points) and K16 the S products r_i sig_i (one column of S points).
//   Computes: the sum of each column of projective points by the plain
//   version's halving tree (`curve.tree_sum_plain`): at each level n
//   points become half = n / 2 complete additions of rows i and i + half,
//   and an odd leftover, row 2 half, is carried unpaired to the end of
//   the level. A projective coordinate is not unique, so this exact
//   pairing and order, with g1.cuh's / g2.cuh's RCB formulas (Algorithm
//   7), is what makes the output bit-identical to the plain version's.
//   Operands: X, Y, Z each with a row stride (along the fold) and a column
//   stride in words, so that a fold along any axis is read in place; a
//   scratch of 2 C ceil(L / 2) points from the caller; output X, Y, Z,
//   each C contiguous coordinates.
//   Design: a block per column, a thread per pair at each level (a block
//   of at most 128 threads walks the pairs of a longer level in turns),
//   __syncthreads between levels. Level 0 reads the caller's points; each
//   level writes its points to one half of the column's scratch and the
//   next reads them from there (ping-pong, so no thread overwrites a point
//   that another has still to read). The scratch lies in device memory:
//   a column has no fixed cap (a 512-key G1 column is 72 KB, a G2 column
//   of 1,024 signatures 288 KB), and every level's points are written and
//   read once, so L2 serves them.
//   Work: L - 1 additions per column, an addition 12 field products (the
//   products by 3b are additions; K15 forms G1's as products, G1_B3 = 12):
//   3,600 word products in G1, 8,928 in G2 (Fp2 products of 744), against
//   144 or 288 bytes a point. Operations bound; the verify path's columns
//   (K = 128 keys, S = 128 signatures) are bound by log2(L) dependent
//   additions on one SM each.
//   Bound (reduction): G1 products are K1's CIOS; G2's lazy sums hold
//   N = 2 products, inside fp384.cuh's N <= 9 for one subtraction.
//
// K18 product_reduce_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/pairing.py:282
//   `product_reduce` (registered pairing.product_reduce): the product of
//   the S + 1 Miller values of a verify (n = 129 at S = 128), and of the
//   W ranks' partials of a sharded verify.
//   Computes: the product of n tower Fp12 values by the plain version's
//   halving tree (`pairing.product_reduce_plain`): half = n / 2 products
//   of rows i and i + half a level, an odd leftover carried to the end.
//   Every Fp12 product is canonical, so the order does not change the
//   bytes; the plain order is kept all the same.
//   Design: one block of 32 six-thread groups (192 threads); each product
//   is K8's six-thread routine (tower.cuh `fp12_mul_thread`, thread k
//   forming flat coefficient e_k), a group walking the level's products
//   in turns; the levels ping-pong through a scratch of 2 ceil(n / 2)
//   values in device memory from the caller (129 values are 74 KB, above
//   the 48 KB of static shared memory), __syncthreads between levels.
//   Work: n - 1 Fp12 products of 17,424 word products (K8 full) against
//   576 bytes a value. Operations bound; at n = 129 the tree is 8 levels
//   of dependent products on one SM.
//   Bound (reduction): K8's, N = 12 products per component, two
//   conditional subtractions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"
#include "tower.cuh"

namespace {

constexpr int kFoldThreads = 128;
constexpr int kReduceGroups = 32;
constexpr int kReduceThreads = 6 * kReduceGroups;

// Where a level reads its points: three coordinate pointers and one row
// stride each. Level 0 reads the caller's operands, later levels a scratch
// half of packed points (X, Y, Z consecutive).
struct Rows {
  const uint32_t* c[3];
  long long stride[3];
};

template <typename G>
__device__ __forceinline__ void load_row(typename G::Point& p, const Rows& src, long long i) {
  load_point<G>(p, src.c[0] + i * src.stride[0], src.c[1] + i * src.stride[1], src.c[2] + i * src.stride[2]);
}

template <typename G>
__device__ __forceinline__ void tree_sum(const uint32_t* x, long long xr, long long xc, const uint32_t* y,
                                         long long yr, long long yc, const uint32_t* z, long long zr, long long zc,
                                         uint32_t* scratch, uint32_t* out, long long L, long long C) {
  using Point = typename G::Point;
  constexpr int W = G::kWords;
  constexpr int kPoint = 3 * W;
  const long long col = blockIdx.x;
  const long long cap = (L + 1) / 2;
  uint32_t* buf[2] = {scratch + 2 * col * cap * kPoint, scratch + (2 * col + 1) * cap * kPoint};
  Rows src = {{x + col * xc, y + col * yc, z + col * zc}, {xr, yr, zr}};
  long long n = L;
  int next = 0;
  while (n > 1) {
    const long long half = n / 2, m = half + (n & 1);
    uint32_t* dst = buf[next];
#pragma unroll 1
    for (long long i = threadIdx.x; i < m; i += blockDim.x) {
      Point a;
      load_row<G>(a, src, i < half ? i : 2 * half);  // the odd leftover rides along
      if (i < half) {
        Point b;
        load_row<G>(b, src, i + half);
        G::add(a, a, b);
      }
#pragma unroll 1
      for (int c = 0; c < 3; ++c) {
        const uint32_t* w = coord<G>(a, c);
        for (int k = 0; k < W; ++k) dst[i * kPoint + c * W + k] = w[k];
      }
    }
    __syncthreads();
    src = {{dst, dst + W, dst + 2 * W}, {kPoint, kPoint, kPoint}};
    next ^= 1;
    n = m;
  }
  if (threadIdx.x == 0) {
    Point a;
    load_row<G>(a, src, 0);
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
      const uint32_t* w = coord<G>(a, c);
      for (int k = 0; k < W; ++k) out[(c * C + col) * W + k] = w[k];
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads) g1_tree_sum_kernel(
    const uint32_t* x, long long xr, long long xc, const uint32_t* y, long long yr, long long yc, const uint32_t* z,
    long long zr, long long zc, uint32_t* scratch, uint32_t* out, long long L, long long C) {
  tree_sum<G1>(x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, C);
}

__global__ void __launch_bounds__(kFoldThreads) g2_tree_sum_kernel(
    const uint32_t* x, long long xr, long long xc, const uint32_t* y, long long yr, long long yc, const uint32_t* z,
    long long zr, long long zc, uint32_t* scratch, uint32_t* out, long long L, long long C) {
  tree_sum<G2>(x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, C);
}

__global__ void __launch_bounds__(kReduceThreads) product_reduce_kernel(const uint32_t* fs, long long sf,
                                                                        uint32_t* scratch, uint32_t* out,
                                                                        long long n) {
  const int g = threadIdx.x / 6, k = threadIdx.x % 6;
  const long long cap = (n + 1) / 2;
  uint32_t* buf[2] = {scratch, scratch + cap * kFp12Words};
  const uint32_t* src = fs;
  long long stride = sf, m = n;
  int next = 0;
  while (m > 1) {
    const long long half = m / 2;
    uint32_t* dst = buf[next];
#pragma unroll 1
    for (long long i = g; i < half; i += kReduceGroups) {
      fp12_mul_thread(src + i * stride, src + (i + half) * stride, k, kFull, dst + i * kFp12Words);
    }
    if (m & 1) {  // the odd leftover rides along
      for (int w = threadIdx.x; w < kFp12Words; w += kReduceThreads) {
        dst[half * kFp12Words + w] = src[2 * half * stride + w];
      }
    }
    __syncthreads();
    src = dst;
    stride = kFp12Words;
    next ^= 1;
    m = half + (m & 1);
  }
  for (int w = threadIdx.x; w < kFp12Words; w += kReduceThreads) out[w] = src[w];
}

inline unsigned fold_threads(long long L) {
  const long long pairs = (L + 1) / 2;
  const long long warps = (pairs + 31) / 32;
  return (unsigned)(warps * 32 < kFoldThreads ? warps * 32 : kFoldThreads);
}

}  // namespace

extern "C" {

int lh_g1_tree_sum(const void* x, long long xr, long long xc, const void* y, long long yr, long long yc,
                   const void* z, long long zr, long long zc, void* scratch, void* out, long long L, long long C,
                   void* stream) {
  if (L > 0 && C > 0) {
    g1_tree_sum_kernel<<<(unsigned)C, fold_threads(L), 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, xr, xc, (const uint32_t*)y, yr, yc, (const uint32_t*)z, zr, zc, (uint32_t*)scratch,
        (uint32_t*)out, L, C);
  }
  return (int)cudaGetLastError();
}

int lh_g2_tree_sum(const void* x, long long xr, long long xc, const void* y, long long yr, long long yc,
                   const void* z, long long zr, long long zc, void* scratch, void* out, long long L, long long C,
                   void* stream) {
  if (L > 0 && C > 0) {
    g2_tree_sum_kernel<<<(unsigned)C, fold_threads(L), 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, xr, xc, (const uint32_t*)y, yr, yc, (const uint32_t*)z, zr, zc, (uint32_t*)scratch,
        (uint32_t*)out, L, C);
  }
  return (int)cudaGetLastError();
}

int lh_product_reduce(const void* fs, long long sf, void* scratch, void* out, long long n, void* stream) {
  if (n > 0) {
    product_reduce_kernel<<<1, kReduceThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)fs, sf,
                                                                         (uint32_t*)scratch, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
