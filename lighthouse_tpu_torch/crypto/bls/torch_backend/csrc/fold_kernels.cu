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
//   Design: the pair sums run on curve.cuh's lane-group law (`lanes_add<C>`,
//   C = 1 for G1, 2 for G2: RCB's addition in four steps, each product of
//   a level on its own lane, `__syncwarp` between steps), the law that K10,
//   K11 and K17 run; `tree_sum_lanes<C>` is both kernels. A warp packs
//   32 / 6 C groups (five G1 groups on 30 lanes, two G2 groups on 24; the
//   other lanes take no part but reach every `__syncwarp`), a block holds
//   up to kTreeMaxWarps warps, enough for the first level's pairs, and the
//   groups walk a level's pairs in rounds when the pairs outnumber them. A
//   group gathers its two points into shared memory (X, Y, Z consecutive,
//   as the law's slots want them) and writes the sum to one half of the
//   column's scratch; the next level reads that half (ping-pong, so no
//   group overwrites a point that another has still to read). Level 0
//   gathers from the caller's points at their row and column strides. The
//   odd leftover is copied by the whole block. An off group (no pair left
//   this round) reads and writes nothing and still runs every step; a warp
//   whose groups are all off leaves the level. __syncthreads between
//   levels. Each group's two points and 13 scratch slots lie in shared
//   memory (912 bytes in G1, 1,824 in G2; dynamic, up to 72,960 and 58,368
//   bytes a block); the levels' points stay in the scratch in device
//   memory, so a column has no fixed cap (a 512-key G1 column is 72 KB, a
//   G2 column of 1,024 signatures 288 KB: each level is written and read
//   once, and L2 serves it). K15: a block per column, the verify's 128
//   columns of 128 keys on 128 SMs, 13 warps (65 groups) for the 64 pairs
//   of level 1. K16: one column, 16 warps (32 groups), so level 1's 64
//   pairs of a 128-signature verify take two rounds. The launch bounds
//   (512 threads) hold a thread to 128 registers: 16 warps fill an SM's
//   65,536.
//   Work (unchanged): L - 1 additions per column, an addition 12 field
//   products (the products by 3b are additions): 3,600 word products in
//   G1, 8,928 in G2 (Fp2 products of 744), against 144 or 288 bytes a
//   point. Operations bound; at the verify's columns (K = 128 keys,
//   S = 128 signatures) the time is log2(L) dependent additions of four
//   lane steps each (K16: eight, level 1 running twice).
//   ptxas (sm_90a, CUDA 12.8): K15 124 registers, no spills; K16 128 (the
//   launch bounds' cap) and 20 bytes of spill stores; 112 and 128 bytes of
//   stack; no static shared memory (`chip_smoke.py [timing]`, `ptxas=`).
//   A cap of 8 warps (256 threads: K16 152 registers, no spills) was
//   about 7 % slower on the card at the verify's shapes (PERF.md).
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

constexpr int kTreeMaxWarps = 16;  // K15 / K16: a block's warps at most
constexpr int kTreeMaxThreads = 32 * kTreeMaxWarps;
constexpr int kReduceGroups = 32;
constexpr int kReduceThreads = 6 * kReduceGroups;

// Lane groups a warp: five in G1 (C = 1), two in G2 (C = 2).
template <int C>
__host__ __device__ constexpr int tree_groups_per_warp() {
  return 32 / lane_group<C>();
}

// A lane group's shared memory: the pair it sums (X, Y, Z consecutive) and
// the law's scratch, the zero slot last.
template <int C>
struct TreeGroup {
  uint32_t pq[2][3 * C * FP_WORDS];
  uint32_t s[kLaneScratch][C * FP_WORDS];
};

// The column sums of the header, on the lane groups of a block.
template <int C>
__device__ __forceinline__ void tree_sum_lanes(const uint32_t* x, long long xr, long long xc, const uint32_t* y,
                                               long long yr, long long yc, const uint32_t* z, long long zr,
                                               long long zc, uint32_t* scratch, uint32_t* out, long long L,
                                               long long cols) {
  constexpr int W = C * FP_WORDS;  // a coordinate's words
  constexpr int kPoint = 3 * W;
  constexpr int kLanes = lane_group<C>();
  constexpr int kPerWarp = tree_groups_per_warp<C>();
  extern __shared__ uint32_t tree_smem[];
  const int warp = threadIdx.x / 32;
  const int gw = min((int)(threadIdx.x % 32) / kLanes, kPerWarp - 1);
  const int l = threadIdx.x % 32 - gw * kLanes;  // >= kLanes on the lanes outside every group
  const bool lane_on = l < kLanes;
  const int gid = warp * kPerWarp + gw, groups = (blockDim.x / 32) * kPerWarp;
  TreeGroup<C>& sh = reinterpret_cast<TreeGroup<C>*>(tree_smem)[gid];
  const long long col = blockIdx.x;
  const long long cap = (L + 1) / 2;
  uint32_t* buf[2] = {scratch + 2 * col * cap * kPoint, scratch + (2 * col + 1) * cap * kPoint};
  const uint32_t* src[3] = {x + col * xc, y + col * yc, z + col * zc};
  long long stride[3] = {xr, yr, zr};
  if (lane_on) {
    for (int i = l; i < W; i += kLanes) sh.s[kLaneScratch - 1][i] = 0u;
  }
  long long n = L;
  int next = 0;
  while (n > 1) {
    const long long half = n / 2;
    uint32_t* dst = buf[next];
    if (n & 1) {  // the odd leftover rides along
      for (int w = threadIdx.x; w < kPoint; w += blockDim.x) {
        dst[half * kPoint + w] = src[w / W][2 * half * stride[w / W] + w % W];
      }
    }
#pragma unroll 1
    for (long long base = 0; base < half; base += groups) {
      if (base + warp * kPerWarp >= half) break;  // no group of this warp has a pair left
      const long long i = base + gid;
      const bool on = lane_on && i < half;
      if (on) {  // rows i and i + half into the group's p and q
        for (int w = l; w < 2 * kPoint; w += kLanes) {
          const int t = w / kPoint, c = w % kPoint / W;
          sh.pq[t][w % kPoint] = src[c][(i + t * half) * stride[c] + w % W];
        }
      }
      __syncwarp();
      lanes_add<C>(dst + i * kPoint, sh.pq[0], sh.pq[1], &sh.s[0][0], l, on);
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      src[c] = dst + c * W;
      stride[c] = kPoint;
    }
    next ^= 1;
    n = half + (n & 1);
  }
  for (int w = threadIdx.x; w < kPoint; w += blockDim.x) out[(w / W * cols + col) * W + w % W] = src[w / W][w % W];
}

__global__ void __launch_bounds__(kTreeMaxThreads) g1_tree_sum_kernel(
    const uint32_t* x, long long xr, long long xc, const uint32_t* y, long long yr, long long yc, const uint32_t* z,
    long long zr, long long zc, uint32_t* scratch, uint32_t* out, long long L, long long C) {
  tree_sum_lanes<1>(x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, C);
}

__global__ void __launch_bounds__(kTreeMaxThreads) g2_tree_sum_kernel(
    const uint32_t* x, long long xr, long long xc, const uint32_t* y, long long yr, long long yc, const uint32_t* z,
    long long zr, long long zc, uint32_t* scratch, uint32_t* out, long long L, long long C) {
  tree_sum_lanes<2>(x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, C);
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

// Warps for a column of L points: enough groups for the first level's
// pairs, at least one, at most kTreeMaxWarps.
template <int C>
inline int tree_warps(long long L) {
  const long long warps = (L / 2 + tree_groups_per_warp<C>() - 1) / tree_groups_per_warp<C>();
  return (int)(warps < 1 ? 1 : warps < kTreeMaxWarps ? warps : kTreeMaxWarps);
}

// One launch of K15 (C = 1) or K16 (C = 2): a block per column, the groups'
// shared memory dynamic (above the 48 KB of static shared memory).
template <int C>
int tree_sum_launch(const void* x, long long xr, long long xc, const void* y, long long yr, long long yc,
                    const void* z, long long zr, long long zc, void* scratch, void* out, long long L, long long cols,
                    void* stream) {
  const auto kernel = C == 1 ? g1_tree_sum_kernel : g2_tree_sum_kernel;
  const int most = kTreeMaxWarps * tree_groups_per_warp<C>() * (int)sizeof(TreeGroup<C>);
  if (L > 0 && cols > 0 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most) == cudaSuccess) {
    const int warps = tree_warps<C>(L);
    kernel<<<(unsigned)cols, 32 * warps, warps * tree_groups_per_warp<C>() * sizeof(TreeGroup<C>),
             (cudaStream_t)stream>>>((const uint32_t*)x, xr, xc, (const uint32_t*)y, yr, yc, (const uint32_t*)z, zr,
                                     zc, (uint32_t*)scratch, (uint32_t*)out, L, cols);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lh_g1_tree_sum(const void* x, long long xr, long long xc, const void* y, long long yr, long long yc,
                   const void* z, long long zr, long long zc, void* scratch, void* out, long long L, long long C,
                   void* stream) {
  return tree_sum_launch<1>(x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, C, stream);
}

int lh_g2_tree_sum(const void* x, long long xr, long long xc, const void* y, long long yr, long long yc,
                   const void* z, long long zr, long long zc, void* scratch, void* out, long long L, long long C,
                   void* stream) {
  return tree_sum_launch<2>(x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, C, stream);
}

int lh_product_reduce(const void* fs, long long sf, void* scratch, void* out, long long n, void* stream) {
  if (n > 0) {
    product_reduce_kernel<<<1, kReduceThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)fs, sf,
                                                                         (uint32_t*)scratch, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
