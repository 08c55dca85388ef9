// The halving trees of the verify path, one launch per call, with plain C
// launchers (extern "C", bound from Python with ctypes). Each launcher runs
// on the caller's stream, allocates nothing (K15 and K16 take the caller's
// scratch), does not synchronise, and returns the launch's error or
// cudaGetLastError().
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
//   W ranks' partials of a sharded verify (n = 1 to 4).
//   Computes: the product of n tower Fp12 values. Every Fp12 product is
//   canonical and the product of field elements does not depend on the
//   order, so any tree gives the plain version's words
//   (`pairing.product_reduce_plain`, a halving tree of rows i and
//   i + n / 2); this kernel runs its own.
//   Design: one thread block cluster (`cudaLaunchKernelEx` with a cluster
//   dimension) of B blocks on B SMs, B the largest power of two up to
//   kReduceClusterMax = 8 (the portable size) and up to n; block b takes
//   values [b n / B, (b + 1) n / B), loads them into its dynamic shared
//   memory and reduces them in place (`reduce_rows`: rows i and i + h into
//   row i, h = m - m / 2, until row 0 holds the block's partial); after a
//   cluster barrier block 0 reads the other partials through distributed
//   shared memory (`map_shared_rank`) into its rows 1 .. B - 1, a second
//   barrier lets the other blocks leave, and block 0 folds the B partials
//   the same way. A level's products run one a warp, each on 24 lanes
//   (tower.cuh `fp12_mul_pairs`, K8's routine): lane 2 (2k + c) + h sums
//   terms 3h .. 3h + 2 of component c of e_k (six Fp products), a shuffle
//   adds the lane pair's two double-width sums, and one `fp_redc_wide<2>`
//   reduces the component's 12-product sum: the integer is the one K8
//   reduces, so the words are too. The operands sit in shared memory; the
//   lanes of a warp have all read them (`__syncwarp`) before lane h = 0
//   stores over row i. Up to kReduceMaxGroups = 8 warps a block (enough for the first
//   level of n = 129: shares of 16 and 17 values, 8 products), the warps
//   walking a level's products in rounds above that. So n values take
//   ceil(log2 n) dependent product levels (8 at n = 129: 5 in the blocks,
//   3 in block 0's fold, where one block's tree takes 9 steps). A block
//   holds at most kReduceMaxRows = 256 values (147,456 bytes): above 2,048
//   values a block's share is loaded in turns, each later load after row
//   0's running product, a level more for each. No scratch, no state kept
//   across launches. A 12-lane form (a component a lane, the 12 products
//   in one sum, two products a warp) was built, held bit-identical and
//   timed in turns: 0.0872 and 0.0870 ms at n = 129 against 0.0543 and
//   0.0542 for 24 lanes (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md); it
//   was deleted.
//   Work: n - 1 Fp12 products. The function needs 17,424 word products a
//   product (K8's count: Karatsuba Fp2 products; 2,230,272 at n = 129);
//   the kernel forms each component's schoolbook sum, 22,608 a product
//   (2,893,824 at n = 129), and lanes 24-31 of each warp repeat lanes
//   0-7's terms and store nothing. Against 576 bytes a value read
//   and one written: operations bound (0.000133 ms at n = 129); at the
//   verify's n = 129 the time is the 8 dependent levels, one product's
//   latency each (5.4 to 6.5 us with one to four products a block: six Fp
//   products a lane, the shuffle, the reduction; 8.3 us with eight), plus
//   about 0.9 us of cluster hand-off (`chip_smoke.py [reduce_levels]`).
//   Measured at n = 129 (NVIDIA H100 80GB HBM3, 700.00 W, `chip_smoke.py
//   [timing]`, in turns with one block of K8's six-thread groups through
//   device-memory scratch): 0.05387 and 0.05388 ms against 0.23277 and
//   0.24061.
//   ptxas (sm_90a, CUDA 12.8): 144 registers, no spills, no stack; shared
//   memory dynamic, 576 bytes a row (9,792 bytes a block at n = 129).
//   Bound (reduction): K8's, N = 12 products per component, two
//   conditional subtractions; a lane's partial sum is below 6 p^2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "curve.cuh"
#include "tower.cuh"

namespace {

constexpr int kTreeMaxWarps = 16;  // K15 / K16: a block's warps at most
constexpr int kTreeMaxThreads = 32 * kTreeMaxWarps;
// K18: blocks in the cluster at most (the portable cluster size), warps a
// block at most (a product a warp, tower.cuh `fp12_mul_pairs`: enough for
// the first level of a 129-value product), values a block holds in shared
// memory at most (147,456 bytes).
constexpr int kReduceClusterMax = 8;
constexpr int kReduceMaxGroups = 8;
constexpr int kReduceMaxRows = 256;
static_assert(kReduceMaxRows >= kReduceClusterMax && 2 * kReduceMaxGroups >= kReduceClusterMax,
              "block 0 holds and folds every block's partial");

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

// K18's launch for n values: the blocks of its one cluster (a power of two,
// at most kReduceClusterMax and at most n), the values a block holds at
// once (its share, at least the cluster's partials, at most
// kReduceMaxRows) and its lane groups (enough for the first level's
// products and for the fold's first, at most kReduceMaxGroups).
struct ReduceShape {
  int blocks, rows, groups;
};

__host__ __device__ inline ReduceShape reduce_shape(long long n) {
  int blocks = 1;
  while (2 * blocks <= kReduceClusterMax && 2 * blocks <= n) blocks *= 2;
  const long long share = (n + blocks - 1) / blocks;
  const int rows = (int)(share < blocks ? blocks : share < kReduceMaxRows ? share : kReduceMaxRows);
  const int pairs = rows / 2 > blocks / 2 ? rows / 2 : blocks / 2 > 1 ? blocks / 2 : 1;
  return {blocks, rows, pairs < kReduceMaxGroups ? pairs : kReduceMaxGroups};
}

// The halving tree over the m values in shared memory `v` (kFp12Words
// apart), in place: a level multiplies rows i and i + h into row i for
// i < m / 2, h = m - m / 2 (an odd m leaves row h - 1 as it is), until
// row 0 holds the product. The block's warps walk a level's products in
// rounds, a warp its product (tower.cuh `fp12_mul_pairs`: lanes
// 2 (2k + c) + half sum terms 3 half .. 3 half + 2 of component c of e_k,
// a shuffle adds the pair's two double-width sums before the one
// reduction, lanes 24-31 repeat lanes 0-7 and store nothing; the lanes
// have all read their operands before any stores over row i); a warp with
// no product left leaves the level. __syncthreads between levels.
__device__ void reduce_rows(uint32_t* v, int m, int groups) {
  const int warp = threadIdx.x / 32;
  while (m > 1) {
    const int pairs = m / 2, h = m - pairs;
#pragma unroll 1
    for (int i = warp; i < pairs; i += groups) {
      fp12_mul_pairs(v + i * kFp12Words, v + (i + h) * kFp12Words, kFull, v + i * kFp12Words);
    }
    __syncthreads();
    m = h;
  }
}

// K18, one cluster of ReduceShape's blocks: block b takes values
// [b n / B, (b + 1) n / B) of fs (element stride sf words), loads them
// into its shared memory, at most ReduceShape's rows at a time (each
// later load after row 0, which holds the running product), and reduces
// each load with `reduce_rows`; then block 0 reads the other blocks' row 0 through
// distributed shared memory into its rows 1 .. B - 1 and folds the B
// partials the same way. Two cluster barriers: every partial ready;
// every partial read (a block's shared memory lives as long as the block).
__global__ void __launch_bounds__(32 * kReduceMaxGroups) product_reduce_kernel(const uint32_t* __restrict__ fs,
                                                                           long long sf, uint32_t* __restrict__ out,
                                                                           long long n) {
  extern __shared__ uint32_t reduce_smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const ReduceShape shape = reduce_shape(n);
  const int rank = (int)cluster.block_rank();
  const int groups = (int)(blockDim.x / 32);
  const long long hi = (rank + 1) * n / shape.blocks;
  long long next = rank * n / shape.blocks;
  int m = 0;
  do {
    const int take = (int)(hi - next < shape.rows - m ? hi - next : shape.rows - m);
    for (int w = threadIdx.x; w < take * kFp12Words; w += blockDim.x) {
      reduce_smem[m * kFp12Words + w] = fs[(next + w / kFp12Words) * sf + w % kFp12Words];
    }
    __syncthreads();
    reduce_rows(reduce_smem, m + take, groups);
    next += take;
    m = 1;
  } while (next < hi);
  cluster.sync();
  if (rank == 0) {
    for (int w = threadIdx.x; w < (shape.blocks - 1) * kFp12Words; w += blockDim.x) {
      const uint32_t* remote = cluster.map_shared_rank(reduce_smem, 1 + w / kFp12Words);
      reduce_smem[kFp12Words + w] = remote[w % kFp12Words];
    }
  }
  cluster.sync();
  if (rank != 0) return;
  reduce_rows(reduce_smem, shape.blocks, groups);
  for (int w = threadIdx.x; w < kFp12Words; w += blockDim.x) out[w] = reduce_smem[w];
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

int lh_product_reduce(const void* fs, long long sf, void* out, long long n, void* stream) {
  if (n > 0) {
    const ReduceShape shape = reduce_shape(n);
    const int most = kReduceMaxRows * kFp12Words * (int)sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(product_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)shape.blocks;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)shape.blocks);
    config.blockDim = dim3(32 * shape.groups);
    config.dynamicSmemBytes = (size_t)shape.rows * kFp12Words * sizeof(uint32_t);
    config.stream = (cudaStream_t)stream;
    config.attrs = cluster;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, product_reduce_kernel, (const uint32_t*)fs, sf, (uint32_t*)out, n);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
