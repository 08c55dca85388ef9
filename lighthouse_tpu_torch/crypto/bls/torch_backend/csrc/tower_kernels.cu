// The tower products of the verify path, one launch per call, with plain C
// launchers (extern "C", bound from Python with ctypes). Every launcher
// runs on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().
//
// Operands are read in place: each comes with its element stride in
// words, the element's size for a contiguous tensor and 0 for one element
// broadcast over the batch (a constant such as the Frobenius gammas).
// Inside an element the layout is the tensor's own: Fp2 (2, 12) words,
// Fp12 in tower order (w:2, v:3, c:2, 12). Outputs are contiguous.
// Every product is formed in double width and reduced once
// (fp384.cuh, "lazy reduction"), where the composition these kernels
// replace launched K1 for the products and K2 for every sum.
//
// K7 fp2_mul_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/tower.py:61 `fp2_mul`
//   and :77 `fp2_sqr` (registered tower.fp2_mul / tower.fp2_sqr); `op`
//   selects mul (0) or sqr (1).
//   Design: two threads per Fp2 element, adjacent lanes of one warp;
//   thread c forms output component c. mul: c0 = a0 b0 + (-a1) b1 and
//   c1 = a0 b1 + a1 b0 (schoolbook: each thread 2 products where
//   Karatsuba would give one thread 3); sqr: c0 = (a0 + a1)(a0 - a1),
//   c1 = (a0 + a0) a1, the sums in registers. Both threads run one
//   instruction stream: the operands are chosen by branch-free selects.
//   Bound (lazy reduction): T < 2 p^2 (mul) or < p^2 (sqr), N <= 2, one
//   conditional subtraction. Work: 2 x (288 + 156) = 888 word products
//   per element (mul), 2 x (144 + 156) = 600 (sqr; the function needs
//   744 for mul: 3 Karatsuba products), against 288 or 192 bytes moved: about 3 products a byte, below the card's balance of
//   about 5 IMAD per byte, so a batch that filled the card would be bound
//   by bytes. The verify path's batches (a few hundred elements) are
//   bound by launch latency.
// K8 fp12_mul_kernel
//   Replaces: tower.py:243 `_flat_mul`, and through it :292 `fp12_mul`,
//   :352 `fp12_sqr` (`_flat_sqr`, :299) and :342 `fp12_mul_sparse035`;
//   `mode` selects full (0), square (1: b = a) and sparse (2: b only at
//   w^0, w^3, w^5, given as three Fp2 operands with their own strides).
//   Design: one warp per element, four elements (four warps) a block. The
//   block stages its a and b (1,152 bytes an element) in shared memory
//   with coalesced loads; the warp then forms the product on 24 lanes
//   (tower.cuh `fp12_mul_pairs`): lane 2 (2k + c) + half sums its half of
//   component c of flat coefficient e_k = sum_j a_((k-j) mod 6) b_j, terms
//   3 half .. 3 half + 2 (sparse: terms 0 and 1, or 2), with xi = 1 + u
//   applied to the a operand of the terms that wrap (i + j >= 6, i.e.
//   j > k): xi (x0 + x1 u) = (x0 - x1) + (x0 + x1) u, two Fp additions in
//   registers. A term is two products into the lane's double-width sum:
//   c0 += x0 y0 + (-x1) y1, c1 += x0 y1 + x1 y0. The lane pair adds its
//   two sums by a shuffle and the even lane reduces once and stores;
//   lanes 24-31 repeat lanes 0-7 and store nothing. Each lane's chain is
//   six products (four sparse) and one reduction, where the six-thread
//   form it replaced ran 24 products and two reductions on one thread.
//   Bound (lazy reduction): a lane's half is 6 products (sparse 4 or 2),
//   N = 12 after the add (6 sparse), T < 12 p^2, one reduction and two
//   conditional subtractions. Chosen over reducing each Fp2 product
//   (three reductions a lane instead of one) because it does fewer word
//   products, 6 x 144 + 156 = 1,020 a lane instead of
//   3 x (2 x 144 + 156) = 1,332, and keeps the reduction out of the loop
//   over terms.
//   Work: 22,608 word products per element (full and square), 12,240
//   (sparse; the function needs 17,424, 10,080 and 9,648 with Karatsuba
//   Fp2 products and a square's 21 distinct terms), against 1,728 bytes moved (1,440 sparse, 1,152 square):
//   operations bound for a batch that filled the card; the verify path's
//   (129 elements or fewer) are bound by launch latency and by one
//   lane's chain of 6 products, a shuffle of 24 words and a reduction.
//   Flat index k = 2v + w lies at tower offset (3w + v) x 24 words, so
//   operands and output stay in the tower layout and no copy to the flat
//   basis is made. The warp's routine is `fp12_mul_pairs` (tower.cuh),
//   which K9, K18 and K19 run for their products too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "tower.cuh"

namespace {

constexpr int kFp2Threads = 128;  // 64 elements a block
constexpr int kFp12PerBlock = 4;  // one warp per Fp12 element
constexpr int kFp12Threads = 32 * kFp12PerBlock;

__global__ void __launch_bounds__(kFp2Threads) fp2_mul_kernel(const uint32_t* __restrict__ a, long long sa,
                                                              const uint32_t* __restrict__ b, long long sb,
                                                              uint32_t* __restrict__ out, long long n, int op) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const long long e = t >> 1;
  const bool c1 = t & 1;
  uint32_t a0[FP_WORDS], a1[FP_WORDS], r[FP_WORDS], acc[FP_WIDE];
  fp_load(a0, a + e * sa);
  fp_load(a1, a + e * sa + FP_WORDS);
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) acc[i] = 0;
  if (op == 0) {
    uint32_t b0[FP_WORDS], b1[FP_WORDS];
    fp_load(b0, b + e * sb);
    fp_load(b1, b + e * sb + FP_WORDS);
    fp2_component_mac(acc, c1, a0, a1, b0, b1);
  } else {
    // c0 = (a0 + a1)(a0 - a1), c1 = (a0 + a0) a1
    uint32_t x[FP_WORDS], y[FP_WORDS];
    fp_select(x, c1, a0, a1);
    fp_add(x, a0, x);
    fp_sub(y, a0, a1);
    fp_select(y, c1, a1, y);
    fp_mac_wide(acc, x, y);
  }
  fp_redc_wide<1>(r, acc);
  fp_store(out + e * kFp2Words + (c1 ? FP_WORDS : 0), r);
}

__global__ void __launch_bounds__(kFp12Threads) fp12_mul_kernel(
    const uint32_t* __restrict__ a, long long sa, const uint32_t* __restrict__ b0, long long s0,
    const uint32_t* __restrict__ b3, long long s3, const uint32_t* __restrict__ b5, long long s5,
    uint32_t* __restrict__ out, long long n, int mode) {
  __shared__ uint32_t sh_a[kFp12PerBlock * kFp12Words];
  __shared__ uint32_t sh_b[kFp12PerBlock * kFp12Words];
  const long long first = (long long)blockIdx.x * kFp12PerBlock;

  // Stage the block's elements: consecutive threads read consecutive words.
  for (int i = threadIdx.x; i < kFp12PerBlock * kFp12Words; i += kFp12Threads) {
    const long long e = first + i / kFp12Words;
    const int w = i % kFp12Words;
    if (e < n) {
      sh_a[i] = a[e * sa + w];
      if (mode == kFull) sh_b[i] = b0[e * s0 + w];
    }
  }
  if (mode == kSparse) {  // b's w^0, w^3, w^5 coefficients in slots 0, 1, 2
    for (int i = threadIdx.x; i < kFp12PerBlock * 3 * kFp2Words; i += kFp12Threads) {
      const int g = i / (3 * kFp2Words), slot = (i / kFp2Words) % 3, w = i % kFp2Words;
      const long long e = first + g;
      if (e < n) {
        const uint32_t* src = slot == 0 ? b0 + e * s0 : slot == 1 ? b3 + e * s3 : b5 + e * s5;
        sh_b[g * kFp12Words + slot * kFp2Words + w] = src[w];
      }
    }
  }
  __syncthreads();

  const int w = threadIdx.x / 32;
  const long long e = first + w;
  if (e >= n) return;  // the whole warp
  const uint32_t* ea = sh_a + w * kFp12Words;
  const uint32_t* eb = (mode == kSquare ? sh_a : sh_b) + w * kFp12Words;
  fp12_mul_pairs(ea, eb, mode, out + e * kFp12Words);
}

}  // namespace

extern "C" {

int lh_fp2_mul(const void* a, long long sa, const void* b, long long sb, void* out, long long n, int op,
               void* stream) {
  if (n > 0) {
    const long long threads = 2 * n;
    fp2_mul_kernel<<<(unsigned)((threads + kFp2Threads - 1) / kFp2Threads), kFp2Threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa, (const uint32_t*)b, sb, (uint32_t*)out, n, op);
  }
  return (int)cudaGetLastError();
}

int lh_fp12_mul(const void* a, long long sa, const void* b0, long long s0, const void* b3, long long s3,
                const void* b5, long long s5, void* out, long long n, int mode, void* stream) {
  if (n > 0) {
    fp12_mul_kernel<<<(unsigned)((n + kFp12PerBlock - 1) / kFp12PerBlock), kFp12Threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa, (const uint32_t*)b0, s0, (const uint32_t*)b3, s3, (const uint32_t*)b5, s5,
        (uint32_t*)out, n, mode);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
