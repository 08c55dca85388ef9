// Windowed scalar multiplication in G1 and G2, one launch per call, with
// plain C launchers (extern "C", bound from Python with ctypes). Each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// K10 g1_scalar_mul_kernel, K11 g2_scalar_mul_kernel
//   Replace: lighthouse_tpu/crypto/bls/jax_backend/curve.py:282
//   `scalar_mul_bits` (registered curve.scalar_mul_bits.g1 / .g2), over
//   :184 `dbl_fast` and :138 `add`. On the verify path K10 runs
//   r_i [aggpk_i] (S elements, 64 secret bits each) and K11 the 2-stacked
//   [|z|] sig_i and r_i sig_i (2 S elements, 64 bits); hash-to-G2's
//   cofactor multiplications run the same routine inside K17
//   (cofactor_kernels.cu).
//   Computes: [k] P for a projective P and MSB-first 0/1 bits of k, by the
//   plain version's algorithm step for step, so that the projective
//   output is bit-identical to it (a coordinate is not unique; the
//   formulas that produce it are): curve.cuh `scalar_mul_lanes`, whose
//   header states the schedule (a 16-row table, four doublings (RCB
//   Algorithm 9) and one complete addition (Algorithm 7) a 4-bit digit,
//   127 bits making 32 digits), on curve.cuh's lane-group law: g1.cuh's
//   formulas for K10 (C = 1), g2.cuh's for K11 (C = 2), one step table.
//   Operands: X, Y, Z each with an element stride in words (the
//   coordinate's size, or 0 for one point broadcast over the batch); the
//   bits as int32 or int64 rows (one byte read per bit, the low byte of a
//   little-endian 0/1 value), row e at byte (e / inner) * hi +
//   (e % inner) * lo, so a row broadcast over some dims is read in place.
//   Output: X, Y, Z, each n contiguous coordinates.
//   Design, both: one warp a block, a lane group an element. Each group's
//   point goes into its table's row 1 and its bit row is read in place
//   (`step` bytes a bit). An RCB level's products go to the group's
//   lanes, a lane per product component, the additions between the levels
//   a lane per Fp component, `__syncwarp` between steps. The lanes outside
//   every group form nothing and reach every `__syncwarp`.
//   K10: one group of six lanes a warp (a G1 product a lane; lanes 6-31
//   idle; the products by 3b are additions, 12 v by fp_mul12: every value
//   is canonical, so it is the integer g1.cuh's Montgomery product by
//   G1_B3 = 12 R gives). In shared memory 16 rows (2,304 bytes), the
//   accumulator (144) and 13 scratch slots with the zero slot (624): 3,072
//   bytes a block. The verify path's 128 elements take 128 blocks on 128
//   SMs. Two and four groups a warp (64 and 32 blocks) were about 1 %
//   slower on the card (PERF.md).
//   K11: two groups of twelve lanes a warp (lanes 24-31 idle), in one
//   instruction stream over the same nbits (only the table row a digit
//   picks differs); per group 16 rows (4,608 bytes), the accumulator (288)
//   and 13 scratch slots (1,248), 12,288 bytes a block. The verify path's
//   256 elements take 128 blocks on 128 SMs, K17's shape. The last block's
//   second group, where n is odd, is off: it reads group 0's bit row,
//   forms nothing, and reaches every `__syncwarp`.
//   Work: 15 complete additions for the table, then per digit 4 doublings
//   and 1 addition. In the field products the function needs: an addition
//   12, a doubling 6 and 2 squares (the products by 3b are additions).
//   K10 at 64 bits: 31 additions and 64 doublings, 756 Fp products of 300
//   word products and 128 squares of 234, 256,752 word products per
//   element against 288 bytes of points and 64 bits moved. K11 over Fp2
//   products of 744 and squares of 600 (the kernel does every one as a
//   product, 888 word products): 639,264 word products at 64 bits,
//   1,144,608 at 128 (47 additions, 128 doublings), against 576 bytes.
//   Operations bound. At the verify path's shapes each is bound by one
//   warp's chain of 95 group operations (64 bits) of four steps, a step one
//   product component (or its additions) a lane, where one thread would
//   form the 12 (8) products of an addition (doubling) in a row.
//   Bound (reduction): G1 products are K1's CIOS (canonical in, canonical
//   out); G2's lazy sums hold N = 2 products, T < 2 p^2, inside
//   fp384.cuh's N <= 9 for one conditional subtraction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace {

constexpr int kThreads = 32;  // one warp a block
constexpr int kG1Lanes = lane_group<1>();  // K10: one group a warp

constexpr int kG1Point = 3 * FP_WORDS;  // a G1 point's words

// K10's block: the lane group's table, accumulator and scratch.
struct G1MulShared {
  uint32_t tab[kRows][kG1Point];        // the table; row 1 holds the point
  uint32_t acc[kG1Point];               // the accumulator
  uint32_t s[kLaneScratch][FP_WORDS];   // the scratch, the zero slot last
};

__global__ void __launch_bounds__(kThreads) g1_scalar_mul_kernel(
    const uint32_t* __restrict__ x, long long sx, const uint32_t* __restrict__ y, long long sy,
    const uint32_t* __restrict__ z, long long sz, const uint8_t* __restrict__ bits, long long inner, long long hi,
    long long lo, int step, int nbits, uint32_t* __restrict__ out, long long n) {
  __shared__ G1MulShared sh;
  const int l = threadIdx.x;
  const long long e = blockIdx.x;
  const bool on = l < kG1Lanes;  // lanes 6-31 idle
  const uint32_t* src[3] = {x + e * sx, y + e * sy, z + e * sz};
  if (on) {  // the point into row 1, the zero slot
    for (int i = l; i < kG1Point; i += kG1Lanes) sh.tab[1][i] = src[i / FP_WORDS][i % FP_WORDS];
    for (int i = l; i < FP_WORDS; i += kG1Lanes) sh.s[kLaneScratch - 1][i] = 0u;
  }
  __syncwarp();
  const uint8_t* row = bits + (e / inner) * hi + (e % inner) * lo;
  scalar_mul_lanes<1>(&sh.tab[0][0], sh.acc, &sh.s[0][0], row, nbits, step, l, on);
  if (on) {
    for (int i = l; i < kG1Point; i += kG1Lanes) {
      out[((i / FP_WORDS) * n + e) * FP_WORDS + i % FP_WORDS] = sh.acc[i];
    }
  }
}

// K11's block: two lane groups, each with its table, accumulator and
// scratch.
struct G2MulShared {
  G2Proj tab[2][kRows];      // each group's table; row 1 holds its point
  G2Proj acc[2];             // each group's accumulator
  fp2_t s[2][kLaneScratch];  // each group's scratch, the zero slot last
};

__global__ void __launch_bounds__(kThreads) g2_scalar_mul_kernel(
    const uint32_t* __restrict__ x, long long sx, const uint32_t* __restrict__ y, long long sy,
    const uint32_t* __restrict__ z, long long sz, const uint8_t* __restrict__ bits, long long inner, long long hi,
    long long lo, int step, int nbits, uint32_t* __restrict__ out, long long n) {
  __shared__ G2MulShared sh;
  constexpr int W = G2::kWords;
  const int t = threadIdx.x;
  const int g = t < kLaneGroup ? 0 : 1, l = t - g * kLaneGroup;  // lanes 24-31: group 1, l >= 12
  const long long e = 2 * (long long)blockIdx.x + g;
  const bool on = t < 2 * kLaneGroup && e < n;
  const long long re = on ? e : 2 * (long long)blockIdx.x;  // an off group reads group 0's row
  const uint32_t* src[3] = {x + e * sx, y + e * sy, z + e * sz};
  if (on) {  // the point into row 1, the zero slot
    for (int i = l; i < 3 * W; i += kLaneGroup) coord<G2>(sh.tab[g][1], i / W)[i % W] = src[i / W][i % W];
    for (int i = l; i < W; i += kLaneGroup) sh.s[g][kLaneScratch - 1][i / FP_WORDS][i % FP_WORDS] = 0u;
  }
  __syncwarp();
  const uint8_t* row = bits + (re / inner) * hi + (re % inner) * lo;
  scalar_mul_lanes<2>((uint32_t*)sh.tab[g], (uint32_t*)&sh.acc[g], &sh.s[g][0][0][0], row, nbits, step, l, on);
  if (on) {
    for (int i = l; i < 3 * W; i += kLaneGroup) {
      out[((i / W) * n + e) * W + i % W] = coord<G2>(sh.acc[g], i / W)[i % W];
    }
  }
}

}  // namespace

extern "C" {

int lh_g1_scalar_mul(const void* x, long long sx, const void* y, long long sy, const void* z, long long sz,
                     const void* bits, long long inner, long long hi, long long lo, int step, int nbits, void* out,
                     long long n, void* stream) {
  if (n > 0) {
    g1_scalar_mul_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, sx, (const uint32_t*)y, sy, (const uint32_t*)z, sz, (const uint8_t*)bits, inner, hi,
        lo, step, nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_g2_scalar_mul(const void* x, long long sx, const void* y, long long sy, const void* z, long long sz,
                     const void* bits, long long inner, long long hi, long long lo, int step, int nbits, void* out,
                     long long n, void* stream) {
  if (n > 0) {
    g2_scalar_mul_kernel<<<(unsigned)((n + 1) / 2), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, sx, (const uint32_t*)y, sy, (const uint32_t*)z, sz, (const uint8_t*)bits, inner, hi,
        lo, step, nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
