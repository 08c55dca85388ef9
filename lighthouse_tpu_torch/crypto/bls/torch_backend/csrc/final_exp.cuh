// The |z|-power chain of the final exponentiation as a block routine,
// `cyclotomic_pow_x_block`, shared by K9 (final_exp_kernels.cu, one chain
// a launch) and K19 (final_exponentiation_kernels.cu, five chains inside
// the whole final exponentiation). Each .cu compiles on its own and keeps
// its own copy.
//
// The routine computes g^|z| for one tower-layout Fp12 g by the plain
// version's steps (`pairing.pow_abs_x_plain`): compress to (g2, g3, g4,
// g5) = flat coefficients 1, 4, 2, 5; 63 Karabina squarings, keeping the
// checkpoints g^(2^k) at the set bits k = 16, 48, 57, 60, 62, 63 of |z|;
// decompress the six (g1 = (xi g5^2 + 3 g4^2 - 2 g3) / (4 g2), or
// 2 g4 g5 / g3 where g2 = 0; g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1) with
// one Fp inversion of their six denominators' norms, zero norms mapping
// to zero (inv0: the all-zero compressed identity decompresses to one);
// then their product, ((f0 f3)(f1 f4))(f2 f5). Every value is canonical,
// so the output is the same integers as the plain version's whatever the
// formulas inside a step; the products by the small constants 6, 3 and 2
// of `karabina_sqr` are additions and one doubling here. Its work and
// bounds are stated with K9 in final_exp_kernels.cu.
//
// Schedule, for a block of one warp (kPowThreads) that all call the
// routine. The squarings run in registers: lane l of 0-23 (`kPowLane[l]`;
// lanes 24-31 repeat lanes 0-7 and store nothing) forms one 12 x 12
// product a step, half of a component of one of the six Fp2 products
// (g2^2, g3^2, g4^2, g5^2, g4 g5, g2 g3; g2.cuh `fp2_mul_part`'s terms, a
// square's too), and the lane pair adds its two double-width sums by a
// shuffle before the one reduction (doubled first for g4 g5 and g2 g3,
// the 6 of h2 and h5). Eight lanes keep the state, one Fp component each,
// and form its new value from their own product and at most two more,
// taken by shuffle; the product lanes take their operands from them by
// shuffle. No barrier in a step; the six checkpoint steps store the state
// to shared memory. Then twelve lanes (a checkpoint and a component each,
// g2.cuh's split products) decompress the six side by side; the six
// norms' inverses come from a product tree over the lanes and one
// inversion (fp384.cuh `fp_inv`, run by every lane on the same value);
// the product of six is K8's routine (tower.cuh `fp12_mul_pairs`), one
// product after another on the warp. The caller's shared `PowXShared`
// holds the checkpoints, the decompression and the products. `g` and
// `out` may lie in device or shared memory and may be the same element;
// the routine ends in __syncthreads. The `// K9_PHASE(i)` lines mark the
// end of each phase that chip_probes/k9_chain_phases.py stamps.

#pragma once

#include <stdint.h>

#include "fp384.cuh"
#include "g2.cuh"
#include "tower.cuh"

namespace {

constexpr int kPowThreads = 32;  // one warp per element
constexpr uint64_t kAbsZ = 0xd201000000010000ull;
constexpr int kSteps = 63;
constexpr int kCheckpoints = 6;  // set bits of |z|

// A squaring step's lane (see the header). u, v: the lanes whose state
// components are its product's operands; a, b: the lanes whose products
// its update takes; slot, c: the state component it keeps (compressed
// slots g2, g3, g4, g5 = 0..3, component c).
struct PowLane {
  uint8_t u, v, a, b, slot, c, flags;
};

enum PowFlag : uint8_t {
  kNegU = 1,    // the half (-x1) y1: u negated
  kDbl = 2,     // the pair's sum doubled (g4 g5, g2 g3: the 6 of h2 and h5)
  kOwner = 4,   // keeps component c of its slot: the update is its new value
  kXi = 8,      // the update takes xi's component c of (its product, lane a's)
  kAddB = 16,   // and adds lane b's product
  kMinus = 32,  // 3 x - 2 g (h3, h4); else 3 x + 2 g (h2, h5)
};

// Lane l of 0-23: product p = l / 4 (g4 g5, g2 g3) for l < 8, else the
// square of slot (l - 8) / 4; component (l / 2) % 2; half l % 2 (half 0:
// x0 y0 or x0 y1; half 1: -x1 y1 or x1 y0). Keepers: g2_c on lane 2c
// (h2 = 6 xi (g4 g5) + 2 g2), g5_c on 4 + 2c (h5 = 6 g2 g3 + 2 g5), g4_c on
// 12 + 2c (h4 = 3 (g2^2 + xi g3^2) - 2 g4), g3_c on 20 + 2c (h3 =
// 3 (g4^2 + xi g5^2) - 2 g3).
constexpr int kPowLanes = 24;
__constant__ PowLane kPowLane[kPowLanes] = {
    // u, v, a, b, slot, c, flags
    {12, 4, 2, 0, 0, 0, kDbl | kOwner | kXi},               // g4_0 g5_0; keeps g2_0
    {14, 6, 1, 1, 0, 0, kDbl | kNegU},                      // -g4_1 g5_1
    {12, 6, 0, 2, 0, 1, kDbl | kOwner | kXi},               // g4_0 g5_1; keeps g2_1
    {14, 4, 3, 3, 0, 1, kDbl},                              // g4_1 g5_0
    {0, 20, 4, 4, 3, 0, kDbl | kOwner},                     // g2_0 g3_0; keeps g5_0
    {2, 22, 5, 5, 0, 0, kDbl | kNegU},                      // -g2_1 g3_1
    {0, 22, 6, 6, 3, 1, kDbl | kOwner},                     // g2_0 g3_1; keeps g5_1
    {2, 20, 7, 7, 0, 1, kDbl},                              // g2_1 g3_0
    {0, 0, 8, 8, 0, 0, 0},                                  // g2_0 g2_0
    {2, 2, 9, 9, 0, 0, kNegU},                              // -g2_1 g2_1
    {0, 2, 10, 10, 0, 1, 0},                                // g2_0 g2_1
    {2, 0, 11, 11, 0, 1, 0},                                // g2_1 g2_0
    {20, 20, 14, 8, 2, 0, kOwner | kXi | kAddB | kMinus},   // g3_0 g3_0; keeps g4_0
    {22, 22, 13, 13, 0, 0, kNegU},                          // -g3_1 g3_1
    {20, 22, 12, 10, 2, 1, kOwner | kXi | kAddB | kMinus},  // g3_0 g3_1; keeps g4_1
    {22, 20, 15, 15, 0, 1, 0},                              // g3_1 g3_0
    {12, 12, 16, 16, 0, 0, 0},                              // g4_0 g4_0
    {14, 14, 17, 17, 0, 0, kNegU},                          // -g4_1 g4_1
    {12, 14, 18, 18, 0, 1, 0},                              // g4_0 g4_1
    {14, 12, 19, 19, 0, 1, 0},                              // g4_1 g4_0
    {4, 4, 22, 16, 1, 0, kOwner | kXi | kAddB | kMinus},    // g5_0 g5_0; keeps g3_0
    {6, 6, 21, 21, 0, 0, kNegU},                            // -g5_1 g5_1
    {4, 6, 20, 18, 1, 1, kOwner | kXi | kAddB | kMinus},    // g5_0 g5_1; keeps g3_1
    {6, 4, 23, 23, 0, 1, 0},                                // g5_1 g5_0
};

// Flat Fp12 index of compressed slot s: g2, g3, g4, g5 = 1, 4, 2, 5.
__device__ __forceinline__ int slot_flat(int s) { return s == 0 ? 1 : s == 1 ? 4 : s == 2 ? 2 : 5; }

// r = a as lane `src` holds it; every lane of the warp takes part.
__device__ __forceinline__ void fp_shfl(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS], int src) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = __shfl_sync(0xffffffffu, a[i], src);
}

struct PowXShared {
  uint32_t cp[kCheckpoints][4][2][FP_WORDS];   // the checkpoints, compressed
  uint32_t dec[kCheckpoints][4][2][FP_WORDS];  // num, den, g3 g4, g2 g5
  uint32_t f[kCheckpoints][kFp12Words];        // the decompressed checkpoints
  uint32_t p[3][kFp12Words];                   // the product tree's first level
};

// out = g^|z| (see the header); every thread of the one-warp block calls it.
__device__ __noinline__ void cyclotomic_pow_x_block(const uint32_t* g, uint32_t* out, PowXShared& sh) {
  const int lane = threadIdx.x & 31;

  // the squarings: compress, then 63 steps in registers
  {
    const PowLane me = kPowLane[lane % kPowLanes];
    const bool neg_u = me.flags & kNegU, c1 = me.c == 1, xi = me.flags & kXi, minus = me.flags & kMinus;
    const bool store = (me.flags & kOwner) && lane < kPowLanes;
    const uint32_t keep_b = (me.flags & kAddB) ? 0xffffffffu : 0u;
    const int dbl = (me.flags & kDbl) ? 1 : 0;
    uint32_t own[FP_WORDS];
    fp_load(own, g + tower_offset(slot_flat(me.slot)) + me.c * FP_WORDS);
    // K9_PHASE(0)
#pragma unroll 1
    for (int s = 1; s <= kSteps; ++s) {
      uint32_t u[FP_WORDS], v[FP_WORDS], x[FP_WORDS], y[FP_WORDS], two_g[FP_WORDS], pr[FP_WORDS];
      uint32_t wide[FP_WIDE], other[FP_WIDE];
      fp_add(two_g, own, own);  // 2 g, negated for h3 and h4
      fp_neg(x, two_g);
      fp_select(two_g, minus, x, two_g);
      // the product half: operands from their keepers, the pair's sums added
      fp_shfl(u, own, me.u);
      fp_shfl(v, own, me.v);
      fp_neg(x, u);
      fp_select(x, neg_u, x, u);
      fp_mul_wide(wide, x, v);
#pragma unroll
      for (int i = 0; i < FP_WIDE; ++i) other[i] = __shfl_sync(0xffffffffu, wide[i], lane ^ 1);
      fp_add_wide(wide, other);
#pragma unroll
      for (int i = FP_WIDE - 1; i > 0; --i) wide[i] = __funnelshift_l(wide[i - 1], wide[i], dbl);
      wide[0] <<= dbl;
      fp_redc_wide<1>(pr, wide);
      // K9_PHASE(1)
      // the update: x = xi's component c of (pr, lane a's) or pr, plus lane b's; 2 x + (x -+ 2 g)
      fp_shfl(u, pr, me.a);
      fp_shfl(v, pr, me.b);
      fp_sub(x, pr, u);
      fp_add(y, pr, u);
      fp_select(x, c1, y, x);
      fp_select(x, xi, x, pr);
#pragma unroll
      for (int i = 0; i < FP_WORDS; ++i) v[i] &= keep_b;
      fp_add(x, x, v);
      fp_add(y, x, x);
      fp_add(x, x, two_g);
      fp_add(own, y, x);
      if (((kAbsZ >> s) & 1) && store) fp_store(sh.cp[__popcll(kAbsZ & ((1ull << s) - 1))][me.slot][me.c], own);
      // K9_PHASE(2)
    }
  }
  __syncwarp();

  // decompress: lane (t, c) = (lane / 2 mod 6, lane % 2), a checkpoint and a
  // component; lanes 12-31 repeat lanes 0-19 and store nothing
  const int t = (lane >> 1) % kCheckpoints, c = lane & 1;
  const bool lead = lane < 2 * kCheckpoints;
  uint32_t norm[FP_WORDS];
  {
    fp2_t g2, g3, g4, g5;
    uint32_t r[FP_WORDS], x[FP_WORDS], y[FP_WORDS];
    fp2_copy(g2, sh.cp[t][0]);
    fp2_copy(g3, sh.cp[t][1]);
    fp2_copy(g4, sh.cp[t][2]);
    fp2_copy(g5, sh.cp[t][3]);
    fp2_mul_part(r, g3, g4, c);
    if (lead) fp_store(sh.dec[t][2][c], r);
    fp2_mul_part(r, g2, g5, c);
    if (lead) fp_store(sh.dec[t][3][c], r);
    // num1 = (xi g5^2 + 3 g4^2) - 2 g3
    fp2_sqr_part(r, g5, c);
    fp_shfl(y, r, lane ^ 1);
    fp_sub(x, r, y);
    fp_add(y, r, y);
    fp_select(x, c == 1, y, x);
    fp2_sqr_part(r, g4, c);
    fp_add(y, r, r);
    fp_add(y, y, r);
    fp_add(x, x, y);
    fp_load(r, sh.cp[t][1][c]);
    fp_add(y, r, r);
    fp_sub(x, x, y);
    // num2 = 2 g4 g5; den = 4 g2, or g3 where g2 = 0
    fp2_mul_part(r, g4, g5, c);
    fp_add(r, r, r);
    const bool g2nz = !fp2_is_zero(g2);
    fp_select(x, g2nz, x, r);
    fp_load(r, sh.cp[t][0][c]);
    fp_add(y, r, r);
    fp_add(y, y, y);
    fp_load(r, sh.cp[t][1][c]);
    fp_select(y, g2nz, y, r);
    if (lead) {
      fp_store(sh.dec[t][0][c], x);
      fp_store(sh.dec[t][1][c], y);
    }
    // den's norm den0^2 + den1^2: the pair's two squares added by a shuffle
    uint32_t wide[FP_WIDE], other[FP_WIDE];
    fp_mul_wide(wide, y, y);
#pragma unroll
    for (int i = 0; i < FP_WIDE; ++i) other[i] = __shfl_sync(0xffffffffu, wide[i], lane ^ 1);
    fp_add_wide(wide, other);
    fp_redc_wide<1>(norm, wide);
  }
  __syncwarp();

  // K9_PHASE(3)
  // the norms' inverses: m_t = norm_t (one for a zero norm); pair products,
  // the other two pairs' product, every m but m_t, their whole product
  // (the same on every lane), one inversion, then 1 / m_t
  uint32_t inv[FP_WORDS];
  {
    uint32_t m[FP_WORDS], mp[FP_WORDS], pp[FP_WORDS], q[FP_WORDS], others[FP_WORDS];
    const bool zero = fp_is_zero(norm);
    const int pair = t >> 1;
    fp_select(m, zero, FP_ONE, norm);
    fp_shfl(mp, m, 2 * (t ^ 1) + c);
    fp_mul(pp, m, mp);
    fp_shfl(q, pp, 4 * ((pair + 1) % 3) + c);
    fp_shfl(others, pp, 4 * ((pair + 2) % 3) + c);
    fp_mul(q, q, others);
    fp_mul(others, mp, q);
    fp_mul(inv, others, m);
    fp_inv(inv, inv);
    fp_mul(inv, inv, others);
    fp_select(inv, zero, norm, inv);  // a zero norm stays zero
  }

  // K9_PHASE(4)
  // decompress: g1 = num / den, g0, written in the tower layout
  {
    fp2_t num, d, g1;
    uint32_t r[FP_WORDS], x[FP_WORDS], y[FP_WORDS], g1c[FP_WORDS];
    fp2_copy(num, sh.dec[t][0]);
    // component c of 1 / den = (den0 - den1 u) / norm
    fp_load(x, sh.dec[t][1][c]);
    fp_mul(r, x, inv);
    fp_neg(x, r);
    fp_select(r, c == 1, x, r);
    fp_shfl(x, r, lane ^ 1);
    fp_select(d[0], c == 1, x, r);
    fp_select(d[1], c == 1, r, x);
    fp2_mul_part(g1c, num, d, c);
    fp_shfl(x, g1c, lane ^ 1);
    fp_select(g1[0], c == 1, x, g1c);
    fp_select(g1[1], c == 1, g1c, x);
    // a = 2 g1^2 + g2 g5 - 3 g3 g4; g0 = xi a + 1
    fp2_sqr_part(r, g1, c);
    fp_add(r, r, r);
    fp_load(x, sh.dec[t][3][c]);
    fp_add(r, r, x);
    fp_load(x, sh.dec[t][2][c]);
    fp_add(y, x, x);
    fp_add(y, y, x);
    fp_sub(r, r, y);
    fp_shfl(y, r, lane ^ 1);
    fp_sub(x, r, y);
    fp_add(x, x, FP_ONE);
    fp_add(y, r, y);
    fp_select(x, c == 1, y, x);
    if (lead) {  // flat 0..5 = g0, g2, g4, g1, g3, g5
      uint32_t* f = sh.f[t] + c * FP_WORDS;
      fp_store(f + tower_offset(0), x);
      fp_store(f + tower_offset(1), sh.cp[t][0][c]);
      fp_store(f + tower_offset(2), sh.cp[t][2][c]);
      fp_store(f + tower_offset(3), g1c);
      fp_store(f + tower_offset(4), sh.cp[t][1][c]);
      fp_store(f + tower_offset(5), sh.cp[t][3][c]);
    }
  }
  __syncwarp();

  // K9_PHASE(5)
  // ((f0 f3)(f1 f4))(f2 f5): five products one after another, one call
  // site of K8's routine
#pragma unroll 1
  for (int i = 0; i < 5; ++i) {
    const uint32_t* a = i < 3 ? sh.f[i] : sh.p[0];
    const uint32_t* b = i < 3 ? sh.f[i + 3] : sh.p[i - 2];
    fp12_mul_pairs(a, b, kFull, i < 3 ? sh.p[i] : i == 3 ? sh.p[0] : out);
    __syncwarp();
    // K9_PHASE(6 + i)
  }
  __syncthreads();
}

}  // namespace
