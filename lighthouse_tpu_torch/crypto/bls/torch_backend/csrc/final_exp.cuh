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
// one Fp inversion of their six denominators' norms shared by Montgomery's
// trick, zero norms mapping to zero (inv0: the all-zero compressed
// identity decompresses to one); then their product in `product_reduce`'s
// pairing order, ((f0 f3)(f1 f4))(f2 f5). Every value is canonical, so the
// output is the same integers as the plain version's; the products by the
// small constants 6, 3 and 2 of `karabina_sqr` are additions here. Its
// work and bounds are stated with K9 in final_exp_kernels.cu.
//
// Schedule, for a block of at least kPowThreads threads that all call the
// routine: a squaring's six Fp2 products (g2^2, g4^2, g3^2, g5^2, g4 g5,
// g2 g3) go to twelve threads, a product's two components to two threads
// as in K7; then eight threads form the four new coordinates' components
// by additions. Six threads decompress the six checkpoints side by side;
// one thread runs the shared inversion (fp384.cuh `fp_inv`); the product
// of six is K8's six-thread routine (tower.cuh `fp12_mul_thread`), three
// groups side by side for the tree's first level. The state lives in the
// caller's shared `PowXShared`. `g` and `out` may lie in device or shared
// memory and may be the same element; the routine ends in __syncthreads.

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
// slot k's operands of the squaring's product k, four bits each, in the
// compressed slots (g2, g3, g4, g5) = 0..3: [g2, g4, g3, g5, g4, g2] times
// [g2, g4, g3, g5, g5, g3]
constexpr uint32_t kSqrX = 0x023120u;
constexpr uint32_t kSqrY = 0x133120u;

// Flat Fp12 index of compressed slot s: g2, g3, g4, g5 = 1, 4, 2, 5.
__device__ __forceinline__ int slot_flat(int s) { return s == 0 ? 1 : s == 1 ? 4 : s == 2 ? 2 : 5; }

// Component c of xi b, xi = 1 + u: b0 - b1 or b0 + b1.
__device__ __forceinline__ void xi_component(uint32_t r[FP_WORDS], const uint32_t b[2][FP_WORDS], int c) {
  if (c == 0) {
    fp_sub(r, b[0], b[1]);
  } else {
    fp_add(r, b[0], b[1]);
  }
}

struct PowXShared {
  uint32_t c[4][2][FP_WORDS];                 // compressed state: g2, g3, g4, g5
  uint32_t sq[6][2][FP_WORDS];                // a squaring's six Fp2 products
  uint32_t cp[kCheckpoints][4][2][FP_WORDS];   // the checkpoints, compressed
  uint32_t dec[kCheckpoints][4][2][FP_WORDS];  // num, den, g3 g4, g2 g5
  uint32_t norm[kCheckpoints][FP_WORDS];       // den's norm, then its inverse
  uint32_t f[kCheckpoints][kFp12Words];        // the decompressed checkpoints
  uint32_t p[3][kFp12Words];                   // the product tree's first level
};

// out = g^|z| (see the header); every thread of the block calls it.
__device__ __noinline__ void cyclotomic_pow_x_block(const uint32_t* g, uint32_t* out, PowXShared& sh) {
  const int t = threadIdx.x;

  // compress
  if (t < 8) {
    const uint32_t* src = g + tower_offset(slot_flat(t >> 1)) + (t & 1) * FP_WORDS;
    fp_load(sh.c[t >> 1][t & 1], src);
  }
  __syncthreads();

#pragma unroll 1
  for (int s = 1; s <= kSteps; ++s) {
    if (t < 12) {  // product k = t / 2, component t % 2
      const int k = t >> 1, c = t & 1;
      const int xs = (kSqrX >> (4 * k)) & 0xF, ys = (kSqrY >> (4 * k)) & 0xF;
      uint32_t acc[FP_WIDE], r[FP_WORDS];
#pragma unroll
      for (int i = 0; i < FP_WIDE; ++i) acc[i] = 0;
      fp2_component_mac(acc, c == 1, sh.c[xs][0], sh.c[xs][1], sh.c[ys][0], sh.c[ys][1]);
      fp_redc_wide<1>(r, acc);
      fp_store(sh.sq[k][c], r);
    }
    __syncthreads();
    if (t < 8) {  // new coordinate h = t / 2 (h2, h3, h4, h5), component t % 2
      const int h = t >> 1, c = t & 1;
      uint32_t a[FP_WORDS], x[FP_WORDS], two_g[FP_WORDS], r[FP_WORDS];
      fp_add(two_g, sh.c[h][c], sh.c[h][c]);
      if (h == 0 || h == 3) {
        // h2 = 6 xi (g4 g5) + 2 g2, h5 = 6 (g2 g3) + 2 g5
        if (h == 0) {
          xi_component(a, sh.sq[4], c);
        } else {
          fp_copy(a, sh.sq[5][c]);
        }
        fp_add(x, a, a);
        fp_add(x, x, a);
        fp_add(x, x, x);
        fp_add(r, x, two_g);
      } else {
        // h3 = 3 (g4^2 + xi g5^2) - 2 g3, h4 = 3 (g2^2 + xi g3^2) - 2 g4
        xi_component(x, sh.sq[h == 1 ? 3 : 2], c);
        fp_add(a, sh.sq[h == 1 ? 1 : 0][c], x);
        fp_add(x, a, a);
        fp_add(x, x, a);
        fp_sub(r, x, two_g);
      }
      fp_store(sh.c[h][c], r);
      if ((kAbsZ >> s) & 1) fp_store(sh.cp[__popcll(kAbsZ & ((1ull << s) - 1))][h][c], r);
    }
    __syncthreads();
  }

  // decompress, one checkpoint a thread: everything up to den's norm
  if (t < kCheckpoints) {
    fp2_t g2, g3, g4, g5, a, b, num, den;
    fp2_copy(g2, sh.cp[t][0]);
    fp2_copy(g3, sh.cp[t][1]);
    fp2_copy(g4, sh.cp[t][2]);
    fp2_copy(g5, sh.cp[t][3]);
    fp2_mul(a, g3, g4);
    fp2_copy(sh.dec[t][2], a);
    fp2_mul(a, g2, g5);
    fp2_copy(sh.dec[t][3], a);
    // num1 = (xi g5^2 + 3 g4^2) - 2 g3
    fp2_mul(a, g5, g5);
    fp2_mul_xi(a, a);
    fp2_mul(b, g4, g4);
    fp2_add(num, b, b);
    fp2_add(num, num, b);
    fp2_add(num, a, num);
    fp2_add(a, g3, g3);
    fp2_sub(num, num, a);
    // num2 = 2 g4 g5; 4 g2
    fp2_mul(a, g4, g5);
    fp2_add(a, a, a);
    fp2_add(b, g2, g2);
    fp2_add(b, b, b);
    const bool g2nz = !fp2_is_zero(g2);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fp_select(num[c], g2nz, num[c], a[c]);
      fp_select(den[c], g2nz, b[c], g3[c]);
    }
    fp2_copy(sh.dec[t][0], num);
    fp2_copy(sh.dec[t][1], den);
    uint32_t acc[FP_WIDE], r[FP_WORDS];
    fp_mul_wide(acc, den[0], den[0]);
    fp_mac_wide(acc, den[1], den[1]);
    fp_redc_wide<1>(r, acc);
    fp_store(sh.norm[t], r);
  }
  __syncthreads();

  // the shared inversion: Montgomery's trick over the nonzero norms
  if (t == 0) {
    uint32_t pre[kCheckpoints][FP_WORDS], inv[FP_WORDS], m[FP_WORDS], r[FP_WORDS];
    fp_select(pre[0], fp_is_zero(sh.norm[0]), FP_ONE, sh.norm[0]);
#pragma unroll 1
    for (int i = 1; i < kCheckpoints; ++i) {
      fp_select(m, fp_is_zero(sh.norm[i]), FP_ONE, sh.norm[i]);
      fp_mul(pre[i], pre[i - 1], m);
    }
    fp_inv(inv, pre[kCheckpoints - 1]);
#pragma unroll 1
    for (int i = kCheckpoints - 1; i >= 0; --i) {
      const bool zero = fp_is_zero(sh.norm[i]);
      fp_select(m, zero, FP_ONE, sh.norm[i]);
      if (i > 0) {
        fp_mul(r, inv, pre[i - 1]);
        fp_mul(inv, inv, m);
      } else {
        fp_copy(r, inv);
      }
      fp_select(r, zero, sh.norm[i], r);  // a zero norm stays zero
      fp_store(sh.norm[i], r);
    }
  }
  __syncthreads();

  // decompress: g1 = num / den, g0, written in the tower layout
  if (t < kCheckpoints) {
    fp2_t num, den, g1, s1, a, b;
    fp2_copy(num, sh.dec[t][0]);
    fp2_copy(den, sh.dec[t][1]);
    // 1/den = (den0 - den1 u) / norm
    fp_mul(a[0], den[0], sh.norm[t]);
    fp_mul(b[0], den[1], sh.norm[t]);
    fp_neg(a[1], b[0]);
    fp2_mul(g1, num, a);
    fp2_mul(s1, g1, g1);
    fp2_add(a, s1, s1);
    fp2_copy(b, sh.dec[t][3]);
    fp2_add(a, a, b);  // 2 g1^2 + g2 g5
    fp2_copy(s1, sh.dec[t][2]);
    fp2_add(b, s1, s1);
    fp2_add(b, b, s1);  // 3 g3 g4
    fp2_sub(a, a, b);
    fp2_mul_xi(a, a);
    fp_add(a[0], a[0], FP_ONE);
    uint32_t* f = sh.f[t];
    const fp2_t* cp = sh.cp[t];
    // flat 0..5 = g0, g2, g4, g1, g3, g5
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fp_store(f + tower_offset(0) + c * FP_WORDS, a[c]);
      fp_store(f + tower_offset(1) + c * FP_WORDS, cp[0][c]);
      fp_store(f + tower_offset(2) + c * FP_WORDS, cp[2][c]);
      fp_store(f + tower_offset(3) + c * FP_WORDS, g1[c]);
      fp_store(f + tower_offset(4) + c * FP_WORDS, cp[1][c]);
      fp_store(f + tower_offset(5) + c * FP_WORDS, cp[3][c]);
    }
  }
  __syncthreads();

  // ((f0 f3)(f1 f4))(f2 f5): three levels of six-thread groups, one call
  // site of K8's routine (level 0: three groups side by side)
#pragma unroll 1
  for (int level = 0; level < 3; ++level) {
    const int grp = t / 6;
    if (grp < (level == 0 ? 3 : 1)) {
      const uint32_t* a = level == 0 ? sh.f[grp] : level == 1 ? sh.p[0] : sh.f[0];
      const uint32_t* b = level == 0 ? sh.f[grp + 3] : level == 1 ? sh.p[1] : sh.p[2];
      uint32_t* dst = level == 0 ? sh.p[grp] : level == 1 ? sh.f[0] : out;
      fp12_mul_thread(a, b, t % 6, kFull, dst);
    }
    __syncthreads();
  }
}

}  // namespace
