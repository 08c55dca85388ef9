// Fp2 = Fp[u]/(u^2 + 1) in one thread or split over two, and G2
// (y^2 = x^3 + 4(1 + u) over Fp2) in homogeneous projective coordinates
// (X : Y : Z), infinity = (0 : 1 : 0), as __device__ building blocks over
// fp384.cuh for K9 and K19 (final_exp_kernels.cu,
// final_exponentiation_kernels.cu), K11 (curve_kernels.cu), K12
// (pairing_kernels.cu), K13 / K14 (h2c_kernels.cu), K17
// (cofactor_kernels.cu) and K20 / K21 (verify_kernels.cu).
//
// An Fp2 element is uint32_t[2][12]: [c0, c1], canonical Montgomery words.
// A product forms each output component as one double-width sum and
// reduces it once (fp384.cuh, "lazy reduction"): c0 = a0 b0 + (-a1) b1 and
// c1 = a0 b1 + a1 b0, each a sum of N = 2 products below 2 p^2, so one
// conditional subtraction leaves it canonical (fp384.cuh's bound: N <= 9).
// 4 x 144 + 2 x 156 = 888 word products, where Karatsuba with a
// reduction per product would take 3 x 300 = 900.
//
// The group law is g1.cuh's, the complete formulas of Renes-Costello-
// Batina 2016 for a = 0 (Algorithm 7, addition; Algorithm 9, doubling),
// over Fp2 with 3b = 12 (1 + u). A product by 3b is
// 12 ((x0 - x1) + (x0 + x1) u), formed by additions; every value is
// canonical, so it is the same integers as the Fp2 product by the constant
// that curve.py's FP2 field forms.

#pragma once

#include <stdint.h>

#include "fp384.cuh"

typedef uint32_t fp2_t[2][FP_WORDS];

__device__ __forceinline__ void fp2_copy(fp2_t r, const fp2_t a) {
  fp_copy(r[0], a[0]);
  fp_copy(r[1], a[1]);
}

__device__ __forceinline__ void fp2_load(fp2_t r, const uint32_t* src) {
  fp_load(r[0], src);
  fp_load(r[1], src + FP_WORDS);
}

__device__ __forceinline__ void fp2_store(uint32_t* dst, const fp2_t a) {
  fp_store(dst, a[0]);
  fp_store(dst + FP_WORDS, a[1]);
}

__device__ __forceinline__ void fp2_add(fp2_t r, const fp2_t a, const fp2_t b) {
  fp_add(r[0], a[0], b[0]);
  fp_add(r[1], a[1], b[1]);
}

__device__ __forceinline__ void fp2_sub(fp2_t r, const fp2_t a, const fp2_t b) {
  fp_sub(r[0], a[0], b[0]);
  fp_sub(r[1], a[1], b[1]);
}

__device__ __forceinline__ bool fp2_is_zero(const fp2_t a) { return fp_is_zero(a[0]) && fp_is_zero(a[1]); }

// r = a b. r may alias a or b. Not inlined: the group law makes 12 or 8
// products a step, and one copy of the 888 unrolled word products keeps
// the kernels small enough to build in seconds.
static __device__ __noinline__ void fp2_mul(fp2_t r, const fp2_t a, const fp2_t b) {
  uint32_t t[FP_WIDE], u[FP_WORDS], c0[FP_WORDS];
  fp_mul_wide(t, a[0], b[0]);
  fp_neg(u, a[1]);
  fp_mac_wide(t, u, b[1]);
  fp_redc_wide<1>(c0, t);
  fp_mul_wide(t, a[0], b[1]);
  fp_mac_wide(t, a[1], b[0]);
  fp_redc_wide<1>(r[1], t);
  fp_copy(r[0], c0);
}

// Component c of a b, as one of the two threads that form an Fp2 product
// together (K7's split): c0 = a0 b0 + (-a1) b1, c1 = a0 b1 + a1 b0, one
// lazy sum of N = 2 products below 2 p^2, reduced once (fp384.cuh: N <= 9).
// The operands are chosen by selects, so both threads run one instruction
// stream. a and b may lie in shared memory.
__device__ __forceinline__ void fp2_mul_part(uint32_t r[FP_WORDS], const fp2_t a, const fp2_t b, int c) {
  uint32_t t[FP_WIDE], u[FP_WORDS], v0[FP_WORDS], v1[FP_WORDS];
  fp_neg(u, a[1]);
  fp_select(u, c == 1, a[1], u);
  fp_select(v0, c == 1, b[1], b[0]);
  fp_select(v1, c == 1, b[0], b[1]);
  fp_mul_wide(t, a[0], v0);
  fp_mac_wide(t, u, v1);
  fp_redc_wide<1>(r, t);
}

// Component c of e f + a0 b0 (+ a1 b1 where n = 2), for e, f in Fp and
// a_k, b_k in Fp2 (each 24 words, c0 then c1): e f, then per pair
// fp2_mul_part's terms (c0: a0 b0 + (-a1) b1; c1: a0 b1 + a1 b0), one lazy
// sum of N = 2n + 1 <= 5 products below p^2, reduced once (fp384.cuh:
// N <= 9). The operands may lie in shared or global memory and are taken
// by address, so every lane runs one instruction stream. The terms run in
// a rolled loop: one copy of the product, where the unrolled sum's copies
// cost a caller that runs it a few times more in instruction fetches than
// they save (K14, PERF.md).
__device__ __forceinline__ void fp2_sum_part(uint32_t r[FP_WORDS], const uint32_t* e, const uint32_t* f,
                                             const uint32_t* a0, const uint32_t* b0, const uint32_t* a1,
                                             const uint32_t* b1, int n, int c) {
  uint32_t t[FP_WIDE], x[FP_WORDS], y[FP_WORDS], u[FP_WORDS];
  fp_load(x, e);
  fp_load(y, f);
  fp_mul_wide(t, x, y);
#pragma unroll 1
  for (int i = 0; i < 2 * n; ++i) {
    const int h = i & 1;  // term h of pair i / 2: that a's component h
    fp_load(x, (i < 2 ? a0 : a1) + h * FP_WORDS);
    fp_neg(u, x);
    fp_select(x, h == 1 && c == 0, u, x);
    fp_load(y, (i < 2 ? b0 : b1) + (h ^ c) * FP_WORDS);
    fp_mac_wide(t, x, y);
  }
  fp_redc_wide<1>(r, t);
}

// Component c of a^2: c0 = (a0 + a1)(a0 - a1), c1 = (a0 + a0) a1, one
// product below p^2, reduced once (K7's square).
__device__ __forceinline__ void fp2_sqr_part(uint32_t r[FP_WORDS], const fp2_t a, int c) {
  uint32_t t[FP_WIDE], x[FP_WORDS], y[FP_WORDS], s[FP_WORDS];
  fp_add(x, a[0], a[1]);
  fp_add(s, a[0], a[0]);
  fp_select(x, c == 1, s, x);
  fp_sub(y, a[0], a[1]);
  fp_select(y, c == 1, a[1], y);
  fp_mul_wide(t, x, y);
  fp_redc_wide<1>(r, t);
}

__device__ __forceinline__ void fp2_neg(fp2_t r, const fp2_t a) {
  fp_neg(r[0], a[0]);
  fp_neg(r[1], a[1]);
}

// r = c ? x : y, branch-free.
__device__ __forceinline__ void fp2_select(fp2_t r, bool c, const fp2_t x, const fp2_t y) {
  fp_select(r[0], c, x[0], y[0]);
  fp_select(r[1], c, x[1], y[1]);
}

// Word equality: a field equality, since every value is canonical.
__device__ __forceinline__ bool fp2_eq(const fp2_t a, const fp2_t b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) acc |= (a[0][i] ^ b[0][i]) | (a[1][i] ^ b[1][i]);
  return acc == 0;
}

// r = 1 / a = (a0 - a1 u) / (a0^2 + a1^2), 0 -> 0 (inv0, as the port's
// tower.fp2_inv): the norm as one lazy sum of N = 2 squares reduced once,
// its inverse (fp384.cuh `fp_inv`, the fixed-count binary GCD), two
// products. r may alias a.
static __device__ __noinline__ void fp2_inv(fp2_t r, const fp2_t a) {
  uint32_t t[FP_WIDE], n[FP_WORDS];
  fp_mul_wide(t, a[0], a[0]);
  fp_mac_wide(t, a[1], a[1]);
  fp_redc_wide<1>(n, t);
  fp_inv(n, n);
  fp_mul(t, a[1], n);
  fp_mul(r[0], a[0], n);
  fp_neg(r[1], t);
}

// r = xi a, xi = 1 + u: (a0 - a1) + (a0 + a1) u. r may alias a.
__device__ __forceinline__ void fp2_mul_xi(fp2_t r, const fp2_t a) {
  uint32_t d[FP_WORDS];
  fp_sub(d, a[0], a[1]);
  fp_add(r[1], a[0], a[1]);
  fp_copy(r[0], d);
}

// r = 3b a = 12 (1 + u) a. r may alias a.
__device__ __forceinline__ void fp2_mul_b3(fp2_t r, const fp2_t a) {
  fp2_mul_xi(r, a);
  fp_mul12(r[0], r[0]);
  fp_mul12(r[1], r[1]);
}

struct G2Proj {
  fp2_t x;
  fp2_t y;
  fp2_t z;
};

// r = p + q, RCB 2016 Algorithm 7 (a = 0), g1_add's steps over Fp2. r may
// alias p or q.
__device__ __forceinline__ void g2_add(G2Proj& r, const G2Proj& p, const G2Proj& q) {
  fp2_t t0, t1, t2, t3, t4, x3, y3, z3;
  fp2_mul(t0, p.x, q.x);
  fp2_mul(t1, p.y, q.y);
  fp2_mul(t2, p.z, q.z);
  fp2_add(t3, p.x, p.y);
  fp2_add(t4, q.x, q.y);
  fp2_mul(t3, t3, t4);
  fp2_add(t4, t0, t1);
  fp2_sub(t3, t3, t4);  // X1 Y2 + X2 Y1
  fp2_add(t4, p.y, p.z);
  fp2_add(x3, q.y, q.z);
  fp2_mul(t4, t4, x3);
  fp2_add(x3, t1, t2);
  fp2_sub(t4, t4, x3);  // Y1 Z2 + Y2 Z1
  fp2_add(x3, p.x, p.z);
  fp2_add(y3, q.x, q.z);
  fp2_mul(x3, x3, y3);
  fp2_add(y3, t0, t2);
  fp2_sub(y3, x3, y3);  // X1 Z2 + X2 Z1
  fp2_add(x3, t0, t0);
  fp2_add(t0, x3, t0);  // 3 X1 X2
  fp2_mul_b3(t2, t2);
  fp2_add(z3, t1, t2);
  fp2_sub(t1, t1, t2);
  fp2_mul_b3(y3, y3);
  fp2_mul(x3, t4, y3);
  fp2_mul(t2, t3, t1);
  fp2_sub(x3, t2, x3);
  fp2_mul(y3, y3, t0);
  fp2_mul(t1, t1, z3);
  fp2_add(y3, t1, y3);
  fp2_mul(t0, t0, t3);
  fp2_mul(z3, z3, t4);
  fp2_add(z3, z3, t0);
  fp2_copy(r.x, x3);
  fp2_copy(r.y, y3);
  fp2_copy(r.z, z3);
}

// r = 2 p, RCB 2016 Algorithm 9 (a = 0), g1_dbl's steps over Fp2. r may
// alias p.
__device__ __forceinline__ void g2_dbl(G2Proj& r, const G2Proj& p) {
  fp2_t t0, t1, t2, x3, y3, z3;
  fp2_mul(t0, p.y, p.y);
  fp2_add(z3, t0, t0);
  fp2_add(z3, z3, z3);
  fp2_add(z3, z3, z3);  // 8 Y^2
  fp2_mul(t1, p.y, p.z);
  fp2_mul(t2, p.z, p.z);
  fp2_mul_b3(t2, t2);  // 3b Z^2
  fp2_mul(x3, t2, z3);
  fp2_add(y3, t0, t2);
  fp2_mul(z3, t1, z3);
  fp2_add(t1, t2, t2);
  fp2_add(t2, t1, t2);
  fp2_sub(t0, t0, t2);  // Y^2 - 9b Z^2
  fp2_mul(y3, t0, y3);
  fp2_add(y3, x3, y3);
  fp2_mul(t1, p.x, p.y);
  fp2_mul(x3, t0, t1);
  fp2_add(x3, x3, x3);
  fp2_copy(r.x, x3);
  fp2_copy(r.y, y3);
  fp2_copy(r.z, z3);
}
