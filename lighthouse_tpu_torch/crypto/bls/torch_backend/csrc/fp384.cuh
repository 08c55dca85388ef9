// Fp arithmetic for BLS12-381 on 12 little-endian 32-bit words, as
// __device__ building blocks for the launchers in fp_kernels.cu and for
// later fused tower / Miller-loop / final-exponentiation kernels.
//
// Representation: an Fp element is 12 u32 words, value < p, kept in
// Montgomery form with R = 2^384 (the same integers the JAX package keeps
// in 32 12-bit limbs, so the two agree after a pure limb repack).
//
// Hopper multiplies 32 x 32 -> 64 bits natively (IMAD.WIDE), so the product
// is a plain CIOS Montgomery multiplication with 64-bit accumulators. Every
// helper works in registers; nothing here touches shared memory. The
// constants are static: each .cu that includes this file is compiled on
// its own and keeps its own copy.

#pragma once

#include <stdint.h>

#define FP_WORDS 12

// p, little-endian words.
static __constant__ uint32_t FP_P[FP_WORDS] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// -p^-1 mod 2^32.
#define FP_PINV 0xfffcfffdu
// R mod p: one in Montgomery form.
static __constant__ uint32_t FP_ONE[FP_WORDS] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// The inversion's batches (fp_inv below): 26 of 30 divsteps, 780 >= 2 x 381 - 1.
#define FP_INV_STEPS 30
#define FP_INV_BATCHES 26
// 2^(1152 + 32 x 26 - 780) = 2^1204 mod p, fp_inv's closing factor.
static __constant__ uint32_t FP_INV_C[FP_WORDS] = {
    0x8c5d1a2eu, 0x42957fa8u, 0x24cc85b1u, 0xa6507a62u, 0x39990a58u, 0xd8ca1b85u,
    0xac2f63fcu, 0xe65a054fu, 0xe1f35417u, 0x4ca0897au, 0xa0365c54u, 0x032748cbu};

__device__ __forceinline__ void fp_load(uint32_t r[FP_WORDS], const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = src[i];
}

__device__ __forceinline__ void fp_store(uint32_t* dst, const uint32_t r[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) dst[i] = r[i];
}

__device__ __forceinline__ void fp_copy(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fp_set_one(uint32_t r[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = FP_ONE[i];
}

__device__ __forceinline__ bool fp_is_zero(const uint32_t a[FP_WORDS]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) acc |= a[i];
  return acc == 0;
}

// r = t - p if t >= p else t, for t < 2p held in 12 words plus a top word.
__device__ __forceinline__ void fp_reduce_once(uint32_t r[FP_WORDS], const uint32_t t[FP_WORDS],
                                               uint32_t top) {
  uint32_t d[FP_WORDS];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t s = (uint64_t)t[i] - FP_P[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  // t >= p exactly when the subtraction did not borrow past the top word.
  bool take = top != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = take ? d[i] : t[i];
}

// Montgomery product r = a * b * 2^-384 mod p (CIOS). Inputs canonical,
// output canonical. r may alias a or b.
__device__ __forceinline__ void fp_mul(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t b[FP_WORDS]) {
  uint32_t t[FP_WORDS + 2];
#pragma unroll
  for (int i = 0; i < FP_WORDS + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FP_WORDS] + c;
    t[FP_WORDS] = (uint32_t)s;
    t[FP_WORDS + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * FP_PINV;
    s = (uint64_t)m * FP_P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FP_WORDS; ++j) {
      s = (uint64_t)m * FP_P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FP_WORDS] + c;
    t[FP_WORDS - 1] = (uint32_t)s;
    t[FP_WORDS] = t[FP_WORDS + 1] + (uint32_t)(s >> 32);
  }
  fp_reduce_once(r, t, t[FP_WORDS]);
}

// r = a + b mod p.
__device__ __forceinline__ void fp_add(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t b[FP_WORDS]) {
  uint32_t t[FP_WORDS];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t s = (uint64_t)a[i] + b[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  fp_reduce_once(r, t, (uint32_t)c);
}

// r = a - b mod p.
__device__ __forceinline__ void fp_sub(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t b[FP_WORDS]) {
  uint32_t t[FP_WORDS];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t s = (uint64_t)a[i] - b[i] - borrow;
    t[i] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  // a < b: add p back (the result then lies in (0, p)).
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t s = (uint64_t)t[i] + (FP_P[i] & mask) + c;
    r[i] = (uint32_t)s;
    c = s >> 32;
  }
}

// r = -a mod p (0 stays 0).
__device__ __forceinline__ void fp_neg(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS]) {
  uint32_t mask = fp_is_zero(a) ? 0u : 0xffffffffu;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t s = (uint64_t)(FP_P[i] & mask) - a[i] - borrow;
    r[i] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
}

// r = a^e for a public exponent e of `nbits` bits (little-endian words),
// MSB-first square-and-multiply. 0^e = 0 for e > 0 (inv0 semantics).
__device__ __forceinline__ void fp_pow(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t* e, int nbits) {
  uint32_t acc[FP_WORDS];
  fp_set_one(acc);
  for (int k = nbits - 1; k >= 0; --k) {
    fp_mul(acc, acc, acc);
    if ((e[k >> 5] >> (k & 31)) & 1u) fp_mul(acc, acc, a);
  }
  fp_copy(r, acc);
}

// -- lazy reduction: double-width sums of products, one reduction ---------------
//
// The counterpart of the JAX package's poly + redc contract (its
// jax_backend/fp.py:190-203): a tower product forms a sum T of Fp products
// in 24 words and reduces it once, where K1 reduces every product.
//
// Every operand is canonical (< p), so every product is below p^2. A
// difference is never formed in double width: a tower formula negates the
// Fp operand instead (-x = p - x, canonical), which turns a0 b0 - a1 b1
// into a0 b0 + (p - a1) b1, two products below p^2. So T is a sum of N
// nonnegative products, T < N p^2, and needs no offset of k p^2.
//
// Bound. The reduction adds m p with m < 2^384 (m is found word by word)
// and divides by 2^384, so it leaves a value below T / 2^384 + p <
// (N / 9.84 + 1) p, since 2^384 / p > 9.84. That is below 2p for N <= 9,
// where one conditional subtraction makes it canonical (SUBS = 1), and
// below 3p for N <= 19, where two do (SUBS = 2). On the way,
// T + m p < 19 p^2 + 2^384 p < 2^767, so the 24 words never carry out.

#define FP_WIDE 24

// r = a * b in 24 words, schoolbook: 144 word products in IMAD.WIDE chains.
__device__ __forceinline__ void fp_mul_wide(uint32_t r[FP_WIDE], const uint32_t a[FP_WORDS],
                                            const uint32_t b[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + r[i + j] + c;
      r[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    r[i + FP_WORDS] = (uint32_t)c;
  }
}

// t += x over 24 words (the caller's bound keeps the sum below 2^768).
__device__ __forceinline__ void fp_add_wide(uint32_t t[FP_WIDE], const uint32_t x[FP_WIDE]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) {
    uint64_t s = (uint64_t)t[i] + x[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
}

// t += a * b.
__device__ __forceinline__ void fp_mac_wide(uint32_t t[FP_WIDE], const uint32_t a[FP_WORDS],
                                            const uint32_t b[FP_WORDS]) {
  uint32_t prod[FP_WIDE];
  fp_mul_wide(prod, a, b);
  fp_add_wide(t, prod);
}

// r = T * 2^-384 mod p, canonical, for T < N p^2 with N <= 9 (SUBS = 1) or
// N <= 19 (SUBS = 2); see the bound above. Word-serial Montgomery
// reduction: 12 rounds of m = t_i (-p^-1) mod 2^32, t += m p 2^(32 i), each
// round's carry out of word i + 12 kept in one word for the next round.
// T is overwritten.
template <int SUBS>
__device__ __forceinline__ void fp_redc_wide(uint32_t r[FP_WORDS], uint32_t t[FP_WIDE]) {
  uint32_t hi = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    uint32_t m = t[i] * FP_PINV;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; ++j) {
      uint64_t s = (uint64_t)m * FP_P[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + FP_WORDS] + c + hi;
    t[i + FP_WORDS] = (uint32_t)s;
    hi = (uint32_t)(s >> 32);
  }
  fp_reduce_once(r, t + FP_WORDS, hi);
#pragma unroll
  for (int k = 1; k < SUBS; ++k) fp_reduce_once(r, r, 0);
}

// r = c ? x : y, branch-free.
__device__ __forceinline__ void fp_select(uint32_t r[FP_WORDS], bool c, const uint32_t x[FP_WORDS],
                                          const uint32_t y[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = c ? x[i] : y[i];
}

// -- inversion: a constant-iteration binary GCD ----------------------------------
//
// fp_inv(r, a) = a^-1 in Montgomery form (a = x R gives x^-1 R), 0 -> 0:
// Pornin's optimized binary GCD (IACR ePrint 2020/972, Algorithm 2). The
// inverse is one integer, so it returns the plain version's words (fp.py
// `inv`, the Fermat power over Montgomery products).
//
// a = x, b = p, u = 1, v = 0; after i batches (t = 30 i divsteps)
// a 2^t = u 2^(32 i) x and b 2^t = v 2^(32 i) x (mod p). A batch runs FP_INV_STEPS = 30 divsteps on 62-bit
// approximations of a and b (their low 30 bits, and their top 32 bits from
// bit n - 32, n = max(len a, len b, 62): exact once both fit in 62 bits),
// collecting them as a signed matrix [f0 g0; f1 g1] with |f0| + |g0| and
// |f1| + |g1| at most 2^30 (int32); then a, b = (a f0 + b g0) / 2^30,
// (a f1 + b g1) / 2^30 (exact; a negative one is negated with its row) and
// u, v = (u f0 + v g0) 2^-32, (u f1 + v g1) 2^-32 mod p (one Montgomery
// word step, a negative factor taken as the negated operand, so the sum
// is below 2^30 p and the step leaves it below 1.25 p). 2 x 381 - 1 = 761
// divsteps take len a + len b from 762 to 1 (a = 0, b = 1), with these
// approximations too (Pornin's bound); 26 batches give 780. Then
// v = x^-1 2^(780 - 32 x 26),
// and one Montgomery product by FP_INV_C = 2^1204 mod p gives
// v 2^1204 2^-384 = x^-1 2^768 = (x R^-1)^-1 R: the Montgomery inverse.
//
// The batch count is fixed and every divstep is selects, not branches: the
// threads of a warp stay together (K13 and K14 run one inversion a thread)
// and the time does not depend on a. An approximation is two words (64-bit
// operations are pairs of 32-bit instructions on this card). A batch is 30
// divsteps of a few selects each and four 12-word linear combinations by
// one word, where a Fermat chain is 608 dependent 12-word products. One
// copy per .cu (`__noinline__`). A Python replay, word for word, is
// tests/test_torch_inversion.py.

// Bits of a | b (0 for both zero).
__device__ __forceinline__ int fp_inv_bit_length(const uint32_t a[FP_WORDS], const uint32_t b[FP_WORDS]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    const uint32_t w = a[i] | b[i];
    n = w ? 32 * i + 32 - __clz(w) : n;
  }
  return n;
}

// x's 32 bits from bit s up (s < 352), read without indexing the array.
__device__ __forceinline__ uint32_t fp_inv_window(const uint32_t x[FP_WORDS], int s) {
  const int w = s >> 5;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    lo = i == w ? x[i] : lo;
    hi = i == w + 1 ? x[i] : hi;
  }
  return __funnelshift_r(lo, hi, s & 31);
}

// r = (a f + b g) / 2^30, exact, as its magnitude; returns whether it was
// negative. |f| + |g| <= 2^30, so a word's sum stays below 2^62 in size.
__device__ __forceinline__ bool fp_inv_combine(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                               const uint32_t b[FP_WORDS], int32_t f, int32_t g) {
  uint32_t t[FP_WORDS];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    c += (int64_t)a[i] * f + (int64_t)b[i] * g;
    t[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: the signed carry
  }
  // |a f + b g| < 2^411, so the quotient fits 384 bits with c's sign.
#pragma unroll
  for (int i = 0; i < FP_WORDS - 1; ++i) r[i] = __funnelshift_r(t[i], t[i + 1], FP_INV_STEPS);
  r[FP_WORDS - 1] = __funnelshift_r(t[FP_WORDS - 1], (uint32_t)c, FP_INV_STEPS);
  const bool neg = c < 0;
  uint32_t borrow = 0;  // r = -r where negative: 0 - r
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    const uint64_t s = (uint64_t)0 - r[i] - borrow;
    r[i] = neg ? (uint32_t)s : r[i];
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  return neg;
}

// r = (u f + v g) 2^-32 mod p, canonical. A negative factor takes the
// negated operand: u f = (p - u) |f|. The sum is below 2^30 p, so after
// the word step (add m p, m = t_0 (-p^-1) mod 2^32, drop the low word) it
// is below 1.25 p: one conditional subtraction.
__device__ __forceinline__ void fp_inv_update(uint32_t r[FP_WORDS], const uint32_t u[FP_WORDS],
                                              const uint32_t v[FP_WORDS], int32_t f, int32_t g) {
  uint32_t x[FP_WORDS], y[FP_WORDS], t[FP_WORDS + 1];
  fp_neg(x, u);
  fp_select(x, f < 0, x, u);
  fp_neg(y, v);
  fp_select(y, g < 0, y, v);
  const uint32_t fa = (uint32_t)(f < 0 ? -f : f), ga = (uint32_t)(g < 0 ? -g : g);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    c += (uint64_t)x[i] * fa + (uint64_t)y[i] * ga;
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  t[FP_WORDS] = (uint32_t)c;
  const uint32_t m = t[0] * FP_PINV;
  c = ((uint64_t)m * FP_P[0] + t[0]) >> 32;
#pragma unroll
  for (int i = 1; i < FP_WORDS; ++i) {
    c += (uint64_t)m * FP_P[i] + t[i];
    t[i - 1] = (uint32_t)c;
    c >>= 32;
  }
  t[FP_WORDS - 1] = (uint32_t)(c + t[FP_WORDS]);
  fp_reduce_once(r, t, 0);
}

// r = a^-1 (0 -> 0); see above. r may alias a.
static __device__ __noinline__ void fp_inv(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS]) {
  const uint32_t kLow = (1u << FP_INV_STEPS) - 1;
  uint32_t x[FP_WORDS], y[FP_WORDS], u[FP_WORDS], v[FP_WORDS], na[FP_WORDS], nb[FP_WORDS];
  const bool zero = fp_is_zero(a);
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    x[i] = a[i];
    y[i] = FP_P[i];
    u[i] = i == 0 ? 1u : 0u;
    v[i] = 0;
  }
#pragma unroll 1
  for (int batch = 0; batch < FP_INV_BATCHES; ++batch) {
    const int n = max(fp_inv_bit_length(x, y), 2 * FP_INV_STEPS + 2);
    uint64_t ah = ((uint64_t)fp_inv_window(x, n - 32) << FP_INV_STEPS) | (x[0] & kLow);
    uint64_t bh = ((uint64_t)fp_inv_window(y, n - 32) << FP_INV_STEPS) | (y[0] & kLow);
    int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
    for (int j = 0; j < FP_INV_STEPS; ++j) {
      // a odd: swap when a < b, then a -= b; then a /= 2 (b's row doubles)
      const bool odd = (ah & 1) != 0;
      const bool swap = odd && ah < bh;
      const uint64_t a1 = swap ? bh : ah, b1 = swap ? ah : bh;
      const int32_t f0s = swap ? f1 : f0, g0s = swap ? g1 : g0;
      const int32_t f1s = swap ? f0 : f1, g1s = swap ? g0 : g1;
      ah = (odd ? a1 - b1 : a1) >> 1;
      bh = b1;
      f0 = odd ? f0s - f1s : f0s;
      g0 = odd ? g0s - g1s : g0s;
      f1 = 2 * f1s;
      g1 = 2 * g1s;
    }
    const bool neg_a = fp_inv_combine(na, x, y, f0, g0);
    const bool neg_b = fp_inv_combine(nb, x, y, f1, g1);
    f0 = neg_a ? -f0 : f0;
    g0 = neg_a ? -g0 : g0;
    f1 = neg_b ? -f1 : f1;
    g1 = neg_b ? -g1 : g1;
    fp_inv_update(x, u, v, f0, g0);  // x, y hold u', v' for a moment
    fp_inv_update(y, u, v, f1, g1);
    fp_copy(u, x);
    fp_copy(v, y);
    fp_copy(x, na);
    fp_copy(y, nb);
  }
  fp_mul(v, v, FP_INV_C);
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = zero ? 0u : v[i];
}
