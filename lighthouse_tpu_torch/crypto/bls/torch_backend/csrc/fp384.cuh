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
// p - 2, the Fermat inversion exponent, and its bit length.
static __constant__ uint32_t FP_P_MINUS_2[FP_WORDS] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
#define FP_P_MINUS_2_BITS 381

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

// r = a^(p-2) = a^-1 (0 -> 0), with the exponent read from constant memory.
__device__ __forceinline__ void fp_inv(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS]) {
  fp_pow(r, a, FP_P_MINUS_2, FP_P_MINUS_2_BITS);
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
