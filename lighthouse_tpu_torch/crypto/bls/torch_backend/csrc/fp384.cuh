// Fp arithmetic for BLS12-381 on 12 little-endian 32-bit words, as
// __device__ building blocks for the launchers in fp_kernels.cu and for
// every fused kernel of the port (each .cu includes this file).
//
// Representation: an Fp element is 12 u32 words, value < p, kept in
// Montgomery form with R = 2^384 (the same integers the JAX package keeps
// in 32 12-bit limbs, so the two agree after a pure limb repack).
//
// All multi-word integer arithmetic is written by hand in PTX carry
// chains (`add.cc` / `addc`, `sub.cc` / `subc`, `mad.lo.cc` / `madc.hi.cc`),
// one inline `asm` statement a chain, so that the carry flag never has to
// live across two statements; a carry that a later chain needs is saved
// in a register (`addc.u32 c, 0, 0`). p's words are immediates. A row of
// products by one word is split into two chains, the even words of the
// multiplicand (whose low and high halves fill words 0, 1, 2, ...) and
// the odd ones (words 1, 2, 3, ...), each into an accumulator of its own,
// so that the two chains share no register and run side by side; the two
// meet only at the row's lowest word, which one chain folds into the
// other. A product's halves become one IMAD.WIDE.U32.X, which wants them
// in an aligned register pair, so the accumulators keep words at fixed
// positions and never shift (below). The statements are plain `asm` (not
// volatile): the compiler may interleave independent chains. Every helper
// works in registers; nothing here touches shared memory. The constants
// are static: each .cu that includes this file is compiled on its own and
// keeps its own copy.
//
// tests/test_torch_fp384_chains.py reads each chain's text below and runs
// it in a Python interpreter of the PTX it uses, carry flag included.

#pragma once

#include <stdint.h>

#define FP_WORDS 12
// A double-width value (a product, a lazy sum of products): 24 words.
#define FP_WIDE 24

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

// -- the carry chains ------------------------------------------------------------
//
// Operand lists: 12 words of array x as outputs (FP_W12), read and written
// (FP_RW12), inputs (FP_R12); the same from word s of x on (FP_W12_AT,
// FP_RW12_AT, FP_R12_AT; FP_RW13_AT for 13 words); the even / odd words of
// a multiplicand (FP_EVEN6, FP_ODD6).

#define FP_W12_AT(x, s)                                                                                   \
  "=r"((x)[(s) + 0]), "=r"((x)[(s) + 1]), "=r"((x)[(s) + 2]), "=r"((x)[(s) + 3]), "=r"((x)[(s) + 4]),     \
      "=r"((x)[(s) + 5]), "=r"((x)[(s) + 6]), "=r"((x)[(s) + 7]), "=r"((x)[(s) + 8]), "=r"((x)[(s) + 9]), \
      "=r"((x)[(s) + 10]), "=r"((x)[(s) + 11])
#define FP_RW12_AT(x, s)                                                                                  \
  "+r"((x)[(s) + 0]), "+r"((x)[(s) + 1]), "+r"((x)[(s) + 2]), "+r"((x)[(s) + 3]), "+r"((x)[(s) + 4]),     \
      "+r"((x)[(s) + 5]), "+r"((x)[(s) + 6]), "+r"((x)[(s) + 7]), "+r"((x)[(s) + 8]), "+r"((x)[(s) + 9]), \
      "+r"((x)[(s) + 10]), "+r"((x)[(s) + 11])
#define FP_RW13_AT(x, s) FP_RW12_AT(x, s), "+r"((x)[(s) + 12])
#define FP_R12_AT(x, s)                                                                                   \
  "r"((x)[(s) + 0]), "r"((x)[(s) + 1]), "r"((x)[(s) + 2]), "r"((x)[(s) + 3]), "r"((x)[(s) + 4]),          \
      "r"((x)[(s) + 5]), "r"((x)[(s) + 6]), "r"((x)[(s) + 7]), "r"((x)[(s) + 8]), "r"((x)[(s) + 9]),      \
      "r"((x)[(s) + 10]), "r"((x)[(s) + 11])
#define FP_W12(x) FP_W12_AT(x, 0)
#define FP_RW12(x) FP_RW12_AT(x, 0)
#define FP_R12(x) FP_R12_AT(x, 0)
#define FP_EVEN6(x) "r"((x)[0]), "r"((x)[2]), "r"((x)[4]), "r"((x)[6]), "r"((x)[8]), "r"((x)[10])
#define FP_ODD6(x) "r"((x)[1]), "r"((x)[3]), "r"((x)[5]), "r"((x)[7]), "r"((x)[9]), "r"((x)[11])

// The product and reduction chains work on a double-width value held in
// two accumulators z[0] and z[1], 25 words each at their absolute word
// positions, whose sum is the value. A product's low and high halves form
// a register pair (IMAD.WIDE's 64-bit operand), so each accumulator only
// ever takes pairs that start at even (z[0]) or odd (z[1]) positions: in
// row i, the products by the multiplicand's even words (positions i, i+1,
// ...) go to z[i & 1] and those by its odd words (positions i+1, ...) to
// the other, and the same for p's words in a reduction step. Each row is
// two chains on disjoint registers, and no word moves between rows.

// x[0..11] = six words (%12-%17) times one (%18): the low and high halves
// of each product side by side, no carries.
#define FP_ASM_HALF_MUL \
  "mul.lo.u32 %0, %12, %18;\n\t" \
  "mul.hi.u32 %1, %12, %18;\n\t" \
  "mul.lo.u32 %2, %13, %18;\n\t" \
  "mul.hi.u32 %3, %13, %18;\n\t" \
  "mul.lo.u32 %4, %14, %18;\n\t" \
  "mul.hi.u32 %5, %14, %18;\n\t" \
  "mul.lo.u32 %6, %15, %18;\n\t" \
  "mul.hi.u32 %7, %15, %18;\n\t" \
  "mul.lo.u32 %8, %16, %18;\n\t" \
  "mul.hi.u32 %9, %16, %18;\n\t" \
  "mul.lo.u32 %10, %17, %18;\n\t" \
  "mul.hi.u32 %11, %17, %18;"

// A reduction's first step, odd half: m (%12) from the value's word 0
// (%13), x[0..11] = m times p's odd words (no carries).
#define FP_ASM_REDC_ODD_FIRST \
  "mul.lo.u32 %12, %13, 0xfffcfffd;\n\t" \
  "mul.lo.u32 %0, %12, 0xb9feffff;\n\t" \
  "mul.hi.u32 %1, %12, 0xb9feffff;\n\t" \
  "mul.lo.u32 %2, %12, 0x1eabfffe;\n\t" \
  "mul.hi.u32 %3, %12, 0x1eabfffe;\n\t" \
  "mul.lo.u32 %4, %12, 0x6730d2a0;\n\t" \
  "mul.hi.u32 %5, %12, 0x6730d2a0;\n\t" \
  "mul.lo.u32 %6, %12, 0x64774b84;\n\t" \
  "mul.hi.u32 %7, %12, 0x64774b84;\n\t" \
  "mul.lo.u32 %8, %12, 0x4b1ba7b6;\n\t" \
  "mul.hi.u32 %9, %12, 0x4b1ba7b6;\n\t" \
  "mul.lo.u32 %10, %12, 0x1a0111ea;\n\t" \
  "mul.hi.u32 %11, %12, 0x1a0111ea;"

// Z (%0-%12, from the row's first position) += six words (%13-%18) times
// one (%19), in place; the carry out of word 11 into word 12.
#define FP_ASM_ROW \
  "mad.lo.cc.u32 %0, %13, %19, %0;\n\t" \
  "madc.hi.cc.u32 %1, %13, %19, %1;\n\t" \
  "madc.lo.cc.u32 %2, %14, %19, %2;\n\t" \
  "madc.hi.cc.u32 %3, %14, %19, %3;\n\t" \
  "madc.lo.cc.u32 %4, %15, %19, %4;\n\t" \
  "madc.hi.cc.u32 %5, %15, %19, %5;\n\t" \
  "madc.lo.cc.u32 %6, %16, %19, %6;\n\t" \
  "madc.hi.cc.u32 %7, %16, %19, %7;\n\t" \
  "madc.lo.cc.u32 %8, %17, %19, %8;\n\t" \
  "madc.hi.cc.u32 %9, %17, %19, %9;\n\t" \
  "madc.lo.cc.u32 %10, %18, %19, %10;\n\t" \
  "madc.hi.cc.u32 %11, %18, %19, %11;\n\t" \
  "addc.u32 %12, %12, 0;"

// The other chain of a row, led by the fold of the row's lowest position:
// X[i] (%13) += Y[i] (%14), whose carry enters Y's chain from position
// i + 1 on (%0-%12): Y += six words (%15-%20) times one (%21), in place.
// X[i] is then the value's final word i.
#define FP_ASM_FOLD_ROW \
  "add.cc.u32 %13, %13, %14;\n\t" \
  "madc.lo.cc.u32 %0, %15, %21, %0;\n\t" \
  "madc.hi.cc.u32 %1, %15, %21, %1;\n\t" \
  "madc.lo.cc.u32 %2, %16, %21, %2;\n\t" \
  "madc.hi.cc.u32 %3, %16, %21, %3;\n\t" \
  "madc.lo.cc.u32 %4, %17, %21, %4;\n\t" \
  "madc.hi.cc.u32 %5, %17, %21, %5;\n\t" \
  "madc.lo.cc.u32 %6, %18, %21, %6;\n\t" \
  "madc.hi.cc.u32 %7, %18, %21, %7;\n\t" \
  "madc.lo.cc.u32 %8, %19, %21, %8;\n\t" \
  "madc.hi.cc.u32 %9, %19, %21, %9;\n\t" \
  "madc.lo.cc.u32 %10, %20, %21, %10;\n\t" \
  "madc.hi.cc.u32 %11, %20, %21, %11;\n\t" \
  "addc.u32 %12, %12, 0;"

// A reduction step's odd chain, led by the fold: X[i] (%13) += Y[i] (%15),
// m = X[i] (-p^-1) mod 2^32 (%14), Y (%0-%12, from position i + 1) += m
// times p's odd words, the fold's carry entering it.
#define FP_ASM_FOLD_RED \
  "add.cc.u32 %13, %13, %15;\n\t" \
  "mul.lo.u32 %14, %13, 0xfffcfffd;\n\t" \
  "madc.lo.cc.u32 %0, %14, 0xb9feffff, %0;\n\t" \
  "madc.hi.cc.u32 %1, %14, 0xb9feffff, %1;\n\t" \
  "madc.lo.cc.u32 %2, %14, 0x1eabfffe, %2;\n\t" \
  "madc.hi.cc.u32 %3, %14, 0x1eabfffe, %3;\n\t" \
  "madc.lo.cc.u32 %4, %14, 0x6730d2a0, %4;\n\t" \
  "madc.hi.cc.u32 %5, %14, 0x6730d2a0, %5;\n\t" \
  "madc.lo.cc.u32 %6, %14, 0x64774b84, %6;\n\t" \
  "madc.hi.cc.u32 %7, %14, 0x64774b84, %7;\n\t" \
  "madc.lo.cc.u32 %8, %14, 0x4b1ba7b6, %8;\n\t" \
  "madc.hi.cc.u32 %9, %14, 0x4b1ba7b6, %9;\n\t" \
  "madc.lo.cc.u32 %10, %14, 0x1a0111ea, %10;\n\t" \
  "madc.hi.cc.u32 %11, %14, 0x1a0111ea, %11;\n\t" \
  "addc.u32 %12, %12, 0;"

// A reduction step's even chain: X (%0-%12, from position i) += m (%13)
// times p's even words; word i becomes 0 (dropped).
#define FP_ASM_RED \
  "{\n\t" \
  ".reg .u32 q;\n\t" \
  "mad.lo.cc.u32 q, %13, 0xffffaaab, %0;\n\t" \
  "madc.hi.cc.u32 %1, %13, 0xffffaaab, %1;\n\t" \
  "madc.lo.cc.u32 %2, %13, 0xb153ffff, %2;\n\t" \
  "madc.hi.cc.u32 %3, %13, 0xb153ffff, %3;\n\t" \
  "madc.lo.cc.u32 %4, %13, 0xf6b0f624, %4;\n\t" \
  "madc.hi.cc.u32 %5, %13, 0xf6b0f624, %5;\n\t" \
  "madc.lo.cc.u32 %6, %13, 0xf38512bf, %6;\n\t" \
  "madc.hi.cc.u32 %7, %13, 0xf38512bf, %7;\n\t" \
  "madc.lo.cc.u32 %8, %13, 0x434bacd7, %8;\n\t" \
  "madc.hi.cc.u32 %9, %13, 0x434bacd7, %9;\n\t" \
  "madc.lo.cc.u32 %10, %13, 0x397fe69a, %10;\n\t" \
  "madc.hi.cc.u32 %11, %13, 0x397fe69a, %11;\n\t" \
  "addc.u32 %12, %12, 0;\n\t" \
  "}"

// s (%0-%11) += x (%12-%23); no carry out.
#define FP_ASM_ADD12 \
  "add.cc.u32 %0, %0, %12;\n\t" \
  "addc.cc.u32 %1, %1, %13;\n\t" \
  "addc.cc.u32 %2, %2, %14;\n\t" \
  "addc.cc.u32 %3, %3, %15;\n\t" \
  "addc.cc.u32 %4, %4, %16;\n\t" \
  "addc.cc.u32 %5, %5, %17;\n\t" \
  "addc.cc.u32 %6, %6, %18;\n\t" \
  "addc.cc.u32 %7, %7, %19;\n\t" \
  "addc.cc.u32 %8, %8, %20;\n\t" \
  "addc.cc.u32 %9, %9, %21;\n\t" \
  "addc.cc.u32 %10, %10, %22;\n\t" \
  "addc.u32 %11, %11, %23;"

// s (%0-%11) += x (%13-%24), the carry out added to c (%12).
#define FP_ASM_ADD12_CARRY \
  "add.cc.u32 %0, %0, %13;\n\t" \
  "addc.cc.u32 %1, %1, %14;\n\t" \
  "addc.cc.u32 %2, %2, %15;\n\t" \
  "addc.cc.u32 %3, %3, %16;\n\t" \
  "addc.cc.u32 %4, %4, %17;\n\t" \
  "addc.cc.u32 %5, %5, %18;\n\t" \
  "addc.cc.u32 %6, %6, %19;\n\t" \
  "addc.cc.u32 %7, %7, %20;\n\t" \
  "addc.cc.u32 %8, %8, %21;\n\t" \
  "addc.cc.u32 %9, %9, %22;\n\t" \
  "addc.cc.u32 %10, %10, %23;\n\t" \
  "addc.cc.u32 %11, %11, %24;\n\t" \
  "addc.u32 %12, %12, 0;"

// s (%0-%11) += x (%12-%23) + c (%24, 0 or 1): c is turned back into the
// carry flag first.
#define FP_ASM_ADD12_CARRY_IN \
  "{\n\t" \
  ".reg .u32 q;\n\t" \
  "add.cc.u32 q, %24, 0xffffffff;\n\t" \
  "addc.cc.u32 %0, %0, %12;\n\t" \
  "addc.cc.u32 %1, %1, %13;\n\t" \
  "addc.cc.u32 %2, %2, %14;\n\t" \
  "addc.cc.u32 %3, %3, %15;\n\t" \
  "addc.cc.u32 %4, %4, %16;\n\t" \
  "addc.cc.u32 %5, %5, %17;\n\t" \
  "addc.cc.u32 %6, %6, %18;\n\t" \
  "addc.cc.u32 %7, %7, %19;\n\t" \
  "addc.cc.u32 %8, %8, %20;\n\t" \
  "addc.cc.u32 %9, %9, %21;\n\t" \
  "addc.cc.u32 %10, %10, %22;\n\t" \
  "addc.u32 %11, %11, %23;\n\t" \
  "}"

// d (%0-%11) = t (%13-%24) - p; %12 = top (%25) - the borrow, all ones
// exactly when t + top 2^384 < p.
#define FP_ASM_SUB_P \
  "sub.cc.u32 %0, %13, 0xffffaaab;\n\t" \
  "subc.cc.u32 %1, %14, 0xb9feffff;\n\t" \
  "subc.cc.u32 %2, %15, 0xb153ffff;\n\t" \
  "subc.cc.u32 %3, %16, 0x1eabfffe;\n\t" \
  "subc.cc.u32 %4, %17, 0xf6b0f624;\n\t" \
  "subc.cc.u32 %5, %18, 0x6730d2a0;\n\t" \
  "subc.cc.u32 %6, %19, 0xf38512bf;\n\t" \
  "subc.cc.u32 %7, %20, 0x64774b84;\n\t" \
  "subc.cc.u32 %8, %21, 0x434bacd7;\n\t" \
  "subc.cc.u32 %9, %22, 0x4b1ba7b6;\n\t" \
  "subc.cc.u32 %10, %23, 0x397fe69a;\n\t" \
  "subc.cc.u32 %11, %24, 0x1a0111ea;\n\t" \
  "subc.u32 %12, %25, 0;"

// d (%0-%11) -= b (%13-%24); %12 = all ones on a borrow, else 0.
#define FP_ASM_SUB12 \
  "sub.cc.u32 %0, %0, %13;\n\t" \
  "subc.cc.u32 %1, %1, %14;\n\t" \
  "subc.cc.u32 %2, %2, %15;\n\t" \
  "subc.cc.u32 %3, %3, %16;\n\t" \
  "subc.cc.u32 %4, %4, %17;\n\t" \
  "subc.cc.u32 %5, %5, %18;\n\t" \
  "subc.cc.u32 %6, %6, %19;\n\t" \
  "subc.cc.u32 %7, %7, %20;\n\t" \
  "subc.cc.u32 %8, %8, %21;\n\t" \
  "subc.cc.u32 %9, %9, %22;\n\t" \
  "subc.cc.u32 %10, %10, %23;\n\t" \
  "subc.cc.u32 %11, %11, %24;\n\t" \
  "subc.u32 %12, 0, 0;"

// d (%0-%11) += p & mask (%12), modulo 2^384.
#define FP_ASM_ADD_P_MASKED \
  "{\n\t" \
  ".reg .u32 q;\n\t" \
  "and.b32 q, %12, 0xffffaaab;\n\t" \
  "add.cc.u32 %0, %0, q;\n\t" \
  "and.b32 q, %12, 0xb9feffff;\n\t" \
  "addc.cc.u32 %1, %1, q;\n\t" \
  "and.b32 q, %12, 0xb153ffff;\n\t" \
  "addc.cc.u32 %2, %2, q;\n\t" \
  "and.b32 q, %12, 0x1eabfffe;\n\t" \
  "addc.cc.u32 %3, %3, q;\n\t" \
  "and.b32 q, %12, 0xf6b0f624;\n\t" \
  "addc.cc.u32 %4, %4, q;\n\t" \
  "and.b32 q, %12, 0x6730d2a0;\n\t" \
  "addc.cc.u32 %5, %5, q;\n\t" \
  "and.b32 q, %12, 0xf38512bf;\n\t" \
  "addc.cc.u32 %6, %6, q;\n\t" \
  "and.b32 q, %12, 0x64774b84;\n\t" \
  "addc.cc.u32 %7, %7, q;\n\t" \
  "and.b32 q, %12, 0x434bacd7;\n\t" \
  "addc.cc.u32 %8, %8, q;\n\t" \
  "and.b32 q, %12, 0x4b1ba7b6;\n\t" \
  "addc.cc.u32 %9, %9, q;\n\t" \
  "and.b32 q, %12, 0x397fe69a;\n\t" \
  "addc.cc.u32 %10, %10, q;\n\t" \
  "and.b32 q, %12, 0x1a0111ea;\n\t" \
  "addc.u32 %11, %11, q;\n\t" \
  "}"

// r (%0-%11) = (p & mask (%24)) - a (%12-%23).
#define FP_ASM_NEG_MASKED \
  "{\n\t" \
  ".reg .u32 q;\n\t" \
  "and.b32 q, %24, 0xffffaaab;\n\t" \
  "sub.cc.u32 %0, q, %12;\n\t" \
  "and.b32 q, %24, 0xb9feffff;\n\t" \
  "subc.cc.u32 %1, q, %13;\n\t" \
  "and.b32 q, %24, 0xb153ffff;\n\t" \
  "subc.cc.u32 %2, q, %14;\n\t" \
  "and.b32 q, %24, 0x1eabfffe;\n\t" \
  "subc.cc.u32 %3, q, %15;\n\t" \
  "and.b32 q, %24, 0xf6b0f624;\n\t" \
  "subc.cc.u32 %4, q, %16;\n\t" \
  "and.b32 q, %24, 0x6730d2a0;\n\t" \
  "subc.cc.u32 %5, q, %17;\n\t" \
  "and.b32 q, %24, 0xf38512bf;\n\t" \
  "subc.cc.u32 %6, q, %18;\n\t" \
  "and.b32 q, %24, 0x64774b84;\n\t" \
  "subc.cc.u32 %7, q, %19;\n\t" \
  "and.b32 q, %24, 0x434bacd7;\n\t" \
  "subc.cc.u32 %8, q, %20;\n\t" \
  "and.b32 q, %24, 0x4b1ba7b6;\n\t" \
  "subc.cc.u32 %9, q, %21;\n\t" \
  "and.b32 q, %24, 0x397fe69a;\n\t" \
  "subc.cc.u32 %10, q, %22;\n\t" \
  "and.b32 q, %24, 0x1a0111ea;\n\t" \
  "subc.u32 %11, q, %23;\n\t" \
  "}"

// -- the routines ------------------------------------------------------------------

// r = t - p if t + top 2^384 >= p, else t, for t + top 2^384 < 2p held in
// 12 words and a top word (0 or 1): one borrow chain and a select.
__device__ __forceinline__ void fp_reduce_once(uint32_t r[FP_WORDS], const uint32_t t[FP_WORDS],
                                               uint32_t top) {
  uint32_t d[FP_WORDS], keep;
  asm(FP_ASM_SUB_P : FP_W12(d), "=r"(keep) : FP_R12(t), "r"(top));
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = keep == 0xffffffffu ? t[i] : d[i];
}

// Montgomery product r = a * b * 2^-384 mod p (CIOS: a row of products by
// b's word i, then a reduction step). Inputs canonical, output canonical.
// r may alias a or b. The running value stays below 2p after every row
// (a < p) and below 2p + 2^32 p < 2^414 within one, so no accumulator
// word past position i + 12 is ever nonzero in row i, and the sum at
// positions 12-24 needs one conditional subtraction.
__device__ __forceinline__ void fp_mul(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t b[FP_WORDS]) {
  uint32_t z[2][FP_WIDE + 1], s[FP_WORDS], m;
#pragma unroll
  for (int k = 0; k <= FP_WIDE; ++k) z[0][k] = z[1][k] = 0;
  asm(FP_ASM_HALF_MUL : FP_W12_AT(z[0], 0) : FP_EVEN6(a), "r"(b[0]));
  asm(FP_ASM_HALF_MUL : FP_W12_AT(z[1], 1) : FP_ODD6(a), "r"(b[0]));
  asm(FP_ASM_FOLD_RED : FP_RW13_AT(z[1], 1), "+r"(z[0][0]), "=r"(m) : "r"(z[1][0]));
  asm(FP_ASM_RED : FP_RW13_AT(z[0], 0) : "r"(m));
#pragma unroll
  for (int i = 1; i < FP_WORDS; ++i) {
    const int x = i & 1, y = x ^ 1;
    asm(FP_ASM_ROW : FP_RW13_AT(z[x], i) : FP_EVEN6(a), "r"(b[i]));
    asm(FP_ASM_ROW : FP_RW13_AT(z[y], i + 1) : FP_ODD6(a), "r"(b[i]));
    asm(FP_ASM_FOLD_RED : FP_RW13_AT(z[y], i + 1), "+r"(z[x][i]), "=r"(m) : "r"(z[y][i]));
    asm(FP_ASM_RED : FP_RW13_AT(z[x], i) : "r"(m));
  }
  uint32_t top = z[0][FP_WIDE] + z[1][FP_WIDE];
  asm(FP_ASM_ADD12_CARRY : FP_RW12_AT(z[0], FP_WORDS), "+r"(top) : FP_R12_AT(z[1], FP_WORDS));
#pragma unroll
  for (int k = 0; k < FP_WORDS; ++k) s[k] = z[0][FP_WORDS + k];
  fp_reduce_once(r, s, top);
}

// r = a + b mod p: the sum (below 2p < 2^382, no carry out), then one
// conditional subtraction.
__device__ __forceinline__ void fp_add(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t b[FP_WORDS]) {
  uint32_t s[FP_WORDS];
  fp_copy(s, a);
  asm(FP_ASM_ADD12 : FP_RW12(s) : FP_R12(b));
  fp_reduce_once(r, s, 0);
}

// r = a - b mod p: the difference, then p added under the borrow's mask
// (the sum wraps past 2^384 exactly then, into (0, p)).
__device__ __forceinline__ void fp_sub(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS],
                                       const uint32_t b[FP_WORDS]) {
  uint32_t d[FP_WORDS], mask;
  fp_copy(d, a);
  asm(FP_ASM_SUB12 : FP_RW12(d), "=r"(mask) : FP_R12(b));
  asm(FP_ASM_ADD_P_MASKED : FP_RW12(d) : "r"(mask));
  fp_copy(r, d);
}

// r = -a mod p (0 stays 0): (p & mask) - a, mask all ones for a != 0.
__device__ __forceinline__ void fp_neg(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS]) {
  const uint32_t mask = fp_is_zero(a) ? 0u : 0xffffffffu;
  asm(FP_ASM_NEG_MASKED : FP_W12(r) : FP_R12(a), "r"(mask));
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
//
// Where the carries go. The product rows and the reduction's steps keep
// the value in two accumulators at absolute word positions (z[0], z[1]
// above), each a nonnegative part of it, so neither has a nonzero word
// past the value's top. In row or step i the chains reach position i + 13
// at most, and the value so far is below 2^(32 (i + 13)): in fp_mul_wide
// below 2^(32 (i + 1)) a with a < p < 2^381; in fp_mac_wide that plus T's
// low words (< 2^384); in fp_redc_wide T's low words plus m p 2^(32 j)
// for j <= i (< 2^384 + 2^(32 i + 413)); in fp_mul below 2^(32 i)
// (2p + 2^32 p). So no chain carries out. T's high words enter
// fp_redc_wide after its steps (no m depends on them) and fp_mac_wide at
// its end; those sums are the results, below 3p and 2^768.

// r = a * b in 24 words, schoolbook: 144 word products, a row of two
// chains for each word of b, the row's lowest position folded and final.
// a canonical, so the value past row i's positions stays below
// 2^(32 i + 32) a: no word past position i + 12 is nonzero.
__device__ __forceinline__ void fp_mul_wide(uint32_t r[FP_WIDE], const uint32_t a[FP_WORDS],
                                            const uint32_t b[FP_WORDS]) {
  uint32_t z[2][FP_WIDE + 1];
#pragma unroll
  for (int k = 0; k <= FP_WIDE; ++k) z[0][k] = z[1][k] = 0;
  asm(FP_ASM_HALF_MUL : FP_W12_AT(z[0], 0) : FP_EVEN6(a), "r"(b[0]));
  asm(FP_ASM_HALF_MUL : FP_W12_AT(z[1], 1) : FP_ODD6(a), "r"(b[0]));
  r[0] = z[0][0];
#pragma unroll
  for (int i = 1; i < FP_WORDS; ++i) {
    const int x = i & 1, y = x ^ 1;
    asm(FP_ASM_ROW : FP_RW13_AT(z[x], i) : FP_EVEN6(a), "r"(b[i]));
    asm(FP_ASM_FOLD_ROW : FP_RW13_AT(z[y], i + 1), "+r"(z[x][i]) : "r"(z[y][i]), FP_ODD6(a), "r"(b[i]));
    r[i] = z[x][i];
  }
  asm(FP_ASM_ADD12 : FP_RW12_AT(z[0], FP_WORDS) : FP_R12_AT(z[1], FP_WORDS));
#pragma unroll
  for (int k = 0; k < FP_WORDS; ++k) r[FP_WORDS + k] = z[0][FP_WORDS + k];
}

// t += x over 24 words (the caller's bound keeps the sum below 2^768): two
// chains of 12, the carry between them in a register.
__device__ __forceinline__ void fp_add_wide(uint32_t t[FP_WIDE], const uint32_t x[FP_WIDE]) {
  uint32_t c = 0;
  asm(FP_ASM_ADD12_CARRY : FP_RW12(t), "+r"(c) : FP_R12(x));
  asm(FP_ASM_ADD12_CARRY_IN : FP_RW12_AT(t, FP_WORDS) : FP_R12_AT(x, FP_WORDS), "r"(c));
}

// t += a * b (a canonical, t + a b < 2^768): fp_mul_wide's rows over T's
// low words, T's high words added at the end; no 24-word temporary.
__device__ __forceinline__ void fp_mac_wide(uint32_t t[FP_WIDE], const uint32_t a[FP_WORDS],
                                            const uint32_t b[FP_WORDS]) {
  uint32_t z[2][FP_WIDE + 1];
#pragma unroll
  for (int k = 0; k <= FP_WIDE; ++k) {
    z[0][k] = k < FP_WORDS ? t[k] : 0u;
    z[1][k] = 0;
  }
  asm(FP_ASM_ROW : FP_RW13_AT(z[0], 0) : FP_EVEN6(a), "r"(b[0]));
  asm(FP_ASM_HALF_MUL : FP_W12_AT(z[1], 1) : FP_ODD6(a), "r"(b[0]));
  t[0] = z[0][0];
#pragma unroll
  for (int i = 1; i < FP_WORDS; ++i) {
    const int x = i & 1, y = x ^ 1;
    asm(FP_ASM_ROW : FP_RW13_AT(z[x], i) : FP_EVEN6(a), "r"(b[i]));
    asm(FP_ASM_FOLD_ROW : FP_RW13_AT(z[y], i + 1), "+r"(z[x][i]) : "r"(z[y][i]), FP_ODD6(a), "r"(b[i]));
    t[i] = z[x][i];
  }
  asm(FP_ASM_ADD12 : FP_RW12_AT(t, FP_WORDS) : FP_R12_AT(z[0], FP_WORDS));
  asm(FP_ASM_ADD12 : FP_RW12_AT(t, FP_WORDS) : FP_R12_AT(z[1], FP_WORDS));
}

// r = T * 2^-384 mod p, canonical, for T < N p^2 with N <= 9 (SUBS = 1) or
// N <= 19 (SUBS = 2); see the bound above. Word-serial Montgomery
// reduction: 12 steps of m = t_i (-p^-1) mod 2^32, t += m p 2^(32 i),
// each an odd and an even chain over T's low words; m never depends on
// T's high words, so they are added after the steps. T is not written.
template <int SUBS>
__device__ __forceinline__ void fp_redc_wide(uint32_t r[FP_WORDS], uint32_t t[FP_WIDE]) {
  uint32_t z[2][FP_WIDE + 1], s[FP_WORDS], m;
#pragma unroll
  for (int k = 0; k <= FP_WIDE; ++k) {
    z[0][k] = k < FP_WORDS ? t[k] : 0u;
    z[1][k] = 0;
  }
  asm(FP_ASM_REDC_ODD_FIRST : FP_W12_AT(z[1], 1), "=r"(m) : "r"(z[0][0]));
  asm(FP_ASM_RED : FP_RW13_AT(z[0], 0) : "r"(m));
#pragma unroll
  for (int i = 1; i < FP_WORDS; ++i) {
    const int x = i & 1, y = x ^ 1;
    asm(FP_ASM_FOLD_RED : FP_RW13_AT(z[y], i + 1), "+r"(z[x][i]), "=r"(m) : "r"(z[y][i]));
    asm(FP_ASM_RED : FP_RW13_AT(z[x], i) : "r"(m));
  }
  uint32_t top = z[0][FP_WIDE] + z[1][FP_WIDE];
  asm(FP_ASM_ADD12_CARRY : FP_RW12_AT(z[0], FP_WORDS), "+r"(top) : FP_R12_AT(z[1], FP_WORDS));
  asm(FP_ASM_ADD12_CARRY : FP_RW12_AT(z[0], FP_WORDS), "+r"(top) : FP_R12_AT(t, FP_WORDS));
#pragma unroll
  for (int k = 0; k < FP_WORDS; ++k) s[k] = z[0][FP_WORDS + k];
  fp_reduce_once(r, s, top);
#pragma unroll
  for (int k = 1; k < SUBS; ++k) fp_reduce_once(r, r, 0);
}

// r = c ? x : y, branch-free.
__device__ __forceinline__ void fp_select(uint32_t r[FP_WORDS], bool c, const uint32_t x[FP_WORDS],
                                          const uint32_t y[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = c ? x[i] : y[i];
}

// r = 12 a in Fp, by additions (2a, 3a, 6a, 12a).
__device__ __forceinline__ void fp_mul12(uint32_t r[FP_WORDS], const uint32_t a[FP_WORDS]) {
  uint32_t t[FP_WORDS];
  fp_add(t, a, a);
  fp_add(t, t, a);
  fp_add(t, t, t);
  fp_add(r, t, t);
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
