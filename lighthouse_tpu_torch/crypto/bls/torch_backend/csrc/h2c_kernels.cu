// Hash-to-G2's maps onto the curve, one launch per call each, with plain C
// launchers (extern "C", bound from Python with ctypes). Every launcher
// runs on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().
//
// Both kernels read a constant operand of twelve Fp2 rows
// (`h2c._H2C_CONSTS`, Montgomery words): A, B, Z of the isogenous curve E'
// and SSWU, the x1 constants C1 = -B/A and C2 = B/(Z A), the isogeny's
// kernel point X0, 1/9 and -1/27 (the sign pin) in c0, then K14's folded
// T/9, U/9, T' = T/27 and U' = 2U/27 of the isogeny's T and U. Every
// value is canonical, so the arithmetic inside a formula is arranged
// freely: a power is one number, whatever the addition chain.
//
// K13 sswu_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/h2c.py:117 `sswu`, with
//   :102 `fp2_sqrt_candidate` inside it (and :95 `_fp2_pow_bits`); the
//   port's `h2c.sswu`, called once per verify on u0 and u1 of every set,
//   stacked (m = 2 S = 256 at S = 128).
//   Computes: per element u, the plain version's steps
//   (`h2c.sswu_composed`): u^2, Z u^2, t1 = (Z u^2)^2 + Z u^2, its inverse
//   with inv0 (tower.fp2_inv); x1 = C1 (1 + 1/t1), or C2 where t1 = 0;
//   x2 = Z u^2 x1; gx_j = x_j^3 + A x_j + B; the square-root candidate of
//   each gx_j (Adj-Rodriguez-Henriquez for p = 3 mod 4: a1 = x^((p-3)/4),
//   x0 = a1 x, alpha = a1 x0, cand = (alpha + 1)^((p-1)/2) x0, or u x0
//   where alpha = -1, a word compare); is_square = (y1^2 == gx1) picks
//   (x1, y1) or (x2, y2); y is negated where sgn0(u) != sgn0(y), sgn0 the
//   parity of the standard value (a product with 1 takes it out of
//   Montgomery form).
//   Design: four threads per element, eight elements a warp-sized block:
//   thread (j, c) takes candidate j and component c. The four run the
//   prologue up to gx_j side by side in one instruction stream (the
//   inversion, fp384.cuh's fixed-count binary GCD, in every thread).
//   Each candidate's two powers (e = p >> 2 and p >> 1) run on a windowed
//   addition chain (`kSqrtChain`, sliding windows of at most 5 bits
//   generated from p: a table of the odd powers x .. x^31 in shared
//   memory, one square and 15 products, then 375 (376) squares and 66
//   products, 457 (458) steps where binary square and multiply took 605
//   (607)); every Fp2 square and product is split over the thread pair,
//   thread c forming component c as one lazy sum (g2.cuh `fp2_sqr_part`,
//   `fp2_mul_part`) and taking the other component from its partner with
//   `__shfl_xor_sync`; the two candidates run side by side. A power is
//   one integer whatever its chain, and every value is canonical, so the
//   words are the plain version's (its 4-bit windows). Then the
//   candidates and gx1 are exchanged between the pairs, and the four
//   threads select, fix the sign, and store a component of x or y each.
//   Shared memory: a pair's table of 16 Fp2 (1,536 bytes), 24,576 bytes
//   a block. Splitting each component's product by rows over four lanes
//   (128 blocks at m = 256) was bit-identical and slower on the card,
//   2.11 ms against the pair's 1.88 (PERF.md).
//   Work per element, in the word products the function needs (an Fp2
//   product 744, an Fp2 square 600, an Fp product 300, an Fp square 234,
//   a reduction alone 156; products by small constants, Z = -(2 + u) and
//   A = 240 u among them, are additions; each power on the cheaper of the
//   plain version's 4-bit windows and 5-bit sliding windows, here the
//   sliding ones): u^2, (Z u^2)^2 1,200; the inversion (a norm of two
//   squares summed and reduced once 312, fp384.cuh's binary GCD 3,472,
//   two products) 4,384; x1, x2 1,488; two gx 2,688; two candidates of
//   574,560 (x^(p >> 2) 376 squares and 81 products, x^(p >> 1) 377 and
//   81, three products) 1,149,120; y1^2 600; sgn0 of u and y, four
//   reductions 624: 1,160,104, against 288 bytes moved
//   (u in, x and y out). Operations bound; at the verify path's 256
//   elements bound by one thread pair's chain of dependent Fp2 steps,
//   the two windowed powers' 915 (binary square and multiply took 1,212)
//   after the prologue's inversion.
//   Bound (reduction): every Fp2 component is a sum of N <= 2 products
//   below 2 p^2, one conditional subtraction (fp384.cuh: N <= 9), the norm
//   too.
// K14 iso3_map_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/h2c.py:146 `iso3_map`;
//   the port's `h2c.iso3_map`, called once per verify on SSWU's m points.
//   Computes: the plain version's function (`h2c.iso3_map_composed`):
//   d = x - X0, xo = (x + T/d + U/d^2) / 9, yo = y (1 - T/d^2 - 2U/d^3)
//   (-1/27); (xo, yo, 1), or the canonical infinity (0, 1, 0) where d = 0
//   (x is the kernel point X0). With the scalings folded into the
//   constants: xo = x (1/9) + (T/9) d^-1 + (U/9) d^-2 and yo = y (-1/27) +
//   V d^-2, V = y T' + y U' d^-1. Every value is canonical, so this
//   arrangement gives the plain version's words.
//   Design: a group of four lanes per element, eight elements a one-warp
//   block (32 blocks at m = 256); lane (j, c) takes part j and component
//   c. The group's Fp2 values lie in its slots in shared memory (864
//   bytes, 6,912 a block). Every step is one row of `kIsoLane`: lane
//   (j, c) forms component c of e_c f + a0 b0 (+ a1 b1) as one lazy sum
//   (g2.cuh `fp2_sum_part`, as wide as the step needs: `kIsoPairs`),
//   stores it in its slot, and a `__syncwarp` hands it to the group.
//   Step 0, before the inversion: y T' and y U'.
//   Then every lane forms d, the norm d0^2 + d1^2 (one lazy sum), its
//   inverse (fp384.cuh `fp_inv`, the binary GCD, in every lane: one
//   instruction stream, one GCD's time) and component c of d^-1. Step 1:
//   d^-2 (part 0) and V (part 1); step 2: xo (part 0) and yo (part 1),
//   stored as they come, part 0 also storing Z. Where the thread-per-
//   element kernel ran the inversion and eleven dependent products on one
//   thread, a lane runs one step, the GCD, then two steps. Lanes past
//   the end take the last element and store nothing.
//   Work per element, in the word products the function needs: the
//   inversion 4,384; d^2 600; six Fp2 products 4,464; four Fp products
//   by 1/9 and -1/27, 1,200: 10,648 (`chip_smoke.h2c_word_products`, the
//   bound), against 480 bytes moved (x, y in; X, Y, Z out). The kernel
//   does more: seven Fp2 products where the function needs d^2 and six
//   (y T', y U', d^-1 d^-1, y U' d^-1, (T/9) d^-1, (U/9) d^-2, V d^-2),
//   each lane each step at the step's widest sum (N = 3, 3, 5: 588, 588
//   and 876 word products) and every lane the norm (444), the GCD (3,472)
//   and a component of d^-1 (300): 6,268 a lane, 25,072 a group.
//   Operations bound; at 256 elements bound by one lane's chain, the GCD
//   and three steps.
//   Measured at m = 257 (NVIDIA H100 80GB HBM3, 700.00 W, device ms, each
//   form against another in turns in one call; PERF.md): the thread per
//   element 0.1273; this kernel 0.0811-0.0814. Forms timed and dropped:
//   every sum at N = 5 unrolled, 0.0878-0.0888; a routine a step, each as
//   wide as it needs, unrolled, 0.0934-0.0940 (three copies of the sum,
//   each run once: instruction fetches cost more than the products it
//   saved); every sum at N = 5 in the rolled loop, 0.0830-0.0841. The
//   inversion alone, a thread an element, takes 0.068
//   (`chip_probes/fp_inv_phases.py`): the floor of this design.
//   ptxas (sm_90a, CUDA 12.8): 126 registers, 192 bytes of stack
//   (fp_inv's call), no spills, 6,912 bytes of shared memory.
//   Bound (reduction): every step's sum N <= 5 products below p^2 (e f and
//   one or two Fp2 pairs), the norm N = 2; one conditional subtraction
//   (fp384.cuh: N <= 9).
//
// K32 fp2_sqrt_candidate_kernel
//   Replaces: jax_backend/h2c.py:102 `fp2_sqrt_candidate` (registered
//   h2c.fp2_sqrt_candidate) called on its own; the port's
//   `h2c.fp2_sqrt_candidate`.
//   Computes: K13's `sqrt_candidate` routine, the one that runs inside
//   K13 for both of SSWU's candidates (a1 = x^((p-3)/4), x0 = a1 x,
//   alpha = a1 x0, (alpha + 1)^((p-1)/2) x0, or u x0 where alpha = -1), so
//   the standalone launch and K13 cannot drift apart.
//   Design: a thread pair per element, sixteen elements a warp-sized
//   block, thread c forming component c of every square and product of
//   the two windowed power chains (`fp2_sqr_part`, `fp2_mul_part`, the
//   other component from its partner by `__shfl_xor_sync`; each pair's
//   table of odd powers in shared memory, 24,576 bytes a block); lanes
//   past the end take the last element, since every lane takes part in
//   the shuffles, and store nothing.
//   Work per element: the two powers (as K13 counts them) and three Fp2
//   products, 574,560 word products, against 192 bytes. Operations bound; a pair's chain of about 920 dependent
//   squares and products (two windowed powers) sets the time at any batch
//   up to a few thousand.
//   Bound (reduction): N <= 2 per component, one conditional subtraction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "g2.cuh"

namespace {

constexpr int kSswuThreads = 32;  // one warp a block
constexpr int kSswuPerBlock = kSswuThreads / 4;  // K13: two candidates an element, a thread pair each
constexpr int kSqrtPerBlock = kSswuThreads / 2;  // K32: one candidate
constexpr int kIsoThreads = 32;  // one warp a block
constexpr int kIsoLanes = 4;  // K14: an element's lane group
constexpr int kIsoPerBlock = kIsoThreads / kIsoLanes;
constexpr int kFp2Words = 2 * FP_WORDS;
enum Const { kConstA, kConstB, kConstZ, kConstC1, kConstC2, kConstX0, kConstInv9, kConstInv27, kConstT9, kConstU9,
             kConstYT, kConstYU };

__device__ __forceinline__ void fp2_load(fp2_t r, const uint32_t* src) {
  fp_load(r[0], src);
  fp_load(r[1], src + FP_WORDS);
}

__device__ __forceinline__ void fp2_store(uint32_t* dst, const fp2_t a) {
  fp_store(dst, a[0]);
  fp_store(dst + FP_WORDS, a[1]);
}

// acc = {component c: r, component 1 - c: the partner's r}, the partner
// being the other thread of the pair.
__device__ __forceinline__ void join_parts(fp2_t acc, const uint32_t r[FP_WORDS], int c) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, r[i], 1);
    acc[0][i] = c ? o : r[i];
    acc[1][i] = c ? r[i] : o;
  }
}

// The two powers of the square-root candidate, x^(p >> 2) = x^((p - 3) / 4)
// and x^(p >> 1) = x^((p - 1) / 2), as sliding windows of at most 5 bits
// over the exponent, MSB first, generated from p (and held to it:
// tests/test_torch_miller_h2c_kernels.py folds each row back into its
// exponent). Entry k: {squares, d}, the squares before the window's
// product by x^d (d odd, table row d >> 1); entry 0 starts the chain at
// x^d, and the last entry holds the trailing squares (d = 0: no product).
// 67 windows each: 375 (376) squares and 66 products, after the table's
// one square and 15 products; binary square and multiply took 378 (379)
// and 227 (228).
constexpr int kChainEntries = 68;
constexpr int kChainRows = 16;  // x, x^3, ..., x^31
static __constant__ uint8_t kSqrtChain[2][kChainEntries][2] = {
    // x^(p >> 2)
    {{0, 13}, {13, 17}, {7, 15}, {4, 5}, {6, 7}, {7, 23}, {5, 31}, {5, 25}, {3, 5}, {6, 13}, {6, 9}, {3, 3},
     {8, 27}, {3, 5}, {6, 15}, {6, 27}, {3, 1}, {8, 13}, {7, 23}, {5, 11}, {6, 13}, {6, 29}, {4, 9}, {8, 29},
     {4, 13}, {7, 23}, {9, 19}, {5, 25}, {2, 3}, {7, 5}, {7, 9}, {6, 23}, {5, 29}, {5, 19}, {5, 19}, {8, 13},
     {7, 21}, {9, 15}, {5, 13}, {3, 3}, {8, 15}, {3, 3}, {7, 9}, {9, 15}, {6, 21}, {6, 31}, {5, 31}, {5, 31},
     {4, 13}, {3, 3}, {8, 21}, {7, 31}, {5, 31}, {5, 31}, {4, 15}, {4, 7}, {7, 31}, {5, 29}, {5, 31}, {5, 31},
     {5, 31}, {5, 31}, {5, 31}, {5, 31}, {4, 13}, {6, 21}, {4, 5}, {1, 0}},
    // x^(p >> 1)
    {{0, 13}, {13, 17}, {7, 15}, {4, 5}, {6, 7}, {7, 23}, {5, 31}, {5, 25}, {3, 5}, {6, 13}, {6, 9}, {3, 3},
     {8, 27}, {3, 5}, {6, 15}, {6, 27}, {3, 1}, {8, 13}, {7, 23}, {5, 11}, {6, 13}, {6, 29}, {4, 9}, {8, 29},
     {4, 13}, {7, 23}, {9, 19}, {5, 25}, {2, 3}, {7, 5}, {7, 9}, {6, 23}, {5, 29}, {5, 19}, {5, 19}, {8, 13},
     {7, 21}, {9, 15}, {5, 13}, {3, 3}, {8, 15}, {3, 3}, {7, 9}, {9, 15}, {6, 21}, {6, 31}, {5, 31}, {5, 31},
     {4, 13}, {3, 3}, {8, 21}, {7, 31}, {5, 31}, {5, 31}, {4, 15}, {4, 7}, {7, 31}, {5, 29}, {5, 31}, {5, 31},
     {5, 31}, {5, 31}, {5, 31}, {5, 31}, {4, 13}, {6, 21}, {6, 21}, {0, 0}},
};

// r = x^(p >> 2) (which = 0) or x^(p >> 1) (which = 1), 0 -> 0, on a
// thread pair (thread c forms component c of every square and product,
// g2.cuh `fp2_sqr_part` / `fp2_mul_part`, joined by `__shfl_xor_sync`),
// on kSqrtChain[which]: first the odd powers x, x^3, ..., x^31 into the
// pair's table `tab` (shared memory; thread c writes component c of each
// row), then the windows. Every thread of the warp runs the same chain.
__device__ __noinline__ void fp2_pow_chain(fp2_t r, const fp2_t x, int which, fp2_t* tab, int c) {
  fp2_t acc, x2;
  uint32_t part[FP_WORDS];
  __syncwarp();  // the pair's reads of the table's last use are done
  fp2_sqr_part(part, x, c);
  join_parts(x2, part, c);
  fp2_copy(acc, x);
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) tab[0][c][i] = c ? x[1][i] : x[0][i];
#pragma unroll 1
  for (int k = 1; k < kChainRows; ++k) {
    fp2_mul_part(part, acc, x2, c);
    join_parts(acc, part, c);
    fp_store(tab[k][c], part);
  }
  __syncwarp();
  const uint8_t(*chain)[2] = kSqrtChain[which];
  fp2_load(acc, (const uint32_t*)tab[chain[0][1] >> 1]);
#pragma unroll 1
  for (int k = 1; k < kChainEntries; ++k) {
    const int squares = chain[k][0], d = chain[k][1];
#pragma unroll 1
    for (int i = 0; i < squares; ++i) {
      fp2_sqr_part(part, acc, c);
      join_parts(acc, part, c);
    }
    if (d != 0) {
      fp2_load(x2, (const uint32_t*)tab[d >> 1]);
      fp2_mul_part(part, acc, x2, c);
      join_parts(acc, part, c);
    }
  }
  fp2_copy(r, acc);
}

// The square-root candidate of x (h2c.fp2_sqrt_candidate), on a thread
// pair, with its table `tab`.
__device__ __forceinline__ void sqrt_candidate(fp2_t r, const fp2_t x, fp2_t* tab, int c) {
  fp2_t a1, x0, alpha, b, m1;
  fp2_pow_chain(a1, x, 0, tab, c);  // x^((p-3)/4)
  fp2_mul(x0, a1, x);
  fp2_mul(alpha, a1, x0);
  fp_add(b[0], alpha[0], FP_ONE);
  fp_copy(b[1], alpha[1]);
  fp2_pow_chain(b, b, 1, tab, c);  // (alpha + 1)^((p-1)/2)
  fp2_mul(r, b, x0);
  fp_neg(m1[0], FP_ONE);
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) m1[1][i] = 0u;
  const bool is_m1 = fp2_eq(alpha, m1);
  fp_neg(b[0], x0[1]);  // u x0 = (-x0_1, x0_0)
  fp_select(r[0], is_m1, b[0], r[0]);
  fp_select(r[1], is_m1, x0[0], r[1]);
}

// Component c of a into dst (component c's words).
__device__ __forceinline__ void store_part(uint32_t* dst, const fp2_t a, int c) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) dst[i] = c ? a[1][i] : a[0][i];
}

// RFC 9380 sgn0 of an Fp2 element: the parity of the standard values.
__device__ __forceinline__ bool fp2_sgn0(const fp2_t a) {
  uint32_t one[FP_WORDS], s0[FP_WORDS], s1[FP_WORDS];
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) one[i] = i == 0;
  fp_mul(s0, a[0], one);
  fp_mul(s1, a[1], one);
  return (s0[0] & 1u) | (fp_is_zero(a[0]) & (s1[0] & 1u));
}

__global__ void __launch_bounds__(kSswuThreads) sswu_kernel(const uint32_t* __restrict__ u_in, long long su,
                                                            const uint32_t* __restrict__ cst,
                                                            uint32_t* __restrict__ out, long long n) {
  __shared__ fp2_t tabs[2 * kSswuPerBlock][kChainRows];
  const int lane = threadIdx.x;
  const int c = lane & 1, j = (lane >> 1) & 1;
  const long long e0 = (long long)blockIdx.x * kSswuPerBlock + lane / 4;
  const bool live = e0 < n;
  const long long e = live ? e0 : n - 1;  // every lane takes part in the shuffles

  fp2_t u, zu2, t1, x1, x2, xj, gx, k;
  fp2_load(u, u_in + e * su);
  fp2_mul(t1, u, u);
  fp2_load(k, cst + kConstZ * kFp2Words);
  fp2_mul(zu2, k, t1);
  fp2_mul(t1, zu2, zu2);
  fp2_add(t1, t1, zu2);
  const bool t1_zero = fp2_is_zero(t1);
  fp2_inv(t1, t1);
  fp_add(t1[0], t1[0], FP_ONE);
  fp2_load(k, cst + kConstC1 * kFp2Words);
  fp2_mul(x1, k, t1);
  fp2_load(k, cst + kConstC2 * kFp2Words);
  fp2_select(x1, t1_zero, k, x1);
  fp2_mul(x2, zu2, x1);
  // gx_j = x_j^3 + A x_j + B
  fp2_select(xj, j == 1, x2, x1);
  fp2_mul(gx, xj, xj);
  fp2_mul(gx, gx, xj);
  fp2_load(k, cst + kConstA * kFp2Words);
  fp2_mul(t1, k, xj);
  fp2_add(gx, gx, t1);
  fp2_load(k, cst + kConstB * kFp2Words);
  fp2_add(gx, gx, k);

  fp2_t y, other, gx1;
  sqrt_candidate(y, gx, tabs[lane / 2], c);
  // the other candidate's root and gx (lane ^ 2)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < FP_WORDS; ++i) {
      other[h][i] = __shfl_xor_sync(0xffffffffu, y[h][i], 2);
      gx1[h][i] = __shfl_xor_sync(0xffffffffu, gx[h][i], 2);
    }
  }
  fp2_select(gx1, j == 0, gx, gx1);
  fp2_t y1, y2;
  fp2_select(y1, j == 0, y, other);
  fp2_select(y2, j == 0, other, y);
  fp2_mul(t1, y1, y1);
  const bool is_sq = fp2_eq(t1, gx1);
  fp2_select(xj, is_sq, x1, x2);
  fp2_select(y, is_sq, y1, y2);
  if (fp2_sgn0(u) != fp2_sgn0(y)) fp2_neg(y, y);
  // thread (j, c) stores component c of x (j = 0) or y (j = 1)
  if (live) store_part(out + (j * n + e) * kFp2Words + c * FP_WORDS, j == 0 ? xj : y, c);
}

// K14: lane (j, c) of element g's group takes part j and component c. A
// group's Fp2 values lie in its slots in shared memory; a slot number at or
// past kSlotCst names row (number - kSlotCst) of the constant operand.
enum IsoSlot { kSlotX, kSlotY, kSlotD1, kSlotD2, kSlotV, kSlotYT, kSlotYU, kSlotZero, kSlotOne, kIsoSlots };
constexpr int kSlotOut = 15;  // the last step's result: coordinate j of the output
constexpr int kSlotCst = 16;
constexpr int kIsoSteps = 3;
// The Fp2 pairs of each step's sum: N = 2 kIsoPairs[s] + 1 products.
static __constant__ uint8_t kIsoPairs[kIsoSteps] = {1, 1, 2};
// Step s, part j: {out, e, f, a0, b0, a1, b1}: lane (j, c) forms component
// c of e_c f_0 + a0 b0 (+ a1 b1 where the step has two pairs; else both
// kSlotZero) as one lazy sum (g2.cuh `fp2_sum_part`) and stores it in slot
// `out`. Step 0 runs before the inversion, steps 1 and 2 after it, with
// d^-1 in kSlotD1.
static __constant__ uint8_t kIsoLane[kIsoSteps][2][7] = {
    // y T' and y U' (T' = T / 27, U' = 2U / 27)
    {{kSlotYT, kSlotZero, kSlotZero, kSlotY, kSlotCst + kConstYT, kSlotZero, kSlotZero},
     {kSlotYU, kSlotZero, kSlotZero, kSlotY, kSlotCst + kConstYU, kSlotZero, kSlotZero}},
    // d^-2, and V = y T' + y U' d^-1
    {{kSlotD2, kSlotZero, kSlotZero, kSlotD1, kSlotD1, kSlotZero, kSlotZero},
     {kSlotV, kSlotYT, kSlotOne, kSlotYU, kSlotD1, kSlotZero, kSlotZero}},
    // xo = x (1/9) + (T/9) d^-1 + (U/9) d^-2, yo = y (-1/27) + V d^-2
    {{kSlotOut, kSlotX, kSlotCst + kConstInv9, kSlotCst + kConstT9, kSlotD1, kSlotCst + kConstU9, kSlotD2},
     {kSlotOut, kSlotY, kSlotCst + kConstInv27, kSlotV, kSlotD2, kSlotZero, kSlotZero}},
};

__device__ __forceinline__ const uint32_t* iso_slot(int s, const uint32_t* group, const uint32_t* cst) {
  return s >= kSlotCst ? cst + (s - kSlotCst) * kFp2Words : group + s * kFp2Words;
}

// Lane (j, c)'s share of step s (kIsoLane), stored in its slot unless it
// is the output; returns it in r. One routine for the three steps.
__device__ __noinline__ void iso_step(uint32_t r[FP_WORDS], int s, int j, int c, uint32_t* group,
                                      const uint32_t* cst) {
  const uint8_t* t = kIsoLane[s][j];
  fp2_sum_part(r, iso_slot(t[1], group, cst) + c * FP_WORDS, iso_slot(t[2], group, cst), iso_slot(t[3], group, cst),
               iso_slot(t[4], group, cst), iso_slot(t[5], group, cst), iso_slot(t[6], group, cst), kIsoPairs[s], c);
  if (t[0] != kSlotOut) fp_store(group + t[0] * kFp2Words + c * FP_WORDS, r);
}

__global__ void __launch_bounds__(kIsoThreads) iso3_map_kernel(const uint32_t* __restrict__ x_in, long long sx,
                                                               const uint32_t* __restrict__ y_in, long long sy,
                                                               const uint32_t* __restrict__ cst,
                                                               uint32_t* __restrict__ out, long long n) {
  __shared__ uint32_t slots[kIsoPerBlock][kIsoSlots * kFp2Words];
  const int lane = threadIdx.x, g = lane / kIsoLanes, j = (lane >> 1) & 1, c = lane & 1;
  const long long e0 = (long long)blockIdx.x * kIsoPerBlock + g;
  const bool live = e0 < n;
  const long long e = live ? e0 : n - 1;  // every lane takes part in the steps
  uint32_t* group = slots[g];
  uint32_t w[FP_WORDS], r[FP_WORDS];
  // lane (j, c): component c of x (j = 0) or y (j = 1), and of zero or one
  fp_load(w, (j == 0 ? x_in + e * sx : y_in + e * sy) + c * FP_WORDS);
  fp_store(group + (j == 0 ? kSlotX : kSlotY) * kFp2Words + c * FP_WORDS, w);
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) w[i] = j == 1 && c == 0 ? FP_ONE[i] : 0u;
  fp_store(group + (j == 0 ? kSlotZero : kSlotOne) * kFp2Words + c * FP_WORDS, w);
  __syncwarp();
  iso_step(r, 0, j, c, group, cst);
  // d = x - X0 and component c of d^-1 = conj(d) / (d0^2 + d1^2), 0 -> 0,
  // in every lane (one instruction stream: one GCD's time)
  fp2_t d, k;
  fp2_load(d, group + kSlotX * kFp2Words);
  fp2_load(k, cst + kConstX0 * kFp2Words);
  fp2_sub(d, d, k);
  const bool kernel_point = fp2_is_zero(d);
  uint32_t t[FP_WIDE];
  fp_mul_wide(t, d[0], d[0]);
  fp_mac_wide(t, d[1], d[1]);
  fp_redc_wide<1>(w, t);
  fp_inv(w, w);
  fp_select(k[0], c == 1, d[1], d[0]);
  fp_mul(r, k[0], w);
  fp_neg(w, r);
  fp_select(r, c == 1, w, r);
  if (j == 0) fp_store(group + kSlotD1 * kFp2Words + c * FP_WORDS, r);
  __syncwarp();
  iso_step(r, 1, j, c, group, cst);
  __syncwarp();
  iso_step(r, 2, j, c, group, cst);
  if (!live) return;
  // (xo, yo, 1), or (0, 1, 0) at the kernel point
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    const uint32_t one = c == 0 ? FP_ONE[i] : 0u;
    r[i] = kernel_point ? (j == 1 ? one : 0u) : r[i];
    w[i] = kernel_point ? 0u : one;
  }
  fp_store(out + (j * n + e) * kFp2Words + c * FP_WORDS, r);
  if (j == 0) fp_store(out + (2 * n + e) * kFp2Words + c * FP_WORDS, w);
}

__global__ void __launch_bounds__(kSswuThreads) fp2_sqrt_candidate_kernel(const uint32_t* __restrict__ x_in,
                                                                          long long sx, uint32_t* __restrict__ out,
                                                                          long long n) {
  __shared__ fp2_t tabs[kSqrtPerBlock][kChainRows];
  const int lane = threadIdx.x;
  const int c = lane & 1;
  const long long e0 = (long long)blockIdx.x * kSqrtPerBlock + lane / 2;
  const bool live = e0 < n;
  const long long e = live ? e0 : n - 1;  // every lane takes part in the shuffles
  fp2_t x, r;
  fp2_load(x, x_in + e * sx);
  sqrt_candidate(r, x, tabs[lane / 2], c);
  if (live) store_part(out + e * kFp2Words + c * FP_WORDS, r, c);
}

}  // namespace

extern "C" {

int lh_sswu(const void* u, long long su, const void* cst, void* out, long long n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kSswuPerBlock - 1) / kSswuPerBlock);
    sswu_kernel<<<blocks, kSswuThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)u, su, (const uint32_t*)cst,
                                                                   (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_iso3_map(const void* x, long long sx, const void* y, long long sy, const void* cst, void* out, long long n,
                void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kIsoPerBlock - 1) / kIsoPerBlock);
    iso3_map_kernel<<<blocks, kIsoThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)x, sx, (const uint32_t*)y, sy,
                                                                      (const uint32_t*)cst, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp2_sqrt_candidate(const void* x, long long sx, void* out, long long n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kSqrtPerBlock - 1) / kSqrtPerBlock);
    fp2_sqrt_candidate_kernel<<<blocks, kSswuThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)x, sx,
                                                                                 (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
