// The whole final exponentiation, one launch per call, and standalone
// launches of two of its block routines, with plain C launchers (extern
// "C", bound from Python with ctypes). Each launcher runs on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// K19 final_exponentiation_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/pairing.py:263
//   `final_exponentiation` (registered pairing.final_exponentiation), with
//   :210 `frobenius`, :257 `_pow_x_minus_1`, :239 `_pow_abs_x` (five
//   times) and tower.py:546 `fp12_inv` (with :100 `fp2_inv`) inside it: the
//   port's `pairing.final_exponentiation`, once per verify on the product
//   of the Miller values (n = 1), and once per rank of a sharded verify.
//   Computes: f^((p^12 - 1) / r * 3) for tower-layout Fp12 f, by the plain
//   version's steps (`pairing.final_exponentiation_plain`, the ref
//   oracle's decomposition): F = conj(f) f^-1, F = F^(p^2) F; a = h(h(F))
//   with h(g) = g^(z - 1) = conj(g^|z| g); b = conj(a^|z|) a^p;
//   c = (b^|z|)^|z| b^(p^2) conj(b); the result c F (F F). The five
//   |z|-power chains are K9's routine (final_exp.cuh
//   `cyclotomic_pow_x_block`, formula for formula: for an input off the
//   cyclotomic subgroup, f = 0 for one, its output depends on the
//   formulas). f^-1 follows the plain version's norm chain
//   (`tower.fp12_inv`): N = a conj(a), phi(N) and phi^2(N) by the Fp
//   scalars of `tower._PHI_SCALARS`, G = phi(N) phi^2(N), M = N G (its w^0
//   coefficient, an Fp2), a^-1 = (conj(a) G) M^-1 with g2.cuh `fp2_inv`;
//   a zero M maps to zero (inv0), so f = 0 gives the plain version's
//   integers too. Every other value is canonical, so the arithmetic inside
//   a product, a Frobenius map or a conjugation is free.
//   Operands: f with its element stride in words (0: one element
//   broadcast); the constants (`pairing._FE_CONSTS`: the Frobenius gammas
//   by flat coefficient and component, then the phi and phi^2 scalars by
//   flat coefficient, 24 Fp rows); out, contiguous.
//   Design: one block (one warp) per element, the state in shared memory
//   (K9's checkpoints and decompression, 9.6 KB, and seven Fp12 slots, 4
//   KB). Each step is a block routine that ends in __syncthreads: a chain
//   is K9's (its squarings in registers, final_exp.cuh); a product is K8's
//   24-lane routine (tower.cuh `fp12_mul_pairs`, one call site here, so
//   K30 runs it too); a conjugation
//   twelve threads, one Fp component each; a Frobenius map twelve threads,
//   thread 2k + c forming component c of conj(f_k) gamma_k (g2.cuh
//   `fp2_mul_part`); phi(N) and phi^2(N) 24 threads, one Fp product each;
//   the Fp2 inversion one thread (fp384.cuh `fp_inv`, the binary GCD).
//   The routines stay `__noinline__`: one copy of each, as K9's and K17's.
//   Work per element, in the word products the function needs (an Fp12
//   product 17,424, an Fp2 product 744, an Fp product 300): five K9
//   chains of 374,164; fourteen Fp12 products (ten, and fp12_inv's four);
//   five Frobenius maps of six Fp2 products; phi(N) and phi^2(N), eight Fp
//   products (N lies in Fp6); the Fp2 inversion, 4,384 (its norm 312,
//   fp384.cuh's binary GCD 3,472, two products); the product by M^-1,
//   six Fp2 products: 2,148,324, against
//   2,304 bytes (f in, the result out, the constants). Operations bound;
//   one element (the verify path) is bound by the chains: the five |z|
//   chains' 315 squarings, six inversions (fp384.cuh's binary GCD, one
//   thread's time each) and the rest one after the other on one warp.
//   Bound (reduction): K9's and K8's (fp384.cuh: a lane pair's Fp2
//   component N = 2, doubled N = 4, one subtraction; a lane pair's Fp12
//   component N = 12, two); the Frobenius and M^-1 products K7's N = 2.
//
// K30 fp12_inv_kernel / K31 frobenius_kernel
//   Replace: jax_backend/tower.py:546 `fp12_inv` (registered
//   tower.fp12_inv) and jax_backend/pairing.py:210 `frobenius` (registered
//   pairing.frobenius) called on their own; the port's `tower.fp12_inv`
//   and `pairing.frobenius`.
//   Computes: K19's `fp12_inv_block` and `frobenius_block` on one element,
//   the routines that run inside K19, so the standalone launches and K19
//   cannot drift apart (zero maps to zero in the inversion, inv0).
//   Operands: a with its element stride in words (0: broadcast); K30 the
//   phi and phi^2 scalars (`tower._PHI_SCALARS`, K19's constants from row
//   12), K31 the gammas (`pairing._FE_CONSTS`, its first 12 rows); out,
//   contiguous.
//   Design: one block (one warp) per element, as K19; the inversion's
//   scratch (five Fp12 slots and M^-1, 2.9 KB) in shared memory.
//   Work per element, in the word products the function needs: K30 four
//   Fp12 products, eight Fp products, the Fp2 inversion (4,384) and six
//   Fp2 products, 80,944, against 1,728 bytes (a in, out, the phi
//   scalars); one warp's chain of dependent steps sets its time. K31 six Fp2 products, 4,464, against 1,728
//   bytes (a in, out, the gammas).

#include <cuda_runtime.h>
#include <stdint.h>

#include "final_exp.cuh"

namespace {

constexpr int kFinalExpThreads = 32;  // one warp per element
constexpr int kSlots = 7;             // Fp12 values in shared memory
constexpr int kGammaRows = 12;        // consts: gammas (6 Fp2), then phi, phi^2 (6 Fp each)

struct FinalExpShared {
  PowXShared pow;
  uint32_t v[kSlots][kFp12Words];
  uint32_t minv[2 * FP_WORDS];
};

// out = a b (K8's routine, tower.cuh `fp12_mul_pairs`, on the block's
// warp). out may overlap a or b.
__device__ __noinline__ void fp12_mul_block(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  fp12_mul_pairs(a, b, kFull, out);
  __syncthreads();
}

// out = conj(a): Fp component i = 6 w + 2 v + c of the tower layout,
// negated where w = 1. out may be a.
__device__ __noinline__ void fp12_conj_block(const uint32_t* a, uint32_t* out) {
  const int i = threadIdx.x;
  if (i < 12) {
    uint32_t x[FP_WORDS];
    fp_load(x, a + i * FP_WORDS);
    if (i >= 6) fp_neg(x, x);
    fp_store(out + i * FP_WORDS, x);
  }
  __syncthreads();
}

// out = a^p: thread 2k + c forms component c of conj(a_k) gamma_k for flat
// coefficient k. out must not overlap a.
__device__ __noinline__ void frobenius_block(const uint32_t* a, uint32_t* out, const uint32_t* gammas) {
  const int t = threadIdx.x;
  if (t < 12) {
    const int k = t >> 1, c = t & 1;
    fp2_t x, g;
    uint32_t r[FP_WORDS];
    fp2_load(x, a + tower_offset(k));
    fp_neg(x[1], x[1]);
    fp2_load(g, gammas + k * kFp2Words);
    fp2_mul_part(r, x, g, c);
    fp_store(out + tower_offset(k) + c * FP_WORDS, r);
  }
  __syncthreads();
}

// out = a^-1 by the norm chain (see the header); zero maps to zero. s:
// five scratch slots; minv: M^-1; phi: the phi, then the phi^2 scalars by
// flat coefficient. out must not overlap a or the scratch.
__device__ __noinline__ void fp12_inv_block(const uint32_t* a, uint32_t* out, uint32_t (*s)[kFp12Words],
                                            uint32_t* minv, const uint32_t* phi) {
  const int t = threadIdx.x;
  fp12_conj_block(a, s[0]);      // conj(a)
  fp12_mul_block(a, s[0], s[1]);  // N, in Fp6
  if (t < 24) {                  // s[2] = phi(N), s[3] = phi^2(N), one Fp component a thread
    const int j = t / 12, i = t % 12;
    const int k = 2 * ((i >> 1) % 3) + i / 6;  // flat coefficient of component i = 6 w + 2 v + c
    uint32_t x[FP_WORDS], m[FP_WORDS];
    fp_load(x, s[1] + i * FP_WORDS);
    fp_load(m, phi + (6 * j + k) * FP_WORDS);
    fp_mul(x, x, m);
    fp_store(s[2 + j] + i * FP_WORDS, x);
  }
  __syncthreads();
  fp12_mul_block(s[2], s[3], s[4]);  // G = phi(N) phi^2(N)
  fp12_mul_block(s[1], s[4], s[2]);  // M = N G, in Fp2: its w^0 coefficient
  if (t == 0) {
    fp2_t m;
    fp2_load(m, s[2] + tower_offset(0));
    fp2_inv(m, m);
    fp2_store(minv, m);
  }
  __syncthreads();
  fp12_mul_block(s[0], s[4], s[3]);  // conj(a) G
  if (t < 12) {                      // times M^-1: component c of coefficient k
    const int k = t >> 1, c = t & 1;
    fp2_t x, m;
    uint32_t r[FP_WORDS];
    fp2_load(x, s[3] + tower_offset(k));
    fp2_load(m, minv);
    fp2_mul_part(r, x, m, c);
    fp_store(out + tower_offset(k) + c * FP_WORDS, r);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kFinalExpThreads) final_exponentiation_kernel(const uint32_t* __restrict__ f,
                                                                                long long sf,
                                                                                const uint32_t* __restrict__ consts,
                                                                                uint32_t* __restrict__ out,
                                                                                long long n) {
  __shared__ FinalExpShared sh;
  const long long e = blockIdx.x;
  if (e >= n) return;
  const uint32_t* gammas = consts;
  const uint32_t* phi = consts + kGammaRows * FP_WORDS;
  uint32_t(*v)[kFp12Words] = sh.v;
  for (int w = threadIdx.x; w < kFp12Words; w += blockDim.x) v[0][w] = f[e * sf + w];
  __syncthreads();

  // easy part: F = conj(f) f^-1, then F = F^(p^2) F, kept in v[0]
  fp12_inv_block(v[0], v[1], v + 2, sh.minv, phi);
  fp12_conj_block(v[0], v[2]);
  fp12_mul_block(v[2], v[1], v[3]);
  frobenius_block(v[3], v[4], gammas);
  frobenius_block(v[4], v[5], gammas);
  fp12_mul_block(v[5], v[3], v[0]);

  // a = g^(z - 1) of g = F^(z - 1), each conj(g^|z| g): v[3]
  cyclotomic_pow_x_block(v[0], v[1], sh.pow);
  fp12_mul_block(v[1], v[0], v[2]);
  fp12_conj_block(v[2], v[2]);
  cyclotomic_pow_x_block(v[2], v[1], sh.pow);
  fp12_mul_block(v[1], v[2], v[3]);
  fp12_conj_block(v[3], v[3]);

  // b = conj(a^|z|) a^p: v[4]
  cyclotomic_pow_x_block(v[3], v[1], sh.pow);
  fp12_conj_block(v[1], v[1]);
  frobenius_block(v[3], v[2], gammas);
  fp12_mul_block(v[1], v[2], v[4]);

  // c = ((b^|z|)^|z| b^(p^2)) conj(b): v[2]
  cyclotomic_pow_x_block(v[4], v[1], sh.pow);
  cyclotomic_pow_x_block(v[1], v[2], sh.pow);
  frobenius_block(v[4], v[3], gammas);
  frobenius_block(v[3], v[5], gammas);
  fp12_mul_block(v[2], v[5], v[1]);
  fp12_conj_block(v[4], v[4]);
  fp12_mul_block(v[1], v[4], v[2]);

  // c F (F F)
  fp12_mul_block(v[0], v[0], v[1]);
  fp12_mul_block(v[0], v[1], v[3]);
  fp12_mul_block(v[2], v[3], out + e * kFp12Words);
}

__global__ void __launch_bounds__(kFinalExpThreads) fp12_inv_kernel(const uint32_t* __restrict__ a, long long sa,
                                                                    const uint32_t* __restrict__ phi,
                                                                    uint32_t* __restrict__ out, long long n) {
  __shared__ uint32_t s[5][kFp12Words];
  __shared__ uint32_t minv[2 * FP_WORDS];
  const long long e = blockIdx.x;
  if (e >= n) return;
  fp12_inv_block(a + e * sa, out + e * kFp12Words, s, minv, phi);
}

__global__ void __launch_bounds__(kFinalExpThreads) frobenius_kernel(const uint32_t* __restrict__ a, long long sa,
                                                                     const uint32_t* __restrict__ consts,
                                                                     uint32_t* __restrict__ out, long long n) {
  const long long e = blockIdx.x;
  if (e >= n) return;
  frobenius_block(a + e * sa, out + e * kFp12Words, consts);
}

}  // namespace

extern "C" {

int lh_final_exponentiation(const void* f, long long sf, const void* consts, void* out, long long n, void* stream) {
  if (n > 0) {
    final_exponentiation_kernel<<<(unsigned)n, kFinalExpThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)f, sf, (const uint32_t*)consts, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp12_inv(const void* a, long long sa, const void* phi, void* out, long long n, void* stream) {
  if (n > 0) {
    fp12_inv_kernel<<<(unsigned)n, kFinalExpThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa, (const uint32_t*)phi, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_frobenius(const void* a, long long sa, const void* consts, void* out, long long n, void* stream) {
  if (n > 0) {
    frobenius_kernel<<<(unsigned)n, kFinalExpThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa, (const uint32_t*)consts, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
