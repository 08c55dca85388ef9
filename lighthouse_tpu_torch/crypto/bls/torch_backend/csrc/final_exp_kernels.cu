// The |z|-power chain of the final exponentiation, one launch per call,
// with a plain C launcher (extern "C", bound from Python with ctypes). The
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// K9 cyclotomic_pow_x_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/pairing.py:239
//   `_pow_abs_x` (registered pairing.pow_abs_x), with tower.py:401
//   `karabina_sqr` and :481 `karabina_decompress` inside it; the port's
//   `pairing.pow_abs_x`, called five times by `final_exponentiation` on
//   the single Fp12 of a verify (n = 1).
//   Computes: g^|z| for tower-layout Fp12 g (cyclotomic on the verify
//   path), by the plain version's steps: compress to (g2, g3, g4, g5) =
//   flat coefficients 1, 4, 2, 5; 63 Karabina squarings, keeping the
//   checkpoints g^(2^k) at the set bits k = 16, 48, 57, 60, 62, 63 of
//   |z|; decompress the six (g1 = (xi g5^2 + 3 g4^2 - 2 g3) / (4 g2), or
//   2 g4 g5 / g3 where g2 = 0; g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1)
//   with one Fp inversion shared by their six denominators' norms, zero
//   norms mapping to zero (inv0: the all-zero compressed identity
//   decompresses to one); then their product, ((f0 f3)(f1 f4))(f2 f5).
//   Every value is canonical, so the output is the same integers as the
//   plain version's whatever the formulas; the products by the small
//   constants 6, 3 and 2 of `karabina_sqr` are additions and a doubling
//   here.
//   Design: one block (one warp) per element; the body is final_exp.cuh
//   `cyclotomic_pow_x_block`, which K19 also runs five times. The 63
//   squarings run in registers on 24 lanes (`kPowLane`; lanes 24-31
//   repeat lanes 0-7): eight lanes keep the compressed state, an Fp
//   component each; a step's six Fp2 products (g2^2, g3^2, g4^2, g5^2,
//   g4 g5, g2 g3) take one 12 x 12 product a lane, each component's two
//   split over a lane pair whose double-width sums a shuffle adds (and
//   doubles, for g4 g5 and g2 g3) before one reduction; each keeper forms
//   its new component from its own product and at most two more taken by
//   `__shfl_sync` (x = xi's component of a square or a doubled product,
//   plus a square; 2 x + (x -+ 2 g), four levels of Fp additions), and
//   the product lanes take their next operands from the keepers by
//   shuffle. A lane's chain a step is one product, a shuffle of 24 words,
//   one reduction and four levels of additions, with no barrier, where
//   the six-thread form it replaced ran two products, two `__syncthreads`
//   and two shared-memory round trips. Only the six checkpoint steps store
//   the state to shared memory. The squares take the split products'
//   form: the first build, with fp2_sqr_part's one product a square's
//   component (sixteen lanes, the operands' sum and difference formed
//   first) and five levels of additions, took 2.65 us a step against
//   this form's 2.05 (`chip_probes/k9_chain_phases.py`, two calls,
//   PERF.md). Twelve lanes
//   (a checkpoint and a component each) decompress the six side by side,
//   each Fp2 product split over the lane pair as in K7 and the pair's
//   values exchanged by shuffle; the six norms' inverses come from a
//   product tree over the lanes (pair products, the other two pairs'
//   product, every norm but one's, their whole product: four products
//   before the inversion, one after, where Montgomery's trick on one
//   thread ran fifteen) and one inversion, which every lane runs on the
//   same value (fp384.cuh `fp_inv`, the binary GCD of 26 batches;
//   chip_smoke.py's [timing] line sets K3 alone on the Fermat chain of
//   p - 2 beside this kernel's time); the product of six is K8's routine
//   (tower.cuh `fp12_mul_pairs`, 24 lanes a product), five products one
//   after another on the warp. A block of three warps, the first level's
//   three products side by side, was built and timed in turns: the
//   product of six 23.0 us against 30.5, but the squarings 7.2 us slower
//   (246 registers against 220), K9 0.2811 against 0.2845 ms and K19
//   1.617 against 1.651 (PERF.md); not kept. Any leading batch shape: a
//   block per element.
//   Work per element, in the word products the function needs (a
//   Karatsuba Fp2 product 744, an Fp2 square 600, K1's product 300, an Fp
//   square 234, an Fp12 product 17,424): 63 squarings of 3,888, 244,944;
//   six decompressions of 5,688, 34,128; the shared inversion, 15
//   products and fp384.cuh's binary GCD (3,472), 7,972; the product of
//   six 87,120: 374,164, against 1,152 bytes moved (g in, g^|z| out).
//   Operations bound; one element (the verify path) is bound by the
//   chain: 63 squarings of one product and one reduction each (300 word
//   products a lane), the inversion and five Fp12 products.
//   Bound (reduction): a product half is N = 1 product, N = 2 after the
//   pair's add, N = 4 doubled, T < 4 p^2: one conditional subtraction
//   (fp384.cuh: N <= 9); the decompression's sums N <= 2, the same; the
//   Fp12 products K8's: a lane's half 6 products, N = 12 after the add,
//   two subtractions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "final_exp.cuh"

namespace {

__global__ void __launch_bounds__(kPowThreads) cyclotomic_pow_x_kernel(const uint32_t* __restrict__ g, long long sg,
                                                                       uint32_t* __restrict__ out, long long n) {
  __shared__ PowXShared sh;
  const long long e = blockIdx.x;
  if (e >= n) return;
  cyclotomic_pow_x_block(g + e * sg, out + e * kFp12Words, sh);
}

}  // namespace

extern "C" {

int lh_cyclotomic_pow_x(const void* g, long long sg, void* out, long long n, void* stream) {
  if (n > 0) {
    cyclotomic_pow_x_kernel<<<(unsigned)n, kPowThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)g, sg,
                                                                                   (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
