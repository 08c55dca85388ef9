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
//   with one Fp inversion of their six denominators' norms shared by
//   Montgomery's trick, zero norms mapping to zero (inv0: the all-zero
//   compressed identity decompresses to one); then their product in
//   `product_reduce`'s pairing order, ((f0 f3)(f1 f4))(f2 f5). Every value
//   is canonical, so the output is the same integers as the plain
//   version's; the products by the small constants 6, 3 and 2 of
//   `karabina_sqr` are additions here.
//   Design: one block (one warp) per element, the state in shared memory;
//   the body is final_exp.cuh `cyclotomic_pow_x_block`, which K19 also
//   runs five times. A squaring's six Fp2 products (g2^2, g4^2, g3^2,
//   g5^2, g4 g5, g2 g3) go to twelve threads, a product's two components to two threads as in
//   K7, each a double-width sum of N = 2 products reduced once; then
//   eight threads form the four new coordinates' components by additions.
//   Six threads decompress the six checkpoints side by side; one thread
//   runs the shared inversion (fp384.cuh `fp_inv`, the binary GCD of 26
//   batches; chip_smoke.py's [timing] line sets K3 alone on the Fermat
//   chain of p - 2 beside this kernel's time); the product of
//   six is K8's six-thread routine (tower.cuh `fp12_mul_thread`), three
//   groups side by side for the tree's first level. Any leading batch
//   shape: a block per element.
//   Work per element, in the word products the function needs (a
//   Karatsuba Fp2 product 744, an Fp2 square 600, K1's product 300, an Fp
//   square 234, an Fp12 product 17,424): 63 squarings of 3,888, 244,944;
//   six decompressions of 5,688, 34,128; the shared inversion, 15
//   products and fp384.cuh's binary GCD (3,472), 7,972; the product of
//   six 87,120: 374,164, against 1,152 bytes moved (g in, g^|z| out).
//   Operations bound; one element (the verify path) is bound by the
//   chain: 63 squarings of one sum each (444 word products), the
//   inversion and three Fp12 products.
//   Bound (reduction): the squaring's and decompression's sums hold N = 2
//   products, T < 2 p^2, one conditional subtraction (fp384.cuh: N <= 9);
//   the Fp12 products K8's N = 12, two subtractions.

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
