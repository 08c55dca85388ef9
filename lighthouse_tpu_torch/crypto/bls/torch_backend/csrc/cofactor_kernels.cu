// Hash-to-G2's cofactor clearing, one launch per call, with a plain C
// launcher (extern "C", bound from Python with ctypes). The launcher runs
// on the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().
//
// K17 clear_cofactor_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/h2c.py:189
//   `clear_cofactor` (registered h2c.clear_cofactor), together with
//   `map_to_g2`'s sum of the two SSWU points (h2c.py:216 in :208
//   `map_to_g2`, `jac_add(q0, q1)`): the port's `h2c.clear_cofactor(p, q)`,
//   once per verify on the S messages' isogeny outputs (K14's 2-stacked
//   q0, q1).
//   Computes, per element, by the plain version's steps
//   (`h2c.clear_cofactor_plain`): p = q0 + q1 (or p alone when no q is
//   given); psi(p); the two windowed multiplications [z^2 - z - 1] p and
//   [|z - 1|] psi(p) on K11's algorithm (curve.cuh `scalar_mul_point`;
//   the two rows of 128 public bits of `h2c._CC_BITS`, a byte a bit, 32
//   digits); the second negated (z - 1 < 0); t3 = psi(psi(2 p)); then
//   (t1 + t2) + t3. A projective coordinate is not unique, so every point
//   is formed by the plain version's formula and in its order (g2.cuh's
//   RCB Algorithms 7 and 9; psi(x, y, z) = (conj(x) CX, conj(y) CY,
//   conj(z)), CX and CY from `curve._PSI_C`, the constant operand). Every
//   value is canonical, so the arithmetic inside a formula is free.
//   Design: a thread pair per element, sixteen pairs (one warp) a block,
//   so the verify path's 128 elements spread over 8 SMs as K11's 256
//   elements did. Both threads form p; lane 0 forms t3 while lane 1 forms
//   psi(p); each then runs one multiplication chain (the two chains are
//   the same length: both bit rows have 128 bits, 32 digits); lane 1
//   negates its product and hands it to lane 0 through shared memory;
//   lane 0 forms the two additions and writes the element. One thread
//   per element would run both chains one after the other, twice as long.
//   The group routines stay `__noinline__` (curve.cuh), as in K11: full
//   inlining takes ptxas minutes.
//   Work per element, in the word products the function needs (an Fp2
//   product 744, a square 600, products by 3b are additions): the sum 12
//   products; psi 2 products each, three in all; the doubling 6 products
//   and 2 squares; two chains of 15 table additions and 32 digits of four
//   doublings and an addition (1,144,608 at 128 bits for both, as K11
//   counts them); the two final additions 24 products. Against 864 bytes
//   (q0, q1 in, the element out). Operations bound; at the verify path's
//   128 elements it is bound by one thread's chain of dependent products.
//   Bound (reduction): every Fp2 component is a lazy sum of N = 2 products
//   below 2 p^2, one conditional subtraction (fp384.cuh: N <= 9).

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace {

constexpr int kCofactorThreads = 32;  // a thread pair per element
constexpr int kPairs = kCofactorThreads / 2;

__global__ void __launch_bounds__(kCofactorThreads) clear_cofactor_kernel(
    const uint32_t* __restrict__ px, long long spx, const uint32_t* __restrict__ py, long long spy,
    const uint32_t* __restrict__ pz, long long spz, const uint32_t* __restrict__ qx, long long sqx,
    const uint32_t* __restrict__ qy, long long sqy, const uint32_t* __restrict__ qz, long long sqz, int sum,
    const uint32_t* __restrict__ psi_c, const uint8_t* __restrict__ bits, int nbits, uint32_t* __restrict__ out,
    long long n) {
  __shared__ G2Proj sh_t2[kPairs];
  const int pair = threadIdx.x >> 1, lane = threadIdx.x & 1;
  const long long e = (long long)blockIdx.x * kPairs + pair;
  const bool live = e < n;
  G2Proj p, t3, acc;
  if (live) {
    load_point<G2>(p, px + e * spx, py + e * spy, pz + e * spz);
    if (sum) {  // q in acc, which the chain overwrites
      load_point<G2>(acc, qx + e * sqx, qy + e * sqy, qz + e * sqz);
      G2::add(p, p, acc);
    }
    if (lane == 0) {  // t3 = psi(psi(2 p)); lane 0's base is p
      G2::dbl(t3, p);
      g2_psi(t3, t3, psi_c);
      g2_psi(t3, t3, psi_c);
    } else {  // lane 1's base is psi(p)
      g2_psi(p, p, psi_c);
    }
    scalar_mul_point<G2>(acc, p, bits + lane * nbits, nbits, 1);
    if (lane == 1) {  // t2 = -[|z - 1|] psi(p)
      fp2_neg(acc.y, acc.y);
      sh_t2[pair] = acc;
    }
  }
  __syncthreads();
  if (live && lane == 0) {
    G2::add(acc, acc, sh_t2[pair]);
    G2::add(acc, acc, t3);
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
      const uint32_t* w = coord<G2>(acc, c);
      uint32_t* dst = out + (c * n + e) * G2::kWords;
      for (int i = 0; i < G2::kWords; ++i) dst[i] = w[i];
    }
  }
}

}  // namespace

extern "C" {

int lh_clear_cofactor(const void* px, long long spx, const void* py, long long spy, const void* pz, long long spz,
                      const void* qx, long long sqx, const void* qy, long long sqy, const void* qz, long long sqz,
                      int sum, const void* psi_c, const void* bits, int nbits, void* out, long long n,
                      void* stream) {
  if (n > 0) {
    clear_cofactor_kernel<<<(unsigned)((n + kPairs - 1) / kPairs), kCofactorThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, spx, (const uint32_t*)py, spy, (const uint32_t*)pz, spz, (const uint32_t*)qx, sqx,
        (const uint32_t*)qy, sqy, (const uint32_t*)qz, sqz, sum, (const uint32_t*)psi_c, (const uint8_t*)bits,
        nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
