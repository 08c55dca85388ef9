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
//   [|z - 1|] psi(p) on K11's algorithm (curve.cuh `scalar_mul_lanes`'
//   table and digits; the two rows of 128 public bits of `h2c._CC_BITS`,
//   a byte a bit, 32 digits); the second negated (z - 1 < 0);
//   t3 = psi(psi(2 p)); then (t1 + t2) + t3. A projective coordinate is not unique, so every point
//   is formed by the plain version's formula and in its order (g2.cuh's
//   RCB Algorithms 7 and 9; psi(x, y, z) = (conj(x) CX, conj(y) CY,
//   conj(z)), CX and CY from `curve._PSI_C`, the constant operand). Every
//   value is canonical, so the arithmetic inside a formula is free.
//   Design: one warp per element, a block each, so the verify path's 128
//   elements occupy 128 SMs. Lanes 0-11 (group 0) run [z^2 - z - 1] p
//   from bit row 0, lanes 12-23 (group 1) [|z - 1|] psi(p) from bit row
//   1, on curve.cuh's lane-group law (`scalar_mul_lanes<2>`): each Fp2
//   product of an RCB level on a lane pair, a lane per component, the
//   additions between the levels a lane per Fp component, `__syncwarp`
//   between steps. Both rows have 128 bits (32 digits), so the two groups
//   run one instruction stream. Lanes 24-31 idle but reach every
//   `__syncwarp`. The state lies in shared memory: both chains' 16-row
//   tables (2 x 4,608 bytes), their accumulators, each group's scratch
//   (1,248 bytes), t3 and psi's two constants, 12,768 bytes a block. The
//   prefix: both groups form p = q0 + q1; group 0 forms 2 p while group 1
//   idles, then the psi steps, group 1's psi(p) beside group 0's first.
//   The suffix: group 1 negates its product's Y in place, group 0 forms
//   the two additions and the lanes write the element.
//   Work per element, in the word products the function needs (an Fp2
//   product 744, a square 600, products by 3b are additions): the sum 12
//   products; psi 2 products each, three in all; the doubling 6 products
//   and 2 squares; two chains of 15 table additions and 32 digits of four
//   doublings and an addition (1,144,608 at 128 bits for both, as K11
//   counts them); the two final additions 24 products. Against 864 bytes
//   (q0, q1 in, the element out). Operations bound; at the verify path's
//   128 elements one warp's chain of dependent steps sets the time: 175
//   group operations of four steps each, a step one product component (or
//   its additions) on each lane, where one thread would form the 12 (8)
//   full Fp2 products of an addition (doubling) in a row.
//   Bound (reduction): every Fp2 component is a lazy sum of N = 2 products
//   below 2 p^2, one conditional subtraction (fp384.cuh: N <= 9).

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace {

constexpr int kCofactorThreads = 32;  // one warp per element, two lane groups

struct CofactorShared {
  G2Proj tab[2][kRows];              // each chain's table; row 1 holds its base
  G2Proj acc[2];                     // each chain's accumulator (q1 before the sum)
  G2Proj t3;                         // psi(psi(2 p))
  fp2_t s[2][kLaneScratch];          // each group's scratch
  fp2_t cc[2];                       // conj(CX), conj(CY)
};

__global__ void __launch_bounds__(kCofactorThreads) clear_cofactor_kernel(
    const uint32_t* __restrict__ px, long long spx, const uint32_t* __restrict__ py, long long spy,
    const uint32_t* __restrict__ pz, long long spz, const uint32_t* __restrict__ qx, long long sqx,
    const uint32_t* __restrict__ qy, long long sqy, const uint32_t* __restrict__ qz, long long sqz, int sum,
    const uint32_t* __restrict__ psi_c, const uint8_t* __restrict__ bits, int nbits, uint32_t* __restrict__ out,
    long long n) {
  __shared__ CofactorShared sh;
  const long long e = blockIdx.x;
  if (e >= n) return;
  const int t = threadIdx.x;
  const int g = t < kLaneGroup ? 0 : 1, l = t - g * kLaneGroup;  // lanes 24-31: group 1, l >= 12
  const bool on = t < 2 * kLaneGroup;
  uint32_t* s = &sh.s[g][0][0][0];

  // q0 into both tables' row 1, q1 into both accumulators; the zero slots;
  // conj(CX), conj(CY)
  const uint32_t* src[6] = {px + e * spx, py + e * spy, pz + e * spz, qx + e * sqx, qy + e * sqy, qz + e * sqz};
  for (int i = t; i < 6 * 2 * FP_WORDS; i += kCofactorThreads) {
    const int c = i / (2 * FP_WORDS), w = i % (2 * FP_WORDS);
    const uint32_t v = src[c][w];
    if (c < 3) {
      coord<G2>(sh.tab[0][1], c)[w] = v;
      coord<G2>(sh.tab[1][1], c)[w] = v;
    } else {
      coord<G2>(sh.acc[0], c - 3)[w] = v;
      coord<G2>(sh.acc[1], c - 3)[w] = v;
    }
  }
  if (t < 4) {  // component t & 1 of constant t >> 1
    uint32_t v[FP_WORDS];
    fp_load(v, psi_c + t * FP_WORDS);
    if (t & 1) fp_neg(v, v);
    fp_store(sh.cc[t >> 1][t & 1], v);
  }
  if (t < 2 * FP_WORDS) {
    sh.s[0][kLaneScratch - 1][t / FP_WORDS][t % FP_WORDS] = 0u;
    sh.s[1][kLaneScratch - 1][t / FP_WORDS][t % FP_WORDS] = 0u;
  }
  __syncwarp();

  // p = q0 + q1 on both groups; t3 = psi(psi(2 p)) on group 0, psi(p) on
  // group 1 beside the first psi
  G2Proj* base = &sh.tab[g][1];
  if (sum) lanes_add<2>((uint32_t*)base, (uint32_t*)base, (uint32_t*)&sh.acc[g], s, l, on);
  lanes_dbl<2>((uint32_t*)&sh.t3, (uint32_t*)base, s, l, on && g == 0);
  g2_psi_lanes(g == 0 ? &sh.t3 : base, g == 0 ? &sh.t3 : base, sh.cc, l, on);
  g2_psi_lanes(&sh.t3, &sh.t3, sh.cc, l, on && g == 0);

  // the two chains
  scalar_mul_lanes<2>((uint32_t*)sh.tab[g], (uint32_t*)&sh.acc[g], s, bits + g * nbits, nbits, 1, l, on);

  // t2 = -[|z - 1|] psi(p), in place; then (t1 + t2) + t3 on group 0
  if (g == 1 && l < 2) {
    uint32_t v[FP_WORDS];
    fp_load(v, sh.acc[1].y[l]);
    fp_neg(v, v);
    fp_store(sh.acc[1].y[l], v);
  }
  __syncwarp();
  lanes_add<2>((uint32_t*)&sh.acc[0], (uint32_t*)&sh.acc[0], (uint32_t*)&sh.acc[1], s, l, on && g == 0);
  lanes_add<2>((uint32_t*)&sh.acc[0], (uint32_t*)&sh.acc[0], (uint32_t*)&sh.t3, s, l, on && g == 0);
  for (int i = t; i < 3 * 2 * FP_WORDS; i += kCofactorThreads) {
    const int c = i / (2 * FP_WORDS), w = i % (2 * FP_WORDS);
    out[(c * n + e) * G2::kWords + w] = coord<G2>(sh.acc[0], c)[w];
  }
}

}  // namespace

extern "C" {

int lh_clear_cofactor(const void* px, long long spx, const void* py, long long spy, const void* pz, long long spz,
                      const void* qx, long long sqx, const void* qy, long long sqy, const void* qz, long long sqz,
                      int sum, const void* psi_c, const void* bits, int nbits, void* out, long long n,
                      void* stream) {
  if (n > 0) {
    clear_cofactor_kernel<<<(unsigned)n, kCofactorThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, spx, (const uint32_t*)py, spy, (const uint32_t*)pz, spz, (const uint32_t*)qx, sqx,
        (const uint32_t*)qy, sqy, (const uint32_t*)qz, sqz, sum, (const uint32_t*)psi_c, (const uint8_t*)bits,
        nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
