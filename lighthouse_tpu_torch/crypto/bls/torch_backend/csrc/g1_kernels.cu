// The G1 subgroup check of pubkey admission (K5), with a plain C launcher
// (extern "C", bound from Python with ctypes). The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// K5 g1_subgroup_check_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/api.py:599
//   `_pk_validate_kernel`, and inside it curve.py:438 `g1_in_subgroup`
//   (`phi_g1` :432, `scalar_mul_bits` :282 at 128 static bits,
//   `eq_points` :347).
//   Computes: out[i] = (phi(P) == -[z^2] P or P == O) && !inf[i], with
//   P = from_affine(x[i], y[i], inf[i]) and phi(x, y) = (beta x, y). Only
//   the verdict leaves the kernel, so it uses its own chain: z^2 > 0 and
//   |z| = 0xd201000000010000 has 6 set bits, so [z^2] P = [|z|]([|z|] P),
//   two 64-bit double-and-add chains of 63 doublings and 5 additions.
//   Bound: operations. A key costs 126 doublings (9 Montgomery products
//   each), 10 complete additions (14 each) and 5 products for phi and the
//   cross-multiplied comparison: 1,279 products of 300 word products, about
//   384,000 32 x 32-bit products against 98 bytes moved (x, y, inf in, the
//   verdict out). Infinity rows return at once and cost nothing.
//   Design: one thread per key, the whole check in registers with the
//   complete formulas of g1.cuh (no branch on the data: the small-order
//   points of E(Fp) outside G1, such as (0, 2) of order 3, meet P + (-P)
//   and infinity inside the chain and are handled like any other point).
//   beta is read from a device array the caller fills with the same
//   Montgomery constant as the plain version (curve.PHI_BETA), so the two
//   cannot disagree on the cube root. No shared memory, nothing crosses
//   threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "g1.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint64_t kAbsZ = 0xd201000000010000ull;  // |z|, z the BLS12-381 parameter

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__global__ void g1_subgroup_check_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                                         const uint8_t* __restrict__ inf, const uint32_t* __restrict__ beta,
                                         uint8_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (inf[i]) {
    out[i] = 0;
    return;
  }
  uint32_t xa[FP_WORDS], ya[FP_WORDS];
  fp_load(xa, x + i * FP_WORDS);
  fp_load(ya, y + i * FP_WORDS);
  G1Proj q;
  g1_from_affine(q, xa, ya, false);
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) g1_mul_u64(q, q, kAbsZ);  // q = [z^2] P
  fp_neg(q.y, q.y);                                               // -[z^2] P

  // phi(P) = (beta x : y : 1), reloaded so that P is not live across the chain.
  G1Proj phi;
  uint32_t b[FP_WORDS];
  fp_load(xa, x + i * FP_WORDS);
  fp_load(ya, y + i * FP_WORDS);
  fp_load(b, beta);
  fp_mul(xa, xa, b);
  g1_from_affine(phi, xa, ya, false);
  // P is finite here (Z = 1), so eq_points' infinity cases reduce to g1_eq.
  out[i] = g1_eq(phi, q) ? 1 : 0;
}

}  // namespace

extern "C" {

int lh_g1_subgroup_check(const void* x, const void* y, const void* inf, const void* beta, void* out,
                         long long n, void* stream) {
  if (n > 0) {
    g1_subgroup_check_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint8_t*)inf, (const uint32_t*)beta,
        (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
