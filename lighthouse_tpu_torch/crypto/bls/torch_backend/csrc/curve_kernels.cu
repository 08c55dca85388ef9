// Windowed scalar multiplication in G1 and G2, one launch per call, with
// plain C launchers (extern "C", bound from Python with ctypes). Each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// K10 g1_scalar_mul_kernel, K11 g2_scalar_mul_kernel
//   Replace: lighthouse_tpu/crypto/bls/jax_backend/curve.py:282
//   `scalar_mul_bits` (registered curve.scalar_mul_bits.g1 / .g2), over
//   :184 `dbl_fast` and :138 `add`. On the verify path K10 runs
//   r_i [aggpk_i] (S elements, 64 secret bits each) and K11 the 2-stacked
//   [|z|] sig_i and r_i sig_i (2 S elements, 64 bits); hash-to-G2's
//   cofactor multiplications run the same routine inside K17
//   (cofactor_kernels.cu).
//   Computes: [k] P for a projective P and MSB-first 0/1 bits of k, by the
//   plain version's algorithm step for step, so that the projective
//   output is bit-identical to it (a coordinate is not unique; the
//   formulas that produce it are): curve.cuh `scalar_mul_point`, whose
//   header states the schedule (a 16-row table, four doublings (RCB
//   Algorithm 9) and one complete addition (Algorithm 7) a 4-bit digit,
//   127 bits making 32 digits). The formulas are g1.cuh's (K10) and
//   g2.cuh's (K11).
//   Operands: X, Y, Z each with an element stride in words (the
//   coordinate's size, or 0 for one point broadcast over the batch); the
//   bits as int32 or int64 rows (one byte read per bit, the low byte of a
//   little-endian 0/1 value), row e at byte (e / inner) * hi +
//   (e % inner) * lo, so a row broadcast over some dims is read in place.
//   Output: X, Y, Z, each n contiguous coordinates.
//   Design: one thread per element, the table (16 points: 2.3 KB in G1,
//   4.6 KB in G2) in local memory, one warp a block so that the verify
//   path's 128 or 256 elements spread over 4 or 8 SMs. Every value is
//   canonical, so the field arithmetic inside a formula may be arranged
//   freely (G2's products by 3b are additions, its Fp2 products lazy
//   sums); which formula runs follows the plain version. Two threads per
//   element (K7's split) would halve the chain of a G2 element; one
//   thread keeps the table and every formula in one place, and a verify's
//   time is still set by the host (PERF.md), so the split waits for a
//   measurement that asks for it.
//   Work: 15 complete additions for the table, then per digit 4 doublings
//   and 1 addition. In the field products the function needs: an addition
//   12, a doubling 6 and 2 squares (the products by 3b are additions; K10
//   does G1's as products, G1_B3 = 12). K10 at 64 bits: 31 additions and
//   64 doublings, 756 Fp products of 300 word products and 128 squares of
//   234, 256,752 word products per element against 288 bytes of points and
//   64 bits moved. K11 over Fp2 products of 744 and squares of 600 (the
//   kernel does every one as a product, 888 word products):
//   639,264 word products at 64 bits, 1,144,608 at 128 (47 additions,
//   128 doublings), against 576 bytes.
//   Operations bound; the verify path's shapes leave most of the card idle
//   and are bound by one thread's chain of dependent products.
//   Bound (reduction): G1 products are K1's CIOS (canonical in, canonical
//   out); G2's lazy sums hold N = 2 products, T < 2 p^2, inside fp384.cuh's
//   N <= 9 for one conditional subtraction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace {

constexpr int kThreads = 32;  // one warp a block

template <typename G>
__device__ __forceinline__ void scalar_mul(const uint32_t* x, long long sx, const uint32_t* y, long long sy,
                                           const uint32_t* z, long long sz, const uint8_t* bits, long long inner,
                                           long long hi, long long lo, int step, int nbits, uint32_t* out,
                                           long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  using Point = typename G::Point;
  constexpr int W = G::kWords;
  Point p, acc;
  load_point<G>(p, x + e * sx, y + e * sy, z + e * sz);
  scalar_mul_point<G>(acc, p, bits + (e / inner) * hi + (e % inner) * lo, nbits, step);
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const uint32_t* w = coord<G>(acc, c);
    uint32_t* dst = out + (c * n + e) * W;
    for (int i = 0; i < W; ++i) dst[i] = w[i];
  }
}

__global__ void __launch_bounds__(kThreads) g1_scalar_mul_kernel(
    const uint32_t* __restrict__ x, long long sx, const uint32_t* __restrict__ y, long long sy,
    const uint32_t* __restrict__ z, long long sz, const uint8_t* __restrict__ bits, long long inner, long long hi,
    long long lo, int step, int nbits, uint32_t* __restrict__ out, long long n) {
  scalar_mul<G1>(x, sx, y, sy, z, sz, bits, inner, hi, lo, step, nbits, out, n);
}

__global__ void __launch_bounds__(kThreads) g2_scalar_mul_kernel(
    const uint32_t* __restrict__ x, long long sx, const uint32_t* __restrict__ y, long long sy,
    const uint32_t* __restrict__ z, long long sz, const uint8_t* __restrict__ bits, long long inner, long long hi,
    long long lo, int step, int nbits, uint32_t* __restrict__ out, long long n) {
  scalar_mul<G2>(x, sx, y, sy, z, sz, bits, inner, hi, lo, step, nbits, out, n);
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int lh_g1_scalar_mul(const void* x, long long sx, const void* y, long long sy, const void* z, long long sz,
                     const void* bits, long long inner, long long hi, long long lo, int step, int nbits, void* out,
                     long long n, void* stream) {
  if (n > 0) {
    g1_scalar_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, sx, (const uint32_t*)y, sy, (const uint32_t*)z, sz, (const uint8_t*)bits, inner, hi,
        lo, step, nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_g2_scalar_mul(const void* x, long long sx, const void* y, long long sy, const void* z, long long sz,
                     const void* bits, long long inner, long long hi, long long lo, int step, int nbits, void* out,
                     long long n, void* stream) {
  if (n > 0) {
    g2_scalar_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, sx, (const uint32_t*)y, sy, (const uint32_t*)z, sz, (const uint8_t*)bits, inner, hi,
        lo, step, nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
