// Standalone launches of routines that run inside the verify path's
// kernels, for the JAX registry's functions that the port used to compose
// from K1-K8 when called on their own, with plain C launchers (extern "C",
// bound from Python with ctypes). Each launcher runs on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). Operands are read in place: each comes with its
// element stride in words, the element's size for a contiguous tensor and
// 0 for one element broadcast over the batch. Outputs are contiguous. None
// of them is on the verify path (a verify launches K10-K21 only).
//
// K26 g1_add_kernel / K27 g2_add_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/curve.py:138 `add`
//   (registered curve.add.g1 / .g2) called on its own; the port's
//   `curve.add(FP / FP2, p, q)`. On the verify path the same formulas run
//   inside K10, K11 and K15-K17.
//   Computes: the complete addition of RCB 2016 (Algorithm 7, a = 0), the
//   plain version's formulas (`curve.add_composed`), through curve.cuh's
//   one-copy group laws (`G1::add`, `G2::add`) (K10, K11 and K15-K17 run
//   the same formulas on curve.cuh's lane-group law). A projective output
//   is not unique; the formulas are the same, so the words are the plain
//   version's.
//   Design: a thread per element, 32 a block; the six coordinates read in
//   place, X, Y, Z of the sum written as three contiguous planes.
//   Work per element, in the word products the function needs: 12 field
//   products (those by 3b are additions in G2; G1 forms its two as
//   products of the constant, counted here as the function's 12 of 14):
//   3,600 in G1, 8,928 in G2 (Fp2 products of 744), against 432 or 864
//   bytes (two points in, one out). Operations bound.
//   Bound (reduction): G1 products are K1's CIOS; G2's lazy sums hold
//   N = 2 products, one conditional subtraction (fp384.cuh: N <= 9).
//
// K28 karabina_sqr_kernel
//   Replaces: jax_backend/tower.py:401 `karabina_sqr` (registered
//   tower.karabina_sqr) called on its own; the port's `tower.karabina_sqr`.
//   Inside K9 and K19 the same squaring runs on twelve threads.
//   Computes, for compressed (g2, g3, g4, g5):
//     h2 = 2 g2 + 6 xi g4 g5          h3 = 3 (g4^2 + xi g5^2) - 2 g3
//     h4 = 3 (g2^2 + xi g3^2) - 2 g4  h5 = 2 g5 + 6 g2 g3
//   the plain version's formulas, its products by 6, 3 and 2 formed by
//   additions (every value canonical: the same integers).
//   Design: a thread per element, 32 a block; six Fp2 products (g2.cuh
//   `fp2_mul`, each component one lazy sum of N = 2 reduced once).
//   Work per element: four Fp2 squares and two products the function needs
//   (600 and 744), 3,888, against 768 bytes. Operations bound.
//
// K29 karabina_decompress_kernel
//   Replaces: jax_backend/tower.py:481 `karabina_decompress` (registered
//   tower.karabina_decompress) called on its own; the port's
//   `tower.karabina_decompress`. Inside K9 and K19 six decompressions share
//   one inversion.
//   Computes: g1 = (xi g5^2 + 3 g4^2 - 2 g3) / (4 g2), or 2 g4 g5 / g3
//   where g2 = 0; g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1; the tower Fp12
//   from flat coefficients (g0, g2, g4, g1, g3, g5). The denominator's
//   inverse is (d0 - d1 u) / (d0^2 + d1^2) with a zero norm mapping to zero
//   (inv0): each element's own inversion, where the plain version
//   shares one batch inversion whose zero lanes map to zero. Every value is
//   canonical, so the words are the plain version's.
//   Design: a thread per element, 32 a block; the inversion fp384.cuh
//   `fp_inv`, the binary GCD (one `__noinline__` copy).
//   Work per element, in the word products its branch needs: where
//   g2 != 0 three Fp2 squares (g5^2, g4^2, g1^2) and three products (g1,
//   g2 g5, g3 g4), where g2 = 0 one square and four products (2 g4 g5
//   too); the norm (two Fp squares summed and reduced once, 312), the
//   inversion (fp384.cuh's binary GCD, 3,472) and two Fp products: 8,416
//   or 7,960, against 960 bytes. Operations
//   bound; one thread's chain sets the time at any batch up to a few
//   thousand.
//
// K33 fp_redc_kernel
//   Replaces: jax_backend/fp.py:261 `redc` (registered fp.mont_reduce); the
//   port's `fp.mont_reduce`. Inside K1 (fp_mul) and every kernel's lazy
//   sums (fp384.cuh `fp_redc_wide`).
//   Computes: T 2^-384 mod p, canonical, for T < 2 p 2^384 given as 24
//   little-endian words, the JAX function's domain (its `mult = 2`: a
//   nonnegative value below 2 p 2^384, there in 63 columns of 12-bit limb
//   products, here in the port's double-width words).
//   Design: a thread per element, 128 a block; `fp_redc_wide<2>`: 12
//   word-serial rounds, then two conditional subtractions, since the
//   rounds leave T / 2^384 + p < 3 p (fp384.cuh's bound with T < 2 p 2^384
//   in place of N p^2; T + m p < 3 p 2^384 < 2^767, so no carry leaves the
//   24 words).
//   Work per element: 156 word products against 144 bytes (T in, the
//   residue out): about one product a byte, bytes bound on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"
#include "fp384.cuh"
#include "g2.cuh"
#include "tower.cuh"

namespace {

constexpr int kThreads = 32;       // a thread per element, one warp a block
constexpr int kRedcThreads = 128;  // K33: a short function, fuller blocks
constexpr int kCompressedWords = 4 * kFp2Words;


template <typename G>
__device__ __forceinline__ void add_points(const uint32_t* const* in, const long long* st, uint32_t* out,
                                           long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  typename G::Point p, q, r;
  load_point<G>(p, in[0] + e * st[0], in[1] + e * st[1], in[2] + e * st[2]);
  load_point<G>(q, in[3] + e * st[3], in[4] + e * st[4], in[5] + e * st[5]);
  G::add(r, p, q);
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const uint32_t* w = coord<G>(r, c);
    uint32_t* dst = out + ((long long)c * n + e) * G::kWords;
    for (int i = 0; i < G::kWords; ++i) dst[i] = w[i];
  }
}

struct AddArgs {
  const uint32_t* in[6];  // X1, Y1, Z1, X2, Y2, Z2
  long long st[6];
};

__global__ void __launch_bounds__(kThreads) g1_add_kernel(AddArgs a, uint32_t* __restrict__ out, long long n) {
  add_points<G1>(a.in, a.st, out, n);
}

__global__ void __launch_bounds__(kThreads) g2_add_kernel(AddArgs a, uint32_t* __restrict__ out, long long n) {
  add_points<G2>(a.in, a.st, out, n);
}

// r = 2 a, 3 a, 6 a by additions
__device__ __forceinline__ void fp2_dbl(fp2_t r, const fp2_t a) { fp2_add(r, a, a); }

__device__ __forceinline__ void fp2_triple(fp2_t r, const fp2_t a) {
  fp2_t t;
  fp2_add(t, a, a);
  fp2_add(r, t, a);
}

__global__ void __launch_bounds__(kThreads) karabina_sqr_kernel(const uint32_t* __restrict__ c, long long sc,
                                                                uint32_t* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  fp2_t g2, g3, g4, g5, a, b, t;
  const uint32_t* src = c + e * sc;
  fp2_load(g2, src);
  fp2_load(g3, src + kFp2Words);
  fp2_load(g4, src + 2 * kFp2Words);
  fp2_load(g5, src + 3 * kFp2Words);
  uint32_t* dst = out + e * kCompressedWords;

  // h3 = 3 (g4^2 + xi g5^2) - 2 g3
  fp2_mul(a, g4, g4);
  fp2_mul(b, g5, g5);
  fp2_mul_xi(b, b);
  fp2_add(a, a, b);
  fp2_triple(a, a);
  fp2_dbl(t, g3);
  fp2_sub(a, a, t);
  fp2_store(dst + kFp2Words, a);
  // h4 = 3 (g2^2 + xi g3^2) - 2 g4
  fp2_mul(a, g2, g2);
  fp2_mul(b, g3, g3);
  fp2_mul_xi(b, b);
  fp2_add(a, a, b);
  fp2_triple(a, a);
  fp2_dbl(t, g4);
  fp2_sub(a, a, t);
  fp2_store(dst + 2 * kFp2Words, a);
  // h2 = 2 g2 + 6 xi g4 g5
  fp2_mul(a, g4, g5);
  fp2_mul_xi(a, a);
  fp2_triple(a, a);
  fp2_dbl(a, a);
  fp2_dbl(t, g2);
  fp2_add(a, t, a);
  fp2_store(dst, a);
  // h5 = 2 g5 + 6 g2 g3
  fp2_mul(a, g2, g3);
  fp2_triple(a, a);
  fp2_dbl(a, a);
  fp2_dbl(t, g5);
  fp2_add(a, t, a);
  fp2_store(dst + 3 * kFp2Words, a);
}

__global__ void __launch_bounds__(kThreads) karabina_decompress_kernel(const uint32_t* __restrict__ c, long long sc,
                                                                       uint32_t* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  fp2_t g2, g3, g4, g5, num, den, t, g1, g0;
  const uint32_t* src = c + e * sc;
  fp2_load(g2, src);
  fp2_load(g3, src + kFp2Words);
  fp2_load(g4, src + 2 * kFp2Words);
  fp2_load(g5, src + 3 * kFp2Words);

  // num, den: (xi g5^2 + 3 g4^2 - 2 g3, 4 g2), or (2 g4 g5, g3) where g2 = 0
  const bool g2nz = !fp2_is_zero(g2);
  if (g2nz) {
    fp2_mul(num, g5, g5);
    fp2_mul_xi(num, num);
    fp2_mul(t, g4, g4);
    fp2_triple(t, t);
    fp2_add(num, num, t);
    fp2_dbl(t, g3);
    fp2_sub(num, num, t);
    fp2_dbl(den, g2);
    fp2_dbl(den, den);
  } else {
    fp2_mul(num, g4, g5);
    fp2_dbl(num, num);
    fp2_copy(den, g3);
  }
  // 1 / den = (d0 - d1 u) / (d0^2 + d1^2), a zero norm to zero (inv0)
  uint32_t wide[FP_WIDE], norm[FP_WORDS];
  fp_mul_wide(wide, den[0], den[0]);
  fp_mac_wide(wide, den[1], den[1]);
  fp_redc_wide<1>(norm, wide);
  fp_inv(norm, norm);
  fp_mul(t[0], den[0], norm);
  fp_mul(t[1], den[1], norm);
  fp_neg(t[1], t[1]);
  fp2_mul(g1, num, t);
  // g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1
  fp2_mul(g0, g1, g1);
  fp2_dbl(g0, g0);
  fp2_mul(t, g2, g5);
  fp2_add(g0, g0, t);
  fp2_mul(t, g3, g4);
  fp2_triple(t, t);
  fp2_sub(g0, g0, t);
  fp2_mul_xi(g0, g0);
  fp_add(g0[0], g0[0], FP_ONE);

  uint32_t* dst = out + e * kFp12Words;
  fp2_store(dst + tower_offset(0), g0);
  fp2_store(dst + tower_offset(1), g2);
  fp2_store(dst + tower_offset(2), g4);
  fp2_store(dst + tower_offset(3), g1);
  fp2_store(dst + tower_offset(4), g3);
  fp2_store(dst + tower_offset(5), g5);
}

__global__ void __launch_bounds__(kRedcThreads) fp_redc_kernel(const uint32_t* __restrict__ t, long long st,
                                                               uint32_t* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t w[FP_WIDE], r[FP_WORDS];
  const uint32_t* src = t + e * st;
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) w[i] = src[i];
  fp_redc_wide<2>(r, w);
  fp_store(out + e * FP_WORDS, r);
}

unsigned blocks(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

AddArgs add_args(const void* x1, long long sx1, const void* y1, long long sy1, const void* z1, long long sz1,
                 const void* x2, long long sx2, const void* y2, long long sy2, const void* z2, long long sz2) {
  return AddArgs{{(const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
                  (const uint32_t*)y2, (const uint32_t*)z2},
                 {sx1, sy1, sz1, sx2, sy2, sz2}};
}

}  // namespace

extern "C" {

int lh_g1_add(const void* x1, long long sx1, const void* y1, long long sy1, const void* z1, long long sz1,
              const void* x2, long long sx2, const void* y2, long long sy2, const void* z2, long long sz2, void* out,
              long long n, void* stream) {
  if (n > 0) {
    g1_add_kernel<<<blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        add_args(x1, sx1, y1, sy1, z1, sz1, x2, sx2, y2, sy2, z2, sz2), (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_g2_add(const void* x1, long long sx1, const void* y1, long long sy1, const void* z1, long long sz1,
              const void* x2, long long sx2, const void* y2, long long sy2, const void* z2, long long sz2, void* out,
              long long n, void* stream) {
  if (n > 0) {
    g2_add_kernel<<<blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        add_args(x1, sx1, y1, sy1, z1, sz1, x2, sx2, y2, sy2, z2, sz2), (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_karabina_sqr(const void* c, long long sc, void* out, long long n, void* stream) {
  if (n > 0) {
    karabina_sqr_kernel<<<blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)c, sc,
                                                                                    (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_karabina_decompress(const void* c, long long sc, void* out, long long n, void* stream) {
  if (n > 0) {
    karabina_decompress_kernel<<<blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)c, sc, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp_redc(const void* t, long long st, void* out, long long n, void* stream) {
  if (n > 0) {
    fp_redc_kernel<<<blocks(n, kRedcThreads), kRedcThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)t, st,
                                                                                       (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
