// The last composed functions of the JAX package's registry, one launch
// per call each, with plain C launchers (extern "C", bound from Python with
// ctypes). Each launcher runs on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError(). Operands are read
// in place: each comes with its element stride in words, the element's
// size for a contiguous tensor and 0 for one element broadcast over the
// batch. Outputs are contiguous. None of the four is on the verify path
// (a verify launches K10-K21 only); each replaces a PyTorch composition of
// the port (`curve.to_affine_plain`, `tower.fp6_mul_composed`,
// `tower.fp2_inv_composed`).
//
// K22 g1_to_affine_kernel / K23 g2_to_affine_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/curve.py:120
//   `to_affine` (registered curve.to_affine.g1 / .g2, curve.py:540 / :545):
//   (X / Z, Y / Z, Z == 0), infinity decoding to zeroed coordinates (inv0:
//   the inverse of 0 is 0). The port's `curve.to_affine(FP / FP2, p)`.
//   Design: a thread per point, one-warp blocks so a few hundred points
//   spread over as many SMs. G1: fp384.cuh `fp_inv` on Z (the binary
//   GCD), two `fp_mul`. G2: g2.cuh `fp2_inv` (the norm Z0^2 + Z1^2 as one
//   lazy sum of N = 2 squares reduced once, its inverse, two Fp products),
//   two `fp2_mul`. The
//   norm is zero only for Z = 0 (-1 is no square mod p), and then both
//   output words are zero, as inv0 gives. Every value is canonical, so the
//   words are those of the plain version's K3/K1 (G1) or fp2_inv/K7 (G2).
//   Work per point, in the word products the function needs (the
//   inversion, fp384.cuh's binary GCD, 3,472): G1 4,072, G2 5,872 (the
//   norm 312, the inversion, two Fp products, two Fp2
//   products of 744), against 241 or 481 bytes (a point in, x, y and the
//   flag out). Operations bound; at a few hundred points bound by one
//   thread's inversion and its products.
//
// K24 fp6_mul_kernel
//   Replaces: jax_backend/tower.py:155 `fp6_mul` (registered tower.fp6_mul,
//   tower.py:622), Karatsuba over Fp2; the port's `tower.fp6_mul`.
//   Computes c_k = sum_(i + j = k) a_i b_j + xi sum_(i + j = k + 3) a_i b_j
//   (v^3 = xi = 1 + u), schoolbook: for output coefficient k and each j,
//   i = (k - j) mod 3, and the terms that wrap (j > k) take xi a_i =
//   (a_i0 - a_i1) + (a_i0 + a_i1) u, two Fp additions in registers, as K8
//   does for w^6. The JAX function's Karatsuba cross terms
//   (a_i + a_j)(b_i + b_j) would have operands up to 2p; the schoolbook
//   form keeps every operand canonical, so the bound below holds as
//   stated, and the output, a canonical field element, is the JAX
//   function's.
//   Design: a group of six threads per element, sixteen groups (three
//   warps) a block; thread 2k + c forms component c of coefficient k as
//   one double-width sum of three Fp2 terms, each split as K7 splits a
//   product (tower.cuh `fp2_component_mac`: c0 += x0 y0 + (-x1) y1,
//   c1 += x0 y1 + x1 y0), reduced once. Operands are read straight from
//   device memory (the group's six threads read the same 576 bytes, which
//   L1 serves after the first).
//   Bound (lazy reduction, fp384.cuh): N = 6 products per component, all
//   operands canonical, T < 6 p^2: one reduction and one conditional
//   subtraction (SUBS = 1, N <= 9).
//   Work: 6 x (6 x 144 + 156) = 6,120 word products per element; the
//   function needs 3,528 (six Karatsuba Fp2 products of 3 x 144, one
//   reduction per output component), against 864 bytes (a, b in, c out):
//   about 4 products a byte, so a batch that filled the card would sit
//   near the balance of bytes and operations.
//
// K25 fp2_inv_kernel
//   Replaces: jax_backend/tower.py:100 `fp2_inv` (registered tower.fp2_inv,
//   tower.py:617) standalone; the port's `tower.fp2_inv(a)` over the kernel
//   field operations. 0 -> 0 (inv0).
//   Design: a thread per element, one-warp blocks, over g2.cuh `fp2_inv`,
//   the routine that K13, K14 and K19 run inside their bodies, so the
//   standalone launch and those kernels cannot drift apart.
//   Work per element: 4,384 word products the function needs (the norm
//   312, the inversion, fp384.cuh's binary GCD 3,472, two Fp products),
//   against 192 bytes. Operations
//   bound; one thread's inversion sets the time at any batch up to a few
//   thousand.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "g2.cuh"
#include "tower.cuh"

namespace {

constexpr int kAffineThreads = 32;  // a thread per element, one warp a block
constexpr int kFp6Group = 6;        // threads per Fp6 element
constexpr int kFp6PerBlock = 16;
constexpr int kFp6Threads = kFp6Group * kFp6PerBlock;  // three warps
constexpr int kFp6Words = 3 * kFp2Words;

__global__ void __launch_bounds__(kAffineThreads) g1_to_affine_kernel(
    const uint32_t* __restrict__ x, long long sx, const uint32_t* __restrict__ y, long long sy,
    const uint32_t* __restrict__ z, long long sz, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint8_t* __restrict__ inf, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[FP_WORDS], zi[FP_WORDS];
  fp_load(a, z + e * sz);
  inf[e] = fp_is_zero(a) ? 1 : 0;
  fp_inv(zi, a);
  fp_load(a, x + e * sx);
  fp_mul(a, a, zi);
  fp_store(ox + e * FP_WORDS, a);
  fp_load(a, y + e * sy);
  fp_mul(a, a, zi);
  fp_store(oy + e * FP_WORDS, a);
}

__global__ void __launch_bounds__(kAffineThreads) g2_to_affine_kernel(
    const uint32_t* __restrict__ x, long long sx, const uint32_t* __restrict__ y, long long sy,
    const uint32_t* __restrict__ z, long long sz, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint8_t* __restrict__ inf, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  fp2_t a, zi;
  fp2_load(a, z + e * sz);
  inf[e] = fp2_is_zero(a) ? 1 : 0;
  fp2_inv(zi, a);
  fp2_load(a, x + e * sx);
  fp2_mul(a, a, zi);
  fp2_store(ox + e * kFp2Words, a);
  fp2_load(a, y + e * sy);
  fp2_mul(a, a, zi);
  fp2_store(oy + e * kFp2Words, a);
}

__global__ void __launch_bounds__(kFp6Threads) fp6_mul_kernel(const uint32_t* __restrict__ a, long long sa,
                                                               const uint32_t* __restrict__ b, long long sb,
                                                               uint32_t* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * kFp6PerBlock + threadIdx.x / kFp6Group;
  if (e >= n) return;
  const int t = threadIdx.x % kFp6Group;
  const int k = t >> 1;      // output coefficient
  const bool c1 = t & 1;     // output component
  const uint32_t* ea = a + e * sa;
  const uint32_t* eb = b + e * sb;
  uint32_t x0[FP_WORDS], x1[FP_WORDS], y0[FP_WORDS], y1[FP_WORDS], d[FP_WORDS], s[FP_WORDS], acc[FP_WIDE];
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) acc[i] = 0;
#pragma unroll 1
  for (int j = 0; j < 3; ++j) {
    const int i = (k - j + 3) % 3;
    fp_load(x0, ea + i * kFp2Words);
    fp_load(x1, ea + i * kFp2Words + FP_WORDS);
    fp_load(y0, eb + j * kFp2Words);
    fp_load(y1, eb + j * kFp2Words + FP_WORDS);
    // the wrapped terms carry v^3 = xi: a_i -> (a0 - a1, a0 + a1)
    const bool wrap = j > k;
    fp_sub(d, x0, x1);
    fp_add(s, x0, x1);
    fp_select(x0, wrap, d, x0);
    fp_select(x1, wrap, s, x1);
    fp2_component_mac(acc, c1, x0, x1, y0, y1);
  }
  uint32_t r[FP_WORDS];
  fp_redc_wide<1>(r, acc);
  fp_store(out + e * kFp6Words + k * kFp2Words + (c1 ? FP_WORDS : 0), r);
}

__global__ void __launch_bounds__(kAffineThreads) fp2_inv_kernel(const uint32_t* __restrict__ a, long long sa,
                                                                 uint32_t* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  fp2_t v;
  fp2_load(v, a + e * sa);
  fp2_inv(v, v);
  fp2_store(out + e * kFp2Words, v);
}

unsigned blocks(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

}  // namespace

extern "C" {

int lh_g1_to_affine(const void* x, long long sx, const void* y, long long sy, const void* z, long long sz, void* ox,
                    void* oy, void* inf, long long n, void* stream) {
  if (n > 0) {
    g1_to_affine_kernel<<<blocks(n, kAffineThreads), kAffineThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, sx, (const uint32_t*)y, sy, (const uint32_t*)z, sz, (uint32_t*)ox, (uint32_t*)oy,
        (uint8_t*)inf, n);
  }
  return (int)cudaGetLastError();
}

int lh_g2_to_affine(const void* x, long long sx, const void* y, long long sy, const void* z, long long sz, void* ox,
                    void* oy, void* inf, long long n, void* stream) {
  if (n > 0) {
    g2_to_affine_kernel<<<blocks(n, kAffineThreads), kAffineThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, sx, (const uint32_t*)y, sy, (const uint32_t*)z, sz, (uint32_t*)ox, (uint32_t*)oy,
        (uint8_t*)inf, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp6_mul(const void* a, long long sa, const void* b, long long sb, void* out, long long n, void* stream) {
  if (n > 0) {
    fp6_mul_kernel<<<blocks(n, kFp6PerBlock), kFp6Threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa, (const uint32_t*)b, sb, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp2_inv(const void* a, long long sa, void* out, long long n, void* stream) {
  if (n > 0) {
    fp2_inv_kernel<<<blocks(n, kAffineThreads), kAffineThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
