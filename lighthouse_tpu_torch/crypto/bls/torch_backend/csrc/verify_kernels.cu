// The glue of the verify pipeline around the chain kernels, one launch per
// call each, with plain C launchers (extern "C", bound from Python with
// ctypes). Each launcher runs on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError(). Point operands come as three coordinate pointers,
// each with its element stride in words (0: one point broadcast).
//
// K20 g2_psi_check_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/curve.py:389
//   `g2_in_subgroup` (registered curve.g2_in_subgroup) as the verify
//   inlines it, jax_backend/api.py:293: curve.py:375 `psi`, :347
//   `eq_points`, `neg` and `is_infinity`; the port's `curve.g2_psi_check`,
//   once per verify on the S signatures and their [|z|] multiples (K11's
//   first half, read in place).
//   Computes, per element: eq_points(psi(sig), -zsig) | is_infinity(sig),
//   by the plain version's function (`curve.g2_psi_check_plain`): psi is
//   (conj(x) CX, conj(y) CY, conj(z)) with CX, CY from `curve._PSI_C`;
//   the comparison is the cross-multiplied one, X1 Z2 == X2 Z1 and
//   Y1 Z2 == Y2 Z1 word for word (every value canonical), where
//   canonical infinities (Z = 0) equal each other and nothing else. One
//   byte out, 0 or 1 (a torch.bool).
//   Design: a group of eight lanes per element, four elements a one-warp
//   block (32 blocks at S = 128), the six products in two dependent
//   rounds, each product on a lane pair, lane (k, c) forming component c
//   as one lazy sum (g2.cuh `fp2_mul_part`). The rounds are the rows of
//   `kPsiLane`: round 0 the four independent products X1 = conj(x) CX,
//   Y1 = conj(y) CY, X2 Z1 = zx conj(z) and Y2 Z1 = (-zy) conj(z), each
//   lane reading its operands from device memory; round 1 X1 Z2 and
//   Y1 Z2 on lanes 0-3, X1 and Y1 taken from round 0's lanes by
//   `__shfl_sync`, lanes 4-7 off. Each comparison lane takes round 0's
//   matching component (`kPsiEq`) by shuffle; one `__ballot_sync` over the
//   group's mask gives the word equality, two more the infinity flags
//   (every lane tests component c of sig's and zsig's z). Lanes past the
//   end take the last element and store nothing; the group's first lane
//   stores the byte. Where the thread per element ran six dependent
//   products, a lane runs two.
//   Work per element: six Fp2 products (two in psi, four in the
//   comparison) of 744 word products, 4,464, against 577 bytes (two
//   points in, a byte out) and the constant's 192 once; the kernel does
//   the same six. Operations bound; at 128 elements bound by two
//   dependent component products and the loads. Measured at S = 128
//   (NVIDIA H100 80GB HBM3, 700.00 W, `chip_smoke.py [timing]`, in turns
//   with the thread per element): 0.00733 and 0.00738 ms against 0.03561
//   and 0.03549. ptxas (sm_90a, CUDA 12.8): 124 registers, no stack, no
//   spills (the thread per element: 128 registers, 1,008 bytes of stack,
//   8 bytes of spills).
//   Bound (reduction): every Fp2 component a lazy sum of N = 2 products,
//   one conditional subtraction (fp384.cuh: N <= 9).
//
// K21 miller_inputs_kernel
//   Replaces: jax_backend/api.py:307-327, the batch-affine Miller inputs
//   of `verify_pipeline_local` (api.py:240): the G2 z's norms, `fp.batch_inv`
//   (fp.py:466, at api.py:311) over the S G1 z's and the S + 1 norms, the
//   products to affine coordinates, the generator pair and the infinity
//   flags; the port's `api.miller_inputs`, once per verify.
//   Computes, for S points r_i aggpk_i in G1 (K10's output) and S + 1 in
//   G2 (the hashes H_i, K17's output, then sig_acc, K16's), by the plain
//   version's steps (`api.miller_inputs_plain`): the n = 2S + 1
//   denominators d (a G1 z; a G2 z's norm z0^2 + z1^2, zero exactly at
//   infinity since -1 is no square mod p); their inverses, zero where
//   d = 0; px, py = x / z, y / z of G1 lane i and, as lane S, G1's
//   generator (x, -y), never at infinity; qx, qy = x conj(z) / d, y conj(z)
//   / d of G2 lane j; p_in, q_in the lanes whose z is zero. An inverse is
//   unique, so inverting each denominator on its own gives the words of
//   the plain version's Montgomery trick; fp_inv maps 0 to 0, so an
//   infinity lane's coordinates come out zero as there.
//   Design: a thread per denominator in one-warp blocks: ceil(S / 32) G1
//   blocks (at least one; its first thread also writes lane S), then
//   ceil((S + 1) / 32) G2 blocks, so no warp holds both paths and the
//   verify's 257 lanes spread over 9 SMs. A G1 lane inverts its z
//   (fp384.cuh `fp_inv`, the binary GCD, whose time does not depend on
//   the value) and forms x / z, y / z; a G2 lane forms the norm (one lazy
//   sum of two squares), inverts it, forms conj(z) / norm and two Fp2
//   products. No product tree, no scratch, no barrier: every lane takes
//   one inversion's time, where a one-block product tree runs the root's
//   inversion in series with 18 levels of dependent products
//   (`chip_probes/k21_tree_phases.py`, PERF.md).
//   Work: the function needs the S + 1 norms (two squares and one
//   reduction, 312 each), 3(n - 1) Fp products of 300 and one inversion
//   (the binary GCD, 3,472) for Montgomery's trick, two Fp products a G1
//   lane, two Fp products and two Fp2 products (744) a G2 lane: 620,272
//   word products at S = 128 (`chip_smoke.k21_word_products`, the bound;
//   this header's earlier 737,154 counted the inversion as a Fermat
//   power). The kernel does n inversions where the function needs one:
//   4,072 word products a G1 lane and 5,872 a G2 lane, 1,278,704 at
//   S = 128. Against 432 S + 290 (S + 1) + 384 bytes (points in,
//   coordinates and flags out, sig_acc and the generator): operations
//   bound (0.000037 ms at S = 128); the time is one lane's chain, an
//   inversion and a few products. Measured at S = 128 (NVIDIA H100 80GB
//   HBM3, 700.00 W, `chip_smoke.py [timing]`, in turns with the one-block
//   product tree): 0.08522 and 0.08621 ms against 0.14268 and 0.13965;
//   the tree's root inversion alone took 0.062 of its 0.149 ms.
//   ptxas (sm_90a, CUDA 12.8): 154 registers, no spills, 384 bytes of
//   stack (fp_inv's frame), no shared memory.
//   Bound (reduction): the norm a lazy sum of N = 2 squares (fp384.cuh:
//   N <= 9); the Fp products K1's CIOS; the Fp2 products N = 2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace {

constexpr int kPsiThreads = 32;      // one warp a block
constexpr int kPsiLanes = 8;         // K20: an element's lane group
constexpr int kPsiPerBlock = kPsiThreads / kPsiLanes;
static_assert(kPsiThreads % kPsiLanes == 0 && kPsiLanes < 32, "whole lane groups a warp");
constexpr int kInputsThreads = 32;   // K21: a lane a thread, one warp a block

// K20's operands: sig's and zsig's coordinates, CX and CY, then round 0's
// products (kRound0 + k: product k, on lanes 2k and 2k + 1 of the group).
enum PsiOperand { kSigX, kSigY, kSigZ, kZsigX, kZsigY, kZsigZ, kPsiCX, kPsiCY, kRound0, kPsiOff = 15 };
enum PsiMap { kAsIs, kConj, kNegated };
constexpr int kPsiRounds = 2;
constexpr int kPsiProducts = kPsiLanes / 2;
// Round r, product k (lanes 2k and 2k + 1 of the group, a component each,
// g2.cuh `fp2_mul_part`): {a, a's map, b, b's map}; kPsiOff: no product.
static __constant__ uint8_t kPsiLane[kPsiRounds][kPsiProducts][4] = {
    // X1 = conj(x) CX, Y1 = conj(y) CY (psi(sig)); X2 Z1 = zx conj(z), Y2 Z1 = (-zy) conj(z)
    {{kSigX, kConj, kPsiCX, kAsIs}, {kSigY, kConj, kPsiCY, kAsIs}, {kZsigX, kAsIs, kSigZ, kConj},
     {kZsigY, kNegated, kSigZ, kConj}},
    // X1 Z2, Y1 Z2
    {{kRound0 + 0, kAsIs, kZsigZ, kAsIs}, {kRound0 + 1, kAsIs, kZsigZ, kAsIs}, {kPsiOff, kAsIs, kPsiOff, kAsIs},
     {kPsiOff, kAsIs, kPsiOff, kAsIs}},
};
// Round 1's product k equals round 0's product kPsiEq[k] when the points
// agree: X1 Z2 == X2 Z1, Y1 Z2 == Y2 Z1.
static __constant__ uint8_t kPsiEq[kPsiProducts] = {2, 3, kPsiOff, kPsiOff};

// Operand `id` of element e under `map`, read from device memory.
__device__ __forceinline__ void psi_operand(fp2_t r, int id, int map, const uint32_t* const* coords,
                                            const long long* strides, const uint32_t* psi_c, long long e) {
  const uint32_t* src = psi_c + (id == kPsiCY ? 2 * FP_WORDS : 0);
#pragma unroll
  for (int i = 0; i < 6; ++i) src = id == i ? coords[i] + e * strides[i] : src;
  uint32_t t[FP_WORDS];
  fp2_load(r, src);
  fp_neg(t, r[0]);
  fp_select(r[0], map == kNegated, t, r[0]);
  fp_neg(t, r[1]);
  fp_select(r[1], map != kAsIs, t, r[1]);
}

__global__ void __launch_bounds__(kPsiThreads) g2_psi_check_kernel(
    const uint32_t* __restrict__ sx, long long ssx, const uint32_t* __restrict__ sy, long long ssy,
    const uint32_t* __restrict__ sz, long long ssz, const uint32_t* __restrict__ zx, long long szx,
    const uint32_t* __restrict__ zy, long long szy, const uint32_t* __restrict__ zz, long long szz,
    const uint32_t* __restrict__ psi_c, uint8_t* __restrict__ out, long long n) {
  const int lane = threadIdx.x, g = lane / kPsiLanes, k = (lane % kPsiLanes) >> 1, c = lane & 1;
  const int base = g * kPsiLanes;
  const long long e0 = (long long)blockIdx.x * kPsiPerBlock + g;
  const bool live = e0 < n;
  const long long e = live ? e0 : n - 1;  // every lane takes part in the shuffles
  const uint32_t* coords[6] = {sx, sy, sz, zx, zy, zz};
  const long long strides[6] = {ssx, ssy, ssz, szx, szy, szz};
  fp2_t a, b;
  uint32_t r0[FP_WORDS], r1[FP_WORDS] = {}, o[FP_WORDS];
  // round 0: four independent products, a component a lane
  const uint8_t* t = kPsiLane[0][k];
  psi_operand(a, t[0], t[1], coords, strides, psi_c, e);
  psi_operand(b, t[2], t[3], coords, strides, psi_c, e);
  fp2_mul_part(r0, a, b, c);
  // round 1: a round-0 product (both components, by shuffle) times an operand
  t = kPsiLane[1][k];
  const bool on = t[0] != kPsiOff;
  const int src = base + 2 * (on && t[0] >= kRound0 ? t[0] - kRound0 : 0);
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) {
    a[0][i] = __shfl_sync(0xffffffffu, r0[i], src);
    a[1][i] = __shfl_sync(0xffffffffu, r0[i], src + 1);
  }
  if (on) {
    if (t[0] < kRound0) psi_operand(a, t[0], t[1], coords, strides, psi_c, e);
    psi_operand(b, t[2], t[3], coords, strides, psi_c, e);
    fp2_mul_part(r1, a, b, c);
  }
  // the comparisons, component c on lane (k, c) against lane (kPsiEq[k], c)
  const int eq_k = kPsiEq[k];
  const bool compares = on && eq_k != kPsiOff;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) o[i] = __shfl_sync(0xffffffffu, r0[i], base + 2 * (compares ? eq_k : 0) + c);
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) diff |= compares ? r1[i] ^ o[i] : 0u;
  // the infinity flags: component c of sig's and zsig's z on every lane
  fp_load(o, sz + e * ssz + c * FP_WORDS);
  const bool sz_zero = fp_is_zero(o);
  fp_load(o, zz + e * szz + c * FP_WORDS);
  const bool zz_zero = fp_is_zero(o);
  const unsigned group = ((1u << kPsiLanes) - 1) << base;
  const bool eq = (__ballot_sync(0xffffffffu, diff == 0) & group) == group;
  const bool p_inf = (__ballot_sync(0xffffffffu, sz_zero) & group) == group;  // psi keeps z's zeros: sig_inf
  const bool q_inf = (__ballot_sync(0xffffffffu, zz_zero) & group) == group;
  if (live && lane == base) out[e] = ((p_inf && q_inf) || (!p_inf && !q_inf && eq) || p_inf) ? 1 : 0;
}

// Coordinate of G2 lane j: the hashes H_j (j < S, stride sh), then sig_acc.
__device__ __forceinline__ const uint32_t* g2_lane(const uint32_t* h, long long sh, const uint32_t* acc, long long j,
                                                   long long S) {
  return j < S ? h + j * sh : acc;
}

// K21's G1 blocks for S sets: a lane each, at least one (its first thread
// also writes lane S, the generator); the G2 blocks follow them.
__host__ __device__ inline long long inputs_g1_blocks(long long S) {
  return S > 0 ? (S + kInputsThreads - 1) / kInputsThreads : 1;
}

__global__ void __launch_bounds__(kInputsThreads) miller_inputs_kernel(
    const uint32_t* __restrict__ rx, long long srx, const uint32_t* __restrict__ ry, long long sry,
    const uint32_t* __restrict__ rz, long long srz, const uint32_t* __restrict__ hx, long long shx,
    const uint32_t* __restrict__ hy, long long shy, const uint32_t* __restrict__ hz, long long shz,
    const uint32_t* __restrict__ ax, const uint32_t* __restrict__ ay, const uint32_t* __restrict__ az,
    const uint32_t* __restrict__ gens, uint32_t* __restrict__ pxy, uint8_t* __restrict__ p_in,
    uint32_t* __restrict__ qxy, uint8_t* __restrict__ q_in, long long S) {
  const long long lanes = S + 1, g1_blocks = inputs_g1_blocks(S);
  uint32_t a[FP_WORDS], inv[FP_WORDS], r[FP_WORDS];
  if (blockIdx.x < g1_blocks) {  // G1 lane j: (x, y) / z; infinity: zeros
    const long long j = (long long)blockIdx.x * kInputsThreads + threadIdx.x;
    if (j == 0) {  // lane S: G1's generator (x, -y)
      fp_load(a, gens);
      fp_store(pxy + S * FP_WORDS, a);
      fp_load(a, gens + FP_WORDS);
      fp_store(pxy + (lanes + S) * FP_WORDS, a);
      p_in[S] = 0;
    }
    if (j >= S) return;
    fp_load(a, rz + j * srz);
    const bool inf = fp_is_zero(a);
    fp_inv(inv, a);  // 0 -> 0
    fp_load(a, rx + j * srx);
    fp_mul(r, a, inv);
    fp_store(pxy + j * FP_WORDS, r);
    fp_load(a, ry + j * sry);
    fp_mul(r, a, inv);
    fp_store(pxy + (lanes + j) * FP_WORDS, r);
    p_in[j] = inf ? 1 : 0;
    return;
  }
  // G2 lane j: (x, y) conj(z) / norm; infinity: zeros
  const long long j = (blockIdx.x - g1_blocks) * kInputsThreads + threadIdx.x;
  if (j >= lanes) return;
  fp2_t z, zi, x;
  uint32_t acc[FP_WIDE];
  fp2_load(z, g2_lane(hz, shz, az, j, S));
  const bool inf = fp2_is_zero(z);
  fp_mul_wide(acc, z[0], z[0]);
  fp_mac_wide(acc, z[1], z[1]);
  fp_redc_wide<1>(a, acc);  // the norm, zero exactly at infinity
  fp_inv(inv, a);           // 0 -> 0
  fp_mul(zi[0], z[0], inv);
  fp_mul(r, z[1], inv);
  fp_neg(zi[1], r);
  fp2_load(x, g2_lane(hx, shx, ax, j, S));
  fp2_mul(x, x, zi);
  fp2_store(qxy + j * 2 * FP_WORDS, x);
  fp2_load(x, g2_lane(hy, shy, ay, j, S));
  fp2_mul(x, x, zi);
  fp2_store(qxy + (lanes + j) * 2 * FP_WORDS, x);
  q_in[j] = inf ? 1 : 0;
}

}  // namespace

extern "C" {

int lh_g2_psi_check(const void* sx, long long ssx, const void* sy, long long ssy, const void* sz, long long ssz,
                    const void* zx, long long szx, const void* zy, long long szy, const void* zz, long long szz,
                    const void* psi_c, void* out, long long n, void* stream) {
  if (n > 0) {
    g2_psi_check_kernel<<<(unsigned)((n + kPsiPerBlock - 1) / kPsiPerBlock), kPsiThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)sx, ssx, (const uint32_t*)sy, ssy, (const uint32_t*)sz, ssz, (const uint32_t*)zx, szx,
        (const uint32_t*)zy, szy, (const uint32_t*)zz, szz, (const uint32_t*)psi_c, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_miller_inputs(const void* rx, long long srx, const void* ry, long long sry, const void* rz, long long srz,
                     const void* hx, long long shx, const void* hy, long long shy, const void* hz, long long shz,
                     const void* ax, const void* ay, const void* az, const void* gens, void* pxy, void* p_in,
                     void* qxy, void* q_in, long long S, void* stream) {
  if (S >= 0) {
    const long long blocks = inputs_g1_blocks(S) + (S + kInputsThreads) / kInputsThreads;
    miller_inputs_kernel<<<(unsigned)blocks, kInputsThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rx, srx, (const uint32_t*)ry, sry, (const uint32_t*)rz, srz, (const uint32_t*)hx, shx,
        (const uint32_t*)hy, shy, (const uint32_t*)hz, shz, (const uint32_t*)ax, (const uint32_t*)ay,
        (const uint32_t*)az, (const uint32_t*)gens, (uint32_t*)pxy, (uint8_t*)p_in, (uint32_t*)qxy,
        (uint8_t*)q_in, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
