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
//   two MSB-first double-and-add passes over |z| of 63 doublings and 5
//   complete additions each, the second pass's base the first's result.
//   Design: a quad of four lanes a key, eight keys a one-warp block. Each
//   lane of a quad holds the key's accumulator in registers, and an RCB
//   level's products (curve.cuh's lane-group law, its steps and values:
//   RCB 2016 Algorithms 9 and 7 with the products by 3b as `fp_mul12`)
//   are spread over the quad, lane q forming product q (`quad_dbl`: A =
//   Y Y, B = Y Z, C = Z Z, D = X Y, then four products of the middle's
//   values; `quad_add`: six products a level in two rounds, lanes 2 and
//   3 repeating lanes 0 and 1 in the second). Each level's products reach
//   every lane of the quad by `__shfl_sync` (`quad_gather`), and every lane
//   forms the additions between the levels itself, so the quad's four
//   copies of the accumulator stay equal and no lane waits on shared
//   memory or a barrier: a doubling is two product latencies where one
//   thread waits on eight, an addition four where it waits on twelve, and
//   all 32 lanes of a warp form products. The pass's base lies in shared
//   memory (144 bytes a key), read in the additions. After the chain one
//   more pair of rounds forms g1_eq's cross-products of phi(P) =
//   (beta x : y : 1) and -[z^2] P = (X : -Y : Z): lane 0 (beta x) Z, lane
//   1 X 1, lane 2 y Z, lane 3 -(Y 1) (the first round the products by
//   beta or one, the second by Z or one); each lane against its partner
//   (`__shfl_xor_sync`), and one `__ballot_sync` over the quad gives the
//   verdict: both pairs equal and Z != 0 (P is finite, so eq_points'
//   infinity cases reduce to that). beta is read from a device array the
//   caller fills with the same Montgomery constant as the plain version
//   (curve.PHI_BETA), so the two cannot disagree on the cube root. The
//   complete formulas have no branch on the data: the points of E(Fp)
//   outside G1, such as (0, 2) of order 3, meet P + (-P) and infinity
//   inside the chain and are handled like any other point (E(Fp) has odd
//   order: no point of order 2). A quad past n or at an infinity row runs
//   infinity (0 : 1 : 0) through the chain and stores nothing of it; a
//   warp with no key to check writes its zeros and leaves, so infinity
//   rows cost nothing.
//   Bound: operations. The function needs per key 126 doublings (6
//   products and 2 squares each; the products by 3b are additions), 10
//   complete additions (12 products) and 5 products for phi and the
//   cross-multiplied comparison: 881 products of 300 word products and
//   252 squares of 234, 323,268 word products, against 98 bytes moved (x,
//   y, inf in, the verdict out). The kernel forms every square as a
//   product, lanes 2 and 3 repeat two products of each addition level,
//   and the comparison takes 8: 1,176 products, 352,800 word products a
//   key. Infinity rows return at once and cost nothing. At 16 keys the
//   time is one quad's chain of 294 product latencies (two a doubling,
//   four an addition, two for the comparison); at 16,384 the card is full
//   (2,048 warps) and the time is the throughput of every lane's products.
//   Measured (NVIDIA H100 80GB HBM3, 700.00 W, `chip_smoke.py [timing]`,
//   in turns with the thread a key): 1.09069 and 1.09326 ms at S = 16,384
//   against 1.29915 and 1.29827; 0.37386 and 0.37344 at S = 16 (`[pk]`
//   k5_device_ms 0.3725 against 1.2656). Timed and dropped
//   (`chip_probes/k4_k5_schedules.py`, PERF.md): curve.cuh's shared-memory
//   lane-group law on six lanes a key, 0.585 ms at S = 16 but 2.13 at
//   16,384 with five groups a warp (8.73 with one); launch bounds of 12,
//   16 or 20 blocks an SM (168, 128, 96 registers, spills), within 7 %.
//   ptxas (sm_90a, CUDA 12.8): 155 registers, no stack, no spills, 1,152
//   bytes of shared memory (the thread a key: 186 registers).
//   Bound (reduction): every product is K1's CIOS (fp384.cuh `fp_mul`),
//   canonical in and canonical out (below 2p before its one conditional
//   subtraction); the additions between the levels are fp_add / fp_sub /
//   `fp_mul12` of canonical values, canonical each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "g1.cuh"

namespace {

constexpr int kThreads = 32;               // one warp a block
constexpr int kQuad = 4;                   // lanes a key
constexpr int kKeys = kThreads / kQuad;    // keys a block
constexpr uint64_t kAbsZ = 0xd201000000010000ull;  // |z|, z the BLS12-381 parameter
constexpr int kAbsZTop = 63;               // |z|'s top bit

// r = (x0, x1, x2, x3)[q], branch-free.
__device__ __forceinline__ void fp_pick(uint32_t r[FP_WORDS], int q, const uint32_t x0[FP_WORDS],
                                        const uint32_t x1[FP_WORDS], const uint32_t x2[FP_WORDS],
                                        const uint32_t x3[FP_WORDS]) {
#pragma unroll
  for (int i = 0; i < FP_WORDS; ++i) r[i] = q == 0 ? x0[i] : q == 1 ? x1[i] : q == 2 ? x2[i] : x3[i];
}

// v[j] = lane j's r, for the quad whose lane 0 is warp lane `base`.
__device__ __forceinline__ void quad_gather(uint32_t v[kQuad][FP_WORDS], const uint32_t r[FP_WORDS], int base) {
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
#pragma unroll
    for (int w = 0; w < FP_WORDS; ++w) v[j][w] = __shfl_sync(0xffffffffu, r[w], base + j);
  }
}

// p = 2 p on a quad, lane q (RCB 2016 Algorithm 9, a = 0).
__device__ __forceinline__ void quad_dbl(G1Proj& p, int q, int base) {
  uint32_t a[FP_WORDS], b[FP_WORDS], r[FP_WORDS], v[kQuad][FP_WORDS];
  fp_pick(a, q, p.y, p.y, p.z, p.x);  // A = Y Y, B = Y Z, C = Z Z, D = X Y
  fp_pick(b, q, p.y, p.z, p.z, p.y);
  fp_mul(r, a, b);
  quad_gather(v, r, base);
  uint32_t t[FP_WORDS], e[FP_WORDS], f[FP_WORDS], g[FP_WORDS];
  fp_mul12(t, v[2]);  // 3b C
  fp_add(e, v[0], t);  // A + 3b C
  fp_add(f, t, t);
  fp_add(f, f, t);
  fp_sub(f, v[0], f);  // A - 9b C
  fp_add(g, v[0], v[0]);
  fp_add(g, g, g);
  fp_add(g, g, g);  // 8 A
  fp_pick(a, q, f, v[1], t, f);  // (A - 9bC) D, B 8A, 3bC 8A, (A - 9bC)(A + 3bC)
  fp_pick(b, q, v[3], g, g, e);
  fp_mul(r, a, b);
  quad_gather(v, r, base);
  fp_add(p.x, v[0], v[0]);  // X3 = 2 (A - 9bC) D
  fp_add(p.y, v[2], v[3]);  // Y3 = 3bC 8A + (A - 9bC)(A + 3bC)
  fp_copy(p.z, v[1]);       // Z3 = B 8A
}

// p = p + o on a quad, lane q (RCB 2016 Algorithm 7, a = 0); o in shared
// memory.
__device__ __forceinline__ void quad_add(G1Proj& p, const G1Proj& o, int q, int base) {
  uint32_t a[FP_WORDS], b[FP_WORDS], r[FP_WORDS], v[kQuad][FP_WORDS], w[2][FP_WORDS];
  // level 1: X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2); then (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
  uint32_t s1[FP_WORDS], s2[FP_WORDS];
  fp_add(s1, p.x, p.y);
  fp_add(s2, o.x, o.y);
  fp_pick(a, q, p.x, p.y, p.z, s1);
  fp_pick(b, q, o.x, o.y, o.z, s2);
  fp_mul(r, a, b);
  quad_gather(v, r, base);  // t0, t1, t2, m3
  fp_select(s1, q & 1, p.x, p.y);
  fp_add(a, s1, p.z);
  fp_select(s2, q & 1, o.x, o.y);
  fp_add(b, s2, o.z);
  fp_mul(r, a, b);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < FP_WORDS; ++i) w[j][i] = __shfl_sync(0xffffffffu, r[i], base + j);  // m4, m5
  }
  // the middle: t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, y3 = 3b (m5 - t0 - t2), 3 t0, z3 = t1 + 3b t2,
  // t1' = t1 - 3b t2
  uint32_t t3[FP_WORDS], t4[FP_WORDS], y3[FP_WORDS], s0[FP_WORDS], z3[FP_WORDS], t1[FP_WORDS];
  fp_sub(t3, v[3], v[0]);
  fp_sub(t3, t3, v[1]);
  fp_sub(t4, w[0], v[1]);
  fp_sub(t4, t4, v[2]);
  fp_sub(y3, w[1], v[0]);
  fp_sub(y3, y3, v[2]);
  fp_mul12(y3, y3);
  fp_add(s0, v[0], v[0]);
  fp_add(s0, s0, v[0]);
  fp_mul12(r, v[2]);
  fp_add(z3, v[1], r);
  fp_sub(t1, v[1], r);
  // level 2: t4 y3, t3 t1', y3 3t0, t1' z3; then 3t0 t3, z3 t4
  fp_pick(a, q, t4, t3, y3, t1);
  fp_pick(b, q, y3, t1, s0, z3);
  fp_mul(r, a, b);
  quad_gather(v, r, base);
  fp_select(a, q & 1, z3, s0);
  fp_select(b, q & 1, t4, t3);
  fp_mul(r, a, b);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < FP_WORDS; ++i) w[j][i] = __shfl_sync(0xffffffffu, r[i], base + j);
  }
  fp_sub(p.x, v[1], v[0]);  // X3 = t3 t1' - t4 y3
  fp_add(p.y, v[3], v[2]);  // Y3 = t1' z3 + y3 3t0
  fp_add(p.z, w[1], w[0]);  // Z3 = z3 t4 + 3t0 t3
}

__global__ void __launch_bounds__(kThreads) g1_subgroup_check_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y, const uint8_t* __restrict__ inf,
    const uint32_t* __restrict__ beta, uint8_t* __restrict__ out, long long n) {
  __shared__ G1Proj bases[kKeys];
  const int lane = threadIdx.x, q = lane % kQuad, base = lane - q;
  const long long i = (long long)blockIdx.x * kKeys + lane / kQuad;
  const bool mine = i < n;
  const bool on = mine && !inf[i];
  if (!__any_sync(0xffffffffu, on)) {  // infinity rows only
    if (mine && q == 0) out[i] = 0;
    return;
  }
  const long long e = on ? i : 0;  // an off quad runs (0 : 1 : 0)
  G1Proj acc;
  fp_load(acc.x, x + e * FP_WORDS);
  fp_load(acc.y, y + e * FP_WORDS);
  fp_set_one(acc.z);
#pragma unroll
  for (int w = 0; w < FP_WORDS; ++w) {
    acc.x[w] = on ? acc.x[w] : 0u;
    acc.y[w] = on ? acc.y[w] : acc.z[w];
    acc.z[w] = on ? acc.z[w] : 0u;
  }
  G1Proj& o = bases[lane / kQuad];
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    __syncwarp();  // the last pass's reads of the base are done
    if (q == 0) o = acc;  // the pass's base: P, then [|z|] P
    __syncwarp();
#pragma unroll 1
    for (int b = kAbsZTop - 1; b >= 0; --b) {
      quad_dbl(acc, q, base);
      if ((kAbsZ >> b) & 1u) quad_add(acc, o, q, base);
    }
  }
  // g1_eq(phi(P), -[z^2] P): lane 0 (beta x) Z, lane 1 X 1, lane 2 y Z, lane 3 -(Y 1); P reloaded, so
  // that it is not live across the chain
  uint32_t a[FP_WORDS], c[FP_WORDS], u[FP_WORDS], r[FP_WORDS], one[FP_WORDS];
  fp_set_one(one);
  fp_load(a, (q == 0 ? x : y) + e * FP_WORDS);
  fp_load(c, beta);
  fp_pick(a, q, a, acc.x, a, acc.y);
  fp_pick(c, q, c, one, one, one);
  fp_mul(u, a, c);
  fp_select(c, q & 1, one, acc.z);
  fp_mul(r, u, c);
  if (q == 3) fp_neg(r, r);
  uint32_t diff = 0;
#pragma unroll
  for (int w = 0; w < FP_WORDS; ++w) diff |= r[w] ^ __shfl_xor_sync(0xffffffffu, r[w], 1);
  const bool z_zero = q == 0 && fp_is_zero(acc.z);
  const unsigned bad = __ballot_sync(0xffffffffu, on && (diff != 0 || z_zero));
  if (mine && q == 0) out[i] = on && ((bad >> base) & 0xfu) == 0 ? 1 : 0;
}

}  // namespace

extern "C" {

int lh_g1_subgroup_check(const void* x, const void* y, const void* inf, const void* beta, void* out,
                         long long n, void* stream) {
  if (n > 0) {
    g1_subgroup_check_kernel<<<(unsigned)((n + kKeys - 1) / kKeys), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint8_t*)inf, (const uint32_t*)beta, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
