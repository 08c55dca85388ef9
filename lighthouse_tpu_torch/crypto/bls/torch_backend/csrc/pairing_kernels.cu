// The Miller loop of the pairing, one launch per call, with a plain C
// launcher (extern "C", bound from Python with ctypes). The launcher runs
// on the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().
//
// K12 miller_loop_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/pairing.py:163
//   `miller_loop` (registered pairing.miller_loop), with `_dbl_step`
//   (:108), `_add_step` (:137) and `_mul_by_line` (:97) inside it; the
//   port's `pairing.miller_loop`, called once per verify on its S + 1
//   pairs (n = 129 at S = 128).
//   Computes: f_{|z|, Q}(P), conjugated for z < 0, per pair, by the plain
//   version's steps (`pairing.miller_loop_composed`): lanes where P or Q
//   is infinity take the generators; T = (qx, qy, 1), f = 1; for each of
//   the 63 bits of |z| below the leading one, MSB first: f = f^2, the
//   doubling step and its tangent line, f *= line; on the five set bits
//   also the mixed addition step and its chord line, f *= line; then f is
//   conjugated, and infinity lanes get one. The lines are exactly the
//   plain version's, so f is the same integers, not only the same after
//   the final exponentiation:
//     tangent  A0 = -xi Z3 Z^2 yp, A3 = 2Y^2 - 3X^3, A5 = 3X^2 Z^2 xp,
//              x3 = 9X^4 - 8XY^2, y3 = 3X^2 (4XY^2 - x3) - 8Y^4, z3 = 2YZ
//     chord    H = qx Z^2 - X, D = qy Z^3 - Y, A0 = -xi H Z yp,
//              A3 = qy H Z - D qx, A5 = D xp, x3 = D^2 - H^3 - 2 X H^2,
//              y3 = D (X H^2 - x3) - Y H^3, z3 = H Z
//   Every value is canonical, so the arithmetic inside a formula is
//   arranged freely (squares as products, 8C by additions).
//   Design: one block per pair, two warps, the state in shared memory.
//   Warp 1, the line warp, runs the T chain: the doubling step and its
//   tangent line, and on a set bit of |z| the addition step and its chord
//   line, in the plain version's formulas, groups and order (T is
//   projective, and its representative fixes the lines' integers). A
//   step's independent Fp2 products go to two lanes each, lane c forming
//   component c as one lazy sum (g2.cuh `fp2_mul_part`), in the port's
//   groups (doubling: X^2, Y^2, Z^2, 2YZ; then B^2, (X + B)^2, E^2, E X,
//   E Z^2, z3 Z^2; then E (D - x3); chord: Z^2; qx Z^2, Z Z^2; qy Z^3;
//   H^2, D^2, H Z; H^3, X H^2; then the four of y3 and A3), the additions
//   of a group on the lanes that need them, the Fp scalings by xp and yp
//   on four lanes, `__syncwarp` between groups. Warp 0, the f warp, runs
//   f = f^2, f *= tangent and, on set bits, f *= chord, each Fp12 product
//   on twelve lanes, lane 2k + c forming component c of coefficient e_k
//   as one lazy sum (tower.cuh `fp12_mul_lane`, modes kSquare and
//   kSparse), `__syncwarp` between products. f is an Fp12 element and its
//   canonical words are unique, so how its products are split over lanes
//   does not change a word. The warps meet on a two-slot ring of lines (a
//   slot: an iteration's tangent line and its chord line, 6 Fp2): warp 1
//   forms iteration 0's lines into slot 0 first; then in iteration i warp
//   0 multiplies slot i & 1's lines into f while warp 1 forms iteration
//   i + 1's into slot (i + 1) & 1, and one `__syncthreads` ends the
//   iteration. A slot is written one iteration before it is read and read
//   before it is written again. |z| is a compile-time constant, so both
//   warps know which iterations hold a chord. Warp 0 conjugates f at the
//   end and writes one in infinity lanes. Shared memory: f ping-pong
//   (1,152 bytes), the ring (1,152), T, Q, P and the 26 step slots, 5,376
//   bytes a block.
//   Work per pair, in the word products the function needs (an Fp2
//   product 744, an Fp2 square 600, an Fp product 300, an Fp12 square
//   10,080 and a sparse Fp12 product 9,648, as K8 counts them; products by
//   small constants are additions): a doubling step 6 squares, 5 products
//   and 4 Fp products, 8,520; an addition step 3 squares, 10 products and
//   4 Fp products, 10,440; 63 x (10,080 + 8,520 + 9,648) + 5 x (10,440 +
//   9,648) = 1,880,064, against 866 bytes moved (P, Q and the two flags
//   in, f out). Operations bound; at the verify path's 129 pairs it is
//   bound by the f warp's chain: per iteration a square of 12 wide
//   products and a sparse product of 6 a lane (and a second sparse
//   product on the five set bits), the line warp's steps beside them.
//   Bound (reduction): every Fp2 component is a sum of N = 2 products
//   below 2 p^2, one conditional subtraction (fp384.cuh: N <= 9); the Fp12
//   products K8's N = 12 (6 sparse), two subtractions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "g2.cuh"
#include "tower.cuh"

namespace {

constexpr int kMillerThreads = 64;  // warp 0: f; warp 1: the lines
constexpr uint64_t kAbsZ = 0xd201000000010000ull;
constexpr int kLoopBits = 63;  // the bits of |z| below the leading one

// the step's intermediates, one Fp2 slot each
enum Slot {
  kA, kB, kZZ, kZ3, kE, kXB, kC, kXB2, kF6, kEX, kEZZ, kM1, kX3, kDX, kZY,
  kH, kD, kHH, kDD, kHZ, kHHH, kV, kR0, kR1, kR2, kR3, kSlots
};

struct MillerShared {
  uint32_t f[2][kFp12Words];  // f, ping-pong (warp 0)
  fp2_t line[2][6];           // the ring: per slot A0, A3, A5 of the tangent, then of the chord
  fp2_t t[3];                 // T = (X, Y, Z) (warp 1)
  fp2_t q[2];                 // Q = (qx, qy)
  uint32_t p[2][FP_WORDS];    // P = (xp, yp)
  fp2_t s[kSlots];            // the steps' intermediates (warp 1)
};

// Component c of x y: one copy of the product for every call site.
__device__ __noinline__ void mul_part(uint32_t r[FP_WORDS], const fp2_t x, const fp2_t y, int c) {
  fp2_mul_part(r, x, y, c);
}

// Component c of x y into dst[c].
__device__ __forceinline__ void mul_part_to(fp2_t dst, const fp2_t x, const fp2_t y, int c) {
  uint32_t r[FP_WORDS];
  mul_part(r, x, y, c);
  fp_store(dst[c], r);
}

// Lane 2k + c of a twelve-lane group: one copy for both modes.
__device__ __noinline__ void fp12_lane(const uint32_t* a, const uint32_t* b, int k, int c, int mode, uint32_t* out) {
  fp12_mul_lane(a, b, k, c, mode, out);
}

// dst = a x for Fp2 a and Fp x, on lane j = 0, 1 (component j).
__device__ __forceinline__ void scale_part(fp2_t dst, const fp2_t a, const uint32_t x[FP_WORDS], int j) {
  uint32_t r[FP_WORDS];
  fp_mul(r, a[j], x);
  fp_store(dst[j], r);
}

// line[0] component c = xi (-zy): (-zy0) - (-zy1), (-zy0) + (-zy1).
__device__ __forceinline__ void a0_part(fp2_t line0, const fp2_t zy, int c) {
  uint32_t n0[FP_WORDS], n1[FP_WORDS], r[FP_WORDS], s[FP_WORDS];
  fp_neg(n0, zy[0]);
  fp_neg(n1, zy[1]);
  fp_sub(r, n0, n1);
  fp_add(s, n0, n1);
  fp_select(r, c == 1, s, r);
  fp_store(line0[c], r);
}

// The doubling step on lane t of the line warp: T = 2T, its tangent line
// (A0, A3, A5) into `line`. Every lane of the warp calls it.
__device__ __forceinline__ void tangent_step(MillerShared& sh, fp2_t* line, int t) {
  const int k = t >> 1, c = t & 1;
  // A = X^2, B = Y^2, ZZ = Z^2, z3 = 2 Y Z
  if (t < 8) {
    const int xs = k == 3 ? 1 : k, ys = k == 3 ? 2 : k;
    uint32_t r[FP_WORDS];
    mul_part(r, sh.t[xs], sh.t[ys], c);
    if (k == 3) fp_add(r, r, r);
    fp_store(sh.s[k == 0 ? kA : k == 1 ? kB : k == 2 ? kZZ : kZ3][c], r);
  }
  __syncwarp();
  // E = 3A, XB = X + B
  if (t < 4) {
    uint32_t r[FP_WORDS];
    if (k == 0) {
      fp_add(r, sh.s[kA][c], sh.s[kA][c]);
      fp_add(r, r, sh.s[kA][c]);
    } else {
      fp_add(r, sh.t[0][c], sh.s[kB][c]);
    }
    fp_store(sh.s[k == 0 ? kE : kXB][c], r);
  }
  __syncwarp();
  // C = B^2, XB2 = (X + B)^2, F6 = E^2, EX = E X, EZZ = E ZZ, M1 = z3 ZZ
  if (t < 12) {
    const fp2_t* x = k == 0 ? &sh.s[kB] : k == 1 ? &sh.s[kXB] : k == 5 ? &sh.s[kZ3] : &sh.s[kE];
    const fp2_t* y = k == 0 ? &sh.s[kB] : k == 1 ? &sh.s[kXB] : k == 2 ? &sh.s[kE] : k == 3 ? &sh.t[0] : &sh.s[kZZ];
    mul_part_to(sh.s[k == 0 ? kC : k == 1 ? kXB2 : k == 2 ? kF6 : k == 3 ? kEX : k == 4 ? kEZZ : kM1], *x, *y, c);
  }
  __syncwarp();
  if (t < 2) {  // D = 2 (XB2 - (A + C)), x3 = F6 - 2D, DX = D - x3
    uint32_t a[FP_WORDS], d[FP_WORDS], x3[FP_WORDS];
    fp_add(a, sh.s[kA][c], sh.s[kC][c]);
    fp_sub(d, sh.s[kXB2][c], a);
    fp_add(d, d, d);
    fp_add(a, d, d);
    fp_sub(x3, sh.s[kF6][c], a);
    fp_store(sh.s[kX3][c], x3);
    fp_sub(d, d, x3);
    fp_store(sh.s[kDX][c], d);
  } else if (t < 4) {  // A3 = 2B - EX
    uint32_t r[FP_WORDS];
    fp_add(r, sh.s[kB][c], sh.s[kB][c]);
    fp_sub(r, r, sh.s[kEX][c]);
    fp_store(line[1][c], r);
  } else if (t < 8) {  // A5 = EZZ xp, zy = M1 yp
    const int j = t & 1;
    if (t < 6) {
      scale_part(line[2], sh.s[kEZZ], sh.p[0], j);
    } else {
      scale_part(sh.s[kZY], sh.s[kM1], sh.p[1], j);
    }
  }
  __syncwarp();
  if (t < 2) {  // T = (x3, E DX - 8C, z3)
    uint32_t r[FP_WORDS], c8[FP_WORDS];
    mul_part(r, sh.s[kE], sh.s[kDX], c);
    fp_add(c8, sh.s[kC][c], sh.s[kC][c]);
    fp_add(c8, c8, c8);
    fp_add(c8, c8, c8);
    fp_sub(r, r, c8);
    fp_store(sh.t[1][c], r);
    fp_store(sh.t[0][c], sh.s[kX3][c]);
    fp_store(sh.t[2][c], sh.s[kZ3][c]);
  } else if (t < 4) {
    a0_part(line[0], sh.s[kZY], c);
  }
  __syncwarp();
}

// The mixed addition step on lane t of the line warp: T = T + Q, its
// chord line (A0, A3, A5) into `line`. Every lane of the warp calls it.
__device__ __forceinline__ void chord_step(MillerShared& sh, fp2_t* line, int t) {
  const int k = t >> 1, c = t & 1;
  // ZZ = Z^2
  if (t < 2) mul_part_to(sh.s[kZZ], sh.t[2], sh.t[2], c);
  __syncwarp();
  // H = qx ZZ - X, M1 = Z ZZ
  if (t < 4) {
    uint32_t r[FP_WORDS];
    mul_part(r, k == 0 ? sh.q[0] : sh.t[2], sh.s[kZZ], c);
    if (k == 0) fp_sub(r, r, sh.t[0][c]);
    fp_store(sh.s[k == 0 ? kH : kM1][c], r);
  }
  __syncwarp();
  // D = qy M1 - Y
  if (t < 2) {
    uint32_t r[FP_WORDS];
    mul_part(r, sh.q[1], sh.s[kM1], c);
    fp_sub(r, r, sh.t[1][c]);
    fp_store(sh.s[kD][c], r);
  }
  __syncwarp();
  // HH = H^2, DD = D^2, hz = H Z
  if (t < 6) {
    const fp2_t* x = k == 1 ? &sh.s[kD] : &sh.s[kH];
    const fp2_t* y = k == 0 ? &sh.s[kH] : k == 1 ? &sh.s[kD] : &sh.t[2];
    mul_part_to(sh.s[k == 0 ? kHH : k == 1 ? kDD : kHZ], *x, *y, c);
  }
  __syncwarp();
  // HHH = H HH, V = X HH; hy = hz yp, A5 = D xp
  if (t < 4) {
    mul_part_to(sh.s[k == 0 ? kHHH : kV], k == 0 ? sh.s[kH] : sh.t[0], sh.s[kHH], c);
  } else if (t < 8) {
    const int j = t & 1;
    if (t < 6) {
      scale_part(sh.s[kZY], sh.s[kHZ], sh.p[1], j);
    } else {
      scale_part(line[2], sh.s[kD], sh.p[0], j);
    }
  }
  __syncwarp();
  if (t < 2) {  // x3 = DD - HHH - 2V, DX = V - x3
    uint32_t a[FP_WORDS], x3[FP_WORDS];
    fp_sub(x3, sh.s[kDD][c], sh.s[kHHH][c]);
    fp_add(a, sh.s[kV][c], sh.s[kV][c]);
    fp_sub(x3, x3, a);
    fp_store(sh.s[kX3][c], x3);
    fp_sub(a, sh.s[kV][c], x3);
    fp_store(sh.s[kDX][c], a);
  } else if (t < 4) {
    a0_part(line[0], sh.s[kZY], c);
  }
  __syncwarp();
  // R0 = D DX, R1 = Y HHH, R2 = qy hz, R3 = D qx
  if (t < 8) {
    const fp2_t* x = k == 1 ? &sh.t[1] : k == 2 ? &sh.q[1] : &sh.s[kD];
    const fp2_t* y = k == 0 ? &sh.s[kDX] : k == 1 ? &sh.s[kHHH] : k == 2 ? &sh.s[kHZ] : &sh.q[0];
    mul_part_to(sh.s[kR0 + k], *x, *y, c);
  }
  __syncwarp();
  if (t < 2) {  // T = (x3, R0 - R1, hz)
    uint32_t r[FP_WORDS];
    fp_sub(r, sh.s[kR0][c], sh.s[kR1][c]);
    fp_store(sh.t[1][c], r);
    fp_store(sh.t[0][c], sh.s[kX3][c]);
    fp_store(sh.t[2][c], sh.s[kHZ][c]);
  } else if (t < 4) {  // A3 = R2 - R3
    uint32_t r[FP_WORDS];
    fp_sub(r, sh.s[kR2][c], sh.s[kR3][c]);
    fp_store(line[1][c], r);
  }
  __syncwarp();
}

// Whether iteration i (0 = the bit of |z| below the leading one) holds a chord.
__device__ __forceinline__ bool chord_at(int i) { return (kAbsZ >> (kLoopBits - 1 - i)) & 1; }

__global__ void __launch_bounds__(kMillerThreads) miller_loop_kernel(
    const uint32_t* __restrict__ px, long long spx, const uint32_t* __restrict__ py, long long spy,
    const uint32_t* __restrict__ qx, long long sqx, const uint32_t* __restrict__ qy, long long sqy,
    const bool* __restrict__ p_inf, const bool* __restrict__ q_inf, const uint32_t* __restrict__ gens,
    uint32_t* __restrict__ out, long long n) {
  __shared__ MillerShared sh;

  const long long e = blockIdx.x;
  if (e >= n) return;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const bool inf = p_inf[e] || q_inf[e];

  // P, Q (or the generators), T = (qx, qy, 1) on warp 1; f = 1 on warp 0
  if (warp == 1) {
    if (t < 6) {
      const uint32_t* src = t == 0 ? px + e * spx : t == 1 ? py + e * spy
                          : t < 4 ? qx + e * sqx + (t - 2) * FP_WORDS : qy + e * sqy + (t - 4) * FP_WORDS;
      uint32_t v[FP_WORDS];
      fp_load(v, inf ? gens + t * FP_WORDS : src);
      if (t < 2) {
        fp_store(sh.p[t], v);
      } else {
        fp_store(sh.q[(t - 2) >> 1][t & 1], v);
        fp_store(sh.t[(t - 2) >> 1][t & 1], v);
      }
    } else if (t < 8) {
#pragma unroll
      for (int i = 0; i < FP_WORDS; ++i) sh.t[2][t - 6][i] = t == 6 ? FP_ONE[i] : 0u;
    }
  } else {
    for (int i = t; i < kFp12Words; i += 32) sh.f[0][i] = i < FP_WORDS ? FP_ONE[i] : 0u;
  }
  __syncthreads();

  // Iteration -1: warp 1 forms iteration 0's lines. Iteration i >= 0: warp
  // 0 takes iteration i's lines (slot i & 1) into f, warp 1 forms
  // iteration i + 1's (slot (i + 1) & 1).
  const int k = t >> 1, c = t & 1;
  int cur = 0;
#pragma unroll 1
  for (int i = -1; i < kLoopBits; ++i) {
    if (warp == 0) {
      if (i >= 0) {
        const uint32_t* line = &sh.line[i & 1][0][0][0];
        if (t < 12) fp12_lane(sh.f[cur], sh.f[cur], k, c, kSquare, sh.f[cur ^ 1]);
        cur ^= 1;
        __syncwarp();
        if (t < 12) fp12_lane(sh.f[cur], line, k, c, kSparse, sh.f[cur ^ 1]);
        cur ^= 1;
        if (chord_at(i)) {
          __syncwarp();
          if (t < 12) fp12_lane(sh.f[cur], line + 3 * kFp2Words, k, c, kSparse, sh.f[cur ^ 1]);
          cur ^= 1;
        }
      }
    } else if (i + 1 < kLoopBits) {
      fp2_t* slot = sh.line[(i + 1) & 1];
      tangent_step(sh, slot, t);
      if (chord_at(i + 1)) chord_step(sh, slot + 3, t);
    }
    __syncthreads();
  }

  // conjugate (negate the w^1 half), one in infinity lanes
  if (warp == 0 && t < 12) {
    uint32_t v[FP_WORDS];
    fp_load(v, sh.f[cur] + t * FP_WORDS);
    if (t >= 6) fp_neg(v, v);
#pragma unroll
    for (int i = 0; i < FP_WORDS; ++i) {
      if (inf) v[i] = t == 0 ? FP_ONE[i] : 0u;
    }
    fp_store(out + e * kFp12Words + t * FP_WORDS, v);
  }
}

}  // namespace

extern "C" {

int lh_miller_loop(const void* px, long long spx, const void* py, long long spy, const void* qx, long long sqx,
                   const void* qy, long long sqy, const void* p_inf, const void* q_inf, const void* gens, void* out,
                   long long n, void* stream) {
  if (n > 0) {
    miller_loop_kernel<<<(unsigned)n, kMillerThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, spx, (const uint32_t*)py, spy, (const uint32_t*)qx, sqx, (const uint32_t*)qy, sqy,
        (const bool*)p_inf, (const bool*)q_inf, (const uint32_t*)gens, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
