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
//   Design: one block (one warp) per pair, the state in shared memory:
//   T, f (two buffers, ping-pong), the line, the step's intermediates.
//   A step's independent Fp2 products go to two threads each, thread c
//   forming component c as one lazy sum (g2.cuh `fp2_mul_part`), in the
//   port's groups (doubling: X^2, Y^2, Z^2, 2YZ; then B^2, (X + B)^2,
//   E^2, E X, E Z^2, z3 Z^2; then E (D - x3); chord: Z^2; qx Z^2, Z Z^2;
//   qy Z^3; H^2, D^2, H Z; H^3, X H^2; then the four of y3 and A3), the
//   additions of a group on the threads that need them, the Fp scalings
//   by xp and yp on four threads, `__syncwarp` between groups. The Fp12
//   square and the sparse product by the line are K8's six-thread routine
//   (tower.cuh `fp12_mul_thread`, modes kSquare and kSparse). |z| is a
//   compile-time constant. The T chain does not depend on f, so the next
//   line could be formed while f is squared (by a second warp); that
//   overlap is left to a later change.
//   Work per pair, in the word products the function needs (an Fp2
//   product 744, an Fp2 square 600, an Fp product 300, an Fp12 square
//   10,080 and a sparse Fp12 product 9,648, as K8 counts them; products by
//   small constants are additions): a doubling step 6 squares, 5 products
//   and 4 Fp products, 8,520; an addition step 3 squares, 10 products and
//   4 Fp products, 10,440; 63 x (10,080 + 8,520 + 9,648) + 5 x (10,440 +
//   9,648) = 1,880,064, against 866 bytes moved (P, Q and the two flags
//   in, f out). Operations bound; at the verify path's 129 pairs it is
//   bound by one warp's chain of 68 steps.
//   Bound (reduction): every Fp2 component is a sum of N = 2 products
//   below 2 p^2, one conditional subtraction (fp384.cuh: N <= 9); the Fp12
//   products K8's N = 12 (6 sparse), two subtractions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"
#include "g2.cuh"
#include "tower.cuh"

namespace {

constexpr int kMillerThreads = 32;  // one warp per pair
constexpr uint64_t kAbsZ = 0xd201000000010000ull;
constexpr int kLoopBits = 63;  // the bits of |z| below the leading one

// the step's intermediates, one Fp2 slot each
enum Slot {
  kA, kB, kZZ, kZ3, kE, kXB, kC, kXB2, kF6, kEX, kEZZ, kM1, kX3, kDX, kZY,
  kH, kD, kHH, kDD, kHZ, kHHH, kV, kR0, kR1, kR2, kR3, kSlots
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

// Thread k of a six-thread group: K8's routine, one copy for both modes.
__device__ __noinline__ void fp12_part(const uint32_t* a, const uint32_t* b, int k, int mode, uint32_t* out) {
  fp12_mul_thread(a, b, k, mode, out);
}

// dst = a x for Fp2 a and Fp x, on thread j = 0, 1 (component j).
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

__global__ void __launch_bounds__(kMillerThreads) miller_loop_kernel(
    const uint32_t* __restrict__ px, long long spx, const uint32_t* __restrict__ py, long long spy,
    const uint32_t* __restrict__ qx, long long sqx, const uint32_t* __restrict__ qy, long long sqy,
    const bool* __restrict__ p_inf, const bool* __restrict__ q_inf, const uint32_t* __restrict__ gens,
    uint32_t* __restrict__ out, long long n) {
  __shared__ uint32_t sh_f[2][kFp12Words];  // f, ping-pong
  __shared__ fp2_t sh_t[3];                 // T = (X, Y, Z)
  __shared__ fp2_t sh_q[2];                 // Q = (qx, qy)
  __shared__ uint32_t sh_p[2][FP_WORDS];    // P = (xp, yp)
  __shared__ fp2_t sh_line[3];              // A0, A3, A5: the sparse operand
  __shared__ fp2_t sh_s[kSlots];

  const long long e = blockIdx.x;
  if (e >= n) return;
  const int t = threadIdx.x;
  const int k = t >> 1, c = t & 1;
  const bool inf = p_inf[e] || q_inf[e];

  // P, Q (or the generators), T = (qx, qy, 1), f = 1
  if (t < 6) {
    const uint32_t* src = t == 0 ? px + e * spx : t == 1 ? py + e * spy
                        : t < 4 ? qx + e * sqx + (t - 2) * FP_WORDS : qy + e * sqy + (t - 4) * FP_WORDS;
    uint32_t v[FP_WORDS];
    fp_load(v, inf ? gens + t * FP_WORDS : src);
    if (t < 2) {
      fp_store(sh_p[t], v);
    } else {
      fp_store(sh_q[(t - 2) >> 1][t & 1], v);
      fp_store(sh_t[(t - 2) >> 1][t & 1], v);
    }
  } else if (t < 8) {
#pragma unroll
    for (int i = 0; i < FP_WORDS; ++i) sh_t[2][t - 6][i] = t == 6 ? FP_ONE[i] : 0u;
  }
  for (int i = t; i < kFp12Words; i += kMillerThreads) {
    sh_f[0][i] = i < FP_WORDS ? FP_ONE[i] : 0u;
  }
  __syncwarp();

  int cur = 0;
#pragma unroll 1
  for (int s = kLoopBits - 1; s >= 0; --s) {
    // f = f^2
    if (t < 6) fp12_part(sh_f[cur], sh_f[cur], t, kSquare, sh_f[cur ^ 1]);
    cur ^= 1;
    // doubling step: A = X^2, B = Y^2, ZZ = Z^2, z3 = 2 Y Z
    if (t < 8) {
      const int xs = k == 3 ? 1 : k, ys = k == 3 ? 2 : k;
      uint32_t r[FP_WORDS];
      mul_part(r, sh_t[xs], sh_t[ys], c);
      if (k == 3) fp_add(r, r, r);
      fp_store(sh_s[k == 0 ? kA : k == 1 ? kB : k == 2 ? kZZ : kZ3][c], r);
    }
    __syncwarp();
    // E = 3A, XB = X + B
    if (t < 4) {
      uint32_t r[FP_WORDS];
      if (k == 0) {
        fp_add(r, sh_s[kA][c], sh_s[kA][c]);
        fp_add(r, r, sh_s[kA][c]);
      } else {
        fp_add(r, sh_t[0][c], sh_s[kB][c]);
      }
      fp_store(sh_s[k == 0 ? kE : kXB][c], r);
    }
    __syncwarp();
    // C = B^2, XB2 = (X + B)^2, F6 = E^2, EX = E X, EZZ = E ZZ, M1 = z3 ZZ
    if (t < 12) {
      const fp2_t* x = k == 0 ? &sh_s[kB] : k == 1 ? &sh_s[kXB] : k == 5 ? &sh_s[kZ3] : &sh_s[kE];
      const fp2_t* y = k == 0 ? &sh_s[kB] : k == 1 ? &sh_s[kXB] : k == 2 ? &sh_s[kE]
                     : k == 3 ? &sh_t[0] : &sh_s[kZZ];
      mul_part_to(sh_s[k == 0 ? kC : k == 1 ? kXB2 : k == 2 ? kF6 : k == 3 ? kEX : k == 4 ? kEZZ : kM1], *x, *y, c);
    }
    __syncwarp();
    if (t < 2) {  // D = 2 (XB2 - (A + C)), x3 = F6 - 2D, DX = D - x3
      uint32_t a[FP_WORDS], d[FP_WORDS], x3[FP_WORDS];
      fp_add(a, sh_s[kA][c], sh_s[kC][c]);
      fp_sub(d, sh_s[kXB2][c], a);
      fp_add(d, d, d);
      fp_add(a, d, d);
      fp_sub(x3, sh_s[kF6][c], a);
      fp_store(sh_s[kX3][c], x3);
      fp_sub(d, d, x3);
      fp_store(sh_s[kDX][c], d);
    } else if (t < 4) {  // A3 = 2B - EX
      uint32_t r[FP_WORDS];
      fp_add(r, sh_s[kB][c], sh_s[kB][c]);
      fp_sub(r, r, sh_s[kEX][c]);
      fp_store(sh_line[1][c], r);
    } else if (t < 8) {  // A5 = EZZ xp, zy = M1 yp
      const int j = t & 1;
      if (t < 6) {
        scale_part(sh_line[2], sh_s[kEZZ], sh_p[0], j);
      } else {
        scale_part(sh_s[kZY], sh_s[kM1], sh_p[1], j);
      }
    }
    __syncwarp();
    if (t < 2) {  // T = (x3, E DX - 8C, z3)
      uint32_t r[FP_WORDS], c8[FP_WORDS];
      mul_part(r, sh_s[kE], sh_s[kDX], c);
      fp_add(c8, sh_s[kC][c], sh_s[kC][c]);
      fp_add(c8, c8, c8);
      fp_add(c8, c8, c8);
      fp_sub(r, r, c8);
      fp_store(sh_t[1][c], r);
      fp_store(sh_t[0][c], sh_s[kX3][c]);
      fp_store(sh_t[2][c], sh_s[kZ3][c]);
    } else if (t < 4) {
      a0_part(sh_line[0], sh_s[kZY], c);
    }
    __syncwarp();
    // f *= line
    if (t < 6) fp12_part(sh_f[cur], &sh_line[0][0][0], t, kSparse, sh_f[cur ^ 1]);
    cur ^= 1;
    __syncwarp();

    if ((kAbsZ >> s) & 1) {
      // addition step: ZZ = Z^2
      if (t < 2) mul_part_to(sh_s[kZZ], sh_t[2], sh_t[2], c);
      __syncwarp();
      // H = qx ZZ - X, M1 = Z ZZ
      if (t < 4) {
        uint32_t r[FP_WORDS];
        mul_part(r, k == 0 ? sh_q[0] : sh_t[2], sh_s[kZZ], c);
        if (k == 0) fp_sub(r, r, sh_t[0][c]);
        fp_store(sh_s[k == 0 ? kH : kM1][c], r);
      }
      __syncwarp();
      // D = qy M1 - Y
      if (t < 2) {
        uint32_t r[FP_WORDS];
        mul_part(r, sh_q[1], sh_s[kM1], c);
        fp_sub(r, r, sh_t[1][c]);
        fp_store(sh_s[kD][c], r);
      }
      __syncwarp();
      // HH = H^2, DD = D^2, hz = H Z
      if (t < 6) {
        const fp2_t* x = k == 1 ? &sh_s[kD] : &sh_s[kH];
        const fp2_t* y = k == 0 ? &sh_s[kH] : k == 1 ? &sh_s[kD] : &sh_t[2];
        mul_part_to(sh_s[k == 0 ? kHH : k == 1 ? kDD : kHZ], *x, *y, c);
      }
      __syncwarp();
      // HHH = H HH, V = X HH; hy = hz yp, A5 = D xp
      if (t < 4) {
        mul_part_to(sh_s[k == 0 ? kHHH : kV], k == 0 ? sh_s[kH] : sh_t[0], sh_s[kHH], c);
      } else if (t < 8) {
        const int j = t & 1;
        if (t < 6) {
          scale_part(sh_s[kZY], sh_s[kHZ], sh_p[1], j);
        } else {
          scale_part(sh_line[2], sh_s[kD], sh_p[0], j);
        }
      }
      __syncwarp();
      if (t < 2) {  // x3 = DD - HHH - 2V, DX = V - x3
        uint32_t a[FP_WORDS], x3[FP_WORDS];
        fp_sub(x3, sh_s[kDD][c], sh_s[kHHH][c]);
        fp_add(a, sh_s[kV][c], sh_s[kV][c]);
        fp_sub(x3, x3, a);
        fp_store(sh_s[kX3][c], x3);
        fp_sub(a, sh_s[kV][c], x3);
        fp_store(sh_s[kDX][c], a);
      } else if (t < 4) {
        a0_part(sh_line[0], sh_s[kZY], c);
      }
      __syncwarp();
      // R0 = D DX, R1 = Y HHH, R2 = qy hz, R3 = D qx
      if (t < 8) {
        const fp2_t* x = k == 1 ? &sh_t[1] : k == 2 ? &sh_q[1] : &sh_s[kD];
        const fp2_t* y = k == 0 ? &sh_s[kDX] : k == 1 ? &sh_s[kHHH] : k == 2 ? &sh_s[kHZ] : &sh_q[0];
        mul_part_to(sh_s[kR0 + k], *x, *y, c);
      }
      __syncwarp();
      if (t < 2) {  // T = (x3, R0 - R1, hz)
        uint32_t r[FP_WORDS];
        fp_sub(r, sh_s[kR0][c], sh_s[kR1][c]);
        fp_store(sh_t[1][c], r);
        fp_store(sh_t[0][c], sh_s[kX3][c]);
        fp_store(sh_t[2][c], sh_s[kHZ][c]);
      } else if (t < 4) {  // A3 = R2 - R3
        uint32_t r[FP_WORDS];
        fp_sub(r, sh_s[kR2][c], sh_s[kR3][c]);
        fp_store(sh_line[1][c], r);
      }
      __syncwarp();
      if (t < 6) fp12_part(sh_f[cur], &sh_line[0][0][0], t, kSparse, sh_f[cur ^ 1]);
      cur ^= 1;
      __syncwarp();
    }
  }

  // conjugate (negate the w^1 half), one in infinity lanes
  if (t < 12) {
    uint32_t v[FP_WORDS];
    fp_load(v, sh_f[cur] + t * FP_WORDS);
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
