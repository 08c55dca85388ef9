// G1 (y^2 = x^3 + 4 over Fp) in homogeneous projective coordinates
// (X : Y : Z), infinity = (0 : 1 : 0), as __device__ building blocks over
// fp384.cuh, for curve.cuh's one-copy group law (K26 and the lane-group
// law's reference formulas).
//
// The formulas are the complete ones of Renes-Costello-Batina 2016 for
// a = 0: Algorithm 7 (addition, 12 products + 2 by 3b) and Algorithm 9
// (doubling, 8 products + 1 by 3b). E(Fp) has odd order (no point
// of order 2), so they hold for every input pair, P == Q, P == -Q and
// infinity included: no branch on the data. They are the formulas of
// curve.py's `add` / `dbl_fast`, in the order of the paper.

#pragma once

#include <stdint.h>

#include "fp384.cuh"

// 3 b = 12 in Montgomery form.
static __constant__ uint32_t G1_B3[FP_WORDS] = {
    0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au, 0x4a6e8b59u, 0x6f7ee9ceu,
    0xc0a95bc6u, 0xb10330b7u, 0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u};

struct G1Proj {
  uint32_t x[FP_WORDS];
  uint32_t y[FP_WORDS];
  uint32_t z[FP_WORDS];
};

// r = p + q, RCB 2016 Algorithm 7 (a = 0). r may alias p or q.
__device__ __forceinline__ void g1_add(G1Proj& r, const G1Proj& p, const G1Proj& q) {
  uint32_t t0[FP_WORDS], t1[FP_WORDS], t2[FP_WORDS], t3[FP_WORDS], t4[FP_WORDS];
  uint32_t x3[FP_WORDS], y3[FP_WORDS], z3[FP_WORDS];
  fp_mul(t0, p.x, q.x);
  fp_mul(t1, p.y, q.y);
  fp_mul(t2, p.z, q.z);
  fp_add(t3, p.x, p.y);
  fp_add(t4, q.x, q.y);
  fp_mul(t3, t3, t4);
  fp_add(t4, t0, t1);
  fp_sub(t3, t3, t4);  // X1 Y2 + X2 Y1
  fp_add(t4, p.y, p.z);
  fp_add(x3, q.y, q.z);
  fp_mul(t4, t4, x3);
  fp_add(x3, t1, t2);
  fp_sub(t4, t4, x3);  // Y1 Z2 + Y2 Z1
  fp_add(x3, p.x, p.z);
  fp_add(y3, q.x, q.z);
  fp_mul(x3, x3, y3);
  fp_add(y3, t0, t2);
  fp_sub(y3, x3, y3);  // X1 Z2 + X2 Z1
  fp_add(x3, t0, t0);
  fp_add(t0, x3, t0);  // 3 X1 X2
  fp_mul(t2, G1_B3, t2);
  fp_add(z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_mul(y3, G1_B3, y3);
  fp_mul(x3, t4, y3);
  fp_mul(t2, t3, t1);
  fp_sub(x3, t2, x3);
  fp_mul(y3, y3, t0);
  fp_mul(t1, t1, z3);
  fp_add(y3, t1, y3);
  fp_mul(t0, t0, t3);
  fp_mul(z3, z3, t4);
  fp_add(z3, z3, t0);
  fp_copy(r.x, x3);
  fp_copy(r.y, y3);
  fp_copy(r.z, z3);
}

// r = 2 p, RCB 2016 Algorithm 9 (a = 0). r may alias p.
__device__ __forceinline__ void g1_dbl(G1Proj& r, const G1Proj& p) {
  uint32_t t0[FP_WORDS], t1[FP_WORDS], t2[FP_WORDS], x3[FP_WORDS], y3[FP_WORDS], z3[FP_WORDS];
  fp_mul(t0, p.y, p.y);
  fp_add(z3, t0, t0);
  fp_add(z3, z3, z3);
  fp_add(z3, z3, z3);  // 8 Y^2
  fp_mul(t1, p.y, p.z);
  fp_mul(t2, p.z, p.z);
  fp_mul(t2, G1_B3, t2);  // 3b Z^2
  fp_mul(x3, t2, z3);
  fp_add(y3, t0, t2);
  fp_mul(z3, t1, z3);
  fp_add(t1, t2, t2);
  fp_add(t2, t1, t2);
  fp_sub(t0, t0, t2);  // Y^2 - 9b Z^2
  fp_mul(y3, t0, y3);
  fp_add(y3, x3, y3);
  fp_mul(t1, p.x, p.y);
  fp_mul(x3, t0, t1);
  fp_add(x3, x3, x3);
  fp_copy(r.x, x3);
  fp_copy(r.y, y3);
  fp_copy(r.z, z3);
}
