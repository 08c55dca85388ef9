// The group laws of G1 and G2 as one-copy routines, for the standalone
// additions K26 / K27 (standalone_kernels.cu) and the psi comparison K20
// (verify_kernels.cu, which loads its points with `load_point`); and the
// same laws spread over a group of lanes, with the windowed scalar
// multiplication on them, for K10 and K11 (curve_kernels.cu), the tree
// sums K15 / K16 (fold_kernels.cu, `lanes_add` alone) and the cofactor
// clearing K17 (cofactor_kernels.cu; see "the lane-group law" below). Each
// .cu compiles on its own, so each keeps its own copy of what it uses.
//
// `scalar_mul_lanes` is the plain version's algorithm step for step
// (curve.py `scalar_mul_bits_plain`): a 16-row table built by the eight
// 2-stacked complete additions [T_k + T_(k+1), T_(k+1) + T_(k+1)] =
// [T_(2k+1), T_(2k+2)] from T_0 = (0 : 1 : 0) and T_1 = P (row 1 is
// overwritten by T_0 + T_1, another representative of P; the plain
// version's row 16 is never read and is not formed); the accumulator
// starts at infinity; each 4-bit digit, zero-padded at the MSB end, costs
// four doublings and one complete addition of row d, row 0 included. So
// its projective output is bit-identical to the plain version's: a
// projective coordinate is not unique, and bit-identity needs the plain
// version's formulas and order.

#pragma once

#include <stdint.h>

#include "fp384.cuh"
#include "g1.cuh"
#include "g2.cuh"

namespace {

constexpr int kWindow = 4;
constexpr int kRows = 16;

// Digit j (0 = most significant) of the MSB-first bits in `row`, one byte
// read per bit `step` bytes apart, zero-padded at the MSB end to a multiple
// of four bits.
__device__ __forceinline__ int window_digit(const uint8_t* row, int j, int nbits, int step) {
  const int pad = (kWindow - nbits % kWindow) % kWindow;
  int d = 0;
#pragma unroll
  for (int t = 0; t < kWindow; ++t) {
    const int i = kWindow * j + t - pad;
    d = 2 * d + ((i >= 0 && row[(long long)i * step] != 0) ? 1 : 0);
  }
  return d;
}

// The group laws, each one copy that every call site shares (not inlined
// at each: that multiplies what ptxas compiles).
struct G1 {
  using Point = G1Proj;
  static constexpr int kWords = FP_WORDS;  // per coordinate
  static __device__ __noinline__ void add(Point& r, const Point& p, const Point& q) { g1_add(r, p, q); }
  static __device__ __noinline__ void dbl(Point& r, const Point& p) { g1_dbl(r, p); }
};

struct G2 {
  using Point = G2Proj;
  static constexpr int kWords = 2 * FP_WORDS;
  static __device__ __noinline__ void add(Point& r, const Point& p, const Point& q) { g2_add(r, p, q); }
  static __device__ __noinline__ void dbl(Point& r, const Point& p) { g2_dbl(r, p); }
};

// Coordinate c (0 = X, 1 = Y, 2 = Z) of a point as kWords consecutive words.
template <typename G>
__device__ __forceinline__ uint32_t* coord(typename G::Point& p, int c) {
  return reinterpret_cast<uint32_t*>(&p) + c * G::kWords;
}

template <typename G>
__device__ __forceinline__ const uint32_t* coord(const typename G::Point& p, int c) {
  return reinterpret_cast<const uint32_t*>(&p) + c * G::kWords;
}

// A point from three coordinate pointers (kWords words each).
template <typename G>
__device__ __forceinline__ void load_point(typename G::Point& p, const uint32_t* x, const uint32_t* y,
                                           const uint32_t* z) {
  const uint32_t* src[3] = {x, y, z};
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    uint32_t* w = coord<G>(p, c);
    for (int i = 0; i < G::kWords; ++i) w[i] = src[c][i];
  }
}

// -- the lane-group law -----------------------------------------------------------
//
// `lanes_add` / `lanes_dbl` form g1.cuh's g1_add / g1_dbl (C = 1, G1) and
// g2.cuh's g2_add / g2_dbl (C = 2, G2), RCB 2016 Algorithms 7 and 9, on a
// group of 6 C lanes of a warp, and `scalar_mul_lanes` runs the windowed
// multiplication on them (see the header). C is the coordinate's
// components: a G1 coordinate is one Fp element, a G2 one two. Every value
// is canonical, so which lane forms a product, and how the additions
// around it are grouped, does not change a word; the same holds for a
// product by 3b: over Fp it is 12 v by additions (fp_mul12), the integer
// that g1.cuh's Montgomery product by G1_B3 = 12 R gives; over Fp2 it is
// 12 xi(v), g2.cuh's fp2_mul_b3.
//
// An operation is four steps, each ending in __syncwarp:
//   level 1   the independent products of the operands, lane C k + c
//             forming component c of product k (in G2 K7's split, g2.cuh
//             `fp2_mul_part`; in G1 one Fp product a lane), its operand
//             sums formed on the lane;
//   middle    the additions between the levels, a lane per Fp component:
//             out = H +- m y, y = 12 v (G1) or 12 xi_c(v) (G2) (3b, where
//             set) or v_c, v = E - F - G, m in {1, 3, 8};
//   level 2   the products of the middle's values;
//   out       the coordinates, r_j = H +- m E (m in {1, 2}), 3 C lanes.
// Addition, X1 X2 = t0, Y1 Y2 = t1, Z1 Z2 = t2 and the three cross
// products m3, m4, m5 on 6 C lanes; t3 = m3 - t0 - t1, t4 = m4 - t1 - t2,
// y3 = 3b (m5 - t0 - t2), 3 t0, z3 = t1 + 3b t2, t1' = t1 - 3b t2; t4 y3,
// t3 t1', y3 3t0, t1' z3, 3t0 t3, z3 t4 on 6 C lanes; X3 = t3 t1' - t4 y3,
// Y3 = t1' z3 + y3 3t0, Z3 = z3 t4 + 3t0 t3. Doubling, A = Y^2, B = Y Z,
// C = Z^2, D = X Y on 4 C lanes; 3b C, A + 3b C, A - 3 (3b C), 8A, B, D;
// 3bC 8A, B 8A, (A - 9bC)(A + 3bC), (A - 9bC) D on 4 C lanes; X3 = 2
// (A - 9bC) D, Y3 = 3bC 8A + (A - 9bC)(A + 3bC), Z3 = B 8A. Squares stay
// products, as g1_dbl and g2_dbl form them.
//
// Operands are numbered slots (kLane, one table for both groups): 0-2 p's
// X, Y, Z; 3-5 q's; 6-11 bank A (level products); 12-17 bank B (middle
// values); 18 zero. A slot is one coordinate, C Fp elements. Each step
// reads one bank and writes the other (level 1 reads p and q, the out step
// writes r), so no lane overwrites what another lane of the step still
// reads, and r may alias p or q. The group's scratch (13 slots: 624 bytes
// in G1, 1,248 in G2), p, q and r lie in shared memory. The product, the
// middle and the out step are one `__noinline__` copy each per group
// (full inlining of a group law takes ptxas minutes), picked per step by
// the table, which every lane reads at the same address.

constexpr int kLaneScratch = 13;  // banks A and B, six slots each, and the zero slot
constexpr int kLz = 18;           // the zero slot's number
enum LaneStep { kAddL1, kAddMid, kAddL2, kAddOut, kDblL1, kDblMid, kDblL2, kDblOut, kLaneSteps };

// Lanes of a group: six products, C components each.
template <int C>
__host__ __device__ constexpr int lane_group() {
  return 6 * C;
}
constexpr int kLaneGroup = lane_group<2>();  // G2's twelve

// Six 5-bit fields, output k's at bit 5k.
__host__ __device__ constexpr uint32_t lane_pack(int a0, int a1, int a2, int a3, int a4, int a5) {
  return (uint32_t)a0 | (uint32_t)a1 << 5 | (uint32_t)a2 << 10 | (uint32_t)a3 << 15 | (uint32_t)a4 << 20 |
         (uint32_t)a5 << 25;
}

// Per step: the outputs, then per output k its slots (products: xa, xb, ya,
// yb for (xa + xb)(ya + yb); middle: E, F, G, H; out: E, -, -, H), 3b, the
// sign (1: H - m y) and m.
static __constant__ uint32_t kLane[kLaneSteps][8] = {
    // add, level 1: X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
    {6, lane_pack(0, 1, 2, 0, 1, 0), lane_pack(kLz, kLz, kLz, 1, 2, 2), lane_pack(3, 4, 5, 3, 4, 3),
     lane_pack(kLz, kLz, kLz, 4, 5, 5), 0, 0, 0},
    // add, middle: t3, t4, y3 = 3b (m5 - t0 - t2), 3 t0, z3 = t1 + 3b t2, t1' = t1 - 3b t2
    {6, lane_pack(9, 10, 11, 6, 8, 8), lane_pack(6, 7, 6, kLz, kLz, kLz), lane_pack(7, 8, 8, kLz, kLz, kLz),
     lane_pack(kLz, kLz, kLz, kLz, 7, 7), lane_pack(0, 0, 1, 0, 1, 1), lane_pack(0, 0, 0, 0, 0, 1),
     lane_pack(1, 1, 1, 3, 1, 1)},
    // add, level 2: t4 y3, t3 t1', y3 3t0, t1' z3, 3t0 t3, z3 t4
    {6, lane_pack(13, 12, 14, 17, 15, 16), lane_pack(kLz, kLz, kLz, kLz, kLz, kLz), lane_pack(14, 17, 15, 16, 12, 13),
     lane_pack(kLz, kLz, kLz, kLz, kLz, kLz), 0, 0, 0},
    // add, out: X3 = t3 t1' - t4 y3, Y3 = t1' z3 + y3 3t0, Z3 = z3 t4 + 3t0 t3
    {3, lane_pack(6, 8, 10, 0, 0, 0), 0, 0, lane_pack(7, 9, 11, 0, 0, 0), 0, lane_pack(1, 0, 0, 0, 0, 0),
     lane_pack(1, 1, 1, 0, 0, 0)},
    // dbl, level 1: A = Y Y, B = Y Z, C = Z Z, D = X Y
    {4, lane_pack(1, 1, 2, 0, 0, 0), lane_pack(kLz, kLz, kLz, kLz, 0, 0), lane_pack(1, 2, 2, 1, 0, 0),
     lane_pack(kLz, kLz, kLz, kLz, 0, 0), 0, 0, 0},
    // dbl, middle: 3b C, A + 3b C, A - 3 (3b C), 8 A, B, D
    {6, lane_pack(8, 8, 8, 6, 7, 9), lane_pack(kLz, kLz, kLz, kLz, kLz, kLz), lane_pack(kLz, kLz, kLz, kLz, kLz, kLz),
     lane_pack(kLz, 6, 6, kLz, kLz, kLz), lane_pack(1, 1, 1, 0, 0, 0), lane_pack(0, 0, 1, 0, 0, 0),
     lane_pack(1, 1, 3, 8, 1, 1)},
    // dbl, level 2: 3bC 8A, B 8A, (A - 9bC)(A + 3bC), (A - 9bC) D
    {4, lane_pack(12, 16, 14, 14, 0, 0), lane_pack(kLz, kLz, kLz, kLz, 0, 0), lane_pack(15, 15, 13, 17, 0, 0),
     lane_pack(kLz, kLz, kLz, kLz, 0, 0), 0, 0, 0},
    // dbl, out: X3 = 2 (A - 9bC) D, Y3 = 3bC 8A + (A - 9bC)(A + 3bC), Z3 = B 8A
    {3, lane_pack(9, 8, 7, 0, 0, 0), 0, 0, lane_pack(kLz, 6, kLz, 0, 0, 0), 0, 0, lane_pack(2, 1, 1, 0, 0, 0)},
};

__device__ __forceinline__ int lane_field(uint32_t w, int k) { return (int)(w >> (5 * k)) & 31; }

// Slot i of a group's operand space (see above); a slot is C Fp elements.
template <int C>
__device__ __forceinline__ const uint32_t* lane_slot(int i, const uint32_t* p, const uint32_t* q,
                                                     const uint32_t* s) {
  const uint32_t* base = i < 3 ? p : i < 6 ? q : s;
  return base + (i < 3 ? i : i < 6 ? i - 3 : i - 6) * C * FP_WORDS;
}

// Component c of (xa + xb)(ya + yb), or of xa ya without `sums`: every
// product of the law. G1: one Montgomery product; G2: K7's split.
template <int C>
__device__ __noinline__ void lane_product(uint32_t r[FP_WORDS], const uint32_t* xa, const uint32_t* xb,
                                          const uint32_t* ya, const uint32_t* yb, bool sums, int c) {
  if constexpr (C == 1) {
    uint32_t x[FP_WORDS], y[FP_WORDS], t[FP_WORDS];
    fp_load(x, xa);
    fp_load(y, ya);
    if (sums) {
      fp_load(t, xb);
      fp_add(x, x, t);
      fp_load(t, yb);
      fp_add(y, y, t);
    }
    fp_mul(r, x, y);
  } else {
    fp2_t x, y, t;
    fp2_load(x, xa);
    fp2_load(y, ya);
    if (sums) {
      fp2_load(t, xb);
      fp2_add(x, x, t);
      fp2_load(t, yb);
      fp2_add(y, y, t);
    }
    fp2_mul_part(r, x, y, c);
  }
}

// Component c of H +- m y: the middle (kMid: y = 12 v (G1) or 12 xi_c(v)
// (G2) where b3, else v_c, v = E - F - G; m in {1, 3, 8}) or the out step
// (y = E_c, m in {1, 2}).
template <bool kMid, int C>
__device__ __noinline__ void lane_lin(uint32_t r[FP_WORDS], const uint32_t* e, const uint32_t* f,
                                      const uint32_t* g, const uint32_t* h, bool b3, bool neg, int m, int c) {
  uint32_t y[FP_WORDS], t[FP_WORDS], u[FP_WORDS];
  if (kMid) {
    if constexpr (C == 1) {
      fp_load(u, e);
      fp_load(t, f);
      fp_sub(u, u, t);
      fp_load(t, g);
      fp_sub(u, u, t);
      fp_mul12(t, u);
    } else {
      fp2_t v, w;
      fp2_load(v, e);
      fp2_load(w, f);
      fp2_sub(v, v, w);
      fp2_load(w, g);
      fp2_sub(v, v, w);
      fp_sub(t, v[0], v[1]);  // xi v = (v0 - v1) + (v0 + v1) u
      fp_add(u, v[0], v[1]);
      fp_select(t, c == 1, u, t);
      fp_mul12(t, t);
      fp_select(u, c == 1, v[1], v[0]);
    }
    fp_select(y, b3, t, u);
    fp_add(t, y, y);  // 2y, 3y; 4y, 8y
    fp_add(u, t, y);
    fp_add(t, t, t);
    fp_add(t, t, t);
    fp_select(y, m == 3, u, y);
    fp_select(y, m == 8, t, y);
  } else {
    fp_load(y, e + c * FP_WORDS);
    fp_add(t, y, y);
    fp_select(y, m == 2, t, y);
  }
  fp_load(t, h + c * FP_WORDS);
  fp_add(u, t, y);
  fp_sub(t, t, y);
  fp_select(r, neg, t, u);
}

// Step st of the law on lane l (0 .. 6 C - 1) of a group; `on`: the group
// takes part. Every lane of the warp calls it, and it ends in __syncwarp.
template <int C>
__device__ __noinline__ void lane_step(int st, uint32_t* r, const uint32_t* p, const uint32_t* q, uint32_t* s,
                                       int l, bool on) {
  constexpr int W = C * FP_WORDS;  // a slot's words
  const uint32_t* row = kLane[st];
  const int k = l / C, c = l % C, kind = st & 3;
  if (on && k < (int)row[0]) {
    const uint32_t* a = lane_slot<C>(lane_field(row[1], k), p, q, s);
    const uint32_t* b = lane_slot<C>(lane_field(row[2], k), p, q, s);
    const uint32_t* x = lane_slot<C>(lane_field(row[3], k), p, q, s);
    const uint32_t* y = lane_slot<C>(lane_field(row[4], k), p, q, s);
    const bool b3 = lane_field(row[5], k) != 0, neg = lane_field(row[6], k) != 0;
    const int m = lane_field(row[7], k);
    uint32_t v[FP_WORDS];
    if (kind == 0 || kind == 2) {
      lane_product<C>(v, a, b, x, y, kind == 0, c);
    } else if (kind == 1) {
      lane_lin<true, C>(v, a, b, x, y, b3, neg, m, c);
    } else {
      lane_lin<false, C>(v, a, b, x, y, false, neg, m, c);
    }
    uint32_t* dst = kind == 3 ? r + k * W : s + ((kind == 1 ? 6 : 0) + k) * W;
    fp_store(dst + c * FP_WORDS, v);
  }
  __syncwarp();
}

// r = p + q on a lane group. r may alias p or q.
template <int C>
__device__ __forceinline__ void lanes_add(uint32_t* r, const uint32_t* p, const uint32_t* q, uint32_t* s, int l,
                                          bool on) {
#pragma unroll 1
  for (int st = kAddL1; st <= kAddOut; ++st) lane_step<C>(st, r, p, q, s, l, on);
}

// r = 2 p on a lane group. r may alias p.
template <int C>
__device__ __forceinline__ void lanes_dbl(uint32_t* r, const uint32_t* p, uint32_t* s, int l, bool on) {
#pragma unroll 1
  for (int st = kDblL1; st <= kDblOut; ++st) lane_step<C>(st, r, p, p, s, l, on);
}

// r = psi(p) = (conj(x) CX, conj(y) CY, conj(z)) on a lane group (curve.py
// `psi`'s values, with CX, CY from `curve._PSI_C`): lanes 0-3 form
// component c of conj(x) CX = conj(x conj(CX)) and of conj(y) CY from
// cc = [conj(CX), conj(CY)] (two Fp2 in shared memory), lanes 4, 5
// conj(z). r may alias p.
__device__ __noinline__ void g2_psi_lanes(G2Proj* r, const G2Proj* p, const fp2_t* cc, int l, bool on) {
  const int k = l >> 1, c = l & 1;
  const bool act = on && k < 3;
  uint32_t v[FP_WORDS];
  if (act) {
    const uint32_t* src = (const uint32_t*)p + k * 2 * FP_WORDS;
    if (k < 2) {
      lane_product<2>(v, src, nullptr, (const uint32_t*)cc[k], nullptr, false, c);
    } else {
      fp_load(v, src + c * FP_WORDS);
    }
    if (c == 1) fp_neg(v, v);
  }
  __syncwarp();
  if (act) fp_store((uint32_t*)r + k * 2 * FP_WORDS + c * FP_WORDS, v);
  __syncwarp();
}

// dst = (0 : 1 : 0), each lane of a group its share of the words; the
// caller synchronises.
template <int C>
__device__ __forceinline__ void lanes_set_infinity(uint32_t* dst, int l, bool on) {
  if (!on) return;
  for (int i = l; i < 3 * C * FP_WORDS; i += lane_group<C>()) {
    dst[i] = (i >= C * FP_WORDS && i < C * FP_WORDS + FP_WORDS) ? FP_ONE[i - C * FP_WORDS] : 0u;
  }
}

// acc = [k] tab[1] for the MSB-first bits of k at `row` (one byte read a
// bit, `step` bytes apart), on a lane group: the header's table and
// digits step for step (each table step forms row 2k + 2 before row
// 2k + 1, both from rows k and k + 1, which neither overwrites). tab (16
// points of 3 C Fp elements), acc and s lie in shared memory; tab's row 1
// holds the base on entry.
template <int C>
__device__ __forceinline__ void scalar_mul_lanes(uint32_t* tab, uint32_t* acc, uint32_t* s, const uint8_t* row,
                                                 int nbits, int step, int l, bool on) {
  constexpr int PW = 3 * C * FP_WORDS;  // a point's words
  lanes_set_infinity<C>(tab, l, on);
  lanes_set_infinity<C>(acc, l, on);
  __syncwarp();
#pragma unroll 1
  for (int k = 0; k < kRows / 2; ++k) {
    if (2 * k + 2 < kRows) lanes_add<C>(tab + (2 * k + 2) * PW, tab + (k + 1) * PW, tab + (k + 1) * PW, s, l, on);
    lanes_add<C>(tab + (2 * k + 1) * PW, tab + k * PW, tab + (k + 1) * PW, s, l, on);
  }
  const int digits = (nbits + kWindow - 1) / kWindow;
#pragma unroll 1
  for (int j = 0; j < digits; ++j) {
#pragma unroll 1
    for (int t = 0; t < kWindow; ++t) lanes_dbl<C>(acc, acc, s, l, on);
    lanes_add<C>(acc, acc, tab + window_digit(row, j, nbits, step) * PW, s, l, on);
  }
}

}  // namespace
