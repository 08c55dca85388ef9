// The group laws of G1 and G2 as one-copy routines, and the windowed
// scalar multiplication of one thread, as __device__ building blocks for
// K10 / K11 (curve_kernels.cu), the tree sums K15 / K16 (fold_kernels.cu),
// the cofactor clearing K17 (cofactor_kernels.cu) and the psi comparison
// K20 (verify_kernels.cu, which loads its points with `load_point`). Each .cu compiles
// on its own, so each keeps its own copy of what it uses.
//
// `scalar_mul_point` is the plain version's algorithm step for step
// (curve.py `scalar_mul_bits_plain`): a 16-row table built by the eight
// 2-stacked complete additions [T_k + T_(k+1), T_(k+1) + T_(k+1)] =
// [T_(2k+1), T_(2k+2)] from T_0 = (0 : 1 : 0) and T_1 = P (row 1 is
// overwritten by T_0 + T_1, another representative of P; the plain
// version's row 16 is never read and is not formed); the accumulator
// starts at infinity; each 4-bit digit, zero-padded at the MSB end, costs
// four doublings and one complete addition of row d, row 0 included. So
// its projective output is bit-identical to the plain version's.

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

template <typename G>
__device__ __forceinline__ void set_infinity(typename G::Point& p) {
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    uint32_t* w = coord<G>(p, c);
    for (int i = 0; i < G::kWords; ++i) w[i] = (c == 1 && i < FP_WORDS) ? FP_ONE[i] : 0u;
  }
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

// acc = [k] p for the MSB-first bits of k at `row` (see the header). The
// table (16 points: 2.3 KB in G1, 4.6 KB in G2) lives in local memory.
template <typename G>
__device__ __forceinline__ void scalar_mul_point(typename G::Point& acc, const typename G::Point& p,
                                                 const uint8_t* row, int nbits, int step) {
  using Point = typename G::Point;
  Point tab[kRows];
  set_infinity<G>(tab[0]);
  tab[1] = p;
  // [T_(2k+1), T_(2k+2)] = [T_k + T_(k+1), T_(k+1) + T_(k+1)], both from the
  // rows as they stood before the step
#pragma unroll 1
  for (int k = 0; k < kRows / 2; ++k) {
    Point u;
    G::add(u, tab[k], tab[k + 1]);
    if (2 * k + 2 < kRows) G::add(tab[2 * k + 2], tab[k + 1], tab[k + 1]);
    tab[2 * k + 1] = u;
  }
  set_infinity<G>(acc);
  const int digits = (nbits + kWindow - 1) / kWindow;
#pragma unroll 1
  for (int j = 0; j < digits; ++j) {
#pragma unroll 1
    for (int t = 0; t < kWindow; ++t) G::dbl(acc, acc);
    G::add(acc, acc, tab[window_digit(row, j, nbits, step)]);
  }
}

}  // namespace
