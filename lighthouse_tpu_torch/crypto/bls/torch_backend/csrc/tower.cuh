// Tower-layout Fp12 helpers shared by K8 (tower_kernels.cu), K9 and K19
// (final_exp_kernels.cu, final_exponentiation_kernels.cu), K12
// (pairing_kernels.cu) and K18 (fold_kernels.cu), as __device__ building
// blocks over fp384.cuh.
//
// Fp12 lies in tower order (w:2, v:3, c:2, 12) words; flat coefficient
// k = 2v + w of Fp12 = Fp2[w]/(w^6 - xi) sits at offset (3w + v) x 24
// words. `fp12_lane_terms` is a share of one component's terms;
// `fp12_mul_lane` one lane's share of a product formed by twelve lanes,
// lane 2k + c forming component c of e_k (K12); `fp12_mul_pairs` a warp's
// product on 24 lanes, each component's terms split over a lane pair whose
// two double-width sums a shuffle adds (K8, K9, K18, K19). Each component
// is one lazy sum reduced once, so the forms give the same words; their
// bound and work are stated with K8 in tower_kernels.cu.

#pragma once

#include <stdint.h>

#include "fp384.cuh"

namespace {

constexpr int kFp2Words = 2 * FP_WORDS;
constexpr int kFp12Words = 6 * kFp2Words;

enum Fp12Mode { kFull = 0, kSquare = 1, kSparse = 2 };

constexpr int kPairLanes = 24;  // the lanes of `fp12_mul_pairs`: 12 components, two lanes each

__device__ __forceinline__ int tower_offset(int k) { return ((k & 1) * 3 + (k >> 1)) * kFp2Words; }

// The four operands of one output component's term pair, chosen without a
// branch: t += x0 y0 + (-x1) y1 for component 0, x0 y1 + x1 y0 for 1.
__device__ __forceinline__ void fp2_component_mac(uint32_t t[FP_WIDE], bool c1, const uint32_t x0[FP_WORDS],
                                                  const uint32_t x1[FP_WORDS], const uint32_t y0[FP_WORDS],
                                                  const uint32_t y1[FP_WORDS]) {
  uint32_t u[FP_WORDS], v[FP_WORDS];
  fp_neg(u, x1);
  fp_select(u, c1, x1, u);
  fp_select(v, c1, y1, y0);
  fp_mac_wide(t, x0, v);
  fp_select(v, c1, y0, y1);
  fp_mac_wide(t, u, v);
}

// Adds to `acc` the terms q0 <= q < q1 of component c of flat coefficient
// e_k of a * b: per term two products (x0 (y0 or y1) and u (y1 or y0),
// u = x1 or -x1) into the double-width sum, 2 (q1 - q0) in all. `a` is a
// tower-layout element; `b` is one too (kFull, kSquare: pass a), or in
// kSparse mode the w^0, w^3, w^5 coefficients in three consecutive Fp2
// slots. Terms are q < 6 (kFull, kSquare) or q < 3 (kSparse): term q
// takes b_j (j = q, or 0, 3, 5 in kSparse mode) and a_i, i = (k - j) mod 6,
// with xi = 1 + u applied to a_i where the term wraps (j > k):
// xi (x0 + x1 u) = (x0 - x1) + (x0 + x1) u.
__device__ __forceinline__ void fp12_lane_terms(uint32_t acc[FP_WIDE], const uint32_t* a, const uint32_t* b, int k,
                                                int c, int mode, int q0, int q1) {
  uint32_t x0[FP_WORDS], x1[FP_WORDS], y0[FP_WORDS], y1[FP_WORDS], d[FP_WORDS], s[FP_WORDS];
#pragma unroll 1
  for (int q = q0; q < q1; ++q) {
    const int j = mode == kSparse ? (q == 0 ? 0 : q == 1 ? 3 : 5) : q;
    const int i = (k - j + 6) % 6;
    const uint32_t* bj = b + (mode == kSparse ? q * kFp2Words : tower_offset(j));
    const uint32_t* ai = a + tower_offset(i);
    fp_load(x0, ai);
    fp_load(x1, ai + FP_WORDS);
    fp_load(y0, bj);
    fp_load(y1, bj + FP_WORDS);
    const bool wrap = j > k;  // w^6 = xi: a_i -> (a0 - a1, a0 + a1)
    fp_sub(d, x0, x1);
    fp_add(s, x0, x1);
    fp_select(x0, wrap, d, x0);
    fp_select(x1, wrap, s, x1);
    fp2_component_mac(acc, c == 1, x0, x1, y0, y1);
  }
}

// Lane 2k + c of a twelve-lane group: component c of flat coefficient e_k
// of a * b, written to `out` (tower layout), with the operands and modes
// of `fp12_lane_terms`: 12 products (kFull, kSquare) or 6 (kSparse) in
// one double-width sum, one reduction. `out` must not overlap a or b.
__device__ __forceinline__ void fp12_mul_lane(const uint32_t* a, const uint32_t* b, int k, int c, int mode,
                                              uint32_t* out) {
  uint32_t acc[FP_WIDE];
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) acc[i] = 0;
  fp12_lane_terms(acc, a, b, k, c, mode, 0, mode == kSparse ? 3 : 6);
  uint32_t r[FP_WORDS];
  fp_redc_wide<2>(r, acc);
  fp_store(out + tower_offset(k) + c * FP_WORDS, r);
}

// a * b on one warp, written to `out` (tower layout): lane
// 2 (2k + c) + half adds its share of component c of e_k with
// `fp12_lane_terms` (terms 3 half .. 3 half + 2; in kSparse mode terms 0
// and 1, or 2), the lane pair adds its two double-width sums by a shuffle
// (N = 12 products, 6 in kSparse mode), and the even lane reduces once and
// stores. Lanes 24-31 repeat lanes 0-7's terms and store nothing. Every
// lane of the warp calls it; the lanes have all read their operands
// (`__syncwarp`) before any lane stores, so `out` may overlap a or b.
__device__ __forceinline__ void fp12_mul_pairs(const uint32_t* a, const uint32_t* b, int mode, uint32_t* out) {
  const int lane = threadIdx.x & 31, comp = (lane % kPairLanes) >> 1, k = comp >> 1, c = comp & 1, half = lane & 1;
  const int q0 = mode == kSparse ? 2 * half : 3 * half;
  uint32_t acc[FP_WIDE], other[FP_WIDE], r[FP_WORDS];
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) acc[i] = 0;
  fp12_lane_terms(acc, a, b, k, c, mode, q0, mode == kSparse ? 2 + half : q0 + 3);
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) other[i] = __shfl_xor_sync(0xffffffffu, acc[i], 1);
  fp_add_wide(acc, other);
  fp_redc_wide<2>(r, acc);
  __syncwarp();
  if (lane < kPairLanes && half == 0) fp_store(out + tower_offset(k) + c * FP_WORDS, r);
}

}  // namespace
