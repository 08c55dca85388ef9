// K6: the Montgomery product on Hopper's tensor cores, with a plain C
// launcher (extern "C", bound from Python with ctypes). Like the launchers
// of fp_kernels.cu it runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().
//
// K6 fp_mul_mma_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/fp.py:373 `mul_mxu`
//   (the opt-in matrix-unit product; with LIGHTHOUSE_TPU_MXU_FP_MUL=1 every
//   `mul` / `sqr` goes through it, fp.py:310-314). Same function as K1, bit
//   for bit: (n, 12) canonical Montgomery words in, a * b * 2^-384 mod p out.
//   Bound: bytes, as K1 (144 per element). Per element it does two
//   m16n8k32 u8 MMAs (8,192 multiply-adds, 16,384 operations, against the
//   int8 tensor peak) and the reduction's 156 word products (12 for m, 144
//   for m * p, against the integer multiply-add peak); at the verify path's
//   shapes both take less time than the bytes.
//   Design: the byte product is a Toeplitz matrix product. For one element,
//   with a and b its 48 little-endian bytes, r in [0, 16), t in [0, 64) and
//   j in [0, 8):
//     A[r][t] = a[r + 48 - t]      (0 outside [0, 48)), a 16 x 64 tile
//     B[t][j] = b[t - 48 + 16 j]   (0 outside [0, 48))
//     D[r][j] = sum_t A[r][t] B[t][j] = c[r + 16 j],  c_k = sum_i a_i b_(k-i)
//   so two MMAs (k = 32 each) give the 95 byte columns in D's columns 0-5
//   (6 of 8 in use); columns 6 and 7 are zero. Bytes are unsigned (u8, not
//   s8) and a column is at most 48 * 255^2 = 3,121,200 < 2^22, exact in the
//   s32 accumulator. A warp owns a tile of 32 elements: it stages their
//   bytes in shared memory with zero padding on both sides (A's reversed),
//   so every fragment is built without branches, runs the two MMAs element
//   by element and writes the columns to shared memory; then each lane
//   carries one element's 96 columns into 24 words (64-bit accumulation: a
//   column shifted by 24 bits is < 2^46), runs a word-level Montgomery
//   reduction (12 rounds of m = t_i p' mod 2^32, t += m p 2^(32 i)) and one
//   conditional subtraction. Elements past n are staged as zeros and not
//   stored. wgmma, several elements per MMA and a reduction spread across
//   lanes are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"

namespace {

constexpr int kWarps = 2;   // warps per block
constexpr int kTile = 32;   // elements per warp
constexpr int kCols = 96;   // byte columns: 95 and a zero one
// Staging of one element, in 32-bit words: A's bytes reversed between 16
// zero bytes on each side (rev[y] = a[63 - y]), then B's bytes after 48
// zero bytes and before 80 (bb[z] = b[z - 48]). One spare word makes the
// stride odd, as does the column row's.
constexpr int kRevWords = 20;
constexpr int kBbWords = 44;
constexpr int kStage = kRevWords + kBbWords + 1;
constexpr int kColStride = kCols + 1;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kWarps * kTile - 1) / (kWarps * kTile));
}

__global__ void __launch_bounds__(kWarps * 32)
    fp_mul_mma_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long long n) {
  __shared__ uint32_t stage_all[kWarps][kTile * kStage];
  __shared__ uint32_t cols_all[kWarps][kTile * kColStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = ((long long)blockIdx.x * kWarps + warp) * kTile;
  if (base >= n) return;  // uniform across the warp; only __syncwarp below
  uint32_t* stage = stage_all[warp];
  uint32_t* cols = cols_all[warp];

  // 1. Stage the tile's bytes: zeros everywhere, then each element's words
  //    (coalesced: neighbouring lanes read neighbouring words).
  for (int w = lane; w < kTile * kStage; w += 32) stage[w] = 0;
  __syncwarp();
  for (int w = lane; w < kTile * FP_WORDS; w += 32) {
    const int e = w / FP_WORDS, q = w % FP_WORDS;
    if (base + e < n) {
      const long long src = (base + e) * FP_WORDS + q;
      // rev word 15 - q holds a's bytes 4q + 3 .. 4q, lowest first
      stage[e * kStage + 15 - q] = __byte_perm(a[src], 0, 0x0123);
      stage[e * kStage + kRevWords + 12 + q] = b[src];
    }
  }
  __syncwarp();

  // 2. Two MMAs per element. Fragments of m16n8k32 (PTX ISA, "Matrix
  //    fragments for mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
  //    A register i holds row g + 8 (i & 1), columns 4t + 16 (i >> 1) + 0..3;
  //    B register i holds rows 4t + 16 i + 0..3 of column g; D register i
  //    holds row g + 8 (i >> 1), column 2t + (i & 1).
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < kTile; ++e) {
    const uint32_t* rev = stage + e * kStage;
    const uint32_t* bb = rev + kRevWords;
    int d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A[row][col] = rev[15 - row + col]: four bytes from byte y on
        const int y = 15 - (g + 8 * (i & 1)) + 32 * s + 4 * t + 16 * (i >> 1);
        af[i] = __funnelshift_r(rev[y >> 2], rev[(y >> 2) + 1], 8 * (y & 3));
      }
      // B[k][g] = bb[k + 16 g], k = 32 s + 4 t (+ 16): word-aligned
      const uint32_t b0 = bb[8 * s + t + 4 * g], b1 = bb[8 * s + t + 4 * g + 4];
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(b0), "r"(b1));
    }
    // D[r][j] = c[r + 16 j]; lanes with t = 3 hold D's columns 6 and 7,
    // which are c[96..127] = 0.
    if (t < 3) {
      uint32_t* c = cols + e * kColStride + g + 32 * t;
      c[0] = (uint32_t)d[0];
      c[16] = (uint32_t)d[1];
      c[8] = (uint32_t)d[2];
      c[24] = (uint32_t)d[3];
    }
  }
  __syncwarp();

  // 3. Each lane reduces one element.
  const long long i = base + lane;
  if (i >= n) return;
  const uint32_t* c = cols + lane * kColStride;
  uint32_t w24[2 * FP_WORDS];
  uint64_t acc = 0;
#pragma unroll
  for (int w = 0; w < 2 * FP_WORDS; ++w) {
    acc += (uint64_t)c[4 * w] + ((uint64_t)c[4 * w + 1] << 8) + ((uint64_t)c[4 * w + 2] << 16) +
           ((uint64_t)c[4 * w + 3] << 24);
    w24[w] = (uint32_t)acc;
    acc >>= 32;
  }
  // acc is 0 here: the columns sum to a * b < p^2 < 2^768.
  // Montgomery reduction by words: (T + m p) / 2^384 < 2p, 12 words and a
  // top word that `fp_reduce_once` takes.
  uint32_t top = 0;
#pragma unroll
  for (int r = 0; r < FP_WORDS; ++r) {
    const uint32_t m = w24[r] * FP_PINV;
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; ++j) {
      const uint64_t s = (uint64_t)m * FP_P[j] + w24[r + j] + carry;
      w24[r + j] = (uint32_t)s;
      carry = s >> 32;
    }
    const uint64_t s = (uint64_t)w24[r + FP_WORDS] + carry + top;
    w24[r + FP_WORDS] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }
  uint32_t res[FP_WORDS];
  fp_reduce_once(res, w24 + FP_WORDS, top);
  fp_store(out + i * FP_WORDS, res);
}

}  // namespace

extern "C" {

int lh_fp_mul_mma(const void* a, const void* b, void* out, long long n, void* stream) {
  if (n > 0) {
    fp_mul_mma_kernel<<<blocks_for(n), kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
