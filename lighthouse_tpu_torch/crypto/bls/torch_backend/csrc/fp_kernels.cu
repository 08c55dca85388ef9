// The four hand-written Fp kernels of the verify path, with plain C
// launchers (extern "C", bound from Python with ctypes). Every launcher
// runs on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() so that a refused launch is reported.
//
// Arrays are (n, 12) int32 tensors holding u32 words, contiguous, one
// Fp element per row. One thread owns one element (K1-K3) or a chunk of
// one lane (K4) and keeps it in registers.
//
// K1 fp_mul_kernel
//   Replaces: lighthouse_tpu/crypto/bls/jax_backend/fp.py:310 `mul` (and
//   `sqr`, and through them every poly + redc of the tower, fp.py:172/261).
//   Bound: 300 32x32->64 word products per element (144 for a*b, 144 for
//   m*p, 12 for m) against 144 bytes moved (two 48-byte inputs, one
//   48-byte output): about 2 products per byte, below the card's balance
//   of about 5 integer multiply-adds per byte of memory bandwidth, so a
//   batch that filled the card would be bound by bytes. The verify path's
//   batches are a few hundred to a few tens of thousands of elements, so
//   in practice each launch is bound by launch latency; inside the fused
//   kernels, which run fp384.cuh's routines on a few threads each, by the
//   latency of one thread's dependent product chain.
//   Bound (reduction): a, b < p. After each of the 12 rows (products by
//   b's word i, then m = t_i (-p^-1) mod 2^32 and m p 2^(32 i) added, word
//   i dropped) the running value over the words not dropped is below
//   (2p + (2^32 - 1)(a + p)) / 2^32 < 2p < 2^382, and within a row below
//   2p + 2^32 p < 2^414. The two accumulators whose sum it is are each a
//   nonnegative part of it, so in row i neither has a nonzero word past
//   position i + 12, which the row's chains reach and carry into: no
//   carry leaves the words. The final sum (positions 12-24) is below 2p,
//   so one conditional subtraction makes it canonical.
//   Design: fp384.cuh `fp_mul`, CIOS on PTX carry chains: each row is two
//   chains of `madc.lo.cc` / `madc.hi.cc` (the multiplicand's even and
//   odd words, into two accumulators), then the reduction's two chains
//   (the fold of the row's lowest word and m, then p's odd words; p's
//   even words), p's words immediates; one `asm` statement a chain, so
//   the carry flag never crosses statements. The accumulators keep words
//   at fixed positions, so a product's halves stay one register pair and
//   each word product is one IMAD.WIDE.U32.X. A thread owns an element, no
//   shared memory. The same routine, or `fp_mul_wide` with `fp_redc_wide`
//   on the same chains, is every kernel's Fp product.
// K2 fp_addsub_kernel
//   Replaces: fp.py:294/299/304 `add` / `sub` / `neg`.
//   Bound: bytes (144 per element for add/sub, 96 for neg) against one
//   carry chain of 12 adds and a conditional correction: memory bound.
//   Bound (reduction): a, b < p. add: a + b < 2p < 2^382, so the sum's
//   chain never carries out of 12 words and one conditional subtraction
//   (`fp_reduce_once`, t - p taken when it does not borrow) makes it
//   canonical. sub: a - b borrows out of the top word exactly when a < b;
//   then p is added under the borrow's mask, and that sum carries out of
//   the top word, back to a - b + p in (0, p). neg: a != 0 gives p - a in
//   (0, p), no borrow; a = 0 gives 0 (the mask clears p).
//   Design: fp384.cuh `fp_add` (an `add.cc` / `addc.cc` chain, then a
//   `sub.cc` / `subc.cc` chain by p and one branch-free select), `fp_sub`
//   (a borrow chain, its borrow as a mask, p & mask added in a carry
//   chain) and `fp_neg` ((p & mask) - a in one borrow chain); `op` selects
//   add (0), sub (1) or neg (2).
// K3 fp_pow_kernel
//   Replaces: fp.py:422 `_pow_bits_windowed` as used by fp.py:460 `inv`
//   and fp.py:497 `sqrt_candidate` (a 95-step lax.scan of windowed steps).
//   Bound: operations: the power p - 2, on the cheaper of the plain
//   version's 4-bit windows and 5-bit sliding windows (here the sliding
//   ones, `chip_smoke.power_word_products`), needs 113,052 word products
//   per element, against 96 bytes moved.
//   Design: plain MSB-first square-and-multiply in registers with the
//   public exponent read from a uniform (cached) global array; 0 -> 0.
// K4 fp_batch_inv_kernel
//   Replaces: fp.py:466 `batch_inv` (two lax.scans of N steps and one
//   Fermat chain).
//   Bound: operations: 3N - 1 products (N forward from one, N - 1 by the
//   prefixes and N updates of the inverse on the way back) and one
//   inversion (fp384.cuh's binary GCD, 3,472 word products) per lane,
//   (3N - 1) 300 + 3,472: 234,472 word products a lane at N = 257
//   (`chip_smoke.batch_inv_word_products`), against 2 * 48 * N bytes per
//   lane; with few lanes it is bound by the latency of one thread's
//   dependent product chain.
//   Design: a column (trailing lane) is cut into `chunks` contiguous
//   chunks of c = ceil(N / chunks) rows, a thread each; thread j of a
//   column walks rows [j c, min((j + 1) c, N)): the chunk's prefix
//   products from its first value (zeros read as one) written into the
//   output, one inversion of the chunk's total (fp384.cuh `fp_inv`, the
//   binary GCD), a backward loop that overwrites the prefixes with the
//   inverses (inv_k = t prefix_(k-1), t = t a'_k; the first row's is t),
//   zero entries written back as zero. The inverse of each entry is
//   unique, so any cut gives the plain version's words; no thread reads
//   another's values, so there is no shuffle and no barrier.
//   `chunks_per_column`: 32 (a warp a column, its 32 GCDs side by side)
//   below kWarpColumns = 512 columns, 8 below kThreadColumns = 16,384,
//   then 1 (a thread a column, the cheapest schedule, once the columns
//   alone fill the card): each the fastest of 32, 8 and 1 at 257 rows and
//   1, 8, 128, 1,024, 4,096 and 16,384 columns on the card
//   (`chip_probes/k4_k5_schedules.py`, PERF.md). The cut does more work
//   than the bound counts: 3 (N - m) products and m inversions a column,
//   m = ceil(N / c) its nonempty chunks; at N = 257 in 32 chunks c = 9
//   and m = 29, 684 products and 29 inversions, 305,888 word products a
//   column (the thread a column: 3 (N - 1) products and one inversion,
//   233,872). At one column the time is one chunk's chain: 8 + 16
//   products and a GCD.
//   Measured (NVIDIA H100 80GB HBM3, 700.00 W, `chip_smoke.py [timing]`,
//   in turns with the thread a column): 0.08209 and 0.08440 ms at 257 x 1
//   against 0.83598 and 0.83596; 0.09560 and 0.09534 at 257 x 8. ptxas
//   (sm_90a, CUDA 12.8): 110 registers, 192 bytes of stack (`fp_inv`'s),
//   no spills (the thread a column: 92 registers, the same stack).
//   Bound (reduction): every product is K1's CIOS (canonical in, canonical
//   out); `fp_inv` returns the canonical inverse (its closing Montgomery
//   product is K1's).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long long kWarpColumns = 512;       // K4: 32 threads a column below this many columns,
constexpr long long kThreadColumns = 16384;   // 8 below this many, then a thread a column

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__global__ void fp_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FP_WORDS], y[FP_WORDS], r[FP_WORDS];
  fp_load(x, a + i * FP_WORDS);
  fp_load(y, b + i * FP_WORDS);
  fp_mul(r, x, y);
  fp_store(out + i * FP_WORDS, r);
}

__global__ void fp_addsub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, long long n, int op) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FP_WORDS], y[FP_WORDS], r[FP_WORDS];
  fp_load(x, a + i * FP_WORDS);
  if (op == 2) {
    fp_neg(r, x);
  } else {
    fp_load(y, b + i * FP_WORDS);
    if (op == 0) {
      fp_add(r, x, y);
    } else {
      fp_sub(r, x, y);
    }
  }
  fp_store(out + i * FP_WORDS, r);
}

__global__ void fp_pow_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ e,
                              int nbits, uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FP_WORDS], r[FP_WORDS];
  fp_load(x, a + i * FP_WORDS);
  fp_pow(r, x, e, nbits);
  fp_store(out + i * FP_WORDS, r);
}

// Threads a column for `lanes` columns (see K4's header).
inline int chunks_per_column(long long lanes) { return lanes < kWarpColumns ? 32 : lanes < kThreadColumns ? 8 : 1; }

__global__ void fp_batch_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                    long long steps, long long lanes, int chunks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = t / chunks;
  if (lane >= lanes) return;
  const long long per = (steps + chunks - 1) / chunks;
  const long long begin = (t % chunks) * per, end = min(begin + per, steps);
  if (begin >= end) return;  // an empty chunk
  const long long stride = lanes * FP_WORDS;
  const uint32_t* src = a + lane * FP_WORDS;
  uint32_t* dst = out + lane * FP_WORDS;

  // Forward: out[k] = prod_{begin <= j <= k} a'[j], with zero entries read as one.
  uint32_t acc[FP_WORDS], x[FP_WORDS];
  fp_load(acc, src + begin * stride);
  if (fp_is_zero(acc)) fp_set_one(acc);
  fp_store(dst + begin * stride, acc);
  for (long long k = begin + 1; k < end; ++k) {
    fp_load(x, src + k * stride);
    if (fp_is_zero(x)) fp_set_one(x);
    fp_mul(acc, acc, x);
    fp_store(dst + k * stride, acc);
  }
  // t = (prod a')^-1 over the chunk, then walk back: inv_k = t * prefix_{k-1}, t *= a'_k.
  uint32_t t_inv[FP_WORDS], p[FP_WORDS], r[FP_WORDS];
  fp_inv(t_inv, acc);
  for (long long k = end - 1; k > begin; --k) {
    fp_load(x, src + k * stride);
    const bool zero = fp_is_zero(x);
    if (zero) fp_set_one(x);
    fp_load(p, dst + (k - 1) * stride);
    fp_mul(r, t_inv, p);
    fp_mul(t_inv, t_inv, x);
    if (zero) {
#pragma unroll
      for (int w = 0; w < FP_WORDS; ++w) r[w] = 0;
    }
    fp_store(dst + k * stride, r);
  }
  fp_load(x, src + begin * stride);
  if (fp_is_zero(x)) {
#pragma unroll
    for (int w = 0; w < FP_WORDS; ++w) t_inv[w] = 0;
  }
  fp_store(dst + begin * stride, t_inv);
}

}  // namespace

extern "C" {

int lh_fp_mul(const void* a, const void* b, void* out, long long n, void* stream) {
  if (n > 0) {
    fp_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp_addsub(const void* a, const void* b, void* out, long long n, int op, void* stream) {
  if (n > 0) {
    fp_addsub_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, op);
  }
  return (int)cudaGetLastError();
}

int lh_fp_pow(const void* a, const void* e, int nbits, void* out, long long n, void* stream) {
  if (n > 0) {
    fp_pow_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)e, nbits, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lh_fp_batch_inv(const void* a, void* out, long long steps, long long lanes, void* stream) {
  if (steps > 0 && lanes > 0) {
    const int chunks = chunks_per_column(lanes);
    fp_batch_inv_kernel<<<blocks_for(lanes * chunks), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, steps, lanes, chunks);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
