#!/usr/bin/env python3
"""Smoke run of lighthouse_tpu_torch on one CUDA GPU (written for an H100).

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

  1. device   require a CUDA device; print its name and power limit
  2. build    compile the hand-written kernels (csrc/) with nvcc, one
              process per source; K5's to K18's registers and spills
              from ptxas
  3. kernels  K1-K4 and K6 bit-identical to their plain PyTorch versions
              on the card: edge inputs 0, 1, p-1, p-2 and 4096 seeded
              random elements; batch inversion at N = 257 with zero
              lanes; K6 also against K1, at 4104 elements and at the
              tails 1, 31 and 33. The tower products K7 (fp2 mul, sqr)
              and K8 (fp12 full, square, sparse) bit-identical to their
              plain versions and to the K1/K2 composition they replaced:
              edge values 0, one, p-1 in every word slot and u, seeded
              random elements, a broadcast operand, element counts that
              are no multiple of a block or a six-thread group. The
              chains K9 (|z|-power, n = 1 and 4, with one and a lane
              whose checkpoints take decompression's g2 = 0 branch), K10
              (G1, 128 points at 64 bits) and K11 (G2, 256 points at 64
              bits and clear_cofactor's 2 x 128 at 128 broadcast bits),
              with infinity rows, P + (-P), a P, -P pair and all-zero and
              all-one scalars, and K12 (the Miller loop, 129 pairs with P,
              Q and both at infinity: the generator-substitution lanes),
              K13 (SSWU, 256 u's with 0, one, u and -1 among them) and K14
              (the isogeny, SSWU's 256 points and the kernel point X0),
              bit-identical to their plain versions and to the K1-K4/K7/K8
              composition they replaced. The tree sums K15 (G1, 2 columns)
              and K16 (G2, one column) at column lengths 1, 2, 3, 5, 128
              and 512 with P == Q, P == -Q and infinity rows, K17 (sum and
              cofactor clearing, 19 elements with u = 0's point, q1 = q0,
              q1 = -q0 and q1 at infinity, and without the sum) and K18
              (Fp12 product, n = 1, 2, 3, 129), and all four at the verify
              path's shapes, bit-identical to their plain versions and to
              the composition they replaced. After
              set-up, K5 bit-identical to its plain version (on CPU
              tensors) on 64 points: interop keys, the order-3 point
              (0, 2), points of E(Fp) outside G1 and infinity rows
  4. verify   the verify path, `verify_signature_sets`, on 128 sets x 1
              key and on the mainnet-block shape 128 sets x 128 keys: both
              True, with the kernels' launch counts of one verify (K9 5,
              K10 1, K11 1, K4 1, K12 1, K13 1, K14 1, K3 1 and K15-K18 1
              each at either shape); then a
              tampered message, a wrong key and a non-subgroup signature
              at 128 x 1, each False; warm ms per batch and sets/s,
              and the warm host staging's ms alone
     pk       the admission path, `batch_validate_public_keys`, at
              S = 16384 (a checkpoint-start admission chunk) and S = 16
              (one block's deposits): 256 distinct interop pubkeys tiled,
              every 8th key an invalid encoding; every verdict equal to
              the ref oracle's, exactly one K5 launch and no other kernel
              per call; warm ms and keys/s, host decompression and packing
              ms, K5's device ms
     mxu      the same verify batches, bad batches included, with
              fp.USE_MXU_MUL set (every Fp product on K6, the JAX
              package's LIGHTHOUSE_TPU_MXU_FP_MUL path): verdicts, K6
              launched as often as K1 was by default and K1 never, K7 to
              K18 as often as by default (they keep their CUDA-core
              products, as the JAX package's flag reaches only direct Fp
              products); ms per
              batch with and without the flag, timed in turns; admission
              at S = 16 still one K5 launch and nothing else
  5. profile  device busy time, idle share and top kernels of one verify,
              at both shapes by default and at 128 x 128 with the flag; the
              trace holds K3, K4 and K9-K18 as often as a verify launches
              them
     timing   each kernel at the shape that carries most of its main-path
              work, against its plain version and its bound (K6 at K1's
              shape, so the two compare; K7 and K8 also against the K1/K2
              composition they replaced); K9-K18 at the verify path's
              shapes against their plain versions, the composition they
              replaced and their bounds, K9 with its Fermat chain's share
     extras   to_affine (G1, G2), fp6_mul and fp6_inv on the card
              bit-identical to the same functions on CPU tensors
  6. parity   one S=4, K=2 batch: the card's Miller partial and GT value
              bit-identical to the same functions on the CPU
  7. sharded  `parallel.sharded.sharded_verify_signature_sets` in spawned
              ranks (kernels built by this process first, join under a
              time limit): NCCL over W = min(4, cards) ranks, one card
              each, and gloo over 2 ranks sharing cuda:0. Each world: a
              128 x 1 batch True and a tampered one False on every rank,
              with the kernels' launch counts of one verify on every rank
              (K18 twice: the rank's Miller values and the partials); a
              tampered S = 8 batch whose GT value is bit-identical to the
              one-process final_exponentiation(verify_pipeline_local(...))
              on the card; warm ms per batch (median of 3), bytes
              broadcast and gathered
     coalescer  the port's BatchVerifier over the port's backend on the
              card (s_bucket = 32): 8 threads submit 32 single sets, one
              with a tampered message (the last set of each thread through
              `api.verify_signature_set`, which routes to the service);
              verdicts equal to the oracle's, no internal error,
              `device_fingerprint` on "cuda"; dispatches, their sizes,
              launches (each dispatch one verify's) and wall time

then a `{"kernels": [...]}` JSON line, the nvidia-smi name/power line, and
as the last line `{"ok": true, "device": {...}}`. Signature sets are built
with the port's own ref oracle from fixed interop keys.
"""

from __future__ import annotations

import datetime
import json
import os
import queue
import random
import socket
import statistics
import subprocess
import sys
import threading
import time

DEVICE = "cuda"
N_RANDOM = 4096  # random elements of the kernel comparisons
BATCH_INV_STEPS = 257  # K4's leading axis on the verify path: 2 S + 1
N_SETS = 128
BLOCK_KEYS = 128
WARM_REPS = 3
# a verify's wall time varies by several ms from call to call (host
# staging is Python): its median is taken over more calls
VERIFY_REPS = 11
# Pubkey admission: one chunk of a checkpoint-start admission (1/64 of a
# million-key registry) and one block's deposits (MAX_DEPOSITS).
PK_SIZES = (16384, 16)
PK_DISTINCT = 256
PK_INVALID_EVERY = 8
K5_POINTS = 64

# The card's published memory rate (H100 SXM data sheet): the bytes bound.
MEM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-add throughput per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): the operations bound, with the SM count and maximum SM clock
# read from this card. One 32 x 32 -> 64-bit word product counts as one.
IMAD_PER_SM_PER_CLK = 64
# 32 x 32 -> 64 word products of one CIOS Montgomery product: 12x12 for
# a*b, 12x12 for m*p, 12 for m. A square needs the 78 distinct a_i a_j of
# its 12x12, then the same reduction.
WORD_PRODUCTS_PER_MUL = 300
WORD_PRODUCTS_PER_SQR = 78 + 156
# K6: the H100 SXM's dense int8 tensor-core peak (data sheet, 1,979 TOPS;
# a multiply-add counts as two operations), the operations of its two
# m16n8k32 MMAs per element, and the word products of its reduction
# (12 for m, 12x12 for m*p).
INT8_TENSOR_OPS_PER_S = 1.979e15
MMA_OPS_PER_MUL = 2 * (16 * 8 * 32) * 2
REDC_WORD_PRODUCTS = 156

SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/fp_kernels.cu"
G1_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/g1_kernels.cu"
MMA_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/fp_mma.cu"
TOWER_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/tower_kernels.cu"
CURVE_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/curve_kernels.cu"
FINAL_EXP_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/final_exp_kernels.cu"
PAIRING_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/pairing_kernels.cu"
H2C_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/h2c_kernels.cu"
FOLD_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/fold_kernels.cu"
COFACTOR_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/cofactor_kernels.cu"
REPLACES = {
    "fp_mul": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:310",
    "fp_addsub": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:294",
    "fp_pow": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:460",
    "fp_batch_inv": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:466",
    "g1_subgroup_check": "lighthouse_tpu/crypto/bls/jax_backend/api.py:599",
    "fp_mul_mma": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:373",
    "fp2_mul": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:61",
    "fp12_mul": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:243",
    "cyclotomic_pow_x": "lighthouse_tpu/crypto/bls/jax_backend/pairing.py:239",
    "g1_scalar_mul": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:282",
    "g2_scalar_mul": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:282",
    "miller_loop": "lighthouse_tpu/crypto/bls/jax_backend/pairing.py:163",
    "sswu": "lighthouse_tpu/crypto/bls/jax_backend/h2c.py:117",
    "iso3_map": "lighthouse_tpu/crypto/bls/jax_backend/h2c.py:146",
    "g1_tree_sum": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:138",
    "g2_tree_sum": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:138",
    "clear_cofactor": "lighthouse_tpu/crypto/bls/jax_backend/h2c.py:189",
    "product_reduce": "lighthouse_tpu/crypto/bls/jax_backend/pairing.py:282",
}
SOURCES = {"fp_mul_mma": MMA_SOURCE, "fp2_mul": TOWER_SOURCE, "fp12_mul": TOWER_SOURCE,
           "cyclotomic_pow_x": FINAL_EXP_SOURCE, "g1_scalar_mul": CURVE_SOURCE, "g2_scalar_mul": CURVE_SOURCE,
           "miller_loop": PAIRING_SOURCE, "sswu": H2C_SOURCE, "iso3_map": H2C_SOURCE, "g1_tree_sum": FOLD_SOURCE,
           "g2_tree_sum": FOLD_SOURCE, "clear_cofactor": COFACTOR_SOURCE, "product_reduce": FOLD_SOURCE}
# the chain kernels K9-K18, and the field and tower kernels timed at their heaviest main-path shape
CHAIN_KERNELS = ("cyclotomic_pow_x", "g1_scalar_mul", "g2_scalar_mul", "miller_loop", "sswu", "iso3_map",
                 "g1_tree_sum", "g2_tree_sum", "clear_cofactor", "product_reduce")
TIMED_KERNELS = ("fp_mul", "fp_addsub", "fp_pow", "fp_batch_inv", "fp2_mul", "fp12_mul")
VERIFY_KERNELS = (*TIMED_KERNELS, *CHAIN_KERNELS)
# the verify path with fp.USE_MXU_MUL set: K6 in K1's place
MXU_KERNELS = ("fp_mul_mma", *VERIFY_KERNELS[1:])
# launches of one verify, whatever its shape: the five |z|-power chains of the
# final exponentiation (K9), r_i aggpk_i (K10), the signatures' 2-stacked
# multiplication (K11), the Miller pairs' batch inversion (K4), the Miller
# loop (K12), SSWU (K13), the isogeny (K14), fp12_inv's Fp2 inversion (K3),
# the sums of each set's keys (K15) and of the r_i sig_i (K16), the sum of
# the SSWU points with the cofactor clearing (K17) and the product of the
# Miller values (K18)
VERIFY_LAUNCHES = {"cyclotomic_pow_x": 5, "g1_scalar_mul": 1, "g2_scalar_mul": 1, "fp_batch_inv": 1,
                   "miller_loop": 1, "sswu": 1, "iso3_map": 1, "fp_pow": 1, "g1_tree_sum": 1, "g2_tree_sum": 1,
                   "clear_cofactor": 1, "product_reduce": 1}
# a sharded rank also multiplies the gathered partials (K18)
SHARDED_LAUNCHES = {**VERIFY_LAUNCHES, "product_reduce": 2}
# the tree sums' edge column lengths (512: a sync-committee aggregate's
# keys) and the Fp12 product's edge counts (129: the Miller values of a
# 128-set verify); K17's edge batch, no multiple of its 16 pairs a block
FOLD_LENGTHS = (1, 2, 3, 5, 128, 512)
REDUCE_COUNTS = (1, 2, 3, 129)
COFACTOR_EDGE = 19
# the kernels that keep their CUDA-core products with fp.USE_MXU_MUL set
MXU_UNMOVED = ("fp2_mul", "fp12_mul", *CHAIN_KERNELS)
K6_TAILS = (1, 31, 33)
# K7 runs 64 elements a block, K8 16 (groups of six threads): whole blocks
# and counts that are none
K7_COUNTS = (1, 65, 2048, 2051)
K8_COUNTS = (1, 17, 128, 131)
# word products that one element needs (the operations bound): a Karatsuba
# Fp2 product is 3 Fp products of 12 x 12 words, an Fp2 square 2, and each
# output Fp component is reduced once (156). K7: mul, sqr. K8: full is 36
# Fp2 products; square the 21 distinct a_i a_j, 6 of them squares; sparse 18.
K7_WORD_PRODUCTS = {0: 3 * 144 + 2 * 156, 1: 2 * 144 + 2 * 156}
K8_WORD_PRODUCTS = {
    0: 36 * 3 * 144 + 12 * 156,
    1: (6 * 2 + 15 * 3) * 144 + 12 * 156,
    2: 18 * 3 * 144 + 12 * 156,
}
# bytes of one element: inputs read once, the output written once (keys as
# above: K7 mul, sqr; K8 full, square, sparse)
K7_BYTES = {0: 3 * 96, 1: 2 * 96}
K8_BYTES = {0: 3 * 576, 1: 2 * 576, 2: 2 * 576 + 3 * 96}
# K9-K11, word products one element needs (the operations bound). A
# Karatsuba Fp2 product 744, an Fp2 square 600, an Fp12 product 17,424 (K8
# full); products by small constants are additions and count as none. K9:
# 63 compressed squarings (4 Fp2 squares, 2 products), six decompressions
# (2 squares, 3 products, a norm of two Fp squares summed and reduced once,
# 2 Fp products, 1 product, 1 square), the shared inversion (15 Fp products
# and the power p - 2, `inversion_word_products`), five Fp12 products.
FP2_MUL_WP, FP2_SQR_WP, FP12_MUL_WP = 744, 600, 36 * 3 * 144 + 12 * 156
K9_WORD_PRODUCTS_BUT_POWER = (63 * (4 * FP2_SQR_WP + 2 * FP2_MUL_WP)
                              + 6 * (3 * FP2_SQR_WP + 4 * FP2_MUL_WP + 2 * 78 + 156 + 2 * WORD_PRODUCTS_PER_MUL)
                              + 15 * WORD_PRODUCTS_PER_MUL + 5 * FP12_MUL_WP)
K9_BYTES = 2 * 576
# K12: a doubling step is 6 Fp2 squares, 5 Fp2 products and 4 Fp products
# (the line's scalings by xp, yp), an addition step 3 squares, 10 products
# and 4 Fp products; each of the 63 bits of |z| below the leading one takes
# an Fp12 square (K8's 10,080), a doubling and a sparse product (9,648), the
# five set bits an addition and another sparse product. Bytes of a pair:
# P and Q in, the two flags, f out.
K12_DBL_WP = 6 * FP2_SQR_WP + 5 * FP2_MUL_WP + 4 * WORD_PRODUCTS_PER_MUL
K12_ADD_WP = 3 * FP2_SQR_WP + 10 * FP2_MUL_WP + 4 * WORD_PRODUCTS_PER_MUL
K12_WORD_PRODUCTS = (63 * (K8_WORD_PRODUCTS[1] + K12_DBL_WP + K8_WORD_PRODUCTS[2])
                     + 5 * (K12_ADD_WP + K8_WORD_PRODUCTS[2]))
K12_BYTES = 2 * 48 + 2 * 96 + 2 + 576
K13_BYTES, K14_BYTES = 3 * 96, 5 * 96  # u in, x and y out; x and y in, X, Y, Z out
H2C_CONST_BYTES = 10 * 96  # K13's and K14's constant operand, read once
# K15, K16: an addition is 12 field products (products by 3b are additions);
# a point is 3 coordinates of 48 or 96 bytes. K17: the sum (12 products),
# psi three times (2 each), the doubling (6 products, 2 squares), the two
# final additions (24), and the two 128-bit chains; q0, q1 in, H out, and
# the constants (CX, CY; 2 x 128 bit bytes) read once. K18: n - 1 Fp12
# products (K8 full), a value 576 bytes.
G1_ADD_WP, G2_ADD_WP = 12 * WORD_PRODUCTS_PER_MUL, 12 * FP2_MUL_WP
K17_BYTES, K17_CONST_BYTES = 3 * 3 * 96, 2 * 96 + 2 * 128


def pow_word_products(e: int, mul: int, sqr: int) -> int:
    """A power by a public exponent on the plain version's schedule
    (`fp.pow_windowed`, 4-bit windows, MSB first): the table's square and
    13 products, 4 squares per digit below the leading one, a product per
    nonzero digit below it."""
    digits = []
    while e:
        digits.append(e & 15)
        e >>= 4
    return (1 + 4 * (len(digits) - 1)) * sqr + (13 + sum(1 for d in digits[:-1] if d)) * mul


def inversion_word_products(P: int) -> int:
    """An Fp inversion, the power p - 2 (K3's function on the verify path)."""
    return pow_word_products(P - 2, WORD_PRODUCTS_PER_MUL, WORD_PRODUCTS_PER_SQR)


def h2c_word_products(P: int) -> tuple[int, int]:
    """(K13, K14) word products one element needs. The Fp2 inversion: the
    norm's two Fp squares summed and reduced once, the power p - 2, two Fp
    products. K13: u^2, (Z u^2)^2, the inversion, x1, x2, gx1 and gx2 (a
    square and a product each), two square-root candidates (the powers
    (p - 3) / 4 and (p - 1) / 2, three products), y1^2, and sgn0 of u and y
    (four reductions out of Montgomery form); the products by Z = -(2 + u)
    and A = 240 u are additions. K14: the inversion, d^2, six products,
    four Fp products (1/9, -1/27)."""
    inv = 2 * 78 + REDC_WORD_PRODUCTS + inversion_word_products(P) + 2 * WORD_PRODUCTS_PER_MUL
    sqrt = (pow_word_products((P - 3) // 4, FP2_MUL_WP, FP2_SQR_WP)
            + pow_word_products((P - 1) // 2, FP2_MUL_WP, FP2_SQR_WP) + 3 * FP2_MUL_WP)
    sswu = (2 * FP2_SQR_WP + inv + 2 * FP2_MUL_WP + 2 * (FP2_SQR_WP + FP2_MUL_WP) + 2 * sqrt
            + FP2_SQR_WP + 4 * REDC_WORD_PRODUCTS)
    iso = inv + FP2_SQR_WP + 6 * FP2_MUL_WP + 4 * WORD_PRODUCTS_PER_MUL
    return sswu, iso


def k17_word_products() -> int:
    """Word products one element of K17 needs (see K17_BYTES)."""
    return ((12 + 3 * 2 + 6 + 24) * FP2_MUL_WP + 2 * FP2_SQR_WP
            + 2 * scalar_mul_word_products(128, FP2_MUL_WP, FP2_SQR_WP))


def scalar_mul_word_products(nbits: int, mul: int, sqr: int) -> int:
    """Word products of one windowed scalar multiplication (K10, K11), from
    a field product's and a square's: 15 complete additions build the table
    (row 16 is never read), each 4-bit digit costs 4 doublings and 1
    addition. An addition is 12 products, a doubling 6 products and 2
    squares; the products by 3b are additions."""
    digits = (nbits + 3) // 4
    return (15 + digits) * 12 * mul + 4 * digits * (6 * mul + 2 * sqr)
# Sharded verify: at most this many ranks, one card each, over NCCL; the
# seed of the staged RLC scalars; the time limit on a world's join.
SHARDED_MAX_RANKS = 4
SHARDED_SEED = 11
SHARDED_S8 = 8
SHARDED_JOIN_SECONDS = 420
# Coalescer: 8 threads of 4 single sets each, into buckets of 32.
COALESCER_THREADS = 8
COALESCER_PER_THREAD = 4
COALESCER_BUCKET = 32


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` warm calls, by CUDA
    events: the device timeline, gaps included while the host issues."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


#: traces that came back with no device event and were taken again
EMPTY_TRACES = 0
TRACE_TRIES = 3


def traced_device_events(window):
    """Run window() under torch.profiler, tracing the device's activity
    only, and return (rows, wall ms of the traced window), a row being
    (self device microseconds, calls, name) of an event that spent time
    on the device. The profiler now and then returns a trace with no
    device event at all; such a trace is counted in EMPTY_TRACES and taken
    again, and after TRACE_TRIES empty traces this raises."""
    global EMPTY_TRACES
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_TRIES):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            window()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        if rows:
            return rows, wall_ms
        EMPTY_TRACES += 1
    raise RuntimeError(f"the profiler trace held no device events in {TRACE_TRIES} tries")


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of one launch of `kernel` (a name in the
    profiler's device events) over `reps` warm calls of fn."""
    import torch

    fn()
    torch.cuda.synchronize()
    rows, _ = traced_device_events(lambda: [fn() for _ in range(reps)])
    hits = [(us, c) for us, c, k in rows if kernel in k]
    if not hits:
        raise RuntimeError(f"the profiler trace holds no device event of {kernel}")
    return sum(us for us, _ in hits) / sum(c for _, c in hits) / 1e3


# -- inputs ----------------------------------------------------------------------


def field_inputs(fp, P, n: int, seed: int, device):
    """Edge values 0, 1, p-1, p-2 (as stored words and in Montgomery form)
    and n seeded random canonical elements: (k, 12) int32 on device."""
    import torch

    rng = random.Random(seed)
    edges = [0, 1, P - 1, P - 2]
    mont_edges = [(x * fp.R_MONT) % P for x in edges]
    vals = edges + mont_edges + [rng.randrange(P) for _ in range(n)]
    return torch.from_numpy(fp.ints_to_words(vals)).to(device)


def fp2_inputs(fp, P, n: int, seed: int, device):
    """Fp2 edge values 0, one, p - 1 in every word slot and u, then seeded
    random elements: (n, 2, 12) int32 on device, Montgomery form."""
    import torch

    rng = random.Random(seed)
    pairs = [(0, 0), (fp.R_MONT, 0), (P - 1, P - 1), (0, fp.R_MONT)]
    pairs += [(rng.randrange(P), rng.randrange(P)) for _ in range(max(0, n - len(pairs)))]
    words = fp.ints_to_words([x for pair in pairs[:n] for x in pair])
    return torch.from_numpy(words).reshape(n, 2, fp.WORDS).to(device)


def fp12_inputs(fp, tower, P, n: int, seed: int, device):
    """Tower Fp12 edge values p - 1 in every word slot, 0 and one, then
    seeded random elements: (n, 2, 3, 2, 12) int32 on device."""
    import torch

    edges = torch.stack([
        torch.from_numpy(fp.int_to_words(P - 1)).expand(2, 3, 2, fp.WORDS),
        torch.zeros(2, 3, 2, fp.WORDS, dtype=torch.int32),
        tower.fp12_one((), "cpu"),
    ]).to(device)
    rand = fp2_inputs(fp, P, 6 * n + 4, seed, device)[4:].reshape(n, 2, 3, 2, fp.WORDS)
    return torch.cat([edges, rand])[:n]


def curve_inputs(torch, fp, curve, group: str, n: int, seed: int):
    """n projective points of G1 or G2 on the card, with Z != 1: sums of
    pairs of 8 seeded random subgroup points, the negative of the first and
    infinity. Row 0 is P + (-P) (an infinity that the complete addition
    forms), row 1 infinity + infinity, rows 2 and 3 the pair P and -P."""
    from lighthouse_tpu_torch.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
    from lighthouse_tpu_torch.crypto.bls.torch_backend.pack import pack_g1_batch, pack_g2_batch

    gen, inf, pack, F = {
        "g1": (g1_generator, g1_infinity, pack_g1_batch, curve.FP),
        "g2": (g2_generator, g2_infinity, pack_g2_batch, curve.FP2),
    }[group]
    rng = random.Random(seed)
    base = [gen().mul(rng.getrandbits(64) | 1) for _ in range(8)]
    base += [-base[0], inf()]
    x, y, i = pack(base)
    p = curve.from_affine(F, fp.from_jax_limbs(x, DEVICE), fp.from_jax_limbs(y, DEVICE),
                          torch.from_numpy(i).to(DEVICE))
    ia = torch.tensor([0, 9, 0, 8] + [k % 8 for k in range(4, n)], device=DEVICE)
    ib = torch.tensor([8, 9, 9, 9] + [(3 * k + 1) % 10 for k in range(4, n)], device=DEVICE)
    return curve.add(F, curve.Proj(*(c[ia] for c in p)), curve.Proj(*(c[ib] for c in p)))


def scalar_bits(torch, n: int, width: int, seed: int):
    """(n, width) int32 seeded random MSB-first bits, as the verify path's
    r_bits: rows 2 and 3 equal (the P, -P pair of `curve_inputs`), row 4
    all zero, row 5 all one."""
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (n, width), generator=g, dtype=torch.int32)
    bits[3] = bits[2]
    bits[4] = 0
    bits[5] = 1
    return bits.to(DEVICE)


def cyclotomic_inputs(torch, fp, tower, pairing, P, n: int, seed: int):
    """(n, 2, 3, 2, 12) Fp12 on the card: the final exponentiation's easy
    part f^((p^6 - 1)(p^2 + 1)) of seeded random f; from n = 3 on, lane 2
    is one (compressed all zero) and lane 3 a random element with b0 = b2 = 0,
    whose compressed squarings keep g2 = g5 = 0, so that every checkpoint
    decompresses through the g2 = 0 branch."""
    f = fp12_inputs(fp, tower, P, n + 3, seed, DEVICE)[3:]
    g = tower.fp12_mul(tower.fp12_conj(f), tower.fp12_inv(f))
    g = tower.fp12_mul(pairing.frobenius2(g), g)
    if n > 3:
        g[2] = tower.fp12_one((), DEVICE)
        g[3] = f[3]
        g[3, 1, 0] = 0
        g[3, 1, 2] = 0
    return g


def miller_inputs(torch, fp, n: int, seed: int, device=DEVICE):
    """n Miller pairs on the card, as the verify path hands them to K12:
    8 seeded random G1 and G2 points, affine, tiled; lanes 1, 2 and 3 with
    P, Q and both at infinity (the generator-substitution lanes). Also
    tests/test_torch_gpu.py's."""
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
    from lighthouse_tpu_torch.crypto.bls.torch_backend.pack import pack_g1_batch, pack_g2_batch

    rng = random.Random(seed)
    g1 = [g1_generator().mul(rng.randrange(1, R)) for _ in range(8)]
    g2 = [g2_generator().mul(rng.randrange(1, R)) for _ in range(8)]
    ps = [g1[i % 8] for i in range(n)]
    qs = [g2[(i // 8) % 8] for i in range(n)]
    ps[1], qs[2], ps[3], qs[3] = g1_infinity(), g2_infinity(), g1_infinity(), g2_infinity()
    px, py, pi = pack_g1_batch(ps)
    qx, qy, qi = pack_g2_batch(qs)
    return (fp.from_jax_limbs(px, device), fp.from_jax_limbs(py, device), torch.from_numpy(pi).to(device),
            fp.from_jax_limbs(qx, device), fp.from_jax_limbs(qy, device), torch.from_numpy(qi).to(device))


def sswu_inputs(fp, P, n: int, seed: int, device=DEVICE):
    """n SSWU inputs u on the card, Montgomery form: 0 (SSWU's t1 = 0
    branch), one, u, -1, then seeded random elements. Also
    tests/test_torch_gpu.py's."""
    import torch

    rng = random.Random(seed)
    pairs = [(0, 0), (1, 0), (0, 1), (P - 1, 0)] + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    words = fp.to_mont_host_bulk([x for pair in pairs[:n] for x in pair])
    return torch.from_numpy(words).reshape(n, 2, fp.WORDS).to(device)


def fold_inputs(torch, fp, curve, group: str, length: int, columns: int, seed: int):
    """Points for the tree sums on the card, from `curve_inputs` (Z != 1,
    infinity rows): G1 (columns, length), summed along axis 1 as the
    verify sums each set's keys; G2 (length,), one column summed along
    axis 0 as the verify sums the r_i sig_i. In every column the first
    level of the tree meets a P == Q pair (rows 0 and half), a P == -Q pair
    (rows 1 and half + 1) and an infinity row (the last). Also
    tests/test_torch_gpu.py's."""
    F = curve.FP if group == "g1" else curve.FP2
    n = length * columns
    p = curve_inputs(torch, fp, curve, group, max(n, 4), seed)
    cols = curve.Proj(*(c[:n].reshape(columns, length, *c.shape[1:]).clone() for c in p))
    half = length // 2
    if half >= 1:
        for c in cols:
            c[:, half] = c[:, 0]
    if half >= 2:
        cols.x[:, half + 1] = cols.x[:, 1]
        cols.y[:, half + 1] = F.neg(cols.y[:, 1])
        cols.z[:, half + 1] = cols.z[:, 1]
    if length >= 3:
        for c, v in zip(cols, curve.infinity(F, (columns,), cols.x.device)):
            c[:, length - 1] = v
    return cols if group == "g1" else curve.Proj(*(c[0] for c in cols))


def cofactor_inputs(torch, fp, curve, h2c, P, m: int, seed: int):
    """K17's operands on the card as the verify path hands them over: the
    isogeny's images q0, q1 (K14) of m seeded pairs u0, u1, the u0 of the
    first four lanes `sswu_inputs`' edges (0: SSWU's t1 = 0 branch, one,
    u, -1); lane 1 with q1 = q0 (P == Q), lane 2 with q1 = -q0 (the sum
    is infinity), lane 3 with q1 at infinity. Also tests/test_torch_gpu.py's."""
    u = sswu_inputs(fp, P, 2 * m, seed, DEVICE).reshape(2, m, 2, fp.WORDS)
    q = h2c.iso3_map(*h2c.sswu(u))
    q0, q1 = (curve.Proj(*(c[i].clone() for c in q)) for i in (0, 1))
    for c0, c1 in zip(q0, q1):
        c1[1] = c0[1]
    q1.x[2], q1.y[2], q1.z[2] = q0.x[2], curve.FP2.neg(q0.y[2]), q0.z[2]
    for c, v in zip(q1, curve.infinity(curve.FP2, (), q0.x.device)):
        c[3] = v
    return q0, q1


def make_sets(api, n_sets: int, keys_per_set: int):
    """bench.py's shapes: 8 distinct single-key sets tiled to n_sets, or one
    aggregate set of keys_per_set signers repeated n_sets times. The
    aggregate signature is the signature under the sum of the secret keys,
    which equals the sum of the signers' signatures."""
    from lighthouse_tpu_torch.crypto.bls.constants import R

    if keys_per_set == 1:
        base = []
        for i in range(8):
            sk, pk = api.interop_keypair(i)
            msg = bytes([i]) * 32
            base.append(api.SignatureSet(signature=sk.sign(msg), signing_keys=[pk], message=msg))
        return [base[i % 8] for i in range(n_sets)]
    pairs = [api.interop_keypair(i) for i in range(keys_per_set)]
    msg = b"\x07" * 32
    agg = api.SecretKey(sum(sk.k for sk, _ in pairs) % R).sign(msg)
    one = api.SignatureSet(signature=agg, signing_keys=[pk for _, pk in pairs], message=msg)
    return [one] * n_sets


def non_subgroup_signature(api):
    """A point on E2 outside the r-torsion subgroup, as a Signature."""
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.ref.curves import Point, _B2
    from lighthouse_tpu_torch.crypto.bls.ref.fields import Fp, Fp2

    x = 0
    while True:
        x += 1
        xe = Fp2(Fp(x), Fp(1))
        y = (xe * xe * xe + _B2).sqrt()
        if y is None:
            continue
        pt = Point(xe, y, False, _B2)
        if not pt.mul(R).inf:
            return api.Signature(pt)


def invalid_encodings():
    """name -> a 48-byte compressed G1 key that admission must refuse: two
    that decode to points outside G1 (besides the order-3 point), and the
    ones the host decoder rejects or reads as infinity."""
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref
    from lighthouse_tpu_torch.crypto.bls.ref.curves import Point, _B1
    from lighthouse_tpu_torch.crypto.bls.ref.fields import Fp

    non_g1, x_off, x = [], None, 5
    while len(non_g1) < 2 or x_off is None:
        x += 1
        y = (Fp(x) * Fp(x) * Fp(x) + _B1).sqrt()
        if y is None:
            x_off = x_off or x
        elif len(non_g1) < 2 and not Point(Fp(x), y, False, _B1).mul(R).inf:
            non_g1.append(ref.g1_to_compressed(Point(Fp(x), y, False, _B1)))
    return {
        "order_3": b"\x80" + bytes(47),  # (0, 2): on the curve, order 3
        "non_g1_a": non_g1[0],
        "garbage": b"\xff" * 48,
        "infinity": b"\xc0" + bytes(47),
        "x_ge_p": b"\x9f" + b"\xff" * 47,
        "not_on_curve": b"\x80" + x_off.to_bytes(47, "big"),
        "non_g1_b": non_g1[1],
        "uncompressed": bytes(48),
    }


def admission_keys(valid: list[bytes], invalid: list[bytes], n: int) -> list[bytes]:
    """n keys: the valid ones tiled, every PK_INVALID_EVERY-th key the next
    invalid encoding."""
    k = PK_INVALID_EVERY
    return [invalid[(i // k) % len(invalid)] if i % k == k - 1 else valid[(i - i // k) % len(valid)]
            for i in range(n)]


def oracle_pk_verdict(kb: bytes) -> bool:
    """The ref oracle's admission verdict: the key decodes with the full
    [r]P == O subgroup check and is not infinity."""
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref

    try:
        return not ref.g1_from_compressed(kb).inf
    except ref.DecodeError:
        return False


def ptxas_summary(log: str, kernel: str) -> str:
    """ptxas's register and spill lines for `kernel` from the build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            return "; ".join(l.split(":", 1)[-1].strip() for l in lines[i + 1 : i + 3])
    return "not found"


def ptxas_spills(log: str) -> dict[str, int]:
    """Spill-store bytes of every function in the build log that spills,
    device functions (`__noinline__`) included, by ptxas's name for it."""
    lines = log.splitlines()
    spills = {}
    for line, props in zip(lines, lines[1:]):
        if "Function properties for" in line and "bytes spill stores" in props:
            stores = int(props.split("bytes spill stores")[0].rsplit(",", 1)[-1])
            if stores:
                spills[line.rsplit(" ", 1)[-1]] = stores
    return spills


# -- phases ----------------------------------------------------------------------


def check_kernels(torch, fp, P, dev) -> None:
    a = field_inputs(fp, P, N_RANDOM, 1, dev)
    b = a.roll(1, dims=0)
    checks = {
        "fp_mul": (fp.mul(a, b), fp.mul_plain(a, b)),
        "fp_add": (fp.add(a, b), fp.addsub_plain(a, b, 0)),
        "fp_sub": (fp.sub(a, b), fp.addsub_plain(a, b, 1)),
        "fp_neg": (fp.neg(a), fp.addsub_plain(a, None, 2)),
        "fp_pow_inv": (fp.inv(a), fp.pow_plain(a, fp.INV_EXP)),
        "fp_pow_sqrt": (fp.sqrt_candidate(a), fp.pow_plain(a, fp.SQRT_EXP)),
    }
    # batch inversion: N = 257 steps x 16 lanes, zero entries in some lanes
    n = BATCH_INV_STEPS
    x = field_inputs(fp, P, n * 16 - 8, 2, dev).reshape(n, 16, fp.WORDS).clone()
    x[::5, 3] = 0
    x[:, 7] = 0
    checks["fp_batch_inv"] = (fp.batch_inv(x), fp.batch_inv_plain(x))
    # K6 against its plain version and against K1, at whole tiles of 32
    # elements and at tails
    for m in (a.shape[0], *K6_TAILS):
        x6, y6 = a[:m], b[:m]
        got6 = fp.mul_mxu(x6, y6)
        checks[f"fp_mul_mma_n{m}"] = (got6, fp.mul_mxu_plain(x6, y6))
        checks[f"fp_mul_mma_vs_k1_n{m}"] = (got6, fp.mul(x6, y6))
    torch.cuda.synchronize()
    for name, (got, want) in checks.items():
        if not torch.equal(got, want):
            bad = (got != want).any(dim=-1).nonzero()[:4].tolist()
            raise AssertionError(f"{name}: kernel differs from its plain version at {bad}")
    # spot-check the plain versions against Python integers
    ints = [fp.words_to_int(w) for w in a[:64].cpu()]
    got = fp.mul_plain(a[:64], a[:64]).cpu()
    rinv = pow(fp.R_MONT, -1, P)
    for i, v in enumerate(ints):
        assert fp.words_to_int(got[i]) == v * v * rinv % P, "plain mul disagrees with integers"
    phase("kernels", ok=True, compared=",".join(checks), elements=a.shape[0], batch_inv_steps=n)


def check_tower_kernels(torch, fp, tower, P, dev) -> None:
    """K7 and K8 bit-identical to their plain versions and to the K1/K2
    composition they replaced (fp.KERNEL_OPS), in every op and mode, with a
    broadcast operand (one element read with stride 0), at K7_COUNTS and
    K8_COUNTS elements."""
    cases = {}  # name -> (kernel output, composition over F)
    x2 = fp2_inputs(fp, P, max(K7_COUNTS), 7, dev)
    for n in K7_COUNTS:
        a, b, c = x2[:n], x2.roll(1, dims=0)[:n], x2[2]  # c: p - 1 in every slot
        cases[f"fp2_mul_n{n}"] = (tower.fp2_mul(a, b), lambda F, a=a, b=b: tower.fp2_mul_plain(a, b, F))
        cases[f"fp2_sqr_n{n}"] = (tower.fp2_sqr(a), lambda F, a=a: tower.fp2_sqr_plain(a, F))
        cases[f"fp2_mul_broadcast_n{n}"] = (tower.fp2_mul(a, c), lambda F, a=a, c=c: tower.fp2_mul_plain(a, c, F))
    x12 = fp12_inputs(fp, tower, P, max(K8_COUNTS), 8, dev)
    lines = fp2_inputs(fp, P, 2 * max(K8_COUNTS), 9, dev)
    for n in K8_COUNTS:
        a = x12[:n]
        operands = {
            "full": (tower.FP12_FULL, (x12.roll(1, dims=0)[:n],)),
            "square": (tower.FP12_SQUARE, ()),
            "sparse": (tower.FP12_SPARSE, (lines[:n], lines[n : 2 * n], x2[2])),
            "full_broadcast": (tower.FP12_FULL, (x12[0],)),
        }
        for mode_name, (mode, bs) in operands.items():
            cases[f"fp12_{mode_name}_n{n}"] = (
                tower.fp12_product(a, bs, mode),
                lambda F, a=a, bs=bs, mode=mode: tower.fp12_product_plain(a, bs, mode, F),
            )
    torch.cuda.synchronize()
    for name, (got, composed) in cases.items():
        for label, F in (("plain", fp.PLAIN_OPS), ("K1/K2 composition", fp.KERNEL_OPS)):
            want = composed(F)
            if not torch.equal(got, want):
                bad = (got != want).flatten(got.dim() - (2 if name.startswith("fp2") else 4)).any(dim=-1)
                raise AssertionError(f"{name}: kernel differs from its {label} at {bad.nonzero()[:4].tolist()}")
    phase("kernels", ok=True, compared="fp2_mul,fp2_sqr,fp12_full,fp12_square,fp12_sparse,broadcast",
          against="plain,K1/K2", k7_elements=",".join(map(str, K7_COUNTS)), k8_elements=",".join(map(str, K8_COUNTS)))


def chain_cases(torch, fp, curve, tower, pairing, h2c, P):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K9-K18 at the verify path's shapes (128 x 128 verify):
    K10 on S points at 64 bits, K11 on the 2 S stacked signatures at 64
    bits and on the cofactor clearing's 2 x S points at 128 broadcast bits
    (the chains K17 now runs: K11's launch of them before K17), K9 on one
    element and on four with the edge lanes, K12 on the S + 1 Miller pairs,
    K13 on the 2 S stacked u's, K14 on SSWU's 2 S points and the kernel
    point, K15 on S columns of K keys, K16 on one column of S points, K17
    on the isogeny's 2-stacked images of S messages, K18 on the S + 1
    Miller values."""
    S = N_SETS
    p1 = curve_inputs(torch, fp, curve, "g1", S, 21)
    b1 = scalar_bits(torch, S, 64, 22)
    p2 = curve_inputs(torch, fp, curve, "g2", 2 * S, 23)
    b2 = scalar_bits(torch, 2 * S, 64, 24)
    base = curve.Proj(*(c.reshape(2, S, 2, fp.WORDS) for c in p2))
    cc = fp.const(h2c._CC_BITS, DEVICE).reshape(2, 1, h2c._CC_WIDTH)
    g4 = cyclotomic_inputs(torch, fp, tower, pairing, P, 4, 25)
    smul = curve.scalar_mul_bits_plain
    cases = {
        "g1_scalar_mul_n128_b64": ([S, 64], lambda: curve.scalar_mul_bits(curve.FP, p1, b1),
                                   lambda: smul(curve.FP_PLAIN, p1, b1), lambda: smul(curve.FP, p1, b1)),
        "g2_scalar_mul_n256_b64": ([2 * S, 64], lambda: curve.scalar_mul_bits(curve.FP2, p2, b2),
                                   lambda: smul(curve.FP2_PLAIN, p2, b2), lambda: smul(curve.FP2, p2, b2)),
        "g2_scalar_mul_2x128_b128": ([2, S, h2c._CC_WIDTH], lambda: curve.scalar_mul_bits(curve.FP2, base, cc),
                                     lambda: smul(curve.FP2_PLAIN, base, cc), lambda: smul(curve.FP2, base, cc)),
    }
    for n in (1, 4):
        g = g4[:n].contiguous()
        cases[f"cyclotomic_pow_x_n{n}"] = ([n], lambda g=g: pairing.pow_abs_x(g), lambda g=g: pairing.pow_abs_x_plain(g),
                                          lambda g=g: pairing.pow_abs_x_composed(g, tower.KERNEL_TOWER))
    mil = miller_inputs(torch, fp, S + 1, 26)
    cases[f"miller_loop_n{S + 1}"] = ([S + 1], lambda: pairing.miller_loop(*mil),
                                      lambda: pairing.miller_loop_plain(*mil),
                                      lambda: pairing.miller_loop_composed(*mil, tower.KERNEL_TOWER))
    u = sswu_inputs(fp, P, 2 * S, 27)
    cases[f"sswu_m{2 * S}"] = ([2 * S], lambda: h2c.sswu(u), lambda: h2c.sswu_plain(u),
                               lambda: h2c.sswu_composed(u, tower.KERNEL_TOWER))
    x, y = h2c.sswu_plain(u)
    xs, ys = torch.cat([x, fp.const(h2c._X0, DEVICE)[None]]), torch.cat([y, y[:1]])
    cases[f"iso3_map_m{2 * S + 1}"] = ([2 * S + 1], lambda: h2c.iso3_map(xs, ys), lambda: h2c.iso3_map_plain(xs, ys),
                                       lambda: h2c.iso3_map_composed(xs, ys, tower.KERNEL_TOWER))
    cases.update(fold_cases(torch, fp, curve, tower, pairing, h2c, P, [(S, BLOCK_KEYS)], [S], S, [S + 1], 28))
    return cases


def fold_cases(torch, fp, curve, tower, pairing, h2c, P, g1_shapes, g2_lengths, cofactor_m, counts, seed,
               nosum=False):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K15-K18: K15 on G1 columns of each (columns, length) in
    `g1_shapes` and K16 on one G2 column of each length in `g2_lengths`
    (`fold_inputs`), K17 on K14's 2-stacked images of `cofactor_m`
    messages (`cofactor_inputs`; with `nosum`, also on q0 alone), K18 on
    each count of Fp12 values in `counts` (`fp12_inputs`: p - 1 in every
    word slot, zero, one, seeded random values)."""
    cases = {}
    trees = [("g1", columns, length, 1) for columns, length in g1_shapes]
    trees += [("g2", 1, length, 0) for length in g2_lengths]
    for group, columns, length, axis in trees:
        F, F_plain = (curve.FP, curve.FP_PLAIN) if group == "g1" else (curve.FP2, curve.FP2_PLAIN)
        pts = fold_inputs(torch, fp, curve, group, length, columns, seed + length)
        shape = [columns, length] if group == "g1" else [length]
        cases[f"{group}_tree_sum_{'x'.join(map(str, shape))}"] = (
            shape, lambda F=F, pts=pts, axis=axis: curve.tree_sum(F, pts, axis),
            lambda F=F_plain, pts=pts, axis=axis: curve.tree_sum_plain(F, pts, axis),
            lambda F=F, pts=pts, axis=axis: curve.tree_sum_plain(F, pts, axis))
    q0, q1 = cofactor_inputs(torch, fp, curve, h2c, P, cofactor_m, seed)
    cases[f"clear_cofactor_m{cofactor_m}"] = ([cofactor_m], lambda: h2c.clear_cofactor(q0, q1),
                                              lambda: h2c.clear_cofactor_plain(q0, q1),
                                              lambda: h2c.clear_cofactor_composed(q0, q1, curve.FP2))
    if nosum:
        cases[f"clear_cofactor_nosum_m{cofactor_m}"] = ([cofactor_m], lambda: h2c.clear_cofactor(q0),
                                                        lambda: h2c.clear_cofactor_plain(q0),
                                                        lambda: h2c.clear_cofactor_composed(q0, None, curve.FP2))
    for n in counts:
        fs = fp12_inputs(fp, tower, P, n, seed + n, DEVICE)
        cases[f"product_reduce_n{n}"] = ([n], lambda fs=fs: pairing.product_reduce(fs),
                                         lambda fs=fs: pairing.product_reduce_plain(fs),
                                         lambda fs=fs: pairing.product_reduce_composed(fs, tower.KERNEL_TOWER))
    return cases


def _stacked(out):
    """A kernel's output as one int64 tensor of u32 words (a point's three
    coordinates stacked)."""
    import torch

    t = torch.stack(list(out)) if isinstance(out, tuple) else out
    return t.to(torch.int64) & 0xFFFFFFFF


def max_word_err(got, want) -> int:
    return int((_stacked(got) - _stacked(want)).abs().max())


def check_chain_kernels(torch, cases) -> None:
    """Each kernel of `cases` (`chain_cases`, `fold_cases`) bit-identical to
    its plain version and to the composition it replaced, with the edge
    rows of `curve_inputs`, `scalar_bits`, `cyclotomic_inputs`,
    `miller_inputs`, `sswu_inputs`, `fold_inputs` and `cofactor_inputs`
    (and the isogeny's kernel point)."""
    for name, (_, run, plain, composed) in cases.items():
        got = run()
        for label, fn in (("plain version", plain), ("composition replaced", composed)):
            want = fn()
            if not torch.equal(_stacked(got), _stacked(want)):
                raise AssertionError(f"{name}: kernel differs from its {label}")
    phase("kernels", ok=True, compared=",".join(cases), against="plain,composition")


def check_g1_kernel(torch, api, fp, curve, valid: list[bytes], invalid: list[bytes]) -> None:
    """K5 on the card bit-identical to its plain version, the composed
    g1_in_subgroup on CPU tensors, on K5_POINTS points: valid keys, the
    decodable invalid ones, and infinity rows (the rest, and padding)."""
    keys = valid[: K5_POINTS - len(invalid)] + invalid
    pts, _ = api.decompress_public_keys(keys)
    x, y, inf = (torch.from_numpy(a) for a in api.pack_g1_batch(pts))
    xw, yw = fp.from_jax_limbs(x), fp.from_jax_limbs(y)
    want = curve.g1_subgroup_check_plain(xw, yw, inf)
    got = curve.g1_in_subgroup_kernel(xw.to(DEVICE), yw.to(DEVICE), inf.to(DEVICE)).cpu()
    n_valid = len(keys) - len(invalid)
    assert want.tolist() == [True] * n_valid + [False] * (len(pts) - n_valid), "plain K5 verdicts are wrong"
    if not torch.equal(got, want):
        raise AssertionError(f"g1_subgroup_check differs from its plain version at {(got != want).nonzero().tolist()}")
    phase("kernels", ok=True, compared="g1_subgroup_check", points=len(pts), g1=n_valid,
          non_g1=int((~inf).sum()) - n_valid, infinity=int(inf.sum()))


def run_pk(torch, api, fp, keys: list[bytes], want: list[bool], card: str, tag: str = "pk"):
    """One counted admission call (launch counts reset just before, read
    just after), then WARM_REPS timed ones; the host halves timed apart,
    and K5's device time from a profiled call. Returns the launches."""
    torch.cuda.synchronize()
    fp.reset_launches()
    got = api.batch_validate_public_keys(keys)
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad or len(got) != len(want):
        raise AssertionError(f"pk S={len(keys)}: verdicts differ from the oracle at {bad[:8]}")
    if launches != {k: int(k == "g1_subgroup_check") for k in fp.KERNELS}:
        raise AssertionError(f"pk S={len(keys)}: expected one K5 launch and nothing else, got {launches}")
    times = []
    for _ in range(WARM_REPS):
        t0 = time.perf_counter()
        again = api.batch_validate_public_keys(keys)
        times.append((time.perf_counter() - t0) * 1e3)
        assert again == got
    ms = statistics.median(times)
    t0 = time.perf_counter()
    pts, _ = api.decompress_public_keys(keys)
    t1 = time.perf_counter()
    api.pack_g1_batch(pts)
    t2 = time.perf_counter()
    rows, _ = traced_device_events(lambda: api.batch_validate_public_keys(keys))
    k5_ms = sum(us for us, _, k in rows if "g1_subgroup_check_kernel" in k) / 1e3
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    phase(tag, S=len(keys), invalid=sum(not w for w in want), ms=f"{ms:.3f}",
          keys_per_s=f"{len(keys) / ms * 1e3:.1f}", host_decompress_ms=f"{(t1 - t0) * 1e3:.3f}",
          host_pack_ms=f"{(t2 - t1) * 1e3:.3f}", k5_device_ms=f"{k5_ms:.4f}", device_busy_ms=f"{busy_ms:.4f}",
          idle_share=f"{1 - busy_ms / ms:.4f}", launches=json.dumps(launches, separators=(",", ":")),
          card=f'"{card}"')
    return launches


def time_g1_kernel(torch, api, fp, curve, keys: list[bytes], launches, peak_ops_per_s):
    """K5 at the admission chunk's shape: device ms per launch (profiler),
    ms per call, the plain version's ms on the same card tensors, and the
    bound, counting only the rows that are not infinity (those return at
    once)."""
    from lighthouse_tpu_torch.crypto.bls.constants import X

    x, y, inf, _ = api.stage_public_keys(keys)
    xw, yw = fp.from_jax_limbs(x, DEVICE), fp.from_jax_limbs(y, DEVICE)
    infd = torch.from_numpy(inf).to(DEVICE)
    n = len(inf)
    run = lambda: curve.g1_in_subgroup_kernel(xw, yw, infd)  # noqa: E731
    plain = lambda: curve.g1_subgroup_check_plain(xw, yw, infd)  # noqa: E731
    saved = dict(fp.LAUNCHES)
    got, want = run(), plain()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    call_ms = cuda_ms(run, 5)
    ms = kernel_device_ms(run, 5, "g1_subgroup_check_kernel")
    plain_ms = cuda_ms(plain, 1)
    fp.LAUNCHES.update(saved)
    # [z^2] P as two chains over |z|: per chain bit_length - 1 doublings (6
    # products, 2 squares) and popcount - 1 additions (12); the products by
    # 3b are additions; phi and the comparison 5 products.
    absz = abs(X)
    dbls, adds = 2 * (absz.bit_length() - 1), 2 * (bin(absz).count("1") - 1)
    word_products = (dbls * 6 + adds * 12 + 5) * WORD_PRODUCTS_PER_MUL + dbls * 2 * WORD_PRODUCTS_PER_SQR
    live = int((~infd).sum())
    t_ops = live * word_products / peak_ops_per_s * 1e3
    t_bytes = (n * (2 * 48 + 1) + n + 48) / MEM_BYTES_PER_S * 1e3
    phase("timing", kernel="g1_subgroup_check", shape=n, live=live, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
          plain_ms=f"{plain_ms:.3f}", bound_ms=f"{max(t_ops, t_bytes):.6f}", max_abs_err=err)
    if err != 0:
        raise AssertionError(f"g1_subgroup_check differs from its plain version at S={n}")
    return {
        "name": "g1_subgroup_check", "route": "cuda", "source": G1_SOURCE, "replaces": REPLACES["g1_subgroup_check"],
        "launches": launches["g1_subgroup_check"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "shape": [n], "ms_per_call": call_ms,
    }


def check_extras(torch, fp, curve, tower, P) -> None:
    """to_affine (G1, G2), fp6_mul and fp6_inv on the card bit-identical to
    the same functions on CPU tensors, on 8 random elements each, zero Z and
    a zero Fp6 element among them (infinity, inv0)."""
    n = 8
    r = field_inputs(fp, P, 12 * n, 6, "cpu")[8:].reshape(n, 2, 3, 2, fp.WORDS)
    a6, b6 = r[:, 0], r[:, 1]
    a6[1] = 0  # inv0: zero maps to zero
    b6[0, 2] = 0  # Z = 0: infinity in both groups
    g1 = curve.Proj(*(b6[:, c, 0] for c in range(3)))
    g2 = curve.Proj(*(b6[:, c] for c in range(3)))
    cases = {
        "to_affine_g1": lambda d: curve.to_affine(curve.FP, curve.Proj(*(c.to(d) for c in g1))),
        "to_affine_g2": lambda d: curve.to_affine(curve.FP2, curve.Proj(*(c.to(d) for c in g2))),
        "fp6_mul": lambda d: (tower.fp6_mul(a6.to(d), b6.to(d)),),
        "fp6_inv": lambda d: (tower.fp6_inv(a6.to(d)),),
    }
    for name, fn in cases.items():
        card, cpu = fn(DEVICE), fn("cpu")
        if not all(torch.equal(c.cpu(), h) for c, h in zip(card, cpu)):
            raise AssertionError(f"{name}: the card differs from the CPU")
    inv = tower.fp6_inv(a6.to(DEVICE))
    ones = tower.fp6_mul(a6.to(DEVICE), inv).cpu() == tower.fp6_one((n,), "cpu")
    assert ones.flatten(1).all(dim=1).tolist() == [i != 1 for i in range(n)], "fp6_inv(a) a != 1"
    phase("extras", ok=True, compared=",".join(cases), elements=n)


def run_verify(torch, api, fp, sets, label: str, card: str, record_shapes: bool = False):
    """One counted verify (launch counts reset just before, read just after),
    then VERIFY_REPS timed ones, then VERIFY_REPS of its host staging alone
    (`stage_sets`, warm caches: the part of a verify's wall time before
    its first launch). Returns (verdict, launches, ms, shapes)."""
    torch.cuda.synchronize()
    fp.SHAPES = {} if record_shapes else None
    fp.reset_launches()
    ok = api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)
    shapes, fp.SHAPES = fp.SHAPES, None
    times = []
    for _ in range(VERIFY_REPS):
        t0 = time.perf_counter()
        again = api.verify_signature_sets(sets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert again == ok
    ms = statistics.median(times)
    stage = []
    for _ in range(VERIFY_REPS):
        t0 = time.perf_counter()
        api.stage_sets(sets)
        stage.append((time.perf_counter() - t0) * 1e3)
    phase(
        "verify", shape=label, result=ok, ms_per_batch=f"{ms:.3f}", host_stage_ms=f"{statistics.median(stage):.3f}",
        sets_per_s=f"{len(sets) / ms * 1e3:.2f}", launches=json.dumps(launches, separators=(",", ":")),
        card=f'"{card}"',
    )
    return ok, launches, ms, shapes


def run_mxu(torch, api, fp, default, bad, pk_keys: list[bytes], pk_want: list[bool], card: str):
    """The verify path with fp.USE_MXU_MUL set, restored afterwards
    whatever happens. For each valid batch of `default` (label -> (sets,
    launches) of the default run): one counted verify, which must launch
    K6 exactly as often as the default run launched K1 and K1 never; then
    the two settings timed in turns (default, flag, flag, default, twice),
    so that both medians come from the same stretch of the host's time.
    Then the `bad` batches fail, admission still launches K5 once and
    nothing else, and a profile of the last batch. Returns the last
    batch's launches."""
    saved = fp.USE_MXU_MUL
    try:
        for label, (sets, base) in default.items():
            fp.USE_MXU_MUL = True
            torch.cuda.synchronize()
            fp.reset_launches()
            ok = api.verify_signature_sets(sets)
            torch.cuda.synchronize()
            launches = dict(fp.LAUNCHES)
            assert ok, f"mxu {label}: a valid batch did not verify"
            missing = [k for k in MXU_KERNELS if launches[k] <= 0]
            assert not missing, f"mxu {label}: kernels not launched: {missing}"
            if launches["fp_mul"] != 0 or launches["fp_mul_mma"] != base["fp_mul"]:
                raise AssertionError(f"mxu {label}: K6 should take K1's {base['fp_mul']} launches, got {launches}")
            moved = {k: (base[k], launches[k]) for k in MXU_UNMOVED if launches[k] != base[k]}
            if moved:
                raise AssertionError(f"mxu {label}: K7-K11 launches (default, flag) differ: {moved}")
            times = {False: [], True: []}
            for flag in (False, True, True, False) * 2:
                fp.USE_MXU_MUL = flag
                t0 = time.perf_counter()
                again = api.verify_signature_sets(sets)
                torch.cuda.synchronize()
                times[flag].append((time.perf_counter() - t0) * 1e3)
                assert again is True
            ms, base_ms = statistics.median(times[True]), statistics.median(times[False])
            phase("mxu", shape=label, result=ok, ms_per_batch=f"{ms:.3f}", default_ms_per_batch=f"{base_ms:.3f}",
                  sets_per_s=f"{len(sets) / ms * 1e3:.2f}", launches=json.dumps(launches, separators=(",", ":")),
                  card=f'"{card}"')
        fp.USE_MXU_MUL = True
        for case, bad_sets in bad:
            verdict = api.verify_signature_sets(bad_sets)
            phase("mxu", case=case, result=verdict)
            assert verdict is False, f"mxu {case}: a bad batch verified"
        run_pk(torch, api, fp, pk_keys, pk_want, card, tag="mxu")
        profile_verify(torch, api, sets, f"{label}_mxu", ms)
    finally:
        fp.USE_MXU_MUL = saved
    return launches


def heaviest_shape(counter, name: str):
    """The launch shape that carries the most elements over the main path's
    launches (count x elements; for K4 the shape is (steps, lanes), for K7
    and K8 (elements, op or mode))."""
    def work(kv):
        shape, count = kv
        if name == "fp_batch_inv":
            elems = shape[0] * shape[1]
        else:
            elems = shape[0] if isinstance(shape, tuple) else shape
        return (count * elems, count)

    return max(counter.items(), key=work)[0]


def profile_verify(torch, api, sets, label: str, warm_ms: float) -> None:
    """Device busy time of one warm verify, from a torch.profiler trace of
    the device's activity only (a trace of every host-side operation of a
    verify is too large to summarise quickly), and the kernels that take
    the most device time. The idle share is taken against `warm_ms`, the
    median wall time of the same verify run without the profiler, which
    inflates the wall time of the verify it traces. The trace must hold
    each kernel of VERIFY_LAUNCHES as many times as the verify launches it."""
    api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    rows, profiled_wall_ms = traced_device_events(lambda: api.verify_signature_sets(sets))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    top = [{"kernel": k[:60], "ms": round(us / 1e3, 3), "calls": c} for us, c, k in rows[:8]]
    traced = {k: sum(c for _, c, key in rows if f"{k}_kernel" in key) for k in VERIFY_LAUNCHES}
    phase("profile", shape=label, warm_wall_ms=f"{warm_ms:.3f}", profiled_wall_ms=f"{profiled_wall_ms:.1f}",
          device_busy_ms=f"{busy_ms:.3f}", idle_share=f"{1 - busy_ms / warm_ms:.4f}",
          device_calls=sum(r[1] for r in rows), traced=json.dumps(traced, separators=(",", ":")),
          top=json.dumps(top, separators=(",", ":")))
    if traced != VERIFY_LAUNCHES:
        raise AssertionError(f"profile {label}: the trace holds {traced}, a verify launches {VERIFY_LAUNCHES}")


def time_kernels(torch, fp, tower, P, dev, shapes, launches, peak_ops_per_s):
    """Each kernel at the shape that carries most of its main-path work:
    its device time per launch (profiler), its time per call from the host
    (CUDA events, launch overhead included), the plain version's time, the
    bound, and the largest word difference from the plain version. K6 runs
    at K1's shape: the flag gives it the same launches. K7 and K8 run in
    the op or mode of that shape, and the K1/K2 composition they replaced
    is timed beside them (`composed_ms`, per call)."""
    results = []
    inv_word_products = inversion_word_products(P)
    for name in (*TIMED_KERNELS, "fp_mul_mma"):
        shape = heaviest_shape(shapes["fp_mul" if name == "fp_mul_mma" else name], name)
        composed = None
        if name == "fp_batch_inv":
            steps, lanes = shape
            x = field_inputs(fp, P, steps * lanes, 3, dev)[8 : 8 + steps * lanes].reshape(steps, lanes, fp.WORDS)
            run, plain = (lambda: fp.batch_inv(x)), (lambda: fp.batch_inv_plain(x))
            elems = steps * lanes
            ops_s = lanes * ((3 * steps - 1) * WORD_PRODUCTS_PER_MUL + inv_word_products) / peak_ops_per_s
            nbytes = 2 * 48 * elems
        elif name == "fp2_mul":
            n, op = shape
            a = fp2_inputs(fp, P, n + 4, 4, dev)[4:]
            b = None if op == tower.FP2_SQR else a.roll(1, dims=0)
            run = lambda: tower.fp2_product(a, b, op)  # noqa: E731
            if op == tower.FP2_SQR:
                plain, composed = (lambda: tower.fp2_sqr_plain(a)), (lambda: tower.fp2_sqr_plain(a, fp.KERNEL_OPS))
            else:
                plain, composed = (lambda: tower.fp2_mul_plain(a, b)), (lambda: tower.fp2_mul_plain(a, b, fp.KERNEL_OPS))
            ops_s, nbytes = n * K7_WORD_PRODUCTS[op] / peak_ops_per_s, n * K7_BYTES[op]
        elif name == "fp12_mul":
            n, mode = shape
            a = fp12_inputs(fp, tower, P, n + 3, 4, dev)[3:]
            bs = {
                tower.FP12_FULL: (a.roll(1, dims=0),),
                tower.FP12_SQUARE: (),
                tower.FP12_SPARSE: tuple(fp2_inputs(fp, P, 3 * n + 4, 5, dev)[4:].reshape(3, n, 2, fp.WORDS)),
            }[mode]
            run = lambda: tower.fp12_product(a, bs, mode)  # noqa: E731
            plain = lambda: tower.fp12_product_plain(a, bs, mode)  # noqa: E731
            composed = lambda: tower.fp12_product_plain(a, bs, mode, fp.KERNEL_OPS)  # noqa: E731
            ops_s, nbytes = n * K8_WORD_PRODUCTS[mode] / peak_ops_per_s, n * K8_BYTES[mode]
        else:
            n = shape
            a = field_inputs(fp, P, n, 4, dev)[8 : 8 + n]
            b = a.roll(1, dims=0)
            if name == "fp_mul":
                run, plain = (lambda: fp.mul(a, b)), (lambda: fp.mul_plain(a, b))
                ops_s, nbytes = n * WORD_PRODUCTS_PER_MUL / peak_ops_per_s, 3 * 48 * n
            elif name == "fp_mul_mma":
                run, plain = (lambda: fp.mul_mxu(a, b)), (lambda: fp.mul_mxu_plain(a, b))
                # the larger of the tensor-core time and the reduction's
                ops_s = max(n * MMA_OPS_PER_MUL / INT8_TENSOR_OPS_PER_S, n * REDC_WORD_PRODUCTS / peak_ops_per_s)
                nbytes = 3 * 48 * n
            elif name == "fp_addsub":
                run, plain = (lambda: fp.add(a, b)), (lambda: fp.addsub_plain(a, b, 0))
                ops_s, nbytes = n * 2 * fp.WORDS / peak_ops_per_s, 3 * 48 * n
            else:
                run, plain = (lambda: fp.inv(a)), (lambda: fp.pow_plain(a, fp.INV_EXP))
                ops_s, nbytes = n * inv_word_products / peak_ops_per_s, 2 * 48 * n + 48
        saved = dict(fp.LAUNCHES)  # comparison launches are not main-path launches
        got, want = run(), plain()
        err = int(((got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        if composed is not None and not torch.equal(got, composed()):
            raise AssertionError(f"{name}: kernel differs from the K1/K2 composition at shape {shape}")
        elementwise = name in ("fp_mul", "fp_addsub", "fp_mul_mma", "fp2_mul", "fp12_mul")
        reps = 50 if elementwise else 5
        call_ms = cuda_ms(run, reps)
        ms = kernel_device_ms(run, reps, f"{name}_kernel")
        plain_ms = cuda_ms(plain, 3 if elementwise else 1)
        extra = {} if composed is None else {"composed_ms": cuda_ms(composed, 10)}
        fp.LAUNCHES.update(saved)
        t_ops, t_bytes = ops_s * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        results.append({
            "name": name, "route": "cuda", "source": SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": list(shape) if isinstance(shape, tuple) else [shape],
            "ms_per_call": call_ms, **extra,
        })
        phase("timing", kernel=name, shape=shape, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.3f}", bound_ms=f"{max(t_ops, t_bytes):.6f}", max_abs_err=err,
              **{k: f"{v:.5f}" for k, v in extra.items()})
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version at shape {shape}")
    return results


def time_chain_kernels(torch, fp, P, cases, launches, peak_ops_per_s):
    """K9-K18 at the verify path's shapes (`chain_cases`): device ms per
    launch (profiler), ms per call (CUDA events), the plain version's and
    the composition's ms per call, and the bound. K11 runs at two shapes
    (the signatures' 64 bits; the cofactor clearing's 128, which K17 now
    runs): its JSON entry is the first, with the second beside it. K9's
    inversion is not timed inside K9: K3 runs alone on one element (the
    Fermat chain of p - 2 that K9's one thread also walks), and that time
    is set against K9's device time (`k3_same_chain_ms`,
    `k3_same_chain_over_k9`)."""
    S = N_SETS
    bounds = {  # case -> (kernel, word products, bytes: points in and out, bits read once)
        "g1_scalar_mul_n128_b64": ("g1_scalar_mul",
                                   S * scalar_mul_word_products(64, WORD_PRODUCTS_PER_MUL, WORD_PRODUCTS_PER_SQR),
                                   S * (288 + 64 * 4)),
        "g2_scalar_mul_n256_b64": ("g2_scalar_mul", 2 * S * scalar_mul_word_products(64, FP2_MUL_WP, FP2_SQR_WP),
                                   2 * S * (576 + 64 * 4)),
        "g2_scalar_mul_2x128_b128": ("g2_scalar_mul", 2 * S * scalar_mul_word_products(128, FP2_MUL_WP, FP2_SQR_WP),
                                     2 * S * 576 + 2 * 128 * 8),
        "cyclotomic_pow_x_n1": ("cyclotomic_pow_x", K9_WORD_PRODUCTS_BUT_POWER + inversion_word_products(P), K9_BYTES),
        f"miller_loop_n{S + 1}": ("miller_loop", (S + 1) * K12_WORD_PRODUCTS, (S + 1) * K12_BYTES + 6 * 48),
        f"sswu_m{2 * S}": ("sswu", 2 * S * h2c_word_products(P)[0], 2 * S * K13_BYTES + H2C_CONST_BYTES),
        f"iso3_map_m{2 * S + 1}": ("iso3_map", (2 * S + 1) * h2c_word_products(P)[1],
                                   (2 * S + 1) * K14_BYTES + H2C_CONST_BYTES),
        f"g1_tree_sum_{S}x{BLOCK_KEYS}": ("g1_tree_sum", S * (BLOCK_KEYS - 1) * G1_ADD_WP,
                                          S * (BLOCK_KEYS + 1) * 3 * 48),
        f"g2_tree_sum_{S}": ("g2_tree_sum", (S - 1) * G2_ADD_WP, (S + 1) * 3 * 96),
        f"clear_cofactor_m{S}": ("clear_cofactor", S * k17_word_products(), S * K17_BYTES + K17_CONST_BYTES),
        f"product_reduce_n{S + 1}": ("product_reduce", S * FP12_MUL_WP, (S + 2) * 576),
    }
    rows = {}
    for case, (name, ops, nbytes) in bounds.items():
        shape, run, plain, composed = cases[case]
        saved = dict(fp.LAUNCHES)  # comparison launches are not main-path launches
        err = max_word_err(run(), plain())
        call_ms = cuda_ms(run, 5)
        ms = kernel_device_ms(run, 5, f"{name}_kernel")
        plain_ms, composed_ms = cuda_ms(plain, 1), cuda_ms(composed, 2)
        extra = {}
        if name == "cyclotomic_pow_x":
            one = field_inputs(fp, P, 1, 9, DEVICE)[8:9]
            k3_ms = kernel_device_ms(lambda: fp.inv(one), 5, "fp_pow_kernel")
            extra = {"k3_same_chain_ms": k3_ms, "k3_same_chain_over_k9": k3_ms / ms}
        fp.LAUNCHES.update(saved)
        t_ops, t_bytes = ops / peak_ops_per_s * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": shape, "ms_per_call": call_ms, "composed_ms": composed_ms, **extra,
        }
        phase("timing", kernel=name, shape=shape, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.3f}", composed_ms=f"{composed_ms:.3f}", bound_ms=f"{row['bound_ms']:.6f}",
              word_products=ops, launches=launches[name], max_abs_err=err,
              **{k: f"{v:.5f}" for k, v in extra.items()})
        if err != 0:
            raise AssertionError(f"{case}: kernel differs from its plain version")
        if name in rows:
            rows[name]["at_cofactor_shape"] = {k: row[k] for k in ("shape", "ms", "ms_per_call", "plain_ms",
                                                                  "composed_ms", "bound_ms", "bound_by")}
        else:
            rows[name] = row
    return list(rows.values())


def check_parity(torch, api, fp, pairing) -> None:
    """S=4, K=2: card and CPU give bit-identical partials and GT values."""
    keys = [api.interop_keypair(i) for i in range(8)]
    sets = []
    for s in range(4):
        (sk0, pk0), (sk1, pk1) = keys[2 * s], keys[2 * s + 1]
        msg = bytes([0x30 + s]) * 32
        sig = api.aggregate_signatures([sk0.sign(msg), sk1.sign(msg)])
        sets.append(api.SignatureSet(signature=sig, signing_keys=[pk0, pk1], message=msg))
    staged = api.stage_sets(sets, rng=random.Random(5).getrandbits)
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        partial, ok = api.verify_pipeline_local(*api.from_jax_staged(staged, dev))
        gt = pairing.final_exponentiation(partial)
        out[dev] = (partial.cpu(), bool(ok), gt.cpu())
        phase("parity-run", device=dev, seconds=f"{time.perf_counter() - t0:.2f}")
    (pc, okc, gc), (pp, okp, gp) = out[DEVICE], out["cpu"]
    assert okc and okp, "parity batch failed its subgroup checks"
    assert torch.equal(pc, pp), "Miller partial differs between card and CPU"
    assert torch.equal(gc, gp), "GT value differs between card and CPU"
    one = torch.equal(gc, pairing.fp12_one((), "cpu"))
    assert one, "parity batch does not verify"
    phase("parity", ok=True, shape="S4xK2", partial_identical=True, gt_identical=True)


def sharded_batches(api):
    """(valid 128 x 1, tampered 128 x 1, tampered S = 8) batches."""
    valid = make_sets(api, N_SETS, 1)
    s = valid[N_SETS // 2]
    tampered = list(valid)
    tampered[N_SETS // 2] = api.SignatureSet(s.signature, s.signing_keys, b"\xee" * 32)
    small = valid[:SHARDED_S8]
    small[3] = api.SignatureSet(small[3].signature, small[3].signing_keys, b"\xee" * 32)
    return valid, tampered, small


def _sharded_rank(rank: int, world: int, backend: str, addr: str, devices: list, results) -> None:
    """One rank of a sharded world: the verdicts of the valid and tampered
    128 x 1 batches, the launches of one sharded verify, the median warm
    ms of the valid one, and the GT value of the tampered S = 8 batch."""
    import torch
    import torch.distributed as dist

    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, fp
    from lighthouse_tpu_torch.parallel import sharded

    # one host: bootstrap the collectives over loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = sharded.rank_device(devices[rank])
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=SHARDED_JOIN_SECONDS))
    try:
        valid, tampered, small = sharded_batches(api)
        verify = lambda sets: sharded.sharded_verify_signature_sets(sets, device=dev)  # noqa: E731
        verify(valid)  # warm: staging caches and kernel library
        torch.cuda.synchronize(dev)
        fp.reset_launches()
        ok = verify(valid)
        torch.cuda.synchronize(dev)
        launches = dict(fp.LAUNCHES)
        times = []
        for _ in range(WARM_REPS):
            dist.barrier()
            t0 = time.perf_counter()
            assert verify(valid) == ok
            times.append((time.perf_counter() - t0) * 1e3)
        bad = verify(tampered)
        gt, ok8, _ = sharded.sharded_verify_parts(small, rng=random.Random(SHARDED_SEED).getrandbits, device=dev)
        results.put((rank, ok, bad, launches, statistics.median(times), gt.cpu().numpy(), ok8))
    finally:
        dist.destroy_process_group()


def run_world(backend: str, world: int, devices: list) -> list:
    """Spawn a world of ranks, wait for every result under a time limit,
    and join; a rank that fails makes the join raise."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    procs = tmp.start_processes(_sharded_rank, args=(world, backend, addr, devices, results), nprocs=world,
                                join=False, start_method="spawn")
    got, deadline = {}, time.monotonic() + SHARDED_JOIN_SECONDS
    try:
        while not procs.join(timeout=1):
            while True:
                try:
                    item = results.get_nowait()
                except queue.Empty:
                    break
                got[item[0]] = item
            if time.monotonic() > deadline:
                raise TimeoutError(f"{backend} world of {world}: ranks did not finish in {SHARDED_JOIN_SECONDS} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    while len(got) < world:
        item = results.get(timeout=30)
        got[item[0]] = item
    return [got[r] for r in range(world)]


def run_sharded(torch, api, fp, pairing, card: str) -> None:
    """The sharded verify path in two worlds; see the module docstring."""
    valid, _, small = sharded_batches(api)
    staged = api.stage_sets(small, rng=random.Random(SHARDED_SEED).getrandbits)
    partial, ok = api.verify_pipeline_local(*api.from_jax_staged(staged, DEVICE))
    want = pairing.final_exponentiation(partial).cpu().numpy()
    assert bool(ok), "the S = 8 batch failed its subgroup checks"
    S, K = api.stage_sets(valid, rng=api._ONE_RNG)[2].shape
    flat_bytes = 4 * sum(int(torch.Size(shape).numel()) for shape, _ in api._staged_specs(S, K))
    nccl_world = min(SHARDED_MAX_RANKS, torch.cuda.device_count())
    worlds = (("nccl", nccl_world, [f"cuda:{r}" for r in range(nccl_world)]), ("gloo", 2, ["cuda:0", "cuda:0"]))
    for backend, world, devices in worlds:
        t0 = time.perf_counter()
        out = run_world(backend, world, devices)
        for rank, ok_r, bad_r, launches, _, gt, ok8 in out:
            assert ok_r is True, f"{backend} rank {rank}: the valid batch did not verify"
            assert bad_r is False, f"{backend} rank {rank}: the tampered batch verified"
            assert ok8 and (gt == want).all(), f"{backend} rank {rank}: GT differs from the one-process value"
            missing = [k for k in VERIFY_KERNELS if launches[k] <= 0]
            assert not missing, f"{backend} rank {rank}: kernels not launched by the sharded path: {missing}"
            counts = {k: launches[k] for k in SHARDED_LAUNCHES}
            assert counts == SHARDED_LAUNCHES, f"{backend} rank {rank}: a sharded verify launched {counts}"
        phase("sharded", backend=backend, W=world, nccl_world=nccl_world, shape=f"{N_SETS}x1", bucket=f"{S}x{K}",
              result=True,
              tampered=False, gt_identical=True, ms_per_batch=f"{out[0][4]:.3f}",
              broadcast_bytes=16 + flat_bytes, gathered_bytes_per_rank=world * (fp.WORDS * 4 * 12 + 4),
              launches_rank0=json.dumps(out[0][3], separators=(",", ":")),
              world_seconds=f"{time.perf_counter() - t0:.1f}", card=f'"{card}"')


def run_coalescer(torch, api, fp, card: str) -> None:
    """The port's coalescer on the card; see the module docstring."""
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.crypto.bls import batch_verifier as bv
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref

    n = COALESCER_THREADS * COALESCER_PER_THREAD
    sets = make_sets(api, n, 1)
    bad = 13
    sets[bad] = api.SignatureSet(sets[bad].signature, sets[bad].signing_keys, b"\xee" * 32)
    oracle = {}
    want = [oracle.setdefault(id(s), ref.verify_signature_sets([s])) for s in sets]
    assert want == [i != bad for i in range(n)], "oracle verdicts are wrong"
    sizes = []
    dispatch = api.verify_signature_sets_async

    def recorded(batch, rng=None):
        sizes.append(len(batch))
        return dispatch(batch, rng=rng)

    errors0 = metrics.BLS_COALESCER_INTERNAL_ERRORS_TOTAL.value
    bisect0 = metrics.BLS_BISECTION_DISPATCHES_TOTAL.value
    svc = bv.ensure_running(api, s_bucket=COALESCER_BUCKET)
    got = [None] * n
    barrier = threading.Barrier(COALESCER_THREADS)

    def caller(t):
        mine = range(t * COALESCER_PER_THREAD, (t + 1) * COALESCER_PER_THREAD)
        barrier.wait()
        futures = {i: svc.submit([sets[i]]) for i in mine[:-1]}
        got[mine[-1]] = api.verify_signature_set(sets[mine[-1]])  # routed through the service
        for i, f in futures.items():
            got[i] = f.result(timeout=SHARDED_JOIN_SECONDS)[0]

    try:
        api.verify_signature_sets_async = recorded
        info = api.device_fingerprint()
        torch.cuda.synchronize()
        fp.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=caller, args=(t,)) for t in range(COALESCER_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(SHARDED_JOIN_SECONDS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fp.LAUNCHES)
        assert not any(th.is_alive() for th in threads), "a coalescer caller did not finish"
        dispatches = svc.dispatches
    finally:
        api.verify_signature_sets_async = dispatch
        bv.release(svc)
    errors = metrics.BLS_COALESCER_INTERNAL_ERRORS_TOTAL.value - errors0
    assert got == want, f"coalescer verdicts differ from the oracle's at {[i for i in range(n) if got[i] != want[i]]}"
    assert errors == 0, f"{errors} coalescer internal errors"
    assert info["platform"] == "cuda" and info["device_kind"] == torch.cuda.get_device_name(0), info
    assert info["coalescer"]["running"] and info["coalescer"]["s_bucket"] == COALESCER_BUCKET, info
    missing = [k for k in VERIFY_KERNELS if launches[k] <= 0]
    assert not missing, f"kernels not launched by the coalesced path: {missing}"
    counts = {k: launches[k] for k in VERIFY_LAUNCHES}
    want_counts = {k: v * len(sizes) for k, v in VERIFY_LAUNCHES.items()}
    assert counts == want_counts, f"{len(sizes)} coalesced dispatches launched {counts}, expected {want_counts}"
    phase("coalescer", sets=n, blamed=got.count(False), dispatches=dispatches,
          bisection_dispatches=int(metrics.BLS_BISECTION_DISPATCHES_TOTAL.value - bisect0),
          batch_sizes=json.dumps(sizes, separators=(",", ":")), wall_ms=f"{wall_ms:.3f}", internal_errors=int(errors),
          fingerprint=f'"{info["platform"]}/{info["device_kind"]}/{info["chip_count"]}"',
          launches=json.dumps(launches, separators=(",", ":")), card=f'"{card}"')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, h2c, kernels, pairing, tower

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    name_power = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak_ops = props.multi_processor_count * IMAD_PER_SM_PER_CLK * max_sm_mhz * 1e6
    phase("device", name=torch.cuda.get_device_name(0).replace(" ", "_"), smi=f'"{name_power}"',
          sms=props.multi_processor_count, max_sm_mhz=max_sm_mhz, torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    kernels.library()
    log = kernels.BUILD_LOG or ""
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}", nvcc_seconds=kernels.BUILD_SECONDS,
          spill_stores=json.dumps(ptxas_spills(log), separators=(",", ":")),
          g1_subgroup_check=f'"{ptxas_summary(log, "g1_subgroup_check")}"',
          fp_mul_mma=f'"{ptxas_summary(log, "fp_mul_mma_kernel")}"',
          fp2_mul=f'"{ptxas_summary(log, "fp2_mul_kernel")}"',
          fp12_mul=f'"{ptxas_summary(log, "fp12_mul_kernel")}"',
          cyclotomic_pow_x=f'"{ptxas_summary(log, "cyclotomic_pow_x_kernel")}"',
          g1_scalar_mul=f'"{ptxas_summary(log, "g1_scalar_mul_kernel")}"',
          g2_scalar_mul=f'"{ptxas_summary(log, "g2_scalar_mul_kernel")}"',
          miller_loop=f'"{ptxas_summary(log, "miller_loop_kernel")}"',
          sswu=f'"{ptxas_summary(log, "sswu_kernel")}"',
          iso3_map=f'"{ptxas_summary(log, "iso3_map_kernel")}"',
          g1_tree_sum=f'"{ptxas_summary(log, "g1_tree_sum_kernel")}"',
          g2_tree_sum=f'"{ptxas_summary(log, "g2_tree_sum_kernel")}"',
          clear_cofactor=f'"{ptxas_summary(log, "clear_cofactor_kernel")}"',
          product_reduce=f'"{ptxas_summary(log, "product_reduce_kernel")}"')

    check_kernels(torch, fp, P, dev)
    check_tower_kernels(torch, fp, tower, P, dev)
    chains = chain_cases(torch, fp, curve, tower, pairing, h2c, P)
    check_chain_kernels(torch, chains)
    edges = fold_cases(torch, fp, curve, tower, pairing, h2c, P, [(2, n) for n in FOLD_LENGTHS], FOLD_LENGTHS,
                       COFACTOR_EDGE, REDUCE_COUNTS, 29, nosum=True)
    check_chain_kernels(torch, edges)

    t0 = time.perf_counter()
    gossip = make_sets(api, N_SETS, 1)
    block = make_sets(api, N_SETS, BLOCK_KEYS)
    bad_sig = non_subgroup_signature(api)
    valid = [pk.to_bytes() for pk in block[0].signing_keys]
    valid += [api.interop_keypair(i)[1].to_bytes() for i in range(len(valid), PK_DISTINCT)]
    invalid = list(invalid_encodings().values())
    oracle = {kb: oracle_pk_verdict(kb) for kb in valid + invalid}
    assert all(oracle[kb] for kb in valid) and not any(oracle[kb] for kb in invalid)
    phase("setup", host_seconds=f"{time.perf_counter() - t0:.2f}", pk_distinct=len(valid), pk_invalid=len(invalid))

    check_g1_kernel(torch, api, fp, curve, valid, invalid)

    gossip_shape, block_shape = f"{N_SETS}x1", f"{N_SETS}x{BLOCK_KEYS}"
    ok_g, launches_g, gossip_ms, _ = run_verify(torch, api, fp, gossip, gossip_shape, name_power)
    ok_b, launches_b, block_ms, shapes = run_verify(torch, api, fp, block, block_shape, name_power, record_shapes=True)
    assert ok_g and ok_b, "a valid batch did not verify"
    for launches in (launches_g, launches_b):
        missing = [k for k in VERIFY_KERNELS if launches[k] <= 0]
        assert not missing, f"kernels not launched by the verify path: {missing}"
        assert launches["fp_mul_mma"] == 0, "K6 launched on the default verify path"
        counts = {k: launches[k] for k in VERIFY_LAUNCHES}
        assert counts == VERIFY_LAUNCHES, f"a verify launched {counts}, expected {VERIFY_LAUNCHES}"

    i = len(gossip) // 2  # the set each bad batch spoils
    s = gossip[i]
    tampered, wrong_key, non_sub = list(gossip), list(gossip), list(gossip)
    tampered[i] = api.SignatureSet(s.signature, s.signing_keys, b"\xee" * 32)
    wrong_key[i] = api.SignatureSet(s.signature, [api.interop_keypair(99)[1]], s.message)
    non_sub[i] = api.SignatureSet(bad_sig, s.signing_keys, s.message)
    bad = (("tampered_message", tampered), ("wrong_key", wrong_key), ("non_subgroup_sig", non_sub))
    for label, sets in bad:
        verdict = api.verify_signature_sets(sets)
        phase("reject", case=label, shape=gossip_shape, result=verdict)
        assert verdict is False, f"{label}: a bad batch verified"

    pk_keys, pk_launches = {}, {}
    for size in PK_SIZES:
        pk_keys[size] = admission_keys(valid, invalid, size)
        pk_launches[size] = run_pk(torch, api, fp, pk_keys[size], [oracle[kb] for kb in pk_keys[size]], name_power)

    default = {gossip_shape: (gossip, launches_g), block_shape: (block, launches_b)}
    small = PK_SIZES[-1]
    mxu_launches = run_mxu(torch, api, fp, default, bad, pk_keys[small], [oracle[kb] for kb in pk_keys[small]],
                           name_power)

    profile_verify(torch, api, gossip, gossip_shape, gossip_ms)
    profile_verify(torch, api, block, block_shape, block_ms)
    results = time_kernels(torch, fp, tower, P, dev, shapes,
                           {**launches_b, "fp_mul_mma": mxu_launches["fp_mul_mma"]}, peak_ops)
    results += time_chain_kernels(torch, fp, P, chains, launches_b, peak_ops)
    results.append(time_g1_kernel(torch, api, fp, curve, pk_keys[PK_SIZES[0]], pk_launches[PK_SIZES[0]], peak_ops))
    check_extras(torch, fp, curve, tower, P)
    check_parity(torch, api, fp, pairing)
    run_sharded(torch, api, fp, pairing, name_power)
    run_coalescer(torch, api, fp, name_power)

    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}", empty_traces_retaken=EMPTY_TRACES)
    print(json.dumps({"kernels": results}))
    print(name_power)
    # the run drives cuda:0 only, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
