#!/usr/bin/env python3
"""Smoke run of lighthouse_tpu_torch on one CUDA GPU (written for an H100).

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

  1. device   require a CUDA device; print its name and power limit
  2. build    compile the hand-written kernels (csrc/) with nvcc, one
              process per source; K5's to K33's registers and spills
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
              (G1, 128 points at 64 bits; then 1, 2, 3, 127, 128 and 129
              points) and K11 (G2, 256 points at 64
              bits and clear_cofactor's 2 x 128 at 128 broadcast bits;
              then 1, 2, 3, 255, 256 and 257 points, odd counts leaving a
              lane group off), with infinity rows, P + (-P), a P, -P pair
              and all-zero and all-one scalars, and K12 (the Miller loop,
              129 pairs, then 1, 2, 129 and 130, with P, Q and both at
              infinity: the generator-substitution lanes),
              K13 (SSWU, 256 u's with 0, one, u and -1 among them; then
              1, 7, 8, 9, 255, 256 and 257 u's) and K14
              (the isogeny, SSWU's 256 points and the kernel point X0;
              then SSWU's points at K13's counts with X0 and all p - 1
              coordinates among them, and each alone),
              bit-identical to their plain versions and to the K1-K4/K7/K8
              composition they replaced. The tree sums K15 (G1, 2 columns)
              and K16 (G2, one column) at column lengths 1, 2, 3, 5, 128,
              512 and 1,025 with P == Q, P == -Q and infinity rows, K17 (sum and
              cofactor clearing, 19 elements with u = 0's point, q1 = q0,
              q1 = -q0 and q1 at infinity, and without the sum) and K18
              (Fp12 product, n = 1, 2, 3, 4, 17, 129, 1,025 and 2,049
              values with no zero among them, and three with a zero), and
              all four at the verify
              path's shapes, bit-identical to their plain versions and to
              the composition they replaced. The final exponentiation K19
              (n = 1 as on the verify path, n = 3 with p - 1 in every word
              slot, zero and one, and zero alone), the psi comparison K20
              (S = 128 and 19: G2 points, points of E2 outside G2,
              infinity, and a multiple of another point; then 19 with sig,
              zsig and both at infinity and all p - 1 coordinates) and the
              Miller
              inputs K21 (S = 1, 33 and 128, infinity lanes in G1 and
              G2), likewise. The
              standalone kernels off the verify path, K22 and K23
              (to_affine, G1 and G2: Z = 0, Z = one, p - 1 in every word
              slot), K24 (fp6_mul, with a broadcast operand and an all
              p - 1 element) and K25 (fp2_inv, zero: inv0), at counts
              that are and are not whole blocks, likewise. The
              standalone launches of routines that run inside the verify
              path's kernels, K26 and K27 (curve.add, G1 and G2: Z = 0,
              Z = one, p - 1 words, P == Q, P == -Q, a broadcast point),
              K28 and K29 (Karabina's squaring and decompression: the
              compressed identity, p - 1 words, decompression's g2 = 0
              branch and a zero denominator), K30 and K31 (fp12_inv,
              frobenius: p - 1, zero, one), K32 (the Fp2 square-root
              candidate: 0, one, u, -1; K13's counts and 17) and K33
              (mont_reduce: T = 0,
              2 p 2^384 - 1, p^2 - 1, p 2^384), likewise (K33 against its
              plain version only: it replaced no composition). After
              set-up, K5 bit-identical to its plain version (on CPU
              tensors) on 64 points: interop keys, the order-3 point
              (0, 2), points of E(Fp) outside G1 and infinity rows; and
              on 1, 5, 6, 7, 8, 9 and 31 of them (partial warps: eight
              keys a warp, a quad of lanes each)
  4. verify   the verify path, `verify_signature_sets`, on 128 sets x 1
              key and on the mainnet-block shape 128 sets x 128 keys: both
              True, with the kernels' launch counts of one verify (K10-K21
              once each, K1-K9 never, at either shape); then a
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
              fp.USE_MXU_MUL set (every direct Fp product on K6, the JAX
              package's LIGHTHOUSE_TPU_MXU_FP_MUL path): verdicts, K6
              launched as often as K1 was by default and K1 never, every
              other kernel as often as by default (K7 to K21 keep their
              CUDA-core products, as the JAX package's flag reaches only
              direct Fp products; a verify has none left, so K6's count is
              K1's 0); ms per batch with and without the flag, timed in
              turns; admission at S = 16 still one K5 launch and nothing
              else
  5. profile  device busy time, idle share and top kernels of one verify,
              at both shapes by default and at 128 x 128 with the flag; the
              trace holds every kernel as often as a verify launches it
              (K10-K21 once, the rest, K22-K33 included, never)
     timing   each kernel against its plain version and its bound: K1-K4,
              K6, K7 and K8, which a verify no longer launches, at the
              shapes that carried most of their main-path work before
              (`OFF_PATH_SHAPES`; K4 also at 257 x 8; K6 at K1's, so the
              two compare; K7 and K8 also against the K1/K2 composition
              they replaced); K5 at both admission shapes;
              K9-K21 at the verify path's shapes against their plain
              versions, the composition they replaced and their bounds;
              K22-K25 at `AFFINE_SHAPES`
              (off the path: G1 128, G2 256, Fp6 128, Fp2 256) and
              K26-K33 at `STANDALONE_SHAPES` likewise, with the launches
              of one verify as `verify` counted them (0)
     tree_levels K16 (one column) and K15 (128 columns) at column
              lengths 2, 4, ..., 128: device ms a level deeper each
     reduce_levels K18 at 1, 2, 4, 8, 9, 16, 17, 32, 64, 128 and 129
              values: device ms of a copy, of the cluster hand-off with
              one to three fold levels, and a level deeper each
     registry every entry of the port's kernel registry
              (torch_backend/registry.py: the JAX registry's 38 names,
              SSWU, the three launch entry points) called once on the card
              at its example shape, the counts set to 0 just before the
              walk: every entry a "kernel" entry (a hand-written kernel
              of its own) or a "path" entry, with declared launches; each
              entry's launches as declared, a "kernel" entry's output
              bit-identical to its plain version on CPU tensors (the big
              composites of `HELD_IN_KERNELS` are held in `kernels` and
              not run again), and every kernel, K1-K33, launched in the
              walk
     extras   fp6_inv (over K7 and K25; no registry entry) on the card
              bit-identical to the same function on CPU tensors
  6. parity   one S=4, K=2 batch: the card's Miller partial and GT value
              bit-identical to the same functions on the CPU
  7. sharded  `parallel.sharded.sharded_verify_signature_sets` in spawned
              ranks (kernels built by this process first, join under a
              time limit): NCCL over W = min(4, cards) ranks, one card
              each, and gloo over 2 ranks sharing cuda:0. Each world: a
              128 x 1 batch True and a tampered one False on every rank,
              with the kernels' launch counts of one verify on every rank
              (K18 twice: the rank's Miller values and the partials; K19
              once, on the partials' product); a
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
     chain    block import through the port's consensus host (chain/,
              state_transition/, fork_choice/, store/) on the torch
              backend: minimal preset, phase0, 64 interop validators.
              Chain A, `BeaconChainHarness(64, TransitionContext.minimal())
              .extend_chain(40)`: 40 blocks, each imported by
              `BeaconChain.process_block` with one verify on the card
              (K10-K21 once a block, K1-K9 never), finalized epoch >= 2.
              Chain B, a fresh chain on the same genesis: chain A's first
              32 blocks as one `process_chain_segment` (one verify of 126
              sets, staged 128 x 4) to chain A's block 32. Refused, the
              head unchanged: the other 8 as a segment whose last block
              carries an aggregate with another aggregate's signature,
              and a block whose proposal another validator signed; then
              the genuine 8 reach chain A's head.
              `lighthouse_tpu_bls_signature_sets_total` grown by exactly
              the sets verified. Host seconds of set-up, signing and
              import; ms per import, per verify and per segment
     conformance  the port generator's 39 eth2 BLS cases (sign, verify,
              aggregate, aggregate_verify, fast_aggregate_verify,
              eth_aggregate_pubkeys, eth_fast_aggregate_verify; infinity,
              non-subgroup and malformed encodings among them) through
              `conformance.run_case(case, api)` on the card: each with its
              expected outcome, each verify launching K10-K21 once and
              nothing else, the cases decided on the host launching
              nothing; per case type the cases, the verifies and their
              launches, and K5's launches (public keys decompress on the
              host, so none); generation (host `ref` signing) timed apart
     gossip   the gossip path over chain A through the port's network
              layer: node A's `network.NetworkService` on a `LocalNetwork`
              (its node a stand-in of chain, context, op pool and a
              BeaconProcessor over the coalescer), a peer publishing one
              epoch at its last slot: every validator's one-bit
              attestation and one SignedAggregateAndProof a committee,
              signed in host processes, with a tampered signature, an
              unknown head block, a future slot and an aggregate with
              another validator's selection proof; at a second tick of the
              same slot the victim's genuine attestation, an exact
              duplicate of an accepted one and an attestation on the
              aggregate topic. Admission is `on_gossip` (a
              flight-recorder id a message), the drain `process_pending`
              at each slot tick (the clock, fork choice's tick, the
              drain), routed by the service into the op pool and its
              reprocess queue. Every verdict the expected one; the
              tampered set blamed alone in its batch; every set's verdict
              the ref oracle's on that set alone (all sets, host
              processes); the wrong container dropped once; the early
              attestation released by the next tick and accepted;
              launches K10-K21 once a dispatch (first level and
              bisection); `lighthouse_tpu_bls_signature_sets_total` grown
              by the sets; queue depth 0 after every tick; fork choice
              holding every validator's vote. Then the next block, packed
              by the op pool with the gossip attestations, imported with
              one verify and fork choice weighing the votes. Dispatches,
              batch sizes, bisection, tick and aggregate-handler ms,
              per-set latency from admission to verdict (recorder clock),
              queue-depth peak, import and verify ms
     sync     range sync and block gossip over real localhost sockets
              (`network.SocketNetwork`): node A (chain A at its head after
              `[gossip]`) and a follower F, a fresh chain on chain A's
              genesis and context. F's status exchange over TCP starts
              `RangeSync`, which downloads batches of two epochs with
              BlocksByRange (ssz_snappy) and imports each with one
              `process_chain_segment`, one verify a batch (K10-K21 once):
              F reaches A's head in ceil(head slot / 16) batches, none
              falling back to single-block imports, the sets verified
              those the blocks carry. Per batch its blocks, S x K, the
              download ms (of it the Req/Resp call: connect, frames,
              snappy), the wire bytes, the import's host ms and the verify
              ms. Then A's next block (two host signatures) published over
              `GossipNode` on the spec topic with the fork digest reaches
              F's processor within `SYNC_GOSSIP_WAIT_S` and imports at F's
              tick with one verify; its second copy is dropped by F's seen
              cache and launches nothing; the gossip internal-error count
              stays 0. Which ENR signing backend (`cryptography` or pure)
              the machine has
     vc       the validator client over the Beacon API, over chain A at
              its head after `[sync]`: the 64 interop keys encrypted as
              EIP-2335 keystores (pbkdf2, c = 262,144) in host processes,
              saved in a directory held by its lockfile (a second holder,
              in another process and in this one, refused), loaded and
              decrypted in host processes, each public key its
              validator's. Node A's `BeaconNodeApi` served by
              `HttpApiServer` on localhost; a `ValidatorStore` on an
              EIP-3076 `SlashingDatabase` file with 63 local keys and one
              held by the Web3Signer mock (a validator with a duty in the
              first slot); `BeaconNodeHttpClient` and `ValidatorClient`.
              For each of two slots: the clock and fork choice's tick,
              then `on_slot`: the block, every attestation and the first
              aggregate of each committee verified on the card in the
              server's handler threads (K10-K21 once a verify, nothing
              else, K5 0) and accepted; the committees' other aggregates
              dropped as already known before any verify; the head at the
              slot; the second block carrying the first slot's
              attesters. Per slot the signatures and their host seconds,
              the HTTP requests and their ms, each verify's sets and ms,
              the block import's ms. The remote key's signatures byte for
              byte the local key's; a tampered attestation POSTed over
              HTTP refused after one verify, False as the ref oracle's;
              the second slot again from a client restarted on the same
              store against a node anchored at chain A's earlier head:
              the proposal and every attestation refused by the
              database, no slashable signature, no verify, no launch; the
              interchange export listing exactly the blocks and
              attestations published; the client's `/metrics` and
              `/health` showing the duties run. The phase under
              `VC_MAX_S`

then a `{"kernels": [...]}` JSON line, the nvidia-smi name/power line, and
as the last line `{"ok": true, "device": {...}}`. Signature sets are built
with the port's own ref oracle from fixed interop keys.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import queue
import random
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import types

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
# the counts K5 is held to its plain version at: partial warps (eight keys a
# warp, a quad of lanes each), a whole one and K5_POINTS
K5_COUNTS = (1, 5, 6, 7, 8, 9, 31, K5_POINTS)
# K4's second timed shape: several columns, a warp each
BATCH_INV_COLUMNS_SHAPE = (BATCH_INV_STEPS, 8)

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
FINAL_EXPONENTIATION_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/final_exponentiation_kernels.cu"
VERIFY_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/verify_kernels.cu"
AFFINE_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/affine_kernels.cu"
STANDALONE_SOURCE = "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/standalone_kernels.cu"
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
    "final_exponentiation": "lighthouse_tpu/crypto/bls/jax_backend/pairing.py:263",
    "g2_psi_check": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:389",
    "miller_inputs": "lighthouse_tpu/crypto/bls/jax_backend/api.py:307",
    "g1_to_affine": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:120",
    "g2_to_affine": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:120",
    "fp6_mul": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:155",
    "fp2_inv": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:100",
    "g1_add": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:138",
    "g2_add": "lighthouse_tpu/crypto/bls/jax_backend/curve.py:138",
    "karabina_sqr": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:401",
    "karabina_decompress": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:481",
    "fp12_inv": "lighthouse_tpu/crypto/bls/jax_backend/tower.py:546",
    "frobenius": "lighthouse_tpu/crypto/bls/jax_backend/pairing.py:210",
    "fp2_sqrt_candidate": "lighthouse_tpu/crypto/bls/jax_backend/h2c.py:102",
    "fp_redc": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:261",
}
SOURCES = {"fp_mul_mma": MMA_SOURCE, "fp2_mul": TOWER_SOURCE, "fp12_mul": TOWER_SOURCE,
           "cyclotomic_pow_x": FINAL_EXP_SOURCE, "g1_scalar_mul": CURVE_SOURCE, "g2_scalar_mul": CURVE_SOURCE,
           "miller_loop": PAIRING_SOURCE, "sswu": H2C_SOURCE, "iso3_map": H2C_SOURCE, "g1_tree_sum": FOLD_SOURCE,
           "g2_tree_sum": FOLD_SOURCE, "clear_cofactor": COFACTOR_SOURCE, "product_reduce": FOLD_SOURCE,
           "final_exponentiation": FINAL_EXPONENTIATION_SOURCE, "g2_psi_check": VERIFY_SOURCE,
           "miller_inputs": VERIFY_SOURCE, "g1_to_affine": AFFINE_SOURCE, "g2_to_affine": AFFINE_SOURCE,
           "fp6_mul": AFFINE_SOURCE, "fp2_inv": AFFINE_SOURCE, "g1_add": STANDALONE_SOURCE,
           "g2_add": STANDALONE_SOURCE, "karabina_sqr": STANDALONE_SOURCE, "karabina_decompress": STANDALONE_SOURCE,
           "fp12_inv": FINAL_EXPONENTIATION_SOURCE, "frobenius": FINAL_EXPONENTIATION_SOURCE,
           "fp2_sqrt_candidate": H2C_SOURCE, "fp_redc": STANDALONE_SOURCE}
# launches of one verify, whatever its shape, for every kernel: hash-to-G2's
# SSWU (K13), isogeny (K14) and sum with the cofactor clearing (K17); the sums
# of each set's keys (K15) and of the r_i sig_i (K16); r_i aggpk_i (K10); the
# signatures' 2-stacked multiplication (K11) and the psi comparison (K20);
# the Miller pairs' affine inputs (K21), the Miller loop (K12), the product
# of the Miller values (K18) and the final exponentiation (K19). The field
# and tower kernels K1-K4, K7 and K8 and the |z|-power chain K9 run only
# inside those; K5 is admission's, K6 the flag's; K22-K33 are standalone
# functions off the path (the registry's, `[registry]`).
VERIFY_LAUNCHES = {"fp_mul": 0, "fp_addsub": 0, "fp_pow": 0, "fp_batch_inv": 0, "g1_subgroup_check": 0,
                   "fp_mul_mma": 0, "fp2_mul": 0, "fp12_mul": 0, "cyclotomic_pow_x": 0, "g1_scalar_mul": 1,
                   "g2_scalar_mul": 1, "miller_loop": 1, "sswu": 1, "iso3_map": 1, "g1_tree_sum": 1,
                   "g2_tree_sum": 1, "clear_cofactor": 1, "product_reduce": 1, "final_exponentiation": 1,
                   "g2_psi_check": 1, "miller_inputs": 1, "g1_to_affine": 0, "g2_to_affine": 0, "fp6_mul": 0,
                   "fp2_inv": 0, "g1_add": 0, "g2_add": 0, "karabina_sqr": 0, "karabina_decompress": 0,
                   "fp12_inv": 0, "frobenius": 0, "fp2_sqrt_candidate": 0, "fp_redc": 0}
VERIFY_KERNELS = tuple(k for k, n in VERIFY_LAUNCHES.items() if n)
# a sharded rank also multiplies the gathered partials (K18)
SHARDED_LAUNCHES = {**VERIFY_LAUNCHES, "product_reduce": 2}
# the field and tower kernels, off the verify path since K19-K21, timed at the
# shapes that carried most of their main-path work until then: K1 n, K2 n
# (add), K3 n (p - 2), K4 (steps, lanes), K7 (n, op), K8 (n, mode); K6 at K1's
OFF_PATH_SHAPES = {"fp_mul": 258, "fp_addsub": 384, "fp_pow": 1, "fp_batch_inv": (257, 1), "fp2_mul": (512, 0),
                   "fp12_mul": (1, 0), "fp_mul_mma": 258}
# the tree sums' edge column lengths (512: a sync-committee aggregate's
# keys; 1,025: a G2 column past 1,024 signatures with an odd leftover, its
# levels several rounds of K16's 32 lane groups) and the Fp12 product's
# edge counts (129: the Miller values of a 128-set verify); K17's edge
# batch, no multiple of its 16 pairs a block
FOLD_LENGTHS = (1, 2, 3, 5, 128, 512, 1025)
# K15's (128 columns) and K16's (one column) device ms at columns of 2, 4,
# ..., 128 points, one level more each: K16's level of 64 pairs runs two
# rounds of its 32 lane groups (`[tree_levels]`)
TREE_LEVEL_LENGTHS = (2, 4, 8, 16, 32, 64, 128)
# K18's edge counts: one value (a copy), the sharded path's W = 2 to 4 (a
# cluster of 2 and 4 one-value blocks), 17 (a cluster of 8, one block of
# three values), the verify's 129, 1,025 (a level of 64 products on a
# block's eight lane groups, eight rounds) and 2,049 (a block's 257 values
# past its 256 rows: two loads)
REDUCE_COUNTS = (1, 2, 3, 4, 17, 129, 1025, 2049)
# K18's device ms at these counts (`[reduce_levels]`): 1 a copy; 2, 4, 8
# the cluster hand-off and one to three fold levels; 9 a block level
# more than 8; then 16 to 128 a level more each, and 129
REDUCE_LEVEL_COUNTS = (1, 2, 4, 8, 9, 16, 17, 32, 64, 128, 129)
COFACTOR_EDGE = 19
# K11's edge counts (two elements a warp: an odd count leaves the last
# block's second lane group off) and K12's edge pair counts (a block of two
# warps a pair), around the verify path's 256 elements and 129 pairs
SCALAR_MUL_COUNTS = (1, 2, 3, 255, 256, 257)
MILLER_COUNTS = (1, 2, 129, 130)
# K10's edge counts (a lane group of six an element) around the verify
# path's 128, and K13's and K32's (eight and sixteen elements a block)
# around its 256
G1_SCALAR_MUL_COUNTS = (1, 2, 3, 127, 128, 129)
SQRT_COUNTS = (1, 7, 8, 9, 255, 256, 257)
# K19's, K20's and K21's edge shapes: n = 3 Fp12 values (p - 1 in every word
# slot, zero, one); K20 at 19 elements, no multiple of its 32 a block; K21 at
# 1, 33 and 128 sets (a lane a thread, one-warp blocks, G1 warps then G2
# warps, the last of each partly filled at 33; infinity lanes in both)
FINAL_EXP_EDGE = 3
PSI_EDGE = 19
MILLER_INPUTS_EDGE = (1, 33, 128)
# K22, K23 and K25 run a thread per element in one-warp blocks, K24 sixteen
# elements a block: whole blocks and counts that are none
AFFINE_COUNTS = (1, 33, 256)
FP6_COUNTS = (1, 17, 128, 131)
# K22-K25's [timing] shapes, off the verify path: G1 and G2 at the verify's
# batch sizes (S = 128 keys' aggregates, 2 S signatures and hashes), the Fp6
# product at 128, the Fp2 inversion at 256
AFFINE_SHAPES = {"g1_to_affine": 128, "g2_to_affine": 256, "fp6_mul": 128, "fp2_inv": 256}
# K26-K33, the standalone launches of routines that run inside the verify
# path's kernels: counts that are and are not whole blocks (a thread per
# element, 32 a block, K33 128; K30 and K31 a warp per element; K32 a
# thread pair, 16 a block)
STANDALONE_COUNTS = {"g1_add": (1, 33, 256), "g2_add": (1, 33, 256), "karabina_sqr": (1, 33, 128),
                     "karabina_decompress": (1, 6, 33), "fp12_inv": (1, 3, 33), "frobenius": (1, 3, 33),
                     "fp2_sqrt_candidate": (*SQRT_COUNTS[:4], 17, *SQRT_COUNTS[4:]), "fp_redc": (1, 129, 4096)}
# their [timing] shapes, off the verify path: the counts at which the bodies
# run inside the verify's kernels at S = 128 (K15's 128 G1 pairs, K17's 128
# G2 sums, K9's 128 squarings' worth of elements and six decompressions,
# K19's one element, K13's 256 candidates), and 4096 reductions
STANDALONE_SHAPES = {"g1_add": 128, "g2_add": 128, "karabina_sqr": 128, "karabina_decompress": 6,
                     "fp12_inv": 1, "frobenius": 1, "fp2_sqrt_candidate": 256, "fp_redc": 4096}
# registry entries whose plain versions `[kernels]` already holds at the
# verify path's shapes (minutes each on the plain version): `[registry]`
# holds their launches only
HELD_IN_KERNELS = ("pairing.miller_loop", "pairing.final_exponentiation")
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
# and the binary GCD, `inversion_word_products`), five Fp12 products.
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
H2C_CONST_BYTES = 12 * 96  # K13's and K14's constant operand, read once
# K15, K16: an addition is 12 field products (products by 3b are additions);
# a point is 3 coordinates of 48 or 96 bytes. K17: the sum (12 products),
# psi three times (2 each), the doubling (6 products, 2 squares), the two
# final additions (24), and the two 128-bit chains; q0, q1 in, H out, and
# the constants (CX, CY; 2 x 128 bit bytes) read once. K18: n - 1 Fp12
# products (K8 full), a value 576 bytes.
G1_ADD_WP, G2_ADD_WP = 12 * WORD_PRODUCTS_PER_MUL, 12 * FP2_MUL_WP
K17_BYTES, K17_CONST_BYTES = 3 * 3 * 96, 2 * 96 + 2 * 128
# K19: f in and out, the constants (24 Fp rows) read once. K20: sig and
# zsig in, a byte out; CX, CY once. K21: a G1 and a G2 point in per set, a
# G1 and a G2 pair of coordinates and two flags out per lane (S + 1), and
# sig_acc and -g1 read once.
K19_BYTES = 2 * 576 + 24 * 48
K20_BYTES, K20_CONST_BYTES = 6 * 96 + 1, 2 * 96
K21_BYTES_PER_SET, K21_BYTES_PER_LANE, K21_CONST_BYTES = 3 * 48 + 3 * 96, 2 * 48 + 2 * 96 + 2, 3 * 96 + 2 * 48
# K22-K25, bytes of one element: a point in, x, y and the flag out; a, b in
# and c out; a in and its inverse out. K24's word products: six Karatsuba Fp2
# products of 3 x 144 and a reduction per output component.
K22_BYTES, K23_BYTES, K24_BYTES, K25_BYTES = 3 * 48 + 2 * 48 + 1, 3 * 96 + 2 * 96 + 1, 3 * 288, 2 * 96
K24_WORD_PRODUCTS = 6 * 3 * 144 + 6 * REDC_WORD_PRODUCTS
# K26-K33, bytes of one element (inputs read once, the output written once)
# and the constants read once per launch: two points in and one out; a
# compressed element in and out; compressed in, Fp12 out; Fp12 in and out
# and 12 Fp rows of constants (the phi scalars, the gammas); Fp2 in and out;
# T in (24 words) and the residue out
STANDALONE_BYTES = {"g1_add": 9 * 48, "g2_add": 9 * 96, "karabina_sqr": 2 * 384, "karabina_decompress": 384 + 576,
                    "fp12_inv": 2 * 576, "frobenius": 2 * 576, "fp2_sqrt_candidate": 2 * 96, "fp_redc": 96 + 48}
STANDALONE_CONST_BYTES = {"fp12_inv": 12 * 48, "frobenius": 12 * 48}


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


def sliding_window_word_products(e: int, mul: int, sqr: int, width: int = 5) -> int:
    """A power by a public exponent on sliding windows of at most `width`
    bits, MSB first, that start and end on a one bit: the odd powers up to
    the largest window's (a square and a product each past x), a square
    per bit below the leading window, a product per window below it."""
    bits, windows, i = bin(e)[2:], [], 0
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + width, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        windows.append((i, int(bits[i:j], 2)))
        i = j
    table = max(d for _, d in windows) >> 1
    squares = len(bits) - (windows[0][0] + len(bin(windows[0][1])) - 2)
    return (1 + squares) * sqr + (table + len(windows) - 1) * mul


def power_word_products(e: int, mul: int, sqr: int) -> int:
    """A power by a public exponent, as cheaply as the function allows of
    the two schedules counted here: the plain version's 4-bit windows or
    5-bit sliding windows (K13's and K32's chains)."""
    return min(pow_word_products(e, mul, sqr), sliding_window_word_products(e, mul, sqr))


# fp384.cuh's fp_inv: 26 batches of 30 divsteps on two-word approximations
# (selects and additions, no word product).
FP_INV_BATCHES = 26


def inversion_word_products() -> int:
    """An Fp inversion in a kernel, fp384.cuh's binary GCD: a batch is two
    12-word combinations a f + b g (24 word products each) and two u f + v g
    with their Montgomery word step (24, 12 for m p, 1 for m); then the
    closing Montgomery product. K3 is a general power and is counted on
    `power_word_products` instead."""
    return FP_INV_BATCHES * (2 * 24 + 2 * (24 + 12 + 1)) + WORD_PRODUCTS_PER_MUL


def batch_inv_word_products(steps: int) -> int:
    """Word products one lane of K4 needs over `steps` values: 3 steps - 1
    Fp products (the forward products from one, the products by the
    prefixes, the updates of the inverse on the way back) and one
    inversion."""
    return (3 * steps - 1) * WORD_PRODUCTS_PER_MUL + inversion_word_products()


def h2c_word_products(P: int) -> tuple[int, int]:
    """(K13, K14) word products one element needs. The Fp2 inversion: the
    norm's two Fp squares summed and reduced once, the Fp inversion, two Fp
    products. K13: u^2, (Z u^2)^2, the inversion, x1, x2, gx1 and gx2 (a
    square and a product each), two square-root candidates (the powers
    (p - 3) / 4 and (p - 1) / 2, three products), y1^2, and sgn0 of u and y
    (four reductions out of Montgomery form); the products by Z = -(2 + u)
    and A = 240 u are additions. K14: the inversion, d^2, six products,
    four Fp products (1/9, -1/27)."""
    inv = 2 * 78 + REDC_WORD_PRODUCTS + inversion_word_products() + 2 * WORD_PRODUCTS_PER_MUL
    sqrt = (power_word_products((P - 3) // 4, FP2_MUL_WP, FP2_SQR_WP)
            + power_word_products((P - 1) // 2, FP2_MUL_WP, FP2_SQR_WP) + 3 * FP2_MUL_WP)
    sswu = (2 * FP2_SQR_WP + inv + 2 * FP2_MUL_WP + 2 * (FP2_SQR_WP + FP2_MUL_WP) + 2 * sqrt
            + FP2_SQR_WP + 4 * REDC_WORD_PRODUCTS)
    iso = inv + FP2_SQR_WP + 6 * FP2_MUL_WP + 4 * WORD_PRODUCTS_PER_MUL
    return sswu, iso


def k17_word_products() -> int:
    """Word products one element of K17 needs (see K17_BYTES)."""
    return ((12 + 3 * 2 + 6 + 24) * FP2_MUL_WP + 2 * FP2_SQR_WP
            + 2 * scalar_mul_word_products(128, FP2_MUL_WP, FP2_SQR_WP))


def k19_word_products() -> int:
    """Word products one element of K19 needs: five K9 chains; fourteen
    Fp12 products (ten, and fp12_inv's four); five Frobenius maps of six
    Fp2 products; phi(N) and phi^2(N), eight Fp products (N lies in Fp6);
    the Fp2 inversion (its norm's two Fp squares summed and reduced once,
    the Fp inversion, two Fp products); the product by its result, six Fp2
    products."""
    k9 = K9_WORD_PRODUCTS_BUT_POWER + inversion_word_products()
    return (5 * k9 + 14 * FP12_MUL_WP + 5 * 6 * FP2_MUL_WP + 8 * WORD_PRODUCTS_PER_MUL + fp2_inv_word_products()
            + 6 * FP2_MUL_WP)


def fp2_inv_word_products() -> int:
    """An Fp2 inversion (K25, and inside K23): the norm's two Fp squares
    summed and reduced once, the Fp inversion, two Fp products."""
    return 2 * 78 + REDC_WORD_PRODUCTS + inversion_word_products() + 2 * WORD_PRODUCTS_PER_MUL


def affine_word_products() -> dict:
    """Word products one element of K22-K25 needs: to_affine is an
    inversion and two products (Fp for G1, Fp2 for G2)."""
    return {"g1_to_affine": inversion_word_products() + 2 * WORD_PRODUCTS_PER_MUL,
            "g2_to_affine": fp2_inv_word_products() + 2 * FP2_MUL_WP,
            "fp6_mul": K24_WORD_PRODUCTS, "fp2_inv": fp2_inv_word_products()}


def standalone_word_products(P: int) -> dict:
    """Word products one element of K26-K33 needs (K29 where g2 != 0; see
    `decompress_word_products`): an addition is 12 field products (the
    products by 3b are additions); Karabina's squaring four Fp2 squares
    and two products; the Fp12 inversion fp12_inv's four Fp12 products,
    eight Fp products, the Fp2 inversion and six Fp2 products; the
    Frobenius map six Fp2 products; the square-root candidate its two
    powers on the plain version's schedule and three Fp2 products; the
    reduction 156."""
    sqrt = (power_word_products((P - 3) // 4, FP2_MUL_WP, FP2_SQR_WP)
            + power_word_products((P - 1) // 2, FP2_MUL_WP, FP2_SQR_WP) + 3 * FP2_MUL_WP)
    return {"g1_add": G1_ADD_WP, "g2_add": G2_ADD_WP, "karabina_sqr": 4 * FP2_SQR_WP + 2 * FP2_MUL_WP,
            "karabina_decompress": decompress_word_products(True),
            "fp12_inv": 4 * FP12_MUL_WP + 8 * WORD_PRODUCTS_PER_MUL + fp2_inv_word_products() + 6 * FP2_MUL_WP,
            "frobenius": 6 * FP2_MUL_WP, "fp2_sqrt_candidate": sqrt, "fp_redc": REDC_WORD_PRODUCTS}


def decompress_word_products(g2_nonzero: bool) -> int:
    """One decompression (K29), by its branch: where g2 != 0 three Fp2
    squares and three products, where g2 = 0 one square and four products;
    the norm's two Fp squares summed and reduced once, the Fp inversion,
    two Fp products."""
    fp2 = 3 * FP2_SQR_WP + 3 * FP2_MUL_WP if g2_nonzero else FP2_SQR_WP + 4 * FP2_MUL_WP
    return fp2 + 2 * 78 + REDC_WORD_PRODUCTS + inversion_word_products() + 2 * WORD_PRODUCTS_PER_MUL


def k21_word_products(S: int) -> int:
    """Word products K21 needs for S sets: the S + 1 G2 norms (two Fp
    squares summed and reduced once), Montgomery's trick over n = 2S + 1
    values (3(n - 1) Fp products and one inversion), two Fp products a G1
    lane, two Fp products and two Fp2 products a G2 lane."""
    n = 2 * S + 1
    return ((S + 1) * (2 * 78 + REDC_WORD_PRODUCTS) + 3 * (n - 1) * WORD_PRODUCTS_PER_MUL
            + inversion_word_products() + 2 * S * WORD_PRODUCTS_PER_MUL
            + (S + 1) * (2 * WORD_PRODUCTS_PER_MUL + 2 * FP2_MUL_WP))


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
# Block import: minimal preset, phase0, 64 interop validators (2 committees
# of 4 a slot, so a block carries 4 signature sets), 40 slots; chain B
# takes the first 32 blocks as one segment (126 sets, staged 128 x 4).
CHAIN_VALIDATORS = 64
CHAIN_SLOTS = 40
CHAIN_SEGMENT = 32
CHAIN_MIN_FINALIZED = 2
# Conformance: the port generator's eth2 BLS cases, seven types.
CONFORMANCE_CASES = 39
# [sync]: the most a gossip block (or its second copy) may take to reach the
# follower over localhost sockets
SYNC_GOSSIP_WAIT_S = 10.0
# [vc]: the slots the validator client drives after chain A's head; its
# keystores' KDF (pbkdf2 at the EIP-2335 test vector's count) and password
# (the vector's, which NFKD folds to "testpassword" and the key); the most
# an HTTP call may wait; the phase's limit
VC_SLOTS = 2
VC_KDF = {"c": 262144, "dklen": 32}
VC_PASSWORD = "\U0001d531\U0001d522\U0001d530\U0001d531\U0001d52d\U0001d51e\U0001d530\U0001d530\U0001d534\U0001d52c\U0001d52f\U0001d521\U0001f511"
VC_HTTP_TIMEOUT_S = 10.0
VC_MAX_S = 60.0
# the whole run's limit, well inside the 1,200 s a run may take
DONE_MAX_S = 1000.0


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
#: traces that came back with another count of device events than the
#: window issues (events lost), taken again
PARTIAL_TRACES = 0
#: the most tries that one trace took in this run
TRACE_TRIES_MOST = 0
# the card's profiler has returned three empty traces of one short window
# in a row (K24's 20 launches of 7 us), and on one machine ten in a row
# of a verify's, three runs out of four: thirty tries before a phase
# fails, each window left to settle (below) before the profiler stops
TRACE_TRIES = 30
# seconds a traced window waits, after its work has finished on the
# device, before the profiler stops: the device's activity records reach
# the profiler asynchronously (chip_probes/profiler_traces.py: without the
# wait a verify's trace now and then comes back short of events)
TRACE_SETTLE_S = 0.02
# device operations (kernels, copies, fills) of one verify, at each
# profiled shape and with the MXU flag
VERIFY_DEVICE_OPS = 155
# the runtime calls that enqueue a device operation, as the profiler records
# them on the host's side of a trace
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync")
# the one loss of device events that a verify's trace may keep: on one
# machine every trace of a 128 x 128 verify lacked the window's first two
# operations, the verify's one copy of a pageable host buffer to the device
# and the kernel launched after it (chip_probes/trace_losses.py)
HEAD_LOSS_COPY = "Memcpy HtoD (Pageable -> Device)"
HEAD_LOSS_MOST = 2


def device_op_kind(name: str) -> str:
    """'copy', 'fill' or 'kernel': the kind of device operation that a
    runtime call of ENQUEUE_CALLS enqueues, or that a device event is."""
    if name == "cudaMemcpyAsync" or name.startswith("Memcpy"):
        return "copy"
    if name == "cudaMemsetAsync" or name.startswith("Memset"):
        return "fill"
    return "kernel"


def head_loss(prof, device_calls: int) -> int:
    """The device events a trace lost, where the loss is HEAD_LOSS_* and
    nothing else, else 0. The runtime calls must number `device_calls`,
    the first a copy and a second lost one a launch, and the trace must
    hold no HEAD_LOSS_COPY event (the window's one such copy is the lost
    one). Then, in order of start, each device event answers the call as
    many places on as were lost (one stream runs the operations in the
    order they were enqueued): it must be of that call's kind and start
    after the call began, so that a loss further on, where the device
    keeps up with the host, shifts an event onto a call made after it."""
    events = list(prof.events())
    calls = sorted((e for e in events if e.name in ENQUEUE_CALLS), key=lambda e: e.time_range.start)
    dev = sorted((e for e in events if str(e.device_type).endswith("CUDA")), key=lambda e: e.time_range.start)
    lost = len(calls) - len(dev)
    if len(calls) != device_calls or not 1 <= lost <= HEAD_LOSS_MOST:
        return 0
    if [device_op_kind(e.name) for e in calls[:lost]] != ["copy", "kernel"][:lost]:
        return 0
    if any(e.name == HEAD_LOSS_COPY for e in dev):
        return 0
    if any(device_op_kind(c.name) != device_op_kind(d.name) or d.time_range.start < c.time_range.start
           for c, d in zip(calls[lost:], dev)):
        return 0
    return lost


def traced_device_events(window, device_calls: int | None = None):
    """Run window() under torch.profiler, tracing the device's activity
    only, and return (rows, wall ms of the traced window), a row being
    (self device microseconds, calls, name) of an event that spent time
    on the device. The profiler now and then returns a trace with no
    device event at all, or one that lost some: a trace with no event, or
    where `device_calls` is given one whose device events or whose runtime
    calls that enqueue device operations (ENQUEUE_CALLS) are not
    `device_calls`, is counted in EMPTY_TRACES or PARTIAL_TRACES and taken
    again. After TRACE_TRIES such traces, the one that lost fewest events
    to `head_loss` alone is returned (its rows then lack them), else this
    raises. The wall time ends when the window's work has finished on the
    device, before the settling wait."""
    global EMPTY_TRACES, PARTIAL_TRACES, TRACE_TRIES_MOST
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen, short, short_lost = [], None, HEAD_LOSS_MOST + 1
    for tries in range(1, TRACE_TRIES + 1):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            window()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(TRACE_SETTLE_S)
        rows, enqueued = [], 0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
            elif e.key in ENQUEUE_CALLS:
                enqueued += e.count
        seen.append((sum(r[1] for r in rows), enqueued))
        if not rows:
            EMPTY_TRACES += 1
        elif device_calls is not None and seen[-1] != (device_calls, device_calls):
            PARTIAL_TRACES += 1
            lost = head_loss(prof, device_calls)
            if 0 < lost < short_lost:
                short, short_lost = (rows, wall_ms), lost
        else:
            TRACE_TRIES_MOST = max(TRACE_TRIES_MOST, tries)
            return rows, wall_ms
    if short is None:
        raise RuntimeError(f"the profiler trace held no device events, or not the {device_calls} expected, "
                           f"in {TRACE_TRIES} tries (device events, enqueued operations): {seen}")
    TRACE_TRIES_MOST = TRACE_TRIES
    return short


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
    8 seeded random G1 and G2 points, affine, tiled; lanes 1, 2 and 3 (those
    below n) with P, Q and both at infinity (the generator-substitution
    lanes). Also tests/test_torch_gpu.py's."""
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
    from lighthouse_tpu_torch.crypto.bls.torch_backend.pack import pack_g1_batch, pack_g2_batch

    rng = random.Random(seed)
    g1 = [g1_generator().mul(rng.randrange(1, R)) for _ in range(8)]
    g2 = [g2_generator().mul(rng.randrange(1, R)) for _ in range(8)]
    ps = [g1[i % 8] for i in range(n)]
    qs = [g2[(i // 8) % 8] for i in range(n)]
    for i in range(1, min(n, 4)):  # lane 1 P, lane 2 Q, lane 3 both at infinity
        if i != 2:
            ps[i] = g1_infinity()
        if i != 1:
            qs[i] = g2_infinity()
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


def psi_inputs(torch, fp, curve, h2c, P, n: int, seed: int):
    """K20's operands on the card as the verify hands them over, n >= 4
    signatures and their [|z|] multiples (K11): `curve_inputs`' G2 points
    (rows 0 and 1 at infinity), every fifth row from row 5 on a point of E2
    outside G2 (the isogeny's image of an SSWU point, before the cofactor
    clearing), and the last row's multiple that of row 2, another point.
    Returns (sig, zsig, the verdicts the psi criterion must give). Also
    tests/test_torch_gpu.py's."""
    sig = curve.Proj(*(c.clone() for c in curve_inputs(torch, fp, curve, "g2", n, seed)))
    off = list(range(5, n, 5))
    q = h2c.iso3_map(*h2c.sswu(sswu_inputs(fp, P, len(off) + 4, seed, DEVICE)[4:]))
    for c, v in zip(sig, q):
        c[off] = v
    zsig = curve.Proj(*(c.clone() for c in curve.scalar_mul_bits(curve.FP2, sig, curve._ABS_X_BITS)))
    for c in zsig:
        c[n - 1] = c[2]
    return sig, zsig, [i not in off and i != n - 1 for i in range(n)]


def miller_input_points(torch, fp, curve, S: int, seed: int):
    """K21's operands on the card: r_pk (S G1 points, K10's output), H (S G2
    points, K17's) and sig_acc (one G2 point, K16's), from `curve_inputs`
    (Z != 1): for S > 1 the first S rows, rows 0 and 1 at infinity in both
    groups; for S = 1 a finite G1 point and a G2 point at infinity. Also
    tests/test_torch_gpu.py's."""
    g1 = curve_inputs(torch, fp, curve, "g1", S + 4, seed)
    g2 = curve_inputs(torch, fp, curve, "g2", S + 4, seed + 1)
    rows = (list(range(S)), list(range(S))) if S > 1 else ([2], [1])
    r_pk, h = (curve.Proj(*(c[r].contiguous() for c in p)) for p, r in zip((g1, g2), rows))
    return r_pk, h, curve.unstack(g2, S + 3)


def affine_inputs(torch, fp, curve, tower, group: str, n: int, seed: int):
    """n projective points of G1 or G2 on the card for K22 and K23, from
    `curve_inputs` (Z != 1; rows 0 and 1 at infinity, Z = 0), row 2 with
    Z = one and row 3 with p - 1 in every word slot of X, Y and Z (the map
    to affine coordinates is a field function of any X, Y, Z)."""
    from lighthouse_tpu_torch.crypto.bls.constants import P

    pts = curve.Proj(*(c[:n].clone() for c in curve_inputs(torch, fp, curve, group, max(n, 4), seed)))
    if n > 3:
        pts.z[2] = (fp.one if group == "g1" else tower.fp2_one)((), DEVICE)
        for c in pts:
            c[3] = torch.from_numpy(fp.int_to_words(P - 1)).to(DEVICE)
    return pts


def affine_cases(torch, fp, curve, tower, P, shapes: dict, seed: int):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K22-K25 at the counts of `shapes` (kernel -> counts): K22
    and K23 on `affine_inputs`, against `to_affine_plain` over the plain
    fields and over the kernel fields (K3 and K1; the Fp2 inversion as the
    K1-K3 composition and K7); K24 on `fp2_inputs` in threes (a zero
    coefficient, one, p - 1 in every word slot, u; one element all p - 1)
    against `fp6_mul_composed` over the plain and the kernel tower (K7,
    K2), with an operand broadcast over the batch too; K25 on `fp2_inputs`
    (zero: inv0) against `fp2_inv_composed` over the plain and the kernel
    field operations (K1, K2, K3)."""
    cases = {}
    fp2_composed = curve.FP2._replace(inv=lambda a: tower.fp2_inv_composed(a, fp.KERNEL_OPS))
    fields = {"g1_to_affine": ("g1", curve.FP, curve.FP_PLAIN, curve.FP),
              "g2_to_affine": ("g2", curve.FP2, curve.FP2_PLAIN, fp2_composed)}
    for name, (group, F, F_plain, F_comp) in fields.items():
        counts = shapes.get(name, ())
        if counts:
            pts = affine_inputs(torch, fp, curve, tower, group, max(counts), seed)
        for n in counts:
            p = curve.Proj(*(c[:n] for c in pts))
            cases[f"{name}_n{n}"] = ([n], lambda F=F, p=p: curve.to_affine(F, p),
                                     lambda F=F_plain, p=p: curve.to_affine_plain(F, p),
                                     lambda F=F_comp, p=p: curve.to_affine_plain(F, p))
    for n in shapes.get("fp2_inv", ()):
        a = fp2_inputs(fp, P, n, seed + 1, DEVICE)
        cases[f"fp2_inv_n{n}"] = ([n], lambda a=a: tower.fp2_inv(a), lambda a=a: tower.fp2_inv_plain(a),
                                  lambda a=a: tower.fp2_inv_composed(a, fp.KERNEL_OPS))
    counts = shapes.get("fp6_mul", ())
    if counts:
        x6 = fp2_inputs(fp, P, 3 * max(counts) + 3, seed + 2, DEVICE).reshape(-1, 3, 2, fp.WORDS).clone()
        x6[1] = torch.from_numpy(fp.int_to_words(P - 1)).to(DEVICE)
    for n in counts:
        a, b = x6[:n], x6.roll(1, dims=0)[:n]
        for label, bb in (("", b), ("broadcast_", x6[0])):
            cases[f"fp6_mul_{label}n{n}"] = ([n], lambda a=a, b=bb: tower.fp6_mul(a, b),
                                             lambda a=a, b=bb: tower.fp6_mul_plain(a, b),
                                             lambda a=a, b=bb: tower.fp6_mul_composed(a, b, tower.KERNEL_TOWER))
    return cases


def standalone_cases(torch, fp, curve, tower, pairing, h2c, P, shapes: dict, seed: int):
    """(cases, work) for K26-K33 at the counts of `shapes` (kernel ->
    counts). cases: name -> (shape, kernel call, plain version, the
    composition it replaced, or None for K33, which replaced the plain
    reduction only). work: name -> (word products, bytes) of the case's
    inputs (K29's by each element's branch). Inputs: K26 and K27 on
    `affine_inputs` (Z = 0, Z = one, p - 1 in every word slot) added to
    the rows rolled by one, with a P == Q row, a P == -Q row and a point
    broadcast over the batch; K28 and K29 on `fp2_inputs` in fours (zero,
    one, p - 1, u), K29 with the all-zero identity, a g2 = 0 row (the
    other branch) and a g2 = g3 = 0 row (a zero denominator: inv0); K30
    and K31 on `fp12_inputs` (p - 1, zero, one); K32 on `sswu_inputs` (0,
    one, u, -1, whose alpha is -1); K33 on T = 0, 2 p 2^384 - 1, p^2 - 1,
    p 2^384 and seeded random T below 2 p 2^384."""
    cases, work = {}, {}
    ops = standalone_word_products(P)

    def add(name, n, run, plain, composed, wp=None, extra_bytes=0):
        cases[name] = ([n], run, plain, composed)
        kernel = name.rsplit("_n", 1)[0].replace("_broadcast", "")
        work[name] = (n * ops[kernel] if wp is None else wp,
                      n * STANDALONE_BYTES[kernel] + STANDALONE_CONST_BYTES.get(kernel, 0) + extra_bytes)

    for name, group, F, F_plain in (("g1_add", "g1", curve.FP, curve.FP_PLAIN),
                                    ("g2_add", "g2", curve.FP2, curve.FP2_PLAIN)):
        counts = shapes.get(name, ())
        if not counts:
            continue
        p = affine_inputs(torch, fp, curve, tower, group, max(max(counts), 6), seed)
        q = curve.Proj(*(c.roll(1, dims=0) for c in p))
        for c_p, c_q in zip(p, q):
            c_q[4] = c_p[4]  # P == Q
        q.y[5] = F_plain.neg(p.y[5])  # P == -Q
        q.x[5], q.z[5] = p.x[5], p.z[5]
        for n in counts:
            pn, qn = curve.Proj(*(c[:n] for c in p)), curve.Proj(*(c[:n] for c in q))
            add(f"{name}_n{n}", n, lambda F=F, a=pn, b=qn: curve.add(F, a, b),
                lambda F=F_plain, a=pn, b=qn: curve.add_composed(F, a, b),
                lambda F=F, a=pn, b=qn: curve.add_composed(F, a, b))
        n = max(counts)
        pn, one = curve.Proj(*(c[:n] for c in p)), curve.Proj(*(c[3] for c in q))  # Z = one
        add(f"{name}_broadcast_n{n}", n, lambda F=F, a=pn, b=one: curve.add(F, a, b),
            lambda F=F_plain, a=pn, b=one: curve.add_composed(F, a, b),
            lambda F=F, a=pn, b=one: curve.add_composed(F, a, b))
    compressed = {}
    for name in ("karabina_sqr", "karabina_decompress"):
        counts = shapes.get(name, ())
        if counts:
            c = fp2_inputs(fp, P, 4 * max(max(counts), 4) + 4, seed + 1, DEVICE)[4:]
            c = c.reshape(-1, 4, 2, fp.WORDS)[: max(counts)].clone()
            c[0] = 0  # the compressed identity
            if name == "karabina_decompress" and c.shape[0] > 2:
                c[1, 0] = 0  # g2 = 0: the other branch
                c[2, 0:2] = 0  # g2 = g3 = 0: a zero denominator (inv0)
            if c.shape[0] > 3:
                c[3] = torch.from_numpy(fp.int_to_words(P - 1)).to(DEVICE)
            compressed[name] = c
    for n in shapes.get("karabina_sqr", ()):
        c = compressed["karabina_sqr"][:n]
        add(f"karabina_sqr_n{n}", n, lambda c=c: tower.karabina_sqr(c), lambda c=c: tower.karabina_sqr_plain(c),
            lambda c=c: tower.karabina_sqr_composed(c, tower.KERNEL_TOWER))
    for n in shapes.get("karabina_decompress", ()):
        c = compressed["karabina_decompress"][:n]
        nz = int((c[:, 0] != 0).flatten(1).any(dim=1).sum())
        add(f"karabina_decompress_n{n}", n, lambda c=c: tower.karabina_decompress(c),
            lambda c=c: tower.karabina_decompress_plain(c),
            lambda c=c: tower.karabina_decompress_composed(c, tower.KERNEL_TOWER),
            wp=nz * decompress_word_products(True) + (n - nz) * decompress_word_products(False))
    for name, run, plain, composed in (
            ("fp12_inv", tower.fp12_inv, tower.fp12_inv_plain,
             lambda a: tower.fp12_inv_composed(a, tower.KERNEL_TOWER)),
            ("frobenius", pairing.frobenius, pairing.frobenius_plain,
             lambda a: pairing.frobenius_composed(a, tower.KERNEL_TOWER))):
        counts = shapes.get(name, ())
        if counts:
            f = fp12_inputs(fp, tower, P, max(counts), seed + 2, DEVICE)
        for n in counts:
            add(f"{name}_n{n}", n, lambda f=f[:n], g=run: g(f), lambda f=f[:n], g=plain: g(f),
                lambda f=f[:n], g=composed: g(f))
    counts = shapes.get("fp2_sqrt_candidate", ())
    if counts:
        x = sswu_inputs(fp, P, max(counts), seed + 3, DEVICE)
    for n in counts:
        add(f"fp2_sqrt_candidate_n{n}", n, lambda x=x[:n]: h2c.fp2_sqrt_candidate(x),
            lambda x=x[:n]: h2c.fp2_sqrt_candidate_plain(x),
            lambda x=x[:n]: h2c.fp2_sqrt_candidate_composed(x, tower.KERNEL_TOWER))
    counts = shapes.get("fp_redc", ())
    if counts:
        rng = random.Random(seed + 4)
        top = 2 * P << 384
        vals = [0, top - 1, P * P - 1, P << 384] + [rng.randrange(top) for _ in range(max(counts))]
        buf = b"".join(v.to_bytes(96, "little") for v in vals[: max(counts)])
        t = torch.frombuffer(bytearray(buf), dtype=torch.int32).reshape(-1, 24).to(DEVICE)
    for n in counts:
        add(f"fp_redc_n{n}", n, lambda t=t[:n]: fp.mont_reduce(t), lambda t=t[:n]: fp.mont_reduce_plain(t), None)
    return cases, work


def interop_public_key(i: int):
    """Interop validator i's public key (the ref oracle's: a pure-Python
    scalar multiplication, so the set-up maps it over a process pool)."""
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref

    return ref.interop_keypair(i)[1]


def host_pool():
    """A pool of spawned host processes for the set-up's pure-Python key
    work, one a core up to 8; leaving its `with` block ends them all."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1))


def sign_root(task) -> bytes:
    """(secret key as an integer, 32-byte signing root) -> the compressed
    signature by the ref oracle (a host process of `host_pool`)."""
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref

    k, root = task
    return ref.SecretKey(k).sign(root).to_bytes()


def oracle_set_verdict(task) -> bool:
    """(signature bytes, [public key bytes], message) -> the ref oracle's
    verdict on that one set, decoding with the subgroup checks."""
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref

    sig, keys, message = task
    try:
        s = ref.SignatureSet(ref.Signature.from_bytes(sig), [ref.PublicKey.from_bytes(k) for k in keys], message)
    except ref.DecodeError:
        return False
    return bool(ref.verify_signature_sets([s]))


def encrypt_keystore(task) -> dict:
    """(secret key as an integer, validator index, public key hex) -> its
    EIP-2335 keystore by the port's `keystore.encrypt`, pbkdf2 at VC_KDF
    (a host process of `host_pool`)."""
    from lighthouse_tpu_torch.crypto import keystore

    k, i, pubkey = task
    return keystore.encrypt(k.to_bytes(32, "big"), VC_PASSWORD, path=f"m/12381/3600/{i}/0/0", pubkey=pubkey,
                            kdf_function="pbkdf2", kdf_params=VC_KDF)


def decrypt_keystore(path: str) -> tuple[bytes, bytes]:
    """A keystore file -> (its secret key, that key's public key by the ref
    oracle), by the port's `keystore.load` and `decrypt` (a host process of
    `host_pool`)."""
    from lighthouse_tpu_torch.crypto import keystore
    from lighthouse_tpu_torch.crypto.bls.ref import api as ref

    secret = keystore.decrypt(keystore.load(path), VC_PASSWORD)
    return secret, ref.SecretKey.from_bytes(secret).public_key().to_bytes()


def second_lock_holder(path: str) -> str:
    """Try to take the validator directory's lock from another process:
    the refusal's message, or "acquired" (a host process of `host_pool`)."""
    from lighthouse_tpu_torch.validator_client.lockfile import Lockfile, LockfileError

    try:
        Lockfile(path).acquire().release()
    except LockfileError as e:
        return str(e)
    return "acquired"


def make_sets(api, n_sets: int, keys_per_set: int, pubkeys=None):
    """bench.py's shapes: 8 distinct single-key sets tiled to n_sets, or one
    aggregate set of keys_per_set signers repeated n_sets times. The
    aggregate signature is the signature under the sum of the secret keys,
    which equals the sum of the signers' signatures. `pubkeys[i]`, where
    given, is interop validator i's public key."""
    from lighthouse_tpu_torch.crypto.bls.constants import R

    def pair(i):
        sk = api.interop_secret_key(i)
        return sk, (pubkeys[i] if pubkeys is not None else sk.public_key())

    if keys_per_set == 1:
        base = []
        for i in range(8):
            sk, pk = pair(i)
            msg = bytes([i]) * 32
            base.append(api.SignatureSet(signature=sk.sign(msg), signing_keys=[pk], message=msg))
        return [base[i % 8] for i in range(n_sets)]
    pairs = [pair(i) for i in range(keys_per_set)]
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


def ptxas_summary(log: str, kernel: str, nlines: int = 2) -> str:
    """ptxas's stack and spill line and (for a kernel, nlines = 2) its
    registers and shared memory line for function `kernel` (or
    `kernel`_kernel) from the build log. The name must be the function's
    own in the mangled name, a length before it and "E" after it: every
    function of final_exponentiation_kernels.cu carries that file's name."""
    lines = log.splitlines()
    own = re.compile(rf"\d{re.escape(kernel)}(_kernel)?E")
    for i, line in enumerate(lines):
        if "Function properties for" in line and own.search(line):
            return "; ".join(l.split(":", 1)[-1].strip() for l in lines[i + 1 : i + 1 + nlines])
    return "not found"


# [timing] lines that carry ptxas's registers, shared memory and spills:
# K1 and K2 (fp384.cuh's carry chains alone), K4 (a chunk of a column a
# thread), K5 (a quad of lanes a key), K8 and K9 (the 24-lane Fp12
# product; the |z| chain in registers, with
# its routine's own stack and spills), K10, K11, K15, K16 and K17 (the
# lane-group law), K12 (two warps), K13 (the windowed square-root chains),
# K14 and K20 (a lane group an element), K18 (a cluster of lane groups),
# K19, K21 and K22 (callers of fp384.cuh's binary-GCD inversion; K22's
# line also gives the inversion's own stack and spills).
PTXAS_TIMED = {"fp_mul": "fp_mul_kernel", "fp_addsub": "fp_addsub_kernel", "fp_batch_inv": "fp_batch_inv_kernel",
               "g1_subgroup_check": "g1_subgroup_check_kernel", "fp12_mul": "fp12_mul_kernel",
               "cyclotomic_pow_x": "cyclotomic_pow_x_kernel",
               "g1_scalar_mul": "g1_scalar_mul_kernel", "g2_scalar_mul": "g2_scalar_mul_kernel",
               "miller_loop": "miller_loop_kernel", "sswu": "sswu_kernel", "iso3_map": "iso3_map_kernel",
               "g2_psi_check": "g2_psi_check_kernel", "g1_tree_sum": "g1_tree_sum_kernel",
               "g2_tree_sum": "g2_tree_sum_kernel", "clear_cofactor": "clear_cofactor_kernel",
               "product_reduce": "product_reduce_kernel", "final_exponentiation": "final_exponentiation_kernel",
               "miller_inputs": "miller_inputs_kernel", "g1_to_affine": "g1_to_affine_kernel"}
# the device functions whose own stack and spills a kernel's line adds
PTXAS_ROUTINES = {"cyclotomic_pow_x": ("ptxas_chain", "cyclotomic_pow_x_block"),
                  "g1_to_affine": ("ptxas_fp_inv", "fp_inv")}


def ptxas_fields(log: str, name: str) -> dict:
    """The `[timing]` fields of ptxas's report in build log `log` for
    kernel `name` (none for a kernel outside PTXAS_TIMED)."""
    if name not in PTXAS_TIMED:
        return {}
    fields = {"ptxas": ptxas_summary(log, PTXAS_TIMED[name])}
    if name in PTXAS_ROUTINES:
        key, routine = PTXAS_ROUTINES[name]
        fields[key] = ptxas_summary(log, routine, 1)
    return fields


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


def fp_edge_values(fp, P) -> list[int]:
    """Edge operands of K1 and K2 (fp384.cuh's carry chains): 0, 1 and
    p - 1 (stored and in Montgomery form); one word 1 or all ones in each
    of the 12 word positions (where below p); all ones below p's top word
    and p less all ones below it, whose words carry or borrow through every
    chain."""
    vals = [0, 1, P - 1, fp.R_MONT, (P - 1) * fp.R_MONT % P, P - 2]
    for i in range(fp.WORDS):
        vals += [v << (32 * i) for v in (1, 0xFFFFFFFF) if v << (32 * i) < P]
    vals += [(1 << 352) - 1, (1 << 380) - 1, P - (1 << 352), P - (1 << 32)]
    return vals


def check_kernels(torch, fp, P, dev) -> None:
    a = field_inputs(fp, P, N_RANDOM, 1, dev)
    b = a.roll(1, dims=0)
    # K1 and K2 on every pair of edge operands, and all-(p - 1)
    edges = fp_edge_values(fp, P)
    ea = torch.from_numpy(fp.ints_to_words([x for x in edges for _ in edges])).to(dev)
    eb = torch.from_numpy(fp.ints_to_words([y for _ in edges for y in edges])).to(dev)
    checks = {
        "fp_mul": (fp.mul(a, b), fp.mul_plain(a, b)),
        "fp_add": (fp.add(a, b), fp.addsub_plain(a, b, 0)),
        "fp_sub": (fp.sub(a, b), fp.addsub_plain(a, b, 1)),
        "fp_neg": (fp.neg(a), fp.addsub_plain(a, None, 2)),
        "fp_mul_edges": (fp.mul(ea, eb), fp.mul_plain(ea, eb)),
        "fp_add_edges": (fp.add(ea, eb), fp.addsub_plain(ea, eb, 0)),
        "fp_sub_edges": (fp.sub(ea, eb), fp.addsub_plain(ea, eb, 1)),
        "fp_neg_edges": (fp.neg(ea), fp.addsub_plain(ea, None, 2)),
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
    phase("kernels", ok=True, compared=",".join(checks), elements=a.shape[0], edge_pairs=ea.shape[0],
          batch_inv_steps=n)


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


def chain_cases(torch, fp, curve, tower, pairing, api, h2c, P):
    """(cases, K20's verdicts; see `glue_cases`): name -> (shape, kernel
    call, plain version, the composition it replaced) for K9-K21 at the
    verify path's shapes (128 x 128 verify):
    K10 on S points at 64 bits, K11 on the 2 S stacked signatures at 64
    bits and on the cofactor clearing's 2 x S points at 128 broadcast bits
    (the chains K17 now runs: K11's launch of them before K17), K9 on one
    element and on four with the edge lanes, K12 on the S + 1 Miller pairs,
    K13 on the 2 S stacked u's, K14 on SSWU's 2 S points and the kernel
    point, K15 on S columns of K keys, K16 on one column of S points, K17
    on the isogeny's 2-stacked images of S messages, K18 on the S + 1
    Miller values, K19 on one Fp12 value, K20 on S signatures and K21 on S
    sets (`glue_cases`)."""
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
    fe = {"final_exponentiation_n1": fp12_inputs(fp, tower, P, 4, 30, DEVICE)[3:]}
    glue, verdicts = glue_cases(torch, fp, curve, tower, pairing, api, h2c, P, fe, [S], [S], 31)
    cases.update(glue)
    return cases, verdicts


def lane_cases(torch, fp, curve, tower, pairing, smul_counts, miller_counts, seed, g1_counts=()):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K11 on each count of `smul_counts` and K10 on each of
    `g1_counts` (`curve_inputs`' points and `scalar_bits`' 64-bit rows,
    their edge rows where the count reaches them; int64 bits at odd
    counts, int32 at even ones) and K12 on each count of `miller_counts`
    (`miller_inputs`, infinity lanes where the count reaches them)."""
    smul = curve.scalar_mul_bits_plain
    cases = {}
    for group, counts, F, plain in (("g2", smul_counts, curve.FP2, curve.FP2_PLAIN),
                                    ("g1", g1_counts, curve.FP, curve.FP_PLAIN)):
        for n in counts:
            p = curve.Proj(*(c[:n] for c in curve_inputs(torch, fp, curve, group, max(n, 4), seed + n)))
            b = scalar_bits(torch, max(n, 6), 64, seed + n + 1)[:n]
            b = b.to(torch.int64) if n % 2 else b
            cases[f"{group}_scalar_mul_n{n}_b64"] = ([n, 64], lambda F=F, p=p, b=b: curve.scalar_mul_bits(F, p, b),
                                                     lambda plain=plain, p=p, b=b: smul(plain, p, b),
                                                     lambda F=F, p=p, b=b: smul(F, p, b))
    for n in miller_counts:
        mil = miller_inputs(torch, fp, n, seed + n + 2, DEVICE)
        cases[f"miller_loop_n{n}"] = ([n], lambda mil=mil: pairing.miller_loop(*mil),
                                      lambda mil=mil: pairing.miller_loop_plain(*mil),
                                      lambda mil=mil: pairing.miller_loop_composed(*mil, tower.KERNEL_TOWER))
    return cases


def sswu_cases(torch, fp, tower, h2c, P, counts, seed):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K13 on each count of `counts` (`sswu_inputs`: 0, one, u
    and -1 where the count reaches them), partial and whole blocks of its
    eight elements."""
    cases = {}
    for n in counts:
        u = sswu_inputs(fp, P, max(n, 4), seed + n)[:n]
        cases[f"sswu_m{n}"] = ([n], lambda u=u: h2c.sswu(u), lambda u=u: h2c.sswu_plain(u),
                               lambda u=u: h2c.sswu_composed(u, tower.KERNEL_TOWER))
    return cases


def iso3_cases(torch, fp, tower, h2c, P, counts, seed):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K14 on SSWU's images of `sswu_inputs` at each count of
    `counts` (partial and whole blocks of its eight elements; from 7 on,
    lane 3 the kernel point X0 and the last lane all p - 1 coordinates),
    and on the kernel point alone and all p - 1 coordinates alone."""
    x0 = fp.const(h2c._X0, DEVICE)
    p1 = torch.from_numpy(fp.int_to_words(P - 1)).to(DEVICE).expand(2, fp.WORDS)
    points = {"iso3_map_kernel_point": (x0[None], h2c.sswu(sswu_inputs(fp, P, 5, seed))[1][4:]),
              "iso3_map_p_minus_1": (p1[None], p1[None])}
    for n in counts:
        x, y = (c.clone() for c in h2c.sswu(sswu_inputs(fp, P, max(n, 4), seed + n)[:n]))
        if n >= 7:
            x[3], x[n - 1], y[n - 1] = x0, p1, p1
        points[f"iso3_map_edge_m{n}"] = (x, y)
    return {name: ([x.shape[0]], lambda x=x, y=y: h2c.iso3_map(x, y), lambda x=x, y=y: h2c.iso3_map_plain(x, y),
                   lambda x=x, y=y: h2c.iso3_map_composed(x, y, tower.KERNEL_TOWER))
            for name, (x, y) in points.items()}


def psi_edge_cases(torch, fp, curve, h2c, P, n: int, seed: int):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K20 on `psi_inputs` of n >= 5 with its infinities and
    words at their edges: row 0 sig at infinity with a finite zsig (row
    2's), row 1 both at infinity, row 3's zsig at infinity under a finite
    sig, row 4 every coordinate of both all p - 1."""
    sig, zsig, _ = psi_inputs(torch, fp, curve, h2c, P, n, seed)
    p1 = torch.from_numpy(fp.int_to_words(P - 1)).to(DEVICE).expand(2, fp.WORDS)
    for c, v in zip(zsig, curve.infinity(curve.FP2, (), DEVICE)):
        c[0], c[3] = c[2], v
    for c in (*sig, *zsig):
        c[4] = p1
    return {f"g2_psi_check_edges_n{n}": ([n], lambda: curve.g2_psi_check(sig, zsig),
                                         lambda: curve.g2_psi_check_plain(sig, zsig),
                                         lambda: curve.g2_psi_check_composed(sig, zsig, curve.FP2))}


def fold_cases(torch, fp, curve, tower, pairing, h2c, P, g1_shapes, g2_lengths, cofactor_m, counts, seed,
               nosum=False):
    """name -> (shape, kernel call, plain version, the composition it
    replaced) for K15-K18: K15 on G1 columns of each (columns, length) in
    `g1_shapes` and K16 on one G2 column of each length in `g2_lengths`
    (`fold_inputs`), K17 on K14's 2-stacked images of `cofactor_m`
    messages (`cofactor_inputs`; with `nosum`, also on q0 alone), K18 on
    each count of Fp12 values in `counts` (`fp12_inputs` without its zero:
    p - 1 in every word slot, one, seeded random values, so that the
    product is no zero) and on `fp12_inputs`' first three values, zero
    among them."""
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
    reduce = {"product_reduce_zero_n3": fp12_inputs(fp, tower, P, 3, seed, DEVICE)}
    for n in counts:  # without the zero row, so that the product is no zero
        fs = fp12_inputs(fp, tower, P, n + 1, seed + n, DEVICE)
        reduce[f"product_reduce_n{n}"] = torch.cat([fs[:1], fs[2:]])
    for name, fs in reduce.items():
        cases[name] = ([fs.shape[0]], lambda fs=fs: pairing.product_reduce(fs),
                       lambda fs=fs: pairing.product_reduce_plain(fs),
                       lambda fs=fs: pairing.product_reduce_composed(fs, tower.KERNEL_TOWER))
    return cases


def glue_cases(torch, fp, curve, tower, pairing, api, h2c, P, fe_inputs, psi_sizes, mi_sizes, seed):
    """(cases, verdicts): name -> (shape, kernel call, plain version, the
    composition it replaced) for K19 on each tensor of `fe_inputs` (name ->
    Fp12 values), K20 on `psi_inputs` of each size in `psi_sizes` and K21
    on `miller_input_points` of each S in `mi_sizes`; and K20's case name ->
    the verdicts its inputs must give."""
    cases, verdicts = {}, {}
    for name, f in fe_inputs.items():
        cases[name] = ([f.shape[0]], lambda f=f: pairing.final_exponentiation(f),
                       lambda f=f: pairing.final_exponentiation_plain(f),
                       lambda f=f: pairing.final_exponentiation_composed(f, tower.KERNEL_TOWER, pairing.pow_abs_x))
    for n in psi_sizes:
        sig, zsig, want = psi_inputs(torch, fp, curve, h2c, P, n, seed + n)
        name = f"g2_psi_check_n{n}"
        cases[name] = ([n], lambda sig=sig, zsig=zsig: curve.g2_psi_check(sig, zsig),
                       lambda sig=sig, zsig=zsig: curve.g2_psi_check_plain(sig, zsig),
                       lambda sig=sig, zsig=zsig: curve.g2_psi_check_composed(sig, zsig, curve.FP2))
        verdicts[name] = want
    for S in mi_sizes:
        pts = miller_input_points(torch, fp, curve, S, seed + S)
        cases[f"miller_inputs_s{S}"] = ([S], lambda pts=pts: api.miller_inputs(*pts),
                                        lambda pts=pts: api.miller_inputs_plain(*pts),
                                        lambda pts=pts: api.miller_inputs_composed(*pts, tower.KERNEL_TOWER))
    return cases, verdicts


def _stacked(out):
    """A kernel's output as one flat int64 tensor of u32 words (the
    tensors of a tuple, a point's coordinates or K21's six outputs,
    concatenated)."""
    import torch

    parts = out if isinstance(out, tuple) else (out,)
    return torch.cat([t.reshape(-1).to(torch.int64) & 0xFFFFFFFF for t in parts])


def max_word_err(got, want) -> int:
    return int((_stacked(got) - _stacked(want)).abs().max())


def check_chain_kernels(torch, cases, verdicts=None) -> None:
    """Each kernel of `cases` (`chain_cases`, `fold_cases`, `glue_cases`)
    bit-identical to its plain version and to the composition it replaced,
    with the edge rows of `curve_inputs`, `scalar_bits`,
    `cyclotomic_inputs`, `miller_inputs`, `sswu_inputs`, `fold_inputs`,
    `cofactor_inputs`, `fp12_inputs`, `psi_inputs` and
    `miller_input_points` (and the isogeny's kernel point), and of
    `affine_cases` and `standalone_cases`; the cases of `verdicts` (name ->
    bools) also give those verdicts."""
    for name, (_, run, plain, composed) in cases.items():
        got = run()
        try:  # a fault in the kernel surfaces here, under its case's name
            torch.cuda.synchronize()
        except RuntimeError as exc:
            raise AssertionError(f"{name}: the kernel faulted: {exc}") from exc
        for label, fn in (("plain version", plain), ("composition replaced", composed)):
            if fn is None:  # K33 replaced no composition
                continue
            want = fn()
            if not torch.equal(_stacked(got), _stacked(want)):
                raise AssertionError(f"{name}: kernel differs from its {label}")
        if verdicts and name in verdicts and got.tolist() != verdicts[name]:
            raise AssertionError(f"{name}: verdicts {got.tolist()}, expected {verdicts[name]}")
    phase("kernels", ok=True, compared=",".join(cases), against="plain,composition")


def check_g1_kernel(torch, api, fp, curve, valid: list[bytes], invalid: list[bytes]) -> None:
    """K5 on the card bit-identical to its plain version, the composed
    g1_in_subgroup on CPU tensors, on K5_POINTS points: valid keys, the
    decodable invalid ones, and infinity rows (the rest, and padding); at
    each of K5_COUNTS, n of those points from the last one back (five
    apart, tiled), so that the invalid ones come first."""
    keys = valid[: K5_POINTS - len(invalid)] + invalid
    pts, _ = api.decompress_public_keys(keys)
    x, y, inf = (torch.from_numpy(a) for a in api.pack_g1_batch(pts))
    xw, yw = fp.from_jax_limbs(x), fp.from_jax_limbs(y)
    want = curve.g1_subgroup_check_plain(xw, yw, inf)
    n_valid = len(keys) - len(invalid)
    assert want.tolist() == [True] * n_valid + [False] * (len(pts) - n_valid), "plain K5 verdicts are wrong"
    m = len(pts)
    for n in K5_COUNTS:
        idx = (m - 1 - 5 * torch.arange(n)) % m
        got = curve.g1_in_subgroup_kernel(xw[idx].to(DEVICE), yw[idx].to(DEVICE), inf[idx].to(DEVICE)).cpu()
        if not torch.equal(got, want[idx]):
            raise AssertionError(f"g1_subgroup_check differs from its plain version at n={n}, rows "
                                 f"{(got != want[idx]).nonzero().flatten()[:8].tolist()}")
    phase("kernels", ok=True, compared="g1_subgroup_check", points=len(pts), g1=n_valid,
          non_g1=int((~inf).sum()) - n_valid, infinity=int(inf.sum()), counts=",".join(map(str, K5_COUNTS)))


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


def time_g1_kernel(torch, api, fp, curve, pk_keys: dict, pk_launches: dict, peak_ops_per_s, log):
    """K5 at both admission shapes (PK_SIZES): device ms per launch
    (profiler), ms per call, the plain version's ms on the same card
    tensors, and the bound, counting only the rows that are not infinity
    (those return at once). The JSON entry is the admission chunk's
    (S = 16,384), with one block's deposits (S = 16) beside it."""
    from lighthouse_tpu_torch.crypto.bls.constants import X

    # [z^2] P as two chains over |z|: per chain bit_length - 1 doublings (6
    # products, 2 squares) and popcount - 1 additions (12); the products by
    # 3b are additions; phi and the comparison 5 products.
    absz = abs(X)
    dbls, adds = 2 * (absz.bit_length() - 1), 2 * (bin(absz).count("1") - 1)
    word_products = (dbls * 6 + adds * 12 + 5) * WORD_PRODUCTS_PER_MUL + dbls * 2 * WORD_PRODUCTS_PER_SQR
    row = None
    for size in PK_SIZES:
        x, y, inf, _ = api.stage_public_keys(pk_keys[size])
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
        live = int((~infd).sum())
        t_ops = live * word_products / peak_ops_per_s * 1e3
        t_bytes = (n * (2 * 48 + 1) + n + 48) / MEM_BYTES_PER_S * 1e3
        phase("timing", kernel="g1_subgroup_check", shape=n, live=live, ms=f"{ms:.5f}",
              ms_per_call=f"{call_ms:.5f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{max(t_ops, t_bytes):.6f}",
              max_abs_err=err, **{k: f'"{v}"' for k, v in ptxas_fields(log, "g1_subgroup_check").items()})
        if err != 0:
            raise AssertionError(f"g1_subgroup_check differs from its plain version at S={n}")
        shape_row = {"shape": [n], "ms": ms, "ms_per_call": call_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        if row is None:
            row = {"name": "g1_subgroup_check", "route": "cuda", "source": G1_SOURCE,
                   "replaces": REPLACES["g1_subgroup_check"], "launches": pk_launches[size]["g1_subgroup_check"],
                   "max_abs_err": err, "library_ms": None, **shape_row, **ptxas_fields(log, "g1_subgroup_check")}
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["at_deposit_shape"] = {**shape_row, "launches": pk_launches[size]["g1_subgroup_check"]}
    return row


def check_extras(torch, fp, tower, P) -> None:
    """fp6_inv, which no registry entry holds (the JAX registry has no
    fp6_inv), over K7 and K25 on 8 elements with a zero one (inv0): on the
    card bit-identical to the same function on CPU tensors, and
    fp6_inv(a) a == 1 but for the zero element."""
    n = 8
    a6 = field_inputs(fp, P, 6 * n, 6, "cpu")[8:].reshape(n, 3, 2, fp.WORDS).clone()
    a6[1] = 0  # inv0: zero maps to zero
    inv = tower.fp6_inv(a6.to(DEVICE))
    if not torch.equal(inv.cpu(), tower.fp6_inv(a6)):
        raise AssertionError("tower.fp6_inv: the card differs from the CPU")
    ones = tower.fp6_mul(a6.to(DEVICE), inv).cpu() == tower.fp6_one((n,), "cpu")
    assert ones.flatten(1).all(dim=1).tolist() == [i != 1 for i in range(n)], "fp6_inv(a) a != 1"
    phase("extras", ok=True, compared="tower.fp6_inv", fp6_inv_elements=n)


def run_verify(torch, api, fp, sets, label: str, card: str):
    """One counted verify (launch counts reset just before, read just after),
    then VERIFY_REPS timed ones, then VERIFY_REPS of its host staging alone
    (`stage_sets`, warm caches: the part of a verify's wall time before
    its first launch). Returns (verdict, launches, ms)."""
    torch.cuda.synchronize()
    fp.reset_launches()
    ok = api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)
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
    return ok, launches, ms


def run_mxu(torch, api, fp, default, bad, pk_keys: list[bytes], pk_want: list[bool], card: str):
    """The verify path with fp.USE_MXU_MUL set, restored afterwards
    whatever happens. For each valid batch of `default` (label -> (sets,
    launches) of the default run): one counted verify, which must launch
    K6 exactly as often as the default run launched K1, K1 never and every
    other kernel as the default run did; then
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
            expected = {**base, "fp_mul": 0, "fp_mul_mma": base["fp_mul"]}
            if launches != expected:
                raise AssertionError(f"mxu {label}: expected the default launches with K6 in K1's place, {expected}, "
                                     f"got {launches}")
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


def profile_verify(torch, api, sets, label: str, warm_ms: float) -> None:
    """Device busy time of one warm verify, from a torch.profiler trace of
    the device's activity only (a trace of every host-side operation of a
    verify is too large to summarise quickly), and the kernels that take
    the most device time. The idle share is taken against `warm_ms`, the
    median wall time of the same verify run without the profiler, which
    inflates the wall time of the verify it traces. The trace must hold
    the runtime calls of the verify's VERIFY_DEVICE_OPS device operations
    and as many device events, or have lost only `head_loss`'s (see
    `traced_device_events`; `lost_device_events` counts them, and the busy
    time then lacks them), each kernel of VERIFY_LAUNCHES as many times as
    the verify launches it."""
    api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    rows, profiled_wall_ms = traced_device_events(lambda: api.verify_signature_sets(sets), VERIFY_DEVICE_OPS)
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    device_calls = sum(r[1] for r in rows)
    top = [{"kernel": k[:60], "ms": round(us / 1e3, 3), "calls": c} for us, c, k in rows[:8]]
    traced = {k: sum(c for _, c, key in rows if f"{k}_kernel" in key) for k in VERIFY_LAUNCHES}
    phase("profile", shape=label, warm_wall_ms=f"{warm_ms:.3f}", profiled_wall_ms=f"{profiled_wall_ms:.1f}",
          device_busy_ms=f"{busy_ms:.3f}", idle_share=f"{1 - busy_ms / warm_ms:.4f}",
          device_calls=device_calls, lost_device_events=VERIFY_DEVICE_OPS - device_calls,
          traced=json.dumps(traced, separators=(",", ":")),
          top=json.dumps(top, separators=(",", ":")))
    if traced != VERIFY_LAUNCHES:
        raise AssertionError(f"profile {label}: the trace holds {traced}, a verify launches {VERIFY_LAUNCHES}")


def time_kernels(torch, fp, tower, P, dev, launches, peak_ops_per_s, log):
    """The field and tower kernels at `OFF_PATH_SHAPES`, and K4 also at
    BATCH_INV_COLUMNS_SHAPE (its JSON entry the first shape's, the second
    beside it as `at_columns_shape`): device time per
    launch (profiler), time per call from the host (CUDA events, launch
    overhead included), the plain version's time, the bound, and the
    largest word difference from the plain version. K6 runs at K1's shape.
    K7 and K8 run in the op or mode of their shape, and the K1/K2
    composition they replaced is timed beside them (`composed_ms`, per
    call). K4's inversion is the kernels' binary GCD; K3 is a general
    power, counted as the power p - 2 on `power_word_products`. K1's, K2's,
    K4's and K8's rows carry ptxas's report (`ptxas_fields`)."""
    results = {}
    pow_inv_word_products = power_word_products(P - 2, WORD_PRODUCTS_PER_MUL, WORD_PRODUCTS_PER_SQR)
    for name, shape in [*OFF_PATH_SHAPES.items(), ("fp_batch_inv", BATCH_INV_COLUMNS_SHAPE)]:
        composed = None
        if name == "fp_batch_inv":
            steps, lanes = shape
            x = field_inputs(fp, P, steps * lanes, 3, dev)[8 : 8 + steps * lanes].reshape(steps, lanes, fp.WORDS)
            run, plain = (lambda: fp.batch_inv(x)), (lambda: fp.batch_inv_plain(x))
            elems = steps * lanes
            ops_s = lanes * batch_inv_word_products(steps) / peak_ops_per_s
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
                ops_s, nbytes = n * pow_inv_word_products / peak_ops_per_s, 2 * 48 * n + 48
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
        row = {
            "name": name, "route": "cuda", "source": SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": list(shape) if isinstance(shape, tuple) else [shape],
            "ms_per_call": call_ms, **extra, **ptxas_fields(log, name),
        }
        if name in results:  # K4's columns shape, beside its first
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            results[name]["at_columns_shape"] = {k: row[k] for k in ("shape", "ms", "ms_per_call", "plain_ms",
                                                                     "bound_ms", "bound_by")}
        else:
            results[name] = row
        phase("timing", kernel=name, shape=shape, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.3f}", bound_ms=f"{max(t_ops, t_bytes):.6f}", max_abs_err=err,
              **{k: f"{v:.5f}" for k, v in extra.items()},
              **{k: f'"{v}"' for k, v in ptxas_fields(log, name).items()})
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version at shape {shape}")
    return list(results.values())


def time_chain_kernels(torch, fp, P, cases, launches, peak_ops_per_s, log):
    """K9-K21 at the verify path's shapes (`chain_cases`): device ms per
    launch (profiler), ms per call (CUDA events), the plain version's and
    the composition's ms per call, and the bound. K11 runs at two shapes
    (the signatures' 64 bits; the cofactor clearing's 128, which K17 now
    runs): its JSON entry is the first, with the second beside it. K17's
    and K19's rows carry ptxas's report (`ptxas_fields`)."""
    S = N_SETS
    bounds = {  # case -> (kernel, word products, bytes: points in and out, bits read once)
        "g1_scalar_mul_n128_b64": ("g1_scalar_mul",
                                   S * scalar_mul_word_products(64, WORD_PRODUCTS_PER_MUL, WORD_PRODUCTS_PER_SQR),
                                   S * (288 + 64 * 4)),
        "g2_scalar_mul_n256_b64": ("g2_scalar_mul", 2 * S * scalar_mul_word_products(64, FP2_MUL_WP, FP2_SQR_WP),
                                   2 * S * (576 + 64 * 4)),
        "g2_scalar_mul_2x128_b128": ("g2_scalar_mul", 2 * S * scalar_mul_word_products(128, FP2_MUL_WP, FP2_SQR_WP),
                                     2 * S * 576 + 2 * 128 * 8),
        "cyclotomic_pow_x_n1": ("cyclotomic_pow_x", K9_WORD_PRODUCTS_BUT_POWER + inversion_word_products(), K9_BYTES),
        f"miller_loop_n{S + 1}": ("miller_loop", (S + 1) * K12_WORD_PRODUCTS, (S + 1) * K12_BYTES + 6 * 48),
        f"sswu_m{2 * S}": ("sswu", 2 * S * h2c_word_products(P)[0], 2 * S * K13_BYTES + H2C_CONST_BYTES),
        f"iso3_map_m{2 * S + 1}": ("iso3_map", (2 * S + 1) * h2c_word_products(P)[1],
                                   (2 * S + 1) * K14_BYTES + H2C_CONST_BYTES),
        f"g1_tree_sum_{S}x{BLOCK_KEYS}": ("g1_tree_sum", S * (BLOCK_KEYS - 1) * G1_ADD_WP,
                                          S * (BLOCK_KEYS + 1) * 3 * 48),
        f"g2_tree_sum_{S}": ("g2_tree_sum", (S - 1) * G2_ADD_WP, (S + 1) * 3 * 96),
        f"clear_cofactor_m{S}": ("clear_cofactor", S * k17_word_products(), S * K17_BYTES + K17_CONST_BYTES),
        f"product_reduce_n{S + 1}": ("product_reduce", S * FP12_MUL_WP, (S + 2) * 576),
        "final_exponentiation_n1": ("final_exponentiation", k19_word_products(), K19_BYTES),
        f"g2_psi_check_n{S}": ("g2_psi_check", S * 6 * FP2_MUL_WP, S * K20_BYTES + K20_CONST_BYTES),
        f"miller_inputs_s{S}": ("miller_inputs", k21_word_products(S),
                                S * K21_BYTES_PER_SET + (S + 1) * K21_BYTES_PER_LANE + K21_CONST_BYTES),
    }
    rows = {}
    for case, (name, ops, nbytes) in bounds.items():
        shape, run, plain, composed = cases[case]
        saved = dict(fp.LAUNCHES)  # comparison launches are not main-path launches
        err = max_word_err(run(), plain())
        call_ms = cuda_ms(run, 5)
        ms = kernel_device_ms(run, 5, f"{name}_kernel")
        plain_ms, composed_ms = cuda_ms(plain, 1), cuda_ms(composed, 2)
        fp.LAUNCHES.update(saved)
        t_ops, t_bytes = ops / peak_ops_per_s * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": shape, "ms_per_call": call_ms, "composed_ms": composed_ms,
            **ptxas_fields(log, name),
        }
        phase("timing", kernel=name, shape=shape, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.3f}", composed_ms=f"{composed_ms:.3f}", bound_ms=f"{row['bound_ms']:.6f}",
              word_products=ops, launches=launches[name], max_abs_err=err,
              **{k: f'"{v}"' for k, v in ptxas_fields(log, name).items()})
        if err != 0:
            raise AssertionError(f"{case}: kernel differs from its plain version")
        if name in rows:
            rows[name]["at_cofactor_shape"] = {k: row[k] for k in ("shape", "ms", "ms_per_call", "plain_ms",
                                                                  "composed_ms", "bound_ms", "bound_by")}
        else:
            rows[name] = row
    return list(rows.values())


def time_tree_levels(torch, fp, curve) -> None:
    """K16 on one G2 column and K15 on N_SETS G1 columns of each length in
    TREE_LEVEL_LENGTHS (`fold_inputs`): device ms per launch (profiler),
    one `[tree_levels]` line a kernel. These launches are not main-path
    launches."""
    for group, F, columns, axis in (("g2", curve.FP2, 1, 0), ("g1", curve.FP, N_SETS, 1)):
        saved = dict(fp.LAUNCHES)
        ms = []
        for length in TREE_LEVEL_LENGTHS:
            pts = fold_inputs(torch, fp, curve, group, length, columns, 50 + length)
            ms.append(kernel_device_ms(lambda: curve.tree_sum(F, pts, axis), 5, f"{group}_tree_sum_kernel"))
        fp.LAUNCHES.update(saved)
        phase("tree_levels", kernel=f"{group}_tree_sum", columns=columns,
              lengths=",".join(map(str, TREE_LEVEL_LENGTHS)), ms=",".join(f"{t:.5f}" for t in ms))


def time_reduce_levels(torch, fp, tower, pairing, P) -> None:
    """K18 on `fp12_inputs` of each count in REDUCE_LEVEL_COUNTS: device ms
    per launch (profiler), one `[reduce_levels]` line. 1 is a copy (one
    block); 2, 4 and 8 the cluster hand-off (two cluster barriers, the
    partials read across the cluster) and one, two and three fold levels;
    9 a block level more than 8; the rest a level more each. These
    launches are not main-path launches."""
    saved = dict(fp.LAUNCHES)
    ms = []
    for n in REDUCE_LEVEL_COUNTS:
        fs = fp12_inputs(fp, tower, P, n, 53 + n, DEVICE)
        ms.append(kernel_device_ms(lambda fs=fs: pairing.product_reduce(fs), 5, "product_reduce_kernel"))
    fp.LAUNCHES.update(saved)
    phase("reduce_levels", kernel="product_reduce", counts=",".join(map(str, REDUCE_LEVEL_COUNTS)),
          ms=",".join(f"{t:.5f}" for t in ms))


def offpath_timed(torch, fp, curve, tower, pairing, h2c, P):
    """K22-K33 at their `[timing]` shapes, off the verify path:
    [(kernel, (shape, run, plain, composed), word products, bytes)]."""
    ops = affine_word_products()
    nbytes = {"g1_to_affine": K22_BYTES, "g2_to_affine": K23_BYTES, "fp6_mul": K24_BYTES, "fp2_inv": K25_BYTES}
    timed = []
    for name, n in AFFINE_SHAPES.items():
        case = affine_cases(torch, fp, curve, tower, P, {name: (n,)}, 51)[f"{name}_n{n}"]
        timed.append((name, case, n * ops[name], n * nbytes[name]))
    for name, n in STANDALONE_SHAPES.items():
        cases, work = standalone_cases(torch, fp, curve, tower, pairing, h2c, P, {name: (n,)}, 52)
        timed.append((name, cases[f"{name}_n{n}"], *work[f"{name}_n{n}"]))
    return timed


def time_offpath_kernels(torch, fp, timed, launches_verify, peak_ops_per_s, log):
    """K22-K33 (`offpath_timed`): device ms per launch (profiler), ms per
    call (CUDA events), the plain version's and the composition's ms per
    call (None for K33, which replaced none), the bound, and the launches
    of one verify as the `[verify]` run counted them (0). The rows'
    `launches` are set from the `[registry]` walk; K22's carries ptxas's
    report (`ptxas_fields`)."""
    rows = []
    for name, (shape, run, plain, composed), ops, nbytes in timed:
        saved = dict(fp.LAUNCHES)  # comparison launches are not main-path launches
        err = max_word_err(run(), plain())
        if composed is not None and not torch.equal(_stacked(run()), _stacked(composed())):
            raise AssertionError(f"{name}: kernel differs from the composition replaced at {shape}")
        call_ms = cuda_ms(run, 20)
        ms = kernel_device_ms(run, 20, f"{name}_kernel")
        plain_ms = cuda_ms(plain, 1)
        composed_ms = cuda_ms(composed, 3) if composed is not None else None
        fp.LAUNCHES.update(saved)
        t_ops, t_bytes = ops / peak_ops_per_s * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None, "shape": shape,
            "ms_per_call": call_ms, "composed_ms": composed_ms, "launches_per_verify": launches_verify[name],
            "launches_path": "registry", **ptxas_fields(log, name),
        }
        phase("timing", kernel=name, shape=shape, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.3f}", composed_ms="none" if composed_ms is None else f"{composed_ms:.3f}",
              bound_ms=f"{row['bound_ms']:.6f}", word_products=ops, launches_per_verify=launches_verify[name],
              max_abs_err=err, **{k: f'"{v}"' for k, v in ptxas_fields(log, name).items()})
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version at {shape}")
        rows.append(row)
    return rows


def _one_rank_group(dist):
    """A gloo process group of one rank on this host, for the registry's
    sharded entry."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    dist.init_process_group("gloo", init_method=addr, world_size=1, rank=0)


def run_registry(torch, fp, registry, dev) -> dict:
    """[registry]: every entry of the port's kernel registry
    (torch_backend/registry.py: the JAX registry's 38 names, SSWU and the
    three launch entry points) called once on the card at its example
    shape. Every entry must be a "kernel" entry (a hand-written kernel of
    its own) or a "path" entry, and declare its launches. The launch
    counts are set to 0 just before the walk and read just after it; each
    entry's own launches must equal its declared counts, and the output of
    a "kernel" entry must be bit-identical to its plain version on CPU
    tensors (but the big composites of `HELD_IN_KERNELS`, which
    `[kernels]` holds). The sharded entry runs in a one-rank gloo group
    made for it. Returns the walk's launches."""
    import torch.distributed as dist

    mismatches, held = [], 0
    for e in registry.entries():
        if e.kind not in ("kernel", "path") or not e.launches or (e.plain is None) != (e.kind == "path"):
            mismatches.append(f"{e.name}: kind {e.kind}, launches {e.launches}, plain {e.plain}")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    fp.reset_launches()
    for i, e in enumerate(registry.entries()):
        cpu_args = e.example(100 + i)
        args = registry.to_device(cpu_args, dev)
        before = dict(fp.LAUNCHES)
        if e.needs_group:
            _one_rank_group(dist)
            try:
                out = e.fn(*args)
            finally:
                dist.destroy_process_group()
        else:
            out = e.fn(*args)
        torch.cuda.synchronize()
        got = {k: fp.LAUNCHES[k] - before[k] for k in fp.KERNELS if fp.LAUNCHES[k] != before[k]}
        if got != e.launches:
            mismatches.append(f"{e.name}: launched {got}, declared {e.launches}")
        if e.kind == "kernel" and e.name not in HELD_IN_KERNELS:
            held += 1
            if not torch.equal(_stacked(out).cpu(), _stacked(e.plain(*cpu_args))):
                mismatches.append(f"{e.name}: differs from its plain version")
    launches = dict(fp.LAUNCHES)
    kinds = {k: sum(e.kind == k for e in registry.entries()) for k in registry.KINDS}
    phase("registry", ok=not mismatches, entries=len(registry.entries()),
          kinds=json.dumps(kinds, separators=(",", ":")), held_to_plain=held, mismatches=json.dumps(mismatches), seconds=f"{time.perf_counter() - t0:.1f}",
          launches=json.dumps(launches, separators=(",", ":")))
    if mismatches:
        raise AssertionError(f"registry: {len(mismatches)} entries differ: {mismatches}")
    missing = [k for k in fp.KERNELS if launches[k] <= 0]
    assert not missing, f"kernels not launched by the registry walk: {missing}"
    return launches


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


def block_sets(signed) -> int:
    """Signature sets one phase0 block carries: proposal, RANDAO, one a
    slashing, attestation and exit (deposits verify alone, and the
    harness makes none)."""
    body = signed.message.body
    assert not body.deposits, "the chain phase counts no deposit signatures"
    return (2 + 2 * len(body.proposer_slashings) + 2 * len(body.attester_slashings) + len(body.attestations)
            + len(body.voluntary_exits))


def run_chain(torch, api, fp, card: str):
    """Block import on the card; see the module docstring. Every verify is
    one `api.verify_staged` call, recorded with its (S, K) by a wrapper
    that is removed afterwards whatever happens. Returns chain A's harness,
    which `[gossip]` goes on with."""
    from lighthouse_tpu_torch.chain import BeaconChain, BeaconChainHarness, BlockError, ManualSlotClock
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.state_transition import TransitionContext

    ctx = TransitionContext.minimal()
    assert ctx.bls is api, f"TransitionContext.minimal() runs on {ctx.bls.__name__}, not the card's backend"
    staged_shapes = []
    verify_staged = api.verify_staged

    def recorded(flat, S, K):
        staged_shapes.append((S, K))
        return verify_staged(flat, S, K)

    def counted(fn):
        """fn() with the launch counts set to 0 just before it and read just
        after: (its value or the BlockError it raised, launches, the (S, K)
        of each verify, the sets verified, the verifies' seconds, wall ms)."""
        del staged_shapes[:]
        sets0, secs0, calls0 = metrics.BLS_SETS_TOTAL.value, metrics.BLS_BATCH_SECONDS.sum, \
            metrics.BLS_BATCH_SECONDS.count
        torch.cuda.synchronize()
        fp.reset_launches()
        t0 = time.perf_counter()
        try:
            out = fn()
        except BlockError as e:
            out = e
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fp.LAUNCHES)
        assert metrics.BLS_BATCH_SECONDS.count - calls0 == len(staged_shapes), "a verify was not staged once"
        return (out, launches, list(staged_shapes), int(metrics.BLS_SETS_TOTAL.value - sets0),
                metrics.BLS_BATCH_SECONDS.sum - secs0, wall_ms)

    validators, slots, segment = CHAIN_VALIDATORS, CHAIN_SLOTS, CHAIN_SEGMENT

    def per_verify(launches, n):
        counts = {k: launches[k] for k in VERIFY_LAUNCHES}
        want = {k: v * n for k, v in VERIFY_LAUNCHES.items()}
        assert counts == want, f"{n} verifies launched {counts}, expected {want}"
        return json.dumps(launches, separators=(",", ":"))

    sets_total0 = metrics.BLS_SETS_TOTAL.value
    expected_sets = 0
    api.verify_staged = recorded
    try:
        t0 = time.perf_counter()
        harness = BeaconChainHarness(validators, ctx)
        setup_s = time.perf_counter() - t0
        chain_a = harness.chain
        genesis = chain_a.store.get_state(chain_a.genesis_block_root).copy()
        # each import's wall ms: the first blocks also fill the pubkey cache
        # (a ref decompression with the subgroup check a validator)
        import_ms, process_block = [], chain_a.process_block

        def timed_import(*args, **kwargs):
            t = time.perf_counter()
            try:
                return process_block(*args, **kwargs)
            finally:
                import_ms.append((time.perf_counter() - t) * 1e3)

        chain_a.process_block = timed_import
        import0, nimport0 = metrics.BLOCK_IMPORT_SECONDS.sum, metrics.BLOCK_IMPORT_SECONDS.count
        head_a, launches, shapes, nsets, verify_s, wall_ms = counted(lambda: harness.extend_chain(slots))
        assert not isinstance(head_a, BlockError), f"chain A: {head_a}"
        import_s = metrics.BLOCK_IMPORT_SECONDS.sum - import0
        nimports = metrics.BLOCK_IMPORT_SECONDS.count - nimport0
        assert nimports == slots == len(import_ms), "chain A: not one import a slot"
        blocks, root = [], head_a
        while root != chain_a.genesis_block_root:
            blocks.append(chain_a.store.get_block(root))
            root = bytes(blocks[-1].message.parent_root)
        blocks.reverse()
        assert [int(b.message.slot) for b in blocks] == list(range(1, slots + 1)), "chain A: a slot has no block"
        per_block = [block_sets(b) for b in blocks]
        expected_sets += sum(per_block)
        assert nsets == sum(per_block), f"chain A verified {nsets} sets, its blocks carry {sum(per_block)}"
        assert len(shapes) == slots, f"chain A: {len(shapes)} verifies for {slots} blocks"
        fin, just = harness.finalized_epoch(), harness.justified_epoch()
        assert fin >= CHAIN_MIN_FINALIZED, f"chain A finalized only epoch {fin}"
        phase("chain", step="A", validators=validators, blocks=slots, verify_calls=len(shapes),
              sets=nsets, sets_per_block=json.dumps(dict(sorted(collections.Counter(per_block).items())),
                                                    separators=(",", ":")),
              shapes=json.dumps(sorted(set(shapes)), separators=(",", ":")), finalized_epoch=fin,
              justified_epoch=just, setup_s=f"{setup_s:.2f}", sign_and_produce_s=f"{wall_ms / 1e3 - import_s:.2f}",
              import_s=f"{import_s:.3f}", ms_per_import=f"{import_s / slots * 1e3:.3f}",
              import_ms_median=f"{statistics.median(import_ms):.3f}", import_ms_max=f"{max(import_ms):.3f}",
              verify_ms_per_import=f"{verify_s / slots * 1e3:.3f}", launches=per_verify(launches, slots),
              card=f'"{card}"')

        chain_b = BeaconChain(genesis, ctx, slot_clock=ManualSlotClock())
        chain_b.slot_clock.set_slot(slots)
        seg = blocks[:segment]
        roots, launches, shapes, nsets, verify_s, wall_ms = counted(lambda: chain_b.process_chain_segment(seg))
        assert not isinstance(roots, BlockError), f"chain B: {roots}"
        want_sets = sum(per_block[:segment])
        expected_sets += want_sets
        assert nsets == want_sets and len(shapes) == 1, f"chain B: {len(shapes)} verifies of {nsets} sets"
        S, K = shapes[0]
        assert (S, K) == (api._next_pow2(want_sets), 4), f"chain B staged {S} x {K}"
        root_a = type(seg[-1].message).hash_tree_root(seg[-1].message)
        assert chain_b.head_root == root_a and roots[-1] == root_a, "chain B's head is not chain A's block"
        phase("chain", step="B_segment", blocks=len(seg), sets=nsets, S=S, K=K, result=True,
              segment_ms=f"{wall_ms:.3f}", verify_ms=f"{verify_s * 1e3:.3f}", head_equal=True,
              launches=per_verify(launches, 1), card=f'"{card}"')

        # reject 1: the rest of chain A, its last block made again on the
        # same parent with one aggregate's signature replaced by another
        # aggregate's (well-formed, in G2) and signed by its proposer, so
        # that only that aggregate is wrong
        rest = blocks[segment:]
        last = rest[-1].message
        atts = list(last.body.attestations)
        assert len(atts) >= 2 and bytes(atts[0].signature) != bytes(atts[1].signature)
        atts[0] = ctx.types.Attestation(aggregation_bits=list(atts[0].aggregation_bits), data=atts[0].data,
                                        signature=bytes(atts[1].signature))
        parent = chain_a.store.get_state(bytes(last.parent_root)).copy()
        block, _ = chain_a.produce_block_on_state(parent, int(last.slot), bytes(last.body.randao_reveal),
                                                  attestations=atts, graffiti=bytes(last.body.graffiti))
        bad = rest[:-1] + [chain_a.sign_block(block, harness.keypairs[int(last.proposer_index)][0])]
        head_b = chain_b.head_root
        err, launches, shapes, nsets, verify_s, wall_ms = counted(lambda: chain_b.process_chain_segment(bad))
        expected_sets += nsets
        assert isinstance(err, BlockError) and "signature" in str(err), f"tampered segment: {err!r}"
        assert nsets == sum(per_block[segment:]) and len(shapes) == 1, "tampered segment: not one verify"
        assert chain_b.head_root == head_b, "a refused segment moved the head"
        assert all(chain_b.store.get_block(type(b.message).hash_tree_root(b.message)) is None for b in bad)
        phase("chain", step="reject_segment", blocks=len(bad), sets=nsets, S=shapes[0][0], K=shapes[0][1],
              refused=f'"{err}"', head_unchanged=True, verify_ms=f"{verify_s * 1e3:.3f}",
              launches=per_verify(launches, 1), card=f'"{card}"')

        # reject 2: the next block, its proposal signed by another validator
        nxt = rest[0]
        forger = (int(nxt.message.proposer_index) + 1) % validators
        forged = chain_a.sign_block(nxt.message, harness.keypairs[forger][0])
        assert bytes(forged.signature) != bytes(nxt.signature)
        err, launches, shapes, nsets, verify_s, wall_ms = counted(lambda: chain_b.process_block(forged))
        expected_sets += nsets
        assert isinstance(err, BlockError), f"a block signed by validator {forger} was imported"
        assert nsets == block_sets(nxt) and len(shapes) == 1, "forged proposal: not one verify"
        assert chain_b.head_root == head_b, "a refused block moved the head"
        phase("chain", step="reject_proposer", slot=int(nxt.message.slot), signer=forger,
              proposer=int(nxt.message.proposer_index), sets=nsets, refused=f'"{err}"', head_unchanged=True,
              verify_ms=f"{verify_s * 1e3:.3f}", launches=per_verify(launches, 1), card=f'"{card}"')

        # the genuine rest, as one segment: chain B reaches chain A's head
        roots, launches, shapes, nsets, verify_s, wall_ms = counted(lambda: chain_b.process_chain_segment(rest))
        assert not isinstance(roots, BlockError), f"chain B, the rest: {roots}"
        expected_sets += nsets
        assert chain_b.head_root == head_a, "chain B did not reach chain A's head"
        phase("chain", step="B_rest", blocks=len(rest), sets=nsets, S=shapes[0][0], K=shapes[0][1],
              head_equal=True, segment_ms=f"{wall_ms:.3f}", verify_ms=f"{verify_s * 1e3:.3f}",
              launches=per_verify(launches, 1), card=f'"{card}"')
    finally:
        api.verify_staged = verify_staged
    grown = int(metrics.BLS_SETS_TOTAL.value - sets_total0)
    assert grown == expected_sets, f"{metrics.BLS_SETS_TOTAL.name} grew by {grown}, {expected_sets} sets verified"
    phase("chain", step="metrics", metric=metrics.BLS_SETS_TOTAL.name, grown=grown,
          sets_verified=expected_sets, card=f'"{card}"')
    return harness


def run_conformance(torch, api, fp, card: str) -> None:
    """The port's BLS conformance cases on the card; see the module
    docstring. A case's verifies are counted by the sync verify's timer
    (`lighthouse_tpu_bls_batch_verify_seconds`), its launches by the
    kernels' counts set to 0 just before the case and read just after."""
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.conformance import ALL_CASE_TYPES, generate_bls_cases, run_case
    from lighthouse_tpu_torch.crypto.bls import batch_verifier as bv

    assert bv.active_for(api) is None, "a coalescer still runs over the card's backend"
    t0 = time.perf_counter()
    cases = generate_bls_cases()
    generate_s = time.perf_counter() - t0
    assert len(cases) == CONFORMANCE_CASES, f"{len(cases)} conformance cases, expected {CONFORMANCE_CASES}"
    rows = {t: {"cases": 0, "verify_cases": 0, "verifies": 0, "ms": 0.0, "launches": collections.Counter()}
            for t in ALL_CASE_TYPES}
    admission = 0
    t0 = time.perf_counter()
    for case in cases:
        row = rows[case.case_type]
        calls0 = metrics.BLS_BATCH_SECONDS.count
        torch.cuda.synchronize()
        fp.reset_launches()
        t = time.perf_counter()
        run_case(case, api)  # raises on an outcome other than the expected one
        torch.cuda.synchronize()
        row["ms"] += (time.perf_counter() - t) * 1e3
        launches = dict(fp.LAUNCHES)
        calls = metrics.BLS_BATCH_SECONDS.count - calls0
        counts = {k: launches[k] for k in VERIFY_LAUNCHES}
        want = {k: v * calls for k, v in VERIFY_LAUNCHES.items()}
        assert calls <= 1 and counts == want, f"{case.name}: {calls} verifies launched {counts}, expected {want}"
        admission += launches["g1_subgroup_check"]
        row["cases"] += 1
        row["verify_cases"] += int(calls > 0)
        row["verifies"] += calls
        row["launches"].update({k: n for k, n in launches.items() if n})
    cases_s = time.perf_counter() - t0
    for case_type, row in rows.items():
        phase("conformance", case_type=case_type, cases=row["cases"], verify_cases=row["verify_cases"],
              host_decided=row["cases"] - row["verify_cases"], verifies=row["verifies"], ms=f"{row['ms']:.3f}",
              launches=json.dumps(dict(sorted(row["launches"].items())), separators=(",", ":")), card=f'"{card}"')
    phase("conformance", cases=len(cases), expected_outcomes=len(cases),
          verify_cases=sum(r["verify_cases"] for r in rows.values()), k5_launches=admission,
          generate_s=f"{generate_s:.2f}", cases_s=f"{cases_s:.2f}", card=f'"{card}"')


def node_stand_in(chain, processor):
    """What `network.NetworkService` reads of a node (the port has no
    client yet): the chain, its context, an op pool and a processor, no
    slasher, and no HTTP API (only sync-committee gossip reaches it)."""
    from lighthouse_tpu_torch.op_pool import OperationPool

    return types.SimpleNamespace(chain=chain, ctx=chain.ctx, op_pool=OperationPool(chain.ctx), processor=processor,
                                 slasher=None, api=None)


def slot_tick(node, service, slot: int) -> None:
    """A node's slot tick (the JAX client's `per_slot_task`, with no
    slasher): the clock, fork choice's tick, then the service's drain."""
    node.chain.slot_clock.set_slot(slot)
    node.chain.fork_choice.on_tick(slot)
    service.process_pending()


def run_gossip(torch, api, fp, card: str, harness) -> None:
    """The gossip path on the card over chain A; see the module docstring.
    A peer publishes every item over a `LocalNetwork` to node A's
    `NetworkService`, which admits it (`on_gossip`) and drains it
    (`process_pending`) at each slot tick. The service's verifier and
    aggregate check are wrapped to record each verdict as it is routed,
    and unwrapped afterwards whatever happens."""
    from lighthouse_tpu_torch.chain.attestation_processing import AttestationError
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.crypto.bls import batch_verifier as bv
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.network import LocalNetwork, NetworkService, Topic
    from lighthouse_tpu_torch.network import service as network_service
    from lighthouse_tpu_torch.scheduler import BeaconProcessor
    from lighthouse_tpu_torch.state_transition.helpers import get_beacon_committee, get_committee_count_per_slot
    from lighthouse_tpu_torch.state_transition.signature_sets import _signing_root_for_uint64
    from lighthouse_tpu_torch.types import compute_signing_root, get_domain, schedule_domain
    from lighthouse_tpu_torch.types.containers import Checkpoint

    chain, ctx = harness.chain, harness.ctx
    assert ctx.bls is api, f"chain A runs on {ctx.bls.__name__}, not the card's backend"
    t, preset, spec = ctx.types, ctx.preset, ctx.spec
    spe = preset.slots_per_epoch
    state, head = chain.head_state(), bytes(chain.head_root)
    epoch = int(state.slot) // spe
    assert int(state.slot) == epoch * spe, "the gossip epoch starts at the head's slot"
    clock = (epoch + 1) * spe - 1  # every slot of the epoch inside the gossip window
    secret = [int(kp[0].k) for kp in harness.keypairs]
    gvr = bytes(state.genesis_validators_root)
    root_type = t.AttestationData.hash_tree_root

    def data_at(slot: int, index: int, target_epoch: int = epoch):
        return t.AttestationData(slot=slot, index=index, beacon_block_root=head,
                                 source=state.current_justified_checkpoint,
                                 target=Checkpoint(epoch=target_epoch, root=head))

    def att_root(data, target_epoch: int = epoch) -> bytes:
        return compute_signing_root(data, get_domain(state, spec.domain_beacon_attester, target_epoch, preset))

    def selection_root(slot: int) -> bytes:
        return _signing_root_for_uint64(slot, schedule_domain(spec, spec.domain_selection_proof, slot // spe, gvr))

    # the epoch's duties: every validator once, in one committee of one slot
    duties = [(slot, index, list(get_beacon_committee(state, slot, index, preset, spec)))
              for slot in range(epoch * spe, clock + 1)
              for index in range(get_committee_count_per_slot(state, epoch, preset))]
    assert sorted(v for _, _, c in duties for v in c) == list(range(len(secret))), "not one duty a validator"
    early_committee = list(get_beacon_committee(state, clock + 1, 0, preset, spec))
    early_data = data_at(clock + 1, 0, epoch + 1)

    t0 = time.perf_counter()
    tasks = [(secret[v], att_root(data_at(slot, index))) for slot, index, c in duties for v in c]
    tasks += [(secret[c[0]], selection_root(slot)) for slot, _, c in duties]
    tasks += [(sum(secret[v] for v in c) % R, att_root(data_at(slot, index))) for slot, index, c in duties]
    tasks += [(secret[duties[0][2][0]], selection_root(duties[0][0])),  # for another aggregator's proof
              (secret[early_committee[0]], att_root(early_data, epoch + 1))]
    with host_pool() as pool:
        sigs = iter(pool.map(sign_root, tasks))
        single = {(slot, index, j): next(sigs) for slot, index, c in duties for j in range(len(c))}
        proofs = [next(sigs) for _ in duties]
        inner = [next(sigs) for _ in duties]
        stolen_proof, early_sig = next(sigs), next(sigs)
        messages = [t.AggregateAndProof(aggregator_index=c[0], selection_proof=proof,
                                        aggregate=t.Attestation(aggregation_bits=[True] * len(c),
                                                                data=data_at(slot, index), signature=sig))
                    for (slot, index, c), proof, sig in zip(duties, proofs, inner)]
        slot0, index0, c0 = duties[0]
        messages.append(t.AggregateAndProof(aggregator_index=c0[1], selection_proof=stolen_proof,
                                            aggregate=messages[0].aggregate))
        outer = pool.map(sign_root, [
            (secret[m.aggregator_index],
             compute_signing_root(m, schedule_domain(spec, spec.domain_aggregate_and_proof, epoch, gvr)))
            for m in messages])
    sign_s = time.perf_counter() - t0

    def one_bit(slot, index, c, j, sig):
        return t.Attestation(aggregation_bits=[i == j for i in range(len(c))], data=data_at(slot, index),
                             signature=sig)

    unagg = {c[j]: one_bit(slot, index, c, j, single[(slot, index, j)])
             for slot, index, c in duties for j in range(len(c))}
    aggregates = [t.SignedAggregateAndProof(message=m, signature=s) for m, s in zip(messages, outer)]
    victim = c0[0]  # its attestation arrives first with another member's signature, then genuine
    hostile = {
        "tampered_signature": one_bit(slot0, index0, c0, 0, single[(slot0, index0, 1)]),
        "unknown_head": t.Attestation(aggregation_bits=list(unagg[c0[1]].aggregation_bits),
                                      data=t.AttestationData(slot=slot0, index=index0, beacon_block_root=b"\xfe" * 32,
                                                             source=state.current_justified_checkpoint,
                                                             target=Checkpoint(epoch=epoch, root=head)),
                                      signature=single[(slot0, index0, 1)]),
        "future_slot": t.Attestation(aggregation_bits=[i == 0 for i in range(len(early_committee))],
                                     data=early_data, signature=early_sig),
        "bad_selection_proof": aggregates.pop(),
        "duplicate": t.Attestation.deserialize(t.Attestation.serialize(unagg[duties[-1][2][-1]])),
        "wrong_container": t.Attestation(aggregation_bits=[True] * len(c0), data=data_at(slot0, index0),
                                         signature=b"\xc0" + bytes(95)),
    }
    batch_a = [a for v, a in sorted(unagg.items()) if v != victim] + [hostile["tampered_signature"]]
    invalid = AttestationError("invalid signature")
    expect = {id(a): True for a in batch_a}
    expect.update({id(a): True for a in aggregates})
    expect[id(unagg[victim])] = True
    expect[id(hostile["tampered_signature"])] = invalid
    expect[id(hostile["bad_selection_proof"])] = invalid
    expect[id(hostile["duplicate"])] = AttestationError("prior attestation known")
    expect[id(hostile["unknown_head"])] = AttestationError("unknown head block")
    expect[id(hostile["future_slot"])] = AttestationError("future slot")

    recorder = chain.flight_recorder
    got, agg_ms, depth, released = [], [], [0], []
    verifier_cls, verify_aggregates = network_service.PipelinedGossipVerifier, \
        network_service.batch_verify_gossip_aggregates

    class RecordedVerifier(verifier_cls):
        """The service's attestation verifier, each verdict recorded as the
        service routes it."""

        def flush(self, route):
            return super().flush(lambda att, ok: (got.append((att, ok)), route(att, ok)))

    def recorded_aggregates(chain_, items):
        t1 = time.perf_counter()
        try:
            results = verify_aggregates(chain_, items)
        finally:
            agg_ms.append((time.perf_counter() - t1) * 1e3)
        got.extend(zip(items, results))
        return results

    sizes, submissions = [], []
    dispatch = api.verify_signature_sets_async

    def recorded(batch, rng=None):
        sizes.append(len(batch))
        return dispatch(batch, rng=rng)

    sets0, dropped0 = metrics.BLS_SETS_TOTAL.value, metrics.PROCESSOR_ITEMS_DROPPED.value
    bisect0 = metrics.BLS_BISECTION_DISPATCHES_TOTAL.value
    net = LocalNetwork()
    svc = bv.ensure_running(api)
    try:
        assert svc is not None and svc.s_bucket == bv.DEFAULT_S_BUCKET, "the coalescer is not the card backend's"
        real_submit = svc.submit

        def submit(sets, corr_meta=None):
            fut = real_submit(sets, corr_meta=corr_meta)
            submissions.append((list(sets), fut))
            return fut

        svc.submit = submit
        api.verify_signature_sets_async = recorded
        network_service.PipelinedGossipVerifier = RecordedVerifier
        network_service.batch_verify_gossip_aggregates = recorded_aggregates
        node = node_stand_in(chain, BeaconProcessor(coalescer=svc))
        aserv = NetworkService("A", node, net)
        peer = NetworkService("P", types.SimpleNamespace(), net)  # publishes only: no chain of its own
        reprocess, on_slot = aserv.reprocess, aserv.reprocess.on_slot

        def recorded_on_slot(slot):
            out = on_slot(slot)
            released.extend(out)
            return out

        reprocess.on_slot = recorded_on_slot

        def publish(items, send) -> None:
            for item in items:
                send(item)  # NetworkService.on_gossip admits it with a flight-recorder id
                depth[0] = max(depth[0], int(metrics.PROCESSOR_QUEUE_DEPTH.value))

        def tick(slot: int) -> float:
            t1 = time.perf_counter()
            slot_tick(node, aserv, slot)
            assert metrics.PROCESSOR_QUEUE_DEPTH.value == 0 and len(node.processor) == 0, "work left queued"
            return (time.perf_counter() - t1) * 1e3

        torch.cuda.synchronize()
        fp.reset_launches()
        dispatches0 = svc.dispatches
        t0 = time.perf_counter()
        # cycle 1, two ticks at the epoch's last slot: the epoch's gossip
        # with hostile items among it, then the victim's genuine attestation,
        # a duplicate of an accepted one and a wrong container
        publish(batch_a + [hostile["unknown_head"], hostile["future_slot"]], peer.publish_attestation)
        publish(aggregates + [hostile["bad_selection_proof"]], peer.publish_aggregate)
        tick_ms = tick(clock)
        publish([unagg[victim], hostile["duplicate"]], peer.publish_attestation)
        publish([hostile["wrong_container"]], lambda a: net.publish("P", Topic.BEACON_AGGREGATE_AND_PROOF, a))
        tick_b_ms = tick(clock)
        cycle1_ms = (time.perf_counter() - t0) * 1e3
        n_cycle1 = len(submissions)
        events = recorder.events()
        parked = len(reprocess)
        early_parked = [item for _, _, item in reprocess._early]
        unknown_parked = [p.item for p in reprocess._by_root.get(b"\xfe" * 32, [])]
        # cycle 2: the next slot's tick applies the last slot's votes and
        # the reprocess queue releases the early attestation into the drain
        early_tick_ms = tick(clock + 1)
        votes = [(bytes(chain.fork_choice.votes[v].next_root), chain.fork_choice.votes[v].next_epoch)
                 for v in range(len(secret))]
        verdicts = [f.result(timeout=SHARDED_JOIN_SECONDS) for _, f in submissions]
        torch.cuda.synchronize()
        launches = dict(fp.LAUNCHES)
        dispatches = svc.dispatches - dispatches0
        events_all = recorder.events()
    finally:
        network_service.PipelinedGossipVerifier = verifier_cls
        network_service.batch_verify_gossip_aggregates = verify_aggregates
        api.verify_signature_sets_async = dispatch
        svc.__dict__.pop("submit", None)
        bv.release(svc)
    bisections = int(metrics.BLS_BISECTION_DISPATCHES_TOTAL.value - bisect0)

    # verdicts, item by item, against the expected ones
    early = hostile["future_slot"]
    assert [item for _, item in released] == [early], f"the ticks released {len(released)} items"
    outcome = lambda r: True if r is True else (type(r).__name__, str(r))  # noqa: E731
    first = {}
    for item, ok in got:
        first.setdefault(id(item), outcome(ok))
    want = {k: outcome(v) for k, v in expect.items()}
    assert first == want, f"verdicts differ: {[(k, first.get(k), w) for k, w in want.items() if first.get(k) != w]}"
    assert outcome(got[-1][1]) is True and got[-1][0] is early, "the released early attestation was not accepted"
    dropped = int(metrics.PROCESSOR_ITEMS_DROPPED.value - dropped0)
    assert dropped == 1, f"{dropped} items dropped, the wrong container alone expected"
    assert parked == 2 and early_parked == [early] and unknown_parked == [hostile["unknown_head"]], \
        f"parked {parked}: {len(early_parked)} early, {len(unknown_parked)} on the unknown block"
    assert len(reprocess) == 1, "the unknown-block attestation left the queue before it expired"

    # per-set verdicts: the tampered set blamed alone in its batch, and each
    # equal to the ref oracle's on that set alone (all sets, host processes)
    flat = [(s, v) for (sets, _), vs in zip(submissions, verdicts) for s, v in zip(sets, vs)]
    shapes = [len(sets) for sets, _ in submissions]
    assert shapes == [3 * (len(aggregates) + 1), len(batch_a), 1, 1], f"coalescer submissions of {shapes} sets"
    assert verdicts[1].count(False) == 1, "the tampered attestation was not blamed alone"
    t0 = time.perf_counter()
    with host_pool() as pool:
        oracle = pool.map(oracle_set_verdict, [(s.signature.to_bytes(), [pk.to_bytes() for pk in s.signing_keys],
                                                s.message) for s, _ in flat])
    oracle_s = time.perf_counter() - t0
    assert [v for _, v in flat] == oracle, "a set's verdict differs from the ref oracle's"
    assert sum(not v for _, v in flat) == 2, "not exactly the tampered and the stolen-proof sets failed"

    # the device work: one verify a dispatch (first level and bisection)
    assert len(sizes) == dispatches + bisections, f"{len(sizes)} verifies, {dispatches} + {bisections} dispatches"
    counts = {k: launches[k] for k in VERIFY_LAUNCHES}
    want_counts = {k: v * len(sizes) for k, v in VERIFY_LAUNCHES.items()}
    assert counts == want_counts, f"{len(sizes)} gossip verifies launched {counts}, expected {want_counts}"
    grown = int(metrics.BLS_SETS_TOTAL.value - sets0)
    assert grown == len(flat), f"{metrics.BLS_SETS_TOTAL.name} grew by {grown}, {len(flat)} sets verified"
    fc = chain.fork_choice
    assert all(v == (head, epoch) for v in votes), "fork choice did not take every gossip vote"

    # latency from admission to each set's verdict, on the recorder's clock
    admitted = {e["corr_id"]: e["t_mono"] for e in events_all if e["event"] == "admitted"}
    lat = [(e["t_mono"] - admitted[e["corr_id"]]) * 1e3 for e in events if e["event"] == "set_verdict"]
    early_id = recorder.lookup(bytes(type(early).hash_tree_root(early)))
    early_lat = [(e["t_mono"] - admitted[early_id]) * 1e3 for e in events_all
                 if e["event"] == "set_verdict" and e["corr_id"] == early_id]
    assert len(lat) == sum(len(s) for s, _ in submissions[:n_cycle1]) and len(early_lat) == 1, "a set has no verdict"
    path = ("admitted", "staged", "batch_formed", "device_dispatch", "set_verdict")
    seen = collections.defaultdict(dict)
    for e in events:
        seen[e["corr_id"]].setdefault(e["event"], e["t_mono"])
    hops = {}
    for kind in ("attestation", "aggregate"):
        rows = [ts for cid, ts in seen.items() if cid.startswith(kind) and all(h in ts for h in path)]
        hops[kind] = {f"{a}-{b}": round(statistics.median((ts[b] - ts[a]) * 1e3 for ts in rows), 3)
                      for a, b in zip(path, path[1:])}
    phase("gossip", validators=len(secret), epoch=epoch, clock_slot=clock,
          attestations=len(batch_a) + 1, aggregates=len(aggregates), hostile=len(hostile),
          attestation_sets=len(batch_a) + 1, aggregate_sets=3 * (len(aggregates) + 1),
          dispatches=dispatches, bisection_dispatches=bisections,
          batch_sizes=json.dumps(sizes, separators=(",", ":")), sets=len(flat), blamed=sum(not v for _, v in flat),
          sign_s=f"{sign_s:.2f}", oracle_s=f"{oracle_s:.2f}", oracle_sets=len(oracle), card=f'"{card}"')
    phase("gossip", tick_ms=f"{tick_ms:.3f}", tick_b_ms=f"{tick_b_ms:.3f}", cycle1_ms=f"{cycle1_ms:.3f}",
          early_tick_ms=f"{early_tick_ms:.3f}", aggregate_handler_ms=json.dumps([round(x, 3) for x in agg_ms]),
          set_latency_ms_median=f"{statistics.median(lat):.3f}", set_latency_ms_max=f"{max(lat):.3f}",
          set_latency_ms_min=f"{min(lat):.3f}", early_latency_ms=f"{early_lat[0]:.3f}", queue_depth_peak=depth[0],
          hop_ms_median=json.dumps(hops, separators=(",", ":")),
          items_dropped=dropped, launches=json.dumps(launches, separators=(",", ":")), card=f'"{card}"')

    # the loop: the op pool's attestations in the next block, imported
    pre = chain.state_at_slot(clock + 1)
    packed = node.op_pool.get_attestations(pre)
    gossip_roots = {root_type(data_at(slot, index)) for slot, index, _ in duties}
    assert len(packed) == len(duties) and {root_type(a.data) for a in packed} == gossip_roots, \
        f"the op pool packed {len(packed)} attestations for {len(duties)} committees"
    calls0, secs0, sets0 = metrics.BLS_BATCH_SECONDS.count, metrics.BLS_BATCH_SECONDS.sum, metrics.BLS_SETS_TOTAL.value
    import0 = metrics.BLOCK_IMPORT_SECONDS.sum
    torch.cuda.synchronize()
    fp.reset_launches()
    root, signed = harness.add_block_at_slot(clock + 1, attestations=packed)
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)
    import_ms = (metrics.BLOCK_IMPORT_SECONDS.sum - import0) * 1e3
    calls = metrics.BLS_BATCH_SECONDS.count - calls0
    body = signed.message.body
    assert chain.head_root == root and int(signed.message.slot) == clock + 1, "the next block is not the head"
    assert [type(a).hash_tree_root(a) for a in body.attestations] == [type(a).hash_tree_root(a) for a in packed]
    assert calls == 1 and {k: launches[k] for k in VERIFY_LAUNCHES} == VERIFY_LAUNCHES, \
        f"the next block's import ran {calls} verifies, launching {launches}"
    assert int(metrics.BLS_SETS_TOTAL.value - sets0) == block_sets(signed)
    nodes, idx = fc.proto.nodes, fc.proto.indices
    voters = [v for v in range(len(secret)) if bytes(fc.votes[v].current_root) == head]
    assert len(voters) == len(secret), f"{len(voters)} of {len(secret)} votes on the gossip head after import"
    assert nodes[idx[head]].weight - nodes[idx[root]].weight == sum(fc.balances[v] for v in voters), \
        "fork choice does not weigh the gossip votes"
    assert any(q.slot == clock + 1 for q in fc.queued), "the early vote is not queued for its next slot"
    phase("gossip", step="next_block", slot=clock + 1,
          op_pool_attestations=sum(map(len, node.op_pool.attestations.values())),
          block_attestations=len(body.attestations), sets=block_sets(signed), import_ms=f"{import_ms:.3f}",
          verify_ms=f"{(metrics.BLS_BATCH_SECONDS.sum - secs0) * 1e3:.3f}", head_is_block=True,
          voters=len(voters), launches=json.dumps(launches, separators=(",", ":")), card=f'"{card}"')


def run_sync(torch, api, fp, card: str, harness) -> None:
    """Range sync and block gossip on the card over real localhost sockets;
    see the module docstring. Node A is chain A; the follower F a fresh
    chain on its genesis and context. The follower's downloads, segment
    imports and verifies, the Req/Resp client's calls and the bytes it
    reads, and F's gossip deliveries and seen-cache answers are wrapped to
    be recorded, and unwrapped afterwards whatever happens."""
    from lighthouse_tpu_torch.chain import BeaconChain, ManualSlotClock
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.network import NetworkService, SocketNetwork, Topic, enr, rpc
    from lighthouse_tpu_torch.network.gossip import message_id
    from lighthouse_tpu_torch.network.sync import EPOCHS_PER_BATCH, SyncState
    from lighthouse_tpu_torch.scheduler import BeaconProcessor
    from lighthouse_tpu_torch.types import compute_fork_digest

    chain_a, ctx = harness.chain, harness.ctx
    assert ctx.bls is api, f"chain A runs on {ctx.bls.__name__}, not the card's backend"
    head_a, head_slot = bytes(chain_a.head_root), int(chain_a.head_state().slot)
    span = EPOCHS_PER_BATCH * ctx.preset.slots_per_epoch
    want_batches = -(-head_slot // span)
    blocks_a, root = [], head_a
    while root != chain_a.genesis_block_root:
        blocks_a.append(chain_a.store.get_block(root))
        root = bytes(blocks_a[-1].message.parent_root)
    blocks_a.reverse()
    follower = BeaconChain(chain_a.store.get_state(chain_a.genesis_block_root).copy(), ctx,
                           slot_clock=ManualSlotClock())

    staged, downloads, segments, block_imports, frames, rpc_ms, delivered, seen = [], [], [], [], [], [], [], []
    verify_staged, request, recv_frame = api.verify_staged, rpc.request, rpc._recv_frame
    main_thread = threading.main_thread()

    def recorded_staged(flat, S, K):
        staged.append((S, K))
        return verify_staged(flat, S, K)

    def recorded_request(*args, **kwargs):
        t = time.perf_counter()
        try:
            return request(*args, **kwargs)
        finally:
            rpc_ms.append((time.perf_counter() - t) * 1e3)

    def recorded_recv_frame(sock, *args, **kwargs):
        frame = recv_frame(sock, *args, **kwargs)
        if threading.current_thread() is main_thread:  # the client's reads, not the server threads'
            frames.append(4 + len(frame))
        return frame

    segment, process_block = follower.process_chain_segment, follower.process_block

    def recorded_segment(blocks):
        row = {"blocks": len(blocks), "slots": [int(b.message.slot) for b in blocks],
               "sets": sum(block_sets(b) for b in blocks), "calls": metrics.BLS_BATCH_SECONDS.count,
               "verify_s": metrics.BLS_BATCH_SECONDS.sum, "sets_verified": metrics.BLS_SETS_TOTAL.value,
               "shapes": len(staged)}
        torch.cuda.synchronize()
        before = dict(fp.LAUNCHES)
        t = time.perf_counter()
        try:
            return segment(blocks)
        finally:
            torch.cuda.synchronize()
            row["ms"] = (time.perf_counter() - t) * 1e3
            row["launches"] = {k: fp.LAUNCHES[k] - before[k] for k in before}
            row["calls"] = metrics.BLS_BATCH_SECONDS.count - row["calls"]
            row["verify_ms"] = (metrics.BLS_BATCH_SECONDS.sum - row["verify_s"]) * 1e3
            row["sets_verified"] = int(metrics.BLS_SETS_TOTAL.value - row["sets_verified"])
            row["shapes"] = staged[row["shapes"]:]
            segments.append(row)

    def recorded_block(*args, **kwargs):
        block_imports.append(args)
        return process_block(*args, **kwargs)

    follower.process_chain_segment, follower.process_block = recorded_segment, recorded_block
    errors0, sets0 = metrics.GOSSIP_INTERNAL_ERRORS_TOTAL.value, metrics.BLS_SETS_TOTAL.value
    net = SocketNetwork(ctx)
    try:
        api.verify_staged, rpc.request, rpc._recv_frame = recorded_staged, recorded_request, recorded_recv_frame
        anode = node_stand_in(chain_a, BeaconProcessor())
        fnode = node_stand_in(follower, BeaconProcessor())
        aserv = NetworkService("A", anode, net)
        fserv = NetworkService("F", fnode, net)
        by_range = net.blocks_by_range_from

        def recorded_by_range(requester, peer, start_slot, count):
            n_frames, n_calls = len(frames), len(rpc_ms)
            t = time.perf_counter()
            blocks = by_range(requester, peer, start_slot, count)
            downloads.append({"start_slot": start_slot, "count": count, "ms": (time.perf_counter() - t) * 1e3,
                              "rpc_ms": sum(rpc_ms[n_calls:]), "blocks": len(blocks),
                              "wire_bytes": sum(frames[n_frames:])})
            return blocks

        net.blocks_by_range_from = recorded_by_range

        # status_sync: status over TCP, then BlocksByRange batches, each one
        # process_chain_segment with one verify
        follower.slot_clock.set_slot(head_slot)
        follower.fork_choice.on_tick(head_slot)
        torch.cuda.synchronize()
        fp.reset_launches()
        t0 = time.perf_counter()
        fserv.exchange_status()
        torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fp.LAUNCHES)
        assert bytes(follower.head_root) == head_a, "the follower did not reach node A's head"
        assert fserv.sync.range.state is SyncState.IDLE, f"range sync ended {fserv.sync.range.state}"
        assert fserv.sync.range.batches_imported == want_batches == len(segments) == len(downloads), \
            f"{fserv.sync.range.batches_imported} batches imported, {len(segments)} segments, " \
            f"{len(downloads)} downloads, {want_batches} expected"
        assert not block_imports, f"range sync fell back to {len(block_imports)} single-block imports"
        slots = [s for row in segments for s in row["slots"]]
        assert slots == [int(b.message.slot) for b in blocks_a], "the batches did not carry chain A's blocks"
        for i, (row, down) in enumerate(zip(segments, downloads)):
            assert row["calls"] == 1 and len(row["shapes"]) == 1, f"batch {i}: {row['calls']} verifies"
            assert {k: row["launches"][k] for k in VERIFY_LAUNCHES} == VERIFY_LAUNCHES, \
                f"batch {i} launched {row['launches']}"
            assert row["sets_verified"] == row["sets"], f"batch {i}: {row['sets_verified']} of {row['sets']} sets"
            S, K = row["shapes"][0]
            phase("sync", step="batch", index=i, start_slot=down["start_slot"], count=down["count"],
                  blocks=row["blocks"], sets=row["sets"], S=S, K=K, download_ms=f"{down['ms']:.3f}",
                  rpc_ms=f"{down['rpc_ms']:.3f}", ssz_decode_ms=f"{down['ms'] - down['rpc_ms']:.3f}",
                  wire_bytes=down["wire_bytes"], import_ms=f"{row['ms']:.3f}",
                  import_host_ms=f"{row['ms'] - row['verify_ms']:.3f}", verify_ms=f"{row['verify_ms']:.3f}",
                  card=f'"{card}"')
        counts = {k: launches[k] for k in VERIFY_LAUNCHES}
        assert counts == {k: v * want_batches for k, v in VERIFY_LAUNCHES.items()}, \
            f"{want_batches} batches launched {counts}"
        assert sum(launches.values()) == sum(counts.values()), f"a kernel off the verify path launched: {launches}"
        phase("sync", step="status_sync", head_slot=head_slot, batches=want_batches, blocks=len(slots),
              sets=sum(r["sets"] for r in segments), verifies=sum(r["calls"] for r in segments),
              wire_bytes=sum(d["wire_bytes"] for d in downloads), step_ms=f"{sync_ms:.3f}",
              download_ms=f"{sum(d['ms'] for d in downloads):.3f}",
              import_host_ms=f"{sum(r['ms'] - r['verify_ms'] for r in segments):.3f}",
              verify_ms=f"{sum(r['verify_ms'] for r in segments):.3f}", head_equal=True,
              state=fserv.sync.range.state.name, launches=json.dumps(launches, separators=(",", ":")),
              card=f'"{card}"')

        # gossip_block: node A's next block over GossipNode (the spec topic
        # with the fork digest, a snappy payload, the spec message id) into
        # F's processor, imported at F's tick with one verify; then the
        # same block again, dropped by F's seen cache
        slot = head_slot + 1
        t0 = time.perf_counter()
        root, signed = harness.add_block_at_slot(slot)
        produce_ms = (time.perf_counter() - t0) * 1e3
        gossip_f = net._nodes["F"]["gossip"]
        deliver, mark_seen = gossip_f.deliver, gossip_f._mark_seen

        def recorded_deliver(topic, payload, src):
            delivered.append((topic, len(payload)))
            return deliver(topic, payload, src)

        def recorded_mark_seen(mid):
            novel = mark_seen(mid)
            seen.append((mid, novel))
            return novel

        gossip_f.deliver, gossip_f._mark_seen = recorded_deliver, recorded_mark_seen
        mid = message_id(type(signed).serialize(signed))
        state = chain_a.head_state()
        digest = compute_fork_digest(bytes(state.fork.current_version), bytes(state.genesis_validators_root))

        def wait_for(done, what: str) -> float:
            t1 = time.perf_counter()
            while not done():
                if time.perf_counter() - t1 > SYNC_GOSSIP_WAIT_S:
                    raise TimeoutError(f"{what}: nothing within {SYNC_GOSSIP_WAIT_S} s")
                time.sleep(0.005)
            return (time.perf_counter() - t1) * 1e3

        wait_for(lambda: len(net._nodes["A"]["gossip"]._peers) > 0, "node A's gossip link to F")
        calls0, secs0, n_staged = metrics.BLS_BATCH_SECONDS.count, metrics.BLS_BATCH_SECONDS.sum, len(staged)
        torch.cuda.synchronize()
        fp.reset_launches()
        aserv.publish_block(signed)
        arrive_ms = wait_for(lambda: len(fnode.processor) > 0, "the gossip block")
        t0 = time.perf_counter()
        slot_tick(fnode, fserv, slot)
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fp.LAUNCHES)
        calls = metrics.BLS_BATCH_SECONDS.count - calls0
        assert bytes(follower.head_root) == bytes(chain_a.head_root) == root, "the gossip block is not F's head"
        assert delivered == [(Topic.BEACON_BLOCK.full_name(digest), len(type(signed).serialize(signed)))], \
            f"F's gossip deliveries: {delivered}"
        assert seen == [(mid, True)], "the block did not arrive once under the spec message id"
        assert calls == 1 and {k: launches[k] for k in VERIFY_LAUNCHES} == VERIFY_LAUNCHES, \
            f"the gossip block's import ran {calls} verifies, launching {launches}"
        assert [args[0] for args in block_imports] == [signed], "the gossip block was not imported alone"
        S, K = staged[n_staged]
        verify_ms = (metrics.BLS_BATCH_SECONDS.sum - secs0) * 1e3
        fp.reset_launches()
        aserv.publish_block(signed)
        dup_ms = wait_for(lambda: len(seen) > 1, "the second copy")
        slot_tick(fnode, fserv, slot)
        torch.cuda.synchronize()
        assert seen[1:] == [(mid, False)] and len(delivered) == 1, "the second copy was not dropped as seen"
        assert all(n == 0 for n in fp.LAUNCHES.values()), f"the dropped copy launched {dict(fp.LAUNCHES)}"
        assert bytes(follower.head_root) == root and metrics.BLS_BATCH_SECONDS.count - calls0 == 1
    finally:
        net.close()
        api.verify_staged, rpc.request, rpc._recv_frame = verify_staged, request, recv_frame
    errors = int(metrics.GOSSIP_INTERNAL_ERRORS_TOTAL.value - errors0)
    assert errors == 0, f"{metrics.GOSSIP_INTERNAL_ERRORS_TOTAL.name} grew by {errors}"
    grown = int(metrics.BLS_SETS_TOTAL.value - sets0)
    want = sum(r["sets"] for r in segments) + 2 * block_sets(signed)  # node A's import and F's
    assert grown == want, f"{metrics.BLS_SETS_TOTAL.name} grew by {grown}, {want} sets verified"
    phase("sync", step="gossip_block", slot=slot, sets=block_sets(signed), S=S, K=K,
          payload_bytes=len(type(signed).serialize(signed)), produce_ms=f"{produce_ms:.3f}",
          arrive_ms=f"{arrive_ms:.3f}", tick_ms=f"{tick_ms:.3f}", verify_ms=f"{verify_ms:.3f}",
          duplicate_dropped=True, duplicate_ms=f"{dup_ms:.3f}", gossip_internal_errors=errors,
          enr_backend="cryptography" if enr._HAVE_CRYPTOGRAPHY else "pure", head_equal=True,
          launches=json.dumps(launches, separators=(",", ":")), card=f'"{card}"')


def run_vc(torch, api, fp, card: str, harness) -> None:
    """The validator client over the Beacon API on the card, over chain A;
    see the module docstring. The store's signing methods and its remote
    key, the client's HTTP calls, node A's publish calls, the aggregate
    admission and the backend's verify are wrapped to be recorded, and
    unwrapped afterwards whatever happens; every server, the signer, the
    lock and the directory are closed in a `finally`."""
    import tempfile
    import urllib.error
    import urllib.request

    from lighthouse_tpu_torch.chain import BeaconChain, ManualSlotClock
    from lighthouse_tpu_torch.chain import attestation_processing as ap
    from lighthouse_tpu_torch.crypto import keystore
    from lighthouse_tpu_torch.http_api import HttpApiServer, encode
    from lighthouse_tpu_torch.op_pool import OperationPool
    from lighthouse_tpu_torch.types import compute_signing_root, compute_start_slot_at_epoch, schedule_domain
    from lighthouse_tpu_torch.types.containers import Checkpoint
    from lighthouse_tpu_torch.validator_client import (BeaconNodeApi, BeaconNodeHttpClient, MetricsServer,
                                                       SlashingDatabase, SlashingProtectionError, ValidatorClient,
                                                       ValidatorStore)
    from lighthouse_tpu_torch.validator_client.lockfile import Lockfile, LockfileError
    from lighthouse_tpu_torch.validator_client.validator_client import VC_DUTIES_TOTAL
    from lighthouse_tpu_torch.validator_client.web3signer import MockWeb3Signer, Web3SignerClient

    t_phase = time.perf_counter()
    chain, ctx = harness.chain, harness.ctx
    assert ctx.bls is api, f"chain A runs on {ctx.bls.__name__}, not the card's backend"
    t, preset, spec = ctx.types, ctx.preset, ctx.spec
    spe = preset.slots_per_epoch
    state = chain.head_state()
    head0, head_root0 = int(state.slot), bytes(chain.head_root)
    gvr = bytes(state.genesis_validators_root)
    pubkeys = [bytes(v.pubkey) for v in state.validators]
    n = len(pubkeys)
    slots = list(range(head0 + 1, head0 + 1 + VC_SLOTS))
    epoch = slots[0] // spe
    assert all(s // spe == epoch for s in slots), f"the slots {slots} are not in one epoch"
    # the replay's node: chain A's head state as a checkpoint anchor, a
    # node that never sees the phase's blocks
    lag = BeaconChain(state.copy(), ctx, slot_clock=ManualSlotClock())
    assert lag.head_root == head_root0, "the anchored node's head is not chain A's"

    sign_methods = [m for m in dir(ValidatorStore) if m.startswith("sign_")]
    made, refused, sign_s = collections.Counter(), collections.Counter(), [0.0]
    http, verifies, published, admissions, remote_signed = [], [], [], [], []
    verify_async, admit_aggregates = api.verify_signature_sets_async, ap.batch_verify_gossip_aggregates
    main_thread = threading.main_thread()

    def recorded_sign(name, fn):
        def wrapper(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except SlashingProtectionError:
                refused[name] += 1
                raise
            finally:
                sign_s[0] += time.perf_counter() - t1
            made[name] += 1
            return out
        return wrapper

    def recorded_request(request):
        def wrapper(path, *args, **kwargs):
            t1 = time.perf_counter()
            try:
                return request(path, *args, **kwargs)
            finally:
                http.append((path, (time.perf_counter() - t1) * 1e3))
        return wrapper

    def recorded_verify(sets, *args, **kwargs):
        """One verify from whichever thread calls it (the node's handler
        threads): its sets, wall ms to the verdict, verdict, launches."""
        torch.cuda.synchronize()
        before = dict(fp.LAUNCHES)
        t1 = time.perf_counter()
        fut = verify_async(sets, *args, **kwargs)
        ok = fut.result()
        torch.cuda.synchronize()
        verifies.append({"sets": len(sets), "ms": (time.perf_counter() - t1) * 1e3, "ok": ok,
                         "launches": {k: fp.LAUNCHES[k] - before[k] for k in before},
                         "handler_thread": threading.current_thread() is not main_thread,
                         "device": torch.cuda.current_device()})
        return fut

    def recorded_admission(chain_, aggregates, *args, **kwargs):
        results = admit_aggregates(chain_, aggregates, *args, **kwargs)
        admissions.extend(results)
        return results

    def recorded_publish(kind, fn):
        def wrapper(item):
            nv, t1 = len(verifies), time.perf_counter()
            out = fn(item)
            published.append({"kind": kind, "item": item, "out": out, "verifies": len(verifies) - nv,
                              "ms": (time.perf_counter() - t1) * 1e3})
            return out
        return wrapper

    def one_verify_each(rows, what: str) -> None:
        for v in rows:
            counts = {k: v["launches"][k] for k in VERIFY_LAUNCHES}
            assert counts == VERIFY_LAUNCHES and sum(v["launches"].values()) == sum(counts.values()), \
                f"{what}: a verify launched {v['launches']}"
            assert v["handler_thread"] and v["device"] == 0, f"{what}: a verify ran off the node's threads or cuda:0"

    tmp = tempfile.TemporaryDirectory(prefix="lighthouse_vc_")
    lock_path = os.path.join(tmp.name, "validators.lock")
    lock, store, stop = None, None, []
    try:
        # keys: EIP-2335 keystores in a directory held by its lockfile
        lock = Lockfile(lock_path).acquire()
        with host_pool() as pool:
            t0 = time.perf_counter()
            encrypted = pool.map(encrypt_keystore, [(int(kp[0].k), i, pubkeys[i].hex())
                                                    for i, kp in enumerate(harness.keypairs)])
            encrypt_s = time.perf_counter() - t0
            paths = [os.path.join(tmp.name, f"keystore-{i}.json") for i in range(n)]
            for ks, path in zip(encrypted, paths):
                keystore.save(ks, path)
            other_process = pool.apply(second_lock_holder, (lock_path,))
            try:
                Lockfile(lock_path).acquire().release()
                this_process = "acquired"
            except LockfileError as e:
                this_process = str(e)
            t0 = time.perf_counter()
            decrypted = pool.map(decrypt_keystore, paths)
            decrypt_s = time.perf_counter() - t0
        assert "is locked" in other_process and "is locked" in this_process, \
            f"a second holder took the lock: {other_process!r}, {this_process!r}"
        assert [pk for _, pk in decrypted] == pubkeys, "a decrypted key's public key is not its validator's"
        assert [int.from_bytes(sk, "big") for sk, _ in decrypted] == [int(kp[0].k) for kp in harness.keypairs]
        assert all(ks["crypto"]["kdf"]["params"]["c"] == VC_KDF["c"] for ks in encrypted)
        phase("vc", step="keys", keystores=n, kdf="pbkdf2", c=VC_KDF["c"], encrypt_s=f"{encrypt_s:.3f}",
              decrypt_s=f"{decrypt_s:.3f}", pubkeys_equal=True, second_holder_refused=True,
              refusal=f'"{other_process.split(" — ")[0]}"', card=f'"{card}"')

        # node A over the Beacon API; the store with 63 local keys and one
        # in the Web3Signer mock, a validator with a duty in the first slot
        node_api = BeaconNodeApi(chain, OperationPool(ctx))
        server = HttpApiServer(node_api).start()
        stop.append(server)
        url = f"http://127.0.0.1:{server.port}"
        duties = node_api.attester_duties(epoch, pubkeys)
        assert sorted(d.validator_index for d in duties) == list(range(n)), "not one duty a validator"
        remote = min((d.committee_index, d.committee_position, d.validator_index)
                     for d in duties if d.slot == slots[0])[2]
        keys = [api.SecretKey.from_bytes(sk) for sk, _ in decrypted]
        store = ValidatorStore(ctx, SlashingDatabase(os.path.join(tmp.name, "slashing_protection.sqlite")))
        for i, sk in enumerate(keys):
            if i != remote:
                store.add_validator(sk)
        signer = MockWeb3Signer([keys[remote]]).start()
        stop.append(signer)
        signer_client = Web3SignerClient(signer.url, timeout=VC_HTTP_TIMEOUT_S)
        assert signer_client.upcheck() and signer_client.public_keys() == [pubkeys[remote]]
        store.add_web3signer_validator(pubkeys[remote], signer_client)
        assert sorted(store.pubkeys()) == sorted(pubkeys)
        remote_key = store.keys[pubkeys[remote]]
        remote_sign = remote_key.sign

        def recorded_remote(root):
            sig = remote_sign(root)
            remote_signed.append((bytes(root), sig.to_bytes(), remote_key._duty_type))
            return sig

        remote_key.sign = recorded_remote
        for name in sign_methods:
            setattr(store, name, recorded_sign(name, getattr(store, name)))
        client = BeaconNodeHttpClient([url], ctx, timeout=VC_HTTP_TIMEOUT_S)
        client._request = recorded_request(client._request)
        for kind in ("block", "attestation", "aggregate"):
            setattr(node_api, f"publish_{kind}", recorded_publish(kind, getattr(node_api, f"publish_{kind}")))
        api.verify_signature_sets_async, ap.batch_verify_gossip_aggregates = recorded_verify, recorded_admission
        vc = ValidatorClient(client, store)
        metrics_server = MetricsServer(vc).start()
        stop.append(metrics_server)

        def scrape(path: str) -> str:
            with urllib.request.urlopen(f"http://127.0.0.1:{metrics_server.port}{path}",
                                        timeout=VC_HTTP_TIMEOUT_S) as r:
                return r.read().decode()

        def duty_counts() -> dict:
            return {m.group(1): float(m.group(2)) for m in re.finditer(
                rf'^{VC_DUTIES_TOTAL.name}\{{duty="(\w+)"\}} (\S+)$', scrape("/metrics"), re.M)}

        duties0 = duty_counts()
        phase("vc", step="node", url=url, validators=n, local_keys=n - 1, remote_key=remote, signer=signer.url,
              first_slot=slots[0], duties_first_slot=sum(1 for d in duties if d.slot == slots[0]),
              card=f'"{card}"')

        rows = []
        for s in slots:
            chain.slot_clock.set_slot(s)
            chain.fork_choice.on_tick(s)
            n_http, n_ver, n_pub, n_adm = len(http), len(verifies), len(published), len(admissions)
            made.clear()
            sign_s[0] = 0.0
            torch.cuda.synchronize()
            fp.reset_launches()
            t1 = time.perf_counter()
            summary = vc.on_slot(s)
            torch.cuda.synchronize()
            slot_ms = (time.perf_counter() - t1) * 1e3
            launches = dict(fp.LAUNCHES)
            ver, pub, calls, adm = verifies[n_ver:], published[n_pub:], http[n_http:], admissions[n_adm:]
            mine = [d for d in duties if d.slot == s]
            committees = sorted({d.committee_index for d in mine})
            by_kind = {k: [p for p in pub if p["kind"] == k] for k in ("block", "attestation", "aggregate")}
            assert int(chain.head_state().slot) == s, f"slot {s}: the head is at {int(chain.head_state().slot)}"
            assert summary["proposed"] == bytes(chain.head_root), f"slot {s}: the proposal is not the head"
            [block] = by_kind["block"]
            assert block["out"] == bytes(chain.head_root) and block["verifies"] == 1, f"slot {s}: block {block}"
            assert summary["attested"] == len(by_kind["attestation"]) == len(mine), \
                f"slot {s}: {summary['attested']} attested of {len(mine)} duties"
            assert all(p["out"] is True and p["verifies"] == 1 for p in by_kind["attestation"]), \
                f"slot {s}: an attestation was refused or not verified once"
            # every member of a small committee aggregates; the first
            # aggregate of a committee is verified, the rest carry nothing new
            verified = [p for p in by_kind["aggregate"] if p["out"] is True]
            dropped = [p for p in by_kind["aggregate"] if p["out"] is not True]
            assert len(by_kind["aggregate"]) == made["sign_aggregate_and_proof"] == len(adm)
            assert sorted(int(p["item"].message.aggregate.data.index) for p in verified) == committees, \
                f"slot {s}: verified aggregates {len(verified)} for committees {committees}"
            assert all(p["verifies"] == 1 for p in verified) and all(p["verifies"] == 0 for p in dropped)
            reasons = collections.Counter("accepted" if r is True else str(r) for r in adm)
            assert reasons == {"accepted": len(verified), "aggregate already known": len(dropped)}, reasons
            assert summary["aggregated"] == len(verified)
            assert len(ver) == 1 + len(mine) + len(verified) and all(v["ok"] is True for v in ver), \
                f"slot {s}: {len(ver)} verifies, verdicts {[v['ok'] for v in ver]}"
            one_verify_each(ver, f"slot {s}")
            counts = {k: launches[k] for k in VERIFY_LAUNCHES}
            assert counts == {k: v * len(ver) for k, v in VERIFY_LAUNCHES.items()}, f"slot {s} launched {launches}"
            assert sum(launches.values()) == sum(counts.values()), f"slot {s}: a kernel off the path: {launches}"
            body = chain.store.get_block(bytes(chain.head_root)).message.body
            carried = [a for a in body.attestations if int(a.data.slot) == s - 1]
            carried_bits = sum(sum(a.aggregation_bits) for a in carried)
            if rows:
                assert carried_bits == rows[-1]["attested"] > 0, \
                    f"slot {s}'s block carries {carried_bits} of slot {s - 1}'s {rows[-1]['attested']} attesters"
            rows.append({"attested": summary["attested"], "signatures": sum(made.values())})
            phase("vc", step="slot", slot=s, proposed=f"0x{summary['proposed'].hex()}",
                  proposer=int(block["item"].message.proposer_index), attested=summary["attested"],
                  aggregated=summary["aggregated"], committees=len(committees),
                  aggregates_published=len(by_kind["aggregate"]), aggregates_verified=len(verified),
                  aggregates_dropped_seen=len(dropped), carried_attestations=len(carried),
                  carried_attesters=carried_bits, signatures=sum(made.values()),
                  signatures_by_kind=json.dumps(dict(sorted(made.items())), separators=(",", ":")),
                  sign_s=f"{sign_s[0]:.3f}", http_requests=len(calls), http_ms=f"{sum(ms for _, ms in calls):.3f}",
                  verifies=len(ver), verify_sets=json.dumps([v["sets"] for v in ver], separators=(",", ":")),
                  verify_ms=json.dumps([round(v["ms"], 3) for v in ver], separators=(",", ":")),
                  block_import_ms=f"{block['ms']:.3f}", slot_ms=f"{slot_ms:.3f}",
                  head_slot=int(chain.head_state().slot), launches=json.dumps(launches, separators=(",", ":")),
                  card=f'"{card}"')

        # the remote key signed over HTTP what the local key signs
        assert remote_signed, "the remote key signed nothing"
        for root, sig, _ in remote_signed:
            assert sig == keys[remote].sign(root).to_bytes(), "the remote signature is not the local one"
        phase("vc", step="remote_key", validator=remote, signatures=len(remote_signed),
              duties=json.dumps(sorted({d for _, _, d in remote_signed}), separators=(",", ":")),
              byte_identical=True, card=f'"{card}"')

        # a tampered attestation POSTed over HTTP: a validator of an earlier
        # slot of the epoch (none of its votes seen yet), signed by another key
        start = compute_start_slot_at_epoch(epoch, preset)
        earlier = [d for d in duties if start <= d.slot < slots[0]]
        assert earlier, f"no slot of epoch {epoch} before {slots[0]}"
        victim = min(earlier, key=lambda d: (-d.slot, d.committee_index, d.committee_position))
        head_state = chain.head_state()
        hist = preset.slots_per_historical_root
        data = t.AttestationData(slot=victim.slot, index=victim.committee_index,
                                 beacon_block_root=bytes(head_state.block_roots[victim.slot % hist]),
                                 source=head_state.current_justified_checkpoint,
                                 target=Checkpoint(epoch=epoch, root=bytes(head_state.block_roots[start % hist])))
        root = compute_signing_root(data, schedule_domain(spec, spec.domain_beacon_attester, epoch, gvr))
        forger = (victim.validator_index + 1) % n
        bad = t.Attestation(aggregation_bits=[i == victim.committee_position for i in range(victim.committee_length)],
                            data=data, signature=keys[forger].sign(root).to_bytes())
        oracle = oracle_set_verdict((bytes(bad.signature), [pubkeys[victim.validator_index]], root))
        n_ver, n_pub, head_before = len(verifies), len(published), bytes(chain.head_root)
        torch.cuda.synchronize()
        fp.reset_launches()
        req = urllib.request.Request(url + "/eth/v1/beacon/pool/attestations",
                                     data=json.dumps([encode(bad, t.Attestation)]).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=VC_HTTP_TIMEOUT_S) as r:
                status, answer = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, answer = e.code, e.read()
        torch.cuda.synchronize()
        launches = dict(fp.LAUNCHES)
        ver = verifies[n_ver:]
        assert status == 400 and json.loads(answer)["failures"] == [{"index": 0, "message": "attestation rejected"}], \
            f"the tampered attestation: HTTP {status} {answer[:200]!r}"
        assert [(p["kind"], p["out"]) for p in published[n_pub:]] == [("attestation", False)]
        assert oracle is False and [v["ok"] for v in ver] == [oracle], \
            f"verdicts {[v['ok'] for v in ver]}, the oracle's {oracle}"
        one_verify_each(ver, "tampered attestation")
        assert {k: launches[k] for k in VERIFY_LAUNCHES} == {k: v * len(ver) for k, v in VERIFY_LAUNCHES.items()}
        assert bytes(chain.head_root) == head_before and not any(
            bytes(a.signature) == bytes(bad.signature) for b in node_api.op_pool.attestations.values() for a in b)
        phase("vc", step="tampered_attestation", slot=victim.slot, validator=victim.validator_index, signer=forger,
              status=status, verifies=len(ver), verdicts=json.dumps([v["ok"] for v in ver]), oracle=oracle,
              verify_ms=json.dumps([round(v["ms"], 3) for v in ver], separators=(",", ":")),
              launches=json.dumps(launches, separators=(",", ":")), card=f'"{card}"')

        # the second slot again, from a client restarted on the same store
        # against a node that never saw the phase's blocks: the database
        # refuses the proposal and every attestation
        lag_api = BeaconNodeApi(lag, OperationPool(ctx))
        lag_server = HttpApiServer(lag_api).start()
        stop.append(lag_server)
        s = slots[-1]
        lag.slot_clock.set_slot(s)
        lag.fork_choice.on_tick(s)
        client2 = BeaconNodeHttpClient([f"http://127.0.0.1:{lag_server.port}"], ctx, timeout=VC_HTTP_TIMEOUT_S)
        client2._request = recorded_request(client2._request)
        vc2 = ValidatorClient(client2, store)
        made.clear()
        refused.clear()
        n_ver, n_pub = len(verifies), len(published)
        torch.cuda.synchronize()
        fp.reset_launches()
        replay = vc2.on_slot(s)
        torch.cuda.synchronize()
        launches = dict(fp.LAUNCHES)
        mine = [d for d in duties if d.slot == s]
        assert (replay["proposed"], replay["attested"], replay["aggregated"]) == (None, 0, 0), replay
        assert refused == {"sign_block": 1, "sign_attestation": len(mine)}, f"the replay: refusals {dict(refused)}"
        slashable = made["sign_block"] + made["sign_attestation"]
        assert slashable == 0 and set(made) <= {"sign_randao"}, f"the replay signed {dict(made)}"
        assert len(verifies) == n_ver and len(published) == n_pub and not any(launches.values()), \
            f"the replay verified {len(verifies) - n_ver} times, launching {launches}"
        assert lag.head_root == head_root0 and int(chain.head_state().slot) == slots[-1]
        phase("vc", step="replay", slot=s, node=f"anchored_at_slot_{head0}", proposal_refused=True,
              attestations_refused=refused["sign_attestation"], slashable_signatures=slashable,
              randao_reveals=made["sign_randao"], verifies=0, launches=json.dumps(launches, separators=(",", ":")),
              card=f'"{card}"')

        # the EIP-3076 interchange lists what the phase signed, no more
        interchange = store.slashing_db.export_interchange(gvr)
        got_blocks = {(r["pubkey"], int(b["slot"]), b["signing_root"])
                      for r in interchange["data"] for b in r["signed_blocks"]}
        got_atts = {(r["pubkey"], int(a["source_epoch"]), int(a["target_epoch"]), a["signing_root"])
                    for r in interchange["data"] for a in r["signed_attestations"]}
        member = {(d.slot, d.committee_index, d.committee_position): d.validator_index for d in duties}
        want_blocks, want_atts = set(), set()
        for p in published:
            if p["kind"] == "block":
                blk = p["item"].message
                sr = compute_signing_root(blk, schedule_domain(spec, spec.domain_beacon_proposer, int(blk.slot) // spe,
                                                               gvr))
                want_blocks.add((f"0x{pubkeys[int(blk.proposer_index)].hex()}", int(blk.slot), f"0x{sr.hex()}"))
            elif p["kind"] == "attestation" and p["out"] is True:
                d = p["item"].data
                vi = member[(int(d.slot), int(d.index), list(p["item"].aggregation_bits).index(True))]
                sr = compute_signing_root(d, schedule_domain(spec, spec.domain_beacon_attester, int(d.target.epoch),
                                                             gvr))
                want_atts.add((f"0x{pubkeys[vi].hex()}", int(d.source.epoch), int(d.target.epoch), f"0x{sr.hex()}"))
        assert len(interchange["data"]) == n and interchange["metadata"]["genesis_validators_root"] == f"0x{gvr.hex()}"
        assert got_blocks == want_blocks and got_atts == want_atts, \
            f"the interchange lists {len(got_blocks)} blocks and {len(got_atts)} attestations, " \
            f"the phase signed {len(want_blocks)} and {len(want_atts)}"
        phase("vc", step="interchange", validators=len(interchange["data"]), blocks=len(got_blocks),
              attestations=len(got_atts), equal_to_signed=True, card=f'"{card}"')

        # the client's own /metrics and /health
        duties1 = duty_counts()
        grown = {k: int(v - duties0.get(k, 0.0)) for k, v in duties1.items() if v != duties0.get(k, 0.0)}
        health = json.loads(scrape("/health"))
        assert grown == vc.duty_totals == health["duties"] and grown["proposed"] == VC_SLOTS, \
            f"{VC_DUTIES_TOTAL.name} grew by {grown}; the client ran {vc.duty_totals}"
        assert health["keys"] == n and health["last_duty_slot"] == slots[-1], health
        phase("vc", step="metrics", family=VC_DUTIES_TOTAL.name, grown=json.dumps(grown, separators=(",", ":")),
              health_keys=health["keys"], last_duty_slot=health["last_duty_slot"], card=f'"{card}"')
    finally:
        api.verify_signature_sets_async, ap.batch_verify_gossip_aggregates = verify_async, admit_aggregates
        for srv in reversed(stop):
            srv.stop()
        if store is not None:
            store.slashing_db.close()
        if lock is not None:
            lock.release()
        tmp.cleanup()
    seconds = time.perf_counter() - t_phase
    assert seconds < VC_MAX_S, f"[vc] took {seconds:.1f} s, more than {VC_MAX_S} s"
    phase("vc", seconds=f"{seconds:.2f}", slot_signatures=sum(r["signatures"] for r in rows), verifies=len(verifies),
          http_requests=len(http), card=f'"{card}"')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, h2c, kernels, pairing, registry, tower

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
          product_reduce=f'"{ptxas_summary(log, "product_reduce_kernel")}"',
          final_exponentiation=f'"{ptxas_summary(log, "final_exponentiation_kernel")}"',
          g2_psi_check=f'"{ptxas_summary(log, "g2_psi_check_kernel")}"',
          miller_inputs=f'"{ptxas_summary(log, "miller_inputs_kernel")}"',
          g1_to_affine=f'"{ptxas_summary(log, "g1_to_affine_kernel")}"',
          g2_to_affine=f'"{ptxas_summary(log, "g2_to_affine_kernel")}"',
          fp6_mul=f'"{ptxas_summary(log, "fp6_mul_kernel")}"',
          fp2_inv=f'"{ptxas_summary(log, "fp2_inv_kernel")}"',
          **{k: f'"{ptxas_summary(log, f"{k}_kernel")}"' for k in STANDALONE_SHAPES})

    check_kernels(torch, fp, P, dev)
    check_tower_kernels(torch, fp, tower, P, dev)
    chains, verdicts = chain_cases(torch, fp, curve, tower, pairing, api, h2c, P)
    check_chain_kernels(torch, chains, verdicts)
    edges = fold_cases(torch, fp, curve, tower, pairing, h2c, P, [(2, n) for n in FOLD_LENGTHS], FOLD_LENGTHS,
                       COFACTOR_EDGE, REDUCE_COUNTS, 29, nosum=True)
    check_chain_kernels(torch, edges)
    check_chain_kernels(torch, lane_cases(torch, fp, curve, tower, pairing, SCALAR_MUL_COUNTS, MILLER_COUNTS, 36,
                                          G1_SCALAR_MUL_COUNTS))
    check_chain_kernels(torch, sswu_cases(torch, fp, tower, h2c, P, SQRT_COUNTS, 37))
    check_chain_kernels(torch, iso3_cases(torch, fp, tower, h2c, P, SQRT_COUNTS, 38))
    check_chain_kernels(torch, psi_edge_cases(torch, fp, curve, h2c, P, PSI_EDGE, 39))
    fe_edges = fp12_inputs(fp, tower, P, FINAL_EXP_EDGE, 32, DEVICE)  # p - 1 in every word slot, zero, one
    glue, verdicts = glue_cases(torch, fp, curve, tower, pairing, api, h2c, P,
                                {f"final_exponentiation_n{FINAL_EXP_EDGE}": fe_edges,
                                 "final_exponentiation_zero": fe_edges[1:2]},
                                [PSI_EDGE], MILLER_INPUTS_EDGE, 33)
    check_chain_kernels(torch, glue, verdicts)
    check_chain_kernels(torch, affine_cases(torch, fp, curve, tower, P, {
        "g1_to_affine": AFFINE_COUNTS, "g2_to_affine": AFFINE_COUNTS, "fp2_inv": AFFINE_COUNTS,
        "fp6_mul": FP6_COUNTS}, 34))
    check_chain_kernels(torch, standalone_cases(torch, fp, curve, tower, pairing, h2c, P, STANDALONE_COUNTS, 35)[0])

    t0 = time.perf_counter()
    invalid = list(invalid_encodings().values())
    with host_pool() as pool:
        pubkeys = pool.map(interop_public_key, range(max(PK_DISTINCT, BLOCK_KEYS, 8)))
        valid = [pk.to_bytes() for pk in pubkeys[:PK_DISTINCT]]
        oracle = dict(zip(valid + invalid, pool.map(oracle_pk_verdict, valid + invalid)))
    gossip = make_sets(api, N_SETS, 1, pubkeys)
    block = make_sets(api, N_SETS, BLOCK_KEYS, pubkeys)
    bad_sig = non_subgroup_signature(api)
    assert all(oracle[kb] for kb in valid) and not any(oracle[kb] for kb in invalid)
    phase("setup", host_seconds=f"{time.perf_counter() - t0:.2f}", pk_distinct=len(valid), pk_invalid=len(invalid))

    check_g1_kernel(torch, api, fp, curve, valid, invalid)

    gossip_shape, block_shape = f"{N_SETS}x1", f"{N_SETS}x{BLOCK_KEYS}"
    ok_g, launches_g, gossip_ms = run_verify(torch, api, fp, gossip, gossip_shape, name_power)
    ok_b, launches_b, block_ms = run_verify(torch, api, fp, block, block_shape, name_power)
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
    results = time_kernels(torch, fp, tower, P, dev, {**launches_b, "fp_mul_mma": mxu_launches["fp_mul_mma"]},
                           peak_ops, log)
    results += time_chain_kernels(torch, fp, P, chains, launches_b, peak_ops, log)
    time_tree_levels(torch, fp, curve)
    time_reduce_levels(torch, fp, tower, pairing, P)
    results.append(time_g1_kernel(torch, api, fp, curve, pk_keys, pk_launches, peak_ops, log))
    offpath_rows = time_offpath_kernels(torch, fp, offpath_timed(torch, fp, curve, tower, pairing, h2c, P),
                                        launches_b, peak_ops, log)
    registry_launches = run_registry(torch, fp, registry, dev)
    for row in offpath_rows:
        row["launches"] = registry_launches[row["name"]]
    results += offpath_rows
    check_extras(torch, fp, tower, P)
    check_parity(torch, api, fp, pairing)
    run_sharded(torch, api, fp, pairing, name_power)
    run_coalescer(torch, api, fp, name_power)
    harness = run_chain(torch, api, fp, name_power)
    run_conformance(torch, api, fp, name_power)
    run_gossip(torch, api, fp, name_power, harness)
    run_sync(torch, api, fp, name_power, harness)
    run_vc(torch, api, fp, name_power, harness)

    seconds = time.perf_counter() - t_start
    phase("done", seconds=f"{seconds:.1f}", empty_traces_retaken=EMPTY_TRACES,
          partial_traces_retaken=PARTIAL_TRACES, most_tries_a_trace=TRACE_TRIES_MOST)
    assert seconds < DONE_MAX_S, f"the run took {seconds:.1f} s, more than {DONE_MAX_S} s"
    print(json.dumps({"kernels": results}))
    print(name_power)
    # the run drives cuda:0 only, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
