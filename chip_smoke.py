#!/usr/bin/env python3
"""Smoke run of lighthouse_tpu_torch on one CUDA GPU (written for an H100).

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

  1. device   require a CUDA device; print its name and power limit
  2. build    compile the hand-written kernels (csrc/) with nvcc, one
              process per source; K5's and K6's registers and spills
              from ptxas
  3. kernels  K1-K4 and K6 bit-identical to their plain PyTorch versions
              on the card: edge inputs 0, 1, p-1, p-2 and 4096 seeded
              random elements; batch inversion at N = 257 with zero
              lanes; K6 also against K1, at 4104 elements and at the
              tails 1, 31 and 33. After
              set-up, K5 bit-identical to its plain version (on CPU
              tensors) on 64 points: interop keys, the order-3 point
              (0, 2), points of E(Fp) outside G1 and infinity rows
  4. verify   the verify path, `verify_signature_sets`, on 128 sets x 1
              key and on the mainnet-block shape 128 sets x 128 keys: both
              True, with the kernels' launch counts of one verify; then a
              tampered message, a wrong key and a non-subgroup signature
              at 128 x 1, each False; warm ms per batch and sets/s
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
              launched as often as K1 was by default and K1 never; ms per
              batch with and without the flag, timed in turns; admission
              at S = 16 still one K5 launch and nothing else
  5. profile  device busy time, idle share and top kernels of one verify,
              by default and with the flag
     timing   each kernel at the shape that carries most of its main-path
              work, against its plain version and its bound (K6 at K1's
              shape, so the two compare)
     extras   to_affine (G1, G2), fp6_mul and fp6_inv on the card
              bit-identical to the same functions on CPU tensors
  6. parity   one S=4, K=2 batch: the card's Miller partial and GT value
              bit-identical to the same functions on the CPU
  7. sharded  `parallel.sharded.sharded_verify_signature_sets` in spawned
              ranks (kernels built by this process first, join under a
              time limit): NCCL over W = min(4, cards) ranks, one card
              each, and gloo over 2 ranks sharing cuda:0. Each world: a
              128 x 1 batch True and a tampered one False on every rank,
              with the kernels' launch counts of one sharded verify; a
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
              launches and wall time

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
# a*b, 12x12 for m*p, 12 for m.
WORD_PRODUCTS_PER_MUL = 300
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
REPLACES = {
    "fp_mul": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:310",
    "fp_addsub": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:294",
    "fp_pow": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:460",
    "fp_batch_inv": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:466",
    "g1_subgroup_check": "lighthouse_tpu/crypto/bls/jax_backend/api.py:599",
    "fp_mul_mma": "lighthouse_tpu/crypto/bls/jax_backend/fp.py:373",
}
VERIFY_KERNELS = ("fp_mul", "fp_addsub", "fp_pow", "fp_batch_inv")
# the verify path with fp.USE_MXU_MUL set: K6 in K1's place
MXU_KERNELS = ("fp_mul_mma", "fp_addsub", "fp_pow", "fp_batch_inv")
K6_TAILS = (1, 31, 33)
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
    # [z^2] P as two chains over |z|: per chain bit_length - 1 doublings (9
    # products) and popcount - 1 additions (14); phi and the comparison 5.
    absz = abs(X)
    muls = 2 * (absz.bit_length() - 1) * 9 + 2 * (bin(absz).count("1") - 1) * 14 + 5
    live = int((~infd).sum())
    t_ops = live * muls * WORD_PRODUCTS_PER_MUL / peak_ops_per_s * 1e3
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
    then WARM_REPS timed ones. Returns (verdict, launches, ms, shapes)."""
    torch.cuda.synchronize()
    fp.SHAPES = {} if record_shapes else None
    fp.reset_launches()
    ok = api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)
    shapes, fp.SHAPES = fp.SHAPES, None
    times = []
    for _ in range(WARM_REPS):
        t0 = time.perf_counter()
        again = api.verify_signature_sets(sets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert again == ok
    ms = statistics.median(times)
    phase(
        "verify", shape=label, result=ok, ms_per_batch=f"{ms:.3f}",
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


def heaviest_shape(counter):
    """The launch shape that carries the most elements over the main path's
    launches (count x elements; for K4 the shape is (steps, lanes))."""
    def work(kv):
        shape, count = kv
        elems = shape[0] * shape[1] if isinstance(shape, tuple) else shape
        return (count * elems, count)

    return max(counter.items(), key=work)[0]


def profile_verify(torch, api, sets, label: str, warm_ms: float) -> None:
    """Device busy time of one warm verify, from a torch.profiler trace of
    the device's activity only (a trace of every host-side operation of a
    verify is too large to summarise quickly), and the kernels that take
    the most device time. The idle share is taken against `warm_ms`, the
    median wall time of the same verify run without the profiler, which
    inflates the wall time of the verify it traces."""
    api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    rows, profiled_wall_ms = traced_device_events(lambda: api.verify_signature_sets(sets))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    top = [{"kernel": k[:60], "ms": round(us / 1e3, 3), "calls": c} for us, c, k in rows[:8]]
    phase("profile", shape=label, warm_wall_ms=f"{warm_ms:.3f}", profiled_wall_ms=f"{profiled_wall_ms:.1f}",
          device_busy_ms=f"{busy_ms:.3f}", idle_share=f"{1 - busy_ms / warm_ms:.4f}",
          device_calls=sum(r[1] for r in rows), top=json.dumps(top, separators=(",", ":")))


def time_kernels(torch, fp, P, dev, shapes, launches, peak_ops_per_s):
    """Each kernel at the shape that carries most of its main-path work:
    its device time per launch (profiler), its time per call from the host
    (CUDA events, launch overhead included), the plain version's time, the
    bound, and the largest word difference from the plain version. K6 runs
    at K1's shape: the flag gives it the same launches."""
    results = []
    pow_products = fp.INV_EXP.bit_length() + bin(fp.INV_EXP).count("1")
    for name in (*VERIFY_KERNELS, "fp_mul_mma"):
        shape = heaviest_shape(shapes["fp_mul" if name == "fp_mul_mma" else name])
        if name == "fp_batch_inv":
            steps, lanes = shape
            x = field_inputs(fp, P, steps * lanes, 3, dev)[8 : 8 + steps * lanes].reshape(steps, lanes, fp.WORDS)
            run, plain = (lambda: fp.batch_inv(x)), (lambda: fp.batch_inv_plain(x))
            elems = steps * lanes
            ops_s = lanes * (3 * steps - 1 + pow_products) * WORD_PRODUCTS_PER_MUL / peak_ops_per_s
            nbytes = 2 * 48 * elems
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
                ops_s, nbytes = n * pow_products * WORD_PRODUCTS_PER_MUL / peak_ops_per_s, 2 * 48 * n + 48
        saved = dict(fp.LAUNCHES)  # comparison launches are not main-path launches
        got, want = run(), plain()
        err = int(((got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        elementwise = name in ("fp_mul", "fp_addsub", "fp_mul_mma")
        reps = 50 if elementwise else 5
        call_ms = cuda_ms(run, reps)
        ms = kernel_device_ms(run, reps, f"{name}_kernel")
        plain_ms = cuda_ms(plain, 3 if elementwise else 1)
        fp.LAUNCHES.update(saved)
        t_ops, t_bytes = ops_s * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        results.append({
            "name": name, "route": "cuda", "source": MMA_SOURCE if name == "fp_mul_mma" else SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": list(shape) if isinstance(shape, tuple) else [shape],
            "ms_per_call": call_ms,
        })
        phase("timing", kernel=name, shape=shape, ms=f"{ms:.5f}", ms_per_call=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.3f}", bound_ms=f"{max(t_ops, t_bytes):.6f}", max_abs_err=err)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version at shape {shape}")
    return results


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
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, kernels, pairing, tower

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
          g1_subgroup_check=f'"{ptxas_summary(log, "g1_subgroup_check")}"',
          fp_mul_mma=f'"{ptxas_summary(log, "fp_mul_mma_kernel")}"')

    check_kernels(torch, fp, P, dev)

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
    ok_g, launches_g, _, _ = run_verify(torch, api, fp, gossip, gossip_shape, name_power)
    ok_b, launches_b, block_ms, shapes = run_verify(torch, api, fp, block, block_shape, name_power, record_shapes=True)
    assert ok_g and ok_b, "a valid batch did not verify"
    for launches in (launches_g, launches_b):
        missing = [k for k in VERIFY_KERNELS if launches[k] <= 0]
        assert not missing, f"kernels not launched by the verify path: {missing}"
        assert launches["fp_mul_mma"] == 0, "K6 launched on the default verify path"

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

    profile_verify(torch, api, block, block_shape, block_ms)
    results = time_kernels(torch, fp, P, dev, shapes, {**launches_b, "fp_mul_mma": mxu_launches["fp_mul_mma"]},
                           peak_ops)
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
