"""Shared helpers of the tests that hold lighthouse_tpu_torch against the JAX
package (tests/test_torch_*.py).

Inputs are made from a seed and handed to both sides as numpy arrays: the
JAX side takes (..., 32) twelve-bit limbs, the port (..., 12) 32-bit words
on the CPU, where its kernel wrappers run their plain versions. Every
comparison is exact.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import torch

from lighthouse_tpu.crypto.bls.constants import P, R
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu.crypto.bls.ref.curves import Point, _B2
from lighthouse_tpu.crypto.bls.ref.fields import Fp, Fp2
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp

# The plain versions are many small tensor operations; one intra-op thread
# per test process keeps xdist workers from oversubscribing the cores.
torch.set_num_threads(1)

EDGES = [0, 1, P - 1, P - 2]


def rand_fp_ints(seed: int, n: int) -> list[int]:
    """The edge values 0, 1, p-1, p-2, then random elements: n in all."""
    rng = random.Random(seed)
    return EDGES + [rng.randrange(P) for _ in range(n - len(EDGES))]


def mont_limbs(xs) -> np.ndarray:
    """Montgomery-form JAX limbs (n, 32) of Python ints."""
    return jfp.to_mont_host_bulk(xs)


def to_port(limbs) -> torch.Tensor:
    """JAX limbs (numpy or jax array) -> port words on the CPU."""
    return tfp.from_jax_limbs(np.asarray(limbs))


def assert_same(port_out: torch.Tensor, jax_out) -> None:
    """Port words and JAX limbs hold the same integers, exactly."""
    got = tfp.to_jax_limbs(port_out)
    want = np.asarray(jax_out)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = np.argwhere((got != want).any(axis=-1))
    assert bad.size == 0, f"{len(bad)} elements differ, first at {bad[:4].tolist()}"


# -- signature-set batches for the verdict tests ---------------------------------

MSGS = [bytes([0x10 + i]) * 32 for i in range(4)]


def signature_sets(b, spec):
    """SignatureSets of backend module `b` from (key indices, message index)
    pairs; each signature aggregates its signers' signatures."""
    out = []
    for keys, m in spec:
        pairs = [b.interop_keypair(k) for k in keys]
        sig = b.aggregate_signatures([sk.sign(MSGS[m]) for sk, _ in pairs])
        out.append(b.SignatureSet(signature=sig, signing_keys=[pk for _, pk in pairs], message=MSGS[m]))
    return out


#: 3 sets (S bucket 4), up to 2 keys each (K bucket 2)
SPEC = [((0,), 0), ((1, 2), 1), ((3,), 2)]


@functools.lru_cache(maxsize=1)
def _non_subgroup_sig_bytes():
    """A compressed point on E2 outside the r-torsion subgroup."""
    x = 0
    while True:
        x += 1
        xe = Fp2(Fp(x), Fp(1))
        y = (xe * xe * xe + _B2).sqrt()
        if y is not None:
            pt = Point(xe, y, False, _B2)
            if not pt.mul(R).inf:
                return ref.g2_to_compressed(pt)


@functools.lru_cache(maxsize=None)
def base_sets(b):
    return tuple(signature_sets(b, SPEC))


def verdict_batch(b, kind):
    """SPEC's batch for backend module `b`, with set 1 spoiled per `kind`."""
    sets = list(base_sets(b))
    s = sets[1]
    if kind == "tampered_message":
        sets[1] = b.SignatureSet(s.signature, s.signing_keys, b"\x99" * 32)
    elif kind == "wrong_key":
        sets[1] = b.SignatureSet(s.signature, [s.signing_keys[0], b.interop_keypair(9)[1]], s.message)
    elif kind == "non_subgroup_signature":
        data = _non_subgroup_sig_bytes()
        sig = b.Signature(ref.g2_from_compressed(data, subgroup_check=False)) if b is ref else b.Signature.from_bytes(data)
        sets[1] = b.SignatureSet(sig, s.signing_keys, s.message)
    return sets


# -- compressed G1 pubkey encodings for the admission tests ------------------------


def curve_x(start: int, square: bool) -> int:
    """The first x >= start whose x^3 + 4 is a nonzero square (square=True)
    or a non-square (square=False) mod p."""
    x = start
    while pow((x * x * x + 4) % P, (P - 1) // 2, P) != (1 if square else P - 1):
        x += 1
    return x


def non_g1_point(start: int) -> Point:
    """A point of E(Fp) outside G1 with x >= start."""
    from lighthouse_tpu.crypto.bls.ref.curves import _B1

    x = start
    while True:
        x = curve_x(x, True)
        xe = Fp(x)
        pt = Point(xe, (xe * xe * xe + _B1).sqrt(), False, _B1)
        if not pt.mul(R).inf:
            return pt
        x += 1


#: the encodings of `pk_encodings`, in order
PK_KINDS = ("interop_0", "interop_1", "interop_2", "garbage", "infinity", "order_3", "non_g1", "x_ge_p",
            "not_on_curve")


@functools.lru_cache(maxsize=1)
def pk_encodings() -> dict:
    """name -> 48-byte compressed G1 encoding: three interop pubkeys and one
    of each invalid kind."""
    keys = {f"interop_{i}": ref.interop_keypair(i)[1].to_bytes() for i in range(3)}
    x_off = curve_x(5, False)
    keys.update({
        "garbage": b"\xff" * 48,
        "infinity": b"\xc0" + bytes(47),
        "order_3": b"\x80" + bytes(47),  # (0, 2): order 3, on the curve, not in G1
        "non_g1": ref.g1_to_compressed(non_g1_point(5)),
        "x_ge_p": b"\x9f" + b"\xff" * 47,
        "not_on_curve": bytes([0x80 | (x_off >> 376)]) + (x_off % (1 << 376)).to_bytes(47, "big"),
    })
    assert tuple(keys) == PK_KINDS
    return keys


def oracle_pk_verdict(kb: bytes) -> bool:
    """The ref oracle's admission verdict: decodes with the full subgroup
    check, and is not infinity."""
    try:
        return not ref.g1_from_compressed(kb).inf
    except ref.DecodeError:
        return False
