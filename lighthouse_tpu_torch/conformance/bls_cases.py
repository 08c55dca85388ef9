"""BLS conformance cases: the 7 eth2 bls runner case types, byte-level.

Mirrors lighthouse/testing/ef_tests/src/cases/bls_{sign,verify,
aggregate,aggregate_verify,fast_aggregate_verify,eth_aggregate_pubkeys,
eth_fast_aggregate_verify}.rs. Inputs/outputs are wire bytes so every
backend performs its own decoding — deserialization edge cases (invalid
flags, off-curve, non-subgroup, infinity) are part of the contract.

The official consensus-spec-tests archive is not available offline;
`generate_bls_cases()` deterministically regenerates the same behavioral
coverage against the pure-Python oracle: valid sign/verify/aggregate paths,
wrong-message / wrong-key / tampered-signature negatives, zero secret keys,
infinity pubkeys, the altair G2_POINT_AT_INFINITY rule, non-subgroup points
(constructed on-curve, off-subgroup), and malformed encodings.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any

ERROR = "error"  # expected-outcome sentinel for invalid-input cases

ALL_CASE_TYPES = (
    "sign",
    "verify",
    "aggregate",
    "aggregate_verify",
    "fast_aggregate_verify",
    "eth_aggregate_pubkeys",
    "eth_fast_aggregate_verify",
)


@dataclass
class BlsCase:
    case_type: str
    name: str
    input: dict
    expected: Any  # bytes (output), bool (verdict), or ERROR


# -- non-subgroup / off-curve fixture points -----------------------------------


@lru_cache(maxsize=1)
def _non_subgroup_points() -> tuple[bytes, bytes]:
    """Compressed (G1-shaped, G2-shaped) points that are on-curve but NOT in
    the r-order subgroup — the deserialization edge the psi/full-order
    checks exist for."""
    from ..crypto.bls.constants import R
    from ..crypto.bls.ref.api import g1_to_compressed, g2_to_compressed
    from ..crypto.bls.ref.curves import Point, _B1, _B2
    from ..crypto.bls.ref.fields import Fp, Fp2

    def find_g1() -> bytes:
        x = 1
        while True:
            x += 1
            rhs = Fp(x) * Fp(x) * Fp(x) + _B1
            y = rhs.sqrt()
            if y is None:
                continue
            pt = Point(Fp(x), y, False, _B1)
            if not pt.mul(R).inf:  # not killed by r => outside the subgroup
                return g1_to_compressed(pt)

    def find_g2() -> bytes:
        x = 0
        while True:
            x += 1
            xe = Fp2(Fp(x), Fp(1))
            rhs = xe * xe * xe + _B2
            y = rhs.sqrt()
            if y is None:
                continue
            pt = Point(xe, y, False, _B2)
            if not pt.mul(R).inf:
                return g2_to_compressed(pt)

    return find_g1(), find_g2()


INFINITY_PUBKEY = bytes([0xC0]) + bytes(47)
INFINITY_SIGNATURE = bytes([0xC0]) + bytes(95)


def generate_bls_cases() -> list[BlsCase]:
    """Deterministic vector generation against the oracle backend."""
    from ..crypto.bls.ref import api as oracle

    sks = [oracle.interop_secret_key(i) for i in range(4)]
    pks = [sk.public_key() for sk in sks]
    pk_b = [pk.to_bytes() for pk in pks]
    msgs = [bytes([i]) * 32 for i in range(4)]

    sig0 = sks[0].sign(msgs[0])
    sigs_same = [sk.sign(msgs[0]) for sk in sks]
    agg_same = oracle.aggregate_signatures(sigs_same)
    sigs_distinct = [sk.sign(m) for sk, m in zip(sks, msgs)]
    agg_distinct = oracle.aggregate_signatures(sigs_distinct)

    tampered = bytearray(sig0.to_bytes())
    tampered[17] ^= 0x01  # almost surely off-curve after decompression
    bad_flags = bytearray(sig0.to_bytes())
    bad_flags[0] &= 0x3F  # clear the compression flag: invalid encoding
    non_sub_g1, non_sub_g2 = _non_subgroup_points()

    cases: list[BlsCase] = []
    add = cases.append

    # -- sign (bls_sign.rs) ----------------------------------------------------
    add(BlsCase("sign", "sign_basic", {"privkey": sks[0].to_bytes(), "message": msgs[0]}, sig0.to_bytes()))
    add(BlsCase("sign", "sign_other_key", {"privkey": sks[1].to_bytes(), "message": msgs[1]}, sks[1].sign(msgs[1]).to_bytes()))
    add(BlsCase("sign", "sign_zero_privkey", {"privkey": bytes(32), "message": msgs[0]}, ERROR))

    # -- verify (bls_verify.rs) ------------------------------------------------
    add(BlsCase("verify", "verify_valid", {"pubkey": pk_b[0], "message": msgs[0], "signature": sig0.to_bytes()}, True))
    add(BlsCase("verify", "verify_wrong_message", {"pubkey": pk_b[0], "message": msgs[1], "signature": sig0.to_bytes()}, False))
    add(BlsCase("verify", "verify_wrong_key", {"pubkey": pk_b[1], "message": msgs[0], "signature": sig0.to_bytes()}, False))
    add(BlsCase("verify", "verify_tampered_signature", {"pubkey": pk_b[0], "message": msgs[0], "signature": bytes(tampered)}, False))
    add(BlsCase("verify", "verify_bad_flags_signature", {"pubkey": pk_b[0], "message": msgs[0], "signature": bytes(bad_flags)}, False))
    add(BlsCase("verify", "verify_infinity_pubkey", {"pubkey": INFINITY_PUBKEY, "message": msgs[0], "signature": INFINITY_SIGNATURE}, False))
    add(BlsCase("verify", "verify_non_subgroup_pubkey", {"pubkey": non_sub_g1, "message": msgs[0], "signature": sig0.to_bytes()}, False))
    add(BlsCase("verify", "verify_non_subgroup_signature", {"pubkey": pk_b[0], "message": msgs[0], "signature": non_sub_g2}, False))
    add(BlsCase("verify", "verify_short_signature", {"pubkey": pk_b[0], "message": msgs[0], "signature": sig0.to_bytes()[:95]}, False))

    # -- aggregate (bls_aggregate.rs) ------------------------------------------
    add(BlsCase("aggregate", "aggregate_two", {"signatures": [s.to_bytes() for s in sigs_same[:2]]}, oracle.aggregate_signatures(sigs_same[:2]).to_bytes()))
    add(BlsCase("aggregate", "aggregate_four", {"signatures": [s.to_bytes() for s in sigs_same]}, agg_same.to_bytes()))
    add(BlsCase("aggregate", "aggregate_single", {"signatures": [sig0.to_bytes()]}, sig0.to_bytes()))
    add(BlsCase("aggregate", "aggregate_empty", {"signatures": []}, ERROR))
    add(BlsCase("aggregate", "aggregate_infinity", {"signatures": [INFINITY_SIGNATURE, sig0.to_bytes()]}, sig0.to_bytes()))

    # -- aggregate_verify (bls_aggregate_verify.rs) ----------------------------
    add(BlsCase("aggregate_verify", "aggregate_verify_valid", {"pubkeys": pk_b, "messages": msgs, "signature": agg_distinct.to_bytes()}, True))
    add(BlsCase("aggregate_verify", "aggregate_verify_shuffled_messages", {"pubkeys": pk_b, "messages": msgs[::-1], "signature": agg_distinct.to_bytes()}, False))
    add(BlsCase("aggregate_verify", "aggregate_verify_missing_signer", {"pubkeys": pk_b[:3], "messages": msgs[:3], "signature": agg_distinct.to_bytes()}, False))
    add(BlsCase("aggregate_verify", "aggregate_verify_empty", {"pubkeys": [], "messages": [], "signature": agg_distinct.to_bytes()}, False))
    add(BlsCase("aggregate_verify", "aggregate_verify_infinity_pubkey", {"pubkeys": [pk_b[0], INFINITY_PUBKEY], "messages": msgs[:2], "signature": agg_distinct.to_bytes()}, False))

    # -- fast_aggregate_verify (bls_fast_aggregate_verify.rs) ------------------
    add(BlsCase("fast_aggregate_verify", "fast_valid_two", {"pubkeys": pk_b[:2], "message": msgs[0], "signature": oracle.aggregate_signatures(sigs_same[:2]).to_bytes()}, True))
    add(BlsCase("fast_aggregate_verify", "fast_valid_four", {"pubkeys": pk_b, "message": msgs[0], "signature": agg_same.to_bytes()}, True))
    add(BlsCase("fast_aggregate_verify", "fast_extra_pubkey", {"pubkeys": pk_b[:3], "message": msgs[0], "signature": oracle.aggregate_signatures(sigs_same[:2]).to_bytes()}, False))
    add(BlsCase("fast_aggregate_verify", "fast_wrong_message", {"pubkeys": pk_b[:2], "message": msgs[1], "signature": oracle.aggregate_signatures(sigs_same[:2]).to_bytes()}, False))
    add(BlsCase("fast_aggregate_verify", "fast_empty_pubkeys", {"pubkeys": [], "message": msgs[0], "signature": agg_same.to_bytes()}, False))
    add(BlsCase("fast_aggregate_verify", "fast_infinity_pubkey_in_list", {"pubkeys": [pk_b[0], INFINITY_PUBKEY], "message": msgs[0], "signature": sig0.to_bytes()}, False))
    add(BlsCase("fast_aggregate_verify", "fast_tampered_signature", {"pubkeys": pk_b[:2], "message": msgs[0], "signature": bytes(tampered)}, False))
    add(BlsCase("fast_aggregate_verify", "fast_infinity_signature", {"pubkeys": pk_b[:2], "message": msgs[0], "signature": INFINITY_SIGNATURE}, False))

    # -- eth_aggregate_pubkeys (bls_eth_aggregate_pubkeys.rs) ------------------
    add(BlsCase("eth_aggregate_pubkeys", "eth_agg_pk_two", {"pubkeys": pk_b[:2]}, oracle.aggregate_public_keys(pks[:2]).to_bytes()))
    add(BlsCase("eth_aggregate_pubkeys", "eth_agg_pk_single", {"pubkeys": pk_b[:1]}, pk_b[0]))
    add(BlsCase("eth_aggregate_pubkeys", "eth_agg_pk_empty", {"pubkeys": []}, ERROR))
    add(BlsCase("eth_aggregate_pubkeys", "eth_agg_pk_infinity", {"pubkeys": [INFINITY_PUBKEY]}, ERROR))
    add(BlsCase("eth_aggregate_pubkeys", "eth_agg_pk_non_subgroup", {"pubkeys": [non_sub_g1]}, ERROR))

    # -- eth_fast_aggregate_verify (bls_eth_fast_aggregate_verify.rs) ----------
    add(BlsCase("eth_fast_aggregate_verify", "eth_fast_valid", {"pubkeys": pk_b[:2], "message": msgs[0], "signature": oracle.aggregate_signatures(sigs_same[:2]).to_bytes()}, True))
    add(BlsCase("eth_fast_aggregate_verify", "eth_fast_infinity_no_keys", {"pubkeys": [], "message": msgs[0], "signature": INFINITY_SIGNATURE}, True))
    add(BlsCase("eth_fast_aggregate_verify", "eth_fast_nonempty_infinity_sig", {"pubkeys": pk_b[:1], "message": msgs[0], "signature": INFINITY_SIGNATURE}, False))
    add(BlsCase("eth_fast_aggregate_verify", "eth_fast_wrong_message", {"pubkeys": pk_b[:2], "message": msgs[1], "signature": oracle.aggregate_signatures(sigs_same[:2]).to_bytes()}, False))

    return cases


# -- runner --------------------------------------------------------------------


def _decode(bls, kind: str, data: bytes):
    cls = {"pk": bls.PublicKey, "sig": bls.Signature, "sk": bls.SecretKey}[kind]
    return cls.from_bytes(bytes(data))


def run_case(case: BlsCase, bls) -> None:
    """Execute `case` against backend module `bls`; raises AssertionError on
    behavioral mismatch. Decode failures on verify-type cases mean False
    (handler semantics: invalid inputs fail verification, they don't
    crash the runner — ef_tests cases.rs)."""
    t, inp, expected = case.case_type, case.input, case.expected

    def verdict(fn) -> bool:
        try:
            return bool(fn())
        except bls.DecodeError:
            return False

    if t == "sign":
        try:
            sig = _decode(bls, "sk", inp["privkey"]).sign(inp["message"])
        except (bls.DecodeError, ValueError):
            assert expected is ERROR, f"{case.name}: unexpected sign error"
            return
        assert expected is not ERROR, f"{case.name}: expected error, got signature"
        assert sig.to_bytes() == expected, f"{case.name}: signature mismatch"
    elif t == "verify":
        got = verdict(
            lambda: _decode(bls, "sig", inp["signature"]).verify(
                _decode(bls, "pk", inp["pubkey"]), inp["message"]
            )
        )
        assert got == expected, f"{case.name}: verify -> {got}, want {expected}"
    elif t == "aggregate":
        try:
            sigs = [_decode(bls, "sig", s) for s in inp["signatures"]]
            agg = bls.aggregate_signatures(sigs)
        except (bls.DecodeError, ValueError):
            assert expected is ERROR, f"{case.name}: unexpected aggregate error"
            return
        assert expected is not ERROR, f"{case.name}: expected error"
        assert agg.to_bytes() == expected, f"{case.name}: aggregate mismatch"
    elif t == "aggregate_verify":
        def do():
            sig = _decode(bls, "sig", inp["signature"])
            pks = [_decode(bls, "pk", p) for p in inp["pubkeys"]]
            return sig.aggregate_verify(pks, list(inp["messages"]))

        got = verdict(do)
        assert got == expected, f"{case.name}: aggregate_verify -> {got}, want {expected}"
    elif t in ("fast_aggregate_verify", "eth_fast_aggregate_verify"):
        def do():
            sig = _decode(bls, "sig", inp["signature"])
            pks = [_decode(bls, "pk", p) for p in inp["pubkeys"]]
            fn = getattr(sig, t)
            return fn(pks, inp["message"])

        got = verdict(do)
        assert got == expected, f"{case.name}: {t} -> {got}, want {expected}"
    elif t == "eth_aggregate_pubkeys":
        try:
            pks = [_decode(bls, "pk", p) for p in inp["pubkeys"]]
            agg = bls.aggregate_public_keys(pks)
        except (bls.DecodeError, ValueError):
            assert expected is ERROR, f"{case.name}: unexpected error"
            return
        assert expected is not ERROR, f"{case.name}: expected error"
        assert agg.to_bytes() == expected, f"{case.name}: pubkey aggregate mismatch"
    else:  # pragma: no cover
        raise ValueError(f"unknown case type {t}")
