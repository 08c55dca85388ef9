"""The `fake_crypto` backend: serialization-stable, always-valid BLS types.

Mirrors the reference's third compile-time backend
(lighthouse/crypto/bls/src/impls/fake_crypto.rs): points are opaque byte
blobs, every cryptographic verification returns True, and (de)serialization is
the identity. This lets state-transition / fork-choice conformance vectors that
contain unsignable data run without real BLS, and makes non-crypto tests fast —
the reference CI runs its whole ef_tests matrix once per backend for exactly
this reason (lighthouse/Makefile:98-103).

Structural (non-cryptographic) failure modes are preserved so that code paths
exercising them behave identically across backends: byte-length checks, the
zero-secret-key rejection, and empty-list rules in the aggregate APIs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .constants import PUBLIC_KEY_BYTES_LEN, SECRET_KEY_BYTES_LEN, SIGNATURE_BYTES_LEN

NAME = "fake"


class DecodeError(ValueError):
    pass


INFINITY_PUBLIC_KEY = bytes([0xC0]) + bytes(PUBLIC_KEY_BYTES_LEN - 1)
INFINITY_SIGNATURE = bytes([0xC0]) + bytes(SIGNATURE_BYTES_LEN - 1)


class SecretKey:
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise DecodeError(f"secret key must be {SECRET_KEY_BYTES_LEN} bytes")
        if data == bytes(SECRET_KEY_BYTES_LEN):
            # The reference rejects all-zero secret keys even in fake_crypto
            # (generic_secret_key.rs deserialize guard).
            raise DecodeError("zero secret key rejected")
        self._bytes = bytes(data)

    @staticmethod
    def from_bytes(data: bytes) -> "SecretKey":
        return SecretKey(data)

    @staticmethod
    def random() -> "SecretKey":
        import secrets as _s

        return SecretKey(_s.token_bytes(SECRET_KEY_BYTES_LEN))

    def to_bytes(self) -> bytes:
        return self._bytes

    def public_key(self) -> "PublicKey":
        # Deterministic, distinct per key: fold the secret through SHA-256 so
        # equality semantics of derived pubkeys match the real backends.
        digest = hashlib.sha256(b"fake-pk" + self._bytes).digest()
        return PublicKey(digest + digest[: PUBLIC_KEY_BYTES_LEN - len(digest)])

    def sign(self, message: bytes) -> "Signature":
        h = hashlib.sha256(b"fake-sig" + self._bytes + message).digest()
        return Signature((h * 3)[:SIGNATURE_BYTES_LEN])


class PublicKey:
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUBLIC_KEY_BYTES_LEN:
            raise DecodeError(f"public key must be {PUBLIC_KEY_BYTES_LEN} bytes")
        self._bytes = bytes(data)

    @staticmethod
    def from_bytes(data: bytes) -> "PublicKey":
        return PublicKey(data)

    def to_bytes(self) -> bytes:
        return self._bytes

    def __eq__(self, o):
        return isinstance(o, PublicKey) and self._bytes == o._bytes

    def __hash__(self):
        return hash(self._bytes)


def aggregate_public_keys(pks: list[PublicKey]) -> PublicKey:
    if not pks:
        raise ValueError("cannot aggregate empty pubkey list")
    return PublicKey(INFINITY_PUBLIC_KEY)


class Signature:
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != SIGNATURE_BYTES_LEN:
            raise DecodeError(f"signature must be {SIGNATURE_BYTES_LEN} bytes")
        self._bytes = bytes(data)

    @staticmethod
    def from_bytes(data: bytes) -> "Signature":
        return Signature(data)

    def to_bytes(self) -> bytes:
        return self._bytes

    @staticmethod
    def infinity() -> "Signature":
        return Signature(INFINITY_SIGNATURE)

    def is_infinity(self) -> bool:
        return self._bytes == INFINITY_SIGNATURE

    def verify(self, pk: PublicKey, message: bytes) -> bool:
        return True

    def aggregate_verify(self, pks: list[PublicKey], messages: list[bytes]) -> bool:
        if not pks or len(pks) != len(messages):
            return False
        return True

    def fast_aggregate_verify(self, pks: list[PublicKey], message: bytes) -> bool:
        if not pks:
            return False
        return True

    def eth_fast_aggregate_verify(self, pks: list[PublicKey], message: bytes) -> bool:
        if not pks and self.is_infinity():
            return True
        return self.fast_aggregate_verify(pks, message)

    def __eq__(self, o):
        return isinstance(o, Signature) and self._bytes == o._bytes

    def __hash__(self):
        return hash(self._bytes)


def aggregate_signatures(sigs: list[Signature]) -> Signature:
    if not sigs:
        raise ValueError("cannot aggregate empty signature list")
    return Signature.infinity()


@dataclass
class SignatureSet:
    signature: Signature
    signing_keys: list[PublicKey]
    message: bytes


def verify_signature_set(s: SignatureSet) -> bool:
    return bool(s.signing_keys)


def verify_signature_sets(sets: list[SignatureSet], rng=None) -> bool:
    """Always true, matching fake_crypto.rs verify_signature_sets — except the
    empty-batch / empty-keys structural rules shared by every backend."""
    if not sets:
        return False
    return all(bool(s.signing_keys) for s in sets)


def interop_secret_key(validator_index: int) -> SecretKey:
    """Same derivation as the real backends
    (lighthouse/common/eth2_interop_keypairs/src/lib.rs:44-58) so that
    fake-backend fixtures carry byte-identical secret keys."""
    from .constants import R

    preimage = validator_index.to_bytes(8, "little") + bytes(24)
    k = int.from_bytes(hashlib.sha256(preimage).digest(), "little") % R
    return SecretKey(k.to_bytes(32, "big"))


def interop_keypair(validator_index: int) -> tuple[SecretKey, PublicKey]:
    sk = interop_secret_key(validator_index)
    return sk, sk.public_key()
