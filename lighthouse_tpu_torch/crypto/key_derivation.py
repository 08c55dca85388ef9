"""EIP-2333 hierarchical BLS key derivation.

Counterpart of lighthouse/crypto/eth2_key_derivation (DerivedKey,
src/lib.rs:1-6): HKDF-SHA256 with Lamport round-trips, `derive_master_sk`
from a seed and `derive_child_sk` by index. Pinned to the EIP-2333 test
vector in tests/test_torch_keys_parity.py.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac

from .bls.constants import R


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return _hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes) -> list[bytes]:
    prk = _hkdf_extract(salt, ikm)
    okm = _hkdf_expand(prk, b"", 8160)  # 255 * 32
    return [okm[i * 32 : (i + 1) * 32] for i in range(255)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport_0 = _ikm_to_lamport_sk(ikm, salt)
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport_1 = _ikm_to_lamport_sk(not_ikm, salt)
    pk = b"".join(hashlib.sha256(x).digest() for x in lamport_0 + lamport_1)
    return hashlib.sha256(pk).digest()


def _hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("seed must be at least 32 bytes")
    return _hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    if not 0 <= index < 2**32:
        raise ValueError("index out of range")
    return _hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_path(seed: bytes, path: str) -> int:
    """Derive along an EIP-2334 path like 'm/12381/3600/0/0/0'."""
    parts = path.strip().split("/")
    if parts[0] != "m":
        raise ValueError("path must start with m")
    sk = derive_master_sk(seed)
    for p in parts[1:]:
        sk = derive_child_sk(sk, int(p))
    return sk


def validator_signing_path(index: int) -> str:
    """EIP-2334 signing-key path for validator `index`."""
    return f"m/12381/3600/{index}/0/0"


def validator_withdrawal_path(index: int) -> str:
    return f"m/12381/3600/{index}/0"
