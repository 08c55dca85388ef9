"""EIP-2335 encrypted BLS keystores.

Counterpart of lighthouse/crypto/eth2_keystore (Keystore,
src/lib.rs:1-15): scrypt or pbkdf2 KDF, AES-128-CTR cipher, SHA-256
checksum, JSON wire format with crypto/path/pubkey/uuid fields.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import unicodedata
import uuid as _uuid

try:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    _HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:  # container without the wheel: pure fallback
    _HAVE_CRYPTOGRAPHY = False

from . import aes as _aes


class KeystoreError(ValueError):
    pass


def _normalize_password(password: str) -> bytes:
    """EIP-2335: NFKD-normalize and strip C0/C1/Delete control codes."""
    norm = unicodedata.normalize("NFKD", password)
    return "".join(c for c in norm if unicodedata.category(c) != "Cc").encode()


def _kdf(password: bytes, kdf: dict) -> bytes:
    params = kdf["params"]
    salt = bytes.fromhex(params["salt"])
    if kdf["function"] == "scrypt":
        return hashlib.scrypt(
            password,
            salt=salt,
            n=params["n"],
            r=params["r"],
            p=params["p"],
            dklen=params["dklen"],
            maxmem=256 * 1024 * 1024,
        )
    if kdf["function"] == "pbkdf2":
        if params.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeystoreError("unsupported prf")
        return hashlib.pbkdf2_hmac("sha256", password, salt, params["c"], params["dklen"])
    raise KeystoreError(f"unsupported kdf {kdf['function']}")


def _aes128ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    if _HAVE_CRYPTOGRAPHY:
        cipher = Cipher(algorithms.AES(key), modes.CTR(iv))
        enc = cipher.encryptor()
        return enc.update(data) + enc.finalize()
    return _aes.aes128_ctr(key, iv, data)


def encrypt(
    secret: bytes,
    password: str,
    path: str = "",
    pubkey: str = "",
    kdf_function: str = "scrypt",
    kdf_params: dict | None = None,
) -> dict:
    """Build an EIP-2335 keystore dict for `secret` (a 32-byte BLS SK)."""
    if kdf_params is None:
        if kdf_function == "scrypt":
            kdf_params = {"n": 262144, "r": 8, "p": 1, "dklen": 32}
        else:
            kdf_params = {"c": 262144, "dklen": 32}
    kdf_params = dict(kdf_params)
    kdf_params["salt"] = secrets.token_bytes(32).hex()
    kdf = {"function": kdf_function, "params": kdf_params, "message": ""}

    dk = _kdf(_normalize_password(password), kdf)
    iv = secrets.token_bytes(16)
    ciphertext = _aes128ctr(dk[:16], iv, secret)
    checksum = hashlib.sha256(dk[16:32] + ciphertext).digest()

    return {
        "crypto": {
            "kdf": kdf,
            "checksum": {"function": "sha256", "params": {}, "message": checksum.hex()},
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": ciphertext.hex(),
            },
        },
        "path": path,
        "pubkey": pubkey,
        "uuid": str(_uuid.uuid4()),
        "version": 4,
    }


def decrypt(keystore: dict, password: str) -> bytes:
    crypto = keystore["crypto"]
    if keystore.get("version") != 4:
        raise KeystoreError("unsupported keystore version")
    if crypto["cipher"]["function"] != "aes-128-ctr":
        raise KeystoreError("unsupported cipher")
    dk = _kdf(_normalize_password(password), crypto["kdf"])
    ciphertext = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + ciphertext).digest()
    import hmac as _hmac_mod

    if not _hmac_mod.compare_digest(checksum, bytes.fromhex(crypto["checksum"]["message"])):
        raise KeystoreError("invalid password (checksum mismatch)")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return _aes128ctr(dk[:16], iv, ciphertext)


def save(keystore: dict, path: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(keystore, f, indent=2)
    os.replace(tmp, path)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
