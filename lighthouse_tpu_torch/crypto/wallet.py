"""EIP-2386 hierarchical deterministic wallets.

Counterpart of lighthouse/crypto/eth2_wallet (Wallet): an encrypted
seed (EIP-2335 keystore of the seed bytes) plus a `nextaccount` counter;
validator keystores derive from the seed along EIP-2334 paths.
"""

from __future__ import annotations

import secrets
import uuid as _uuid

from . import key_derivation as kd
from . import keystore as ks


class WalletError(ValueError):
    pass


class Wallet:
    """In-memory representation of an EIP-2386 wallet JSON."""

    def __init__(self, data: dict):
        self.data = data

    @staticmethod
    def create(name: str, password: str, seed: bytes | None = None, kdf_function: str = "pbkdf2", kdf_params: dict | None = None) -> "Wallet":
        seed = seed if seed is not None else secrets.token_bytes(32)
        crypto = ks.encrypt(
            seed, password, kdf_function=kdf_function, kdf_params=kdf_params
        )["crypto"]
        return Wallet(
            {
                "crypto": crypto,
                "name": name,
                "nextaccount": 0,
                "type": "hierarchical deterministic",
                "uuid": str(_uuid.uuid4()),
                "version": 1,
            }
        )

    def decrypt_seed(self, password: str) -> bytes:
        return ks.decrypt({"crypto": self.data["crypto"], "version": 4}, password)

    def next_validator(
        self,
        wallet_password: str,
        keystore_password: str,
        kdf_function: str = "pbkdf2",
        kdf_params: dict | None = None,
    ) -> tuple[dict, int]:
        """Derive the next validator signing keystore; bumps nextaccount.
        Returns (keystore_dict, validator_index_in_wallet). Default KDF
        params are the EIP-2335 spec-strength defaults (keystore.encrypt);
        pass lighter params explicitly only for test tooling."""
        seed = self.decrypt_seed(wallet_password)
        index = self.data["nextaccount"]
        path = kd.validator_signing_path(index)
        sk = kd.derive_path(seed, path)
        keystore = ks.encrypt(
            sk.to_bytes(32, "big"),
            keystore_password,
            path=path,
            kdf_function=kdf_function,
            kdf_params=kdf_params,
        )
        self.data["nextaccount"] = index + 1
        return keystore, index
