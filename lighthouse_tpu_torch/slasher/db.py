"""Slasher persistence: SQLite-backed attestation/proposal history.

The durable-store role of lighthouse/slasher/src/database.rs (MDBX
tables of indexed attestations, attester records and proposals). SQLite is
the in-image KV engine (the same choice as the EIP-3076 slashing-protection
store); the reference's chunked min/max target arrays (array.rs) are NOT
reproduced — detection runs over the per-validator history vectors, which
this module makes restart-durable with one transaction per processing
batch.
"""

from __future__ import annotations

import sqlite3

_SCHEMA = """
CREATE TABLE IF NOT EXISTS attestations (
    validator INTEGER NOT NULL,
    target    INTEGER NOT NULL,
    source    INTEGER NOT NULL,
    data_root BLOB NOT NULL,
    ssz       BLOB NOT NULL,
    PRIMARY KEY (validator, target)
);
CREATE TABLE IF NOT EXISTS proposals (
    proposer INTEGER NOT NULL,
    slot     INTEGER NOT NULL,
    ssz      BLOB NOT NULL,
    PRIMARY KEY (proposer, slot)
);
"""


class SlasherDB:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def load(self, types):
        """-> (attestation_by_target, history rows, proposals) in the
        Slasher's in-memory shapes."""
        by_target: dict[tuple[int, int], tuple[bytes, object]] = {}
        history_rows: list[tuple[int, int, int, object]] = []  # (v, src, tgt, att)
        for v, tgt, src, root, ssz in self.conn.execute(
            "SELECT validator, target, source, data_root, ssz FROM attestations"
        ):
            att = types.IndexedAttestation.deserialize(ssz)
            by_target[(v, tgt)] = (bytes(root), att)
            history_rows.append((v, src, tgt, att))
        proposals: dict[tuple[int, int], object] = {}
        for proposer, slot, ssz in self.conn.execute(
            "SELECT proposer, slot, ssz FROM proposals"
        ):
            proposals[(proposer, slot)] = types.SignedBeaconBlockHeader.deserialize(ssz)
        return by_target, history_rows, proposals

    def put_attestation(self, validator: int, target: int, source: int,
                        data_root: bytes, ssz: bytes) -> None:
        self.conn.execute(
            "INSERT OR IGNORE INTO attestations VALUES (?, ?, ?, ?, ?)",
            (validator, target, source, data_root, ssz),
        )

    def put_proposal(self, proposer: int, slot: int, ssz: bytes) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO proposals VALUES (?, ?, ?)", (proposer, slot, ssz)
        )

    def prune(self, cutoff_epoch: int, cutoff_slot: int) -> None:
        self.conn.execute("DELETE FROM attestations WHERE target < ?", (cutoff_epoch,))
        self.conn.execute("DELETE FROM proposals WHERE slot < ?", (cutoff_slot,))

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()
