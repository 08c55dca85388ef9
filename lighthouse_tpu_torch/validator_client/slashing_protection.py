"""EIP-3076 slashing protection database.

Counterpart of lighthouse/validator_client/slashing_protection
(slashing_database.rs): SQLite (the stdlib module binds the same C SQLite
the reference bundles), one transaction per signing decision, minimal
attestation (source/target) and block (slot) history with the interchange
format's import/export.

Safety rules enforced (slashing_database.rs check_* family):
  blocks:       never sign two different blocks at the same slot; never
                sign below the minimum known slot
  attestations: never double vote (same target, different data), never
                surround or be surrounded by a prior vote
"""

from __future__ import annotations

import json
import sqlite3
from dataclasses import dataclass

INTERCHANGE_VERSION = "5"


class SlashingProtectionError(Exception):
    """Refusing to sign: doing so could be slashable."""


@dataclass
class SigningRecord:
    kind: str
    pubkey: str


_SCHEMA = """
CREATE TABLE IF NOT EXISTS validators (
    id INTEGER PRIMARY KEY,
    pubkey TEXT UNIQUE NOT NULL
);
CREATE TABLE IF NOT EXISTS signed_blocks (
    validator_id INTEGER NOT NULL REFERENCES validators(id),
    slot INTEGER NOT NULL,
    signing_root TEXT,
    UNIQUE (validator_id, slot)
);
CREATE TABLE IF NOT EXISTS signed_attestations (
    validator_id INTEGER NOT NULL REFERENCES validators(id),
    source_epoch INTEGER NOT NULL,
    target_epoch INTEGER NOT NULL,
    signing_root TEXT,
    UNIQUE (validator_id, target_epoch)
);
"""


class SlashingDatabase:
    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()

    # -- registration ----------------------------------------------------------

    def register_validator(self, pubkey: bytes | str) -> int:
        pk = pubkey if isinstance(pubkey, str) else pubkey.hex()
        cur = self.conn.execute(
            "INSERT OR IGNORE INTO validators (pubkey) VALUES (?)", (pk,)
        )
        self.conn.commit()
        row = self.conn.execute("SELECT id FROM validators WHERE pubkey = ?", (pk,)).fetchone()
        return row[0]

    def _vid(self, pubkey: bytes | str) -> int:
        pk = pubkey if isinstance(pubkey, str) else pubkey.hex()
        row = self.conn.execute("SELECT id FROM validators WHERE pubkey = ?", (pk,)).fetchone()
        if row is None:
            raise SlashingProtectionError(f"unregistered validator {pk[:18]}")
        return row[0]

    # -- blocks (check_and_insert_block_proposal) ------------------------------

    def check_and_insert_block_proposal(
        self, pubkey: bytes | str, slot: int, signing_root: bytes
    ) -> None:
        vid = self._vid(pubkey)
        root = signing_root.hex()
        with self.conn:  # one transaction per signing (slashing_database.rs)
            row = self.conn.execute(
                "SELECT signing_root FROM signed_blocks WHERE validator_id = ? AND slot = ?",
                (vid, slot),
            ).fetchone()
            if row is not None:
                if row[0] == root:
                    return  # identical re-sign is safe
                raise SlashingProtectionError(f"double block proposal at slot {slot}")
            low = self.conn.execute(
                "SELECT MIN(slot) FROM signed_blocks WHERE validator_id = ?", (vid,)
            ).fetchone()[0]
            if low is not None and slot < low:
                raise SlashingProtectionError(f"block slot {slot} below minimum {low}")
            self.conn.execute(
                "INSERT INTO signed_blocks (validator_id, slot, signing_root) VALUES (?, ?, ?)",
                (vid, slot, root),
            )

    # -- attestations (check_and_insert_attestation) ---------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes | str, source_epoch: int, target_epoch: int, signing_root: bytes
    ) -> None:
        if source_epoch > target_epoch:
            raise SlashingProtectionError("source epoch after target epoch")
        vid = self._vid(pubkey)
        root = signing_root.hex()
        with self.conn:
            row = self.conn.execute(
                "SELECT signing_root FROM signed_attestations "
                "WHERE validator_id = ? AND target_epoch = ?",
                (vid, target_epoch),
            ).fetchone()
            if row is not None:
                if row[0] == root:
                    return
                raise SlashingProtectionError(f"double vote at target {target_epoch}")
            # surrounding: an existing att with source < new source and
            # target > new target would be surrounded by... careful:
            # new surrounds old:  new.source < old.source and old.target < new.target
            surrounds = self.conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
                "AND source_epoch > ? AND target_epoch < ?",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounds:
                raise SlashingProtectionError("attestation would surround a prior vote")
            surrounded = self.conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
                "AND source_epoch < ? AND target_epoch > ?",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounded:
                raise SlashingProtectionError("attestation would be surrounded by a prior vote")
            low = self.conn.execute(
                "SELECT MIN(source_epoch), MIN(target_epoch) FROM signed_attestations "
                "WHERE validator_id = ?",
                (vid,),
            ).fetchone()
            if low[0] is not None and source_epoch < low[0]:
                raise SlashingProtectionError("source epoch below minimum")
            if low[1] is not None and target_epoch <= low[1]:
                raise SlashingProtectionError("target epoch not above minimum")
            self.conn.execute(
                "INSERT INTO signed_attestations "
                "(validator_id, source_epoch, target_epoch, signing_root) VALUES (?, ?, ?, ?)",
                (vid, source_epoch, target_epoch, root),
            )

    # -- EIP-3076 interchange --------------------------------------------------

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        data = []
        for vid, pk in self.conn.execute("SELECT id, pubkey FROM validators"):
            blocks = [
                {"slot": str(slot), "signing_root": f"0x{sr}" if sr else None}
                for slot, sr in self.conn.execute(
                    "SELECT slot, signing_root FROM signed_blocks WHERE validator_id = ?",
                    (vid,),
                )
            ]
            atts = [
                {
                    "source_epoch": str(s),
                    "target_epoch": str(t),
                    "signing_root": f"0x{sr}" if sr else None,
                }
                for s, t, sr in self.conn.execute(
                    "SELECT source_epoch, target_epoch, signing_root "
                    "FROM signed_attestations WHERE validator_id = ?",
                    (vid,),
                )
            ]
            data.append(
                {"pubkey": f"0x{pk}", "signed_blocks": blocks, "signed_attestations": atts}
            )
        return {
            "metadata": {
                "interchange_format_version": INTERCHANGE_VERSION,
                "genesis_validators_root": "0x" + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, interchange: dict) -> None:
        if interchange["metadata"]["interchange_format_version"] != INTERCHANGE_VERSION:
            raise SlashingProtectionError("unsupported interchange version")
        for record in interchange["data"]:
            pk = record["pubkey"].removeprefix("0x")
            vid = self.register_validator(pk)
            with self.conn:
                for blk in record.get("signed_blocks", []):
                    sr = (blk.get("signing_root") or "0x").removeprefix("0x")
                    self.conn.execute(
                        "INSERT OR IGNORE INTO signed_blocks "
                        "(validator_id, slot, signing_root) VALUES (?, ?, ?)",
                        (vid, int(blk["slot"]), sr),
                    )
                for att in record.get("signed_attestations", []):
                    sr = (att.get("signing_root") or "0x").removeprefix("0x")
                    self.conn.execute(
                        "INSERT OR IGNORE INTO signed_attestations "
                        "(validator_id, source_epoch, target_epoch, signing_root) "
                        "VALUES (?, ?, ?, ?)",
                        (vid, int(att["source_epoch"]), int(att["target_epoch"]), sr),
                    )

    def export_json(self) -> str:
        return json.dumps(self.export_interchange(b"\x00" * 32), indent=2)
