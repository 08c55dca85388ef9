"""Slasher core: double-vote, surround-vote, and double-proposal detection."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..types.containers import AttestationData, BeaconBlockHeader


@dataclass
class SlasherConfig:
    """config.rs: history bound in epochs; records older than
    current_epoch - history_length are pruned."""

    history_length: int = 4096


@dataclass
class _ValidatorHistory:
    sources: list = field(default_factory=list)
    targets: list = field(default_factory=list)
    records: list = field(default_factory=list)  # indexed attestation per row

    def arrays(self):
        return np.asarray(self.sources, dtype=np.int64), np.asarray(
            self.targets, dtype=np.int64
        )


class Slasher:
    def __init__(self, ctx, config: SlasherConfig | None = None, db_path: str | None = None):
        self.ctx = ctx
        self.config = config or SlasherConfig()
        self.queue: list = []
        self.block_queue: list = []
        # (validator, target_epoch) -> (data_root, indexed attestation)
        self.attestation_by_target: dict[tuple[int, int], tuple[bytes, object]] = {}
        self.history: dict[int, _ValidatorHistory] = {}
        # (proposer, slot) -> signed header
        self.proposals: dict[tuple[int, int], object] = {}
        # optional durable store (slasher/src/database.rs role)
        self.db = None
        if db_path is not None:
            from .db import SlasherDB

            self.db = SlasherDB(db_path)
            self.attestation_by_target, rows, self.proposals = self.db.load(ctx.types)
            for v, src, tgt, att in rows:
                hist = self.history.setdefault(v, _ValidatorHistory())
                hist.sources.append(src)
                hist.targets.append(tgt)
                hist.records.append(att)

    # -- ingestion (slasher.rs:69-77) -----------------------------------------

    def accept_attestation(self, indexed_attestation) -> None:
        self.queue.append(indexed_attestation)

    def accept_block_header(self, signed_header) -> None:
        self.block_queue.append(signed_header)

    # -- batch processing (slasher.rs:79 process_queued) ----------------------

    def process_queued(self, current_epoch: int):
        """Process everything queued; returns (attester_slashings,
        proposer_slashings) as container objects ready for the op pool."""
        t = self.ctx.types
        attester_slashings = []
        proposer_slashings = []

        for att in self.queue:
            data_root = AttestationData.hash_tree_root(att.data)
            src, tgt = att.data.source.epoch, att.data.target.epoch
            for v in att.attesting_indices:
                # double vote: same target, different data
                prior = self.attestation_by_target.get((v, tgt))
                if prior is not None and prior[0] != data_root:
                    attester_slashings.append(
                        t.AttesterSlashing(attestation_1=prior[1], attestation_2=att)
                    )
                    continue
                self.attestation_by_target.setdefault((v, tgt), (data_root, att))

                hist = self.history.setdefault(v, _ValidatorHistory())
                if hist.sources:
                    s_arr, t_arr = hist.arrays()
                    # new surrounds old: new.src < old.src and old.tgt < new.tgt
                    surrounds = (src < s_arr) & (t_arr < tgt)
                    # old surrounds new: old.src < new.src and new.tgt < old.tgt
                    surrounded = (s_arr < src) & (tgt < t_arr)
                    hits = np.nonzero(surrounds | surrounded)[0]
                    if hits.size:
                        old = hist.records[int(hits[0])]
                        # attestation_1 must surround attestation_2
                        first, second = (att, old) if bool(surrounds[hits[0]]) else (old, att)
                        attester_slashings.append(
                            t.AttesterSlashing(attestation_1=first, attestation_2=second)
                        )
                        continue
                hist.sources.append(src)
                hist.targets.append(tgt)
                hist.records.append(att)
                if self.db is not None:
                    self.db.put_attestation(
                        int(v), int(tgt), int(src), bytes(data_root),
                        type(att).serialize(att),
                    )
        self.queue.clear()

        for signed in self.block_queue:
            h = signed.message
            key = (int(h.proposer_index), int(h.slot))
            prior = self.proposals.get(key)
            if prior is not None and BeaconBlockHeader.hash_tree_root(
                prior.message
            ) != BeaconBlockHeader.hash_tree_root(h):
                proposer_slashings.append(
                    t.ProposerSlashing(signed_header_1=prior, signed_header_2=signed)
                )
            else:
                self.proposals[key] = signed
                if self.db is not None:
                    self.db.put_proposal(key[0], key[1], type(signed).serialize(signed))
        self.block_queue.clear()

        self._prune(current_epoch)
        if self.db is not None:
            self.db.commit()
        return attester_slashings, proposer_slashings

    # -- pruning (migrate.rs) --------------------------------------------------

    def _prune(self, current_epoch: int) -> None:
        cutoff = current_epoch - self.config.history_length
        if cutoff <= 0:
            return
        if self.db is not None:
            spe = self.ctx.preset.slots_per_epoch
            self.db.prune(cutoff, cutoff * spe)
        self.attestation_by_target = {
            k: v for k, v in self.attestation_by_target.items() if k[1] >= cutoff
        }
        for v, hist in list(self.history.items()):
            keep = [i for i, tgt in enumerate(hist.targets) if tgt >= cutoff]
            if len(keep) != len(hist.targets):
                hist.sources = [hist.sources[i] for i in keep]
                hist.targets = [hist.targets[i] for i in keep]
                hist.records = [hist.records[i] for i in keep]
            if not hist.sources:
                del self.history[v]
