"""Observed-* gossip dedup caches.

Python rendering of the DoS-protection caches in
lighthouse/beacon_node/beacon_chain/src/observed_attesters.rs:40-43
(ObservedAttesters / ObservedAggregators — auto-pruning epoch containers),
observed_aggregates.rs (seen aggregate roots per slot), and
observed_block_producers.rs ((slot, proposer) equivocation guard).

Semantics preserved:
  - epoch containers keep the previous/current/next epochs
    (MAX_CACHED_EPOCHS = 3; next covers gossip clock disparity) and reject
    epochs below the pruning floor;
  - `observe_*` returns True when the item was ALREADY observed (the
    caller drops the duplicate without re-verifying);
  - block producers prune on finalization, and a repeat (slot, proposer)
    observation flags equivocation regardless of the block root — the
    dedup-by-root case is handled by the store before this cache is asked.

ObservedAggregates implements observed_aggregates.rs's non-strict-subset
semantics: per (slot, attestation-data root), an aggregate whose
participation bitfield is covered by one already seen is dropped; only
aggregates carrying new participation are admitted.
"""

from __future__ import annotations

from collections import defaultdict

# previous + current + next epoch (observed_attesters.rs MAX_CACHED_EPOCHS)
MAX_CACHED_EPOCHS = 3
# per-slot distinct-aggregate bound (observed_aggregates.rs's
# ReachedMaxObservationsPerSlot DoS guard)
MAX_OBSERVATIONS_PER_SLOT = 1 << 16


class EpochTooLow(Exception):
    pass


class _EpochIndexContainer:
    """AutoPruningEpochContainer: per-epoch sets of validator indices."""

    def __init__(self):
        self._by_epoch: dict[int, set[int]] = defaultdict(set)
        self.lowest_permissible_epoch = 0

    def observe(self, epoch: int, validator_index: int) -> bool:
        """Record (epoch, index); returns True if it was already present."""
        epoch, validator_index = int(epoch), int(validator_index)
        if epoch < self.lowest_permissible_epoch:
            raise EpochTooLow(f"epoch {epoch} < floor {self.lowest_permissible_epoch}")
        seen = validator_index in self._by_epoch[epoch]
        self._by_epoch[epoch].add(validator_index)
        self._prune(epoch)
        return seen

    def is_observed(self, epoch: int, validator_index: int) -> bool:
        if int(epoch) < self.lowest_permissible_epoch:
            raise EpochTooLow(f"epoch {epoch} < floor {self.lowest_permissible_epoch}")
        return int(validator_index) in self._by_epoch.get(int(epoch), set())

    def _prune(self, current_epoch: int) -> None:
        floor = max(0, current_epoch - (MAX_CACHED_EPOCHS - 1))
        if floor > self.lowest_permissible_epoch:
            self.lowest_permissible_epoch = floor
        for e in [e for e in self._by_epoch if e < self.lowest_permissible_epoch]:
            del self._by_epoch[e]

    def __len__(self) -> int:
        return sum(len(s) for s in self._by_epoch.values())


class ObservedAttesters(_EpochIndexContainer):
    """One unaggregated attestation per (validator, target epoch)
    (observed_attesters.rs EpochBitfield role)."""


class ObservedAggregators(_EpochIndexContainer):
    """One aggregate per (aggregator, target epoch)
    (observed_attesters.rs EpochHashSet role)."""


class ObservedAggregates:
    """Seen aggregate attestations per slot (observed_aggregates.rs).

    Keyed by the ATTESTATION DATA root, storing each seen aggregation
    bitfield: a new aggregate whose participation is a NON-STRICT SUBSET
    of one already seen carries no new information and is dropped —
    the reference's is_non_strict_subset check, not just byte-identity."""

    def __init__(self):
        # slot -> data_root -> list of seen bitfields (as int bitmasks)
        self._by_slot: dict[int, dict[bytes, list[int]]] = defaultdict(dict)
        self._count_by_slot: dict[int, int] = defaultdict(int)
        self.lowest_permissible_slot = 0

    @staticmethod
    def _mask(bits) -> int:
        mask = 0
        for i, bit in enumerate(bits):
            if bit:
                mask |= 1 << i
        return mask

    def observe(self, slot: int, data_root: bytes, aggregation_bits) -> bool:
        """Record the aggregate; True when it was already covered (subset
        of a previously seen bitfield)."""
        slot, data_root = int(slot), bytes(data_root)
        if slot < self.lowest_permissible_slot:
            return True  # too old to matter: treat as seen
        mask = self._mask(aggregation_bits)
        bucket = self._by_slot[slot].get(data_root)
        if bucket is not None and any(mask | seen == seen for seen in bucket):
            return True  # non-strict subset of a seen bitfield
        if self._count_by_slot[slot] >= MAX_OBSERVATIONS_PER_SLOT:
            return True  # DoS guard: refuse to grow; drop the aggregate
        if bucket is None:
            bucket = self._by_slot[slot][data_root] = []
        bucket.append(mask)
        self._count_by_slot[slot] += 1
        return False

    def is_observed(self, slot: int, data_root: bytes, aggregation_bits) -> bool:
        if int(slot) < self.lowest_permissible_slot:
            return True
        bucket = self._by_slot.get(int(slot), {}).get(bytes(data_root), ())
        mask = self._mask(aggregation_bits)
        return any(mask | seen == seen for seen in bucket)

    def prune(self, current_slot: int, keep_slots: int) -> None:
        floor = max(0, int(current_slot) - int(keep_slots))
        self.lowest_permissible_slot = max(self.lowest_permissible_slot, floor)
        for s in [s for s in self._by_slot if s < self.lowest_permissible_slot]:
            del self._by_slot[s]
            self._count_by_slot.pop(s, None)


class ObservedBlockProducers:
    """(slot, proposer_index) pairs of signature-valid blocks
    (observed_block_producers.rs). A repeat pair is an equivocation (or a
    re-gossip; the store dedups identical roots before this is consulted)."""

    def __init__(self):
        self._by_slot: dict[int, set[int]] = defaultdict(set)
        self.finalized_slot = 0

    def observe(self, slot: int, proposer_index: int) -> bool:
        slot, proposer_index = int(slot), int(proposer_index)
        if slot <= self.finalized_slot:
            return True  # pre-finalization blocks are not re-importable
        seen = proposer_index in self._by_slot[slot]
        self._by_slot[slot].add(proposer_index)
        return seen

    def is_observed(self, slot: int, proposer_index: int) -> bool:
        return int(proposer_index) in self._by_slot.get(int(slot), set())

    def prune(self, finalized_slot: int) -> None:
        self.finalized_slot = max(self.finalized_slot, int(finalized_slot))
        for s in [s for s in self._by_slot if s <= self.finalized_slot]:
            del self._by_slot[s]
