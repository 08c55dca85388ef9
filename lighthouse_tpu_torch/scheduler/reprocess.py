"""Work reprocessing queue: park gossip work that is early or references an
unknown block, release it when its trigger fires.

Python rendering of lighthouse/beacon_node/network/src/beacon_processor/
work_reprocessing_queue.rs: attestations arriving before their slot wait for
the clock; attestations for a block the chain has not imported yet wait for
that block (or expire after QUEUED_ATTESTATION_DELAY slots); released items
re-enter the BeaconProcessor queues as ordinary work.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# the reference holds unknown-block attestations for half a slot and expires
# them after the attestation inclusion window; slots is the natural unit here
EXPIRY_SLOTS = 2
# clock-disparity tolerance: park only attestations this close to now
# (anything further out is hostile or hopeless and drops)
MAX_EARLY_SLOTS = 2
MAX_PARKED = 16384  # the BeaconProcessor event-queue bound, reused


@dataclass
class _Parked:
    item: object
    expires_at_slot: int
    work_type: object = None


class ReprocessQueue:
    def __init__(self, expiry_slots: int = EXPIRY_SLOTS):
        self.expiry_slots = expiry_slots
        # (ready_slot, work_type, item)
        self._early: list[tuple[int, object, object]] = []
        self._by_root: dict[bytes, list[_Parked]] = defaultdict(list)
        self.expired = 0

    @staticmethod
    def _default_work_type():
        from . import WorkType

        return WorkType.GOSSIP_ATTESTATION

    # -- parking ---------------------------------------------------------------

    def park_early(self, item, ready_slot: int, current_slot: int, work_type=None) -> bool:
        """An attestation for a future slot (early-arrival clamping,
        work_reprocessing_queue.rs QueuedUnaggregate early path). Only slots
        within clock-disparity tolerance park; the rest drop — a hostile
        peer must not grow this queue without bound."""
        if int(ready_slot) > int(current_slot) + MAX_EARLY_SLOTS:
            return False
        if len(self) >= MAX_PARKED:
            return False
        wt = work_type if work_type is not None else self._default_work_type()
        self._early.append((int(ready_slot), wt, item))
        return True

    def park_unknown_block(self, item, block_root: bytes, current_slot: int, work_type=None) -> bool:
        """An attestation whose beacon_block_root the chain has not imported."""
        if len(self) >= MAX_PARKED:
            return False
        wt = work_type if work_type is not None else self._default_work_type()
        self._by_root[bytes(block_root)].append(
            _Parked(item, int(current_slot) + self.expiry_slots, wt)
        )
        return True

    # -- triggers --------------------------------------------------------------

    def on_slot(self, current_slot: int) -> list:
        """Release (work_type, item) pairs whose slot has arrived; expire
        stale unknown-block parkings."""
        ready = [(wt, item) for slot, wt, item in self._early if slot <= current_slot]
        self._early = [(s, wt, i) for s, wt, i in self._early if s > current_slot]
        for root in list(self._by_root):
            kept = [p for p in self._by_root[root] if p.expires_at_slot > current_slot]
            self.expired += len(self._by_root[root]) - len(kept)
            if kept:
                self._by_root[root] = kept
            else:
                del self._by_root[root]
        return ready

    def on_block_imported(self, block_root: bytes) -> list:
        """Release (work_type, item) pairs waiting on this root (the
        reprocessing queue's BlockImported message)."""
        parked = self._by_root.pop(bytes(block_root), [])
        return [(p.work_type, p.item) for p in parked]

    def __len__(self) -> int:
        return len(self._early) + sum(len(v) for v in self._by_root.values())
