"""Naive aggregation pool for sync-committee messages.

The role of the reference's naive_aggregation_pool for sync contributions
(lighthouse/beacon_node/beacon_chain/src/naive_aggregation_pool.rs and
sync_committee_verification.rs): per-(slot, block_root) accumulation of
verified SyncCommitteeMessages into full-committee participation + an
aggregate signature, from which block production lifts its SyncAggregate
and subcommittee aggregators lift their contributions.

Two stores per (slot, root):
  - per-position individual signatures (a validator occupying several
    committee positions contributes once per position — verification
    aggregates pubkeys by position, so the signature multiset must match
    the bit multiset). These are splittable: contribution production reads
    them.
  - the best (most-participating) foreign contribution per subcommittee —
    indivisible aggregates, best-by-participation like the reference.

get_sync_aggregate picks, per subcommittee, whichever store covers more
positions (subcommittee ranges are disjoint, so mixing across them is
sound; mixing within one would double-count signers)."""

from __future__ import annotations


class _Entry:
    __slots__ = ("per_pos", "best_agg")

    def __init__(self):
        self.per_pos: dict[int, object] = {}  # position -> decoded signature
        # subcommittee index -> (positions tuple, decoded aggregate)
        self.best_agg: dict[int, tuple[tuple[int, ...], object]] = {}


class SyncMessagePool:
    def __init__(self, ctx):
        self.ctx = ctx
        self._by_key: dict[tuple[int, bytes], _Entry] = {}

    def _entry(self, slot: int, block_root: bytes) -> _Entry:
        return self._by_key.setdefault((int(slot), bytes(block_root)), _Entry())

    def add(self, message, committee_positions: list[int]) -> None:
        """Record a VERIFIED message occupying `committee_positions`.
        Individual signatures are always kept (foreign aggregates cannot be
        split, so these remain the source for this node's own contribution
        production regardless of arrival order)."""
        entry = self._entry(message.slot, message.beacon_block_root)
        sig = self.ctx.bls.Signature.from_bytes(bytes(message.signature))
        for pos in committee_positions:
            entry.per_pos.setdefault(pos, sig)

    def add_aggregate(
        self,
        slot: int,
        block_root: bytes,
        subcommittee_index: int,
        positions: list[int],
        signature: bytes,
    ) -> bool:
        """Fold a VERIFIED subcommittee contribution, keeping the
        best-by-participation aggregate per subcommittee (the reference's
        replacement rule)."""
        entry = self._entry(slot, block_root)
        current = entry.best_agg.get(subcommittee_index)
        if current is not None and len(current[0]) >= len(positions):
            return False
        entry.best_agg[subcommittee_index] = (
            tuple(positions),
            self.ctx.bls.Signature.from_bytes(bytes(signature)),
        )
        return True

    def positions_with_own_signature(self, slot: int, block_root: bytes) -> dict[int, object]:
        """position -> decoded signature for positions backed by individual
        messages (contribution production needs splittable signatures)."""
        entry = self._by_key.get((int(slot), bytes(block_root)))
        return dict(entry.per_pos) if entry else {}

    def get_sync_aggregate(self, slot: int, block_root: bytes):
        """SyncAggregate for a block whose parent is `block_root` at `slot`
        (the previous slot from the producing block's point of view)."""
        from ..chain.beacon_chain import empty_sync_aggregate
        from ..types import SYNC_COMMITTEE_SUBNET_COUNT

        t = self.ctx.types
        entry = self._by_key.get((int(slot), bytes(block_root)))
        if entry is None or (not entry.per_pos and not entry.best_agg):
            return empty_sync_aggregate(t)
        size = self.ctx.preset.sync_committee_size
        sub_size = self.ctx.preset.sync_subcommittee_size
        bits = [False] * size
        sigs: list = []
        for sub in range(SYNC_COMMITTEE_SUBNET_COUNT):
            lo = sub * sub_size
            own = [p for p in entry.per_pos if lo <= p < lo + sub_size]
            agg = entry.best_agg.get(sub)
            if agg is not None and len(agg[0]) > len(own):
                for p in agg[0]:
                    bits[p] = True
                sigs.append(agg[1])
            else:
                for p in own:
                    bits[p] = True
                    sigs.append(entry.per_pos[p])
        if not sigs:
            return empty_sync_aggregate(t)
        return t.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=self.ctx.bls.aggregate_signatures(sigs).to_bytes(),
        )

    def prune(self, min_slot: int) -> None:
        for key in [k for k in self._by_key if k[0] < min_slot]:
            del self._by_key[key]
