"""Sync state machines: forward range sync and checkpoint backfill.

Python rendering of lighthouse/beacon_node/network/src/sync/:
  - `SyncManager` (manager.rs:178): owns the machines, decides when a peer's
    status or an unknown-parent block warrants syncing;
  - `RangeSync` (range_sync/chain.rs SyncingChain): the head chase — ordered
    epoch-aligned batches, per-batch peer rotation and bounded retries, each
    completed batch imported as ONE signature-batched chain segment
    (beacon_chain.process_chain_segment — the device-batch path);
  - `BackFillSync` (backfill_sync/mod.rs:101): a checkpoint-booted node
    walks history BACKWARD epoch-batch by epoch-batch, verifying every
    proposer signature of a batch in one device dispatch
    (beacon_chain.import_historical_block_batch).

Deliberate simplifications vs the reference (documented): downloads are
synchronous calls on the harness network (no in-flight request table), and
there is one syncing chain at a time (the reference keeps several and
groups peers per chain) — the batch/retry/peer-rotation semantics are kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


EPOCHS_PER_BATCH = 2  # range_sync/batch.rs EPOCHS_PER_BATCH
MAX_BATCH_ATTEMPTS = 3  # range_sync/batch.rs MAX_BATCH_DOWNLOAD_ATTEMPTS (~5)


class SyncPeerError(Exception):
    """A peer failed to serve a request (transport error / empty answer)."""


class SyncState(Enum):
    IDLE = "idle"
    SYNCING = "syncing"
    FAILED = "failed"


@dataclass
class Batch:
    """One download unit (range_sync/batch.rs BatchInfo)."""

    start_slot: int
    count: int
    attempts: int = 0
    failed_peers: set = field(default_factory=set)


class _PeerRotation:
    """Round-robin peer selection skipping peers that failed this batch
    (the peer-pool role of range_sync/chain.rs)."""

    def __init__(self):
        self._cursor = 0

    def pick(self, peers: list[str], batch: Batch) -> str | None:
        candidates = [p for p in peers if p not in batch.failed_peers]
        if not candidates:
            return None
        self._cursor = (self._cursor + 1) % len(candidates)
        return candidates[self._cursor]


def _download_and_import(service, rotation: _PeerRotation, batch: Batch, importer) -> bool:
    """Shared download-with-retry loop for both sync machines.

    Rotates peers (bounded attempts), downloads the batch span, and hands
    non-empty answers to `importer(peer_id, blocks)`. The importer returns
    True (imported), False (bad batch — blame the peer), or None ("this
    span cannot make progress": nothing behind the frontier, or the whole
    answer breaks the hash chain AT the frontier because the parent sits
    below the requested window). None answers are treated exactly like
    empty ones: they are a VERDICT, not a failure, accepted only when
    EVERY live peer agrees — a single lagging/lying peer cannot make the
    machine skip a span (range_sync/batch.rs marks batches
    AwaitingValidation for the same reason), and honest peers serving a
    fully-empty span no longer burn attempts into FAILED (the caller
    widens its window instead).

    ExecutionEngineError raised by `importer` propagates: an EL outage is
    our fault, not the peer's, and must not burn peer attempts."""
    empty_peers: set[str] = set()
    while batch.attempts < MAX_BATCH_ATTEMPTS:
        peers = service.network.peer_ids(service.node_id)
        peer = rotation.pick(peers, batch)
        if peer is None:
            break
        try:
            blocks = service.network.blocks_by_range_from(
                service.node_id, peer, batch.start_slot, batch.count
            )
        except SyncPeerError:
            batch.failed_peers.add(peer)
            batch.attempts += 1
            continue
        verdict = importer(peer, blocks) if blocks else None
        if verdict is True:
            return True
        if verdict is None:
            empty_peers.add(peer)
            batch.failed_peers.add(peer)  # rotate on; verdict at the end
            continue
        batch.failed_peers.add(peer)
        batch.attempts += 1
    live = set(service.network.peer_ids(service.node_id))
    return bool(live) and live <= empty_peers


class RangeSync:
    """Chase a target head slot with epoch-aligned forward batches."""

    def __init__(self, service):
        self.service = service
        self.state = SyncState.IDLE
        self.target_slot = 0
        self._next_start = 0
        self._rotation = _PeerRotation()
        self.batches_imported = 0

    def start(self, target_slot: int) -> None:
        chain = self.service.client.chain
        head_slot = int(chain.head_state().slot)
        if target_slot <= head_slot:
            return
        if self.state is not SyncState.SYNCING:
            self.state = SyncState.SYNCING
            self._next_start = head_slot + 1
        self.target_slot = max(self.target_slot, int(target_slot))

    def start_fork(self, target_slot: int, from_slot: int) -> None:
        """Re-walk `[from_slot, target_slot]` even though our head is at or
        above the target: fork recovery. A block whose parent is unknown
        AFTER a forward fill sits on a branch that diverged below our head,
        so the walk must restart from the last common point — the finalized
        checkpoint — to pick the branch up (range sync chains in the
        reference restart from the finalized epoch for the same reason)."""
        self.state = SyncState.SYNCING
        self.target_slot = int(target_slot)
        self._next_start = max(1, int(from_slot))

    def tick(self) -> None:
        """Advance the machine: download + import batches until the target
        is reached, a batch exhausts its attempts, or peers run out."""
        if self.state is not SyncState.SYNCING:
            return
        chain = self.service.client.chain
        batch_span = EPOCHS_PER_BATCH * chain.ctx.preset.slots_per_epoch
        while self._next_start <= self.target_slot:
            batch = Batch(
                start_slot=self._next_start,
                count=min(batch_span, self.target_slot - self._next_start + 1),
            )
            if not self._process_batch(batch):
                self.state = SyncState.FAILED
                return
            self._next_start = batch.start_slot + batch.count
            self.batches_imported += 1
        self.state = SyncState.IDLE

    def _process_batch(self, batch: Batch) -> bool:
        from ..state_transition import ExecutionEngineError

        chain = self.service.client.chain

        def importer(peer: str, blocks) -> bool:
            try:
                chain.process_chain_segment(blocks)
                return True
            except ExecutionEngineError:
                raise  # EL outage: abort the sync, don't blame the peer
            except Exception:  # noqa: BLE001 — bad batch: blame the peer
                # fall back to per-block import for precise attribution
                # (an honest partial overlap still imports what it can)
                ok_any = False
                for b in sorted(blocks, key=lambda x: int(x.message.slot)):
                    try:
                        chain.process_block(b)
                        ok_any = True
                    except ExecutionEngineError:
                        raise
                    except Exception:  # noqa: BLE001
                        continue
                return ok_any

        return _download_and_import(self.service, self._rotation, batch, importer)


class BackFillSync:
    """Walk history backward from the checkpoint anchor to genesis."""

    def __init__(self, service):
        self.service = service
        self.state = SyncState.IDLE
        self._rotation = _PeerRotation()
        self.batches_imported = 0

    def tick(self) -> None:
        chain = self.service.client.chain
        if chain.backfill_complete:
            self.state = SyncState.IDLE
            return
        self.state = SyncState.SYNCING
        batch_span = EPOCHS_PER_BATCH * chain.ctx.preset.slots_per_epoch
        stall = 0
        while not chain.backfill_complete:
            end_slot = chain.oldest_block_slot  # exclusive
            # a genuinely block-less span cannot move the frontier: widen the
            # request window backward on stall instead of looping forever
            start_slot = max(1, end_slot - batch_span * (1 << stall))
            batch = Batch(start_slot=start_slot, count=end_slot - start_slot)
            if not self._process_batch(batch):
                self.state = SyncState.FAILED
                return
            if chain.oldest_block_slot >= end_slot:
                stall += 1
                if stall > 3:
                    self.state = SyncState.FAILED
                    return
            else:
                stall = 0
        self.state = SyncState.IDLE

    def _process_batch(self, batch: Batch) -> bool:
        chain = self.service.client.chain

        def importer(peer: str, blocks):
            # keep only the span behind the frontier (peers may over-answer)
            blocks = [
                b for b in blocks if int(b.message.slot) < chain.oldest_block_slot
            ]
            if not blocks:
                return None  # nothing behind the frontier: empty verdict
            # A batch that cannot LINK to the frontier at all — no block in
            # the answer is the frontier's parent — is indistinguishable
            # from a fully-empty span whose parent sits below the window:
            # every honest peer would answer the same way. Treat it like
            # the empty verdict so tick() widens the window instead of
            # burning peer attempts into FAILED. A batch that DOES contain
            # the parent but breaks deeper is a bad batch: blame the peer.
            # Walk descending so an honest answer (parent = highest slot)
            # short-circuits after one root.
            parent = chain.backfill_parent_root
            if not any(
                type(b.message).hash_tree_root(b.message) == parent
                for b in sorted(
                    blocks, key=lambda b: int(b.message.slot), reverse=True
                )
            ):
                return None
            try:
                n = chain.import_historical_block_batch(blocks)
            except Exception:  # noqa: BLE001 — chain-break / bad signature
                return False
            if n > 0:
                self.batches_imported += 1
            return n > 0

        return _download_and_import(self.service, self._rotation, batch, importer)


class SyncManager:
    """manager.rs:178 at harness scale: routes triggers to the machines."""

    def __init__(self, service):
        self.service = service
        self.range = RangeSync(service)
        self.backfill = BackFillSync(service)

    def on_status(self, remote_head_slot: int) -> None:
        """A peer status advertising a higher head starts/extends range sync
        (manager.rs add_peer -> RangeSync)."""
        self.range.start(int(remote_head_slot))
        self.range.tick()

    def on_unknown_parent(self, orphan_block) -> None:
        """A gossip block whose parent is unknown: sync the gap then retry
        the orphan (manager.rs UnknownParentBlock)."""
        chain = self.service.client.chain
        slot = int(orphan_block.message.slot)
        self.range.start(slot)
        self.range.tick()
        try:
            chain.process_block(orphan_block)
            return
        except Exception:  # noqa: BLE001 — still orphaned: try fork recovery
            pass
        # the forward fill didn't connect, so the orphan is on a branch
        # that diverged BELOW our head (e.g. the other side of a healed
        # partition): re-walk from the last finalized slot so the branch
        # imports as a fork and fork choice can weigh it
        state = chain.head_state()
        fin_slot = (
            int(state.finalized_checkpoint.epoch) * chain.ctx.preset.slots_per_epoch
        )
        self.range.start_fork(slot, fin_slot + 1)
        self.range.tick()
        try:
            chain.process_block(orphan_block)
        except Exception:  # noqa: BLE001 — still orphaned or invalid: drop
            pass

    def tick(self) -> None:
        self.range.tick()
        self.backfill.tick()
