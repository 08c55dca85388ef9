"""Work scheduler: bounded priority queues + device-sized batch formation.

Python rendering of lighthouse/beacon_node/network/src/beacon_processor/
mod.rs (copied from the JAX package's scheduler/beacon_processor.py):
  - bounded per-type queues with drop-on-overflow (mod.rs:82: event queue
    16,384 deep; per-queue bounds below mirror the reference's)
  - strict priority order: chain segments > rpc blocks > delayed blocks >
    gossip blocks > aggregates > unaggregated attestations (mod.rs:960-1080)
  - re-batching: attestations/aggregates drain into ONE batch work item for
    a single batched BLS call (mod.rs:163-175). The reference caps batches
    at 64; here the cap is 128, a power-of-two S bucket of the verifier
    (torch_backend/api.py `_next_pow2`), so a full drain of single-key
    sets stages 128 x 1 with zero padding.
  - poisoning fallback stays the HANDLER's job (attestation_processing.py):
    a failed batch falls back to per-item verification, so one bad
    signature cannot poison its batchmates (mod.rs:166-173).

Blocks use FIFO queues (oldest first); attestations use LIFO (freshest
first, stale ones decay at the queue tail) — same asymmetry as the
reference (mod.rs LifoQueue/FifoQueue).
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field


class WorkType(enum.IntEnum):
    """Priority order: lower value = drained first (mod.rs:960-1080)."""

    CHAIN_SEGMENT = 0
    RPC_BLOCK = 1
    DELAYED_BLOCK = 2
    GOSSIP_BLOCK = 3
    GOSSIP_AGGREGATE = 4
    GOSSIP_ATTESTATION = 5


# A power-of-two S bucket of the verifier (vs the reference's 64,
# beacon_processor/mod.rs:174-175).
MAX_GOSSIP_ATTESTATION_BATCH_SIZE = 128
MAX_GOSSIP_AGGREGATE_BATCH_SIZE = 128

_LIFO_TYPES = {WorkType.GOSSIP_ATTESTATION, WorkType.GOSSIP_AGGREGATE}

DEFAULT_QUEUE_BOUNDS = {
    WorkType.CHAIN_SEGMENT: 64,
    WorkType.RPC_BLOCK: 1024,
    WorkType.DELAYED_BLOCK: 1024,
    WorkType.GOSSIP_BLOCK: 1024,
    WorkType.GOSSIP_AGGREGATE: 4096,
    WorkType.GOSSIP_ATTESTATION: 16384,
}


@dataclass
class Batch:
    """A drained batch destined for one device dispatch."""

    work_type: WorkType
    items: list


@dataclass
class ProcessorStats:
    submitted: dict = field(default_factory=dict)
    dropped: dict = field(default_factory=dict)
    drained: dict = field(default_factory=dict)

    def bump(self, table: dict, wt: WorkType, n: int = 1) -> None:
        table[wt] = table.get(wt, 0) + n


class BeaconProcessor:
    def __init__(self, bounds: dict | None = None, coalescer=None):
        self.bounds = dict(DEFAULT_QUEUE_BOUNDS)
        if bounds:
            self.bounds.update(bounds)
        # optional crypto.bls.batch_verifier.BatchVerifier: gossip
        # attestation/aggregate/sync-message handlers verify through it
        # (cross-caller coalescing; blocks keep their dedicated batch) and
        # drain() kicks it when the queues empty so a partial batch is not
        # left waiting out its deadline on an idle device
        self.coalescer = coalescer
        self.queues: dict[WorkType, deque] = {wt: deque() for wt in WorkType}
        # enqueue timestamps, shadowing self.queues op-for-op (append ↔
        # append, pop ↔ pop, popleft ↔ popleft) so drains can attribute
        # queue-wait per work kind without wrapping the items themselves
        # (handlers and tests see raw items)
        self._enqueued_at: dict[WorkType, deque] = {wt: deque() for wt in WorkType}
        self.stats = ProcessorStats()

    def submit(self, work_type: WorkType, item) -> bool:
        """Enqueue; returns False when the bounded queue drops the item
        (drop-on-overflow, mod.rs FifoQueue/LifoQueue push)."""
        q = self.queues[work_type]
        ts = self._enqueued_at[work_type]
        if len(q) >= self.bounds[work_type]:
            # FIFO queues drop the NEW item; LIFO queues drop the OLDEST
            # (freshest-first semantics for attestations).
            if work_type in _LIFO_TYPES:
                try:
                    q.popleft()
                    ts.popleft()
                except IndexError:
                    pass  # a concurrent drain already emptied the queue
                self.stats.bump(self.stats.dropped, work_type)
            else:
                self.stats.bump(self.stats.dropped, work_type)
                return False
        q.append(item)
        ts.append(time.monotonic())
        self.stats.bump(self.stats.submitted, work_type)
        from ..common.metrics import PROCESSOR_QUEUE_DEPTH

        PROCESSOR_QUEUE_DEPTH.set(len(self))
        return True

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # -- draining --------------------------------------------------------------

    def next_batch(self) -> Batch | None:
        """Pop the highest-priority pending work; attestation/aggregate
        types re-batch up to the device bucket into one item."""
        for wt in WorkType:
            q = self.queues[wt]
            if not q:
                continue
            now = time.monotonic()
            ts = self._enqueued_at[wt]
            waits = []
            if wt in _LIFO_TYPES:
                cap = (
                    MAX_GOSSIP_ATTESTATION_BATCH_SIZE
                    if wt == WorkType.GOSSIP_ATTESTATION
                    else MAX_GOSSIP_AGGREGATE_BATCH_SIZE
                )
                items = [q.pop() for _ in range(min(cap, len(q)))]  # LIFO
                for _ in items:
                    # a concurrent submit-overflow popleft can shrink ts
                    # under us (same race submit guards on q): stop rather
                    # than crash the drain; the shadow deque re-aligns as
                    # both sides keep mirroring operations
                    try:
                        waits.append(now - ts.pop())
                    except IndexError:
                        break
            else:
                items = [q.popleft()]
                try:
                    waits.append(now - ts.popleft())
                except IndexError:
                    pass
            self.stats.bump(self.stats.drained, wt, len(items))
            from ..common.metrics import (
                PROCESSOR_QUEUE_DEPTH,
                PROCESSOR_QUEUE_WAIT_SECONDS,
            )

            PROCESSOR_QUEUE_DEPTH.set(len(self))
            wait_hist = PROCESSOR_QUEUE_WAIT_SECONDS.labels(kind=wt.name.lower())
            for w in waits:
                wait_hist.observe(max(0.0, w))
            return Batch(work_type=wt, items=items)
        return None

    @staticmethod
    def isolated(handler):
        """Hostile-input boundary for drain handlers: when a batch handler
        raises, retry per item and drop the single offender — one malformed
        message must not wedge the drain (the worker-panic isolation the
        reference gets from per-task workers)."""

        def run(items):
            try:
                handler(items)
            except Exception:  # noqa: BLE001 — hostile-input boundary
                for item in items:
                    try:
                        handler([item])
                    except Exception:  # noqa: BLE001
                        from ..common.metrics import PROCESSOR_ITEMS_DROPPED

                        PROCESSOR_ITEMS_DROPPED.inc()

        return run

    def drain(self, handlers: dict, max_batches: int | None = None) -> int:
        """Drain by priority through `handlers[work_type](items)`; returns
        the number of batches processed. The synchronous in-process stand-in
        for the reference's manager-task + blocking-worker-pool loop."""
        missing = [wt for wt, q in self.queues.items() if q and wt not in handlers]
        if missing:
            raise KeyError(f"no handler for queued work types {missing!r}")
        from ..common.metrics import PROCESSOR_HANDLE_SECONDS
        from ..common.tracing import span

        n = 0
        # the enclosing drain span times the scheduling overhead BETWEEN
        # handler batches (queue pops, priority scan); the slot ledger
        # attributes its exclusive time separately from the handlers', so
        # "the drain loop itself is slow" is observable per slot
        with span("processor_drain"):
            while max_batches is None or n < max_batches:
                batch = self.next_batch()
                if batch is None:
                    break
                kind = batch.work_type.name.lower()
                with PROCESSOR_HANDLE_SECONDS.labels(kind=kind).time(), span(
                    f"processor_handle_{kind}"
                ):
                    handlers[batch.work_type](batch.items)
                n += 1
        if self.coalescer is not None:
            # the drain produced no more work: the device is about to go
            # idle, so flush any partially-filled coalesced batch now
            self.coalescer.kick()
        return n
