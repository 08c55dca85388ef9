"""Correlated flight recorder: a bounded ring of structured events.

The "what happened to THAT attestation" half of the observability layer:
a correlation id is minted at gossip admission
(network/service.py), bound to the message's hash-tree-root, and threaded
through staging (chain/attestation_processing.py), coalesced batch
formation, device dispatch, bisection blame and the final verdict
(crypto/bls/batch_verifier.py) — so one id reconstructs a signature set's
full path through the node.

Design constraints:
  - bounded: the ring keeps the newest `capacity` events; older ones drop
    and are COUNTED (lighthouse_tpu_flight_recorder_dropped_events_total),
    so a flood cannot grow memory and cannot silently eat history either.
  - lock-guarded: every mutation of the ring, the key map, and the id
    counter happens under one lock (the lock-discipline the thread-hygiene
    / lock-guard lints check); reads snapshot under the same lock.
  - deterministic ids: correlation ids come from a per-recorder counter,
    never from wall clocks — the sim's byte-reproducible event log stays
    reproducible. Wall-clock timestamps live ONLY inside recorder events,
    which are never part of that log.
  - dumps: `dump()` feeds GET /lighthouse/ui/flight_recorder;
    `dump_to_file()` is the slot ledger's deadline-miss auto-dump.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque

from .metrics import REGISTRY

FLIGHT_RECORDER_EVENTS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_flight_recorder_events_total",
    "Structured events appended to the flight-recorder ring",
)
FLIGHT_RECORDER_DROPPED_EVENTS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_flight_recorder_dropped_events_total",
    "Events evicted from the bounded flight-recorder ring (ring overflow)",
)
FLIGHT_RECORDER_DUMPS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_flight_recorder_dumps_total",
    "Flight-recorder rings dumped to JSON files (deadline-miss auto-dumps)",
)

DEFAULT_CAPACITY = 4096  # events kept in the ring
DEFAULT_KEY_CAPACITY = 8192  # message-root -> correlation-id bindings kept


class FlightRecorder:
    """Bounded, lock-guarded ring of correlated events (one per chain)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        key_capacity: int = DEFAULT_KEY_CAPACITY,
    ):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._keys: OrderedDict = OrderedDict()  # message root -> corr id
        self._key_capacity = int(key_capacity)
        self._next_id = 0
        self._next_seq = 0
        self._dropped = 0

    # -- correlation ids -------------------------------------------------------

    def mint(self, kind: str, **fields) -> str:
        """New correlation id for a message admitted from gossip; records
        the "admitted" event. Ids are deterministic counters (replay-safe)."""
        with self._lock:
            corr_id = f"{kind}-{self._next_id:06d}"
            self._next_id += 1
        self.record(corr_id, "admitted", **fields)
        return corr_id

    def bind(self, key: bytes, corr_id: str) -> None:
        """Bind a message's hash-tree-root to its correlation id so the
        verification pipeline (which sees only the message) can look the
        id back up. Bounded: oldest bindings evict first."""
        with self._lock:
            self._keys[key] = corr_id
            self._keys.move_to_end(key)
            while len(self._keys) > self._key_capacity:
                self._keys.popitem(last=False)

    def lookup(self, key: bytes) -> str | None:
        with self._lock:
            return self._keys.get(key)

    # -- events ----------------------------------------------------------------

    def record(self, corr_id: str, event: str, **fields) -> None:
        """Append one structured event. `t_wall` is for humans reading
        dumps; it never enters the sim's byte-reproducible event log."""
        row = {
            "corr_id": corr_id,
            "event": event,
            "t_mono": time.monotonic(),
            "t_wall": time.time(),
            **fields,
        }
        with self._lock:
            self._next_seq += 1
            row["seq"] = self._next_seq
            self._events.append(row)
            while len(self._events) > self.capacity:
                self._events.popleft()
                self._dropped += 1
                FLIGHT_RECORDER_DROPPED_EVENTS_TOTAL.inc()
        FLIGHT_RECORDER_EVENTS_TOTAL.inc()

    def events(self, corr_id: str | None = None) -> list[dict]:
        """Snapshot of the ring, oldest first; optionally one id's path."""
        with self._lock:
            rows = list(self._events)
        if corr_id is not None:
            rows = [r for r in rows if r["corr_id"] == corr_id]
        return [dict(r) for r in rows]

    @property
    def dropped(self) -> int:
        return self._dropped

    # -- dumps -----------------------------------------------------------------

    def dump(self, corr_id: str | None = None) -> dict:
        """JSON-able snapshot (the /lighthouse/ui/flight_recorder payload)."""
        rows = self.events(corr_id)
        return {
            "capacity": self.capacity,
            "dropped": self._dropped,
            "count": len(rows),
            "events": rows,
        }

    def dump_to_file(self, path, extra: dict | None = None) -> str:
        """Write the ring (plus caller context, e.g. the missed slot's
        ledger record) to `path`; returns the path written."""
        payload = dict(extra or {})
        payload["flight_recorder"] = self.dump()
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.write("\n")
        FLIGHT_RECORDER_DUMPS_TOTAL.inc()
        return str(path)
