"""Chain event bus.

Counterpart of lighthouse/beacon_node/beacon_chain/src/events.rs
(the SSE feed http_api serves). The validator monitor that used to live
here grew into chain/validator_monitor.py.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass


@dataclass
class Event:
    kind: str  # "head" | "block" | "attestation" | "finalized_checkpoint"
    data: dict


class EventBus:
    """Fan-out of chain events to bounded subscriber queues (events.rs)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self.capacity)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def emit(self, kind: str, **data) -> None:
        ev = Event(kind=kind, data=data)
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(ev)
            except queue.Full:
                pass  # slow consumer: drop, never block the chain
