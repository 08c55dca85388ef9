"""Slot clocks.

Counterpart of lighthouse/common/slot_clock: SystemSlotClock maps wall
time to slots; ManualSlotClock is the test/harness clock advanced by hand
(manual_slot_clock.rs — the clock BeaconChainHarness uses).

Both clocks notify `listeners` (callables taking the new slot) whenever
the slot CHANGES — the tick source the slot-SLO ledger
(common/slot_ledger.py) windows its per-slot attribution on. Re-announcing
the current slot is not a boundary, so callers may set_slot repeatedly.
"""

from __future__ import annotations

import time


class ManualSlotClock:
    def __init__(self, genesis_slot: int = 0):
        self._slot = genesis_slot
        self.listeners: list = []  # called with the new slot on every change

    def now(self) -> int:
        return self._slot

    def set_slot(self, slot: int) -> None:
        changed = slot != self._slot
        self._slot = slot
        if changed:
            self._notify(slot)

    def advance(self, n: int = 1) -> None:
        self._slot += n
        if n:
            self._notify(self._slot)

    def _notify(self, slot: int) -> None:
        for fn in self.listeners:
            fn(slot)


class SystemSlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.listeners: list = []
        self._last_seen: int | None = None

    def now(self) -> int:
        t = time.time()
        if t < self.genesis_time:
            slot = 0
        else:
            slot = int(t - self.genesis_time) // self.seconds_per_slot
        if self.listeners and slot != self._last_seen:
            self._last_seen = slot
            for fn in self.listeners:
                fn(slot)
        return slot
