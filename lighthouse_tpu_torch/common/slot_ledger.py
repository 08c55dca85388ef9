"""Slot-SLO ledger: per-slot budget accounting against the slot deadline.

The north-star is a node that absorbs its traffic inside the slot budget
(ROADMAP item 4: "validators supportable at slot time"), but spans time
stages, not slots. This ledger makes the SLOT the observable: driven by
slot-clock ticks (chain/slot_clock.py notifies listeners on every slot
change), it windows the tracer's per-stage EXCLUSIVE times
(Tracer.self_time_report — duration minus children, so nested spans never
double-count) plus the coalescer's wait histogram, and attributes each
slot's wall time to named stages:

    gossip_admission   admission checks + set building (gossip handlers)
    coalesce_wait      time submissions waited for batch formation
    staging            host packing / hash-to-field before dispatch
    device_execute     device (or backend) execution of verify batches
    state_transition   block state transitions + bulk signature checks
    fork_choice        proto-array updates
    store_write        persisting blocks/states
    other_traced       spans not mapped to a headline stage
    unattributed       wall time no span covered (residual — makes the
                       attribution sum EXACTLY equal measured wall time)

On every window close the ledger feeds the slot metrics; a deadline miss
(wall > budget) bumps the miss counter and auto-dumps the chain's flight
recorder plus the missed slot's record to a JSON file — the post-mortem
artifact a "why was slot N late" investigation starts from.

Caveat: the tracer and coalescer metrics are process-global, so in a
multi-node in-process sim one node's window includes spans other nodes
closed in the same real-time interval. Windows still tile real time, the
per-stage sum still equals the window's wall clock; only the per-NODE
split is approximate in that configuration.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
import time
from collections import deque

from .metrics import REGISTRY
from .tracing import TRACER

SLOT_LATENESS_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_slot_lateness_seconds",
    "How late each slot closed relative to its budget (<=0 buckets absorb "
    "on-time slots; positive observations are deadline misses)",
    buckets=(0.0, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 12.0),
)
SLOT_STAGE_SHARE_OF_BUDGET = REGISTRY.gauge_vec(
    "lighthouse_tpu_slot_stage_share_of_budget",
    "Fraction of the slot budget the last closed slot spent per stage "
    "(shares can exceed 1.0 on a deadline miss)",
    ("stage",),
)
SLOT_DEADLINE_MISSED_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_slot_deadline_missed_total",
    "Slots whose measured wall time exceeded the slot budget",
)
SLOT_VALIDATORS_SUPPORTABLE = REGISTRY.gauge(
    "lighthouse_tpu_slot_validators_supportable",
    "Derived headline (ROADMAP item 4): signature sets/second achieved over "
    "the last slot's verification stages, extrapolated to a full slot budget",
)

# span name -> ledger stage. Unmapped spans land in other_traced; the
# residual (wall minus everything traced) lands in unattributed.
STAGE_OF_SPAN = {
    "processor_handle_gossip_attestation": "gossip_admission",
    "processor_handle_gossip_aggregate": "gossip_admission",
    "gossip_attestation_verify": "gossip_admission",
    "gossip_aggregate_verify": "gossip_admission",
    "bls_stage": "staging",
    "bls_pack": "staging",
    "bls_h2c_host": "staging",
    "bls_batch_verify": "device_execute",
    "bls_device_execute": "device_execute",
    "state_transition": "state_transition",
    "signature_verify": "state_transition",
    "fork_choice": "fork_choice",
    "store_write": "store_write",
}

HEADLINE_STAGES = (
    "gossip_admission",
    "coalesce_wait",
    "staging",
    "device_execute",
    "state_transition",
    "fork_choice",
    "store_write",
    "other_traced",
    "unattributed",
)

# verification work counted toward the validators-supportable derivation
_VERIFY_STAGES = ("gossip_admission", "coalesce_wait", "staging", "device_execute")

# process-wide dump-filename uniquifier (NOT time-based: replay safety)
_DUMP_SEQ = itertools.count()

DEFAULT_KEEP = 128  # closed slot records retained


class SlotLedger:
    """Per-slot budget accountant. `on_slot` (wired as a slot-clock
    listener) closes the open window and opens the next; `close()` closes
    the final window at shutdown."""

    def __init__(
        self,
        seconds_per_slot: float = 12.0,
        recorder=None,
        dump_dir: str | None = None,
        keep: int = DEFAULT_KEEP,
        tracer=None,
    ):
        self.seconds_per_slot = float(seconds_per_slot)
        self.recorder = recorder  # FlightRecorder dumped on deadline miss
        self.dump_dir = dump_dir
        self._tracer = tracer if tracer is not None else TRACER
        self._keep = int(keep)
        self._lock = threading.Lock()
        self._records: deque = deque()
        self._open: tuple | None = None  # (slot, t0, baseline)
        self.deadline_misses = 0

    # -- windowing -------------------------------------------------------------

    def on_slot(self, slot: int) -> None:
        """Slot-clock tick: close the window for the previous slot (if any)
        and open one for `slot`. Idempotent per slot — re-announcing the
        current slot is not a boundary."""
        slot = int(slot)
        now = time.perf_counter()
        base = self._baseline()
        with self._lock:
            prev = self._open
            if prev is not None and prev[0] == slot:
                return
            self._open = (slot, now, base)
        if prev is not None:
            self._close_window(prev, now, base)

    def close(self) -> None:
        """Close the final open window (client shutdown)."""
        now = time.perf_counter()
        base = self._baseline()
        with self._lock:
            prev = self._open
            self._open = None
        if prev is not None:
            self._close_window(prev, now, base)

    def _baseline(self) -> dict:
        """Monotonic snapshot of every source the attribution diffs."""
        from .metrics import BLS_COALESCE_WAIT_SECONDS, BLS_SETS_TOTAL
        from .metrics import PROCESSOR_QUEUE_WAIT_SECONDS

        queue_wait = 0.0
        for child in PROCESSOR_QUEUE_WAIT_SECONDS.children().values():
            queue_wait += child.sum
        return {
            "self_times": self._tracer.self_time_report(),
            "coalesce_wait": BLS_COALESCE_WAIT_SECONDS.sum,
            "queue_wait": queue_wait,
            "sets": BLS_SETS_TOTAL.value,
        }

    # -- attribution -----------------------------------------------------------

    def _close_window(self, prev: tuple, now: float, end: dict) -> None:
        slot, t0, start = prev
        wall = max(0.0, now - t0)
        budget = self.seconds_per_slot

        stages = {s: 0.0 for s in HEADLINE_STAGES}
        start_self = start["self_times"]
        for name, total in end["self_times"].items():
            delta = total - start_self.get(name, 0.0)
            if delta <= 0.0:
                continue
            stages[STAGE_OF_SPAN.get(name, "other_traced")] += delta
        stages["coalesce_wait"] += max(
            0.0, end["coalesce_wait"] - start["coalesce_wait"]
        )
        traced = sum(stages.values())
        # the residual makes the attribution sum EXACTLY wall time; it can
        # only be squeezed to zero when spans from other threads closed
        # inside this window (see module docstring caveat)
        stages["unattributed"] = max(0.0, wall - traced)

        sets_verified = int(end["sets"] - start["sets"])
        verify_s = sum(stages[s] for s in _VERIFY_STAGES)
        supportable = (
            (sets_verified / verify_s) * budget
            if sets_verified > 0 and verify_s > 1e-9
            else 0.0
        )

        lateness = wall - budget
        missed = lateness > 0.0
        record = {
            "slot": slot,
            "wall_seconds": wall,
            "budget_seconds": budget,
            "lateness_seconds": lateness,
            "deadline_missed": missed,
            "stages": stages,
            # queue wait overlaps the stages above (an item waits while
            # another is handled), so it is reported but never summed
            "queue_wait_seconds": max(0.0, end["queue_wait"] - start["queue_wait"]),
            "sets_verified": sets_verified,
            "validators_supportable": supportable,
            "dump_path": None,
        }

        SLOT_LATENESS_SECONDS.observe(lateness)
        denom = budget if budget > 1e-9 else 1.0
        for stage, sec in stages.items():
            SLOT_STAGE_SHARE_OF_BUDGET.labels(stage=stage).set(sec / denom)
        if supportable > 0.0:
            SLOT_VALIDATORS_SUPPORTABLE.set(supportable)
        if missed:
            SLOT_DEADLINE_MISSED_TOTAL.inc()
            record["dump_path"] = self._auto_dump(record)

        with self._lock:
            self._records.append(record)
            while len(self._records) > self._keep:
                self._records.popleft()
            if missed:
                self.deadline_misses += 1

    # -- deadline-miss auto-dump -----------------------------------------------

    def _auto_dump(self, record: dict) -> str | None:
        """Exactly one JSON file per miss: the missed slot's ledger record
        plus the full flight-recorder ring (the correlated paths of the
        signature sets in flight when the deadline blew)."""
        if self.recorder is None:
            return None
        directory = self.dump_dir or os.environ.get(
            "LIGHTHOUSE_TPU_DUMP_DIR", tempfile.gettempdir()
        )
        name = (
            f"lighthouse_tpu_deadline_miss_pid{os.getpid()}"
            f"_{next(_DUMP_SEQ):04d}_slot{record['slot']}.json"
        )
        path = os.path.join(directory, name)
        try:
            return self.recorder.dump_to_file(path, extra={"slot_record": record})
        except OSError:
            return None  # a full/readonly disk must not take the node down

    # -- reads -----------------------------------------------------------------

    def records(self) -> list[dict]:
        """Closed slot records, oldest first (deep enough copies to mutate)."""
        with self._lock:
            rows = list(self._records)
        return [{**r, "stages": dict(r["stages"])} for r in rows]

    def last_record(self) -> dict | None:
        rows = self.records()
        return rows[-1] if rows else None

    def stage_report(self) -> dict[str, dict]:
        """{stage: {count, total_s, mean_s}} aggregated over closed slots —
        the same shape Tracer.stage_report() emits, so one table printer
        (scripts/profile_stages.py print_stage_table) renders both."""
        totals: dict[str, float] = {}
        counts: dict[str, int] = {}
        for rec in self.records():
            for stage, sec in rec["stages"].items():
                totals[stage] = totals.get(stage, 0.0) + sec
                counts[stage] = counts.get(stage, 0) + 1
        out = {}
        for stage in sorted(totals):
            n = counts[stage]
            out[stage] = {
                "count": n,
                "total_s": totals[stage],
                "mean_s": totals[stage] / n if n else 0.0,
            }
        return out

    def ui_payload(self) -> dict:
        """The GET /lighthouse/ui/slot_ledger response body."""
        with self._lock:
            open_slot = self._open[0] if self._open is not None else None
        return {
            "seconds_per_slot": self.seconds_per_slot,
            "deadline_misses": self.deadline_misses,
            "open_slot": open_slot,
            "slots": self.records(),
        }
