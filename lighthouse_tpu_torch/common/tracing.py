"""Pipeline tracing of the port: timed span trees + per-stage histograms.

Copied from the JAX package's common/tracing.py. Every pipeline stage
(block import, chain segment import, BLS device funnel) runs under
`span("stage_name")`. A span times itself, nests under whatever span is
open on ITS thread, and on completion feeds
`lighthouse_tpu_stage_seconds{stage=...}`.

Design constraints:
  - thread-local stacks: spans never cross threads.
  - completed ROOT spans (no parent) enter a bounded keep-the-N-slowest
    ring, so "what were the worst block imports" is answerable after the
    fact without logging every import.
  - exceptions propagate; the span still closes and records its time.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from .metrics import REGISTRY

STAGE_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_stage_seconds",
    "Wall time per traced pipeline stage (fed by common.tracing spans)",
    ("stage",),
)

SLOW_TRACE_KEEP = 32  # root traces retained by the slowest-ring


class Span:
    __slots__ = ("name", "started_at", "duration", "children")

    def __init__(self, name: str):
        self.name = name
        self.started_at = time.perf_counter()
        self.duration: float | None = None  # None while still open
        self.children: list[Span] = []

    def tree(self) -> dict:
        """JSON-able {name, duration_s, children} snapshot."""
        return {
            "name": self.name,
            "duration_s": self.duration,
            "children": [c.tree() for c in self.children],
        }

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class Tracer:
    def __init__(self, keep: int = SLOW_TRACE_KEEP, stage_histogram=STAGE_SECONDS):
        self._local = threading.local()
        self._keep = keep
        self._stage_histogram = stage_histogram
        self._slowest: list[Span] = []  # sorted slowest-first, len <= keep
        self._lock = threading.Lock()
        # cumulative EXCLUSIVE (self) time per stage: a span's duration
        # minus its children's — non-overlapping within a thread, so
        # windowed deltas sum to at most wall time. The slot-SLO ledger
        # (common/slot_ledger.py) diffs this dict at slot boundaries;
        # monotonic by design, so reset() leaves it alone.
        self._self_times: dict[str, float] = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def span(self, name: str):
        stack = self._stack()
        s = Span(name)
        if stack:
            stack[-1].children.append(s)
        stack.append(s)
        try:
            yield s
        finally:
            s.duration = time.perf_counter() - s.started_at
            stack.pop()
            self._stage_histogram.labels(stage=name).observe(s.duration)
            child_s = sum(c.duration or 0.0 for c in s.children)
            with self._lock:
                self._self_times[name] = self._self_times.get(name, 0.0) + max(
                    0.0, s.duration - child_s
                )
            if not stack:  # a completed root trace
                self._record_root(s)

    def _record_root(self, root: Span) -> None:
        with self._lock:
            ring = self._slowest
            ring.append(root)
            ring.sort(key=lambda sp: sp.duration, reverse=True)
            del ring[self._keep :]

    def slowest(self, n: int | None = None) -> list[dict]:
        """The slowest completed root traces, slowest first, as trees."""
        with self._lock:
            roots = list(self._slowest[: n if n is not None else self._keep])
        return [r.tree() for r in roots]

    def stage_report(self) -> dict[str, dict]:
        """{stage: {count, total_s, mean_s}} from the stage histogram — the
        table a stage profile prints."""
        out = {}
        for (stage,), child in sorted(self._stage_histogram.children().items()):
            n = child.count
            out[stage] = {
                "count": n,
                "total_s": child.sum,
                "mean_s": (child.sum / n) if n else 0.0,
            }
        return out

    def self_time_report(self) -> dict[str, float]:
        """{stage: cumulative exclusive seconds} — duration minus children,
        so summing stages never double-counts nested spans. Monotonic: the
        slot ledger attributes a slot by diffing two snapshots."""
        with self._lock:
            return dict(self._self_times)

    def reset(self) -> None:
        """Drop the slow-trace ring (tests; the stage histogram is owned by
        the metrics registry and is NOT cleared here; self-times stay —
        the slot ledger depends on their monotonicity)."""
        with self._lock:
            self._slowest.clear()


# The process-global tracer; `span("x")` is the instrumentation one-liner.
TRACER = Tracer()
span = TRACER.span
