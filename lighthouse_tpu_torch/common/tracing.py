"""Pipeline tracing of the port: timed span trees + per-stage histograms.

Copied from the JAX package's common/tracing.py. A span times itself,
nests under whatever span is open on ITS thread, and on completion feeds
`lighthouse_tpu_stage_seconds{stage=...}`; completed root spans enter a
bounded keep-the-N-slowest ring. Stacks are thread-local (spans never
cross threads), and exceptions propagate with the span still recorded.
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


class Tracer:
    def __init__(self, keep: int = SLOW_TRACE_KEEP, stage_histogram=STAGE_SECONDS):
        self._local = threading.local()
        self._keep = keep
        self._stage_histogram = stage_histogram
        self._slowest: list[Span] = []  # sorted slowest-first, len <= keep
        self._lock = threading.Lock()

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


# The process-global tracer; `span("x")` is the instrumentation one-liner.
TRACER = Tracer()
span = TRACER.span
