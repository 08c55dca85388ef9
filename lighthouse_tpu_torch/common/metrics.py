"""Prometheus-style metrics registry of the port.

A process-global registry of counters, gauges and histograms with timer
helpers, and text exposition in the Prometheus format. Copied from the JAX
package's common/metrics.py (which the port may not import): the registry
classes, and the families that the port's BLS api, coalescer, chain and
its services record, under the same names and help texts, so one dashboard
reads either package.

Labeled families: `CounterVec` / `GaugeVec` / `HistogramVec` hand out
cached per-label-set children via `.labels(**kv)` and expose as ONE family
(one HELP/TYPE header, one sample line per child with an escaped
`{k="v",...}` label set; histogram children interleave `le` into theirs).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


def _escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, quote, LF."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(pairs) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)


class Metric:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()


class Counter(Metric):
    typ = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> list:
        """[(name_suffix, extra_label_pairs, value)] — the family exposition
        unit shared by plain metrics and vec children."""
        with self._lock:
            return [("", (), self._value)]

    def expose(self) -> str:
        return expose_family(self, [((), self)])


class Gauge(Metric):
    typ = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> list:
        with self._lock:
            return [("", (), self._value)]

    def expose(self) -> str:
        return expose_family(self, [((), self)])


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(Metric):
    typ = "histogram"

    def __init__(self, name: str, help_text: str, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def samples(self) -> list:
        """Bucket counts are cumulative WITHIN this metric (each vec child
        carries its own cumulative `le` series, per the Prometheus format)."""
        with self._lock:
            counts = list(self._counts)
            total_sum, n = self._sum, self._n
        out = []
        cumulative = 0
        for b, c in zip(self.buckets, counts):
            cumulative += c
            out.append(("_bucket", (("le", b),), cumulative))
        out.append(("_bucket", (("le", "+Inf"),), cumulative + counts[-1]))
        out.append(("_sum", (), total_sum))
        out.append(("_count", (), n))
        return out

    def expose(self) -> str:
        return expose_family(self, [((), self)])


def expose_family(family, children) -> str:
    """HELP/TYPE header + every child's samples. `children` is a list of
    (label_pairs, metric) — plain metrics pass one unlabeled child (self)."""
    lines = [
        f"# HELP {family.name} {family.help}",
        f"# TYPE {family.name} {family.typ}",
    ]
    for label_pairs, child in children:
        for suffix, extra, value in child.samples():
            labels = _label_str(tuple(label_pairs) + tuple(extra))
            braces = f"{{{labels}}}" if labels else ""
            lines.append(f"{family.name}{suffix}{braces} {value}")
    return "\n".join(lines) + "\n"


class MetricVec(Metric):
    """A labeled family: `.labels(stage="h2c")` returns the cached child for
    that label set, creating it on first use (prometheus's *Vec types /
    lighthouse_metrics' try_create_*_vec + get_metric_with_label_values)."""

    child_cls: type = Metric

    def __init__(self, name: str, help_text: str, label_names, **child_kwargs):
        super().__init__(name, help_text)
        if not label_names:
            raise ValueError(f"metric vec {name} needs at least one label name")
        self.label_names = tuple(label_names)
        self._child_kwargs = child_kwargs
        self._children: dict[tuple, Metric] = {}

    @property
    def typ(self) -> str:
        return self.child_cls.typ

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name} takes labels {self.label_names}, got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self.child_cls(self.name, self.help, **self._child_kwargs)
                self._children[key] = child
            return child

    def children(self) -> dict[tuple, Metric]:
        """Snapshot of {label-values tuple: child} (introspection/reports)."""
        with self._lock:
            return dict(self._children)

    def expose(self) -> str:
        with self._lock:
            kids = sorted(self._children.items())
        return expose_family(
            self, [(tuple(zip(self.label_names, key)), child) for key, child in kids]
        )


class CounterVec(MetricVec):
    child_cls = Counter


class GaugeVec(MetricVec):
    child_cls = Gauge


class HistogramVec(MetricVec):
    child_cls = Histogram


class Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help_text: str, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(f"metric {name} already registered with another type")
                return existing
            m = cls(name, help_text, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_text, buckets=buckets)

    def _register_vec(self, cls, name, help_text, label_names, **kw):
        vec = self._register(cls, name, help_text, label_names=label_names, **kw)
        if vec.label_names != tuple(label_names):
            raise ValueError(
                f"metric {name} already registered with labels {vec.label_names}"
            )
        return vec

    def counter_vec(self, name: str, help_text: str = "", label_names=()) -> CounterVec:
        return self._register_vec(CounterVec, name, help_text, label_names)

    def gauge_vec(self, name: str, help_text: str = "", label_names=()) -> GaugeVec:
        return self._register_vec(GaugeVec, name, help_text, label_names)

    def histogram_vec(
        self, name: str, help_text: str = "", label_names=(), buckets=DEFAULT_BUCKETS
    ) -> HistogramVec:
        return self._register_vec(
            HistogramVec, name, help_text, label_names, buckets=buckets
        )

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def gather(self) -> str:
        """Prometheus text exposition of every registered metric."""
        with self._lock:
            return "".join(m.expose() for _, m in sorted(self._metrics.items()))


# The process-global registry (lighthouse_metrics' lazy_static pattern).
REGISTRY = Registry()

# Batched BLS verification (crypto/bls/torch_backend/api.py).
BLS_BATCH_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_bls_batch_verify_seconds", "Device batch verification wall time"
)
BLS_SETS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_bls_signature_sets_total", "Signature sets verified"
)
BLS_BATCH_PADDED_SIZE = REGISTRY.histogram(
    "lighthouse_tpu_bls_batch_padded_size",
    "Padded set-count (S bucket) of each dispatched verify batch",
    buckets=(4, 8, 16, 32, 64, 128, 256, 512),
)
BLS_STAGE_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_bls_stage_seconds",
    "Host staging wall time per batch (point packing + hash-to-field + "
    "RLC scalar draw — everything before device dispatch)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
)

# Block import (chain/beacon_chain.py).
BLOCK_IMPORT_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_block_import_seconds", "Full block import wall time"
)
CHAIN_REORGS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_chain_reorgs_total",
    "Head moved to a block that does not descend from the previous head",
)

# The beacon processor (scheduler/beacon_processor.py) and supervised tasks
# (common/task_executor.py). common/slot_ledger.py reads the queue wait to
# attribute a slot's time.
PROCESSOR_QUEUE_DEPTH = REGISTRY.gauge(
    "lighthouse_tpu_processor_queue_depth", "BeaconProcessor total queued events"
)
PROCESSOR_ITEMS_DROPPED = REGISTRY.counter(
    "lighthouse_tpu_processor_items_dropped_total",
    "Work items dropped because their handler raised (hostile-input isolation)",
)
TASKS_FAILED_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_tasks_failed_total",
    "Supervised tasks that died with an uncaught exception",
)
PROCESSOR_QUEUE_WAIT_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_processor_queue_wait_seconds",
    "Time work items spent queued before a drain picked them up",
    ("kind",),
)
PROCESSOR_HANDLE_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_processor_handle_seconds",
    "Handler wall time per drained batch",
    ("kind",),
)

# The network's receive loops (network/gossip.py, network/discovery.py).
GOSSIP_INTERNAL_ERRORS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_gossip_internal_errors_total",
    "Frames dropped because OUR handler raised (not the peer's fault: the "
    "link is kept; a climbing rate means a local bug, not a bad peer)",
)
DISCOVERY_INTERNAL_ERRORS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_discovery_internal_errors_total",
    "Discovery datagrams dropped because OUR handler raised (the recv loop "
    "keeps serving; a climbing rate means a local bug, not a hostile peer)",
)

# Cross-caller batch coalescing (crypto/bls/batch_verifier.py).
BLS_COALESCED_BATCH_SIZE = REGISTRY.histogram(
    "lighthouse_tpu_bls_coalesced_batch_size",
    "Signature sets per coalesced device dispatch (pre-padding: full "
    "buckets mean the coalescer is beating the S=4 padding floor)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)
BLS_COALESCE_WAIT_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_bls_coalesce_wait_seconds",
    "Time a submission waited in the coalescer before its batch dispatched",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
)
BLS_COALESCED_DISPATCHES_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_bls_coalesced_dispatches_total",
    "Device batches dispatched by the coalescer (vs one per caller without it)",
)
BLS_BISECTION_BATCHES_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_bls_bisection_batches_total",
    "Coalesced batches that failed and entered bisection blame",
)
BLS_BISECTION_DISPATCHES_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_bls_bisection_dispatches_total",
    "Extra verification dispatches performed while bisecting failed batches",
)
BLS_BISECTION_BLAMED_SETS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_bls_bisection_blamed_sets_total",
    "Signature sets individually blamed (rejected) by bisection",
)
BLS_COALESCER_INTERNAL_ERRORS_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_bls_coalescer_internal_errors_total",
    "Coalescer stager/resolver faults recovered by failing the affected "
    "batches/futures (a climbing rate means every verdict is quietly "
    "going False)",
)

# Device provenance: value 1, the identity in the labels, so a platform flip
# shows up as a new labelled child on the scrape.
DEVICE_PROVENANCE_INFO = REGISTRY.gauge_vec(
    "lighthouse_tpu_device_provenance_info",
    "Active BLS backend fingerprint (value 1; identity in the platform / "
    "device_kind / chip_count labels)",
    ("platform", "device_kind", "chip_count"),
)
