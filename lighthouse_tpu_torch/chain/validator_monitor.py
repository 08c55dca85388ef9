"""Per-validator participation attribution for registered keys.

The real counterpart of lighthouse/beacon_node/beacon_chain/src/
validator_monitor.rs (replacing the counting stub that lived in
chain/events.py): for every monitored validator the monitor records, per
epoch, whether an attestation landed on chain, with what inclusion delay,
and whether its head/target votes matched the canonical chain at import
time, plus block proposals. When the chain enters epoch e, epoch e-2 is
*summarized* (one epoch of lag, because an attestation for epoch e-1 may
legally be included through the end of e): one KvLogger line per monitored
validator (the operator-facing "did my validator perform" feed) and
cumulative labeled metric export, both capped by MAX_MONITORED_VALIDATORS
so a hostile registration flood cannot mint unbounded label sets.

`/lighthouse/ui/validator_metrics` on the beacon HTTP API serves
`ui_payload()` — the same shape the reference's UI endpoint returns.
"""

from __future__ import annotations

from ..common.logging import KvLogger
from ..common.metrics import REGISTRY

# Cap on the monitored set AND on the per-validator label cardinality the
# monitor may export (validator_monitor.rs warns and degrades above its own
# threshold; here registration beyond the cap is refused).
MAX_MONITORED_VALIDATORS = 64

MONITOR_ATTESTATION_HITS = REGISTRY.counter_vec(
    "lighthouse_tpu_validator_monitor_attestation_hits_total",
    "Epochs in which a monitored validator's attestation was included",
    ("validator",),
)
MONITOR_ATTESTATION_MISSES = REGISTRY.counter_vec(
    "lighthouse_tpu_validator_monitor_attestation_misses_total",
    "Epochs in which a monitored validator's attestation never landed",
    ("validator",),
)
MONITOR_INCLUSION_DELAY = REGISTRY.histogram_vec(
    "lighthouse_tpu_validator_monitor_inclusion_delay_slots",
    "Slots between a monitored attestation's slot and its including block",
    ("validator",),
    buckets=(1, 2, 3, 4, 8, 16, 32),
)
MONITOR_PROPOSALS = REGISTRY.counter_vec(
    "lighthouse_tpu_validator_monitor_proposals_total",
    "Blocks proposed by a monitored validator",
    ("validator",),
)

# epochs of per-validator detail kept live (an attestation for epoch e can
# be included through e+1, so summaries run one epoch behind the head)
_EPOCH_HISTORY = 4


class _EpochDuty:
    """What one monitored validator did in one epoch."""

    __slots__ = ("attested", "inclusion_delay", "head_hit", "target_hit")

    def __init__(self):
        self.attested = False
        self.inclusion_delay: int | None = None
        self.head_hit = False
        self.target_hit = False


class ValidatorMonitor:
    def __init__(self, slots_per_epoch: int = 8, log: KvLogger | None = None):
        self.slots_per_epoch = slots_per_epoch
        self.log = log or KvLogger("validator_monitor")
        self.monitored: set[int] = set()
        # epoch -> {validator_index -> _EpochDuty}
        self._epochs: dict[int, dict[int, _EpochDuty]] = {}
        self._summarized_through: int | None = None  # set by the first note_slot
        self._current_epoch: int | None = None  # highest epoch note_slot saw
        # epoch at which each validator was registered (None = before the
        # chain was first observed): epochs before it are unknowable for
        # that validator and are never charged as misses
        self._registered_at_epoch: dict[int, int | None] = {}
        # cumulative per-validator totals (what ui_payload serves)
        self._totals: dict[int, dict] = {}
        # lifetime raw counts (summary()'s view) — plain counters, bounded
        self._attestation_count: dict[int, int] = {}
        self._block_count: dict[int, int] = {}
        # epoch -> {validator_index -> proposal count}, pruned with _epochs
        self._proposals_by_epoch: dict[int, dict[int, int]] = {}

    # -- registration ----------------------------------------------------------

    def register(self, validator_index: int) -> bool:
        """Monitor a validator; refused (False) past the cardinality cap."""
        if validator_index in self.monitored:
            return True
        if len(self.monitored) >= MAX_MONITORED_VALIDATORS:
            self.log.warning(
                "validator monitor full; registration refused",
                validator=validator_index,
                cap=MAX_MONITORED_VALIDATORS,
            )
            return False
        self.monitored.add(validator_index)
        self._registered_at_epoch[validator_index] = self._current_epoch
        self._totals[validator_index] = {
            "attestation_hits": 0,
            "attestation_misses": 0,
            "head_hits": 0,
            "target_hits": 0,
            "blocks_proposed": 0,
            "delay_sum": 0,
        }
        return True

    def _duty(self, epoch: int, validator_index: int) -> _EpochDuty:
        by_vi = self._epochs.setdefault(epoch, {})
        duty = by_vi.get(validator_index)
        if duty is None:
            duty = by_vi[validator_index] = _EpochDuty()
        return duty

    # -- chain feed (called by BeaconChain._post_import) -----------------------

    def on_attestation_included(
        self,
        validator_index: int,
        slot: int,
        *,
        inclusion_delay: int | None = None,
        head_hit: bool = False,
        target_hit: bool = False,
    ) -> None:
        """An imported block carried this validator's attestation for
        `slot`. Keyword details are best-effort: a bare (index, slot) call
        still counts the hit (the pre-refactor surface)."""
        if validator_index not in self.monitored:
            return
        self._attestation_count[validator_index] = (
            self._attestation_count.get(validator_index, 0) + 1
        )
        epoch = slot // self.slots_per_epoch
        duty = self._duty(epoch, validator_index)
        duty.attested = True
        if inclusion_delay is not None and (
            duty.inclusion_delay is None or inclusion_delay < duty.inclusion_delay
        ):
            duty.inclusion_delay = inclusion_delay
        duty.head_hit = duty.head_hit or head_hit
        duty.target_hit = duty.target_hit or target_hit

    def on_block_proposed(self, validator_index: int, slot: int) -> None:
        if validator_index not in self.monitored:
            return
        self._block_count[validator_index] = self._block_count.get(validator_index, 0) + 1
        epoch = slot // self.slots_per_epoch
        by_vi = self._proposals_by_epoch.setdefault(epoch, {})
        by_vi[validator_index] = by_vi.get(validator_index, 0) + 1
        self._totals[validator_index]["blocks_proposed"] += 1
        MONITOR_PROPOSALS.labels(validator=validator_index).inc()

    def note_slot(self, slot: int) -> None:
        """Advance the monitor's clock: on entering epoch e, summarize every
        un-summarized epoch through e-2. The one-epoch lag matters: an
        attestation for epoch e-1 may legally land in any block through the
        end of e (process_attestation's slot + slots_per_epoch window), so
        summarizing e-1 the moment e starts would mis-report late-but-valid
        inclusions as permanent misses."""
        epoch = slot // self.slots_per_epoch
        if self._current_epoch is None or epoch > self._current_epoch:
            self._current_epoch = epoch
        if self._summarized_through is None:
            # baseline at first observation: epochs before monitoring began
            # are unknowable, not misses (a checkpoint-started chain must
            # not charge every validator N epochs of misses in one burst)
            self._summarized_through = epoch - 1
        while self._summarized_through < epoch - 2:
            self.summarize_epoch(self._summarized_through + 1)

    # -- summaries -------------------------------------------------------------

    def summarize_epoch(self, epoch: int) -> None:
        """Emit the per-validator epoch report: one log line each, and fold
        the epoch into the cumulative totals + labeled metrics."""
        by_vi = self._epochs.pop(epoch, {})
        proposals = self._proposals_by_epoch.pop(epoch, {})
        for vi in sorted(self.monitored):
            reg = self._registered_at_epoch.get(vi)
            if reg is not None and epoch <= reg:
                # the registration epoch was only partially observed (an
                # inclusion before registration was not recorded): charge
                # from the first FULLY-observed epoch — unknowable is not
                # a miss
                continue
            duty = by_vi.get(vi, _EpochDuty())
            totals = self._totals[vi]
            if duty.attested:
                totals["attestation_hits"] += 1
                MONITOR_ATTESTATION_HITS.labels(validator=vi).inc()
                if duty.inclusion_delay is not None:
                    totals["delay_sum"] += duty.inclusion_delay
                    MONITOR_INCLUSION_DELAY.labels(validator=vi).observe(
                        duty.inclusion_delay
                    )
                totals["head_hits"] += int(duty.head_hit)
                totals["target_hits"] += int(duty.target_hit)
            else:
                totals["attestation_misses"] += 1
                MONITOR_ATTESTATION_MISSES.labels(validator=vi).inc()
            self.log.info(
                "validator epoch summary",
                epoch=epoch,
                validator=vi,
                attestation_hit=duty.attested,
                inclusion_delay=duty.inclusion_delay,
                head_hit=duty.head_hit,
                target_hit=duty.target_hit,
                proposals=proposals.get(vi, 0),
            )
        if self._summarized_through is None or epoch > self._summarized_through:
            self._summarized_through = epoch
        # bound the live per-epoch detail
        for e in [e for e in self._epochs if e + _EPOCH_HISTORY < epoch]:
            del self._epochs[e]
        for e in [e for e in self._proposals_by_epoch if e + _EPOCH_HISTORY < epoch]:
            del self._proposals_by_epoch[e]

    # -- read surfaces ---------------------------------------------------------

    def summary(self, validator_index: int) -> dict:
        """Raw lifetime counts (included attestations / proposed blocks —
        NOT per-epoch hits; a validator attesting 8 slots of one epoch shows
        8 here and 1 in ui_payload)."""
        return {
            "attestations": self._attestation_count.get(validator_index, 0),
            "blocks": self._block_count.get(validator_index, 0),
        }

    def ui_payload(self) -> dict:
        """The /lighthouse/ui/validator_metrics body: cumulative per-epoch
        attribution for every monitored validator."""
        validators = {}
        for vi in sorted(self.monitored):
            t = self._totals[vi]
            hits, misses = t["attestation_hits"], t["attestation_misses"]
            epochs = hits + misses
            validators[str(vi)] = {
                "attestation_hits": hits,
                "attestation_misses": misses,
                "attestation_hit_percentage": (100.0 * hits / epochs) if epochs else 0.0,
                "average_inclusion_delay": (t["delay_sum"] / hits) if hits else 0.0,
                "head_hits": t["head_hits"],
                "target_hits": t["target_hits"],
                "blocks_proposed": t["blocks_proposed"],
            }
        return {"validators": validators}
