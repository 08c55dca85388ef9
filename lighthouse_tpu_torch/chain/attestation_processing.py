"""Batched gossip-attestation verification with poisoning fallback.

Python rendering of lighthouse/beacon_node/beacon_chain/src/
attestation_verification/batch.rs:139-222 (batch_verify_unaggregated_
attestations): per-attestation structural checks first, then ONE backend
batch over every surviving signature set; if the batch rejects, fall back
to per-set verification so a single bad signature cannot poison the rest
(batch.rs:203-219). On the torch backend the batch call is one verify on
the card: this is the gossip hot path the BeaconProcessor's re-batching
exists to feed. Copied from the JAX package's chain/attestation_processing.py
and rewired to the port's coalescer, signature sets and caches.
"""

from __future__ import annotations

from ..crypto.bls.batch_verifier import active_for, verify_sets
from ..state_transition import signature_sets as sigsets
from ..state_transition.helpers import (
    StateTransitionError,
    get_indexed_attestation,
)
from ..fork_choice.proto_array import ForkChoiceError


class AttestationError(Exception):
    pass


def _stage_gossip_attestations(chain, attestations):
    """Per-item admission checks + signature-set construction (the host
    staging half). Returns (results, staged) where staged rows are
    (index, indexed_attestation, signature_set)."""
    ctx = chain.ctx
    state = chain.head_state()
    pubkey = ctx.pubkeys.resolver(state)
    current_slot = int(chain.slot())

    results: list = [None] * len(attestations)
    staged = []
    for i, att in enumerate(attestations):
        try:
            _common_attestation_checks(chain, att, current_slot)
            indexed = get_indexed_attestation(state, att, ctx.types, ctx.preset, ctx.spec)
            if not indexed.attesting_indices:
                raise AttestationError("empty attestation")
            # observed_attesters.rs PriorAttestationKnown: every attester
            # already published for this target epoch -> drop without
            # re-verifying (spec: one attestation per validator per epoch)
            epoch = int(indexed.data.target.epoch)
            if all(
                _safe_observed(chain.observed_attesters, epoch, int(vi))
                for vi in indexed.attesting_indices
            ):
                raise AttestationError("prior attestation known")
            s = sigsets.indexed_attestation_signature_set(
                state, indexed, ctx.bls, pubkey, ctx.preset, ctx.spec
            )
            staged.append((i, indexed, s))
        except (AttestationError, StateTransitionError) as e:
            results[i] = e
    return results, staged


def _resolve_and_apply(chain, results, staged, set_verdicts, apply_to_fork_choice):
    """Fill `results` from the per-set verdicts (produced by the coalescer's
    bisection blame, or by the one-batch + per-set poisoning fallback of
    batch.rs:203-219), then observe + fork-choice the accepted
    attestations."""
    for (i, _, _), ok in zip(staged, set_verdicts):
        results[i] = True if ok else AttestationError("invalid signature")

    for i, indexed, _ in staged:
        if results[i] is True:
            epoch = int(indexed.data.target.epoch)
            for vi in indexed.attesting_indices:
                _safe_observe(chain.observed_attesters, epoch, int(vi))
            for obs in chain.attestation_observers:
                for vi in indexed.attesting_indices:
                    obs(int(vi), epoch)
            if apply_to_fork_choice:
                try:
                    chain.fork_choice.on_attestation(indexed)
                except ForkChoiceError:
                    pass
    return results


def batch_verify_gossip_attestations(chain, attestations, apply_to_fork_choice: bool = True):
    """Verify a batch of unaggregated/aggregated gossip attestations.

    Returns a list aligned with `attestations`: True for accepted, or an
    Exception describing the rejection. Accepted attestations are applied
    to fork choice when `apply_to_fork_choice`."""
    from ..common.tracing import span

    with span("gossip_attestation_verify"):
        results, staged = _stage_gossip_attestations(chain, attestations)
        verdicts = verify_sets(chain.ctx.bls, [s for _, _, s in staged])
        return _resolve_and_apply(chain, results, staged, verdicts, apply_to_fork_choice)


class PipelinedGossipVerifier:
    """Overlap host staging of batch i+1 with device execution of batch i.

    The serving-path rendering of the reference's blocking-worker overlap:
    without it the device idles between drain batches. `submit()` runs
    admission checks + set building and DISPATCHES the backend call
    without awaiting the verdict (through the coalescer when one runs over
    the backend, else verify_signature_sets_async on the torch backend;
    synchronous elsewhere); `flush()` materializes verdicts in submission
    order and hands (attestation, result) pairs to the router callback."""

    def __init__(self, chain, apply_to_fork_choice: bool = True):
        self.chain = chain
        self.apply_to_fork_choice = apply_to_fork_choice
        self._pending = []  # (items, results, staged, future|None, corr_meta)
        # roots of attestations staged this cycle but not yet resolved:
        # IDENTICAL duplicates across batches in one drain are dropped
        # without re-verification, while a different attestation from the
        # same validator still verifies (global observed-marking happens
        # only after signature success, as in the reference — keying this
        # on (epoch, validator) would let one bad-signature copy suppress
        # the validator's real attestation)
        self._provisional: set[bytes] = set()

    def submit(self, attestations) -> None:
        results, staged = _stage_gossip_attestations(self.chain, attestations)
        recorder = getattr(self.chain, "flight_recorder", None)
        kept, corr = [], []
        for row in staged:
            i, _indexed, _ = row
            att = attestations[i]
            root = type(att).hash_tree_root(att)
            if root in self._provisional:
                results[i] = AttestationError("prior attestation known")
                continue
            self._provisional.add(root)
            kept.append(row)
            # correlate: the id minted at gossip admission is bound to this
            # root; record the staging hop and ride (recorder, id) alongside
            # the set so the coalescer can mark its batch/verdict hops
            cid = recorder.lookup(bytes(root)) if recorder is not None else None
            if cid is not None:
                recorder.record(cid, "staged", sets=1)
            corr.append((recorder, cid) if cid is not None else None)
        staged = kept
        future = None
        if staged:
            bls = self.chain.ctx.bls
            sets = [s for _, _, s in staged]
            svc = active_for(bls)
            submit_async = getattr(bls, "verify_signature_sets_async", None)
            if svc is not None:
                # cross-caller coalescing: the batch shares a device
                # dispatch with whatever else is in flight, and a failed
                # shared batch bisects to per-set verdicts
                future = svc.submit(sets, corr_meta=corr)
            else:
                from ..common.metrics import BLS_SETS_TOTAL

                # the coalescer counts its sets in _dispatch; direct paths
                # count here so the ledger's throughput derivation sees
                # every gossip set regardless of backend
                BLS_SETS_TOTAL.inc(len(sets))
                if submit_async is not None:
                    future = submit_async(sets)
                else:
                    future = _SyncVerdict(bls.verify_signature_sets(sets))
        self._pending.append((list(attestations), results, staged, future, corr))

    def _verdicts(self, staged, future) -> list:
        """Normalize a batch future into per-set verdicts: BatchFuture
        resolves to a verdict list already; a bool verdict expands to
        all-True or falls back to per-set verification (batch.rs:203)."""
        raw = future.result() if future is not None else []
        if isinstance(raw, (list, tuple)):
            return list(raw)
        if raw:
            return [True] * len(staged)
        bls = self.chain.ctx.bls
        return [bool(bls.verify_signature_sets([s])) for _, _, s in staged]

    def flush(self, route) -> None:
        """`route(att, result)` is called for every submitted attestation,
        in order; result is True or the rejection Exception. Each batch
        resolves behind its own hostile-input boundary: one poisoned batch
        cannot discard the other batches' verdicts."""
        pending, self._pending = self._pending, []
        self._provisional.clear()
        for items, results, staged, future, corr in pending:
            try:
                _resolve_and_apply(
                    self.chain,
                    results,
                    staged,
                    self._verdicts(staged, future),
                    self.apply_to_fork_choice,
                )
            except Exception:  # noqa: BLE001 — hostile-input boundary
                from ..common.metrics import PROCESSOR_ITEMS_DROPPED

                PROCESSOR_ITEMS_DROPPED.inc()
                continue
            for (i, _, _), meta in zip(staged, corr):
                if meta is not None:
                    recorder, cid = meta
                    recorder.record(cid, "verdict", ok=results[i] is True)
            for att, res in zip(items, results):
                try:
                    route(att, res)
                except Exception:  # noqa: BLE001
                    from ..common.metrics import PROCESSOR_ITEMS_DROPPED

                    PROCESSOR_ITEMS_DROPPED.inc()


class _SyncVerdict:
    def __init__(self, ok: bool):
        self._ok = ok

    def result(self) -> bool:
        return self._ok


def _safe_observed(cache, epoch: int, index: int) -> bool:
    from .observed import EpochTooLow

    try:
        return cache.is_observed(epoch, index)
    except EpochTooLow:
        return True  # below the pruning floor: too old, treat as seen


def _safe_observe(cache, epoch: int, index: int) -> bool:
    from .observed import EpochTooLow

    try:
        return cache.observe(epoch, index)
    except EpochTooLow:
        return True


def _common_attestation_checks(chain, att, current_slot: int) -> None:
    """The shared gossip admission list of attestation_verification.rs:607-960:
    slot window, slot/target-epoch consistency, known blocks, and the
    head-descends-from-target ancestry requirement."""
    from ..types import compute_epoch_at_slot

    preset = chain.ctx.preset
    slot = int(att.data.slot)
    # gossip slot window (early attestations re-queue via the reprocessing
    # queue; stale ones beyond ATTESTATION_PROPAGATION_SLOT_RANGE drop)
    if slot > current_slot:
        raise AttestationError("future slot")
    if slot + preset.slots_per_epoch < current_slot:
        raise AttestationError("stale attestation")
    if int(att.data.target.epoch) != compute_epoch_at_slot(slot, preset):
        raise AttestationError("target epoch does not match slot")
    head_root = bytes(att.data.beacon_block_root)
    if not chain.fork_choice.contains_block(head_root):
        raise AttestationError("unknown head block")
    target_root = bytes(att.data.target.root)
    if not chain.fork_choice.contains_block(target_root):
        raise AttestationError("unknown target block")
    if not chain.fork_choice.is_descendant(target_root, head_root):
        raise AttestationError("head does not descend from target")


def batch_verify_gossip_aggregates(chain, aggregates, apply_to_fork_choice: bool = True):
    """Admit a batch of gossiped SignedAggregateAndProofs.

    The three-signature admission of
    lighthouse/beacon_node/beacon_chain/src/attestation_verification.rs:1143-1201
    — selection proof, outer aggregator signature, inner aggregate — built
    for EVERY aggregate in the batch and dispatched as ONE backend call
    (3*N sets), with the same per-aggregate poisoning fallback as the
    unaggregated path. Returns a list aligned with `aggregates`: True or an
    Exception."""
    from ..common.tracing import span

    # the span covers the WHOLE admission (staging + verify + application),
    # matching gossip_attestation_verify's scope so the two stage metrics
    # are comparable; the BLS-only cost is the nested bls_batch_verify span
    with span("gossip_aggregate_verify"):
        return _batch_verify_gossip_aggregates(chain, aggregates, apply_to_fork_choice)


def _batch_verify_gossip_aggregates(chain, aggregates, apply_to_fork_choice: bool):
    from ..state_transition.helpers import get_beacon_committee, is_aggregator

    ctx = chain.ctx
    state = chain.head_state()
    resolver = ctx.pubkeys.resolver(state)
    current_slot = int(chain.slot())

    chain.observed_aggregates.prune(current_slot, ctx.preset.slots_per_epoch + 2)

    results: list = [None] * len(aggregates)
    staged = []  # (index, signed_aggregate, indexed_attestation, [three sets], data_root)
    for i, signed in enumerate(aggregates):
        try:
            msg = signed.message
            att = msg.aggregate
            _common_attestation_checks(chain, att, current_slot)
            # observed_aggregates.rs AttestationKnown: an aggregate whose
            # participation is a (non-strict) subset of one already seen
            # this slot carries nothing new
            data_root = type(att.data).hash_tree_root(att.data)
            if chain.observed_aggregates.is_observed(
                int(att.data.slot), data_root, att.aggregation_bits
            ):
                raise AttestationError("aggregate already known")
            # observed_attesters.rs AggregatorAlreadyKnown
            if _safe_observed(
                chain.observed_aggregators,
                int(att.data.target.epoch),
                int(msg.aggregator_index),
            ):
                raise AttestationError("aggregator already known")
            committee = get_beacon_committee(
                state, int(att.data.slot), int(att.data.index), ctx.preset, ctx.spec
            )
            if int(msg.aggregator_index) not in committee:
                raise AttestationError("aggregator not in committee")
            if not is_aggregator(len(committee), bytes(msg.selection_proof)):
                raise AttestationError("selection proof does not select aggregator")
            indexed = get_indexed_attestation(state, att, ctx.types, ctx.preset, ctx.spec)
            if not indexed.attesting_indices:
                raise AttestationError("empty aggregate")
            sets = [
                sigsets.selection_proof_signature_set(
                    state, int(att.data.slot), int(msg.aggregator_index),
                    msg.selection_proof, ctx.bls, resolver, ctx.preset, ctx.spec,
                ),
                sigsets.aggregate_and_proof_signature_set(
                    state, signed, ctx.bls, resolver, ctx.preset, ctx.spec
                ),
                sigsets.indexed_attestation_signature_set(
                    state, indexed, ctx.bls, resolver, ctx.preset, ctx.spec
                ),
            ]
            staged.append((i, signed, indexed, sets, data_root))
        except (AttestationError, StateTransitionError) as e:
            results[i] = e

    # correlate: the admission-time id is bound to the signed aggregate's
    # root; all three of an aggregate's sets share its one correlation id
    recorder = getattr(chain, "flight_recorder", None)
    corr_of_row: dict[int, str] = {}
    if recorder is not None:
        for i, signed, _, sets, _ in staged:
            cid = recorder.lookup(bytes(type(signed).hash_tree_root(signed)))
            if cid is not None:
                recorder.record(cid, "staged", sets=len(sets))
                corr_of_row[i] = cid

    if staged:
        svc = active_for(ctx.bls)
        if svc is not None:
            # coalesced: one verdict per individual set (bisection blame);
            # an aggregate is admitted iff all three of its sets verify
            all_sets = [s for _, _, _, sets, _ in staged for s in sets]
            all_meta = [
                (recorder, corr_of_row[i]) if i in corr_of_row else None
                for i, _, _, sets, _ in staged
                for _ in sets
            ]
            verdicts = svc.submit(all_sets, corr_meta=all_meta).result()
            pos = 0
            for i, _, _, sets, _ in staged:
                ok = all(verdicts[pos : pos + len(sets)])
                pos += len(sets)
                results[i] = True if ok else AttestationError("invalid signature")
        else:
            from ..common.metrics import BLS_SETS_TOTAL

            all_sets = [s for _, _, _, sets, _ in staged for s in sets]
            BLS_SETS_TOTAL.inc(len(all_sets))
            if ctx.bls.verify_signature_sets(all_sets):
                for i, _, _, _, _ in staged:
                    results[i] = True
            else:
                for i, _, _, sets, _ in staged:
                    results[i] = (
                        True
                        if ctx.bls.verify_signature_sets(sets)
                        else AttestationError("invalid signature")
                    )
        for i, cid in corr_of_row.items():
            recorder.record(cid, "verdict", ok=results[i] is True)

    for i, signed, indexed, _, data_root in staged:
        if results[i] is True:
            chain.observed_aggregates.observe(
                int(indexed.data.slot),
                data_root,
                signed.message.aggregate.aggregation_bits,
            )
            _safe_observe(
                chain.observed_aggregators,
                int(indexed.data.target.epoch),
                int(signed.message.aggregator_index),
            )
            for obs in chain.attestation_observers:
                for vi in indexed.attesting_indices:
                    obs(int(vi), int(indexed.data.target.epoch))
            if apply_to_fork_choice:
                try:
                    chain.fork_choice.on_attestation(indexed)
                except ForkChoiceError:
                    pass
    return results
