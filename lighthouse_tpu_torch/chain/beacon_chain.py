"""The chain core: block production, import, head tracking.

The in-process heart of lighthouse/beacon_node/beacon_chain/src/
beacon_chain.rs (process_block:2400, import_block:2462, produce_block:2889,
fork_choice():3269), built around:
  - state_transition with BlockSignatureStrategy.VERIFY_BULK — every block
    signature (proposal, randao, slashings, attestations, exits) verifies as
    ONE backend batch (on the torch backend, one verify on the card)
  - proto-array fork choice fed by block imports and attestations
  - a Store for blocks and post-states

No networking: the minimum end-to-end slice (copied from the JAX package's
chain/beacon_chain.py).
"""

from __future__ import annotations

from ..fork_choice.fork_choice import ForkChoice
from ..fork_choice.proto_array import ForkChoiceError
from ..state_transition import (
    BlockSignatureStrategy,
    StateTransitionError,
    TransitionContext,
    per_block_processing,
    process_slots,
    state_transition,
)
from ..state_transition.helpers import (
    get_beacon_proposer_index,
    get_current_epoch,
    get_indexed_attestation,
)
from ..state_transition import signature_sets as sigsets
from ..store import MemoryStore
from ..types import compute_epoch_at_slot, compute_signing_root, get_domain
from ..types.containers import BeaconBlockHeader
from .slot_clock import ManualSlotClock


class BlockError(Exception):
    pass


class BeaconChain:
    def __init__(self, genesis_state, ctx: TransitionContext, store=None, slot_clock=None):
        from .events import EventBus
        from .validator_monitor import ValidatorMonitor

        from ..common.flight_recorder import FlightRecorder
        from ..common.slot_ledger import SlotLedger

        self.ctx = ctx
        self.store = store if store is not None else MemoryStore()
        self.slot_clock = slot_clock if slot_clock is not None else ManualSlotClock()
        # per-chain observability: correlated event ring +
        # slot-budget accountant, ticked by the slot clock's listener hook
        self.flight_recorder = FlightRecorder()
        self.slot_ledger = SlotLedger(
            seconds_per_slot=float(ctx.spec.seconds_per_slot),
            recorder=self.flight_recorder,
        )
        listeners = getattr(self.slot_clock, "listeners", None)
        if listeners is not None:
            listeners.append(self.slot_ledger.on_slot)
        self.events = EventBus()
        self.validator_monitor = ValidatorMonitor(
            slots_per_epoch=ctx.preset.slots_per_epoch
        )
        # callables (validator_index, target_epoch) invoked for every
        # attestation seen in imported blocks or accepted from gossip —
        # the doppelganger service's liveness feed (doppelganger_service.rs)
        self.attestation_observers: list = []
        self._last_finalized_epoch = 0

        # gossip dedup / equivocation caches (observed_attesters.rs:40-43,
        # observed_aggregates.rs, observed_block_producers.rs)
        from .observed import (
            ObservedAggregates,
            ObservedAggregators,
            ObservedAttesters,
            ObservedBlockProducers,
        )

        self.observed_attesters = ObservedAttesters()
        self.observed_aggregators = ObservedAggregators()
        self.observed_aggregates = ObservedAggregates()
        self.observed_block_producers = ObservedBlockProducers()

        t = ctx.types
        genesis_state_root = type(genesis_state).hash_tree_root(genesis_state)
        header = BeaconBlockHeader(
            slot=genesis_state.slot,
            proposer_index=genesis_state.latest_block_header.proposer_index,
            parent_root=genesis_state.latest_block_header.parent_root,
            state_root=genesis_state_root,
            body_root=genesis_state.latest_block_header.body_root,
        )
        self.genesis_block_root = BeaconBlockHeader.hash_tree_root(header)
        self.store.put_state(self.genesis_block_root, genesis_state)
        self.fork_choice = ForkChoice(self.genesis_block_root, genesis_state, ctx)
        self.head_root = self.genesis_block_root
        # backfill frontier (store anchor info, hot_cold_store.rs AnchorInfo):
        # for a true-genesis boot the parent root is zero and backfill is
        # already complete; a checkpoint boot anchors mid-chain
        self.oldest_block_root = self.genesis_block_root
        self.oldest_block_slot = int(genesis_state.slot)
        self._anchor_parent_root = bytes(genesis_state.latest_block_header.parent_root)

    @property
    def backfill_complete(self) -> bool:
        """Backfill ends at the first signed block (slot 1): the genesis
        'block' is a header with a zero parent, not a fetchable
        SignedBeaconBlock (backfill_sync/mod.rs stops at genesis)."""
        return self.oldest_block_slot <= 1 or self._anchor_parent_root == b"\x00" * 32

    @property
    def backfill_parent_root(self) -> bytes:
        """Root of the block the backfill frontier needs next (the oldest
        known block's parent) — BackFillSync uses it to tell a bad batch
        from a span that simply ends below the frontier's parent."""
        return self._anchor_parent_root

    # -- queries ---------------------------------------------------------------

    def head_state(self):
        return self.store.get_state(self.head_root)

    def state_at_slot(self, slot: int):
        """Head state advanced (with empty slots) to `slot` — a copy."""
        state = self.head_state().copy()
        if state.slot < slot:
            process_slots(state, slot, self.ctx)
        return state

    # -- import (beacon_chain.rs:2400 process_block + 2462 import_block) -------

    def process_block(
        self,
        signed_block,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ) -> bytes:
        from ..common.metrics import BLOCK_IMPORT_SECONDS
        from ..common.tracing import span

        t = self.ctx.types
        block = signed_block.message
        parent_root = bytes(block.parent_root)
        parent_state = self.store.get_state(parent_root)
        if parent_state is None:
            raise BlockError(f"unknown parent {parent_root.hex()[:16]}")

        # the root trace of the import pipeline: signature verification
        # shows up inside state_transition as the backend's bls spans;
        # store/fork-choice children come from _post_import
        with BLOCK_IMPORT_SECONDS.time(), span("block_import"):
            with span("state_transition"):
                state = parent_state.copy()
                try:
                    state_transition(state, signed_block, self.ctx, strategy=strategy)
                except StateTransitionError as e:
                    raise BlockError(str(e)) from e

            block_root = type(block).hash_tree_root(block)
            self._post_import(block_root, signed_block, state)
            self.recompute_head()
        return block_root

    def _post_import(
        self, block_root: bytes, signed_block, state, execution_status: str | None = None
    ) -> None:
        """Everything after a signature-valid transition: store, events,
        monitor, fork choice (the tail of beacon_chain.rs import_block).
        Does NOT recompute the head — batch importers do that once.
        `execution_status` must be captured at transition time for batch
        imports (the engine's last_status is per-call mutable state)."""
        from ..common.tracing import span
        from ..state_transition.helpers import get_block_root_at_slot

        t = self.ctx.types
        preset = self.ctx.preset
        block = signed_block.message
        # the block carried a valid proposer signature: record (slot,
        # proposer) for the gossip equivocation guard
        # (observed_block_producers.rs)
        self.observed_block_producers.observe(int(block.slot), int(block.proposer_index))
        with span("store_write"):
            self.store.put_block(block_root, signed_block)
            self.store.put_state(block_root, state)
        self.events.emit(
            "block", slot=int(block.slot), block="0x" + block_root.hex()
        )
        self.validator_monitor.on_block_proposed(int(block.proposer_index), int(block.slot))

        # fork choice: the block, then every attestation it carries
        with span("fork_choice"):
            self.fork_choice.on_tick(max(self.slot(), block.slot))
            if execution_status is None:
                execution_status = self._execution_status_of(block)
            self.fork_choice.on_block(
                block, block_root, state, execution_status=execution_status
            )
            monitoring = bool(self.validator_monitor.monitored)
            for att in block.body.attestations:
                indexed = get_indexed_attestation(state, att, t, preset, self.ctx.spec)
                att_slot = int(att.data.slot)
                if monitoring:
                    # canonical-vote attribution against the importing state
                    # (validator_monitor.rs register_attestation_in_block):
                    # head = the chain's block root at the attestation's
                    # slot, target = the root at its target epoch's start
                    # slot. Skipped entirely when nothing is monitored —
                    # this is the block-import hot path.
                    head_hit = bytes(att.data.beacon_block_root) == bytes(
                        get_block_root_at_slot(state, att_slot, preset)
                    )
                    target_start = int(att.data.target.epoch) * preset.slots_per_epoch
                    target_hit = (
                        int(state.slot) - target_start
                        <= preset.slots_per_historical_root
                        and bytes(att.data.target.root)
                        == bytes(get_block_root_at_slot(state, target_start, preset))
                    )
                for vi in indexed.attesting_indices:
                    if monitoring:
                        self.validator_monitor.on_attestation_included(
                            int(vi),
                            att_slot,
                            inclusion_delay=int(block.slot) - att_slot,
                            head_hit=head_hit,
                            target_hit=target_hit,
                        )
                    for obs in self.attestation_observers:
                        obs(int(vi), int(att.data.target.epoch))
                try:
                    self.fork_choice.on_attestation(indexed, is_from_block=True)
                except ForkChoiceError:
                    pass  # e.g. attestation for a block this store never saw
        self.validator_monitor.note_slot(int(block.slot))

    def _execution_status_of(self, block) -> str:
        """EL verdict for the block just imported: "irrelevant" for payload-
        less blocks, "valid" when the engine answered VALID during the
        transition, "optimistic" for SYNCING/ACCEPTED or no engine
        (PayloadVerificationStatus, beacon_chain.rs import path)."""
        from ..state_transition.bellatrix import block_has_payload

        if not block_has_payload(block):
            return "irrelevant"
        last = getattr(getattr(self.ctx, "execution_engine", None), "last_status", None)
        return "valid" if last == "VALID" else "optimistic"

    def on_invalid_execution_payload(self, block_root: bytes) -> None:
        """The EL refuted a previously-optimistic payload: invalidate the
        subtree and move the head off it (fork_choice.rs:516 +
        payload_invalidation.rs)."""
        self.fork_choice.on_invalid_execution_payload(bytes(block_root))
        self.recompute_head()

    def process_chain_segment(self, blocks) -> list[bytes]:
        """Import a parent-linked ascending run of blocks with EVERY block's
        signatures verified in ONE backend batch — the sustained-throughput
        path range sync and backfill feed (block_verification.rs:458
        signature_verify_chain_segment + process_chain_segment).

        On the torch backend this is the big-batch device dispatch: a
        2-epoch batch of minimal-preset blocks lands hundreds of signature
        sets in a single verify on the card. Raises BlockError on the first
        structural problem; the caller may fall back to per-block import
        for precise attribution."""
        blocks = sorted(blocks, key=lambda b: int(b.message.slot))
        blocks = [
            b
            for b in blocks
            if self.store.get_block(type(b.message).hash_tree_root(b.message)) is None
        ]
        if not blocks:
            return []

        parent_root = bytes(blocks[0].message.parent_root)
        parent_state = self.store.get_state(parent_root)
        if parent_state is None:
            raise BlockError(f"unknown parent {parent_root.hex()[:16]}")

        from ..common.tracing import span
        from ..state_transition.per_block import BlockSignatureVerifier

        with span("chain_segment_import"):
            state = parent_state.copy()
            all_sets = []
            staged = []  # (root, signed_block, post_state)
            prev_root = parent_root

            with span("state_transition"):
                for signed in blocks:
                    block = signed.message
                    if bytes(block.parent_root) != prev_root:
                        raise BlockError("segment is not parent-linked")
                    try:
                        process_slots(state, int(block.slot), self.ctx)
                        verifier = BlockSignatureVerifier(state, self.ctx)
                        verifier.include_all_signatures(signed)
                        all_sets.extend(verifier.sets)
                        per_block_processing(
                            state,
                            signed,
                            self.ctx,
                            strategy=BlockSignatureStrategy.NO_VERIFICATION,
                        )
                    except StateTransitionError as e:
                        raise BlockError(str(e)) from e
                    root = type(block).hash_tree_root(block)
                    if bytes(block.state_root) != type(state).hash_tree_root(state):
                        raise BlockError("segment block state root mismatch")
                    # engine verdict is per-block mutable state: capture it NOW
                    staged.append(
                        (root, signed, state.copy(), self._execution_status_of(block))
                    )
                    prev_root = root

            with span("signature_verify"):
                if all_sets and not self.ctx.bls.verify_signature_sets(all_sets):
                    raise BlockError("segment signature verification failed")

            for root, signed, post_state, exec_status in staged:
                self._post_import(root, signed, post_state, execution_status=exec_status)
            self.recompute_head()
            return [root for root, _, _, _ in staged]

    def import_historical_block_batch(self, blocks) -> int:
        """Backfill: append blocks BEHIND the chain's oldest known block.

        The rendering of lighthouse/beacon_node/beacon_chain/src/
        historical_blocks.rs:59 import_historical_block_batch — the heaviest
        sustained signature workload a node runs (whole epochs of proposer
        signatures per call, here ONE backend batch per call):

          1. hash-chain continuity: the batch's last block must be the
             parent of the current oldest block, and each block the parent
             of its successor (no state replay needed — the anchor's
             ancestry commits to every root);
          2. proposer signatures of ALL blocks verified in one batched
             device dispatch, domains from the fork schedule;
          3. blocks persist withOUT post-states (states are reconstructable
             later; the freezer stores blocks + periodic restore points).

        Returns the number of blocks imported. `chain.oldest_block_root/
        oldest_block_slot` track the backfill frontier (store anchor info).
        """
        if not blocks:
            return 0
        blocks = sorted(blocks, key=lambda b: int(b.message.slot), reverse=True)
        expected_root = self._anchor_parent_root
        state = self.head_state()
        resolver = self.ctx.pubkeys.resolver(state)
        sets = []
        chained = []
        for signed in blocks:  # descending slots: walk parents backwards
            block = signed.message
            root = type(block).hash_tree_root(block)
            if root != expected_root:
                raise BlockError(
                    f"historical batch breaks the hash chain at slot {int(block.slot)}"
                )
            sets.append(
                sigsets.historical_block_proposal_signature_set(
                    signed,
                    self.ctx.bls,
                    resolver,
                    self.ctx.preset,
                    self.ctx.spec,
                    state.genesis_validators_root,
                )
            )
            chained.append((root, signed))
            expected_root = bytes(block.parent_root)
        if not self.ctx.bls.verify_signature_sets(sets):
            raise BlockError("historical batch signature verification failed")
        for root, signed in chained:
            self.store.put_block(root, signed)
        tail_root, tail_signed = chained[-1]
        self.oldest_block_root = tail_root
        self.oldest_block_slot = int(tail_signed.message.slot)
        self._anchor_parent_root = bytes(tail_signed.message.parent_root)
        return len(chained)

    def apply_attestation(self, attestation) -> None:
        """Unaggregated/gossip attestation -> fork choice (the tail of
        beacon_chain.rs:1836 apply_attestation_to_fork_choice)."""
        state = self.head_state()
        indexed = get_indexed_attestation(
            state, attestation, self.ctx.types, self.ctx.preset, self.ctx.spec
        )
        self.fork_choice.on_attestation(indexed)

    def recompute_head(self) -> bytes:
        old = self.head_root
        self.head_root = self.fork_choice.get_head()
        if self.head_root != old:
            state = self.store.get_state(self.head_root)
            if not self.fork_choice.is_descendant(old, self.head_root):
                # the new head is on a different branch: a re-org, not a
                # chain extension (beacon_chain.rs detects the same way and
                # feeds metrics::BEACON_REORG_TOTAL + the SSE stream)
                from ..common.metrics import CHAIN_REORGS_TOTAL

                CHAIN_REORGS_TOTAL.inc()
                self.events.emit(
                    "reorg",
                    slot=int(state.slot) if state else None,
                    old_head="0x" + old.hex(),
                    new_head="0x" + self.head_root.hex(),
                )
            self.events.emit(
                "head",
                slot=int(state.slot) if state else None,
                block="0x" + self.head_root.hex(),
            )
            if state is not None:
                fin = state.finalized_checkpoint
                if fin.epoch > self._last_finalized_epoch:
                    self._last_finalized_epoch = fin.epoch
                    self.observed_block_producers.prune(
                        int(fin.epoch) * self.ctx.preset.slots_per_epoch
                    )
                    self.events.emit(
                        "finalized_checkpoint",
                        epoch=int(fin.epoch),
                        block="0x" + bytes(fin.root).hex(),
                    )
        return self.head_root

    def slot(self) -> int:
        return self.slot_clock.now()

    # -- production (beacon_chain.rs:2889 produce_block) -----------------------

    def produce_block_on_state(
        self,
        state,
        slot: int,
        randao_reveal: bytes,
        attestations=(),
        deposits=(),
        exits=(),
        proposer_slashings=(),
        attester_slashings=(),
        graffiti: bytes = b"\x00" * 32,
        sync_aggregate=None,
    ):
        """Build an (unsigned) block on `state` advanced to `slot`, of the
        state's fork variant; returns (block, post_state). The caller signs
        it."""
        t = self.ctx.types
        if state.slot < slot:
            process_slots(state, slot, self.ctx)
        ft = t.for_fork(t.fork_of(state))
        parent_root = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
        proposer_index = get_beacon_proposer_index(state, self.ctx.preset, self.ctx.spec)
        body_kwargs = dict(
            randao_reveal=randao_reveal,
            eth1_data=state.eth1_data,
            graffiti=graffiti,
            proposer_slashings=list(proposer_slashings),
            attester_slashings=list(attester_slashings),
            attestations=list(attestations),
            deposits=list(deposits),
            voluntary_exits=list(exits),
        )
        if t.fork_of(state) != "phase0":
            body_kwargs["sync_aggregate"] = (
                sync_aggregate if sync_aggregate is not None else empty_sync_aggregate(t)
            )
        if "execution_payload" in dict(ft.BeaconBlockBody.fields):
            payload = self._request_payload(state, slot)
            if payload is not None:
                body_kwargs["execution_payload"] = payload
        body = ft.BeaconBlockBody(**body_kwargs)
        block = ft.BeaconBlock(
            slot=slot,
            proposer_index=proposer_index,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=body,
        )
        signed = ft.SignedBeaconBlock(message=block, signature=b"\x00" * 96)
        per_block_processing(
            state, signed, self.ctx, strategy=BlockSignatureStrategy.NO_VERIFICATION
        )
        block.state_root = type(state).hash_tree_root(state)
        return block, state

    def _request_payload(self, state, slot: int):
        """Ask the execution engine to build the block's payload
        (execution_layer/src/lib.rs:142-148: forkchoiceUpdated w/ payload
        attributes -> getPayload). Returns None when no payload-building
        engine is attached AND the chain is pre-merge (the empty payload is
        then valid); raises ExecutionEngineError if the merge is complete
        and no payload can be obtained — producing a payload-less block
        post-merge would be consensus-invalid."""
        from ..state_transition.bellatrix import (
            compute_timestamp_at_slot,
            is_merge_transition_complete,
        )
        from ..state_transition.helpers import (
            ExecutionEngineError,
            get_current_epoch,
            get_randao_mix,
        )

        engine = getattr(self.ctx, "execution_engine", None)
        build = getattr(engine, "build_payload", None)
        merged = is_merge_transition_complete(state)
        if build is None:
            if merged:
                raise ExecutionEngineError(
                    "merge is complete but no payload-building engine attached"
                )
            return None
        try:
            return build(
                self.ctx.types,
                bytes(state.latest_execution_payload_header.block_hash),
                compute_timestamp_at_slot(state, slot, self.ctx),
                bytes(
                    get_randao_mix(
                        state, get_current_epoch(state, self.ctx.preset), self.ctx.preset
                    )
                ),
            )
        except Exception as e:  # noqa: BLE001 — engine transport boundary
            if merged:
                raise ExecutionEngineError(f"payload build failed: {e}") from e
            return None

    def sign_block(self, block, secret_key):
        """Proposal signature (signature_sets.rs:55 semantics). The fork
        version comes from the SCHEDULE at the block's epoch (not the parent
        state's fork record, which is stale for the first block of a new
        fork's epoch)."""
        from ..types import schedule_domain

        spec = self.ctx.spec
        state = self.store.get_state(bytes(block.parent_root)) or self.head_state()
        epoch = compute_epoch_at_slot(block.slot, self.ctx.preset)
        domain = schedule_domain(
            spec, spec.domain_beacon_proposer, epoch, state.genesis_validators_root
        )
        root = compute_signing_root(block, domain)
        signed_cls = self.ctx.types.for_fork(self.ctx.types.fork_of(block.body)).SignedBeaconBlock
        return signed_cls(message=block, signature=secret_key.sign(root).to_bytes())


def empty_sync_aggregate(t):
    """No participants + the infinity signature — the valid empty aggregate
    (sync_aggregate.rs SyncAggregate::new)."""
    from ..crypto.bls.constants import G2_POINT_AT_INFINITY

    return t.SyncAggregate(
        sync_committee_bits=[False] * t.preset.sync_committee_size,
        sync_committee_signature=G2_POINT_AT_INFINITY,
    )
