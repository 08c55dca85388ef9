"""Validator client: duties, signing, publishing.

Counterpart of lighthouse/validator_client/src (lib.rs:81
ProductionValidatorClient, duties_service.rs, attestation_service.rs,
block_service.rs), restructured in-process: the `BeaconNodeApi` seam plays
the role of the eth2 HTTP client — the duty/production/publish surface is
the same, so an HTTP transport can slot in behind it without touching the
services.

Every signature passes through the ValidatorStore, which consults the
EIP-3076 slashing database before releasing a signature
(signing_method.rs + slashing_database.rs one-txn-per-signing).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..chain.attestation_processing import batch_verify_gossip_attestations
from ..common.metrics import REGISTRY
from ..op_pool import OperationPool
from ..ssz.types import uint64
from ..state_transition.helpers import (
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    get_current_epoch,
)
from ..types import (
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_domain,
    schedule_domain,
)
from ..types.containers import Checkpoint, SigningData
from .slashing_protection import SlashingDatabase, SlashingProtectionError


# successful duty publications per type — the VC's own /metrics headline
# (http_metrics' SIGNED_* counters in the reference VC)
VC_DUTIES_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_vc_duties_total",
    "Duties this validator client completed, by duty type",
    ("duty",),
)


@dataclass
class AttesterDuty:
    validator_index: int
    slot: int
    committee_index: int
    committee_position: int
    committee_length: int


class ValidatorStore:
    """Keys + slashing-protected signing (validator_store.rs)."""

    def __init__(self, ctx, slashing_db: SlashingDatabase | None = None):
        self.ctx = ctx
        self.keys = {}  # pubkey bytes -> SecretKey | web3signer.RemoteKey
        self.slashing_db = slashing_db or SlashingDatabase()

    def _key_for(self, pubkey: bytes, duty_type: str):
        """The signing key, stamped with the duty type when remote (the
        Web3Signer request's "type" field; local keys ignore it)."""
        key = self.keys[pubkey]
        if hasattr(key, "set_duty"):
            key.set_duty(duty_type)
        return key

    def add_validator(self, secret_key) -> bytes:
        pk = secret_key.public_key().to_bytes()
        self.keys[pk] = secret_key
        self.slashing_db.register_validator(pk)
        return pk

    def add_web3signer_validator(self, pubkey: bytes, client) -> bytes:
        """Register a key whose secret lives in a remote Web3Signer
        (signing_method.rs SigningMethod::Web3Signer): the RemoteKey carries
        the same sign(root) shape local SecretKeys have, so every duty path
        and the slashing DB work identically."""
        from .web3signer import RemoteKey

        pk = bytes(pubkey)
        self.keys[pk] = RemoteKey(pk, client)
        self.slashing_db.register_validator(pk)
        return pk

    def pubkeys(self) -> list[bytes]:
        return list(self.keys)

    def sign_block(self, pubkey: bytes, block, state):
        # schedule_domain, NOT get_domain on the head state: the head state's
        # fork record is stale when proposing the first block of a new
        # fork's epoch (the verifier checks against the post-slots state)
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_beacon_proposer,
            compute_epoch_at_slot(block.slot, ctx.preset),
            state.genesis_validators_root,
        )
        root = compute_signing_root(block, domain)
        self.slashing_db.check_and_insert_block_proposal(pubkey, block.slot, root)
        return self._key_for(pubkey, "BLOCK_V2").sign(root).to_bytes()

    def sign_attestation(self, pubkey: bytes, data, state) -> bytes:
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_beacon_attester,
            data.target.epoch,
            state.genesis_validators_root,
        )
        root = compute_signing_root(data, domain)
        self.slashing_db.check_and_insert_attestation(
            pubkey, data.source.epoch, data.target.epoch, root
        )
        return self._key_for(pubkey, "ATTESTATION").sign(root).to_bytes()

    def sign_randao(self, pubkey: bytes, epoch: int, state) -> bytes:
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec, ctx.spec.domain_randao, epoch, state.genesis_validators_root
        )
        sd = SigningData(object_root=uint64.hash_tree_root(epoch), domain=domain)
        return self._key_for(pubkey, "RANDAO_REVEAL").sign(
            SigningData.hash_tree_root(sd)
        ).to_bytes()

    def sign_selection_proof(self, pubkey: bytes, slot: int, state) -> bytes:
        """Aggregation-slot selection proof (signing_method.rs
        SignableMessage::SelectionProof): the slot under
        DOMAIN_SELECTION_PROOF; its hash decides aggregator duty."""
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_selection_proof,
            slot // ctx.preset.slots_per_epoch,
            state.genesis_validators_root,
        )
        sd = SigningData(object_root=uint64.hash_tree_root(slot), domain=domain)
        return self._key_for(pubkey, "AGGREGATION_SLOT").sign(
            SigningData.hash_tree_root(sd)
        ).to_bytes()

    def sign_aggregate_and_proof(self, pubkey: bytes, message, state) -> bytes:
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_aggregate_and_proof,
            int(message.aggregate.data.slot) // ctx.preset.slots_per_epoch,
            state.genesis_validators_root,
        )
        root = compute_signing_root(message, domain)
        return self._key_for(pubkey, "AGGREGATE_AND_PROOF").sign(root).to_bytes()

    def sign_sync_selection_proof(
        self, pubkey: bytes, slot: int, subcommittee_index: int, state
    ) -> bytes:
        """SyncAggregatorSelectionData signature deciding sync-subcommittee
        aggregator duty (signing_method.rs SyncSelectionProof)."""
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_sync_committee_selection_proof,
            slot // ctx.preset.slots_per_epoch,
            state.genesis_validators_root,
        )
        obj = ctx.types.SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subcommittee_index
        )
        root = compute_signing_root(obj, domain)
        return self._key_for(pubkey, "SYNC_COMMITTEE_SELECTION_PROOF").sign(root).to_bytes()

    def sign_contribution_and_proof(self, pubkey: bytes, message, state) -> bytes:
        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_contribution_and_proof,
            int(message.contribution.slot) // ctx.preset.slots_per_epoch,
            state.genesis_validators_root,
        )
        root = compute_signing_root(message, domain)
        return self._key_for(pubkey, "SYNC_COMMITTEE_CONTRIBUTION_AND_PROOF").sign(
            root
        ).to_bytes()

    def sign_sync_committee_message(
        self, pubkey: bytes, slot: int, block_root: bytes, state
    ) -> bytes:
        """Sync-committee duty signature over the head block root
        (sync_committee_service.rs; verified by
        signature_sets.sync_committee_message_signature_set)."""
        from ..ssz.types import Bytes32

        ctx = self.ctx
        domain = schedule_domain(
            ctx.spec,
            ctx.spec.domain_sync_committee,
            slot // ctx.preset.slots_per_epoch,
            state.genesis_validators_root,
        )
        sd = SigningData(
            object_root=Bytes32.hash_tree_root(bytes(block_root)), domain=domain
        )
        return self._key_for(pubkey, "SYNC_COMMITTEE_MESSAGE").sign(
            SigningData.hash_tree_root(sd)
        ).to_bytes()


class BeaconNodeApi:
    """In-process beacon-node surface (the role of common/eth2's
    BeaconNodeHttpClient + beacon_node/http_api endpoints the VC uses)."""

    def __init__(self, chain, op_pool: OperationPool | None = None):
        from ..op_pool.sync_pool import SyncMessagePool

        self.chain = chain
        self.op_pool = op_pool or OperationPool(chain.ctx)
        self.sync_pool = SyncMessagePool(chain.ctx)
        self._sync_committee_cache: dict[int, list[bytes]] = {}
        # (slot, head_root) -> (source cp, target epoch, target root):
        # the attester_cache.rs role (one state advance per slot+head)
        self._att_data_cache: dict = {}

    # duties (http_api validator/duties/{attester,proposer})
    def attester_duties(self, epoch: int, pubkeys: list[bytes]) -> list[AttesterDuty]:
        ctx = self.chain.ctx
        state = self.chain.head_state().copy()
        start = compute_start_slot_at_epoch(epoch, ctx.preset)
        if state.slot < start:
            from ..state_transition import process_slots

            process_slots(state, start, ctx)
        index_by_pk = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        wanted = {index_by_pk[pk] for pk in pubkeys if pk in index_by_pk}
        duties = []
        for slot in range(start, start + ctx.preset.slots_per_epoch):
            n = get_committee_count_per_slot(state, epoch, ctx.preset)
            for ci in range(n):
                committee = get_beacon_committee(state, slot, ci, ctx.preset, ctx.spec)
                for pos, vi in enumerate(committee):
                    if vi in wanted:
                        duties.append(
                            AttesterDuty(
                                validator_index=vi,
                                slot=slot,
                                committee_index=ci,
                                committee_position=pos,
                                committee_length=len(committee),
                            )
                        )
        return duties

    def _state_at_epoch_start(self, epoch: int):
        """A state advanced to exactly the epoch's start slot: walk head
        ancestry back to the last block before the epoch, then advance its
        post-state forward (proposer seeds depend on state.slot, so duties
        must come from the epoch-start state, not the head state)."""
        ctx = self.chain.ctx
        start = compute_start_slot_at_epoch(epoch, ctx.preset)
        root = self.chain.head_root
        block = self.chain.store.get_block(root)
        while block is not None and block.message.slot >= start:
            root = bytes(block.message.parent_root)
            block = self.chain.store.get_block(root)
        state = self.chain.store.get_state(root)
        if state is None:  # pre-genesis epoch or pruned: fall back to head
            state = self.chain.head_state()
        state = state.copy()
        if state.slot < start:
            from ..state_transition import process_slots

            process_slots(state, start, ctx)
        return state

    def proposer_duties(self, epoch: int) -> dict[int, int]:
        """slot -> proposer validator index, from the epoch-start state
        advanced sequentially (ONE state walk per epoch, not per slot)."""
        ctx = self.chain.ctx
        from ..state_transition import process_slots

        state = self._state_at_epoch_start(epoch)
        start = compute_start_slot_at_epoch(epoch, ctx.preset)
        out = {}
        for slot in range(start, start + ctx.preset.slots_per_epoch):
            if state.slot < slot:
                process_slots(state, slot, ctx)
            out[slot] = get_beacon_proposer_index(state, ctx.preset, ctx.spec)
        return out

    # attestation production/publish (validator/attestation_data + POST)
    def attestation_data(self, slot: int, committee_index: int):
        """AttestationData for a duty. The (source, target) pair depends
        only on (slot, head) — NOT the committee index — so it is computed
        once per slot+head and served to every committee from the cache
        (attester_cache.rs: 'the data is identical for all validators of a
        slot'; state_at_slot's state copy is the expensive part)."""
        ctx = self.chain.ctx
        head_root = self.chain.head_root
        key = (int(slot), bytes(head_root))
        hit = self._att_data_cache.get(key)
        if hit is None:
            state = self.chain.state_at_slot(slot)
            epoch = compute_epoch_at_slot(slot, ctx.preset)
            start_slot = compute_start_slot_at_epoch(epoch, ctx.preset)
            if start_slot == slot or state.slot <= start_slot:
                target_root = head_root
            else:
                target_root = bytes(
                    state.block_roots[start_slot % ctx.preset.slots_per_historical_root]
                )
            hit = (state.current_justified_checkpoint, epoch, target_root)
            if len(self._att_data_cache) > 64:
                self._att_data_cache.clear()
            self._att_data_cache[key] = hit
        source, epoch, target_root = hit
        return ctx.types.AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=head_root,
            source=source,
            target=Checkpoint(epoch=epoch, root=target_root),
        )

    def publish_attestation(self, attestation) -> bool:
        results = batch_verify_gossip_attestations(self.chain, [attestation])
        ok = results[0] is True
        if ok:
            self.op_pool.insert_attestation(attestation)
        return ok

    # aggregation (validator/aggregate_attestation + aggregate_and_proofs)
    def get_aggregate(self, slot: int, committee_index: int):
        """Best pooled aggregate for (slot, index) — the naive aggregation
        pool read (beacon_chain.rs get_aggregated_attestation)."""
        best = None
        for bucket in self.op_pool.attestations.values():
            for att in bucket:
                if int(att.data.slot) == slot and int(att.data.index) == committee_index:
                    if best is None or sum(att.aggregation_bits) > sum(best.aggregation_bits):
                        best = att
        return best

    def publish_aggregate(self, signed_aggregate) -> bool:
        """Admit a SignedAggregateAndProof via the chain-level three-set
        batched admission (attestation_processing.batch_verify_gossip_
        aggregates — attestation_verification.rs:1143-1201)."""
        from ..chain.attestation_processing import batch_verify_gossip_aggregates

        results = batch_verify_gossip_aggregates(self.chain, [signed_aggregate])
        if results[0] is not True:
            return False
        self.op_pool.insert_attestation(signed_aggregate.message.aggregate)
        return True

    # sync contributions (validator/sync_committee_contribution + POST)
    def produce_sync_contribution(self, slot: int, block_root: bytes, subcommittee_index: int):
        """Best contribution for a subcommittee from the pooled messages
        (the naive aggregation pool read the reference serves aggregators)."""
        ctx = self.chain.ctx
        sub_size = ctx.preset.sync_subcommittee_size
        per_pos = self.sync_pool.positions_with_own_signature(slot, block_root)
        lo = subcommittee_index * sub_size
        sub_bits = [lo + i in per_pos for i in range(sub_size)]
        if not any(sub_bits):
            return None
        sub_sigs = [per_pos[lo + i] for i in range(sub_size) if sub_bits[i]]
        return ctx.types.SyncCommitteeContribution(
            slot=slot,
            beacon_block_root=bytes(block_root),
            subcommittee_index=subcommittee_index,
            aggregation_bits=sub_bits,
            signature=ctx.bls.aggregate_signatures(sub_sigs).to_bytes(),
        )

    def publish_contribution(self, signed_contribution) -> bool:
        """Admit a SignedContributionAndProof: selection proof + outer
        signature + the contribution's aggregate, one batched call
        (sync_committee_verification.rs)."""
        from ..state_transition import signature_sets as sigsets
        from ..state_transition.helpers import StateTransitionError

        ctx = self.chain.ctx
        state = self.chain.head_state()
        if ctx.types.fork_of(state) == "phase0":
            return False
        msg = signed_contribution.message
        contribution = msg.contribution
        from ..types import SYNC_COMMITTEE_SUBNET_COUNT

        sub_size = ctx.preset.sync_subcommittee_size
        sub_index = int(contribution.subcommittee_index)
        if sub_index >= SYNC_COMMITTEE_SUBNET_COUNT:
            return False
        committee = self._sync_committee_for_message_slot(int(contribution.slot))
        if committee is None:
            return False
        lo = sub_index * sub_size
        participant_pks = [
            committee[lo + i]
            for i, bit in enumerate(contribution.aggregation_bits)
            if bit
        ]
        if not participant_pks:
            return False
        # the aggregator must be a MEMBER of this subcommittee and its proof
        # must actually SELECT it (sync_committee_verification.rs
        # AggregatorNotInCommittee / InvalidSelectionProof)
        if not (0 <= int(msg.aggregator_index) < len(state.validators)):
            return False
        agg_pk = bytes(state.validators[int(msg.aggregator_index)].pubkey)
        if agg_pk not in committee[lo : lo + sub_size]:
            return False
        if not is_sync_aggregator(sub_size, bytes(msg.selection_proof)):
            return False
        resolver = ctx.pubkeys.resolver(state)
        try:
            sets = [
                sigsets.sync_selection_proof_signature_set(
                    state,
                    int(contribution.slot),
                    sub_index,
                    int(msg.aggregator_index),
                    msg.selection_proof,
                    ctx.bls,
                    resolver,
                    ctx.preset,
                    ctx.spec,
                    types=ctx.types,
                ),
                sigsets.contribution_and_proof_signature_set(
                    state, signed_contribution, ctx.bls, resolver, ctx.preset, ctx.spec
                ),
                sigsets.sync_contribution_signature_set(
                    state, contribution, participant_pks, ctx.bls, ctx.preset, ctx.spec
                ),
            ]
        except StateTransitionError:
            return False
        if not ctx.bls.verify_signature_sets(sets):
            return False
        # fold into the pool at full-committee positions
        positions = [lo + i for i, bit in enumerate(contribution.aggregation_bits) if bit]
        self.sync_pool.add_aggregate(
            int(contribution.slot),
            bytes(contribution.beacon_block_root),
            sub_index,
            positions,
            bytes(contribution.signature),
        )
        return True

    # sync committee duties (validator/duties/sync + sync_committee pool)
    def _sync_committee_for_message_slot(self, slot: int) -> list[bytes] | None:
        """Pubkeys (by position) of the committee that will VERIFY messages
        made at `slot`: the committee of the state at slot+1, where the
        aggregating block lives. Using the head state's committee directly
        would hand out the outgoing committee on the last slot of every
        sync-committee period (the spec's slot+1 lookahead rule). Cached per
        period — a period's current committee is fixed once it starts."""
        ctx = self.chain.ctx
        state = self.chain.head_state()
        if ctx.types.fork_of(state) == "phase0":
            return None
        per_len = ctx.preset.epochs_per_sync_committee_period
        period = compute_epoch_at_slot(slot + 1, ctx.preset) // per_len
        cached = self._sync_committee_cache.get(period)
        if cached is None:
            head_period = compute_epoch_at_slot(state.slot, ctx.preset) // per_len
            if period < head_period:
                # a duty slot behind the head's period: state_at_slot cannot
                # rewind, so the outgoing committee is unrecoverable here —
                # no duties rather than wrong positions
                return None
            if period > head_period:
                state = self.chain.state_at_slot(slot + 1)
            cached = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
            self._sync_committee_cache = {
                p: c for p, c in self._sync_committee_cache.items() if p + 2 > period
            }
            self._sync_committee_cache[period] = cached
        return cached

    def sync_duties(self, pubkeys: list[bytes], slot: int) -> dict[bytes, list[int]]:
        """pubkey -> committee positions for messages made at `slot`
        (empty dict on phase0)."""
        committee = self._sync_committee_for_message_slot(slot)
        if committee is None:
            return {}
        wanted = set(pubkeys)
        out: dict[bytes, list[int]] = {}
        for pos, pkb in enumerate(committee):
            if pkb in wanted:
                out.setdefault(pkb, []).append(pos)
        return out

    def publish_sync_message(self, message) -> bool:
        """Verify a SyncCommitteeMessage against the head state and pool it
        (sync_committee_verification.rs gossip admission, minus p2p)."""
        from ..state_transition import signature_sets as sigsets
        from ..state_transition.helpers import StateTransitionError

        ctx = self.chain.ctx
        state = self.chain.head_state()
        if ctx.types.fork_of(state) == "phase0":
            return False
        try:
            s = sigsets.sync_committee_message_signature_set(
                state, message, ctx.bls, ctx.pubkeys.resolver(state), ctx.preset, ctx.spec
            )
        except StateTransitionError:
            return False
        # single-set path: rides a shared coalesced device batch when the
        # BatchVerifier service is running (crypto/bls/batch_verifier.py)
        from ..crypto.bls.batch_verifier import verify_sets

        if not verify_sets(ctx.bls, [s])[0]:
            return False
        vk = bytes(state.validators[message.validator_index].pubkey)
        positions = self.sync_duties([vk], int(message.slot)).get(vk)
        if not positions:
            return False
        self.sync_pool.add(message, positions)
        return True

    # block production/publish (validator/blocks + POST)
    def produce_block(self, slot: int, randao_reveal: bytes):
        from ..types.containers import BeaconBlockHeader

        chain = self.chain
        state = chain.state_at_slot(slot)
        atts = self.op_pool.get_attestations(state)
        proposer, attester, exits = self.op_pool.get_slashings_and_exits(state)
        sync_aggregate = None
        if chain.ctx.types.fork_of(state) != "phase0":
            # the block's sync aggregate covers the PREVIOUS slot's head
            parent_root = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
            sync_aggregate = self.sync_pool.get_sync_aggregate(slot - 1, parent_root)
        block, _ = chain.produce_block_on_state(
            state,
            slot,
            randao_reveal,
            attestations=atts,
            proposer_slashings=proposer,
            attester_slashings=attester,
            exits=exits,
            sync_aggregate=sync_aggregate,
        )
        return block

    def publish_block(self, signed_block) -> bytes:
        self.chain.slot_clock.set_slot(max(self.chain.slot(), signed_block.message.slot))
        root = self.chain.process_block(signed_block)
        self.op_pool.prune(self.chain.store.get_state(root))
        self.sync_pool.prune(int(signed_block.message.slot))
        return root


from ..state_transition.helpers import (  # noqa: E402
    TARGET_AGGREGATORS_PER_COMMITTEE,
)

TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 16


def is_sync_aggregator(subcommittee_size: int, selection_proof: bytes) -> bool:
    """Spec is_sync_committee_aggregator (altair validator guide)."""
    import hashlib

    modulo = max(1, subcommittee_size // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE)
    digest = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(digest[:8], "little") % modulo == 0


# spec is_aggregator moved to state_transition.helpers (the chain-side
# aggregate admission needs it too); re-exported here for duty services
from ..state_transition.helpers import is_aggregator  # noqa: E402


class ValidatorClient:
    """Drives duties for its validators each slot (the per-slot work of
    duties_service + attestation_service + block_service)."""

    def __init__(self, api: BeaconNodeApi, store: ValidatorStore, doppelganger=None):
        self.api = api
        self.store = store
        self.ctx = store.ctx
        self.doppelganger = doppelganger  # None -> protection disabled
        self._duty_cache: dict[int, list[AttesterDuty]] = {}
        self._proposer_cache: dict[int, dict[int, int]] = {}
        # the /health surface (metrics_server.MetricsServer)
        self.last_duty_slot: int | None = None
        self.duty_totals: dict[str, int] = {}
        if doppelganger is not None:
            # liveness feed: every attestation the BN sees (blocks + gossip)
            api.chain.attestation_observers.append(self._observe_attestation)

    def _observe_attestation(self, validator_index: int, epoch: int) -> None:
        from .doppelganger import DoppelgangerDetected

        try:
            self.doppelganger.observe_attestation(validator_index, epoch)
        except DoppelgangerDetected as e:
            # signing stays disabled permanently (recorded in the service);
            # a production deployment would also initiate shutdown here
            # (doppelganger_service.rs shuts the whole VC down)
            print(f"CRITICAL: {e}")

    def _register_doppelganger(self, epoch: int) -> None:
        """Register every managed validator each duty tick — register() is
        idempotent (setdefault), and running per-tick means keys added to
        the store mid-flight, or whose deposits activate later, still get a
        watch window before their first signature
        (doppelganger_service.rs register_*)."""
        if self.doppelganger is None:
            return
        state = self.api.chain.head_state()
        index_by_pk = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        for pk in self.store.pubkeys():
            vi = index_by_pk.get(pk)
            if vi is not None:
                self.doppelganger.register(vi, epoch)

    def _may_sign(self, validator_index: int, epoch: int) -> bool:
        if self.doppelganger is None:
            return True
        return self.doppelganger.allows_signing(validator_index, epoch)

    def _duties_for_epoch(self, epoch: int) -> list[AttesterDuty]:
        if epoch not in self._duty_cache:
            self._duty_cache[epoch] = self.api.attester_duties(epoch, self.store.pubkeys())
            # keep the cache bounded
            for e in [e for e in self._duty_cache if e + 2 < epoch]:
                del self._duty_cache[e]
        return self._duty_cache[epoch]

    def on_slot(self, slot: int) -> dict:
        """Run this slot's duties: propose if due, then attest. Returns a
        summary {proposed: root|None, attested: n}."""
        ctx = self.ctx
        epoch = compute_epoch_at_slot(slot, ctx.preset)
        self._register_doppelganger(epoch)
        summary = {
            "proposed": None,
            "attested": 0,
            "synced": 0,
            "aggregated": 0,
            "contributions": 0,
        }

        # -- block duty (block_service.rs) --
        if epoch not in self._proposer_cache:
            self._proposer_cache[epoch] = self.api.proposer_duties(epoch)
            for e in [e for e in self._proposer_cache if e + 2 < epoch]:
                del self._proposer_cache[e]
        proposers = self._proposer_cache[epoch]
        proposer_index = proposers.get(slot)
        state = self.api.chain.head_state()
        if (
            proposer_index is not None
            and proposer_index < len(state.validators)
            and self._may_sign(proposer_index, epoch)
        ):
            pk = bytes(state.validators[proposer_index].pubkey)
            if pk in self.store.keys:
                reveal = self.store.sign_randao(pk, epoch, state)
                block = self.api.produce_block(slot, reveal)
                try:
                    sig = self.store.sign_block(pk, block, state)
                except SlashingProtectionError:
                    # a proposal was already signed for this slot (e.g. the
                    # key is doubled elsewhere): refuse, keep attesting —
                    # the DB refusing is the success case, not a crash
                    sig = None
                if sig is not None:
                    signed_cls = ctx.types.for_fork(ctx.types.fork_of(block.body)).SignedBeaconBlock
                    signed = signed_cls(message=block, signature=sig)
                    summary["proposed"] = self.api.publish_block(signed)

        # -- attestation duties at slot (attestation_service.rs:125) --
        head_state = self.api.chain.head_state()
        index_by_pk = {bytes(v.pubkey): i for i, v in enumerate(head_state.validators)}
        by_committee: dict[int, list[AttesterDuty]] = {}
        for duty in self._duties_for_epoch(epoch):
            if duty.slot == slot:
                by_committee.setdefault(duty.committee_index, []).append(duty)
        for ci, duties in sorted(by_committee.items()):
            data = self.api.attestation_data(slot, ci)
            for duty in duties:
                if not self._may_sign(duty.validator_index, epoch):
                    continue
                pk = next(
                    (
                        pk
                        for pk, vi in index_by_pk.items()
                        if vi == duty.validator_index and pk in self.store.keys
                    ),
                    None,
                )
                if pk is None:
                    continue
                try:
                    sig = self.store.sign_attestation(pk, data, head_state)
                except SlashingProtectionError:
                    continue
                bits = [i == duty.committee_position for i in range(duty.committee_length)]
                att = ctx.types.Attestation(
                    aggregation_bits=bits, data=data, signature=sig
                )
                if self.api.publish_attestation(att):
                    summary["attested"] += 1

        # -- aggregation duty (attestation_service.rs slot+2/3 aggregates) --
        pk_by_index = {
            vi: pk for pk, vi in index_by_pk.items() if pk in self.store.keys
        }
        for ci, duties in sorted(by_committee.items()):
            aggregate = self.api.get_aggregate(slot, ci)  # one pool scan per ci
            if aggregate is None:
                continue
            for duty in duties:
                if not self._may_sign(duty.validator_index, epoch):
                    continue
                pk = pk_by_index.get(duty.validator_index)
                if pk is None:
                    continue
                proof = self.store.sign_selection_proof(pk, slot, head_state)
                if not is_aggregator(duty.committee_length, proof):
                    continue
                message = ctx.types.AggregateAndProof(
                    aggregator_index=duty.validator_index,
                    aggregate=aggregate,
                    selection_proof=proof,
                )
                signed = ctx.types.SignedAggregateAndProof(
                    message=message,
                    signature=self.store.sign_aggregate_and_proof(pk, message, head_state),
                )
                if self.api.publish_aggregate(signed):
                    summary["aggregated"] += 1

        # -- sync committee duties (sync_committee_service.rs) --
        head_root = self.api.chain.head_root
        sync_duties = self.api.sync_duties(self.store.pubkeys(), slot)
        for pk, positions in sync_duties.items():
            vi = index_by_pk.get(pk)
            if vi is None or not self._may_sign(vi, epoch):
                continue
            sig = self.store.sign_sync_committee_message(pk, slot, head_root, head_state)
            msg = ctx.types.SyncCommitteeMessage(
                slot=slot,
                beacon_block_root=head_root,
                validator_index=vi,
                signature=sig,
            )
            if self.api.publish_sync_message(msg):
                summary["synced"] += 1

        # -- sync contribution duty (per-subcommittee aggregators) --
        sub_size = ctx.preset.sync_subcommittee_size
        contribution_cache: dict[int, object] = {}  # one pool scan per sub
        for pk, positions in sync_duties.items():
            vi = index_by_pk.get(pk)
            if vi is None or not self._may_sign(vi, epoch):
                continue
            for sub_index in sorted({p // sub_size for p in positions}):
                proof = self.store.sign_sync_selection_proof(pk, slot, sub_index, head_state)
                if not is_sync_aggregator(sub_size, proof):
                    continue
                if sub_index not in contribution_cache:
                    contribution_cache[sub_index] = self.api.produce_sync_contribution(
                        slot, head_root, sub_index
                    )
                contribution = contribution_cache[sub_index]
                if contribution is None:
                    continue
                message = ctx.types.ContributionAndProof(
                    aggregator_index=vi,
                    contribution=contribution,
                    selection_proof=proof,
                )
                signed = ctx.types.SignedContributionAndProof(
                    message=message,
                    signature=self.store.sign_contribution_and_proof(pk, message, head_state),
                )
                if self.api.publish_contribution(signed):
                    summary["contributions"] += 1

        self.last_duty_slot = slot
        for duty, count in summary.items():
            n = int(count is not None) if duty == "proposed" else int(count)
            if n:
                self.duty_totals[duty] = self.duty_totals.get(duty, 0) + n
                VC_DUTIES_TOTAL.labels(duty=duty).inc(n)
        return summary
