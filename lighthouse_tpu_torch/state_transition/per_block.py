"""Per-block processing (phase0) with pluggable signature strategies.

Mirrors lighthouse/consensus/state_processing/src/per_block_processing.rs:
  - BlockSignatureStrategy {NoVerification, VerifyIndividual, VerifyRandao,
    VerifyBulk} (per_block_processing.rs:44-53)
  - process_block_header / process_randao / process_eth1_data /
    process_operations (per_block_processing.rs:90-170 and submodules)
  - BlockSignatureVerifier: accumulate EVERY signature in the block into one
    list and dispatch ONE batched verification
    (block_signature_verifier.rs:66,120-160) — on the torch backend that is
    a single verify on the card over the whole block, the entire point of
    this framework.

Operation sub-processing raises StateTransitionError on any spec assertion
failure; callers treat the state as poisoned (the reference consumes the
state the same way).
"""

from __future__ import annotations

import enum
import hashlib

from ..types import FAR_FUTURE_EPOCH, compute_epoch_at_slot
from ..types.containers import BeaconBlockHeader, Validator
from .context import TransitionContext
from .helpers import (
    StateTransitionError,
    decrease_balance,
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    get_current_epoch,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    increase_balance,
    initiate_validator_exit,
    is_active_validator,
    is_slashable_attestation_data,
    is_slashable_validator,
    slash_validator,
)
from . import signature_sets as sigsets


class BlockSignatureStrategy(enum.Enum):
    """per_block_processing.rs:44-53."""

    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_RANDAO = "verify_randao"
    VERIFY_BULK = "verify_bulk"


class BlockSignatureVerifier:
    """Accumulates signature sets, verifies them in ONE batch
    (block_signature_verifier.rs:120-160,333-361)."""

    def __init__(self, state, ctx: TransitionContext):
        self.state = state
        self.ctx = ctx
        self.sets = []
        self._pubkey = ctx.pubkeys.resolver(state)

    # -- include_* (block_signature_verifier.rs:147-260) ----------------------

    def include_block_proposal(self, signed_block, proposer_index: int | None = None) -> None:
        if proposer_index is None:
            proposer_index = signed_block.message.proposer_index
        self.sets.append(
            sigsets.block_proposal_signature_set(
                self.state, signed_block, proposer_index, self.ctx.bls, self._pubkey,
                self.ctx.preset, self.ctx.spec,
            )
        )

    def include_randao_reveal(self, block) -> None:
        self.sets.append(
            sigsets.randao_signature_set(
                self.state, block.body.randao_reveal, block.proposer_index,
                self.ctx.bls, self._pubkey, self.ctx.preset, self.ctx.spec,
            )
        )

    def include_proposer_slashings(self, block) -> None:
        for ps in block.body.proposer_slashings:
            self.sets.extend(
                sigsets.proposer_slashing_signature_sets(
                    self.state, ps, self.ctx.bls, self._pubkey, self.ctx.preset, self.ctx.spec
                )
            )

    def include_attester_slashings(self, block) -> None:
        for s in block.body.attester_slashings:
            self.sets.extend(
                sigsets.attester_slashing_signature_sets(
                    self.state, s, self.ctx.bls, self._pubkey, self.ctx.preset, self.ctx.spec
                )
            )

    def include_attestations(self, block) -> None:
        for att in block.body.attestations:
            indexed = get_indexed_attestation(
                self.state, att, self.ctx.types, self.ctx.preset, self.ctx.spec
            )
            _check_indexed_sorted(indexed)
            self.sets.append(
                sigsets.indexed_attestation_signature_set(
                    self.state, indexed, self.ctx.bls, self._pubkey, self.ctx.preset, self.ctx.spec
                )
            )

    def include_exits(self, block) -> None:
        for ex in block.body.voluntary_exits:
            self.sets.append(
                sigsets.exit_signature_set(
                    self.state, ex, self.ctx.bls, self._pubkey, self.ctx.preset, self.ctx.spec
                )
            )

    def include_sync_aggregate(self, block) -> None:
        """block_signature_verifier.rs include_sync_aggregate (altair+)."""
        if not hasattr(block.body, "sync_aggregate"):
            return
        s = sigsets.sync_aggregate_signature_set(
            self.state, block.body.sync_aggregate, self.ctx.bls, self.ctx.preset, self.ctx.spec
        )
        if s is not None:
            self.sets.append(s)

    def include_all_signatures(self, signed_block) -> None:
        """block_signature_verifier.rs:120 include_all_signatures: proposal +
        everything else. Deposits are deliberately NOT included: deposit
        signatures are verified individually during processing (they may
        legitimately be invalid and are then skipped, per spec)."""
        self.include_block_proposal(signed_block)
        self.include_all_signatures_except_proposal(signed_block)

    def include_all_signatures_except_proposal(self, signed_block) -> None:
        block = signed_block.message
        self.include_randao_reveal(block)
        self.include_proposer_slashings(block)
        self.include_attester_slashings(block)
        self.include_attestations(block)
        self.include_exits(block)
        self.include_sync_aggregate(block)

    def verify(self) -> None:
        """ONE backend batch call (block_signature_verifier.rs:333-361; torch
        backend: one verify on the card)."""
        if not self.sets:
            return
        if not self.ctx.bls.verify_signature_sets(self.sets):
            raise StateTransitionError("bulk signature verification failed")


def _check_indexed_sorted(indexed) -> None:
    idx = list(indexed.attesting_indices)
    if not idx:
        raise StateTransitionError("indexed attestation has no attesting indices")
    if idx != sorted(set(idx)):
        raise StateTransitionError("attesting indices not sorted/unique")


def _verify_set_now(s, ctx: TransitionContext) -> None:
    if not ctx.bls.verify_signature_sets([s]):
        raise StateTransitionError("signature verification failed")


# -- block component processing ------------------------------------------------


def process_block_header(state, block, ctx: TransitionContext) -> None:
    if block.slot != state.slot:
        raise StateTransitionError("block slot != state slot")
    if block.slot <= state.latest_block_header.slot:
        raise StateTransitionError("block not newer than latest header")
    expected_proposer = get_beacon_proposer_index(state, ctx.preset, ctx.spec)
    if block.proposer_index != expected_proposer:
        raise StateTransitionError("wrong proposer index")
    parent_root = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    if bytes(block.parent_root) != parent_root:
        raise StateTransitionError("parent root mismatch")
    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,  # filled by the next process_slot
        body_root=type(block.body).hash_tree_root(block.body),
    )
    proposer = state.validators[block.proposer_index]
    if proposer.slashed:
        raise StateTransitionError("proposer is slashed")


def process_randao(state, body, ctx: TransitionContext, verify: bool) -> None:
    epoch = get_current_epoch(state, ctx.preset)
    if verify:
        proposer_index = get_beacon_proposer_index(state, ctx.preset, ctx.spec)
        s = sigsets.randao_signature_set(
            state, body.randao_reveal, proposer_index, ctx.bls,
            ctx.pubkeys.resolver(state), ctx.preset, ctx.spec,
        )
        _verify_set_now(s, ctx)
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(state, epoch, ctx.preset),
            hashlib.sha256(bytes(body.randao_reveal)).digest(),
        )
    )
    state.randao_mixes[epoch % ctx.preset.epochs_per_historical_vector] = mix


def process_eth1_data(state, body, ctx: TransitionContext) -> None:
    state.eth1_data_votes.append(body.eth1_data)
    votes = [v for v in state.eth1_data_votes if v == body.eth1_data]
    if len(votes) * 2 > ctx.preset.slots_per_eth1_voting_period:
        state.eth1_data = body.eth1_data


def process_proposer_slashing(state, slashing, ctx: TransitionContext, verify: bool) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    if h1.slot != h2.slot:
        raise StateTransitionError("proposer slashing: different slots")
    if h1.proposer_index != h2.proposer_index:
        raise StateTransitionError("proposer slashing: different proposers")
    if h1 == h2:
        raise StateTransitionError("proposer slashing: identical headers")
    if not 0 <= h1.proposer_index < len(state.validators):
        raise StateTransitionError("proposer slashing: unknown validator")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(proposer, get_current_epoch(state, ctx.preset)):
        raise StateTransitionError("proposer slashing: not slashable")
    if verify:
        for s in sigsets.proposer_slashing_signature_sets(
            state, slashing, ctx.bls, ctx.pubkeys.resolver(state), ctx.preset, ctx.spec
        ):
            _verify_set_now(s, ctx)
    slash_validator(state, h1.proposer_index, ctx.preset, ctx.spec)


def process_attester_slashing(state, slashing, ctx: TransitionContext, verify: bool) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not is_slashable_attestation_data(a1.data, a2.data):
        raise StateTransitionError("attestation data not slashable")
    for a in (a1, a2):
        _check_indexed_sorted(a)
        if max(a.attesting_indices, default=0) >= len(state.validators):
            raise StateTransitionError("attester slashing: unknown validator")
        if verify:
            _verify_set_now(
                sigsets.indexed_attestation_signature_set(
                    state, a, ctx.bls, ctx.pubkeys.resolver(state), ctx.preset, ctx.spec
                ),
                ctx,
            )
    slashed_any = False
    cur = get_current_epoch(state, ctx.preset)
    for index in sorted(set(a1.attesting_indices) & set(a2.attesting_indices)):
        if is_slashable_validator(state.validators[index], cur):
            slash_validator(state, index, ctx.preset, ctx.spec)
            slashed_any = True
    if not slashed_any:
        raise StateTransitionError("attester slashing slashed nobody")


def process_attestation(state, attestation, ctx: TransitionContext, verify: bool) -> None:
    data = attestation.data
    preset, spec = ctx.preset, ctx.spec
    cur = get_current_epoch(state, preset)
    prev = get_previous_epoch(state, preset)
    if data.target.epoch not in (prev, cur):
        raise StateTransitionError("attestation target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, preset):
        raise StateTransitionError("attestation target/slot mismatch")
    if not data.slot + spec.min_attestation_inclusion_delay <= state.slot <= data.slot + preset.slots_per_epoch:
        raise StateTransitionError("attestation outside inclusion window")
    if data.index >= get_committee_count_per_slot(state, data.target.epoch, preset):
        raise StateTransitionError("attestation committee index out of range")

    committee = get_beacon_committee(state, data.slot, data.index, preset, spec)
    if len(attestation.aggregation_bits) != len(committee):
        raise StateTransitionError("aggregation bits length != committee size")

    pending = ctx.types.PendingAttestation(
        aggregation_bits=list(attestation.aggregation_bits),
        data=data,
        inclusion_delay=state.slot - data.slot,
        proposer_index=get_beacon_proposer_index(state, preset, spec),
    )
    if data.target.epoch == cur:
        if data.source != state.current_justified_checkpoint:
            raise StateTransitionError("attestation source != current justified")
        state.current_epoch_attestations.append(pending)
    else:
        if data.source != state.previous_justified_checkpoint:
            raise StateTransitionError("attestation source != previous justified")
        state.previous_epoch_attestations.append(pending)

    indexed = get_indexed_attestation(state, attestation, ctx.types, preset, spec)
    _check_indexed_sorted(indexed)
    if verify:
        _verify_set_now(
            sigsets.indexed_attestation_signature_set(
                state, indexed, ctx.bls, ctx.pubkeys.resolver(state), preset, spec
            ),
            ctx,
        )


def get_validator_from_deposit(deposit_data, spec) -> Validator:
    amount = deposit_data.amount
    effective = min(
        amount - amount % spec.effective_balance_increment, spec.max_effective_balance
    )
    return Validator(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        effective_balance=effective,
        slashed=False,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )


def _verify_merkle_branch(leaf: bytes, branch, depth: int, index: int, root: bytes) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hashlib.sha256(bytes(branch[i]) + value).digest()
        else:
            value = hashlib.sha256(value + bytes(branch[i])).digest()
    return value == bytes(root)


def process_deposit(state, deposit, ctx: TransitionContext) -> None:
    from ..types import DEPOSIT_CONTRACT_TREE_DEPTH
    from ..types.containers import DepositData

    leaf = DepositData.hash_tree_root(deposit.data)
    if not _verify_merkle_branch(
        leaf,
        deposit.proof,
        DEPOSIT_CONTRACT_TREE_DEPTH + 1,
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise StateTransitionError("bad deposit merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(state, deposit.data, ctx)


def apply_deposit(state, deposit_data, ctx: TransitionContext) -> None:
    """Deposit signatures verify individually and failures are SKIPPED, not
    fatal (spec; the reference routes these around the bulk verifier too)."""
    pubkeys = [bytes(v.pubkey) for v in state.validators]
    pk = bytes(deposit_data.pubkey)
    if pk not in pubkeys:
        try:
            s = sigsets.deposit_signature_set(deposit_data, ctx.bls, ctx.spec)
        except StateTransitionError:
            return  # undecodable pubkey/signature: skip the deposit
        if not ctx.bls.verify_signature_sets([s]):
            return
        state.validators.append(get_validator_from_deposit(deposit_data, ctx.spec))
        state.balances.append(deposit_data.amount)
        if ctx.types.fork_of(state) != "phase0":
            state.previous_epoch_participation.append(0)
            state.current_epoch_participation.append(0)
            state.inactivity_scores.append(0)
    else:
        increase_balance(state, pubkeys.index(pk), deposit_data.amount)


def process_voluntary_exit(state, signed_exit, ctx: TransitionContext, verify: bool) -> None:
    exit_msg = signed_exit.message
    cur = get_current_epoch(state, ctx.preset)
    if not 0 <= exit_msg.validator_index < len(state.validators):
        raise StateTransitionError("exit: unknown validator")
    v = state.validators[exit_msg.validator_index]
    if not is_active_validator(v, cur):
        raise StateTransitionError("exit: validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise StateTransitionError("exit: already exiting")
    if cur < exit_msg.epoch:
        raise StateTransitionError("exit: not yet valid")
    if cur < v.activation_epoch + ctx.spec.shard_committee_period:
        raise StateTransitionError("exit: validator too young")
    if verify:
        _verify_set_now(
            sigsets.exit_signature_set(
                state, signed_exit, ctx.bls, ctx.pubkeys.resolver(state), ctx.preset, ctx.spec
            ),
            ctx,
        )
    initiate_validator_exit(state, exit_msg.validator_index, ctx.preset, ctx.spec)


def process_operations(state, body, ctx: TransitionContext, verify: bool) -> None:
    expected_deposits = min(
        ctx.preset.max_deposits,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    if len(body.deposits) != expected_deposits:
        raise StateTransitionError(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )
    if ctx.types.fork_of(state) == "phase0":
        attestation_fn = process_attestation
    else:
        from .altair import process_attestation_altair as attestation_fn
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, ctx, verify)
    for als in body.attester_slashings:
        process_attester_slashing(state, als, ctx, verify)
    for att in body.attestations:
        attestation_fn(state, att, ctx, verify)
    for dep in body.deposits:
        process_deposit(state, dep, ctx)
    for ex in body.voluntary_exits:
        process_voluntary_exit(state, ex, ctx, verify)


def per_block_processing(
    state,
    signed_block,
    ctx: TransitionContext,
    strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
) -> None:
    """per_block_processing.rs:90-170: header, (bulk sigs), randao, eth1,
    operations."""
    block = signed_block.message

    verifier = None
    if strategy == BlockSignatureStrategy.VERIFY_BULK:
        # Accumulate EVERYTHING (incl. proposal) and fire one batch.
        verifier = BlockSignatureVerifier(state, ctx)
        verifier.include_all_signatures(signed_block)
        verifier.verify()
    elif strategy == BlockSignatureStrategy.VERIFY_INDIVIDUAL:
        s = sigsets.block_proposal_signature_set(
            state, signed_block, block.proposer_index, ctx.bls,
            ctx.pubkeys.resolver(state), ctx.preset, ctx.spec,
        )
        _verify_set_now(s, ctx)

    verify_each = strategy == BlockSignatureStrategy.VERIFY_INDIVIDUAL
    verify_randao = verify_each or strategy == BlockSignatureStrategy.VERIFY_RANDAO

    process_block_header(state, block, ctx)
    if ctx.types.fork_of(state) == "bellatrix":
        from .bellatrix import is_execution_enabled, process_execution_payload

        if is_execution_enabled(state, block.body, ctx):
            process_execution_payload(state, block.body.execution_payload, ctx)
    process_randao(state, block.body, ctx, verify=verify_randao)
    process_eth1_data(state, block.body, ctx)
    process_operations(state, block.body, ctx, verify=verify_each)
    if hasattr(block.body, "sync_aggregate"):
        from .altair import process_sync_aggregate

        # in VERIFY_BULK mode the aggregate's signature was already part of
        # the one batched device call above
        process_sync_aggregate(state, block.body.sync_aggregate, ctx, verify=verify_each)
