"""Bellatrix (merge) fork: execution payload processing + the fork upgrade.

Python rendering of:
  - lighthouse/consensus/state_processing/src/per_block_processing.rs
    process_execution_payload / is_execution_enabled / is_merge_transition_*
  - lighthouse/consensus/state_processing/src/upgrade/merge.rs
    upgrade_to_bellatrix

Payload validity against an execution engine is delegated to the
`ExecutionEngine` protocol (the state transition only checks consensus-side
invariants); the in-process default accepts every payload — the role of the
reference's optimistic-sync PayloadVerificationStatus plus its mock EL
(lighthouse/beacon_node/execution_layer/src/test_utils/).
"""

from __future__ import annotations

from ..types.containers import Fork
from .context import TransitionContext
from .helpers import (
    ExecutionEngineError,
    StateTransitionError,
    get_current_epoch,
    get_randao_mix,
)


class OptimisticEngine:
    """Accepts every payload (consensus checks still run)."""

    def notify_new_payload(self, payload) -> bool:
        return True


def is_merge_transition_complete(state) -> bool:
    """spec: latest_execution_payload_header != ExecutionPayloadHeader()."""
    return state.latest_execution_payload_header != type(
        state.latest_execution_payload_header
    )()


def is_merge_transition_block(state, body) -> bool:
    return not is_merge_transition_complete(state) and (
        body.execution_payload != type(body.execution_payload)()
    )


def is_execution_enabled(state, body, ctx: TransitionContext) -> bool:
    return is_merge_transition_block(state, body) or is_merge_transition_complete(state)


def compute_timestamp_at_slot(state, slot: int, ctx: TransitionContext) -> int:
    return state.genesis_time + slot * ctx.spec.seconds_per_slot


def process_execution_payload(state, payload, ctx: TransitionContext) -> None:
    """per_block_processing.rs process_execution_payload: consensus-side
    invariants, then the engine's verdict, then fold the payload header into
    the state."""
    t = ctx.types
    if is_merge_transition_complete(state):
        if bytes(payload.parent_hash) != bytes(
            state.latest_execution_payload_header.block_hash
        ):
            raise StateTransitionError("payload parent hash mismatch")
    if bytes(payload.prev_randao) != bytes(
        get_randao_mix(state, get_current_epoch(state, ctx.preset), ctx.preset)
    ):
        raise StateTransitionError("payload prev_randao mismatch")
    if payload.timestamp != compute_timestamp_at_slot(state, state.slot, ctx):
        raise StateTransitionError("payload timestamp mismatch")

    engine = getattr(ctx, "execution_engine", None) or OptimisticEngine()
    try:
        accepted = engine.notify_new_payload(payload)
    except Exception as e:  # noqa: BLE001 — engine transport errors
        # an unreachable EL is a transport failure, not consensus
        # invalidity: raise the distinct type so import paths can
        # retry/queue instead of treating the block as invalid
        raise ExecutionEngineError(f"execution engine unavailable: {e}") from e
    if not accepted:
        raise StateTransitionError("execution engine rejected payload")

    txs_field = dict(t.ExecutionPayload.fields)["transactions"]
    state.latest_execution_payload_header = t.ExecutionPayloadHeader(
        parent_hash=payload.parent_hash,
        fee_recipient=payload.fee_recipient,
        state_root=payload.state_root,
        receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom,
        prev_randao=payload.prev_randao,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=txs_field.hash_tree_root(payload.transactions),
    )


def block_has_payload(block) -> bool:
    """True when the block body carries a real (non-default) execution
    payload — a real payload always commits to a nonzero EL block hash
    (is_merge_transition_block's emptiness test, shared so importers and
    fork choice agree on one definition)."""
    payload = getattr(block.body, "execution_payload", None)
    return payload is not None and bytes(payload.block_hash) != b"\x00" * 32


def upgrade_to_bellatrix(state, ctx: TransitionContext):
    """upgrade/merge.rs upgrade_to_bellatrix: in-place class swap (see
    altair.upgrade_to_altair) + a zeroed execution payload header."""
    if ctx.types.fork_of(state) != "altair":
        raise StateTransitionError("upgrade_to_bellatrix: state is not altair")
    epoch = get_current_epoch(state, ctx.preset)
    state.__class__ = ctx.types.BeaconStateBellatrix
    state.fork = Fork(
        previous_version=state.fork.current_version,
        current_version=ctx.spec.bellatrix_fork_version,
        epoch=epoch,
    )
    state.latest_execution_payload_header = ctx.types.ExecutionPayloadHeader()
    return state
