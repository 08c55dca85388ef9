"""Per-slot processing and the full state transition entry point.

Mirrors lighthouse/consensus/state_processing/src/per_slot_processing.rs:25
and the spec's state_transition wrapper.
"""

from __future__ import annotations

from ..types.containers import BeaconBlockHeader
from .context import TransitionContext
from .helpers import StateTransitionError
from .per_block import BlockSignatureStrategy, per_block_processing
from .per_epoch import process_epoch


def process_slot(state, ctx: TransitionContext) -> None:
    preset = ctx.preset
    prev_state_root = type(state).hash_tree_root(state)
    state.state_roots[state.slot % preset.slots_per_historical_root] = prev_state_root
    if bytes(state.latest_block_header.state_root) == b"\x00" * 32:
        state.latest_block_header.state_root = prev_state_root
    prev_block_root = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % preset.slots_per_historical_root] = prev_block_root


def process_slots(state, slot: int, ctx: TransitionContext) -> None:
    """Advance to `slot`, running epoch processing at boundaries and applying
    any scheduled fork upgrade when its epoch begins (the reference does this
    in per_slot_processing.rs:25 via upgrade_to_altair et al.; upgrades here
    mutate the state in place, swapping its container class)."""
    if state.slot > slot:
        raise StateTransitionError(f"cannot rewind state from {state.slot} to {slot}")
    while state.slot < slot:
        process_slot(state, ctx)
        if (state.slot + 1) % ctx.preset.slots_per_epoch == 0:
            _process_epoch_for_fork(state, ctx)
        state.slot += 1
        if state.slot % ctx.preset.slots_per_epoch == 0:
            _apply_fork_upgrades(state, ctx)


def _process_epoch_for_fork(state, ctx: TransitionContext) -> None:
    if ctx.types.fork_of(state) == "phase0":
        process_epoch(state, ctx)
    else:
        from .altair import process_epoch_altair

        process_epoch_altair(state, ctx)


def _apply_fork_upgrades(state, ctx: TransitionContext) -> None:
    epoch = state.slot // ctx.preset.slots_per_epoch
    if ctx.types.fork_of(state) == "phase0" and epoch == ctx.spec.altair_fork_epoch:
        from .altair import upgrade_to_altair

        upgrade_to_altair(state, ctx)
    if ctx.types.fork_of(state) == "altair" and epoch == ctx.spec.bellatrix_fork_epoch:
        from .bellatrix import upgrade_to_bellatrix

        upgrade_to_bellatrix(state, ctx)


def per_slot_processing(state, ctx: TransitionContext) -> None:
    """Advance exactly one slot (per_slot_processing.rs:25)."""
    process_slots(state, state.slot + 1, ctx)


def state_transition(
    state,
    signed_block,
    ctx: TransitionContext,
    strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    validate_result: bool = True,
):
    """Full spec state_transition: advance slots, apply the block, check the
    block's claimed state root. Mutates `state` in place and returns it."""
    block = signed_block.message
    process_slots(state, block.slot, ctx)
    if ctx.types.fork_of(state) != ctx.types.fork_of(block.body):
        raise StateTransitionError(
            f"block fork {ctx.types.fork_of(block.body)} != state fork "
            f"{ctx.types.fork_of(state)}"
        )
    per_block_processing(state, signed_block, ctx, strategy=strategy)
    if validate_result:
        got = type(state).hash_tree_root(state)
        if got != bytes(block.state_root):
            raise StateTransitionError("block state root mismatch")
    return state
