"""Per-epoch processing (phase0).

Mirrors lighthouse/consensus/state_processing/src/per_epoch_processing.rs:27
and its base/ submodules: justification & finality, rewards & penalties
(attestation deltas), registry updates, slashings, and the final-update
family (eth1 reset, effective balances, slashings reset, randao reset,
historical roots, participation rotation).
"""

from __future__ import annotations

from ..types import (
    BASE_REWARDS_PER_EPOCH,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    compute_activation_exit_epoch,
)
from ..types.containers import Checkpoint
from .context import TransitionContext
from .helpers import (
    StateTransitionError,
    decrease_balance,
    get_active_validator_indices,
    get_attesting_indices,
    get_base_reward,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_proposer_reward,
    get_randao_mix,
    get_total_active_balance,
    get_total_balance,
    increase_balance,
    initiate_validator_exit,
    is_active_validator,
)


# -- attestation matching ------------------------------------------------------


def get_matching_source_attestations(state, epoch: int, ctx: TransitionContext):
    cur = get_current_epoch(state, ctx.preset)
    prev = get_previous_epoch(state, ctx.preset)
    if epoch == cur:
        return list(state.current_epoch_attestations)
    if epoch == prev:
        return list(state.previous_epoch_attestations)
    raise StateTransitionError("matching attestations: epoch out of range")


def get_matching_target_attestations(state, epoch: int, ctx: TransitionContext):
    root = get_block_root(state, epoch, ctx.preset)
    return [
        a
        for a in get_matching_source_attestations(state, epoch, ctx)
        if bytes(a.data.target.root) == root
    ]


def get_matching_head_attestations(state, epoch: int, ctx: TransitionContext):
    return [
        a
        for a in get_matching_target_attestations(state, epoch, ctx)
        if bytes(a.data.beacon_block_root)
        == get_block_root_at_slot(state, a.data.slot, ctx.preset)
    ]


def get_unslashed_attesting_indices(state, attestations, ctx: TransitionContext) -> set[int]:
    out: set[int] = set()
    for a in attestations:
        out |= get_attesting_indices(state, a.data, a.aggregation_bits, ctx.preset, ctx.spec)
    return {i for i in out if not state.validators[i].slashed}


def get_attesting_balance(state, attestations, ctx: TransitionContext) -> int:
    return get_total_balance(
        state, get_unslashed_attesting_indices(state, attestations, ctx), ctx.spec
    )


# -- justification & finality --------------------------------------------------


def process_justification_and_finality(state, ctx: TransitionContext) -> None:
    preset = ctx.preset
    cur = get_current_epoch(state, preset)
    if cur <= GENESIS_EPOCH + 1:
        return
    prev = get_previous_epoch(state, preset)
    total = get_total_active_balance(state, preset, ctx.spec)
    prev_target = get_attesting_balance(
        state, get_matching_target_attestations(state, prev, ctx), ctx
    )
    cur_target = get_attesting_balance(
        state, get_matching_target_attestations(state, cur, ctx), ctx
    )
    weigh_justification_and_finality(state, ctx, total, prev_target, cur_target)


def weigh_justification_and_finality(
    state, ctx: TransitionContext, total_balance: int, prev_target: int, cur_target: int
) -> None:
    preset = ctx.preset
    cur = get_current_epoch(state, preset)
    prev = get_previous_epoch(state, preset)

    old_prev_justified = state.previous_justified_checkpoint
    old_cur_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[:-1]
    if prev_target * 3 >= total_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=prev, root=get_block_root(state, prev, preset)
        )
        bits[1] = True
    if cur_target * 3 >= total_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=cur, root=get_block_root(state, cur, preset)
        )
        bits[0] = True
    state.justification_bits = bits

    # 2nd/3rd/4th most recent epochs justified -> finalize
    if all(bits[1:4]) and old_prev_justified.epoch + 3 == cur:
        state.finalized_checkpoint = old_prev_justified
    if all(bits[1:3]) and old_prev_justified.epoch + 2 == cur:
        state.finalized_checkpoint = old_prev_justified
    if all(bits[0:3]) and old_cur_justified.epoch + 2 == cur:
        state.finalized_checkpoint = old_cur_justified
    if all(bits[0:2]) and old_cur_justified.epoch + 1 == cur:
        state.finalized_checkpoint = old_cur_justified


# -- rewards & penalties -------------------------------------------------------


def get_finality_delay(state, ctx: TransitionContext) -> int:
    return get_previous_epoch(state, ctx.preset) - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state, ctx: TransitionContext) -> bool:
    return get_finality_delay(state, ctx) > ctx.spec.min_epochs_to_inactivity_penalty


def get_eligible_validator_indices(state, ctx: TransitionContext) -> list[int]:
    prev = get_previous_epoch(state, ctx.preset)
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, prev) or (v.slashed and prev + 1 < v.withdrawable_epoch)
    ]


def _attestation_component_deltas(state, attestations, ctx, rewards, penalties, total_balance):
    unslashed = get_unslashed_attesting_indices(state, attestations, ctx)
    attesting_balance = get_total_balance(state, unslashed, ctx.spec)
    incr = ctx.spec.effective_balance_increment
    leak = is_in_inactivity_leak(state, ctx)
    for index in get_eligible_validator_indices(state, ctx):
        br = get_base_reward(state, index, total_balance, ctx.spec)
        if index in unslashed:
            if leak:
                rewards[index] += br
            else:
                rewards[index] += br * (attesting_balance // incr) // (total_balance // incr)
        else:
            penalties[index] += br


def get_attestation_deltas(state, ctx: TransitionContext) -> tuple[list[int], list[int]]:
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    prev = get_previous_epoch(state, ctx.preset)
    total = get_total_active_balance(state, ctx.preset, ctx.spec)

    source_atts = get_matching_source_attestations(state, prev, ctx)
    target_atts = get_matching_target_attestations(state, prev, ctx)
    head_atts = get_matching_head_attestations(state, prev, ctx)

    for atts in (source_atts, target_atts, head_atts):
        _attestation_component_deltas(state, atts, ctx, rewards, penalties, total)

    # inclusion delay: reward the fastest inclusion, pay the proposer
    source_indices = get_unslashed_attesting_indices(state, source_atts, ctx)
    for index in source_indices:
        candidates = [
            a
            for a in source_atts
            if index
            in get_attesting_indices(state, a.data, a.aggregation_bits, ctx.preset, ctx.spec)
        ]
        attestation = min(candidates, key=lambda a: a.inclusion_delay)
        br = get_base_reward(state, index, total, ctx.spec)
        proposer_reward = br // ctx.spec.proposer_reward_quotient
        rewards[attestation.proposer_index] += proposer_reward
        max_attester_reward = br - proposer_reward
        rewards[index] += max_attester_reward // attestation.inclusion_delay

    # inactivity leak
    if is_in_inactivity_leak(state, ctx):
        target_indices = get_unslashed_attesting_indices(state, target_atts, ctx)
        delay = get_finality_delay(state, ctx)
        for index in get_eligible_validator_indices(state, ctx):
            br = get_base_reward(state, index, total, ctx.spec)
            proposer_reward = br // ctx.spec.proposer_reward_quotient
            penalties[index] += BASE_REWARDS_PER_EPOCH * br - proposer_reward
            if index not in target_indices:
                penalties[index] += (
                    state.validators[index].effective_balance
                    * delay
                    // ctx.spec.inactivity_penalty_quotient
                )
    return rewards, penalties


def process_rewards_and_penalties(state, ctx: TransitionContext) -> None:
    if get_current_epoch(state, ctx.preset) == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(state, ctx)
    for index in range(len(state.validators)):
        increase_balance(state, index, rewards[index])
        decrease_balance(state, index, penalties[index])


# -- registry updates ----------------------------------------------------------


def process_registry_updates(state, ctx: TransitionContext) -> None:
    preset, spec = ctx.preset, ctx.spec
    cur = get_current_epoch(state, preset)
    for index, v in enumerate(state.validators):
        if (
            v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance == spec.max_effective_balance
        ):
            v.activation_eligibility_epoch = cur + 1
        if is_active_validator(v, cur) and v.effective_balance <= spec.ejection_balance:
            initiate_validator_exit(state, index, preset, spec)

    queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    churn = spec.churn_limit(len(get_active_validator_indices(state, cur)))
    for i in queue[:churn]:
        state.validators[i].activation_epoch = compute_activation_exit_epoch(cur, spec)


# -- slashings -----------------------------------------------------------------


def process_slashings(state, ctx: TransitionContext) -> None:
    preset, spec = ctx.preset, ctx.spec
    epoch = get_current_epoch(state, preset)
    total = get_total_active_balance(state, preset, spec)
    adjusted = min(sum(state.slashings) * spec.proportional_slashing_multiplier, total)
    incr = spec.effective_balance_increment
    for index, v in enumerate(state.validators):
        if v.slashed and epoch + preset.epochs_per_slashings_vector // 2 == v.withdrawable_epoch:
            penalty = v.effective_balance // incr * adjusted // total * incr
            decrease_balance(state, index, penalty)


# -- final updates -------------------------------------------------------------


def process_eth1_data_reset(state, ctx: TransitionContext) -> None:
    next_epoch = get_current_epoch(state, ctx.preset) + 1
    if next_epoch % ctx.preset.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, ctx: TransitionContext) -> None:
    spec = ctx.spec
    hysteresis_incr = spec.effective_balance_increment // spec.hysteresis_quotient
    down = hysteresis_incr * spec.hysteresis_downward_multiplier
    up = hysteresis_incr * spec.hysteresis_upward_multiplier
    for index, v in enumerate(state.validators):
        balance = state.balances[index]
        if balance + down < v.effective_balance or v.effective_balance + up < balance:
            v.effective_balance = min(
                balance - balance % spec.effective_balance_increment,
                spec.max_effective_balance,
            )


def process_slashings_reset(state, ctx: TransitionContext) -> None:
    next_epoch = get_current_epoch(state, ctx.preset) + 1
    state.slashings[next_epoch % ctx.preset.epochs_per_slashings_vector] = 0


def process_randao_mixes_reset(state, ctx: TransitionContext) -> None:
    preset = ctx.preset
    cur = get_current_epoch(state, preset)
    next_epoch = cur + 1
    state.randao_mixes[next_epoch % preset.epochs_per_historical_vector] = get_randao_mix(
        state, cur, preset
    )


def process_historical_roots_update(state, ctx: TransitionContext) -> None:
    preset = ctx.preset
    next_epoch = get_current_epoch(state, preset) + 1
    if next_epoch % (preset.slots_per_historical_root // preset.slots_per_epoch) == 0:
        batch = ctx.types.HistoricalBatch(
            block_roots=list(state.block_roots), state_roots=list(state.state_roots)
        )
        state.historical_roots.append(ctx.types.HistoricalBatch.hash_tree_root(batch))


def process_participation_record_updates(state, ctx: TransitionContext) -> None:
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


def process_epoch(state, ctx: TransitionContext) -> None:
    """per_epoch_processing.rs:27 (base fork ordering)."""
    process_justification_and_finality(state, ctx)
    process_rewards_and_penalties(state, ctx)
    process_registry_updates(state, ctx)
    process_slashings(state, ctx)
    process_eth1_data_reset(state, ctx)
    process_effective_balance_updates(state, ctx)
    process_slashings_reset(state, ctx)
    process_randao_mixes_reset(state, ctx)
    process_historical_roots_update(state, ctx)
    process_participation_record_updates(state, ctx)
