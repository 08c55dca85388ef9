"""Altair fork: participation flags, sync committees, and the fork upgrade.

Python rendering of the reference's altair paths:
  - participation-flag accessors and attestation processing
    (lighthouse/consensus/state_processing/src/per_block_processing/
     altair/sync_committee.rs and process_operations' altair branch)
  - epoch processing on participation flags + inactivity scores
    (lighthouse/consensus/state_processing/src/per_epoch_processing/
     altair/*.rs)
  - sync committee computation
    (lighthouse/consensus/types/src/beacon_state.rs
     get_next_sync_committee / compute_sync_committee_indices)
  - the in-place fork upgrade
    (lighthouse/consensus/state_processing/src/upgrade/altair.rs:
     upgrade_to_altair + translate_participation)

The sync-aggregate signature rides the same batched device verifier as
every other signature (signature_sets.sync_aggregate_signature_set).
"""

from __future__ import annotations

from ..types import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    compute_epoch_at_slot,
)
from ..types.containers import Fork
from ..utils.shuffle import compute_shuffled_index
from .context import TransitionContext
from .helpers import (
    StateTransitionError,
    _hash,
    decrease_balance,
    get_active_validator_indices,
    get_attesting_indices,
    get_beacon_proposer_index,
    get_block_root,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_previous_epoch,
    get_seed,
    get_total_active_balance,
    get_total_balance,
    increase_balance,
    integer_squareroot,
)


# -- participation flags -------------------------------------------------------


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def get_unslashed_participating_indices(
    state, flag_index: int, epoch: int, ctx: TransitionContext
) -> set[int]:
    cur = get_current_epoch(state, ctx.preset)
    prev = get_previous_epoch(state, ctx.preset)
    if epoch == cur:
        participation = state.current_epoch_participation
    elif epoch == prev:
        participation = state.previous_epoch_participation
    else:
        raise StateTransitionError("participation epoch out of range")
    active = get_active_validator_indices(state, epoch)
    return {
        i
        for i in active
        if has_flag(participation[i], flag_index) and not state.validators[i].slashed
    }


# -- base rewards (altair restates them per-increment) -------------------------


def get_base_reward_per_increment(state, ctx: TransitionContext) -> int:
    spec = ctx.spec
    return (
        spec.effective_balance_increment
        * spec.base_reward_factor
        // integer_squareroot(get_total_active_balance(state, ctx.preset, spec))
    )


def get_base_reward(state, index: int, ctx: TransitionContext) -> int:
    increments = (
        state.validators[index].effective_balance // ctx.spec.effective_balance_increment
    )
    return increments * get_base_reward_per_increment(state, ctx)


# -- sync committees -----------------------------------------------------------


def get_next_sync_committee_indices(state, ctx: TransitionContext) -> list[int]:
    """Effective-balance-weighted sampling of the next period's committee
    (beacon_state.rs compute_sync_committee_indices)."""
    preset, spec = ctx.preset, ctx.spec
    epoch = get_current_epoch(state, preset) + 1
    active = get_active_validator_indices(state, epoch)
    if not active:
        raise StateTransitionError("no active validators for sync committee")
    seed = get_seed(state, epoch, spec.domain_sync_committee, preset, spec)
    indices: list[int] = []
    i = 0
    while len(indices) < preset.sync_committee_size:
        shuffled = compute_shuffled_index(
            i % len(active), len(active), seed, rounds=preset.shuffle_round_count
        )
        candidate = active[shuffled]
        random_byte = _hash(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        if state.validators[candidate].effective_balance * 255 >= (
            spec.max_effective_balance * random_byte
        ):
            indices.append(candidate)
        i += 1
    return indices


def get_next_sync_committee(state, ctx: TransitionContext):
    indices = get_next_sync_committee_indices(state, ctx)
    pubkey_bytes = [bytes(state.validators[i].pubkey) for i in indices]
    # resolve through the PubkeyCache, not PublicKey.from_bytes directly:
    # sync-committee rotation re-samples the same validators every period,
    # and each direct decompression costs a Python bigint sqrt per key
    resolve = ctx.pubkeys.resolver(state)
    pks = []
    for i in indices:
        pk = resolve(i)
        if pk is None:
            raise StateTransitionError(f"undecodable pubkey for validator {i}")
        pks.append(pk)
    aggregate = ctx.bls.aggregate_public_keys(pks)
    return ctx.types.SyncCommittee(
        pubkeys=pubkey_bytes, aggregate_pubkey=aggregate.to_bytes()
    )


# -- attestation processing (participation-flag form) --------------------------


def get_attestation_participation_flag_indices(
    state, data, inclusion_delay: int, ctx: TransitionContext
) -> list[int]:
    preset, spec = ctx.preset, ctx.spec
    if data.target.epoch == get_current_epoch(state, preset):
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = data.source == justified_checkpoint
    if not is_matching_source:
        raise StateTransitionError("attestation source != justified checkpoint")
    is_matching_target = (
        bytes(data.target.root) == get_block_root(state, data.target.epoch, preset)
    )
    is_matching_head = is_matching_target and (
        bytes(data.beacon_block_root) == get_block_root_at_slot(state, data.slot, preset)
    )

    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(preset.slots_per_epoch):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= preset.slots_per_epoch:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def process_attestation_altair(state, attestation, ctx: TransitionContext, verify: bool) -> None:
    """Altair process_attestation: same admission checks as phase0, then flag
    accrual + proposer micro-reward instead of PendingAttestation append."""
    from . import signature_sets as sigsets
    from .helpers import get_beacon_committee, get_indexed_attestation
    from .per_block import _check_indexed_sorted, _verify_set_now

    data = attestation.data
    preset, spec = ctx.preset, ctx.spec
    cur = get_current_epoch(state, preset)
    prev = get_previous_epoch(state, preset)
    if data.target.epoch not in (prev, cur):
        raise StateTransitionError("attestation target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, preset):
        raise StateTransitionError("attestation target/slot mismatch")
    if not (
        data.slot + spec.min_attestation_inclusion_delay
        <= state.slot
        <= data.slot + preset.slots_per_epoch
    ):
        raise StateTransitionError("attestation outside inclusion window")
    if data.index >= get_committee_count_per_slot(state, data.target.epoch, preset):
        raise StateTransitionError("attestation committee index out of range")

    committee = get_beacon_committee(state, data.slot, data.index, preset, spec)
    if len(attestation.aggregation_bits) != len(committee):
        raise StateTransitionError("aggregation bits length != committee size")

    flag_indices = get_attestation_participation_flag_indices(
        state, data, state.slot - data.slot, ctx
    )

    indexed = get_indexed_attestation(state, attestation, ctx.types, preset, spec)
    _check_indexed_sorted(indexed)
    if verify:
        _verify_set_now(
            sigsets.indexed_attestation_signature_set(
                state, indexed, ctx.bls, ctx.pubkeys.resolver(state), preset, spec
            ),
            ctx,
        )

    if data.target.epoch == cur:
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation

    proposer_reward_numerator = 0
    for index in indexed.attesting_indices:
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in flag_indices and not has_flag(
                epoch_participation[index], flag_index
            ):
                epoch_participation[index] = add_flag(epoch_participation[index], flag_index)
                proposer_reward_numerator += get_base_reward(state, index, ctx) * weight

    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    )
    proposer_reward = proposer_reward_numerator // proposer_reward_denominator
    increase_balance(
        state, get_beacon_proposer_index(state, preset, spec), proposer_reward
    )


# -- sync aggregate processing -------------------------------------------------


def process_sync_aggregate(state, sync_aggregate, ctx: TransitionContext, verify: bool) -> None:
    """altair/sync_committee.rs process_sync_aggregate: verify the committee
    signature over the previous slot's block root, then pay participants and
    the proposer (non-participants are penalized)."""
    from . import signature_sets as sigsets
    from .per_block import _verify_set_now

    preset, spec = ctx.preset, ctx.spec
    if verify:
        s = sigsets.sync_aggregate_signature_set(
            state, sync_aggregate, ctx.bls, ctx.preset, ctx.spec
        )
        if s is not None:
            _verify_set_now(s, ctx)

    total_active_increments = (
        get_total_active_balance(state, preset, spec) // spec.effective_balance_increment
    )
    total_base_rewards = get_base_reward_per_increment(state, ctx) * total_active_increments
    max_participant_rewards = (
        total_base_rewards * SYNC_REWARD_WEIGHT // WEIGHT_DENOMINATOR // preset.slots_per_epoch
    )
    participant_reward = max_participant_rewards // preset.sync_committee_size
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    index_of = _pubkey_index_map(state)
    proposer_index = get_beacon_proposer_index(state, preset, spec)
    committee_indices = [
        index_of[bytes(pk)] for pk in state.current_sync_committee.pubkeys
    ]
    for participant_index, bit in zip(
        committee_indices, sync_aggregate.sync_committee_bits
    ):
        if bit:
            increase_balance(state, participant_index, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, participant_index, participant_reward)


def _pubkey_index_map(state) -> dict[bytes, int]:
    """pubkey bytes -> validator index, cached per state instance and
    extended incrementally as the registry grows (the reference resolves via
    its ValidatorPubkeyCache)."""
    cache = getattr(state, "_pubkey_index_cache", None)
    if cache is None or cache[0] > len(state.validators):
        cache = [0, {}]
        object.__setattr__(state, "_pubkey_index_cache", cache)
    n, mapping = cache
    if n < len(state.validators):
        for i in range(n, len(state.validators)):
            mapping[bytes(state.validators[i].pubkey)] = i
        cache[0] = len(state.validators)
    return mapping


# -- epoch processing ----------------------------------------------------------


def process_justification_and_finality_altair(state, ctx: TransitionContext) -> None:
    from .per_epoch import weigh_justification_and_finality

    preset = ctx.preset
    cur = get_current_epoch(state, preset)
    if cur <= GENESIS_EPOCH + 1:
        return
    prev = get_previous_epoch(state, preset)
    total = get_total_active_balance(state, preset, ctx.spec)
    prev_target = get_total_balance(
        state,
        get_unslashed_participating_indices(state, TIMELY_TARGET_FLAG_INDEX, prev, ctx),
        ctx.spec,
    )
    cur_target = get_total_balance(
        state,
        get_unslashed_participating_indices(state, TIMELY_TARGET_FLAG_INDEX, cur, ctx),
        ctx.spec,
    )
    weigh_justification_and_finality(state, ctx, total, prev_target, cur_target)


def process_inactivity_updates(state, ctx: TransitionContext) -> None:
    """Vectorized (same numpy registry pass as rewards; the scalar spec form
    is what the expressions transcribe: participating scores decay by 1,
    others grow by the bias, and outside a leak everything recovers)."""
    import numpy as np

    from .per_epoch import is_in_inactivity_leak

    if get_current_epoch(state, ctx.preset) == GENESIS_EPOCH:
        return
    spec = ctx.spec
    eff, slashed, active_prev, eligible, participation = _epoch_arrays(state, ctx)
    participating = (
        active_prev & ~slashed & ((participation >> TIMELY_TARGET_FLAG_INDEX) & 1).astype(bool)
    )
    scores = np.fromiter(
        state.inactivity_scores, dtype=np.int64, count=len(state.inactivity_scores)
    )
    new = np.where(
        participating, scores - np.minimum(1, scores), scores + spec.inactivity_score_bias
    )
    if not is_in_inactivity_leak(state, ctx):
        new = new - np.minimum(spec.inactivity_score_recovery_rate, new)
    scores = np.where(eligible, new, scores)
    state.inactivity_scores = [int(s) for s in scores]


def get_flag_index_deltas(
    state, flag_index: int, ctx: TransitionContext
) -> tuple[list[int], list[int]]:
    from .per_epoch import get_eligible_validator_indices, is_in_inactivity_leak

    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    prev = get_previous_epoch(state, ctx.preset)
    unslashed = get_unslashed_participating_indices(state, flag_index, prev, ctx)
    weight = PARTICIPATION_FLAG_WEIGHTS[flag_index]
    incr = ctx.spec.effective_balance_increment
    unslashed_increments = get_total_balance(state, unslashed, ctx.spec) // incr
    active_increments = get_total_active_balance(state, ctx.preset, ctx.spec) // incr
    leak = is_in_inactivity_leak(state, ctx)
    for index in get_eligible_validator_indices(state, ctx):
        base_reward = get_base_reward(state, index, ctx)
        if index in unslashed:
            if not leak:
                reward_numerator = base_reward * weight * unslashed_increments
                rewards[index] += reward_numerator // (active_increments * WEIGHT_DENOMINATOR)
        elif flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties[index] += base_reward * weight // WEIGHT_DENOMINATOR
    return rewards, penalties


def get_inactivity_penalty_deltas(state, ctx: TransitionContext) -> tuple[list[int], list[int]]:
    from .per_epoch import get_eligible_validator_indices

    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    prev = get_previous_epoch(state, ctx.preset)
    participating = get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, prev, ctx
    )
    quotient = ctx.spec.inactivity_score_bias * _inactivity_penalty_quotient(state, ctx)
    for index in get_eligible_validator_indices(state, ctx):
        if index not in participating:
            penalty_numerator = (
                state.validators[index].effective_balance * state.inactivity_scores[index]
            )
            penalties[index] += penalty_numerator // quotient
    return rewards, penalties


def _inactivity_penalty_quotient(state, ctx: TransitionContext) -> int:
    if ctx.types.fork_of(state) == "bellatrix":
        return ctx.spec.inactivity_penalty_quotient_bellatrix
    return ctx.spec.inactivity_penalty_quotient_altair


def _proportional_slashing_multiplier(state, ctx: TransitionContext) -> int:
    if ctx.types.fork_of(state) == "bellatrix":
        return ctx.spec.proportional_slashing_multiplier_bellatrix
    return ctx.spec.proportional_slashing_multiplier_altair


def _epoch_arrays(state, ctx: TransitionContext):
    """The per-validator vectors every altair epoch computation reads —
    gathered ONCE per epoch into numpy int64 (the role rayon-parallel
    per-validator iteration plays for the reference at 300k validators).
    int64 is safe: the largest intermediate, base_reward * weight *
    unslashed_increments, is < 2^60 even at 10^7 validators."""
    import numpy as np

    prev = get_previous_epoch(state, ctx.preset)
    n = len(state.validators)
    eff = np.empty(n, dtype=np.int64)
    slashed = np.empty(n, dtype=bool)
    active_prev = np.empty(n, dtype=bool)
    withdrawable = np.empty(n, dtype=np.float64)  # only compared, never summed
    for i, v in enumerate(state.validators):
        eff[i] = v.effective_balance
        slashed[i] = v.slashed
        active_prev[i] = v.activation_epoch <= prev < v.exit_epoch
        withdrawable[i] = v.withdrawable_epoch
    eligible = active_prev | (slashed & (prev + 1 < withdrawable))
    participation = np.fromiter(
        state.previous_epoch_participation, dtype=np.int64, count=n
    )
    return eff, slashed, active_prev, eligible, participation


def process_rewards_and_penalties_altair(state, ctx: TransitionContext) -> None:
    """Vectorized altair rewards: identical arithmetic to the spec loop
    (get_flag_index_deltas / get_inactivity_penalty_deltas, kept above as
    the differential reference and the rewards-API surface), computed as
    whole-registry numpy expressions."""
    import numpy as np

    from .per_epoch import is_in_inactivity_leak

    if get_current_epoch(state, ctx.preset) == GENESIS_EPOCH:
        return
    spec = ctx.spec
    incr = spec.effective_balance_increment
    eff, slashed, active_prev, eligible, participation = _epoch_arrays(state, ctx)
    per_increment = get_base_reward_per_increment(state, ctx)
    base_reward = (eff // incr) * per_increment
    active_increments = get_total_active_balance(state, ctx.preset, spec) // incr
    leak = is_in_inactivity_leak(state, ctx)

    balances = np.fromiter(state.balances, dtype=np.int64, count=len(state.balances))
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = active_prev & ~slashed & ((participation >> flag_index) & 1).astype(bool)
        # get_total_balance floors at one increment (helpers.get_total_balance)
        unslashed_increments = max(incr, int(eff[participating].sum())) // incr
        rewards = np.zeros_like(balances)
        penalties = np.zeros_like(balances)
        if not leak:
            numer = base_reward * weight * unslashed_increments
            rewards = np.where(
                eligible & participating,
                numer // (active_increments * WEIGHT_DENOMINATOR),
                0,
            )
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = np.where(
                eligible & ~participating, base_reward * weight // WEIGHT_DENOMINATOR, 0
            )
        balances = np.maximum(0, balances + rewards - penalties)

    # inactivity penalties (quadratic leak component)
    target_participating = (
        active_prev & ~slashed & ((participation >> TIMELY_TARGET_FLAG_INDEX) & 1).astype(bool)
    )
    scores = np.fromiter(state.inactivity_scores, dtype=np.int64, count=len(balances))
    quotient = spec.inactivity_score_bias * _inactivity_penalty_quotient(state, ctx)
    inactivity_penalties = np.where(
        eligible & ~target_participating, eff * scores // quotient, 0
    )
    balances = np.maximum(0, balances - inactivity_penalties)
    state.balances = [int(b) for b in balances]


def process_slashings_altair(state, ctx: TransitionContext) -> None:
    preset, spec = ctx.preset, ctx.spec
    epoch = get_current_epoch(state, preset)
    total = get_total_active_balance(state, preset, spec)
    adjusted = min(
        sum(state.slashings) * _proportional_slashing_multiplier(state, ctx), total
    )
    incr = spec.effective_balance_increment
    for index, v in enumerate(state.validators):
        if v.slashed and epoch + preset.epochs_per_slashings_vector // 2 == v.withdrawable_epoch:
            penalty = v.effective_balance // incr * adjusted // total * incr
            decrease_balance(state, index, penalty)


def process_participation_flag_updates(state, ctx: TransitionContext) -> None:
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = [0] * len(state.validators)


def process_sync_committee_updates(state, ctx: TransitionContext) -> None:
    next_epoch = get_current_epoch(state, ctx.preset) + 1
    if next_epoch % ctx.preset.epochs_per_sync_committee_period == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state, ctx)


def process_epoch_altair(state, ctx: TransitionContext) -> None:
    """per_epoch_processing.rs altair ordering (also used by bellatrix —
    fork-sensitive quotients resolve via the state's fork)."""
    from .per_epoch import (
        process_effective_balance_updates,
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_registry_updates,
        process_slashings_reset,
    )

    process_justification_and_finality_altair(state, ctx)
    process_inactivity_updates(state, ctx)
    process_rewards_and_penalties_altair(state, ctx)
    process_registry_updates(state, ctx)
    process_slashings_altair(state, ctx)
    process_eth1_data_reset(state, ctx)
    process_effective_balance_updates(state, ctx)
    process_slashings_reset(state, ctx)
    process_randao_mixes_reset(state, ctx)
    process_historical_roots_update(state, ctx)
    process_participation_flag_updates(state, ctx)
    process_sync_committee_updates(state, ctx)


# -- fork upgrade --------------------------------------------------------------


def translate_participation(state, pending_attestations, ctx: TransitionContext) -> None:
    """upgrade/altair.rs translate_participation: replay the pre-fork pending
    attestations into previous-epoch participation flags."""
    for attestation in pending_attestations:
        data = attestation.data
        flag_indices = get_attestation_participation_flag_indices(
            state, data, attestation.inclusion_delay, ctx
        )
        for index in get_attesting_indices(
            state, data, attestation.aggregation_bits, ctx.preset, ctx.spec
        ):
            for flag_index in flag_indices:
                state.previous_epoch_participation[index] = add_flag(
                    state.previous_epoch_participation[index], flag_index
                )


def upgrade_to_altair(state, ctx: TransitionContext):
    """upgrade/altair.rs upgrade_to_altair, as an IN-PLACE class swap: the
    codebase's transition API mutates states, and a fork upgrade is the one
    operation that changes the state's (container) type — swapping __class__
    keeps every existing reference valid across the boundary. Returns the
    same object."""
    if ctx.types.fork_of(state) != "phase0":
        raise StateTransitionError("upgrade_to_altair: state is not phase0")
    epoch = get_current_epoch(state, ctx.preset)
    pending = list(state.previous_epoch_attestations)

    n = len(state.validators)
    state.__class__ = ctx.types.BeaconStateAltair
    del state.previous_epoch_attestations
    del state.current_epoch_attestations
    state.previous_epoch_participation = [0] * n
    state.current_epoch_participation = [0] * n
    state.inactivity_scores = [0] * n
    state.fork = Fork(
        previous_version=state.fork.current_version,
        current_version=ctx.spec.altair_fork_version,
        epoch=epoch,
    )
    translate_participation(state, pending, ctx)
    # spec assigns get_next_sync_committee(post) to BOTH committees; the two
    # calls are byte-identical at the upgrade epoch, so compute once
    sync_committee = get_next_sync_committee(state, ctx)
    state.current_sync_committee = sync_committee
    state.next_sync_committee = sync_committee
    return state
