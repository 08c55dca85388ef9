"""BeaconState accessors and mutators (phase0).

The Python rendering of the spec helpers the reference implements across
lighthouse/consensus/state_processing/src/common/ and
lighthouse/consensus/types/src/beacon_state.rs (committee caches,
proposer seeds, balances). Committee computation reuses the vectorized
swap-or-not shuffle (utils/shuffle.py).

A per-state-instance epoch committee cache mirrors the reference's
`CommitteeCache` (beacon_state.rs:295-313): committees for an epoch are
computed once (one vectorized whole-list shuffle) and reused across every
attestation touching that epoch.
"""

from __future__ import annotations

import hashlib

from ..types import (
    BASE_REWARDS_PER_EPOCH,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    ChainSpec,
    Preset,
    compute_activation_exit_epoch,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
)
from ..utils.shuffle import compute_shuffled_index, shuffle_list


class StateTransitionError(Exception):
    """Invalid block / invalid state transition."""


class ExecutionEngineError(Exception):
    """Execution-engine transport failure — NOT consensus invalidity.

    Mirrors the reference's ExecutionLayerError vs InvalidBlock split
    (beacon_chain/src/errors.rs): importers catch this to retry or queue
    optimistically instead of marking the block invalid.
    """


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


integer_squareroot = _isqrt


# -- epochs & activation -------------------------------------------------------


def get_current_epoch(state, preset: Preset) -> int:
    return compute_epoch_at_slot(state.slot, preset)


def get_previous_epoch(state, preset: Preset) -> int:
    cur = get_current_epoch(state, preset)
    return GENESIS_EPOCH if cur == GENESIS_EPOCH else cur - 1


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and v.activation_epoch <= epoch < v.withdrawable_epoch


def get_active_validator_indices(state, epoch: int) -> list[int]:
    return [i for i, v in enumerate(state.validators) if is_active_validator(v, epoch)]


# -- randomness ----------------------------------------------------------------


def get_randao_mix(state, epoch: int, preset: Preset) -> bytes:
    return state.randao_mixes[epoch % preset.epochs_per_historical_vector]


def get_seed(state, epoch: int, domain_type: bytes, preset: Preset, spec: ChainSpec) -> bytes:
    mix = get_randao_mix(
        state,
        epoch + preset.epochs_per_historical_vector - spec.min_seed_lookahead - 1,
        preset,
    )
    return _hash(domain_type + epoch.to_bytes(8, "little") + mix)


# -- block roots ---------------------------------------------------------------


def get_block_root_at_slot(state, slot: int, preset: Preset) -> bytes:
    if not slot < state.slot <= slot + preset.slots_per_historical_root:
        raise StateTransitionError(f"block root for slot {slot} not available at {state.slot}")
    return state.block_roots[slot % preset.slots_per_historical_root]


def get_block_root(state, epoch: int, preset: Preset) -> bytes:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch, preset), preset)


# -- committees ----------------------------------------------------------------


def get_committee_count_per_slot(state, epoch: int, preset: Preset) -> int:
    active = len(get_active_validator_indices(state, epoch))
    return max(
        1,
        min(
            preset.max_committees_per_slot,
            active // preset.slots_per_epoch // preset.target_committee_size,
        ),
    )


class _EpochCommittees:
    """All committees of one epoch from ONE vectorized whole-list shuffle —
    the role of the reference's CommitteeCache (beacon_state.rs:295)."""

    def __init__(self, state, epoch: int, preset: Preset, spec: ChainSpec):
        self.epoch = epoch
        self.active = get_active_validator_indices(state, epoch)
        seed = get_seed(state, epoch, spec.domain_beacon_attester, preset, spec)
        shuffled = (
            list(shuffle_list(self.active, seed, rounds=preset.shuffle_round_count))
            if self.active
            else []
        )
        self.shuffled = [int(x) for x in shuffled]
        self.committees_per_slot = get_committee_count_per_slot(state, epoch, preset)
        self.slots_per_epoch = preset.slots_per_epoch

    def committee(self, slot: int, index: int) -> list[int]:
        count = self.committees_per_slot * self.slots_per_epoch
        idx = (slot % self.slots_per_epoch) * self.committees_per_slot + index
        n = len(self.shuffled)
        start = n * idx // count
        end = n * (idx + 1) // count
        return self.shuffled[start:end]


def _committee_cache(state) -> dict:
    cache = getattr(state, "_committee_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(state, "_committee_cache", cache)
    return cache


def get_epoch_committees(state, epoch: int, preset: Preset, spec: ChainSpec) -> _EpochCommittees:
    cache = _committee_cache(state)
    key = (epoch, len(state.validators))
    got = cache.get(key)
    if got is None:
        got = _EpochCommittees(state, epoch, preset, spec)
        cache[key] = got
    return got


def get_beacon_committee(state, slot: int, index: int, preset: Preset, spec: ChainSpec) -> list[int]:
    epoch = compute_epoch_at_slot(slot, preset)
    return get_epoch_committees(state, epoch, preset, spec).committee(slot, index)


def compute_proposer_index(state, indices: list[int], seed: bytes, preset: Preset, spec: ChainSpec) -> int:
    if not indices:
        raise StateTransitionError("no active validators")
    max_eb = spec.max_effective_balance
    total = len(indices)
    i = 0
    while True:
        candidate = indices[
            compute_shuffled_index(i % total, total, seed, rounds=preset.shuffle_round_count)
        ]
        random_byte = _hash(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        if state.validators[candidate].effective_balance * 255 >= max_eb * random_byte:
            return candidate
        i += 1


def get_beacon_proposer_index(state, preset: Preset, spec: ChainSpec) -> int:
    epoch = get_current_epoch(state, preset)
    seed = _hash(
        get_seed(state, epoch, spec.domain_beacon_proposer, preset, spec)
        + state.slot.to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed, preset, spec)


# -- balances ------------------------------------------------------------------


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)


def get_total_balance(state, indices, spec: ChainSpec) -> int:
    return max(
        spec.effective_balance_increment,
        sum(state.validators[i].effective_balance for i in indices),
    )


def get_total_active_balance(state, preset: Preset, spec: ChainSpec) -> int:
    return get_total_balance(
        state, get_active_validator_indices(state, get_current_epoch(state, preset)), spec
    )


def get_base_reward(state, index: int, total_balance: int, spec: ChainSpec) -> int:
    eb = state.validators[index].effective_balance
    return eb * spec.base_reward_factor // _isqrt(total_balance) // BASE_REWARDS_PER_EPOCH


def get_proposer_reward(state, attesting_index: int, total_balance: int, spec: ChainSpec) -> int:
    return get_base_reward(state, attesting_index, total_balance, spec) // spec.proposer_reward_quotient


# -- exits & slashing ----------------------------------------------------------


def initiate_validator_exit(state, index: int, preset: Preset, spec: ChainSpec) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH]
    cur = get_current_epoch(state, preset)
    exit_queue_epoch = max(exit_epochs + [compute_activation_exit_epoch(cur, spec)])
    exit_queue_churn = sum(1 for w in state.validators if w.exit_epoch == exit_queue_epoch)
    if exit_queue_churn >= spec.churn_limit(len(get_active_validator_indices(state, cur))):
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = exit_queue_epoch + spec.min_validator_withdrawability_delay


def slash_validator(
    state, slashed_index: int, preset: Preset, spec: ChainSpec, whistleblower_index: int | None = None
) -> None:
    epoch = get_current_epoch(state, preset)
    initiate_validator_exit(state, slashed_index, preset, spec)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(v.withdrawable_epoch, epoch + preset.epochs_per_slashings_vector)
    state.slashings[epoch % preset.epochs_per_slashings_vector] += v.effective_balance
    decrease_balance(state, slashed_index, v.effective_balance // spec.min_slashing_penalty_quotient)

    proposer_index = get_beacon_proposer_index(state, preset, spec)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = v.effective_balance // spec.whistleblower_reward_quotient
    proposer_reward = whistleblower_reward // spec.proposer_reward_quotient
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)


# -- attestations --------------------------------------------------------------


def get_attesting_indices(state, data, bits, preset: Preset, spec: ChainSpec) -> set[int]:
    committee = get_beacon_committee(state, data.slot, data.index, preset, spec)
    if len(bits) != len(committee):
        raise StateTransitionError("aggregation bits length != committee size")
    return {idx for idx, bit in zip(committee, bits) if bit}


def get_indexed_attestation(state, attestation, types, preset: Preset, spec: ChainSpec):
    indices = get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits, preset, spec
    )
    return types.IndexedAttestation(
        attesting_indices=sorted(indices),
        data=attestation.data,
        signature=attestation.signature,
    )


def is_slashable_attestation_data(d1, d2) -> bool:
    ad = type(d1)
    double = ad.hash_tree_root(d1) != ad.hash_tree_root(d2) and d1.target.epoch == d2.target.epoch
    surround = d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    return double or surround


TARGET_AGGREGATORS_PER_COMMITTEE = 16


def is_aggregator(committee_length: int, selection_proof: bytes) -> bool:
    """Spec is_aggregator: hash of the selection proof picks ~16 aggregators
    per committee (attestation_service.rs:125-230's slot+2/3 duty)."""
    modulo = max(1, committee_length // TARGET_AGGREGATORS_PER_COMMITTEE)
    digest = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(digest[:8], "little") % modulo == 0
