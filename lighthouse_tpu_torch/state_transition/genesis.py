"""Genesis state construction.

Two paths, mirroring lighthouse/beacon_node/genesis/src/:
  - `interop_genesis_state` (interop.rs): validators created directly from
    interop secret keys, all active at genesis — the harness/test path.
  - `initialize_beacon_state_from_eth1` + `is_valid_genesis_state`
    (eth1_genesis_service.rs's spec core): the real path — replay deposit
    logs from the deposit contract, activate validators at max effective
    balance, trigger at MIN_GENESIS_ACTIVE_VALIDATOR_COUNT/TIME.
"""

from __future__ import annotations

import hashlib

from ..types import FAR_FUTURE_EPOCH, GENESIS_EPOCH, ChainSpec, Preset
from ..types.containers import (
    BeaconBlockHeader,
    Eth1Data,
    Fork,
    Validator,
)
from .context import TransitionContext

BLS_WITHDRAWAL_PREFIX = b"\x00"


def interop_validator(pubkey_bytes: bytes, spec: ChainSpec) -> Validator:
    wc = BLS_WITHDRAWAL_PREFIX + hashlib.sha256(pubkey_bytes).digest()[1:]
    return Validator(
        pubkey=pubkey_bytes,
        withdrawal_credentials=wc,
        effective_balance=spec.max_effective_balance,
        slashed=False,
        activation_eligibility_epoch=GENESIS_EPOCH,
        activation_epoch=GENESIS_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )


def interop_genesis_state(n_validators: int, genesis_time: int, ctx: TransitionContext):
    """Build a fully-active genesis BeaconState for n interop validators."""
    t, preset, spec = ctx.types, ctx.preset, ctx.spec
    eth1_block_hash = b"\x42" * 32

    validators = []
    for i in range(n_validators):
        _, pk = ctx.bls.interop_keypair(i)
        validators.append(interop_validator(pk.to_bytes(), spec))

    state = _empty_genesis_scaffold(
        ctx,
        genesis_time,
        Eth1Data(
            deposit_root=b"\x00" * 32,
            deposit_count=n_validators,
            block_hash=eth1_block_hash,
        ),
    )
    state.eth1_deposit_index = n_validators
    state.validators = validators
    state.balances = [spec.max_effective_balance] * n_validators

    # genesis_validators_root commits to the registry (spec
    # initialize_beacon_state_from_eth1 tail).
    state.genesis_validators_root = _validators_root(t, state)
    return _upgrade_genesis_to_scheduled_fork(state, ctx)


def _upgrade_genesis_to_scheduled_fork(state, ctx: TransitionContext):
    """A network whose fork schedule starts a later fork at epoch 0 boots
    directly into that fork (the reference builds genesis per the schedule,
    beacon_chain/src/builder.rs genesis handling): apply the upgrades the
    schedule owes at the genesis epoch."""
    if ctx.spec.altair_fork_epoch == GENESIS_EPOCH:
        from .altair import upgrade_to_altair

        upgrade_to_altair(state, ctx)
        # genesis fork has no "previous": both versions are altair's
        state.fork.previous_version = ctx.spec.altair_fork_version
    if ctx.spec.bellatrix_fork_epoch == GENESIS_EPOCH:
        from .bellatrix import upgrade_to_bellatrix

        upgrade_to_bellatrix(state, ctx)
        # merged-at-genesis: same no-previous-fork rule as altair above
        state.fork.previous_version = ctx.spec.bellatrix_fork_version
    return state


def _validators_root(t, state) -> bytes:
    validators_field = dict(zip(t.BeaconState._field_names, t.BeaconState._field_types))[
        "validators"
    ]
    return validators_field.hash_tree_root(state.validators)


def _empty_genesis_scaffold(ctx: TransitionContext, genesis_time: int, eth1_data: Eth1Data):
    """The shared empty-state scaffold both genesis paths start from."""
    t, preset, spec = ctx.types, ctx.preset, ctx.spec
    return t.BeaconState(
        genesis_time=genesis_time,
        slot=0,
        fork=Fork(
            previous_version=spec.genesis_fork_version,
            current_version=spec.genesis_fork_version,
            epoch=GENESIS_EPOCH,
        ),
        latest_block_header=BeaconBlockHeader(
            slot=0,
            proposer_index=0,
            parent_root=b"\x00" * 32,
            state_root=b"\x00" * 32,
            body_root=t.BeaconBlockBody.hash_tree_root(t.BeaconBlockBody.default()),
        ),
        eth1_data=eth1_data,
        randao_mixes=[bytes(eth1_data.block_hash)] * preset.epochs_per_historical_vector,
    )


# -- the real deposit-driven path ----------------------------------------------


def initialize_beacon_state_from_eth1(
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits: list,
    ctx: TransitionContext,
):
    """Spec initialize_beacon_state_from_eth1: apply every deposit (with
    proof verification against an incrementally-built deposit tree),
    then activate validators holding MAX_EFFECTIVE_BALANCE."""
    from ..ssz.merkle_proof import MerkleTree, deposit_root, deposit_tree_proof
    from ..types import DEPOSIT_CONTRACT_TREE_DEPTH
    from ..types.containers import Deposit, DepositData
    from .per_block import process_deposit

    t, preset, spec = ctx.types, ctx.preset, ctx.spec
    state = _empty_genesis_scaffold(
        ctx,
        eth1_timestamp + spec.genesis_delay,
        Eth1Data(
            deposit_root=b"\x00" * 32, deposit_count=len(deposits), block_hash=eth1_block_hash
        ),
    )

    tree = MerkleTree([], DEPOSIT_CONTRACT_TREE_DEPTH)
    leaves = [DepositData.hash_tree_root(d.data if isinstance(d, Deposit) else d) for d in deposits]
    for index, dep in enumerate(deposits):
        dd = dep.data if isinstance(dep, Deposit) else dep
        tree.push(leaves[index])
        state.eth1_data.deposit_root = deposit_root(tree, index + 1)
        proved = Deposit(proof=deposit_tree_proof(tree, index, index + 1), data=dd)
        process_deposit(state, proved, ctx)

    # Process activations (spec): recompute effective balances from actual
    # balances FIRST — a validator funded across several partial deposits
    # must still activate — then flag full-balance validators active.
    for index, v in enumerate(state.validators):
        balance = state.balances[index]
        v.effective_balance = min(
            balance - balance % spec.effective_balance_increment,
            spec.max_effective_balance,
        )
        if v.effective_balance == spec.max_effective_balance:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH

    state.genesis_validators_root = _validators_root(t, state)
    return _upgrade_genesis_to_scheduled_fork(state, ctx)


def is_valid_genesis_state(state, ctx: TransitionContext) -> bool:
    """Spec trigger condition (the Eth1GenesisService's poll predicate)."""
    from .helpers import get_active_validator_indices

    if state.genesis_time < ctx.spec.min_genesis_time:
        return False
    active = get_active_validator_indices(state, GENESIS_EPOCH)
    return len(active) >= ctx.spec.min_genesis_active_validator_count
