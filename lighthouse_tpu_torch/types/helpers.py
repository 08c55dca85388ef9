"""Slot/epoch math, domains, and signing roots.

Reference: lighthouse/consensus/types/src/{slot_epoch.rs,signing_data.rs,
chain_spec.rs (compute_domain/get_domain equivalents)}.
"""

from __future__ import annotations

from .containers import ForkData, SigningData
from .spec import ChainSpec, Preset


def compute_epoch_at_slot(slot: int, preset: Preset) -> int:
    return slot // preset.slots_per_epoch


def compute_start_slot_at_epoch(epoch: int, preset: Preset) -> int:
    return epoch * preset.slots_per_epoch

def compute_activation_exit_epoch(epoch: int, spec: ChainSpec) -> int:
    return epoch + 1 + spec.max_seed_lookahead


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    fd = ForkData(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root,
    )
    return ForkData.hash_tree_root(fd)


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: bytes | None = None,
    genesis_validators_root: bytes = b"\x00" * 32,
    spec: ChainSpec | None = None,
) -> bytes:
    """32-byte domain: 4-byte type || first 28 bytes of the fork data root."""
    if fork_version is None:
        fork_version = (spec or ChainSpec()).genesis_fork_version
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fork_data_root[:28]


def get_domain(state, domain_type: bytes, epoch: int | None, preset: Preset) -> bytes:
    """Domain for signing at `epoch` given the state's fork schedule
    (signature_sets.rs callers obtain domains this way)."""
    if epoch is None:
        epoch = compute_epoch_at_slot(state.slot, preset)
    fork_version = (
        state.fork.previous_version if epoch < state.fork.epoch else state.fork.current_version
    )
    return compute_domain(
        domain_type, fork_version, state.genesis_validators_root
    )


def schedule_domain(
    spec: ChainSpec, domain_type: bytes, epoch: int, genesis_validators_root: bytes
) -> bytes:
    """Domain at `epoch` from the ChainSpec fork SCHEDULE. Signers must use
    this (not `get_domain` on a head state) so that signatures made for the
    first epoch of a newly-activated fork verify against the post-upgrade
    state's fork record (chain_spec.rs fork_version_for_name +
    enr_fork_id-style schedule lookups)."""
    version = spec.fork_version(spec.fork_name_at_epoch(epoch))
    return compute_domain(domain_type, version, bytes(genesis_validators_root))


def compute_signing_root(obj, domain: bytes) -> bytes:
    """hash_tree_root(SigningData{object_root, domain}) — what actually gets
    BLS-signed (lighthouse/consensus/types/src/signing_data.rs)."""
    sd = SigningData(object_root=type(obj).hash_tree_root(obj), domain=domain)
    return SigningData.hash_tree_root(sd)


# -- fork-aware SSZ decoding ---------------------------------------------------
#
# The reference decodes fork-multiplexed types via
# SignedBeaconBlock::from_ssz_bytes_with_fork / BeaconState's slot peek
# (lighthouse/consensus/types/src/signed_beacon_block.rs,
#  beacon_state.rs from_ssz_bytes): read the fixed-offset slot/fork-version
# field, map it through the ChainSpec schedule, then decode as that fork's
# container.

_STATE_FORK_VERSION_OFFSET = 8 + 32 + 8 + 4  # genesis_time, gvr, slot, prev_version
_BLOCK_SLOT_OFFSET = 4 + 96  # message offset bytes, signature


def decode_beacon_state(data: bytes, types, spec: ChainSpec):
    """SSZ bytes -> the right fork's BeaconState, keyed on the embedded
    fork.current_version."""
    version = bytes(data[_STATE_FORK_VERSION_OFFSET : _STATE_FORK_VERSION_OFFSET + 4])
    from .spec import FORK_ORDER

    for name in FORK_ORDER:
        if spec.fork_version(name) == version:
            return types.for_fork(name).BeaconState.deserialize(data)
    raise ValueError(f"unknown fork version {version.hex()} in state bytes")


def decode_signed_block(data: bytes, types, spec: ChainSpec, preset: Preset):
    """SSZ bytes -> the right fork's SignedBeaconBlock, keyed on the
    embedded slot mapped through the fork schedule."""
    slot = int.from_bytes(data[_BLOCK_SLOT_OFFSET : _BLOCK_SLOT_OFFSET + 8], "little")
    name = spec.fork_name_at_epoch(compute_epoch_at_slot(slot, preset))
    return types.for_fork(name).SignedBeaconBlock.deserialize(data)
