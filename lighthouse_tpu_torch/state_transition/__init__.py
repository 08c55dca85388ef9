"""State transition (phase0 / altair / bellatrix): per-slot/block/epoch
processing, signature sets, and the bulk block-signature verifier.

Counterpart of lighthouse/consensus/state_processing: the layer that turns
consensus objects into the device-sized signature batches the card's
verifier consumes. Fork multiplexing dispatches on the
container classes' fork_name markers (per_slot._process_epoch_for_fork,
per_block.process_operations); scheduled upgrades run inside process_slots.
"""

from .altair import upgrade_to_altair
from .bellatrix import upgrade_to_bellatrix
from .context import PubkeyCache, TransitionContext
from .helpers import ExecutionEngineError, StateTransitionError
from .per_block import (
    BlockSignatureStrategy,
    BlockSignatureVerifier,
    per_block_processing,
    process_attestation,
    process_block_header,
    process_deposit,
    process_eth1_data,
    process_operations,
    process_randao,
)
from .per_epoch import process_epoch
from .per_slot import per_slot_processing, process_slot, process_slots, state_transition
from .genesis import interop_genesis_state

__all__ = [
    "upgrade_to_altair",
    "upgrade_to_bellatrix",
    "PubkeyCache",
    "TransitionContext",
    "StateTransitionError",
    "BlockSignatureStrategy",
    "BlockSignatureVerifier",
    "per_block_processing",
    "process_attestation",
    "process_block_header",
    "process_deposit",
    "process_eth1_data",
    "process_operations",
    "process_randao",
    "process_epoch",
    "per_slot_processing",
    "process_slot",
    "process_slots",
    "state_transition",
    "interop_genesis_state",
]
