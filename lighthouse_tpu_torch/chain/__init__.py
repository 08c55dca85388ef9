"""Chain core + in-process harness (copied from the JAX package's chain/).

Counterpart of lighthouse/beacon_node/beacon_chain: BeaconChain
(block production/import/head), slot clocks, and the BeaconChainHarness
used to drive an end-to-end chain without networking.
"""

from .beacon_chain import BeaconChain, BlockError
from .harness import BeaconChainHarness
from .slot_clock import ManualSlotClock, SystemSlotClock

__all__ = [
    "BeaconChain",
    "BlockError",
    "BeaconChainHarness",
    "ManualSlotClock",
    "SystemSlotClock",
]
