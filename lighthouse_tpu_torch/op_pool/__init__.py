"""Operation pool: block-packing of pending operations (copied from the JAX
package's op_pool/).

Counterpart of lighthouse/beacon_node/operation_pool: greedy weighted
maximum-coverage attestation packing (max_cover.rs:48), aggregate-on-insert
attestation storage, slashing/exit dedup + validity filtering.
"""

from .max_cover import maximum_cover
from .pool import OperationPool

__all__ = ["maximum_cover", "OperationPool"]
