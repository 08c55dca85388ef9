"""Work scheduling: the BeaconProcessor priority-queue/batch-formation layer
(copied from the JAX package's scheduler/), with gossip batches capped at
the verifier's 128-set bucket.
"""

from .beacon_processor import (
    Batch,
    BeaconProcessor,
    MAX_GOSSIP_AGGREGATE_BATCH_SIZE,
    MAX_GOSSIP_ATTESTATION_BATCH_SIZE,
    WorkType,
)

__all__ = [
    "Batch",
    "BeaconProcessor",
    "MAX_GOSSIP_AGGREGATE_BATCH_SIZE",
    "MAX_GOSSIP_ATTESTATION_BATCH_SIZE",
    "WorkType",
]
