"""Slashing detection engine.

Counterpart of lighthouse/slasher/src (slasher.rs:69
accept_attestation, :79 process_queued; array.rs min/max target arrays):
queued attestations/blocks are batch-processed per epoch; double votes are
detected by (validator, target) record collision, surround votes by a
vectorized numpy comparison over each validator's (source, target) history
— the same scan the reference runs over its chunked min/max arrays, kept
as flat arrays here because that layout is also the device-friendly one.
"""

from .slasher import Slasher, SlasherConfig

__all__ = ["Slasher", "SlasherConfig"]
