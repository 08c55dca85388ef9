"""ENRForkID: the "eth2" ENR field used for fork-aware peer selection.

Mirrors lighthouse/beacon_node/lighthouse_network/src/discovery/enr.rs
(build_enr's ETH2_ENR_KEY) and the consensus p2p spec's ENRForkID: peers
advertise {current fork digest, next scheduled fork version/epoch} so a
node dials only peers on its chain."""

from __future__ import annotations

from ..ssz.types import Bytes4, Container, uint64
from ..types import FAR_FUTURE_EPOCH, FORK_ORDER, compute_fork_digest

ETH2_ENR_KEY = b"eth2"


class ENRForkID(Container):
    fields = [
        ("fork_digest", Bytes4),
        ("next_fork_version", Bytes4),
        ("next_fork_epoch", uint64),
    ]


def enr_fork_id(spec, current_epoch: int, genesis_validators_root: bytes) -> ENRForkID:
    current = spec.fork_name_at_epoch(current_epoch)
    digest = compute_fork_digest(spec.fork_version(current), genesis_validators_root)
    nxt_version, nxt_epoch = spec.fork_version(current), FAR_FUTURE_EPOCH
    for name in FORK_ORDER:
        epoch = spec.fork_epoch(name)
        if epoch > current_epoch and epoch != FAR_FUTURE_EPOCH:
            nxt_version, nxt_epoch = spec.fork_version(name), epoch
            break
    return ENRForkID(
        fork_digest=digest, next_fork_version=nxt_version, next_fork_epoch=nxt_epoch
    )


def eth2_enr_pair(spec, current_epoch: int, genesis_validators_root: bytes) -> dict[bytes, bytes]:
    """The extra= dict entry for Enr.build."""
    fid = enr_fork_id(spec, current_epoch, genesis_validators_root)
    return {ETH2_ENR_KEY: ENRForkID.serialize(fid)}


def compatible(local: ENRForkID, remote_raw: bytes) -> bool:
    """The subnet_predicate-style compatibility check: same current digest."""
    try:
        remote = ENRForkID.deserialize(remote_raw)
    except Exception:  # noqa: BLE001 — malformed field -> incompatible
        return False
    return bytes(remote.fork_digest) == bytes(local.fork_digest)
