"""Gossip topic registry (types/topics.rs:11-28) + subnet mapping.

Attestations ride 64 subnets (`beacon_attestation_{n}`); the subnet for an
attestation is the spec's compute_subnet_for_attestation (the reference's
SubnetId::compute_subnet, consensus/types/src/subnet_id.rs). Sync committee
messages ride 4 subnets (`sync_committee_{n}` = subcommittee index).
"""

from __future__ import annotations

import enum

ATTESTATION_SUBNET_COUNT = 64


class Topic(str, enum.Enum):
    BEACON_BLOCK = "beacon_block"
    BEACON_AGGREGATE_AND_PROOF = "beacon_aggregate_and_proof"
    BEACON_ATTESTATION = "beacon_attestation"  # base name; wire adds _{subnet}
    SYNC_COMMITTEE_CONTRIBUTION = "sync_committee_contribution_and_proof"
    SYNC_COMMITTEE = "sync_committee"  # base name; wire adds _{subnet}
    VOLUNTARY_EXIT = "voluntary_exit"
    PROPOSER_SLASHING = "proposer_slashing"
    ATTESTER_SLASHING = "attester_slashing"

    def full_name(self, fork_digest: bytes, subnet_id: int | None = None) -> str:
        """Wire form: /eth2/{fork_digest}/{topic}[_{subnet}]/ssz_snappy."""
        name = self.value if subnet_id is None else f"{self.value}_{subnet_id}"
        return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"

    @classmethod
    def parse_wire_name(cls, name: str) -> tuple["Topic", int | None] | None:
        """Topic + subnet id from the wire segment (inverse of full_name).
        Exact names first: sync_committee_contribution_and_proof would
        otherwise false-match the sync_committee_{n} prefix."""
        try:
            return cls(name), None
        except ValueError:
            pass
        for topic in (cls.BEACON_ATTESTATION, cls.SYNC_COMMITTEE):
            prefix = topic.value + "_"
            if name.startswith(prefix):
                try:
                    return topic, int(name[len(prefix) :])
                except ValueError:
                    return None
        return None


def compute_subnet_for_attestation(
    committees_per_slot: int, slot: int, committee_index: int, slots_per_epoch: int
) -> int:
    """Spec compute_subnet_for_attestation (subnet_id.rs compute_subnet)."""
    slots_since_epoch_start = slot % slots_per_epoch
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (committees_since_epoch_start + committee_index) % ATTESTATION_SUBNET_COUNT
