"""Phase0 consensus containers, parameterized by preset.

The reference expresses container shapes through the `EthSpec` typenum trait
(lighthouse/consensus/types/src/eth_spec.rs:51-100) and derive macros;
the idiomatic Python rendering is a *type factory*: `SpecTypes(preset)`
builds one concrete SSZ `Container` class per consensus object with the
preset's limits baked in. `mainnet_types()` / `minimal_types()` return
cached instances.

Containers covered (phase0):
  Fork, ForkData, Checkpoint, Validator, AttestationData, IndexedAttestation,
  PendingAttestation, Eth1Data, HistoricalBatch, DepositMessage, DepositData,
  BeaconBlockHeader, SignedBeaconBlockHeader, SigningData, ProposerSlashing,
  AttesterSlashing, Attestation, Deposit, VoluntaryExit, SignedVoluntaryExit,
  AggregateAndProof, SignedAggregateAndProof, BeaconBlockBody, BeaconBlock,
  SignedBeaconBlock, BeaconState
(reference: lighthouse/consensus/types/src/beacon_state.rs:202,
 beacon_block.rs, attestation.rs, validator.rs et al.)

Preset-independent containers (Fork, Checkpoint, Validator, ...) are defined
once at module scope and re-exported from every SpecTypes instance, so
isinstance checks hold across presets.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..ssz.types import (
    Bitlist,
    Bitvector,
    ByteList,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Vector,
    boolean,
    uint8,
    uint64,
    uint256,
)
from .spec import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    JUSTIFICATION_BITS_LENGTH,
    MAINNET_PRESET,
    MINIMAL_PRESET,
    Preset,
)


# -- preset-independent containers --------------------------------------------


class Fork(Container):
    fields = [
        ("previous_version", Bytes4),
        ("current_version", Bytes4),
        ("epoch", uint64),
    ]


class ForkData(Container):
    fields = [
        ("current_version", Bytes4),
        ("genesis_validators_root", Bytes32),
    ]


class Checkpoint(Container):
    root_memo_limit = 1 << 16
    fields = [
        ("epoch", uint64),
        ("root", Bytes32),
    ]


class Validator(Container):
    # lighthouse/consensus/types/src/validator.rs
    # Registry entries rarely change within an epoch: memoized roots turn
    # per-slot state hashing from O(validators * 15 sha256) into O(validators)
    # dict hits (the cached_tree_hash role).
    root_memo_limit = 1 << 20
    fields = [
        ("pubkey", Bytes48),
        ("withdrawal_credentials", Bytes32),
        ("effective_balance", uint64),
        ("slashed", boolean),
        ("activation_eligibility_epoch", uint64),
        ("activation_epoch", uint64),
        ("exit_epoch", uint64),
        ("withdrawable_epoch", uint64),
    ]


class AttestationData(Container):
    root_memo_limit = 1 << 16
    fields = [
        ("slot", uint64),
        ("index", uint64),
        ("beacon_block_root", Bytes32),
        ("source", Checkpoint),
        ("target", Checkpoint),
    ]


class Eth1Data(Container):
    fields = [
        ("deposit_root", Bytes32),
        ("deposit_count", uint64),
        ("block_hash", Bytes32),
    ]


class DepositMessage(Container):
    fields = [
        ("pubkey", Bytes48),
        ("withdrawal_credentials", Bytes32),
        ("amount", uint64),
    ]


class DepositData(Container):
    fields = [
        ("pubkey", Bytes48),
        ("withdrawal_credentials", Bytes32),
        ("amount", uint64),
        ("signature", Bytes96),
    ]


class BeaconBlockHeader(Container):
    fields = [
        ("slot", uint64),
        ("proposer_index", uint64),
        ("parent_root", Bytes32),
        ("state_root", Bytes32),
        ("body_root", Bytes32),
    ]


class SignedBeaconBlockHeader(Container):
    fields = [
        ("message", BeaconBlockHeader),
        ("signature", Bytes96),
    ]


class SigningData(Container):
    # lighthouse/consensus/types/src/signing_data.rs
    fields = [
        ("object_root", Bytes32),
        ("domain", Bytes32),
    ]


class ProposerSlashing(Container):
    fields = [
        ("signed_header_1", SignedBeaconBlockHeader),
        ("signed_header_2", SignedBeaconBlockHeader),
    ]


class Deposit(Container):
    fields = [
        ("proof", Vector(Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
        ("data", DepositData),
    ]


class VoluntaryExit(Container):
    fields = [
        ("epoch", uint64),
        ("validator_index", uint64),
    ]


class SignedVoluntaryExit(Container):
    fields = [
        ("message", VoluntaryExit),
        ("signature", Bytes96),
    ]


_SHARED = {
    "Fork": Fork,
    "ForkData": ForkData,
    "Checkpoint": Checkpoint,
    "Validator": Validator,
    "AttestationData": AttestationData,
    "Eth1Data": Eth1Data,
    "DepositMessage": DepositMessage,
    "DepositData": DepositData,
    "BeaconBlockHeader": BeaconBlockHeader,
    "SignedBeaconBlockHeader": SignedBeaconBlockHeader,
    "SigningData": SigningData,
    "ProposerSlashing": ProposerSlashing,
    "Deposit": Deposit,
    "VoluntaryExit": VoluntaryExit,
    "SignedVoluntaryExit": SignedVoluntaryExit,
}


@dataclass(frozen=True)
class ForkTypes:
    """The four fork-variant container classes for one fork."""

    BeaconState: type
    BeaconBlock: type
    BeaconBlockBody: type
    SignedBeaconBlock: type


class SpecTypes:
    """All consensus container types for one preset."""

    def __init__(self, preset: Preset):
        self.preset = preset
        p = preset
        for name, cls in _SHARED.items():
            setattr(self, name, cls)

        class IndexedAttestation(Container):
            fields = [
                ("attesting_indices", List(uint64, p.max_validators_per_committee)),
                ("data", AttestationData),
                ("signature", Bytes96),
            ]

        class PendingAttestation(Container):
            fields = [
                ("aggregation_bits", Bitlist(p.max_validators_per_committee)),
                ("data", AttestationData),
                ("inclusion_delay", uint64),
                ("proposer_index", uint64),
            ]

        class Attestation(Container):
            fields = [
                ("aggregation_bits", Bitlist(p.max_validators_per_committee)),
                ("data", AttestationData),
                ("signature", Bytes96),
            ]

        class AttesterSlashing(Container):
            fields = [
                ("attestation_1", IndexedAttestation),
                ("attestation_2", IndexedAttestation),
            ]

        class AggregateAndProof(Container):
            fields = [
                ("aggregator_index", uint64),
                ("aggregate", Attestation),
                ("selection_proof", Bytes96),
            ]

        class SignedAggregateAndProof(Container):
            fields = [
                ("message", AggregateAndProof),
                ("signature", Bytes96),
            ]

        class HistoricalBatch(Container):
            fields = [
                ("block_roots", Vector(Bytes32, p.slots_per_historical_root)),
                ("state_roots", Vector(Bytes32, p.slots_per_historical_root)),
            ]

        class BeaconBlockBody(Container):
            fields = [
                ("randao_reveal", Bytes96),
                ("eth1_data", Eth1Data),
                ("graffiti", Bytes32),
                ("proposer_slashings", List(ProposerSlashing, p.max_proposer_slashings)),
                ("attester_slashings", List(AttesterSlashing, p.max_attester_slashings)),
                ("attestations", List(Attestation, p.max_attestations)),
                ("deposits", List(Deposit, p.max_deposits)),
                ("voluntary_exits", List(SignedVoluntaryExit, p.max_voluntary_exits)),
            ]

        class BeaconBlock(Container):
            fields = [
                ("slot", uint64),
                ("proposer_index", uint64),
                ("parent_root", Bytes32),
                ("state_root", Bytes32),
                ("body", BeaconBlockBody),
            ]

        class SignedBeaconBlock(Container):
            fields = [
                ("message", BeaconBlock),
                ("signature", Bytes96),
            ]

        class BeaconState(Container):
            # lighthouse/consensus/types/src/beacon_state.rs:202 (Base)
            fields = [
                ("genesis_time", uint64),
                ("genesis_validators_root", Bytes32),
                ("slot", uint64),
                ("fork", Fork),
                ("latest_block_header", BeaconBlockHeader),
                ("block_roots", Vector(Bytes32, p.slots_per_historical_root)),
                ("state_roots", Vector(Bytes32, p.slots_per_historical_root)),
                ("historical_roots", List(Bytes32, p.historical_roots_limit)),
                ("eth1_data", Eth1Data),
                ("eth1_data_votes", List(Eth1Data, p.slots_per_eth1_voting_period)),
                ("eth1_deposit_index", uint64),
                ("validators", List(Validator, p.validator_registry_limit)),
                ("balances", List(uint64, p.validator_registry_limit)),
                ("randao_mixes", Vector(Bytes32, p.epochs_per_historical_vector)),
                ("slashings", Vector(uint64, p.epochs_per_slashings_vector)),
                (
                    "previous_epoch_attestations",
                    List(PendingAttestation, p.max_attestations * p.slots_per_epoch),
                ),
                (
                    "current_epoch_attestations",
                    List(PendingAttestation, p.max_attestations * p.slots_per_epoch),
                ),
                ("justification_bits", Bitvector(JUSTIFICATION_BITS_LENGTH)),
                ("previous_justified_checkpoint", Checkpoint),
                ("current_justified_checkpoint", Checkpoint),
                ("finalized_checkpoint", Checkpoint),
            ]

        # -- altair (beacon_state.rs Altair variant; sync_committee.rs) --------

        class SyncCommittee(Container):
            fields = [
                ("pubkeys", Vector(Bytes48, p.sync_committee_size)),
                ("aggregate_pubkey", Bytes48),
            ]

        class SyncAggregate(Container):
            fields = [
                ("sync_committee_bits", Bitvector(p.sync_committee_size)),
                ("sync_committee_signature", Bytes96),
            ]

        class SyncCommitteeMessage(Container):
            # consensus/types/src/sync_committee_message.rs
            fields = [
                ("slot", uint64),
                ("beacon_block_root", Bytes32),
                ("validator_index", uint64),
                ("signature", Bytes96),
            ]

        class SyncCommitteeContribution(Container):
            # consensus/types/src/sync_committee_contribution.rs
            fields = [
                ("slot", uint64),
                ("beacon_block_root", Bytes32),
                ("subcommittee_index", uint64),
                ("aggregation_bits", Bitvector(p.sync_subcommittee_size)),
                ("signature", Bytes96),
            ]

        class ContributionAndProof(Container):
            fields = [
                ("aggregator_index", uint64),
                ("contribution", SyncCommitteeContribution),
                ("selection_proof", Bytes96),
            ]

        class SignedContributionAndProof(Container):
            fields = [
                ("message", ContributionAndProof),
                ("signature", Bytes96),
            ]

        class SyncAggregatorSelectionData(Container):
            fields = [
                ("slot", uint64),
                ("subcommittee_index", uint64),
            ]

        class BeaconBlockBodyAltair(Container):
            fields = BeaconBlockBody.fields + [("sync_aggregate", SyncAggregate)]

        class BeaconBlockAltair(Container):
            fields = [
                ("slot", uint64),
                ("proposer_index", uint64),
                ("parent_root", Bytes32),
                ("state_root", Bytes32),
                ("body", BeaconBlockBodyAltair),
            ]

        class SignedBeaconBlockAltair(Container):
            fields = [
                ("message", BeaconBlockAltair),
                ("signature", Bytes96),
            ]

        class BeaconStateAltair(Container):
            # beacon_state.rs:202 (Altair variant): pending attestations are
            # replaced by per-validator participation flag bytes; adds
            # inactivity scores and the two sync committees.
            fields = [
                ("genesis_time", uint64),
                ("genesis_validators_root", Bytes32),
                ("slot", uint64),
                ("fork", Fork),
                ("latest_block_header", BeaconBlockHeader),
                ("block_roots", Vector(Bytes32, p.slots_per_historical_root)),
                ("state_roots", Vector(Bytes32, p.slots_per_historical_root)),
                ("historical_roots", List(Bytes32, p.historical_roots_limit)),
                ("eth1_data", Eth1Data),
                ("eth1_data_votes", List(Eth1Data, p.slots_per_eth1_voting_period)),
                ("eth1_deposit_index", uint64),
                ("validators", List(Validator, p.validator_registry_limit)),
                ("balances", List(uint64, p.validator_registry_limit)),
                ("randao_mixes", Vector(Bytes32, p.epochs_per_historical_vector)),
                ("slashings", Vector(uint64, p.epochs_per_slashings_vector)),
                ("previous_epoch_participation", List(uint8, p.validator_registry_limit)),
                ("current_epoch_participation", List(uint8, p.validator_registry_limit)),
                ("justification_bits", Bitvector(JUSTIFICATION_BITS_LENGTH)),
                ("previous_justified_checkpoint", Checkpoint),
                ("current_justified_checkpoint", Checkpoint),
                ("finalized_checkpoint", Checkpoint),
                ("inactivity_scores", List(uint64, p.validator_registry_limit)),
                ("current_sync_committee", SyncCommittee),
                ("next_sync_committee", SyncCommittee),
            ]

        # -- bellatrix (execution_payload.rs; beacon_state.rs Merge variant) ---

        Transaction = ByteList(p.max_bytes_per_transaction)

        class ExecutionPayload(Container):
            fields = [
                ("parent_hash", Bytes32),
                ("fee_recipient", Bytes20),
                ("state_root", Bytes32),
                ("receipts_root", Bytes32),
                ("logs_bloom", Vector(uint8, p.bytes_per_logs_bloom)),
                ("prev_randao", Bytes32),
                ("block_number", uint64),
                ("gas_limit", uint64),
                ("gas_used", uint64),
                ("timestamp", uint64),
                ("extra_data", ByteList(p.max_extra_data_bytes)),
                ("base_fee_per_gas", uint256),
                ("block_hash", Bytes32),
                ("transactions", List(Transaction, p.max_transactions_per_payload)),
            ]

        class ExecutionPayloadHeader(Container):
            fields = ExecutionPayload.fields[:-1] + [("transactions_root", Bytes32)]

        class BeaconBlockBodyBellatrix(Container):
            fields = BeaconBlockBodyAltair.fields + [("execution_payload", ExecutionPayload)]

        class BeaconBlockBellatrix(Container):
            fields = [
                ("slot", uint64),
                ("proposer_index", uint64),
                ("parent_root", Bytes32),
                ("state_root", Bytes32),
                ("body", BeaconBlockBodyBellatrix),
            ]

        class SignedBeaconBlockBellatrix(Container):
            fields = [
                ("message", BeaconBlockBellatrix),
                ("signature", Bytes96),
            ]

        class BeaconStateBellatrix(Container):
            fields = BeaconStateAltair.fields + [
                ("latest_execution_payload_header", ExecutionPayloadHeader),
            ]

        self.IndexedAttestation = IndexedAttestation
        self.PendingAttestation = PendingAttestation
        self.Attestation = Attestation
        self.AttesterSlashing = AttesterSlashing
        self.AggregateAndProof = AggregateAndProof
        self.SignedAggregateAndProof = SignedAggregateAndProof
        self.HistoricalBatch = HistoricalBatch
        self.BeaconBlockBody = BeaconBlockBody
        self.BeaconBlock = BeaconBlock
        self.SignedBeaconBlock = SignedBeaconBlock
        self.BeaconState = BeaconState
        self.SyncCommittee = SyncCommittee
        self.SyncAggregate = SyncAggregate
        self.SyncCommitteeMessage = SyncCommitteeMessage
        self.SyncCommitteeContribution = SyncCommitteeContribution
        self.ContributionAndProof = ContributionAndProof
        self.SignedContributionAndProof = SignedContributionAndProof
        self.SyncAggregatorSelectionData = SyncAggregatorSelectionData
        self.BeaconBlockBodyAltair = BeaconBlockBodyAltair
        self.BeaconBlockAltair = BeaconBlockAltair
        self.SignedBeaconBlockAltair = SignedBeaconBlockAltair
        self.BeaconStateAltair = BeaconStateAltair
        self.Transaction = Transaction
        self.ExecutionPayload = ExecutionPayload
        self.ExecutionPayloadHeader = ExecutionPayloadHeader
        self.BeaconBlockBodyBellatrix = BeaconBlockBodyBellatrix
        self.BeaconBlockBellatrix = BeaconBlockBellatrix
        self.SignedBeaconBlockBellatrix = SignedBeaconBlockBellatrix
        self.BeaconStateBellatrix = BeaconStateBellatrix

        for cls_name in (
            "IndexedAttestation",
            "PendingAttestation",
            "Attestation",
            "AttesterSlashing",
            "AggregateAndProof",
            "SignedAggregateAndProof",
            "HistoricalBatch",
            "BeaconBlockBody",
            "BeaconBlock",
            "SignedBeaconBlock",
            "BeaconState",
            "SyncCommittee",
            "SyncAggregate",
            "SyncCommitteeMessage",
            "SyncCommitteeContribution",
            "ContributionAndProof",
            "SignedContributionAndProof",
            "SyncAggregatorSelectionData",
            "BeaconBlockBodyAltair",
            "BeaconBlockAltair",
            "SignedBeaconBlockAltair",
            "BeaconStateAltair",
            "ExecutionPayload",
            "ExecutionPayloadHeader",
            "BeaconBlockBodyBellatrix",
            "BeaconBlockBellatrix",
            "SignedBeaconBlockBellatrix",
            "BeaconStateBellatrix",
        ):
            getattr(self, cls_name).__name__ = f"{cls_name}_{p.name}"
            getattr(self, cls_name).__qualname__ = f"{cls_name}_{p.name}"

        # fork-name markers + per-fork namespaces (the role of the
        # reference's superstruct fork enums + ForkName mapping,
        # lighthouse/consensus/types/src/fork_name.rs)
        for cls in (BeaconState, BeaconBlock, BeaconBlockBody, SignedBeaconBlock):
            cls.fork_name = "phase0"
        for cls in (
            BeaconStateAltair,
            BeaconBlockAltair,
            BeaconBlockBodyAltair,
            SignedBeaconBlockAltair,
        ):
            cls.fork_name = "altair"
        for cls in (
            BeaconStateBellatrix,
            BeaconBlockBellatrix,
            BeaconBlockBodyBellatrix,
            SignedBeaconBlockBellatrix,
        ):
            cls.fork_name = "bellatrix"

        self.forks = {
            "phase0": ForkTypes(BeaconState, BeaconBlock, BeaconBlockBody, SignedBeaconBlock),
            "altair": ForkTypes(
                BeaconStateAltair,
                BeaconBlockAltair,
                BeaconBlockBodyAltair,
                SignedBeaconBlockAltair,
            ),
            "bellatrix": ForkTypes(
                BeaconStateBellatrix,
                BeaconBlockBellatrix,
                BeaconBlockBodyBellatrix,
                SignedBeaconBlockBellatrix,
            ),
        }

    def for_fork(self, fork_name: str) -> "ForkTypes":
        return self.forks[fork_name]

    @staticmethod
    def fork_of(obj) -> str:
        """Fork name of a state/block/body instance (isinstance-free: the
        classes carry a fork_name marker)."""
        return type(obj).fork_name


@lru_cache(maxsize=None)
def _types_for(preset: Preset) -> SpecTypes:
    return SpecTypes(preset)


def mainnet_types() -> SpecTypes:
    return _types_for(MAINNET_PRESET)


def minimal_types() -> SpecTypes:
    return _types_for(MINIMAL_PRESET)
