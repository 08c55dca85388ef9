"""Spec constants: compile-time presets + runtime chain spec.

Mirrors the reference's two-tier split:
  - `Preset` — the typenum-style *shape* constants of the `EthSpec` trait
    (lighthouse/consensus/types/src/eth_spec.rs:51-100): list limits,
    vector lengths, per-block maxima. These parameterize SSZ container
    types, so they are fixed per preset (Mainnet / Minimal:
    eth_spec.rs:238,281).
  - `ChainSpec` — runtime-configurable values (domains, fork versions,
    timing, balances) (lighthouse/consensus/types/src/chain_spec.rs).

Keeping shape constants separate: anything that sizes a device batch
lives in `Preset`, never in `ChainSpec`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0
GENESIS_SLOT = 0
DEPOSIT_CONTRACT_TREE_DEPTH = 32
JUSTIFICATION_BITS_LENGTH = 4
ENDIANNESS = "little"

BASE_REWARDS_PER_EPOCH = 4

# -- altair participation flags (consensus/types/src/consts.rs altair) ---------

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64

PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
]

SYNC_COMMITTEE_SUBNET_COUNT = 4

# Fork names in activation order (the reference's ForkName enum,
# lighthouse/consensus/types/src/fork_name.rs).
FORK_ORDER = ("phase0", "altair", "bellatrix")


@dataclass(frozen=True)
class Preset:
    """Shape constants (eth_spec.rs:51-100). One instance per named preset."""

    name: str
    # time
    slots_per_epoch: int
    epochs_per_eth1_voting_period: int
    slots_per_historical_root: int
    # state list lengths
    epochs_per_historical_vector: int
    epochs_per_slashings_vector: int
    historical_roots_limit: int
    validator_registry_limit: int
    # committees
    max_committees_per_slot: int
    target_committee_size: int
    max_validators_per_committee: int
    shuffle_round_count: int
    # max operations per block
    max_proposer_slashings: int
    max_attester_slashings: int
    max_attestations: int
    max_deposits: int
    max_voluntary_exits: int
    # sync committee (altair)
    sync_committee_size: int
    epochs_per_sync_committee_period: int
    # execution (merge)
    max_bytes_per_transaction: int
    max_transactions_per_payload: int
    bytes_per_logs_bloom: int
    max_extra_data_bytes: int

    @property
    def slots_per_eth1_voting_period(self) -> int:
        return self.epochs_per_eth1_voting_period * self.slots_per_epoch

    @property
    def sync_subcommittee_size(self) -> int:
        """Positions per sync subnet (sync_committee_size /
        SYNC_COMMITTEE_SUBNET_COUNT) — the single source for the five call
        sites and the SyncCommitteeContribution bitvector length."""
        return self.sync_committee_size // SYNC_COMMITTEE_SUBNET_COUNT


# lighthouse/consensus/types/src/eth_spec.rs:238 (MainnetEthSpec)
MAINNET_PRESET = Preset(
    name="mainnet",
    slots_per_epoch=32,
    epochs_per_eth1_voting_period=64,
    slots_per_historical_root=8192,
    epochs_per_historical_vector=65536,
    epochs_per_slashings_vector=8192,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    shuffle_round_count=90,
    max_proposer_slashings=16,
    max_attester_slashings=2,
    max_attestations=128,
    max_deposits=16,
    max_voluntary_exits=16,
    sync_committee_size=512,
    epochs_per_sync_committee_period=256,
    max_bytes_per_transaction=2**30,
    max_transactions_per_payload=2**20,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
)

# lighthouse/consensus/types/src/eth_spec.rs:281 (MinimalEthSpec)
MINIMAL_PRESET = Preset(
    name="minimal",
    slots_per_epoch=8,
    epochs_per_eth1_voting_period=4,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    max_committees_per_slot=4,
    target_committee_size=4,
    max_validators_per_committee=2048,
    shuffle_round_count=10,
    max_proposer_slashings=16,
    max_attester_slashings=2,
    max_attestations=128,
    max_deposits=16,
    max_voluntary_exits=16,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
    max_bytes_per_transaction=2**30,
    max_transactions_per_payload=2**20,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
)


@dataclass(frozen=True)
class ChainSpec:
    """Runtime constants (chain_spec.rs). Defaults are the mainnet phase0
    values; a Minimal network overrides the timing/churn fields."""

    # fork schedule (chain_spec.rs altair_fork_{version,epoch} etc.;
    # FAR_FUTURE_EPOCH = fork not scheduled)
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: int = FAR_FUTURE_EPOCH
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: int = FAR_FUTURE_EPOCH
    # domains (4-byte type prefixes)
    domain_beacon_proposer: bytes = b"\x00\x00\x00\x00"
    domain_beacon_attester: bytes = b"\x01\x00\x00\x00"
    domain_randao: bytes = b"\x02\x00\x00\x00"
    domain_deposit: bytes = b"\x03\x00\x00\x00"
    domain_voluntary_exit: bytes = b"\x04\x00\x00\x00"
    domain_selection_proof: bytes = b"\x05\x00\x00\x00"
    domain_aggregate_and_proof: bytes = b"\x06\x00\x00\x00"
    domain_sync_committee: bytes = b"\x07\x00\x00\x00"
    domain_sync_committee_selection_proof: bytes = b"\x08\x00\x00\x00"
    domain_contribution_and_proof: bytes = b"\x09\x00\x00\x00"
    # gwei
    min_deposit_amount: int = 10**9
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9
    ejection_balance: int = 16 * 10**9
    # time
    seconds_per_slot: int = 12
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_epochs_to_inactivity_penalty: int = 4
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    # churn
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 2**16
    # rewards & penalties (phase0 values; per-fork overrides below)
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1
    # altair rewards & penalties + inactivity scoring
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # bellatrix rewards & penalties
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3
    # merge transition
    terminal_total_difficulty: int = 2**256 - 2**10
    terminal_block_hash: bytes = b"\x00" * 32
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH
    # hysteresis
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5
    # genesis
    min_genesis_active_validator_count: int = 2**14
    min_genesis_time: int = 1606824000
    genesis_delay: int = 604800
    # deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1

    def churn_limit(self, active_validator_count: int) -> int:
        return max(
            self.min_per_epoch_churn_limit,
            active_validator_count // self.churn_limit_quotient,
        )

    # -- fork schedule (fork_name.rs / ChainSpec::fork_name_at_epoch) ----------

    def fork_epoch(self, fork_name: str) -> int:
        return {
            "phase0": 0,
            "altair": self.altair_fork_epoch,
            "bellatrix": self.bellatrix_fork_epoch,
        }[fork_name]

    def fork_version(self, fork_name: str) -> bytes:
        return {
            "phase0": self.genesis_fork_version,
            "altair": self.altair_fork_version,
            "bellatrix": self.bellatrix_fork_version,
        }[fork_name]

    def fork_name_at_epoch(self, epoch: int) -> str:
        name = "phase0"
        for candidate in FORK_ORDER:
            if self.fork_epoch(candidate) <= epoch:
                name = candidate
        return name


MAINNET_SPEC = ChainSpec()

MINIMAL_SPEC = ChainSpec(
    genesis_fork_version=b"\x00\x00\x00\x01",
    altair_fork_version=b"\x01\x00\x00\x01",
    bellatrix_fork_version=b"\x02\x00\x00\x01",
    seconds_per_slot=6,
    min_genesis_active_validator_count=64,
    min_genesis_time=1578009600,
    min_validator_withdrawability_delay=256,
    shard_committee_period=64,
    genesis_delay=300,
    churn_limit_quotient=32,
    deposit_chain_id=5,
    deposit_network_id=5,
)
