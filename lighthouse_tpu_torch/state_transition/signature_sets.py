"""SignatureSet constructors: consensus objects -> verifiable {signature,
pubkeys, message} triples.

Python rendering of the constructor fns in
lighthouse/consensus/state_processing/src/per_block_processing/
signature_sets.rs:55-562. Every constructor takes `bls` (a backend module
from lighthouse_tpu_torch.crypto.bls — torch/ref/fake) and `pubkey`, a
validator-index -> decompressed-PublicKey resolver (the ValidatorPubkeyCache
role, lighthouse/beacon_node/beacon_chain/src/validator_pubkey_cache.rs).

Constructors raise StateTransitionError for structurally-invalid inputs
(unknown validator, undecodable signature) — mirroring the reference's
Error::ValidatorUnknown / BadSignature split from verification failure.

The signed *message* in every set is a 32-byte signing root
(compute_signing_root = hash_tree_root(SigningData{object_root, domain})),
so sets from heterogeneous operations batch uniformly on the device.

Domain derivation follows the reference split (chain_spec.rs get_domain ->
Fork::get_fork_version): every constructor consumed by per_block_processing
/ process_operations derives its domain from the STATE's fork record
(types.get_domain — previous_version for epochs before the fork epoch,
current_version from it onward), because block validity must agree with
other clients on operations signed up to one fork back. Gossip-time-only
constructors (selection proofs, aggregate-and-proof wrappers, sync-committee
messages/contributions) use the ChainSpec fork SCHEDULE
(types.schedule_domain) so verification against a head state that has not
yet crossed a fork boundary still derives the signer's domain.
"""

from __future__ import annotations

from ..ssz.types import uint64
from ..types import (
    ChainSpec,
    Preset,
    compute_signing_root,
    get_domain,
    schedule_domain,
)
from ..types.containers import SigningData
from .helpers import StateTransitionError


def _signing_root_for_uint64(value: int, domain: bytes) -> bytes:
    sd = SigningData(object_root=uint64.hash_tree_root(value), domain=domain)
    return SigningData.hash_tree_root(sd)


def _decode_signature(bls, sig_bytes: bytes):
    try:
        return bls.Signature.from_bytes(bytes(sig_bytes))
    except bls.DecodeError as e:
        raise StateTransitionError(f"undecodable signature: {e}") from e


def _resolve(pubkey, index: int):
    pk = pubkey(index)
    if pk is None:
        raise StateTransitionError(f"unknown validator index {index}")
    return pk


def block_proposal_signature_set(
    state, signed_block, proposer_index: int, bls, pubkey, preset: Preset, spec: ChainSpec
):
    """signature_sets.rs:55 block_proposal_signature_set."""
    block = signed_block.message
    if block.proposer_index != proposer_index:
        raise StateTransitionError("incorrect proposer index")
    domain = get_domain(
        state, spec.domain_beacon_proposer, compute_epoch(block.slot, preset), preset
    )
    root = compute_signing_root(block, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, signed_block.signature),
        signing_keys=[_resolve(pubkey, proposer_index)],
        message=root,
    )


def compute_epoch(slot: int, preset: Preset) -> int:
    return slot // preset.slots_per_epoch


def historical_block_proposal_signature_set(
    signed_block, bls, pubkey, preset: Preset, spec: ChainSpec,
    genesis_validators_root: bytes,
):
    """Proposer signature of a backfilled historical block.

    Backfill batches reach arbitrarily far behind the anchor state's fork
    record, so the domain comes from the ChainSpec SCHEDULE at the block's
    epoch — exactly what an on-schedule state at that epoch would derive
    (historical_blocks.rs:59 import_historical_block_batch verifies against
    the per-epoch fork)."""
    block = signed_block.message
    domain = schedule_domain(
        spec,
        spec.domain_beacon_proposer,
        compute_epoch(int(block.slot), preset),
        bytes(genesis_validators_root),
    )
    root = compute_signing_root(block, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, signed_block.signature),
        signing_keys=[_resolve(pubkey, int(block.proposer_index))],
        message=root,
    )


def randao_signature_set(state, randao_reveal, proposer_index: int, bls, pubkey, preset: Preset, spec: ChainSpec):
    """signature_sets.rs randao_signature_set: message is the epoch (as SSZ
    uint64) under DOMAIN_RANDAO."""
    epoch = compute_epoch(state.slot, preset)
    domain = get_domain(state, spec.domain_randao, epoch, preset)
    root = _signing_root_for_uint64(epoch, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, randao_reveal),
        signing_keys=[_resolve(pubkey, proposer_index)],
        message=root,
    )


def block_header_signature_set(state, signed_header, bls, pubkey, preset: Preset, spec: ChainSpec):
    """One half of a proposer slashing (signature_sets.rs
    proposer_slashing_signature_set builds two of these)."""
    header = signed_header.message
    domain = get_domain(
        state, spec.domain_beacon_proposer, compute_epoch(header.slot, preset), preset
    )
    root = compute_signing_root(header, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, signed_header.signature),
        signing_keys=[_resolve(pubkey, header.proposer_index)],
        message=root,
    )


def proposer_slashing_signature_sets(state, slashing, bls, pubkey, preset: Preset, spec: ChainSpec):
    return (
        block_header_signature_set(state, slashing.signed_header_1, bls, pubkey, preset, spec),
        block_header_signature_set(state, slashing.signed_header_2, bls, pubkey, preset, spec),
    )


def _attester_domain(state, spec: ChainSpec, epoch: int, preset: Preset) -> bytes:
    """Domain a state *advanced to `epoch`* would derive via get_domain.

    The reference verifies gossip attestations against a shuffling-cache state
    at the attestation's target epoch, whose fork record is on schedule for
    that epoch; block-path states are advanced to the block slot before
    verification. Both reduce to: state.fork for epochs the state has crossed,
    the schedule for epochs past the state's fork record (a head state at a
    fork's first slots before any post-fork block lands)."""
    if spec.fork_epoch(spec.fork_name_at_epoch(epoch)) > int(state.fork.epoch):
        return schedule_domain(
            spec, spec.domain_beacon_attester, epoch, state.genesis_validators_root
        )
    return get_domain(state, spec.domain_beacon_attester, epoch, preset)


def indexed_attestation_signature_set(state, indexed, bls, pubkey, preset: Preset, spec: ChainSpec):
    """signature_sets.rs indexed_attestation_signature_set: one set with ALL
    attesting pubkeys (aggregate verify of the same message)."""
    domain = _attester_domain(state, spec, int(indexed.data.target.epoch), preset)
    root = compute_signing_root(indexed.data, domain)
    keys = [_resolve(pubkey, i) for i in indexed.attesting_indices]
    return bls.SignatureSet(
        signature=_decode_signature(bls, indexed.signature),
        signing_keys=keys,
        message=root,
    )


def attester_slashing_signature_sets(state, slashing, bls, pubkey, preset: Preset, spec: ChainSpec):
    return (
        indexed_attestation_signature_set(state, slashing.attestation_1, bls, pubkey, preset, spec),
        indexed_attestation_signature_set(state, slashing.attestation_2, bls, pubkey, preset, spec),
    )


def deposit_signature_set(deposit_data, bls, spec: ChainSpec):
    """signature_sets.rs deposit_pubkey_signature_message: deposits are
    signed over DepositMessage with the *genesis* fork domain (they must
    validate across forks), and the pubkey comes from the deposit itself."""
    from ..types import compute_domain
    from ..types.containers import DepositMessage

    msg = DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    domain = compute_domain(spec.domain_deposit, spec.genesis_fork_version, b"\x00" * 32)
    root = compute_signing_root(msg, domain)
    try:
        pk = bls.PublicKey.from_bytes(bytes(deposit_data.pubkey))
    except bls.DecodeError as e:
        raise StateTransitionError(f"undecodable deposit pubkey: {e}") from e
    return bls.SignatureSet(
        signature=_decode_signature(bls, deposit_data.signature),
        signing_keys=[pk],
        message=root,
    )


def exit_signature_set(state, signed_exit, bls, pubkey, preset: Preset, spec: ChainSpec):
    exit_msg = signed_exit.message
    domain = get_domain(state, spec.domain_voluntary_exit, int(exit_msg.epoch), preset)
    root = compute_signing_root(exit_msg, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, signed_exit.signature),
        signing_keys=[_resolve(pubkey, exit_msg.validator_index)],
        message=root,
    )


def selection_proof_signature_set(state, slot: int, aggregator_index: int, selection_proof, bls, pubkey, preset: Preset, spec: ChainSpec):
    """signature_sets.rs signed_aggregate_selection_proof_signature_set:
    message is the slot (SSZ uint64) under DOMAIN_SELECTION_PROOF."""
    domain = schedule_domain(
        spec,
        spec.domain_selection_proof,
        compute_epoch(slot, preset),
        state.genesis_validators_root,
    )
    root = _signing_root_for_uint64(slot, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, selection_proof),
        signing_keys=[_resolve(pubkey, aggregator_index)],
        message=root,
    )


def _decompress_cached(bls, raw: bytes):
    """Decompress a G1 pubkey with a module-level memo (sync committees reuse
    the same few hundred keys every slot of a 256-epoch period)."""
    key = (id(bls), raw)
    pk = _PK_MEMO.get(key)
    if pk is None:
        try:
            pk = bls.PublicKey.from_bytes(raw)
        except bls.DecodeError as e:
            raise StateTransitionError(f"undecodable sync committee pubkey: {e}") from e
        if len(_PK_MEMO) > 1 << 16:
            _PK_MEMO.clear()
        _PK_MEMO[key] = pk
    return pk


_PK_MEMO: dict = {}


def sync_aggregate_signature_set(state, sync_aggregate, bls, preset: Preset, spec: ChainSpec):
    """signature_sets.rs sync_aggregate_signature_set: the current sync
    committee's participants sign the PREVIOUS slot's block root. Returns
    None for the valid no-participants + infinity-signature case (the
    eth_fast_aggregate_verify carve-out) and raises for no participants with
    a real signature."""
    from ..ssz.types import Bytes32

    bits = list(sync_aggregate.sync_committee_bits)
    participant_pubkeys = [
        bytes(pk) for pk, bit in zip(state.current_sync_committee.pubkeys, bits) if bit
    ]
    sig_bytes = bytes(sync_aggregate.sync_committee_signature)
    if not participant_pubkeys:
        from ..crypto.bls.constants import G2_POINT_AT_INFINITY

        if sig_bytes == G2_POINT_AT_INFINITY:
            return None
        raise StateTransitionError("sync aggregate: no participants but non-infinity sig")

    previous_slot = max(state.slot, 1) - 1
    domain = get_domain(
        state, spec.domain_sync_committee, previous_slot // preset.slots_per_epoch, preset
    )
    block_root = get_block_root_at_slot_for_sync(state, previous_slot, preset)
    sd = SigningData(object_root=Bytes32.hash_tree_root(block_root), domain=domain)
    root = SigningData.hash_tree_root(sd)
    return bls.SignatureSet(
        signature=_decode_signature(bls, sig_bytes),
        signing_keys=[_decompress_cached(bls, raw) for raw in participant_pubkeys],
        message=root,
    )


def get_block_root_at_slot_for_sync(state, slot: int, preset: Preset) -> bytes:
    """get_block_root_at_slot, with the genesis-slot carve-out (state.slot ==
    0 -> slot == 0 and the root is the latest header's parent chain: zeroed —
    handled by the normal path everywhere past genesis)."""
    from .helpers import get_block_root_at_slot

    if slot == state.slot:  # only at genesis (previous_slot clamps to 0)
        return bytes(state.block_roots[slot % preset.slots_per_historical_root])
    return get_block_root_at_slot(state, slot, preset)


def sync_contribution_signature_set(
    state, contribution, participant_pubkeys: list[bytes], bls, preset: Preset, spec: ChainSpec
):
    """The aggregate inside a SignedContributionAndProof: participants of
    one subcommittee over the contribution's block root
    (sync_committee_verification.rs's inner-signature check)."""
    from ..ssz.types import Bytes32

    domain = schedule_domain(
        spec,
        spec.domain_sync_committee,
        compute_epoch(int(contribution.slot), preset),
        state.genesis_validators_root,
    )
    sd = SigningData(
        object_root=Bytes32.hash_tree_root(bytes(contribution.beacon_block_root)),
        domain=domain,
    )
    return bls.SignatureSet(
        signature=_decode_signature(bls, contribution.signature),
        signing_keys=[_decompress_cached(bls, bytes(pk)) for pk in participant_pubkeys],
        message=SigningData.hash_tree_root(sd),
    )


def sync_committee_message_signature_set(state, message, bls, pubkey, preset: Preset, spec: ChainSpec):
    """A single validator's sync-committee message (sync duty signing; the
    VC-side counterpart of the aggregate above)."""
    from ..ssz.types import Bytes32

    domain = schedule_domain(
        spec,
        spec.domain_sync_committee,
        compute_epoch(message.slot, preset),
        state.genesis_validators_root,
    )
    sd = SigningData(
        object_root=Bytes32.hash_tree_root(bytes(message.beacon_block_root)), domain=domain
    )
    root = SigningData.hash_tree_root(sd)
    return bls.SignatureSet(
        signature=_decode_signature(bls, message.signature),
        signing_keys=[_resolve(pubkey, message.validator_index)],
        message=root,
    )


def sync_selection_proof_signature_set(
    state, slot: int, subcommittee_index: int, aggregator_index: int, proof, bls, pubkey,
    preset: Preset, spec: ChainSpec, types=None,
):
    """signature_sets.rs signed_sync_aggregate_selection_proof_signature_set:
    message is SyncAggregatorSelectionData{slot, subcommittee_index}."""
    domain = schedule_domain(
        spec,
        spec.domain_sync_committee_selection_proof,
        compute_epoch(slot, preset),
        state.genesis_validators_root,
    )
    sd_type = types.SyncAggregatorSelectionData
    obj = sd_type(slot=slot, subcommittee_index=subcommittee_index)
    root = compute_signing_root(obj, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, proof),
        signing_keys=[_resolve(pubkey, aggregator_index)],
        message=root,
    )


def contribution_and_proof_signature_set(state, signed_contribution, bls, pubkey, preset: Preset, spec: ChainSpec):
    msg = signed_contribution.message
    domain = schedule_domain(
        spec,
        spec.domain_contribution_and_proof,
        compute_epoch(msg.contribution.slot, preset),
        state.genesis_validators_root,
    )
    root = compute_signing_root(msg, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, signed_contribution.signature),
        signing_keys=[_resolve(pubkey, msg.aggregator_index)],
        message=root,
    )


def aggregate_and_proof_signature_set(state, signed_aggregate, bls, pubkey, preset: Preset, spec: ChainSpec):
    """signature_sets.rs signed_aggregate_signature_set."""
    msg = signed_aggregate.message
    domain = schedule_domain(
        spec,
        spec.domain_aggregate_and_proof,
        compute_epoch(msg.aggregate.data.slot, preset),
        state.genesis_validators_root,
    )
    root = compute_signing_root(msg, domain)
    return bls.SignatureSet(
        signature=_decode_signature(bls, signed_aggregate.signature),
        signing_keys=[_resolve(pubkey, msg.aggregator_index)],
        message=root,
    )
