"""In-process chain harness: deterministic validators driving a BeaconChain.

Python rendering of lighthouse/beacon_node/beacon_chain/src/
test_utils.rs:66-105 (BeaconChainHarness): interop keypairs, a manual slot
clock, block production + all-validator attestation, chain extension until
justification/finality. Used by tests and by the multi-node simulator-style
checks; with the torch backend it is also a workload generator for the
card's batch verifier.
"""

from __future__ import annotations

from ..ssz.types import uint64
from ..state_transition import BlockSignatureStrategy, TransitionContext, interop_genesis_state
from ..state_transition.helpers import (
    get_beacon_committee,
    get_committee_count_per_slot,
    get_current_epoch,
)
from ..types import (
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_domain,
)
from ..types.containers import Checkpoint, SigningData
from .beacon_chain import BeaconChain
from .slot_clock import ManualSlotClock


class BeaconChainHarness:
    def __init__(self, n_validators: int, ctx: TransitionContext, genesis_time: int = 1600000000):
        self.ctx = ctx
        self.keypairs = [ctx.bls.interop_keypair(i) for i in range(n_validators)]
        genesis = interop_genesis_state(n_validators, genesis_time, ctx)
        self.chain = BeaconChain(genesis, ctx, slot_clock=ManualSlotClock())

    @classmethod
    def for_chain(cls, chain: BeaconChain, n_validators: int) -> "BeaconChainHarness":
        """Wrap an EXISTING chain (e.g. one a Client built) so tests can
        drive it with interop validators."""
        h = cls.__new__(cls)
        h.ctx = chain.ctx
        h.keypairs = [chain.ctx.bls.interop_keypair(i) for i in range(n_validators)]
        h.chain = chain
        return h

    # -- signing helpers -------------------------------------------------------

    def _sk_for(self, validator_index: int):
        return self.keypairs[validator_index][0]

    def randao_reveal(self, state, proposer_index: int, slot: int) -> bytes:
        epoch = compute_epoch_at_slot(slot, self.ctx.preset)
        domain = get_domain(state, self.ctx.spec.domain_randao, epoch, self.ctx.preset)
        sd = SigningData(object_root=uint64.hash_tree_root(epoch), domain=domain)
        root = SigningData.hash_tree_root(sd)
        return self._sk_for(proposer_index).sign(root).to_bytes()

    # -- attestations (test_utils.rs make_attestations) ------------------------

    def attestations_for_slot(self, state, head_root: bytes, slot: int):
        """One fully-aggregated attestation per committee of `slot`, signed by
        every committee member, attesting to `head_root`."""
        ctx = self.ctx
        preset, spec = ctx.preset, ctx.spec
        epoch = compute_epoch_at_slot(slot, preset)
        start_slot = compute_start_slot_at_epoch(epoch, preset)
        if start_slot == slot or state.slot <= start_slot:
            target_root = head_root
        else:
            target_root = state.block_roots[start_slot % preset.slots_per_historical_root]

        data_by_index = {}
        n_committees = get_committee_count_per_slot(state, epoch, preset)
        for index in range(n_committees):
            committee = get_beacon_committee(state, slot, index, preset, spec)
            if not committee:
                continue
            data = ctx.types.AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=target_root),
            )
            domain = get_domain(state, spec.domain_beacon_attester, epoch, preset)
            root = compute_signing_root(data, domain)
            sigs = [self._sk_for(v).sign(root) for v in committee]
            att = ctx.types.Attestation(
                aggregation_bits=[True] * len(committee),
                data=data,
                signature=ctx.bls.aggregate_signatures(sigs).to_bytes(),
            )
            data_by_index[index] = att
        return list(data_by_index.values())

    # -- sync committee (altair+) ----------------------------------------------

    def sync_aggregate_for_parent(self, state, slot: int):
        """Full-participation SyncAggregate over the parent block root (the
        message the committee owes in the block at `slot`,
        altair/sync_committee.rs process_sync_aggregate). Returns None on
        phase0 states."""
        t, preset, spec = self.ctx.types, self.ctx.preset, self.ctx.spec
        if t.fork_of(state) == "phase0":
            return None
        from ..ssz.types import Bytes32
        from ..types.containers import BeaconBlockHeader

        prev_slot = max(slot, 1) - 1
        parent_root = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
        domain = get_domain(
            state, spec.domain_sync_committee, prev_slot // preset.slots_per_epoch, preset
        )
        sd = SigningData(object_root=Bytes32.hash_tree_root(parent_root), domain=domain)
        root = SigningData.hash_tree_root(sd)
        pk_to_vi = {
            self.keypairs[i][1].to_bytes(): i for i in range(len(self.keypairs))
        }
        bits, sigs = [], []
        for pkb in state.current_sync_committee.pubkeys:
            vi = pk_to_vi.get(bytes(pkb))
            if vi is None:
                bits.append(False)
            else:
                bits.append(True)
                sigs.append(self._sk_for(vi).sign(root))
        from .beacon_chain import empty_sync_aggregate

        if not sigs:
            return empty_sync_aggregate(t)
        return t.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=self.ctx.bls.aggregate_signatures(sigs).to_bytes(),
        )

    # -- chain building --------------------------------------------------------

    def add_block_at_slot(
        self,
        slot: int,
        attestations=(),
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ):
        """Produce, sign, and import a block at `slot` on the current head."""
        chain = self.chain
        chain.slot_clock.set_slot(slot)
        state = chain.state_at_slot(slot)
        from ..state_transition.helpers import get_beacon_proposer_index

        proposer = get_beacon_proposer_index(state, self.ctx.preset, self.ctx.spec)
        reveal = self.randao_reveal(state, proposer, slot)
        block, _post = chain.produce_block_on_state(
            state,
            slot,
            reveal,
            attestations=attestations,
            sync_aggregate=self.sync_aggregate_for_parent(state, slot),
        )
        signed = chain.sign_block(block, self._sk_for(proposer))
        root = chain.process_block(signed, strategy=strategy)
        return root, signed

    def extend_chain(
        self,
        num_slots: int,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ) -> bytes:
        """Advance `num_slots`, one block per slot, all validators attesting
        every slot (test_utils.rs extend_chain + AttestationStrategy::AllValidators).

        Attestations made at slot s are packed into the block at s+1
        (min inclusion delay 1)."""
        chain = self.chain
        pending = []
        head_root = chain.head_root
        start = chain.head_state().slot + 1
        for slot in range(start, start + num_slots):
            head_root, _ = self.add_block_at_slot(slot, attestations=pending, strategy=strategy)
            # attest to the new head at its own slot; include next slot
            state = chain.store.get_state(head_root)
            pending = self.attestations_for_slot(state, head_root, slot)
        return head_root

    # -- queries ----------------------------------------------------------------

    def finalized_epoch(self) -> int:
        return self.chain.head_state().finalized_checkpoint.epoch

    def justified_epoch(self) -> int:
        return self.chain.head_state().current_justified_checkpoint.epoch
