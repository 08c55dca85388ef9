"""State-transition conformance: operations / sanity runners, ef_tests-shaped.

Mirrors the structure of lighthouse/testing/ef_tests/src/cases/
{operations.rs, sanity_blocks.rs, sanity_slots.rs}: each case carries a
pre-state, an input object (operation / block / slot count), and either an
expected post-state root or the expectation that processing FAILS — the
"post is None" convention of the official vectors. Cases run across the
fork matrix (phase0 + altair) under the `fake` BLS backend (the vectors
carry unsignable fixtures, exactly why the reference runs its
state-transition handlers under fake_crypto, Makefile:98-103); the
cryptographic per-backend accept/reject matrix lives in bls_cases.py.

The official consensus-spec-tests archive is unavailable offline, so
vectors are generated by the harness itself: each generator builds a
scenario, runs it once to capture the post-state root, and the runner then
re-executes from serialized bytes — ensuring SSZ round-trips, fork-aware
decoding, and processing agree end to end.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

OPERATION_HANDLERS = (
    "attestation",
    "voluntary_exit",
    "proposer_slashing",
    "attester_slashing",
    "deposit",
    "block_header",
    "sync_aggregate",
)

FORK_MATRIX = ("phase0", "altair", "bellatrix")


@dataclass
class TransitionCase:
    runner: str  # "operations" | "sanity_blocks" | "sanity_slots"
    handler: str  # operation name, or "blocks"/"slots"
    fork: str  # "phase0" | "altair"
    name: str
    pre_ssz: bytes
    input_ssz: bytes | int  # operation/block bytes, or slot count
    post_root: bytes | None  # None = processing must raise


def _ctx(fork: str):
    from ..crypto import bls as bls_pkg
    from ..state_transition import TransitionContext
    from ..types import MINIMAL_SPEC
    from ..types.containers import minimal_types

    spec = MINIMAL_SPEC
    if fork == "altair":
        spec = dataclasses.replace(spec, altair_fork_epoch=0)
    elif fork == "bellatrix":
        spec = dataclasses.replace(spec, altair_fork_epoch=0, bellatrix_fork_epoch=0)
    return TransitionContext(minimal_types(), spec, bls_pkg.backend("fake"))


def _harness(fork: str, n: int = 16):
    from ..chain.harness import BeaconChainHarness

    return BeaconChainHarness(n, _ctx(fork))


def _state_bytes(state) -> bytes:
    return type(state).serialize(state)


def _root(state) -> bytes:
    return type(state).hash_tree_root(state)


def generate_transition_cases() -> list:
    """Deterministic vector set across the fork matrix."""
    from ..state_transition import process_slots
    from ..state_transition.per_block import process_attestation, process_voluntary_exit
    from ..types import compute_start_slot_at_epoch

    cases: list[TransitionCase] = []
    for fork in FORK_MATRIX:
        ctx = _ctx(fork)
        t = ctx.types
        h = _harness(fork)
        spe = ctx.preset.slots_per_epoch
        h.extend_chain(spe + 2)
        state = h.chain.head_state().copy()
        pre = _state_bytes(state)

        # -- sanity_slots: advance N empty slots --------------------------------
        for n_slots in (1, spe):
            s2 = state.copy()
            process_slots(s2, s2.slot + n_slots, ctx)
            cases.append(
                TransitionCase(
                    "sanity_slots", "slots", fork, f"advance_{n_slots}", pre, n_slots, _root(s2)
                )
            )

        # -- operations: attestation -------------------------------------------
        atts = h.attestations_for_slot(state, h.chain.head_root, int(state.slot))
        att = atts[0]
        s2 = state.copy()
        s2.slot = int(s2.slot) + 1  # satisfy min inclusion delay
        pre_att = _state_bytes(s2)
        s3 = s2.copy()
        if fork == "phase0":
            process_attestation(s3, att, ctx, verify=False)
        else:
            from ..state_transition.altair import process_attestation_altair

            process_attestation_altair(s3, att, ctx, verify=False)
        cases.append(
            TransitionCase(
                "operations", "attestation", fork, "valid",
                pre_att, t.Attestation.serialize(att), _root(s3),
            )
        )
        # invalid: source checkpoint mutated
        bad = t.Attestation.deserialize(t.Attestation.serialize(att))
        bad.data.source = t.Checkpoint(epoch=99, root=b"\x13" * 32)
        cases.append(
            TransitionCase(
                "operations", "attestation", fork, "wrong_source",
                pre_att, t.Attestation.serialize(bad), None,
            )
        )

        # -- operations: voluntary exit ----------------------------------------
        # age the chain past shard_committee_period so exits are admissible
        aged = state.copy()
        target_epoch = ctx.spec.shard_committee_period + 2
        process_slots(aged, compute_start_slot_at_epoch(target_epoch, ctx.preset), ctx)
        pre_exit = _state_bytes(aged)
        exit_msg = t.SignedVoluntaryExit(
            message=t.VoluntaryExit(epoch=target_epoch - 1, validator_index=3),
            signature=b"\x00" * 96,
        )
        s4 = aged.copy()
        process_voluntary_exit(s4, exit_msg, ctx, verify=False)
        cases.append(
            TransitionCase(
                "operations", "voluntary_exit", fork, "valid",
                pre_exit, t.SignedVoluntaryExit.serialize(exit_msg), _root(s4),
            )
        )
        bad_exit = t.SignedVoluntaryExit(
            message=t.VoluntaryExit(epoch=0, validator_index=10**6),
            signature=b"\x00" * 96,
        )
        cases.append(
            TransitionCase(
                "operations", "voluntary_exit", fork, "unknown_validator",
                pre_exit, t.SignedVoluntaryExit.serialize(bad_exit), None,
            )
        )

        # -- operations: proposer slashing --------------------------------------
        from ..state_transition.per_block import process_proposer_slashing
        from ..types.containers import BeaconBlockHeader

        def header(slot, proposer, body_root):
            return t.SignedBeaconBlockHeader(
                message=BeaconBlockHeader(
                    slot=slot,
                    proposer_index=proposer,
                    parent_root=b"\x01" * 32,
                    state_root=b"\x02" * 32,
                    body_root=body_root,
                ),
                signature=b"\x00" * 96,
            )

        ps_slot = int(state.slot)
        slashing = t.ProposerSlashing(
            signed_header_1=header(ps_slot, 5, b"\x0a" * 32),
            signed_header_2=header(ps_slot, 5, b"\x0b" * 32),
        )
        s_ps = state.copy()
        process_proposer_slashing(s_ps, slashing, ctx, verify=False)
        cases.append(
            TransitionCase(
                "operations", "proposer_slashing", fork, "valid",
                pre, t.ProposerSlashing.serialize(slashing), _root(s_ps),
            )
        )
        bad_ps = t.ProposerSlashing(
            signed_header_1=header(ps_slot, 5, b"\x0a" * 32),
            signed_header_2=header(ps_slot, 6, b"\x0b" * 32),  # different proposer
        )
        cases.append(
            TransitionCase(
                "operations", "proposer_slashing", fork, "different_proposers",
                pre, t.ProposerSlashing.serialize(bad_ps), None,
            )
        )

        # -- operations: attester slashing (double vote) ------------------------
        from ..state_transition.per_block import process_attester_slashing

        cp = t.Checkpoint
        data1 = t.AttestationData(
            slot=int(state.slot) - 1, index=0,
            beacon_block_root=b"\x0c" * 32,
            source=state.current_justified_checkpoint,
            target=cp(epoch=int(state.slot) // spe, root=b"\x0d" * 32),
        )
        data2 = t.AttestationData(
            slot=int(state.slot) - 1, index=0,
            beacon_block_root=b"\x0e" * 32,  # double vote: same target epoch
            source=state.current_justified_checkpoint,
            target=cp(epoch=int(state.slot) // spe, root=b"\x0f" * 32),
        )
        asl = t.AttesterSlashing(
            attestation_1=t.IndexedAttestation(
                attesting_indices=[1, 2, 3], data=data1, signature=b"\x00" * 96
            ),
            attestation_2=t.IndexedAttestation(
                attesting_indices=[2, 3, 4], data=data2, signature=b"\x00" * 96
            ),
        )
        s_as = state.copy()
        process_attester_slashing(s_as, asl, ctx, verify=False)
        cases.append(
            TransitionCase(
                "operations", "attester_slashing", fork, "double_vote",
                pre, t.AttesterSlashing.serialize(asl), _root(s_as),
            )
        )
        not_slashable = t.AttesterSlashing(
            attestation_1=asl.attestation_1,
            attestation_2=asl.attestation_1,  # identical data: not slashable
        )
        cases.append(
            TransitionCase(
                "operations", "attester_slashing", fork, "same_data",
                pre, t.AttesterSlashing.serialize(not_slashable), None,
            )
        )

        # -- operations: deposit -------------------------------------------------
        from ..ssz.merkle_proof import MerkleTree, deposit_root, deposit_tree_proof
        from ..state_transition.per_block import process_deposit
        from ..types import DEPOSIT_CONTRACT_TREE_DEPTH
        from ..types.containers import DepositData, Eth1Data

        dep_data = DepositData(
            pubkey=b"\x31" * 48,
            withdrawal_credentials=b"\x00" + b"\x32" * 31,
            amount=ctx.spec.max_effective_balance,
            signature=b"\x33" * 96,
        )
        leaf = DepositData.hash_tree_root(dep_data)
        tree = MerkleTree([leaf], DEPOSIT_CONTRACT_TREE_DEPTH)
        s_dep_pre = state.copy()
        s_dep_pre.eth1_data = Eth1Data(
            deposit_root=deposit_root(tree, 1), deposit_count=1, block_hash=b"\x00" * 32
        )
        s_dep_pre.eth1_deposit_index = 0
        deposit = t.Deposit(proof=deposit_tree_proof(tree, 0, 1), data=dep_data)
        s_dep = s_dep_pre.copy()
        process_deposit(s_dep, deposit, ctx)
        assert len(s_dep.validators) == len(state.validators) + 1
        cases.append(
            TransitionCase(
                "operations", "deposit", fork, "new_validator",
                _state_bytes(s_dep_pre), t.Deposit.serialize(deposit), _root(s_dep),
            )
        )
        bad_dep = t.Deposit(proof=[b"\x00" * 32] * len(deposit.proof), data=dep_data)
        cases.append(
            TransitionCase(
                "operations", "deposit", fork, "bad_merkle_proof",
                _state_bytes(s_dep_pre), t.Deposit.serialize(bad_dep), None,
            )
        )

        # -- operations: block_header -------------------------------------------
        from ..state_transition.helpers import get_beacon_proposer_index as _gpi

        from ..state_transition.per_block import process_block_header

        s_bh_pre = state.copy()
        process_slots(s_bh_pre, int(s_bh_pre.slot) + 1, ctx)
        bh_proposer = _gpi(s_bh_pre, ctx.preset, ctx.spec)
        ft_bh = t.for_fork(fork)
        # produce_block_on_state on a copy yields a block whose slot,
        # proposer and parent_root are exactly right for s_bh_pre
        bh_block, _ = h.chain.produce_block_on_state(
            s_bh_pre.copy(), int(s_bh_pre.slot), randao_reveal=b"\x00" * 96
        )
        s_bh = s_bh_pre.copy()
        process_block_header(s_bh, bh_block, ctx)
        cases.append(
            TransitionCase(
                "operations", "block_header", fork, "valid",
                _state_bytes(s_bh_pre), ft_bh.BeaconBlock.serialize(bh_block), _root(s_bh),
            )
        )
        wrong = ft_bh.BeaconBlock.deserialize(ft_bh.BeaconBlock.serialize(bh_block))
        wrong.proposer_index = (bh_proposer + 1) % len(s_bh_pre.validators)
        cases.append(
            TransitionCase(
                "operations", "block_header", fork, "wrong_proposer",
                _state_bytes(s_bh_pre), ft_bh.BeaconBlock.serialize(wrong), None,
            )
        )

        # -- operations: sync aggregate (altair+) -------------------------------
        if fork != "phase0":
            from ..chain.beacon_chain import empty_sync_aggregate
            from ..state_transition.altair import process_sync_aggregate

            s5 = state.copy()
            agg = empty_sync_aggregate(t)
            s6 = s5.copy()
            process_sync_aggregate(s6, agg, ctx, verify=True)
            cases.append(
                TransitionCase(
                    "operations", "sync_aggregate", fork, "empty_valid",
                    _state_bytes(s5), t.SyncAggregate.serialize(agg), _root(s6),
                )
            )
            bad_agg = t.SyncAggregate(
                sync_committee_bits=[False] * ctx.preset.sync_committee_size,
                sync_committee_signature=b"\x11" * 96,  # not infinity, no signers
            )
            cases.append(
                TransitionCase(
                    "operations", "sync_aggregate", fork, "no_signers_bad_sig",
                    _state_bytes(s5), t.SyncAggregate.serialize(bad_agg), None,
                )
            )

        # -- sanity_blocks: one full block via the harness ----------------------
        head_pre = h.chain.head_state().copy()
        slot = int(head_pre.slot) + 1
        from ..state_transition.helpers import get_beacon_proposer_index

        adv = head_pre.copy()
        process_slots(adv, slot, ctx)
        proposer = get_beacon_proposer_index(adv, ctx.preset, ctx.spec)
        reveal = h.randao_reveal(head_pre, proposer, slot)
        block, post = h.chain.produce_block_on_state(
            head_pre.copy(), slot, reveal,
            sync_aggregate=h.sync_aggregate_for_parent(adv, slot) if fork != "phase0" else None,
        )
        signed = h.chain.sign_block(block, h._sk_for(proposer))
        ft = t.for_fork(fork)
        cases.append(
            TransitionCase(
                "sanity_blocks", "blocks", fork, "one_block",
                _state_bytes(head_pre), ft.SignedBeaconBlock.serialize(signed), _root(post),
            )
        )
        # wrong state root must fail
        tampered = ft.SignedBeaconBlock.deserialize(ft.SignedBeaconBlock.serialize(signed))
        tampered.message.state_root = b"\x77" * 32
        cases.append(
            TransitionCase(
                "sanity_blocks", "blocks", fork, "bad_state_root",
                _state_bytes(head_pre), ft.SignedBeaconBlock.serialize(tampered), None,
            )
        )
    return cases


def run_transition_case(case: TransitionCase) -> None:
    """Execute one case from serialized bytes; raises AssertionError on any
    divergence from the recorded expectation (handler.rs Case::result)."""
    from ..state_transition import StateTransitionError, process_slots, state_transition
    from ..types import decode_beacon_state, decode_signed_block

    ctx = _ctx(case.fork)
    t = ctx.types
    state = decode_beacon_state(case.pre_ssz, t, ctx.spec)

    def expect(fn) -> None:
        if case.post_root is None:
            try:
                fn()
            except StateTransitionError:
                return
            raise AssertionError(f"{case.runner}/{case.name}: expected failure, succeeded")
        fn()
        got = _root(state)
        assert got == case.post_root, f"{case.runner}/{case.name}: post-state root mismatch"

    if case.runner == "sanity_slots":
        expect(lambda: process_slots(state, int(state.slot) + case.input_ssz, ctx))
    elif case.runner == "sanity_blocks":
        signed = decode_signed_block(case.input_ssz, t, ctx.spec, ctx.preset)
        from ..state_transition import BlockSignatureStrategy

        expect(
            lambda: state_transition(
                state, signed, ctx, strategy=BlockSignatureStrategy.NO_VERIFICATION
            )
        )
    elif case.runner == "operations":
        if case.handler == "attestation":
            att = t.Attestation.deserialize(case.input_ssz)
            if case.fork == "phase0":
                from ..state_transition.per_block import process_attestation as fn
            else:
                from ..state_transition.altair import process_attestation_altair as fn
            expect(lambda: fn(state, att, ctx, False))
        elif case.handler == "voluntary_exit":
            ex = t.SignedVoluntaryExit.deserialize(case.input_ssz)
            from ..state_transition.per_block import process_voluntary_exit

            expect(lambda: process_voluntary_exit(state, ex, ctx, False))
        elif case.handler == "proposer_slashing":
            ps = t.ProposerSlashing.deserialize(case.input_ssz)
            from ..state_transition.per_block import process_proposer_slashing

            expect(lambda: process_proposer_slashing(state, ps, ctx, False))
        elif case.handler == "attester_slashing":
            asl = t.AttesterSlashing.deserialize(case.input_ssz)
            from ..state_transition.per_block import process_attester_slashing

            expect(lambda: process_attester_slashing(state, asl, ctx, False))
        elif case.handler == "deposit":
            dep = t.Deposit.deserialize(case.input_ssz)
            from ..state_transition.per_block import process_deposit

            expect(lambda: process_deposit(state, dep, ctx))
        elif case.handler == "block_header":
            blk = t.for_fork(case.fork).BeaconBlock.deserialize(case.input_ssz)
            from ..state_transition.per_block import process_block_header

            expect(lambda: process_block_header(state, blk, ctx))
        elif case.handler == "sync_aggregate":
            agg = t.SyncAggregate.deserialize(case.input_ssz)
            from ..state_transition.altair import process_sync_aggregate

            expect(lambda: process_sync_aggregate(state, agg, ctx, True))
        else:
            raise AssertionError(f"unknown handler {case.handler}")
    else:
        raise AssertionError(f"unknown runner {case.runner}")
