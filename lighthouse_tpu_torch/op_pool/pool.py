"""Operation pool: attestations, slashings, exits awaiting block inclusion.

Python rendering of lighthouse/beacon_node/operation_pool/src/lib.rs:
  - insert_attestation aggregates disjoint attestations sharing the same
    AttestationData (lib.rs:118 signature aggregation on insert)
  - get_attestations packs via greedy weighted max-cover over unseen
    attester effective balance (lib.rs:278 + max_cover.rs)
  - slashings / exits are deduped by target validator and filtered for
    continued validity against the target state (get_slashings_and_exits:398)
"""

from __future__ import annotations

from ..state_transition.context import TransitionContext
from ..state_transition.helpers import (
    StateTransitionError,
    get_attesting_indices,
    get_current_epoch,
    get_previous_epoch,
    is_slashable_attestation_data,
    is_slashable_validator,
)
from ..types import FAR_FUTURE_EPOCH
from .max_cover import maximum_cover


class OperationPool:
    def __init__(self, ctx: TransitionContext):
        self.ctx = ctx
        # data_root -> list of {bits, signature(bytes), attestation}
        self.attestations: dict[bytes, list] = {}
        self.proposer_slashings: dict[int, object] = {}  # proposer index -> op
        self.attester_slashings: list = []
        self.voluntary_exits: dict[int, object] = {}  # validator index -> op

    # -- attestations ----------------------------------------------------------

    def insert_attestation(self, attestation) -> None:
        """Aggregate on insert: merge into the first existing aggregate with
        the same data and disjoint bits, else keep separately."""
        t = self.ctx.types
        data_root = t.AttestationData.hash_tree_root(attestation.data)
        bucket = self.attestations.setdefault(data_root, [])
        bits = list(attestation.aggregation_bits)
        for existing in bucket:
            ebits = existing.aggregation_bits
            if len(ebits) == len(bits) and not any(a and b for a, b in zip(ebits, bits)):
                agg = self.ctx.bls.aggregate_signatures(
                    [
                        self.ctx.bls.Signature.from_bytes(bytes(existing.signature)),
                        self.ctx.bls.Signature.from_bytes(bytes(attestation.signature)),
                    ]
                )
                existing.aggregation_bits = [a or b for a, b in zip(ebits, bits)]
                existing.signature = agg.to_bytes()
                return
        bucket.append(
            t.Attestation(
                aggregation_bits=bits,
                data=attestation.data,
                signature=bytes(attestation.signature),
            )
        )

    def get_attestations(self, state) -> list:
        """Pack up to MAX_ATTESTATIONS maximizing fresh attester balance."""
        ctx = self.ctx
        preset, spec = ctx.preset, ctx.spec
        cur = get_current_epoch(state, preset)
        prev = get_previous_epoch(state, preset)

        # Precompute who is already credited, once (C+A, not C*A). Phase0
        # records inclusion per attestation-data (pending lists); altair+
        # records it per validator as participation flags — an attestation is
        # only fresh for validators still missing the target flag
        # (operation_pool's altair scoring, op pool lib.rs get_attestations).
        if ctx.types.fork_of(state) == "phase0":
            ad_root = ctx.types.AttestationData.hash_tree_root
            seen_by_root: dict[bytes, set[int]] = {}
            for epoch_list in (
                state.previous_epoch_attestations,
                state.current_epoch_attestations,
            ):
                for pa in epoch_list:
                    try:
                        seen_by_root.setdefault(ad_root(pa.data), set()).update(
                            get_attesting_indices(
                                state, pa.data, pa.aggregation_bits, preset, spec
                            )
                        )
                    except StateTransitionError:
                        pass

            def seen_for(data_root: bytes, epoch: int) -> set[int]:
                return seen_by_root.get(data_root, set())

        else:
            from ..state_transition.altair import TIMELY_TARGET_FLAG_INDEX, has_flag

            seen_by_epoch = {
                e: {
                    i
                    for i, f in enumerate(participation)
                    if has_flag(f, TIMELY_TARGET_FLAG_INDEX)
                }
                for e, participation in (
                    (prev, state.previous_epoch_participation),
                    (cur, state.current_epoch_participation),
                )
            }

            def seen_for(data_root: bytes, epoch: int) -> set[int]:
                return seen_by_epoch[epoch]

        candidates = []
        for data_root, bucket in self.attestations.items():
            for att in bucket:
                epoch = att.data.target.epoch
                if epoch not in (prev, cur):
                    continue
                if not (
                    att.data.slot + spec.min_attestation_inclusion_delay
                    <= state.slot
                    <= att.data.slot + preset.slots_per_epoch
                ):
                    continue
                src = (
                    state.current_justified_checkpoint
                    if epoch == cur
                    else state.previous_justified_checkpoint
                )
                if att.data.source != src:
                    continue
                try:
                    indices = get_attesting_indices(
                        state, att.data, att.aggregation_bits, preset, spec
                    )
                except StateTransitionError:
                    continue
                seen = seen_for(data_root, epoch)
                fresh = {
                    i: state.validators[i].effective_balance
                    for i in indices
                    if i not in seen
                }
                if fresh:
                    candidates.append((att, fresh))

        cov = dict((id(att), fresh) for att, fresh in candidates)
        return maximum_cover(
            [att for att, _ in candidates],
            covering=lambda a: cov[id(a)],
            limit=preset.max_attestations,
        )

    # -- slashings & exits -----------------------------------------------------

    def insert_proposer_slashing(self, slashing) -> None:
        self.proposer_slashings[slashing.signed_header_1.message.proposer_index] = slashing

    def insert_attester_slashing(self, slashing) -> None:
        t = self.ctx.types
        key = t.AttesterSlashing.hash_tree_root(slashing)
        if all(t.AttesterSlashing.hash_tree_root(s) != key for s in self.attester_slashings):
            self.attester_slashings.append(slashing)

    def insert_voluntary_exit(self, signed_exit) -> None:
        self.voluntary_exits[signed_exit.message.validator_index] = signed_exit

    def get_slashings_and_exits(self, state):
        ctx = self.ctx
        epoch = get_current_epoch(state, ctx.preset)

        proposer = [
            s
            for i, s in self.proposer_slashings.items()
            if i < len(state.validators) and is_slashable_validator(state.validators[i], epoch)
        ][: ctx.preset.max_proposer_slashings]

        to_slash: set[int] = set()
        attester = []
        for s in self.attester_slashings:
            if len(attester) >= ctx.preset.max_attester_slashings:
                break
            if not is_slashable_attestation_data(s.attestation_1.data, s.attestation_2.data):
                continue
            both = set(s.attestation_1.attesting_indices) & set(s.attestation_2.attesting_indices)
            fresh = {
                i
                for i in both
                if i < len(state.validators)
                and is_slashable_validator(state.validators[i], epoch)
                and i not in to_slash
            }
            if fresh:
                attester.append(s)
                to_slash |= fresh

        exits = [
            e
            for i, e in self.voluntary_exits.items()
            if i < len(state.validators)
            and state.validators[i].exit_epoch == FAR_FUTURE_EPOCH
            and state.validators[i].activation_epoch + ctx.spec.shard_committee_period <= epoch
            and e.message.epoch <= epoch
            and i not in to_slash
        ][: ctx.preset.max_voluntary_exits]

        return proposer, attester, exits

    def prune(self, state) -> None:
        """Drop operations no longer includable (lib.rs prune_*)."""
        preset = self.ctx.preset
        cur = get_current_epoch(state, preset)
        keep: dict[bytes, list] = {}
        for root, bucket in self.attestations.items():
            live = [a for a in bucket if a.data.target.epoch + 1 >= cur]
            if live:
                keep[root] = live
        self.attestations = keep
        self.voluntary_exits = {
            i: e
            for i, e in self.voluntary_exits.items()
            if i < len(state.validators) and state.validators[i].exit_epoch == FAR_FUTURE_EPOCH
        }
        self.proposer_slashings = {
            i: s
            for i, s in self.proposer_slashings.items()
            if i < len(state.validators) and is_slashable_validator(state.validators[i], cur)
        }
        self.attester_slashings = [
            s
            for s in self.attester_slashings
            if any(
                i < len(state.validators) and is_slashable_validator(state.validators[i], cur)
                for i in set(s.attestation_1.attesting_indices)
                & set(s.attestation_2.attesting_indices)
            )
        ]
