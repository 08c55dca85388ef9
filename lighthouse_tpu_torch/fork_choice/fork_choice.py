"""Spec fork choice over the proto-array.

Python rendering of lighthouse/consensus/fork_choice/src/fork_choice.rs
(get_head:429, on_block:544, on_attestation:837): checkpoint bookkeeping,
LMD vote tracking, attestation queuing, and delta application around
`ProtoArray`.

Deliberate simplification vs the reference snapshot: the `best_justified`
two-phase justified-checkpoint update (SAFE_SLOTS_TO_UPDATE_JUSTIFIED) is
replaced by the unconditional update the consensus spec itself later
adopted — simpler, equivalent on honest chains, and strictly easier to
reason about. Proposer boost is implemented as in fork_choice.rs
(score = committee_fraction applied to the current-slot block).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..state_transition.context import TransitionContext
from ..state_transition.helpers import (
    get_active_validator_indices,
    get_current_epoch,
)
from ..types import compute_epoch_at_slot, compute_start_slot_at_epoch
from ..types.containers import Checkpoint
from .proto_array import ForkChoiceError, ProtoArray, VoteTracker

ZERO_ROOT = b"\x00" * 32


@dataclass
class QueuedAttestation:
    slot: int
    attesting_indices: list[int]
    block_root: bytes
    target_epoch: int


class ForkChoice:
    """One instance per chain; fed by block import and attestation
    processing; queried for the canonical head."""

    def __init__(self, genesis_block_root: bytes, genesis_state, ctx: TransitionContext):
        self.ctx = ctx
        self.proto = ProtoArray()
        self.votes: list[VoteTracker] = []
        self.balances: list[int] = []  # balances last applied to the array
        self.queued: list[QueuedAttestation] = []
        self.current_slot = int(genesis_state.slot)

        genesis_epoch = get_current_epoch(genesis_state, ctx.preset)
        cp = Checkpoint(epoch=genesis_epoch, root=genesis_block_root)
        self.justified_checkpoint = cp
        self.finalized_checkpoint = cp
        self.justified_balances = self._effective_balances(genesis_state)
        self.proposer_boost_root = ZERO_ROOT
        self._applied_boost: tuple[bytes, int] = (ZERO_ROOT, 0)

        self.proto.on_block(
            slot=int(genesis_state.slot),
            root=genesis_block_root,
            parent_root=None,
            justified_epoch=genesis_epoch,
            finalized_epoch=genesis_epoch,
        )

    # -- helpers ---------------------------------------------------------------

    def _effective_balances(self, state) -> list[int]:
        epoch = get_current_epoch(state, self.ctx.preset)
        active = set(get_active_validator_indices(state, epoch))
        return [
            v.effective_balance if i in active else 0
            for i, v in enumerate(state.validators)
        ]

    def contains_block(self, root: bytes) -> bool:
        return root in self.proto.indices

    def block_slot(self, root: bytes) -> int | None:
        idx = self.proto.indices.get(root)
        return None if idx is None else self.proto.nodes[idx].slot

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        """True iff `descendant_root`'s chain passes through `ancestor_root`
        (proto_array.rs is_descendant — the target-ancestry gossip check)."""
        from .proto_array import NONE

        a = self.proto.indices.get(bytes(ancestor_root))
        d = self.proto.indices.get(bytes(descendant_root))
        if a is None or d is None:
            return False
        a_slot = self.proto.nodes[a].slot
        i = d
        while i != NONE:
            if i == a:
                return True
            node = self.proto.nodes[i]
            if node.slot < a_slot:
                return False
            i = node.parent
        return False

    # -- on_tick (fork_choice.rs on_tick) --------------------------------------

    def on_tick(self, slot: int) -> None:
        if slot > self.current_slot:
            self.current_slot = slot
            self.proposer_boost_root = ZERO_ROOT
        self._process_queued()

    def _process_queued(self) -> None:
        remaining = []
        for qa in self.queued:
            if qa.slot + 1 <= self.current_slot:
                self._apply_attestation(qa)
            else:
                remaining.append(qa)
        self.queued = remaining

    # -- on_block (fork_choice.rs:544) -----------------------------------------

    def on_block(self, block, block_root: bytes, state, execution_status: str = "irrelevant") -> None:
        """Register an imported block. `state` is the post-state of `block`.
        `execution_status` records the EL verdict for bellatrix blocks
        ("valid" / "optimistic" / "irrelevant" for payload-less)."""
        if block.slot > self.current_slot:
            raise ForkChoiceError("block from the future")
        if not self.contains_block(bytes(block.parent_root)):
            raise ForkChoiceError("unknown parent block")

        # checkpoint updates (simplified: newer wins — see module docstring)
        if state.current_justified_checkpoint.epoch > self.justified_checkpoint.epoch:
            self.justified_checkpoint = state.current_justified_checkpoint
            self.justified_balances = self._effective_balances(state)
        if state.finalized_checkpoint.epoch > self.finalized_checkpoint.epoch:
            self.finalized_checkpoint = state.finalized_checkpoint
            if state.current_justified_checkpoint.epoch > self.justified_checkpoint.epoch:
                self.justified_checkpoint = state.current_justified_checkpoint
                self.justified_balances = self._effective_balances(state)

        # proposer boost: first block of the current slot arriving on time
        if block.slot == self.current_slot and self.proposer_boost_root == ZERO_ROOT:
            self.proposer_boost_root = block_root

        known = block_root in self.proto.indices
        self.proto.on_block(
            slot=block.slot,
            root=block_root,
            parent_root=bytes(block.parent_root),
            justified_epoch=state.current_justified_checkpoint.epoch,
            finalized_epoch=state.finalized_checkpoint.epoch,
        )
        idx = self.proto.indices.get(block_root)
        if idx is not None:
            if not known:
                self.proto.nodes[idx].execution_status = execution_status
            # a VALID verdict upgrades (and chain-confirms ancestors); a
            # re-import must never DOWNGRADE a settled verdict — in
            # particular not resurrect an EL-refuted block
            if execution_status == "valid" and self.proto.nodes[idx].execution_status != "invalid":
                self.proto.on_valid_execution_payload(block_root)

    def on_invalid_execution_payload(self, block_root: bytes) -> None:
        """fork_choice.rs:516 on_invalid_execution_payload: the EL refuted a
        previously-optimistic payload — the block and its descendants leave
        the head race."""
        self.proto.on_invalid_execution_payload(block_root)

    def is_optimistic(self, block_root: bytes) -> bool:
        idx = self.proto.indices.get(bytes(block_root))
        return idx is not None and self.proto.nodes[idx].execution_status == "optimistic"

    # -- on_attestation (fork_choice.rs:837) -----------------------------------

    def on_attestation(self, indexed_attestation, is_from_block: bool = False) -> None:
        data = indexed_attestation.data
        target_epoch = data.target.epoch
        block_root = bytes(data.beacon_block_root)

        current_epoch = compute_epoch_at_slot(self.current_slot, self.ctx.preset)
        if not is_from_block:
            if target_epoch > current_epoch:
                raise ForkChoiceError("attestation targets future epoch")
            if target_epoch + 1 < current_epoch:
                return  # too old to matter; drop silently like the ref queue
        if not self.contains_block(block_root):
            raise ForkChoiceError("attestation for unknown block")
        block_slot = self.block_slot(block_root)
        if block_slot is not None and block_slot > data.slot:
            raise ForkChoiceError("attestation for block newer than attestation slot")

        qa = QueuedAttestation(
            slot=data.slot,
            attesting_indices=list(indexed_attestation.attesting_indices),
            block_root=block_root,
            target_epoch=target_epoch,
        )
        if is_from_block or data.slot + 1 <= self.current_slot:
            self._apply_attestation(qa)
        else:
            self.queued.append(qa)

    def _apply_attestation(self, qa: QueuedAttestation) -> None:
        for v_index in qa.attesting_indices:
            while v_index >= len(self.votes):
                self.votes.append(VoteTracker())
            vote = self.votes[v_index]
            if qa.target_epoch > vote.next_epoch or vote.next_root == ZERO_ROOT:
                vote.next_epoch = qa.target_epoch
                vote.next_root = qa.block_root

    # -- get_head (fork_choice.rs:429) -----------------------------------------

    def get_head(self) -> bytes:
        self._process_queued()
        from .proto_array import compute_deltas

        new_balances = list(self.justified_balances)
        deltas = compute_deltas(self.proto.indices, self.votes, self.balances, new_balances)

        # proposer boost (fork_choice.rs compute_proposer_boost): transient —
        # the previous round's boost is backed out before the new one lands.
        prev_root, prev_amount = self._applied_boost
        if prev_amount and prev_root in self.proto.indices:
            deltas[self.proto.indices[prev_root]] -= prev_amount
        self._applied_boost = (ZERO_ROOT, 0)
        if self.proposer_boost_root != ZERO_ROOT:
            idx = self.proto.indices.get(self.proposer_boost_root)
            if idx is not None:
                total = sum(new_balances)
                committee_weight = total // self.ctx.preset.slots_per_epoch
                boost = committee_weight * 40 // 100
                deltas[idx] += boost
                self._applied_boost = (self.proposer_boost_root, boost)

        self.balances = new_balances
        self.proto.apply_score_changes(
            deltas, self.justified_checkpoint.epoch, self.finalized_checkpoint.epoch
        )
        return self.proto.find_head(bytes(self.justified_checkpoint.root))

    def prune(self) -> None:
        self.proto.maybe_prune(bytes(self.finalized_checkpoint.root))
