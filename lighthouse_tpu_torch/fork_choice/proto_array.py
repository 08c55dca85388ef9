"""Proto-array LMD-GHOST.

Python rendering of lighthouse/consensus/proto_array/src/proto_array.rs:
a flat append-only node array where every node stores its best child and
best descendant, so score propagation and head-finding are each a single
linear pass (apply_score_changes: proto_array.rs:142; find_head:
proto_array.rs:577; maybe_prune: proto_array.rs:637). Vote deltas are
computed from per-validator vote trackers exactly as
proto_array_fork_choice.rs:387 compute_deltas.

The structure-of-arrays layout (parallel lists of ints) is deliberate: it
keeps the hot passes allocation-free and is the same flat shape a future
device-side batch scoring pass would consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ForkChoiceError(Exception):
    pass


NONE = -1  # sentinel index (Rust's Option<usize>)


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int  # index or NONE
    justified_epoch: int
    finalized_epoch: int
    weight: int = 0
    best_child: int = NONE
    best_descendant: int = NONE
    # execution-payload verdict (proto_array.rs ExecutionStatus):
    #   "irrelevant" pre-merge, "valid" EL-confirmed, "optimistic" imported
    #   while the EL was syncing, "invalid" EL-refuted (never head-viable)
    execution_status: str = "irrelevant"


@dataclass
class VoteTracker:
    """proto_array_fork_choice.rs VoteTracker: one per validator."""

    current_root: bytes = b"\x00" * 32
    next_root: bytes = b"\x00" * 32
    next_epoch: int = 0


class ProtoArray:
    def __init__(self, prune_threshold: int = 256):
        self.prune_threshold = prune_threshold
        self.justified_epoch = 0
        self.finalized_epoch = 0
        self.nodes: list[ProtoNode] = []
        self.indices: dict[bytes, int] = {}

    # -- insertion (proto_array.rs on_block) ----------------------------------

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        justified_epoch: int,
        finalized_epoch: int,
    ) -> None:
        if root in self.indices:
            return
        node_index = len(self.nodes)
        parent = self.indices.get(parent_root, NONE) if parent_root is not None else NONE
        node = ProtoNode(
            slot=slot,
            root=root,
            parent=parent,
            justified_epoch=justified_epoch,
            finalized_epoch=finalized_epoch,
        )
        self.indices[root] = node_index
        self.nodes.append(node)
        if parent != NONE:
            self._maybe_update_best_child_and_descendant(parent, node_index)

    # -- score propagation (proto_array.rs:142) --------------------------------

    def apply_score_changes(
        self, deltas: list[int], justified_epoch: int, finalized_epoch: int
    ) -> None:
        if len(deltas) != len(self.nodes):
            raise ForkChoiceError("deltas length != node count")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        # Back-to-front: each node accumulates its delta, pushes it to its
        # parent's delta, then refreshes the parent's best pointers.
        for node_index in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[node_index]
            delta = deltas[node_index]
            node.weight += delta
            if node.weight < 0:
                raise ForkChoiceError("negative node weight")
            if node.parent != NONE:
                deltas[node.parent] += delta
                self._maybe_update_best_child_and_descendant(node.parent, node_index)

    # -- head finding (proto_array.rs:577) -------------------------------------

    def find_head(self, justified_root: bytes) -> bytes:
        justified_index = self.indices.get(justified_root)
        if justified_index is None:
            raise ForkChoiceError("unknown justified root")
        justified_node = self.nodes[justified_index]
        best_descendant_index = (
            justified_node.best_descendant
            if justified_node.best_descendant != NONE
            else justified_index
        )
        best_node = self.nodes[best_descendant_index]
        if not self._node_is_viable_for_head(best_node):
            raise ForkChoiceError(
                "best node is not viable for head "
                f"(justified {best_node.justified_epoch}/{self.justified_epoch}, "
                f"finalized {best_node.finalized_epoch}/{self.finalized_epoch})"
            )
        return best_node.root

    # -- pruning (proto_array.rs:637) ------------------------------------------

    def maybe_prune(self, finalized_root: bytes) -> None:
        finalized_index = self.indices.get(finalized_root)
        if finalized_index is None:
            raise ForkChoiceError("unknown finalized root")
        if finalized_index < self.prune_threshold:
            return
        # Drop every node before the finalized one; remap indices.
        self.nodes = self.nodes[finalized_index:]
        self.indices = {node.root: i for i, node in enumerate(self.nodes)}
        for node in self.nodes:
            node.parent = node.parent - finalized_index if node.parent >= finalized_index else NONE
            if node.best_child != NONE:
                node.best_child -= finalized_index
            if node.best_descendant != NONE:
                node.best_descendant -= finalized_index

    # -- internals -------------------------------------------------------------

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """proto_array.rs node_is_viable_for_head: filter_block_tree's
        condition — the node must agree with the store's checkpoints, and an
        EL-refuted payload disqualifies the block outright."""
        if node.execution_status == "invalid":
            return False
        return (
            node.justified_epoch == self.justified_epoch or self.justified_epoch == 0
        ) and (node.finalized_epoch == self.finalized_epoch or self.finalized_epoch == 0)

    # -- execution-status propagation (proto_array.rs propagate_execution_*) ---

    def on_invalid_execution_payload(self, root: bytes) -> None:
        """Mark `root` and every descendant invalid (the INVALID response to
        a previously-optimistic import), then recompute best children so
        find_head routes around the poisoned subtree."""
        start = self.indices.get(bytes(root))
        if start is None:
            raise ForkChoiceError("unknown block for payload invalidation")
        invalid = {start}
        for i, node in enumerate(self.nodes):
            if node.parent in invalid:
                invalid.add(i)
        if any(self.nodes[i].execution_status == "valid" for i in invalid):
            # the reference aborts here too
            # (ValidExecutionStatusBecameInvalid): a confirmed payload
            # cannot become invalid without a consensus failure
            raise ForkChoiceError("INVALID verdict contradicts earlier VALID")
        for i in invalid:
            # status only — weights stay: the vote-delta machinery drains
            # them naturally, and zeroing would break the delta invariant
            # (apply_score_changes raises on negative weights)
            self.nodes[i].execution_status = "invalid"
        # rebuild best pointers leaf-to-root (same order apply_score_changes
        # uses) so viability filtering applies everywhere
        for node in self.nodes:
            node.best_child = NONE
            node.best_descendant = NONE
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent != NONE:
                self._maybe_update_best_child_and_descendant(node.parent, i)

    def on_valid_execution_payload(self, root: bytes) -> None:
        """An EL VALID verdict confirms the block AND its ancestors
        (payload validity is chained): the node itself flips from
        optimistic, then optimistic ancestors flip until the first settled
        (valid/irrelevant) one."""
        i = self.indices.get(bytes(root))
        if i is None:
            raise ForkChoiceError("unknown block for payload validation")
        node = self.nodes[i]
        if node.execution_status == "invalid":
            raise ForkChoiceError("VALID verdict contradicts earlier INVALID")
        if node.execution_status == "optimistic":
            node.execution_status = "valid"
        i = node.parent
        while i != NONE:
            node = self.nodes[i]
            if node.execution_status == "invalid":
                raise ForkChoiceError("VALID verdict contradicts earlier INVALID")
            if node.execution_status != "optimistic":
                break  # settled: everything above is too
            node.execution_status = "valid"
            i = node.parent

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant != NONE:
            return self._node_is_viable_for_head(self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    def _maybe_update_best_child_and_descendant(self, parent_index: int, child_index: int) -> None:
        """proto_array.rs:~400 maybe_update_best_child_and_descendant."""
        child = self.nodes[child_index]
        parent = self.nodes[parent_index]
        child_leads_to_viable_head = self._node_leads_to_viable_head(child)

        def make_child_best():
            parent.best_child = child_index
            parent.best_descendant = (
                child.best_descendant if child.best_descendant != NONE else child_index
            )

        if parent.best_child == NONE:
            if child_leads_to_viable_head:
                make_child_best()
            return
        if parent.best_child == child_index:
            if not child_leads_to_viable_head:
                # child became non-viable: search remaining children
                self._recompute_best_child(parent_index)
            else:
                make_child_best()  # refresh best_descendant
            return
        best = self.nodes[parent.best_child]
        best_viable = self._node_leads_to_viable_head(best)
        if child_leads_to_viable_head and not best_viable:
            make_child_best()
        elif child_leads_to_viable_head and (
            child.weight > best.weight
            or (child.weight == best.weight and child.root >= best.root)
        ):
            # weight tie broken by root order (proto_array.rs tie-break)
            make_child_best()

    def _recompute_best_child(self, parent_index: int) -> None:
        parent = self.nodes[parent_index]
        parent.best_child = NONE
        parent.best_descendant = NONE
        for idx in range(parent_index + 1, len(self.nodes)):
            node = self.nodes[idx]
            if node.parent != parent_index:
                continue
            self._maybe_update_best_child_and_descendant(parent_index, idx)


def compute_deltas(
    indices: dict[bytes, int],
    votes: list[VoteTracker],
    old_balances: list[int],
    new_balances: list[int],
) -> list[int]:
    """proto_array_fork_choice.rs:387 compute_deltas: move each validator's
    weight from its current vote to its next vote. Mutates votes (current
    becomes next)."""
    deltas = [0] * len(indices)
    for v_index, vote in enumerate(votes):
        if vote.current_root == b"\x00" * 32 and vote.next_root == b"\x00" * 32:
            continue
        old_balance = old_balances[v_index] if v_index < len(old_balances) else 0
        new_balance = new_balances[v_index] if v_index < len(new_balances) else 0
        if vote.current_root != vote.next_root or old_balance != new_balance:
            cur = indices.get(vote.current_root)
            if cur is not None:
                deltas[cur] -= old_balance
            nxt = indices.get(vote.next_root)
            if nxt is not None:
                deltas[nxt] += new_balance
            vote.current_root = vote.next_root
    return deltas
