"""Merkle trees with proof generation/verification.

Counterpart of lighthouse/consensus/merkle_proof (MerkleTree): the
sparse deposit-contract tree (fixed depth, zero-hash padding), proof
generation for any leaf, and branch verification — the proof side of
state_transition.per_block.process_deposit.
"""

from __future__ import annotations

import hashlib

from .hash import ZERO_HASHES


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


class MerkleTree:
    """Fixed-depth sparse binary tree over 32-byte leaves."""

    def __init__(self, leaves: list[bytes], depth: int):
        if len(leaves) > (1 << depth):
            raise ValueError("too many leaves for depth")
        self.depth = depth
        self.leaves = [bytes(l) for l in leaves]
        # levels[0] = leaves padded implicitly with zero-hashes
        self._levels: list[list[bytes]] = [list(self.leaves)]
        for d in range(depth):
            prev = self._levels[d]
            nxt = []
            for i in range(0, (len(prev) + 1) // 2):
                left = prev[2 * i]
                right = prev[2 * i + 1] if 2 * i + 1 < len(prev) else ZERO_HASHES[d]
                nxt.append(_h(left, right))
            if not nxt:
                nxt = [ZERO_HASHES[d + 1]]
            self._levels.append(nxt)

    @property
    def root(self) -> bytes:
        # top level has one real node, or pure zero-tree
        top = self._levels[self.depth]
        return top[0] if top else ZERO_HASHES[self.depth]

    def proof(self, index: int) -> list[bytes]:
        """Sibling path (bottom-up) for the leaf at `index`."""
        if not 0 <= index < (1 << self.depth):
            raise IndexError("leaf index out of range")
        path = []
        for d in range(self.depth):
            sibling_index = (index >> d) ^ 1
            level = self._levels[d]
            path.append(level[sibling_index] if sibling_index < len(level) else ZERO_HASHES[d])
        return path

    def push(self, leaf: bytes) -> None:
        """Append a leaf (deposit-tree style), updating only the O(depth)
        branch path — the canonical incremental deposit-tree insert."""
        index = len(self.leaves)
        if index >= (1 << self.depth):
            raise ValueError("tree is full")
        self.leaves.append(bytes(leaf))
        node = bytes(leaf)
        for d in range(self.depth):
            level = self._levels[d]
            if index < len(level):
                level[index] = node
            else:
                level.append(node)
            sibling_index = index ^ 1
            if index & 1:
                sibling = level[sibling_index]
                node = _h(sibling, node)
            else:
                sibling = level[sibling_index] if sibling_index < len(level) else ZERO_HASHES[d]
                node = _h(node, sibling)
            index >>= 1
        top = self._levels[self.depth]
        if index < len(top):
            top[index] = node
        else:
            top.append(node)


def verify_merkle_proof(leaf: bytes, proof: list[bytes], depth: int, index: int, root: bytes) -> bool:
    value = bytes(leaf)
    for i in range(depth):
        sibling = bytes(proof[i])
        if (index >> i) & 1:
            value = _h(sibling, value)
        else:
            value = _h(value, sibling)
    return value == bytes(root)


def deposit_tree_proof(tree: MerkleTree, index: int, deposit_count: int) -> list[bytes]:
    """Deposit-contract proof: the tree branch plus the mixed-in length leaf
    (depth+1 semantics of process_deposit, per_block.rs)."""
    return tree.proof(index) + [deposit_count.to_bytes(32, "little")]


def deposit_root(tree: MerkleTree, deposit_count: int) -> bytes:
    return _h(tree.root, deposit_count.to_bytes(32, "little"))
