"""In-memory block/state store.

Python rendering of lighthouse/beacon_node/store/src/memory_store.rs:
a KV store keyed by root, with typed helpers for blocks and states. The
`Store` base class is the seam a persistent hot/cold implementation
(hot_cold_store.rs:44) plugs into later.
"""

from __future__ import annotations


class Store:
    """Abstract store interface (store/src/lib.rs KeyValueStore/ItemStore)."""

    def put_block(self, root: bytes, signed_block) -> None:
        raise NotImplementedError

    def get_block(self, root: bytes):
        raise NotImplementedError

    def put_state(self, root: bytes, state) -> None:
        raise NotImplementedError

    def get_state(self, root: bytes):
        raise NotImplementedError


class MemoryStore(Store):
    def __init__(self):
        self.blocks: dict[bytes, object] = {}
        self.states: dict[bytes, object] = {}

    def put_block(self, root: bytes, signed_block) -> None:
        self.blocks[bytes(root)] = signed_block

    def get_block(self, root: bytes):
        return self.blocks.get(bytes(root))

    def put_state(self, root: bytes, state) -> None:
        self.states[bytes(root)] = state

    def get_state(self, root: bytes):
        return self.states.get(bytes(root))

    def __len__(self) -> int:
        return len(self.blocks)
