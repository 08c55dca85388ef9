"""Split hot/cold store with on-disk persistence and replay reconstruction.

Counterpart of lighthouse/beacon_node/store/src/hot_cold_store.rs:44:
  - hot: every unfinalized post-state, in memory + on disk
  - cold ("freezer"): finalized states thinned to restore points every
    `slots_per_restore_point` slots; intermediate states reconstruct by
    replaying blocks from the nearest restore point (hot_cold_store.rs:
    611-731 + block_replayer.rs, NO_VERIFICATION replay)
  - `migrate(finalized_root)` is the BackgroundMigrator's hot->cold move
    (migrate.rs:29-35)
  - chain-head checkpoint/resume: persist_head/load_head mirror
    PersistedBeaconChain (beacon_chain.rs:4590 Drop persistence).

Disk layout under `path/`: blocks/<root>.ssz, states/<root>.ssz,
meta.json (head root, finalized root, restore-point index, genesis root).
"""

from __future__ import annotations

import json
import os
import pathlib

from .memory import Store


class HotColdDB(Store):
    def __init__(
        self,
        ctx,
        path: str | None = None,
        slots_per_restore_point: int = 32,
        hot_state_interval: int | None = None,
    ):
        self.ctx = ctx
        self.sprp = slots_per_restore_point
        # hot-state thinning (hot_cold_store.rs HotStateSummary): full
        # states persist only at epoch boundaries; everything between
        # reconstructs by replaying blocks from the previous boundary
        self.hot_interval = hot_state_interval or ctx.preset.slots_per_epoch
        # in-memory cache bound: the snapshot-cache role (snapshot_cache.rs)
        self.max_cached = 4 * self.hot_interval
        self.path = pathlib.Path(path) if path else None
        self.blocks: dict[bytes, object] = {}
        self.hot_states: dict[bytes, object] = {}
        self.cold_states: dict[bytes, object] = {}  # restore points only
        self._persisted_hot: set[bytes] = set()  # roots with a states/ file
        self.block_parent: dict[bytes, bytes] = {}
        self.block_slot: dict[bytes, int] = {}
        self.meta: dict = {}
        if self.path:
            (self.path / "blocks").mkdir(parents=True, exist_ok=True)
            (self.path / "states").mkdir(parents=True, exist_ok=True)
            self._load_disk()

    # -- Store interface ---------------------------------------------------

    def put_block(self, root: bytes, signed_block) -> None:
        root = bytes(root)
        self.blocks[root] = signed_block
        self.block_parent[root] = bytes(signed_block.message.parent_root)
        self.block_slot[root] = int(signed_block.message.slot)
        if self.path:
            self._write(
                self.path / "blocks" / f"{root.hex()}.ssz",
                type(signed_block).serialize(signed_block),
            )

    def get_block(self, root: bytes):
        return self.blocks.get(bytes(root))

    def put_state(self, root: bytes, state) -> None:
        root = bytes(root)
        self.hot_states[root] = state
        # persist the full state only at hot-summary boundaries — or when
        # it is an ANCHOR (genesis / checkpoint state with no stored block:
        # nothing to replay from, it must survive a restart verbatim)
        boundary = int(state.slot) % self.hot_interval == 0
        anchor = root not in self.blocks
        if self.path and (boundary or anchor):
            self._write(
                self.path / "states" / f"{root.hex()}.ssz",
                type(state).serialize(state),
            )
            self._persisted_hot.add(root)
        self._evict()

    def get_state(self, root: bytes):
        root = bytes(root)
        got = self.hot_states.get(root) or self.cold_states.get(root)
        if got is not None:
            return got
        return self._reconstruct(root)

    def _evict(self) -> None:
        """Bound the in-memory hot cache: drop the oldest non-boundary,
        non-anchor states beyond capacity (they reconstruct by replay)."""
        if len(self.hot_states) <= self.max_cached:
            return
        by_age = sorted(self.hot_states.items(), key=lambda kv: int(kv[1].slot))
        excess = len(self.hot_states) - self.max_cached
        for root, state in by_age:
            if excess <= 0:
                break
            if int(state.slot) % self.hot_interval == 0 or root not in self.blocks:
                continue
            del self.hot_states[root]
            excess -= 1

    def __len__(self) -> int:
        return len(self.blocks)

    # -- hot->cold migration (migrate.rs) -----------------------------------

    def migrate(self, finalized_root: bytes) -> None:
        """Move pre-finalized hot states to the freezer: keep states whose
        slot is a restore-point multiple, drop the rest (they reconstruct by
        replay). The finalized state itself always stays loadable."""
        finalized_root = bytes(finalized_root)
        fin_state = self.get_state(finalized_root)
        if fin_state is None:
            return
        fin_slot = int(fin_state.slot)
        candidates = set(self.hot_states) | set(self._persisted_hot)
        for root in candidates:
            state = self.hot_states.get(root)
            slot = int(state.slot) if state is not None else self.block_slot.get(root)
            if slot is None:
                continue  # anchor with no block record: keep
            if slot >= fin_slot and root != finalized_root:
                continue  # still hot
            self.hot_states.pop(root, None)
            if slot % self.sprp == 0 or root == finalized_root:
                if state is None:
                    state = self.get_state(root)
                if state is not None:
                    self.cold_states[root] = state
                # the disk file stays (restore points reload on resume) but
                # later migrates must not revisit this root
                self._persisted_hot.discard(root)
            elif self.path:
                p = self.path / "states" / f"{root.hex()}.ssz"
                if p.exists():
                    p.unlink()  # reconstructable: drop from disk too
                self._persisted_hot.discard(root)
        self.meta["finalized_root"] = finalized_root.hex()
        self._write_meta()

    # -- replay reconstruction (hot_cold_store.rs:611, block_replayer.rs) ---

    def _ancestors(self, root: bytes) -> list[bytes]:
        """Block roots from `root` back to (excluding) a stored state."""
        chain = []
        cur = root
        while cur in self.block_parent:
            if cur in self.hot_states or cur in self.cold_states:
                break
            chain.append(cur)
            cur = self.block_parent[cur]
        return chain[::-1]

    def _reconstruct(self, root: bytes):
        if root not in self.blocks:
            return None
        from ..state_transition import BlockSignatureStrategy, state_transition

        todo = self._ancestors(root)
        if not todo:
            return None
        base_root = self.block_parent[todo[0]]
        base = self.hot_states.get(base_root) or self.cold_states.get(base_root)
        if base is None:
            return None
        state = base.copy()
        for r in todo:
            state = state_transition(
                state,
                self.blocks[r],
                self.ctx,
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
            )
        return state

    # -- disk persistence / resume ------------------------------------------

    def persist_head(self, head_root: bytes, genesis_root: bytes) -> None:
        """PersistedBeaconChain: record enough to resume from disk."""
        self.meta.update(
            {"head_root": bytes(head_root).hex(), "genesis_root": bytes(genesis_root).hex()}
        )
        self._write_meta()

    @property
    def head_root(self) -> bytes | None:
        h = self.meta.get("head_root")
        return bytes.fromhex(h) if h else None

    @property
    def genesis_root(self) -> bytes | None:
        h = self.meta.get("genesis_root")
        return bytes.fromhex(h) if h else None

    def _write(self, path: pathlib.Path, data: bytes) -> None:
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)

    def _write_meta(self) -> None:
        if self.path:
            self._write(self.path / "meta.json", json.dumps(self.meta).encode())

    def _load_disk(self) -> None:
        from ..types import decode_beacon_state, decode_signed_block

        t = self.ctx.types
        meta_p = self.path / "meta.json"
        if meta_p.exists():
            self.meta = json.loads(meta_p.read_text())
        for p in (self.path / "blocks").glob("*.ssz"):
            signed = decode_signed_block(
                p.read_bytes(), t, self.ctx.spec, self.ctx.preset
            )
            root = bytes.fromhex(p.stem)
            self.blocks[root] = signed
            self.block_parent[root] = bytes(signed.message.parent_root)
            self.block_slot[root] = int(signed.message.slot)
        for p in (self.path / "states").glob("*.ssz"):
            root = bytes.fromhex(p.stem)
            self.hot_states[root] = decode_beacon_state(p.read_bytes(), t, self.ctx.spec)
            self._persisted_hot.add(root)
