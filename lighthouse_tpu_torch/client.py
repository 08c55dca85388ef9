"""Client assembly: build a running node from config.

Counterpart of lighthouse/beacon_node/client/src/builder.rs:58
(ClientBuilder) + beacon_node/src: chains store -> genesis strategy ->
beacon chain -> op pool -> work scheduler -> HTTP API -> (optional)
slasher, then drives the per-slot timer (beacon_node/timer).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .chain import BeaconChain
from .chain.slot_clock import ManualSlotClock, SystemSlotClock
from .http_api import HttpApiServer
from .op_pool import OperationPool
from .scheduler import BeaconProcessor, WorkType
from .chain.attestation_processing import batch_verify_gossip_attestations
from .slasher import Slasher
from .state_transition import (
    ExecutionEngineError,
    TransitionContext,
    interop_genesis_state,
)
from .store import HotColdDB, MemoryStore
from .validator_client import BeaconNodeApi


@dataclass
class ClientConfig:
    preset: str = "minimal"
    bls_backend: str = "torch"
    datadir: str | None = None  # None = in-memory store
    http_port: int = 0  # 0 = ephemeral
    http_enabled: bool = True
    slasher_enabled: bool = False
    # genesis
    interop_validators: int = 16
    genesis_time: int = 1600000000
    slots_per_restore_point: int = 32
    # checkpoint sync: boot from a trusted node's finalized state
    # (ClientGenesis::CheckpointSyncUrl, client/src/builder.rs:264-330)
    checkpoint_url: str | None = None
    # execution layer (bellatrix): engine endpoints + shared JWT secret
    execution_endpoints: list = field(default_factory=list)
    jwt_secret: bytes | None = None
    # network selection (eth2_network_config): a named network or a custom
    # ChainSpec (e.g. loaded from a testnet dir's config.yaml); either
    # overrides `preset`'s default spec
    network: str | None = None
    spec_override: object = None
    # explicit genesis state (a testnet dir's genesis.ssz): overrides the
    # interop genesis when booting fresh
    genesis_state_path: str | None = None
    # cross-caller BLS batch coalescing (crypto/bls/batch_verifier.py).
    # None = auto: enabled iff the backend exposes an async dispatch path
    # (the torch backend) — the ref/fake backends gain nothing from
    # coalescing and keep their synchronous behavior.
    coalesce_bls: bool | None = None


class Client:
    """An assembled node: chain + pool + scheduler + API server."""

    def __init__(self, config: ClientConfig):
        self.config = config
        preset_name, spec = config.preset, None
        if config.network is not None:
            from .networks import network_config

            preset_name, spec = network_config(config.network)
        if config.spec_override is not None:
            spec = config.spec_override
        ctx = (
            TransitionContext.minimal(config.bls_backend)
            if preset_name == "minimal"
            else TransitionContext.mainnet(config.bls_backend)
        )
        if spec is not None:
            ctx.spec = spec
        self.ctx = ctx

        if config.execution_endpoints:
            from .execution_layer import EngineApiClient, ExecutionLayer

            ctx.execution_engine = ExecutionLayer(
                [
                    EngineApiClient(url, jwt_secret=config.jwt_secret)
                    for url in config.execution_endpoints
                ]
            )

        if config.datadir:
            store = HotColdDB(
                ctx, path=config.datadir, slots_per_restore_point=config.slots_per_restore_point
            )
        else:
            store = MemoryStore()

        # genesis strategy (builder.rs:218-330): resume from store if it has
        # a persisted head; else checkpoint-sync from a trusted URL; else
        # interop genesis
        resumed = False
        if isinstance(store, HotColdDB) and store.genesis_root is not None:
            genesis_state = store.get_state(store.genesis_root)
            resumed = genesis_state is not None
        anchor_block = None
        if not resumed and config.checkpoint_url:
            genesis_state, anchor_block = self._fetch_checkpoint_state(
                config.checkpoint_url, ctx
            )
        elif not resumed and config.genesis_state_path:
            from .types import decode_beacon_state

            with open(config.genesis_state_path, "rb") as f:
                genesis_state = decode_beacon_state(f.read(), ctx.types, ctx.spec)
        elif not resumed:
            genesis_state = interop_genesis_state(
                config.interop_validators, config.genesis_time, ctx
            )

        self.chain = BeaconChain(genesis_state, ctx, store=store)
        if anchor_block is not None:
            # seed the store with the anchor block itself (checkpoint sync
            # downloads state AND block): backfill walks strictly BELOW the
            # anchor slot, so without this the anchor is a hole in history
            msg = anchor_block.message
            if type(msg).hash_tree_root(msg) == self.chain.genesis_block_root:
                self.chain.store.put_block(self.chain.genesis_block_root, anchor_block)
        if resumed:
            self._replay_fork_choice(store)
        self.op_pool = OperationPool(ctx)
        self.api = BeaconNodeApi(self.chain, op_pool=self.op_pool)
        # cross-caller batch coalescing: gossip attestation / aggregate /
        # sync-message verifications share device batches (blocks keep
        # their dedicated per-block batch)
        self.coalescer = None
        coalesce = config.coalesce_bls
        if coalesce is None:
            coalesce = hasattr(ctx.bls, "verify_signature_sets_async")
        if coalesce:
            from .crypto.bls.batch_verifier import ensure_running

            self.coalescer = ensure_running(ctx.bls)
        try:
            self.processor = BeaconProcessor(coalescer=self.coalescer)
            self.slasher = Slasher(ctx) if config.slasher_enabled else None
            self.http: HttpApiServer | None = None
            if config.http_enabled:
                self.http = HttpApiServer(self.api, port=config.http_port).start()
        except BaseException:
            # construction failed after the refcount was taken (e.g. the
            # HTTP port is already bound): release it, or the process-wide
            # coalescer threads outlive every Client forever
            if self.coalescer is not None:
                from .crypto.bls.batch_verifier import release

                release(self.coalescer)
            raise

    @staticmethod
    def _fetch_checkpoint_state(url: str, ctx):
        """Download the trusted node's finalized state (SSZ) plus the
        finalized block, and anchor the chain on them. BeaconChain anchors
        fork choice on any self-consistent state, so a mid-chain finalized
        state works exactly like genesis — history backfills later via
        range sync. The block matters too: backfill only fetches slots
        BELOW the anchor, so the anchor block must come from the trusted
        node (builder.rs weak-subjectivity boot takes state + block)."""
        import json as _json
        import urllib.request

        with urllib.request.urlopen(
            f"{url}/eth/v2/debug/beacon/states/finalized", timeout=60
        ) as r:
            data = r.read()
        from .types import decode_beacon_state

        state = decode_beacon_state(data, ctx.types, ctx.spec)
        anchor_block = None
        try:
            with urllib.request.urlopen(
                f"{url}/eth/v2/beacon/blocks/finalized", timeout=60
            ) as r:
                payload = _json.loads(r.read())
            from .http_api.json_codec import decode

            anchor_block = decode(
                payload["data"],
                ctx.types.for_fork(payload["version"]).SignedBeaconBlock,
            )
        except Exception:  # noqa: BLE001 — state-only boot still anchors;
            pass  # the anchor block just stays a (reported) history hole
        return state, anchor_block

    def _replay_fork_choice(self, store: HotColdDB) -> None:
        """Rebuild fork choice from persisted blocks (ClientGenesis::FromStore)."""
        for root, blk in sorted(
            store.blocks.items(), key=lambda kv: store.block_slot[kv[0]]
        ):
            if not self.chain.fork_choice.contains_block(root):
                state = store.get_state(root)
                if state is None:
                    continue
                self.chain.fork_choice.on_tick(blk.message.slot)
                # across a restart the EL has confirmed nothing: payload
                # blocks replay as OPTIMISTIC until re-verified (never
                # consult the engine's stale last_status here)
                from .state_transition.bellatrix import block_has_payload

                self.chain.fork_choice.on_block(
                    blk.message, root, state,
                    execution_status=(
                        "optimistic" if block_has_payload(blk.message) else "irrelevant"
                    ),
                )
        self.chain.recompute_head()

    # -- gossip ingestion via the work scheduler -------------------------------

    def submit_gossip_attestation(self, attestation) -> bool:
        return self.processor.submit(WorkType.GOSSIP_ATTESTATION, attestation)

    def submit_gossip_block(self, signed_block) -> bool:
        return self.processor.submit(WorkType.GOSSIP_BLOCK, signed_block)

    def process_pending(self) -> int:
        """Drain the scheduler (the manager-loop turn)."""

        def handle_attestations(items):
            results = batch_verify_gossip_attestations(self.chain, items)
            for att, ok in zip(items, results):
                if ok is True:
                    self.op_pool.insert_attestation(att)
                    if self.slasher is not None:
                        from .state_transition.helpers import get_indexed_attestation

                        self.slasher.accept_attestation(
                            get_indexed_attestation(
                                self.chain.head_state(), att, self.ctx.types,
                                self.ctx.preset, self.ctx.spec,
                            )
                        )

        def handle_block(items):
            for signed in items:
                try:
                    self.chain.process_block(signed)
                except ExecutionEngineError:
                    continue  # EL transport outage: drop, block is not invalid

        def handle_aggregates(items):
            from .chain.attestation_processing import batch_verify_gossip_aggregates

            results = batch_verify_gossip_aggregates(self.chain, items)
            for signed, ok in zip(items, results):
                if ok is True:
                    self.op_pool.insert_attestation(signed.message.aggregate)

        isolated = BeaconProcessor.isolated
        return self.processor.drain(
            {
                WorkType.GOSSIP_ATTESTATION: isolated(handle_attestations),
                WorkType.GOSSIP_BLOCK: isolated(handle_block),
                WorkType.GOSSIP_AGGREGATE: isolated(handle_aggregates),
                WorkType.CHAIN_SEGMENT: isolated(handle_block),
                WorkType.RPC_BLOCK: isolated(handle_block),
                WorkType.DELAYED_BLOCK: isolated(handle_block),
            }
        )

    # -- per-slot tick (beacon_node/timer) -------------------------------------

    def per_slot_task(self, slot: int) -> None:
        self.chain.slot_clock.set_slot(slot)
        self.chain.fork_choice.on_tick(slot)
        self.process_pending()
        if self.slasher is not None:
            from .types import compute_epoch_at_slot

            atts, props = self.slasher.process_queued(
                compute_epoch_at_slot(slot, self.ctx.preset)
            )
            for s in atts:
                self.op_pool.insert_attester_slashing(s)
            for s in props:
                self.op_pool.insert_proposer_slashing(s)

    def shutdown(self) -> None:
        """Clean shutdown: persist chain head (Drop for BeaconChain,
        beacon_chain.rs:4590), stop servers."""
        # close the final slot window so its record (and any deadline-miss
        # dump) exists before the process goes away
        self.chain.slot_ledger.close()
        if self.coalescer is not None:
            from .crypto.bls.batch_verifier import release

            release(self.coalescer)
            self.coalescer = None
        store = self.chain.store
        if isinstance(store, HotColdDB):
            store.persist_head(self.chain.head_root, self.chain.genesis_block_root)
            fin = self.chain.head_state().finalized_checkpoint
            if bytes(fin.root) in store.blocks or bytes(fin.root) == self.chain.genesis_block_root:
                if bytes(fin.root) != self.chain.genesis_block_root:
                    store.migrate(bytes(fin.root))
        if self.http is not None:
            self.http.stop()
