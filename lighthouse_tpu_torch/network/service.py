"""Per-node network service: gossip <-> BeaconProcessor <-> chain.

The router/worker glue of lighthouse/beacon_node/network/src
(router/mod.rs, worker/gossip_methods.rs, sync/range_sync): inbound gossip
lands in the node's bounded priority queues; draining verifies batches and
imports blocks; a block with an unknown parent triggers range sync from
peers (sync/manager.rs:178)."""

from __future__ import annotations

from ..chain.attestation_processing import (
    AttestationError,
    PipelinedGossipVerifier,
    batch_verify_gossip_aggregates,
)
from ..chain.beacon_chain import BlockError
from ..state_transition import ExecutionEngineError
from ..scheduler import BeaconProcessor, WorkType
from ..scheduler.reprocess import ReprocessQueue
from .topics import Topic


class NetworkService:
    def __init__(self, node_id: str, client, network):
        from .sync import SyncManager

        self.node_id = node_id
        self.client = client
        self.network = network
        self.reprocess = ReprocessQueue()
        self.sync = SyncManager(self)
        network.register(node_id, self)

    # -- outbound --------------------------------------------------------------

    def publish_block(self, signed_block) -> None:
        self.network.publish(self.node_id, Topic.BEACON_BLOCK, signed_block)

    def publish_attestation(self, attestation) -> None:
        self.network.publish(self.node_id, Topic.BEACON_ATTESTATION, attestation)

    def publish_aggregate(self, signed_aggregate) -> None:
        self.network.publish(
            self.node_id, Topic.BEACON_AGGREGATE_AND_PROOF, signed_aggregate
        )

    def publish_proposer_slashing(self, slashing) -> None:
        self.network.publish(self.node_id, Topic.PROPOSER_SLASHING, slashing)

    def publish_attester_slashing(self, slashing) -> None:
        self.network.publish(self.node_id, Topic.ATTESTER_SLASHING, slashing)

    def publish_voluntary_exit(self, signed_exit) -> None:
        self.network.publish(self.node_id, Topic.VOLUNTARY_EXIT, signed_exit)

    # -- inbound (router/mod.rs on_network_msg) --------------------------------

    def on_gossip(self, topic: Topic, message) -> None:
        p = self.client.processor
        if topic == Topic.BEACON_BLOCK:
            self._admit_to_recorder("block", message)
            p.submit(WorkType.GOSSIP_BLOCK, message)
        elif topic in (Topic.BEACON_ATTESTATION, Topic.BEACON_AGGREGATE_AND_PROOF):
            is_att = topic == Topic.BEACON_ATTESTATION
            self._admit_to_recorder("attestation" if is_att else "aggregate", message)
            p.submit(
                WorkType.GOSSIP_ATTESTATION if is_att else WorkType.GOSSIP_AGGREGATE,
                message,
            )
        elif topic == Topic.SYNC_COMMITTEE:
            self.client.api.publish_sync_message(message)
        elif topic == Topic.SYNC_COMMITTEE_CONTRIBUTION:
            self.client.api.publish_contribution(message)
        elif topic == Topic.VOLUNTARY_EXIT:
            self.client.op_pool.insert_voluntary_exit(message)
        elif topic == Topic.PROPOSER_SLASHING:
            self.client.op_pool.insert_proposer_slashing(message)
        elif topic == Topic.ATTESTER_SLASHING:
            self.client.op_pool.insert_attester_slashing(message)

    def _admit_to_recorder(self, kind: str, message) -> None:
        """Mint a flight-recorder correlation id at gossip admission and
        bind it to the message's hash-tree-root — the verification pipeline
        (attestation_processing / batch_verifier) looks the id up by root,
        so the message rides the work queues untouched."""
        try:
            key = bytes(type(message).hash_tree_root(message))
        except Exception:  # noqa: BLE001 — junk payloads (adversarial
            # frames) cannot be rooted; they fail later behind the drain's
            # hostile-input boundary and there is nothing to correlate
            return
        recorder = self.client.chain.flight_recorder
        corr_id = recorder.mint(kind, node=self.node_id)
        recorder.bind(key, corr_id)

    def connect_discovered(self, discovery) -> int:
        """Dial every routing-table peer advertising a TCP (gossip) port —
        the discovery→peer-selection wiring (the Kademlia table is the peer
        source).
        Returns the number of dials attempted."""
        connect = getattr(self.network, "connect_peer", None)
        if connect is None:
            return 0  # process-local networks have no dialable addresses
        dialed = 0
        for bucket in discovery.table.buckets:
            for enr in bucket:
                ip, tcp = enr.ip(), enr.tcp()
                if ip is None or tcp is None:
                    continue
                # only dial PONG-verified endpoints: an attacker can sign
                # an ENR pointing at a victim's address (discv5 dials only
                # liveness-checked records for the same reason)
                if not discovery.ping(enr, timeout=1.0):
                    continue
                try:
                    if connect(self.node_id, (ip, tcp)):
                        dialed += 1
                except OSError:
                    continue
        return dialed

    def exchange_status(self) -> None:
        """Status-handshake every peer; a peer ahead of us starts range sync
        (router.rs on_status_response -> SyncManager add_peer)."""
        for peer_id in self.network.peer_ids(self.node_id):
            try:
                status = self.network.status_of(self.node_id, peer_id)
            except Exception:  # noqa: BLE001 — unreachable peer
                continue
            self.sync.on_status(int(status.head_slot))

    # -- req/resp server (rpc BlocksByRange) -----------------------------------

    def serve_blocks_by_range(self, start_slot: int, count: int):
        store = self.client.chain.store
        out = []
        for root, signed in store.blocks.items():
            if start_slot <= signed.message.slot < start_slot + count:
                out.append(signed)
        return sorted(out, key=lambda b: b.message.slot)

    # -- processing with sync recovery -----------------------------------------

    def process_pending(self) -> None:
        """Drain the node's queues; unknown-parent blocks trigger range sync
        (the simulator-scale stand-in for SyncManager + BackFillSync)."""
        chain = self.client.chain

        current_slot = int(chain.slot())

        def handle_block(items, gossip: bool = False):
            for signed in items:
                block = signed.message
                root = type(block).hash_tree_root(block)
                if chain.store.get_block(root) is not None:
                    continue  # duplicate of an imported block: ignore
                if gossip and chain.observed_block_producers.is_observed(
                    int(block.slot), int(block.proposer_index)
                ):
                    # a DIFFERENT block from this proposer at this slot was
                    # already imported: gossip equivocation. Reject without
                    # importing (observed_block_producers.rs), but hand the
                    # signed header to the slasher — the imported twin was
                    # fed at import, so this completes the double-proposal
                    # pair (beacon_chain.rs verify_block_for_gossip ->
                    # slasher.accept_block_header on both)
                    self._slasher_accept_header(signed, verify_signature=True)
                    continue
                try:
                    root = chain.process_block(signed)
                except ExecutionEngineError:
                    # EL transport outage: the block is NOT invalid — drop it
                    # and let re-gossip/range-sync retry once the EL is back
                    continue
                except BlockError as e:
                    if "unknown parent" in str(e):
                        self._range_sync(signed)
                    # other invalid blocks drop, as gossip verification would
                else:
                    if gossip:
                        # import already proved the proposer signature, so
                        # the header goes to the slasher unverified
                        self._slasher_accept_header(signed)
                    # release attestations parked on this root
                    # (work_reprocessing_queue.rs BlockImported)
                    for wt, att in self.reprocess.on_block_imported(root):
                        p.submit(wt, att)

        # attestation batches are SUBMITTED during the drain and their
        # verdicts collected afterwards: host staging of batch i+1 overlaps
        # device execution of batch i (PipelinedGossipVerifier)
        verifier = PipelinedGossipVerifier(chain)

        def route_attestation(att, ok):
            if ok is True:
                self.client.op_pool.insert_attestation(att)
            elif isinstance(ok, AttestationError) and "unknown head block" in str(ok):
                self.reprocess.park_unknown_block(
                    att, bytes(att.data.beacon_block_root), current_slot
                )
            elif isinstance(ok, AttestationError) and "future slot" in str(ok):
                # early arrival: park until its slot starts (bounded)
                self.reprocess.park_early(att, int(att.data.slot), current_slot)

        def handle_atts(items):
            verifier.submit(items)

        def handle_aggs(items):
            # SignedAggregateAndProofs: three-set admission per aggregate,
            # one device batch for all of them
            results = batch_verify_gossip_aggregates(chain, items)
            for signed, ok in zip(items, results):
                att = signed.message.aggregate
                if ok is True:
                    self.client.op_pool.insert_attestation(att)
                elif (
                    isinstance(ok, AttestationError)
                    and "unknown head block" in str(ok)
                ):
                    self.reprocess.park_unknown_block(
                        signed, bytes(att.data.beacon_block_root), current_slot,
                        work_type=WorkType.GOSSIP_AGGREGATE,
                    )
                elif isinstance(ok, AttestationError) and "future slot" in str(ok):
                    self.reprocess.park_early(
                        signed, int(att.data.slot), current_slot,
                        work_type=WorkType.GOSSIP_AGGREGATE,
                    )

        p = self.client.processor
        isolated = BeaconProcessor.isolated
        # clock tick first: resubmit anything whose slot has arrived
        for wt, item in self.reprocess.on_slot(current_slot):
            p.submit(wt, item)
        p.drain(
            {
                WorkType.GOSSIP_BLOCK: isolated(
                    lambda items: handle_block(items, gossip=True)
                ),
                WorkType.RPC_BLOCK: isolated(handle_block),
                WorkType.DELAYED_BLOCK: isolated(handle_block),
                WorkType.CHAIN_SEGMENT: isolated(handle_block),
                WorkType.GOSSIP_ATTESTATION: isolated(handle_atts),
                WorkType.GOSSIP_AGGREGATE: isolated(handle_aggs),
            }
        )
        # collect the in-flight attestation verdicts (route callbacks may
        # park items for reprocessing on a later call)
        verifier.flush(route_attestation)

    def _slasher_accept_header(self, signed_block, verify_signature: bool = False) -> None:
        """Queue a gossip block's header for the slasher's double-proposal
        detector. `verify_signature` is set on the equivocation path: the
        duplicate was never imported, so its proposer signature must be
        proved here — otherwise anyone could forge a second "block" and
        frame an honest proposer into a slashing."""
        slasher = getattr(self.client, "slasher", None)
        if slasher is None:
            return
        ctx = self.client.ctx
        block = signed_block.message
        if verify_signature:
            from ..state_transition import signature_sets as sigsets

            state = self.client.chain.head_state()
            try:
                sset = sigsets.historical_block_proposal_signature_set(
                    signed_block,
                    ctx.bls,
                    ctx.pubkeys.resolver(state),
                    ctx.preset,
                    ctx.spec,
                    bytes(state.genesis_validators_root),
                )
                if not ctx.bls.verify_signature_sets([sset]):
                    return
            except (IndexError, KeyError, ValueError):
                return  # unresolvable proposer: cannot be a valid twin
        from ..types.containers import BeaconBlockHeader, SignedBeaconBlockHeader

        header = BeaconBlockHeader(
            slot=block.slot,
            proposer_index=block.proposer_index,
            parent_root=block.parent_root,
            state_root=block.state_root,
            body_root=type(block.body).hash_tree_root(block.body),
        )
        slasher.accept_block_header(
            SignedBeaconBlockHeader(message=header, signature=signed_block.signature)
        )

    def _range_sync(self, orphan_block) -> None:
        """Unknown-parent trigger: hand the gap to the SyncManager
        (sync/manager.rs UnknownParentBlock -> RangeSync)."""
        try:
            self.sync.on_unknown_parent(orphan_block)
        except ExecutionEngineError:
            pass  # EL outage mid-sync: retry on the next trigger
