"""Real-socket network hub: the LocalNetwork interface over TCP.

Drop-in replacement for `LocalNetwork` (same register/publish/
blocks_by_range surface consumed by NetworkService) where every message
actually crosses a socket with the spec wire encodings: gossip via
`gossip.GossipNode` (snappy-block SSZ, spec topic names + message ids) and
Req/Resp via `rpc.ReqRespServer` (varint + snappy-frame SSZ chunks). This
is the reference simulator's shape — N nodes, one OS, real localhost
sockets (lighthouse/testing/simulator/src/main.rs:1-16) — with the
reference's codecs (rpc/codec/ssz_snappy.rs).
"""

from __future__ import annotations

import threading

from ..types import FORK_ORDER, compute_fork_digest, decode_signed_block
from . import rpc
from .gossip import GossipNode
from .topics import Topic


class _RpcNode:
    def __init__(self, chain):
        self.chain = chain
        self.metadata_seq = 1


class SocketNetwork:
    # fault-injection seam, mirroring LocalNetwork.link_filter: the sim's
    # LinkFaults installs itself here to drop/delay/duplicate gossip and
    # sever req/resp links (src/dst are logical node ids)
    link_filter = None

    def __init__(self, ctx=None):
        # ctx may be None at construction: it is lazily bound from the
        # first registered node's client (all nodes on one hub share the
        # same spec/preset/types context by construction)
        self.ctx = ctx
        self._nodes: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._digest_cache: dict[bytes, set[bytes]] = {}

    # -- LocalNetwork interface ------------------------------------------------

    def register(self, node_id: str, service) -> None:
        from .peer_manager import PeerDB

        if self.ctx is None:
            self.ctx = service.client.ctx

        peer_db = PeerDB()  # shared score book: gossip + req/resp
        box: list = []  # late-bound: the deliver closure needs the node
        gossip = GossipNode(
            deliver=lambda topic, payload, src: self._deliver(
                service, box[0], topic, payload, src
            ),
            peer_db=peer_db,
            node_id=node_id,
        )
        box.append(gossip)
        server = rpc.ReqRespServer(
            _RpcNode(service.client.chain), peer_db=peer_db
        ).start()
        with self._lock:
            for entry in self._nodes.values():
                gossip.connect(entry["gossip"].addr)  # full mesh
            self._nodes[node_id] = {
                "service": service,
                "gossip": gossip,
                "rpc": server,
                "peer_db": peer_db,
            }

    def publish(self, from_id: str, topic: Topic, message) -> None:
        entry = self._nodes[from_id]
        chain = entry["service"].client.chain
        state = chain.head_state()
        digest = compute_fork_digest(
            bytes(state.fork.current_version), bytes(state.genesis_validators_root)
        )
        subnet = None
        if topic == Topic.BEACON_ATTESTATION:
            from ..state_transition.helpers import get_committee_count_per_slot
            from .topics import compute_subnet_for_attestation

            ctx = chain.ctx
            data = message.data
            subnet = compute_subnet_for_attestation(
                get_committee_count_per_slot(
                    state, int(data.target.epoch), ctx.preset
                ),
                int(data.slot),
                int(data.index),
                ctx.preset.slots_per_epoch,
            )
        ssz = self._encode(topic, message)
        entry["gossip"].publish(topic.full_name(digest, subnet), ssz)

    def peer_ids(self, requester_id: str) -> list[str]:
        fil = self.link_filter
        with self._lock:
            ids = [nid for nid in self._nodes if nid != requester_id]
        if fil is None:
            return ids
        return [nid for nid in ids if fil(requester_id, nid, "peers", None)]

    def gossip_addr(self, node_id: str):
        """This node's gossip TCP listener (for its ENR tcp field)."""
        with self._lock:
            return self._nodes[node_id]["gossip"].addr

    def rpc_addr(self, node_id: str):
        """This node's req/resp TCP listener."""
        with self._lock:
            return self._nodes[node_id]["rpc"].addr

    def peer_db(self, node_id: str):
        """This node's peer score book (shared by gossip + req/resp) — the
        observability hook adversarial scenarios assert against."""
        with self._lock:
            return self._nodes[node_id]["peer_db"]

    def connect_peer(self, node_id: str, addr, timeout: float = 2.0) -> None:
        """Dial a discovered peer's gossip listener (discovery -> gossip
        peer selection; the libp2p dial lighthouse_network issues from
        discv5 results). Idempotent per address; short timeout so stale
        table entries cannot stall the sweep."""
        with self._lock:
            entry = self._nodes.get(node_id)
        if entry is None:
            raise OSError(f"node {node_id} is not registered on this network")
        return entry["gossip"].connect(tuple(addr), timeout=timeout)

    def blocks_by_range_from(
        self, requester_id: str, peer_id: str, start_slot: int, count: int
    ):
        from .sync import SyncPeerError

        if count <= 0:
            return []
        fil = self.link_filter
        if fil is not None and not fil(requester_id, peer_id, "rpc", None):
            raise SyncPeerError(f"link to {peer_id} is down")
        with self._lock:
            entry = self._nodes.get(peer_id)
        if entry is None:
            raise SyncPeerError(f"unknown peer {peer_id}")
        req = rpc.BlocksByRangeRequest(start_slot=start_slot, count=count, step=1)
        try:
            chunks = rpc.request(
                entry["rpc"].addr, rpc.Protocol.BLOCKS_BY_RANGE, req, node_id=requester_id
            )
        except (OSError, RuntimeError, ValueError) as e:
            raise SyncPeerError(f"peer {peer_id}: {e}") from e
        return [
            decode_signed_block(c, self.ctx.types, self.ctx.spec, self.ctx.preset)
            for c in chunks
        ]

    def status_of(self, node_id: str, peer_id: str) -> rpc.StatusMessage:
        """Status handshake from node_id's view of peer_id (rpc status)."""
        fil = self.link_filter
        if fil is not None and not fil(node_id, peer_id, "rpc", None):
            raise OSError(f"link to {peer_id} is down")
        me = self._nodes[node_id]
        peer_addr = self._nodes[peer_id]["rpc"].addr
        chunks = rpc.request(peer_addr, rpc.Protocol.STATUS, me["rpc"].status(), node_id=node_id)
        return rpc.StatusMessage.deserialize(chunks[0])

    def close(self) -> None:
        with self._lock:
            for entry in self._nodes.values():
                entry["gossip"].close()
                entry["rpc"].stop()
            self._nodes.clear()

    # -- codecs ----------------------------------------------------------------

    def _encode(self, topic: Topic, message) -> bytes:
        return type(message).serialize(message)

    def _decode(self, topic: Topic, payload: bytes):
        t = self.ctx.types
        if topic == Topic.BEACON_BLOCK:
            return decode_signed_block(payload, t, self.ctx.spec, self.ctx.preset)
        decoder = {
            Topic.BEACON_ATTESTATION: t.Attestation,
            Topic.BEACON_AGGREGATE_AND_PROOF: t.SignedAggregateAndProof,
            Topic.SYNC_COMMITTEE: t.SyncCommitteeMessage,
            Topic.SYNC_COMMITTEE_CONTRIBUTION: t.SignedContributionAndProof,
            Topic.VOLUNTARY_EXIT: t.SignedVoluntaryExit,
            Topic.PROPOSER_SLASHING: t.ProposerSlashing,
            Topic.ATTESTER_SLASHING: t.AttesterSlashing,
        }[topic]
        return decoder.deserialize(payload)

    def _valid_digests(self, chain) -> set[bytes]:
        # depends only on genesis_validators_root: compute once per chain
        gvr = bytes(chain.head_state().genesis_validators_root)
        cached = self._digest_cache.get(gvr)
        if cached is None:
            cached = {
                compute_fork_digest(self.ctx.spec.fork_version(name), gvr)
                for name in FORK_ORDER
            }
            self._digest_cache[gvr] = cached
        return cached

    def _deliver(self, service, gossip, topic_name: str, payload: bytes, src: str):
        """Gossip delivery callback. Returns False when the payload fails
        validation (the GossipNode then refuses to forward it — gossipsub
        v1.1 validate-before-propagate); any other return accepts it."""
        fil = self.link_filter
        if fil is None:
            return self._deliver_app(service, gossip, topic_name, payload, src)
        # fault layer owns the delivery decision; an un-delivered (dropped
        # or delayed) message must not be forwarded either, so the verdict
        # defaults to False unless the filter ran the closure
        out: list = []
        fil(
            src,
            service.node_id,
            "gossip",
            lambda: out.append(
                self._deliver_app(service, gossip, topic_name, payload, src)
            ),
        )
        return out[0] if out else False

    def _deliver_app(self, service, gossip, topic_name: str, payload: bytes, src: str):
        # /eth2/{digest}/{name}[_{subnet}]/ssz_snappy
        parts = topic_name.strip("/").split("/")
        if len(parts) != 4 or parts[0] != "eth2" or parts[3] != "ssz_snappy":
            gossip.report_invalid_message(src)
            return False
        try:
            digest = bytes.fromhex(parts[1])
        except ValueError:
            gossip.report_invalid_message(src)
            return False
        parsed = Topic.parse_wire_name(parts[2])
        if parsed is None:
            return False  # unknown topic: don't relay what we can't vet
        topic, _subnet = parsed
        if digest not in self._valid_digests(service.client.chain):
            # unknown fork digest: not subscribed (types/topics.rs)
            return False
        try:
            obj = self._decode(topic, payload)
        except Exception:  # noqa: BLE001 — malformed gossip: drop + score
            # the forwarder relayed an undecodable container
            # (gossip_methods.rs reject -> report_peer)
            gossip.report_invalid_message(src)
            return False
        return service.on_gossip(topic, obj)
