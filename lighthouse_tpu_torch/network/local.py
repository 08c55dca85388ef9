"""Process-local gossip + req/resp hub.

The transport role of libp2p gossipsub and the BlocksByRange RPC
(lighthouse_network/src/rpc/protocol.rs:118-131) for multi-node-in-one-
process testing — the reference's simulator runs N nodes over localhost
sockets (testing/simulator/src/main.rs:1-16); this collapses the socket to
a call, keeping the publish/subscribe/req-resp shape.
"""

from __future__ import annotations

from .topics import Topic


class LocalNetwork:
    # fault-injection seam (sim.LinkFaults installs itself here): gossip
    # deliveries are wrapped in a closure the filter may drop/delay/
    # duplicate; req-resp paths ask it for a boolean link-up verdict
    link_filter = None

    def __init__(self):
        self.peers: dict[str, object] = {}  # node_id -> NetworkService

    def register(self, node_id: str, service) -> None:
        self.peers[node_id] = service

    def publish(self, from_id: str, topic: Topic, message) -> None:
        """Gossip: deliver to every peer except the publisher."""
        fil = self.link_filter
        for node_id, service in self.peers.items():
            if node_id == from_id:
                continue
            if fil is None:
                service.on_gossip(topic, message)
            else:
                fil(from_id, node_id, "gossip", lambda s=service: s.on_gossip(topic, message))

    # -- per-peer surface for the sync machines --------------------------------

    def peer_ids(self, requester_id: str) -> list[str]:
        fil = self.link_filter
        return [
            nid
            for nid in self.peers
            if nid != requester_id
            and (fil is None or fil(requester_id, nid, "peers", None))
        ]

    def blocks_by_range_from(
        self, requester_id: str, peer_id: str, start_slot: int, count: int
    ):
        from .sync import SyncPeerError

        fil = self.link_filter
        if fil is not None and not fil(requester_id, peer_id, "rpc", None):
            raise SyncPeerError(f"link to {peer_id} is down")
        service = self.peers.get(peer_id)
        if service is None:
            raise SyncPeerError(f"unknown peer {peer_id}")
        try:
            return service.serve_blocks_by_range(start_slot, count)
        except Exception as e:  # noqa: BLE001 — peer failure, not ours
            raise SyncPeerError(f"peer {peer_id}: {e}") from e

    def status_of(self, node_id: str, peer_id: str):
        from .rpc import StatusMessage

        fil = self.link_filter
        if fil is not None and not fil(node_id, peer_id, "rpc", None):
            raise OSError(f"link to {peer_id} is down")
        chain = self.peers[peer_id].client.chain
        state = chain.head_state()
        return StatusMessage(
            fork_digest=b"\x00" * 4,
            finalized_root=bytes(state.finalized_checkpoint.root),
            finalized_epoch=int(state.finalized_checkpoint.epoch),
            head_root=chain.head_root,
            head_slot=int(state.slot),
        )
