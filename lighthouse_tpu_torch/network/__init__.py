"""Networking seam: gossip topics, an in-process gossip bus, per-node
network services, and range sync.

The reference's stack (lighthouse_network libp2p gossipsub + discv5 +
Req/Resp, network/ router + sync) is an internet-facing host subsystem:
the card serves the verifier, not the talk to peers. This package provides
the protocol-shaped seam and an in-process transport (copied from the JAX
package's network/):

  - `topics`: the gossip topic registry (types/topics.rs:11-28)
  - `snappy`: pure-Python snappy block + frame codecs (the `snap` crate's
    role in rpc/codec/ssz_snappy.rs)
  - `rpc`: the six Req/Resp protocols with spec wire framing over TCP
    (rpc/protocol.rs:118-131, codec/ssz_snappy.rs)
  - `gossip`: TCP gossip with spec topic names, snappy payloads, spec
    message ids, and seen-cache dedup (gossipsub's message plane;
    mesh-degree management/scoring is the remaining delta)
  - `LocalNetwork`: a process-local gossip/req-resp hub — the transport the
    reference's multi-node simulator runs over localhost sockets
    (testing/simulator), collapsed to function calls
  - `SocketNetwork`: the same hub interface over REAL localhost sockets
    with the wire codecs above
  - `NetworkService`: per-node glue routing gossip into the node's
    BeaconProcessor queues and serving BlocksByRange (network/src/router +
    sync/range_sync)
"""

from .local import LocalNetwork
from .service import NetworkService
from .socket_net import SocketNetwork
from .topics import Topic

__all__ = ["LocalNetwork", "NetworkService", "SocketNetwork", "Topic"]
