"""Req/Resp RPC: protocol IDs, SSZ message containers, ssz_snappy wire
codec, and a threaded TCP server/client.

The protocol surface of lighthouse/beacon_node/lighthouse_network/src/
rpc/ (protocol.rs:118-131 — Status, Goodbye, BlocksByRange, BlocksByRoot,
Ping, MetaData; codec/ssz_snappy.rs — varint-prefixed snappy-framed SSZ;
methods.rs — the message containers). Wire framing follows the consensus
p2p spec: requests are `varint(ssz_len) || snappy_frames(ssz)`; responses
are chunks of `result_byte || varint(ssz_len) || snappy_frames(ssz)`.

Transport: one TCP connection per request with a length-prefixed protocol
id instead of libp2p's multistream-select + noise session (the stream
DATA framing — what the fuzzable parsers consume — matches the spec; the
connection bootstrap is simplified and documented as such).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading

from ..ssz.types import Bytes4, Bytes32, Container, List, uint64, Bitvector
from . import snappy as sn

MAX_PAYLOAD = 10 * 1024 * 1024
MAX_REQUEST_BLOCKS = 1024

SUCCESS = 0x00
INVALID_REQUEST = 0x01
SERVER_ERROR = 0x02
RESOURCE_UNAVAILABLE = 0x03


# -- message containers (rpc/methods.rs) ---------------------------------------


class StatusMessage(Container):
    fields = [
        ("fork_digest", Bytes4),
        ("finalized_root", Bytes32),
        ("finalized_epoch", uint64),
        ("head_root", Bytes32),
        ("head_slot", uint64),
    ]


class Goodbye(Container):
    fields = [("reason", uint64)]


class Ping(Container):
    fields = [("data", uint64)]


class MetaData(Container):
    fields = [
        ("seq_number", uint64),
        ("attnets", Bitvector(64)),
    ]


class BlocksByRangeRequest(Container):
    fields = [
        ("start_slot", uint64),
        ("count", uint64),
        ("step", uint64),
    ]


class BlocksByRootRequest(Container):
    fields = [("block_roots", List(Bytes32, MAX_REQUEST_BLOCKS))]


class Protocol:
    """Protocol IDs (protocol.rs:118-131 + the /eth2/... prefix scheme)."""

    STATUS = "/eth2/beacon_chain/req/status/1/ssz_snappy"
    GOODBYE = "/eth2/beacon_chain/req/goodbye/1/ssz_snappy"
    PING = "/eth2/beacon_chain/req/ping/1/ssz_snappy"
    METADATA = "/eth2/beacon_chain/req/metadata/1/ssz_snappy"
    BLOCKS_BY_RANGE = "/eth2/beacon_chain/req/beacon_blocks_by_range/1/ssz_snappy"
    BLOCKS_BY_ROOT = "/eth2/beacon_chain/req/beacon_blocks_by_root/1/ssz_snappy"


REQUEST_TYPES = {
    Protocol.STATUS: StatusMessage,
    Protocol.GOODBYE: Goodbye,
    Protocol.PING: Ping,
    Protocol.METADATA: None,  # metadata requests have no body
    Protocol.BLOCKS_BY_RANGE: BlocksByRangeRequest,
    Protocol.BLOCKS_BY_ROOT: BlocksByRootRequest,
}


# -- ssz_snappy payload codec (codec/ssz_snappy.rs) ----------------------------


def encode_payload(ssz_bytes: bytes) -> bytes:
    return sn._uvarint_encode(len(ssz_bytes)) + sn.compress_frames(ssz_bytes)


def decode_payload(data: bytes, max_len: int = MAX_PAYLOAD) -> bytes:
    declared, pos = sn._uvarint_decode(data)
    if declared > max_len:
        raise ValueError(f"rpc payload {declared} exceeds cap {max_len}")
    out = sn.decompress_frames(data[pos:], max_output=declared)
    if len(out) != declared:
        raise ValueError("rpc payload length mismatch")
    return out


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_frame(sock: socket.socket, cap: int = MAX_PAYLOAD) -> bytes:
    (n,) = struct.unpack("<I", _read_exact(sock, 4))
    if n > cap:
        raise ValueError(f"frame {n} exceeds cap")
    return _read_exact(sock, n)


# -- server --------------------------------------------------------------------


class ReqRespServer:
    """Serves the six protocols for one node over TCP.

    `node` must expose: chain (BeaconChain), metadata_seq (int). Handlers
    mirror the worker-side RPC methods (network/src/router/processor.rs).
    """

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0, peer_db=None):
        from .peer_manager import PENALTY_RATE_LIMITED, RateLimiter

        self.node = node
        self.rate_limiter = RateLimiter()
        self.peer_db = peer_db
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    header = _recv_frame(self.request, cap=1024).decode()
                    # header: protocol id, optionally "\n" + requester node
                    # id (the logical identity libp2p's PeerId provides —
                    # per-IP keying would pool every localhost-simulator
                    # node into one bucket)
                    proto, _, peer_id = header.partition("\n")
                    peer_id = peer_id or self.client_address[0]
                    # token-bucket quota per (peer, protocol)
                    # (rpc/rate_limiter.rs:59): over-quota streams drop and
                    # the peer manager hears about it
                    # /eth2/beacon_chain/req/<name>/1/ssz_snappy
                    short = proto.strip("/").split("/")
                    name = short[3] if len(short) > 3 else proto
                    if outer.peer_db is not None and not outer.peer_db.is_usable(peer_id):
                        return  # graylisted requester: ignored (peerdb.rs)
                    if not outer.rate_limiter.allow(peer_id, name):
                        if outer.peer_db is not None:
                            outer.peer_db.penalize(peer_id, PENALTY_RATE_LIMITED)
                        return
                    body = _recv_frame(self.request)
                    for chunk in outer._dispatch(proto, body):
                        _send_frame(self.request, chunk)
                except (ConnectionError, ValueError, OSError):
                    pass  # malformed peer: drop the stream

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.addr = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def start(self) -> "ReqRespServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- handlers --------------------------------------------------------------

    def _dispatch(self, proto: str, body: bytes):
        chain = self.node.chain
        ctx = chain.ctx
        if proto == Protocol.STATUS:
            yield self._chunk(StatusMessage.serialize(self.status()))
        elif proto == Protocol.PING:
            ping = Ping.deserialize(decode_payload(body))
            yield self._chunk(Ping.serialize(Ping(data=self.node.metadata_seq)))
        elif proto == Protocol.GOODBYE:
            yield self._chunk(Goodbye.serialize(Goodbye(reason=0)))
        elif proto == Protocol.METADATA:
            md = MetaData(seq_number=self.node.metadata_seq, attnets=[False] * 64)
            yield self._chunk(MetaData.serialize(md))
        elif proto == Protocol.BLOCKS_BY_RANGE:
            req = BlocksByRangeRequest.deserialize(decode_payload(body))
            count = min(int(req.count), MAX_REQUEST_BLOCKS)
            step = max(1, int(req.step))
            wanted = range(req.start_slot, req.start_slot + count * step, step)
            blocks = sorted(
                (
                    b
                    for b in chain.store.blocks.values()
                    if int(b.message.slot) in wanted
                ),
                key=lambda b: int(b.message.slot),
            )
            for b in blocks:
                yield self._chunk(type(b).serialize(b))
        elif proto == Protocol.BLOCKS_BY_ROOT:
            req = BlocksByRootRequest.deserialize(decode_payload(body))
            for root in req.block_roots:
                b = chain.store.get_block(bytes(root))
                if b is not None:
                    yield self._chunk(type(b).serialize(b))
        else:
            yield bytes([INVALID_REQUEST]) + encode_payload(b"unknown protocol")

    def _chunk(self, ssz_bytes: bytes) -> bytes:
        return bytes([SUCCESS]) + encode_payload(ssz_bytes)

    def status(self) -> StatusMessage:
        from ..types import compute_fork_digest

        chain = self.node.chain
        state = chain.head_state()
        return StatusMessage(
            fork_digest=compute_fork_digest(
                bytes(state.fork.current_version), bytes(state.genesis_validators_root)
            ),
            finalized_root=bytes(state.finalized_checkpoint.root),
            finalized_epoch=int(state.finalized_checkpoint.epoch),
            head_root=chain.head_root,
            head_slot=int(state.slot),
        )


# -- client --------------------------------------------------------------------


def request(addr, protocol: str, req_obj=None, timeout: float = 10.0, node_id: str = "") -> list[bytes]:
    """One RPC: connect, send protocol id (+ requester identity) + request,
    read SUCCESS chunks to EOF. Returns the decoded SSZ payloads; raises on
    an error result byte. `node_id` identifies the requester to the
    server's rate limiter / peer manager (the PeerId libp2p would supply)."""
    req_type = REQUEST_TYPES[protocol]
    body = b"" if req_obj is None else req_type.serialize(req_obj)
    with socket.create_connection(addr, timeout=timeout) as sock:
        header = protocol + ("\n" + node_id if node_id else "")
        _send_frame(sock, header.encode())
        _send_frame(sock, encode_payload(body) if req_type is not None else b"")
        sock.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            try:
                frame = _recv_frame(sock)
            except ConnectionError:
                break
            if not frame:
                break
            result, payload = frame[0], frame[1:]
            if result != SUCCESS:
                raise RuntimeError(
                    f"rpc error {result}: {decode_payload(payload)[:200]!r}"
                )
            chunks.append(decode_payload(payload))
        return chunks
