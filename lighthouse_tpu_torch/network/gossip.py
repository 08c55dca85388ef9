"""Gossipsub over TCP: per-topic mesh, lazy gossip (IHAVE/IWANT), peer
scoring hooks, spec topic names, snappy-block payloads, spec message IDs.

The message-plane of lighthouse/beacon_node/lighthouse_network's
gossipsub (behaviour/mod.rs, gossipsub_scoring_parameters.rs:27, and the
libp2p gossipsub v1.1 spec the reference embeds):

  - topic wire names: /eth2/{fork_digest}/{topic}/ssz_snappy
  - payloads: snappy BLOCK-format compressed SSZ
  - message id: SHA256(MESSAGE_DOMAIN_VALID_SNAPPY || uncompressed)[:20]
  - dedup: bounded seen-cache keyed by message id
  - MESH: eager push goes only to the per-topic mesh (degree D, maintained
    between D_LOW and D_HIGH by GRAFT/PRUNE at heartbeat); everyone else
    learns ids lazily via IHAVE at heartbeat and pulls with IWANT from the
    message cache (mcache). Broken IWANT promises and protocol violations
    feed the PeerDB score; graylisted peers are ignored, banned peers
    disconnected.

Deliberate simplifications vs libp2p (documented): control frames are JSON
(not protobuf), subscriptions are implicit (every node participates in
every topic — the simulator subscribes all subnets), and scoring uses the
PeerDB's flat additive penalties rather than the per-topic weighted P1-P7
sum. Transport: persistent TCP links, one length-prefixed frame per
message: type_byte || varint(topic_len) || topic || payload.
"""

from __future__ import annotations

import hashlib
import json
import random
import socket
import struct
import threading
import time
from collections import OrderedDict

from . import snappy as sn
from .peer_manager import (
    PENALTY_BROKEN_PROMISE,
    PENALTY_INVALID_MESSAGE,
    PENALTY_PROTOCOL_VIOLATION,
    PeerDB,
)
from .rpc import _recv_frame, _send_frame

MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
MAX_MESSAGE = 10 * 1024 * 1024
SEEN_CACHE = 4096
MCACHE_SIZE = 1024

FRAME_DATA = 0
FRAME_CONTROL = 1

# mesh degree parameters (gossipsub spec defaults; constructor-overridable)
D = 8
D_LOW = 6
D_HIGH = 12
D_LAZY = 6
IWANT_PROMISE_TTL = 3.0  # seconds until an unanswered IWANT is a broken promise
HEARTBEAT_INTERVAL = 0.7


def message_id(uncompressed: bytes) -> bytes:
    return hashlib.sha256(MESSAGE_DOMAIN_VALID_SNAPPY + uncompressed).digest()[:20]


def encode_message(topic: str, ssz_bytes: bytes) -> bytes:
    t = topic.encode()
    return bytes([FRAME_DATA]) + sn._uvarint_encode(len(t)) + t + sn.compress_block(ssz_bytes)


def decode_message(frame: bytes) -> tuple[str, bytes]:
    if not frame or frame[0] != FRAME_DATA:
        raise ValueError("not a data frame")
    body = frame[1:]
    tlen, pos = sn._uvarint_decode(body)
    topic = body[pos : pos + tlen].decode()
    payload = sn.decompress_block(body[pos + tlen :], max_output=MAX_MESSAGE)
    return topic, payload


def encode_control(ctrl: dict) -> bytes:
    return bytes([FRAME_CONTROL]) + json.dumps(ctrl).encode()


class GossipNode:
    """One node's gossipsub endpoint: a TCP listener + outbound peer links.

    `deliver(topic_name, ssz_bytes)` is invoked (on a receiver thread) for
    every novel message; `publish` pushes to the topic mesh."""

    def __init__(
        self,
        deliver,
        host: str = "127.0.0.1",
        port: int = 0,
        peer_db: PeerDB | None = None,
        node_id: str | None = None,
        d: int = D,
        d_low: int = D_LOW,
        d_high: int = D_HIGH,
        d_lazy: int = D_LAZY,
        heartbeat: bool = True,
    ):
        self.deliver = deliver
        self.node_id = node_id or "anon"
        self.peer_db = peer_db if peer_db is not None else PeerDB()
        self.d, self.d_low, self.d_high, self.d_lazy = d, d_low, d_high, d_lazy
        # peer socket -> its send lock: sendall from several threads (a
        # publish racing a forward) must not interleave frame bytes
        self._peers: dict[socket.socket, threading.Lock] = {}
        self._peer_ids: dict[socket.socket, str] = {}
        self._dialed: set[tuple] = set()  # outbound addrs (dial dedup)
        self._sock_dial_addr: dict[socket.socket, tuple] = {}
        # _peers_lock guards every compound mutation/iteration of the
        # shared peer/mesh/gossip state below (_peers, _peer_ids, _dialed,
        # _mesh, _mcache, _recent, _promises) — receiver threads and the
        # heartbeat all touch them. Sends and PeerDB calls happen OUTSIDE
        # the lock (sendall can block; _drop_peer re-acquires it).
        self._peers_lock = threading.Lock()
        self._mesh: dict[str, set[socket.socket]] = {}
        self._seen: OrderedDict[bytes, None] = OrderedDict()
        self._seen_lock = threading.Lock()
        # mcache: mid -> (topic, frame); _recent: ids to advertise via IHAVE
        self._mcache: OrderedDict[bytes, tuple[str, bytes]] = OrderedDict()
        self._recent: list[tuple[bytes, str]] = []
        # IWANT promises: mid -> (peer socket, logical peer id, deadline).
        # The id is captured at promise time: by expiry the peer may have
        # disconnected (socket closed, _peer_ids entry gone), and the
        # penalty must land on the LOGICAL id, not a phantom socket name —
        # else cycling connections sheds broken-promise penalties.
        self._promises: dict[bytes, tuple[socket.socket, str, float]] = {}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.addr = self._listener.getsockname()
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()
        if heartbeat:
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    # -- peering ---------------------------------------------------------------

    def connect(self, addr, timeout: float = 10.0) -> bool:
        """Dial a peer's listener; returns False when the address is
        already dialed (idempotent — periodic discovery sweeps must not
        stack duplicate links)."""
        addr = tuple(addr)
        with self._peers_lock:
            if addr in self._dialed:
                return False
            self._dialed.add(addr)
        try:
            sock = socket.create_connection(addr, timeout=timeout)
        except OSError:
            with self._peers_lock:
                self._dialed.discard(addr)  # retryable later
            raise
        # the connect timeout must not survive onto the long-lived link: a
        # blocking recv() on an idle mesh would raise after 10 s and the
        # recv loop would reap a healthy peer
        sock.settimeout(None)
        with self._peers_lock:
            self._sock_dial_addr[sock] = addr
        self._add_peer(sock)
        return True

    def _peer_id(self, sock: socket.socket) -> str:
        """Logical peer id: the HELLO-announced node id once received;
        transient address before that. Scoring a LOGICAL id means a banned
        peer cannot shed its score by reconnecting from a fresh ephemeral
        port (peerdb.rs keys records by PeerId, not socket address)."""
        pid = self._peer_ids.get(sock)
        if pid is None:
            try:
                pid = "%s:%d" % sock.getpeername()
            except OSError:
                pid = f"sock-{id(sock)}"
        return pid

    def _add_peer(self, sock: socket.socket) -> None:
        if not self.peer_db.on_connect(self._peer_id(sock)):
            try:
                sock.close()  # banned: refuse (peerdb.rs BanResult)
            except OSError:
                pass
            return
        with self._peers_lock:
            self._peers[sock] = threading.Lock()
        # identity handshake: announce our logical node id first
        self._send(sock, encode_control({"hello": self.node_id}))
        threading.Thread(target=self._recv_loop, args=(sock,), daemon=True).start()

    def _drop_peer(self, sock: socket.socket) -> None:
        with self._peers_lock:
            present = sock in self._peers
            if present:
                # resolve the pid BEFORE the mapping is dropped below
                pid = self._peer_id(sock)
                self._peers.pop(sock, None)
                # drop the id mapping too: a stale entry would leak per
                # reconnect and make report_invalid_message double-count
                # on_disconnect against sockets long dead
                self._peer_ids.pop(sock, None)
                dialed = self._sock_dial_addr.pop(sock, None)
                if dialed is not None:
                    self._dialed.discard(dialed)  # allow a future redial
                for mesh in self._mesh.values():
                    mesh.discard(sock)
        if present:
            self.peer_db.on_disconnect(pid)
        # not present: already dropped (a banned peer's dead socket gets
        # re-dropped by its recv loop and by heartbeat ban checks) — the
        # bookkeeping ran once, and resolving a pid NOW would fall back to
        # a phantom 'sock-<id>' and mint a junk PeerRecord per re-drop
        try:
            sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            self._add_peer(sock)

    # -- wire ------------------------------------------------------------------

    def _recv_loop(self, sock: socket.socket) -> None:
        while self._running:
            try:
                frame = _recv_frame(sock, cap=MAX_MESSAGE)
            except (OSError, ValueError, struct.error):
                # transport death, EOF, or an unframeable stream: reap the
                # peer — never leak a half-dead socket in _peers/_mesh
                self._drop_peer(sock)
                return
            try:
                self._on_frame(frame, source=sock)
            except Exception:  # noqa: BLE001 — an INTERNAL fault (e.g. a
                # race in our own bookkeeping) must not be charged to a
                # healthy peer: keep the link, skip the frame — but COUNT
                # it, or a systematic handler bug becomes invisible total
                # gossip loss
                from ..common.metrics import GOSSIP_INTERNAL_ERRORS_TOTAL

                GOSSIP_INTERNAL_ERRORS_TOTAL.inc()
                continue

    def _mark_seen(self, mid: bytes) -> bool:
        """True if novel (and marks it)."""
        with self._seen_lock:
            if mid in self._seen:
                return False
            self._seen[mid] = None
            while len(self._seen) > SEEN_CACHE:
                self._seen.popitem(last=False)
            return True

    def _on_frame(self, frame: bytes, source) -> None:
        if not self.peer_db.is_usable(self._peer_id(source)):
            # graylisted: connection dropped, requests ignored (peerdb.rs
            # score bands); reconnect allowed once the score decays
            self._drop_peer(source)
            return
        if frame and frame[0] == FRAME_CONTROL:
            self._on_control(frame, source)
            return
        try:
            topic, payload = decode_message(frame)
        except (ValueError, UnicodeDecodeError):
            # undecodable gossip: protocol violation (gossip_methods.rs
            # rejects + reports the peer)
            rec = self.peer_db.penalize(self._peer_id(source), PENALTY_PROTOCOL_VIOLATION)
            if rec.banned:
                self._drop_peer(source)
            return
        mid = message_id(payload)
        with self._peers_lock:
            self._promises.pop(mid, None)  # any promise on this id is fulfilled
        if not self._mark_seen(mid):
            return
        self._ensure_mesh(topic)
        # validate BEFORE propagating (gossipsub v1.1 flood-protection):
        # the app callback's verdict gates forwarding — a `False` return
        # means the payload failed validation, and relaying it would make
        # this node look like the attacker to its own mesh peers. Any
        # other return (None included) accepts the message.
        if self.deliver(topic, payload, self._peer_id(source)) is False:
            return
        self._remember(mid, topic, frame)
        self._push_to_mesh(topic, frame, exclude=source)

    def _on_control(self, frame: bytes, source) -> None:
        try:
            ctrl = json.loads(frame[1:])
            if not isinstance(ctrl, dict):
                raise ValueError("control frame must be an object")
            self._apply_control(ctrl, source)
        except (ValueError, TypeError, AttributeError, RecursionError):
            # hostile shapes anywhere in the structure ({"ihave": []},
            # {"graft": 5}, non-hex ids, deeply-nested json bombs that
            # overflow the parser's recursion, ...) are ONE violation, not
            # a receiver-thread crash — and must reach the penalty path,
            # not _recv_loop's internal-fault counter (a peer could feed
            # that alarm at line rate for free)
            rec = self.peer_db.penalize(self._peer_id(source), PENALTY_PROTOCOL_VIOLATION)
            if rec.banned:
                self._drop_peer(source)

    def _apply_control(self, ctrl: dict, source) -> None:
        hello = ctrl.get("hello")
        if isinstance(hello, str) and hello:
            # identity handshake: re-key the connection to the logical id
            # (carrying over nothing — scores live in the PeerDB by id)
            with self._peers_lock:
                prev = self._peer_ids.get(source)
                self._peer_ids[source] = hello
            if prev is not None and prev != hello:
                self.peer_db.on_disconnect(prev)
            if not self.peer_db.on_connect(hello):
                self._drop_peer(source)  # known-banned identity
                return
        prunes = []
        usable = self.peer_db.is_usable(self._peer_id(source))
        with self._peers_lock:
            for topic in ctrl.get("graft", []):
                # GRAFT is refused with PRUNE when the peer is graylisted
                # (v1.1 score gate) OR the mesh is already at D_HIGH —
                # admitting past the bound and trimming at the next
                # heartbeat leaves windows where the mesh exceeds its
                # contract (gossipsub spec: a full mesh answers GRAFT with
                # PRUNE immediately). The mesh entry is created only on
                # actual admission, so refused GRAFTs (e.g. a graylisted
                # peer spamming random topic names) cannot mint unbounded
                # empty mesh entries.
                mesh = self._mesh.get(str(topic), ())
                if usable and (source in mesh or len(mesh) < self.d_high):
                    self._mesh.setdefault(str(topic), set()).add(source)
                else:
                    prunes.append(topic)
            for topic in ctrl.get("prune", []):
                self._mesh.get(str(topic), set()).discard(source)
        if prunes:
            self._send(source, encode_control({"prune": prunes}))
        wanted = []
        ihave = ctrl.get("ihave", {})
        if not isinstance(ihave, dict):
            raise ValueError("ihave must map topics to id lists")
        for _topic, mids in ihave.items():
            for h in mids:
                mid = bytes.fromhex(h)
                with self._seen_lock:
                    novel = mid not in self._seen
                if not novel:
                    continue
                with self._peers_lock:
                    if mid not in self._promises:
                        self._promises[mid] = (
                            source,
                            self._peer_id(source),
                            time.monotonic() + IWANT_PROMISE_TTL,
                        )
                        wanted.append(h)
        if wanted:
            self._send(source, encode_control({"iwant": wanted}))
        for h in ctrl.get("iwant", []):
            with self._peers_lock:
                got = self._mcache.get(bytes.fromhex(h))
            if got is not None:
                self._send(source, got[1])

    def _remember(self, mid: bytes, topic: str, frame: bytes) -> None:
        with self._peers_lock:
            self._mcache[mid] = (topic, frame)
            while len(self._mcache) > MCACHE_SIZE:
                self._mcache.popitem(last=False)
            self._recent.append((mid, topic))

    # -- mesh maintenance (gossipsub heartbeat) --------------------------------

    def _ensure_mesh(self, topic: str) -> None:
        with self._peers_lock:
            mesh = self._mesh.setdefault(topic, set())
            if len(mesh) >= self.d_low:
                return
            candidates = [
                p
                for p in self._peers
                if p not in mesh and self.peer_db.is_usable(self._peer_id(p))
            ]
            random.shuffle(candidates)
            grafted = candidates[: self.d - len(mesh)]
            mesh.update(grafted)
        for p in grafted:
            self._send(p, encode_control({"graft": [topic]}))

    def heartbeat(self) -> None:
        """One gossipsub heartbeat: mesh degree maintenance, IHAVE gossip to
        non-mesh peers, broken-promise accounting. All shared-state reads
        and mutations happen under _peers_lock; sends and PeerDB penalties
        happen outside it."""
        # mesh upkeep
        low, pruned = [], []
        with self._peers_lock:
            for topic in list(self._mesh):
                mesh = self._mesh[topic]
                if len(mesh) < self.d_low:
                    low.append(topic)
                elif len(mesh) > self.d_high:
                    for p in random.sample(sorted(mesh, key=id), len(mesh) - self.d):
                        mesh.discard(p)
                        pruned.append((p, topic))
        for topic in low:
            self._ensure_mesh(topic)
        for p, topic in pruned:
            self._send(p, encode_control({"prune": [topic]}))
        # lazy gossip: advertise this window's ids to non-mesh peers
        with self._peers_lock:
            recent, self._recent = self._recent, []
        by_topic: dict[str, list[str]] = {}
        for mid, topic in recent[-256:]:
            by_topic.setdefault(topic, []).append(mid.hex())
        for topic, mids in by_topic.items():
            with self._peers_lock:
                mesh = self._mesh.get(topic, set())
                others = [p for p in self._peers if p not in mesh]
            for p in random.sample(others, min(self.d_lazy, len(others))):
                self._send(p, encode_control({"ihave": {topic: mids}}))
        # broken promises
        now = time.monotonic()
        broken = []
        with self._peers_lock:
            for mid, (peer, pid, deadline) in list(self._promises.items()):
                if deadline < now:
                    del self._promises[mid]
                    broken.append((peer, pid))
        for peer, pid in broken:
            rec = self.peer_db.penalize(pid, PENALTY_BROKEN_PROMISE)
            if rec.banned:
                self._drop_peer(peer)

    def _heartbeat_loop(self) -> None:
        while self._running:
            time.sleep(HEARTBEAT_INTERVAL)
            try:
                self.heartbeat()
            except Exception:  # noqa: BLE001 — heartbeat must never die,
                # but a silently-failing heartbeat means mesh maintenance
                # and promise accounting have stopped: count it
                from ..common.metrics import GOSSIP_INTERNAL_ERRORS_TOTAL

                GOSSIP_INTERNAL_ERRORS_TOTAL.inc()

    # -- sending ---------------------------------------------------------------

    def _send(self, peer: socket.socket, frame: bytes) -> None:
        lk = self._peers.get(peer)
        if lk is None:
            return
        try:
            with lk:
                _send_frame(peer, frame)
        except OSError:
            pass  # dead peer reaped by its recv loop

    def _push_to_mesh(self, topic: str, frame: bytes, exclude=None) -> None:
        with self._peers_lock:
            targets = list(self._mesh.get(topic, ()))
        for p in targets:
            if p is not exclude:
                self._send(p, frame)

    # -- API -------------------------------------------------------------------

    def publish(self, topic: str, ssz_bytes: bytes) -> None:
        frame = encode_message(topic, ssz_bytes)
        mid = message_id(ssz_bytes)
        self._mark_seen(mid)  # don't re-deliver to self
        self._remember(mid, topic, frame)
        self._ensure_mesh(topic)
        self._push_to_mesh(topic, frame)

    def report_invalid_message(self, source_peer_id: str) -> None:
        """Application feedback: a message from this peer failed admission
        (undecodable SSZ, bad container). Feeds the score; a banned peer's
        connections drop (behaviour reporting -> peer_manager)."""
        rec = self.peer_db.penalize(source_peer_id, PENALTY_INVALID_MESSAGE)
        if rec.banned:
            with self._peers_lock:
                peers = [p for p, pid in self._peer_ids.items() if pid == source_peer_id]
            for p in peers:
                self._drop_peer(p)

    def close(self) -> None:
        self._running = False
        try:
            self._listener.close()
        except OSError:
            pass
        with self._peers_lock:
            for p in self._peers:
                try:
                    p.close()
                except OSError:
                    pass
            self._peers.clear()
            self._mesh.clear()
