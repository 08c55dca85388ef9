"""UDP peer discovery: PING/PONG/FINDNODE/NODES over ENRs with a
log-distance routing table.

The role of lighthouse/beacon_node/lighthouse_network/src/discovery/
(the discv5 crate + subnet_predicate.rs) and of the standalone boot node
(lighthouse/boot_node/src/lib.rs:1): nodes hold signed ENRs, learn
peers' records over UDP, keep them in Kademlia buckets by
log2(node_id XOR distance), and answer FINDNODE with the records at the
requested distances — the workflow a fresh node uses to find its first
gossip/RPC peers from a boot ENR.

Wire: one RLP list per datagram — [msg_type, request_id, *payload] — with
every learned ENR signature-verified before the table admits it. Deviation
from discv5 v5.1, stated plainly: the session-encryption layer (masked
headers, WHOAREYOU handshake, AES-GCM frames) is NOT implemented; records
themselves carry the same authentication (secp256k1 over keccak256) the
spec's handshake proves.
"""

from __future__ import annotations

import secrets
import socket
import threading

from .enr import Enr, rlp_decode, rlp_encode

PING = 0x01
PONG = 0x02
FINDNODE = 0x03
NODES = 0x04

MAX_DATAGRAM = 1280  # discv5's packet budget
BUCKET_SIZE = 16
N_BUCKETS = 256


def log2_distance(a: bytes, b: bytes) -> int:
    """Kademlia log-distance: bit length of a XOR b (0 = same id)."""
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return x.bit_length()


class RoutingTable:
    """Fixed-size XOR-metric buckets (the discv5 crate's kbucket table).

    Thread-safe: the recv loop learns records while API callers
    (bootstrap/find_node) walk the table from their own threads."""

    def __init__(self, local_id: bytes):
        self.local_id = local_id
        self._lock = threading.Lock()
        self.buckets: list[list[Enr]] = [[] for _ in range(N_BUCKETS + 1)]

    def insert(self, enr: Enr) -> bool:
        nid = enr.node_id()
        if nid == self.local_id:
            return False
        with self._lock:
            bucket = self.buckets[log2_distance(self.local_id, nid)]
            for i, existing in enumerate(bucket):
                if existing.node_id() == nid:
                    if enr.seq > existing.seq:
                        bucket[i] = enr  # newer record replaces
                    return True
            if len(bucket) >= BUCKET_SIZE:
                return False  # full bucket: drop (no eviction ping, noted)
            bucket.append(enr)
            return True

    def at_distance(self, distance: int) -> list[Enr]:
        if not 0 <= distance <= N_BUCKETS:
            return []
        with self._lock:
            return list(self.buckets[distance])

    def closest(self, target_id: bytes, limit: int = BUCKET_SIZE) -> list[Enr]:
        with self._lock:
            all_nodes = [e for b in self.buckets for e in b]
        all_nodes.sort(key=lambda e: log2_distance(target_id, e.node_id()))
        return all_nodes[:limit]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self.buckets)


class DiscoveryService:
    """One node's discovery endpoint. `boot_mode=True` is the boot_node
    profile: answer queries, never query out."""

    def __init__(
        self,
        key,
        host: str = "127.0.0.1",
        port: int = 0,
        boot_mode: bool = False,
        tcp_port: int | None = None,
    ):
        self.key = key
        self.boot_mode = boot_mode
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self.addr = self._sock.getsockname()
        # tcp = the node's gossip/rpc listener: discovered peers dial it
        # (the ENR tcp field lighthouse_network reads for libp2p dialing)
        self.enr = Enr.build(
            key, seq=1, ip=self.addr[0], udp=self.addr[1], tcp=tcp_port
        )
        self.table = RoutingTable(self.enr.node_id())
        self._pending: dict[bytes, threading.Event] = {}
        self._responses: dict[bytes, list] = {}
        self._lock = threading.Lock()
        self._running = True
        threading.Thread(target=self._recv_loop, daemon=True).start()

    # -- wire ------------------------------------------------------------------

    def _send(self, addr, msg_type: int, request_id: bytes, payload: list) -> None:
        data = rlp_encode([bytes([msg_type]), request_id, *payload])
        if len(data) > MAX_DATAGRAM:
            raise ValueError("datagram exceeds discv5 budget")
        self._sock.sendto(data, addr)

    def _recv_loop(self) -> None:
        while self._running:
            try:
                data, addr = self._sock.recvfrom(MAX_DATAGRAM)
            except OSError:
                return  # socket closed: the service is shutting down
            try:
                items = rlp_decode(data)
                msg_type = items[0][0]
                request_id = items[1]
                payload = items[2:]
            except (ValueError, IndexError):
                continue  # malformed datagram drops (the sender's fault)
            try:
                self._handle(addr, msg_type, request_id, payload)
            except Exception:  # noqa: BLE001 — an INTERNAL fault (a bug in
                # our own handler, a send failure) must not kill the recv
                # loop and silently deafen discovery — COUNT it and keep
                # serving (as gossip's _recv_loop does)
                from ..common.metrics import DISCOVERY_INTERNAL_ERRORS_TOTAL

                DISCOVERY_INTERNAL_ERRORS_TOTAL.inc()
                continue

    def _handle(self, addr, msg_type: int, request_id: bytes, payload: list) -> None:
        if msg_type == PING:
            # payload: [sender_enr_rlp]; answer with our record
            self._learn(payload[0] if payload else b"")
            self._send(addr, PONG, request_id, [self.enr.to_rlp()])
        elif msg_type == PONG:
            self._learn(payload[0] if payload else b"")
            self._complete(request_id, payload)
        elif msg_type == FINDNODE:
            # payload: [[distance_bytes, ...]] (discv5 v5.1 multi-distance)
            distances = [int.from_bytes(d, "big") for d in payload[0]] if payload else []
            enrs = []
            for d in distances:
                enrs.extend(e.to_rlp() for e in self.table.at_distance(d))
            if 0 in distances:
                enrs.append(self.enr.to_rlp())
            # fit the datagram budget
            out, total = [], 0
            for e in enrs:
                if total + len(e) > MAX_DATAGRAM - 64:
                    break
                out.append(e)
                total += len(e)
            self._send(addr, NODES, request_id, [out])
        elif msg_type == NODES:
            records = payload[0] if payload else []
            for raw in records:
                self._learn(raw)
            self._complete(request_id, payload)

    def _learn(self, enr_rlp: bytes) -> None:
        if not enr_rlp:
            return
        try:
            enr = Enr.from_rlp(bytes(enr_rlp))
        except ValueError:
            return
        if enr.verify():  # unsigned/forged records never enter the table
            self.table.insert(enr)

    def _complete(self, request_id: bytes, payload: list) -> None:
        with self._lock:
            ev = self._pending.get(bytes(request_id))
            if ev is None:
                return  # unsolicited/late response: never store (no growth)
            self._responses[bytes(request_id)] = payload
        ev.set()

    def _request(self, addr, msg_type: int, payload: list, timeout: float):
        request_id = secrets.token_bytes(8)
        ev = threading.Event()
        with self._lock:
            self._pending[request_id] = ev
        try:
            self._send(addr, msg_type, request_id, payload)
            if not ev.wait(timeout):
                return None
            with self._lock:
                return self._responses.pop(request_id, None)
        finally:
            with self._lock:
                self._pending.pop(request_id, None)
                self._responses.pop(request_id, None)  # timed-out-but-arrived

    # -- API -------------------------------------------------------------------

    def ping(self, enr: Enr, timeout: float = 5.0) -> bool:
        addr = (enr.ip(), enr.udp())
        resp = self._request(addr, PING, [self.enr.to_rlp()], timeout)
        if resp is None:
            return False
        self.table.insert(enr)
        return True

    def find_node(self, enr: Enr, distances: list[int], timeout: float = 5.0) -> list[Enr]:
        addr = (enr.ip(), enr.udp())
        payload = [[d.to_bytes(2, "big") if d else b"" for d in distances]]
        resp = self._request(addr, FINDNODE, payload, timeout)
        if not resp:
            return []
        out = []
        for raw in resp[0]:
            try:
                e = Enr.from_rlp(bytes(raw))
            except ValueError:
                continue
            if e.verify():
                out.append(e)
        return out

    def bootstrap(self, boot_enr: Enr, rounds: int = 3) -> int:
        """Join via a boot node: ping it, then iteratively FINDNODE at the
        distances around our own id (the discv5 table-fill walk)."""
        if not self.ping(boot_enr):
            return 0
        my_id = self.enr.node_id()
        for _ in range(rounds):
            targets = list(self.table.closest(my_id, limit=3)) or [boot_enr]
            for peer in targets:
                d = log2_distance(peer.node_id(), my_id)
                # random 256-bit ids concentrate in the top buckets, so
                # always sweep those alongside the peer-relative distances
                # (discv5 fills its table by querying random target ids)
                distances = sorted(
                    {d, max(1, d - 1), min(256, d + 1), 256, 255, 254, 253}
                )
                self.find_node(peer, distances)
        return len(self.table)

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
