"""Peer manager: scored peer database with ban/graylist thresholds.

The role of lighthouse/beacon_node/lighthouse_network/src/
peer_manager/mod.rs:61 + peer_manager/peerdb.rs (score-driven connection
management) at harness scale. Scores follow the gossipsub-v1.1 shape used by
behaviour/gossipsub_scoring_parameters.rs:27 in spirit — additive penalties
for invalid messages, protocol violations, and broken IWANT promises, with
slow decay back toward zero — without the per-topic weighting machinery
(documented simplification).

Thresholds (peerdb.rs score bands):
  score <= GRAYLIST  -> all requests ignored, connections dropped
  score <= BAN       -> banned: reconnects refused until the score decays
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

GRAYLIST_THRESHOLD = -4.0
BAN_THRESHOLD = -8.0
DECAY_PER_SECOND = 0.05  # toward zero

# penalty weights (peer_manager/mod.rs report_peer call sites)
PENALTY_INVALID_MESSAGE = 2.0
PENALTY_PROTOCOL_VIOLATION = 4.0
PENALTY_BROKEN_PROMISE = 1.0
PENALTY_RATE_LIMITED = 1.0


@dataclass
class PeerRecord:
    """One peer's score book entry. Score decay and penalties are
    read-modify-write sequences hit concurrently by every receiver thread
    plus the gossip heartbeat, so each record carries its own lock; the
    `*_locked` helpers are called with it held (the convention the
    lock-guard analyzer enforces)."""

    peer_id: str
    score: float = 0.0
    connected: bool = False
    last_update: float = field(default_factory=time.monotonic)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def _decay_locked(self) -> None:
        now = time.monotonic()
        dt = now - self.last_update
        self.last_update = now
        if self.score < 0:
            self.score = min(0.0, self.score + dt * DECAY_PER_SECOND)

    def penalize(self, amount: float) -> None:
        with self._lock:
            self._decay_locked()
            self.score -= amount

    def try_connect(self) -> bool:
        """Atomically refuse-if-banned / mark-connected (peerdb.rs BanResult)."""
        with self._lock:
            self._decay_locked()
            if self.score <= BAN_THRESHOLD:
                return False
            self.connected = True
            return True

    def mark_disconnected(self) -> None:
        with self._lock:
            self.connected = False

    @property
    def banned(self) -> bool:
        with self._lock:
            self._decay_locked()
            return self.score <= BAN_THRESHOLD

    @property
    def graylisted(self) -> bool:
        with self._lock:
            self._decay_locked()
            return self.score <= GRAYLIST_THRESHOLD


class PeerDB:
    """Thread-safe score book; GossipNode and the RPC server consult it."""

    def __init__(self):
        self._peers: dict[str, PeerRecord] = {}
        self._lock = threading.Lock()

    def record(self, peer_id: str) -> PeerRecord:
        with self._lock:
            rec = self._peers.get(peer_id)
            if rec is None:
                rec = self._peers[peer_id] = PeerRecord(peer_id)
            return rec

    def penalize(self, peer_id: str, amount: float) -> PeerRecord:
        rec = self.record(peer_id)
        rec.penalize(amount)
        return rec

    def on_connect(self, peer_id: str) -> bool:
        """False if the peer is banned (refuse the connection)."""
        return self.record(peer_id).try_connect()

    def on_disconnect(self, peer_id: str) -> None:
        self.record(peer_id).mark_disconnected()

    def is_usable(self, peer_id: str) -> bool:
        return not self.record(peer_id).graylisted

    def connected_peers(self) -> list[str]:
        with self._lock:
            return [p for p, r in self._peers.items() if r.connected]


class RateLimiter:
    """Token-bucket request quotas per (peer, protocol)
    (rpc/rate_limiter.rs:59 Quota/Limiter)."""

    #: protocol -> (tokens, per_seconds) — the reference's beacon-node quotas
    QUOTAS = {
        "status": (5, 15),
        "goodbye": (1, 10),
        "ping": (2, 10),
        "metadata": (2, 5),
        "beacon_blocks_by_range": (128, 10),
        "beacon_blocks_by_root": (128, 10),
    }
    DEFAULT = (64, 10)

    def __init__(self):
        self._buckets: dict[tuple[str, str], tuple[float, float]] = {}
        self._lock = threading.Lock()

    def allow(self, peer_id: str, protocol: str, cost: float = 1.0) -> bool:
        max_tokens, per = self.QUOTAS.get(protocol, self.DEFAULT)
        rate = max_tokens / per
        now = time.monotonic()
        with self._lock:
            tokens, last = self._buckets.get((peer_id, protocol), (float(max_tokens), now))
            tokens = min(float(max_tokens), tokens + (now - last) * rate)
            if tokens < cost:
                self._buckets[(peer_id, protocol)] = (tokens, now)
                return False
            self._buckets[(peer_id, protocol)] = (tokens - cost, now)
            return True
