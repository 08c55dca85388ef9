"""Remote-monitoring push client.

Python rendering of lighthouse/common/monitoring_api (gather.rs +
lib.rs): periodically POST a JSON snapshot of beacon-node / validator /
system health to a remote monitoring endpoint (beaconcha.in-style schema:
a list of records tagged with `process`: "beaconnode" / "validator" /
"system").

Transport is stdlib urllib with a short timeout; failures are swallowed and
counted (monitoring must never take the node down).
"""

from __future__ import annotations

import json
import resource
import sys
import time
import urllib.request

from ..common.logging import KvLogger

log = KvLogger("monitoring")

VERSION = 1
CLIENT_NAME = "lighthouse_tpu"


def gather_beacon_node(chain) -> dict:
    """The beaconnode record (gather.rs BeaconProcessMetrics)."""
    state = chain.head_state()
    return {
        "version": VERSION,
        "timestamp": int(time.time() * 1000),
        "process": "beaconnode",
        "client_name": CLIENT_NAME,
        "sync_beacon_head_slot": int(state.slot) if state is not None else 0,
        "sync_eth2_synced": True,
        "store_blocks": len(chain.store),
        "finalized_epoch": int(state.finalized_checkpoint.epoch) if state is not None else 0,
    }


def gather_validator(validator_count: int, active_count: int) -> dict:
    return {
        "version": VERSION,
        "timestamp": int(time.time() * 1000),
        "process": "validator",
        "client_name": CLIENT_NAME,
        "validator_total": validator_count,
        "validator_active": active_count,
    }


def gather_system() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "version": VERSION,
        "timestamp": int(time.time() * 1000),
        "process": "system",
        "client_name": CLIENT_NAME,
        "cpu_process_seconds_total": int(ru.ru_utime + ru.ru_stime),
        # ru_maxrss is KiB on Linux but bytes on macOS
        "memory_process_bytes": ru.ru_maxrss * (1 if sys.platform == "darwin" else 1024),
    }


class MonitoringService:
    """Pushes snapshots to `endpoint` no more often than `update_period`
    seconds (monitoring_api lib.rs's MonitoringHttpClient + its 60 s
    default period)."""

    def __init__(self, endpoint: str, chain=None, validator_store=None, update_period: int = 60):
        self.endpoint = endpoint
        self.chain = chain
        self.validator_store = validator_store
        self.update_period = update_period
        self.sent = 0
        self.errors = 0
        self._last_send = 0.0

    def gather(self) -> list[dict]:
        records = []
        if self.chain is not None:
            records.append(gather_beacon_node(self.chain))
        if self.validator_store is not None:
            n = len(self.validator_store.pubkeys())
            records.append(gather_validator(n, n))
        records.append(gather_system())
        return records

    def send(self) -> bool:
        """One push; never raises. The attempt (not the success) stamps the
        period clock so an endpoint outage costs one timeout per period, not
        one per tick."""
        self._last_send = time.monotonic()
        body = json.dumps(self.gather()).encode()
        req = urllib.request.Request(
            self.endpoint,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                ok = 200 <= r.status < 300
        except Exception as e:  # noqa: BLE001 — monitoring is best-effort
            log.debug("monitoring push failed", error=str(e))
            self.errors += 1
            return False
        if ok:
            self.sent += 1
        else:
            self.errors += 1
        return ok

    def tick(self) -> bool | None:
        """Call from any periodic loop; sends when the period has elapsed."""
        if time.monotonic() - self._last_send >= self.update_period:
            return self.send()
        return None
