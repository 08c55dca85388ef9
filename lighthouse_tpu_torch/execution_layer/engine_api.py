"""Engine-API client: JSON-RPC over HTTP with JWT auth + engine fallback.

Python rendering of lighthouse/beacon_node/execution_layer/src/
engine_api/http.rs (the JSON-RPC transport + jsonwebtoken auth) and
engines.rs (multi-engine first-success fallback with periodic upcheck —
the watchdog routine at lib.rs:317). Methods covered are the merge-era
Engine API surface the bellatrix transition needs:

    engine_newPayloadV1
    engine_forkchoiceUpdatedV1
    engine_getPayloadV1
    engine_exchangeTransitionConfigurationV1

`ExecutionLayer.notify_new_payload` plugs into
state_transition.bellatrix.process_execution_payload via
TransitionContext.execution_engine; SYNCING/ACCEPTED statuses map to
optimistic import (the reference's PayloadVerificationStatus::Optimistic).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.request

JWT_VALID_SECONDS = 60


class EngineApiError(Exception):
    pass


class PayloadStatus:
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def jwt_token(secret: bytes, now: int | None = None) -> str:
    """HS256 JWT with an `iat` claim — the Engine API auth scheme
    (engine_api/auth.rs)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = _b64url(json.dumps({"iat": int(now if now is not None else time.time())}).encode())
    signing_input = header + b"." + claims
    sig = hmac.new(secret, signing_input, hashlib.sha256).digest()
    return (signing_input + b"." + _b64url(sig)).decode()


def payload_to_json(payload) -> dict:
    """ExecutionPayload container -> Engine API JSON (quantities as 0x-hex,
    json_structures.rs)."""
    q = lambda n: hex(int(n))
    b = lambda v: "0x" + bytes(v).hex()
    return {
        "parentHash": b(payload.parent_hash),
        "feeRecipient": b(payload.fee_recipient),
        "stateRoot": b(payload.state_root),
        "receiptsRoot": b(payload.receipts_root),
        "logsBloom": "0x" + bytes(payload.logs_bloom).hex(),
        "prevRandao": b(payload.prev_randao),
        "blockNumber": q(payload.block_number),
        "gasLimit": q(payload.gas_limit),
        "gasUsed": q(payload.gas_used),
        "timestamp": q(payload.timestamp),
        "extraData": "0x" + bytes(payload.extra_data).hex(),
        "baseFeePerGas": q(payload.base_fee_per_gas),
        "blockHash": b(payload.block_hash),
        "transactions": ["0x" + bytes(tx).hex() for tx in payload.transactions],
    }


def json_to_payload(t, j: dict):
    """Engine API JSON -> ExecutionPayload container (json_structures.rs,
    inverse of payload_to_json)."""
    unb = lambda v: bytes.fromhex(v[2:]) if isinstance(v, str) else bytes(v)
    unq = lambda v: int(v, 16) if isinstance(v, str) else int(v)
    return t.ExecutionPayload(
        parent_hash=unb(j["parentHash"]),
        fee_recipient=unb(j["feeRecipient"]),
        state_root=unb(j["stateRoot"]),
        receipts_root=unb(j["receiptsRoot"]),
        logs_bloom=unb(j["logsBloom"]),
        prev_randao=unb(j["prevRandao"]),
        block_number=unq(j["blockNumber"]),
        gas_limit=unq(j["gasLimit"]),
        gas_used=unq(j["gasUsed"]),
        timestamp=unq(j["timestamp"]),
        extra_data=unb(j["extraData"]),
        base_fee_per_gas=unq(j["baseFeePerGas"]),
        block_hash=unb(j["blockHash"]),
        transactions=[unb(tx) for tx in j.get("transactions", [])],
    )


class EngineApiClient:
    """One engine endpoint (http.rs HttpJsonRpc)."""

    def __init__(self, url: str, jwt_secret: bytes | None = None, timeout: float = 8.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self.jwt_secret is not None:
            headers["Authorization"] = f"Bearer {jwt_token(self.jwt_secret)}"
        req = urllib.request.Request(self.url, data=body, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                resp = json.loads(r.read())
        except OSError as e:
            raise EngineApiError(f"engine unreachable: {e}") from e
        except ValueError as e:  # non-JSON body behind a broken proxy
            raise EngineApiError(f"engine returned non-JSON: {e}") from e
        if "error" in resp and resp["error"]:
            raise EngineApiError(f"engine error: {resp['error']}")
        return resp.get("result")

    # -- methods ---------------------------------------------------------------

    def new_payload(self, payload) -> dict:
        return self.call("engine_newPayloadV1", [payload_to_json(payload)])

    def forkchoice_updated(
        self, head_hash: bytes, safe_hash: bytes, finalized_hash: bytes, attrs: dict | None = None
    ) -> dict:
        state = {
            "headBlockHash": "0x" + head_hash.hex(),
            "safeBlockHash": "0x" + safe_hash.hex(),
            "finalizedBlockHash": "0x" + finalized_hash.hex(),
        }
        return self.call("engine_forkchoiceUpdatedV1", [state, attrs])

    def get_payload(self, payload_id: str) -> dict:
        return self.call("engine_getPayloadV1", [payload_id])

    def exchange_transition_configuration(self, ttd: int, terminal_hash: bytes) -> dict:
        return self.call(
            "engine_exchangeTransitionConfigurationV1",
            [
                {
                    "terminalTotalDifficulty": hex(ttd),
                    "terminalBlockHash": "0x" + terminal_hash.hex(),
                    "terminalBlockNumber": "0x0",
                }
            ],
        )

    def upcheck(self) -> bool:
        """The watchdog probe (lib.rs:317 periodic upcheck)."""
        try:
            self.exchange_transition_configuration(0, b"\x00" * 32)
            return True
        except EngineApiError:
            return False


class ExecutionLayer:
    """First-success fallback over several engines (engines.rs), exposing
    the TransitionContext.execution_engine seam."""

    def __init__(self, engines: list[EngineApiClient]):
        if not engines:
            raise ValueError("at least one engine required")
        self.engines = list(engines)
        self.last_status: str | None = None

    def notify_new_payload(self, payload) -> bool:
        """True = payload may be imported: VALID immediately, or
        SYNCING/ACCEPTED optimistically (payload_invalidation-style INVALID
        rejects). Engines are tried in order; the first that answers wins
        (engines.rs first_success)."""
        err: Exception | None = None
        for engine in self.engines:
            try:
                result = engine.new_payload(payload)
            except EngineApiError as e:
                err = e
                continue
            status = (result or {}).get("status", PayloadStatus.SYNCING)
            self.last_status = status
            return status in (
                PayloadStatus.VALID,
                PayloadStatus.SYNCING,
                PayloadStatus.ACCEPTED,
            )
        raise EngineApiError(f"all engines failed: {err}")

    def forkchoice_updated(
        self, head: bytes, safe: bytes, finalized: bytes, attrs: dict | None = None
    ) -> dict:
        err: Exception | None = None
        for engine in self.engines:
            try:
                return engine.forkchoice_updated(head, safe, finalized, attrs)
            except EngineApiError as e:
                err = e
        raise EngineApiError(f"all engines failed: {err}")

    def build_payload(
        self,
        t,
        head_hash: bytes,
        timestamp: int,
        prev_randao: bytes,
        fee_recipient: bytes = b"\x00" * 20,
        safe_hash: bytes | None = None,
        finalized_hash: bytes | None = None,
    ):
        """The production flow of lighthouse/beacon_node/execution_layer/
        src/lib.rs:142-148 (get_payload): forkchoiceUpdated with payload
        attributes -> payloadId -> getPayload -> ExecutionPayload container."""
        attrs = {
            "timestamp": hex(int(timestamp)),
            "prevRandao": "0x" + bytes(prev_randao).hex(),
            "suggestedFeeRecipient": "0x" + bytes(fee_recipient).hex(),
        }
        resp = self.forkchoice_updated(
            head_hash,
            safe_hash if safe_hash is not None else head_hash,
            finalized_hash if finalized_hash is not None else head_hash,
            attrs,
        )
        payload_id = (resp or {}).get("payloadId")
        if payload_id is None:
            raise EngineApiError("engine returned no payloadId")
        err: Exception | None = None
        for engine in self.engines:
            try:
                j = engine.get_payload(payload_id)
            except EngineApiError as e:
                err = e
                continue
            if j is None:
                # this engine never saw the id (another engine built it):
                # keep trying the rest of the fallback list
                err = EngineApiError(f"engine did not know payloadId {payload_id}")
                continue
            return json_to_payload(t, j)
        raise EngineApiError(f"all engines failed: {err}")

    def upcheck(self) -> list[bool]:
        return [e.upcheck() for e in self.engines]
