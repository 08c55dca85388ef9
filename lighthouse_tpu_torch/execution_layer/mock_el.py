"""Mock execution engine: an in-process Engine-API JSON-RPC server.

The role of lighthouse/beacon_node/execution_layer/src/test_utils/
(the mock EL the harness and payload-invalidation tests drive): validates
the JWT, answers the V1 engine methods, remembers payloads, and can be
configured to declare payloads INVALID or itself go offline — the fault
injection the reference uses in beacon_chain/tests/payload_invalidation.rs.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer


class MockExecutionEngine:
    def __init__(self, jwt_secret: bytes | None = None, host: str = "127.0.0.1", port: int = 0):
        self.jwt_secret = jwt_secret
        self.payloads: dict[str, dict] = {}  # blockHash -> payload json
        self.forkchoice: dict | None = None
        self.next_status = "VALID"  # fault injection: set to INVALID/SYNCING
        self.offline = False
        self.requests: list[str] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if outer.offline:
                    self.send_response(503)
                    self.end_headers()
                    return
                if outer.jwt_secret is not None and not outer._check_jwt(
                    self.headers.get("Authorization", "")
                ):
                    self.send_response(401)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                result = outer._dispatch(req["method"], req.get("params", []))
                body = json.dumps(
                    {"jsonrpc": "2.0", "id": req.get("id"), "result": result}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = HTTPServer((host, port), Handler)
        self.url = f"http://{host}:{self._server.server_port}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def _check_jwt(self, auth_header: str) -> bool:
        from .engine_api import JWT_VALID_SECONDS

        if not auth_header.startswith("Bearer "):
            return False
        token = auth_header[len("Bearer ") :]
        try:
            signing_input, sig_b64 = token.rsplit(".", 1)
            expected = hmac.new(
                self.jwt_secret, signing_input.encode(), hashlib.sha256
            ).digest()
            pad = "=" * (-len(sig_b64) % 4)
            got = base64.urlsafe_b64decode(sig_b64 + pad)
            if not hmac.compare_digest(expected, got):
                return False
            claims_b64 = signing_input.split(".")[1]
            claims = json.loads(
                base64.urlsafe_b64decode(claims_b64 + "=" * (-len(claims_b64) % 4))
            )
            # iat freshness (engine_api auth: tokens are short-lived)
            return abs(time.time() - claims.get("iat", 0)) <= JWT_VALID_SECONDS
        except (ValueError, TypeError):
            return False

    def _dispatch(self, method: str, params: list):
        self.requests.append(method)
        if method == "engine_newPayloadV1":
            payload = params[0]
            status = self.next_status
            if status == "VALID":
                self.payloads[payload["blockHash"]] = payload
            return {"status": status, "latestValidHash": payload["parentHash"], "validationError": None}
        if method == "engine_forkchoiceUpdatedV1":
            self.forkchoice = params[0]
            attrs = params[1] if len(params) > 1 else None
            payload_id = None
            if attrs:
                # synthesize a payload honoring the attributes (the mock EL
                # in test_utils/mock_execution_layer.rs does the same)
                self._payload_counter = getattr(self, "_payload_counter", 0) + 1
                payload_id = hex(0x0101010101010000 + self._payload_counter)
                parent = params[0]["headBlockHash"]
                body = {
                    "parentHash": parent,
                    "feeRecipient": attrs.get("suggestedFeeRecipient", "0x" + "00" * 20),
                    "stateRoot": "0x" + "11" * 32,
                    "receiptsRoot": "0x" + "22" * 32,
                    "logsBloom": "0x" + "00" * 256,
                    "prevRandao": attrs["prevRandao"],
                    "blockNumber": hex(self._payload_counter),
                    "gasLimit": hex(30_000_000),
                    "gasUsed": "0x0",
                    "timestamp": attrs["timestamp"],
                    "extraData": "0x",
                    "baseFeePerGas": hex(7),
                }
                body["blockHash"] = "0x" + hashlib.sha256(
                    json.dumps(body, sort_keys=True).encode()
                ).digest().hex()
                body["transactions"] = []
                self.built_payloads = getattr(self, "built_payloads", {})
                self.built_payloads[payload_id] = body
            return {
                "payloadStatus": {"status": "VALID", "latestValidHash": None, "validationError": None},
                "payloadId": payload_id or "0x0101010101010101",
            }
        if method == "engine_getPayloadV1":
            built = getattr(self, "built_payloads", {})
            if params and params[0] in built:
                return built[params[0]]
            return next(iter(self.payloads.values()), None)
        if method == "engine_exchangeTransitionConfigurationV1":
            return params[0]
        raise ValueError(f"unknown method {method}")

    def start(self) -> "MockExecutionEngine":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
