"""Web3Signer remote signing: HTTP client + in-process mock server.

The second arm of the reference's SigningMethod enum
(lighthouse/validator_client/src/signing_method.rs:75-90
{LocalKeystore, Web3Signer}) plus the testing harness role of
lighthouse/testing/web3signer_tests (which drives a real Web3Signer
JVM): keys whose secret lives in an external signer service reached over
HTTP, signing by 32-byte signing root.

API surface (the Web3Signer ETH2 interface):
  GET  /upcheck                      -> 200 "OK"
  GET  /api/v1/eth2/publicKeys      -> JSON ["0x<48-byte pk>", ...]
  POST /api/v1/eth2/sign/0x<pk>     -> {"signature": "0x<96-byte sig>"}
       body: {"type": <duty type>, "signingRoot": "0x<32 bytes>"}

`RemoteKey` mimics a local SecretKey's `sign(root) -> has .to_bytes()`
shape, so a ValidatorStore holds local and remote keys in the same map and
every signing path works unchanged (the reference's SigningMethod seam).
The store stamps each RemoteKey call with the duty type so the request's
"type" field is truthful; the type-specific payload bodies a hardened
Web3Signer deployment can demand for ITS OWN slashing checks (fork_info,
full block/attestation data) are not reproduced — this client targets
signers trusting the VC-side EIP-3076 database, and says so here rather
than pretending otherwise."""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer


class Web3SignerError(Exception):
    pass


class Web3SignerClient:
    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.url + path, timeout=self.timeout) as r:
            return r.read()

    def upcheck(self) -> bool:
        try:
            return self._get("/upcheck").strip() in (b"OK", b'"OK"')
        except OSError:
            return False

    def public_keys(self) -> list[bytes]:
        raw = json.loads(self._get("/api/v1/eth2/publicKeys"))
        return [bytes.fromhex(h.removeprefix("0x")) for h in raw]

    def sign(self, pubkey: bytes, signing_root: bytes, duty_type: str = "AGGREGATION_SLOT") -> bytes:
        body = json.dumps(
            {"type": duty_type, "signingRoot": "0x" + signing_root.hex()}
        ).encode()
        req = urllib.request.Request(
            f"{self.url}/api/v1/eth2/sign/0x{pubkey.hex()}",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                payload = json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise Web3SignerError(f"signer returned {e.code}") from e
        except OSError as e:
            raise Web3SignerError(f"signer unreachable: {e}") from e
        return bytes.fromhex(payload["signature"].removeprefix("0x"))


class _RemoteSignature:
    def __init__(self, raw: bytes):
        self._raw = raw

    def to_bytes(self) -> bytes:
        return self._raw


class RemoteKey:
    """Drop-in for a local SecretKey inside ValidatorStore.keys: same
    `sign(root)` shape, signature produced by the remote service. The
    ValidatorStore sets `duty_type` before each call (set_duty) so the HTTP
    request declares what is being signed."""

    def __init__(self, pubkey: bytes, client: Web3SignerClient):
        self.pubkey = pubkey
        self.client = client
        self._duty_type = "AGGREGATION_SLOT"

    def set_duty(self, duty_type: str) -> "RemoteKey":
        self._duty_type = duty_type
        return self

    def sign(self, signing_root: bytes) -> _RemoteSignature:
        return _RemoteSignature(
            self.client.sign(self.pubkey, signing_root, duty_type=self._duty_type)
        )


class MockWeb3Signer:
    """In-process signer service holding real secret keys (the role the
    reference's web3signer_tests JVM plays)."""

    def __init__(self, secret_keys, host: str = "127.0.0.1", port: int = 0):
        # secret_keys: list of backend SecretKey objects
        self.keys = {sk.public_key().to_bytes(): sk for sk in secret_keys}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/upcheck":
                    self._ok(b"OK", "text/plain")
                elif self.path == "/api/v1/eth2/publicKeys":
                    body = json.dumps(["0x" + pk.hex() for pk in outer.keys]).encode()
                    self._ok(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                prefix = "/api/v1/eth2/sign/0x"
                if not self.path.startswith(prefix):
                    self.send_response(404)
                    self.end_headers()
                    return
                pk = bytes.fromhex(self.path[len(prefix) :])
                sk = outer.keys.get(pk)
                if sk is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                root = bytes.fromhex(req["signingRoot"].removeprefix("0x"))
                sig = sk.sign(root).to_bytes()
                self._ok(json.dumps({"signature": "0x" + sig.hex()}).encode())

            def _ok(self, body: bytes, ctype: str = "application/json"):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = HTTPServer((host, port), Handler)
        self.url = f"http://{host}:{self._server.server_port}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def start(self) -> "MockWeb3Signer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
