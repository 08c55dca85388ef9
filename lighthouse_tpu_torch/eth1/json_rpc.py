"""Eth1 JSON-RPC endpoint client + deposit-log ABI codec + mock server.

The role of lighthouse/beacon_node/eth1/src/http.rs (eth_blockNumber /
eth_getBlockByNumber / eth_getLogs over JSON-RPC, with endpoint fallback as
in service.rs's endpoint cycling) and deposit_log.rs (ABI decoding of the
deposit contract's DepositEvent). `JsonRpcEth1Endpoint` exposes the same
seam `Eth1Service` consumes (`latest_block` / `block_by_number` /
`deposit_logs_in_range`), so the service runs unchanged against a real
endpoint; `MockEth1RpcServer` serves the same three methods over real HTTP
for tests (test_utils mock server role).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

from ..network.keccak import keccak256
from ..types.containers import DepositData
from .service import Eth1Block

# keccak("DepositEvent(bytes,bytes,bytes,bytes,bytes)")
DEPOSIT_EVENT_TOPIC = "0x" + keccak256(
    b"DepositEvent(bytes,bytes,bytes,bytes,bytes)"
).hex()


class Eth1RpcError(Exception):
    pass


# -- DepositEvent ABI codec (deposit_log.rs DepositLog::from_log) --------------


def _abi_tail(data: bytes) -> bytes:
    """One dynamic `bytes` tail: 32-byte length + right-padded payload."""
    pad = (-len(data)) % 32
    return len(data).to_bytes(32, "big") + data + b"\x00" * pad


def encode_deposit_log(dd: DepositData, index: int) -> bytes:
    """ABI-encode DepositEvent's data (5 dynamic bytes params: pubkey,
    withdrawal_credentials, amount(LE bytes8), signature, index(LE bytes8))."""
    parts = [
        bytes(dd.pubkey),
        bytes(dd.withdrawal_credentials),
        int(dd.amount).to_bytes(8, "little"),
        bytes(dd.signature),
        int(index).to_bytes(8, "little"),
    ]
    head, tails = b"", b""
    offset = 32 * len(parts)
    for p in parts:
        head += offset.to_bytes(32, "big")
        tail = _abi_tail(p)
        tails += tail
        offset += len(tail)
    return head + tails


def decode_deposit_log(data: bytes) -> tuple[DepositData, int]:
    """Inverse of encode_deposit_log, with the reference's length checks."""

    def read_bytes(param: int) -> bytes:
        off = int.from_bytes(data[32 * param : 32 * param + 32], "big")
        n = int.from_bytes(data[off : off + 32], "big")
        out = data[off + 32 : off + 32 + n]
        if len(out) != n:
            raise Eth1RpcError("truncated deposit log")
        return out

    pubkey = read_bytes(0)
    wc = read_bytes(1)
    amount = read_bytes(2)
    signature = read_bytes(3)
    index = read_bytes(4)
    if len(pubkey) != 48 or len(wc) != 32 or len(amount) != 8 or len(signature) != 96:
        raise Eth1RpcError("deposit log field lengths invalid")
    dd = DepositData(
        pubkey=pubkey,
        withdrawal_credentials=wc,
        amount=int.from_bytes(amount, "little"),
        signature=signature,
    )
    return dd, int.from_bytes(index, "little")


# -- the client ----------------------------------------------------------------


class JsonRpcEth1Endpoint:
    """eth_* JSON-RPC over HTTP with first-success endpoint fallback
    (http.rs + the endpoint cycling of service.rs)."""

    def __init__(self, urls: list[str] | str, deposit_contract: str = "0x" + "00" * 20,
                 timeout: float = 8.0):
        self.urls = [urls] if isinstance(urls, str) else list(urls)
        self.deposit_contract = deposit_contract
        self.timeout = timeout
        self._id = 0

    def _call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        last: Exception | None = None
        for url in self.urls:
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"}, method="POST"
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    resp = json.loads(r.read())
            except (OSError, ValueError) as e:
                last = e
                continue
            if resp.get("error"):
                raise Eth1RpcError(f"{method}: {resp['error']}")
            return resp.get("result")
        raise Eth1RpcError(f"all eth1 endpoints failed for {method}: {last}")

    # Eth1Service seam ---------------------------------------------------------

    def latest_block(self) -> Eth1Block:
        number = int(self._call("eth_blockNumber", []), 16)
        return self.block_by_number(number)

    def block_by_number(self, number: int) -> Eth1Block | None:
        j = self._call("eth_getBlockByNumber", [hex(number), False])
        if j is None:
            return None
        return Eth1Block(
            number=int(j["number"], 16),
            hash=bytes.fromhex(j["hash"].removeprefix("0x")),
            timestamp=int(j["timestamp"], 16),
        )

    def deposit_logs_in_range(self, lo: int, hi: int):
        logs = self._call(
            "eth_getLogs",
            [
                {
                    "address": self.deposit_contract,
                    "topics": [DEPOSIT_EVENT_TOPIC],
                    "fromBlock": hex(max(0, lo)),
                    "toBlock": hex(hi),
                }
            ],
        )
        out = []
        for log in logs or []:
            data = bytes.fromhex(log["data"].removeprefix("0x"))
            dd, _index = decode_deposit_log(data)
            out.append((int(log["blockNumber"], 16), dd))
        return out


# -- mock HTTP server ----------------------------------------------------------


class MockEth1RpcServer:
    """Serves eth_blockNumber / eth_getBlockByNumber / eth_getLogs over real
    HTTP, backed by a MockEth1Endpoint's in-memory chain."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0):
        self.backend = backend
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
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

    def _dispatch(self, method: str, params: list):
        be = self.backend
        if method == "eth_blockNumber":
            return hex(be.latest_block().number)
        if method == "eth_getBlockByNumber":
            blk = be.block_by_number(int(params[0], 16))
            if blk is None:
                return None
            return {
                "number": hex(blk.number),
                "hash": "0x" + blk.hash.hex(),
                "timestamp": hex(blk.timestamp),
            }
        if method == "eth_getLogs":
            f = params[0]
            lo, hi = int(f["fromBlock"], 16), int(f["toBlock"], 16)
            out = []
            for i, (n, dd) in enumerate(be.deposit_logs_in_range(lo, hi)):
                out.append(
                    {
                        "address": f.get("address", "0x" + "00" * 20),
                        "topics": [DEPOSIT_EVENT_TOPIC],
                        "data": "0x" + encode_deposit_log(dd, i).hex(),
                        "blockNumber": hex(n),
                    }
                )
            return out
        raise ValueError(f"unknown method {method}")

    def start(self) -> "MockEth1RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
