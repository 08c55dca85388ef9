"""RLP codec + EIP-778 Ethereum Node Records (ENR).

The identity layer of the reference's discovery stack
(lighthouse/beacon_node/lighthouse_network/src/discovery/enr.rs — the
`enr` + `discv5` crates): a signed, sequenced key/value record carrying a
node's identity (secp256k1 pubkey), endpoints (ip/udp/tcp), and eth2 fields
(fork digest via the "eth2" key). The "v4" identity scheme signs the RLP
content with secp256k1/keccak256; node id = keccak256(uncompressed pubkey
coordinates).

Interop is pinned by decoding and verifying the EIP-778 example record in
tests/test_torch_network_parity.py (same node id, same textual form
round-trip).
"""

from __future__ import annotations

import base64

try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        Prehashed,
        decode_dss_signature,
        encode_dss_signature,
    )

    _HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:  # container without the wheel: pure fallback
    _HAVE_CRYPTOGRAPHY = False

from ..crypto import secp256k1 as _secp
from .keccak import keccak256

MAX_ENR_SIZE = 300


# -- RLP -----------------------------------------------------------------------


def rlp_encode(item) -> bytes:
    """bytes or nested lists of bytes -> RLP."""
    if isinstance(item, (bytes, bytearray)):
        data = bytes(item)
        if len(data) == 1 and data[0] < 0x80:
            return data
        return _rlp_length(len(data), 0x80) + data
    if isinstance(item, int):  # canonical integer: big-endian, no leading zeros
        return rlp_encode(item.to_bytes((item.bit_length() + 7) // 8, "big") if item else b"")
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _rlp_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _rlp_length(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def rlp_decode(data: bytes):
    item, rest = _rlp_decode_one(data)
    if rest:
        raise ValueError("rlp: trailing bytes")
    return item


def _rlp_decode_one(data: bytes):
    if not data:
        raise ValueError("rlp: empty input")
    b0 = data[0]
    if b0 < 0x80:
        return bytes([b0]), data[1:]
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        if len(data) < 1 + n:
            raise ValueError("rlp: truncated string")
        if n == 1 and data[1] < 0x80:
            raise ValueError("rlp: non-canonical single byte")
        return data[1 : 1 + n], data[1 + n :]
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        n = int.from_bytes(data[1 : 1 + ln], "big")
        if n < 56 or (ln > 1 and data[1] == 0):
            raise ValueError("rlp: non-canonical length")
        start = 1 + ln
        if len(data) < start + n:
            raise ValueError("rlp: truncated string")
        return data[start : start + n], data[start + n :]
    # lists
    if b0 < 0xF8:
        n = b0 - 0xC0
        ln = 1
    else:
        lb = b0 - 0xF7
        n = int.from_bytes(data[1 : 1 + lb], "big")
        if n < 56 or (lb > 1 and data[1] == 0):
            raise ValueError("rlp: non-canonical length")
        ln = 1 + lb
    if len(data) < ln + n:
        raise ValueError("rlp: truncated list")
    payload = data[ln : ln + n]
    out = []
    while payload:
        item, payload = _rlp_decode_one(payload)
        out.append(item)
    return out, data[ln + n :]


# -- secp256k1 identity scheme -------------------------------------------------


def generate_key() -> "ec.EllipticCurvePrivateKey":
    if _HAVE_CRYPTOGRAPHY:
        return ec.generate_private_key(ec.SECP256K1())
    return _secp.PrivateKey.generate()

def private_key_from_bytes(raw: bytes) -> "ec.EllipticCurvePrivateKey":
    if _HAVE_CRYPTOGRAPHY:
        return ec.derive_private_key(int.from_bytes(raw, "big"), ec.SECP256K1())
    return _secp.PrivateKey(int.from_bytes(raw, "big"))


def compressed_pubkey(key) -> bytes:
    """33-byte SEC1 compressed point of a private or public key."""
    pub = key.public_key() if hasattr(key, "public_key") else key
    nums = pub.public_numbers()
    return bytes([0x02 + (nums.y & 1)]) + nums.x.to_bytes(32, "big")


def pubkey_from_compressed(data: bytes) -> "ec.EllipticCurvePublicKey":
    if _HAVE_CRYPTOGRAPHY:
        return ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256K1(), data)
    return _secp.PublicKey.from_compressed(data)


def node_id_from_pubkey(pub: ec.EllipticCurvePublicKey) -> bytes:
    nums = pub.public_numbers()
    return keccak256(nums.x.to_bytes(32, "big") + nums.y.to_bytes(32, "big"))


_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def _sign_v4(key: "ec.EllipticCurvePrivateKey", content: bytes) -> bytes:
    digest = keccak256(content)
    if isinstance(key, _secp.PrivateKey):
        r, s = key.sign_digest(digest)
    else:
        der = key.sign(digest, ec.ECDSA(Prehashed(hashes.SHA256())))
        r, s = decode_dss_signature(der)
    if s > _N // 2:  # low-s normalization (EIP-778 convention)
        s = _N - s
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def _verify_v4(pub: "ec.EllipticCurvePublicKey", signature: bytes, content: bytes) -> bool:
    if len(signature) != 64:
        return False
    r = int.from_bytes(signature[:32], "big")
    s = int.from_bytes(signature[32:], "big")
    if isinstance(pub, _secp.PublicKey):
        return pub.verify_digest(r, s, keccak256(content))
    try:
        der = encode_dss_signature(r, s)
        pub.verify(der, keccak256(content), ec.ECDSA(Prehashed(hashes.SHA256())))
        return True
    except Exception:  # noqa: BLE001 — invalid signature
        return False


# -- ENR -----------------------------------------------------------------------


class Enr:
    """A decoded node record: seq + sorted key/value pairs + signature."""

    def __init__(self, seq: int, pairs: dict[bytes, bytes], signature: bytes):
        self.seq = seq
        self.pairs = dict(pairs)
        self.signature = signature

    # -- building --------------------------------------------------------------

    @classmethod
    def build(
        cls,
        key: ec.EllipticCurvePrivateKey,
        seq: int = 1,
        ip: str | None = None,
        udp: int | None = None,
        tcp: int | None = None,
        extra: dict[bytes, bytes] | None = None,
    ) -> "Enr":
        pairs: dict[bytes, bytes] = {b"id": b"v4", b"secp256k1": compressed_pubkey(key)}
        if ip is not None:
            pairs[b"ip"] = bytes(int(o) for o in ip.split("."))
        if udp is not None:
            pairs[b"udp"] = udp.to_bytes(2, "big")
        if tcp is not None:
            pairs[b"tcp"] = tcp.to_bytes(2, "big")
        if extra:
            pairs.update(extra)
        content = cls._content_rlp(seq, pairs)
        return cls(seq, pairs, _sign_v4(key, content))

    @staticmethod
    def _content_rlp(seq: int, pairs: dict[bytes, bytes]) -> bytes:
        items: list = [seq]
        for k in sorted(pairs):
            items += [k, pairs[k]]
        return rlp_encode(items)

    # -- identity --------------------------------------------------------------

    def public_key(self) -> ec.EllipticCurvePublicKey:
        return pubkey_from_compressed(self.pairs[b"secp256k1"])

    def node_id(self) -> bytes:
        return node_id_from_pubkey(self.public_key())

    def verify(self) -> bool:
        if self.pairs.get(b"id") != b"v4" or b"secp256k1" not in self.pairs:
            return False
        content = self._content_rlp(self.seq, self.pairs)
        try:
            return _verify_v4(self.public_key(), self.signature, content)
        except ValueError:
            return False

    # -- endpoints -------------------------------------------------------------

    def ip(self) -> str | None:
        raw = self.pairs.get(b"ip")
        return ".".join(str(b) for b in raw) if raw else None

    def udp(self) -> int | None:
        raw = self.pairs.get(b"udp")
        return int.from_bytes(raw, "big") if raw else None

    def tcp(self) -> int | None:
        raw = self.pairs.get(b"tcp")
        return int.from_bytes(raw, "big") if raw else None

    # -- wire / text -----------------------------------------------------------

    def to_rlp(self) -> bytes:
        items: list = [self.signature, self.seq]
        for k in sorted(self.pairs):
            items += [k, self.pairs[k]]
        out = rlp_encode(items)
        if len(out) > MAX_ENR_SIZE:
            raise ValueError("ENR exceeds 300 bytes")
        return out

    @classmethod
    def from_rlp(cls, data: bytes) -> "Enr":
        if len(data) > MAX_ENR_SIZE:
            raise ValueError("ENR exceeds 300 bytes")
        items = rlp_decode(data)
        if not isinstance(items, list) or len(items) < 2 or len(items) % 2 != 0:
            raise ValueError("malformed ENR")
        signature, seq_raw = items[0], items[1]
        pairs: dict[bytes, bytes] = {}
        prev = None
        for i in range(2, len(items), 2):
            k, v = items[i], items[i + 1]
            if prev is not None and k <= prev:
                raise ValueError("ENR keys not strictly sorted")
            prev = k
            pairs[k] = v
        return cls(int.from_bytes(seq_raw, "big"), pairs, signature)

    def to_text(self) -> str:
        return "enr:" + base64.urlsafe_b64encode(self.to_rlp()).rstrip(b"=").decode()

    @classmethod
    def from_text(cls, text: str) -> "Enr":
        if not text.startswith("enr:"):
            raise ValueError("missing enr: prefix")
        b64 = text[4:]
        pad = "=" * (-len(b64) % 4)
        return cls.from_rlp(base64.urlsafe_b64decode(b64 + pad))

    def __eq__(self, other):
        return (
            isinstance(other, Enr)
            and self.seq == other.seq
            and self.pairs == other.pairs
            and self.signature == other.signature
        )
