"""Pure-Python secp256k1 ECDSA.

Fallback for the ENR "v4" identity scheme (network/enr.py) when the
`cryptography` wheel is absent. Jacobian-coordinate arithmetic keeps a
scalar multiplication to a few thousand bigint mults (one modular
inversion at the end), which is milliseconds in CPython — ENR signing is
a handful of scalar mults per record, far off any hot path. Nonces are
deterministic RFC 6979 (HMAC-SHA256), so record signatures are
reproducible. Known answers and the EIP-778 example record are pinned in
tests/test_torch_network_parity.py.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


# -- Jacobian point arithmetic (a = 0, b = 7; None = infinity) -----------------


def _jdbl(pt):
    if pt is None:
        return None
    x1, y1, z1 = pt
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = b * b % P
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y1 * z1 % P
    return (x3, y3, z3)


def _jadd(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    zz1 = z1 * z1 % P
    zz2 = z2 * z2 % P
    u1 = x1 * zz2 % P
    u2 = x2 * zz1 % P
    s1 = y1 * zz2 * z2 % P
    s2 = y2 * zz1 * z1 % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jdbl(p1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = hh * h % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = h * z1 * z2 % P
    return (x3, y3, z3)


def _to_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _mul(k: int, x: int, y: int):
    """k * (x, y) in affine, None for infinity."""
    acc = None
    pt = (x, y, 1)
    while k:
        if k & 1:
            acc = _jadd(acc, pt)
        pt = _jdbl(pt)
        k >>= 1
    return _to_affine(acc)


# -- ECDSA ---------------------------------------------------------------------


def _rfc6979_nonces(d: int, digest: bytes):
    z = int.from_bytes(digest, "big") % N
    bx = d.to_bytes(32, "big") + z.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + bx, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + bx, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


class PublicKey:
    def __init__(self, x: int, y: int):
        if not (0 <= x < P and 0 <= y < P) or (y * y - (x * x * x + 7)) % P != 0:
            raise ValueError("point not on secp256k1")
        self.x = x
        self.y = y

    def public_numbers(self) -> "PublicKey":
        # mirrors the accessor shape of cryptography's EllipticCurvePublicKey
        return self

    @classmethod
    def from_compressed(cls, data: bytes) -> "PublicKey":
        if len(data) != 33 or data[0] not in (2, 3):
            raise ValueError("bad SEC1 compressed point")
        x = int.from_bytes(data[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        rhs = (x * x * x + 7) % P
        y = pow(rhs, (P + 1) // 4, P)  # p ≡ 3 (mod 4)
        if y * y % P != rhs:
            raise ValueError("x not on curve")
        if (y & 1) != (data[0] & 1):
            y = P - y
        return cls(x, y)

    def to_compressed(self) -> bytes:
        return bytes([0x02 + (self.y & 1)]) + self.x.to_bytes(32, "big")

    def verify_digest(self, r: int, s: int, digest: bytes) -> bool:
        if not (1 <= r < N and 1 <= s < N):
            return False
        z = int.from_bytes(digest, "big")
        w = pow(s, -1, N)
        a = _mul(z * w % N, GX, GY)
        b = _mul(r * w % N, self.x, self.y)
        pa = None if a is None else (a[0], a[1], 1)
        pb = None if b is None else (b[0], b[1], 1)
        pt = _to_affine(_jadd(pa, pb))
        return pt is not None and pt[0] % N == r


class PrivateKey:
    def __init__(self, d: int):
        if not 1 <= d < N:
            raise ValueError("private scalar out of range")
        self.d = d
        self._pub: PublicKey | None = None

    @classmethod
    def generate(cls) -> "PrivateKey":
        return cls(1 + secrets.randbelow(N - 1))

    def public_key(self) -> PublicKey:
        if self._pub is None:
            x, y = _mul(self.d, GX, GY)
            self._pub = PublicKey(x, y)
        return self._pub

    def sign_digest(self, digest: bytes) -> tuple[int, int]:
        z = int.from_bytes(digest, "big")
        for k in _rfc6979_nonces(self.d, digest):
            pt = _mul(k, GX, GY)
            if pt is None:
                continue
            r = pt[0] % N
            if r == 0:
                continue
            s = pow(k, -1, N) * (z + r * self.d) % N
            if s != 0:
                return r, s
        raise AssertionError("unreachable")
