"""Pure-Python AES-128-CTR.

Fallback cipher for environments without the `cryptography` wheel.
EIP-2335 keystores encrypt 32-byte BLS secrets — a two-block workload —
so table-light pure Python is perfectly adequate. The SP 800-38A F.5.1
CTR stream is pinned in tests/test_torch_keys_parity.py.
"""

from __future__ import annotations


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


def _gmul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        b >>= 1
        a = _xtime(a)
    return r


def _build_sbox() -> list[int]:
    # log/antilog tables over generator 3, then the FIPS-197 affine map
    exp = [0] * 255
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x = _gmul(x, 3)
    sbox = [0x63] * 256
    for a in range(1, 256):
        inv = exp[(255 - log[a]) % 255]
        s = inv
        for sh in (1, 2, 3, 4):
            s ^= ((inv << sh) | (inv >> (8 - sh))) & 0xFF
        sbox[a] = s ^ 0x63
    return sbox


_SBOX = _build_sbox()
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _expand_key(key: bytes) -> list[list[int]]:
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum((w[4 * r + c] for c in range(4)), []) for r in range(11)]


def _shift_rows(s: list[int]) -> list[int]:
    # state is flat index 4*c + r (FIPS-197 column-major)
    out = list(s)
    for r in range(1, 4):
        row = [s[4 * c + r] for c in range(4)]
        row = row[r:] + row[:r]
        for c in range(4):
            out[4 * c + r] = row[c]
    return out


def _mix_columns(s: list[int]) -> list[int]:
    out = []
    for c in range(4):
        a0, a1, a2, a3 = s[4 * c : 4 * c + 4]
        out += [
            _gmul(a0, 2) ^ _gmul(a1, 3) ^ a2 ^ a3,
            a0 ^ _gmul(a1, 2) ^ _gmul(a2, 3) ^ a3,
            a0 ^ a1 ^ _gmul(a2, 2) ^ _gmul(a3, 3),
            _gmul(a0, 3) ^ a1 ^ a2 ^ _gmul(a3, 2),
        ]
    return out


def encrypt_block(key: bytes, block: bytes) -> bytes:
    if len(key) != 16 or len(block) != 16:
        raise ValueError("AES-128 needs a 16-byte key and 16-byte block")
    rk = _expand_key(key)
    s = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 10):
        s = _mix_columns(_shift_rows([_SBOX[b] for b in s]))
        s = [b ^ k for b, k in zip(s, rk[rnd])]
    s = _shift_rows([_SBOX[b] for b in s])
    return bytes(b ^ k for b, k in zip(s, rk[10]))


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """CTR keystream over the full 16-byte counter block (big-endian
    increment), XORed with `data`. Encryption and decryption are the same
    operation."""
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("AES-128-CTR needs a 16-byte key and 16-byte counter block")
    rk = _expand_key(key)
    ctr = int.from_bytes(iv, "big")
    out = bytearray()
    for off in range(0, len(data), 16):
        s = [b ^ k for b, k in zip(ctr.to_bytes(16, "big"), rk[0])]
        for rnd in range(1, 10):
            s = _mix_columns(_shift_rows([_SBOX[b] for b in s]))
            s = [b ^ k for b, k in zip(s, rk[rnd])]
        s = _shift_rows([_SBOX[b] for b in s])
        ks = bytes(b ^ k for b, k in zip(s, rk[10]))
        ctr = (ctr + 1) % (1 << 128)
        out += bytes(d ^ k for d, k in zip(data[off : off + 16], ks))
    return bytes(out)
