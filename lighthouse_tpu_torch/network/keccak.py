"""Keccak-256 (the pre-NIST padding variant Ethereum uses), pure Python.

Needed for EIP-778 ENR node ids and record signing
(lighthouse/beacon_node/lighthouse_network's discv5 dependency uses
it via the enr crate). Python's hashlib ships only NIST SHA3 (different
padding byte: 0x06 vs Keccak's 0x01), so the permutation is implemented
here; correctness is pinned by known-answer tests
(tests/test_torch_network_parity.py)."""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[list[int]]) -> None:
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        state[0][0] ^= rc


def _sponge256(data: bytes, domain: int) -> bytes:
    """The 1088-bit-rate sponge. domain=0x01 is Keccak-256; domain=0x06 is
    NIST SHA3-256 — the latter exists ONLY so tests can pin the multi-block
    absorb path against hashlib.sha3_256."""
    rate = 136  # 1088-bit rate for 256-bit output
    state = [[0] * 5 for _ in range(5)]

    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    if pad_len >= 2:
        padded += bytes([domain]) + b"\x00" * (pad_len - 2) + b"\x80"
    else:
        padded += bytes([domain | 0x80])

    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        _keccak_f(state)

    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return bytes(out)


def keccak256(data: bytes) -> bytes:
    return _sponge256(data, 0x01)


def sha3_256(data: bytes) -> bytes:
    """NIST SHA3-256 via the same sponge (test cross-check only)."""
    return _sponge256(data, 0x06)
