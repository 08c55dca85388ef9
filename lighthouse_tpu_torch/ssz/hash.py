"""SSZ Merkleization: hash_tree_root machinery.

Role of the reference's tree_hash crate (lighthouse/consensus/tree_hash/
src/): pack values into 32-byte chunks, merkleize to a fixed-depth root with
precomputed zero-subtree hashes, mix in lengths/selectors for lists/unions.

Host implementation uses hashlib's C SHA-256. A device-side batched
Merkleization (vmapped SHA-256 compression over chunk planes) is a later
optimization hook for epoch-scale state hashing —
the chunking layout here (flat arrays of 32-byte chunks) is already the
device-friendly layout.
"""

from __future__ import annotations

import hashlib

BYTES_PER_CHUNK = 32
ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# zero_hashes[i] = root of a depth-i tree of zero chunks.
ZERO_HASHES: list[bytes] = [ZERO_CHUNK]
for _ in range(64):
    ZERO_HASHES.append(
        hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest()
    )


def hash_pair(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pack_bytes(data: bytes) -> list[bytes]:
    """Pad serialized basic-value bytes to whole 32-byte chunks."""
    if not data:
        return []
    if len(data) % BYTES_PER_CHUNK:
        data = data + b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return [data[i : i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)]


_NATIVE_MIN_CHUNKS = 8  # below this, ctypes call overhead beats the win
_ZERO_TABLE = None


def _native_zero_table() -> bytes:
    global _ZERO_TABLE
    if _ZERO_TABLE is None:
        _ZERO_TABLE = b"".join(ZERO_HASHES)
    return _ZERO_TABLE


def merkleize(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Merkle root over `chunks`, virtually padded with zero chunks to
    next_pow_of_two(limit or len). Matches the spec's merkleize(): a limit
    smaller than the chunk count is an error.

    Large chunk planes route through the native C hasher (the
    eth2_hashing native-SHA role) when it built successfully; the
    hashlib path is the always-available fallback and the differential
    reference for it (tests/test_common.py)."""
    count = len(chunks)
    if limit is None:
        width = next_pow_of_two(count)
    else:
        if count > limit:
            raise ValueError(f"{count} chunks exceed limit {limit}")
        width = next_pow_of_two(limit)
    depth = (width - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]
    if count >= _NATIVE_MIN_CHUNKS:
        from .. import native

        if native.available():
            return native.merkleize(b"".join(chunks), count, depth, _native_zero_table())
    layer = list(chunks)
    for d in range(depth):
        nxt = []
        for i in range(0, len(layer), 2):
            left = layer[i]
            right = layer[i + 1] if i + 1 < len(layer) else ZERO_HASHES[d]
            nxt.append(hash_pair(left, right))
        layer = nxt
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_pair(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_pair(root, selector.to_bytes(32, "little"))
