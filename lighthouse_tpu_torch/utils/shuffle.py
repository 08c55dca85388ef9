"""Swap-or-not committee shuffling.

Role of lighthouse/consensus/swap_or_not_shuffle: the spec's
`compute_shuffled_index` (single index) and the optimized whole-list shuffle
(`shuffle_list`, lighthouse/consensus/swap_or_not_shuffle/src/
shuffle_list.rs:79). The whole-list form here is numpy-vectorized: each of
the 90 rounds computes every position's swap bit from n/256 block hashes at
once — the natural batch layout (and trivially liftable to a device kernel
if epoch processing ever wants it resident).

Both directions (shuffle/unshuffle) run the rounds forward or backward, as
in the reference.
"""

from __future__ import annotations

import hashlib

import numpy as np

SHUFFLE_ROUND_COUNT = 90


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(
    index: int, list_size: int, seed: bytes, rounds: int = SHUFFLE_ROUND_COUNT
) -> int:
    """Spec's single-index swap-or-not (consensus/swap_or_not_shuffle/src/
    compute_shuffled_index.rs:21)."""
    if not 0 <= index < list_size:
        raise ValueError("index out of range")
    if list_size > 2**40:
        raise ValueError("list too large")
    for r in range(rounds):
        pivot = int.from_bytes(_hash(seed + bytes([r]))[:8], "little") % list_size
        flip = (pivot + list_size - index) % list_size
        position = max(index, flip)
        source = _hash(seed + bytes([r]) + (position // 256).to_bytes(4, "little"))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def shuffle_list(
    indices: np.ndarray | list[int],
    seed: bytes,
    forwards: bool = True,
    rounds: int = SHUFFLE_ROUND_COUNT,
) -> np.ndarray:
    """Permute a whole index list (vectorized).

    Direction contract (asserted in tests):
        shuffle_list(x, seed)[i] == x[compute_shuffled_index(i, n, seed)]
    i.e. the whole-list form agrees with the spec's single-index map; the
    inverse (`forwards=False` / unshuffle_list) undoes it — the same pair
    the reference exposes (shuffle_list.rs runs rounds forward or reverse)."""
    out = np.asarray(indices, dtype=np.uint64).copy()
    n = out.size
    if n == 0:
        return out
    positions = np.arange(n, dtype=np.uint64)
    order = range(rounds - 1, -1, -1) if forwards else range(rounds)
    # `out` holds the value at each slot; swap-or-not acts on positions, so
    # track the permutation by shuffling slot contents in place.
    for r in order:
        pivot = int.from_bytes(_hash(seed + bytes([r]))[:8], "little") % n
        flips = (np.uint64(pivot) + np.uint64(n) - positions) % np.uint64(n)
        pos = np.maximum(positions, flips)
        n_blocks = (n + 255) // 256
        blocks = np.frombuffer(
            b"".join(
                _hash(seed + bytes([r]) + blk.to_bytes(4, "little"))
                for blk in range(n_blocks)
            ),
            dtype=np.uint8,
        )
        byte_idx = (pos // np.uint64(8)).astype(np.int64)
        bits = (blocks[byte_idx] >> (pos % np.uint64(8)).astype(np.uint8)) & 1
        # swap each i<j pair (i, flip) exactly once: act on the half where
        # position == flip >= index
        do_swap = bits.astype(bool)
        src = np.where(do_swap, flips, positions).astype(np.int64)
        out = out[src]
    return out


def unshuffle_list(indices, seed: bytes, rounds: int = SHUFFLE_ROUND_COUNT) -> np.ndarray:
    return shuffle_list(indices, seed, forwards=False, rounds=rounds)
