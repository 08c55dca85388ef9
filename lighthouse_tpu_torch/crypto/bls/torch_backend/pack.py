"""Host-side packing between ref-oracle objects and the two limb layouts.

Device layout: Montgomery-form (..., 12) int32 words (fp.py), used for
the device constants.

Wire layout: the JAX package's Montgomery-form (..., 32) twelve-bit limbs.
`stage_sets` emits it, so staged bytes compare directly between the two
packages; api.py converts it to words on the device after one copy.

Only used at the host/device boundary, never inside the verify path.
"""

from __future__ import annotations

import numpy as np

from ..constants import G1_GENERATOR_X, G1_GENERATOR_Y, G2_GENERATOR_X, G2_GENERATOR_Y, P
from ..ref.curves import Point
from ..ref.fields import Fp2
from . import fp

# -- device words ----------------------------------------------------------------


def pack_fp(x: int) -> np.ndarray:
    return fp.to_mont_host(x)


def pack_fp2(c0: int, c1: int) -> np.ndarray:
    return np.stack([pack_fp(c0), pack_fp(c1)])


def pack_fp2_el(x: Fp2) -> np.ndarray:
    return pack_fp2(x.c0.n, x.c1.n)


# Generator constants (device words): substitutes for masked lanes in the
# branch-free pairing code and the fixed (-g1) pairing input.
G1_GEN_X_L = pack_fp(G1_GENERATOR_X)
G1_GEN_Y_L = pack_fp(G1_GENERATOR_Y)
G1_GEN_NEG_Y_L = pack_fp(P - G1_GENERATOR_Y)
G2_GEN_X_L = pack_fp2(*G2_GENERATOR_X)
G2_GEN_Y_L = pack_fp2(*G2_GENERATOR_Y)

# -- wire limbs (the JAX package's staged layout) --------------------------------


def ints_to_wire_limbs(xs) -> np.ndarray:
    """(n, 32) int32 twelve-bit limbs; every 3 little-endian bytes carry
    two limbs."""
    n = len(xs)
    if n == 0:
        return np.empty((0, fp.JAX_LIMBS), dtype=np.int32)
    try:
        buf = b"".join(x.to_bytes(fp.BITS // 8, "little") for x in xs)
    except (OverflowError, AttributeError) as e:
        raise ValueError("value out of limb range") from e
    trip = np.frombuffer(buf, dtype=np.uint8).reshape(n, fp.JAX_LIMBS // 2, 3).astype(np.int32)
    out = np.empty((n, fp.JAX_LIMBS), dtype=np.int32)
    out[:, 0::2] = trip[..., 0] | ((trip[..., 1] & 0x0F) << 8)
    out[:, 1::2] = (trip[..., 1] >> 4) | (trip[..., 2] << 4)
    return out


def to_mont_wire_bulk(xs) -> np.ndarray:
    return ints_to_wire_limbs([(x % P) * fp.R_MONT % P for x in xs])


# -- batch packing with per-point limb-row caching -----------------------------
#
# The staging hot path. Limb rows are memoized on the Point itself (its
# `_limbs` slot): a validator pubkey is packed once per process, later
# stagings gather the rows. Misses convert in ONE bulk call.


def _pack_batch(pts, row_shape, coords_of, split_rows):
    xs = np.zeros((len(pts), *row_shape), dtype=np.int32)
    ys = np.zeros_like(xs)
    infs = np.zeros(len(pts), dtype=bool)
    miss: dict[int, list[int]] = {}  # id(pt) -> positions (dedup in-batch)
    for i, pt in enumerate(pts):
        if pt.inf:
            infs[i] = True
            continue
        rows = getattr(pt, "_limbs", None)
        if rows is None:
            miss.setdefault(id(pt), []).append(i)
        else:
            xs[i] = rows[0]
            ys[i] = rows[1]
    if miss:
        coords: list[int] = []
        for idxs in miss.values():
            coords.extend(coords_of(pts[idxs[0]]))
        limbs = to_mont_wire_bulk(coords)
        for k, idxs in enumerate(miss.values()):
            # copies, so a cached point does not pin the whole batch array
            x_row, y_row = (r.copy() for r in split_rows(limbs, k))
            x_row.setflags(write=False)
            y_row.setflags(write=False)
            pts[idxs[0]]._limbs = (x_row, y_row)
            for i in idxs:
                xs[i] = x_row
                ys[i] = y_row
    return xs, ys, infs


def pack_g1_batch(pts: list[Point]):
    """(x, y, inf) wire limbs of G1 points: (n, 32), (n, 32), (n,)."""
    return _pack_batch(
        pts,
        (fp.JAX_LIMBS,),
        lambda pt: (pt.x.n, pt.y.n),
        lambda limbs, k: (limbs[2 * k], limbs[2 * k + 1]),
    )


def pack_g2_batch(pts: list[Point]):
    """(x, y, inf) wire limbs of G2 points: (n, 2, 32), (n, 2, 32), (n,)."""
    return _pack_batch(
        pts,
        (2, fp.JAX_LIMBS),
        lambda pt: (pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n),
        lambda limbs, k: (limbs[4 * k : 4 * k + 2], limbs[4 * k + 2 : 4 * k + 4]),
    )


def precompute_limbs(pt: Point) -> None:
    """Attach a point's wire-limb rows now (no-op for infinity or a point
    already packed), so the first batch that stages it is a cache hit."""
    if pt.inf or getattr(pt, "_limbs", None) is not None:
        return
    if isinstance(pt.x, Fp2):
        pack_g2_batch([pt])
    else:
        pack_g1_batch([pt])
