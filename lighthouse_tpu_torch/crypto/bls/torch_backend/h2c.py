"""Hash-to-G2 split across host and device.

HOST  : expand_message_xmd (SHA-256) and the reduction to two Fp2 field
        elements per message, packed to the wire limbs `stage_sets` emits,
        behind a process-wide LRU keyed by (message, dst).
DEVICE: simplified SWU onto E' with its Fp2 square roots (one launch of
        K13), the 3-isogeny to E2 (one launch of K14), and the sum of
        the two points with the psi-method cofactor clearing (one
        launch of K17). `sswu_composed`, `iso3_map_composed` and
        `clear_cofactor_composed` keep K13, K14 and K17 as compositions
        over a `TowerOps` or the curve's field operations, their plain
        versions over the plain operations.

Semantics are pinned to the ref oracle (ref/hash_to_curve.py). The device
formulas mirror the JAX package (lighthouse_tpu jax_backend/h2c.py), so
the projective points are bit-identical to its points.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..constants import DST, P, X as X_PARAM
from ..ref import hash_to_curve as ref_h2c
from ..ref.fields import Fp as RefFp, Fp2 as RefFp2
from . import fp, tower
from .curve import _PSI_C, FP2, FP2_PLAIN, FieldOps, Proj, add as proj_add, dbl, neg as proj_neg, psi
from .curve import scalar_mul_bits, stack2, unstack
from .pack import pack_fp2_el, to_mont_wire_bulk
from .tower import fp2, fp2_eq, fp2_inv, fp2_is_zero, fp2_one, fp2_select, fp2_sgn0

# -- constants (device words) ----------------------------------------------------

_A = pack_fp2_el(ref_h2c.ISO_A)
_B = pack_fp2_el(ref_h2c.ISO_B)
_Z = pack_fp2_el(ref_h2c.SSWU_Z)
# x1 constants: C1 = -B/A (generic branch), C2 = B/(Z A) (tv1 == 0 branch)
_C1 = pack_fp2_el(-(ref_h2c.ISO_B * ref_h2c.ISO_A.inv()))
_C2 = pack_fp2_el(ref_h2c.ISO_B * (ref_h2c.SSWU_Z * ref_h2c.ISO_A).inv())
_X0 = pack_fp2_el(ref_h2c._ISO_X0)
_T = pack_fp2_el(ref_h2c._ISO_T)
_U = pack_fp2_el(ref_h2c._ISO_U)
_INV9 = fp.to_mont_host(ref_h2c._INV9.n)
_INV27 = fp.to_mont_host(ref_h2c._INV27.n)  # carries the -1/27 sign pin
_MINUS_ONE = pack_fp2_el(RefFp2(RefFp(P - 1), RefFp(0)))

_SQRT_E1 = (P - 3) // 4
_SQRT_E2 = (P - 1) // 2
# K13's and K14's constant operand, one Fp2 row each (INV9 and INV27 with a
# zero c1): A, B, Z, C1, C2, X0, T, U, INV9, INV27
_H2C_CONSTS = np.stack([_A, _B, _Z, _C1, _C2, _X0, _T, _U,
                        np.stack([_INV9, fp.ZERO]), np.stack([_INV27, fp.ZERO])])


def _one_like(x):
    """Fp2 one with the batch shape and device of x."""
    return fp2_one(x.shape[:-2], x.device)


def fp2_sqrt_candidate(x, T: tower.TowerOps):
    """Branch-free Fp2 square-root candidate (Adj-Rodriguez-Henriquez for
    p = 3 mod 4, as ref/fields.py), over the operations T; on the card it
    runs inside K13 (`sswu`). Callers check cand^2 == x."""
    F = T.fp
    a1 = fp.pow_windowed(x, _SQRT_E1, T.fp2_mul, T.fp2_sqr, _one_like(x))  # x^((p-3)/4)
    x0 = T.fp2_mul(a1, x)
    alpha = T.fp2_mul(a1, x0)
    ux0 = fp2(F.neg(x0[..., 1, :]), x0[..., 0, :])  # u * x0
    b = fp.pow_windowed(F.add(alpha, _one_like(alpha)), _SQRT_E2, T.fp2_mul, T.fp2_sqr, _one_like(x))
    cand = T.fp2_mul(b, x0)
    is_m1 = fp2_eq(alpha, fp.const(_MINUS_ONE, x.device))
    return fp2_select(is_m1, ux0, cand)


def sswu_composed(u, T: tower.TowerOps):
    """Simplified SWU onto E' (branch-free), over the operations T: the
    composition K13 replaced (T = tower.KERNEL_TOWER) or K13's plain version
    (tower.PLAIN_TOWER). u: (..., 2, W) -> affine (x, y)."""
    F = T.fp
    dev = u.device
    A, B, Z = (fp.const(c, dev) for c in (_A, _B, _Z))
    u2 = T.fp2_sqr(u)
    zu2 = T.fp2_mul(Z, u2)
    t1 = F.add(T.fp2_sqr(zu2), zu2)
    t1_zero = fp2_is_zero(t1)
    x1_generic = T.fp2_mul(fp.const(_C1, dev), F.add(_one_like(t1), fp2_inv(t1, F)))
    x1 = fp2_select(t1_zero, fp.const(_C2, dev), x1_generic)
    x2 = T.fp2_mul(zu2, x1)
    xs = torch.stack([x1, x2])
    gx = F.add(F.add(T.fp2_mul(T.fp2_sqr(xs), xs), T.fp2_mul(A, xs)), B)
    cand = fp2_sqrt_candidate(gx, T)  # both candidates in one stacked chain
    y1, y2 = cand[0], cand[1]
    is_sq = fp2_eq(T.fp2_sqr(y1), gx[0])
    x = fp2_select(is_sq, x1, x2)
    y = fp2_select(is_sq, y1, y2)
    flip = fp2_sgn0(u, F) != fp2_sgn0(y, F)
    return x, fp2_select(flip, F.neg(y), y)


def sswu_plain(u):
    """K13's plain version: PyTorch operations only, on any device."""
    return sswu_composed(u, tower.PLAIN_TOWER)


def sswu(u):
    """Simplified SWU onto E' (branch-free). u: (..., 2, W) -> affine (x, y):
    one launch of K13 (csrc/h2c_kernels.cu) for a CUDA tensor, the plain
    version for a CPU tensor."""
    cpu = fp._is_cpu(u)
    tower._check_trailing(u, (2, fp.WORDS), "Fp2")
    if cpu:
        return sswu_plain(u)
    from . import kernels

    out = torch.empty((2, *u.shape), dtype=torch.int32, device=u.device)
    n = u.numel() // (2 * fp.WORDS)
    a, sa = tower._operand(u, u.shape, 2, 2 * fp.WORDS)
    kernels.launch("lh_sswu", u.device, a.data_ptr(), sa, fp.const(_H2C_CONSTS, u.device).data_ptr(),
                   out.data_ptr(), n)
    fp._count("sswu", n)
    return out[0], out[1]


def iso3_map_composed(x, y, T: tower.TowerOps) -> Proj:
    """The 3-isogeny E' -> E2 (ref/hash_to_curve.py) as a projective point,
    over the operations T: the composition K14 replaced (T =
    tower.KERNEL_TOWER) or K14's plain version (tower.PLAIN_TOWER). Its
    kernel point maps to the canonical infinity (0, 1, 0)."""
    F = T.fp
    dev = x.device
    d = F.sub(x, fp.const(_X0, dev))
    dinv = fp2_inv(d, F)  # inv0: the kernel point is masked below
    d2 = T.fp2_sqr(dinv)
    d3 = T.fp2_mul(d2, dinv)
    Tc, U = fp.const(_T, dev), fp.const(_U, dev)
    xo = F.mul(F.add(x, F.add(T.fp2_mul(Tc, dinv), T.fp2_mul(U, d2))), fp.const(_INV9, dev))
    one = _one_like(x)
    yo = F.mul(
        T.fp2_mul(y, F.sub(one, F.add(T.fp2_mul(Tc, d2), T.fp2_mul(F.add(U, U), d3)))),
        fp.const(_INV27, dev),
    )
    kernel = fp2_is_zero(d)
    zero = FP2.zero(kernel.shape, dev)
    return Proj(fp2_select(kernel, zero, xo), fp2_select(kernel, one, yo), fp2_select(kernel, zero, one))


def iso3_map_plain(x, y) -> Proj:
    """K14's plain version: PyTorch operations only, on any device."""
    return iso3_map_composed(x, y, tower.PLAIN_TOWER)


def iso3_map(x, y) -> Proj:
    """The 3-isogeny E' -> E2 on affine (x, y), each (..., 2, W): one
    launch of K14 (csrc/h2c_kernels.cu) for CUDA tensors, the plain version
    for CPU tensors."""
    cpu = fp._is_cpu(x, y)
    for t in (x, y):
        tower._check_trailing(t, (2, fp.WORDS), "Fp2")
    if cpu:
        return iso3_map_plain(x, y)
    from . import kernels

    shape = tower._broadcast(x.shape, y.shape)
    out = torch.empty((3, *shape), dtype=torch.int32, device=x.device)
    n = shape.numel() // (2 * fp.WORDS)
    (a, sa), (b, sb) = (tower._operand(t, shape, 2, 2 * fp.WORDS) for t in (x, y))
    kernels.launch("lh_iso3_map", x.device, a.data_ptr(), sa, b.data_ptr(), sb,
                   fp.const(_H2C_CONSTS, x.device).data_ptr(), out.data_ptr(), n)
    fp._count("iso3_map", n)
    return Proj(out[0], out[1], out[2])


# [X^2 - X - 1] and [X - 1] for the psi-method cofactor clearing.
_CC_K1 = X_PARAM * X_PARAM - X_PARAM - 1  # positive
_CC_K2 = X_PARAM - 1  # negative
_CC_WIDTH = _CC_K1.bit_length()  # 128
_CC_BITS = np.array(
    [
        [(_CC_K1 >> (_CC_WIDTH - 1 - i)) & 1 for i in range(_CC_WIDTH)],
        [(abs(_CC_K2) >> (_CC_WIDTH - 1 - i)) & 1 for i in range(_CC_WIDTH)],
    ],
    dtype=np.int64,
)


# K17's operand: the two rows as bytes, one per bit
_CC_BITS_U8 = _CC_BITS.astype(np.uint8)


def clear_cofactor_composed(p: Proj, q: Proj | None, F: FieldOps) -> Proj:
    """Budroni-Pintore: [X^2 - X - 1]P + [X - 1]psi(P) + psi^2(2P) of
    P = p + q (map_to_g2's sum of its two SSWU points), or of P = p when q
    is None, over the field operations F: the composition K17 replaced
    (F = FP2: K2, K7 and one launch of K11 for the two multiplications,
    2-stacked) or K17's plain version (FP2_PLAIN)."""
    if q is not None:
        p = proj_add(F, p, q)
    base = stack2(p, psi(p, F))
    batch_rank = p.z.ndim - 2
    bits = fp.const(_CC_BITS, p.z.device).reshape(2, *([1] * batch_rank), _CC_WIDTH)
    u = scalar_mul_bits(F, base, bits)
    t1 = unstack(u, 0)
    t2 = proj_neg(F, unstack(u, 1))  # X - 1 < 0
    t3 = psi(psi(dbl(F, p), F), F)
    return proj_add(F, proj_add(F, t1, t2), t3)


def clear_cofactor_plain(p: Proj, q: Proj | None = None) -> Proj:
    """K17's plain version: PyTorch operations only, on any device."""
    return clear_cofactor_composed(p, q, FP2_PLAIN)


def clear_cofactor(p: Proj, q: Proj | None = None) -> Proj:
    """The cofactor clearing of p + q (or of p when q is None), G2
    projective coordinates (..., 2, W): one launch of K17
    (csrc/cofactor_kernels.cu), a thread pair per element, for CUDA
    tensors; the plain version for CPU tensors."""
    pts = (*p, *q) if q is not None else tuple(p)
    cpu = fp._is_cpu(*pts)
    for t in pts:
        tower._check_trailing(t, (2, fp.WORDS), "Fp2")
    if cpu:
        return clear_cofactor_plain(p, q)
    from . import kernels

    dev = p.z.device
    shape = tower._broadcast(*(t.shape for t in pts))
    ops = [tower._operand(t, shape, 2, 2 * fp.WORDS) for t in pts]
    ops += ops if q is None else []  # q's slots: unread when there is no sum
    ptrs = [x for t, st in ops for x in (t.data_ptr(), st)]
    out = torch.empty((3, *shape), dtype=torch.int32, device=dev)
    n = shape.numel() // (2 * fp.WORDS)
    kernels.launch("lh_clear_cofactor", dev, *ptrs, int(q is not None), fp.const(_PSI_C, dev).data_ptr(),
                   fp.const(_CC_BITS_U8, dev).data_ptr(), _CC_WIDTH, out.data_ptr(), n)
    fp._count("clear_cofactor", n)
    return Proj(out[0], out[1], out[2])


def map_to_g2(u0, u1) -> Proj:
    """SSWU + isogeny once on the 2-stacked (u0, u1) (K13, K14), then the
    sum and the cofactor clearing (K17)."""
    q = iso3_map(*sswu(torch.stack([u0, u1])))
    return clear_cofactor(unstack(q, 0), unstack(q, 1))


def hash_to_g2_device(u) -> Proj:
    """u: (..., 2, 2, W) field elements (device words) -> G2 points."""
    return map_to_g2(u[..., 0, :, :], u[..., 1, :, :])


# -- host-side field derivation ------------------------------------------------


class _H2CFieldCache:
    """Process-wide LRU of hash_to_field wire-limb rows keyed by (message,
    dst): repeated signing roots skip SHA-256 and the bigint reduction.
    Rows are read-only; staging copies them into its output."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        with self._lock:
            row = self._entries.get(key)
            if row is not None:
                self._entries.move_to_end(key)
            return row

    def put(self, key, row) -> None:
        with self._lock:
            self._entries[key] = row
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


H2C_FIELD_CACHE = _H2CFieldCache()


def hash_to_field_limbs(messages: list[bytes], dst: bytes = DST) -> np.ndarray:
    """RFC 9380 hash_to_field (count = 2, m = 2) as wire limbs
    (S, 2, 2, 32): [message, u-index, component, limbs]. SHA-256 runs once
    per unique (message, dst), behind H2C_FIELD_CACHE."""
    out = np.empty((len(messages), 2, 2, fp.JAX_LIMBS), dtype=np.int32)
    by_msg: dict[bytes, list[int]] = {}
    for i, msg in enumerate(messages):
        by_msg.setdefault(msg, []).append(i)
    pending: dict[bytes, list[int]] = {}
    for msg, idxs in by_msg.items():
        row = H2C_FIELD_CACHE.get((msg, dst))
        if row is None:
            pending[msg] = idxs
        else:
            out[idxs] = row
    if pending:
        coords: list[int] = []
        for msg in pending:
            u0, u1 = ref_h2c.hash_to_field_fp2(msg, dst, 2)
            coords.extend((u0.c0.n, u0.c1.n, u1.c0.n, u1.c1.n))
        rows = to_mont_wire_bulk(coords).reshape(len(pending), 2, 2, fp.JAX_LIMBS)
        for k, (msg, idxs) in enumerate(pending.items()):
            row = rows[k].copy()  # not a view: an LRU entry must not pin the batch
            row.setflags(write=False)
            H2C_FIELD_CACHE.put((msg, dst), row)
            out[idxs] = row
    return out
