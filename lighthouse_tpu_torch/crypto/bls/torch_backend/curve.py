"""Branch-free projective curve arithmetic for G1 (over Fp) and G2 (over Fp2).

Homogeneous projective coordinates (X : Y : Z), infinity = (0 : 1 : 0),
with the complete addition of Renes-Costello-Batina 2016 (Algorithm 7,
a = 0) and their dedicated doubling (Algorithm 9). Projective coordinates
are not unique, so the formulas and their order mirror the JAX package
(lighthouse_tpu jax_backend/curve.py) exactly: the port's points are then
bit-identical to its points, not only equal as points.

Scalar multiplication is the 4-bit fixed-window form with a 17-row table
built by 2-stacked complete additions: one launch of K10 (G1) or K11 (G2)
(csrc/curve_kernels.cu) on the card, and beside it the plain version,
where `lax.scan` becomes a Python loop and the table gather becomes
`torch.gather`. The verify's sums of many points (`tree_sum`: a set's
keys, the r_i sig_i) are one launch of K15 (G1) or K16 (G2)
(csrc/fold_kernels.cu), on the plain version's halving tree.

G2 subgroup membership is Scott's psi criterion: P in G2 iff
psi(P) == [z]P (z < 0), a 64-bit multiplication instead of a 255-bit one.
G1 membership is the phi criterion: P in G1 iff phi(P) == -[z^2]P, with
phi(x, y) = (beta x, y); as one kernel (K5, csrc/g1_kernels.cu) it is the
pubkey-admission check. The Montgomery ladder and the full-order checks
[r]P == O are the oracle-grade criteria both are validated against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import B_G1, B_G2, R as R_ORD, X as X_PARAM
from ..ref.curves import Point, g1_generator
from ..ref.fields import Fp as RefFp
from ..ref.hash_to_curve import _PSI_CX, _PSI_CY
from . import fp, tower
from .pack import pack_fp2, pack_fp2_el


class FieldOps(NamedTuple):
    """Uniform field interface for the generic group law."""

    add: Callable
    sub: Callable
    neg: Callable
    mul: Callable
    inv: Callable
    is_zero: Callable
    eq: Callable
    select: Callable
    one: Callable  # (shape, device) -> broadcast one
    zero: Callable
    b3: np.ndarray  # 3 * b, Montgomery-packed
    elem_dims: int  # trailing dims of one coordinate: 1 (Fp) or 2 (Fp2)
    # "g1" / "g2": the group's kernels, scalar multiplication (K10, K11) and
    # tree sum (K15, K16); None: plain ops
    group: str | None = None


FP = FieldOps(
    add=fp.add,
    sub=fp.sub,
    neg=fp.neg,
    mul=fp.mul,
    inv=fp.inv,
    is_zero=fp.is_zero,
    eq=fp.eq,
    select=fp.select,
    one=fp.one,
    zero=fp.zero,
    b3=fp.to_mont_host(3 * B_G1),
    elem_dims=1,
    group="g1",
)

FP2 = FieldOps(
    add=tower.fp2_add,
    sub=tower.fp2_sub,
    neg=tower.fp2_neg,
    mul=tower.fp2_mul,
    inv=tower.fp2_inv,
    is_zero=tower.fp2_is_zero,
    eq=tower.fp2_eq,
    select=tower.fp2_select,
    one=tower.fp2_one,
    zero=tower.fp2_zero,
    b3=pack_fp2(3 * B_G2[0], 3 * B_G2[1]),
    elem_dims=2,
    group="g2",
)

# The plain versions of K1-K3 and K7 as fields: the group law over them is
# PyTorch operations only, on any device (the plain versions of K5, K10,
# K11, K15, K16 and K17, also on the card).
FP_PLAIN = FP._replace(**fp.PLAIN_OPS._asdict(), group=None)
FP2_PLAIN = FP2._replace(
    add=fp.PLAIN_OPS.add,
    sub=fp.PLAIN_OPS.sub,
    neg=fp.PLAIN_OPS.neg,
    mul=tower.fp2_mul_plain,
    inv=lambda a: tower.fp2_inv(a, fp.PLAIN_OPS),
    group=None,
)
_PLAIN_FIELD = {1: FP_PLAIN, 2: FP2_PLAIN}


class Proj(NamedTuple):
    """A (batch of) homogeneous projective point(s); coordinates share batch dims."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def from_affine(F: FieldOps, x, y, inf) -> Proj:
    """Affine coordinates + infinity mask -> projective; infinity = (0, 1, 0)."""
    one = F.one(inf.shape, x.device)
    zero = F.zero(inf.shape, x.device)
    return Proj(F.select(inf, zero, x), F.select(inf, one, y), F.select(inf, zero, one))


def to_affine(F: FieldOps, p: Proj):
    """(x, y, inf); infinity decodes to zeroed coordinates (inv0). One
    field inversion (K3 underneath) and one stacked product."""
    zinv = F.inv(p.z)
    m = F.mul(torch.stack([p.x, p.y]), zinv)
    return m[0], m[1], F.is_zero(p.z)


def is_infinity(F: FieldOps, p: Proj):
    return F.is_zero(p.z)


def infinity(F: FieldOps, shape, device) -> Proj:
    return Proj(F.zero(shape, device), F.one(shape, device).clone(), F.zero(shape, device))


def neg(F: FieldOps, p: Proj) -> Proj:
    return Proj(p.x, F.neg(p.y), p.z)


def add(F: FieldOps, p: Proj, q: Proj) -> Proj:
    """Complete addition, RCB 2016 Algorithm 7 (a = 0, b3 = 3b): valid for
    every pair, including P == Q, P == -Q and infinity. The 14 products
    ride three stacked multiplications."""
    x1, y1, z1, x2, y2, z2 = torch.broadcast_tensors(*p, *q)
    b3 = fp.const(F.b3, x1.device)
    s = F.add(torch.stack([x1, y1, x1, y2, z2, z2]), torch.stack([y1, z1, z1, x2, y2, x2]))
    # x1x2, y1y2, z1z2, (x1+y1)(x2+y2), (y1+z1)(y2+z2), (x1+z1)(x2+z2)
    m = F.mul(torch.stack([x1, y1, z1, s[0], s[1], s[2]]), torch.stack([x2, y2, z2, s[3], s[4], s[5]]))
    t0, t1, t2 = m[0], m[1], m[2]
    u = F.add(torch.stack([t0, t1, t0]), torch.stack([t1, t2, t2]))
    d = F.sub(m[3:6], u)  # t3 = x1y2+x2y1, t4 = y1z2+y2z1, y3 = x1z2+x2z1
    t3, t4, y3 = d[0], d[1], d[2]
    t0 = F.add(F.add(t0, t0), t0)
    bm = F.mul(torch.stack([t2, y3]), b3)
    t2, y3 = bm[0], bm[1]
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    w = F.mul(torch.stack([t4, t3, y3, t1, t0, z3]), torch.stack([y3, t1, t0, z3, t3, t4]))
    x3 = F.sub(w[1], w[0])
    fin = F.add(torch.stack([w[3], w[5]]), torch.stack([w[2], w[4]]))
    return Proj(x3, fin[0], fin[1])


def dbl_fast(F: FieldOps, p: Proj) -> Proj:
    """Dedicated doubling, RCB 2016 Algorithm 9 (a = 0); maps infinity to
    itself."""
    X, Y, Z = p
    b3 = fp.const(F.b3, X.device)
    m = F.mul(torch.stack([Y, Y, Z, X]), torch.stack([Y, Z, Z, Y]))
    t0, t1, t2, txy = m[0], m[1], m[2], m[3]
    z8 = F.add(t0, t0)
    z8 = F.add(z8, z8)
    z8 = F.add(z8, z8)  # 8 Y^2
    t2 = F.mul(b3, t2)  # 3b Z^2
    a = F.add(torch.stack([t0, t2]), torch.stack([t2, t2]))
    y3p, t2d = a[0], a[1]
    t0 = F.sub(t0, F.add(t2d, t2))  # Y^2 - 9b Z^2
    w = F.mul(torch.stack([t2, t1, t0, t0]), torch.stack([z8, z8, y3p, txy]))
    fin = F.add(torch.stack([w[0], w[3]]), torch.stack([w[2], w[3]]))
    return Proj(fin[1], fin[0], w[1])


dbl = dbl_fast


def stack2(a: Proj, b: Proj) -> Proj:
    return Proj(*(torch.stack([u, v]) for u, v in zip(a, b)))


def unstack(p: Proj, i: int) -> Proj:
    return Proj(p.x[i], p.y[i], p.z[i])


def _sel(F: FieldOps, cond, a: Proj, b: Proj) -> Proj:
    return Proj(*(F.select(cond, u, v) for u, v in zip(a, b)))


def _bits_tensor(bits, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(bits)) if isinstance(bits, np.ndarray) else bits
    return t.to(device)


def scalar_mul_bits_ladder(F: FieldOps, p: Proj, bits) -> Proj:
    """Montgomery ladder, MSB-first over a fixed bit width: the oracle-grade
    form the windowed multiplication is validated against. `bits` as for
    `scalar_mul_bits`. Each step computes R0 + R1 and 2 R_b as ONE 2-stacked
    complete addition."""
    shape = F.is_zero(p.z).shape
    bits = _bits_tensor(bits, p.x.device)
    r0, r1 = infinity(F, shape, p.x.device), p
    for j in range(bits.shape[-1]):
        take = (bits[..., j] != 0).expand(shape)
        rsel = _sel(F, take, r1, r0)
        u = add(F, stack2(r0, rsel), stack2(r1, rsel))
        u_add, u_dbl = unstack(u, 0), unstack(u, 1)
        r0, r1 = _sel(F, take, u_add, u_dbl), _sel(F, take, u_dbl, u_add)
    return r0


_WINDOW = 4
_WINDOW_WEIGHTS = np.array([8, 4, 2, 1], dtype=np.int64)


def _window_digits(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first 0/1 bits (..., n) -> window digits (..., ceil(n/4)) in
    [0, 16), zero-padded at the MSB end."""
    n = bits.shape[-1]
    pad = (-n) % _WINDOW
    bits = torch.nn.functional.pad(bits.to(torch.int64), (pad, 0))
    chunks = bits.reshape(*bits.shape[:-1], -1, _WINDOW)
    return (chunks * fp.const(_WINDOW_WEIGHTS, bits.device)).sum(dim=-1)


def _table_gather(coord, digit, shape, elem_dims):
    """Rows of `coord` (17, *shape, *elem) at per-element `digit` (broadcast
    to `shape`)."""
    idx = digit.expand(shape).reshape(1, *shape, *([1] * elem_dims))
    idx = idx.expand(1, *coord.shape[1:])
    return torch.gather(coord, 0, idx)[0]


def scalar_mul_bits_plain(F: FieldOps, p: Proj, bits) -> Proj:
    """Fixed-window (4-bit) scalar multiplication, MSB-first, composed over
    the field operations F: the plain version of K10 and K11 over FP_PLAIN
    and FP2_PLAIN, the composition they replaced over FP and FP2.

    bits: (n,) public bits as a numpy array, or a (..., n) tensor of 0/1
    per-element bits broadcast against the batch. Table row k = [k]P,
    built 8 steps of one 2-stacked complete addition each:
    [T_k + T_{k+1}, 2 T_{k+1}] = [T_{2k+1}, T_{2k+2}] (row 16 is built and
    never read). Each digit costs 4 dedicated doublings and one complete
    addition of the gathered row; digit 0 gathers row 0 = infinity."""
    dev = p.x.device
    shape = F.is_zero(p.z).shape
    public = isinstance(bits, np.ndarray)
    digits = _window_digits(_bits_tensor(bits, "cpu") if public else bits)
    inf = infinity(F, shape, dev)
    rows = [inf, Proj(*(c.expand_as(i) for c, i in zip(p, inf)))] + [inf] * 15
    for k in range(8):
        u = add(F, stack2(rows[k], rows[k + 1]), stack2(rows[k + 1], rows[k + 1]))
        rows[2 * k + 1], rows[2 * k + 2] = unstack(u, 0), unstack(u, 1)
    acc = inf
    if public:
        for d in digits.tolist():
            for _ in range(_WINDOW):
                acc = dbl_fast(F, acc)
            acc = add(F, acc, rows[d])
        return acc
    tab = Proj(*(torch.stack([r[c] for r in rows]) for c in range(3)))
    digits = digits.to(dev)
    for j in range(digits.shape[-1]):
        for _ in range(_WINDOW):
            acc = dbl_fast(F, acc)
        t = Proj(*(_table_gather(c, digits[..., j], shape, F.elem_dims) for c in tab))
        acc = add(F, acc, t)
    return acc


def scalar_mul_bits(F: FieldOps, p: Proj, bits) -> Proj:
    """[k]P by `scalar_mul_bits_plain`'s algorithm, bit-identical to it:
    one launch of K10 (F = FP, G1) or K11 (F = FP2, G2) for CUDA tensors,
    the plain version for CPU tensors and for the plain fields."""
    if F.group is None:
        return scalar_mul_bits_plain(F, p, bits)
    if fp._is_cpu(*p):
        return scalar_mul_bits_plain(_PLAIN_FIELD[F.elem_dims], p, bits)
    return _scalar_mul_kernel(F, p, bits)


def _row_strides(b: torch.Tensor):
    """Element strides of the bit rows of `b` (..., n) (last dim
    contiguous), as two levels: row e starts at (e // inner) * hi +
    (e % inner) * lo elements. Returns (b, inner, hi, lo); a layout that
    two levels cannot describe is copied once."""
    dims = []
    for size, stride in zip(b.shape[:-1], b.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)  # merges with the dim before
        else:
            dims.append((size, stride))
    if len(dims) > 2:
        b = b.contiguous()
        dims = [(b.numel() // b.shape[-1], b.shape[-1])]
    if len(dims) == 2:
        return b, dims[1][0], dims[0][1], dims[1][1]
    if len(dims) == 1:
        return b, dims[0][0], 0, dims[0][1]
    return b, 1, 0, 0


def _scalar_mul_kernel(F: FieldOps, p: Proj, bits) -> Proj:
    """One launch of K10 or K11 (csrc/curve_kernels.cu). The coordinates are
    read in place (element stride 0 where one point is broadcast), and so
    are the bits, int32 or int64 0/1 rows read a byte each: per element, or
    one row broadcast over some dims (`clear_cofactor`'s (2, 1, ..., n))."""
    from . import kernels

    dev = p.z.device
    elem = tuple(p.z.shape[-F.elem_dims :])
    batch = p.z.shape[: -F.elem_dims]
    if isinstance(bits, np.ndarray):
        bits = fp.const(bits, dev)
    if bits.device != dev:
        raise RuntimeError(f"bits on {bits.device}, points on {dev}")
    nbits = bits.shape[-1]
    b = bits.expand(*batch, nbits)
    if b.stride(-1) != 1:
        b = b.contiguous()
    b, inner, hi, lo = _row_strides(b)
    size = b.element_size()
    words = fp.WORDS * (2 if F.elem_dims == 2 else 1)
    shape = torch.Size((*batch, *elem))
    ops = [tower._operand(c, shape, F.elem_dims, words) for c in p]
    ptrs = [x for t, st in ops for x in (t.data_ptr(), st)]
    out = torch.empty((3, *shape), dtype=torch.int32, device=dev)
    n = batch.numel()
    name = f"{F.group}_scalar_mul"
    kernels.launch(f"lh_{name}", dev, *ptrs, b.data_ptr(), inner, hi * size, lo * size, size, nbits,
                   out.data_ptr(), n)
    fp._count(name, (n, nbits))
    return Proj(out[0], out[1], out[2])


# -- tree sums (K15, K16) ----------------------------------------------------------


def tree_sum_plain(F: FieldOps, pts: Proj, axis: int) -> Proj:
    """Sum points along `axis` with a pairwise halving tree over the field
    operations F (the complete formulas make doubling and identity
    operands safe): at each level n points become n // 2 additions of rows
    i and i + n // 2, and an odd leftover rides along unpaired at the end.
    The plain version of K15 and K16 over FP_PLAIN and FP2_PLAIN, the
    composition they replaced over FP and FP2."""
    pts = Proj(*(c.movedim(axis, 0) for c in pts))
    while pts.x.shape[0] > 1:
        n = pts.x.shape[0]
        half = n // 2
        summed = add(F, Proj(*(c[:half] for c in pts)), Proj(*(c[half : 2 * half] for c in pts)))
        if n % 2:
            summed = Proj(*(torch.cat([s, c[2 * half :]]) for s, c in zip(summed, pts)))
        pts = summed
    return unstack(pts, 0)


def tree_sum(F: FieldOps, pts: Proj, axis: int) -> Proj:
    """The sum of the points along `axis` by `tree_sum_plain`'s tree,
    bit-identical to it: one launch of K15 (F = FP, G1) or K16 (F = FP2,
    G2) for CUDA tensors, the plain version for CPU tensors and for the
    plain fields."""
    if F.group is None:
        return tree_sum_plain(F, pts, axis)
    if fp._is_cpu(*pts):
        return tree_sum_plain(_PLAIN_FIELD[F.elem_dims], pts, axis)
    return _tree_sum_kernel(F, pts, axis)


def _tree_sum_kernel(F: FieldOps, pts: Proj, axis: int) -> Proj:
    """One launch of K15 or K16 (csrc/fold_kernels.cu), a block per column.
    Each coordinate is read in place as (length, columns) points with a
    row and a column stride in words (a layout that two strides cannot
    describe is copied once); the kernel's scratch, two halves of
    ceil(length / 2) points per column, comes from torch.empty."""
    from . import kernels

    dev = pts.z.device
    words = fp.WORDS * F.elem_dims
    coords = [c.movedim(axis, 0) for c in torch.broadcast_tensors(*pts)]
    L, elem = coords[0].shape[0], coords[0].shape[coords[0].dim() - F.elem_dims :]
    rest = coords[0].shape[1 : coords[0].dim() - F.elem_dims]
    C = rest.numel()
    if L == 0:
        raise ValueError("tree_sum of an empty axis")
    ops = [c.reshape(L, C, words) for c in coords]
    ops = [c if c.stride(2) == 1 else c.contiguous() for c in ops]
    scratch = torch.empty(2 * C * ((L + 1) // 2) * 3 * words, dtype=torch.int32, device=dev)
    out = torch.empty((3, *rest, *elem), dtype=torch.int32, device=dev)
    ptrs = [x for c in ops for x in (c.data_ptr(), c.stride(0), c.stride(1))]
    name = f"{F.group}_tree_sum"
    kernels.launch(f"lh_{name}", dev, *ptrs, scratch.data_ptr(), out.data_ptr(), L, C)
    fp._count(name, (C, L))
    return Proj(out[0], out[1], out[2])


def eq_points(F: FieldOps, p: Proj, q: Proj):
    """Projective-class equality (cross-multiplied); canonical infinities
    equal each other and nothing else."""
    px, py, pz, qx, qy, qz = torch.broadcast_tensors(*p, *q)
    m = F.mul(torch.stack([px, qx, py, qy]), torch.stack([qz, pz, qz, pz]))
    x_eq = F.eq(m[0], m[1])
    y_eq = F.eq(m[2], m[3])
    p_inf = F.is_zero(pz)
    q_inf = F.is_zero(qz)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & x_eq & y_eq)


# -- psi endomorphism & G2 subgroup check ---------------------------------------

# psi(x, y) = (conj(x) CX, conj(y) CY), CX = 1/h^2, CY = 1/h^3, h = xi^((p-1)/6)
_PSI_C = np.stack([pack_fp2_el(_PSI_CX), pack_fp2_el(_PSI_CY)])

_ABS_X_BITS = np.array([(abs(X_PARAM) >> (63 - i)) & 1 for i in range(64)], dtype=np.int64)


def psi(p: Proj, F: FieldOps = FP2) -> Proj:
    """Untwist-Frobenius-twist endomorphism in homogeneous coordinates, over
    the field operations F (FP2_PLAIN in the plain versions)."""
    xyz = torch.stack([p.x, p.y, p.z])
    c = tower.fp2(xyz[..., 0, :], F.neg(xyz[..., 1, :]))  # conjugates
    batch = p.x.shape[:-2]
    consts = fp.const(_PSI_C, p.x.device).reshape(2, *([1] * len(batch)), 2, fp.WORDS)
    xy = F.mul(c[:2], consts)
    return Proj(xy[0], xy[1], c[2])


def g2_in_subgroup(p: Proj):
    """psi(P) == -[|z|]P, or P is infinity."""
    rhs = neg(FP2, scalar_mul_bits(FP2, p, _ABS_X_BITS))
    return eq_points(FP2, psi(p), rhs) | is_infinity(FP2, p)


# -- phi endomorphism & G1 subgroup check ---------------------------------------
#
# phi(x, y) = (beta x, y), beta a primitive cube root of unity in Fp, acts on
# G1 as multiplication by a root lambda of lambda^2 + lambda + 1 = 0 mod r.
# r = z^4 - z^2 + 1, so lambda = -z^2 is one, and P is in G1 iff
# phi(P) == -[z^2]P (Scott 2021): a 128-bit multiplication instead of a
# 255-bit one. Which cube root pairs with -z^2 is settled at import on the
# ref generator.

_X_SQ_BITS = np.array([((X_PARAM * X_PARAM) >> (127 - i)) & 1 for i in range(128)], dtype=np.int64)
_R_BITS = np.array([(R_ORD >> (254 - i)) & 1 for i in range(255)], dtype=np.int64)


def _phi_beta() -> np.ndarray:
    """Montgomery words of the cube root beta with phi(g) == [-z^2] g."""
    g = g1_generator()
    target = -g.mul(X_PARAM * X_PARAM)
    for w in (tower._OMEGA, tower._OMEGA2):
        if Point(RefFp(w) * g.x, g.y, False, g.b) == target:
            return fp.to_mont_host(w)
    raise AssertionError("neither cube root matches the -z^2 eigenvalue")


PHI_BETA = _phi_beta()


def phi_g1(p: Proj, F: FieldOps = FP) -> Proj:
    """(X : Y : Z) -> (beta X : Y : Z); fixes infinity."""
    return Proj(F.mul(p.x, fp.const(PHI_BETA, p.x.device)), p.y, p.z)


def g1_in_subgroup(p: Proj, F: FieldOps = FP):
    """phi(P) == -[z^2]P, or P is infinity. `F` is FP or FP_PLAIN."""
    rhs = neg(F, scalar_mul_bits(F, p, _X_SQ_BITS))
    return eq_points(F, phi_g1(p, F), rhs) | is_infinity(F, p)


def g1_in_subgroup_full(p: Proj):
    """[r]P == O by the ladder: the criterion the phi check is validated against."""
    return is_infinity(FP, scalar_mul_bits_ladder(FP, p, _R_BITS))


def g2_in_subgroup_full(p: Proj):
    """[r]P == O by the ladder: the criterion the psi check is validated against."""
    return is_infinity(FP2, scalar_mul_bits_ladder(FP2, p, _R_BITS))


def g1_subgroup_check_plain(x, y, inf):
    """K5's plain version: g1_in_subgroup(from_affine(x, y, inf)) & ~inf over
    the plain field operations, so PyTorch only, on any device."""
    return g1_in_subgroup(from_affine(FP_PLAIN, x, y, inf), FP_PLAIN) & ~inf


def g1_in_subgroup_kernel(x: torch.Tensor, y: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """Subgroup verdicts of n affine G1 points, infinity reported False:
    g1_in_subgroup(from_affine(FP, x, y, inf)) & ~inf (K5).

    x, y: (n, 12) int32 Montgomery words; inf: (n,) bool; all contiguous on
    one device. A CUDA tensor launches K5, a CPU tensor takes the plain
    version; anything else raises. Returns (n,) bool."""
    if inf.dtype != torch.bool or inf.dim() != 1:
        raise TypeError(f"inf must be bool (n,), got {inf.dtype} {tuple(inf.shape)}")
    n = inf.shape[0]
    for t in (x, y):
        if t.dtype != torch.int32 or t.shape != (n, fp.WORDS):
            raise TypeError(f"coordinates must be int32 ({n}, {fp.WORDS}), got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (x, y, inf)):
        raise ValueError("g1_in_subgroup_kernel takes contiguous tensors")
    if fp._is_cpu(x, y) and inf.device.type == "cpu":
        return g1_subgroup_check_plain(x, y, inf)
    if inf.device != x.device:
        raise RuntimeError(f"operands on different devices: {x.device}, {inf.device}")
    from . import kernels

    beta = fp.const(PHI_BETA, x.device)
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    kernels.launch("lh_g1_subgroup_check", x.device, x.data_ptr(), y.data_ptr(), inf.data_ptr(),
                   beta.data_ptr(), out.data_ptr(), n)
    fp._count("g1_subgroup_check", n)
    return out
