"""Extension-field towers Fp2 / Fp6 / Fp12 over the word base field.

Same tower as the ref oracle (ref/fields.py) and the JAX package:

    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Tensor layout (leading batch dims broadcast everywhere), as in the JAX
package with 12 words per Fp element instead of 32 limbs:

    Fp2:  (..., 2, 12)        [c0, c1]
    Fp6:  (..., 3, 2, 12)     [c0, c1, c2]
    Fp12: (..., 2, 3, 2, 12)  [c0, c1]

Every value is canonical Montgomery, so the outputs are the unique field
elements whatever formula computes them. Each function stacks independent
Fp products into one K1 launch and independent additions into one K2
launch; the JAX package's lazy reduction (poly + one redc per tower
operation) has no counterpart here, since every Fp product is reduced
inside K1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from . import fp

# -- Fp2 -----------------------------------------------------------------------


def fp2(c0, c1):
    return torch.stack([c0, c1], dim=-2)


def fp2_zero(shape, device):
    return torch.zeros((*shape, 2, fp.WORDS), dtype=torch.int32, device=device)


_FP2_ONE = np.stack([fp.ONE_MONT, fp.ZERO])


def fp2_one(shape, device):
    return fp.const(_FP2_ONE, device).expand(*shape, 2, fp.WORDS)


def fp2_add(a, b):
    return fp.add(a, b)


def fp2_sub(a, b):
    return fp.sub(a, b)


def fp2_neg(a):
    return fp.neg(a)


def fp2_conj(a):
    return fp2(a[..., 0, :], fp.neg(a[..., 1, :]))


def fp2_mul(a, b):
    """Karatsuba: one stacked addition, one 3-row product, two subtractions."""
    a, b = torch.broadcast_tensors(a, b)
    s = fp.add(torch.stack([a[..., 0, :], b[..., 0, :]]), torch.stack([a[..., 1, :], b[..., 1, :]]))
    t = fp.mul(
        torch.stack([a[..., 0, :], a[..., 1, :], s[0]], dim=-2),
        torch.stack([b[..., 0, :], b[..., 1, :], s[1]], dim=-2),
    )
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    u = fp.sub(torch.stack([t0, t2], dim=-2), torch.stack([t1, t0], dim=-2))
    return fp2(u[..., 0, :], fp.sub(u[..., 1, :], t1))


def fp2_sqr(a):
    # (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = fp.mul(torch.stack([fp.add(a0, a1), a0], dim=-2), torch.stack([fp.sub(a0, a1), a1], dim=-2))
    return fp2(t[..., 0, :], fp.add(t[..., 1, :], t[..., 1, :]))


def fp2_scale(a, k):
    """Both components times an Fp element k (..., 12)."""
    return fp.mul(a, k[..., None, :])


def fp2_mul_by_nonresidue(a):
    # xi = 1 + u: (c0 - c1) + (c0 + c1) u
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return fp2(fp.sub(a0, a1), fp.add(a0, a1))


def fp2_inv(a):
    """1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2); 0 -> 0 (inv0, from fp.inv)."""
    sq = fp.sqr(a)
    d = fp.inv(fp.add(sq[..., 0, :], sq[..., 1, :]))
    t = fp.mul(a, d[..., None, :])
    return fp2(t[..., 0, :], fp.neg(t[..., 1, :]))


def fp2_is_zero(a):
    return (a == 0).all(dim=-1).all(dim=-1)


def fp2_eq(a, b):
    return (a == b).all(dim=-1).all(dim=-1)


def fp2_select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


def fp2_sgn0(a):
    """RFC 9380 sgn0 for Fp2 (little-endian component order)."""
    s = fp.sgn0_mont(a)
    z0 = fp.is_zero(a[..., 0, :])
    return s[..., 0] | (z0.to(s.dtype) & s[..., 1])


# -- Fp6 -----------------------------------------------------------------------


def fp6(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


def fp6_zero(shape, device):
    return torch.zeros((*shape, 3, 2, fp.WORDS), dtype=torch.int32, device=device)


def fp6_one(shape, device):
    return fp6(fp2_one(shape, device), fp2_zero(shape, device), fp2_zero(shape, device))


def fp6_neg(a):
    return fp.neg(a)


def _c(a, i):
    """Fp2 coefficient i of an Fp6 (..., 3, 2, W), or of a stack of Fp2s."""
    return a[..., i, :, :]


def fp6_mul(a, b):
    """Karatsuba over Fp2, as the JAX package: the six Fp2 products
    a_i b_i and (a_i + a_j)(b_i + b_j) ride one stacked fp2_mul."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    b0, b1, b2 = _c(b, 0), _c(b, 1), _c(b, 2)
    s = fp.add(torch.stack([a1, a0, a0, b1, b0, b0], dim=-3), torch.stack([a2, a1, a2, b2, b1, b2], dim=-3))
    t = fp2_mul(torch.cat([a, s[..., :3, :, :]], dim=-3), torch.cat([b, s[..., 3:, :, :]], dim=-3))
    t0, t1, t2 = _c(t, 0), _c(t, 1), _c(t, 2)
    # (a1 + a2)(b1 + b2) - t1 - t2, (a0 + a1)(b0 + b1) - t0 - t1, (a0 + a2)(b0 + b2) - t0 - t2
    d = fp.sub(fp.sub(t[..., 3:, :, :], torch.stack([t1, t0, t0], dim=-3)), torch.stack([t2, t1, t2], dim=-3))
    xi = fp2_mul_by_nonresidue(torch.stack([_c(d, 0), t2], dim=-3))
    return fp.add(torch.stack([_c(xi, 0), _c(d, 1), _c(d, 2)], dim=-3), torch.stack([t0, _c(xi, 1), t1], dim=-3))


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """v (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2."""
    return fp6(fp2_mul_by_nonresidue(_c(a, 2)), _c(a, 0), _c(a, 1))


def fp6_scale(a, k):
    """All three coefficients times an Fp2 element k (..., 2, W)."""
    return fp2_mul(a, k[..., None, :, :])


def fp6_inv(a):
    """Inverse through the norm to Fp2, as the JAX package:
    t0 = a0^2 - xi a1 a2, t1 = xi a2^2 - a0 a1, t2 = a1^2 - a0 a2,
    a^-1 = (t0, t1, t2) / (a0 t0 + xi (a2 t1 + a1 t2)); 0 -> 0 (inv0)."""
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    sq = fp2_mul(torch.stack([a0, a2, a1, a1, a0, a0], dim=-3), torch.stack([a0, a2, a1, a2, a1, a2], dim=-3))
    xi = fp2_mul_by_nonresidue(torch.stack([_c(sq, 1), _c(sq, 3)], dim=-3))  # xi a2^2, xi a1 a2
    t = fp.sub(
        torch.stack([_c(sq, 0), _c(xi, 0), _c(sq, 2)], dim=-3),
        torch.stack([_c(xi, 1), _c(sq, 4), _c(sq, 5)], dim=-3),
    )  # t0, t1, t2
    m = fp2_mul(torch.stack([a0, a2, a1], dim=-3), t)  # a0 t0, a2 t1, a1 t2
    d = fp2_inv(fp.add(_c(m, 0), fp2_mul_by_nonresidue(fp.add(_c(m, 1), _c(m, 2)))))
    return fp2_mul(t, d[..., None, :, :])


# -- Fp12 ----------------------------------------------------------------------


def fp12(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def fp12_one(shape, device):
    return fp12(fp6_one(shape, device), fp6_zero(shape, device))


# Products work in the flat basis Fp12 = Fp2[w]/(w^6 - xi) (w^2 = v): six
# Fp2 coefficients, k = 2v + w for the tower's (w, v) index.


def _to_flat(a):
    """Tower (..., w:2, v:3, c:2, W) -> flat (..., k:6, c:2, W)."""
    t = a.transpose(-4, -3)
    return t.reshape(*t.shape[:-4], 6, 2, fp.WORDS)


def _from_flat(x):
    t = x.reshape(*x.shape[:-3], 3, 2, 2, fp.WORDS)
    return t.transpose(-4, -3)


def _diag_index(ii, jj):
    """For each anti-diagonal k = i + j (0..10), the product rows that land
    on it, padded with `len(ii)` (a zero row): (11, T) int64."""
    rows = [[q for q in range(len(ii)) if ii[q] + jj[q] == k] for k in range(11)]
    width = max(len(r) for r in rows)
    return np.array([r + [len(ii)] * (width - len(r)) for r in rows], dtype=np.int64)


def _product_plan(b_positions):
    ii = np.repeat(np.arange(6), len(b_positions))
    jj = np.tile(np.arange(len(b_positions)), 6)
    kk = np.tile(np.array(b_positions), 6)
    return ii, jj, _diag_index(ii, kk)


_PLANS = {pos: _product_plan(pos) for pos in [(0, 1, 2, 3, 4, 5), (0, 3, 5)]}


def _tree_sum(x, dim):
    """Sum Fp2 terms along `dim` (a tensor dim left of the Fp2 axes) with a
    halving tree of stacked additions."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = fp.add(x[:half], x[half : 2 * half])
        x = torch.cat([s, x[2 * half :]]) if x.shape[0] % 2 else s
    return x[0]


def _flat_mul(af, bf, b_positions=(0, 1, 2, 3, 4, 5)):
    """Product of flat Fp12 elements. bf holds only the coefficients at
    `b_positions` (the pairing line has w^0, w^3, w^5): (..., len, 2, W)."""
    ii, jj, diag = _PLANS[tuple(b_positions)]
    shape = torch.broadcast_shapes(af.shape[:-3], bf.shape[:-3])
    af = af.expand(*shape, *af.shape[-3:])
    bf = bf.expand(*shape, *bf.shape[-3:])
    dev = af.device
    # coefficient sums c0 + c1 of both operands, one stacked addition
    sa, sb = fp.add(af[..., 0, :], af[..., 1, :]), fp.add(bf[..., 0, :], bf[..., 1, :])
    ia, ib = fp.const(ii, dev), fp.const(jj, dev)
    la, rb = af[..., ia, :, :], bf[..., ib, :, :]
    t = fp.mul(
        torch.stack([la[..., 0, :], la[..., 1, :], sa[..., ia, :]], dim=-2),
        torch.stack([rb[..., 0, :], rb[..., 1, :], sb[..., ib, :]], dim=-2),
    )  # (..., NP, 3, W): a0 b0, a1 b1, (a0 + a1)(b0 + b1)
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    u = fp.sub(torch.stack([t0, t2], dim=-2), torch.stack([t1, t0], dim=-2))
    c = fp2(u[..., 0, :], fp.sub(u[..., 1, :], t1))  # (..., NP, 2, W)
    c = torch.cat([c, torch.zeros_like(c[..., :1, :, :])], dim=-3)
    d = _tree_sum(c[..., fp.const(diag, dev), :, :], dim=-3)  # (..., 11, 2, W)
    # w^6 = xi: e_k = d_k + xi d_{k+6} for k < 5, e_5 = d_5
    e = fp.add(d[..., :5, :, :], fp2_mul_by_nonresidue(d[..., 6:, :, :]))
    return torch.cat([e, d[..., 5:6, :, :]], dim=-3)


def fp12_mul(a, b):
    return _from_flat(_flat_mul(_to_flat(a), _to_flat(b)))


def fp12_sqr(a):
    af = _to_flat(a)
    return _from_flat(_flat_mul(af, af))


def fp12_mul_sparse035(a, b0, b3, b5):
    """a * (B0 + B3 w^3 + B5 w^5) for Fp2 coefficients B_i: the pairing
    line shape, 18 instead of 36 Fp2 products."""
    bf = torch.stack(torch.broadcast_tensors(b0, b3, b5), dim=-3)
    return _from_flat(_flat_mul(_to_flat(a), bf, b_positions=(0, 3, 5)))


def fp12_conj(a):
    """Conjugation (Frobenius^6): the inverse on the cyclotomic subgroup."""
    return fp12(a[..., 0, :, :, :], fp6_neg(a[..., 1, :, :, :]))


# -- Karabina compressed cyclotomic squaring -----------------------------------
#
# For f in the cyclotomic subgroup, with tower f = (a0 + a1 v + a2 v^2) +
# (b0 + b1 v + b2 v^2) w and (g2, g3, g4, g5) = (b0, a2, a1, b2) (flat
# indices [1, 4, 2, 5]):
#
#   h2 = 2 g2 + 6 xi g4 g5          h3 = 3 (g4^2 + xi g5^2) - 2 g3
#   h4 = 3 (g2^2 + xi g3^2) - 2 g4  h5 = 2 g5 + 6 g2 g3
#
# and decompression recovers g1, g0 (one shared Fp inversion, K4):
#
#   g1 = (xi g5^2 + 3 g4^2 - 2 g3) / (4 g2)     g2 != 0
#      = 2 g4 g5 / g3                           g2 == 0
#   g0 = (2 g1^2 + g2 g5 - 3 g3 g4) xi + 1

KARABINA_FLAT_IDX = np.array([1, 4, 2, 5])
# small multipliers of karabina_sqr's stacked product, Montgomery form
_KARABINA_SCALE = np.stack([fp.to_mont_host(k) for k in (6, 3, 3, 6, 2, 2, 2, 2)])[:, None, :]


def karabina_compress(a):
    """Tower Fp12 (..., 2, 3, 2, W) -> compressed (..., 4, 2, W) = [g2, g3, g4, g5]."""
    return _to_flat(a)[..., fp.const(KARABINA_FLAT_IDX, a.device), :, :]


def karabina_sqr(c):
    """One compressed cyclotomic squaring."""
    g2, g3, g4, g5 = (c[..., i, :, :] for i in range(4))
    sq = fp2_mul(
        torch.stack([g2, g4, g3, g5, g4, g2], dim=-3),
        torch.stack([g2, g4, g3, g5, g5, g3], dim=-3),
    )  # [g2^2, g4^2, g3^2, g5^2, g4 g5, g2 g3]
    xi = fp2_mul_by_nonresidue(sq[..., 2:5, :, :])  # xi g3^2, xi g5^2, xi g4 g5
    a = fp.add(sq[..., 0:2, :, :], xi[..., 0:2, :, :])  # g2^2 + xi g3^2, g4^2 + xi g5^2
    m = fp.mul(
        torch.stack([xi[..., 2, :, :], a[..., 1, :, :], a[..., 0, :, :], sq[..., 5, :, :], g2, g3, g4, g5], dim=-3),
        fp.const(_KARABINA_SCALE, c.device),
    )  # 6 xi g4 g5, 3 (g4^2 + xi g5^2), 3 (g2^2 + xi g3^2), 6 g2 g3, 2 g2, 2 g3, 2 g4, 2 g5
    m0, m3, m4, m7 = m[..., 0, :, :], m[..., 3, :, :], m[..., 4, :, :], m[..., 7, :, :]
    hp = fp.add(torch.stack([m0, m3], dim=-3), torch.stack([m4, m7], dim=-3))  # h2, h5
    hm = fp.sub(m[..., 1:3, :, :], m[..., 5:7, :, :])  # h3, h4
    return torch.stack([hp[..., 0, :, :], hm[..., 0, :, :], hm[..., 1, :, :], hp[..., 1, :, :]], dim=-3)


def karabina_decompress(c):
    """Compressed (..., 4, 2, W) -> tower Fp12, sharing ONE Fp inversion
    (K4) across every lane. The all-zero compressed identity decompresses
    to one through inv0."""
    dev = c.device
    g2, g3, g4, g5 = (c[..., i, :, :] for i in range(4))
    pr = fp2_mul(torch.stack([g5, g4, g4, g3, g2]), torch.stack([g5, g4, g5, g4, g5]))
    s5, s4, b45, g3g4, g2g5 = pr
    s4_3 = fp.add(fp.add(s4, s4), s4)
    num1 = fp.sub(fp.add(fp2_mul_by_nonresidue(s5), s4_3), fp.add(g3, g3))
    num2 = fp.add(b45, b45)
    g2nz = ~fp2_is_zero(g2)
    four_g2 = fp.add(fp.add(g2, g2), fp.add(g2, g2))
    num = fp2_select(g2nz, num1, num2)
    den = fp2_select(g2nz, four_g2, g3)
    # 1/(d0 + d1 u) = (d0 - d1 u)/(d0^2 + d1^2), the norms on one batch_inv
    nsq = fp.sqr(den)
    norm = fp.add(nsq[..., 0, :], nsq[..., 1, :])
    ninv = fp.batch_inv(norm.reshape(-1, fp.WORDS)).reshape(norm.shape)
    dm = fp.mul(den, ninv[..., None, :])
    dinv = fp2(dm[..., 0, :], fp.neg(dm[..., 1, :]))
    g1 = fp2_mul(num, dinv)
    s1 = fp2_sqr(g1)
    g0 = fp.add(
        fp2_mul_by_nonresidue(fp.sub(fp.add(fp.add(s1, s1), g2g5), fp.add(fp.add(g3g4, g3g4), g3g4))),
        fp2_one(c.shape[:-3], dev),
    )
    return _from_flat(torch.stack([g0, g2, g4, g1, g3, g5], dim=-3))


# -- inversion ------------------------------------------------------------------


def _omega_constants():
    """omega in Fp with omega^2 + omega + 1 = 0, via sqrt(-3) (p = 3 mod 4)."""
    s = pow(P - 3, (P + 1) // 4, P)
    assert (s * s + 3) % P == 0
    omega = (s - 1) * pow(2, -1, P) % P
    assert (omega * omega + omega + 1) % P == 0
    return omega, omega * omega % P


_OMEGA, _OMEGA2 = _omega_constants()
# Fp scalars per flat index for the Galois map phi: v -> omega v, and phi^2.
_PHI_TABLES = np.stack(
    [
        np.stack([fp.ONE_MONT, fp.ONE_MONT, fp.to_mont_host(_OMEGA), fp.to_mont_host(_OMEGA),
                  fp.to_mont_host(_OMEGA2), fp.to_mont_host(_OMEGA2)]),
        np.stack([fp.ONE_MONT, fp.ONE_MONT, fp.to_mont_host(_OMEGA2), fp.to_mont_host(_OMEGA2),
                  fp.to_mont_host(_OMEGA), fp.to_mont_host(_OMEGA)]),
    ]
)[:, :, None, :]  # (2, 6, 1, W)


def fp12_inv(a):
    """Inverse by the Galois norm chain: N = a conj(a) lies in Fp6,
    M = N phi(N) phi^2(N) in Fp2, a^-1 = conj(a) phi(N) phi^2(N) M^-1."""
    af = _to_flat(a)
    cf = _to_flat(fp12_conj(a))
    n = _flat_mul(af, cf)
    batch = n.shape[:-3]
    tables = fp.const(_PHI_TABLES, a.device).reshape(2, *([1] * len(batch)), 6, 1, fp.WORDS)
    phi = fp.mul(n.unsqueeze(0), tables)  # [phi(N), phi^2(N)]
    g = _flat_mul(phi[0], phi[1])
    m = _flat_mul(n, g)  # Fp2, at w^0 only
    minv = fp2_inv(m[..., 0, :, :])
    return _from_flat(fp2_mul(_flat_mul(cf, g), minv[..., None, :, :]))


def fp12_eq(a, b):
    return (a == b).flatten(-4).all(dim=-1)


def fp12_is_one(a):
    return fp12_eq(a, fp12_one(a.shape[:-4], a.device))


def fp12_select(cond, a, b):
    return torch.where(cond[..., None, None, None, None], a, b)
