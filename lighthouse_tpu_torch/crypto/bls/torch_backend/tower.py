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
elements whatever formula computes them. The products of Fp2 and Fp12
are one launch each of their own kernels (csrc/tower_kernels.cu), which
sum Fp products in double width and reduce once, as the JAX package's
lazy reduction does (poly + one redc per tower operation):

    K7 fp2_mul   fp2_mul, fp2_sqr
    K8 fp12_mul  fp12_mul, fp12_sqr, fp12_mul_sparse035 (and fp12_inv's
                 products), reading and writing the tower layout

Fp6 products and standalone Fp2 inversions, off the verify path, are one
launch each of csrc/affine_kernels.cu:

    K24 fp6_mul  fp6_mul, fp6_sqr (schoolbook, six threads per element)
    K25 fp2_inv  fp2_inv over the kernel field operations (g2.cuh's
                 routine, which K13, K14 and K19 run inside)

and Karabina's squaring and decompression and the Fp12 inversion, called
on their own over the kernel tower (the default), one launch each:

    K28 karabina_sqr         csrc/standalone_kernels.cu, a thread each
    K29 karabina_decompress  csrc/standalone_kernels.cu, a thread each
    K30 fp12_inv             csrc/final_exponentiation_kernels.cu, K19's
                             block routine, a warp each

The compositions that K9 and K19 replaced, and their plain versions, call
`*_composed`.

Their plain versions (`*_plain`), taken for CPU tensors, are the
compositions over Fp operations that the port ran before them. Every
other function stacks independent Fp products into one K1 launch and
independent additions into one K2 launch. Karabina's compressed squaring
and decompression and the Fp12 inversion are written over a `TowerOps`
(`*_composed`: the kernels, or their plain versions): the |z|-power chain
over them is K9's composition and its plain version (`pairing.pow_abs_x`),
and `fp12_inv_composed` runs inside K19's (`pairing.final_exponentiation`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import P
from . import fp

FP2_MUL, FP2_SQR = 0, 1  # K7's op
FP12_FULL, FP12_SQUARE, FP12_SPARSE = 0, 1, 2  # K8's mode
_FP2_WORDS = 2 * fp.WORDS
_FP6_WORDS = 3 * _FP2_WORDS
_FP12_WORDS = 6 * _FP2_WORDS


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


def fp2_conj(a, F=fp.KERNEL_OPS):
    return fp2(a[..., 0, :], F.neg(a[..., 1, :]))


def fp2_mul(a, b):
    return fp2_product(a, b, FP2_MUL)


def fp2_sqr(a):
    return fp2_product(a, None, FP2_SQR)


def fp2_mul_plain(a, b, F=fp.PLAIN_OPS):
    """K7's plain version, op mul. Karatsuba: one stacked addition, one
    3-row product, two subtractions."""
    a, b = torch.broadcast_tensors(a, b)
    s = F.add(torch.stack([a[..., 0, :], b[..., 0, :]]), torch.stack([a[..., 1, :], b[..., 1, :]]))
    t = F.mul(
        torch.stack([a[..., 0, :], a[..., 1, :], s[0]], dim=-2),
        torch.stack([b[..., 0, :], b[..., 1, :], s[1]], dim=-2),
    )
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    u = F.sub(torch.stack([t0, t2], dim=-2), torch.stack([t1, t0], dim=-2))
    return fp2(u[..., 0, :], F.sub(u[..., 1, :], t1))


def fp2_sqr_plain(a, F=fp.PLAIN_OPS):
    """K7's plain version, op sqr: (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = F.mul(torch.stack([F.add(a0, a1), a0], dim=-2), torch.stack([F.sub(a0, a1), a1], dim=-2))
    return fp2(t[..., 0, :], F.add(t[..., 1, :], t[..., 1, :]))


def fp2_scale(a, k):
    """Both components times an Fp element k (..., 12)."""
    return fp.mul(a, k[..., None, :])


def fp2_mul_by_nonresidue(a, F=fp.KERNEL_OPS):
    # xi = 1 + u: (c0 - c1) + (c0 + c1) u
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return fp2(F.sub(a0, a1), F.add(a0, a1))


def fp2_inv_composed(a, F):
    """1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2); 0 -> 0 (inv0, from F.inv),
    over the Fp operations F: K25's plain version (fp.PLAIN_OPS), the
    composition it replaced (fp.KERNEL_OPS: K1, K2, K3, K1, K2)."""
    sq = F.mul(a, a)
    d = F.inv(F.add(sq[..., 0, :], sq[..., 1, :]))
    t = F.mul(a, d[..., None, :])
    return fp2(t[..., 0, :], F.neg(t[..., 1, :]))


def fp2_inv_plain(a):
    """K25's plain version: PyTorch operations only, on any device."""
    return fp2_inv_composed(a, fp.PLAIN_OPS)


def fp2_inv(a, F=fp.KERNEL_OPS):
    """1/a in Fp2, 0 -> 0 (inv0). Over the kernel field operations (the
    default): one launch of K25 (csrc/affine_kernels.cu, g2.cuh's routine
    that K13, K14 and K19 run inside) for a CUDA tensor, the plain version
    for a CPU tensor. Over any other F (the plain versions of K13, K14 and
    K19, `curve.FP2_PLAIN.inv`) the composition over F."""
    if F is not fp.KERNEL_OPS:
        return fp2_inv_composed(a, F)
    cpu = fp._is_cpu(a)
    _check_trailing(a, (2, fp.WORDS), "Fp2")
    if cpu:
        return fp2_inv_plain(a)
    from . import kernels

    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    x, sa = _operand(a, a.shape, 2, _FP2_WORDS)
    kernels.launch("lh_fp2_inv", a.device, x.data_ptr(), sa, out.data_ptr(), out.numel() // _FP2_WORDS)
    fp._count("fp2_inv")
    return out


def fp2_is_zero(a):
    return (a == 0).all(dim=-1).all(dim=-1)


def fp2_eq(a, b):
    return (a == b).all(dim=-1).all(dim=-1)


def fp2_select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


def fp2_sgn0(a, F=fp.KERNEL_OPS):
    """RFC 9380 sgn0 for Fp2 (little-endian component order): the parity of
    each component's canonical value, out of Montgomery form by a product
    with 1."""
    s = F.mul(a, fp.const(fp._ONE_STD, a.device))[..., 0] & 1
    z0 = fp.is_zero(a[..., 0, :])
    return s[..., 0] | (z0.to(s.dtype) & s[..., 1])


# -- Fp6 -----------------------------------------------------------------------


def fp6(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


def fp6_zero(shape, device):
    return torch.zeros((*shape, 3, 2, fp.WORDS), dtype=torch.int32, device=device)


def fp6_one(shape, device):
    return fp6(fp2_one(shape, device), fp2_zero(shape, device), fp2_zero(shape, device))


def _c(a, i):
    """Fp2 coefficient i of an Fp6 (..., 3, 2, W), or of a stack of Fp2s."""
    return a[..., i, :, :]


def fp6_mul_composed(a, b, T):
    """Karatsuba over Fp2, as the JAX package, over the operations T: the
    six Fp2 products a_i b_i and (a_i + a_j)(b_i + b_j) ride one stacked
    T.fp2_mul. K24's plain version (PLAIN_TOWER), the composition it
    replaced (KERNEL_TOWER: one K7 launch, six of K2)."""
    F = T.fp
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    b0, b1, b2 = _c(b, 0), _c(b, 1), _c(b, 2)
    s = F.add(torch.stack([a1, a0, a0, b1, b0, b0], dim=-3), torch.stack([a2, a1, a2, b2, b1, b2], dim=-3))
    t = T.fp2_mul(torch.cat([a, s[..., :3, :, :]], dim=-3), torch.cat([b, s[..., 3:, :, :]], dim=-3))
    t0, t1, t2 = _c(t, 0), _c(t, 1), _c(t, 2)
    # (a1 + a2)(b1 + b2) - t1 - t2, (a0 + a1)(b0 + b1) - t0 - t1, (a0 + a2)(b0 + b2) - t0 - t2
    d = F.sub(F.sub(t[..., 3:, :, :], torch.stack([t1, t0, t0], dim=-3)), torch.stack([t2, t1, t2], dim=-3))
    xi = fp2_mul_by_nonresidue(torch.stack([_c(d, 0), t2], dim=-3), F)
    return F.add(torch.stack([_c(xi, 0), _c(d, 1), _c(d, 2)], dim=-3), torch.stack([t0, _c(xi, 1), t1], dim=-3))


def fp6_mul_plain(a, b):
    """K24's plain version: PyTorch operations only, on any device."""
    return fp6_mul_composed(a, b, PLAIN_TOWER)


def fp6_mul(a, b):
    """a * b in Fp6 (..., 3, 2, W), broadcasting: one launch of K24
    (csrc/affine_kernels.cu) for CUDA tensors, each operand read in place
    (element stride 72 words, or 0 for one element broadcast); the plain
    version for CPU tensors."""
    cpu = fp._is_cpu(a, b)
    for t in (a, b):
        _check_trailing(t, (3, 2, fp.WORDS), "Fp6")
    if cpu:
        return fp6_mul_plain(a, b)
    from . import kernels

    shape = _broadcast(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    x, sa = _operand(a, shape, 3, _FP6_WORDS)
    y, sb = _operand(b, shape, 3, _FP6_WORDS)
    kernels.launch("lh_fp6_mul", a.device, x.data_ptr(), sa, y.data_ptr(), sb, out.data_ptr(),
                   out.numel() // _FP6_WORDS)
    fp._count("fp6_mul")
    return out


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


# The flat basis Fp12 = Fp2[w]/(w^6 - xi) (w^2 = v): six Fp2 coefficients,
# k = 2v + w for the tower's (w, v) index. The plain products, Frobenius
# and Karabina's compression work in it; K8 reads the tower layout.


def _to_flat(a):
    """Tower (..., w:2, v:3, c:2, W) -> flat (..., k:6, c:2, W)."""
    t = a.transpose(-4, -3)
    return t.reshape(*t.shape[:-4], 6, 2, fp.WORDS)


def _from_flat(x):
    t = x.reshape(*x.shape[:-3], 3, 2, 2, fp.WORDS)
    return t.transpose(-4, -3)


_FULL, _SPARSE = (0, 1, 2, 3, 4, 5), (0, 3, 5)


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


_PLANS = {pos: _product_plan(pos) for pos in (_FULL, _SPARSE)}


def _tree_sum(F, x, dim):
    """Sum Fp2 terms along `dim` (a tensor dim left of the Fp2 axes) with a
    halving tree of stacked additions."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = F.add(x[:half], x[half : 2 * half])
        x = torch.cat([s, x[2 * half :]]) if x.shape[0] % 2 else s
    return x[0]


def flat_mul_plain(af, bf, b_positions=_FULL, F=fp.PLAIN_OPS):
    """Product of flat Fp12 elements (K8's arithmetic). bf holds only the
    coefficients at `b_positions` (the pairing line has w^0, w^3, w^5):
    (..., len, 2, W)."""
    ii, jj, diag = _PLANS[tuple(b_positions)]
    shape = torch.broadcast_shapes(af.shape[:-3], bf.shape[:-3])
    af = af.expand(*shape, *af.shape[-3:])
    bf = bf.expand(*shape, *bf.shape[-3:])
    dev = af.device
    # coefficient sums c0 + c1 of both operands, one stacked addition
    sa, sb = F.add(af[..., 0, :], af[..., 1, :]), F.add(bf[..., 0, :], bf[..., 1, :])
    ia, ib = fp.const(ii, dev), fp.const(jj, dev)
    la, rb = af[..., ia, :, :], bf[..., ib, :, :]
    t = F.mul(
        torch.stack([la[..., 0, :], la[..., 1, :], sa[..., ia, :]], dim=-2),
        torch.stack([rb[..., 0, :], rb[..., 1, :], sb[..., ib, :]], dim=-2),
    )  # (..., NP, 3, W): a0 b0, a1 b1, (a0 + a1)(b0 + b1)
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    u = F.sub(torch.stack([t0, t2], dim=-2), torch.stack([t1, t0], dim=-2))
    c = fp2(u[..., 0, :], F.sub(u[..., 1, :], t1))  # (..., NP, 2, W)
    c = torch.cat([c, torch.zeros_like(c[..., :1, :, :])], dim=-3)
    d = _tree_sum(F, c[..., fp.const(diag, dev), :, :], dim=-3)  # (..., 11, 2, W)
    # w^6 = xi: e_k = d_k + xi d_{k+6} for k < 5, e_5 = d_5; xi = 1 + u
    hi0, hi1 = d[..., 6:, 0, :], d[..., 6:, 1, :]
    e = F.add(d[..., :5, :, :], fp2(F.sub(hi0, hi1), F.add(hi0, hi1)))
    return torch.cat([e, d[..., 5:6, :, :]], dim=-3)


def fp12_product_plain(a, bs, mode, F=fp.PLAIN_OPS):
    """K8's plain version, in the tower layout (see fp12_product)."""
    af = _to_flat(a)
    if mode == FP12_FULL:
        return _from_flat(flat_mul_plain(af, _to_flat(bs[0]), _FULL, F))
    if mode == FP12_SQUARE:
        return _from_flat(flat_mul_plain(af, af, _FULL, F))
    bf = torch.stack(torch.broadcast_tensors(*bs), dim=-3)
    return _from_flat(flat_mul_plain(af, bf, _SPARSE, F))


def fp12_mul(a, b):
    return fp12_product(a, (b,), FP12_FULL)


def fp12_sqr(a):
    return fp12_product(a, (), FP12_SQUARE)


def fp12_mul_sparse035(a, b0, b3, b5):
    """a * (B0 + B3 w^3 + B5 w^5) for Fp2 coefficients B_i: the pairing
    line shape, 18 instead of 36 Fp2 products."""
    return fp12_product(a, (b0, b3, b5), FP12_SPARSE)


def fp12_conj(a, F=fp.KERNEL_OPS):
    """Conjugation (Frobenius^6): the inverse on the cyclotomic subgroup."""
    return fp12(a[..., 0, :, :, :], F.neg(a[..., 1, :, :, :]))


# -- the operations a composed tower function runs over ---------------------------


class TowerOps(NamedTuple):
    """Fp operations, the batch inversion and the Fp2 / Fp12 products that a
    composed tower function (Karabina's chain, `pairing.pow_abs_x_composed`,
    the Miller loop `pairing.miller_loop_composed`, hash-to-G2's
    `h2c.sswu_composed` and `h2c.iso3_map_composed`, `fp12_inv_composed`,
    `pairing.final_exponentiation_composed`, the verify's
    `api.miller_inputs_composed`) is written over."""

    fp: fp.FpOps
    batch_inv: Callable
    fp2_mul: Callable
    fp2_sqr: Callable
    fp12_mul: Callable
    fp12_sqr: Callable
    fp12_mul_sparse035: Callable


#: K1-K4, K7 and K8: the composition that K9, K12, K13, K14, K19 and K21
#: replaced
KERNEL_TOWER = TowerOps(fp.KERNEL_OPS, fp.batch_inv, fp2_mul, fp2_sqr, fp12_mul, fp12_sqr, fp12_mul_sparse035)
#: their plain versions, PyTorch operations only, on any device: the plain
#: versions of K9, K12, K13, K14, K19 and K21 run over them
PLAIN_TOWER = TowerOps(
    fp.PLAIN_OPS,
    fp.batch_inv_plain,
    fp2_mul_plain,
    fp2_sqr_plain,
    lambda a, b: fp12_product_plain(a, (b,), FP12_FULL),
    lambda a: fp12_product_plain(a, (), FP12_SQUARE),
    lambda a, b0, b3, b5: fp12_product_plain(a, (b0, b3, b5), FP12_SPARSE),
)


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


def _compressed_launch(name, c, out_shape):
    """One launch of K28 or K29 on compressed c (..., 4, 2, W), read in
    place (element stride 96 words, or 0 for one element broadcast)."""
    from . import kernels

    _check_trailing(c, (4, 2, fp.WORDS), "compressed Fp12")
    out = torch.empty(out_shape, dtype=torch.int32, device=c.device)
    x, sc = _operand(c, c.shape, 3, 4 * _FP2_WORDS)
    kernels.launch(f"lh_{name}", c.device, x.data_ptr(), sc, out.data_ptr(), c[..., 0, 0, 0].numel())
    fp._count(name)
    return out


def karabina_sqr(c, T=KERNEL_TOWER):
    """One compressed cyclotomic squaring by `karabina_sqr_composed`'s
    formulas: over the kernel tower (the default) one launch of K28 for a
    CUDA tensor and the plain version for a CPU tensor; over any other T
    the composition over T."""
    if T is not KERNEL_TOWER:
        return karabina_sqr_composed(c, T)
    if fp._is_cpu(c):
        return karabina_sqr_plain(c)
    return _compressed_launch("karabina_sqr", c, c.shape)


def karabina_sqr_plain(c):
    """K28's plain version: PyTorch operations only, on any device."""
    return karabina_sqr_composed(c, PLAIN_TOWER)


def karabina_sqr_composed(c, T):
    """One compressed cyclotomic squaring over the operations T: K28's
    plain version (PLAIN_TOWER), the composition it replaced and that K9
    replaced (KERNEL_TOWER: K7, K2, K1)."""
    F = T.fp
    g2, g3, g4, g5 = (c[..., i, :, :] for i in range(4))
    sq = T.fp2_mul(
        torch.stack([g2, g4, g3, g5, g4, g2], dim=-3),
        torch.stack([g2, g4, g3, g5, g5, g3], dim=-3),
    )  # [g2^2, g4^2, g3^2, g5^2, g4 g5, g2 g3]
    xi = fp2_mul_by_nonresidue(sq[..., 2:5, :, :], F)  # xi g3^2, xi g5^2, xi g4 g5
    a = F.add(sq[..., 0:2, :, :], xi[..., 0:2, :, :])  # g2^2 + xi g3^2, g4^2 + xi g5^2
    m = F.mul(
        torch.stack([xi[..., 2, :, :], a[..., 1, :, :], a[..., 0, :, :], sq[..., 5, :, :], g2, g3, g4, g5], dim=-3),
        fp.const(_KARABINA_SCALE, c.device),
    )  # 6 xi g4 g5, 3 (g4^2 + xi g5^2), 3 (g2^2 + xi g3^2), 6 g2 g3, 2 g2, 2 g3, 2 g4, 2 g5
    m0, m3, m4, m7 = m[..., 0, :, :], m[..., 3, :, :], m[..., 4, :, :], m[..., 7, :, :]
    hp = F.add(torch.stack([m0, m3], dim=-3), torch.stack([m4, m7], dim=-3))  # h2, h5
    hm = F.sub(m[..., 1:3, :, :], m[..., 5:7, :, :])  # h3, h4
    return torch.stack([hp[..., 0, :, :], hm[..., 0, :, :], hm[..., 1, :, :], hp[..., 1, :, :]], dim=-3)


def karabina_decompress(c, T=KERNEL_TOWER):
    """Compressed (..., 4, 2, W) -> tower Fp12 by
    `karabina_decompress_composed`'s formulas: over the kernel tower (the
    default) one launch of K29 for a CUDA tensor, an inversion per
    element, and the plain version for a CPU tensor; over any other T the
    composition over T."""
    if T is not KERNEL_TOWER:
        return karabina_decompress_composed(c, T)
    if fp._is_cpu(c):
        return karabina_decompress_plain(c)
    return _compressed_launch("karabina_decompress", c, (*c.shape[:-3], 2, 3, 2, fp.WORDS))


def karabina_decompress_plain(c):
    """K29's plain version: PyTorch operations only, on any device."""
    return karabina_decompress_composed(c, PLAIN_TOWER)


def karabina_decompress_composed(c, T):
    """Compressed (..., 4, 2, W) -> tower Fp12, sharing ONE Fp inversion
    (T.batch_inv, K4) across every lane, over the operations T: K29's
    plain version (PLAIN_TOWER), the composition it replaced (KERNEL_TOWER).
    The all-zero compressed identity decompresses to one through inv0."""
    F = T.fp
    dev = c.device
    g2, g3, g4, g5 = (c[..., i, :, :] for i in range(4))
    pr = T.fp2_mul(torch.stack([g5, g4, g4, g3, g2]), torch.stack([g5, g4, g5, g4, g5]))
    s5, s4, b45, g3g4, g2g5 = pr
    s4_3 = F.add(F.add(s4, s4), s4)
    num1 = F.sub(F.add(fp2_mul_by_nonresidue(s5, F), s4_3), F.add(g3, g3))
    num2 = F.add(b45, b45)
    g2nz = ~fp2_is_zero(g2)
    four_g2 = F.add(F.add(g2, g2), F.add(g2, g2))
    num = fp2_select(g2nz, num1, num2)
    den = fp2_select(g2nz, four_g2, g3)
    # 1/(d0 + d1 u) = (d0 - d1 u)/(d0^2 + d1^2), the norms on one batch_inv
    nsq = F.mul(den, den)
    norm = F.add(nsq[..., 0, :], nsq[..., 1, :])
    ninv = T.batch_inv(norm.reshape(-1, fp.WORDS)).reshape(norm.shape)
    dm = F.mul(den, ninv[..., None, :])
    dinv = fp2(dm[..., 0, :], F.neg(dm[..., 1, :]))
    g1 = T.fp2_mul(num, dinv)
    s1 = T.fp2_sqr(g1)
    g0 = F.add(
        fp2_mul_by_nonresidue(F.sub(F.add(F.add(s1, s1), g2g5), F.add(F.add(g3g4, g3g4), g3g4)), F),
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
# Fp scalars by flat index k = 2v + w for the Galois map phi: v -> omega v,
# and phi^2: (2, 6, W), K19's constant operand (`pairing._FE_CONSTS`).
_PHI_SCALARS = np.stack(
    [
        np.stack([fp.ONE_MONT, fp.ONE_MONT, fp.to_mont_host(_OMEGA), fp.to_mont_host(_OMEGA),
                  fp.to_mont_host(_OMEGA2), fp.to_mont_host(_OMEGA2)]),
        np.stack([fp.ONE_MONT, fp.ONE_MONT, fp.to_mont_host(_OMEGA2), fp.to_mont_host(_OMEGA2),
                  fp.to_mont_host(_OMEGA), fp.to_mont_host(_OMEGA)]),
    ]
)
# the same in the tower layout, (2, w, v, 1, W)
_PHI_TABLES = _PHI_SCALARS.reshape(2, 3, 2, 1, fp.WORDS).transpose(0, 2, 1, 3, 4).copy()


def fp12_inv(a, T=KERNEL_TOWER):
    """a^-1 in Fp12 (..., 2, 3, 2, W) by `fp12_inv_composed`'s chain, zero
    to zero: over the kernel tower (the default) one launch of K30
    (csrc/final_exponentiation_kernels.cu, K19's block routine, a warp per
    element) for a CUDA tensor and the plain version for a CPU tensor;
    over any other T the composition over T."""
    if T is not KERNEL_TOWER:
        return fp12_inv_composed(a, T)
    if fp._is_cpu(a):
        return fp12_inv_plain(a)
    from . import kernels

    _check_trailing(a, (2, 3, 2, fp.WORDS), "Fp12")
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    x, sa = _operand(a, a.shape, 4, _FP12_WORDS)
    kernels.launch("lh_fp12_inv", a.device, x.data_ptr(), sa, fp.const(_PHI_SCALARS, a.device).data_ptr(),
                   out.data_ptr(), out.numel() // _FP12_WORDS)
    fp._count("fp12_inv")
    return out


def fp12_inv_plain(a):
    """K30's plain version: PyTorch operations only, on any device."""
    return fp12_inv_composed(a, PLAIN_TOWER)


def fp12_inv_composed(a, T):
    """Inverse by the Galois norm chain: N = a conj(a) lies in Fp6,
    M = N phi(N) phi^2(N) in Fp2, a^-1 = conj(a) phi(N) phi^2(N) M^-1; zero
    maps to zero (M = 0, inv0). Four Fp12 products, all in the tower
    layout, over the operations T: K30's plain version and the plain
    version's inside K19's (PLAIN_TOWER), the composition K30 replaced
    (KERNEL_TOWER: K8, K1-K3 and K25, K7)."""
    F = T.fp
    c = fp12_conj(a, F)
    n = T.fp12_mul(a, c)
    batch = n.shape[:-4]
    tables = fp.const(_PHI_TABLES, a.device).reshape(2, *([1] * len(batch)), 2, 3, 1, fp.WORDS)
    phi = F.mul(n.unsqueeze(0), tables)  # [phi(N), phi^2(N)]
    g = T.fp12_mul(phi[0], phi[1])
    m = T.fp12_mul(n, g)  # Fp2, at w^0 only
    minv = fp2_inv(m[..., 0, 0, :, :], F)
    return T.fp2_mul(T.fp12_mul(c, g), minv[..., None, None, :, :])


def fp12_eq(a, b):
    return (a == b).flatten(-4).all(dim=-1)


def fp12_is_one(a):
    return fp12_eq(a, fp12_one(a.shape[:-4], a.device))


def fp12_select(cond, a, b):
    return torch.where(cond[..., None, None, None, None], a, b)


# -- the kernel wrappers: K7 and K8 ----------------------------------------------


def _operand(t, shape, dims, size):
    """An operand of K7 or K8, broadcast to `shape` and read in place:
    (tensor, element stride in words). The stride is the element's size
    (`size` words, `dims` trailing dimensions) for a contiguous tensor and
    0 for one element broadcast over the batch (a constant); any other
    layout is copied once."""
    if t.shape != shape:
        t = t.expand(shape)
    if t.is_contiguous():
        return t, size
    lead = len(shape) - dims
    if all(st == 0 or d == 1 for st, d in zip(t.stride()[:lead], shape[:lead])) and t[(0,) * lead].is_contiguous():
        return t, 0
    return t.contiguous(), size


def _broadcast(*shapes):
    """torch.broadcast_shapes, with a fast path for shapes that already
    agree (this runs once per tower product)."""
    if all(sh == shapes[0] for sh in shapes[1:]):
        return shapes[0]
    return torch.broadcast_shapes(*shapes)


def _check_trailing(t, trailing, what):
    if tuple(t.shape[-len(trailing):]) != trailing:
        raise TypeError(f"{what} operand must be (..., {', '.join(map(str, trailing))}), got {tuple(t.shape)}")


def fp2_product(a, b, op):
    """a * b (op FP2_MUL) or a^2 (op FP2_SQR, b None) in Fp2: one launch of
    K7 for CUDA tensors, the plain version for CPU tensors."""
    ts = (a,) if op == FP2_SQR else (a, b)
    cpu = fp._is_cpu(*ts)
    for t in ts:
        _check_trailing(t, (2, fp.WORDS), "Fp2")
    if cpu:
        return fp2_mul_plain(a, b) if op == FP2_MUL else fp2_sqr_plain(a)
    from . import kernels

    shape = _broadcast(*(t.shape for t in ts))
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // _FP2_WORDS
    a, sa = _operand(a, shape, 2, _FP2_WORDS)
    b, sb = (a, sa) if op == FP2_SQR else _operand(b, shape, 2, _FP2_WORDS)
    kernels.launch("lh_fp2_mul", a.device, a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), n, op)
    fp._count("fp2_mul")
    return out


def fp12_product(a, bs, mode):
    """a * b (FP12_FULL, bs = (b,)), a^2 (FP12_SQUARE, bs = ()) or
    a * (B0 + B3 w^3 + B5 w^5) (FP12_SPARSE, bs = (B0, B3, B5), Fp2) for
    tower Fp12 a, b: one launch of K8 for CUDA tensors, the plain version
    for CPU tensors."""
    cpu = fp._is_cpu(a, *bs)
    _check_trailing(a, (2, 3, 2, fp.WORDS), "Fp12")
    tails = (2, fp.WORDS) if mode == FP12_SPARSE else (2, 3, 2, fp.WORDS)
    for t in bs:
        _check_trailing(t, tails, "Fp2" if mode == FP12_SPARSE else "Fp12")
    if cpu:
        return fp12_product_plain(a, bs, mode)
    from . import kernels

    lead = _broadcast(a.shape[:-4], *(t.shape[: -len(tails)] for t in bs))
    shape = torch.Size((*lead, 2, 3, 2, fp.WORDS))
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // _FP12_WORDS
    a, sa = _operand(a, shape, 4, _FP12_WORDS)
    if mode == FP12_SPARSE:
        line = torch.Size((*lead, *tails))
        b = [_operand(t, line, 2, _FP2_WORDS) for t in bs]
    else:
        b = [_operand(bs[0], shape, 4, _FP12_WORDS) if mode == FP12_FULL else (a, sa)] * 3
    ptrs = [x for t, st in b for x in (t.data_ptr(), st)]
    kernels.launch("lh_fp12_mul", a.device, a.data_ptr(), sa, *ptrs, out.data_ptr(), n, mode)
    fp._count("fp12_mul")
    return out
