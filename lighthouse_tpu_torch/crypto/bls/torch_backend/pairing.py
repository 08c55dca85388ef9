"""Batched optimal-ate pairing on BLS12-381, over the field and tower kernels.

The Miller loop works on E'(Fp2) in Jacobian coordinates with projective
line evaluation (no inversions): each line is the sparse element
A0 + A3 w^3 + A5 w^5, scaled by Fp2 factors that the final exponentiation
removes. The line formulas mirror the JAX package (lighthouse_tpu
jax_backend/pairing.py) so the Miller value f is bit-identical to its f,
not only equal after the final exponentiation.

The loop runs over the 63 bits of |z| below the leading one: the doubling
step every bit and the addition step on the five set bits. Infinity
inputs are replaced by generators and their f is set to one afterwards.
On the card the whole loop is one launch of K12
(csrc/pairing_kernels.cu); `miller_loop_composed` keeps it as a
composition over a `TowerOps`, which is K12's plain version over the
plain operations.

The final exponentiation is the ref oracle's decomposition (3x the hard
part), so GT values are bit-identical to ref/pairing.py. Its five
|z|-power chains (`pow_abs_x`) are one launch each of K9
(csrc/final_exp_kernels.cu): 63 compressed (Karabina) squarings, the six
checkpoints decompressed with one shared inversion, and their product.
The product of the Miller values (`product_reduce`) is one launch of K18
(csrc/fold_kernels.cu).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import X as X_PARAM
from ..ref.fields import Fp2 as RefFp2
from ..ref.pairing import _H
from . import fp, tower
from .curve import Proj
from .pack import G1_GEN_X_L, G1_GEN_Y_L, G2_GEN_X_L, G2_GEN_Y_L, pack_fp2_el
from .tower import fp2_mul, fp2_mul_by_nonresidue, fp2_select, fp12_conj, fp12_inv, fp12_mul, fp12_one, fp12_select

_ABS_X = abs(X_PARAM)
# MSB-first bits of |z| below the leading bit (T starts at Q).
_ML_BITS = [(_ABS_X >> i) & 1 for i in range(_ABS_X.bit_length() - 2, -1, -1)]
_FP12_WORDS = 12 * fp.WORDS
# all 64 MSB-first bits of |z|
_ABS_X_BITS_MSB = np.array(
    [(_ABS_X >> i) & 1 for i in range(_ABS_X.bit_length() - 1, -1, -1)], dtype=np.int32
)
# |z| = 2^63 + 2^62 + 2^60 + 2^57 + 2^48 + 2^16
_ABS_X_SET_BITS = [k for k in range(64) if (_ABS_X >> k) & 1]


def _frob_constants():
    """Frobenius gammas in the flat basis: (sum c_k w^k)^p = sum conj(c_k) H^k w^k."""
    gammas, acc = [], RefFp2.one()
    for _ in range(6):
        gammas.append(pack_fp2_el(acc))
        acc = acc * _H
    return np.stack(gammas)


_FROB_GAMMAS = _frob_constants()  # (6, 2, W)


# -- Miller loop ---------------------------------------------------------------


def _scale_pair(a, b, xp, yp, F):
    """(a * yp, b * xp) for Fp2 a, b and Fp xp, yp: one stacked product."""
    m = F.mul(torch.stack([a, b]), torch.stack([yp, xp])[..., None, :])
    return m[0], m[1]


def _dbl_step(t: Proj, xp, yp, T: tower.TowerOps):
    """Double T and evaluate the tangent line at P = (xp, yp):
        A0 = -xi * Z3 * Z^2 * yp,  A3 = 2Y^2 - 3X^3,  A5 = 3X^2 * Z^2 * xp."""
    F = T.fp
    X, Y, Z = t
    A, B, ZZ = T.fp2_sqr(torch.stack([X, Y, Z]))
    E = F.add(F.add(A, A), A)  # 3 X^2
    XB = F.add(X, B)
    Y2 = F.add(Y, Y)
    sq = T.fp2_mul(torch.stack([B, XB, E, E, E, Y2]), torch.stack([B, XB, E, X, ZZ, Z]))
    C, XB2, F6, EX, EZZ, z3 = sq
    t0 = F.sub(XB2, F.add(A, C))
    D = F.add(t0, t0)  # 4 X Y^2
    x3 = F.sub(F6, F.add(D, D))
    c4 = F.add(C, C)
    c8 = F.add(F.add(c4, c4), F.add(c4, c4))
    m = T.fp2_mul(torch.stack([E, z3]), torch.stack([F.sub(D, x3), ZZ]))
    y3 = F.sub(m[0], c8)
    zy, a5 = _scale_pair(m[1], EZZ, xp, yp, F)
    a0 = fp2_mul_by_nonresidue(F.neg(zy), F)
    a3 = F.sub(F.add(B, B), EX)
    return Proj(x3, y3, z3), (a0, a3, a5)


def _add_step(t: Proj, qx, qy, xp, yp, T: tower.TowerOps):
    """Mixed addition T + Q (Q affine) and the chord line at P. With
    H = qx Z^2 - X, D = qy Z^3 - Y:
        A0 = -xi * H * Z * yp,  A3 = qy * H * Z - D * qx,  A5 = D * xp."""
    F = T.fp
    X, Y, Z = t
    ZZ = T.fp2_sqr(Z)
    m = T.fp2_mul(torch.stack([qx, Z]), torch.stack([ZZ, ZZ]))
    H = F.sub(m[0], X)
    D = F.sub(T.fp2_mul(qy, m[1]), Y)
    HH = T.fp2_sqr(H)
    m = T.fp2_mul(torch.stack([H, X, H, D]), torch.stack([HH, HH, Z, D]))
    HHH, V, hz, DD = m
    x3 = F.sub(F.sub(DD, HHH), F.add(V, V))
    m = T.fp2_mul(torch.stack([D, Y, qy, D]), torch.stack([F.sub(V, x3), HHH, hz, qx]))
    y3 = F.sub(m[0], m[1])
    hy, a5 = _scale_pair(hz, D, xp, yp, F)
    a0 = fp2_mul_by_nonresidue(F.neg(hy), F)
    a3 = F.sub(m[2], m[3])
    return Proj(x3, y3, hz), (a0, a3, a5)


def miller_loop_composed(px, py, p_inf, qx, qy, q_inf, T: tower.TowerOps):
    """f_{|z|, Q}(P), conjugated for z < 0, over the operations T: the
    composition K12 replaced (T = tower.KERNEL_TOWER) or K12's plain
    version (tower.PLAIN_TOWER). Infinity pairs yield f = 1."""
    dev = px.device
    inf_any = p_inf | q_inf
    shape = inf_any.shape
    px = fp.select(inf_any, fp.const(G1_GEN_X_L, dev), px)
    py = fp.select(inf_any, fp.const(G1_GEN_Y_L, dev), py)
    qx = fp2_select(inf_any, fp.const(G2_GEN_X_L, dev), qx)
    qy = fp2_select(inf_any, fp.const(G2_GEN_Y_L, dev), qy)

    t = Proj(qx, qy, tower.fp2_one(shape, dev))
    f = fp12_one(shape, dev)
    for bit in _ML_BITS:
        f = T.fp12_sqr(f)
        t, line = _dbl_step(t, px, py, T)
        f = T.fp12_mul_sparse035(f, *line)
        if bit:
            t, line = _add_step(t, qx, qy, px, py, T)
            f = T.fp12_mul_sparse035(f, *line)
    f = fp12_conj(f, T.fp)  # z < 0 for BLS12-381
    return fp12_select(inf_any, fp12_one(shape, dev), f)


def miller_loop_plain(px, py, p_inf, qx, qy, q_inf):
    """K12's plain version: PyTorch operations only, on any device."""
    return miller_loop_composed(px, py, p_inf, qx, qy, q_inf, tower.PLAIN_TOWER)


# the substitutes for infinity lanes, in K12's constant operand: G1's
# generator (x, y), then G2's (x, y)
_ML_GENERATORS = np.concatenate([G1_GEN_X_L[None], G1_GEN_Y_L[None], G2_GEN_X_L, G2_GEN_Y_L])


def _flags(t, shape, device, what):
    """A bool operand of a kernel on `device`, broadcast to `shape`, one
    byte an element."""
    if t.dtype != torch.bool:
        raise TypeError(f"{what} must be bool, got {t.dtype}")
    if t.device != device:
        raise RuntimeError(f"{what} on {t.device}, points on {device}")
    return t.expand(shape).contiguous()


def miller_loop(px, py, p_inf, qx, qy, q_inf):
    """f_{|z|, Q}(P), conjugated for z < 0, batched: one launch of K12
    (csrc/pairing_kernels.cu), a block per pair, for CUDA tensors; the
    plain version for CPU tensors.

    px, py: (..., W) G1 affine; qx, qy: (..., 2, W) G2 affine; p_inf,
    q_inf: (...,) bool. Infinity pairs yield f = 1."""
    cpu = fp._is_cpu(px, py, qx, qy)
    for t in (qx, qy):
        tower._check_trailing(t, (2, fp.WORDS), "Fp2")
    if cpu:
        return miller_loop_plain(px, py, p_inf, qx, qy, q_inf)
    from . import kernels

    dev = px.device
    lead = tower._broadcast(px.shape[:-1], py.shape[:-1], qx.shape[:-2], qy.shape[:-2], p_inf.shape, q_inf.shape)
    out = torch.empty((*lead, 2, 3, 2, fp.WORDS), dtype=torch.int32, device=dev)
    n = lead.numel()
    g1, g2 = torch.Size((*lead, fp.WORDS)), torch.Size((*lead, 2, fp.WORDS))
    ops = [tower._operand(t, g1, 1, fp.WORDS) for t in (px, py)]
    ops += [tower._operand(t, g2, 2, 2 * fp.WORDS) for t in (qx, qy)]
    pi, qi = _flags(p_inf, lead, dev, "p_inf"), _flags(q_inf, lead, dev, "q_inf")
    ptrs = [x for t, st in ops for x in (t.data_ptr(), st)]
    gens = fp.const(_ML_GENERATORS, dev)
    kernels.launch("lh_miller_loop", dev, *ptrs, pi.data_ptr(), qi.data_ptr(), gens.data_ptr(), out.data_ptr(), n)
    fp._count("miller_loop", n)
    return out


# -- Frobenius -----------------------------------------------------------------


def frobenius(f):
    """f^p in the flat basis: conjugate every coefficient, scale by gammas."""
    cf = tower.fp2_conj(tower._to_flat(f))
    return tower._from_flat(fp2_mul(cf, fp.const(_FROB_GAMMAS, f.device)))


def frobenius2(f):
    return frobenius(frobenius(f))


# -- final exponentiation ------------------------------------------------------


def pow_abs_x_composed(g, T: tower.TowerOps):
    """g^|z| for cyclotomic g: 63 compressed squarings, the six checkpoints
    g^(2^k) (set bits k of |z|) decompressed together, then multiplied,
    over the operations T: the composition K9 replaced (T =
    tower.KERNEL_TOWER) or K9's plain version (tower.PLAIN_TOWER)."""
    c = tower.karabina_compress(g)
    powers = []
    for _ in range(63):
        c = tower.karabina_sqr(c, T)
        powers.append(c)  # powers[i] = compressed g^(2^(i+1))
    cps = torch.stack([powers[k - 1] for k in _ABS_X_SET_BITS])
    return product_reduce_composed(tower.karabina_decompress(cps, T), T)


def pow_abs_x_plain(g):
    """K9's plain version: PyTorch operations only, on any device."""
    return pow_abs_x_composed(g, tower.PLAIN_TOWER)


def pow_abs_x(g):
    """g^|z| for tower Fp12 g (..., 2, 3, 2, W), any leading batch shape:
    one launch of K9 (csrc/final_exp_kernels.cu), a block per element, for
    a CUDA tensor; the plain version for a CPU tensor."""
    cpu = fp._is_cpu(g)
    tower._check_trailing(g, (2, 3, 2, fp.WORDS), "Fp12")
    if cpu:
        return pow_abs_x_plain(g)
    from . import kernels

    out = torch.empty(g.shape, dtype=torch.int32, device=g.device)
    n = out.numel() // _FP12_WORDS
    a, sa = tower._operand(g, g.shape, 4, _FP12_WORDS)
    kernels.launch("lh_cyclotomic_pow_x", g.device, a.data_ptr(), sa, out.data_ptr(), n)
    fp._count("cyclotomic_pow_x", n)
    return out


def _pow_x_minus_1(g):
    """g^(z-1) = conj(g^|z| * g) for cyclotomic g (z < 0)."""
    return fp12_conj(fp12_mul(pow_abs_x(g), g))


def final_exponentiation(f):
    """f^((p^12 - 1)/r * 3), the oracle's decomposition."""
    f = fp12_mul(fp12_conj(f), fp12_inv(f))
    f = fp12_mul(frobenius2(f), f)
    a = _pow_x_minus_1(_pow_x_minus_1(f))
    b = fp12_mul(fp12_conj(pow_abs_x(a)), frobenius(a))  # a^z * a^p
    c = fp12_mul(fp12_mul(pow_abs_x(pow_abs_x(b)), frobenius2(b)), fp12_conj(b))
    return fp12_mul(c, fp12_mul(f, fp12_mul(f, f)))


# -- products ------------------------------------------------------------------


def product_reduce_composed(fs, T: tower.TowerOps):
    """Multiply a batch of Fp12 values along axis 0 with a log-depth tree
    (rows i and i + n // 2 a level, an odd leftover carried to the end),
    over the operations T: the composition K18 replaced (T =
    tower.KERNEL_TOWER) or K18's plain version (tower.PLAIN_TOWER)."""
    while fs.shape[0] > 1:
        half = fs.shape[0] // 2
        prod = T.fp12_mul(fs[:half], fs[half : 2 * half])
        fs = torch.cat([prod, fs[2 * half :]]) if fs.shape[0] % 2 else prod
    return fs[0]


def product_reduce_plain(fs):
    """K18's plain version: PyTorch operations only, on any device."""
    return product_reduce_composed(fs, tower.PLAIN_TOWER)


def product_reduce(fs):
    """The product of the tower Fp12 values fs (n, 2, 3, 2, W) along axis 0
    by `product_reduce_composed`'s tree: one launch of K18
    (csrc/fold_kernels.cu), one block, for a CUDA tensor; the plain version
    for a CPU tensor."""
    cpu = fp._is_cpu(fs)
    tower._check_trailing(fs, (2, 3, 2, fp.WORDS), "Fp12")
    if fs.dim() != 5 or fs.shape[0] == 0:
        raise ValueError(f"product_reduce takes (n >= 1, 2, 3, 2, {fp.WORDS}), got {tuple(fs.shape)}")
    if cpu:
        return product_reduce_plain(fs)
    from . import kernels

    n = fs.shape[0]
    a, sa = tower._operand(fs, fs.shape, 4, _FP12_WORDS)
    scratch = torch.empty(2 * ((n + 1) // 2) * _FP12_WORDS, dtype=torch.int32, device=fs.device)
    out = torch.empty(fs.shape[1:], dtype=torch.int32, device=fs.device)
    kernels.launch("lh_product_reduce", fs.device, a.data_ptr(), sa, scratch.data_ptr(), out.data_ptr(), n)
    fp._count("product_reduce", n)
    return out
