"""K15 `g1_tree_sum` / K16 `g2_tree_sum` and K18 `product_reduce`
(csrc/fold_kernels.cu) and K17 `clear_cofactor` (csrc/cofactor_kernels.cu)
on the CPU.

1. The plain versions against the JAX package and the oracle:
   `curve.tree_sum_plain` bit-identical to the JAX package's
   `api._tree_fold` (its halving tree as written, each level's complete
   addition the jitted JAX `curve.add`) for G1 along axis 1 and G2 along
   axis 0, with infinity lanes, P == Q and P == -Q; `product_reduce_plain`
   bit-identical to the JAX `pairing.product_reduce` (each level's product
   the jitted JAX `fp12_mul`) at n = 1, 2, 3, 4, 5, 17, 129; `clear_cofactor_plain`
   bit-identical to the composition it replaced, its affine result the
   oracle's `clear_cofactor_g2` of q0 + q1; (slow) bit-identical to the
   jitted JAX `map_to_g2` tail, the sum and `clear_cofactor`.
2. A model in Python integers of each kernel: K15/K16's block (its lane
   groups over the launch's own arguments, test_torch_tree_sum_lanes
   `tree_kernel`), K17's thread pair (lane 0: t3 and [z^2 - z - 1] p; lane 1: psi(p),
   [|z - 1|] psi(p), negated; then lane 0's two additions) and K18's
   cluster (`reduce_cluster`: its blocks' shares, each block's in-place
   tree, block 0's fold of the partials, each product's lanes with their
   partial double-width sums added before the one reduction; constants
   read from fold_kernels.cu), every double-width sum checked
   against fp384.cuh's bound (test_torch_tower_kernels.redc_wide), on real
   inputs and on all-(p - 1) inputs, held to the plain versions bit for
   bit.
3. The wrappers: one launch per call with the operands read in place, a
   raise on a failed launch and no fallback to the plain version on a
   CUDA tensor; K9's plain version and the composition K9 replaced keep
   their products over the tower operations, never K18.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import api as japi
from lighthouse_tpu.crypto.bls.jax_backend import curve as jcurve
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu.crypto.bls.jax_backend import h2c as jh2c
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpair
from lighthouse_tpu.crypto.bls.jax_backend import tower as jtower
from lighthouse_tpu.crypto.bls.ref import hash_to_curve as ref_h2c
from lighthouse_tpu.crypto.bls.ref.curves import Point, _B2, g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref.fields import Fp, Fp2
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from test_torch_curve_final_exp_kernels import _G2, _add, _dbl, _fp2_mul, scalar_mul_thread
from test_torch_tower_kernels import PAIR_LANES, k7_thread, k8_warp, redc_wide
from torch_parity import assert_same, to_port

rng = np.random.default_rng(0x8F0)
R_MONT = (1 << 384) % P
R_INV = pow(1 << 384, -1, P)


def _k():
    return int(rng.integers(1, 1 << 62))


def _column(gen, inf, n):
    """n points whose tree meets, at its first level, P == Q (rows 0 and
    half), P == -Q (rows 1 and half + 1) and infinity (the last row)."""
    pts = [gen().mul(_k()) for _ in range(n)]
    half = n // 2
    if half >= 1:
        pts[half] = pts[0]
    if half >= 2:
        pts[half + 1] = -pts[1]
    if n >= 3:
        pts[n - 1] = inf()
    return pts


def _packed(pack_batch, pts, shape):
    x, y, inf = (np.asarray(a) for a in pack_batch(pts))
    return x.reshape(*shape, *x.shape[1:]), y.reshape(*shape, *y.shape[1:]), inf.reshape(shape)


# G1 columns along axis 1 (each set's keys), G2 one column along axis 0 (the r_i sig_i)
FOLDS = [("g1", (2, 3), 1), ("g1", (3, 5), 1)] + [("g2", (n,), 0) for n in (1, 2, 3, 5)]
GROUPS = {
    "g1": (g1_generator, g1_infinity, jpack.pack_g1_batch, jcurve.FP, tc.FP, tc.FP_PLAIN),
    "g2": (g2_generator, g2_infinity, jpack.pack_g2_batch, jcurve.FP2, tc.FP2, tc.FP2_PLAIN),
}


def _fold_inputs(group, shape, axis):
    gen, inf, pack_batch = GROUPS[group][:3]
    length = shape[axis]
    columns = int(np.prod(shape)) // length
    return _packed(pack_batch, [p for _ in range(columns) for p in _column(gen, inf, length)], shape)


FOLD_IN = {(group, shape): _fold_inputs(group, shape, axis) for group, shape, axis in FOLDS}


def _padded(fn, elem_dims, rows=8):
    """fn (a jitted elementwise JAX function of equal-shaped operands) on
    operands padded to `rows` batch rows of zeros, then cut back: one
    compilation serves every level's shape."""
    def run(*args):
        lead = args[0].shape[: args[0].ndim - elem_dims]
        m = int(np.prod(lead))
        pad = [jnp.concatenate([a.reshape(m, *a.shape[len(lead):]),
                                jnp.zeros((rows - m, *a.shape[len(lead):]), a.dtype)]) for a in args]
        out = fn(*pad)
        return jax.tree_util.tree_map(lambda o: o[:m].reshape(*lead, *o.shape[1:]), out)

    return run


def _jax_add(F, elem_dims, add=jcurve.add):
    jitted = jax.jit(lambda *c: add(F, jcurve.Proj(*c[:3]), jcurve.Proj(*c[3:])))
    padded = _padded(jitted, elem_dims)
    return lambda _, p, q: jcurve.Proj(*padded(*p, *q))


_JAX_ADD = {"g1": _jax_add(jcurve.FP, 1), "g2": _jax_add(jcurve.FP2, 2)}


def _port_points(group, x, y, inf):
    return tc.from_affine(GROUPS[group][4], to_port(x), to_port(y), torch.from_numpy(inf))


@pytest.mark.parametrize("group,shape,axis", FOLDS, ids=[f"{g}_{'x'.join(map(str, s))}" for g, s, _ in FOLDS])
def test_tree_sum_plain_bit_identical_to_jax(monkeypatch, group, shape, axis):
    """The JAX `_tree_fold`, its additions the jitted JAX `curve.add`,
    against `tree_sum_plain` over the plain fields and `tree_sum` (on CPU
    tensors, the plain version), projective coordinates word for word."""
    x, y, inf = FOLD_IN[(group, shape)]
    jF = GROUPS[group][3]
    monkeypatch.setattr(jcurve, "add", _JAX_ADD[group])
    want = japi._tree_fold(jF, jcurve.from_affine(jF, jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf)), axis)
    pts = _port_points(group, x, y, inf)
    for got in (tc.tree_sum_plain(GROUPS[group][5], pts, axis), tc.tree_sum(GROUPS[group][4], pts, axis)):
        for g, w in zip(got, want):
            assert_same(g, w)


def _fp12_limbs(n):
    """(n, 2, 3, 2, 32) JAX limbs of seeded random Fp12 values, the first
    with p - 1 in every slot."""
    vals = [P - 1] * 12 + [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12 * (n - 1))]
    return jfp.ints_to_limbs(vals).reshape(n, 2, 3, 2, jfp.N_LIMBS)


REDUCE_IN = {n: _fp12_limbs(n) for n in (1, 2, 3, 4, 5, 17, 129)}
_JAX_FP12_MUL = _padded(jax.jit(jtower.fp12_mul), 4, rows=64)


@pytest.mark.parametrize("n", sorted(REDUCE_IN))
def test_product_reduce_plain_bit_identical_to_jax(monkeypatch, n):
    """The JAX `product_reduce`, its products the jitted JAX `fp12_mul`,
    against `product_reduce_plain` and the wrapper on CPU tensors."""
    monkeypatch.setattr(jpair, "fp12_mul", _JAX_FP12_MUL)
    fs = REDUCE_IN[n]
    want = jpair.product_reduce(jnp.asarray(fs))
    for got in (tpair.product_reduce_plain(to_port(fs)), tpair.product_reduce(to_port(fs))):
        assert_same(got, want)


# -- the cofactor clearing -------------------------------------------------------


def _cofactor_inputs():
    """q0, q1 (projective, CPU words) as the verify hands them to K17: the
    isogeny's images of SSWU's points of u0 = 0 (SSWU's t1 = 0 branch) and
    seeded u's; lane 1 with q1 = q0, lane 2 with q1 = -q0, lane 3 with q1
    at infinity."""
    us = [Fp2.zero()] + [Fp2(Fp(int.from_bytes(rng.bytes(48), "little") % P),
                             Fp(int.from_bytes(rng.bytes(48), "little") % P)) for _ in range(7)]
    u = to_port(np.stack([jpack.pack_fp2_el(x) for x in us])).reshape(2, 4, 2, tfp.WORDS)
    q = th2c.iso3_map_plain(*th2c.sswu_plain(u))
    q0, q1 = (tc.Proj(*(c[i].clone() for c in q)) for i in (0, 1))
    for c0, c1 in zip(q0, q1):
        c1[1] = c0[1]
    q1.x[2], q1.y[2], q1.z[2] = q0.x[2], tc.FP2_PLAIN.neg(q0.y[2]), q0.z[2]
    for c, v in zip(q1, tc.infinity(tc.FP2_PLAIN, (), "cpu")):
        c[3] = v
    return q0, q1


Q0, Q1 = _cofactor_inputs()


@pytest.fixture(scope="module")
def cofactor_out():
    return th2c.clear_cofactor_plain(Q0, Q1)


def _psi_before(p):
    c = tt.fp2_conj(torch.stack([p.x, p.y, p.z]))
    consts = tfp.const(tc._PSI_C, p.x.device).reshape(2, *([1] * (p.x.dim() - 2)), 2, tfp.WORDS)
    xy = tt.fp2_mul(c[:2], consts)
    return tc.Proj(xy[0], xy[1], c[2])


def _clear_cofactor_before(q0, q1):
    """`map_to_g2`'s tail as the port composed it before K17: the sum,
    then `clear_cofactor` with the two multiplications one 2-stacked K11
    call."""
    p = tc.add(tc.FP2, q0, q1)
    base = tc.stack2(p, _psi_before(p))
    bits = tfp.const(th2c._CC_BITS, p.z.device).reshape(2, *([1] * (p.z.ndim - 2)), th2c._CC_WIDTH)
    u = tc.scalar_mul_bits(tc.FP2, base, bits)
    t2 = tc.neg(tc.FP2, tc.unstack(u, 1))
    t3 = _psi_before(_psi_before(tc.dbl(tc.FP2, p)))
    return tc.add(tc.FP2, tc.add(tc.FP2, tc.unstack(u, 0), t2), t3)


def test_clear_cofactor_plain_matches_the_composition_it_replaced(cofactor_out):
    """On CPU tensors: the plain version, the wrapper, the composition over
    the kernels' wrappers and the port's composition before K17 agree word
    for word."""
    for other in (th2c.clear_cofactor(Q0, Q1), th2c.clear_cofactor_composed(Q0, Q1, tc.FP2),
                  _clear_cofactor_before(Q0, Q1)):
        assert all(torch.equal(a, b) for a, b in zip(other, cofactor_out))


def _ref_point(p, i):
    """Lane i of port projective G2 words as an oracle Point."""
    x, y, z = (Fp2(*(Fp(tfp.words_to_int(w) * R_INV % P) for w in c[i])) for c in p)
    if z.is_zero():
        return g2_infinity()
    zi = z.inv()
    return Point(x * zi, y * zi, False, _B2)


def test_clear_cofactor_plain_matches_ref(cofactor_out):
    """Affine: the oracle's clear_cofactor_g2(q0 + q1), also where the sum is
    infinity (lane 2), and clear_cofactor_g2(q0) without the sum."""
    for i in range(4):
        assert _ref_point(cofactor_out, i) == ref_h2c.clear_cofactor_g2(_ref_point(Q0, i) + _ref_point(Q1, i)), i
    assert _ref_point(cofactor_out, 2) == g2_infinity()
    alone = th2c.clear_cofactor_plain(tc.Proj(*(c[:2] for c in Q0)))
    for i in range(2):
        assert _ref_point(alone, i) == ref_h2c.clear_cofactor_g2(_ref_point(Q0, i)), i


@pytest.mark.slow
def test_clear_cofactor_plain_bit_identical_to_jax_map_to_g2_tail():
    """The jitted JAX `map_to_g2` tail, `clear_cofactor(jac_add(q0, q1))`,
    at 2 elements (JAX's `clear_cofactor` compiles in minutes)."""
    q0, q1 = (tc.Proj(*(c[:2] for c in q)) for q in (Q0, Q1))
    jq = [jcurve.Jac(*(jnp.asarray(tfp.to_jax_limbs(c)) for c in q)) for q in (q0, q1)]
    want = jax.jit(lambda a, b: jh2c.clear_cofactor(jcurve.add(jcurve.FP2, a, b)))(*jq)
    for g, w in zip(th2c.clear_cofactor_plain(q0, q1), want):
        assert_same(g, w)


# -- the kernels in Python integers ------------------------------------------------


def _ints(c, i, elem_dims):
    if elem_dims == 1:
        return tfp.words_to_int(c[i])
    return tuple(tfp.words_to_int(w) for w in c[i])


def _all_p_minus_1(shape, elem_dims):
    w = torch.from_numpy(tfp.int_to_words(P - 1))
    return tc.Proj(*(w.expand(*shape, *([2] if elem_dims == 2 else []), tfp.WORDS).clone() for _ in range(3)))


@pytest.mark.parametrize("group,shape,axis", FOLDS, ids=[f"{g}_{'x'.join(map(str, s))}" for g, s, _ in FOLDS])
def test_tree_block_matches_plain(monkeypatch, group, shape, axis):
    """K15 / K16's block on its lane groups (test_torch_tree_sum_lanes
    `tree_kernel`, over the launch that `tree_sum` records) on every
    column, and on columns of all-(p - 1) coordinates (the lazy sums'
    bound asserted inside K7's thread model), word for word against
    `tree_sum_plain`."""
    from test_torch_tree_sum_lanes import run_tree_model  # it imports this module

    F, F_plain = GROUPS[group][4:]
    for pts in (_port_points(group, *FOLD_IN[(group, shape)]), _all_p_minus_1(shape, F.elem_dims)):
        got, _ = run_tree_model(monkeypatch, F, pts, axis)
        want = tc.tree_sum_plain(F_plain, pts, axis)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _psi_ints(p):
    """cofactor_kernels.cu `g2_psi`: conjugates, then K7's lazy products."""
    cx, cy = (tuple(tfp.words_to_int(w) for w in c) for c in tc._PSI_C)
    conj = [(c[0], (-c[1]) % P) for c in p]
    return _fp2_mul(conj[0], cx), _fp2_mul(conj[1], cy), conj[2]


def _lane_table():
    """curve.cuh `kLane` (the lane-group law's step table, G1's and G2's),
    read from the source: per step (outputs, then per output k the fields
    xa/E, xb/F, ya/G, yb/H, 3b, negate, m)."""
    src = (pathlib.Path(tfp.__file__).parent / "csrc" / "curve.cuh").read_text()
    zero = int(re.search(r"constexpr int kLz = (\d+);", src).group(1))
    body = re.search(r"kLane\[kLaneSteps\]\[8\] = \{(.*?)\n\};", src, re.S).group(1)
    body = "\n".join(line for line in body.splitlines() if not line.strip().startswith("//"))
    steps = []
    for row in re.findall(r"\{([^{}]*)\}", body):
        cols = []
        for m in re.finditer(r"lane_pack\(([^)]*)\)|(\d+)", row):
            if m.group(1) is not None:
                cols.append(tuple(zero if a.strip() == "kLz" else int(a) for a in m.group(1).split(",")))
            else:
                cols.append(int(m.group(2)))
        outs, *fields = cols
        fields = [f if isinstance(f, tuple) else (f,) * 6 for f in fields]
        steps.append((outs, [tuple(f[k] for f in fields) for k in range(outs)]))
    assert len(steps) == 8
    return zero, steps


LANE_ZERO, LANE_STEPS = _lane_table()
_BANK_A, _BANK_B, _OPERANDS = set(range(6, 12)), set(range(12, 18)), set(range(6))


def _point(v=None):
    """A point as three mutable [c0, c1] coordinates (shared memory)."""
    return [list(c) for c in v] if v is not None else [[0, 0] for _ in range(3)]


_INF = ((0, 0), (R_MONT, 0), (0, 0))


def lane_step(st, r, p, q, s, on=True):
    """curve.cuh `lane_step<2>` on the twelve lanes of a group: lane 2k + c
    forms component c of output k from the step's table row. Every lane
    reads before any lane writes (__syncwarp), which the kernel gets from
    its banks: a step reads only slots it does not write, as asserted. A
    group that is off (`on` false) reads and writes nothing."""
    if not on:
        return
    outs, rows = LANE_STEPS[st]
    kind = st % 4
    reads = {0: _OPERANDS, 1: _BANK_A, 2: _BANK_B, 3: _BANK_A}[kind] | {LANE_ZERO}

    def slot(i):
        return p[i] if i < 3 else q[i - 3] if i < 6 else s[i - 6]

    out = {}
    for k, (a, b, x, y, b3, neg, m) in enumerate(rows):
        assert ({a, y} if kind == 3 else {a, b, x, y}) <= reads, (st, k)
        for c in (0, 1):
            if kind in (0, 2):  # lane_product: (xa + xb)(ya + yb), sums on level 1 only
                u, w = slot(a), slot(x)
                if kind == 0:
                    u = [(u[i] + slot(b)[i]) % P for i in (0, 1)]
                    w = [(w[i] + slot(y)[i]) % P for i in (0, 1)]
                v = k7_thread(u, w, c, tt.FP2_MUL)
            else:  # lane_lin: H +- m y
                h = slot(y)[c]
                if kind == 1:
                    e = [(slot(a)[i] - slot(b)[i] - slot(x)[i]) % P for i in (0, 1)]
                    t = (e[0] - e[1]) % P if c == 0 else (e[0] + e[1]) % P  # xi
                    yv = 12 * t % P if b3 else e[c]
                    assert m in (1, 3, 8)
                else:
                    yv = slot(a)[c]
                    assert m in (1, 2) and not b3
                v = (h - m * yv) % P if neg else (h + m * yv) % P
            out[k, c] = v
    for (k, c), v in out.items():
        (r[k] if kind == 3 else s[(6 if kind == 1 else 0) + k])[c] = v


def lanes_add(r, p, q, s, on=True):
    """curve.cuh `lanes_add<2>`: r = p + q, four steps. r may alias p or q."""
    for st in range(4):
        lane_step(st, r, p, q, s, on)


def lanes_dbl(r, p, s, on=True):
    """curve.cuh `lanes_dbl<2>`: r = 2 p, four steps."""
    for st in range(4, 8):
        lane_step(st, r, p, p, s, on)


def psi_lanes(r, p):
    """curve.cuh `g2_psi_lanes`: lanes 0-3 component c of conj(x conj(CX))
    and conj(y conj(CY)), lanes 4, 5 conj(z)."""
    cx, cy = (tuple(tfp.words_to_int(w) for w in c) for c in tc._PSI_C)
    cc = [(k[0], (-k[1]) % P) for k in (cx, cy)]
    out = {}
    for k in range(3):
        for c in (0, 1):
            v = k7_thread(p[k], cc[k], c, tt.FP2_MUL) if k < 2 else p[k][c]
            out[k, c] = (-v) % P if c == 1 else v
    for (k, c), v in out.items():
        r[k][c] = v


def window_digit(row, j, nbits, step):
    """curve.cuh `window_digit`: digit j (0 = most significant) of the
    MSB-first bits in the bytes `row`, one byte read a bit `step` bytes
    apart, zero-padded at the MSB end to a multiple of four bits."""
    pad = (4 - nbits % 4) % 4
    d = 0
    for t in range(4):
        i = 4 * j + t - pad
        d = 2 * d + (1 if i >= 0 and row[i * step] != 0 else 0)
    return d


def scalar_mul_lanes(groups, nbits, step):
    """curve.cuh `scalar_mul_lanes<2>` on the lane groups of one warp:
    every group runs the same sequence of group operations (one
    instruction stream, each step ending in __syncwarp), and only the
    table row that a digit picks differs. The groups share no state, so
    each operation runs group by group here. Each group is (tab, acc, s,
    row, on): tab[1] holds its base, `row` its bits (bytes, `step` apart);
    an off group reads its row but takes no part in a step. Row 2k + 2
    before row 2k + 1 in each table step; 4-bit digits MSB first."""
    for tab, acc, _, _, on in groups:
        if on:
            tab[0][:] = _point(_INF)
            acc[:] = _point(_INF)
    for k in range(8):
        for tab, _, s, _, on in groups:
            if 2 * k + 2 < 16:
                lanes_add(tab[2 * k + 2], tab[k + 1], tab[k + 1], s, on)
        for tab, _, s, _, on in groups:
            lanes_add(tab[2 * k + 1], tab[k], tab[k + 1], s, on)
    for j in range((nbits + 3) // 4):
        for _ in range(4):
            for _, acc, s, _, on in groups:
                lanes_dbl(acc, acc, s, on)
        for tab, acc, s, row, on in groups:
            lanes_add(acc, acc, tab[window_digit(row, j, nbits, step)], s, on)


def cofactor_pair(p, q):
    """K17's warp on one element (csrc/cofactor_kernels.cu): both lane
    groups form p = q0 + q1; group 0 forms 2p, then t3 = psi(psi(2p)),
    group 1 psi(p) beside the first psi; group g runs chain g from its bit
    row; group 1 negates its Y; group 0 forms (t1 + t2) + t3."""
    tab = [[_point() for _ in range(16)] for _ in range(2)]
    acc = [_point(q) if q is not None else _point() for _ in range(2)]
    scratch = [[[0, 0] for _ in range(12)] + [[0, 0]] for _ in range(2)]
    t3 = _point()
    for g in (0, 1):
        tab[g][1] = _point(p)
        if q is not None:
            lanes_add(tab[g][1], tab[g][1], acc[g], scratch[g])
    lanes_dbl(t3, tab[0][1], scratch[0])
    psi_lanes(t3, t3)
    psi_lanes(tab[1][1], tab[1][1])
    psi_lanes(t3, t3)
    rows = th2c._CC_BITS_U8.tobytes()  # K17's operand: the two rows, a byte a bit
    width = th2c._CC_WIDTH
    scalar_mul_lanes([(tab[g], acc[g], scratch[g], rows[g * width:], True) for g in (0, 1)], width, 1)
    acc[1][1] = [(-v) % P for v in acc[1][1]]
    lanes_add(acc[0], acc[0], acc[1], scratch[0])
    lanes_add(acc[0], acc[0], t3, scratch[0])
    assert scratch[0][-1] == scratch[1][-1] == [0, 0]  # the zero slot
    return tuple(tuple(c) for c in acc[0])


def test_cofactor_pair_matches_plain(cofactor_out):
    """K17's warp on every lane (u = 0's point, q1 = q0, -q0 and
    infinity), without the sum, and on all-(p - 1) coordinates, word for
    word against `clear_cofactor_plain`."""
    for i in range(4):
        p, q = (tuple(_ints(c, i, 2) for c in pt) for pt in (Q0, Q1))
        assert cofactor_pair(p, q) == tuple(_ints(c, i, 2) for c in cofactor_out), f"lane {i}"
    edge = _all_p_minus_1((1,), 2)
    for q in (edge, None):
        want = th2c.clear_cofactor_plain(edge, q)
        p = tuple(_ints(c, 0, 2) for c in edge)
        assert cofactor_pair(p, p if q is not None else None) == tuple(_ints(c, 0, 2) for c in want)


def _lane_pairs():
    """(name, p, q): the lane-group law's edge operands from Q0, Q1."""
    pt = {name: tuple(_ints(c, i, 2) for c in src) for name, src, i in
          (("p", Q0, 0), ("q", Q1, 0), ("p2", Q0, 2), ("minus_p2", Q1, 2), ("inf", Q1, 3), ("p3", Q0, 3))}
    return {"random": (pt["p"], pt["q"]), "p_eq_q": (pt["p"], pt["p"]), "p_eq_minus_q": (pt["p2"], pt["minus_p2"]),
            "infinity_q": (pt["p3"], pt["inf"]), "infinity_p": (pt["inf"], pt["p3"]), "both_infinity": (_INF, _INF),
            "p_minus_1": (((P - 1, P - 1),) * 3, pt["q"])}


LANE_PAIRS = _lane_pairs()


def _proj(pt):
    return tc.Proj(*(torch.from_numpy(tfp.ints_to_words(list(c))).reshape(1, 2, tfp.WORDS) for c in pt))


@pytest.mark.parametrize("case", sorted(LANE_PAIRS))
def test_lane_group_add_and_dbl_match_plain(case):
    """The lane-group addition and doubling alone (four steps each) on
    infinity, P == Q, P == -Q, random and all-(p - 1) operands, word for
    word against the plain `curve.add_composed` / `curve.dbl` over
    FP2_PLAIN and g2.cuh's one-thread law."""
    p, q = LANE_PAIRS[case]
    s = [[0, 0] for _ in range(13)]
    r_add, r_dbl = _point(), _point()
    lanes_add(r_add, _point(p), _point(q), s)
    lanes_dbl(r_dbl, _point(p), s)
    want_add = tc.add_composed(tc.FP2_PLAIN, _proj(p), _proj(q))
    want_dbl = tc.dbl(tc.FP2_PLAIN, _proj(p))
    assert tuple(map(tuple, r_add)) == tuple(_ints(c, 0, 2) for c in want_add) == _add(_G2, p, q)
    assert tuple(map(tuple, r_dbl)) == tuple(_ints(c, 0, 2) for c in want_dbl) == _dbl(_G2, p)
    # in place, as the chains call them: r = p + q with r the storage of p, then r = 2 r
    a = _point(p)
    lanes_add(a, a, _point(q), s)
    lanes_dbl(a, a, s)
    assert tuple(map(tuple, a)) == _dbl(_G2, _add(_G2, p, q))


def _flat(x, i):
    return [tuple(tfp.words_to_int(w) for w in c) for c in tt._to_flat(x[i])]


_FOLD_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "fold_kernels.cu").read_text()
# K18's constants: blocks in the cluster at most, lane groups a block at
# most, values a block holds at once at most (a product takes a warp's
# PAIR_LANES lanes, tower.cuh `fp12_mul_pairs`)
K18 = {name: int(re.search(rf"constexpr int {name} = (\d+);", _FOLD_SRC).group(1))
       for name in ("kReduceClusterMax", "kReduceMaxGroups", "kReduceMaxRows")}


def reduce_shape(n, k18=K18):
    """fold_kernels.cu `reduce_shape`: (blocks, rows, groups) for n values."""
    blocks = 1
    while 2 * blocks <= k18["kReduceClusterMax"] and 2 * blocks <= n:
        blocks *= 2
    share = -(-n // blocks)
    rows = min(max(share, blocks), k18["kReduceMaxRows"])
    return blocks, rows, min(max(rows // 2, blocks // 2, 1), k18["kReduceMaxGroups"])


def lane_terms(a, b, k, c, q0, q1):
    """tower.cuh `fp12_lane_terms` in full mode: terms q0 <= j < q1 of
    component c of e_k as one double-width sum (two products a term), in
    the routine's order, its bound asserted."""
    t = 0
    for j in range(q0, q1):
        x0, x1 = a[(k - j) % 6]
        if j > k:  # w^6 = xi = 1 + u
            x0, x1 = (x0 - x1) % P, (x0 + x1) % P
        y0, y1 = b[j]
        u = x1 if c else (P - x1) % P
        t += x0 * (y1 if c else y0) + u * (y0 if c else y1)
    assert t < 2 * (q1 - q0) * P * P
    return t


def product_lanes(a, b, lanes):
    """One Fp12 product on `lanes` = 24 lanes: lane 2 (2k + c) + h sums
    terms [3h, 3h + 3) of component c of e_k; the lane pair's partial sums
    are added (the shuffle), then one reduction of the 12-product sum, as
    `reduce_rows` forms it (tower.cuh `fp12_mul_pairs`). Checked against
    K8's warp model (test_torch_tower_kernels `k8_warp`, the same
    routine's lanes in all three modes)."""
    assert lanes == 24
    split, terms = 2, 3
    out = []
    for k in range(6):
        comps = []
        for c in (0, 1):
            t = sum(lane_terms(a, b, k, c, h * terms, (h + 1) * terms) for h in range(split))
            comps.append(redc_wide(t, 12, subs=2))
        out.append(tuple(comps))
    assert out == k8_warp(a, b, tt.FP12_FULL)
    return out


def reduce_rows(v, m, groups, lanes):
    """fold_kernels.cu `reduce_rows` on the rows `v` (a block's shared
    memory): level by level, rows i and i + h into row i for i < m // 2,
    h = m - m // 2, the block's `groups` warps walking a level's products
    in rounds, a warp leaving the level once it has no product left. Per
    level asserts that no product reads a row that another product of the
    level writes (lanes 24-31 repeat lanes 0-7 on the same rows and store
    nothing; row m - 1 is written by no product). Returns the levels run."""
    levels = 0
    while m > 1:
        pairs, h = m // 2, m - m // 2
        writes = set()
        for base in range(0, pairs, groups):
            for i in range(base, min(base + groups, pairs)):
                v[i] = product_lanes(v[i], v[i + h], lanes)
                writes.add(i)
        assert writes == set(range(pairs)) and m - 1 not in writes
        assert all(i + h not in writes for i in writes)
        m = h
        levels += 1
    return levels


def reduce_cluster(values, k18=K18):
    """K18's cluster (fold_kernels.cu `product_reduce_kernel`) in Python
    integers: `reduce_shape`'s blocks, block b loading values [b n / B,
    (b + 1) n / B) at most `rows` at a time (later loads after row 0, the
    running product) and reducing each load with `reduce_rows`; block 0
    copying the other blocks' row 0 into its rows 1 .. B - 1 and folding
    them. Returns (product, dependent product levels)."""
    n = len(values)
    blocks, rows, groups = reduce_shape(n, k18)
    lanes = PAIR_LANES
    smem, depth = [], 0
    for rank in range(blocks):
        lo, hi = rank * n // blocks, (rank + 1) * n // blocks
        assert hi > lo
        v, nxt, m, levels = [None] * rows, lo, 0, 0
        while True:
            take = min(hi - nxt, rows - m)
            v[m : m + take] = values[nxt : nxt + take]
            levels += reduce_rows(v, m + take, groups, lanes)
            nxt, m = nxt + take, 1
            if nxt >= hi:
                break
        smem.append(v)
        depth = max(depth, levels)
    v0 = smem[0]
    assert rows >= blocks and groups >= blocks // 2
    for r in range(1, blocks):
        v0[r] = smem[r][0]
    depth += reduce_rows(v0, blocks, groups, lanes)
    return v0[0], depth


def test_reduce_constants_read_from_the_source():
    """A cluster of at most the portable 8 blocks, enough warps for a
    129-value product's first level."""
    assert K18["kReduceClusterMax"] == 8
    assert reduce_shape(129) == (8, 17, 8) and reduce_shape(4) == (4, 4, 2) and reduce_shape(1) == (1, 1, 1)


@pytest.mark.parametrize("n", sorted(REDUCE_IN))
def test_reduce_block_matches_plain(n):
    """K18's cluster on seeded values (the first all p - 1) and on all-(p -
    1) values, bit for bit against the plain version, in ceil(log2 n)
    dependent product levels."""
    for fs in (to_port(REDUCE_IN[n]), torch.from_numpy(tfp.int_to_words(P - 1)).expand(n, 2, 3, 2, 12)):
        want = tpair.product_reduce_plain(fs)
        got, levels = reduce_cluster([_flat(fs, i) for i in range(n)])
        assert got == _flat(want[None], 0)
        assert levels == (n - 1).bit_length()


@pytest.mark.parametrize("n", [5, 17, 129])
def test_reduce_cluster_loads_in_rounds(n):
    """Blocks whose shares outgrow their rows (here a cluster of 2 blocks
    of 4 rows): each later load folds into row 0's running product, and
    the words stay the plain version's."""
    fs = to_port(REDUCE_IN[n])
    k18 = {**K18, "kReduceClusterMax": 2, "kReduceMaxRows": 4}
    got, _ = reduce_cluster([_flat(fs, i) for i in range(n)], k18)
    assert got == _flat(tpair.product_reduce_plain(fs)[None], 0)


# -- the wrappers ----------------------------------------------------------------------


@pytest.fixture
def recorded_launches(monkeypatch):
    """Operands dispatch as if they lay on a CUDA device; every launch is
    recorded as (launcher, args) and does nothing; the plain versions fail."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    for mod, name in ((tc, "tree_sum_plain"), (th2c, "clear_cofactor_plain"), (tpair, "product_reduce_plain")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))
    return seen


def test_tree_sum_reads_columns_in_place(recorded_launches):
    """K15 on (S, K) keys along axis 1: rows 12 words apart, columns K x 12;
    K16 on (S,) points along axis 0: rows 24 words apart. One launch each,
    the scratch two halves of ceil(L / 2) points per column."""
    g1 = tc.Proj(*(torch.arange(3 * 5 * 12, dtype=torch.int32).reshape(3, 5, 12) + k for k in range(3)))
    g2 = tc.Proj(*(torch.arange(7 * 24, dtype=torch.int32).reshape(7, 2, 12) + k for k in range(3)))
    s1 = tc.tree_sum(tc.FP, g1, 1)
    s2 = tc.tree_sum(tc.FP2, g2, 0)
    (n1, a1), (n2, a2) = recorded_launches
    assert (n1, n2) == ("lh_g1_tree_sum", "lh_g2_tree_sum")
    assert a1[:9] == (g1.x.data_ptr(), 12, 60, g1.y.data_ptr(), 12, 60, g1.z.data_ptr(), 12, 60)
    assert a1[-2:] == (5, 3) and s1.x.shape == (3, 12) and a1[10] == s1.x.data_ptr()
    assert a2[:3] == (g2.x.data_ptr(), 24, a2[2]) and a2[3] == g2.y.data_ptr() and a2[-2:] == (7, 1)
    assert s2.x.shape == (2, 12) and a2[10] == s2.x.data_ptr()


def test_clear_cofactor_and_product_reduce_launch_once(recorded_launches):
    """K17 on K14's 2-stacked output, q0 and q1 read in place (stride 24
    words), the sum flag set; without q the flag is clear. K18 on (n, ...)
    Fp12 values, stride 144 words, no scratch (the levels stay in the
    cluster's shared memory). One launch each."""
    q = tc.Proj(*(torch.arange(2 * 5 * 24, dtype=torch.int32).reshape(2, 5, 2, 12) + k for k in range(3)))
    h = th2c.clear_cofactor(tc.unstack(q, 0), tc.unstack(q, 1))
    th2c.clear_cofactor(tc.unstack(q, 1))
    fs = torch.zeros(5, 2, 3, 2, 12, dtype=torch.int32)
    f = tpair.product_reduce(fs)
    (n1, a1), (n2, a2), (n3, a3) = recorded_launches
    assert (n1, n2, n3) == ("lh_clear_cofactor", "lh_clear_cofactor", "lh_product_reduce")
    assert a1[:12] == (q.x[0].data_ptr(), 24, q.y[0].data_ptr(), 24, q.z[0].data_ptr(), 24,
                       q.x[1].data_ptr(), 24, q.y[1].data_ptr(), 24, q.z[1].data_ptr(), 24)
    assert a1[12] == 1 and a2[12] == 0 and a2[:6] == a2[6:12] and a1[-1] == a2[-1] == 5
    assert a1[13] == tfp.const(tc._PSI_C, "cpu").data_ptr() and h.z.shape == (5, 2, 12) and a1[-2] == h.x.data_ptr()
    assert a3 == (fs.data_ptr(), 144, f.data_ptr(), 5) and f.shape == (2, 3, 2, 12)


def test_wrappers_raise_on_a_failed_launch(monkeypatch):
    """On a CUDA tensor the wrappers launch or raise: a failed build or
    launch (here: no nvcc) is never replaced by the plain version."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    for mod, name in ((tc, "tree_sum_plain"), (th2c, "clear_cofactor_plain"), (tpair, "product_reduce_plain")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))

    def failing(name, device, *args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tkernels, "launch", failing)
    tfp.reset_launches()
    pts = tc.Proj(*(torch.zeros(3, 2, 12, dtype=torch.int32) for _ in range(3)))
    for call in (lambda: tc.tree_sum(tc.FP2, pts, 0), lambda: th2c.clear_cofactor(pts, pts),
                 lambda: tpair.product_reduce(torch.zeros(3, 2, 3, 2, 12, dtype=torch.int32))):
        with pytest.raises(RuntimeError):
            call()
    assert all(tfp.LAUNCHES[k] == 0 for k in ("g2_tree_sum", "clear_cofactor", "product_reduce"))


def test_pow_abs_x_compositions_never_reach_k18(recorded_launches):
    """K9's plain version and the composition K9 replaced multiply their six
    checkpoints over the tower operations they are given: the composition
    launches K8 (`lh_fp12_mul`), never K18."""
    g = torch.zeros(1, 2, 3, 2, 12, dtype=torch.int32)
    tpair.pow_abs_x_composed(g, tt.KERNEL_TOWER)
    names = {name for name, _ in recorded_launches}
    assert "lh_fp12_mul" in names and "lh_product_reduce" not in names
