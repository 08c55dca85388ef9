"""K15 `g1_tree_sum` / K16 `g2_tree_sum` and K18 `product_reduce`
(csrc/fold_kernels.cu) and K17 `clear_cofactor` (csrc/cofactor_kernels.cu)
on the CPU.

1. The plain versions against the JAX package and the oracle:
   `curve.tree_sum_plain` bit-identical to the JAX package's
   `api._tree_fold` (its halving tree as written, each level's complete
   addition the jitted JAX `curve.add`) for G1 along axis 1 and G2 along
   axis 0, with infinity lanes, P == Q and P == -Q; `product_reduce_plain`
   bit-identical to the JAX `pairing.product_reduce` (each level's product
   the jitted JAX `fp12_mul`) at n = 1, 2, 3, 5; `clear_cofactor_plain`
   bit-identical to the composition it replaced, its affine result the
   oracle's `clear_cofactor_g2` of q0 + q1; (slow) bit-identical to the
   jitted JAX `map_to_g2` tail, the sum and `clear_cofactor`.
2. A model in Python integers of each kernel: K15/K16's block (the levels
   through two scratch halves, the odd leftover read from row 2 half),
   K17's thread pair (lane 0: t3 and [z^2 - z - 1] p; lane 1: psi(p),
   [|z - 1|] psi(p), negated; then lane 0's two additions) and K18's
   levels of K8's six-thread products, every double-width sum checked
   against fp384.cuh's bound (test_torch_tower_kernels.redc_wide), on real
   inputs and on all-(p - 1) inputs, held to the plain versions bit for
   bit.
3. The wrappers: one launch per call with the operands read in place, a
   raise on a failed launch and no fallback to the plain version on a
   CUDA tensor; K9's plain version and the composition K9 replaced keep
   their products over the tower operations, never K18.
"""

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
from test_torch_curve_final_exp_kernels import _G1, _G2, _add, _dbl, _fp2_mul, scalar_mul_thread
from test_torch_tower_kernels import k8_thread
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


REDUCE_IN = {n: _fp12_limbs(n) for n in (1, 2, 3, 5)}
_JAX_FP12_MUL = _padded(jax.jit(jtower.fp12_mul), 4, rows=2)


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


def tree_block(G, column):
    """One block of K15 / K16 (csrc/fold_kernels.cu `tree_sum`): a level
    reads its source (the caller's points, then a scratch half) and writes
    point i of the other scratch half, the pair sum of rows i and i + half
    for i < half and row 2 half, the odd leftover, for i = half."""
    src, bufs, nxt = list(column), [None, None], 0
    while len(src) > 1:
        n = len(src)
        half, m = n // 2, n // 2 + n % 2
        dst = [None] * m
        for i in range(m):
            a = src[i if i < half else 2 * half]
            dst[i] = _add(G, a, src[i + half]) if i < half else a
        bufs[nxt] = dst
        src, nxt = dst, nxt ^ 1
    return src[0]


def _all_p_minus_1(shape, elem_dims):
    w = torch.from_numpy(tfp.int_to_words(P - 1))
    return tc.Proj(*(w.expand(*shape, *([2] if elem_dims == 2 else []), tfp.WORDS).clone() for _ in range(3)))


@pytest.mark.parametrize("group,shape,axis", FOLDS, ids=[f"{g}_{'x'.join(map(str, s))}" for g, s, _ in FOLDS])
def test_tree_block_matches_plain(group, shape, axis):
    """K15 / K16's block on every column, and on columns of all-(p - 1)
    coordinates (the lazy sums' bound asserted inside K7's thread model),
    word for word against `tree_sum_plain`."""
    F = GROUPS[group][5]
    G = _G1 if group == "g1" else _G2
    for pts in (_port_points(group, *FOLD_IN[(group, shape)]), _all_p_minus_1(shape, F.elem_dims)):
        want = tc.tree_sum_plain(F, pts, axis)
        cols = tc.Proj(*(c.movedim(axis, 0).reshape(shape[axis], -1, *c.shape[len(shape):]) for c in pts))
        want_cols = tc.Proj(*(c.reshape(-1, *c.shape[len(shape) - 1:]) for c in want))
        for j in range(cols.x.shape[1]):
            column = [tuple(_ints(c[:, j], i, F.elem_dims) for c in cols) for i in range(shape[axis])]
            assert tree_block(G, column) == tuple(_ints(c, j, F.elem_dims) for c in want_cols), f"column {j}"


def _psi_ints(p):
    """cofactor_kernels.cu `g2_psi`: conjugates, then K7's lazy products."""
    cx, cy = (tuple(tfp.words_to_int(w) for w in c) for c in tc._PSI_C)
    conj = [(c[0], (-c[1]) % P) for c in p]
    return _fp2_mul(conj[0], cx), _fp2_mul(conj[1], cy), conj[2]


def cofactor_pair(p, q):
    """K17's thread pair on one element (csrc/cofactor_kernels.cu)."""
    if q is not None:
        p = _add(_G2, p, q)  # both lanes
    t3 = _psi_ints(_psi_ints(_dbl(_G2, p)))  # lane 0, while lane 1 forms psi(p)
    t1 = scalar_mul_thread(_G2, p, th2c._CC_BITS[0].tolist())
    t2 = scalar_mul_thread(_G2, _psi_ints(p), th2c._CC_BITS[1].tolist())
    t2 = (t2[0], tuple((-v) % P for v in t2[1]), t2[2])  # lane 1, handed to lane 0
    return _add(_G2, _add(_G2, t1, t2), t3)


def test_cofactor_pair_matches_plain(cofactor_out):
    """K17's thread pair on every lane (u = 0's point, q1 = q0, -q0 and
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


def _flat(x, i):
    return [tuple(tfp.words_to_int(w) for w in c) for c in tt._to_flat(x[i])]


def reduce_block(values):
    """K18's block: each level's products by six-thread groups of K8's
    routine (csrc/tower.cuh `fp12_mul_thread`), the odd leftover copied."""
    src = list(values)
    while len(src) > 1:
        n, half = len(src), len(src) // 2
        dst = [[tuple(k8_thread(src[i], src[i + half], k, comp, range(6)) for comp in (0, 1)) for k in range(6)]
               for i in range(half)]
        src = dst + ([src[2 * half]] if n % 2 else [])
    return src[0]


@pytest.mark.parametrize("n", sorted(REDUCE_IN))
def test_reduce_block_matches_plain(n):
    """On seeded values (the first all p - 1) and on all-(p - 1) values."""
    for fs in (to_port(REDUCE_IN[n]), torch.from_numpy(tfp.int_to_words(P - 1)).expand(n, 2, 3, 2, 12)):
        want = tpair.product_reduce_plain(fs)
        assert reduce_block([_flat(fs, i) for i in range(n)]) == _flat(want[None], 0)


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
    Fp12 values, stride 144 words. One launch each."""
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
    assert a3[:2] == (fs.data_ptr(), 144) and a3[-1] == 5 and a3[-2] == f.data_ptr() and f.shape == (2, 3, 2, 12)


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
