"""K14 `iso3_map` (csrc/h2c_kernels.cu) and K20 `g2_psi_check`
(csrc/verify_kernels.cu) on the CPU, as the kernels run them: a lane group
per element, one-warp blocks, each lane forming one component of a lazy
sum a step, the group's values handed over in shared memory (K14) or by
shuffles and ballots (K20).

A model in Python integers runs each launch's grid. It reads the lanes a
group and the elements a block, the step tables (`kIsoLane`, `kPsiLane`,
`kPsiEq`) and the enums that name their slots and operands from the
sources, so that a change of a table changes what the model runs.

- K14: lane (j, c) of a group of four forms component c of part j of a
  step as one lazy sum (`fp2_sum_part`: e_c f + a0 b0 (+ a1 b1)), each
  sum's bound checked (N <= 9 products, each below p^2; the reduction by
  test_torch_tower_kernels.redc_wide). A slot is written once and read
  only after the `__syncwarp` that follows its write; every lane inverts
  the norm (fp384.cuh `fp_inv`, its word-for-word replay); lanes past the
  end make their steps and store nothing; every output word is stored
  once.
- K20: lane (k, c) of a group of eight forms component c of product k of
  a round (`fp2_mul_part`, N = 2); round 1's operands from round 0 come by
  shuffle from the group's own lanes, off lanes make no product; the
  comparisons and the infinity flags are ballots over the group's mask;
  only the group's first lane of a live element stores.

The models' words and verdicts are held to the plain versions
(`h2c.iso3_map_plain`, `curve.g2_psi_check_plain`), and those to the jitted
JAX `iso3_map` and `psi` / `neg` / `eq_points` / `is_infinity`, at the
kernel point X0, all-(p - 1) coordinates, SSWU's points at m = 1, 7, 8, 9
and 257 (K14), and at infinities of sig, zsig and both, all-(p - 1)
coordinates, and n = 19 and 128 signatures (K20). K14's folded constants
are held to T/9, U/9, T/27 and 2U/27 computed in Python integers from the
`ref` oracle's T and U.
"""

import functools
import pathlib
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P, X as X_PARAM
from lighthouse_tpu.crypto.bls.jax_backend import curve as jcurve
from lighthouse_tpu.crypto.bls.jax_backend import h2c as jh2c
from lighthouse_tpu.crypto.bls.ref import hash_to_curve as ref_h2c
from lighthouse_tpu.crypto.bls.ref.curves import g2_generator
from lighthouse_tpu.crypto.bls.ref.fields import Fp, Fp2
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from test_torch_inversion import fp_inv_model
from test_torch_tower_kernels import redc_wide
from torch_parity import assert_same

R_MONT = (1 << 384) % P
R_INV = pow(1 << 384, -1, P)
ABS_Z = abs(X_PARAM)
_CSRC = pathlib.Path(tfp.__file__).parent / "csrc"
_H2C_SRC = (_CSRC / "h2c_kernels.cu").read_text()
_VERIFY_SRC = (_CSRC / "verify_kernels.cu").read_text()


def _int(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _enum(src, name):
    """An enum's names and values, read from the source."""
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    values, v = {}, 0
    for item in (s.strip() for s in body.split(",")):
        if "=" in item:
            item, v = (s.strip() for s in item.split("="))
            v = int(v)
        values[item] = v
        v += 1
    return values


def _table(src, name, names):
    """A `__constant__` table's rows (innermost braces), each entry an
    expression of numbers and the names in `names` joined by '+'."""
    body = re.search(rf"{name}\[[^=]*= \{{(.*?)\n\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    rows = []
    for row in re.findall(r"\{([^{}]*)\}", body):
        rows.append([sum(names[t.strip()] if t.strip() in names else int(t) for t in e.split("+"))
                     for e in row.split(",")])
    return rows


def _mm(a, b):
    """K1's CIOS product on canonical operands."""
    assert 0 <= a < P and 0 <= b < P
    return a * b * R_INV % P


def _neg(a):
    return (P - a) % P


def _lazy(terms):
    """One lazy sum of canonical products, reduced once (fp384.cuh's
    bound checked: each term below p^2, N <= 9)."""
    for a, b in terms:
        assert 0 <= a < P and 0 <= b < P
    return redc_wide(sum(a * b for a, b in terms), len(terms), 1)


def _fp2_terms(a, b, c):
    """g2.cuh `fp2_mul_part`'s two terms of component c of a b."""
    return [(a[0], b[0]), (_neg(a[1]), b[1])] if c == 0 else [(a[0], b[1]), (a[1], b[0])]


@functools.lru_cache(maxsize=None)
def _inv(a):
    return fp_inv_model(a)


# -- K14 ------------------------------------------------------------------------------

ISO_THREADS = _int(_H2C_SRC, "kIsoThreads")
ISO_LANES = _int(_H2C_SRC, "kIsoLanes")
ISO_PER_BLOCK = ISO_THREADS // ISO_LANES
ISO_STEPS = _int(_H2C_SRC, "kIsoSteps")
ISO_PAIRS = [int(v) for v in re.search(r"uint8_t kIsoPairs\[kIsoSteps\] = \{([^}]*)\};", _H2C_SRC)
             .group(1).split(",")]
CONST = _enum(_H2C_SRC, "Const")
SLOT = {**_enum(_H2C_SRC, "IsoSlot"), "kSlotOut": _int(_H2C_SRC, "kSlotOut"), "kSlotCst": _int(_H2C_SRC, "kSlotCst")}
_rows = _table(_H2C_SRC, "kIsoLane", {**SLOT, **CONST})
ISO_LANE = [[_rows[2 * s + j] for j in range(2)] for s in range(ISO_STEPS)]


def _cst_rows():
    return [tuple(tfp.words_to_int(w) for w in row) for row in th2c._H2C_CONSTS]


class Slots:
    """A lane group's slots in shared memory, a component at a time. A
    write lands at the next `__syncwarp` (`sync`); a read sees only what
    landed; a slot component is written once."""

    def __init__(self):
        self.landed, self.pending = {}, {}

    def write(self, s, c, v):
        assert 0 <= v < P
        assert (s, c) not in self.landed and (s, c) not in self.pending, f"slot {s}.{c} written twice"
        self.pending[(s, c)] = v

    def read(self, s, c):
        assert (s, c) in self.landed, f"slot {s}.{c} read before a __syncwarp after its write"
        return self.landed[(s, c)]

    def sync(self):
        self.landed.update(self.pending)
        self.pending = {}


def _iso_operand(slots, cst, s, c):
    return cst[s - SLOT["kSlotCst"]][c] if s >= SLOT["kSlotCst"] else slots.read(s, c)


def _iso_step(slots, cst, s, j, c):
    """Lane (j, c)'s share of step s: component c of e_c f + a0 b0 (+ a1
    b1 in a step of two pairs: `fp2_sum_part`, N = 2K + 1), stored in
    its slot unless it is the output. A pair the step does not take must
    be the zero slot's."""
    out, e, f, *pairs = ISO_LANE[s][j]
    K = ISO_PAIRS[s]
    assert all(v == SLOT["kSlotZero"] for v in pairs[2 * K:]), f"step {s} names a pair it does not take"
    op = lambda slot, comp: _iso_operand(slots, cst, slot, comp)  # noqa: E731
    terms = [(op(e, c), op(f, 0))]
    for a, b in zip(pairs[: 2 * K : 2], pairs[1 : 2 * K : 2]):
        terms += _fp2_terms((op(a, 0), op(a, 1)), (op(b, 0), op(b, 1)), c)
    assert len(terms) == 2 * K + 1 <= 9
    r = _lazy(terms)
    if out != SLOT["kSlotOut"]:
        slots.write(out, c, r)
    return r


def iso3_grid(x, y, cst=None):
    """K14's launch over n points (x, y), each coordinate a (c0, c1) pair of
    stored ints: returns [X, Y, Z], each a list of n pairs."""
    cst = cst or _cst_rows()
    n = len(x)
    blocks = -(-n // ISO_PER_BLOCK)
    out = {}
    for blk in range(blocks):
        groups = [Slots() for _ in range(ISO_PER_BLOCK)]
        lanes = [(lane // ISO_LANES, (lane >> 1) & 1, lane & 1) for lane in range(ISO_THREADS)]
        elem = [min(blk * ISO_PER_BLOCK + g, n - 1) for g in range(ISO_PER_BLOCK)]
        live = [blk * ISO_PER_BLOCK + g < n for g in range(ISO_PER_BLOCK)]
        for g, j, c in lanes:  # loads: component c of x or y, of zero or one
            e = elem[g]
            groups[g].write(SLOT["kSlotX"] if j == 0 else SLOT["kSlotY"], c, (x if j == 0 else y)[e][c])
            groups[g].write(SLOT["kSlotZero"] if j == 0 else SLOT["kSlotOne"], c, R_MONT if j == 1 and c == 0 else 0)
        for s in groups:
            s.sync()
        kernel_point = {}
        for g, j, c in lanes:  # step 0; d, the norm, its inverse, component c of d^-1
            slots = groups[g]
            _iso_step(slots, cst, 0, j, c)
            x0 = cst[CONST["kConstX0"]]
            d = tuple((slots.read(SLOT["kSlotX"], k) - x0[k]) % P for k in (0, 1))
            kernel_point[g] = d == (0, 0)
            ninv = _inv(_lazy([(d[0], d[0]), (d[1], d[1])]))
            r = _mm(d[c], ninv)
            if j == 0:
                slots.write(SLOT["kSlotD1"], c, _neg(r) if c == 1 else r)
        for s in groups:
            s.sync()
        for g, j, c in lanes:
            _iso_step(groups[g], cst, 1, j, c)
        for s in groups:
            s.sync()
        for g, j, c in lanes:
            r = _iso_step(groups[g], cst, 2, j, c)
            if not live[g]:
                continue
            e = elem[g]
            one = R_MONT if c == 0 else 0
            stores = [(j, (one if j == 1 else 0) if kernel_point[g] else r)]
            if j == 0:
                stores.append((2, 0 if kernel_point[g] else one))
            for coord, v in stores:
                assert (coord, e, c) not in out, f"output {coord}.{e}.{c} stored twice"
                out[(coord, e, c)] = v
    assert len(out) == 3 * 2 * n
    return [[(out[(k, e, 0)], out[(k, e, 1)]) for e in range(n)] for k in range(3)]


def _mont(a: Fp2):
    return (a.c0.n * R_MONT % P, a.c1.n * R_MONT % P)


def _words(pairs):
    return torch.from_numpy(tfp.ints_to_words([v for pair in pairs for v in pair])).reshape(len(pairs), 2, tfp.WORDS)


def _pairs(t):
    return [tuple(tfp.words_to_int(w) for w in el) for el in t.reshape(-1, 2, tfp.WORDS)]


def _sswu_points(m, seed):
    """The oracle's SSWU images of m seeded u (points of E')."""
    rnd = random.Random(seed)
    pts = [ref_h2c.sswu(Fp2(Fp(rnd.randrange(P)), Fp(rnd.randrange(P)))) for _ in range(m)]
    return [_mont(px) for px, _ in pts], [_mont(py) for _, py in pts]


X0 = _mont(ref_h2c._ISO_X0)
P1 = (P - 1, P - 1)


def _iso_case(name):
    """(x, y) of a case: the kernel point, all-(p - 1) coordinates, or m
    SSWU points (from m = 7 on lane 3 the kernel point, the last lane all
    p - 1)."""
    if name == "kernel_point":
        x, y = _sswu_points(1, 1)
        return [X0], y
    if name == "p_minus_1":
        return [P1], [P1]
    m = int(name[1:])
    x, y = _sswu_points(m, 0x140 + m)
    if m >= 7:
        x[3], x[m - 1], y[m - 1] = X0, P1, P1
    return x, y


ISO_CASES = ["kernel_point", "p_minus_1", "m1", "m7", "m8", "m9", "m257"]


@pytest.mark.parametrize("case", ISO_CASES)
def test_iso3_grid_matches_plain(case):
    """K14's grid, word for word, against `iso3_map_plain`; at m = 257 the
    plain version against the jitted JAX `iso3_map` too (at the kernel point
    and on all-(p - 1) coordinates in the other cases of this file and of
    test_torch_miller_h2c_kernels)."""
    x, y = _iso_case(case)
    want = th2c.iso3_map_plain(_words(x), _words(y))
    assert iso3_grid(x, y) == [_pairs(c) for c in want]
    if case in ("m257", "kernel_point", "p_minus_1"):
        got = jax.jit(jh2c.iso3_map)(*(jnp.asarray(tfp.to_jax_limbs(_words(v))) for v in (x, y)))
        for g, w in zip(want, got):
            assert_same(g, w)


def test_iso3_table_runs_two_steps_after_the_inversion():
    """The table's shape: four lanes a group, eight groups a warp; one step
    before the inversion, two after it, of 3, 3 and 5 products a lane;
    d^-1 read only after it is formed; the last step's two parts the
    output coordinates."""
    assert (ISO_LANES, ISO_PER_BLOCK, ISO_STEPS, ISO_PAIRS) == (4, 8, 3, [1, 1, 2])
    reads = lambda s: {v for row in ISO_LANE[s] for v in row[1:]}  # noqa: E731
    assert SLOT["kSlotD1"] not in reads(0) and SLOT["kSlotD1"] in reads(1)
    assert all(row[0] == SLOT["kSlotOut"] for row in ISO_LANE[-1])
    assert all(row[0] != SLOT["kSlotOut"] for s in range(ISO_STEPS - 1) for row in ISO_LANE[s])


def test_iso3_folded_constants_are_the_oracles():
    """T/9, U/9, T/27 and 2U/27 in the constant operand, computed here in
    Python integers from the oracle's T and U (Montgomery words); and the
    folded formulas equal the oracle's isogeny on a point."""
    T, U = ((v.c0.n, v.c1.n) for v in (ref_h2c._ISO_T, ref_h2c._ISO_U))
    i9, i27 = pow(9, -1, P), pow(27, -1, P)
    want = {"kConstT9": [t * i9 % P for t in T], "kConstU9": [u * i9 % P for u in U],
            "kConstYT": [t * i27 % P for t in T], "kConstYU": [2 * u * i27 % P for u in U]}
    cst = _cst_rows()
    for name, (c0, c1) in want.items():
        assert cst[CONST[name]] == (c0 * R_MONT % P, c1 * R_MONT % P), name
    assert ref_h2c._INV27 == -Fp(27).inv()
    px, py = ref_h2c.sswu(Fp2(Fp(5), Fp(7)))
    d = (px - ref_h2c._ISO_X0).inv()
    k = [Fp2(Fp(c0), Fp(c1)) for c0, c1 in want.values()]
    xo = px.scale(Fp(9).inv()) + k[0] * d + k[1] * d * d
    yo = py.scale(ref_h2c._INV27) + (py * k[2] + py * k[3] * d) * d * d
    q = ref_h2c.iso3_map(px, py)
    assert (xo, yo) == (q.x, q.y)


# -- K20 ------------------------------------------------------------------------------

PSI_THREADS = _int(_VERIFY_SRC, "kPsiThreads")
PSI_LANES = _int(_VERIFY_SRC, "kPsiLanes")
PSI_PER_BLOCK = PSI_THREADS // PSI_LANES
OPERAND = {**_enum(_VERIFY_SRC, "PsiOperand"), **_enum(_VERIFY_SRC, "PsiMap")}
_rows = _table(_VERIFY_SRC, "kPsiLane", OPERAND)
PSI_LANE = [_rows[:PSI_LANES // 2], _rows[PSI_LANES // 2:]]
PSI_EQ = [OPERAND[t.strip()] if t.strip() in OPERAND else int(t) for t in
          re.search(r"kPsiEq\[kPsiProducts\] = \{([^}]*)\};", _VERIFY_SRC).group(1).split(",")]
OFF, ROUND0 = OPERAND["kPsiOff"], OPERAND["kRound0"]


def _psi_operand(pt_sig, pt_zsig, psi_c, ident, mapping):
    """Operand `ident` of an element under `mapping` (K20's `psi_operand`)."""
    coords = [*pt_sig, *pt_zsig, *psi_c]
    v = coords[ident]
    if mapping == OPERAND["kNegated"]:
        return (_neg(v[0]), _neg(v[1]))
    return (v[0], _neg(v[1])) if mapping == OPERAND["kConj"] else v


def psi_grid(sig, zsig):
    """K20's launch over n elements, each point (x, y, z) of (c0, c1) pairs
    of stored ints: returns the n verdicts."""
    psi_c = [tuple(tfp.words_to_int(w) for w in c) for c in tc._PSI_C]
    n = len(sig)
    out = {}
    for blk in range(-(-n // PSI_PER_BLOCK)):
        lanes = range(PSI_THREADS)
        g = [lane // PSI_LANES for lane in lanes]
        k = [(lane % PSI_LANES) >> 1 for lane in lanes]
        c = [lane & 1 for lane in lanes]
        base = [gi * PSI_LANES for gi in g]
        live = [blk * PSI_PER_BLOCK + gi < n for gi in g]
        e = [min(blk * PSI_PER_BLOCK + gi, n - 1) for gi in g]
        operand = lambda lane, ident, mapping: _psi_operand(sig[e[lane]], zsig[e[lane]], psi_c,  # noqa: E731
                                                             ident, mapping)

        def shfl(values, lane, src):
            assert base[lane] <= src < base[lane] + PSI_LANES, f"lane {lane} reads lane {src} of another group"
            return values[src]

        r0 = []
        for lane in lanes:  # round 0
            a, am, b, bm = PSI_LANE[0][k[lane]]
            assert a < ROUND0 and b < ROUND0, "round 0 reads a product"
            r0.append(_lazy(_fp2_terms(operand(lane, a, am), operand(lane, b, bm), c[lane])))
        r1, on = [], []
        for lane in lanes:  # round 1
            a, am, b, bm = PSI_LANE[1][k[lane]]
            on.append(a != OFF)
            src = base[lane] + 2 * (a - ROUND0 if on[-1] and a >= ROUND0 else 0)
            av = (shfl(r0, lane, src), shfl(r0, lane, src + 1))
            if not on[-1]:
                assert b == OFF, "an off product reads an operand"
                r1.append(None)
                continue
            if a < ROUND0:
                av = operand(lane, a, am)
            assert b < ROUND0
            r1.append(_lazy(_fp2_terms(av, operand(lane, b, bm), c[lane])))
        diff, sz0, zz0 = [], [], []
        for lane in lanes:
            eq_k = PSI_EQ[k[lane]]
            compares = on[lane] and eq_k != OFF
            o = shfl(r0, lane, base[lane] + 2 * (eq_k if compares else 0) + c[lane])
            diff.append(compares and r1[lane] != o)
            sz0.append(sig[e[lane]][2][c[lane]] == 0)
            zz0.append(zsig[e[lane]][2][c[lane]] == 0)
        for lane in lanes:
            if not (live[lane] and lane == base[lane]):
                continue
            grp = range(base[lane], base[lane] + PSI_LANES)
            eq = all(not diff[i] for i in grp)
            p_inf, q_inf = all(sz0[i] for i in grp), all(zz0[i] for i in grp)
            assert e[lane] not in out, f"element {e[lane]} stored twice"
            out[e[lane]] = (p_inf and q_inf) or (not p_inf and not q_inf and eq) or p_inf
    assert sorted(out) == list(range(n))
    return [out[i] for i in range(n)]


def _scaled(pt, lam):
    """An oracle point as projective (x l, y l, l) in stored ints; infinity
    as (0, one, 0)."""
    if pt.inf:
        return ((0, 0), (R_MONT, 0), (0, 0))
    return tuple(_mont(v) for v in (pt.x * lam, pt.y * lam, lam))


@functools.lru_cache(maxsize=None)
def _psi_points(seed):
    """Three G2 points and a point of E2 outside G2 (the isogeny's image of
    an SSWU point, before the cofactor clearing), each with its [|z|]
    multiple."""
    rnd = random.Random(seed)
    g2 = [g2_generator().mul(rnd.getrandbits(62) | 1) for _ in range(3)]
    bad = ref_h2c.iso3_map(*ref_h2c.sswu(Fp2(Fp(rnd.randrange(P)), Fp(rnd.randrange(P)))))
    pts = g2 + [bad]
    return pts, [q.mul(ABS_Z) for q in pts]


def _psi_case(name):
    """(sig, zsig, the verdicts the criterion gives, None where the plain
    version decides). n elements cycle through: sig at infinity; zsig at
    infinity; both; all-(p - 1) coordinates; a point outside G2; a G2 point
    with another one's multiple; G2 points with their own. Every point
    finite is scaled by its own seeded l, so Z != 1 and the comparison is
    the cross-multiplied one."""
    pts, mults = _psi_points(0x20)
    inf = pts[0].mul(0)
    rnd = random.Random(name)
    lam = lambda: Fp2(Fp(rnd.randrange(1, P)), Fp(rnd.randrange(P)))  # noqa: E731
    pm1 = (P1, P1, P1)
    kinds = {"sig_inf": [0], "zsig_inf": [1], "both_inf": [2], "p_minus_1": [3]}
    n = {"n19": 19, "n128": 128}.get(name)
    seq = kinds[name] if n is None else [i % 7 for i in range(n)]
    sig, zsig, want = [], [], []
    for i, kind in enumerate(seq):
        j = i % 3
        s, z, w = {0: (inf, mults[j], True), 1: (pts[j], inf, False), 2: (inf, inf, True), 3: (None, None, None),
                   4: (pts[3], mults[3], False), 5: (pts[j], mults[(j + 1) % 3], False)}.get(kind,
                                                                                      (pts[j], mults[j], True))
        sig.append(pm1 if s is None else _scaled(s, lam()))
        zsig.append(pm1 if z is None else _scaled(z, lam()))
        want.append(w)
    return sig, zsig, want


def _proj(points):
    return tc.Proj(*(_words([p[k] for p in points]) for k in range(3)))


PSI_CASES = ["sig_inf", "zsig_inf", "both_inf", "p_minus_1", "n19", "n128"]


@pytest.mark.parametrize("case", PSI_CASES)
def test_psi_grid_matches_plain(case):
    """K20's grid against `g2_psi_check_plain`, and the plain version
    against the jitted JAX psi criterion (`psi`, `neg`, `eq_points`,
    `is_infinity`) and the verdicts the points must give."""
    sig, zsig, want = _psi_case(case)
    plain = tc.g2_psi_check_plain(_proj(sig), _proj(zsig)).tolist()
    assert psi_grid(sig, zsig) == plain
    assert all(w is None or w == p for w, p in zip(want, plain))
    jsig, jzsig = (jcurve.Proj(*(jnp.asarray(tfp.to_jax_limbs(c)) for c in _proj(v))) for v in (sig, zsig))
    rhs = jax.jit(lambda p: jcurve.neg(jcurve.FP2, p))(jzsig)
    eq = jax.jit(lambda p, q: jcurve.eq_points(jcurve.FP2, p, q))(jax.jit(jcurve.psi)(jsig), rhs)
    assert np.asarray(eq | jax.jit(lambda p: jcurve.is_infinity(jcurve.FP2, p))(jsig)).tolist() == plain


def test_psi_table_is_two_rounds():
    """Eight lanes a group, four groups a warp; round 0's four products read
    no product, round 1's two read round 0's psi coordinates and compare
    with its cross terms, the other two lanes pairs off."""
    assert (PSI_LANES, PSI_PER_BLOCK) == (8, 4)
    assert all(row[0] < ROUND0 and row[2] < ROUND0 for row in PSI_LANE[0])
    assert [row[0] for row in PSI_LANE[1]] == [ROUND0, ROUND0 + 1, OFF, OFF]
    assert PSI_EQ == [2, 3, OFF, OFF]
