"""K9 `cyclotomic_pow_x` (csrc/final_exp_kernels.cu) and K10 / K11
`g1_scalar_mul` / `g2_scalar_mul` (csrc/curve_kernels.cu) on the CPU.

1. The plain versions against the ref oracle, exactly:
   `curve.scalar_mul_bits_plain` against the oracle's point multiplication
   in G1 and G2 at 64 and 127 bits (and r - 1 at 255), with edge scalars,
   infinity and P + (-P); `pairing.pow_abs_x_plain` against the oracle's
   exponentiation by |z| on cyclotomic elements (the final
   exponentiation's easy part of seeded random ones) and one, and on a
   lane whose checkpoints all take decompression's g2 = 0 branch against
   the algorithm evaluated in the oracle's tower.
2. `pow_abs_x_plain` bit-identical to the jitted JAX `pairing._pow_abs_x`
   on the same inputs.
3. An emulation in Python integers of each kernel's per-thread schedule:
   the windowed multiplication's table build and digit loop on one thread
   (g1.cuh's / g2.cuh's formulas, G2's products as K7's lazy sums, its
   products by 3b as additions: the algorithm that K10's and K11's lane
   groups follow, curve.cuh `scalar_mul_lanes`, whose warps
   tests/test_torch_g1_scalar_mul_lanes.py and
   tests/test_torch_scalar_mul_lanes.py model), and K9's warp lane by
   lane (final_exp.cuh, its lane table `kPowLane` read from the source):
   the squarings in registers, each shuffle a read of another lane's
   value, the checkpoints in shared memory written once and read only
   after a `__syncwarp`; the decompression on twelve lanes, the norms'
   product tree and one inversion; the product of six on K8's warp
   (test_torch_tower_kernels `k8_warp`), every double-width sum checked
   against fp384.cuh's bound (test_torch_tower_kernels.redc_wide). Each
   is held to the plain version bit for bit.
4. The wrappers: one launch per call with the operands read in place
   (strides of broadcast bits and points), no fallback to the plain
   version on a CUDA tensor; the bits' window digits made without a host
   tensor; and a structurally invalid batch returning False without a GPU.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P, R, X as X_PARAM
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpair
from lighthouse_tpu.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref.fields import Fp2, Fp6, Fp12
from lighthouse_tpu.crypto.bls.ref.pairing import frobenius_n
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from test_torch_inversion import fp_inv_model
from test_torch_tower_kernels import k7_thread, k8_warp, redc_wide
from torch_parity import assert_same, to_port

rng = np.random.default_rng(0x6B9)
ABS_Z = abs(X_PARAM)
R_MONT = (1 << 384) % P
R_INV = pow(1 << 384, -1, P)


def _scalar(bits):
    return int.from_bytes(rng.bytes(bits // 8 + 1), "little") % (1 << bits)


def _bits(ks, width):
    return torch.tensor([[(k >> (width - 1 - i)) & 1 for i in range(width)] for k in ks], dtype=torch.int64)


# -- inputs ------------------------------------------------------------------------

GROUPS = {
    "g1": (g1_generator, g1_infinity, jpack.pack_g1_batch, tc.FP_PLAIN),
    "g2": (g2_generator, g2_infinity, jpack.pack_g2_batch, tc.FP2_PLAIN),
}


def _points(group, n_random):
    """Projective inputs (port words) and the oracle's points: seeded random
    subgroup points, P and -P, infinity, and P + (-P) formed by the complete
    addition (an infinity other than (0 : 1 : 0)); the random ones go
    through one addition too, so that Z != 1."""
    gen, inf, pack, F = GROUPS[group]
    base = [gen().mul(int(rng.integers(1, 1 << 62))) for _ in range(n_random + 1)]
    firsts = base[:-1] + [base[-1], -base[-1], inf(), base[-1]]
    seconds = [inf()] * (n_random + 3) + [-base[-1]]
    proj = [tc.from_affine(F, to_port(x), to_port(y), torch.from_numpy(i)) for x, y, i in
            (pack(firsts), pack(seconds))]
    pts = tc.add(F, proj[0], proj[1])
    return pts, [a + b for a, b in zip(firsts, seconds)]


def _affine(F, p, i):
    """The i-th projective point as oracle integers (None for infinity)."""
    if F.elem_dims == 1:
        x, y, z = (tfp.from_mont_host(c[i]) for c in p)
        if z == 0:
            return None
        zi = pow(z, P - 2, P)
        return x * zi % P, y * zi % P
    x, y, z = (Fp2.from_ints(tfp.from_mont_host(c[i][0]), tfp.from_mont_host(c[i][1])) for c in p)
    if z.is_zero():
        return None
    zi = z.inv()
    return x * zi, y * zi


def _ref_affine(pt):
    if pt.inf:
        return None
    return (pt.x.n, pt.y.n) if not isinstance(pt.x, Fp2) else (pt.x, pt.y)


# -- 1. the plain versions against the oracle ---------------------------------------


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("width", [64, 127])
def test_scalar_mul_plain_matches_ref(group, width):
    """Per-element scalars 0, 1, all ones and random, on random points, P,
    -P, infinity and P + (-P)."""
    F = GROUPS[group][3]
    pts, ref_pts = _points(group, 3)
    ks = [0, 1, (1 << width) - 1, _scalar(width), _scalar(width), 1, 7]
    out = tc.scalar_mul_bits_plain(F, pts, _bits(ks, width))
    for i, (pt, k) in enumerate(zip(ref_pts, ks)):
        assert _affine(F, out, i) == _ref_affine(pt.mul(k)), f"row {i}, k={k}"


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_plain_r_minus_1_is_negation(group):
    """[r - 1] P = -P for subgroup points (255 bits, broadcast public bits)."""
    F = GROUPS[group][3]
    pts, ref_pts = _points(group, 1)
    bits = np.array([((R - 1) >> (254 - i)) & 1 for i in range(255)], dtype=np.int64)
    out = tc.scalar_mul_bits_plain(F, pts, bits)
    for i, pt in enumerate(ref_pts):
        assert _affine(F, out, i) == _ref_affine(-pt), f"row {i}"


def _fp12(vals):
    return Fp12(Fp6(*(Fp2.from_ints(*vals[i : i + 2]) for i in (0, 2, 4))),
                Fp6(*(Fp2.from_ints(*vals[i : i + 2]) for i in (6, 8, 10))))


def _cyclotomic():
    """The final exponentiation's easy part f^((p^6 - 1)(p^2 + 1)) of a
    seeded random f."""
    f = _fp12([int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)])
    g = f.conj() * f.inv()
    return frobenius_n(g, 2) * g


def _g2_zero_lane():
    """An Fp12 with b0 = b2 = 0 (compressed g2 = g5 = 0, g3 and g4 not):
    compressed squaring keeps g2 = g5 = 0, so every checkpoint decompresses
    through the g2 = 0 branch with den = g3 != 0."""
    v = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
    v[6:8] = [0, 0]
    v[10:12] = [0, 0]
    return _fp12(v)


CYC = [_cyclotomic(), _cyclotomic(), Fp12.one()]
G2_ZERO = _g2_zero_lane()
POW_IN = np.stack([jpack.pack_fp12_el(x) for x in CYC + [G2_ZERO]])


def _from_gs(g0, g1, g2, g3, g4, g5):
    """Flat (g0, g2, g4, g1, g3, g5) at k = 0..5 as an oracle Fp12."""
    return Fp12(Fp6(g0, g4, g3), Fp6(g2, g1, g5))


def _ref_pow_algorithm(x: Fp12):
    """The JAX package's |z|-power algorithm in the oracle's tower: compressed
    squarings, decompression with the g2 = 0 branch, product. Also returns
    the checkpoints' (g2, g3)."""
    xi = Fp2.xi()
    c = [x.c1.c0, x.c0.c2, x.c0.c1, x.c1.c2]  # g2, g3, g4, g5
    two, three, six = (Fp2.from_ints(k, 0) for k in (2, 3, 6))
    cps = []
    for s in range(1, 64):
        g2, g3, g4, g5 = c
        c = [
            two * g2 + six * xi * g4 * g5,
            three * (g4 * g4 + xi * g5 * g5) - two * g3,
            three * (g2 * g2 + xi * g3 * g3) - two * g4,
            two * g5 + six * g2 * g3,
        ]
        if (ABS_Z >> s) & 1:
            cps.append(c)
    acc = Fp12.one()
    for g2, g3, g4, g5 in cps:
        if not g2.is_zero():
            g1 = (xi * g5 * g5 + three * g4 * g4 - two * g3) * (Fp2.from_ints(4, 0) * g2).inv()
        else:
            g1 = Fp2.zero() if g3.is_zero() else (two * g4 * g5) * g3.inv()
        g0 = xi * (two * g1 * g1 + g2 * g5 - three * g3 * g4) + Fp2.one()
        acc = acc * _from_gs(g0, g1, g2, g3, g4, g5)
    return acc, [(cp[0], cp[1]) for cp in cps]


def test_pow_abs_x_plain_matches_ref():
    """g^|z| on cyclotomic elements and one; the g2 = 0 lane against the
    same algorithm in the oracle's tower, every checkpoint with g2 = 0 and
    g3 != 0."""
    got = tpair.pow_abs_x_plain(to_port(POW_IN))
    for i, x in enumerate(CYC):
        assert jpack.unpack_fp12_el(tfp.to_jax_limbs(got[i])) == x.pow(ABS_Z), f"lane {i}"
    want, cps = _ref_pow_algorithm(G2_ZERO)
    assert all(g2.is_zero() and not g3.is_zero() for g2, g3 in cps)
    assert jpack.unpack_fp12_el(tfp.to_jax_limbs(got[-1])) == want
    assert _ref_pow_algorithm(CYC[0])[0] == CYC[0].pow(ABS_Z)  # the model itself


# -- 2. against the jitted JAX function ----------------------------------------------


def test_pow_abs_x_plain_bit_identical_to_jax():
    want = jax.jit(jpair._pow_abs_x)(jnp.asarray(POW_IN))
    assert_same(tpair.pow_abs_x_plain(to_port(POW_IN)), want)


# -- 3. the kernels' threads in Python integers ---------------------------------------


def _mmul(a, b):
    """K1's CIOS product (csrc/fp384.cuh `fp_mul`): canonical in and out."""
    assert 0 <= a < P and 0 <= b < P
    return a * b * R_INV % P


def _fp2_mul(a, b):
    """g2.cuh `fp2_mul`: each component one lazy sum of two products."""
    return tuple(k7_thread(a, b, c, tt.FP2_MUL) for c in (0, 1))


class _G1:
    b3 = tfp.words_to_int(tc.FP.b3)
    zero, one = 0, R_MONT
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(_mmul)

    @classmethod
    def mul_b3(cls, a):
        return _mmul(cls.b3, a)


class _G2:
    zero, one = (0, 0), (R_MONT, 0)
    add = staticmethod(lambda a, b: ((a[0] + b[0]) % P, (a[1] + b[1]) % P))
    sub = staticmethod(lambda a, b: ((a[0] - b[0]) % P, (a[1] - b[1]) % P))
    mul = staticmethod(_fp2_mul)

    @staticmethod
    def mul_b3(a):
        """12 (1 + u) a by additions: xi a, then 2x, 3x, 6x, 12x."""
        def mul12(x):
            t = (x + x) % P
            t = (t + x) % P
            t = (t + t) % P
            return (t + t) % P

        return mul12((a[0] - a[1]) % P), mul12((a[0] + a[1]) % P)


def _add(G, p, q):
    """g1.cuh `g1_add` / g2.cuh `g2_add`, step for step."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    t0, t1, t2 = G.mul(x1, x2), G.mul(y1, y2), G.mul(z1, z2)
    t3 = G.sub(G.mul(G.add(x1, y1), G.add(x2, y2)), G.add(t0, t1))
    t4 = G.sub(G.mul(G.add(y1, z1), G.add(y2, z2)), G.add(t1, t2))
    y3 = G.sub(G.mul(G.add(x1, z1), G.add(x2, z2)), G.add(t0, t2))
    t0 = G.add(G.add(t0, t0), t0)
    t2 = G.mul_b3(t2)
    z3 = G.add(t1, t2)
    t1 = G.sub(t1, t2)
    y3 = G.mul_b3(y3)
    x3 = G.sub(G.mul(t3, t1), G.mul(t4, y3))
    y3b = G.add(G.mul(t1, z3), G.mul(y3, t0))
    z3b = G.add(G.mul(z3, t4), G.mul(t0, t3))
    return x3, y3b, z3b


def _dbl(G, p):
    """g1.cuh `g1_dbl` / g2.cuh `g2_dbl`, step for step."""
    x, y, z = p
    t0 = G.mul(y, y)
    z3 = G.add(t0, t0)
    z3 = G.add(z3, z3)
    z3 = G.add(z3, z3)
    t1 = G.mul(y, z)
    t2 = G.mul_b3(G.mul(z, z))
    x3 = G.mul(t2, z3)
    y3 = G.add(t0, t2)
    z3 = G.mul(t1, z3)
    t2 = G.add(G.add(t2, t2), t2)
    t0 = G.sub(t0, t2)
    y3 = G.add(x3, G.mul(t0, y3))
    x3 = G.mul(t0, G.mul(x, y))
    return G.add(x3, x3), y3, z3


def scalar_mul_thread(G, point, bits):
    """The windowed multiplication on one thread, g1.cuh's / g2.cuh's
    formulas in its order: the algorithm that K10's, K11's and K17's lane
    groups (curve.cuh `scalar_mul_lanes`) follow step for step."""
    inf = (G.zero, G.one, G.zero)
    tab = [inf, point] + [None] * 14
    for k in range(8):
        u = _add(G, tab[k], tab[k + 1])
        if 2 * k + 2 < 16:
            tab[2 * k + 2] = _add(G, tab[k + 1], tab[k + 1])
        tab[2 * k + 1] = u
    padded = [0] * ((-len(bits)) % 4) + list(bits)
    acc = inf
    for j in range(len(padded) // 4):
        for _ in range(4):
            acc = _dbl(G, acc)
        d = int("".join(map(str, padded[4 * j : 4 * j + 4])), 2)
        acc = _add(G, acc, tab[d])
    return acc


def _coord_ints(c, i, elem_dims):
    if elem_dims == 1:
        return tfp.words_to_int(c[i])
    return tuple(tfp.words_to_int(w) for w in c[i])


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("width", [64, 127])
def test_scalar_mul_thread_matches_plain(group, width):
    """The lane groups' schedule on one thread in Python integers (the
    algorithm K10's and K11's lane groups run, modelled lane by lane in
    tests/test_torch_g1_scalar_mul_lanes.py and
    tests/test_torch_scalar_mul_lanes.py) equals the plain version's
    projective coordinates word for word (row 1 of the table rebuilt as
    T_0 + T_1, digit 0 adding infinity, the MSB padding)."""
    F = GROUPS[group][3]
    G = _G1 if group == "g1" else _G2
    pts, _ = _points(group, 1)
    ks = [0, (1 << width) - 1, _scalar(width), 1, 5]
    bits = _bits(ks, width)
    want = tc.scalar_mul_bits_plain(F, pts, bits)
    for i in range(len(ks)):
        point = tuple(_coord_ints(c, i, F.elem_dims) for c in pts)
        got = scalar_mul_thread(G, point, bits[i].tolist())
        assert got == tuple(_coord_ints(c, i, F.elem_dims) for c in want), f"row {i}"


def _mont_inv(a):
    """fp384.cuh `fp_inv` on a Montgomery value, (a R^-1)^-1 R, 0 -> 0: its
    binary GCD replayed word for word (test_torch_inversion)."""
    return fp_inv_model(a)


def _tower_flat(x):
    """Port tower Fp12 (2, 3, 2, 12) -> flat list of six (c0, c1) ints."""
    return [tuple(tfp.words_to_int(w) for w in c) for c in tt._to_flat(x)]


_FINAL_EXP_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "final_exp.cuh").read_text()
POW_FLAG = {name: int(v) for name, v in re.findall(
    r"(k\w+) = (\d+),", re.search(r"enum PowFlag : uint8_t \{(.*?)\};", _FINAL_EXP_SRC, re.S).group(1))}
POW_FIELDS = re.search(r"struct PowLane \{\s*uint8_t ([^;]*);", _FINAL_EXP_SRC).group(1).replace(" ", "").split(",")


POW_LANES = int(re.search(r"constexpr int kPowLanes = (\d+);", _FINAL_EXP_SRC).group(1))


def _pow_lanes():
    """`kPowLane`'s rows, each a dict of PowLane's fields, the flags an or
    of PowFlag's names, read from final_exp.cuh."""
    body = re.search(r"PowLane kPowLane\[kPowLanes\] = \{(.*?)\n\};", _FINAL_EXP_SRC, re.S).group(1)
    rows = []
    for row in re.findall(r"\{([^{}]*)\}", re.sub(r"//[^\n]*", "", body)):
        vals = [sum(POW_FLAG[t.strip()] for t in e.split("|")) if "k" in e else int(e) for e in row.split(",")]
        rows.append(dict(zip(POW_FIELDS, vals)))
    assert len(rows) == POW_LANES
    return rows


POW_LANE = _pow_lanes()
POW_ABS_Z = int(re.search(r"kAbsZ = (0x[0-9a-f]+)ull;", _FINAL_EXP_SRC).group(1), 16)
POW_STEPS = int(re.search(r"constexpr int kSteps = (\d+);", _FINAL_EXP_SRC).group(1))
POW_CHECKPOINTS = int(re.search(r"constexpr int kCheckpoints = (\d+);", _FINAL_EXP_SRC).group(1))
SLOT_FLAT = (1, 4, 2, 5)  # compressed slots g2, g3, g4, g5 as flat Fp12 coefficients


class Shared:
    """A block's shared-memory slots. A write lands at the next `__syncwarp`
    (`sync`); a read sees only what landed; a slot is written at most once
    between two syncs. `once` names the slots written once in all."""

    def __init__(self, once=()):
        self.landed, self.pending, self.once, self.written = {}, {}, set(once), set()

    def write(self, key, v):
        assert 0 <= v < P
        assert key not in self.pending, f"{key} written twice before a __syncwarp"
        if key[0] in self.once:
            assert key not in self.written, f"{key} written twice"
            self.written.add(key)
        self.pending[key] = v

    def read(self, key):
        assert key in self.landed, f"{key} read before a __syncwarp after its write"
        return self.landed[key]

    def sync(self):
        self.landed.update(self.pending)
        self.pending = {}


def _shfl(vals, src):
    """__shfl_sync over the warp: lane l receives lane src[l]'s value."""
    return [vals[s] for s in src]


def _sqr_part(a, c):
    """g2.cuh `fp2_sqr_part`: c0 = (a0 + a1)(a0 - a1), c1 = (a0 + a0) a1."""
    x = (a[0] + (a[0] if c else a[1])) % P
    y = a[1] if c else (a[0] - a[1]) % P
    return redc_wide(x * y, 1, 1)


def _mul_part(a, b, c):
    """g2.cuh `fp2_mul_part` (K7's split): one lazy sum of N = 2."""
    return k7_thread(a, b, c, tt.FP2_MUL)


def _pow_chain(g, sh):
    """K9's 63 squarings, lane by lane (final_exp.cuh, `kPowLane`): each of
    the 32 lanes keeps `own`, lanes 24-31 repeating lanes 0-7; per step
    the operand shuffles, one product a lane (a half of an Fp2 product's
    or square's component: its pair's sums added, doubled where kDbl), the
    update's shuffles and additions; the keepers store the checkpoint
    steps."""
    me = [POW_LANE[lane % POW_LANES] for lane in range(32)]
    keepers = {(m["slot"], m["c"]): lane for lane, m in enumerate(me[:POW_LANES])
               if m["flags"] & POW_FLAG["kOwner"]}
    assert len(keepers) == 8, "every state component has one keeper"
    for m in me:  # operands come from keepers only
        assert all(me[m[f]]["flags"] & POW_FLAG["kOwner"] for f in ("u", "v"))
    own = [g[SLOT_FLAT[m["slot"]]][m["c"]] for m in me]
    for s in range(1, POW_STEPS + 1):
        u, v = _shfl(own, [m["u"] for m in me]), _shfl(own, [m["v"] for m in me])
        wide = []
        for m, x, y in zip(me, u, v):
            x = (P - x) % P if m["flags"] & POW_FLAG["kNegU"] else x
            assert 0 <= x < P and 0 <= y < P
            wide.append(x * y)
        other = _shfl(wide, [lane ^ 1 for lane in range(32)])
        pr = []
        for m, t, o in zip(me, wide, other):
            if m["flags"] & POW_FLAG["kDbl"]:
                pr.append(redc_wide(2 * (t + o), 4, 1))
            else:
                pr.append(redc_wide(t + o, 2, 1))
        r1, r2 = _shfl(pr, [m["a"] for m in me]), _shfl(pr, [m["b"] for m in me])
        for lane, m in enumerate(me):
            x = pr[lane]
            if m["flags"] & POW_FLAG["kXi"]:
                x = (x + r1[lane]) % P if m["c"] == 1 else (x - r1[lane]) % P
            if m["flags"] & POW_FLAG["kAddB"]:
                x = (x + r2[lane]) % P
            two_g = 2 * own[lane] % P
            own[lane] = (2 * x + (x + (P - two_g if m["flags"] & POW_FLAG["kMinus"] else two_g))) % P
        if (POW_ABS_Z >> s) & 1:
            idx = bin(POW_ABS_Z & ((1 << s) - 1)).count("1")
            for (slot, c), lane in keepers.items():
                sh.write(("cp", idx, slot, c), own[lane])
    sh.sync()


def cyclotomic_pow_x_block(g):
    """One block of K9 (csrc/final_exp_kernels.cu, final_exp.cuh
    `cyclotomic_pow_x_block`), lane by lane on one warp: g and the result
    as flat lists of six Fp2 (c0, c1) Montgomery ints. Shared memory is a
    `Shared` (checkpoints written once, every read after a `__syncwarp`
    that follows its write); shuffles read other lanes' registers."""
    sh = Shared(once=("cp", "dec"))
    _pow_chain(g, sh)
    lanes = range(32)
    tc_ = [((lane >> 1) % POW_CHECKPOINTS, lane & 1) for lane in lanes]
    lead = [lane < 2 * POW_CHECKPOINTS for lane in lanes]
    partner = [lane ^ 1 for lane in lanes]
    cp = [[tuple(sh.read(("cp", t, s, k)) for k in (0, 1)) for s in range(4)] for t, _ in tc_]

    # part 1: products, num, den, den's norm (the pair's squares added)
    q = [_sqr_part(cp[lane][3], c) for lane, (_, c) in enumerate(tc_)]
    qo = _shfl(q, partner)
    norm_wide, dens = [], []
    for lane, (t, c) in enumerate(tc_):
        g2, g3, g4, g5 = cp[lane]
        r34, r25 = _mul_part(g3, g4, c), _mul_part(g2, g5, c)
        x = (q[lane] + qo[lane]) % P if c else (q[lane] - qo[lane]) % P
        x = (x + 3 * _sqr_part(g4, c) - 2 * g3[c]) % P
        num2 = 2 * _mul_part(g4, g5, c) % P
        nz = g2 != (0, 0)
        num, den = (x, 4 * g2[c] % P) if nz else (num2, g3[c])
        if lead[lane]:
            for j, val in enumerate((num, den, r34, r25)):
                sh.write(("dec", t, j, c), val)
        dens.append(den)
        norm_wide.append(den * den)
    other = _shfl(norm_wide, partner)
    norm = [redc_wide(w + o, 2, 1) for w, o in zip(norm_wide, other)]
    sh.sync()

    # the norms' inverses: a product tree over the lanes, one inversion
    m = [n or R_MONT for n in norm]
    mp = _shfl(m, [2 * (t ^ 1) + c for t, c in tc_])
    pp = [_mmul(a, b) for a, b in zip(m, mp)]
    q1 = _shfl(pp, [4 * (((t >> 1) + 1) % 3) + c for t, c in tc_])
    q2 = _shfl(pp, [4 * (((t >> 1) + 2) % 3) + c for t, c in tc_])
    others = [_mmul(b, _mmul(x, y)) for b, x, y in zip(mp, q1, q2)]
    total = {_mmul(o, a) for o, a in zip(others, m)}
    assert len(total) == 1, "every lane inverts the same value"
    inv = _mont_inv(total.pop())
    inv = [_mmul(inv, o) if n else 0 for o, n in zip(others, norm)]
    assert all(i == _mont_inv(n) for i, n in zip(inv, norm))

    # part 2: g1 = num / den, g0, the tower layout
    num = [tuple(sh.read(("dec", t, 0, k)) for k in (0, 1)) for t, _ in tc_]
    d = []
    for lane, (t, c) in enumerate(tc_):
        r = _mmul(sh.read(("dec", t, 1, c)), inv[lane])
        d.append((P - r) % P if c else r)
    do = _shfl(d, partner)
    g1c = [_mul_part(num[lane], (do[lane], d[lane]) if c else (d[lane], do[lane]), c)
           for lane, (_, c) in enumerate(tc_)]
    g1o = _shfl(g1c, partner)
    a = []
    for lane, (t, c) in enumerate(tc_):
        g1 = (g1o[lane], g1c[lane]) if c else (g1c[lane], g1o[lane])
        r = (2 * _sqr_part(g1, c) + sh.read(("dec", t, 3, c)) - 3 * sh.read(("dec", t, 2, c))) % P
        a.append(r)
    ao = _shfl(a, partner)
    for lane, (t, c) in enumerate(tc_):
        g0 = (a[lane] + ao[lane]) % P if c else (a[lane] - ao[lane] + R_MONT) % P
        if lead[lane]:
            g2, g3, g4, g5 = cp[lane]
            for k, val in enumerate((g0, g2[c], g4[c], g1c[lane], g3[c], g5[c])):
                sh.write(("f", t, k, c), val)
    sh.sync()

    # ((f0 f3)(f1 f4))(f2 f5): five of K8's warp products on the slots
    def fp12(name, i):
        return [tuple(sh.read((name, i, k, c)) for c in (0, 1)) for k in range(6)]

    out = None
    for i in range(5):
        x = fp12("f", i) if i < 3 else fp12("p", 0)
        y = fp12("f", i + 3) if i < 3 else fp12("p", i - 2)
        r = k8_warp(x, y, tt.FP12_FULL)
        if i < 4:
            for k in range(6):
                for c in (0, 1):
                    sh.write(("p", i if i < 3 else 0, k, c), r[k][c])
        else:
            out = r
        sh.sync()
    return out


def test_cyclotomic_pow_x_block_matches_plain():
    x = to_port(POW_IN)
    want = tpair.pow_abs_x_plain(x)
    for i in range(x.shape[0]):
        assert cyclotomic_pow_x_block(_tower_flat(x[i])) == _tower_flat(want[i]), f"lane {i}"


# -- 4. the wrappers -----------------------------------------------------------------


@pytest.fixture
def recorded_launches(monkeypatch):
    """Operands dispatch as if they lay on a CUDA device; every launch is
    recorded as (launcher, args) and does nothing; the plain versions fail."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    monkeypatch.setattr(tc, "scalar_mul_bits_plain", lambda *a: pytest.fail("took the plain version"))
    monkeypatch.setattr(tpair, "pow_abs_x_plain", lambda *a: pytest.fail("took the plain version"))
    return seen


def _proj(n, elem_dims):
    """n points of stand-in words (the launches are recorded, not run)."""
    shape = (n, 2, 12) if elem_dims == 2 else (n, 12)
    t = torch.arange(3 * int(np.prod(shape)), dtype=torch.int32).reshape(3, *shape)
    return tc.Proj(t[0], t[1], t[2])


def test_scalar_mul_wrapper_reads_bits_in_place(recorded_launches):
    """K10 with per-element int32 bits; K11 with clear_cofactor's broadcast
    int64 rows (2, 1, 128) over a (2, 3) batch and with public numpy bits
    (stride 0), one launch each and no copy of the bits."""
    p1 = _proj(4, 1)
    r_bits = torch.zeros(4, 64, dtype=torch.int32)
    out = tc.scalar_mul_bits(tc.FP, p1, r_bits)
    (name, args), = recorded_launches
    assert name == "lh_g1_scalar_mul"
    assert args[:6] == (p1.x.data_ptr(), 12, p1.y.data_ptr(), 12, p1.z.data_ptr(), 12)
    assert args[6:] == (r_bits.data_ptr(), 4, 0, 64 * 4, 4, 64, out.x.data_ptr(), 4)
    assert out.x.shape == (4, 12) and out.z.data_ptr() == out.x.data_ptr() + 2 * 4 * 48

    recorded_launches.clear()
    p2 = tc.Proj(*(c.reshape(2, 3, 2, 12) for c in _proj(6, 2)))
    cc = tfp.const(th2c._CC_BITS, "cpu").reshape(2, 1, th2c._CC_WIDTH)
    tc.scalar_mul_bits(tc.FP2, p2, cc)
    tc.scalar_mul_bits(tc.FP2, p2, tc._ABS_X_BITS)
    (n1, a1), (n2, a2) = recorded_launches
    assert n1 == n2 == "lh_g2_scalar_mul" and a1[:6] == (p2.x.data_ptr(), 24, p2.y.data_ptr(), 24, p2.z.data_ptr(), 24)
    width = th2c._CC_WIDTH  # 128
    assert a1[6:12] == (cc.data_ptr(), 3, width * 8, 0, 8, width) and a1[13] == 6
    assert a2[7:12] == (6, 0, 0, 8, 64)

    recorded_launches.clear()  # three levels of strides: copied once, then per element
    p3 = tc.Proj(*(c.reshape(2, 3, 4, 12) for c in _proj(24, 1)))
    b3 = torch.zeros(2, 1, 4, 64, dtype=torch.int32)
    tc.scalar_mul_bits(tc.FP, p3, b3)
    (_, a3), = recorded_launches
    assert a3[6] != b3.data_ptr() and a3[7:12] == (24, 0, 64 * 4, 4, 64)


def test_pow_abs_x_wrapper_is_one_launch(recorded_launches):
    """K9: one launch, a contiguous batch with element stride 144 words, one
    element broadcast with 0; any leading shape."""
    f = torch.from_numpy(tfp.to_mont_host_bulk(range(1, 12 * 6 + 1))).reshape(2, 3, 2, 3, 2, 12)
    out = tpair.pow_abs_x(f)
    tpair.pow_abs_x(f[0, 0].expand(4, 2, 3, 2, 12))
    (n1, a1), (n2, a2) = recorded_launches
    assert n1 == n2 == "lh_cyclotomic_pow_x" and out.shape == f.shape
    assert a1 == (f.data_ptr(), 144, out.data_ptr(), 6) and (a2[1], a2[3]) == (0, 4)


def test_scalar_mul_and_pow_raise_on_a_failed_launch(monkeypatch):
    """On a CUDA tensor the wrappers launch or raise: a failed build or
    launch (here: no nvcc) is never replaced by the plain version."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tc, "scalar_mul_bits_plain", lambda *a: pytest.fail("took the plain version"))
    monkeypatch.setattr(tpair, "pow_abs_x_plain", lambda *a: pytest.fail("took the plain version"))

    def failing(name, device, *args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tkernels, "launch", failing)
    tfp.reset_launches()
    with pytest.raises(RuntimeError):
        tc.scalar_mul_bits(tc.FP2, _proj(2, 2), torch.zeros(2, 64, dtype=torch.int64))
    with pytest.raises(RuntimeError):
        tpair.pow_abs_x(torch.zeros(1, 2, 3, 2, 12, dtype=torch.int32))
    assert tfp.LAUNCHES["g2_scalar_mul"] == tfp.LAUNCHES["cyclotomic_pow_x"] == 0


def test_window_digits_copies_no_host_tensor(monkeypatch):
    """The plain version's digit weights come from a cached device constant,
    not a tensor built from a Python list on every call."""
    bits = _bits([0xD201000000010000, 5], 64)
    tc._window_digits(bits)  # the constant is cached on first use

    def no_tensor(*args, **kwargs):
        raise AssertionError("torch.tensor called inside _window_digits")

    monkeypatch.setattr(torch, "tensor", no_tensor)
    got = tc._window_digits(bits)
    assert got[0].tolist() == [int(h, 16) for h in "d201000000010000"] and got[1, -1] == 5


def test_invalid_batches_return_false_without_a_gpu(monkeypatch):
    """With no CUDA device, an empty batch and a batch with a keyless set
    return False (and a False future) instead of raising; a valid batch
    still raises, since the entry points never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sk, pk = tapi.interop_keypair(0)
    msg = b"\x42" * 32
    good = tapi.SignatureSet(signature=sk.sign(msg), signing_keys=[pk], message=msg)
    ragged = [good, tapi.SignatureSet(signature=sk.sign(msg), signing_keys=[], message=msg)]
    for sets in ([], ragged):
        assert tapi.verify_signature_sets(sets) is False
        assert tapi.verify_signature_sets_async(sets).result() is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.verify_signature_sets([good])


def test_final_exponentiation_runs_five_chains():
    """All five |z|-power chains of the final exponentiation go through the
    |z|-power function it is given: `pow_abs_x` (K9 on the card) in the
    composition K19 replaced, `pow_abs_x_plain` in K19's plain version; the
    result is the oracle's, and the wrapper's (K19's plain version here)."""
    calls = []

    def counted(pow_x):
        return lambda g: calls.append(g.shape) or pow_x(g)

    f = _fp12([int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)])
    x = to_port(jpack.pack_fp12_el(f))
    got = tpair.final_exponentiation_composed(x, tt.KERNEL_TOWER, counted(tpair.pow_abs_x))
    assert len(calls) == 5
    plain = tpair.final_exponentiation_composed(x, tt.PLAIN_TOWER, counted(tpair.pow_abs_x_plain))
    assert len(calls) == 10
    from lighthouse_tpu.crypto.bls.ref.pairing import final_exponentiation

    assert jpack.unpack_fp12_el(tfp.to_jax_limbs(got)) == final_exponentiation(f)
    assert torch.equal(plain, got) and torch.equal(tpair.final_exponentiation(x), got)


def test_k9_phase_probe_stamps_the_sources():
    """final_exp.cuh marks the end of each phase that
    chip_probes/k9_chain_phases.py stamps with a `// K9_PHASE(i)` line,
    phases 0-5 and the product loop's 6 + i, and the probe turns each into
    a stamp; in K19's body it stamps the five chains, the Frobenius maps
    and the conjugations, `fp12_inv_block` once, and `fp12_mul_block`
    inside."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_probes" / "k9_chain_phases.py"
    spec = importlib.util.spec_from_file_location("k9_chain_phases", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    csrc = pathlib.Path(tfp.__file__).parent / "csrc"
    assert probe.layout_of(_FINAL_EXP_SRC) == "register_chain"
    marks = re.findall(r"^ *// K9_PHASE\((.+)\)$", _FINAL_EXP_SRC, re.M)
    assert tuple(marks) == probe.PHASES == ("0", "1", "2", "3", "4", "5", "6 + i")
    stamped = probe.stamped_header(_FINAL_EXP_SRC)
    assert not re.search(r"^ *// K9_PHASE\(", stamped, re.M) and all(f"K9_MARK({m});" in stamped for m in marks)
    assert len(probe.NAMES["register_chain"]) == 11
    k19 = probe.stamped_k19((csrc / "final_exponentiation_kernels.cu").read_text())
    assert k19.count("K19_ADD(0,") == 5 and k19.count("K19_ADD(2,") == 1 and k19.count("K19_ADD(1,") == 1
    assert k19.count("K19_ADD(3,") == 5 and k19.count("K19_ADD(4,") == 5
