"""K12 `miller_loop` (csrc/pairing_kernels.cu) and K13 `sswu` / K14
`iso3_map` (csrc/h2c_kernels.cu) on the CPU.

1. The Miller loop's steps and the plain versions against the JAX package:
   one doubling step and one addition step of the port (over the plain
   operations and over the kernels' wrappers) bit-identical to the jitted
   JAX `_dbl_step` / `_add_step`; `fp2_sqrt_candidate` (over the plain
   operations) to the jitted JAX `fp2_sqrt_candidate`, the alpha = -1
   branch included; `iso3_map_plain` to the jitted JAX `iso3_map`, the
   kernel point X0 included; `sswu_plain` to the ref oracle on u = 0 (the
   t1 = 0 branch), 1, u, -1 and seeded u, with and without the sign flip;
   `miller_loop` on CPU tensors (its plain version) bit-identical to the
   composition over the kernels' wrappers, with infinity lanes.
2. A model in Python integers of each kernel's threads: K12's block (the
   line warp's step groups one iteration ahead of the f warp on a
   two-slot ring of lines, the ring's read/write order asserted; the f
   warp's products on twelve lanes), K13's four threads (the
   prologue, the windowed power chains split over a thread pair, the
   exchange, the selects; the chains read from h2c_kernels.cu's
   `kSqrtChain`, folded back into p >> 2 and p >> 1 and held to the
   5-bit sliding window of p) and K14's lane groups
   (test_torch_iso3_psi_lanes), every double-width sum
   checked against fp384.cuh's bound (test_torch_tower_kernels.redc_wide),
   on real inputs and on all-(p - 1) inputs, held to the plain versions
   bit for bit.
3. The wrappers: one launch per call with the operands read in place
   (element stride 0 for a broadcast operand), no fallback to the plain
   version on a CUDA tensor.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P, X as X_PARAM
from lighthouse_tpu.crypto.bls.jax_backend import curve as jcurve
from lighthouse_tpu.crypto.bls.jax_backend import h2c as jh2c
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpair
from lighthouse_tpu.crypto.bls.ref import hash_to_curve as ref_h2c
from lighthouse_tpu.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref.fields import Fp, Fp2
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from lighthouse_tpu_torch.crypto.bls.torch_backend.curve import Proj
from test_torch_iso3_psi_lanes import iso3_grid
from test_torch_tower_kernels import fp12_lane, k7_thread, redc_wide
from torch_parity import assert_same, to_port

rng = np.random.default_rng(0x712)
ABS_Z = abs(X_PARAM)
R_MONT = (1 << 384) % P
R_INV = pow(1 << 384, -1, P)
TOWERS = {"plain": tt.PLAIN_TOWER, "kernel_tower": tt.KERNEL_TOWER}


def _rand_ints(n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _fp2_limbs(pairs):
    """(n, 2, 32) JAX limbs of stored (Montgomery) values."""
    from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp

    return jfp.ints_to_limbs([x for pair in pairs for x in pair]).reshape(len(pairs), 2, jfp.N_LIMBS)


def _fp2_vals(t):
    """Port Fp2 words (n, 2, 12) -> list of (c0, c1) stored ints."""
    return [tuple(tfp.words_to_int(w) for w in el) for el in t.reshape(-1, 2, tfp.WORDS)]


def _mont(x: Fp2):
    return (x.c0.n * R_MONT % P, x.c1.n * R_MONT % P)


# -- 1. against the JAX package and the oracle ------------------------------------

# random Fp2 coordinates (the step formulas hold for any field elements),
# the first lane all p - 1
STEP_PAIRS = [[(P - 1, P - 1)] + [tuple(_rand_ints(2)) for _ in range(3)] for _ in range(5)]
STEP_FP = [[P - 1] + _rand_ints(3) for _ in range(2)]
_JAX_DBL = jax.jit(jpair._dbl_step)
_JAX_ADD = jax.jit(jpair._add_step)


@pytest.mark.parametrize("tower", sorted(TOWERS))
@pytest.mark.parametrize("step", ["dbl", "add"])
def test_step_bit_identical_to_jax(step, tower):
    """T's new coordinates and the line (A0, A3, A5), word for word."""
    from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp

    X, Y, Z, qx, qy = (_fp2_limbs(p) for p in STEP_PAIRS)
    xp, yp = (jfp.ints_to_limbs(v) for v in STEP_FP)
    t_port = Proj(to_port(X), to_port(Y), to_port(Z))
    t_jax = jcurve.Proj(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z))
    if step == "dbl":
        got_t, got_line = tpair._dbl_step(t_port, to_port(xp), to_port(yp), TOWERS[tower])
        want_t, want_line = _JAX_DBL(t_jax, jnp.asarray(xp), jnp.asarray(yp))
    else:
        got_t, got_line = tpair._add_step(t_port, to_port(qx), to_port(qy), to_port(xp), to_port(yp), TOWERS[tower])
        want_t, want_line = _JAX_ADD(t_jax, jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(xp), jnp.asarray(yp))
    for g, w in zip((*got_t, *got_line), (*want_t, *want_line)):
        assert_same(g, w)


# x = -1 is a non-square of Fp, so alpha = x^((p-1)/2) = -1: the u x0 branch
SQRT_X = [(0, 0), (R_MONT, 0), (P - R_MONT, 0), (P - 1, P - 1)] + [tuple(_rand_ints(2)) for _ in range(4)]


def test_fp2_sqrt_candidate_bit_identical_to_jax():
    x = _fp2_limbs(SQRT_X)
    want = jax.jit(jh2c.fp2_sqrt_candidate)(jnp.asarray(x))
    assert_same(th2c.fp2_sqrt_candidate(to_port(x), tt.PLAIN_TOWER), want)
    m1 = Fp2(Fp(P - 1), Fp(0))
    a1 = m1.pow((P - 3) // 4)
    assert a1 * (a1 * m1) == m1, "x = -1 does not take the alpha = -1 branch"


def _sswu_inputs():
    """u = 0 (t1 = 0), 1, u, -1, then seeded elements; both sign cases of
    the final flip occur among them."""
    us = [Fp2.zero(), Fp2.one(), Fp2(Fp(0), Fp(1)), Fp2(Fp(P - 1), Fp(0))]
    us += [Fp2(Fp(a), Fp(b)) for a, b in zip(_rand_ints(6), _rand_ints(6))]
    return us


def _flips(u: Fp2) -> bool:
    """Whether the oracle's SSWU negates its square root for u."""
    zu2 = ref_h2c.SSWU_Z * u.square()
    tv1 = zu2.square() + zu2
    a, b = ref_h2c.ISO_A, ref_h2c.ISO_B
    x1 = b * (ref_h2c.SSWU_Z * a).inv() if tv1.is_zero() else (-b) * a.inv() * (Fp2.one() + tv1.inv())
    y = (x1.square() * x1 + a * x1 + b).sqrt()
    if y is None:
        x2 = zu2 * x1
        y = (x2.square() * x2 + a * x2 + b).sqrt()
    return u.sgn0() != y.sgn0()


SSWU_U = _sswu_inputs()
SSWU_IN = _fp2_limbs([_mont(u) for u in SSWU_U])


@pytest.fixture(scope="module")
def sswu_out():
    return th2c.sswu_plain(to_port(SSWU_IN))


def test_sswu_plain_matches_ref(sswu_out):
    """The oracle's (x, y) for every u; the composition over the kernels'
    wrappers (their plain versions on CPU tensors) and the public wrapper
    agree bit for bit."""
    flips = [_flips(u) for u in SSWU_U]
    assert any(flips) and not all(flips)
    x, y = sswu_out
    for i, u in enumerate(SSWU_U):
        got = tuple(jpack.unpack_fp2_el(tfp.to_jax_limbs(c[i])) for c in (x, y))
        assert got == ref_h2c.sswu(u), f"u = {u}"
    for other in (th2c.sswu(to_port(SSWU_IN)), th2c.sswu_composed(to_port(SSWU_IN), tt.KERNEL_TOWER)):
        assert torch.equal(other[0], x) and torch.equal(other[1], y)


def test_iso3_map_plain_bit_identical_to_jax(sswu_out):
    """On SSWU's points and on the kernel point X0 (to (0 : 1 : 0))."""
    x = torch.cat([sswu_out[0], to_port(jpack.pack_fp2_el(ref_h2c._ISO_X0))[None]])
    y = torch.cat([sswu_out[1], sswu_out[1][:1]])
    got = th2c.iso3_map_plain(x, y)
    want = jax.jit(jh2c.iso3_map)(jnp.asarray(tfp.to_jax_limbs(x)), jnp.asarray(tfp.to_jax_limbs(y)))
    for g, w in zip(got, want):
        assert_same(g, w)
    assert _fp2_vals(got.z)[-1] == (0, 0) and _fp2_vals(got.y)[-1] == (R_MONT, 0)


def _pairs():
    """Four Miller pairs: a real one, P at infinity, Q at infinity, both."""
    a, b = (int(v) for v in rng.integers(1, 1 << 62, size=2))
    ps = [g1_generator().mul(a), g1_infinity(), g1_generator().mul(b), g1_infinity()]
    qs = [g2_generator().mul(b), g2_generator().mul(a), g2_infinity(), g2_infinity()]
    px, py, pi = jpack.pack_g1_batch(ps)
    qx, qy, qi = jpack.pack_g2_batch(qs)
    return to_port(px), to_port(py), torch.from_numpy(pi), to_port(qx), to_port(qy), torch.from_numpy(qi)


PAIRS = _pairs()


@pytest.fixture(scope="module")
def miller_out():
    return tpair.miller_loop(*PAIRS)


def test_miller_loop_matches_composition_with_infinity_lanes(miller_out):
    """On CPU tensors the wrapper takes the plain version; it equals the
    composition over the kernels' wrappers, and every infinity lane is one."""
    assert torch.equal(miller_out, tpair.miller_loop_composed(*PAIRS, tt.KERNEL_TOWER))
    one = tt.fp12_one((), "cpu")
    assert [torch.equal(miller_out[i], one) for i in range(4)] == [False, True, True, True]


# -- 2. the kernels' threads in Python integers -------------------------------------


def _add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def _mm(a, b):
    """fp384.cuh `fp_mul` (CIOS): canonical in and out."""
    assert 0 <= a < P and 0 <= b < P
    return a * b * R_INV % P


def _mul(a, b):
    """Both components of an Fp2 product: g2.cuh `fp2_mul` / `fp2_mul_part`."""
    return k7_thread(a, b, 0, tt.FP2_MUL), k7_thread(a, b, 1, tt.FP2_MUL)


def _scale(a, x):
    return _mm(a[0], x), _mm(a[1], x)


def _xi_neg(z):
    """xi (-z), as K12's a0_part."""
    n0, n1 = (-z[0]) % P, (-z[1]) % P
    return (n0 - n1) % P, (n0 + n1) % P


def _f_lanes(f, a, b, mode):
    """Warp 0's Fp12 product: f[a] holds the operand, the lanes write f[1 - a]
    (ping-pong); lane 2k + c forms component c of e_k (tower.cuh
    `fp12_mul_lane`). Returns the buffer now holding f."""
    assert f[a] is not None
    f[1 - a] = [tuple(fp12_lane(f[a], b, k, c, mode) for c in (0, 1)) for k in range(6)]
    return 1 - a


def line_warp(px, py, qx, qy):
    """K12's warp 1 (`tangent_step`, `chord_step`): the T chain, yielding
    per iteration (MSB first, the 63 bits of |z| below the leading one) its
    tangent line (A0, A3, A5) and, on a set bit, its chord line, else None."""
    X, Y, Z = qx, qy, (R_MONT, 0)
    for s in range(62, -1, -1):
        A, B, ZZ, YZ = _mul(X, X), _mul(Y, Y), _mul(Z, Z), _mul(Y, Z)
        z3 = _add(YZ, YZ)
        E, XB = _add(_add(A, A), A), _add(X, B)
        C, XB2, F6, EX, EZZ, M1 = _mul(B, B), _mul(XB, XB), _mul(E, E), _mul(E, X), _mul(E, ZZ), _mul(z3, ZZ)
        D = _sub(XB2, _add(A, C))
        D = _add(D, D)
        x3 = _sub(F6, _add(D, D))
        DX = _sub(D, x3)
        a3 = _sub(_add(B, B), EX)
        a5, zy = _scale(EZZ, px), _scale(M1, py)
        c8 = _add(C, C)
        c8 = _add(c8, c8)
        c8 = _add(c8, c8)
        X, Y, Z = x3, _sub(_mul(E, DX), c8), z3
        tangent, chord = [_xi_neg(zy), a3, a5], None
        if (ABS_Z >> s) & 1:
            ZZ = _mul(Z, Z)
            H, M1 = _sub(_mul(qx, ZZ), X), _mul(Z, ZZ)
            D = _sub(_mul(qy, M1), Y)
            HH, DD, HZ = _mul(H, H), _mul(D, D), _mul(H, Z)
            HHH, V = _mul(H, HH), _mul(X, HH)
            hy, a5 = _scale(HZ, py), _scale(D, px)
            x3 = _sub(_sub(DD, HHH), _add(V, V))
            DX = _sub(V, x3)
            R0, R1, R2, R3 = _mul(D, DX), _mul(Y, HHH), _mul(qy, HZ), _mul(D, qx)
            X, Y, Z = x3, _sub(R0, R1), HZ
            chord = [_xi_neg(hy), _sub(R2, R3), a5]
        yield tangent, chord


def miller_block(px, py, pinf, qx, qy, qinf):
    """One block of K12 (csrc/pairing_kernels.cu): stored ints in, flat
    Fp12 out. The loop's phases i = -1 .. 62 each end in __syncthreads; in
    phase i warp 1 forms iteration i + 1's lines into ring slot
    (i + 1) & 1 and warp 0 multiplies iteration i's, from slot i & 1, into
    f: f = f^2, f *= tangent, and on a set bit f *= chord. Asserted: warp 0
    reads a slot only in a phase after the one that wrote it for that
    iteration, and warp 1 writes a slot only in a phase after the one that
    read it."""
    if pinf or qinf:
        gens = tpair._ML_GENERATORS
        px, py = (tfp.words_to_int(gens[i]) for i in (0, 1))
        qx, qy = ((tfp.words_to_int(gens[i]), tfp.words_to_int(gens[i + 1])) for i in (2, 4))
    lines = line_warp(px, py, qx, qy)
    ring = [None, None]  # slot -> {"it", "lines", "written", "read"}
    f, cur = [[(R_MONT, 0)] + [(0, 0)] * 5, None], 0
    for i in range(-1, 63):
        if i >= 0:  # warp 0
            slot = ring[i & 1]
            assert slot["it"] == i and slot["written"] < i and slot["read"] is None, (i, slot)
            slot["read"] = i
            tangent, chord = slot["lines"]
            cur = _f_lanes(f, cur, f[cur], tt.FP12_SQUARE)
            cur = _f_lanes(f, cur, tangent, tt.FP12_SPARSE)
            assert (chord is not None) == bool((ABS_Z >> (62 - i)) & 1)
            if chord is not None:
                cur = _f_lanes(f, cur, chord, tt.FP12_SPARSE)
        if i + 1 < 63:  # warp 1
            old = ring[(i + 1) & 1]
            assert old is None or (old["read"] is not None and old["read"] < i), (i, old)
            ring[(i + 1) & 1] = {"it": i + 1, "lines": next(lines), "written": i, "read": None}
    assert next(lines, None) is None and all(slot["read"] is not None for slot in ring)
    g = f[cur]
    g = [g[k] if k % 2 == 0 else _neg(g[k]) for k in range(6)]  # conjugate: the w^1 half (odd flat k)
    return [(R_MONT, 0)] + [(0, 0)] * 5 if pinf or qinf else g


def _tower_flat(x):
    return [tuple(tfp.words_to_int(w) for w in c) for c in tt._to_flat(x)]


def _pair_ints(args, i):
    px, py, pi, qx, qy, qi = args
    return (tfp.words_to_int(px[i]), tfp.words_to_int(py[i]), bool(pi[i]),
            tuple(tfp.words_to_int(w) for w in qx[i]), tuple(tfp.words_to_int(w) for w in qy[i]), bool(qi[i]))


def test_miller_block_matches_plain(miller_out):
    """K12's block on the real pair and on the P-at-infinity lane (the
    generators substituted), word for word."""
    for i in (0, 1):
        assert miller_block(*_pair_ints(PAIRS, i)) == _tower_flat(miller_out[i]), f"lane {i}"


def test_miller_block_all_p_minus_1_stays_under_the_bound():
    """Every coordinate p - 1: each lazy sum of the 68 steps stays below its
    bound (asserted inside the model), and the block equals the plain
    version on the same words."""
    p1 = torch.from_numpy(tfp.int_to_words(P - 1))
    args = (p1[None], p1[None], torch.tensor([False]), p1.expand(1, 2, 12), p1.expand(1, 2, 12),
            torch.tensor([False]))
    want = tpair.miller_loop_plain(*args)
    assert miller_block(*_pair_ints(args, 0)) == _tower_flat(want[0])


def _fermat_inv(a):
    """fp384.cuh `fp_inv` on a stored value: 0 -> 0."""
    return pow(a * R_INV % P, P - 2, P) * R_MONT % P


def _inv2(a):
    """g2.cuh `fp2_inv`: the norm one lazy sum of two squares, reduced once."""
    n = _fermat_inv(redc_wide(a[0] * a[0] + a[1] * a[1], 2, 1))
    return _mm(a[0], n), (-_mm(a[1], n)) % P


def _sqrt_chain():
    """h2c_kernels.cu `kSqrtChain`, read from the source: per power (p >> 2,
    then p >> 1) its entries (squares, d)."""
    src = (pathlib.Path(tfp.__file__).parent / "csrc" / "h2c_kernels.cu").read_text()
    entries = int(re.search(r"constexpr int kChainEntries = (\d+);", src).group(1))
    body = re.search(r"kSqrtChain\[2\]\[kChainEntries\]\[2\] = \{(.*?)\n\};", src, re.S).group(1)
    body = "\n".join(line for line in body.splitlines() if not line.strip().startswith("//"))
    pairs = [(int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}", body)]
    assert len(pairs) == 2 * entries
    return pairs[:entries], pairs[entries:]


def sliding_window_chain(e, width=5):
    """The sliding-window schedule of x^e, MSB first: windows of at most
    `width` bits that start and end on a one bit; per window the squares
    before its product by x^d (the first window's 0: the chain starts at
    x^d), then the trailing squares with d = 0."""
    bits = bin(e)[2:]
    out, pending, i = [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            pending, i = pending + 1, i + 1
            continue
        j = min(i + width, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        out.append((pending + j - i if out else 0, int(bits[i:j], 2)))
        pending, i = 0, j
    return out + [(pending, 0)]


SQRT_CHAIN = _sqrt_chain()


def _fold(chain):
    """The exponent that a chain computes."""
    e = chain[0][1]
    for squares, d in chain[1:]:
        e = (e << squares) + d
    return e


def _pow_pair(x, which):
    """K13's fp2_pow_chain on chain `which` (0: p >> 2, 1: p >> 1): the two
    threads of a pair form one component each of every square and product
    (K7's split), then exchange; the table of odd powers x .. x^31 first
    (x^2, then 15 products by it)."""
    x2 = tuple(k7_thread(x, None, c, tt.FP2_SQR) for c in (0, 1))
    tab = [x]
    for _ in range(15):
        tab.append(tuple(k7_thread(tab[-1], x2, c, tt.FP2_MUL) for c in (0, 1)))
    chain = SQRT_CHAIN[which]
    acc = tab[chain[0][1] >> 1]
    for squares, d in chain[1:]:
        for _ in range(squares):
            acc = tuple(k7_thread(acc, None, c, tt.FP2_SQR) for c in (0, 1))
        if d:
            acc = tuple(k7_thread(acc, tab[d >> 1], c, tt.FP2_MUL) for c in (0, 1))
    return acc


@pytest.mark.parametrize("which,shift", [(0, 2), (1, 1)], ids=["p_shr_2", "p_shr_1"])
def test_sqrt_chain_folds_back_to_its_exponent(which, shift):
    """K13's windowed chain, read from h2c_kernels.cu, folds back into
    p >> 2 (= (p - 3) / 4) and p >> 1 (= (p - 1) / 2) exactly; it is the
    5-bit sliding window generated from p (odd digits below 32, 67
    windows, trailing squares last); and it is shorter than binary square
    and multiply (457 and 458 steps, the table's 16 included, against 605
    and 607)."""
    chain = SQRT_CHAIN[which]
    e = P >> shift
    assert _fold(chain) == e == ((P - 3) // 4 if shift == 2 else (P - 1) // 2)
    assert chain == sliding_window_chain(e)
    assert all(d % 2 == 1 and d < 32 for _, d in chain[:-1]) and chain[-1][1] == 0
    steps = 16 + sum(s for s, _ in chain) + sum(1 for _, d in chain[1:] if d)
    binary = e.bit_length() - 1 + bin(e).count("1") - 1
    assert (steps, binary) == ((457, 605) if shift == 2 else (458, 607))


def test_pow_pair_follows_the_chain():
    """The pair's windowed power equals x^e (the integer, in Montgomery
    form) on 0, one, -1, (p - 1, p - 1) and seeded elements."""
    for x in SQRT_X:
        for which, shift in ((0, 2), (1, 1)):
            v = _pow_pair(x, which)
            want = Fp2.from_ints(x[0] * R_INV % P, x[1] * R_INV % P).pow(P >> shift)
            assert v == _mont(want)


def _sqrt_candidate(x):
    """K13's (and K32's) `sqrt_candidate` on a thread pair."""
    a1 = _pow_pair(x, 0)
    x0 = _mul(a1, x)
    alpha = _mul(a1, x0)
    cand = _mul(_pow_pair(_add(alpha, (R_MONT, 0)), 1), x0)
    return ((-x0[1]) % P, x0[0]) if alpha == (P - R_MONT, 0) else cand


def _sgn0(a):
    s0, s1 = _mm(a[0], 1) & 1, _mm(a[1], 1) & 1
    return s0 | (a[0] == 0 and s1)


def _const(i):
    return tuple(tfp.words_to_int(w) for w in th2c._H2C_CONSTS[i])


def sswu_element(u):
    """K13's four threads of one element: the shared prologue, candidate j
    on the pair j, the exchange and the selects."""
    A, B, Zc, C1, C2 = (_const(i) for i in range(5))
    zu2 = _mul(Zc, _mul(u, u))
    t1 = _add(_mul(zu2, zu2), zu2)
    x1 = C2 if t1 == (0, 0) else _mul(C1, _add(_inv2(t1), (R_MONT, 0)))
    x2 = _mul(zu2, x1)
    gx = [_add(_add(_mul(_mul(x, x), x), _mul(A, x)), B) for x in (x1, x2)]
    y1, y2 = (_sqrt_candidate(g) for g in gx)
    x, y = (x1, y1) if _mul(y1, y1) == gx[0] else (x2, y2)
    return x, _neg(y) if _sgn0(u) != _sgn0(y) else y


def test_sswu_and_iso3_threads_match_plain(sswu_out):
    """K13 on every input u and on u = (p - 1, p - 1); K14's lane groups
    (test_torch_iso3_psi_lanes `iso3_grid`) on SSWU's points, the kernel
    point and (p - 1, p - 1) coordinates in one launch: the bounds asserted
    in every lazy sum, the words equal to the plain versions."""
    p1 = torch.from_numpy(tfp.int_to_words(P - 1)).expand(1, 2, 12)
    edge = th2c.sswu_plain(p1)
    for i, u in enumerate(_fp2_vals(to_port(SSWU_IN)) + [(P - 1, P - 1)]):
        want = (sswu_out[0][i], sswu_out[1][i]) if i < len(SSWU_U) else (edge[0][0], edge[1][0])
        assert sswu_element(u) == tuple(_fp2_vals(c)[0] for c in want), f"u {i}"
    x = torch.cat([sswu_out[0][:3], to_port(jpack.pack_fp2_el(ref_h2c._ISO_X0))[None], p1])
    y = torch.cat([sswu_out[1][:3], sswu_out[1][:1], p1])
    want = th2c.iso3_map_plain(x, y)
    assert iso3_grid(_fp2_vals(x), _fp2_vals(y)) == [_fp2_vals(c) for c in want]


def test_h2c_constants_are_the_oracles():
    """K13's and K14's constant operand holds what the plain versions use,
    and K14's folded T/9, U/9, T/27 and 2U/27 (-T (-1/27), -2U (-1/27))."""
    T, U, inv9, inv27 = ref_h2c._ISO_T, ref_h2c._ISO_U, ref_h2c._INV9, ref_h2c._INV27
    rows = [ref_h2c.ISO_A, ref_h2c.ISO_B, ref_h2c.SSWU_Z, -(ref_h2c.ISO_B * ref_h2c.ISO_A.inv()),
            ref_h2c.ISO_B * (ref_h2c.SSWU_Z * ref_h2c.ISO_A).inv(), ref_h2c._ISO_X0, Fp2(inv9, Fp(0)),
            Fp2(inv27, Fp(0)), T.scale(inv9), U.scale(inv9), -T.scale(inv27), -(U + U).scale(inv27)]
    assert len(th2c._H2C_CONSTS) == len(rows)
    assert [_const(i) for i in range(len(rows))] == [_mont(r) for r in rows]



@pytest.mark.parametrize("e", [P - 2, (P - 3) // 4, (P - 1) // 2], ids=["inverse", "sqrt_e1", "sqrt_e2"])
def test_bound_counts_powers_on_the_plain_schedule(e):
    """chip_smoke.py's operations bound for K3, K13 and K32 counts each
    power on the cheaper of two schedules: the plain version's
    (`fp.pow_windowed`, its table's base^2 a square) and the 5-bit sliding
    window generated from the exponent (K13's chains: the odd powers up to
    the largest window's, a square per bit below the leading window, a
    product per window below it). For all three exponents the sliding
    window is the cheaper, and for p >> 2 and p >> 1 it is K13's
    `kSqrtChain`, square for square and product for product. The SSWU
    constants it counts as additions are small: Z = -(2 + u), A = 240 u."""
    import chip_smoke

    calls = {"mul": 0, "sqr": 0}

    def mul(a, b):
        calls["mul"] += 1
        return a * b % P

    def sqr(a):
        calls["sqr"] += 1
        return a * a % P

    assert tfp.pow_windowed(3, e, mul, sqr, 1) == pow(3, e, P)
    mul_wp, sqr_wp = chip_smoke.WORD_PRODUCTS_PER_MUL, chip_smoke.WORD_PRODUCTS_PER_SQR
    want = (calls["sqr"] + 1) * sqr_wp + (calls["mul"] - 1) * mul_wp
    assert chip_smoke.pow_word_products(e, mul_wp, sqr_wp) == want
    chain = sliding_window_chain(e)
    assert _fold(chain) == e
    squares = 1 + sum(s for s, _ in chain)
    products = (max(d for _, d in chain) >> 1) + sum(1 for _, d in chain[1:] if d)
    slide = squares * sqr_wp + products * mul_wp
    assert chip_smoke.sliding_window_word_products(e, mul_wp, sqr_wp) == slide < want
    assert chip_smoke.power_word_products(e, mul_wp, sqr_wp) == slide
    for which, shift in ((0, 2), (1, 1)):
        if e == P >> shift:
            kernel = SQRT_CHAIN[which]
            assert (squares, products) == (1 + sum(s for s, _ in kernel), 15 + sum(1 for _, d in kernel[1:] if d))
    assert ref_h2c.SSWU_Z == -Fp2(Fp(2), Fp(1)) and ref_h2c.ISO_A == Fp2(Fp(0), Fp(240))

# -- 3. the wrappers -----------------------------------------------------------------


@pytest.fixture
def recorded_launches(monkeypatch):
    """Operands dispatch as if they lay on a CUDA device; every launch is
    recorded as (launcher, args) and does nothing; the plain versions fail."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    for mod, name in ((tpair, "miller_loop_plain"), (th2c, "sswu_plain"), (th2c, "iso3_map_plain")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))
    return seen


def test_wrappers_launch_once_reading_operands_in_place(recorded_launches):
    """K12 with a broadcast G1 point (stride 0) and per-pair G2 points
    (stride 24 words); K13 on the stacked u0, u1 (2, 3, 2, 12); K14 with a
    broadcast y. One launch each, outputs of the right shapes."""
    words = torch.arange(5 * 24, dtype=torch.int32)
    px = words[:12]
    qx = words[:72].reshape(3, 2, 12)
    inf = torch.zeros(3, dtype=torch.bool)
    f = tpair.miller_loop(px, px, inf, qx, qx, inf)
    u = words[:72].reshape(1, 3, 2, 12).expand(2, 3, 2, 12)
    x, y = th2c.sswu(u)
    q = th2c.iso3_map(qx, qx[0])
    (n1, a1), (n2, a2), (n3, a3) = recorded_launches
    assert (n1, n2, n3) == ("lh_miller_loop", "lh_sswu", "lh_iso3_map")
    assert a1[:8] == (px.data_ptr(), 0, px.data_ptr(), 0, qx.data_ptr(), 24, qx.data_ptr(), 24)
    assert a1[-2:] == (f.data_ptr(), 3) and f.shape == (3, 2, 3, 2, 12)
    assert a1[10] == tfp.const(tpair._ML_GENERATORS, "cpu").data_ptr()
    assert a2[1] == 24 and a2[-1] == 6 and x.shape == y.shape == (2, 3, 2, 12)
    assert a2[0] != u.data_ptr()  # an expanded non-broadcast batch is copied once
    assert a3[:4] == (qx.data_ptr(), 24, qx.data_ptr(), 0) and a3[-1] == 3 and q.z.shape == (3, 2, 12)
    assert a3[-3] == a2[2] == tfp.const(th2c._H2C_CONSTS, "cpu").data_ptr()


def test_miller_loop_wrapper_checks_its_flags(recorded_launches):
    """The infinity flags reach the kernel as raw pointers: flags that are
    not bool, or lie on another device than the points, raise before any
    launch."""
    x = torch.zeros(2, 2, 12, dtype=torch.int32)
    inf = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(TypeError):
        tpair.miller_loop(x[:, 0], x[:, 0], inf.to(torch.int32), x, x, inf)
    with pytest.raises(RuntimeError, match="q_inf on meta"):
        tpair.miller_loop(x[:, 0], x[:, 0], inf, x, x, inf.to("meta"))
    assert recorded_launches == []


def test_wrappers_raise_on_a_failed_launch(monkeypatch):
    """On a CUDA tensor the wrappers launch or raise: a failed build or
    launch (here: no nvcc) is never replaced by the plain version."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    for mod, name in ((tpair, "miller_loop_plain"), (th2c, "sswu_plain"), (th2c, "iso3_map_plain")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))

    def failing(name, device, *args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tkernels, "launch", failing)
    tfp.reset_launches()
    x = torch.zeros(2, 2, 12, dtype=torch.int32)
    inf = torch.zeros(2, dtype=torch.bool)
    for call in (lambda: tpair.miller_loop(x[:, 0], x[:, 0], inf, x, x, inf), lambda: th2c.sswu(x),
                 lambda: th2c.iso3_map(x, x)):
        with pytest.raises(RuntimeError):
            call()
    assert tfp.LAUNCHES["miller_loop"] == tfp.LAUNCHES["sswu"] == tfp.LAUNCHES["iso3_map"] == 0
