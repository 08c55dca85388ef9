"""K26-K33, the standalone launches of routines that run inside the verify
path's kernels (csrc/standalone_kernels.cu: K26 `g1_add`, K27 `g2_add`,
K28 `karabina_sqr`, K29 `karabina_decompress`, K33 `fp_redc`;
csrc/final_exponentiation_kernels.cu: K30 `fp12_inv`, K31 `frobenius`;
csrc/h2c_kernels.cu: K32 `fp2_sqrt_candidate`), on the CPU. Every
comparison is exact.

1. The kernels' plain versions (`curve.add_composed` over FP_PLAIN /
   FP2_PLAIN, `tower.karabina_sqr_plain`, `karabina_decompress_plain`,
   `fp12_inv_plain`, `pairing.frobenius_plain`,
   `h2c.fp2_sqrt_candidate_plain`, `fp.mont_reduce_plain`) against the JAX
   package's jitted functions on numpy-seeded batches with edge rows
   (infinity, P == Q, P == -Q, zero, one, p - 1 in every word slot,
   decompression's g2 = 0 branch and a zero denominator, -1 for the
   square root, T = 0 and T = 2 p 2^384 - 1 for the reduction), and
   against the composition each replaced.
2. K28's and K29's formulas, and K33's word-serial reduction with its
   bound, replayed in Python integers.
3. Dispatch: CPU tensors launch nothing; operands that dispatch as if on
   the card launch one kernel per call and nothing else, read in place;
   the compositions that K9, K13, K15-K17 and K19 replaced still run over
   K1-K8 and launch none of K26-K33; a failed launch raises and is never
   replaced by the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import curve as jc
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu.crypto.bls.jax_backend import h2c as jh2c
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpairing
from lighthouse_tpu.crypto.bls.jax_backend import tower as jt
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpairing
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from torch_parity import assert_same, to_port

rng = np.random.default_rng(0xA26)
N = 9
R = 1 << 384
R_INV = pow(R, -1, P)


def _ints(words):
    """(n, 12) words -> n Python integers."""
    return [tfp.words_to_int(w) for w in words.reshape(-1, 12).numpy()]


def _rand_ints(n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _limbs(vals, *shape):
    return jfp.ints_to_limbs(vals).reshape(*shape, jfp.N_LIMBS)


def _elems(*shape):
    """(*shape, 32) JAX limbs of random canonical elements."""
    return _limbs(_rand_ints(int(np.prod(shape, dtype=np.int64))), *shape)


def _one(elem):
    """One (Montgomery) as JAX limbs of an Fp (elem ()) or Fp2 (elem (2,))."""
    o = np.zeros((*elem, jfp.N_LIMBS), np.int32)
    o.reshape(-1, jfp.N_LIMBS)[0] = jfp.ONE_MONT
    return o


# -- 1. the plain versions against the JAX functions --------------------------------


def _point_pairs(elem):
    """Two batches of N projective points (X, Y, Z each (N, *elem, 32)): row
    0 P at infinity (0 : 1 : 0), row 1 both at infinity, row 2 P == Q,
    row 3 P == -Q, row 4 p - 1 in every word slot of P, the rest random
    coordinates (the complete formulas are polynomials: any inputs)."""
    p = [_elems(N, *elem) for _ in range(3)]
    q = [_elems(N, *elem) for _ in range(3)]
    for pts in (p, q):
        pts[0][1] = 0
        pts[1][1] = _one(elem)
        pts[2][1] = 0
    p[0][0], p[1][0], p[2][0] = 0, _one(elem), 0
    for c in range(3):
        q[c][2] = p[c][2]
        q[c][3] = p[c][3]
        p[c][4] = jfp.int_to_limbs(P - 1)
    q[1][3] = np.asarray(jfp.neg(jnp.asarray(p[1][3])))
    return p, q


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_plain_matches_jax(group):
    jF, elem, plain_F, comp_F = {"g1": (jc.FP, (), tc.FP_PLAIN, tc.FP),
                                 "g2": (jc.FP2, (2,), tc.FP2_PLAIN, tc.FP2)}[group]
    p, q = _point_pairs(elem)
    want = jax.jit(lambda *c: jc.add(jF, jc.Proj(*c[:3]), jc.Proj(*c[3:])))(*(jnp.asarray(c) for c in p + q))
    tp, tq = tc.Proj(*(to_port(c) for c in p)), tc.Proj(*(to_port(c) for c in q))
    got = tc.add_composed(plain_F, tp, tq)
    for g, w in zip(got, want):
        assert_same(g, w)
    # the composition K26 / K27 replaced, and the wrapper on CPU tensors
    for other in (tc.add_composed(comp_F, tp, tq), tc.add(comp_F, tp, tq)):
        assert all(torch.equal(a, b) for a, b in zip(got, other))
    # a point broadcast over the batch
    one = tc.Proj(*(c[5] for c in tq))
    wide = tc.Proj(*(c[5:6].expand_as(c).clone() for c in tq))
    assert all(torch.equal(a, b) for a, b in zip(tc.add(comp_F, tp, one), tc.add_composed(plain_F, tp, wide)))


def _compressed():
    """(N, 4, 2, 32) compressed elements: row 0 all zero (the identity),
    row 1 g2 = 0 (decompression's other branch), row 2 g2 = g3 = 0 (a zero
    denominator: inv0), row 3 p - 1 in every word slot, the rest random."""
    c = _elems(N, 4, 2)
    c[0] = 0
    c[1, 0] = 0
    c[2, 0:2] = 0
    c[3] = jfp.int_to_limbs(P - 1)
    return c


@pytest.mark.parametrize("name", ["karabina_sqr", "karabina_decompress"])
def test_karabina_plain_matches_jax(name):
    c = _compressed()
    want = jax.jit(getattr(jt, name))(jnp.asarray(c))
    plain = getattr(tt, f"{name}_plain")
    got = plain(to_port(c))
    assert_same(got, want)
    assert torch.equal(got, getattr(tt, f"{name}_composed")(to_port(c), tt.KERNEL_TOWER))
    assert torch.equal(got, getattr(tt, name)(to_port(c)))
    if name == "karabina_decompress":
        assert torch.equal(got[0], tt.fp12_one((), "cpu"))  # the identity decompresses to one


def _fp12s():
    """(N, 2, 3, 2, 32): p - 1 in every word slot, zero (inv0), one, then
    random."""
    a = _elems(N, 2, 3, 2)
    a[0] = jfp.int_to_limbs(P - 1)
    a[1] = 0
    a[2] = 0
    a[2, 0, 0, 0] = jfp.ONE_MONT
    return a


@pytest.mark.parametrize("name", ["fp12_inv", "frobenius"])
def test_fp12_inv_and_frobenius_plain_match_jax(name):
    a = _fp12s()
    jfn, plain, composed, wrapper = {
        "fp12_inv": (jt.fp12_inv, tt.fp12_inv_plain, tt.fp12_inv_composed, tt.fp12_inv),
        "frobenius": (jpairing.frobenius, tpairing.frobenius_plain, tpairing.frobenius_composed,
                      tpairing.frobenius),
    }[name]
    want = jax.jit(jfn)(jnp.asarray(a))
    got = plain(to_port(a))
    assert_same(got, want)
    assert torch.equal(got, composed(to_port(a), tt.KERNEL_TOWER))
    assert torch.equal(got, wrapper(to_port(a)))
    if name == "fp12_inv":
        assert not got[1].any()  # inv0
        assert torch.equal(got[2], tt.fp12_one((), "cpu"))


def test_fp2_sqrt_candidate_plain_matches_jax():
    """0, one, u, -1 (alpha = -1: the u x0 branch), then random."""
    x = _elems(N, 2)
    x[0] = 0
    x[1] = _one((2,))
    x[2] = 0
    x[2, 1] = jfp.ONE_MONT
    x[3] = 0
    x[3, 0] = np.asarray(jfp.neg(jnp.asarray(jfp.ONE_MONT)))
    want = jax.jit(jh2c.fp2_sqrt_candidate)(jnp.asarray(x))
    got = th2c.fp2_sqrt_candidate_plain(to_port(x))
    assert_same(got, want)
    assert torch.equal(got, th2c.fp2_sqrt_candidate_composed(to_port(x), tt.KERNEL_TOWER))
    assert torch.equal(got, th2c.fp2_sqrt_candidate(to_port(x)))


TOP = 2 * P * R  # the reduction's domain: T < 2 p 2^384 (the JAX spec's mult = 2)
T_EDGES = [0, 1, TOP - 1, P * P - 1, P * R, R - 1, P * R - 1]


def _t_values():
    return T_EDGES + [int.from_bytes(rng.bytes(96), "little") % TOP for _ in range(N)]


def _t_words(vals):
    buf = b"".join(v.to_bytes(96, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(buf, dtype="<u4").view(np.int32).reshape(len(vals), 24).copy())


def _t_cols(vals):
    """JAX `redc` columns: T's 64 twelve-bit digits, the top one folded into
    column 62 (a column may hold more than 12 bits), (n, 63) int32."""
    cols = np.array([[(v >> (12 * i)) & 0xFFF for i in range(64)] for v in vals], dtype=np.int64)
    cols[:, 62] += cols[:, 63] << 12
    return cols[:, :63].astype(np.int32)


def test_mont_reduce_plain_matches_jax():
    """The port's reduction is T 2^-384 mod p, canonical, on the whole of
    the JAX spec's domain. The JAX `redc(cols, mult=2)` is bit-identical
    below p 2^384 (every lazy sum of N <= 9 products lies there); above
    about 1.5 p 2^384 it returns the residue plus p (congruent, not
    canonical: its `canonicalize(t, mult + 1)` leaves the quotient guard's
    extra p), so there the two agree mod p and the port's words are the
    canonical ones."""
    vals = _t_values()
    want = jax.jit(lambda c: jfp.redc(c, mult=2))(jnp.asarray(_t_cols(vals)))
    got = tfp.mont_reduce_plain(_t_words(vals))
    exact = [v * R_INV % P for v in vals]
    assert _ints(got) == exact
    jax_vals = [sum(int(x) << (12 * i) for i, x in enumerate(row)) for row in np.asarray(want)]
    assert [j % P for j in jax_vals] == exact
    low = [i for i, v in enumerate(vals) if v < P * R]
    assert len(low) >= 6
    assert_same(got[low], np.asarray(want)[low])
    assert all(j == e for j, e in zip(jax_vals, exact) if j < P)
    assert jax_vals[T_EDGES.index(TOP - 1)] == exact[T_EDGES.index(TOP - 1)] + P
    assert torch.equal(got, tfp.mont_reduce(_t_words(vals)))
    # a product of two elements: K1's reduction
    a, b = to_port(_elems(N)), to_port(_elems(N))
    prod = [x * y for x, y in zip(_ints(a), _ints(b))]
    assert torch.equal(tfp.mont_reduce_plain(_t_words(prod)), tfp.mul_plain(a, b))


# -- 2. the kernels in Python integers ----------------------------------------------

MASK32 = (1 << 32) - 1
P_INV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _redc_wide_model(t: int, subs: int) -> int:
    """fp384.cuh `fp_redc_wide<SUBS>` step by step: 12 steps of
    m = t_i (-p^-1) mod 2^32, t += m p 2^(32 i) over T's low 12 words (no m
    depends on the high ones), then T's high words added; then SUBS
    conditional subtractions. Asserts that after step i the value has no
    word past position i + 12 (the chains' reach) and that the reduced
    value is below 3p. The chains' own words: tests/test_torch_fp384_chains.py."""
    v = t & ((1 << 384) - 1)
    for i in range(12):
        m = ((v >> (32 * i)) & MASK32) * P_INV32 & MASK32
        v += (m * P) << (32 * i)
        assert v < 1 << (32 * (i + 13))
    assert v & ((1 << 384) - 1) == 0
    r = (v >> 384) + (t >> 384)
    assert r < 3 * P  # T / 2^384 + p for T < 2 p 2^384
    for _ in range(subs):
        r = r - P if r >= P else r
    return r


def test_fp_redc_model_meets_its_bound():
    """K33 is `fp_redc_wide<2>`: on the edges of its domain and random T,
    the word-serial rounds leave a value below 3p, two subtractions make
    it canonical, and the result is T 2^-384 mod p, the plain version's."""
    vals = _t_values()
    got = [_redc_wide_model(v, 2) for v in vals]
    assert got == [v * R_INV % P for v in vals]
    assert got == _ints(tfp.mont_reduce_plain(_t_words(vals)))
    # one subtraction is not enough at the top of the domain
    assert _redc_wide_model(TOP - 1, 1) >= P


def _std(words):
    """Standard values of Montgomery words, per element."""
    return [x * R_INV % P for x in _ints(words)]


def _fp2_vals(t):
    """(n, ..., 2, 12) words -> nested Python pairs of standard values."""
    flat = _std(t.reshape(-1, 12))
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


def _f2mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _f2add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2sc(k, a):
    return (k * a[0] % P, k * a[1] % P)


def _xi(a):
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def _mont_words(pairs, shape):
    return torch.from_numpy(tfp.ints_to_words([v * R % P for pr in pairs for v in pr])).reshape(shape)


def test_karabina_kernels_model_plain_versions():
    """K28's formulas (products by 6, 3 and 2 as additions) and K29's (each
    element's own inversion, g2 = 0 branch, a zero norm to zero) in Python
    integers, against the plain versions."""
    c = to_port(_compressed())
    g = _fp2_vals(c)
    sq, dec = [], []
    for e in range(N):
        g2, g3, g4, g5 = g[4 * e : 4 * e + 4]
        sq += [_f2add(_f2sc(2, g2), _f2sc(6, _xi(_f2mul(g4, g5)))),
               _f2add(_f2sc(3, _f2add(_f2mul(g4, g4), _xi(_f2mul(g5, g5)))), _f2sc(-2, g3)),
               _f2add(_f2sc(3, _f2add(_f2mul(g2, g2), _xi(_f2mul(g3, g3)))), _f2sc(-2, g4)),
               _f2add(_f2sc(2, g5), _f2sc(6, _f2mul(g2, g3)))]
        if g2 != (0, 0):
            num = _f2add(_f2add(_xi(_f2mul(g5, g5)), _f2sc(3, _f2mul(g4, g4))), _f2sc(-2, g3))
            den = _f2sc(4, g2)
        else:
            num, den = _f2sc(2, _f2mul(g4, g5)), g3
        ninv = pow((den[0] ** 2 + den[1] ** 2) % P, P - 2, P)  # 0 -> 0
        g1 = _f2mul(num, (den[0] * ninv % P, -den[1] * ninv % P))
        g0 = _xi(_f2add(_f2add(_f2sc(2, _f2mul(g1, g1)), _f2mul(g2, g5)), _f2sc(-3, _f2mul(g3, g4))))
        g0 = ((g0[0] + 1) % P, g0[1])
        # tower order (w, v): flat k = 2 v + w holds (g0, g2, g4, g1, g3, g5)
        flat = [g0, g2, g4, g1, g3, g5]
        dec += [flat[2 * v + w] for w in range(2) for v in range(3)]
    assert torch.equal(tt.karabina_sqr_plain(c), _mont_words(sq, c.shape))
    assert torch.equal(tt.karabina_decompress_plain(c), _mont_words(dec, (N, 2, 3, 2, 12)))


# -- 3. dispatch --------------------------------------------------------------------

def _inputs():
    p, q = _point_pairs(())
    p2, q2 = _point_pairs((2,))
    return {
        "g1": (tc.Proj(*(to_port(c) for c in p)), tc.Proj(*(to_port(c) for c in q))),
        "g2": (tc.Proj(*(to_port(c) for c in p2)), tc.Proj(*(to_port(c) for c in q2))),
        "c": to_port(_compressed()), "f": to_port(_fp12s()), "x": to_port(_elems(N, 2)),
        "t": _t_words(_t_values()[:N]),
    }


def _calls(d):
    """kernel -> one call of its wrapper on the inputs of `_inputs`."""
    return {
        "g1_add": lambda: tc.add(tc.FP, *d["g1"]),
        "g2_add": lambda: tc.add(tc.FP2, *d["g2"]),
        "karabina_sqr": lambda: tt.karabina_sqr(d["c"]),
        "karabina_decompress": lambda: tt.karabina_decompress(d["c"]),
        "fp12_inv": lambda: tt.fp12_inv(d["f"]),
        "frobenius": lambda: tpairing.frobenius(d["f"]),
        "fp2_sqrt_candidate": lambda: th2c.fp2_sqrt_candidate(d["x"]),
        "fp_redc": lambda: tfp.mont_reduce(d["t"]),
    }


KERNELS = ["g1_add", "g2_add", "karabina_sqr", "karabina_decompress", "fp12_inv", "frobenius",
           "fp2_sqrt_candidate", "fp_redc"]


def test_cpu_tensors_launch_nothing():
    d = _inputs()
    tfp.reset_launches()
    for call in _calls(d).values():
        call()
    assert all(v == 0 for v in tfp.LAUNCHES.values())


@pytest.fixture
def as_if_on_card(monkeypatch):
    """Operands dispatch as if on the card; launches are recorded, not run."""
    launches = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: launches.append((name, args)))
    tfp.reset_launches()
    return launches


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_is_one_launch_read_in_place(as_if_on_card, kernel):
    """Each wrapper issues exactly its own launcher once, counts it, and
    reads its operand in place (contiguous: the element's size in words)
    with the element count last."""
    d = _inputs()
    out = _calls(d)[kernel]()
    (name, args), = as_if_on_card
    assert name == f"lh_{kernel}"
    assert {k: v for k, v in tfp.LAUNCHES.items() if v} == {kernel: 1}
    assert args[-1] == N
    size = {"g1_add": 12, "g2_add": 24, "karabina_sqr": 96, "karabina_decompress": 96, "fp12_inv": 144,
            "frobenius": 144, "fp2_sqrt_candidate": 24, "fp_redc": 24}[kernel]
    first = {"g1_add": d["g1"][0].x, "g2_add": d["g2"][0].x, "karabina_sqr": d["c"],
             "karabina_decompress": d["c"], "fp12_inv": d["f"], "frobenius": d["f"],
             "fp2_sqrt_candidate": d["x"], "fp_redc": d["t"]}[kernel]
    assert args[:2] == (first.data_ptr(), size)
    shapes = {"g1_add": (N, 12), "g2_add": (N, 2, 12), "karabina_sqr": (N, 4, 2, 12),
              "karabina_decompress": (N, 2, 3, 2, 12), "fp12_inv": (N, 2, 3, 2, 12),
              "frobenius": (N, 2, 3, 2, 12), "fp2_sqrt_candidate": (N, 2, 12), "fp_redc": (N, 12)}
    outs = out if isinstance(out, tuple) else (out,)
    assert all(tuple(o.shape) == shapes[kernel] for o in outs)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_reads_a_broadcast_point_with_stride_0(as_if_on_card, group):
    p, q = _inputs()[group]
    one = tc.Proj(*(c[2] for c in q))
    tc.add(tc.FP if group == "g1" else tc.FP2, p, one)
    (_, args), = as_if_on_card
    size = 12 if group == "g1" else 24
    assert args[1::2][:6] == (size, size, size, 0, 0, 0)
    assert args[6:12:2] == (one.x.data_ptr(), one.y.data_ptr(), one.z.data_ptr())


def test_compositions_replaced_keep_their_launches(as_if_on_card):
    """The compositions K26-K32 replaced, and those of K9, K13, K15-K17 and
    K19 that run the same bodies, go on running over K1-K8 (and K25): none
    launches a kernel of K26-K33."""
    d = _inputs()
    new = set(KERNELS)
    calls = [
        lambda: tc.add_composed(tc.FP, *d["g1"]),
        lambda: tc.add_composed(tc.FP2, *d["g2"]),
        lambda: tt.karabina_sqr_composed(d["c"], tt.KERNEL_TOWER),
        lambda: tt.karabina_decompress_composed(d["c"], tt.KERNEL_TOWER),
        lambda: tt.fp12_inv_composed(d["f"], tt.KERNEL_TOWER),
        lambda: tpairing.frobenius_composed(d["f"], tt.KERNEL_TOWER),
        lambda: th2c.fp2_sqrt_candidate_composed(d["x"], tt.KERNEL_TOWER),
        lambda: tpairing.pow_abs_x_composed(d["f"][:1], tt.KERNEL_TOWER),
        lambda: tpairing.final_exponentiation_composed(d["f"][:1], tt.KERNEL_TOWER, tpairing.pow_abs_x),
        lambda: th2c.sswu_composed(d["x"][:2], tt.KERNEL_TOWER),
        lambda: tc.tree_sum_plain(tc.FP, d["g1"][0], 0),
        lambda: tc.scalar_mul_bits_plain(tc.FP2, d["g2"][0], torch.ones(N, 8, dtype=torch.int32)),
    ]
    for call in calls:
        as_if_on_card.clear()
        tfp.reset_launches()
        call()
        launched = {k for k, v in tfp.LAUNCHES.items() if v}
        assert launched and not launched & new, launched


def test_plain_fields_and_towers_take_the_composition(as_if_on_card):
    """Over the plain operations (the plain versions of K9, K13, K19, the
    plain fields of the group law) the wrappers compose PyTorch operations
    on any device and launch nothing."""
    d = _inputs()
    tc.add(tc.FP_PLAIN, *d["g1"])
    tc.add(tc.FP2_PLAIN, *d["g2"])
    tt.karabina_sqr(d["c"], tt.PLAIN_TOWER)
    tt.karabina_decompress(d["c"], tt.PLAIN_TOWER)
    tt.fp12_inv(d["f"], tt.PLAIN_TOWER)
    tpairing.frobenius(d["f"], tt.PLAIN_TOWER)
    th2c.fp2_sqrt_candidate(d["x"], tt.PLAIN_TOWER)
    assert not as_if_on_card and all(v == 0 for v in tfp.LAUNCHES.values())


def test_wrappers_raise_on_a_failed_launch(monkeypatch):
    """On a CUDA tensor the wrappers launch or raise: a failed build or
    launch (here: no nvcc) is never replaced by the plain version."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    for mod, name in ((tt, "karabina_sqr_plain"), (tt, "karabina_decompress_plain"), (tt, "fp12_inv_plain"),
                      (tpairing, "frobenius_plain"), (th2c, "fp2_sqrt_candidate_plain"),
                      (tfp, "mont_reduce_plain")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))

    def failing(name, device, *args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tkernels, "launch", failing)
    d = _inputs()
    tfp.reset_launches()
    for kernel, call in _calls(d).items():
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert all(v == 0 for v in tfp.LAUNCHES.values())


def test_mont_reduce_rejects_other_widths():
    with pytest.raises(TypeError):
        tfp.mont_reduce(torch.zeros(3, 12, dtype=torch.int32))
