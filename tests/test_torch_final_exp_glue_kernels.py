"""K19 `final_exponentiation` (csrc/final_exponentiation_kernels.cu), K20
`g2_psi_check` and K21 `miller_inputs` (csrc/verify_kernels.cu) on the CPU.

1. The plain versions against the JAX package and the oracle:
   `pairing.final_exponentiation_plain` bit-identical to the oracle's
   `final_exponentiation` on random Fp12 values, a Miller value, one and
   zero (the oracle with inv0, as the port's inversions: its own raises on
   zero), and to the composition K19 replaced; the standalone `frobenius`,
   `frobenius2` and `tower.fp12_inv` (over the kernels' wrappers and over
   the plain operations) bit-identical to the jitted JAX functions;
   `curve.g2_psi_check_plain` bit-identical to the jitted JAX `psi`,
   `neg`, `eq_points` and `is_infinity` on points in G2, points of E2
   outside G2 (isogeny outputs before the cofactor clearing), infinity
   and a [|z|] multiple of another point, its verdicts the oracle's
   membership; `api.miller_inputs_plain` bit-identical to a jitted replay
   of the JAX `verify_pipeline_local` lines it replaces (api.py:307-327),
   with infinity lanes among r_pk and H, its coordinates the oracle's
   affine ones. (The whole jitted JAX `final_exponentiation` compiles for
   minutes: tests/test_torch_pairing_h2c.py holds K19's plain version to
   it in the slow tier.)
2. A model in Python integers of each kernel: K19's block (K9's chains,
   K8's six-thread products, the twelve-thread Frobenius maps and
   conjugations, the norm chain of the inversion with its one-thread Fp2
   inversion), K20's lane groups (test_torch_iso3_psi_lanes) and K21's
   grid (a lane per denominator, each
   inverting its own, G1 and G2 lanes in separate warps; `kInputsThreads`
   read from verify_kernels.cu), every double-width sum
   checked against fp384.cuh's bound (test_torch_tower_kernels.redc_wide),
   on real inputs and on all-(p - 1) inputs, held to the plain versions
   bit for bit.
3. The wrappers: one launch per call with the operands read in place (K20
   on K11's output, by element stride), a raise on a failed launch and no
   fallback to the plain version on a CUDA tensor; a verify launches K19,
   K20 and K21 once each and K1-K4 and K7-K9 never.
"""

import pathlib
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P, R, X as X_PARAM
from lighthouse_tpu.crypto.bls.jax_backend import curve as jcurve
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpair
from lighthouse_tpu.crypto.bls.jax_backend import tower as jtower
from lighthouse_tpu.crypto.bls.ref import hash_to_curve as ref_h2c
from lighthouse_tpu.crypto.bls.ref import pairing as ref_pairing
from lighthouse_tpu.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref.fields import Fp, Fp2, Fp12
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from test_torch_curve_final_exp_kernels import _fp2_mul, _fp12, _mmul, _mont_inv, _tower_flat, cyclotomic_pow_x_block
from test_torch_iso3_psi_lanes import psi_grid
from test_torch_tower_kernels import k7_thread, k8_warp, redc_wide
from torch_parity import assert_same, base_sets, to_port

rng = np.random.default_rng(0x919)
ABS_Z = abs(X_PARAM)
R_MONT = (1 << 384) % P


def _rand():
    return int.from_bytes(rng.bytes(48), "little") % P


def _k():
    return int(rng.integers(1, 1 << 62))


# -- 1. the plain versions against the JAX package and the oracle ---------------------


def _miller_value():
    p, q = g1_generator().mul(_k()), g2_generator().mul(_k())
    return ref_pairing.miller_loop(p, q)


# random values, a Miller value, one and zero
FE_VALUES = [_fp12([_rand() for _ in range(12)]), _fp12([_rand() for _ in range(12)]), _miller_value(), Fp12.one(),
             Fp12.zero()]
FE_IN = np.stack([jpack.pack_fp12_el(x) for x in FE_VALUES])


@pytest.fixture(scope="module")
def fe_plain():
    return tpair.final_exponentiation_plain(to_port(FE_IN))


def _ref_final_exp_inv0(monkeypatch, f):
    """The oracle's final exponentiation, its Fp inversion mapping zero to
    zero (the port's fp.inv and fp2_inv, the JAX package's inv0)."""
    inv = Fp.inv
    monkeypatch.setattr(Fp, "inv", lambda self: Fp(0) if self.n == 0 else inv(self))
    return ref_pairing.final_exponentiation(f)


def test_final_exponentiation_plain_matches_ref(monkeypatch, fe_plain):
    for i, f in enumerate(FE_VALUES[:-1]):
        assert jpack.unpack_fp12_el(tfp.to_jax_limbs(fe_plain[i])) == ref_pairing.final_exponentiation(f), f"lane {i}"
    with pytest.raises(ZeroDivisionError):
        ref_pairing.final_exponentiation(Fp12.zero())
    want = _ref_final_exp_inv0(monkeypatch, Fp12.zero())
    assert want == Fp12.zero() and jpack.unpack_fp12_el(tfp.to_jax_limbs(fe_plain[-1])) == want


def test_final_exponentiation_plain_matches_the_composition_it_replaced(fe_plain):
    """On CPU tensors: the plain version, the wrapper and the composition
    over the kernels' wrappers (K9 for the chains) agree word for word, at
    a leading batch shape (5,) and (5, 1)."""
    x = to_port(FE_IN)
    assert torch.equal(tpair.final_exponentiation(x), fe_plain)
    assert torch.equal(tpair.final_exponentiation_composed(x, tt.KERNEL_TOWER, tpair.pow_abs_x), fe_plain)
    assert torch.equal(tpair.final_exponentiation(x[:, None])[:, 0], fe_plain)


@pytest.mark.parametrize("name", ["frobenius", "frobenius2", "fp12_inv"])
def test_frobenius_and_fp12_inv_bit_identical_to_jax(name):
    """The standalone forms (K2, K7, K8, K1, K3 on the card) and the forms
    over the plain operations that K19's plain version runs."""
    port, jfn = {
        "frobenius": (tpair.frobenius, jpair.frobenius),
        "frobenius2": (tpair.frobenius2, jpair.frobenius2),
        "fp12_inv": (tt.fp12_inv, jtower.fp12_inv),
    }[name]
    want = jax.jit(jfn)(jnp.asarray(FE_IN))
    x = to_port(FE_IN)
    assert_same(port(x), want)
    assert_same(port(x, tt.PLAIN_TOWER), want)


# -- K20: the psi comparison ----------------------------------------------------------


def _non_g2(n):
    """Points of E2 outside G2: the isogeny's images of SSWU's points,
    before the cofactor clearing."""
    out = []
    while len(out) < n:
        pt = ref_h2c.iso3_map(*ref_h2c.sswu(Fp2(Fp(_rand()), Fp(_rand()))))
        if not pt.inf and not pt.mul(R).inf:
            out.append(pt)
    return out


def _psi_inputs():
    """(sig, zsig) as oracle points, lane by lane: G2 points and points of
    E2 outside G2, each with zsig = [|z|] sig; infinity; a G2 point whose
    zsig is the [|z|] multiple of another G2 point."""
    g2 = [g2_generator().mul(_k()) for _ in range(3)]
    bad = _non_g2(2)
    sigs = g2 + bad + [g2_infinity(), g2[0]]
    zsigs = [s.mul(ABS_Z) for s in sigs[:-1]] + [g2[1].mul(ABS_Z)]
    return sigs, zsigs


PSI_SIGS, PSI_ZSIGS = _psi_inputs()
PSI_WANT = [True, True, True, False, False, True, False]


def _projective(pts, F=tc.FP2_PLAIN):
    """Oracle G2 points as port projective words with Z != 1 (each added to
    infinity by the complete formula)."""
    x, y, inf = jpack.pack_g2_batch(pts)
    p = tc.from_affine(F, to_port(x), to_port(y), torch.from_numpy(np.asarray(inf)))
    return tc.add(F, p, tc.infinity(F, inf.shape, "cpu"))


PSI_SIG, PSI_ZSIG = _projective(PSI_SIGS), _projective(PSI_ZSIGS)


def test_psi_inputs_are_what_they_claim():
    assert [s.inf or s.mul(R).inf for s in PSI_SIGS] == [True] * 3 + [False] * 2 + [True, True]
    assert not bool(tt.fp2_is_zero(PSI_SIG.z[0]).any()) and bool(tt.fp2_is_zero(PSI_SIG.z[5]))
    assert not torch.equal(PSI_SIG.z[0], tfp.const(tt._FP2_ONE, "cpu"))


def test_g2_psi_check_plain_bit_identical_to_jax():
    """The JAX `psi`, `neg`, `eq_points` and `is_infinity`, each jitted,
    against the plain version, the wrapper on CPU tensors and the
    composition K20 replaced; the verdicts are the oracle's membership
    where zsig = [|z|] sig, and False where it is another point's."""
    jsig, jzsig = (jcurve.Proj(*(jnp.asarray(tfp.to_jax_limbs(c)) for c in p)) for p in (PSI_SIG, PSI_ZSIG))
    rhs = jax.jit(lambda p: jcurve.neg(jcurve.FP2, p))(jzsig)
    eq = jax.jit(lambda p, q: jcurve.eq_points(jcurve.FP2, p, q))(jax.jit(jcurve.psi)(jsig), rhs)
    want = np.asarray(eq | jax.jit(lambda p: jcurve.is_infinity(jcurve.FP2, p))(jsig))
    assert want.tolist() == PSI_WANT
    for got in (tc.g2_psi_check_plain(PSI_SIG, PSI_ZSIG), tc.g2_psi_check(PSI_SIG, PSI_ZSIG),
                tc.g2_psi_check_composed(PSI_SIG, PSI_ZSIG, tc.FP2)):
        assert got.tolist() == PSI_WANT


def test_g2_in_subgroup_goes_through_the_psi_check():
    """`curve.g2_in_subgroup` (K11, then K20) against the oracle's
    membership."""
    assert tc.g2_in_subgroup(PSI_SIG).tolist() == [True] * 3 + [False] * 2 + [True, True]


# -- K21: the batch-affine Miller inputs ----------------------------------------------

S_MI = 4


def _mi_points():
    """r_pk (S G1), H (S G2) and sig_acc (G2) as oracle points, r_pk's lane 1
    and H's lane 2 at infinity."""
    r_pk = [g1_generator().mul(_k()) for _ in range(S_MI)]
    h = [g2_generator().mul(_k()) for _ in range(S_MI)]
    r_pk[1], h[2] = g1_infinity(), g2_infinity()
    return r_pk, h, g2_generator().mul(_k())


MI_R, MI_H, MI_ACC = _mi_points()


def _proj_g1(pts):
    x, y, inf = jpack.pack_g1_batch(pts)
    p = tc.from_affine(tc.FP_PLAIN, to_port(x), to_port(y), torch.from_numpy(np.asarray(inf)))
    return tc.add(tc.FP_PLAIN, p, tc.infinity(tc.FP_PLAIN, inf.shape, "cpu"))


MI_IN = (_proj_g1(MI_R), _projective(MI_H), tc.unstack(_projective([MI_ACC]), 0))


@pytest.fixture(scope="module")
def mi_plain():
    return tapi.miller_inputs_plain(*MI_IN)


@jax.jit
def _jax_miller_inputs(rx, ry, rz, hx, hy, hz, ax, ay, az):
    """jax_backend/api.py:307-327 as written, over the JAX package's fp and
    tower functions."""
    S = rz.shape[0]
    g2_z = jnp.concatenate([hz, az[None]], axis=0)
    z0, z1 = g2_z[..., 0, :], g2_z[..., 1, :]
    zsq = jfp.sqr(jnp.stack([z0, z1]))
    dens = jnp.concatenate([rz, jfp.add(zsq[0], zsq[1])], axis=0)
    inv_all = jfp.batch_inv(dens)
    g1_aff = jfp.mul(jnp.stack([rx, ry]), jnp.broadcast_to(inv_all[:S], (2, S, jfp.N_LIMBS)))
    pk_ainf = jcurve.is_infinity(jcurve.FP, jcurve.Proj(rx, ry, rz))
    nm = jfp.mul(jnp.stack([z0, z1]), jnp.broadcast_to(inv_all[S:], (2, S + 1, jfp.N_LIMBS)))
    zinv2 = jnp.stack([nm[0], jfp.neg(nm[1])], axis=-2)
    g2_aff = jtower.fp2_mul(
        jnp.stack([jnp.concatenate([hx, ax[None]], axis=0), jnp.concatenate([hy, ay[None]], axis=0)]),
        jnp.broadcast_to(zinv2, (2, S + 1, 2, jfp.N_LIMBS)),
    )
    px = jnp.concatenate([g1_aff[0], jnp.asarray(jpack.G1_GEN_X_L)[None]], axis=0)
    py = jnp.concatenate([g1_aff[1], jnp.asarray(jpack.G1_GEN_NEG_Y_L)[None]], axis=0)
    p_in = jnp.concatenate([pk_ainf, jnp.zeros(1, bool)])
    qx, qy = g2_aff[0], g2_aff[1]
    q_in = jcurve.is_infinity(jcurve.FP2, jcurve.Proj(qx, qy, g2_z))
    return px, py, p_in, qx, qy, q_in


def test_miller_inputs_plain_bit_identical_to_jax(mi_plain):
    """The jitted replay against the plain version, the wrapper on CPU
    tensors and the composition K21 replaced (K1, K2, K4, K7 on the card)."""
    args = [jnp.asarray(tfp.to_jax_limbs(c)) for p in MI_IN for c in p]
    want = _jax_miller_inputs(*args)
    for got in (mi_plain, tapi.miller_inputs(*MI_IN), tapi.miller_inputs_composed(*MI_IN, tt.KERNEL_TOWER)):
        for i in (0, 1, 3, 4):
            assert_same(got[i], want[i])
        for i in (2, 5):
            assert got[i].tolist() == np.asarray(want[i]).tolist()


def _fp2_int(w):
    return Fp2.from_ints(*(tfp.from_mont_host(c) for c in w))


def test_miller_inputs_plain_matches_ref(mi_plain):
    """Affine coordinates and flags against the oracle's points; infinity
    lanes zeroed; the last pair (-g1, sig_acc)."""
    px, py, p_in, qx, qy, q_in = mi_plain
    g1 = MI_R + [-g1_generator()]
    g2 = MI_H + [MI_ACC]
    assert p_in.tolist() == [p.inf for p in MI_R] + [False] and q_in.tolist() == [q.inf for q in g2]
    for i, pt in enumerate(g1):
        got = (tfp.from_mont_host(px[i]), tfp.from_mont_host(py[i]))
        assert got == ((0, 0) if pt.inf else (pt.x.n, pt.y.n)), f"G1 lane {i}"
    for i, pt in enumerate(g2):
        got = (_fp2_int(qx[i]), _fp2_int(qy[i]))
        assert got == ((Fp2.zero(), Fp2.zero()) if pt.inf else (pt.x, pt.y)), f"G2 lane {i}"


# -- 2. the kernels in Python integers ----------------------------------------------

GAMMAS = [tuple(tfp.words_to_int(w) for w in g) for g in tpair._FROB_GAMMAS]
PHI = [[tfp.words_to_int(w) for w in row] for row in tt._PHI_SCALARS]


def _neg(x):
    return (P - x) % P


def _conj(a):
    """Twelve threads: the odd flat coefficients (w = 1) negated."""
    return [c if k % 2 == 0 else (_neg(c[0]), _neg(c[1])) for k, c in enumerate(a)]


def _mul12(a, b):
    """K8's routine on the block's warp (csrc/tower.cuh `fp12_mul_pairs`)."""
    return k8_warp(a, b, tt.FP12_FULL)


def _frob(a):
    """Twelve threads: component c of conj(a_k) gamma_k (K7's split)."""
    return [tuple(k7_thread((a[k][0], _neg(a[k][1])), GAMMAS[k], c, tt.FP2_MUL) for c in (0, 1)) for k in range(6)]


def _fp2_inv(m):
    """g2.cuh `fp2_inv`, one thread: the norm one lazy sum of two squares,
    its inverse fp384.cuh's binary GCD (test_torch_inversion's replay)."""
    n = redc_wide(m[0] * m[0] + m[1] * m[1], 2, 1)
    inv = _mont_inv(n)
    return _mmul(m[0], inv), _neg(_mmul(m[1], inv))


def _inv12(a):
    """`fp12_inv_block`: N, phi(N) and phi^2(N) (24 threads of one Fp
    product), G, M, M^-1 on one thread, conj(a) G, then twelve threads of
    the product by M^-1."""
    c = _conj(a)
    n = _mul12(a, c)
    phi = [[tuple(_mmul(x, PHI[j][k]) for x in n[k]) for k in range(6)] for j in (0, 1)]
    g = _mul12(phi[0], phi[1])
    minv = _fp2_inv(_mul12(n, g)[0])
    cg = _mul12(c, g)
    return [tuple(k7_thread(cg[k], minv, comp, tt.FP2_MUL) for comp in (0, 1)) for k in range(6)]


def final_exponentiation_block(f):
    """One block of K19, step for step (csrc/final_exponentiation_kernels.cu),
    on a flat list of six Fp2 (c0, c1) Montgomery ints."""
    pow_x = cyclotomic_pow_x_block
    F = _mul12(_conj(f), _inv12(f))
    F = _mul12(_frob(_frob(F)), F)

    def h(g):  # g^(z - 1)
        return _conj(_mul12(pow_x(g), g))

    a = h(h(F))
    b = _mul12(_conj(pow_x(a)), _frob(a))
    c = _mul12(_mul12(pow_x(pow_x(b)), _frob(_frob(b))), _conj(b))
    return _mul12(c, _mul12(F, _mul12(F, F)))


def test_final_exponentiation_block_matches_plain(fe_plain):
    """On every lane of FE_IN (random, a Miller value, one, zero) and on an
    all-(p - 1) element."""
    x = to_port(FE_IN)
    for i in range(x.shape[0]):
        assert final_exponentiation_block(_tower_flat(x[i])) == _tower_flat(fe_plain[i]), f"lane {i}"
    edge = torch.from_numpy(tfp.int_to_words(P - 1)).expand(1, 2, 3, 2, tfp.WORDS)
    want = tpair.final_exponentiation_plain(edge)
    assert final_exponentiation_block(_tower_flat(edge[0])) == _tower_flat(want[0])


def _g2_ints(p, i):
    return tuple(tuple(tfp.words_to_int(w) for w in c[i]) for c in p)


def test_psi_check_thread_matches_plain():
    """K20's lane groups (test_torch_iso3_psi_lanes `psi_grid`) on every
    lane of the psi inputs in one launch, and on all-(p - 1) coordinates."""
    n = len(PSI_WANT)
    got = psi_grid([_g2_ints(PSI_SIG, i) for i in range(n)], [_g2_ints(PSI_ZSIG, i) for i in range(n)])
    assert got == tc.g2_psi_check_plain(PSI_SIG, PSI_ZSIG).tolist() == PSI_WANT
    w = torch.from_numpy(tfp.int_to_words(P - 1)).expand(1, 2, tfp.WORDS)
    edge = tc.Proj(w, w, w)
    want = tc.g2_psi_check_plain(edge, edge).tolist()
    assert psi_grid([_g2_ints(edge, 0)], [_g2_ints(edge, 0)]) == want


_VERIFY_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "verify_kernels.cu").read_text()
# K21's threads a block (one warp: a lane a thread)
K21_THREADS = int(re.search(r"constexpr int kInputsThreads = (\d+);", _VERIFY_SRC).group(1))


def miller_inputs_block(r_pk, h, acc, gen):
    """K21's grid (csrc/verify_kernels.cu `miller_inputs_kernel`): one-warp
    blocks, first the G1 blocks (a lane per set, at least one block; its
    first thread also writes lane S, the generator (x, -y)), then the G2
    blocks (a lane per hash and sig_acc last). Each lane inverts its own
    denominator (fp384.cuh `fp_inv`, 0 -> 0: an infinity lane's affine
    coordinates are zero): a G1 lane x / z, y / z; a G2 lane the norm z0^2
    + z1^2 (one lazy sum, one reduction), conj(z) / norm and two Fp2
    products. Asserts that no warp holds both kinds of lane and that
    every output is written once. Points are (x, y, z) ints, G2
    coordinates (c0, c1) pairs."""
    S = len(r_pk)
    g2 = h + [acc]
    g1_blocks = -(-S // K21_THREADS) if S else 1
    g2_blocks = -(-(S + 1) // K21_THREADS)
    out = {}

    def write(key, value):
        assert key not in out, f"{key} written twice"
        out[key] = value

    for b in range(g1_blocks + g2_blocks):
        kinds = set()
        for t in range(K21_THREADS):
            if b < g1_blocks:
                j = b * K21_THREADS + t
                if j == 0:
                    write(("p", S), (gen[0], gen[1], False))
                if j >= S:
                    continue
                kinds.add("g1")
                x, y, z = r_pk[j]
                inv = _mont_inv(z)
                write(("p", j), (_mmul(x, inv), _mmul(y, inv), z == 0))
            else:
                j = (b - g1_blocks) * K21_THREADS + t
                if j > S:
                    continue
                kinds.add("g2")
                x, y, z = g2[j]
                inv = _mont_inv(redc_wide(z[0] * z[0] + z[1] * z[1], 2, 1))
                zi = (_mmul(z[0], inv), _neg(_mmul(z[1], inv)))
                write(("q", j), (_fp2_mul(x, zi), _fp2_mul(y, zi), z == (0, 0)))
        assert len(kinds) <= 1, f"block {b} mixes G1 and G2 lanes"
    assert len(out) == 2 * (S + 1)
    p = [out[("p", j)] for j in range(S + 1)]
    q = [out[("q", j)] for j in range(S + 1)]
    return ([e[0] for e in p], [e[1] for e in p], [e[2] for e in p], [e[0] for e in q], [e[1] for e in q],
            [e[2] for e in q])


def _mi_block_run(r_pk, h, acc):
    S = r_pk.z.shape[0]
    gen = [tfp.words_to_int(w) for w in tfp.const(tapi._NEG_G1_GEN, "cpu")]
    g1 = [tuple(tfp.words_to_int(c[i]) for c in r_pk) for i in range(S)]
    g2 = [_g2_ints(h, i) for i in range(S)]
    return miller_inputs_block(g1, g2, _g2_ints(tc.Proj(*(c[None] for c in acc)), 0), gen)


def _mi_ints(out):
    px, py, p_in, qx, qy, q_in = out
    ints = lambda t: [tfp.words_to_int(w) for w in t]  # noqa: E731
    pairs = lambda t: [tuple(tfp.words_to_int(w) for w in e) for e in t]  # noqa: E731
    return ints(px), ints(py), p_in.tolist(), pairs(qx), pairs(qy), q_in.tolist()


def test_miller_inputs_block_matches_plain(mi_plain):
    """At S = 4 with infinity lanes, at S = 1, and on all-(p - 1)
    coordinates at S = 3 (no zero denominator)."""
    assert _mi_block_run(*MI_IN) == _mi_ints(mi_plain)
    one = (tc.Proj(*(c[:1] for c in MI_IN[0])), tc.Proj(*(c[:1] for c in MI_IN[1])), MI_IN[2])
    assert _mi_block_run(*one) == _mi_ints(tapi.miller_inputs_plain(*one))
    w = torch.from_numpy(tfp.int_to_words(P - 1))
    edge = (tc.Proj(*(w.expand(3, tfp.WORDS),) * 3), tc.Proj(*(w.expand(3, 2, tfp.WORDS),) * 3),
            tc.Proj(*(w.expand(2, tfp.WORDS),) * 3))
    assert _mi_block_run(*edge) == _mi_ints(tapi.miller_inputs_plain(*edge))


def _mi_operands(S):
    """r_pk, H and sig_acc of S sets from three seeded G1 and three G2
    points, with infinity lanes in both groups: G1 lanes 0 and S - 1, G2
    lanes S - 1 and 0 (a partly filled last warp at S = 33)."""
    rnd = random.Random(0x21 + S)
    g1 = [g1_generator().mul(rnd.getrandbits(62) | 1) for _ in range(3)]
    g2 = [g2_generator().mul(rnd.getrandbits(62) | 1) for _ in range(3)]
    r_pk = [g1[j % 3] for j in range(S)]
    h = [g2[(j + 1) % 3] for j in range(S)]
    r_pk[0] = r_pk[S - 1] = g1_infinity()
    h[0] = h[S - 1] = g2_infinity()
    return _proj_g1(r_pk), _projective(h), tc.unstack(_projective([g2[2]]), 0)


@pytest.mark.parametrize("S", [1, 4, 33])
def test_miller_inputs_block_matches_plain_at_counts(S):
    """K21's grid at S = 1, 4 and 33 (one G1 and one G2 warp; two G2 warps
    at 4 and 33, the last partly filled), infinity lanes in both groups,
    and on all-(p - 1) coordinates (no zero denominator), bit for bit
    against the plain version."""
    operands = _mi_operands(S)
    assert _mi_block_run(*operands) == _mi_ints(tapi.miller_inputs_plain(*operands))
    w = torch.from_numpy(tfp.int_to_words(P - 1))
    edge = (tc.Proj(*(w.expand(S, tfp.WORDS),) * 3), tc.Proj(*(w.expand(S, 2, tfp.WORDS),) * 3),
            tc.Proj(*(w.expand(2, tfp.WORDS),) * 3))
    assert _mi_block_run(*edge) == _mi_ints(tapi.miller_inputs_plain(*edge))


# -- 3. the wrappers ------------------------------------------------------------------

PLAINS = ((tpair, "final_exponentiation_plain"), (tc, "g2_psi_check_plain"), (tapi, "miller_inputs_plain"))


@pytest.fixture
def recorded_launches(monkeypatch):
    """Operands dispatch as if they lay on a CUDA device; every launch is
    recorded as (launcher, args) and does nothing; the plain versions fail."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    for mod, name in PLAINS:
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))
    return seen


def test_final_exponentiation_wrapper_is_one_launch(recorded_launches):
    """K19: a contiguous (2, 3) batch, element stride 144 words, and one
    element broadcast over 4 (stride 0); the constant operand
    `_FE_CONSTS`, 24 Fp rows."""
    f = torch.from_numpy(tfp.to_mont_host_bulk(range(1, 12 * 6 + 1))).reshape(2, 3, 2, 3, 2, 12)
    out = tpair.final_exponentiation(f)
    tpair.final_exponentiation(f[0, 0].expand(4, 2, 3, 2, 12))
    (n1, a1), (n2, a2) = recorded_launches
    assert n1 == n2 == "lh_final_exponentiation" and out.shape == f.shape
    consts = tfp.const(tpair._FE_CONSTS, "cpu")
    assert consts.shape == (24, 12) and a1 == (f.data_ptr(), 144, consts.data_ptr(), out.data_ptr(), 6)
    assert (a2[1], a2[-1]) == (0, 4)


def test_psi_check_reads_k11_output_in_place(recorded_launches):
    """K20 on the signatures and on the first half of K11's 2-stacked
    output (3, 2, S, 2, 12): each coordinate read in place with element
    stride 24 words; a point broadcast over the batch with stride 0."""
    S = 5
    sig = tc.Proj(*(torch.arange(S * 24, dtype=torch.int32).reshape(S, 2, 12) + k for k in range(3)))
    both = torch.zeros(3, 2, S, 2, 12, dtype=torch.int32)
    zsig = tc.unstack(tc.Proj(both[0], both[1], both[2]), 0)
    out = tc.g2_psi_check(sig, zsig)
    tc.g2_psi_check(tc.Proj(*(c[0].expand(S, 2, 12) for c in sig)), zsig)
    (n1, a1), (n2, a2) = recorded_launches
    assert n1 == n2 == "lh_g2_psi_check" and out.shape == (S,) and out.dtype == torch.bool
    assert a1[:6] == (sig.x.data_ptr(), 24, sig.y.data_ptr(), 24, sig.z.data_ptr(), 24)
    assert a1[6:12] == (both[0, 0].data_ptr(), 24, both[1, 0].data_ptr(), 24, both[2, 0].data_ptr(), 24)
    assert a1[12] == tfp.const(tc._PSI_C, "cpu").data_ptr() and a1[-2:] == (out.data_ptr(), S)
    assert a2[:6] == (sig.x.data_ptr(), 0, sig.y.data_ptr(), 0, sig.z.data_ptr(), 0)


def test_miller_inputs_reads_k10_k17_k16_outputs_in_place(recorded_launches):
    """K21 on K10's (3, S, 12), K17's (3, S, 2, 12) and K16's (3, 2, 12)
    outputs, read in place (strides 12 and 24 words); no scratch (each
    lane inverts its own denominator); one launch."""
    S = 6
    r = torch.zeros(3, S, 12, dtype=torch.int32)
    h = torch.zeros(3, S, 2, 12, dtype=torch.int32)
    acc = torch.zeros(3, 2, 12, dtype=torch.int32)
    px, py, p_in, qx, qy, q_in = tapi.miller_inputs(tc.Proj(*r), tc.Proj(*h), tc.Proj(*acc))
    (name, a), = recorded_launches
    assert name == "lh_miller_inputs" and a[-1] == S
    assert a[:6] == (r[0].data_ptr(), 12, r[1].data_ptr(), 12, r[2].data_ptr(), 12)
    assert a[6:12] == (h[0].data_ptr(), 24, h[1].data_ptr(), 24, h[2].data_ptr(), 24)
    assert a[12:16] == (acc[0].data_ptr(), acc[1].data_ptr(), acc[2].data_ptr(),
                        tfp.const(tapi._NEG_G1_GEN, "cpu").data_ptr())
    assert len(a) == 21 and a[16:20] == (px.data_ptr(), p_in.data_ptr(), qx.data_ptr(), q_in.data_ptr())
    assert py.data_ptr() == px.data_ptr() + (S + 1) * 48 and qy.data_ptr() == qx.data_ptr() + (S + 1) * 96
    assert (px.shape, qx.shape, p_in.shape, q_in.dtype) == ((S + 1, 12), (S + 1, 2, 12), (S + 1,), torch.bool)


def test_wrappers_raise_on_a_failed_launch(monkeypatch):
    """On a CUDA tensor the wrappers launch or raise: a failed build or
    launch (here: no nvcc) is never replaced by the plain version."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    for mod, name in PLAINS:
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))

    def failing(name, device, *args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tkernels, "launch", failing)
    tfp.reset_launches()
    g1 = tc.Proj(*(torch.zeros(3, 12, dtype=torch.int32) for _ in range(3)))
    g2 = tc.Proj(*(torch.zeros(3, 2, 12, dtype=torch.int32) for _ in range(3)))
    calls = (lambda: tpair.final_exponentiation(torch.zeros(1, 2, 3, 2, 12, dtype=torch.int32)),
             lambda: tc.g2_psi_check(g2, g2), lambda: tapi.miller_inputs(g1, g2, tc.unstack(g2, 0)))
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
    assert all(tfp.LAUNCHES[k] == 0 for k in ("final_exponentiation", "g2_psi_check", "miller_inputs"))


def test_verify_launches_the_glue_kernels_once(recorded_launches):
    """A verify (`api.verify_staged`, the device program of every entry
    point) dispatched as if on the card: one launch of each of K10-K21,
    none of K1-K4 and K7-K9, in the pipeline's order."""
    staged = tapi.stage_sets(list(base_sets(tapi)), rng=random.Random(3).getrandbits)
    S, K = staged[2].shape
    tapi.verify_staged(torch.from_numpy(tapi._pack_staged(staged)), S, K)
    names = [name[3:] for name, _ in recorded_launches]
    assert names == ["sswu", "iso3_map", "clear_cofactor", "g1_tree_sum", "g1_scalar_mul", "g2_scalar_mul",
                     "g2_psi_check", "g2_tree_sum", "miller_inputs", "miller_loop", "product_reduce",
                     "final_exponentiation"]
