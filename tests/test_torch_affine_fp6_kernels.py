"""K22 `g1_to_affine`, K23 `g2_to_affine`, K24 `fp6_mul` and K25 `fp2_inv`
(csrc/affine_kernels.cu) and the port's kernel registry
(torch_backend/registry.py), on the CPU. Every comparison is exact.

1. The kernels' plain versions (`curve.to_affine_plain` over FP_PLAIN /
   FP2_PLAIN, `tower.fp6_mul_plain`, `tower.fp2_inv_plain`) against the JAX
   package's jitted `curve.to_affine`, `tower.fp6_mul` and `tower.fp2_inv`
   on numpy-seeded batches of 9 with Z = 0, Z = one, p - 1 in every word
   slot and a zero Fp2 (inv0), and against the composition each replaced.
2. K24's six threads per element replayed in Python integers, with the
   lazy-reduction bound of each double-width sum asserted (T < N p^2 with
   N = 6, one conditional subtraction) on all-(p - 1) and random inputs;
   K23's and K25's norm, one lazy sum of two squares, likewise.
3. Dispatch: CPU tensors launch nothing; operands that dispatch as if on
   the card launch one kernel per call and nothing else, read in place;
   a failed launch raises and is never replaced by the plain version.
4. The registry: it covers every name of the JAX registry
   (`jax_backend/registry.kernel_names()`), every declared kernel is
   counted and bound, every entry's example builds here, one call of each
   entry dispatched as if on the card launches exactly what the entry
   declares, and the module imports no jax.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import curve as jc
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu.crypto.bls.jax_backend import registry as jreg
from lighthouse_tpu.crypto.bls.jax_backend import tower as jt
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import registry as treg
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from torch_parity import assert_same, to_port

rng = np.random.default_rng(0xA22)
N = 9


def _rand_ints(n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _limbs(vals, *shape):
    return jfp.ints_to_limbs(vals).reshape(*shape, jfp.N_LIMBS)


def _coords(elem):
    """Projective coordinates (N, *elem, 32) as JAX limbs: row 0 Z = 0
    (infinity), row 1 Z = one, row 2 p - 1 in every word slot of X, Y and
    Z, the rest random."""
    k = int(np.prod(elem, dtype=np.int64))
    xyz = [_limbs(_rand_ints(N * k), N, *elem) for _ in range(3)]
    z = xyz[2]
    z[0] = 0
    z[1] = 0
    z[1].reshape(-1, jfp.N_LIMBS)[0] = jfp.ONE_MONT
    for c in xyz:
        c[2] = jfp.int_to_limbs(P - 1)
    return xyz


def _fp2_batch():
    """(N, 2, 32): zero (inv0), one, (p - 1, p - 1), u, then random."""
    a = _limbs(_rand_ints(2 * N), N, 2)
    a[0] = 0
    a[1] = 0
    a[1, 0] = jfp.ONE_MONT
    a[2] = jfp.int_to_limbs(P - 1)
    a[3] = 0
    a[3, 1] = jfp.ONE_MONT
    return a


def _fp6_batch(p_minus_1_row):
    """(N, 3, 2, 32): a zero element, one all p - 1 (at row `p_minus_1_row`),
    the rest random."""
    a = _limbs(_rand_ints(6 * N), N, 3, 2)
    a[0] = 0
    a[p_minus_1_row] = jfp.int_to_limbs(P - 1)
    return a


# -- 1. the plain versions against the JAX functions --------------------------------

@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_plain_matches_jax(group):
    jF, elem, plain_F, comp_F = {"g1": (jc.FP, (), tc.FP_PLAIN, tc.FP),
                                 "g2": (jc.FP2, (2,), tc.FP2_PLAIN, tc.FP2)}[group]
    xyz = _coords(elem)
    want = jax.jit(lambda x, y, z: jc.to_affine(jF, jc.Proj(x, y, z)))(*(jnp.asarray(c) for c in xyz))
    p = tc.Proj(*(to_port(c) for c in xyz))
    got = tc.to_affine_plain(plain_F, p)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    assert got[2].tolist() == np.asarray(want[2]).tolist() == [True] + [False] * (N - 1)
    assert not got[0][0].any() and not got[1][0].any()  # infinity: zeroed coordinates (inv0)
    # the composition K22 / K23 replaced, and the wrapper on CPU tensors
    for other in (tc.to_affine_plain(comp_F, p), tc.to_affine(comp_F, p)):
        assert all(torch.equal(a, b) for a, b in zip(got, other))


def test_fp2_inv_plain_matches_jax():
    a = _fp2_batch()
    want = jax.jit(jt.fp2_inv)(jnp.asarray(a))
    got = tt.fp2_inv_plain(to_port(a))
    assert_same(got, want)
    assert not got[0].any()  # inv0
    assert torch.equal(got, tt.fp2_inv_composed(to_port(a), tfp.KERNEL_OPS))
    assert torch.equal(got, tt.fp2_inv(to_port(a)))


def test_fp6_mul_plain_matches_jax():
    a, b = _fp6_batch(2), _fp6_batch(3)
    want = jax.jit(jt.fp6_mul)(jnp.asarray(a), jnp.asarray(b))
    got = tt.fp6_mul_plain(to_port(a), to_port(b))
    assert_same(got, want)
    assert torch.equal(got, tt.fp6_mul_composed(to_port(a), to_port(b), tt.KERNEL_TOWER))
    # a broadcast operand: one element against the batch
    assert torch.equal(tt.fp6_mul_plain(to_port(a), to_port(b[4])),
                       tt.fp6_mul_plain(to_port(a), to_port(np.broadcast_to(b[4], b.shape).copy())))


# -- 2. the kernels' threads in Python integers -------------------------------------

MASK32 = (1 << 32) - 1
P_INV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)
WIDE = 1 << 768
R_INV = pow(1 << 384, -1, P)


def redc_wide(t: int, n_products: int) -> int:
    """fp_redc_wide<1> word for word for T a sum of n_products canonical
    products, with its header's bound checked (N <= 9, one subtraction)."""
    assert 0 <= t < n_products * P * P, "T is not below N p^2"
    assert n_products <= 9, "N is past what one subtraction covers"
    for i in range(12):
        m = ((t >> (32 * i)) & MASK32) * P_INV32 & MASK32
        t += (m * P) << (32 * i)
        assert t < WIDE, "the reduction carried out of 24 words"
    assert t & ((1 << 384) - 1) == 0
    u = t >> 384
    assert u < 2 * P, "more than one multiple of p left"
    return u - P if u >= P else u


def k24_thread(a, b, k: int, comp: int) -> int:
    """Component `comp` of coefficient c_k of a b, as thread 2k + comp of
    fp6_mul_kernel forms it: over j, i = (k - j) mod 3, xi a_i when j > k,
    each Fp2 term split as K7 splits a product."""
    t, n = 0, 0
    for j in range(3):
        x0, x1 = a[(k - j) % 3]
        if j > k:  # v^3 = xi = 1 + u
            x0, x1 = (x0 - x1) % P, (x0 + x1) % P
        y0, y1 = b[j]
        u = x1 if comp else (P - x1) % P
        v0, v1 = (y1, y0) if comp else (y0, y1)
        for x, y in ((x0, v0), (u, v1)):
            assert 0 <= x < P and 0 <= y < P, "an operand is not canonical"
            t += x * y
            n += 1
        assert t < n * P * P
    return redc_wide(t, n)


def _fp6_words(coeffs):
    return torch.from_numpy(tfp.ints_to_words([x for pair in coeffs for x in pair])).reshape(3, 2, tfp.WORDS)


ALL_P_MINUS_1 = [(P - 1, P - 1)] * 3


def _random_fp6():
    return [tuple(_rand_ints(2)) for _ in range(3)]


def test_k24_threads_match_plain_and_stay_under_the_bound():
    elements = [ALL_P_MINUS_1, _random_fp6(), _random_fp6(), [(0, 0), (tfp.R_MONT, 0), (P - 1, 0)]]
    for a in elements:
        for b in elements:
            got = [k24_thread(a, b, k, comp) for k in range(3) for comp in (0, 1)]
            want = tt.fp6_mul_plain(_fp6_words(a), _fp6_words(b))
            assert got == [tfp.words_to_int(w) for w in want.reshape(-1, tfp.WORDS)]


def test_k24_all_p_minus_1_sum_is_the_largest():
    """Every operand p - 1 (and the xi-folded 0 and p - 2): each of the six
    sums has N = 6 products below p^2, T < 6 p^2, and reduces into [0, 2p)."""
    for k in range(3):
        for comp in (0, 1):
            assert k24_thread(ALL_P_MINUS_1, ALL_P_MINUS_1, k, comp) < P
    assert 6 * P * P < WIDE >> 2  # headroom: T + m p stays in 24 words


def _fp2_inv_thread(a0: int, a1: int):
    """g2.cuh `fp2_inv` (K23's and K25's routine) on Montgomery values: the
    norm one lazy sum of N = 2 squares reduced once, its Fermat inverse,
    two Montgomery products, a negation."""
    n = redc_wide(a0 * a0 + a1 * a1, 2)
    inv = pow(n, P - 2, P) * pow(1 << 384, 2, P) % P  # Montgomery inverse: (n R^-1)^-1 R
    return a0 * inv * R_INV % P, (P - a1 * inv * R_INV % P) % P


def test_k25_routine_matches_plain_with_its_norm_under_the_bound():
    a = _fp2_batch()
    words = to_port(a)
    want = tt.fp2_inv_plain(words).reshape(-1, tfp.WORDS)
    for i in range(N):
        a0, a1 = (tfp.words_to_int(w) for w in words[i])
        assert _fp2_inv_thread(a0, a1) == (tfp.words_to_int(want[2 * i]), tfp.words_to_int(want[2 * i + 1]))
    assert _fp2_inv_thread(P - 1, P - 1)[0] < P


# -- 3. dispatch -------------------------------------------------------------------

def _inputs():
    xyz1 = tc.Proj(*(to_port(c) for c in _coords(())))
    xyz2 = tc.Proj(*(to_port(c) for c in _coords((2,))))
    return xyz1, xyz2, to_port(_fp6_batch(2)), to_port(_fp6_batch(3)), to_port(_fp2_batch())


def test_cpu_tensors_launch_nothing():
    p1, p2, a6, b6, a2 = _inputs()
    tfp.reset_launches()
    tc.to_affine(tc.FP, p1)
    tc.to_affine(tc.FP2, p2)
    tt.fp6_mul(a6, b6)
    tt.fp6_sqr(a6)
    tt.fp2_inv(a2)
    assert all(v == 0 for v in tfp.LAUNCHES.values()), tfp.LAUNCHES


PLAINS = ((tc, "to_affine_plain"), (tt, "fp6_mul_plain"), (tt, "fp2_inv_plain"))


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


def test_wrappers_are_one_launch_each_read_in_place(recorded_launches):
    """K22 and K23 read each coordinate in place (element stride 12 or 24
    words, 0 for one point broadcast), K24 its operands (72 words, 0 when
    broadcast) and K25 its operand (24 words); one launch per call, no
    other kernel counted."""
    p1, p2, a6, b6, a2 = _inputs()
    tfp.reset_launches()
    x, y, inf = tc.to_affine(tc.FP, p1)
    tc.to_affine(tc.FP2, tc.Proj(p2.x, p2.y, p2.z[0]))  # one Z broadcast over the batch
    out6 = tt.fp6_mul(a6, b6[4])
    out2 = tt.fp2_inv(a2)
    (n1, g1), (n2, g2), (n3, g3), (n4, g4) = recorded_launches
    assert (n1, n2, n3, n4) == ("lh_g1_to_affine", "lh_g2_to_affine", "lh_fp6_mul", "lh_fp2_inv")
    assert g1[:6] == (p1.x.data_ptr(), 12, p1.y.data_ptr(), 12, p1.z.data_ptr(), 12)
    assert g1[6:] == (x.data_ptr(), y.data_ptr(), inf.data_ptr(), N)
    assert (x.shape, y.shape, inf.shape, inf.dtype) == ((N, 12), (N, 12), (N,), torch.bool)
    assert g2[1::2][:3] == (24, 24, 0) and g2[4] == p2.z[0].data_ptr() and g2[-1] == N
    assert g3 == (a6.data_ptr(), 72, b6[4].data_ptr(), 0, out6.data_ptr(), N) and out6.shape == a6.shape
    assert g4 == (a2.data_ptr(), 24, out2.data_ptr(), N) and out2.shape == a2.shape
    assert {k: v for k, v in tfp.LAUNCHES.items() if v} == {"g1_to_affine": 1, "g2_to_affine": 1, "fp6_mul": 1,
                                                            "fp2_inv": 1}


def test_fp2_inv_over_other_fields_keeps_the_composition(recorded_launches):
    """Only the kernel field operations take K25: over the plain operations
    (the plain versions of K13, K14 and K19, FP2_PLAIN.inv) fp2_inv stays
    the composition, and launches nothing."""
    a2 = _inputs()[4]
    tt.fp2_inv(a2, tfp.PLAIN_OPS)
    tc.FP2_PLAIN.inv(a2)
    assert recorded_launches == []


def test_wrappers_raise_on_a_failed_launch(monkeypatch):
    """On a CUDA tensor the wrappers launch or raise: a failed build or
    launch (here: no nvcc) is never replaced by the plain version."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    for mod, name in PLAINS:
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("took the plain version"))

    def failing(name, device, *args):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tkernels, "launch", failing)
    p1, p2, a6, b6, a2 = _inputs()
    tfp.reset_launches()
    for call in (lambda: tc.to_affine(tc.FP, p1), lambda: tc.to_affine(tc.FP2, p2), lambda: tt.fp6_mul(a6, b6),
                 lambda: tt.fp2_inv(a2)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert all(v == 0 for v in tfp.LAUNCHES.values())


# -- 4. the registry ----------------------------------------------------------------

def test_registry_covers_every_jax_kernel():
    """The 38 names of the JAX registry, SSWU and the three launch entry
    points: 42 entries, each with a kind and its JAX definition."""
    jax_names = set(jreg.kernel_names())
    assert len(jax_names) == 38
    assert jax_names <= set(treg.names())
    extra = set(treg.names()) - jax_names
    assert extra == {"h2c.sswu", "launch api._verify_kernel", "launch api._pk_validate_kernel",
                     "launch parallel.build_sharded_verify"}
    assert all(e.kind in treg.KINDS and e.jax_def for e in treg.entries())


def test_registry_kernels_are_counted_and_bound():
    for e in treg.entries():
        for k in e.launches:
            assert k in tfp.KERNELS, (e.name, k)
            assert f"lh_{k}" in tkernels._SIGNATURES, (e.name, k)
        assert all(n > 0 for n in e.launches.values()), e.name
        if e.kind == "kernel":
            assert e.launches, e.name
    # every kernel of the library is launched by some entry
    assert set(tfp.KERNELS) == {k for e in treg.entries() for k in e.launches}


INSIDE_KERNELS = {"curve.add.g1": ("g1_add", "K26"), "curve.add.g2": ("g2_add", "K27"),
                  "tower.karabina_sqr": ("karabina_sqr", "K28"),
                  "tower.karabina_decompress": ("karabina_decompress", "K29"),
                  "tower.fp12_inv": ("fp12_inv", "K30"), "pairing.frobenius": ("frobenius", "K31"),
                  "h2c.fp2_sqrt_candidate": ("fp2_sqrt_candidate", "K32"), "fp.mont_reduce": ("fp_redc", "K33")}


def test_registry_says_which_bodies_run_inside_kernels():
    """The standalone functions whose bodies run inside the verify path's
    kernels are recorded so, each with its own standalone kernel (K26-K33),
    and K22-K25 as standalone kernels off the path; no entry is a
    composition, and only "path" entries lack a plain version."""
    assert set(treg.KINDS) == {"kernel", "path"}
    for name, (k, tag) in INSIDE_KERNELS.items():
        e = treg.entry(name)
        assert e.kind == "kernel" and e.launches == {k: 1} and e.plain is not None, name
        assert "inside K" in e.verify_path and e.verify_path.endswith(f"standalone {tag}"), e.verify_path
    for name, k in (("curve.to_affine.g1", "g1_to_affine"), ("curve.to_affine.g2", "g2_to_affine"),
                    ("tower.fp6_mul", "fp6_mul"), ("tower.fp2_inv", "fp2_inv")):
        assert treg.entry(name).launches == {k: 1} and treg.entry(name).kind == "kernel"
    for e in treg.entries():
        assert e.launches and (e.plain is None) == (e.kind == "path"), e.name


@pytest.mark.parametrize("name", treg.names())
def test_registry_example_runs_on_cpu(name):
    e = treg.entry(name)
    args = e.example(7)
    assert isinstance(args, tuple) and args
    assert all(a.device.type == "cpu" for a in args if isinstance(a, torch.Tensor))
    assert len(treg.to_device(args, "cpu")) == len(args)


@pytest.mark.parametrize("name", [e.name for e in treg.entries() if not e.needs_group])
def test_registry_launches_as_declared(name, monkeypatch):
    """One call of the entry's port function dispatched as if on the card
    (launches recorded, not run) counts exactly the entry's launches."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: None)
    e = treg.entry(name)
    args = e.example(3)
    tfp.reset_launches()
    e.fn(*args)
    assert {k: v for k, v in tfp.LAUNCHES.items() if v} == e.launches


def test_sharded_entry_declares_the_verify_with_k18_twice():
    e = treg.entry("launch parallel.build_sharded_verify")
    verify = treg.entry("launch api._verify_kernel")
    assert e.needs_group and e.launches == {**verify.launches, "product_reduce": 2}


def test_registry_imports_no_jax():
    code = ("import sys; from lighthouse_tpu_torch.crypto.bls.torch_backend import registry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lighthouse_tpu')]; "
            "assert not bad, bad; assert len(registry.entries()) == 42")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
