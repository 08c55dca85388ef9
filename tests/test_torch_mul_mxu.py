"""The tensor-core Fp product of lighthouse_tpu_torch (`fp.mul_mxu`, K6's
plain version on the CPU) against the JAX package's jitted `fp.mul_mxu`,
the port's `mul_plain` and Python integers, and the verify path with
`fp.USE_MXU_MUL` set against the same path without it and the ref oracle.

Every comparison is exact: both products are canonical, so equal values
have equal words. K6 itself is held to this plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu.crypto.bls.ref.fields import Fp2, Fp6, Fp12
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from torch_parity import EDGES, assert_same, mont_limbs, rand_fp_ints, signature_sets, to_port

RINV = pow(1 << 384, -1, P)


def _ints(t):
    return [tfp.words_to_int(w) for w in t.reshape(-1, 12)]


def _words(xs):
    return torch.from_numpy(tfp.ints_to_words(xs))


def test_mul_mxu_matches_jitted_jax_mul_mxu():
    """The 8 edge pairs of the JAX package's own mul_mxu test (0, 1, 2,
    p-1, p-2 and randoms, in Montgomery form) and 64 seeded random pairs,
    in one batch."""
    rng = random.Random(0x3A)
    xs = [0, 1, 2, P - 1, P - 2, rng.randrange(P), rng.randrange(P), 0]
    ys = [P - 1, 0, 1, P - 2, 2, rng.randrange(P), 1, 0]
    xs += [rng.randrange(P) for _ in range(64)]
    ys += [rng.randrange(P) for _ in range(64)]
    a, b = mont_limbs(xs), mont_limbs(ys)
    want = jax.jit(jfp.mul_mxu)(jnp.asarray(a), jnp.asarray(b))
    got = tfp.mul_mxu(to_port(a), to_port(b))
    assert_same(got, want)
    assert [tfp.from_mont_host(w) for w in got] == [x * y % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("case", ["edges_squared", "edges_crossed", "random"])
def test_mul_mxu_plain_matches_mul_plain_and_integers(case):
    """On stored words, not only Montgomery forms: EDGES against themselves
    and crossed with each other, and 512 seeded random elements."""
    if case == "edges_squared":
        xs, ys = EDGES, EDGES
    elif case == "edges_crossed":
        xs = [x for x in EDGES for _ in EDGES]
        ys = [y for _ in EDGES for y in EDGES]
    else:
        xs, ys = rand_fp_ints(41, 512), rand_fp_ints(42, 512)[::-1]
    a, b = _words(xs), _words(ys)
    got = tfp.mul_mxu_plain(a, b)
    assert torch.equal(got, tfp.mul_plain(a, b))
    assert _ints(got) == [x * y * RINV % P for x, y in zip(xs, ys)]


def test_mul_plain_unchanged_by_shared_reduction():
    """`mul_plain` after its reduction moved into `_redc16`: canonical
    outputs, so equality with the integers is equality with the words it
    gave before; and the 47 digit columns it reduces and the 48 folded byte
    columns of `mul_mxu_plain` carry the same value and reduce alike."""
    xs, ys = rand_fp_ints(43, 64), rand_fp_ints(44, 64)[::-1]
    a, b = _words(xs), _words(ys)
    assert _ints(tfp.mul_plain(a, b)) == [x * y * RINV % P for x, y in zip(xs, ys)]
    t47 = tfp._conv(tfp._digits16(a), tfp._digits16(b), 47)
    c = tfp._byte_columns(a, b)
    t48 = c[..., 0::2] + (c[..., 1::2] << 8)
    weights = [1 << (16 * k) for k in range(48)]
    for r47, r48, x, y in zip(t47.tolist(), t48.tolist(), xs, ys):
        assert sum(v * w for v, w in zip(r47, weights)) == sum(v * w for v, w in zip(r48, weights)) == x * y
    assert torch.equal(tfp._redc16(t47), tfp._redc16(t48))


def test_byte_columns_are_the_schoolbook_columns():
    xs, ys = [P - 1, 1, 0] + rand_fp_ints(45, 5), [P - 1, P - 2, 7] + rand_fp_ints(46, 5)
    cols = tfp._byte_columns(_words(xs), _words(ys))
    assert cols.shape == (8, 96) and bool((cols[:, 95] == 0).all())
    assert int(cols.max()) <= 48 * 255 * 255
    for row, x, y in zip(cols.tolist(), xs, ys):
        xb, yb = x.to_bytes(48, "little"), y.to_bytes(48, "little")
        assert row[:95] == [sum(xb[i] * yb[k - i] for i in range(max(0, k - 47), min(47, k) + 1)) for k in range(95)]


def test_mul_mxu_broadcasts_like_mul():
    a = _words(rand_fp_ints(47, 6)).reshape(2, 3, 12)
    b = _words([5]).reshape(12)
    assert torch.equal(tfp.mul_mxu(a, b), tfp.mul(a, b))
    assert tfp.mul_mxu(a, b).shape == (2, 3, 12)


@pytest.fixture
def mxu_spy(monkeypatch):
    """USE_MXU_MUL set, and a count of the calls that reach mul_mxu_plain
    (CPU calls count no launch)."""
    calls = []
    plain = tfp.mul_mxu_plain

    def spy(a, b):
        calls.append(a.shape)
        return plain(a, b)

    monkeypatch.setattr(tfp, "mul_mxu_plain", spy)
    monkeypatch.setattr(tfp, "USE_MXU_MUL", True)
    return calls


def test_flag_routes_mul_and_sqr_through_mul_mxu(mxu_spy, monkeypatch):
    monkeypatch.setattr(tfp, "mul_plain", lambda a, b: pytest.fail("mul_plain reached with the flag set"))
    a = _words(rand_fp_ints(48, 4))
    tfp.mul(a, a.roll(1, 0))
    tfp.sqr(a)
    tfp.to_mont(a)
    assert len(mxu_spy) == 3


def _fp2_words(x: Fp2):
    return torch.from_numpy(np.stack([tfp.to_mont_host(x.c0.n), tfp.to_mont_host(x.c1.n)]))


def _fp12_words(f: Fp12):
    return torch.stack([torch.stack([_fp2_words(c) for c in (h.c0, h.c1, h.c2)]) for h in (f.c0, f.c1)])


def _fp12_of(w):
    fp2 = lambda t: Fp2.from_ints(tfp.from_mont_host(t[0]), tfp.from_mont_host(t[1]))  # noqa: E731
    return Fp12(*(Fp6(*(fp2(w[h, c]) for c in range(3))) for h in range(2)))


def test_tower_with_flag_matches_flag_off_and_oracle(mxu_spy, monkeypatch):
    """With the flag set, the tower products still run their own kernels
    (K7, K8; their plain versions here) and never reach mul_mxu: as in the
    JAX package, whose tower products call poly + redc and not fp.mul, the
    flag reaches only direct Fp products. The values match the flag off
    and the oracle."""
    rng = random.Random(0x3B)
    r2 = lambda: Fp2.from_ints(rng.randrange(P), rng.randrange(P))  # noqa: E731
    r12 = lambda: Fp12(Fp6(r2(), r2(), r2()), Fp6(r2(), r2(), r2()))  # noqa: E731
    x2, y2 = [Fp2.zero(), r2(), r2()], [r2(), Fp2.one(), r2()]
    x12, y12 = [r12(), r12()], [r12(), r12()]
    a2, b2 = torch.stack([_fp2_words(x) for x in x2]), torch.stack([_fp2_words(y) for y in y2])
    a12, b12 = torch.stack([_fp12_words(x) for x in x12]), torch.stack([_fp12_words(y) for y in y12])
    on2, on12 = tt.fp2_mul(a2, b2), tt.fp12_mul(a12, b12)
    assert mxu_spy == []
    monkeypatch.setattr(tfp, "USE_MXU_MUL", False)
    assert torch.equal(on2, tt.fp2_mul(a2, b2))
    assert torch.equal(on12, tt.fp12_mul(a12, b12))
    assert [Fp2.from_ints(tfp.from_mont_host(w[0]), tfp.from_mont_host(w[1])) for w in on2] == [
        x * y for x, y in zip(x2, y2)
    ]
    assert [_fp12_of(w) for w in on12] == [x * y for x, y in zip(x12, y12)]


#: S = 2: one single-key set and one two-key aggregate
SPEC_S2 = [((0,), 0), ((1, 2), 1)]


@pytest.mark.parametrize("kind", ["valid", "tampered_message"])
def test_verify_with_flag_matches_flag_off_and_oracle(kind, mxu_spy, monkeypatch):
    """The verdicts with the flag set match the flag off and the oracle.
    The verify makes no direct Fp product since K19-K21 (the final
    exponentiation, the psi comparison and the Miller inputs run inside
    kernels of their own, here their plain versions, which keep their own
    products whatever the flag says, as K7 and K8 do), so the flag never
    reaches mul_mxu on this path."""

    def batch(b):
        sets = signature_sets(b, SPEC_S2)
        if kind == "tampered_message":
            s = sets[1]
            sets[1] = b.SignatureSet(s.signature, s.signing_keys, b"\x99" * 32)
        return sets

    want = ref.verify_signature_sets(batch(ref), rng=random.Random(5).getrandbits)
    assert want == (kind == "valid")
    on = tapi.verify_signature_sets(batch(tapi), rng=random.Random(5).getrandbits, device="cpu")
    assert mxu_spy == []
    monkeypatch.setattr(tfp, "USE_MXU_MUL", False)
    off = tapi.verify_signature_sets(batch(tapi), rng=random.Random(5).getrandbits, device="cpu")
    assert on == off == want
