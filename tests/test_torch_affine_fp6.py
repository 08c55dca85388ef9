"""lighthouse_tpu_torch `curve.to_affine` and the Fp6 operations of
`tower.py`, compared exactly (tolerance 0: these are integers):

- `to_affine` G1 against the JAX package's jitted `curve.to_affine` on
  projective sums with Z != 1, infinity included;
- `to_affine` G2 against the ref oracle (the jitted JAX G2 comparison is
  in the slow tier);
- `fp6_mul`, `fp6_sqr`, `fp6_mul_by_v`, `fp6_scale` and `fp6_inv` against
  the JAX package's jitted tower functions; `fp6_inv(a) a == 1`.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P, R
from lighthouse_tpu.crypto.bls.jax_backend import curve as jc
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.jax_backend import tower as jt
from lighthouse_tpu.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref.fields import Fp2, Fp6
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from torch_parity import assert_same, to_port

rng = random.Random(0xAF6)


def _sum_pairs(gen, inf):
    """(a, b) point pairs whose projective sums have Z != 1, and an
    infinity sum from P + (-P), O + O and P + O."""
    p0, p1 = gen.mul(rng.randrange(1, R)), gen.mul(rng.randrange(1, R))
    return [(p0, p1), (p0, p0), (p0, -p0), (inf, inf), (p1, inf)]


def _packed_pairs(pack_batch, pairs):
    return tuple(np.asarray(a) for a in (*pack_batch([a for a, _ in pairs]), *pack_batch([b for _, b in pairs])))


def _affine_of_sum(curve, F, ax, ay, ainf, bx, by, binf):
    s = curve.add(F, curve.from_affine(F, ax, ay, ainf), curve.from_affine(F, bx, by, binf))
    return curve.to_affine(F, s)


def _port_args(args):
    return [torch.from_numpy(a) if a.dtype == bool else to_port(a) for a in args]


def _check_against_jax(jF, tF, pack_batch, gen, inf):
    args = _packed_pairs(pack_batch, _sum_pairs(gen, inf))
    want = jax.jit(lambda *a: _affine_of_sum(jc, jF, *a))(*(jnp.asarray(a) for a in args))
    got = _affine_of_sum(tc, tF, *_port_args(args))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    assert got[2].tolist() == np.asarray(want[2]).tolist() == [False, False, True, True, False]


def test_to_affine_g1_matches_jax():
    _check_against_jax(jc.FP, tc.FP, jpack.pack_g1_batch, g1_generator(), g1_infinity())


def test_to_affine_g2_matches_ref():
    pairs = _sum_pairs(g2_generator(), g2_infinity())
    x, y, inf = _affine_of_sum(tc, tc.FP2, *_port_args(_packed_pairs(jpack.pack_g2_batch, pairs)))
    for i, (a, b) in enumerate(pairs):
        s = a + b
        assert bool(inf[i]) == s.inf
        want = (Fp2.zero(), Fp2.zero()) if s.inf else (s.x, s.y)
        for got_c, want_c in zip((x[i], y[i]), want):
            assert [tfp.from_mont_host(got_c[k]) for k in range(2)] == [want_c.c0.n, want_c.c1.n]


@pytest.mark.slow
def test_to_affine_g2_matches_jax():
    _check_against_jax(jc.FP2, tc.FP2, jpack.pack_g2_batch, g2_generator(), g2_infinity())


def _fp2():
    return Fp2.from_ints(rng.randrange(P), rng.randrange(P))


B = 3
A6 = np.stack([jpack.pack_fp6_el(x) for x in [Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero()), Fp6(_fp2(), Fp2.zero(), _fp2())]
               + [Fp6(_fp2(), _fp2(), _fp2()) for _ in range(B)]])
B6 = np.stack([jpack.pack_fp6_el(Fp6(_fp2(), _fp2(), _fp2())) for _ in range(len(A6))])
K2 = np.stack([jpack.pack_fp2_el(_fp2()) for _ in range(len(A6))])

# name -> (jax function, port function, input arrays)
CASES = {
    "fp6_mul": (jt.fp6_mul, tt.fp6_mul, (A6, B6)),
    "fp6_sqr": (jt.fp6_sqr, tt.fp6_sqr, (A6,)),
    "fp6_mul_by_v": (jt.fp6_mul_by_v, tt.fp6_mul_by_v, (A6,)),
    "fp6_scale": (jt.fp6_scale, tt.fp6_scale, (A6, K2)),
    "fp6_inv": (jt.fp6_inv, tt.fp6_inv, (A6,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp6_op_matches_jax(name):
    jfn, tfn, args = CASES[name]
    want = np.asarray(jax.jit(jfn)(*(jnp.asarray(a) for a in args)))
    assert_same(tfn(*(to_port(a) for a in args)), want)


def test_fp6_inv_times_a_is_one():
    a = to_port(A6)
    prod = tt.fp6_mul(a, tt.fp6_inv(a))
    one = tt.fp6_one((), "cpu")
    assert [bool(torch.equal(p, one)) for p in prod] == [False] + [True] * (len(A6) - 1)
    assert not tt.fp6_inv(a[:1]).any()  # inv0: zero maps to zero
