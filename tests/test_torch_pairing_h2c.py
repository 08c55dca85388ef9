"""lighthouse_tpu_torch pairing and hash-to-G2 (torch_backend/pairing.py,
h2c.py) against the JAX package's ref oracle; and, in the slow tier,
bit-identical to the jitted JAX `miller_loop`, `final_exponentiation` (K12's
and K19's plain versions) and `hash_to_g2_device` (each a minutes-long JAX
compile on the CPU).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import DST, P, R
from lighthouse_tpu.crypto.bls.jax_backend import h2c as jh2c
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpair
from lighthouse_tpu.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref import hash_to_curve as ref_h2c
from lighthouse_tpu.crypto.bls.ref.fields import Fp2
from lighthouse_tpu.crypto.bls.ref.hash_to_curve import hash_to_g2
from lighthouse_tpu.crypto.bls.ref.pairing import multi_pairing as ref_multi
from lighthouse_tpu.crypto.bls.ref.pairing import pairing as ref_pairing
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from torch_parity import assert_same, to_port

rng = random.Random(0x9A1)
MSGS = [b"", b"abc", bytes(rng.randrange(256) for _ in range(32))]


@pytest.fixture(scope="module")
def pairing_inputs():
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    P1, Q1 = g1_generator().mul(a), g2_generator().mul(b)
    P2, Q2 = g1_generator().mul(b), g2_generator().mul(a)
    pts_p = [P1, P2, g1_infinity(), P1]
    pts_q = [Q1, Q2, Q2, g2_infinity()]
    px, py, pinf = jpack.pack_g1_batch(pts_p)
    qx, qy, qinf = jpack.pack_g2_batch(pts_q)
    return pts_p, pts_q, (px, py, pinf, qx, qy, qinf)


def _port(args):
    return [torch.from_numpy(np.asarray(a)) if np.asarray(a).dtype == bool else to_port(a) for a in args]


def _fp12(t):
    return jpack.unpack_fp12_el(tfp.to_jax_limbs(t))


def test_pairing_values_match_ref(pairing_inputs):
    """GT values bit-identical to the oracle's, infinity lanes give one, and
    the batch product matches multi_pairing."""
    pts_p, pts_q, args = pairing_inputs
    f = tpair.miller_loop(*_port(args))
    gt = tpair.final_exponentiation(f)
    for i, (p, q) in enumerate(zip(pts_p, pts_q)):
        assert _fp12(gt[i]) == ref_pairing(p, q), f"lane {i}"
    assert bool(tt.fp12_is_one(gt[2])) and bool(tt.fp12_is_one(gt[3]))
    prod = tpair.final_exponentiation(tpair.product_reduce(f))
    assert _fp12(prod) == ref_multi(list(zip(pts_p, pts_q)))


def test_hash_to_g2_device_matches_ref():
    u = th2c.hash_to_field_limbs(MSGS)
    assert np.array_equal(u, jh2c.hash_to_field_limbs(MSGS))  # host half: same wire limbs
    h = th2c.hash_to_g2_device(to_port(u))
    for i, m in enumerate(MSGS):
        x, y, z = (jpack.unpack_fp2_el(tfp.to_jax_limbs(c[i])) for c in h)
        zi = z.inv()
        want = hash_to_g2(m, DST)
        assert (x * zi, y * zi) == (want.x, want.y), f"message {m!r}"


def _fp2_el(t):
    return jpack.unpack_fp2_el(tfp.to_jax_limbs(t))


def test_sswu_and_iso3_edge_branches_match_ref():
    """SSWU including its t1 == 0 branch (u = 0), and the isogeny including
    its kernel point (x = X0 maps to the canonical infinity (0 : 1 : 0))."""
    us = [Fp2.zero(), Fp2.one(), Fp2.from_ints(rng.randrange(P), rng.randrange(P))]
    x, y = th2c.sswu(to_port(np.stack([jpack.pack_fp2_el(u) for u in us])))
    for i, u in enumerate(us):
        assert (_fp2_el(x[i]), _fp2_el(y[i])) == ref_h2c.sswu(u), f"u = {u}"
    kx = to_port(jpack.pack_fp2_el(ref_h2c._ISO_X0))[None]
    q = th2c.iso3_map(torch.cat([x, kx]), torch.cat([y, y[:1]]))
    for i, u in enumerate(us):
        want = ref_h2c.iso3_map(*ref_h2c.sswu(u))
        assert _fp2_el(q.z[i]) == Fp2.one()
        assert (_fp2_el(q.x[i]), _fp2_el(q.y[i])) == (want.x, want.y)
    assert ref_h2c.iso3_map(ref_h2c._ISO_X0, Fp2.one()).inf
    assert (_fp2_el(q.x[-1]), _fp2_el(q.y[-1]), _fp2_el(q.z[-1])) == (Fp2.zero(), Fp2.one(), Fp2.zero())


def test_hash_to_field_cache_hits_are_identical():
    th2c.H2C_FIELD_CACHE.clear()
    cold = th2c.hash_to_field_limbs(MSGS + MSGS[:1])
    warm = th2c.hash_to_field_limbs(MSGS + MSGS[:1])
    assert np.array_equal(cold, warm)
    assert len(th2c.H2C_FIELD_CACHE) == len(MSGS)


@pytest.mark.slow
def test_miller_loop_and_final_exp_bit_identical_to_jax(pairing_inputs):
    _, _, args = pairing_inputs

    @jax.jit
    def drive(*a):
        f = jpair.miller_loop(*a)
        return f, jpair.final_exponentiation(f)

    want_f, want_gt = drive(*(jnp.asarray(a) for a in args))
    f = tpair.miller_loop(*_port(args))
    assert_same(f, want_f)
    for gt in (tpair.final_exponentiation_plain(f), tpair.final_exponentiation(f)):  # K19's plain version
        assert_same(gt, want_gt)


@pytest.mark.slow
def test_hash_to_g2_device_bit_identical_to_jax():
    u = jh2c.hash_to_field_limbs(MSGS)
    want = jax.jit(jh2c.hash_to_g2_device)(jnp.asarray(u))
    got = th2c.hash_to_g2_device(to_port(u))
    for gc, wc in zip(got, want):
        assert_same(gc, wc)
