"""lighthouse_tpu_torch pubkey admission (`api.batch_validate_public_keys`,
`curve.g1_in_subgroup`, the K5 wrapper) on the CPU, where K5's wrapper runs
its plain version:

- the staged wire limbs identical to the JAX package's `pack_g1_batch` for
  the same keys, padding rows included;
- verdicts equal to the JAX package's jitted `batch_validate_public_keys`
  and to the ref oracle on valid, garbage, infinity, order-3, non-G1,
  x >= p and not-on-curve encodings;
- the plain subgroup check equal to the oracle's full-order check on
  random G1 and non-G1 points of E(Fp);
- (slow) the full-order ladder criteria agree with the phi and psi
  criteria, and the port equals jitted JAX `_pk_validate_kernel` at S=16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import R
from lighthouse_tpu.crypto.bls.jax_backend import api as japi
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu.crypto.bls.ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from lighthouse_tpu.crypto.bls.ref.curves import g1_in_subgroup as ref_g1_in_subgroup
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from torch_parity import PK_KINDS, _non_subgroup_sig_bytes, non_g1_point, oracle_pk_verdict, pk_encodings, to_port

#: the S=8 list held against jitted JAX: 3 interop keys, garbage, infinity,
#: the order-3 point and an on-curve non-G1 point
JAX_LIST = ["interop_0", "interop_1", "interop_2", "garbage", "infinity", "order_3", "non_g1"]


def _keys(names):
    enc = pk_encodings()
    return [enc[n] for n in names]


def _jax_staged(keys):
    """The JAX package's staging of `keys`, as its batch_validate_public_keys
    does it: decompress without the subgroup check, invalid -> infinity,
    pad to the bucket with infinity, pack_g1_batch."""
    pts = []
    for kb in keys:
        try:
            pts.append(ref.g1_from_compressed(kb, subgroup_check=False))
        except ref.DecodeError:
            pts.append(g1_infinity())
    pts += [g1_infinity()] * (japi._next_pow2(len(pts)) - len(pts))
    return jpack.pack_g1_batch(pts)


def test_staged_limbs_identical_to_jax():
    keys = _keys(list(PK_KINDS))
    x, y, inf, decoded = tapi.stage_public_keys(keys)
    for got, want in zip((x, y, inf), _jax_staged(keys)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    assert x.shape == (16, 32) and inf[len(keys):].all()
    assert decoded.tolist() == [n not in ("garbage", "x_ge_p", "not_on_curve") for n in PK_KINDS]


def test_verdicts_match_jax_s8():
    """One S=8 list through both packages; the JAX side compiles
    `_pk_validate_kernel(8)`, about 30 s on the CPU."""
    keys = _keys(JAX_LIST)
    want = japi.batch_validate_public_keys(keys)
    got = tapi.batch_validate_public_keys(keys, device="cpu")
    assert got == want == [True, True, True, False, False, False, False]


@pytest.mark.parametrize("name", list(PK_KINDS) + ["all"])
def test_verdict_matches_oracle(name):
    names = list(PK_KINDS) if name == "all" else [name]
    keys = _keys(names)
    got = tapi.batch_validate_public_keys(keys, device="cpu")
    assert got == [oracle_pk_verdict(kb) for kb in keys]
    assert all(type(v) is bool for v in got)


def _random_points(kind, seed, n=4):
    """n random G1 points, or n random points of E(Fp) outside G1, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "g1":
        return [g1_generator().mul(int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1) for _ in range(n)]
    return [non_g1_point(int.from_bytes(rng.bytes(48), "big") % (1 << 380)) for _ in range(n)]


def _port_points(pts):
    x, y, inf = jpack.pack_g1_batch(pts)
    return to_port(x), to_port(y), torch.from_numpy(inf)


@pytest.mark.parametrize("kind", ["g1", "non_g1"])
def test_plain_check_matches_oracle(kind):
    pts = _random_points(kind, seed={"g1": 11, "non_g1": 12}[kind])
    x, y, inf = _port_points(pts)
    got = tc.g1_in_subgroup(tc.from_affine(tc.FP, x, y, inf)).tolist()
    assert got == [ref_g1_in_subgroup(pt) for pt in pts] == [kind == "g1"] * len(pts)
    assert tc.g1_in_subgroup_kernel(x, y, inf).tolist() == got


def test_kernel_wrapper_plain_on_cpu_counts_no_launch():
    pts = [g1_generator(), g1_infinity(), non_g1_point(5)]
    x, y, inf = _port_points(pts)
    tfp.reset_launches()
    got = tc.g1_in_subgroup_kernel(x, y, inf)
    assert got.dtype == torch.bool and got.tolist() == [True, False, False]
    assert all(v == 0 for v in tfp.LAUNCHES.values()), tfp.LAUNCHES
    assert tapi.validate_staged_g1(x, y, inf).tolist() == got.tolist()


@pytest.mark.parametrize("bad", ["dtype", "shape", "inf_dtype", "non_contiguous", "device"])
def test_kernel_wrapper_checks_operands(bad):
    x, y, inf = _port_points([g1_generator(), g1_generator()])
    err = TypeError
    if bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "shape":
        y = y[:1]
    elif bad == "inf_dtype":
        inf = inf.to(torch.int32)
    elif bad == "non_contiguous":
        x = torch.stack([x, x], dim=-1)[..., 0]
        err = ValueError
    else:
        inf = inf.to("meta")
        err = RuntimeError
    with pytest.raises(err):
        tc.g1_in_subgroup_kernel(x, y, inf)


@pytest.mark.slow
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_full_order_criteria_agree_with_fast(group):
    """The 255-step ladder's [r]P == O against the phi (G1) and psi (G2)
    criteria on subgroup multiples, infinity and points outside the
    subgroup."""
    rng = np.random.default_rng(13)
    if group == "g1":
        goods = [g1_generator().mul(int(rng.integers(1, 1 << 62))) for _ in range(2)] + [g1_infinity()]
        bads = [non_g1_point(5), ref.g1_from_compressed(pk_encodings()["order_3"], subgroup_check=False)]
        x, y, inf = _port_points(goods + bads)
        p = tc.from_affine(tc.FP, x, y, inf)
        fast, full = tc.g1_in_subgroup(p), tc.g1_in_subgroup_full(p)
    else:
        goods = [g2_generator().mul(int(rng.integers(1, 1 << 62))) for _ in range(2)] + [g2_infinity()]
        bads = [ref.g2_from_compressed(_non_subgroup_sig_bytes(), subgroup_check=False)]
        x, y, inf = jpack.pack_g2_batch(goods + bads)
        p = tc.from_affine(tc.FP2, to_port(x), to_port(y), torch.from_numpy(inf))
        fast, full = tc.g2_in_subgroup(p), tc.g2_in_subgroup_full(p)
    want = [True] * len(goods) + [False] * len(bads)
    assert fast.tolist() == full.tolist() == want


@pytest.mark.slow
def test_validate_staged_bit_identical_to_jax_s16():
    """`validate_staged_g1` against jitted JAX `_pk_validate_kernel(16)` on
    the same staged rows (compiles for about 30 s on the CPU)."""
    keys = _keys(list(PK_KINDS)) + _keys(JAX_LIST)
    x, y, inf = _jax_staged(keys)
    assert inf.shape == (16,)
    want = np.asarray(japi._pk_validate_kernel(16)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf)))
    got = tapi.validate_staged_g1(to_port(x), to_port(y), torch.from_numpy(inf))
    assert got.numpy().tolist() == want.tolist()
