"""lighthouse_tpu_torch Fp (torch_backend/fp.py) against the JAX package's
jitted fp functions and against Python integers.

On the CPU each kernel wrapper runs its plain version, so these tests hold
the plain versions (the kernels' reference on the card) to the JAX
arithmetic bit for bit. The kernels themselves are compared with their
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import pathlib
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from torch_parity import EDGES, assert_same, mont_limbs, rand_fp_ints, to_port

N = 16


@jax.jit
def _jax_fp_ops(a, b):
    return {
        "add": jfp.add(a, b),
        "sub": jfp.sub(a, b),
        "neg": jfp.neg(a),
        "mul": jfp.mul(a, b),
        "sqr": jfp.sqr(a),
        "inv": jfp.inv(a),
        "sqrt_candidate": jfp.sqrt_candidate(a),
    }


@pytest.fixture(scope="module")
def fp_case():
    xs = rand_fp_ints(11, N)
    ys = rand_fp_ints(12, N)[::-1]
    a, b = mont_limbs(xs), mont_limbs(ys)
    want = {k: np.asarray(v) for k, v in _jax_fp_ops(jnp.asarray(a), jnp.asarray(b)).items()}
    return to_port(a), to_port(b), want


PORT_OPS = {
    "add": lambda a, b: tfp.add(a, b),
    "sub": lambda a, b: tfp.sub(a, b),
    "neg": lambda a, b: tfp.neg(a),
    "mul": lambda a, b: tfp.mul(a, b),
    "sqr": lambda a, b: tfp.sqr(a),
    "inv": lambda a, b: tfp.inv(a),
    "sqrt_candidate": lambda a, b: tfp.sqrt_candidate(a),
}


@pytest.mark.parametrize("op", sorted(PORT_OPS))
def test_fp_op_matches_jax(fp_case, op):
    a, b, want = fp_case
    assert_same(PORT_OPS[op](a, b), want[op])


def test_batch_inv_matches_jax_with_zero_lanes():
    xs = rand_fp_ints(13, 5 * 3)
    a = mont_limbs(xs).reshape(5, 3, jfp.N_LIMBS)
    a[1, 2] = 0
    a[:, 0] = 0  # a lane of zeros only
    want = jax.jit(jfp.batch_inv)(jnp.asarray(a))
    got = tfp.batch_inv(to_port(a))
    assert_same(got, want)
    assert bool((got[:, 0] == 0).all()) and bool((got[1, 2] == 0).all())


def test_to_from_mont_match_jax():
    xs = rand_fp_ints(14, 8)
    raw = jfp.ints_to_limbs(xs)
    want = jax.jit(lambda a: (jfp.to_mont(a), jfp.from_mont(a)))(jnp.asarray(raw))
    assert_same(tfp.to_mont(to_port(raw)), want[0])
    assert_same(tfp.from_mont(to_port(raw)), want[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_limb_repack_round_trips(seed):
    rng = random.Random(seed)
    xs = EDGES + [rng.randrange(1 << 384) for _ in range(59)] + [(1 << 384) - 1]
    limbs = jfp.ints_to_limbs(xs)
    words = tfp.from_jax_limbs(limbs)
    assert words.dtype == torch.int32 and words.shape == (len(xs), 12)
    assert [tfp.words_to_int(w) for w in words] == xs
    assert np.array_equal(tfp.to_jax_limbs(words), limbs)
    assert np.array_equal(words.numpy(), tfp.ints_to_words(xs))
    # leading batch dims survive both directions
    assert np.array_equal(tfp.to_jax_limbs(tfp.from_jax_limbs(limbs.reshape(4, 16, 32))), limbs.reshape(4, 16, 32))


def _ints(t):
    return [tfp.words_to_int(w) for w in t.reshape(-1, 12)]


@pytest.mark.parametrize("kernel", ["fp_mul", "fp_addsub", "fp_pow", "fp_batch_inv"])
def test_plain_version_matches_python_integers(kernel):
    """K1-K4's plain versions on stored words (not only Montgomery forms):
    x, y in [0, p) as they lie in the 12 words."""
    xs, ys = rand_fp_ints(21, 24), rand_fp_ints(22, 24)[::-1]
    a, b = torch.from_numpy(tfp.ints_to_words(xs)), torch.from_numpy(tfp.ints_to_words(ys))
    rinv = pow(1 << 384, -1, P)
    if kernel == "fp_mul":
        assert _ints(tfp.mul_plain(a, b)) == [x * y * rinv % P for x, y in zip(xs, ys)]
    elif kernel == "fp_addsub":
        assert _ints(tfp.addsub_plain(a, b, 0)) == [(x + y) % P for x, y in zip(xs, ys)]
        assert _ints(tfp.addsub_plain(a, b, 1)) == [(x - y) % P for x, y in zip(xs, ys)]
        assert _ints(tfp.addsub_plain(a, None, 2)) == [(-x) % P for x in xs]
    elif kernel == "fp_pow":
        # Montgomery exponentiation: x^e * R^(1-e), so compare in Montgomery form
        m = torch.from_numpy(tfp.to_mont_host_bulk(xs[:8]))
        got = [tfp.from_mont_host(w) for w in tfp.pow_plain(m, 65537)]
        assert got == [pow(x, 65537, P) for x in xs[:8]]
    else:
        m = torch.from_numpy(tfp.to_mont_host_bulk(xs)).reshape(6, 4, 12)
        got = [tfp.from_mont_host(w) for w in tfp.batch_inv_plain(m).reshape(-1, 12)]
        assert got == [pow(x, P - 2, P) for x in xs]


def test_kernel_header_constants_match_p():
    """fp384.cuh's __constant__ tables are the values fp.py derives from P."""
    src = (pathlib.Path(tfp.__file__).parent / "csrc" / "fp384.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[FP_WORDS\] = \{(.*?)\};", src, re.S).group(1)
        words = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", body)]
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert table("FP_P") == P
    assert table("FP_ONE") == tfp.R_MONT
    assert int(re.search(r"#define FP_PINV (0x[0-9a-f]+)u", src).group(1), 16) == tfp.P_INV32
    # fp_inv's closing factor 2^(1152 + 32 batches - steps x batches)
    steps, batches = (int(re.search(rf"#define FP_INV_{k} (\d+)", src).group(1)) for k in ("STEPS", "BATCHES"))
    assert table("FP_INV_C") == pow(2, 3 * 384 + 32 * batches - steps * batches, P)


def test_wrappers_reject_bad_operands():
    with pytest.raises(TypeError):
        tfp.mul(torch.zeros(4, 12, dtype=torch.int64), torch.zeros(4, 12, dtype=torch.int64))
    with pytest.raises(TypeError):
        tfp.add(torch.zeros(4, 32, dtype=torch.int32), torch.zeros(4, 32, dtype=torch.int32))


def test_wrappers_check_every_operand():
    """The second operand is held to the same layout and device as the first."""
    a = torch.zeros(4, 12, dtype=torch.int32)
    with pytest.raises(TypeError):
        tfp.mul(a, torch.zeros(4, 12, dtype=torch.int64))
    with pytest.raises(TypeError):
        tfp.sub(a, torch.zeros(4, 12, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="different devices"):
        tfp.mul(a, torch.zeros(4, 12, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError, match="different devices"):
        tfp.add(a, torch.zeros(4, 12, dtype=torch.int32, device="meta"))
