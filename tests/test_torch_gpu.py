"""lighthouse_tpu_torch on the card: the hand-written kernels against their
plain versions, launch counting, and a small verify, also with every Fp
product on the tensor cores (K6). Every test needs a
CUDA GPU and skips without one. The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch for CUDA and nvcc:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import random

import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.constants import P, R
from lighthouse_tpu_torch.crypto.bls.ref import api as ref
from lighthouse_tpu_torch.crypto.bls.ref.curves import Point, _B1, g1_generator, g1_infinity
from lighthouse_tpu_torch.crypto.bls.ref.fields import Fp
from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp
from lighthouse_tpu_torch.crypto.bls.torch_backend.pack import pack_g1_batch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _elements(seed, n, device):
    rng = random.Random(seed)
    xs = [0, 1, P - 1, P - 2] + [rng.randrange(P) for _ in range(n - 4)]
    return torch.from_numpy(fp.to_mont_host_bulk(xs)).to(device)


def test_kernels_match_plain_versions_on_card(cuda_device):
    a = _elements(31, 1024, cuda_device)
    b = a.roll(1, dims=0)
    assert torch.equal(fp.mul(a, b), fp.mul_plain(a, b))
    assert torch.equal(fp.add(a, b), fp.addsub_plain(a, b, 0))
    assert torch.equal(fp.sub(a, b), fp.addsub_plain(a, b, 1))
    assert torch.equal(fp.neg(a), fp.addsub_plain(a, None, 2))
    assert torch.equal(fp.inv(a), fp.pow_plain(a, fp.INV_EXP))
    x = a[:1020].reshape(255, 4, 12).clone()
    x[3, 1] = 0
    x[:, 2] = 0
    assert torch.equal(fp.batch_inv(x), fp.batch_inv_plain(x))


def test_wrappers_launch_and_count_on_card(cuda_device):
    a = _elements(32, 64, cuda_device)
    fp.reset_launches()
    fp.mul(a, a[:1])  # broadcast operand
    fp.add(a[::2], a[1::2])  # non-contiguous slices
    fp.inv(a)
    fp.batch_inv(a.reshape(8, 8, 12))
    torch.cuda.synchronize()
    assert fp.LAUNCHES == {
        "fp_mul": 1, "fp_addsub": 1, "fp_pow": 1, "fp_batch_inv": 1, "g1_subgroup_check": 0, "fp_mul_mma": 0,
    }
    assert torch.equal(fp.add(a[::2], a[1::2]), fp.addsub_plain(a[::2], a[1::2], 0))


def _small_batches():
    keys = [api.interop_keypair(i) for i in range(3)]
    msg = b"\x5a" * 32
    sets = [api.SignatureSet(signature=sk.sign(msg), signing_keys=[pk], message=msg) for sk, pk in keys]
    bad = list(sets)
    bad[1] = api.SignatureSet(sets[1].signature, sets[1].signing_keys, b"\x5b" * 32)
    return sets, bad


def test_verify_on_card(cuda_device):
    sets, bad = _small_batches()
    assert api.verify_signature_sets(sets) is True
    assert api.verify_signature_sets(bad) is False


@pytest.mark.parametrize("n", [1, 31, 33, 4104])
def test_mul_mma_matches_plain_and_k1_on_card(cuda_device, n):
    """K6 against its plain version and K1, bit for bit, at whole tiles of
    32 elements and at tails."""
    a = _elements(34, max(n, 4), cuda_device)[:n]
    b = a.roll(1, dims=0)
    fp.reset_launches()
    got = fp.mul_mxu(a, b)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["fp_mul_mma"] == 1
    assert torch.equal(got, fp.mul_mxu_plain(a, b))
    assert torch.equal(got, fp.mul(a, b))


def test_mxu_flag_routes_verify_through_k6(cuda_device, monkeypatch):
    monkeypatch.setattr(fp, "USE_MXU_MUL", True)
    sets, bad = _small_batches()
    fp.reset_launches()
    assert api.verify_signature_sets(sets) is True
    assert fp.LAUNCHES["fp_mul"] == 0 and fp.LAUNCHES["fp_mul_mma"] > 0
    assert api.verify_signature_sets(bad) is False


def _non_g1_points(n):
    out, x = [], 5
    while len(out) < n:
        x += 1
        y = (Fp(x) * Fp(x) * Fp(x) + _B1).sqrt()
        if y is not None and not Point(Fp(x), y, False, _B1).mul(R).inf:
            out.append(Point(Fp(x), y, False, _B1))
    return out


def test_g1_subgroup_kernel_matches_plain_on_card(cuda_device):
    """K5 against its plain version on G1 points, the order-3 point (0, 2),
    points of E(Fp) outside G1 and infinity rows."""
    rng = random.Random(33)
    goods = [g1_generator()] + [g1_generator().mul(rng.randrange(1, R)) for _ in range(5)]
    order3 = ref.g1_from_compressed(b"\x80" + bytes(47), subgroup_check=False)
    pts = goods + [order3] + _non_g1_points(4) + [g1_infinity()] * 2
    x, y, inf = pack_g1_batch(pts)
    xw, yw, infb = fp.from_jax_limbs(x), fp.from_jax_limbs(y), torch.from_numpy(inf)
    want = curve.g1_subgroup_check_plain(xw, yw, infb)
    assert want.tolist() == [True] * len(goods) + [False] * (len(pts) - len(goods))
    fp.reset_launches()
    got = curve.g1_in_subgroup_kernel(xw.to(cuda_device), yw.to(cuda_device), infb.to(cuda_device))
    torch.cuda.synchronize()
    assert fp.LAUNCHES["g1_subgroup_check"] == 1
    assert got.cpu().tolist() == want.tolist()


def test_batch_validate_public_keys_launches_k5_once(cuda_device):
    keys = [api.interop_keypair(i)[1].to_bytes() for i in range(3)] + [b"\xff" * 48, b"\x80" + bytes(47)]
    fp.reset_launches()
    got = api.batch_validate_public_keys(keys)
    assert got == [True, True, True, False, False]
    assert fp.LAUNCHES == {k: int(k == "g1_subgroup_check") for k in fp.KERNELS}
