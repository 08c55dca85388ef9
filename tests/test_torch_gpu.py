"""lighthouse_tpu_torch on the card: the hand-written kernels against their
plain versions (the tower products K7 and K8 also against the K1/K2
composition they replaced), launch counting, launches on a card other than the current
one (and from a fresh thread), and a small verify, also with every Fp
product on the tensor cores (K6). Every test needs a
CUDA GPU and skips without one. The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch for CUDA and nvcc:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import random
import threading

import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.constants import P, R
from lighthouse_tpu_torch.crypto.bls.ref import api as ref
from lighthouse_tpu_torch.crypto.bls.ref.curves import Point, _B1, g1_generator, g1_infinity
from lighthouse_tpu_torch.crypto.bls.ref.fields import Fp
from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, tower
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
        "fp2_mul": 0, "fp12_mul": 0,
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


def _fp2_elements(seed, n, device):
    """Fp2 edge values 0, one, (p-1, p-1) and u, then random elements."""
    rng = random.Random(seed)
    pairs = [(0, 0), (1, 0), (P - 1, P - 1), (0, 1)] + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    words = fp.to_mont_host_bulk([x for pair in pairs[:n] for x in pair])
    return torch.from_numpy(words).reshape(n, 2, 12).to(device)


def _fp12_elements(seed, n, device):
    """Fp12 elements: the first with p - 1 in every word slot, then random."""
    x = _fp2_elements(seed, 6 * n + 4, device)[4:].reshape(n, 2, 3, 2, 12).clone()
    x[0] = torch.from_numpy(fp.int_to_words(P - 1)).to(device)
    return x


@pytest.mark.parametrize("n", [1, 63, 65, 200])
def test_fp2_kernel_matches_plain_on_card(cuda_device, n):
    """K7 against its plain version and the K1/K2 composition, bit for bit,
    one launch per call and no K1/K2 launch, with a broadcast operand."""
    a = _fp2_elements(36, n, cuda_device)
    b = a.roll(1, dims=0)
    fp.reset_launches()
    got = {"mul": tower.fp2_mul(a, b), "sqr": tower.fp2_sqr(a), "broadcast": tower.fp2_mul(a, b[-1])}
    torch.cuda.synchronize()
    assert (fp.LAUNCHES["fp2_mul"], fp.LAUNCHES["fp_mul"], fp.LAUNCHES["fp_addsub"]) == (3, 0, 0)
    for F in (fp.PLAIN_OPS, fp.KERNEL_OPS):
        assert torch.equal(got["mul"], tower.fp2_mul_plain(a, b, F))
        assert torch.equal(got["sqr"], tower.fp2_sqr_plain(a, F))
        assert torch.equal(got["broadcast"], tower.fp2_mul_plain(a, b[-1], F))


@pytest.mark.parametrize("n", [1, 15, 17, 129])
def test_fp12_kernel_matches_plain_on_card(cuda_device, n):
    """K8 in its three modes against its plain version and the K1/K2
    composition, bit for bit, one launch per call, with broadcast operands."""
    a = _fp12_elements(37, n, cuda_device)
    b = a.roll(1, dims=0)
    lines = _fp2_elements(38, 2 * n + 1, cuda_device)
    b0, b3, b5 = lines[:n], lines[n : 2 * n], lines[-1]
    cases = {
        "full": (b,), "square": (), "sparse": (b0, b3, b5), "broadcast": (b[-1],),
    }
    modes = {"full": tower.FP12_FULL, "square": tower.FP12_SQUARE, "sparse": tower.FP12_SPARSE,
             "broadcast": tower.FP12_FULL}
    fp.reset_launches()
    got = {name: tower.fp12_product(a, bs, modes[name]) for name, bs in cases.items()}
    torch.cuda.synchronize()
    assert (fp.LAUNCHES["fp12_mul"], fp.LAUNCHES["fp_mul"], fp.LAUNCHES["fp_addsub"]) == (4, 0, 0)
    for F in (fp.PLAIN_OPS, fp.KERNEL_OPS):
        for name, bs in cases.items():
            assert torch.equal(got[name], tower.fp12_product_plain(a, bs, modes[name], F)), name


def test_mxu_flag_verify_still_launches_k7_k8(cuda_device, monkeypatch):
    """With every Fp product on K6, the tower products stay on K7 and K8
    (as the JAX package's flag reaches only direct Fp products)."""
    sets, _ = _small_batches()
    counts = {}
    for flag in (False, True):
        monkeypatch.setattr(fp, "USE_MXU_MUL", flag)
        fp.reset_launches()
        assert api.verify_signature_sets(sets) is True
        counts[flag] = dict(fp.LAUNCHES)
    assert counts[True]["fp_mul"] == 0 and counts[True]["fp_mul_mma"] == counts[False]["fp_mul"] > 0
    for k in ("fp2_mul", "fp12_mul"):
        assert counts[True][k] == counts[False][k] > 0


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


def test_kernels_launch_on_the_operands_card(cuda_device):
    """K1 and K2 on cuda:1 while cuda:0 is current, and from a fresh host
    thread (whose current device is cuda:0): the results lie on cuda:1 and
    equal the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA GPUs: torch.cuda.device_count() < 2")
    a = _elements(35, 512, torch.device("cuda", 1))
    b = a.roll(1, dims=0)
    want = (fp.mul_plain(a.cpu(), b.cpu()), fp.addsub_plain(a.cpu(), b.cpu(), 0))

    def run(out):
        out.extend([fp.mul(a, b), fp.add(a, b)])
        torch.cuda.synchronize(a.device)

    here, there = [], []
    with torch.cuda.device(0):
        run(here)
    t = threading.Thread(target=run, args=(there,))
    t.start()
    t.join(120)
    assert not t.is_alive()
    for got in (here, there):
        assert [g.device for g in got] == [a.device] * 2
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
