"""lighthouse_tpu_torch on the card: the hand-written kernels against their
plain versions (the tower products K7 and K8 also against the K1/K2
composition they replaced, the chains K9-K14 against the K1-K4/K7/K8
composition, the tree sums K15 and K16, the cofactor clearing K17, the
Fp12 product K18, the final exponentiation K19, the psi comparison K20,
the Miller inputs K21 and the standalone K22-K32 against the composition
each replaced, K33 against its plain version; K10 also at 1, 2, 3, 127,
128 and 129 elements, K11 at 1, 2, 3, 255, 256 and 257, K12 at 1, 2, 129
and 130 pairs, K13 and K32 at 1, 7, 8, 9, 255, 256 and 257, K17 and K19 at 1,
16, 17, 128 and 129 elements, K5 at 1 to 64 keys, K4 at 1 x 1 to
3 x 16,384 values around its thresholds; the port's kernel registry
walked on the card), launch
counting, launches on a card other than the current one (and from a fresh
thread), and a small verify, also with every direct Fp product on the
tensor cores (K6). Every test needs a
CUDA GPU and skips without one. The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch for CUDA and nvcc:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import pathlib
import random
import re
import threading

import pytest
import torch

import chip_smoke
from lighthouse_tpu_torch.crypto.bls.constants import P, R
from lighthouse_tpu_torch.crypto.bls.ref import api as ref
from lighthouse_tpu_torch.crypto.bls.ref.curves import Point, _B1, g1_generator, g1_infinity
from lighthouse_tpu_torch.crypto.bls.ref.fields import Fp
from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, h2c, pairing, tower
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
        "fp2_mul": 0, "fp12_mul": 0, "cyclotomic_pow_x": 0, "g1_scalar_mul": 0, "g2_scalar_mul": 0,
        "miller_loop": 0, "sswu": 0, "iso3_map": 0, "g1_tree_sum": 0, "g2_tree_sum": 0, "clear_cofactor": 0,
        "product_reduce": 0, "final_exponentiation": 0, "g2_psi_check": 0, "miller_inputs": 0,
        "g1_to_affine": 0, "g2_to_affine": 0, "fp6_mul": 0, "fp2_inv": 0, "g1_add": 0, "g2_add": 0,
        "karabina_sqr": 0, "karabina_decompress": 0, "fp12_inv": 0, "frobenius": 0, "fp2_sqrt_candidate": 0,
        "fp_redc": 0,
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


#: launches of one verify, whatever its shape, for every kernel: r_i aggpk_i
#: (K10), the signatures' 2-stacked multiplication (K11) and their psi
#: comparison (K20), the Miller loop (K12), SSWU (K13), the isogeny (K14),
#: the two tree sums (K15, K16), the cofactor clearing with the sum of the
#: SSWU points (K17), the Miller pairs' affine inputs (K21), the product of
#: the Miller values (K18) and the final exponentiation (K19), once each;
#: K1-K9 never (they run only inside those), nor K22-K33 (off the path)
VERIFY_LAUNCHES = chip_smoke.VERIFY_LAUNCHES
assert VERIFY_LAUNCHES == {"fp_mul": 0, "fp_addsub": 0, "fp_pow": 0, "fp_batch_inv": 0, "g1_subgroup_check": 0,
                           "fp_mul_mma": 0, "fp2_mul": 0, "fp12_mul": 0, "cyclotomic_pow_x": 0,
                           "g1_scalar_mul": 1, "g2_scalar_mul": 1, "miller_loop": 1, "sswu": 1, "iso3_map": 1,
                           "g1_tree_sum": 1, "g2_tree_sum": 1, "clear_cofactor": 1, "product_reduce": 1,
                           "final_exponentiation": 1, "g2_psi_check": 1, "miller_inputs": 1, "g1_to_affine": 0,
                           "g2_to_affine": 0, "fp6_mul": 0, "fp2_inv": 0, "g1_add": 0, "g2_add": 0,
                           "karabina_sqr": 0, "karabina_decompress": 0, "fp12_inv": 0, "frobenius": 0,
                           "fp2_sqrt_candidate": 0, "fp_redc": 0}


def test_verify_launches_the_chain_kernels(cuda_device):
    """A 128 x 1 verify launches each chain kernel as VERIFY_LAUNCHES says;
    valid and tampered verdicts are unchanged."""
    sets, bad = _small_batches()
    sets = [sets[i % len(sets)] for i in range(128)]
    bad = [bad[i % len(bad)] for i in range(128)]
    fp.reset_launches()
    assert api.verify_signature_sets(sets) is True
    torch.cuda.synchronize()
    assert fp.LAUNCHES == VERIFY_LAUNCHES
    assert api.verify_signature_sets(bad) is False


def _points(group, n, seed):
    """n projective points with Z != 1 (sums of seeded random subgroup
    points), row 0 P + (-P), row 1 infinity."""
    from lighthouse_tpu_torch.crypto.bls.ref.curves import g2_generator, g2_infinity
    from lighthouse_tpu_torch.crypto.bls.torch_backend.pack import pack_g2_batch

    gen, inf, pack, F = {
        "g1": (g1_generator, g1_infinity, pack_g1_batch, curve.FP),
        "g2": (g2_generator, g2_infinity, pack_g2_batch, curve.FP2),
    }[group]
    rng = random.Random(seed)
    base = [gen().mul(rng.getrandbits(64) | 1) for _ in range(4)]
    base += [-base[0], inf()]
    x, y, i = pack(base)
    p = curve.from_affine(F, fp.from_jax_limbs(x, "cuda"), fp.from_jax_limbs(y, "cuda"), torch.from_numpy(i).cuda())
    ia = torch.tensor([0, 5] + [k % 6 for k in range(2, n)], device="cuda")
    ib = torch.tensor([4, 5] + [(5 * k + 1) % 6 for k in range(2, n)], device="cuda")
    return curve.add(F, curve.Proj(*(c[ia] for c in p)), curve.Proj(*(c[ib] for c in p)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_kernels_match_plain_on_card(cuda_device, group):
    """K10 (G1) and K11 (G2) against their plain versions and the
    composition they replaced, bit for bit, one launch per call: per-element
    int32 bits with an all-zero and an all-one row, and public 128-bit rows
    broadcast over a (2, n) batch."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c

    F, plain, kernel = {"g1": (curve.FP, curve.FP_PLAIN, "g1_scalar_mul"),
                        "g2": (curve.FP2, curve.FP2_PLAIN, "g2_scalar_mul")}[group]
    p = _points(group, 40, 39)
    bits = torch.randint(0, 2, (40, 64), dtype=torch.int32, generator=torch.Generator().manual_seed(40)).cuda()
    bits[2], bits[3] = 0, 1
    pairs = curve.Proj(*(c.reshape(2, 20, *c.shape[1:]) for c in p))
    cc = fp.const(h2c._CC_BITS, cuda_device).reshape(2, 1, h2c._CC_WIDTH)
    fp.reset_launches()
    got = [curve.scalar_mul_bits(F, p, bits), curve.scalar_mul_bits(F, pairs, cc)]
    torch.cuda.synchronize()
    assert fp.LAUNCHES[kernel] == 2
    for out, (q, b) in zip(got, [(p, bits), (pairs, cc)]):
        for field in (plain, F):
            want = curve.scalar_mul_bits_plain(field, q, b)
            assert all(torch.equal(g, w) for g, w in zip(out, want))


@pytest.mark.parametrize("n", chip_smoke.SCALAR_MUL_COUNTS)
def test_g2_scalar_mul_kernel_matches_plain_at_counts(cuda_device, n):
    """K11 (two elements a warp) at 1, 2, 3, 255, 256 and 257 points, odd
    counts leaving the last block's second lane group off, against its
    plain version and the composition it replaced, bit for bit: one
    launch (chip_smoke's `lane_cases`)."""
    cases = chip_smoke.lane_cases(torch, fp, curve, tower, pairing, (n,), (), 60)
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"g2_scalar_mul": 1}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name


@pytest.mark.parametrize("n", chip_smoke.G1_SCALAR_MUL_COUNTS)
def test_g1_scalar_mul_kernel_matches_plain_at_counts(cuda_device, n):
    """K10 (a lane group of six an element, one a warp) at 1, 2, 3, 127,
    128 and 129 points, int64 bits at odd counts, against its plain
    version and the composition it replaced, bit for bit: one launch
    (chip_smoke's `lane_cases`)."""
    cases = chip_smoke.lane_cases(torch, fp, curve, tower, pairing, (), (), 61, (n,))
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"g1_scalar_mul": 1}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name


@pytest.mark.parametrize("n", chip_smoke.SQRT_COUNTS)
def test_sswu_kernel_matches_plain_at_counts(cuda_device, n):
    """K13 (eight elements a block, windowed square-root chains) at 1, 7,
    8, 9, 255, 256 and 257 u's with 0, one, u and -1 where the count
    reaches them, against its plain version and the composition it
    replaced, bit for bit: one launch (chip_smoke's `sswu_cases`)."""
    cases = chip_smoke.sswu_cases(torch, fp, tower, h2c, P, (n,), 62)
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"sswu": 1}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name


def test_iso3_and_psi_kernels_match_plain_at_edges(cuda_device):
    """K14 (four lanes an element, eight elements a block) on SSWU's points
    at K13's counts with the kernel point and all p - 1 coordinates among
    them, and on each alone (chip_smoke's `iso3_cases`); K20 (eight lanes
    an element) with sig, zsig and both at infinity and all p - 1
    coordinates (`psi_edge_cases`): against the plain versions and the
    compositions replaced, bit for bit, one launch a case."""
    cases = chip_smoke.iso3_cases(torch, fp, tower, h2c, P, chip_smoke.SQRT_COUNTS, 63)
    cases.update(chip_smoke.psi_edge_cases(torch, fp, curve, h2c, P, chip_smoke.PSI_EDGE, 64))
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"iso3_map": len(cases) - 1, "g2_psi_check": 1}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name


def test_pow_abs_x_kernel_matches_plain_on_card(cuda_device):
    """K9 against its plain version and the composition it replaced, bit
    for bit, one launch per call: cyclotomic elements, one, and a lane
    whose checkpoints take decompression's g2 = 0 branch."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing

    f = _fp12_elements(41, 5, cuda_device)
    g = tower.fp12_mul(tower.fp12_conj(f), tower.fp12_inv(f))
    g = tower.fp12_mul(pairing.frobenius2(g), g)
    g[2] = tower.fp12_one((), cuda_device)
    g[3] = f[3]
    g[3, 1, 0], g[3, 1, 2] = 0, 0  # b0 = b2 = 0: compressed g2 = g5 = 0 at every step
    fp.reset_launches()
    got = pairing.pow_abs_x(g)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["cyclotomic_pow_x"] == 1
    assert torch.equal(got, pairing.pow_abs_x_plain(g))
    assert torch.equal(got, pairing.pow_abs_x_composed(g, tower.KERNEL_TOWER))


@pytest.mark.parametrize("n", chip_smoke.MILLER_COUNTS)
def test_miller_loop_kernel_matches_plain_on_card(cuda_device, n):
    """K12 (a block of two warps a pair) at 1, 2, 129 (the verify path's)
    and 130 pairs, infinity lanes included where the count reaches them,
    against its plain version and the K1-K4/K7/K8 composition it replaced,
    bit for bit, one launch."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing

    args = chip_smoke.miller_inputs(torch, fp, n, 42, cuda_device)
    fp.reset_launches()
    got = pairing.miller_loop(*args)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["miller_loop"] == 1 and fp.LAUNCHES["fp12_mul"] == 0
    assert torch.equal(got, pairing.miller_loop_plain(*args))
    assert torch.equal(got, pairing.miller_loop_composed(*args, tower.KERNEL_TOWER))
    one = tower.fp12_one((), cuda_device)
    assert all(torch.equal(got[i], one) for i in range(1, min(n, 4))) and not torch.equal(got[0], one)


def test_sswu_and_iso3_kernels_match_plain_on_card(cuda_device):
    """K13 at the verify path's m = 256 (u0 and u1 of 128 sets) with the
    edge u's, and K14 on its output plus the isogeny's kernel point X0,
    against their plain versions and the K1-K4/K7/K8 composition they
    replaced, bit for bit, one launch each."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c

    u = chip_smoke.sswu_inputs(fp, P, 256, 43, cuda_device)
    fp.reset_launches()
    x, y = h2c.sswu(u)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["sswu"] == 1 and fp.LAUNCHES["fp2_mul"] == 0
    for want in (h2c.sswu_plain(u), h2c.sswu_composed(u, tower.KERNEL_TOWER)):
        assert torch.equal(x, want[0]) and torch.equal(y, want[1])
    xs = torch.cat([x, fp.const(h2c._X0, cuda_device)[None]])
    ys = torch.cat([y, y[:1]])
    fp.reset_launches()
    q = h2c.iso3_map(xs, ys)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["iso3_map"] == 1 and fp.LAUNCHES["fp_pow"] == 0
    for want in (h2c.iso3_map_plain(xs, ys), h2c.iso3_map_composed(xs, ys, tower.KERNEL_TOWER)):
        assert all(torch.equal(a, b) for a, b in zip(q, want))
    assert bool(tower.fp2_is_zero(q.z[-1])) and not bool(tower.fp2_is_zero(q.z[:-1]).any())


@pytest.fixture(scope="module")
def fold_edge_cases():
    """chip_smoke's [kernels] edge cases of K15-K18 (`fold_cases`): tree
    sums over columns of 1, 2, 3, 5, 128, 512 and 1,025 points with P == Q,
    P == -Q and infinity rows; the cofactor clearing of 19 elements with
    u = 0's point and q1 = q0, -q0 and infinity, with and without the sum;
    the Fp12 product of 1, 2, 3 and 129 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c, pairing

    return chip_smoke.fold_cases(torch, fp, curve, tower, pairing, h2c, P,
                                 [(2, n) for n in chip_smoke.FOLD_LENGTHS], chip_smoke.FOLD_LENGTHS,
                                 chip_smoke.COFACTOR_EDGE, chip_smoke.REDUCE_COUNTS, 44, nosum=True)


@pytest.mark.parametrize("kernel", ["g1_tree_sum", "g2_tree_sum", "clear_cofactor", "product_reduce"])
def test_fold_and_cofactor_kernels_match_plain_on_card(fold_edge_cases, kernel):
    """K15-K18 at their edge shapes against their plain versions and the
    composition each replaced, bit for bit: one launch per call and no
    other kernel."""
    cases = {name: case for name, case in fold_edge_cases.items() if name.startswith(kernel)}
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {kernel: len(cases)}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name


@pytest.mark.parametrize("n", [1, 16, 17, 128, 129])
def test_cofactor_and_final_exp_kernels_match_plain_at_counts(cuda_device, n):
    """K17 (a warp per element, two lane groups) and K19 (a warp per
    element, the binary-GCD inversion) at 1, 16, 17, 128 and 129 elements
    against their plain versions, bit for bit: one launch each."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c, pairing

    q0, q1 = (curve.Proj(*(c[:n] for c in q))
              for q in chip_smoke.cofactor_inputs(torch, fp, curve, h2c, P, max(n, 4), 47 + n))
    f = chip_smoke.fp12_inputs(fp, tower, P, n, 48 + n, "cuda")
    fp.reset_launches()
    got = h2c.clear_cofactor(q0, q1), pairing.final_exponentiation(f)
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"clear_cofactor": 1, "final_exponentiation": 1}
    want = h2c.clear_cofactor_plain(q0, q1), pairing.final_exponentiation_plain(f)
    for g, w in zip(got, want):
        assert torch.equal(chip_smoke._stacked(g), chip_smoke._stacked(w))


@pytest.fixture(scope="module")
def glue_edge_cases():
    """chip_smoke's [kernels] cases of K19-K21 (`glue_cases`): the final
    exponentiation of one value, of p - 1 in every word slot, zero and one,
    and of zero alone; the psi comparison of 19 and 128 signatures (G2
    points, points of E2 outside G2, infinity, a multiple of another point)
    with their verdicts; the Miller inputs of 1 and 128 sets with infinity
    lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c, pairing

    f = chip_smoke.fp12_inputs(fp, tower, P, 4, 45, "cuda")
    fe = {"final_exponentiation_n1": f[3:], "final_exponentiation_n3": f[:3], "final_exponentiation_zero": f[1:2]}
    return chip_smoke.glue_cases(torch, fp, curve, tower, pairing, api, h2c, P, fe,
                                 [chip_smoke.PSI_EDGE, chip_smoke.N_SETS],
                                 [*chip_smoke.MILLER_INPUTS_EDGE, chip_smoke.N_SETS], 46)


@pytest.mark.parametrize("kernel", ["final_exponentiation", "g2_psi_check", "miller_inputs"])
def test_final_exp_and_glue_kernels_match_plain_on_card(glue_edge_cases, kernel):
    """K19-K21 against their plain versions and the composition each
    replaced, bit for bit: one launch per call and no other kernel; K20's
    verdicts those its inputs must give."""
    cases, verdicts = glue_edge_cases
    cases = {name: case for name, case in cases.items() if name.startswith(kernel)}
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {kernel: len(cases)}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name
        if name in verdicts:
            assert got[name].tolist() == verdicts[name]


@pytest.fixture(scope="module")
def affine_edge_cases():
    """chip_smoke's [kernels] cases of K22-K25 (`affine_cases`): to_affine
    in G1 and G2 with Z = 0, Z = one and p - 1 in every word slot, the Fp2
    inversion with zero (inv0), the Fp6 product with an all p - 1 element
    and a broadcast operand, at counts that are and are not whole blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return chip_smoke.affine_cases(torch, fp, curve, tower, P, {
        "g1_to_affine": chip_smoke.AFFINE_COUNTS, "g2_to_affine": chip_smoke.AFFINE_COUNTS,
        "fp2_inv": chip_smoke.AFFINE_COUNTS, "fp6_mul": chip_smoke.FP6_COUNTS}, 48)


@pytest.mark.parametrize("kernel", ["g1_to_affine", "g2_to_affine", "fp6_mul", "fp2_inv"])
def test_affine_and_fp6_kernels_match_plain_on_card(affine_edge_cases, kernel):
    """K22-K25 against their plain versions and the composition each
    replaced, bit for bit: one launch per call and no other kernel."""
    cases = {name: case for name, case in affine_edge_cases.items() if name.startswith(kernel)}
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {kernel: len(cases)}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain(), composed()):
            assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want)), name


@pytest.fixture(scope="module")
def standalone_edge_cases():
    """chip_smoke's [kernels] cases of K26-K33 (`standalone_cases`): the
    additions with infinity, Z = one, p - 1 words, P == Q, P == -Q and a
    broadcast point; Karabina's squaring and decompression with the
    identity, the g2 = 0 branch and a zero denominator; fp12_inv and
    frobenius with p - 1, zero and one; the square-root candidate with 0,
    one, u and -1; the reduction at 0, 2 p 2^384 - 1, p^2 - 1 and p 2^384,
    at counts that are and are not whole blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return chip_smoke.standalone_cases(torch, fp, curve, tower, pairing, h2c, P, chip_smoke.STANDALONE_COUNTS,
                                       49)[0]


@pytest.mark.parametrize("kernel", sorted(chip_smoke.STANDALONE_COUNTS))
def test_standalone_kernels_match_plain_on_card(standalone_edge_cases, kernel):
    """K26-K33 against their plain versions and (but K33) the composition
    each replaced, bit for bit: one launch per call and no other kernel."""
    cases = {name: case for name, case in standalone_edge_cases.items()
             if name.rsplit("_n", 1)[0].replace("_broadcast", "") == kernel}
    fp.reset_launches()
    got = {name: run() for name, (_, run, _, _) in cases.items()}
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {kernel: len(cases)}
    for name, (_, _, plain, composed) in cases.items():
        for want in (plain, composed):
            if want is not None:
                assert torch.equal(chip_smoke._stacked(got[name]), chip_smoke._stacked(want())), name


def test_registry_walk_on_card(cuda_device):
    """chip_smoke's [registry]: every entry of the port's registry once on
    the card, launches as declared, "kernel" entries bit-identical to their
    plain versions, every kernel launched."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import registry

    launches = chip_smoke.run_registry(torch, fp, registry, cuda_device)
    assert all(launches[k] > 0 for k in fp.KERNELS)


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
    """With the flag, a direct Fp product (`fp.mul`) launches K6 and never
    K1; a verify, which has no direct product left since K19-K21, launches
    neither and keeps its verdicts."""
    monkeypatch.setattr(fp, "USE_MXU_MUL", True)
    a = _elements(47, 8, cuda_device)
    fp.reset_launches()
    assert torch.equal(fp.mul(a, a), fp.mul_plain(a, a))
    assert (fp.LAUNCHES["fp_mul"], fp.LAUNCHES["fp_mul_mma"]) == (0, 1)
    sets, bad = _small_batches()
    fp.reset_launches()
    assert api.verify_signature_sets(sets) is True
    assert fp.LAUNCHES["fp_mul"] == 0 and fp.LAUNCHES["fp_mul_mma"] == 0
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
    """With every direct Fp product on K6, the kernels with products of
    their own (K7 to K21) keep them, as the JAX package's flag reaches only
    direct Fp products: a verify launches exactly what it launches without
    the flag, VERIFY_LAUNCHES."""
    sets, _ = _small_batches()
    counts = {}
    for flag in (False, True):
        monkeypatch.setattr(fp, "USE_MXU_MUL", flag)
        fp.reset_launches()
        assert api.verify_signature_sets(sets) is True
        counts[flag] = dict(fp.LAUNCHES)
    assert counts[True] == counts[False] == VERIFY_LAUNCHES


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


@pytest.mark.parametrize("n", chip_smoke.K5_COUNTS)
def test_g1_subgroup_kernel_matches_plain_at_counts(cuda_device, n):
    """K5 (a quad of four lanes a key, eight keys a warp) at 1, 5, 6, 7, 8,
    9, 31 and 64 keys, partial warps among them: G1 points, the order-3
    point, points outside G1 and infinity rows, tiled."""
    rng = random.Random(34)
    order3 = ref.g1_from_compressed(b"\x80" + bytes(47), subgroup_check=False)
    pts = [g1_generator().mul(rng.randrange(1, R)) for _ in range(3)] + [order3] + _non_g1_points(2)
    pts += [g1_infinity()]
    x, y, inf = pack_g1_batch([pts[(5 * i) % len(pts)] for i in range(n)])
    xw, yw, infb = fp.from_jax_limbs(x)[:n], fp.from_jax_limbs(y)[:n], torch.from_numpy(inf)[:n]
    want = curve.g1_subgroup_check_plain(xw, yw, infb)
    fp.reset_launches()
    got = curve.g1_in_subgroup_kernel(xw.to(cuda_device), yw.to(cuda_device), infb.to(cuda_device))
    torch.cuda.synchronize()
    assert fp.LAUNCHES["g1_subgroup_check"] == 1
    assert got.cpu().tolist() == want.tolist()


def _k4_columns(name):
    src = (pathlib.Path(fp.__file__).parent / "csrc" / "fp_kernels.cu").read_text()
    return int(re.search(rf"constexpr long long {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("shape", [(1, 1), (33, 3), (257, 1), (257, 8), (9, _k4_columns("kWarpColumns") - 1),
                                   (9, _k4_columns("kWarpColumns")), (3, _k4_columns("kThreadColumns"))])
def test_batch_inv_kernel_matches_plain_at_shapes(cuda_device, shape):
    """K4 (32 threads a column below kWarpColumns columns, 8 below
    kThreadColumns, then one) against its plain version, with zeros at
    chunk edges and a column of zeros: one launch."""
    steps, lanes = shape
    a = _elements(35 + lanes, steps * lanes, cuda_device)[: steps * lanes]
    a = a.reshape(steps, lanes, fp.WORDS).contiguous()
    a[:: max(1, -(-steps // 32)), 0] = 0
    a[:, lanes // 2] = 0
    fp.reset_launches()
    got = fp.batch_inv(a)
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"fp_batch_inv": 1}
    assert torch.equal(got, fp.batch_inv_plain(a))


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
