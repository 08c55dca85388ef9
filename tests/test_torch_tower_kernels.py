"""The tower products K7 (`fp2_mul`, csrc/tower_kernels.cu) and K8
(`fp12_mul`) on the CPU.

1. Their plain versions against the JAX package's jitted tower.fp2_mul,
   fp2_sqr, fp12_mul, fp12_sqr and fp12_mul_sparse035, bit for bit: seeded
   inputs with the edge values 0, one and p - 1 in every word slot, leading
   batch dims (2, 3), a broadcast operand and an empty batch.
2. An emulation in Python integers of each kernel's lanes, in the kernels'
   order of operations: K7's two threads per element; K8's warp
   (tower.cuh `fp12_mul_pairs`, which K9, K18 and K19 run too): lane
   2 (2k + c) + half summing its half of component c of flat coefficient
   e_k, the pair's two double-width sums added (the shuffle) and reduced
   once by the even lane, lanes 24-31 repeating lanes 0-7 and storing
   nothing, in all three modes; tower.cuh's twelve-lane form (lane 2k + c
   forming component c, which K12 runs) equal to it for every (k, c); and
   the word-serial reduction (fp384.cuh `fp_redc_wide`). It checks the
   lazy-reduction bound of each double-width sum, a lane's half and the
   pair's whole (T < N p^2, every step of the reduction inside 24 words,
   fewer than SUBS + 1 multiples of p left) on all-(p - 1) inputs and on
   random ones, and the result against the plain versions.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu.crypto.bls.jax_backend import tower as jt
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as tt
from torch_parity import assert_same, to_port

_TOWER_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "tower.cuh").read_text()
# lanes 0 .. PAIR_LANES - 1 of a warp form K8's product (two a component)
PAIR_LANES = int(re.search(r"constexpr int kPairLanes = (\d+);", _TOWER_SRC).group(1))

rng = np.random.default_rng(0x75)


def _rand_ints(n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


# stored (Montgomery-form) values: 0, one, p - 1
EDGE_FP2 = [(0, 0), (tfp.R_MONT, 0), (P - 1, P - 1)]


def _fp2_limbs(lead, edges=True):
    """(*lead, 2, 32) JAX limbs: the edge Fp2 values first, then random."""
    n = int(np.prod(lead))
    pairs = (EDGE_FP2 if edges else [])[:n]
    flat = [x for pair in pairs for x in pair] + _rand_ints(2 * (n - len(pairs)))
    return jfp.ints_to_limbs(flat).reshape(*lead, 2, jfp.N_LIMBS)


def _fp12_limbs(lead):
    """(*lead, 2, 3, 2, 32) JAX limbs: p - 1 in every slot, zero and one
    first, then random."""
    x = _fp2_limbs((*lead, 6), edges=False).reshape(-1, 2, 3, 2, jfp.N_LIMBS)
    one = np.zeros((2, 3, 2, jfp.N_LIMBS), np.int32)
    one[0, 0, 0] = jfp.ONE_MONT
    for i, edge in enumerate([np.broadcast_to(jfp.int_to_limbs(P - 1), x.shape[1:]), 0, one][: len(x)]):
        x[i] = edge
    return x.reshape(*lead, 2, 3, 2, jfp.N_LIMBS)


A2, B2 = _fp2_limbs((2, 3)), _fp2_limbs((2, 3))[::-1].copy()
C2 = jfp.ints_to_limbs([P - 1, P - 1]).reshape(2, jfp.N_LIMBS)  # one element, broadcast
A12, B12 = _fp12_limbs((2, 3)), _fp12_limbs((2, 3))[::-1].copy()
EMPTY2, EMPTY12 = np.zeros((0, 2, jfp.N_LIMBS), np.int32), np.zeros((0, 2, 3, 2, jfp.N_LIMBS), np.int32)


def _k8(mode):
    if mode == tt.FP12_SPARSE:
        return lambda a, b0, b3, b5: tt.fp12_product_plain(a, (b0, b3, b5), mode)
    return lambda a, *b: tt.fp12_product_plain(a, b, mode)


# name -> (jax function, plain version, input arrays[, the JAX side's own,
# where it takes no broadcast operand])
CASES = {
    "fp2_mul": (jt.fp2_mul, tt.fp2_mul_plain, (A2, B2)),
    "fp2_mul_broadcast": (jt.fp2_mul, tt.fp2_mul_plain, (A2, C2)),
    "fp2_mul_empty": (jt.fp2_mul, tt.fp2_mul_plain, (EMPTY2, EMPTY2)),
    "fp2_sqr": (jt.fp2_sqr, tt.fp2_sqr_plain, (A2,)),
    "fp12_mul": (jt.fp12_mul, _k8(tt.FP12_FULL), (A12, B12)),
    "fp12_mul_broadcast": (jt.fp12_mul, _k8(tt.FP12_FULL), (A12, B12[1, 2])),
    "fp12_mul_empty": (jt.fp12_mul, _k8(tt.FP12_FULL), (EMPTY12, EMPTY12)),
    "fp12_sqr": (jt.fp12_sqr, _k8(tt.FP12_SQUARE), (A12,)),
    "fp12_mul_sparse035": (
        jt.fp12_mul_sparse035, _k8(tt.FP12_SPARSE), (A12, B2, A2, C2), (A12, B2, A2, np.broadcast_to(C2, A2.shape)),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax(name):
    jfn, plain, args, *jax_args = CASES[name]
    want = np.asarray(jax.jit(jfn)(*(jnp.asarray(a) for a in (jax_args[0] if jax_args else args))))
    got = plain(*(to_port(a) for a in args))
    assert_same(got, want)


# -- the kernels' threads in Python integers --------------------------------------

MASK32 = (1 << 32) - 1
P_INV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)
WIDE = 1 << 768


def redc_wide(t: int, n_products: int, subs: int) -> int:
    """fp_redc_wide<subs> word for word, for T a sum of n_products
    canonical products, with the bound of its header checked."""
    assert 0 <= t < n_products * P * P, "T is not below N p^2"
    assert n_products <= (9 if subs == 1 else 19), "N is past what SUBS subtractions cover"
    for i in range(12):
        m = ((t >> (32 * i)) & MASK32) * P_INV32 & MASK32
        t += (m * P) << (32 * i)
        assert t < WIDE, "the reduction carried out of 24 words"
    assert t & ((1 << 384) - 1) == 0
    u = t >> 384
    assert u < (subs + 1) * P, "more multiples of p left than SUBS subtractions remove"
    for _ in range(subs):
        u = u - P if u >= P else u
    return u


def k7_thread(a, b, lane: int, op: int) -> int:
    """Output component `lane` of one Fp2 element, as fp2_mul_kernel forms
    it: mul c0 = a0 b0 + (-a1) b1, c1 = a0 b1 + a1 b0; sqr
    c0 = (a0 + a1)(a0 - a1), c1 = (a0 + a0) a1."""
    if op == tt.FP2_MUL:
        u = a[1] if lane else (P - a[1]) % P
        v0, v1 = (b[1], b[0]) if lane else (b[0], b[1])
        terms = [(a[0], v0), (u, v1)]
    else:
        x = (a[0] + (a[0] if lane else a[1])) % P
        y = a[1] if lane else (a[0] - a[1]) % P
        terms = [(x, y)]
    t = 0
    for x, y in terms:
        assert 0 <= x < P and 0 <= y < P
        t += x * y
    return redc_wide(t, len(terms), subs=1)


def lane_terms(a, b, k: int, c: int, mode: int, q0: int, q1: int):
    """tower.cuh `fp12_lane_terms`: terms q0 <= q < q1 of component c of
    flat coefficient e_k, in the routine's order: term q takes b_j (j = q,
    or 0, 3, 5 in kSparse mode) and a_i, i = (k - j) mod 6, folded by xi
    where j > k (x0 - x1 and x0 + x1 both formed, one selected), then
    `fp2_component_mac`: u = x1 (c = 1) or -x1, t += x0 (y1 or y0) +
    u (y0 or y1). `b` is flat (kFull), ignored (kSquare: a), or the three
    Fp2 of the line (kSparse). Returns the double-width sum and its count
    of products, the bound T < N p^2 asserted."""
    positions = (0, 3, 5) if mode == tt.FP12_SPARSE else range(6)
    t = 0
    for q in range(q0, q1):
        j = positions[q]
        x0, x1 = a[(k - j) % 6]
        d, s = (x0 - x1) % P, (x0 + x1) % P
        if j > k:
            x0, x1 = d, s
        y0, y1 = b[q] if mode == tt.FP12_SPARSE else (a if mode == tt.FP12_SQUARE else b)[j]
        u = x1 if c else (P - x1) % P
        t += x0 * (y1 if c else y0)
        t += u * (y0 if c else y1)
    n = 2 * (q1 - q0)
    assert t < n * P * P
    return t, n


def fp12_lane(a, b, k: int, c: int, mode: int) -> int:
    """csrc/tower.cuh `fp12_mul_lane`: lane 2k + c of a twelve-lane group,
    component c of flat coefficient e_k, all its terms in one double-width
    sum (`lane_terms`), one reduction."""
    t, n = lane_terms(a, b, k, c, mode, 0, 3 if mode == tt.FP12_SPARSE else 6)
    return redc_wide(t, n, subs=2)


def k8_warp(a, b, mode: int):
    """csrc/tower.cuh `fp12_mul_pairs` on one warp, lane by lane: lane l
    takes component (l mod PAIR_LANES) // 2 = 2k + c and half l % 2, sums
    terms 3 half .. 3 half + 2 (kSparse: 0 and 1, or 2) with `lane_terms`,
    adds its partner's (lane l ^ 1) sum, the shuffle, and reduces once
    (N = 12, or 6 in kSparse mode, two subtractions); the even lanes below
    PAIR_LANES store, each component once, lanes past it store nothing.
    Arguments as `lane_terms`; returns the flat list of six Fp2."""
    sparse = mode == tt.FP12_SPARSE
    sums = []
    for lane in range(32):
        comp, half = (lane % PAIR_LANES) >> 1, lane & 1
        q0 = 2 * half if sparse else 3 * half
        sums.append((comp, half, lane_terms(a, b, comp >> 1, comp & 1, mode, q0, 2 + half if sparse else q0 + 3)))
    out = {}
    for lane, (comp, half, (t, n)) in enumerate(sums):
        other_comp, _, (t1, n1) = sums[lane ^ 1]
        assert other_comp == comp, "a pair's lanes form one component"
        r = redc_wide(t + t1, n + n1, subs=2)
        if lane < PAIR_LANES and half == 0:
            assert comp not in out, f"component {comp} stored twice"
            out[comp] = r
    assert sorted(out) == list(range(12))
    return [(out[2 * k], out[2 * k + 1]) for k in range(6)]


def _ints(words: torch.Tensor):
    return [tfp.words_to_int(w) for w in words.reshape(-1, tfp.WORDS)]


def _fp2_words(pairs):
    return torch.from_numpy(tfp.ints_to_words([x for pair in pairs for x in pair])).reshape(-1, 2, tfp.WORDS)


ALL_P_MINUS_1 = [(P - 1, P - 1)] * 6
EMU_FP2 = EDGE_FP2 + [(0, tfp.R_MONT)] + [tuple(_rand_ints(2)) for _ in range(4)]  # ... u, random


@pytest.mark.parametrize("op", [tt.FP2_MUL, tt.FP2_SQR], ids=["mul", "sqr"])
def test_k7_thread_split_matches_plain(op):
    a = EMU_FP2
    b = EMU_FP2[1:] + EMU_FP2[:1]
    got = [[k7_thread(x, y, lane, op) for lane in (0, 1)] for x, y in zip(a, b)]
    aw, bw = _fp2_words(a), _fp2_words(b)
    want = tt.fp2_mul_plain(aw, bw) if op == tt.FP2_MUL else tt.fp2_sqr_plain(aw)
    assert [x for pair in got for x in pair] == _ints(want)


MODES = [tt.FP12_FULL, tt.FP12_SQUARE, tt.FP12_SPARSE]
POSITIONS = {tt.FP12_FULL: range(6), tt.FP12_SQUARE: range(6), tt.FP12_SPARSE: (0, 3, 5)}


def _k8_operand(b, mode):
    """The b argument of the lane models: flat (full), ignored (square),
    the line's three Fp2 (sparse)."""
    return [b[j] for j in POSITIONS[mode]] if mode == tt.FP12_SPARSE else b


@pytest.mark.parametrize("mode", MODES, ids=["full", "square", "sparse"])
def test_k8_thread_formula_matches_plain(mode):
    """K8's warp (`k8_warp`, tower.cuh `fp12_mul_pairs`) on all-(p - 1),
    random and edge elements, each against each, equals the plain version
    in every mode."""
    elements = [ALL_P_MINUS_1, [tuple(_rand_ints(2)) for _ in range(6)], EMU_FP2[:6]]
    for a in elements:
        for b in elements:
            got = [x for pair in k8_warp(a, _k8_operand(b, mode), mode) for x in pair]
            aw = tt._from_flat(_fp2_words(a))
            if mode == tt.FP12_SPARSE:
                bs = tuple(_fp2_words([b[j]])[0] for j in POSITIONS[mode])
            else:
                bs = () if mode == tt.FP12_SQUARE else (tt._from_flat(_fp2_words(b)),)
            want = tt._to_flat(tt.fp12_product_plain(aw, bs, mode))
            assert got == _ints(want)


@pytest.mark.parametrize("mode", MODES, ids=["full", "square", "sparse"])
def test_fp12_lane_matches_k8_thread(mode):
    """`fp12_mul_lane` (K12's twelve lanes, a component's terms in one sum)
    forms, for every (k, c), the words that K8's warp forms (the terms
    split over a lane pair, the two sums added before the one reduction):
    one lazy sum per component either way. All-(p - 1), random and edge
    elements, each against each."""
    elements = [ALL_P_MINUS_1, [tuple(_rand_ints(2)) for _ in range(6)], EMU_FP2[:6]]
    for a in elements:
        for b in elements:
            bm = _k8_operand(b, mode)
            warp = k8_warp(a, bm, mode)
            for k in range(6):
                for c in (0, 1):
                    assert fp12_lane(a, bm, k, c, mode) == warp[k][c], (k, c)


def test_k8_warp_lanes_read_from_the_source():
    """The warp's layout as tower.cuh states it: 24 lanes, the sparse
    terms split 2 + 1, lanes past the 24 storing nothing."""
    assert PAIR_LANES == 24
    body = _TOWER_SRC[_TOWER_SRC.index("void fp12_mul_pairs("):]
    assert "const int q0 = mode == kSparse ? 2 * half : 3 * half;" in body
    assert "mode == kSparse ? 2 + half : q0 + 3" in body
    assert "if (lane < kPairLanes && half == 0)" in body


def test_all_p_minus_1_sums_stay_under_the_bound():
    """The largest sums the kernels form: every operand p - 1 (or the
    xi-folded p - 2 and 0). Each sum is below N p^2 and reduces into
    [0, (SUBS + 1) p); the K8 full-mode sum is the largest, N = 12, a
    lane's half N = 6 (sparse: 4 and 2); K9's split Fp2 product halves N
    = 1, their pair's sum doubled N = 4, its squares N = 1."""
    a = (P - 1, P - 1)
    assert k7_thread(a, a, 0, tt.FP2_MUL) < P and k7_thread(a, a, 1, tt.FP2_SQR) < P
    for mode in MODES:
        for k in range(6):
            for c in (0, 1):
                for q0, q1 in ((0, 3), (3, 6)) if mode != tt.FP12_SPARSE else ((0, 2), (2, 3)):
                    lane_terms(ALL_P_MINUS_1, _k8_operand(ALL_P_MINUS_1, mode), k, c, mode, q0, q1)
        assert all(x < P for pair in k8_warp(ALL_P_MINUS_1, _k8_operand(ALL_P_MINUS_1, mode), mode) for x in pair)
    m = P - 1
    assert redc_wide(2 * (m * m + m * m), 4, 1) < P  # K9: a doubled pair sum
    assert redc_wide(m * m, 1, 1) < P  # K9: a square's component
    assert 12 * P * P < WIDE >> 2  # headroom: T + m p stays in 24 words
