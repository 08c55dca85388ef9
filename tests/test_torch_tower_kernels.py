"""The tower products K7 (`fp2_mul`, csrc/tower_kernels.cu) and K8
(`fp12_mul`) on the CPU.

1. Their plain versions against the JAX package's jitted tower.fp2_mul,
   fp2_sqr, fp12_mul, fp12_sqr and fp12_mul_sparse035, bit for bit: seeded
   inputs with the edge values 0, one and p - 1 in every word slot, leading
   batch dims (2, 3), a broadcast operand and an empty batch.
2. An emulation in Python integers of each kernel thread, in the kernels'
   order of operations: K7's two threads per element, K8's thread k
   forming flat coefficient e_k (and tower.cuh's twelve-lane form, lane
   2k + c forming component c, which K12 runs, equal to it for every
   (k, c)), and the word-serial reduction (fp384.cuh `fp_redc_wide`). It checks the lazy-reduction bound of each
   double-width sum (T < N p^2, every step of the reduction inside 24
   words, fewer than SUBS + 1 multiples of p left) on all-(p - 1) inputs
   and on random ones, and the result against the plain versions.
"""

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


def k8_thread(a, b, k: int, comp: int, positions) -> int:
    """Component `comp` of flat coefficient e_k, as thread k of
    fp12_mul_kernel forms it: over j in `positions`, i = (k - j) mod 6,
    a_i times xi when j > k, each Fp2 product split as in K7's mul."""
    t, n = 0, 0
    for j in positions:
        x0, x1 = a[(k - j) % 6]
        if j > k:  # w^6 = xi = 1 + u
            x0, x1 = (x0 - x1) % P, (x0 + x1) % P
        y0, y1 = b[j]
        u = x1 if comp else (P - x1) % P
        v0, v1 = (y1, y0) if comp else (y0, y1)
        t += x0 * v0 + u * v1
        n += 2
        assert t < n * P * P
    return redc_wide(t, n, subs=2)


def fp12_lane(a, b, k: int, c: int, mode: int) -> int:
    """csrc/tower.cuh `fp12_mul_lane`: lane 2k + c of a twelve-lane group,
    component c of flat coefficient e_k, in the routine's order: per term
    j (i = (k - j) mod 6) a_i, folded by xi where j > k (x0 - x1 and
    x0 + x1 both formed, one selected), then `fp2_component_mac`: u = x1
    (c = 1) or -x1, t += x0 (y1 or y0) + u (y0 or y1); one reduction of
    the double-width sum, its bound asserted. `b` is flat (kFull), ignored
    (kSquare: a), or the three Fp2 of the line (kSparse)."""
    positions = (0, 3, 5) if mode == tt.FP12_SPARSE else range(6)
    t = 0
    for q, j in enumerate(positions):
        x0, x1 = a[(k - j) % 6]
        d, s = (x0 - x1) % P, (x0 + x1) % P
        if j > k:
            x0, x1 = d, s
        y0, y1 = b[q] if mode == tt.FP12_SPARSE else (a if mode == tt.FP12_SQUARE else b)[j]
        u = x1 if c else (P - x1) % P
        t += x0 * (y1 if c else y0)
        t += u * (y0 if c else y1)
    return redc_wide(t, 2 * len(positions), subs=2)


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


@pytest.mark.parametrize("mode", [tt.FP12_FULL, tt.FP12_SQUARE, tt.FP12_SPARSE], ids=["full", "square", "sparse"])
def test_k8_thread_formula_matches_plain(mode):
    elements = [ALL_P_MINUS_1, [tuple(_rand_ints(2)) for _ in range(6)], EMU_FP2[:6]]
    for a in elements:
        for b in elements:
            b_flat = a if mode == tt.FP12_SQUARE else b
            positions = (0, 3, 5) if mode == tt.FP12_SPARSE else range(6)
            got = [k8_thread(a, b_flat, k, comp, positions) for k in range(6) for comp in (0, 1)]
            aw = tt._from_flat(_fp2_words(a))
            if mode == tt.FP12_SPARSE:
                bs = tuple(_fp2_words([b[j]])[0] for j in positions)
            else:
                bs = () if mode == tt.FP12_SQUARE else (tt._from_flat(_fp2_words(b)),)
            want = tt._to_flat(tt.fp12_product_plain(aw, bs, mode))
            assert got == _ints(want)


@pytest.mark.parametrize("mode", [tt.FP12_FULL, tt.FP12_SQUARE, tt.FP12_SPARSE], ids=["full", "square", "sparse"])
def test_fp12_lane_matches_k8_thread(mode):
    """`fp12_mul_lane` (K12's twelve lanes) forms, for every (k, c), the
    words that `fp12_mul_thread` (K8's six threads, both components on one
    thread) forms: one lazy sum per component either way. All-(p - 1),
    random and edge elements, each against each."""
    elements = [ALL_P_MINUS_1, [tuple(_rand_ints(2)) for _ in range(6)], EMU_FP2[:6]]
    positions = (0, 3, 5) if mode == tt.FP12_SPARSE else range(6)
    for a in elements:
        for b in elements:
            line = [b[j] for j in positions]
            for k in range(6):
                for c in (0, 1):
                    got = fp12_lane(a, line if mode == tt.FP12_SPARSE else b, k, c, mode)
                    assert got == k8_thread(a, a if mode == tt.FP12_SQUARE else b, k, c, positions), (k, c)


def test_all_p_minus_1_sums_stay_under_the_bound():
    """The largest sums the kernels form: every operand p - 1 (or the
    xi-folded p - 2 and 0). Each sum is below N p^2 and reduces into
    [0, (SUBS + 1) p); the K8 full-mode sum is the largest, N = 12."""
    a = (P - 1, P - 1)
    assert k7_thread(a, a, 0, tt.FP2_MUL) < P and k7_thread(a, a, 1, tt.FP2_SQR) < P
    for k in range(6):
        for comp in (0, 1):
            assert k8_thread(ALL_P_MINUS_1, ALL_P_MINUS_1, k, comp, range(6)) < P
    assert 12 * P * P < WIDE >> 2  # headroom: T + m p stays in 24 words
