"""fp384.cuh `fp_inv` on the CPU: the inversion every kernel of the port
calls, a constant-iteration binary GCD (Pornin, IACR ePrint 2020/972,
Algorithm 2; 26 batches of 30 divsteps).

The kernel runs only on the card, so `fp_inv_replay` replays it in Python
integers, word for word: the 32-bit words of a, b, u and v; the bit
length of a | b and the 32-bit window at n - 32 (n = max(len a, len b,
62)); the two-word approximations and the branch-free divsteps with int32
factors; the signed linear combination shifted by 30 and its negation; the
Montgomery word step of the u, v update; the closing product by FP_INV_C;
the zero branch. The header's constants are read from fp384.cuh.

Each case asserts that the fixed batch count suffices (a = 0, b = 1 at the
end; b = p for zero), that every factor fits in int32 (|f|, |g| <= 2^30,
and |f| + |g| <= 2^30 per row, the bound the combination's 64-bit words
rely on), that each combination is divisible by 2^30, and that the result
is the Fermat power pow(x, p - 2, p); on Montgomery inputs it is held to
the port's plain `fp.inv` (the Fermat chain over K1's plain product).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp

M32 = (1 << 32) - 1
W = tfp.WORDS
R_MONT = (1 << 384) % P
R_INV = pow(1 << 384, -1, P)

_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "fp384.cuh").read_text()
STEPS = int(re.search(r"#define FP_INV_STEPS (\d+)", _SRC).group(1))
BATCHES = int(re.search(r"#define FP_INV_BATCHES (\d+)", _SRC).group(1))
_C_WORDS = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", re.search(
    r"FP_INV_C\[FP_WORDS\] = \{(.*?)\};", _SRC, re.S).group(1))]
FP_INV_C = sum(w << (32 * i) for i, w in enumerate(_C_WORDS))
FP_PINV = tfp.P_INV32
# 32 x 32 -> 64-bit word products the replay has made, as the kernel makes them
WORD_PRODUCTS = [0]


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & M32 for i in range(W)]


def _val(w) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


def _bit_length(a, b) -> int:
    """`fp_inv_bit_length`: 32 i + 32 - clz of the top nonzero word of a | b."""
    n = 0
    for i in range(W):
        w = a[i] | b[i]
        n = 32 * i + w.bit_length() if w else n
    return n


def _window(x, s: int) -> int:
    """`fp_inv_window`: __funnelshift_r(x[w], x[w + 1], s & 31), w = s / 32."""
    w = s >> 5
    lo = x[w]
    hi = x[w + 1] if w + 1 < W else 0
    return ((hi << 32 | lo) >> (s & 31)) & M32


def _combine(a, b, f: int, g: int):
    """`fp_inv_combine`: (a f + b g) / 2^30 as its magnitude, and its sign."""
    t, c = [], 0
    for i in range(W):
        c += a[i] * f + b[i] * g
        WORD_PRODUCTS[0] += 2
        assert -(1 << 63) <= c < (1 << 63)  # int64
        t.append(c & M32)
        c >>= 32  # arithmetic
    assert t[0] & ((1 << STEPS) - 1) == 0, "the combination is not divisible by 2^30"
    top = c & M32
    r = [((t[i + 1] << 32 | t[i]) >> STEPS) & M32 for i in range(W - 1)]
    r.append(((top << 32 | t[W - 1]) >> STEPS) & M32)
    neg = c < 0
    if neg:  # 0 - r word by word, with the borrow
        borrow, out = 0, []
        for x in r:
            s = (0 - x - borrow) % (1 << 64)
            out.append(s & M32)
            borrow = (s >> 32) & 1
        r = out
    assert _val(r) < 1 << 381
    return r, neg


def _neg_mod(u):
    """fp384.cuh `fp_neg`: p - u, 0 stays 0."""
    return _words((P - _val(u)) % P)


def _update(u, v, f: int, g: int):
    """`fp_inv_update`: (u f + v g) 2^-32 mod p, a negative factor taking
    the negated operand, one Montgomery word step, one subtraction."""
    x = _neg_mod(u) if f < 0 else u
    y = _neg_mod(v) if g < 0 else v
    fa, ga = abs(f), abs(g)
    t, c = [], 0
    for i in range(W):
        c += x[i] * fa + y[i] * ga
        WORD_PRODUCTS[0] += 2
        assert c < 1 << 64
        t.append(c & M32)
        c >>= 32
    t.append(c)
    assert _val(t) < (1 << STEPS) * P
    m = (t[0] * FP_PINV) & M32
    p = _words(P)
    c = (m * p[0] + t[0]) >> 32
    WORD_PRODUCTS[0] += 2
    out = []
    for i in range(1, W):
        c += m * p[i] + t[i]
        WORD_PRODUCTS[0] += 1
        assert c < 1 << 64
        out.append(c & M32)
        c >>= 32
    out.append((c + t[W]) & M32)
    assert c + t[W] < 1 << 32
    r = _val(out)
    assert r == (_val(t) + m * P) >> 32 and r < P + P // 4
    return _words(r - P if r >= P else r)


def fp_inv_replay(x: int):
    """fp384.cuh `fp_inv` on the Montgomery words of x: returns (the
    result, the state after the last batch: a, b, v, the largest factor
    and the largest row sum |f| + |g| seen)."""
    a, b, u, v = _words(x), _words(P), _words(1), _words(0)
    low = (1 << STEPS) - 1
    big = row = 0
    for _ in range(BATCHES):
        n = max(_bit_length(a, b), 2 * STEPS + 2)
        ah = (_window(a, n - 32) << STEPS) | (a[0] & low)
        bh = (_window(b, n - 32) << STEPS) | (b[0] & low)
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(STEPS):
            odd = ah & 1
            swap = odd and ah < bh
            a1, b1 = (bh, ah) if swap else (ah, bh)
            f0s, g0s, f1s, g1s = (f1, g1, f0, g0) if swap else (f0, g0, f1, g1)
            ah = ((a1 - b1) if odd else a1) >> 1
            bh = b1
            f0, g0 = (f0s - f1s, g0s - g1s) if odd else (f0s, g0s)
            f1, g1 = 2 * f1s, 2 * g1s
            assert 0 <= ah < 1 << 62 and 0 <= bh < 1 << 62  # two words each
        big = max(big, *(abs(q) for q in (f0, g0, f1, g1)))
        row = max(row, abs(f0) + abs(g0), abs(f1) + abs(g1))
        na, neg_a = _combine(a, b, f0, g0)
        nb, neg_b = _combine(a, b, f1, g1)
        if neg_a:
            f0, g0 = -f0, -g0
        if neg_b:
            f1, g1 = -f1, -g1
        u, v = _update(u, v, f0, g0), _update(u, v, f1, g1)
        a, b = na, nb
    out = _val(v) * FP_INV_C * R_INV % P  # fp_mul(v, FP_INV_C)
    return (0 if x == 0 else out), {"a": _val(a), "b": _val(b), "v": _val(v), "factor": big, "row": row}


def fp_inv_model(x: int) -> int:
    """The kernels' `fp_inv` on a Montgomery value, for the kernel models."""
    return fp_inv_replay(x)[0]


def _check(x: int) -> None:
    got, st = fp_inv_replay(x)
    assert st["a"] == 0 and st["b"] == (P if x == 0 else 1), "the batches did not suffice"
    assert st["factor"] <= 1 << STEPS and st["row"] <= 1 << STEPS  # int32, and the combination's bound
    # v = x^-1 2^(steps - 32 batches): the plain inverse, and the Montgomery one
    inv = st["v"] * pow(2, 32 * BATCHES - STEPS * BATCHES, P) % P
    assert inv == pow(x, P - 2, P)
    assert got == pow(x * R_INV % P, P - 2, P) * R_MONT % P


_KS = (1, 2, 29, 30, 31, 32, 33, 61, 62, 63, 64, 65, 127, 128, 191, 192, 255, 256, 319, 320, 352, 379, 380)
EDGE_CASES = {"0": 0, "1": 1, "2": 2, "p-1": P - 1, "p-2": P - 2, "R": R_MONT, "R-1": R_MONT - 1}
EDGE_CASES.update({f"2^{k}{s:+d}": (1 << k) + s for k in _KS for s in (-1, 1)})
EDGE_CASES.update({f"p-2^{k}": P - (1 << k) for k in _KS})
EDGE_CASES.update({f"2^{k}": 1 << k for k in _KS[::4]})

_rng = np.random.default_rng(0x1A7)
_CHUNKS, _PER_CHUNK = 8, 256
SEEDED = [tfp.words_to_int(w) for w in _rng.integers(0, 1 << 32, size=(_CHUNKS * _PER_CHUNK, W), dtype=np.uint64)]
SEEDED = [x % P for x in SEEDED]


def test_header_batches_suffice_in_theory():
    """30-step batches keep the factors in int32; 26 of them give 780
    divsteps, at least 2 x 381 - 1; FP_INV_C is 2^(1152 + 32 x 26 - 780)."""
    assert (STEPS, BATCHES) == (30, 26)
    assert STEPS * BATCHES >= 2 * P.bit_length() - 1
    assert FP_INV_C == pow(2, 3 * 384 + 32 * BATCHES - STEPS * BATCHES, P)


@pytest.mark.parametrize("x", list(EDGE_CASES.values()), ids=list(EDGE_CASES))
def test_replay_edge_case(x):
    """0, 1, 2, p - 1, p - 2, R mod p, 2^k +- 1, 2^k and p - 2^k around
    the word and approximation boundaries (30, 32, 62, 64 bits)."""
    _check(x)


@pytest.mark.parametrize("chunk", range(_CHUNKS))
def test_replay_seeded(chunk):
    """2,048 values seeded with numpy, 256 a case."""
    for x in SEEDED[chunk * _PER_CHUNK : (chunk + 1) * _PER_CHUNK]:
        _check(x)


@pytest.mark.parametrize("which", ["edge", "seeded"])
def test_replay_matches_plain_inv_on_montgomery_inputs(which):
    """The replay's words against the port's plain `fp.inv` (K3's Fermat
    chain over K1's plain product) on the same Montgomery words."""
    xs = list(EDGE_CASES.values()) if which == "edge" else SEEDED[:256]
    got = [fp_inv_model(x) for x in xs]
    plain = tfp.inv(torch.from_numpy(tfp.ints_to_words(xs)))
    assert got == [tfp.words_to_int(w) for w in plain]


def test_bound_counts_the_gcds_word_products():
    """chip_smoke.py's operations bound counts an inversion in a kernel as
    the word products the replay makes (the combinations, the updates with
    their Montgomery word step), plus the closing Montgomery product."""
    import chip_smoke

    WORD_PRODUCTS[0] = 0
    fp_inv_replay(SEEDED[0])
    assert chip_smoke.FP_INV_BATCHES == BATCHES
    assert chip_smoke.inversion_word_products() == WORD_PRODUCTS[0] + chip_smoke.WORD_PRODUCTS_PER_MUL


_CSRC = pathlib.Path(tfp.__file__).parent / "csrc"


def _section(source: str, title: str) -> str:
    """The comment block of `source` from the line `// {title}` to the next
    kernel's title (or the block's end), as one line of text."""
    text, on = [], False
    for line in (_CSRC / source).read_text().splitlines():
        line = line.strip()
        if not line.startswith("//"):
            if on:
                break
            continue
        body = line[2:].strip()
        if on and re.match(r"K\d+ \w+_kernel", body):
            break
        on = on or body.startswith(title)
        if on:
            text.append(body)
    assert text, f"no header {title!r} in {source}"
    return " ".join(text)


def _header_totals():
    """kernel -> (source, title, a pattern whose groups are the header's
    stated word products, chip_smoke.py's counts of them)."""
    import chip_smoke as c

    inv, mul = c.inversion_word_products(), c.WORD_PRODUCTS_PER_MUL
    aff = c.affine_word_products()
    return {
        "K3": ("fp_kernels.cu", "K3 fp_pow_kernel", r"the power p - 2, .*? needs ([\d,]+) word products per element",
               [c.power_word_products(P - 2, mul, c.WORD_PRODUCTS_PER_SQR)]),
        "K4": ("fp_kernels.cu", "K4 fp_batch_inv_kernel",
               r"binary GCD, ([\d,]+) word products\) per lane, .*?: ([\d,]+) word products a lane at N = (\d+)",
               [inv, c.batch_inv_word_products(257), 257]),
        "K9": ("final_exp_kernels.cu", "K9 cyclotomic_pow_x_kernel",
               r"the shared inversion, 15 products and fp384.cuh's binary GCD \(([\d,]+)\), ([\d,]+); "
               r"the product of six [\d,]+: ([\d,]+),",
               [inv, 15 * mul + inv, c.K9_WORD_PRODUCTS_BUT_POWER + inv]),
        "K19": ("final_exponentiation_kernels.cu", "K19 final_exponentiation_kernel",
                r"five K9 chains of ([\d,]+);.*?the Fp2 inversion, ([\d,]+) \(its norm 312, fp384.cuh's binary GCD "
                r"([\d,]+), two products\); the product by M\^-1, six Fp2 products: ([\d,]+),",
                [c.K9_WORD_PRODUCTS_BUT_POWER + inv, c.fp2_inv_word_products(), inv, c.k19_word_products()]),
        "K30": ("final_exponentiation_kernels.cu", "K30 fp12_inv_kernel",
                r"the Fp2 inversion \(([\d,]+)\) and six Fp2 products, ([\d,]+),",
                [c.fp2_inv_word_products(), c.standalone_word_products(P)["fp12_inv"]]),
        "K22/K23": ("affine_kernels.cu", "K22 g1_to_affine_kernel",
                    r"the inversion, fp384.cuh's binary GCD, ([\d,]+)\): G1 ([\d,]+), G2 ([\d,]+) ",
                    [inv, aff["g1_to_affine"], aff["g2_to_affine"]]),
        "K25": ("affine_kernels.cu", "K25 fp2_inv_kernel",
                r"Work per element: ([\d,]+) word products .*?binary GCD ([\d,]+), two Fp products\)",
                [aff["fp2_inv"], inv]),
        "K29": ("standalone_kernels.cu", "K29 karabina_decompress_kernel",
                r"the inversion \(fp384.cuh's binary GCD, ([\d,]+)\) and two Fp products: ([\d,]+) or ([\d,]+),",
                [inv, c.decompress_word_products(True), c.decompress_word_products(False)]),
    }


@pytest.mark.parametrize("kernel", ["K3", "K4", "K9", "K19", "K30", "K22/K23", "K25", "K29"])
def test_inverting_kernel_headers_state_the_bound(kernel):
    """Each inverting kernel's header states the word products that
    chip_smoke.py's bound counts: an inversion as the binary GCD's (the
    replay's count above), K3's power p - 2 on the cheaper of its two
    schedules, and each total built on them."""
    source, title, pattern, want = _header_totals()[kernel]
    m = re.search(pattern, _section(source, title))
    assert m, f"{kernel}: the header does not state its totals as {pattern!r}"
    assert [int(g.replace(",", "")) for g in m.groups()] == want
