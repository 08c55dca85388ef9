"""K10 `g1_scalar_mul` (csrc/curve_kernels.cu) on the CPU, as the kernel
runs it: one warp a block, an element a block on a lane group of six
(lanes 6-31 idle), on curve.cuh's lane-group law over Fp (C = 1).

`curve.scalar_mul_bits(FP, ...)` is dispatched as if on the card and its
one launch recorded. A model of the kernel in Python integers then runs the
launch's grid over the launch's own arguments: it reads the operands
through their addresses (the points at their element strides, bit row e
at byte (e / inner) hi + (e % inner) lo, a byte a bit `step` apart; a read
outside the operands fails), runs each block's lane group on a model of
`lane_step<1>` that reads curve.cuh's step table `kLane`
from the source (test_torch_fold_cofactor_kernels `_lane_table`; every
step's reads asserted to lie in the bank it may read), and writes X, Y, Z
as n contiguous coordinates each. The output is held word for word to
`curve.scalar_mul_bits_plain(FP_PLAIN, ...)` and to the one-thread
schedule `scalar_mul_thread` (test_torch_curve_final_exp_kernels, g1.cuh's
formulas with its products by 3b as Montgomery products of G1_B3): widths
64 and 127, the scalars 0, 2^w - 1, 1, 5 and a seeded random one, int32
and int64 bits, points with infinity rows and Z != 1, counts of one, two
and three elements, one point broadcast over the batch and bit rows
broadcast over it.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from test_torch_curve_final_exp_kernels import _G1, _bits, _mmul, _points, _scalar, scalar_mul_thread
from test_torch_fold_cofactor_kernels import LANE_STEPS, LANE_ZERO, window_digit
from test_torch_scalar_mul_lanes import Operands

W = tfp.WORDS  # words of a G1 coordinate
R_MONT = (1 << 384) % P
_BANK_A, _BANK_B, _OPERANDS = set(range(6, 12)), set(range(12, 18)), set(range(6))


def lane_step(st, r, p, q, s):
    """curve.cuh `lane_step<1>` on the six lanes of a G1 group: lane k forms
    output k of the step's table row, a product as one Montgomery product
    (fp_mul), a middle value as H +- m y with y = 12 v by additions where
    the row sets 3b. Every lane reads before any lane writes (__syncwarp),
    which the kernel gets from its banks: a step reads only slots it does
    not write, as asserted."""
    _, rows = LANE_STEPS[st]
    kind = st % 4
    reads = {0: _OPERANDS, 1: _BANK_A, 2: _BANK_B, 3: _BANK_A}[kind] | {LANE_ZERO}

    def slot(i):
        return p[i] if i < 3 else q[i - 3] if i < 6 else s[i - 6]

    out = {}
    for k, (a, b, x, y, b3, neg, m) in enumerate(rows):
        assert ({a, y} if kind == 3 else {a, b, x, y}) <= reads, (st, k)
        if kind in (0, 2):  # lane_product: (xa + xb)(ya + yb), sums on level 1 only
            u, w = slot(a), slot(x)
            if kind == 0:
                u, w = (u + slot(b)) % P, (w + slot(y)) % P
            out[k] = _mmul(u, w)
            continue
        h = slot(y)
        if kind == 1:  # lane_lin<true>: v = E - F - G, y = 12 v (3b) or v
            v = (slot(a) - slot(b) - slot(x)) % P
            yv = 12 * v % P if b3 else v
            assert m in (1, 3, 8)
        else:  # lane_lin<false>: y = E
            yv = slot(a)
            assert m in (1, 2) and not b3
        out[k] = (h - m * yv) % P if neg else (h + m * yv) % P
    for k, v in out.items():
        if kind == 3:
            r[k] = v
        else:
            s[(6 if kind == 1 else 0) + k] = v


def lanes_add(r, p, q, s):
    for st in range(4):
        lane_step(st, r, p, q, s)


def lanes_dbl(r, p, s):
    for st in range(4, 8):
        lane_step(st, r, p, p, s)


def scalar_mul_lanes(tab, acc, s, row, nbits, step):
    """curve.cuh `scalar_mul_lanes<1>` on a lane group: tab[1] holds the
    base, `row` the bits (bytes, `step` apart). Row 2k + 2 before row
    2k + 1 in each table step; 4-bit digits MSB first, zero-padded at the
    MSB end."""
    tab[0][:] = [0, R_MONT, 0]
    acc[:] = [0, R_MONT, 0]
    for k in range(8):
        if 2 * k + 2 < 16:
            lanes_add(tab[2 * k + 2], tab[k + 1], tab[k + 1], s)
        lanes_add(tab[2 * k + 1], tab[k], tab[k + 1], s)
    for j in range((nbits + 3) // 4):
        for _ in range(4):
            lanes_dbl(acc, acc, s)
        lanes_add(acc, acc, tab[window_digit(row, j, nbits, step)], s)


def k10_kernel(mem, args):
    """csrc/curve_kernels.cu `g1_scalar_mul_kernel` over the launcher's
    arguments: n one-warp blocks, block e's lane group taking element e;
    its point into the table's row 1, its zero slot cleared; its bit row
    read at (e / inner) hi + (e % inner) lo; `scalar_mul_lanes`; the
    accumulator written to out[(c n + e) W + w]. Returns the output words
    (3 n W)."""
    x, sx, y, sy, z, sz, bits, inner, hi, lo, step, nbits, _, n = args
    out = np.zeros(3 * n * W, dtype=np.uint32)
    for e in range(n):
        row = mem.read(bits + (e // inner) * hi + (e % inner) * lo, (nbits - 1) * step + 1)
        tab = [[0, 0, 0] for _ in range(16)]
        tab[1] = [int.from_bytes(mem.read(base + 4 * e * st, 4 * W), "little")
                  for base, st in ((x, sx), (y, sy), (z, sz))]
        acc, scratch = [0, 0, 0], [0] * 13
        scalar_mul_lanes(tab, acc, scratch, row, nbits, step)
        assert scratch[-1] == 0  # the zero slot
        for c in range(3):
            out[(c * n + e) * W : (c * n + e + 1) * W] = np.frombuffer(acc[c].to_bytes(48, "little"), "<u4")
    return out


@pytest.fixture
def recorded_launch(monkeypatch):
    """K10's launch, recorded as its arguments instead of run: the
    operands dispatch as if they lay on a CUDA device."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    return seen


def _run_k10(recorded, p, bits, *operands):
    """K10's model on the one launch that `scalar_mul_bits` records, with
    its output laid out as the wrapper returns it."""
    recorded.clear()
    tc.scalar_mul_bits(tc.FP, p, bits)
    (name, args), = recorded
    assert name == "lh_g1_scalar_mul"
    out = k10_kernel(Operands(p.x, p.y, p.z, *operands), args).view(np.int32)
    shape = (3, *torch.broadcast_shapes(p.x.shape, p.y.shape, p.z.shape))
    return tc.Proj(*torch.from_numpy(out.copy()).reshape(shape))


def _ints(proj, i):
    return tuple(tfp.words_to_int(c.reshape(-1, W)[i]) for c in proj)


@pytest.mark.parametrize("width,dtype", [(64, torch.int32), (127, torch.int64)], ids=["w64_int32", "w127_int64"])
def test_k10_warp_matches_plain(recorded_launch, width, dtype):
    """Five elements (random, P, -P, infinity, P + (-P); Z != 1) with the
    scalars 0, 2^w - 1, 1, 5 and a seeded random one: word for word
    against the plain version and the one-thread schedule."""
    pts, _ = _points("g1", 1)
    ks = [0, (1 << width) - 1, 1, 5, _scalar(width)]
    bits = _bits(ks, width).to(dtype)
    got = _run_k10(recorded_launch, pts, bits, bits)
    want = tc.scalar_mul_bits_plain(tc.FP_PLAIN, pts, bits)
    for i in range(len(ks)):
        assert _ints(got, i) == _ints(want, i) == scalar_mul_thread(_G1, _ints(pts, i), bits[i].tolist()), f"row {i}"


@pytest.mark.parametrize("n", [1, 2, 3])
def test_k10_partial_warps_match_plain(recorded_launch, n):
    """One, two and three elements, a block each, without reading or
    writing outside the operands: word for word against the plain
    version."""
    pts, _ = _points("g1", 1)
    sub = tc.Proj(*(c[:n].clone() for c in pts))
    bits = _bits([5, _scalar(64), (1 << 64) - 1][:n], 64)
    got = _run_k10(recorded_launch, sub, bits, bits)
    want = tc.scalar_mul_bits_plain(tc.FP_PLAIN, sub, bits)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k10_warp_reads_broadcast_operands_in_place(recorded_launch):
    """One point broadcast over three elements (element stride 0) with
    per-element int64 bits; one public bit row broadcast over three points
    (bit stride 0); two rows broadcast over a (2, 3) batch (two stride
    levels): each against the plain version, word for word."""
    pts, _ = _points("g1", 1)
    one = tc.Proj(*(c[0:1].expand(3, W) for c in pts))
    bits = _bits([5, _scalar(64), 0], 64)
    cases = [(one, bits, (bits,))]
    three = tc.Proj(*(c[:3] for c in pts))
    row = tfp.const(tc._ABS_X_BITS, "cpu")
    cases.append((three, tc._ABS_X_BITS, (row,)))
    six = tc.Proj(*(torch.cat([c, c[:1]]).reshape(2, 3, W) for c in pts))
    two = _bits([_scalar(64), 9], 64).to(torch.int32).reshape(2, 1, 64)
    cases.append((six, two, (two,)))
    for p, b, operands in cases:
        got = _run_k10(recorded_launch, p, b, *operands)
        want = tc.scalar_mul_bits_plain(tc.FP_PLAIN, p, b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_lane_group_law_matches_g1_formulas():
    """The G1 lane-group addition and doubling alone, on P == Q, P == -Q,
    infinity and all-(p - 1) coordinates, equal g1.cuh's one-thread
    formulas (`_add` / `_dbl` over _G1, products by 3b as Montgomery
    products of G1_B3), in place as the chains call them."""
    from test_torch_curve_final_exp_kernels import _add, _dbl

    pts, _ = _points("g1", 1)
    p, mp, inf = _ints(pts, 1), _ints(pts, 2), (0, R_MONT, 0)
    q = _ints(pts, 0)
    for a, b in ((p, q), (p, p), (p, mp), (inf, p), (p, inf), (inf, inf), ((P - 1,) * 3, q)):
        s = [0] * 13
        r_add, r_dbl = [0, 0, 0], [0, 0, 0]
        lanes_add(r_add, list(a), list(b), s)
        lanes_dbl(r_dbl, list(a), s)
        assert tuple(r_add) == _add(_G1, a, b) and tuple(r_dbl) == _dbl(_G1, a)
        acc = list(a)
        lanes_add(acc, acc, list(b), s)
        lanes_dbl(acc, acc, s)
        assert tuple(acc) == _dbl(_G1, _add(_G1, a, b)) and s[-1] == 0
