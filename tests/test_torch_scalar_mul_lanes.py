"""K11 `g2_scalar_mul` (csrc/curve_kernels.cu) on the CPU, as the kernel
runs it: one warp a block, two elements a warp on curve.cuh's lane-group
law.

`curve.scalar_mul_bits(FP2, ...)` is dispatched as if on the card and its
one launch recorded. A model of the kernel in Python integers then runs the
launch's grid over the launch's own arguments: it reads the operands
through their addresses (the points at their element strides, bit row e
at byte (e / inner) hi + (e % inner) lo, a byte a bit `step` apart; a read
outside the operands fails), runs the two lane groups of each warp in
lockstep on the lane-group law's model
(test_torch_fold_cofactor_kernels `scalar_mul_lanes`, every step's reads
and the lazy sums' bound asserted), and writes X, Y, Z as n contiguous
coordinates each. The output is held word for word to
`curve.scalar_mul_bits_plain(FP2_PLAIN, ...)` and to the one-thread
schedule (test_torch_curve_final_exp_kernels `scalar_mul_thread`): widths 64 and 127, the scalars 0, 2^w - 1, 1, 5
and a seeded random one, int32 and int64 bits, odd counts (the last
block's second group off), one point broadcast over the batch, public
bits broadcast (stride 0) and clear_cofactor's two rows broadcast over a
(2, 3) batch.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c as th2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from test_torch_curve_final_exp_kernels import _G2, _bits, _points, _scalar, scalar_mul_thread
from test_torch_fold_cofactor_kernels import _point, scalar_mul_lanes

W = 2 * tfp.WORDS  # words of a G2 coordinate


class Operands:
    """The bytes one launch can read, by address: the storages of the
    given tensors. A read that leaves them fails."""

    def __init__(self, *tensors):
        self.spans = [(t.untyped_storage().data_ptr(), bytes(t.untyped_storage())) for t in tensors]

    def read(self, addr, n):
        for base, buf in self.spans:
            if base <= addr and addr + n <= base + len(buf):
                return buf[addr - base : addr - base + n]
        raise AssertionError(f"a read of {n} bytes at {addr:#x} lies outside the operands")

    def fp2(self, addr):
        """An Fp2 coordinate at `addr`: (c0, c1) stored ints."""
        b = self.read(addr, 4 * W)
        return tuple(int.from_bytes(b[i * 48 : (i + 1) * 48], "little") for i in (0, 1))


def k11_kernel(mem, args):
    """csrc/curve_kernels.cu `g2_scalar_mul_kernel` over the launcher's
    arguments: a block per two elements; lanes 0-11 (group 0) element 2b,
    lanes 12-23 (group 1) element 2b + 1, off where 2b + 1 = n, and an off
    group reads group 0's bit row; each group's point into its table's row
    1, its zero slot cleared; both groups through `scalar_mul_lanes<2>` in
    lockstep; the on groups' accumulators written to out[(c n + e) W + w].
    Returns the output words (3 n W)."""
    x, sx, y, sy, z, sz, bits, inner, hi, lo, step, nbits, _, n = args
    out = np.zeros(3 * n * W, dtype=np.uint32)
    for b in range((n + 1) // 2):
        groups = []
        for g in (0, 1):
            e = 2 * b + g
            on = e < n
            re = e if on else 2 * b
            row = mem.read(bits + (re // inner) * hi + (re % inner) * lo, (nbits - 1) * step + 1)
            tab = [_point() for _ in range(16)]
            if on:
                tab[1] = _point([mem.fp2(base + 4 * e * st) for base, st in ((x, sx), (y, sy), (z, sz))])
            scratch = [[0, 0] for _ in range(13)]
            groups.append((tab, _point(), scratch, row, on))
        scalar_mul_lanes(groups, nbits, step)
        for g, (_, acc, scratch, _, on) in enumerate(groups):
            assert scratch[-1] == [0, 0]  # the zero slot
            if not on:
                assert acc == _point(), "an off group wrote its accumulator"
                continue
            e = 2 * b + g
            for c in range(3):
                words = np.frombuffer(b"".join(v.to_bytes(48, "little") for v in acc[c]), dtype="<u4")
                out[(c * n + e) * W : (c * n + e + 1) * W] = words
    return out


@pytest.fixture
def recorded_launch(monkeypatch):
    """K11's launch, recorded as its arguments instead of run: the
    operands dispatch as if they lay on a CUDA device."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    return seen


def _run_k11(recorded, p, bits, *operands):
    """K11's model on the one launch that `scalar_mul_bits` records, with
    its output laid out as the wrapper returns it."""
    tc.scalar_mul_bits(tc.FP2, p, bits)
    (name, args), = recorded
    assert name == "lh_g2_scalar_mul"
    out = k11_kernel(Operands(p.x, p.y, p.z, *operands), args).view(np.int32)
    shape = (3, *torch.broadcast_shapes(p.x.shape, p.y.shape, p.z.shape))
    return tc.Proj(*torch.from_numpy(out.copy()).reshape(shape))


def _ints(proj, i):
    return tuple(tuple(tfp.words_to_int(w) for w in c.reshape(-1, 2, tfp.WORDS)[i]) for c in proj)


@pytest.mark.parametrize("width,dtype", [(64, torch.int32), (127, torch.int64)], ids=["w64_int32", "w127_int64"])
def test_k11_warp_matches_plain(recorded_launch, width, dtype):
    """Five elements (random, P, -P, infinity, P + (-P)) with the scalars
    0, 2^w - 1, 1, 5 and a seeded random one: two warps of two groups with
    different scalars and a third whose second group is off, word for word
    against the plain version and the one-thread schedule."""
    pts, _ = _points("g2", 1)
    ks = [0, (1 << width) - 1, 1, 5, _scalar(width)]
    bits = _bits(ks, width).to(dtype)
    got = _run_k11(recorded_launch, pts, bits, bits)
    want = tc.scalar_mul_bits_plain(tc.FP2_PLAIN, pts, bits)
    for i in range(len(ks)):
        assert _ints(got, i) == _ints(want, i) == scalar_mul_thread(_G2, _ints(pts, i), bits[i].tolist()), f"row {i}"


def test_k11_warp_reads_broadcast_operands_in_place(recorded_launch):
    """One point broadcast over three elements (element stride 0) with
    per-element int64 bits; |z|'s public bits broadcast over three points
    (bit stride 0, from the cached constant); clear_cofactor's two 128-bit
    rows broadcast over a (2, 3) batch (two stride levels): each against
    the plain version, word for word."""
    pts, _ = _points("g2", 1)
    one = tc.Proj(*(c[0:1].expand(3, 2, tfp.WORDS) for c in pts))
    bits = _bits([5, _scalar(64), 0], 64)
    cases = [(one, bits, (bits,))]
    three = tc.Proj(*(c[:3] for c in pts))
    cases.append((three, tc._ABS_X_BITS, (tfp.const(tc._ABS_X_BITS, "cpu"),)))
    six = tc.Proj(*(torch.cat([c, c[:1]]).reshape(2, 3, 2, tfp.WORDS) for c in pts))
    cc = tfp.const(th2c._CC_BITS, "cpu").reshape(2, 1, th2c._CC_WIDTH)
    cases.append((six, cc, (cc,)))
    for p, b, operands in cases:
        recorded_launch.clear()
        got = _run_k11(recorded_launch, p, b, *operands)
        want = tc.scalar_mul_bits_plain(tc.FP2_PLAIN, p, b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
