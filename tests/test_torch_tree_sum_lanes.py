"""K15 `g1_tree_sum` / K16 `g2_tree_sum` (csrc/fold_kernels.cu) on the CPU,
as the kernels run them: a block per column, the pair sums of each level on
lane groups of curve.cuh's lane-group law (`lanes_add<1>` in G1, six lanes
a group, five groups a warp; `lanes_add<2>` in G2, twelve lanes, two a
warp), the groups walking a level's pairs in rounds.

`curve.tree_sum(FP / FP2, ...)` is dispatched as if on the card and its one
launch recorded. A model of the kernel in Python integers then runs the
launch's grid over the launch's own arguments. The groups a warp and the
warps a block come from the sources (`kTreeMaxWarps` in fold_kernels.cu,
the lane group's 6 C lanes in curve.cuh). The model reads the caller's
points through their addresses at their row and column strides (a read
outside them fails), writes each level into a scratch half that it
invalidates first (a read of a word not written at the level before
fails), and runs each group's four steps on the lane-step models
(tests/test_torch_g1_scalar_mul_lanes.py `lanes_add`,
tests/test_torch_fold_cofactor_kernels.py `lanes_add`, both reading
`kLane` from the source). An off group (no pair left in its round) must
make no access at all; a warp whose groups are all off leaves the level.

The output is held word for word to `curve.tree_sum_plain` over the plain
fields, and through it (tests/test_torch_fold_cofactor_kernels.py
`test_tree_sum_plain_bit_identical_to_jax`, and here at L = 7) to the JAX
`api._tree_fold`: columns of one point; odd lengths whose leftover crosses
levels; G2 lengths whose first level has more pairs than the block has
groups (a second round); a G1 column whose levels leave a warp partly
filled; and layouts read in place (rows broadcast, a coordinate broadcast
over the columns, a fold along a strided axis).
"""

import pathlib
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import api as japi
from lighthouse_tpu.crypto.bls.jax_backend import curve as jcurve
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
import test_torch_fold_cofactor_kernels as fold
import test_torch_g1_scalar_mul_lanes as g1lanes
from test_torch_scalar_mul_lanes import Operands
from torch_parity import assert_same

_CSRC = pathlib.Path(tfp.__file__).parent / "csrc"
MAX_WARPS = int(re.search(r"constexpr int kTreeMaxWarps = (\d+);", (_CSRC / "fold_kernels.cu").read_text()).group(1))
LANES_PER_COMPONENT = int(re.search(r"constexpr int lane_group\(\) \{\s*return (\d+) \* C;",
                                    (_CSRC / "curve.cuh").read_text()).group(1))
FP_BYTES = 4 * tfp.WORDS


def groups_per_warp(C):
    """fold_kernels.cu `tree_groups_per_warp<C>`: 32 / 6 C."""
    return 32 // (LANES_PER_COMPONENT * C)


def block_warps(C, L):
    """fold_kernels.cu `tree_warps<C>`: groups for the first level's pairs,
    at least one warp, at most kTreeMaxWarps."""
    per = groups_per_warp(C)
    return min(max((L // 2 + per - 1) // per, 1), MAX_WARPS)


class Memory:
    """The words one launch touches, by byte address, an Fp element (12
    words) at a time: the caller's points (read only, through `Operands`),
    the scratch and the output (the model's own, at the launch's
    addresses). A scratch element must have been written since its half
    was last invalidated before it is read. Every access is counted
    against `self.by`, the group (or "block") making it."""

    def __init__(self, operands, regions):
        self.operands = operands
        self.regions = {name: (base, size) for name, (base, size) in regions.items()}
        self.words = {name: {} for name in regions}
        self.by = "block"
        self.accesses = Counter()

    def _region(self, addr):
        for name, (base, size) in self.regions.items():
            if base <= addr and addr + FP_BYTES <= base + 4 * size:
                assert (addr - base) % FP_BYTES == 0, f"misaligned element at {addr:#x}"
                return name, (addr - base) // FP_BYTES
        return None, None

    def read(self, addr):
        self.accesses[self.by] += 1
        name, k = self._region(addr)
        if name is None:
            return int.from_bytes(self.operands.read(addr, FP_BYTES), "little")
        assert name != "out", "the kernel reads its output"
        assert k in self.words[name], f"a read of a {name} element at {addr:#x} not written at this level"
        return self.words[name][k]

    def write(self, addr, value):
        self.accesses[self.by] += 1
        name, k = self._region(addr)
        assert name is not None, f"a write at {addr:#x} lies outside the scratch and the output"
        assert 0 <= value < P
        self.words[name][k] = value

    def invalidate(self, base, n_bytes):
        """Forget the scratch elements in [base, base + n_bytes): what a
        level reads must have been written at the level before."""
        sbase, _ = self.regions["scratch"]
        lo, hi = (base - sbase) // FP_BYTES, (base + n_bytes - sbase) // FP_BYTES
        self.words["scratch"] = {k: v for k, v in self.words["scratch"].items() if not lo <= k < hi}


def _law(C):
    """(lanes_add(r, p, q, s), an empty point, an empty scratch) over the
    lane-step model of G1 (a coordinate one int) or G2 (two)."""
    if C == 1:
        return g1lanes.lanes_add, (lambda: [0, 0, 0]), (lambda: [0] * 13)
    return fold.lanes_add, fold._point, (lambda: [[0, 0] for _ in range(13)])


def tree_kernel(mem, args, C):
    """fold_kernels.cu `tree_sum_lanes<C>` over the launcher's arguments:
    a block per column of `block_warps` warps, `groups_per_warp` lane
    groups a warp. Per level the block copies the odd leftover, then the
    groups walk the pairs in rounds: group g of round b takes pair
    i = b G + g, gathers rows i and i + half and writes their sum to row i
    of the level's scratch half; a warp whose first pair index is past
    the level's pairs leaves the level. Returns the warps' round counts
    per level, for the tests' checks of the schedule."""
    x, xr, xc, y, yr, yc, z, zr, zc, scratch, out, L, cols = args
    W = C * tfp.WORDS
    point = 3 * W
    per, warps = groups_per_warp(C), block_warps(C, L)
    groups = warps * per
    cap = (L + 1) // 2
    lanes_add, empty_point, empty_scratch = _law(C)
    schedule = []
    for col in range(cols):
        buf = [scratch + 4 * 2 * col * cap * point, scratch + 4 * (2 * col + 1) * cap * point]
        src, stride = [x + 4 * col * xc, y + 4 * col * yc, z + 4 * col * zc], [xr, yr, zr]
        s = [empty_scratch() for _ in range(groups)]

        def coord(c, row):
            vals = [mem.read(src[c] + 4 * (row * stride[c] + j * tfp.WORDS)) for j in range(C)]
            return vals if C == 2 else vals[0]

        def put(base, row, pt):
            for c in range(3):
                for j, v in enumerate(pt[c] if C == 2 else [pt[c]]):
                    mem.write(base + 4 * (row * point + c * W + j * tfp.WORDS), v)

        n, nxt, levels = L, 0, []
        while n > 1:
            half = n // 2
            dst = buf[nxt]
            mem.invalidate(dst, 4 * cap * point)
            mem.by = "block"
            if n % 2:  # the odd leftover rides along
                put(dst, half, [coord(c, 2 * half) for c in range(3)])
            rounds = [0] * warps
            for base in range(0, half, groups):
                for w in range(warps):
                    if base + w * per >= half:
                        break
                    rounds[w] += 1
                    for g in range(per):
                        gid = w * per + g
                        i = base + gid
                        mem.by = gid
                        before = mem.accesses[gid]
                        if i < half:
                            p = [coord(c, i) for c in range(3)]
                            q = [coord(c, i + half) for c in range(3)]
                            r = empty_point()
                            lanes_add(r, p, q, s[gid])
                            put(dst, i, r)
                        assert i < half or mem.accesses[gid] == before, f"off group {gid} made an access"
            levels.append(rounds)
            src, stride = [dst + 4 * c * W for c in range(3)], [point] * 3
            nxt ^= 1
            n = half + n % 2
        mem.by = "block"
        out_pt = [coord(c, 0) for c in range(3)]
        for c in range(3):
            for j, v in enumerate(out_pt[c] if C == 2 else [out_pt[c]]):
                mem.write(out + 4 * ((c * cols + col) * W + j * tfp.WORDS), v)
        assert all(sc[-1] in (0, [0, 0]) for sc in s)  # the zero slot
        schedule.append(levels)
    return schedule


def run_tree_model(monkeypatch, F, pts, axis):
    """`curve.tree_sum(F, pts, axis)` dispatched as if on the card, its one
    launch recorded and run on the model: (the output as the wrapper
    returns it, the schedule)."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(tfp, "_is_cpu", lambda *ts: False)
        m.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
        tc.tree_sum(F, pts, axis)
    (name, args), = seen
    C = F.elem_dims
    assert name == f"lh_g{C}_tree_sum"
    L, cols = args[-2:]
    W = C * tfp.WORDS
    mem = Memory(Operands(*pts), {"scratch": (args[9], 2 * cols * ((L + 1) // 2) * 3 * W),
                                  "out": (args[10], 3 * cols * W)})
    schedule = tree_kernel(mem, args, C)
    words = np.zeros(3 * cols * W, dtype=np.uint32)
    for k, v in mem.words["out"].items():
        words[k * tfp.WORDS : (k + 1) * tfp.WORDS] = np.frombuffer(v.to_bytes(FP_BYTES, "little"), "<u4")
    assert len(mem.words["out"]) == 3 * cols * C, "an output element was not written"
    shape = torch.broadcast_shapes(*(c.shape for c in pts))
    rest = [d for k, d in enumerate(shape[: len(shape) - C]) if k != axis]
    out = torch.from_numpy(words.view(np.int32).copy()).reshape(3, *rest, *shape[len(shape) - C :])
    return tc.Proj(*out), schedule


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _points(group, shape, seed):
    """Seeded points of `shape`, as port projective words: G1 columns
    along axis 1, G2 one column along axis 0, each meeting at its first
    level P == Q, P == -Q and infinity where its length allows (the fold
    tests' `_column`, from a generator of its own)."""
    gen, inf, pack_batch = fold.GROUPS[group][:3]
    r = np.random.default_rng(seed)
    axis = 1 if group == "g1" else 0
    length = shape[axis]
    pts = []
    for _ in range(int(np.prod(shape)) // length):
        a, step = (gen().mul(int(r.integers(1, 1 << 62))) for _ in range(2))
        col = [a]
        while len(col) < length:  # a + k step: distinct points without a multiplication each
            col.append(col[-1] + step)
        half = length // 2
        if half >= 1:
            col[half] = col[0]
        if half >= 2:
            col[half + 1] = -col[1]
        if length >= 3:
            col[-1] = inf()
        pts += col
    packed = fold._packed(pack_batch, pts, shape)
    return fold._port_points(group, *packed), packed


_FIELDS = {"g1": (tc.FP, tc.FP_PLAIN), "g2": (tc.FP2, tc.FP2_PLAIN)}

# (group, shape, axis): one point a column; odd lengths whose leftover
# crosses levels; G2 first levels of 32 pairs (one round of the block's 32
# groups), 33 and 64 pairs (two rounds) and 65 (three); G1 levels that
# leave a warp partly filled (7 and 3 pairs: the second warp of two holds
# two groups on and three off, then leaves) and 86 pairs over 80 groups
EDGES = [("g1", (3, 1), 1), ("g1", (2, 7), 1), ("g1", (1, 14), 1), ("g1", (1, 173), 1)]
EDGES += [("g2", (n,), 0) for n in (7, 65, 66, 128, 131)]
# the rounds each warp of a column's block runs, level by level: K16 at 128
# signatures (16 warps, 32 groups) runs level 1's 64 pairs in two rounds on
# every warp, then 32, 16, ... pairs with the idle warps gone; K15 at 14
# keys (two warps of five groups) runs 7 pairs on both warps, then 3, 2
# and 1 on the first warp alone
SCHEDULES = {("g2", (128,)): [[2] * 16, [1] * 16] + [[1] * k + [0] * (16 - k) for k in (8, 4, 2, 1, 1)],
             ("g1", (1, 14)): [[1, 1], [1, 0], [1, 0], [1, 0]]}


@pytest.mark.parametrize("group,shape,axis", EDGES, ids=[f"{g}_{'x'.join(map(str, s))}" for g, s, _ in EDGES])
def test_tree_lanes_match_plain_at_edge_lengths(monkeypatch, group, shape, axis):
    """The model of K15 / K16's block on the recorded launch, word for word
    against `tree_sum_plain` over the plain fields; where `SCHEDULES`
    lists the shape, its rounds as listed."""
    F, F_plain = _FIELDS[group]
    pts, _ = _points(group, shape, sum(shape))
    got, schedule = run_tree_model(monkeypatch, F, pts, axis)
    assert _same(got, tc.tree_sum_plain(F_plain, pts, axis))
    if (group, shape) in SCHEDULES:
        assert schedule == [SCHEDULES[group, shape]]


def test_tree_lanes_read_layouts_in_place(monkeypatch):
    """A G1 point broadcast along the fold (row stride 0) over three
    columns; G1 keys whose Z is one row broadcast over the sets (column
    stride 0); G2 points folded along axis 1 of a (2, 5) batch (rows 24
    words apart, columns 120). Each read where it lies, against the plain
    version."""
    g1, _ = _points("g1", (3, 4), 5)
    one = tc.Proj(*(c[:1, :1].expand(6, 3, tfp.WORDS) for c in g1))
    zrow = tc.Proj(g1.x, g1.y, g1.z[:1].expand(3, 4, tfp.WORDS))
    g2, _ = _points("g2", (10,), 6)
    g2 = tc.Proj(*(c.reshape(2, 5, 2, tfp.WORDS) for c in g2))
    for F, F_plain, pts, axis in ((tc.FP, tc.FP_PLAIN, one, 0), (tc.FP, tc.FP_PLAIN, zrow, 1),
                                  (tc.FP2, tc.FP2_PLAIN, g2, 1)):
        got, _ = run_tree_model(monkeypatch, F, pts, axis)
        assert _same(got, tc.tree_sum_plain(F_plain, pts, axis))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_tree_lanes_bit_identical_to_jax_at_seven(monkeypatch, group):
    """At L = 7 (leftovers at two levels) the model's words are the JAX
    `_tree_fold`'s, its additions the jitted JAX `curve.add`."""
    shape, axis = ((2, 7), 1) if group == "g1" else ((7,), 0)
    pts, (x, y, inf) = _points(group, shape, 7)
    got, _ = run_tree_model(monkeypatch, _FIELDS[group][0], pts, axis)
    jF = fold.GROUPS[group][3]
    monkeypatch.setattr(jcurve, "add", fold._JAX_ADD[group])
    want = japi._tree_fold(jF, jcurve.from_affine(jF, jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf)), axis)
    for g, w in zip(got, want):
        assert_same(g, w)
