"""K5 `g1_subgroup_check` (csrc/g1_kernels.cu) on the CPU, as the kernel
runs it: one warp a block, a quad of four lanes a key, eight keys a warp.

`curve.g1_in_subgroup_kernel` is dispatched as if on the card and its one
launch recorded. A model of the kernel in Python integers then runs the
launch's grid over the launch's own arguments: it reads x, y, inf and beta
through their addresses (a read outside the operands fails), leaves a warp
with no key to check after writing its zeros, runs an off quad (past n or
at an infinity row) on (0 : 1 : 0), and runs each quad's two
double-and-add passes over |z| (`kAbsZ`, `kAbsZTop`, `kQuad` and
`kThreads` read from the source) lane by lane: each lane forms its
product of a level from its own copy of the accumulator (`quad_dbl`,
`quad_add`, the picks as the source makes them), every lane receives the
quad's products as `quad_gather`'s shuffles deliver them and forms the
middle and the output itself, and the four copies are asserted equal after
every group operation; then the two rounds of the cross-products, each
lane against its partner (xor 1), and the quad's ballot. Every verdict
byte is written exactly once.

The verdicts are held to `curve.g1_subgroup_check_plain` and to the JAX
`curve.g1_in_subgroup` (& ~inf, as `_pk_validate_kernel` takes it) on
interop keys, a seeded G1 point, the order-3 points (0, 2) and (0, -2)
(their chains meet P + (-P) at the first addition, then infinity, and
the second pass runs on an infinite base), a point of order 11, seeded
points of E(Fp) outside G1 and infinity rows, at 1, 5, 6, 7, 8, 9, 31
and 64 keys (partial warps and blocks), with infinity rows only, and
against the chain's projective values (`g1.cuh`'s one-thread formulas,
test_torch_curve_final_exp_kernels `_add` / `_dbl`).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P, R, X
from lighthouse_tpu.crypto.bls.jax_backend import curve as jcurve
from lighthouse_tpu.crypto.bls.jax_backend import pack as jpack
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu.crypto.bls.ref.curves import Point, g1_generator, g1_infinity
from lighthouse_tpu.crypto.bls.ref.fields import Fp
from lighthouse_tpu_torch.crypto.bls.torch_backend import curve as tc
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from test_torch_curve_final_exp_kernels import _G1, _add, _dbl, _mmul
from test_torch_scalar_mul_lanes import Operands
from torch_parity import non_g1_point, to_port

W = tfp.WORDS
R_MONT = (1 << 384) % P
_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "g1_kernels.cu").read_text()


def _constant(name):
    return re.search(rf"constexpr \w+(?: \w+)? {name} = ([^;]+);", _SRC).group(1)


ABS_Z = int(_constant("kAbsZ").rstrip("ul"), 16)
ABS_Z_TOP = int(_constant("kAbsZTop"))
QUAD = int(_constant("kQuad"))
THREADS = int(_constant("kThreads"))
KEYS = THREADS // QUAD
assert _constant("kKeys") == "kThreads / kQuad" and QUAD == 4


def _pick(q, *xs):
    return xs[q]


def _gather(r):
    """quad_gather: every lane receives lane j's r as v[j]."""
    return [list(r) for _ in range(QUAD)]


def _m12(v):
    return 12 * v % P


def quad_dbl(p):
    """g1_kernels.cu `quad_dbl` on the quad's four copies p[q] = [X, Y, Z]."""
    r = [_mmul(_pick(q, c[1], c[1], c[2], c[0]), _pick(q, c[1], c[2], c[2], c[1])) for q, c in enumerate(p)]
    v = _gather(r)
    r = []
    for q in range(QUAD):
        a, b, c, d = v[q]
        t = _m12(c)
        e, f, g = (a + t) % P, (a - 3 * t) % P, 8 * a % P
        r.append(_mmul(_pick(q, f, b, t, f), _pick(q, d, g, g, e)))
    v = _gather(r)
    for q in range(QUAD):
        p[q] = [2 * v[q][0] % P, (v[q][2] + v[q][3]) % P, v[q][1]]


def quad_add(p, o):
    """g1_kernels.cu `quad_add`: p[q] += o (the base, in shared memory)."""
    r = [_mmul(_pick(q, c[0], c[1], c[2], (c[0] + c[1]) % P), _pick(q, o[0], o[1], o[2], (o[0] + o[1]) % P))
         for q, c in enumerate(p)]
    v = _gather(r)
    r = [_mmul(((c[0] if q & 1 else c[1]) + c[2]) % P, ((o[0] if q & 1 else o[1]) + o[2]) % P)
         for q, c in enumerate(p)]
    w = [r[0], r[1]]  # m4, m5: lanes 0 and 1 by shuffle
    r = []
    mids = []
    for q in range(QUAD):
        t0, t1, t2, m3 = v[q]
        m4, m5 = w
        t3, t4 = (m3 - t0 - t1) % P, (m4 - t1 - t2) % P
        y3, s0 = _m12((m5 - t0 - t2) % P), 3 * t0 % P
        z3, t1p = (t1 + _m12(t2)) % P, (t1 - _m12(t2)) % P
        mids.append((t3, t4, y3, s0, z3, t1p))
        r.append(_mmul(_pick(q, t4, t3, y3, t1p), _pick(q, y3, t1p, s0, z3)))
    v = _gather(r)
    r = [_mmul(z3 if q & 1 else s0, t4 if q & 1 else t3) for q, (t3, t4, y3, s0, z3, t1p) in enumerate(mids)]
    w = [r[0], r[1]]
    for q in range(QUAD):
        p[q] = [(v[q][1] - v[q][0]) % P, (v[q][3] + v[q][2]) % P, (w[1] + w[0]) % P]


def check_group(x, y, beta, on=True, met_infinity=None, chain=None):
    """One quad's check of the key (x, y) (Montgomery ints; an off quad
    runs (0 : 1 : 0)): the two passes over |z|, the base the pass's first
    accumulator; each lane's copy asserted equal after every group
    operation, `met_infinity` collecting Z == 0 and `chain` the
    accumulator after each operation. Then round 1 (lane 0 beta x, lane 1
    X, lane 2 y, lane 3 Y, each times beta or one) and round 2 (times Z on
    lanes 0 and 2, one on 1 and 3; lane 3 negated), each lane against
    lane q ^ 1, and the ballot of the on quad: both pairs equal and
    Z != 0. Returns the verdict."""
    px, py = (x, y) if on else (0, R_MONT)
    acc = [[px, py, R_MONT if on else 0] for _ in range(QUAD)]
    for pass_ in range(2):
        base = list(acc[0])  # lane 0 stores it; every lane reads it after __syncwarp
        for b in range(ABS_Z_TOP - 1, -1, -1):
            ops = [quad_dbl] + ([lambda p: quad_add(p, base)] if (ABS_Z >> b) & 1 else [])
            for op in ops:
                op(acc)
                assert all(c == acc[0] for c in acc), "the quad's copies differ"
                if met_infinity is not None:
                    met_infinity.append(acc[0][2] == 0)
                if chain is not None:
                    chain.append(tuple(acc[0]))
    one = R_MONT
    u = [_mmul(_pick(q, px, c[0], py, c[1]), _pick(q, beta, one, one, one)) for q, c in enumerate(acc)]
    r = [_mmul(u[q], one if q & 1 else c[2]) for q, c in enumerate(acc)]
    r[3] = (-r[3]) % P
    bad = [on and (r[q] != r[q ^ 1] or (q == 0 and acc[q][2] == 0)) for q in range(QUAD)]
    return on and not any(bad)


def k5_kernel(mem, args):
    """csrc/g1_kernels.cu `g1_subgroup_check_kernel` over the launcher's
    arguments: ceil(n / 8) one-warp blocks; lane t in quad t / 4, its key
    8 b + t / 4; a warp with no finite key in range writes its keys' zeros
    and leaves; every quad runs the chain (an off one on infinity); each
    in-range quad's lane 0 writes the byte. Returns the verdicts and the
    keys checked."""
    x, y, inf, beta, _, n = args
    b_mont = int.from_bytes(mem.read(beta, 4 * W), "little")
    out = [None] * n
    checked = []
    for blk in range(-(-n // KEYS)):
        keys = [blk * KEYS + k for k in range(KEYS)]
        mine = [i < n for i in keys]
        on = [m and mem.read(inf + i, 1) == b"\0" for m, i in zip(mine, keys)]
        if not any(on):  # __any_sync: the warp writes its zeros and leaves
            for i, m in zip(keys, mine):
                if m:
                    assert out[i] is None
                    out[i] = False
            continue
        for k, i in enumerate(keys):
            px = py = 0
            if on[k]:
                px = int.from_bytes(mem.read(x + 4 * W * i, 4 * W), "little")
                py = int.from_bytes(mem.read(y + 4 * W * i, 4 * W), "little")
                checked.append(i)
            verdict = check_group(px, py, b_mont, on[k])
            if mine[k]:
                assert out[i] is None, f"key {i} written twice"
                out[i] = verdict
    assert all(v is not None for v in out)
    return out, checked


@pytest.fixture
def recorded_launch(monkeypatch):
    """K5's launch, recorded as its arguments instead of run: the operands
    dispatch as if they lay on a CUDA device."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    return seen


def _order_11_point():
    """A point of E(Fp) of order 11: #E = p - z has 11^2 in its cofactor,
    and E(Fp)'s 11-torsion is Z/11 x Z/11, so [#E / 11^2] Q has order 11
    or is infinity."""
    order = P - X
    assert order % (R * 121) == 0
    x = 7
    while True:
        q0 = non_g1_point(x)
        q = q0.mul(order // 121)
        if not q.inf:
            assert q.mul(11).inf
            return q
        x = int(q0.x) + 1


def _distinct():
    """(name, point) of the cases, from a numpy seed."""
    rng = np.random.default_rng(0x5B)
    g = g1_generator()
    pts = [(f"interop_{i}", ref.g1_from_compressed(ref.interop_keypair(i)[1].to_bytes())) for i in range(3)]
    pts += [("g1_seeded", g.mul(int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1))]
    pts += [("order_3", Point(Fp(0), Fp(2), False, g.b)), ("order_3_neg", Point(Fp(0), -Fp(2), False, g.b))]
    pts += [("order_11", _order_11_point())]
    pts += [(f"non_g1_{k}", non_g1_point(int.from_bytes(rng.bytes(48), "big") % (1 << 380))) for k in range(2)]
    pts += [("infinity", g1_infinity())]
    return pts


CASES = _distinct()
NAMES = [n for n, _ in CASES]
_X, _Y, _INF = jpack.pack_g1_batch([p for _, p in CASES])
WANT = [n.startswith(("interop", "g1_")) for n in NAMES]


@pytest.fixture(scope="module")
def verdicts():
    """The plain version's and the JAX function's verdicts on the cases."""
    plain = tc.g1_subgroup_check_plain(to_port(_X), to_port(_Y), torch.from_numpy(_INF)).tolist()

    @jax.jit
    def check(ax, ay, ainf):
        return jcurve.g1_in_subgroup(jcurve.from_affine(jcurve.FP, ax, ay, ainf)) & ~ainf

    jax_v = np.asarray(check(jnp.asarray(_X), jnp.asarray(_Y), jnp.asarray(_INF))).tolist()
    assert plain == jax_v == WANT
    return plain


def _tiled(n, seed):
    """n keys drawn from the cases (every case among them once n allows),
    as port words; the index of each key's case."""
    rng = np.random.default_rng(seed)
    idx = (list(range(len(CASES))) + list(rng.integers(0, len(CASES), size=max(0, n - len(CASES)))))[:n]
    idx = [int(i) for i in rng.permutation(idx)] if n > 1 else [0]
    return (to_port(_X[idx]).contiguous(), to_port(_Y[idx]).contiguous(), torch.from_numpy(_INF[idx]).contiguous(),
            idx)


def _run_k5(recorded, x, y, inf):
    recorded.clear()
    got = tc.g1_in_subgroup_kernel(x, y, inf)
    (name, args), = recorded
    assert name == "lh_g1_subgroup_check" and args[4] == got.data_ptr() and args[5] == inf.shape[0]
    beta = tfp.const(tc.PHI_BETA, "cpu")
    return k5_kernel(Operands(x, y, inf, beta), args)


def _case_ints(name):
    k = NAMES.index(name)
    return k, tuple(tfp.words_to_int(to_port(a[k : k + 1])[0]) for a in (_X, _Y))


BETA = tfp.words_to_int(torch.from_numpy(tc.PHI_BETA))


def test_cases_cover_the_chain_edges():
    """The chains of (0, 2) and (0, -2), E(Fp)'s points of order 3, meet
    infinity (3 divides |z|: the first addition is P + (-P), and the
    second pass's base is infinity); those of an order-11 point and of a
    G1 key never do (|z|'s prefixes and their multiples by |z| are prime
    to 11 and to r)."""
    for name, want in (("order_3", True), ("order_3_neg", True), ("order_11", False), ("interop_0", False)):
        k, (px, py) = _case_ints(name)
        met = []
        assert check_group(px, py, BETA, True, met) == WANT[k]
        assert any(met) == want, name
    _, (px, py) = _case_ints("order_3")
    met = []
    check_group(px, py, BETA, True, met)
    assert met[:2] == [False, True]  # [2] P = -P, then P + (-P) = O


@pytest.mark.parametrize("name", ["interop_0", "order_3", "order_11", "non_g1_0"])
def test_quad_chain_matches_one_thread_formulas(name):
    """Each group operation of the quad's chain gives the projective value
    of g1.cuh's one-thread formulas (RCB, products by 3b as Montgomery
    products of G1_B3), in the same order: the quad's picks, gathers and
    middle form the same law."""
    _, (px, py) = _case_ints(name)
    chain = []
    check_group(px, py, BETA, True, chain=chain)
    acc, want = (px, py, R_MONT), []
    for _ in range(2):
        base = acc
        for b in range(ABS_Z_TOP - 1, -1, -1):
            acc = _dbl(_G1, acc)
            want.append(acc)
            if (ABS_Z >> b) & 1:
                acc = _add(_G1, acc, base)
                want.append(acc)
    assert chain == want


@pytest.mark.parametrize("n", [1, 5, 6, 7, 8, 9, 31, 64])
def test_k5_grid_matches_plain_and_jax(recorded_launch, verdicts, n):
    """n keys (every case once where n allows, the rest seeded draws),
    partial warps included: the model's verdicts equal the plain version's
    and the JAX function's, key by key, and every finite key is checked
    once."""
    x, y, inf, idx = _tiled(n, seed=n * 10 + 1)
    got, checked = _run_k5(recorded_launch, x, y, inf)
    assert got == [verdicts[i] for i in idx]
    assert sorted(checked) == [i for i in range(n) if not inf[i]]


@pytest.mark.parametrize("n", [8, 12])
def test_all_infinity_warps_check_nothing(recorded_launch, n):
    """Infinity rows only: every warp leaves at once, every byte 0."""
    idx = [NAMES.index("infinity")] * n
    x, y, inf = (torch.from_numpy(a[idx]).contiguous() for a in (to_port(_X).numpy(), to_port(_Y).numpy(), _INF))
    got, checked = _run_k5(recorded_launch, x, y, inf)
    assert got == [False] * n and checked == []


def test_infinity_rows_beside_keys_cost_their_warp_nothing_more(recorded_launch, verdicts):
    """Twelve keys: a warp of infinity rows (leaves at once) and a warp
    with one valid key among off quads: one key checked."""
    idx = [NAMES.index("infinity")] * 11 + [NAMES.index("interop_1")]
    x, y, inf = (torch.from_numpy(a[idx]).contiguous() for a in (to_port(_X).numpy(), to_port(_Y).numpy(), _INF))
    got, checked = _run_k5(recorded_launch, x, y, inf)
    assert got == [False] * 11 + [True] and checked == [11]
