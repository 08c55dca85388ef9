"""K4 `fp_batch_inv` (csrc/fp_kernels.cu) on the CPU, as the kernel runs
it: each column (trailing lane) cut into `chunks` contiguous chunks of
ceil(N / chunks) rows, a thread each, `chunks_per_column(lanes)` of them
(its constants read from the source).

`fp.batch_inv` is dispatched as if on the card and its one launch
recorded. A model of the kernel in Python integers then runs the launch's
grid (128-thread blocks) over the launch's own arguments: it reads the
values through their addresses (a read outside them fails), and each
thread forms its chunk's prefix products (zeros read as one) into the
output, inverts the chunk's total with `fp_inv_model` (the word-for-word
replay of fp384.cuh's binary GCD) and walks the chunk back, zeros written
as zero. A thread reads back only output rows it wrote itself (no thread
reads another's values), and every output row is written by one thread.

The output is held word for word to `fp.batch_inv_plain` and to the JAX
`fp.batch_inv` at N = 1, 31, 32, 33 and 257 rows, one and three columns,
with zeros at chunk edges, a chunk of zeros only and a column of zeros
only, and on an all-zero batch; with 32 threads a column (the launcher's
pick at these shapes), 8 and one (its picks as the columns grow); and the
launcher's rule at its thresholds.
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
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from test_torch_curve_final_exp_kernels import _mmul
from test_torch_inversion import fp_inv_model
from test_torch_scalar_mul_lanes import Operands
from torch_parity import mont_limbs, rand_fp_ints, to_port

W = tfp.WORDS
R_MONT = (1 << 384) % P
_SRC = (pathlib.Path(tfp.__file__).parent / "csrc" / "fp_kernels.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SRC).group(1))
WARP_COLUMNS = int(re.search(r"constexpr long long kWarpColumns = (\d+);", _SRC).group(1))
THREAD_COLUMNS = int(re.search(r"constexpr long long kThreadColumns = (\d+);", _SRC).group(1))
assert "return lanes < kWarpColumns ? 32 : lanes < kThreadColumns ? 8 : 1;" in _SRC  # the rule, as modelled below
assert "blocks_for(lanes * chunks), kThreads" in _SRC
CHUNKS = 32  # below kWarpColumns


def chunks_per_column(lanes):
    return CHUNKS if lanes < WARP_COLUMNS else 8 if lanes < THREAD_COLUMNS else 1


def chunk(t, steps, chunks):
    """Rows [begin, end) of thread t's chunk of its column."""
    per = -(-steps // chunks)
    begin = (t % chunks) * per
    return begin, min(begin + per, steps)


def k4_kernel(mem, args, chunks=None):
    """csrc/fp_kernels.cu `fp_batch_inv_kernel` over the launcher's
    arguments. Returns the output words (steps, lanes, 12) and the
    inversions the grid ran."""
    a, _, steps, lanes = args
    chunks = chunks or chunks_per_column(lanes)
    out, owner, inversions = {}, {}, 0
    for t in range(-(-lanes * chunks // THREADS) * THREADS):
        lane = t // chunks
        if lane >= lanes:
            continue
        begin, end = chunk(t, steps, chunks)
        if begin >= end:
            continue

        def load(k):
            return int.from_bytes(mem.read(a + 4 * W * (k * lanes + lane), 4 * W), "little")

        def store(k, v):
            assert owner.setdefault((k, lane), t) == t, f"row {k} of lane {lane} written by two threads"
            out[(k, lane)] = v

        def load_out(k):
            assert owner.get((k, lane)) == t, f"thread {t} reads row {k}, which it did not write"
            return out[(k, lane)]

        acc = load(begin) or R_MONT  # zero entries read as one
        store(begin, acc)
        for k in range(begin + 1, end):
            acc = _mmul(acc, load(k) or R_MONT)
            store(k, acc)
        t_inv = fp_inv_model(acc)
        inversions += 1
        for k in range(end - 1, begin, -1):
            x = load(k)
            r = _mmul(t_inv, load_out(k - 1))
            t_inv = _mmul(t_inv, x or R_MONT)
            store(k, 0 if x == 0 else r)
        store(begin, 0 if load(begin) == 0 else t_inv)
    assert len(out) == steps * lanes
    words = np.zeros((steps, lanes, W), dtype=np.uint32)
    for (k, lane), v in out.items():
        words[k, lane] = np.frombuffer(v.to_bytes(48, "little"), "<u4")
    return words.view(np.int32), inversions


@pytest.fixture
def recorded_launch(monkeypatch):
    """K4's launch, recorded as its arguments instead of run."""
    seen = []
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tkernels, "launch", lambda name, device, *args: seen.append((name, args)))
    return seen


def _batch(steps, lanes, seed, zeros=()):
    """Montgomery limbs (steps, lanes, 32) from a seed (the edge values
    0, 1, p - 1, p - 2 among them), with the (row, lane) entries of
    `zeros` set to zero ((None, lane): the whole lane)."""
    xs = rand_fp_ints(seed, steps * lanes)[: steps * lanes]
    limbs = mont_limbs(np.random.default_rng(seed).permutation(np.array(xs, dtype=object)).tolist())
    limbs = limbs.reshape(steps, lanes, -1)
    for k, lane in zeros:
        limbs[slice(None) if k is None else k, lane] = 0
    return limbs


def _edge_zeros(steps, lanes):
    """Zeros at the first and last row of every third chunk of lane 0 (32
    chunks), and a whole chunk of zeros in lane 1."""
    per = -(-steps // CHUNKS)
    zeros = []
    for j in range(0, CHUNKS, 3):
        begin, end = j * per, min((j + 1) * per, steps)
        if begin < end:
            zeros += [(begin, 0), (end - 1, 0)]
    if lanes > 1 and steps > 2 * per:
        zeros += [(k, 1) for k in range(per, 2 * per)]
    return zeros


_JAX_INV = jax.jit(jfp.batch_inv)


def _check(recorded, limbs, chunks=None):
    a = to_port(limbs).contiguous()
    recorded.clear()
    tfp.batch_inv(a)
    (name, args), = recorded
    assert name == "lh_fp_batch_inv" and args[2:] == (a.shape[0], a.shape[1])
    got, inversions = k4_kernel(Operands(a), args, chunks)
    got = torch.from_numpy(got)
    assert torch.equal(got, tfp.batch_inv_plain(a))
    assert torch.equal(got, to_port(_JAX_INV(jnp.asarray(limbs))).reshape(got.shape))
    return inversions


@pytest.mark.parametrize("chunks", [None, 8, 1], ids=["launcher", "c8", "c1"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("steps", [1, 31, 32, 33, 257])
def test_k4_chunks_match_plain_and_jax(recorded_launch, steps, lanes, chunks):
    """Seeded values with zeros at chunk edges, a chunk of zeros only and
    (three lanes) a lane of zeros only: word for word against the plain
    version and the JAX function, every nonempty chunk one inversion."""
    zeros = _edge_zeros(steps, lanes) + ([(None, 2)] if lanes == 3 else [])
    inversions = _check(recorded_launch, _batch(steps, lanes, seed=steps * 7 + lanes, zeros=zeros), chunks)
    c = chunks or chunks_per_column(lanes)
    per = -(-steps // c)
    assert inversions == lanes * -(-steps // per)


@pytest.mark.parametrize("steps", [1, 33, 257])
def test_k4_all_zero_batch(recorded_launch, steps):
    """Every entry zero: every output zero, each chunk inverting one."""
    _check(recorded_launch, np.zeros((steps, 2, jfp.N_LIMBS), dtype=np.asarray(mont_limbs([1])).dtype))


def test_k4_chunk_counts_at_257_rows():
    """At N = 257 in 32 chunks: 9 rows a chunk, 29 nonempty, the last of 5
    rows; three chunks empty (the header's count of 29 inversions)."""
    spans = [chunk(t, 257, CHUNKS) for t in range(CHUNKS)]
    sizes = [e - b for b, e in spans if b < e]
    assert CHUNKS == 32 and len(sizes) == 29 and sizes[:-1] == [9] * 28 and sizes[-1] == 5
    assert sum(sizes) == 257 and all(b >= 257 for b, e in spans[29:])


def test_k4_rule_at_its_thresholds(recorded_launch):
    """The launcher's picks around kWarpColumns and kThreadColumns, and one
    recorded launch past each, run on a few columns of it: the grid's
    threads, read at the model's chunk count, cover every row once."""
    assert [chunks_per_column(n) for n in (1, WARP_COLUMNS - 1, WARP_COLUMNS, THREAD_COLUMNS - 1,
                                           THREAD_COLUMNS)] == [32, 32, 8, 8, 1]
    for chunks in (8, 1):
        _check(recorded_launch, _batch(17, 2, seed=chunks, zeros=[(0, 0), (16, 1)]), chunks)
