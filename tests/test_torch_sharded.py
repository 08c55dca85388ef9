"""lighthouse_tpu_torch's sharded verify (parallel/sharded.py) on the CPU,
over a gloo world of spawned ranks (tests/torch_sharded_ranks.py).

The world (4 ranks, groups over the first 1, 2, 3 and 4 of them) starts
once per module, with a timeout on every collective and on every wait for
a rank, so a hung collective fails its test instead of running out the
suite's clock. Every rank run is submitted when the world starts; the
ranks work through them while this process computes the references.

- `stage_sets(..., s_floor=f)` byte-identical to the JAX package's;
- at W = 1, 2, 4 (S = 8, K <= 2) the verdicts equal the ref oracle's and
  the one-process port's, for a valid batch, a tampered message and a
  wrong key; 3 real sets at W = 4, whose last shard is all padding;
- the GT values of a tampered batch bit-identical across W and to the
  one-process `final_exponentiation(verify_pipeline_local(...))`;
- W = 3 raises ValueError on every rank; a structurally invalid batch is
  False on every rank with no collective;
- (slow) each rank's partial bit-identical to the JAX package's jitted
  `verify_pipeline_local` on its rows, and the verdicts equal to the JAX
  `sharded_verify_signature_sets` on the 8-device CPU mesh.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import queue
import random
import socket

import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks
from lighthouse_tpu.crypto.bls.jax_backend import api as japi
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from lighthouse_tpu_torch.parallel import sharded
from torch_parity import base_sets, signature_sets

WORLD = 4
#: seconds to wait for one rank result; the ranks work through every
#: submitted run in order, about 100 s of CPU work in all
RESULT_TIMEOUT = 600
JOIN_TIMEOUT = 30
SEED = 7
#: 8 sets (S = 8), one or two keys each (K bucket 4)
SPEC8 = [((0,), 0), ((1, 2), 1), ((3,), 2), ((4, 5), 3), ((6,), 0), ((7, 8), 1), ((9,), 2), ((10,), 3)]
KINDS = ("valid", "tampered_message", "wrong_key")
SIZES = (1, 2, 4)
SPOILED = 5  # in rank 1's shard at W = 2, rank 2's at W = 4


@functools.lru_cache(maxsize=None)
def _batch(b, kind: str) -> tuple:
    sets = signature_sets(b, SPEC8)
    s = sets[SPOILED]
    if kind == "tampered_message":
        sets[SPOILED] = b.SignatureSet(s.signature, s.signing_keys, b"\x99" * 32)
    elif kind == "wrong_key":
        sets[SPOILED] = b.SignatureSet(s.signature, [s.signing_keys[0], b.interop_keypair(20)[1]], s.message)
    return tuple(sets)


def batch(b, kind: str) -> list:
    """SPEC8's batch for backend module `b`, set SPOILED spoiled per `kind`
    (signed once per module and kind: the oracle signs slowly)."""
    return list(_batch(b, kind))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """The spawned ranks, their task queues and the shared results queue."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        addr = f"tcp://127.0.0.1:{_free_port()}"
        self.tasks = [ctx.Queue() for _ in range(WORLD)]
        self.results = ctx.Queue()
        self.procs = [
            ctx.Process(target=ranks.rank_main, args=(r, WORLD, addr, self.tasks[r], self.results), daemon=True)
            for r in range(WORLD)
        ]
        for p in self.procs:
            p.start()
        self._next = 0
        self._done: dict[int, dict] = {}

    def submit(self, W: int, fn: str, *args) -> tuple[int, int]:
        tid, self._next = self._next, self._next + 1
        for r in range(W):
            self.tasks[r].put((tid, fn, (W, *args)))
        return tid, W

    def collect(self, handle) -> dict[int, tuple[bool, object]]:
        """{rank: (ok, result or error text)} of every rank of the run."""
        tid, W = handle
        got = self._done.setdefault(tid, {})
        while len(got) < W:
            try:
                t, rank, ok, out = self.results.get(timeout=RESULT_TIMEOUT)
            except queue.Empty:
                pytest.fail(f"run {tid}: ranks {sorted(set(range(W)) - set(got))} did not answer")
            self._done.setdefault(t, {})[rank] = (ok, out)
        return got

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(JOIN_TIMEOUT)
            if p.is_alive():
                p.terminate()
                p.join(5)
        assert not any(p.is_alive() for p in self.procs)


@pytest.fixture(scope="module")
def runs():
    """Start the world and submit every rank run at once."""
    world = World()
    handles = {(W, kind): world.submit(W, "verify", batch(tapi, kind), SEED) for W in SIZES for kind in KINDS}
    handles["three_sets"] = world.submit(4, "verify", batch(tapi, "valid")[:3], SEED)
    handles["w3"] = world.submit(3, "verify", batch(tapi, "valid"), SEED)
    bad = batch(tapi, "valid")
    bad[2] = tapi.SignatureSet(bad[2].signature, [], bad[2].message)
    handles["structural"] = world.submit(4, "structural", bad)
    yield lambda key: world.collect(handles[key])
    world.close()


def _results(got) -> list:
    errors = {r: out for r, (ok, out) in got.items() if not ok}
    assert not errors, errors
    return [got[r][1] for r in sorted(got)]


_REFS: dict = {}


def one_process(kind: str):
    """(oracle verdict, one-process port verdict) of the kind's batch."""
    if kind not in _REFS:
        want = ref.verify_signature_sets(batch(ref, kind), rng=random.Random(SEED).getrandbits)
        port = tapi.verify_signature_sets(batch(tapi, kind), rng=random.Random(SEED).getrandbits, device="cpu")
        _REFS[kind] = (want, port)
    return _REFS[kind]


@pytest.mark.parametrize("s_floor", [1, 2, 4, 8])
def test_stage_sets_s_floor_byte_identical_to_jax(s_floor):
    jsets, tsets = list(base_sets(japi)), list(base_sets(tapi))
    want = japi.stage_sets(jsets, rng=random.Random(42).getrandbits, s_floor=s_floor)
    got = tapi.stage_sets(tsets, rng=random.Random(42).getrandbits, s_floor=s_floor)
    assert got[2].shape == want[2].shape == (max(4, s_floor), 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("W", SIZES)
def test_sharded_verdicts_match_oracle_and_one_process(runs, W, kind):
    got = _results(runs((W, kind)))
    want, port = one_process(kind)
    assert want == port == (kind == "valid")
    assert [v for v, *_ in got] == [want] * W


def test_all_padding_shard_verifies_at_w4(runs):
    """3 sets at W = 4: S = 4, one row per rank, rank 3's row padding."""
    got = _results(runs("three_sets"))
    assert [v for v, *_ in got] == [True] * 4
    assert all(ok for _, _, ok, _ in got)


def test_gt_bit_identical_across_world_sizes(runs):
    staged = tapi.stage_sets(batch(tapi, "tampered_message"), rng=random.Random(SEED).getrandbits)
    partial, ok = tapi.verify_pipeline_local(*tapi.from_jax_staged(staged, "cpu"))
    want = tpair.final_exponentiation(partial).numpy()
    assert bool(ok) and not np.array_equal(want, tpair.fp12_one((), "cpu").numpy())
    for W in SIZES:
        got = _results(runs((W, "tampered_message")))
        for verdict, gt, ok_w, partials in got:
            assert partials.shape == (W, *partial.shape)
            assert np.array_equal(gt, want), f"W={W}: GT differs from the one-process value"
            assert ok_w and verdict is False


def test_world_size_not_dividing_s_raises(runs):
    got = runs("w3")
    assert sorted(got) == [0, 1, 2]
    for ok, out in got.values():
        assert not ok and out.startswith("ValueError"), out


def test_structurally_invalid_is_false_without_collective(runs):
    assert _results(runs("structural")) == [False] * 4
    # and with no process group at all: nothing distributed is touched
    assert sharded.sharded_verify_signature_sets([], device="cpu") is False


@pytest.mark.slow
def test_rank_partials_match_jax_pipeline_local(runs):
    """Each rank's partial at W = 2 (rows of 4 sets, K = 2) is the JAX
    package's jitted verify_pipeline_local on the same rows."""
    import jax
    import jax.numpy as jnp

    staged = japi.stage_sets(batch(japi, "tampered_message"), rng=random.Random(SEED).getrandbits, s_floor=2)
    fn = jax.jit(japi.verify_pipeline_local)
    _, _, _, partials = _results(runs((2, "tampered_message")))[0]
    for r in range(2):
        rows = [jnp.asarray(np.asarray(a)[4 * r : 4 * r + 4]) for a in staged]
        want, _ = fn(*rows)
        got = torch.from_numpy(partials[r])
        assert np.array_equal(tapi.fp.to_jax_limbs(got), np.asarray(want)), f"rank {r}"


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_verdicts_match_jax_sharded_mesh(runs, kind):
    from lighthouse_tpu.parallel.sharded import make_mesh, sharded_verify_signature_sets

    want = sharded_verify_signature_sets(batch(japi, kind), mesh=make_mesh(8), rng=random.Random(SEED).getrandbits)
    for W in SIZES:
        assert [v for v, *_ in _results(runs((W, kind)))] == [want] * W
