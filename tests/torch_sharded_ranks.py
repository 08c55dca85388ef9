"""Rank processes for tests/test_torch_sharded.py: a gloo world on the CPU.

Each rank is a spawned process that joins the world over
tcp://127.0.0.1, builds the process groups over the first 1..world ranks
(`sharded.make_mesh`), and then runs tasks from its own queue until it
reads None. A task is (task id, function name, arguments); the rank puts
(task id, rank, True, result) or (task id, rank, False, error text) on the
shared results queue. The module imports torch and the port only, so the
ranks never load jax.
"""

from __future__ import annotations

import datetime
import random
import traceback
from unittest import mock

import torch
import torch.distributed as dist

#: a collective that waits longer than this raises in the rank
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=240)


def rank_main(rank: int, world: int, addr: str, tasks, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)
    from lighthouse_tpu_torch.parallel import sharded

    groups = {n: sharded.make_mesh(n) for n in range(1, world + 1)}
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            tid, fn, args = task
            try:
                results.put((tid, rank, True, TASKS[fn](groups, *args)))
            except Exception as e:  # noqa: BLE001 - reported to the test, which fails on it
                results.put((tid, rank, False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
    finally:
        dist.destroy_process_group()


def verify(groups, W: int, sets, seed: int):
    """`sharded_verify_signature_sets` over the group of W ranks, with the
    (gt, ok, partials) it computed on the way: (verdict, gt, ok, partials)
    as numpy arrays."""
    from lighthouse_tpu_torch.parallel import sharded

    seen = []
    parts = sharded.sharded_verify_parts

    def spy(*a, **kw):
        seen.append(parts(*a, **kw))
        return seen[-1]

    with mock.patch.object(sharded, "sharded_verify_parts", spy):
        verdict = sharded.sharded_verify_signature_sets(
            sets, group=groups[W], rng=random.Random(seed).getrandbits, device="cpu"
        )
    gt, ok, partials = seen[0]
    return verdict, gt.numpy(), ok, partials.numpy()


def structural(groups, W: int, sets):
    """The verdict on `sets` with every collective made to raise."""
    from lighthouse_tpu_torch.parallel import sharded

    def refuse(*a, **kw):
        raise AssertionError("a collective ran")

    with mock.patch.object(dist, "broadcast", refuse), mock.patch.object(dist, "all_gather", refuse):
        return sharded.sharded_verify_signature_sets(sets, group=groups[W], device="cpu")


TASKS = {"verify": verify, "structural": structural}
