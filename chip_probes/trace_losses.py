#!/usr/bin/env python3
"""Which device events a profiler trace of a verify loses, on one CUDA GPU,
and what `chip_smoke.head_loss` makes of real traces.

    python3 chip_probes/trace_losses.py [--windows 4]

Traces one warm 128 x 1 and one 128 x 128 verify (chip_smoke's batches)
`--windows` times each, tracing the device's activity only as
`chip_smoke.py` does, and prints one `[trace_losses]` line a window: the
device events it holds, the runtime calls that enqueued device operations
(`chip_smoke.ENQUEUE_CALLS`, recorded on the host's side of the trace),
against the most complete trace of the run the device events it lacks by
name, and `head_loss` of the trace as it came (`head_loss`) and with device
events taken out by place in start order: the first (`drop_0`), the first
two (`drop_01`, the loss `head_loss` accepts), the first and the sixth
(`drop_05`) and the first three (`drop_012`); the last two must give 0.
`lead_us` is the least time from a runtime call's start to the start of the
device event it enqueued, the events matched to the calls in order (a
negative lead, where the trace is whole, would make `head_loss` refuse the
loss it accepts). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

DROPS = {"drop_0": (0,), "drop_01": (0, 1), "drop_05": (0, 5), "drop_012": (0, 1, 2)}


def start(e):
    return e.time_range.start


class Dropped:
    """A trace with the device events at places `drop` (in start order)
    taken out of its events."""

    def __init__(self, events, drop):
        dev = sorted((e for e in events if str(e.device_type).endswith("CUDA")), key=start)
        gone = {id(dev[i]) for i in drop if i < len(dev)}
        self._events = [e for e in events if id(e) not in gone]

    def events(self):
        return self._events


def trace(torch, window):
    """(device event names in start order, enqueued operations, head_loss
    of the trace and of each of DROPS, least lead in us) of one trace."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
        time.sleep(chip_smoke.TRACE_SETTLE_S)
    events = list(prof.events())
    dev = sorted((e for e in events if str(e.device_type).endswith("CUDA")), key=start)
    calls = sorted((e for e in events if e.name in chip_smoke.ENQUEUE_CALLS), key=start)
    ops = chip_smoke.VERIFY_DEVICE_OPS
    losses = {"head_loss": chip_smoke.head_loss(prof, ops)}
    losses.update({k: chip_smoke.head_loss(Dropped(events, d), ops) for k, d in DROPS.items()})
    lead = min((start(d) - start(c) for c, d in zip(calls[len(calls) - len(dev):], dev)), default=None)
    return [e.name[:60] for e in dev], len(calls), losses, lead


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=4)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("trace_losses: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api

    got = {}
    for keys in (1, chip_smoke.BLOCK_KEYS):
        sets = chip_smoke.make_sets(api, chip_smoke.N_SETS, keys)
        for _ in range(3):
            api.verify_signature_sets(sets)
        torch.cuda.synchronize()
        got[keys] = [trace(torch, lambda: api.verify_signature_sets(sets)) for _ in range(args.windows)]
    whole = max((names for runs in got.values() for names, *_ in runs), key=len)
    card = chip_smoke.nvidia_smi("name,power.limit")
    for keys, runs in got.items():
        for w, (names, enqueued, losses, lead) in enumerate(runs):
            lacks = collections.Counter(whole) - collections.Counter(names)
            chip_smoke.phase("trace_losses", shape=f"{chip_smoke.N_SETS}x{keys}", window=w, device_events=len(names),
                             enqueued=enqueued, first=f'"{names[0] if names else None}"',
                             lacks=f'"{dict(lacks)}"', **losses, lead_us=lead, card=f'"{card}"')
    return 0


if __name__ == "__main__":
    sys.exit(main())
