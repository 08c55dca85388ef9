#!/usr/bin/env python3
"""How often torch.profiler returns a verify's device trace empty or short.

    python3 chip_probes/profiler_traces.py [--windows 30]

`chip_smoke.py` takes the device busy time of a verify from a trace of
the device's activity only, and takes a trace again when it holds no
device event or another count than the verify's 155 device operations.
This probe traces one warm 128 x 1 and one 128 x 128 verify (chip_smoke's
batches) `--windows` times each in every variant below, the variants in
turns, and prints one `[traces]` line a variant and shape: the windows
that came back empty, short or long, and whole.

  device      ProfilerActivity.CUDA only, as chip_smoke.py traces
  settled     the same, with a synchronise and 20 ms of sleep inside the
              window after the verify, before the profiler stops
  host_device ProfilerActivity.CPU and CUDA

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

VARIANTS = ("device", "settled", "host_device")


def device_events(prof) -> int:
    calls = 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            calls += e.count
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=30)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_traces: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, kernels

    kernels.library()
    shapes = {"128x1": chip_smoke.make_sets(api, chip_smoke.N_SETS, 1),
              f"128x{chip_smoke.BLOCK_KEYS}": chip_smoke.make_sets(api, chip_smoke.N_SETS, chip_smoke.BLOCK_KEYS)}
    activities = {"device": [ProfilerActivity.CUDA], "settled": [ProfilerActivity.CUDA],
                  "host_device": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    counts = {(v, s): [] for v in VARIANTS for s in shapes}
    for sets in shapes.values():
        assert api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    for _ in range(args.windows):
        for shape, sets in shapes.items():
            for v in VARIANTS:
                with profile(activities=activities[v]) as prof:
                    api.verify_signature_sets(sets)
                    torch.cuda.synchronize()
                    if v == "settled":
                        time.sleep(0.02)
                counts[(v, shape)].append(device_events(prof))
    want = chip_smoke.VERIFY_DEVICE_OPS
    for (v, shape), seen in counts.items():
        chip_smoke.phase("traces", variant=v, shape=shape, windows=len(seen), empty=sum(c == 0 for c in seen),
                         short=sum(0 < c < want for c in seen), long=sum(c > want for c in seen),
                         whole=sum(c == want for c in seen), seen=",".join(map(str, seen)))
    chip_smoke.phase("device", smi=f'"{chip_smoke.nvidia_smi("name,power.limit")}"', torch=torch.__version__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
