#!/usr/bin/env python3
"""Phase times of the product-tree K21 `miller_inputs_kernel` on one CUDA GPU.

    python3 chip_probes/k21_tree_phases.py --tree DIR [--sets 128] [--reps 5]

DIR is a checkout whose `csrc/verify_kernels.cu` holds the one-block K21
(a product tree over the 2S + 1 denominators, one inversion of the root,
the inverses back down; commit 0e74f79 and before). The probe copies
that source beside it with `clock64()` stamps taken by thread 0 at the
start of each phase and at the end (one `__syncthreads` added before the
G2 lanes and one at the end, so each stamp closes a phase of the whole
block), builds the copy alone with nvcc, runs it through DIR's own
`api.miller_inputs` (its other kernels DIR's own build) on
`chip_smoke.miller_input_points` (the `[timing]` operands), checks the
outputs against the plain version, and prints one `[k21_phases]` line:
each phase's SM clocks and microseconds at the card's maximum SM clock
(`nvidia-smi clocks.max.sm`), the kernel's device ms (profiler) beside
their sum, and the clock that the stamps' span over the device time
implies. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

PHASES = ("leaves", "up", "root_inversion", "down", "g1_lanes", "g2_lanes")
# (marker in the source, code inserted before it); stamp i opens phase i
_MARKS = (
    ("  // the leaves:", "  if (t == 0) k21_stamps[0] = clock64();\n"),
    ("  // up: node i", "  if (t == 0) k21_stamps[1] = clock64();\n"),
    ("  // the root's inverse", "  if (t == 0) k21_stamps[2] = clock64();\n"),
    ("  // down: each node", "  if (t == 0) k21_stamps[3] = clock64();\n"),
    ("  // G1 lanes:", "  if (t == 0) k21_stamps[4] = clock64();\n"),
    ("  // G2 lanes:", "  __syncthreads();\n  if (t == 0) k21_stamps[5] = clock64();\n"),
)
_END = "    q_in[j] = inf ? 1 : 0;\n  }\n}"
_STAMPS = """
__device__ long long k21_stamps[7];

extern "C" int lh_k21_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, k21_stamps, sizeof(k21_stamps));
}
"""


def stamped_source(src: str) -> str:
    for mark, code in _MARKS:
        if src.count(mark) != 1:
            raise SystemExit(f"marker {mark!r} not found once: not the product-tree K21")
        src = src.replace(mark, code + mark)
    if src.count(_END) != 1:
        raise SystemExit("the end of the G2 lanes not found once: not the product-tree K21")
    src = src.replace(_END, _END[:-1] + "  __syncthreads();\n  if (t == 0) k21_stamps[6] = clock64();\n}")
    head = src.index("namespace {")
    return src[:head] + _STAMPS + src[head:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, type=pathlib.Path)
    ap.add_argument("--sets", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k21_tree_phases: no CUDA device available", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, kernels

    csrc = tree / "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc"
    probe = csrc / "verify_kernels_stamped.cu"
    probe.write_text(stamped_source((csrc / "verify_kernels.cu").read_text()))
    lib_path = tree / "build" / "k21_tree_phases.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(probe)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.lh_miller_inputs.argtypes = kernels._SIGNATURES["lh_miller_inputs"]
    lib.lh_k21_stamps.argtypes = [ctypes.c_void_p]

    S = args.sets
    pts = chip_smoke.miller_input_points(torch, fp, curve, S, 31 + S)  # on DIR's own kernels
    launch = kernels.launch

    def stamped_launch(name, device, *largs):  # K21 from the stamped copy, the rest as built
        if name != "lh_miller_inputs":
            return launch(name, device, *largs)
        with torch.cuda.device(device):
            if lib.lh_miller_inputs(*largs, torch.cuda.current_stream(device).cuda_stream) != 0:
                raise RuntimeError("the stamped K21 failed to launch")

    kernels.launch = stamped_launch
    got, want = api.miller_inputs(*pts), api.miller_inputs_plain(*pts)
    torch.cuda.synchronize()
    err = chip_smoke.max_word_err(got, want)
    stamps = (ctypes.c_longlong * 7)()
    clocks = [0] * len(PHASES)
    for _ in range(args.reps):
        api.miller_inputs(*pts)
        torch.cuda.synchronize()
        if lib.lh_k21_stamps(stamps) != 0:
            raise RuntimeError("reading the stamps failed")
        for i in range(len(PHASES)):
            clocks[i] += stamps[i + 1] - stamps[i]
    clocks = [c / args.reps for c in clocks]
    device_ms = chip_smoke.kernel_device_ms(lambda: api.miller_inputs(*pts), args.reps, "miller_inputs_kernel")
    max_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm").split()[0])
    us = [c / max_mhz for c in clocks]
    chip_smoke.phase("k21_phases", sets=S, smi=f'"{chip_smoke.nvidia_smi("name,power.limit")}"',
                     max_sm_mhz=max_mhz, max_abs_err=err, **{f"{p}_clocks": f"{c:.0f}" for p, c in zip(PHASES, clocks)},
                     **{f"{p}_us": f"{u:.2f}" for p, u in zip(PHASES, us)}, sum_us=f"{sum(us):.2f}",
                     device_ms=f"{device_ms:.5f}", implied_mhz=f"{sum(clocks) / (device_ms * 1e3):.0f}")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
