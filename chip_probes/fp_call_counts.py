#!/usr/bin/env python3
"""Calls of fp384.cuh's routines in one batched verify, counted on one CUDA
GPU: how many Fp products, reductions, additions and inversions the
kernels of a verify run through those routines.

    python3 chip_probes/fp_call_counts.py [--tree DIR] [--keys 1]

DIR (default: this checkout) is a checkout of the port. The probe copies
its `csrc/` into `DIR/build/fp_call_counts/csrc/` with one counter a
routine in `fp384.cuh` (a per-unit `__device__` array, one `atomicAdd` at
the top of each routine's body, so every thread's every call counts,
nested calls included: `fp_mul` and `fp_add` call `fp_reduce_once`,
`fp_inv` calls `fp_neg` and `fp_reduce_once`) and a host function in each
`.cu` that reads its unit's counters; builds the library from the copy
(the port's own build, `kernels.CSRC` and `kernels.BUILD_DIR` pointed at
it); runs a 128-set verify with `--keys` keys a set (`chip_smoke.make_sets`)
once to warm, then once counted, and checks the verdict. Prints one
`[fp_calls]` line per unit (the kernels it holds on the verify path) and
one for the whole verify: the calls of each routine, and the totals of Fp
products (`fp_mul`, `fp_mul_wide`, `fp_mac_wide`), reductions
(`fp_redc_wide`) and additions (`fp_add`, `fp_sub`, `fp_neg`). A thread
that runs a routine counts once whether or not its result is kept, as
the card runs it. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = pathlib.Path("lighthouse_tpu_torch/crypto/bls/torch_backend/csrc")
ROUTINES = ("fp_reduce_once", "fp_mul", "fp_add", "fp_sub", "fp_neg", "fp_mul_wide", "fp_add_wide", "fp_mac_wide",
            "fp_redc_wide", "fp_inv")
PRODUCTS = ("fp_mul", "fp_mul_wide", "fp_mac_wide")
ADDITIONS = ("fp_add", "fp_sub", "fp_neg")
# the units whose kernels a verify launches, and those kernels
PATH_UNITS = {
    "curve_kernels": "K10 K11", "pairing_kernels": "K12", "h2c_kernels": "K13 K14", "fold_kernels": "K15 K16 K18",
    "cofactor_kernels": "K17", "final_exponentiation_kernels": "K19", "verify_kernels": "K20 K21",
}

_COUNTERS = f"""
static __device__ unsigned long long fp_calls[{len(ROUTINES)}];
#define FP_COUNT(k) atomicAdd(&fp_calls[k], 1ull)
"""


def stamped_header(src: str) -> str:
    """fp384.cuh with a counter at the top of each routine's body."""
    src = src.replace("#pragma once\n", "#pragma once\n" + _COUNTERS, 1)
    for k, name in enumerate(ROUTINES):
        pat = re.compile(r"(\bvoid " + name + r"\([^)]*\)\s*\{)")
        if len(pat.findall(src)) != 1:
            raise SystemExit(f"{name} not found once in fp384.cuh")
        src = pat.sub(lambda m, k=k: m.group(1) + f"\n  FP_COUNT({k});", src)
    return src


def stamped_unit(src: str, stem: str) -> str:
    """A .cu with a host function that copies its unit's counters out."""
    return src + f"""
extern "C" int lh_fp_calls_{stem}(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, fp_calls, sizeof(fp_calls));
}}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    ap.add_argument("--keys", type=int, default=1)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("fp_call_counts: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, kernels

    src_dir = tree / CSRC
    out = tree / "build" / "fp_call_counts"
    stamped = out / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    stamped.mkdir(parents=True)
    for path in src_dir.iterdir():
        text = path.read_text()
        if path.name == "fp384.cuh":
            text = stamped_header(text)
        elif path.suffix == ".cu":
            text = stamped_unit(text, path.stem)
        (stamped / path.name).write_text(text)
    kernels.CSRC = stamped
    kernels.BUILD_DIR = out / "lib"
    lib = kernels.library()
    units = sorted(p.stem for p in stamped.glob("*.cu"))

    def read() -> dict[str, list[int]]:
        counts = {}
        for stem in units:
            buf = (ctypes.c_ulonglong * len(ROUTINES))()
            if getattr(lib, f"lh_fp_calls_{stem}")(ctypes.byref(buf)) != 0:
                raise RuntimeError(f"reading {stem}'s counters failed")
            counts[stem] = list(buf)
        return counts

    sets = chip_smoke.make_sets(api, chip_smoke.N_SETS, args.keys)
    assert api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    before = read()
    ok = api.verify_signature_sets(sets)
    torch.cuda.synchronize()
    after = read()
    assert ok, "the counted verify failed"
    smi = chip_smoke.nvidia_smi("name,power.limit")
    total = [0] * len(ROUTINES)
    shape = f"{chip_smoke.N_SETS}x{args.keys}"
    for stem in units:
        d = [a - b for a, b in zip(after[stem], before[stem])]
        total = [t + x for t, x in zip(total, d)]
        if any(d):
            fields = dict(zip(ROUTINES, d))
            chip_smoke.phase("fp_calls", shape=shape, unit=stem, kernels=f'"{PATH_UNITS.get(stem, "")}"',
                             products=sum(fields[r] for r in PRODUCTS), additions=sum(fields[r] for r in ADDITIONS),
                             **fields)
    fields = dict(zip(ROUTINES, total))
    chip_smoke.phase("fp_calls", shape=shape, unit="verify", products=sum(fields[r] for r in PRODUCTS),
                     reductions=fields["fp_redc_wide"], additions=sum(fields[r] for r in ADDITIONS),
                     smi=f'"{smi}"', **fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())
