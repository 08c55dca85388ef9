#!/usr/bin/env python3
"""K5's and K4's launch forms, timed against each other and against an
older checkout's kernels, on one CUDA GPU.

    python3 chip_probes/k4_k5_schedules.py [--parent DIR] [--reps 5]

K5 `g1_subgroup_check_kernel` (csrc/g1_kernels.cu): this checkout's
kernel and copies of it with one change each (`K5_VARIANTS`: launch
bounds that hold a thread to 170, 128 or 102 registers, so that 12, 16
or 20 one-warp blocks fit an SM). K4 `fp_batch_inv_kernel` (csrc/fp_kernels.cu), which picks
its threads a column by the column count in `chunks_per_column`: a copy
whose rule returns a value set from the host (`lh_force`, 0 keeps the
rule) before it applies its own. Each source is built alone with nvcc
(`-Xptxas=-v`) into `build/k4_k5_schedules/`, and, with `--parent`, DIR's
own `g1_kernels.cu` and `fp_kernels.cu` likewise (DIR a `git archive` of
an older commit unpacked under `build/`), all at once.

K5 runs on admission keys staged as `chip_smoke.py [pk]` stages them (256
interop keys, every eighth key one of `chip_smoke.invalid_encodings`),
tiled to each of K5_SHAPES; K4 on `chip_smoke.field_inputs` values with
zero entries, at each of K4_SHAPES. Each variant's output is held to the
plain version (`curve.g1_subgroup_check_plain`, `fp.batch_inv_plain`) on
the same card tensors. At each shape the variants are timed in turns,
forward then backward (parent, this checkout's, each K5 variant, then
back; parent, 32, 8, 1, 1, 8, 32, parent threads a column): device ms per
launch from the profiler (`chip_smoke.kernel_device_ms`). Prints one
`[k5_schedule]` or `[k4_schedule]` line per shape, each variant's two
times and max_abs_err, one `[ptxas]` line per kernel built, and the
card's name and power limit. Exits non-zero without a CUDA device or when
a variant's output differs from the plain version's.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = pathlib.Path("lighthouse_tpu_torch/crypto/bls/torch_backend/csrc")
OUT = ROOT / "build" / "k4_k5_schedules"
K5_SHAPES = (16, 256, 1024, 4096, 8192, 16384)
K4_SHAPES = ((257, 1), (257, 8), (257, 128), (257, 1024), (257, 4096), (257, 16384))
# K5's copies: name -> (text, replacement)
K5_VARIANTS = {f"bounds{b}": ("__launch_bounds__(kThreads) g1_subgroup_check_kernel",
                              f"__launch_bounds__(kThreads, {b}) g1_subgroup_check_kernel") for b in (12, 16, 20)}
K4_CHUNKS = (32, 8, 1)
# the hook: a value the host sets, which the rule returns when it is not 0
_HOOK = """
static int lh_forced = 0;
extern "C" void lh_force(int v) { lh_forced = v; }
"""
_RULE = "inline int chunks_per_column(long long lanes) { return "


def variant_source(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"{old!r} not found once in the source")
    return src.replace(old, new)


def forced_source(src: str) -> str:
    if src.count(_RULE) != 1 or src.count("namespace {") != 1:
        raise SystemExit(f"fp_kernels.cu: the launcher's rule {_RULE!r} not found once")
    src = src.replace(_RULE, _RULE.replace("{ return ", "{ if (lh_forced) return lh_forced; return "))
    head = src.index("namespace {")
    return src[:head] + _HOOK + src[head:]


def build(jobs: list[tuple[str, pathlib.Path, pathlib.Path]]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build each (tag, source, include dir) alone into a shared library,
    all at once; tag -> (the library, ptxas's report)."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src, inc in jobs:
        lib = OUT / f"{tag}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(inc), "-shared", "-o", str(lib), str(src)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"{tag}: nvcc failed\n{log}")
        libs[tag] = (ctypes.CDLL(str(lib)), log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4_k5_schedules: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, curve, fp, kernels

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)  # the copies are written before the build
    csrc = ROOT / CSRC
    jobs = [("k5_tree", csrc / "g1_kernels.cu", csrc)]
    for name, (old, new) in K5_VARIANTS.items():
        copy = OUT / f"k5_{name}.cu"
        copy.write_text(variant_source((csrc / "g1_kernels.cu").read_text(), old, new))
        jobs.append((f"k5_{name}", copy, csrc))
    copy = OUT / "k4_forced.cu"
    copy.write_text(forced_source((csrc / "fp_kernels.cu").read_text()))
    jobs.append(("k4_forced", copy, csrc))
    if args.parent:
        pcsrc = args.parent.resolve() / CSRC
        jobs += [("k5_parent", pcsrc / "g1_kernels.cu", pcsrc), ("k4_parent", pcsrc / "fp_kernels.cu", pcsrc)]
    libs = build(jobs)
    for tag, (lib, log) in libs.items():
        k5 = tag.startswith("k5")
        fn = lib.lh_g1_subgroup_check if k5 else lib.lh_fp_batch_inv
        fn.argtypes = kernels._SIGNATURES["lh_g1_subgroup_check" if k5 else "lh_fp_batch_inv"]
        if tag == "k4_forced":
            lib.lh_force.argtypes = [ctypes.c_int]
        kernel = "g1_subgroup_check_kernel" if k5 else "fp_batch_inv_kernel"
        cs.phase("ptxas", build=tag, kernel=kernel, ptxas=f'"{cs.ptxas_summary(log, kernel)}"')
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def in_turns(one):
        """(label, library, forced value), forward then backward."""
        return one + one[::-1]

    k5_variants = in_turns(([("parent", libs["k5_parent"][0], None)] if args.parent else [])
                           + [(tag[3:], libs[tag][0], None) for tag in ["k5_tree", *(f"k5_{v}" for v in K5_VARIANTS)]])
    k4_variants = in_turns(([("parent", libs["k4_parent"][0], None)] if args.parent else [])
                           + [(str(c), libs["k4_forced"][0], c) for c in K4_CHUNKS])

    def timed(rows, label, run, kernel, check):
        err = check(run())
        ms = cs.kernel_device_ms(run, args.reps, kernel)
        rows.setdefault(label, ([], []))
        rows[label][0].append(ms)
        rows[label][1].append(err)

    def report(tag, shape, rows, key):
        fields = {f"{key}_{label}_ms": ",".join(f"{m:.5f}" for m in ms) for label, (ms, _) in rows.items()}
        errs = {label: max(e) for label, (_, e) in rows.items()}
        cs.phase(tag, shape=shape, **fields, max_abs_err=max(errs.values()))
        return max(errs.values())

    failures = 0
    # K5: admission keys as [pk] stages them, tiled
    valid = [api.interop_keypair(i)[1].to_bytes() for i in range(cs.PK_DISTINCT)]
    invalid = list(cs.invalid_encodings().values())
    keys = cs.admission_keys(valid, invalid, cs.PK_DISTINCT + cs.PK_DISTINCT // (cs.PK_INVALID_EVERY - 1) + 1)
    x, y, inf, _ = api.stage_public_keys(keys)
    m = len(keys)
    beta = fp.const(curve.PHI_BETA, dev)
    for n in K5_SHAPES:
        idx = np.arange(n) % m
        xw, yw = fp.from_jax_limbs(x[idx], dev), fp.from_jax_limbs(y[idx], dev)
        infd = torch.from_numpy(np.ascontiguousarray(inf[idx])).to(dev)
        want = curve.g1_subgroup_check_plain(xw, yw, infd)
        out = torch.empty(n, dtype=torch.bool, device=dev)
        rows = {}
        for label, lib, _ in k5_variants:
            def run(lib=lib):
                if lib.lh_g1_subgroup_check(xw.data_ptr(), yw.data_ptr(), infd.data_ptr(), beta.data_ptr(),
                                            out.data_ptr(), n, stream()) != 0:
                    raise RuntimeError("K5 failed to launch")
                return out

            timed(rows, label, run, "g1_subgroup_check_kernel", lambda got: int((got != want).sum()))
        failures += report("k5_schedule", n, rows, "k5") != 0
    # K4: seeded values with zero entries
    for steps, lanes in K4_SHAPES:
        a = cs.field_inputs(fp, P, steps * lanes, 40 + lanes, dev)[8 : 8 + steps * lanes]
        a = a.reshape(steps, lanes, fp.WORDS).contiguous()
        a[::7, :: max(1, lanes // 3)] = 0
        want = fp.batch_inv_plain(a)
        out = torch.empty_like(a)
        rows = {}
        for label, lib, c in k4_variants:
            def run(lib=lib, c=c):
                if c is not None:
                    lib.lh_force(c)
                if lib.lh_fp_batch_inv(a.data_ptr(), out.data_ptr(), steps, lanes, stream()) != 0:
                    raise RuntimeError("K4 failed to launch")
                return out

            timed(rows, label, run, "fp_batch_inv_kernel", lambda got: cs.max_word_err(got, want))
        failures += report("k4_schedule", f"{steps}x{lanes}", rows, "chunks") != 0
    print(cs.nvidia_smi("name,power.limit"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
