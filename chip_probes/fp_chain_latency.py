#!/usr/bin/env python3
"""Latency of fp384.cuh's Fp routines (the multi-word arithmetic inside
every kernel of the port) on one CUDA GPU, and their SASS by kind.

    python3 chip_probes/fp_chain_latency.py [--tree DIR] [--calls 512] [--reps 5] [--ptxas]

DIR (default: this checkout) is a checkout of the port; the probe builds
against its `csrc/fp384.cuh`, so it runs as it is on a `git archive` of
an older commit unpacked under `build/`. It writes one .cu into
`DIR/build/fp_chain_latency/` and builds it twice with nvcc: a shared
library and a cubin for `cuobjdump -sass`.

Latency: one warp (a one-block launch of 32 threads), each thread on its
own seeded operands, runs a dependent chain of `--calls` calls of one
routine (`#pragma unroll 1`; each call takes the last one's result),
with a `clock64()` stamp before and after the chain. A chain per case:

- `fp_mul`: x = x y R^-1;
- `mul_wide_redc1`: `fp_mul_wide(t, x, y)` then `fp_redc_wide<1>(x, t)`,
  the same value as `fp_mul` by a product then a reduction;
- `mac_wide_redc2`: t = w (a fixed sum of two products), `fp_mac_wide(t,
  x, y)`, `fp_redc_wide<2>(x, t)`: x = (w + x y) R^-1, N = 3 products;
- `fp_add`, `fp_sub`: x = x + y, x = x - y; `fp_neg`: x = -x;
- `fp_reduce_once`: x = `fp_reduce_once(x, 0)` (branch-free: its time
  does not depend on which side is taken);
- `fp_add_wide`: t = t + u over 24 words (mod 2^768).

Every thread's final value is held to Python integers. Prints one
`[fp_chain]` line per case: lane 0's SM clocks per call (the least of
`--reps` launches), the spread over the warp, microseconds per call at
the card's maximum SM clock (`nvidia-smi clocks.max.sm`), and max_abs_err.

SASS: one kernel per routine that loads its operands, calls the routine
once and stores the result; the counts of a kernel that only loads and
stores are taken off. Prints one `[fp_sass]` line per routine: the
instruction count and the counts by opcode (modifiers kept, as in
`IMAD.WIDE.U32` or `IADD3.X`), and ptxas's registers for the kernel.
With `--ptxas` it also compiles every `.cu` of DIR's `csrc/` as the
port's build does (one nvcc each, in parallel, `-Xptxas=-v`) and prints
one `[ptxas]` line per function ptxas reports (every kernel, and every
`__noinline__` routine): registers, stack frame, spill stores and loads.
Exits non-zero without a CUDA device or when a chain's value is wrong.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import pathlib
import random
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADER = pathlib.Path("lighthouse_tpu_torch/crypto/bls/torch_backend/csrc/fp384.cuh")

# case -> (operand arrays of 12 words, operand arrays of 24 words, loop body)
CASES = {
    "fp_mul": (("x", "y"), (), "fp_mul(x, x, y);"),
    "mul_wide_redc1": (("x", "y"), (), "fp_mul_wide(t, x, y);\n    fp_redc_wide<1>(x, t);"),
    "mac_wide_redc2": (("x", "y"), ("w",), "fp_copy_wide(t, w);\n    fp_mac_wide(t, x, y);\n"
                                           "    fp_redc_wide<2>(x, t);"),
    "fp_add": (("x", "y"), (), "fp_add(x, x, y);"),
    "fp_sub": (("x", "y"), (), "fp_sub(x, x, y);"),
    "fp_neg": (("x",), (), "fp_neg(x, x);"),
    "fp_reduce_once": (("x",), (), "fp_reduce_once(x, x, 0);"),
    "fp_add_wide": ((), ("t", "u"), "fp_add_wide(t, u);"),
}
# routine -> (12-word operands, 24-word operands, the one call, 12 or 24 output words)
ONCE = {
    "fp_mul": (("x", "y"), (), "fp_mul(r, x, y);", 12),
    "fp_mul_wide": (("x", "y"), (), "fp_mul_wide(t, x, y);", 24),
    "fp_mac_wide": (("x", "y"), ("t",), "fp_mac_wide(t, x, y);", 24),
    "fp_redc_wide_1": ((), ("t",), "fp_redc_wide<1>(r, t);", 12),
    "fp_redc_wide_2": ((), ("t",), "fp_redc_wide<2>(r, t);", 12),
    "fp_add": (("x", "y"), (), "fp_add(r, x, y);", 12),
    "fp_sub": (("x", "y"), (), "fp_sub(r, x, y);", 12),
    "fp_neg": (("x",), (), "fp_neg(r, x);", 12),
    "fp_reduce_once": (("x",), (), "fp_reduce_once(r, x, x[0] & 1u);", 12),
    "fp_add_wide": ((), ("t", "u"), "fp_add_wide(t, u);", 24),
    "copy": (("x",), (), "fp_copy(r, x);", 12),
}
THREADS = 32

_PRELUDE = """#include <cuda_runtime.h>
#include <stdint.h>

#include "fp384.cuh"

namespace {

__device__ __forceinline__ void fp_copy_wide(uint32_t r[FP_WIDE], const uint32_t a[FP_WIDE]) {
#pragma unroll
  for (int i = 0; i < FP_WIDE; ++i) r[i] = a[i];
}

}  // namespace
"""

_CHAIN = """
__global__ void __launch_bounds__(32) chain_{name}(const uint32_t* __restrict__ in12,
    const uint32_t* __restrict__ in24, uint32_t* __restrict__ out, long long* __restrict__ clocks, int calls) {{
  const int i = threadIdx.x;
  uint32_t t[FP_WIDE];
{decl}
  const long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < calls; ++k) {{
    {body}
  }}
  asm volatile("" ::"r"({last}));
  const long long t1 = clock64();
{store}
  clocks[i] = t1 - t0;
}}

extern "C" int run_chain_{name}(const void* in12, const void* in24, void* out, void* clocks, int calls, void* stream) {{
  chain_{name}<<<1, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)in12, (const uint32_t*)in24, (uint32_t*)out,
                                                  (long long*)clocks, calls);
  return (int)cudaGetLastError();
}}
"""

_ONCE = """
extern "C" __global__ void __launch_bounds__(32) once_{name}(const uint32_t* __restrict__ in12,
    const uint32_t* __restrict__ in24, uint32_t* __restrict__ out) {{
  const int i = threadIdx.x;
  uint32_t r[FP_WORDS], t[FP_WIDE];
{decl}
  {body}
{store}
}}
"""


def _decl(words12, words24) -> str:
    lines = []
    for j, v in enumerate(words12):
        lines.append(f"  uint32_t {v}[FP_WORDS];\n  fp_load({v}, in12 + ({j} * {THREADS} + i) * FP_WORDS);")
    for j, v in enumerate(words24):
        if v == "t":
            lines.append(f"#pragma unroll\n  for (int q = 0; q < FP_WIDE; ++q) t[q] = in24[({j} * {THREADS} + i) * FP_WIDE + q];")
        else:
            lines.append(f"  uint32_t {v}[FP_WIDE];\n#pragma unroll\n  for (int q = 0; q < FP_WIDE; ++q) "
                         f"{v}[q] = in24[({j} * {THREADS} + i) * FP_WIDE + q];")
    return "\n".join(lines)


def _store(var: str, words: int) -> str:
    return f"#pragma unroll\n  for (int q = 0; q < {words}; ++q) out[i * {words} + q] = {var}[q];"


def probe_source() -> str:
    """The probe's .cu: a chain kernel per case and a once kernel per routine."""
    parts = [_PRELUDE]
    for name, (w12, w24, body) in CASES.items():
        wide = name == "fp_add_wide"
        parts.append(_CHAIN.format(name=name, decl=_decl(w12, w24), body=body,
                                   last="t[0]" if wide else "x[0]",
                                   store=_store("t" if wide else "x", 24 if wide else 12)))
    for name, (w12, w24, body, words) in ONCE.items():
        parts.append(_ONCE.format(name=name, decl=_decl(w12, w24), body=body,
                                  store=_store("t" if words == 24 else "r", words)))
    return "\n".join(parts)


def expected(case: str, xs, ys, ws, us, calls: int, P: int, r_inv: int) -> list[int]:
    """Each thread's final value after `calls` calls, in Python integers
    (12-word cases) or mod 2^768 (`fp_add_wide`)."""
    got = []
    for i in range(THREADS):
        x = xs[i]
        for k in range(calls):
            if case in ("fp_mul", "mul_wide_redc1"):
                x = x * ys[i] * r_inv % P
            elif case == "mac_wide_redc2":
                x = (ws[i] + x * ys[i]) * r_inv % P
            elif case == "fp_add":
                x = (x + ys[i]) % P
            elif case == "fp_sub":
                x = (x - ys[i]) % P
            elif case == "fp_neg":
                x = -x % P
            elif case == "fp_add_wide":
                x = (x + us[i]) % (1 << 768)
        got.append(x)
    return got


def sass_counts(cuobjdump: str, cubin: pathlib.Path) -> dict[str, collections.Counter]:
    """Opcode counts (modifiers kept) of each `once_*` kernel's SASS."""
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True, text=True).stdout
    counts: dict[str, collections.Counter] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1) if m.group(1).startswith("once_") else None
            if current:
                counts[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and m:
            counts[current][m.group(1)] += 1
    return counts


def short_name(mangled: str) -> str:
    """The last plain identifier of an Itanium-mangled name
    (`_ZN12_GLOBAL__N_113fp_mul_kernelEPKj...` -> `fp_mul_kernel`)."""
    m = re.match(r"_ZN?L?", mangled)
    if not m:
        return mangled
    i, parts = m.end(), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        parts.append(mangled[j:j + n])
        i = j + n
    return parts[-1] if parts else mangled


def ptxas_table(log: str) -> dict[str, dict[str, int]]:
    """ptxas -v's report per function: registers (kernels), stack frame,
    spill stores and loads."""
    rows: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            cur = short_name(m.group(1))
            rows.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            rows[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows[cur]["registers"] = int(m.group(1))
    return rows


def report_ptxas(kernels, tree: pathlib.Path, out_dir: pathlib.Path) -> None:
    """Compile each unit of `tree`'s csrc/ as kernels.build() does and
    print ptxas's report, function by function."""
    csrc = tree / HEADER.parent
    units = sorted(p.name for p in csrc.glob("*.cu"))
    cmds = [[kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o", str(out_dir / f"{u}.o"), str(csrc / u)] for u in units]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    for unit, proc in zip(units, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {unit}:\n{log}")
        for name, row in ptxas_table(log).items():
            print(f"[ptxas] unit={unit} function={name} " + " ".join(f"{k}={v}" for k, v in sorted(row.items())),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    ap.add_argument("--calls", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fp_chain_latency: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp, kernels

    tree = args.tree.resolve()
    header = tree / HEADER
    out_dir = tree / "build" / "fp_chain_latency"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fp_chain_probe.cu"
    src.write_text(probe_source())
    nvcc = kernels._nvcc()
    flags = [f for f in kernels.NVCC_FLAGS if f != "-Xptxas=-v"]
    lib_path, cubin = out_dir / "fp_chain_probe.so", out_dir / "fp_chain_probe.cubin"
    built = subprocess.run([nvcc, *flags, "-Xptxas=-v", "-I", str(header.parent), "-shared", "-o", str(lib_path),
                            str(src)], capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    subprocess.run([nvcc, *flags[:2], "-O3", "-std=c++17", "-I", str(header.parent), "-cubin", "-o", str(cubin),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    smi = chip_smoke.nvidia_smi("name,power.limit")
    max_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm").split()[0])
    print(f"[fp_chain_probe] tree={tree} header_lines={len(header.read_text().splitlines())} "
          f'smi="{smi}" max_sm_mhz={max_mhz} calls={args.calls}', flush=True)

    rng = random.Random(29)
    r_inv = pow(fp.R_MONT, -1, P)
    xs = [P - 1] + [rng.randrange(P) for _ in range(THREADS - 1)]
    ys = [P - 1] + [rng.randrange(P) for _ in range(THREADS - 1)]
    ws = [rng.randrange(P) * rng.randrange(P) + rng.randrange(P) * rng.randrange(P) for _ in range(THREADS)]
    ts = [rng.randrange(1 << 768) for _ in range(THREADS)]
    us = [rng.randrange(1 << 768) for _ in range(THREADS)]

    def wide_words(vals):
        return [(v >> (32 * w)) & 0xFFFFFFFF for v in vals for w in range(24)]

    def dev(words):
        return torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for w in words], dtype=torch.int32).cuda()

    in12 = torch.cat([torch.from_numpy(fp.ints_to_words(v)).reshape(-1) for v in (xs, ys)]).cuda()
    worst = 0
    for case, (w12, w24, _) in CASES.items():
        wide = case == "fp_add_wide"
        in24 = dev(wide_words(ts + us) if wide else wide_words(ws))
        out = torch.zeros(THREADS * (24 if wide else 12), dtype=torch.int32, device="cuda")
        clocks = torch.zeros(THREADS, dtype=torch.int64, device="cuda")
        fn = getattr(lib, f"run_chain_{case}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        best = None
        for _ in range(args.reps):
            if fn(in12.data_ptr(), in24.data_ptr(), out.data_ptr(), clocks.data_ptr(), args.calls,
                  torch.cuda.current_stream().cuda_stream):
                raise RuntimeError(f"chain_{case} failed to launch")
            torch.cuda.synchronize()
            c = clocks.cpu().tolist()
            best = c if best is None or c[0] < best[0] else best
        words = [w & 0xFFFFFFFF for w in out.cpu().tolist()]
        n = 24 if wide else 12
        got = [sum(words[i * n + w] << (32 * w) for w in range(n)) for i in range(THREADS)]
        if case == "fp_reduce_once":
            want = xs
        else:
            want = expected(case, ts if wide else xs, ys, ws, us, args.calls, P, r_inv)
        err = max(abs(g - v) for g, v in zip(got, want))
        worst = max(worst, err)
        per = [b / args.calls for b in best]
        chip_smoke.phase("fp_chain", case=case, clocks_per_call=f"{per[0]:.1f}",
                         warp_min=f"{min(per):.1f}", warp_max=f"{max(per):.1f}",
                         us_per_call=f"{per[0] / max_mhz:.4f}", max_abs_err=err, smi=f'"{smi}"')

    counts = sass_counts(str(pathlib.Path(nvcc).with_name("cuobjdump")), cubin)
    base = counts.pop("once_copy")
    regs = dict(re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", built.stdout + built.stderr,
                           re.S))
    for fn_name, c in counts.items():
        net = collections.Counter({k: v - base.get(k, 0) for k, v in c.items()})
        net = {k: v for k, v in sorted(net.items(), key=lambda kv: (-kv[1], kv[0])) if v}
        chip_smoke.phase("fp_sass", routine=fn_name[len("once_"):], instructions=sum(net.values()),
                         registers=regs.get(fn_name, "?"), **net)
    if args.ptxas:
        report_ptxas(kernels, tree, out_dir)
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
