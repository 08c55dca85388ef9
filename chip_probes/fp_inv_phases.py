#!/usr/bin/env python3
"""Phase times of fp384.cuh's `fp_inv` (the binary GCD every inverting
kernel runs) on one CUDA GPU.

    python3 chip_probes/fp_inv_phases.py [--n 256] [--reps 5]

The probe copies the port's `csrc/fp384.cuh` into `build/fp_inv_phases/`
with `clock64()` stamps in `fp_inv`: in each of the 26 batches, one at the
start, one after the two-word approximations (the bit length and the
windows), one after the 30 divsteps, one after the two combinations
a f + b g, one after the two updates u f + v g with their Montgomery word
step, one after the copies; then one around the closing Montgomery
product. An empty `asm volatile` that takes the phase's results keeps
each stamp after the work it closes. Thread 0 of block 0 sums each phase
over the batches. A one-thread-an-element kernel (32-thread blocks, as
K21 and K25 run `fp_inv`) is built twice with nvcc, over the stamped copy
and over the source as it is, and run on n seeded values (0, one, p - 1,
p - 2 among them); both outputs are held to the port's plain `fp.inv` on
the CPU. Prints one `[fp_inv_phases]` line: each phase's SM clocks over
the 26 batches and microseconds at the card's maximum SM clock
(`nvidia-smi clocks.max.sm`), their sum, both kernels' device ms
(profiler), and the clock the stamps' span over the stamped kernel's
device time implies. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import random
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("approx", "divsteps", "combine", "update", "copy", "closing")
# (marker in fp_inv, code inserted before it)
_MARKS = (
    ("    const int n = max(fp_inv_bit_length(x, y), 2 * FP_INV_STEPS + 2);\n",
     "    const long long s0 = clock64();\n"),
    ("    int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;\n",
     "    asm volatile(\"\" ::\"l\"(ah), \"l\"(bh));\n    const long long s1 = clock64();\n"),
    ("    const bool neg_a = fp_inv_combine(na, x, y, f0, g0);\n",
     "    asm volatile(\"\" ::\"r\"(f0), \"r\"(g0), \"r\"(f1), \"r\"(g1));\n    const long long s2 = clock64();\n"),
    ("    fp_inv_update(x, u, v, f0, g0);",
     "    asm volatile(\"\" ::\"r\"(na[FP_WORDS - 1]), \"r\"(nb[FP_WORDS - 1]));\n"
     "    const long long s3 = clock64();\n"),
    ("    fp_copy(u, x);\n",
     "    asm volatile(\"\" ::\"r\"(x[FP_WORDS - 1]), \"r\"(y[FP_WORDS - 1]));\n    const long long s4 = clock64();\n"),
)
_ZERO = "  const bool zero = fp_is_zero(a);\n"
_LOOP_END = "    fp_copy(y, nb);\n  }\n  fp_mul(v, v, FP_INV_C);\n"
_LOOP_END_STAMPED = """    fp_copy(y, nb);
    asm volatile("" ::"r"(u[0]), "r"(v[0]), "r"(x[0]), "r"(y[0]));
    const long long s5 = clock64();
    ph[0] += s1 - s0;
    ph[1] += s2 - s1;
    ph[2] += s3 - s2;
    ph[3] += s4 - s3;
    ph[4] += s5 - s4;
  }
  const long long s6 = clock64();
  fp_mul(v, v, FP_INV_C);
  asm volatile("" ::"r"(v[FP_WORDS - 1]));
  ph[5] = clock64() - s6;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) fp_inv_phase_clocks[i] = ph[i];
  }
"""
_PROBE = """#include <cuda_runtime.h>
#include <stdint.h>

__device__ long long fp_inv_phase_clocks[6];

#include "{header}"

namespace {{

__global__ void __launch_bounds__(32) fp_inv_probe_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                                          long long n) {{
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FP_WORDS];
  fp_load(x, a + i * FP_WORDS);
  fp_inv(x, x);
  fp_store(out + i * FP_WORDS, x);
}}

}}  // namespace

extern "C" int lh_fp_inv_probe(const void* a, void* out, long long n, void* stream) {{
  fp_inv_probe_kernel<<<(unsigned)((n + 31) / 32), 32, 0, (cudaStream_t)stream>>>((const uint32_t*)a, (uint32_t*)out,
                                                                                  n);
  return (int)cudaGetLastError();
}}

extern "C" int lh_fp_inv_phase_clocks(long long* host) {{
  return (int)cudaMemcpyFromSymbol(host, fp_inv_phase_clocks, sizeof(fp_inv_phase_clocks));
}}
"""


def stamped_header(src: str) -> str:
    """fp384.cuh with fp_inv's phase stamps (see the module's docstring)."""
    for mark, code in _MARKS:
        if src.count(mark) != 1:
            raise SystemExit(f"marker {mark!r} not found once: not the binary-GCD fp_inv")
        src = src.replace(mark, code + mark)
    if src.count(_ZERO) != 1 or src.count(_LOOP_END) != 1:
        raise SystemExit("fp_inv's start or the end of its batch loop not found once")
    src = src.replace(_ZERO, _ZERO + "  long long ph[6] = {0, 0, 0, 0, 0, 0};\n")
    return src.replace(_LOOP_END, _LOOP_END_STAMPED)


def build(kernels, out_dir: pathlib.Path, header: pathlib.Path, name: str):
    probe = out_dir / f"{name}.cu"
    probe.write_text(_PROBE.format(header=header.name))
    lib_path = out_dir / f"{name}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(header.parent), "-shared", "-o", str(lib_path),
                    str(probe)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.lh_fp_inv_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.lh_fp_inv_phase_clocks.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fp_inv_phases: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp, kernels

    out_dir = ROOT / "build" / "fp_inv_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = kernels.CSRC / "fp384.cuh"
    stamped = out_dir / "fp384_stamped.cuh"
    stamped.write_text(stamped_header(source.read_text()))
    libs = {"stamped": build(kernels, out_dir, stamped, "fp_inv_stamped"),
            "plain": build(kernels, out_dir, source, "fp_inv_plain")}

    rng = random.Random(7)
    vals = [0, fp.R_MONT, P - 1, P - 2] + [rng.randrange(P) for _ in range(args.n - 4)]
    a_cpu = torch.from_numpy(fp.ints_to_words(vals[: args.n]))
    a = a_cpu.cuda()
    want = fp.inv(a_cpu)
    outs = {k: torch.empty_like(a) for k in libs}

    def run(k):
        if libs[k].lh_fp_inv_probe(a.data_ptr(), outs[k].data_ptr(), args.n, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"the {k} probe failed to launch")

    errs = {}
    for k in libs:
        run(k)
        torch.cuda.synchronize()
        errs[k] = chip_smoke.max_word_err(outs[k].cpu(), want)
    stamps = (ctypes.c_longlong * 6)()
    clocks = [0.0] * len(PHASES)
    for _ in range(args.reps):
        run("stamped")
        torch.cuda.synchronize()
        if libs["stamped"].lh_fp_inv_phase_clocks(stamps) != 0:
            raise RuntimeError("reading the stamps failed")
        clocks = [c + s / args.reps for c, s in zip(clocks, stamps)]
    ms = {k: chip_smoke.kernel_device_ms(lambda k=k: run(k), args.reps, "fp_inv_probe_kernel") for k in libs}
    max_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm").split()[0])
    us = [c / max_mhz for c in clocks]
    chip_smoke.phase("fp_inv_phases", n=args.n, smi=f'"{chip_smoke.nvidia_smi("name,power.limit")}"',
                     max_sm_mhz=max_mhz, max_abs_err=max(errs.values()), batches=chip_smoke.FP_INV_BATCHES,
                     **{f"{p}_clocks": f"{c:.0f}" for p, c in zip(PHASES, clocks)},
                     **{f"{p}_us": f"{u:.2f}" for p, u in zip(PHASES, us)}, sum_us=f"{sum(us):.2f}",
                     stamped_device_ms=f"{ms['stamped']:.5f}", plain_device_ms=f"{ms['plain']:.5f}",
                     implied_mhz=f"{sum(clocks) / (ms['stamped'] * 1e3):.0f}")
    return 0 if max(errs.values()) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
