#!/usr/bin/env python3
"""Phase times of K9 `cyclotomic_pow_x` (the |z|-power chain) and of K19
`final_exponentiation` (which runs K9's routine five times) on one CUDA
GPU.

    python3 chip_probes/k9_chain_phases.py [--tree DIR] [--reps 5]

DIR (default: this checkout) is a checkout of the port. The probe copies
its `csrc/final_exp.cuh`, `final_exp_kernels.cu` and
`final_exponentiation_kernels.cu` into `DIR/build/k9_chain_phases/` with
`clock64()` stamps taken by thread 0 (lane 0 of the one-warp block, which
takes part in every phase): each stamp closes a phase of
`cyclotomic_pow_x_block` and adds its clocks to that phase's sum. Two
layouts are known, and the source says which:

- the six-thread routine (commit 50cb302 and before): the compression;
  the 63 squarings split into the products (twelve threads), the first
  `__syncthreads`, the additions (eight threads) and the second barrier,
  each summed over the steps; the decompression's part before the norms'
  inversion (six threads); the inversion (Montgomery's trick and
  `fp_inv` on thread 0); the part after; the product of six, level by
  level (three levels of K8's six-thread routine);
- the register chain (`kPowLane`): the compression; the 63 squarings
  split into the product (operand shuffles, the product, the pair's sum,
  the reduction) and the update (shuffles and additions, the checkpoint
  stores), each summed over the steps; the decompression's two parts;
  the inversion (the product tree over the lanes and `fp_inv`); the
  product of six, product by product (five of K8's 24-lane routine).

The register chain's source marks each phase's end with a `// K9_PHASE(i)`
line, which the probe turns into the stamp; the six-thread routine had no
such lines, so the probe finds its phases by the text around them.

In K19 the probe also stamps every step of the kernel's body: the five
chains, `fp12_mul_block` (the 14 products, 4 of them inside
`fp12_inv_block`), `fp12_inv_block`, `frobenius_block` and
`fp12_conj_block`, each with its count, and the whole body. Each stamped
.cu is built alone with nvcc and run at n = 1 (the verify's shape) on a
cyclotomic element (K9: the easy part of a seeded random element) or a
seeded random element (K19); both outputs are held to the plain versions
on the card. Prints one `[k9_phases]` and one `[k19_phases]` line: each
phase's SM clocks and microseconds at the card's maximum SM clock
(`nvidia-smi clocks.max.sm`), the stamped and the tree's own kernel's
device ms (profiler), and the clock the stamps' span over the stamped
kernel's device time implies. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import random
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_MARK = """
#define K9_MARK(i)                                     \\
  do {                                                 \\
    asm volatile("" ::: "memory");                     \\
    const long long k9_now_ = clock64();               \\
    k9_ph_[i] += k9_now_ - k9_st_;                     \\
    k9_st_ = k9_now_;                                  \\
  } while (0)
__device__ long long k9_phase_clocks[16];
"""
_ROUTINE = "__device__ __noinline__ void cyclotomic_pow_x_block(const uint32_t* g, uint32_t* out, PowXShared& sh) {\n"
_START = "  long long k9_ph_[16] = {0};\n  long long k9_st_ = clock64();\n"
_WRITE = """  if (threadIdx.x == 0 && blockIdx.x == 0) {
    for (int i = 0; i < 16; ++i) k9_phase_clocks[i] += k9_ph_[i];
  }
"""

# layout -> phase names, in the order of the K9_MARK arguments
NAMES = {
    "six_thread": ("compress", "step_products", "step_barrier_1", "step_additions", "step_barrier_2",
                   "decompress_1", "inversion", "decompress_2", "level_0", "level_1", "level_2"),
    "register_chain": ("compress", "step_product", "step_update", "decompress_1", "inversion", "decompress_2",
                       "product_0", "product_1", "product_2", "product_3", "product_4"),
}
# the register chain's `// K9_PHASE(i)` lines, in source order
PHASE_LINE = re.compile(r"^( *)// K9_PHASE\((.+)\)$", re.M)
PHASES = ("0", "1", "2", "3", "4", "5", "6 + i")
# the six-thread routine: (text in the source, K9_MARK argument inserted
# before it); the routine's end and its stamped form, which closes the
# last level and adds the sums to k9_phase_clocks
SIX_THREAD = (
    (("#pragma unroll 1\n  for (int s = 1; s <= kSteps; ++s) {\n", "0"),
     ("    __syncthreads();\n    if (t < 8) {  // new coordinate", "1"),
     ("    if (t < 8) {  // new coordinate", "2"),
     ("    __syncthreads();\n  }\n\n  // decompress, one checkpoint a thread", "3"),
     ("  }\n\n  // decompress, one checkpoint a thread", "4"),
     ("  // the shared inversion", "5"),
     ("  // decompress: g1 = num / den", "6"),
     ("  // ((f0 f3)(f1 f4))(f2 f5)", "7")),
    "    __syncthreads();\n  }\n}\n\n}  // namespace",
    "    __syncthreads();\n    K9_MARK(8 + level);\n  }\n" + _WRITE + "}\n\n}  // namespace",
)

K19_KINDS = ("chain", "fp12_mul", "fp12_inv", "frobenius", "conj", "inv_muls", "body")
_K19_DEVICE = """
__device__ long long k19_clocks[7];
__device__ int k19_counts[7];
#define K19_ADD(i, clocks)                               \\
  do {                                                   \\
    if (threadIdx.x == 0 && blockIdx.x == 0) {           \\
      k19_clocks[i] += (clocks);                         \\
      k19_counts[i] += 1;                                \\
    }                                                    \\
  } while (0)
"""
_ACCESS = """
extern "C" int {prefix}_read(long long* k9, long long* k19, int* counts) {{
  int e = (int)cudaMemcpyFromSymbol(k9, k9_phase_clocks, 16 * sizeof(long long));
  {k19_read}
  return e;
}}

extern "C" int {prefix}_zero() {{
  long long z[16] = {{0}};
  int zc[7] = {{0}};
  int e = (int)cudaMemcpyToSymbol(k9_phase_clocks, z, sizeof(z));
  {k19_zero}
  (void)zc;
  return e;
}}
"""


def layout_of(src: str) -> str:
    return "register_chain" if "kPowLane" in src else "six_thread"


def stamped_header(src: str) -> str:
    """final_exp.cuh with the phase stamps of its layout (module docstring)."""
    if src.count(_ROUTINE) != 1:
        raise SystemExit("cyclotomic_pow_x_block not found once in final_exp.cuh")
    if layout_of(src) == "register_chain":
        if tuple(arg for _, arg in PHASE_LINE.findall(src)) != PHASES:
            raise SystemExit(f"final_exp.cuh's K9_PHASE lines are not {PHASES}")
        src = PHASE_LINE.sub(r"\1K9_MARK(\2);", src)
        i = src.index(_ROUTINE) + len(_ROUTINE)
        j = src.index("\n}\n", i) + 1
        src = src[:i] + _START + src[i:j] + _WRITE + src[j:]
    else:
        marks, end, end_stamped = SIX_THREAD
        for mark, arg in marks:
            if src.count(mark) != 1:
                raise SystemExit(f"marker {mark!r} not found once in final_exp.cuh")
            src = src.replace(mark, f"  K9_MARK({arg});\n" + mark)
        if src.count(end) != 1:
            raise SystemExit("cyclotomic_pow_x_block's end not found once")
        src = src.replace(_ROUTINE, _ROUTINE + _START).replace(end, end_stamped)
    head = src.index("namespace {")
    return src[:head] + _MARK + src[head:]


def _wrap(line: str, kind: int) -> str:
    return f"  {{\n    const long long k19_s_ = clock64();\n  {line}\n    K19_ADD({kind}, clock64() - k19_s_);\n  }}"


def stamped_k19(src: str) -> str:
    """final_exponentiation_kernels.cu with a stamp around every step of
    the kernel's body and inside `fp12_mul_block` (module docstring)."""
    sig = "__device__ __noinline__ void fp12_mul_block(const uint32_t* a, const uint32_t* b, uint32_t* out) {\n"
    if src.count(sig) != 1:
        raise SystemExit("fp12_mul_block not found once")
    i = src.index(sig) + len(sig)
    j = src.index("\n}\n", i)
    body = src[i:j]
    src = src[:i] + "  const long long k19_m_ = clock64();\n" + body + "\n  K19_ADD(1, clock64() - k19_m_);" + src[j:]
    load = src.index("  __syncthreads();\n", src.index("void __launch_bounds__(kFinalExpThreads) final_exponentiation_kernel("))
    start = load + len("  __syncthreads();\n")
    stop = src.index("\n}\n", start)
    lines = []
    for line in src[start:stop].split("\n"):
        m = re.match(r"  (cyclotomic_pow_x_block|fp12_inv_block|frobenius_block|fp12_conj_block)\(", line)
        if not m:
            lines.append(line)
        elif m.group(1) == "fp12_inv_block":
            lines.append("  {\n    const long long k19_m0_ = k19_clocks[1];\n" + _wrap(line, 2)
                         + "\n    K19_ADD(5, k19_clocks[1] - k19_m0_);\n  }")
        else:
            lines.append(_wrap(line, {"cyclotomic_pow_x_block": 0, "frobenius_block": 3,
                                      "fp12_conj_block": 4}[m.group(1)]))
    body = "\n".join(lines)
    body = "  const long long k19_b_ = clock64();\n" + body + "\n  __syncthreads();\n  K19_ADD(6, clock64() - k19_b_);"
    src = src[:start] + body + src[stop:]
    head = src.index("namespace {")
    return src[:head] + _K19_DEVICE + src[head:]


def build(kernels, out_dir: pathlib.Path, csrc: pathlib.Path, unit: str, text: str, prefix: str):
    (out_dir / unit).write_text(text + _ACCESS.format(
        prefix=prefix,
        k19_read=("e |= (int)cudaMemcpyFromSymbol(k19, k19_clocks, sizeof(k19_clocks));\n"
                  "  e |= (int)cudaMemcpyFromSymbol(counts, k19_counts, sizeof(k19_counts));")
        if "k19_clocks" in text else "(void)k19; (void)counts;",
        k19_zero=("e |= (int)cudaMemcpyToSymbol(k19_clocks, z, sizeof(k19_clocks));\n"
                  "  e |= (int)cudaMemcpyToSymbol(k19_counts, zc, sizeof(k19_counts));")
        if "k19_clocks" in text else ""))
    lib_path = out_dir / f"{prefix}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o", str(lib_path),
                    str(out_dir / unit)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    getattr(lib, f"{prefix}_read").argtypes = [ctypes.c_void_p] * 3
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k9_chain_phases: no CUDA device available", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import numpy as np

    import chip_smoke
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp, kernels, pairing, tower

    csrc = tree / "lighthouse_tpu_torch/crypto/bls/torch_backend/csrc"
    out_dir = tree / "build" / "k9_chain_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    header = (csrc / "final_exp.cuh").read_text()
    layout = layout_of(header)
    names = NAMES[layout]
    (out_dir / "final_exp.cuh").write_text(stamped_header(header))
    libs = {"k9": build(kernels, out_dir, csrc, "final_exp_kernels.cu", (csrc / "final_exp_kernels.cu").read_text(),
                        "k9_probe"),
            "k19": build(kernels, out_dir, csrc, "final_exponentiation_kernels.cu",
                         stamped_k19((csrc / "final_exponentiation_kernels.cu").read_text()), "k19_probe")}

    rng = random.Random(17)
    f = torch.from_numpy(fp.ints_to_words([rng.randrange(P) for _ in range(12)]).astype(np.int32))
    f = f.reshape(1, 2, 3, 2, fp.WORDS)
    g = tower.fp12_mul(tower.fp12_conj(f), tower.fp12_inv(f))  # the easy part, on the CPU: cyclotomic
    g = tower.fp12_mul(pairing.frobenius2(g), g)
    dev = torch.device("cuda:0")
    g, f = g.to(dev).contiguous(), f.to(dev).contiguous()  # the launches read 144 words in place
    consts = fp.const(pairing._FE_CONSTS, dev)
    outs = {k: torch.empty_like(g) for k in libs}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run_k9():
        if libs["k9"].lh_cyclotomic_pow_x(g.data_ptr(), 0, outs["k9"].data_ptr(), 1, stream()):
            raise RuntimeError("the stamped K9 failed to launch")

    def run_k19():
        if libs["k19"].lh_final_exponentiation(f.data_ptr(), 0, consts.data_ptr(), outs["k19"].data_ptr(), 1,
                                               stream()):
            raise RuntimeError("the stamped K19 failed to launch")

    for lib, fn in ((libs["k9"], "lh_cyclotomic_pow_x"), (libs["k19"], "lh_final_exponentiation")):
        getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
    run_k9()
    run_k19()
    torch.cuda.synchronize()
    errs = {"k9": chip_smoke.max_word_err(outs["k9"], pairing.pow_abs_x_plain(g)),
            "k19": chip_smoke.max_word_err(outs["k19"], pairing.final_exponentiation_plain(f))}

    k9 = (ctypes.c_longlong * 16)()
    k19 = (ctypes.c_longlong * 7)()
    counts = (ctypes.c_int * 7)()
    sums = {}
    for key, run in (("k9", run_k9), ("k19", run_k19)):
        lib = libs[key]
        tot9, tot19, cnt = [0.0] * 16, [0.0] * 7, [0] * 7
        for _ in range(args.reps):
            if getattr(lib, f"{key}_probe_zero")() != 0:
                raise RuntimeError("zeroing the stamps failed")
            run()
            torch.cuda.synchronize()
            if getattr(lib, f"{key}_probe_read")(k9, k19, counts) != 0:
                raise RuntimeError("reading the stamps failed")
            tot9 = [a + b / args.reps for a, b in zip(tot9, k9)]
            tot19 = [a + b / args.reps for a, b in zip(tot19, k19)]
            cnt = list(counts)
        sums[key] = (tot9, tot19, cnt)
    ms = {
        "k9_stamped": chip_smoke.kernel_device_ms(run_k9, args.reps, "cyclotomic_pow_x_kernel"),
        "k9_plain": chip_smoke.kernel_device_ms(lambda: pairing.pow_abs_x(g), args.reps, "cyclotomic_pow_x_kernel"),
        "k19_stamped": chip_smoke.kernel_device_ms(run_k19, args.reps, "final_exponentiation_kernel"),
        "k19_plain": chip_smoke.kernel_device_ms(lambda: pairing.final_exponentiation(f), args.reps,
                                                 "final_exponentiation_kernel"),
    }
    max_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm").split()[0])
    smi = f'"{chip_smoke.nvidia_smi("name,power.limit")}"'
    us = lambda c: f"{c / max_mhz:.2f}"  # noqa: E731
    k9_clocks = sums["k9"][0][: len(names)]
    chip_smoke.phase("k9_phases", layout=layout, n=1, smi=smi, max_sm_mhz=max_mhz, max_abs_err=errs["k9"],
                     **{f"{p}_us": us(c) for p, c in zip(names, k9_clocks)}, sum_us=us(sum(k9_clocks)),
                     step_us=us(sum(c for p, c in zip(names, k9_clocks) if p.startswith("step_")) / 63),
                     stamped_device_ms=f"{ms['k9_stamped']:.5f}", plain_device_ms=f"{ms['k9_plain']:.5f}",
                     implied_mhz=f"{sum(k9_clocks) / (ms['k9_stamped'] * 1e3):.0f}")
    chain9, k19_clocks, k19_counts = sums["k19"]
    chip_smoke.phase("k19_phases", layout=layout, n=1, smi=smi, max_sm_mhz=max_mhz, max_abs_err=errs["k19"],
                     **{f"{k}_us": us(c) for k, c in zip(K19_KINDS, k19_clocks)},
                     **{f"{k}_calls": n for k, n in zip(K19_KINDS[:5], k19_counts[:5])},
                     **{f"chains_{p}_us": us(c) for p, c in zip(names, chain9[: len(names)])},
                     stamped_device_ms=f"{ms['k19_stamped']:.5f}", plain_device_ms=f"{ms['k19_plain']:.5f}",
                     implied_mhz=f"{k19_clocks[6] / (ms['k19_stamped'] * 1e3):.0f}")
    return 0 if max(errs.values()) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
