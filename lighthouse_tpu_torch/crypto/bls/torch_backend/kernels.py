"""Build, load and bind the hand-written CUDA kernels (csrc/).

Each .cu source compiles with its own `nvcc`, all started together, and
the objects link into one shared library with a plain C interface, loaded
with ctypes. The library is built at first use into
`build/torch_kernels/` under the repository root (listed in .gitignore),
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused within a checkout. Nothing here runs when the
module is imported: the CPU tests import every module and have no nvcc.

Each launcher returns `cudaGetLastError()`; `launch()` raises on a non-zero
code, so a launch the card refuses is never silent. `launch()` takes the
operands' device and launches under its guard, on its stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "fp384.cuh", "g1.cuh", "g2.cuh", "tower.cuh", "curve.cuh", "final_exp.cuh",
    "fp_kernels.cu", "g1_kernels.cu", "fp_mma.cu", "tower_kernels.cu", "curve_kernels.cu", "final_exp_kernels.cu",
    "pairing_kernels.cu", "h2c_kernels.cu", "fold_kernels.cu", "cofactor_kernels.cu",
    "final_exponentiation_kernels.cu", "verify_kernels.cu", "affine_kernels.cu", "standalone_kernels.cu",
)
UNITS = tuple(name for name in SOURCES if name.endswith(".cu"))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# name -> argtypes; every pointer and the stream are c_void_p so that
# 64-bit device addresses are never cut to 32 bits.
_SIGNATURES = {
    "lh_fp_mul": [_P, _P, _P, _LL, _P],
    "lh_fp_addsub": [_P, _P, _P, _LL, ctypes.c_int, _P],
    "lh_fp_pow": [_P, _P, ctypes.c_int, _P, _LL, _P],
    "lh_fp_batch_inv": [_P, _P, _LL, _LL, _P],
    "lh_g1_subgroup_check": [_P, _P, _P, _P, _P, _LL, _P],
    "lh_fp_mul_mma": [_P, _P, _P, _LL, _P],
    "lh_fp2_mul": [_P, _LL, _P, _LL, _P, _LL, ctypes.c_int, _P],
    "lh_fp12_mul": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, ctypes.c_int, _P],
    "lh_g1_scalar_mul": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int, _P, _LL, _P],
    "lh_g2_scalar_mul": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int, _P, _LL, _P],
    "lh_cyclotomic_pow_x": [_P, _LL, _P, _LL, _P],
    "lh_miller_loop": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _LL, _P],
    "lh_sswu": [_P, _LL, _P, _P, _LL, _P],
    "lh_iso3_map": [_P, _LL, _P, _LL, _P, _P, _LL, _P],
    "lh_g1_tree_sum": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _LL, _LL, _P],
    "lh_g2_tree_sum": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _LL, _LL, _P],
    "lh_clear_cofactor": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, ctypes.c_int, _P, _P, ctypes.c_int,
                          _P, _LL, _P],
    "lh_product_reduce": [_P, _LL, _P, _LL, _P],
    "lh_final_exponentiation": [_P, _LL, _P, _P, _LL, _P],
    "lh_g2_psi_check": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _LL, _P],
    "lh_miller_inputs": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                         _P],
    "lh_g1_to_affine": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _LL, _P],
    "lh_g2_to_affine": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _LL, _P],
    "lh_fp6_mul": [_P, _LL, _P, _LL, _P, _LL, _P],
    "lh_fp2_inv": [_P, _LL, _P, _LL, _P],
    "lh_g1_add": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P],
    "lh_g2_add": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P],
    "lh_karabina_sqr": [_P, _LL, _P, _LL, _P],
    "lh_karabina_decompress": [_P, _LL, _P, _LL, _P],
    "lh_fp12_inv": [_P, _LL, _P, _P, _LL, _P],
    "lh_frobenius": [_P, _LL, _P, _P, _LL, _P],
    "lh_fp2_sqrt_candidate": [_P, _LL, _P, _LL, _P],
    "lh_fp_redc": [_P, _LL, _P, _LL, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None
#: what the compilers printed in the last build (ptxas: registers, spills)
BUILD_LOG: str | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> pathlib.Path:
    """Compile the kernels into the build directory (no-op when the
    library for these exact sources already exists); return its path."""
    global BUILD_SECONDS, BUILD_LOG
    key = _source_key()
    out = BUILD_DIR / f"libfp_kernels_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{pathlib.Path(u).stem}.{tag}.o" for u in UNITS]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / u)] for u, o in zip(UNITS, objs)])
    log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device, *args) -> None:
    """Call launcher `name` for operands on CUDA `device`: under that
    device's guard and on its current stream, whatever device the calling
    thread has current (a rank on cuda:1, a fresh host thread whose current
    device is cuda:0). Raise on any error code the launcher reports."""
    import torch

    fn = getattr(library(), name)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
