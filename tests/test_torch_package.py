"""Package rules of lighthouse_tpu_torch: it imports neither jax nor
lighthouse_tpu, its entry points default to the CUDA device and fail
without one (no CPU fallback), and a CPU tensor runs the plain versions
without counting a kernel launch."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import lighthouse_tpu_torch
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels as tkernels
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as ttower

ROOT = pathlib.Path(lighthouse_tpu_torch.__file__).resolve().parent.parent
# the port, chip_smoke.py, and the card's tests (they run where jax is absent)
SOURCES = sorted(pathlib.Path(lighthouse_tpu_torch.__file__).parent.rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "test_torch_gpu.py",
]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lighthouse_tpu", "bench", "__graft_entry__")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_lighthouse_tpu_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


def test_forbidden_check_tells_the_packages_apart():
    assert _forbidden("lighthouse_tpu.crypto.bls") and _forbidden("jax.numpy")
    assert not _forbidden("lighthouse_tpu_torch.crypto.bls.torch_backend.api")


def test_import_does_not_load_jax():
    code = (
        "import sys; import lighthouse_tpu_torch.crypto.bls.torch_backend.api, chip_smoke; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lighthouse_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_default_device_is_cuda_and_fails_without_gpu(monkeypatch):
    assert tapi.DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sk, pk = tapi.interop_keypair(0)
    sig = sk.sign(b"\x01" * 32)
    s = tapi.SignatureSet(signature=sig, signing_keys=[pk], message=b"\x01" * 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.verify_signature_sets([s])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sig.verify(pk, b"\x01" * 32)


def test_chip_smoke_refuses_without_gpu(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0


def test_cpu_tensors_use_plain_versions_without_counting():
    tfp.reset_launches()
    a = torch.from_numpy(tfp.to_mont_host_bulk([3, 5, 7]))
    tfp.mul(a, a)
    tfp.add(a, a)
    tfp.inv(a)
    tfp.batch_inv(a)
    a2 = torch.from_numpy(tfp.to_mont_host_bulk(range(1, 7))).reshape(3, 2, 12)
    a12 = torch.from_numpy(tfp.to_mont_host_bulk(range(1, 13))).reshape(2, 3, 2, 12)
    assert torch.equal(ttower.fp2_mul(a2, a2), ttower.fp2_sqr(a2))
    assert torch.equal(ttower.fp12_mul(a12, a12), ttower.fp12_sqr(a12))
    assert all(v == 0 for v in tfp.LAUNCHES.values()), tfp.LAUNCHES


def test_kernel_build_is_lazy():
    """Importing the port builds and loads nothing (there is no nvcc on the
    CPU): a fresh process that imports every module has no kernel library."""
    code = (
        "import lighthouse_tpu_torch.crypto.bls.torch_backend.api; "
        "from lighthouse_tpu_torch.crypto.bls.torch_backend import kernels; "
        "assert kernels._lib is None and kernels.BUILD_SECONDS is None"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_tensor_core_kernel_is_registered():
    """K6's source is hashed into the build key (an edit rebuilds the
    library), compiled as a unit, bound, and counted."""
    assert "fp_mma.cu" in tkernels.SOURCES and "fp_mma.cu" in tkernels.UNITS
    assert "lh_fp_mul_mma" in tkernels._SIGNATURES
    assert "fp_mul_mma" in tfp.KERNELS and "fp_mul_mma" in tfp.LAUNCHES


def test_tower_kernels_are_registered():
    """K7 and K8: their source is hashed into the build key and compiled
    as a unit, both launchers are bound, and fp.KERNELS counts all
    eighteen kernels."""
    assert "tower_kernels.cu" in tkernels.SOURCES and "tower_kernels.cu" in tkernels.UNITS
    assert "lh_fp2_mul" in tkernels._SIGNATURES and "lh_fp12_mul" in tkernels._SIGNATURES
    assert len(tfp.KERNELS) == 18 and set(tfp.LAUNCHES) == set(tfp.KERNELS)
    assert {"fp2_mul", "fp12_mul"} <= set(tfp.KERNELS)


def test_curve_and_final_exp_kernels_are_registered():
    """K9, K10 and K11: their sources and the headers they include are
    hashed into the build key, the .cu files compiled as units, the three
    launchers bound and counted."""
    assert {"g2.cuh", "tower.cuh", "curve_kernels.cu", "final_exp_kernels.cu"} <= set(tkernels.SOURCES)
    assert {"curve_kernels.cu", "final_exp_kernels.cu"} <= set(tkernels.UNITS)
    for name in ("cyclotomic_pow_x", "g1_scalar_mul", "g2_scalar_mul"):
        assert f"lh_{name}" in tkernels._SIGNATURES and name in tfp.KERNELS


def test_miller_and_h2c_kernels_are_registered():
    """K12, K13 and K14: their sources are hashed into the build key and
    compiled as units, the three launchers bound (one argument type per
    launcher parameter, the stream last) and counted."""
    assert {"pairing_kernels.cu", "h2c_kernels.cu"} <= set(tkernels.UNITS)
    arity = {"miller_loop": 14, "sswu": 6, "iso3_map": 8}
    for name, n in arity.items():
        assert len(tkernels._SIGNATURES[f"lh_{name}"]) == n and name in tfp.KERNELS


def test_fold_and_cofactor_kernels_are_registered():
    """K15-K18: their sources and the header they share with K10 and K11
    are hashed into the build key, the .cu files compiled as units, the
    four launchers bound (one argument type per launcher parameter, the
    stream last) and counted."""
    assert "curve.cuh" in tkernels.SOURCES
    assert {"fold_kernels.cu", "cofactor_kernels.cu"} <= set(tkernels.UNITS)
    arity = {"g1_tree_sum": 14, "g2_tree_sum": 14, "clear_cofactor": 19, "product_reduce": 6}
    for name, n in arity.items():
        assert len(tkernels._SIGNATURES[f"lh_{name}"]) == n and name in tfp.KERNELS


@pytest.mark.parametrize("flag", ["unset", "", "0", "true", "1"])
def test_mxu_flag_is_off_unless_set_to_1(flag):
    """fp.USE_MXU_MUL is read once at import from the JAX package's own
    variable, LIGHTHOUSE_TPU_MXU_FP_MUL, and is True only for "1"."""
    env = {k: v for k, v in os.environ.items() if k != "LIGHTHOUSE_TPU_MXU_FP_MUL"}
    if flag != "unset":
        env["LIGHTHOUSE_TPU_MXU_FP_MUL"] = flag
    code = "from lighthouse_tpu_torch.crypto.bls.torch_backend import fp; print(fp.USE_MXU_MUL)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == str(flag == "1")


def test_mul_mxu_on_cuda_tensors_raises_without_a_gpu(monkeypatch):
    """Operands that dispatch to the card (here: the device check told that
    they lie on CUDA) go to K6's launch, which fails where there is no
    card and no nvcc; the plain version is never taken instead."""
    monkeypatch.setattr(tfp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(tfp, "mul_mxu_plain", lambda a, b: pytest.fail("fell back to the plain version"))
    monkeypatch.setattr(tfp, "USE_MXU_MUL", True)
    a = torch.from_numpy(tfp.to_mont_host_bulk([3, 5]))
    tfp.reset_launches()
    for fn in (tfp.mul_mxu, tfp.mul):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(a, a)
    assert tfp.LAUNCHES["fp_mul_mma"] == 0
