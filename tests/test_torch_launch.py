"""Kernel launches go to the operands' device, with stubs on the CPU.

`kernels.launch` enters the device guard of the device it is given and
takes that device's current stream, not the calling thread's current
device; every kernel wrapper gives it its operands' device. (On the card,
tests/test_torch_gpu.py launches on cuda:1 while cuda:0 is current, and
from a fresh thread.)
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.torch_backend import curve, fp, kernels, tower


class _Stream:
    def __init__(self, device):
        self.cuda_stream = 1000 + torch.device(device).index


@pytest.fixture
def stub_cuda(monkeypatch):
    """A kernel library whose launchers record their arguments, and a
    torch.cuda whose guard and streams record the device they are given."""
    events = []

    class Lib:
        def __getattr__(self, name):
            def launcher(*args):
                events.append(("launch", name, args))
                return 0

            return launcher

    @contextlib.contextmanager
    def guard(device):
        events.append(("enter", torch.device(device)))
        yield
        events.append(("exit", torch.device(device)))

    def current_stream(device=None):
        events.append(("stream", torch.device(device) if device is not None else None))
        return _Stream(device if device is not None else "cuda:0")

    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return events


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_uses_the_given_devices_guard_and_stream(stub_cuda, index):
    dev = torch.device("cuda", index)
    kernels.launch("lh_fp_mul", dev, 11, 12, 13, 4)
    assert stub_cuda == [
        ("enter", dev),
        ("stream", dev),
        ("launch", "lh_fp_mul", (11, 12, 13, 4, 1000 + index)),
        ("exit", dev),
    ]


def test_launch_from_a_fresh_thread_uses_the_given_device(stub_cuda):
    """A new host thread (the coalescer's stager) launches on the device it
    names, whatever its own current device is."""
    dev = torch.device("cuda", 2)
    t = threading.Thread(target=kernels.launch, args=("lh_fp_addsub", dev, 1, 2, 3, 4, 0))
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert stub_cuda[0] == ("enter", dev) and stub_cuda[2] == ("launch", "lh_fp_addsub", (1, 2, 3, 4, 0, 1002))


def test_launch_raises_on_an_error_code(monkeypatch, stub_cuda):
    class Failing:
        def lh_fp_mul(self, *args):
            return 700

    monkeypatch.setattr(kernels, "library", Failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernels.launch("lh_fp_mul", torch.device("cuda", 1), 1, 2, 3, 4)


def test_every_wrapper_passes_its_operands_device(monkeypatch):
    """fp.mul / mul_mxu / add / inv / batch_inv and the K5 wrapper hand
    `launch` the device their operands lie on."""
    seen = []
    monkeypatch.setattr(fp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(kernels, "launch", lambda name, device, *args: seen.append((name, device)))
    a = torch.from_numpy(fp.to_mont_host_bulk([3, 5, 7, 9]))
    fp.mul(a, a)
    fp.mul_mxu(a, a)
    fp.add(a, a)
    fp.neg(a)
    fp.inv(a)
    fp.batch_inv(a)
    inf = torch.zeros(4, dtype=torch.bool)
    monkeypatch.setattr(fp, "const", lambda arr, device: torch.from_numpy(np.ascontiguousarray(arr)))
    curve.g1_in_subgroup_kernel(a, a, inf)
    names = ["lh_fp_mul", "lh_fp_mul_mma", "lh_fp_addsub", "lh_fp_addsub", "lh_fp_pow", "lh_fp_batch_inv"]
    assert seen[:6] == [(n, a.device) for n in names]
    assert seen[6] == ("lh_g1_subgroup_check", a.device)


@pytest.fixture
def recorded_launches(monkeypatch):
    """Operands dispatch as if they lay on a CUDA device; every launch is
    recorded as (launcher, device, args) and does nothing."""
    seen = []
    monkeypatch.setattr(fp, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(kernels, "launch", lambda name, device, *args: seen.append((name, device, args)))
    return seen


def _fp2s(n):
    return torch.from_numpy(fp.to_mont_host_bulk(range(1, 2 * n + 1))).reshape(n, 2, fp.WORDS)


def _fp12s(n):
    return torch.from_numpy(fp.to_mont_host_bulk(range(1, 12 * n + 1))).reshape(n, 2, 3, 2, fp.WORDS)


TOWER_PRODUCTS = {
    "fp2_mul": ("lh_fp2_mul", lambda: tower.fp2_mul(_fp2s(4), _fp2s(4))),
    "fp2_sqr": ("lh_fp2_mul", lambda: tower.fp2_sqr(_fp2s(4))),
    "fp12_mul": ("lh_fp12_mul", lambda: tower.fp12_mul(_fp12s(3), _fp12s(3))),
    "fp12_sqr": ("lh_fp12_mul", lambda: tower.fp12_sqr(_fp12s(3))),
    "fp12_mul_sparse035": ("lh_fp12_mul", lambda: tower.fp12_mul_sparse035(_fp12s(3), *_fp2s(9).reshape(3, 3, 2, 12))),
}


@pytest.mark.parametrize("name", sorted(TOWER_PRODUCTS))
def test_tower_product_is_one_launch(recorded_launches, name):
    """Each tower product issues exactly one launch of K7 or K8, on its
    operands' device, and none of K1 or K2."""
    launcher, call = TOWER_PRODUCTS[name]
    call()
    assert [(n, d) for n, d, _ in recorded_launches] == [(launcher, torch.device("cpu"))]


def test_fp12_inv_runs_its_products_on_k8(recorded_launches):
    """fp12_inv's composition over the kernel tower (the one K30 replaced,
    which K19's composition runs) makes its four Fp12 products as K8
    launches."""
    tower.fp12_inv_composed(_fp12s(2), tower.KERNEL_TOWER)
    assert [n for n, _, _ in recorded_launches].count("lh_fp12_mul") == 4


def test_broadcast_operand_goes_in_place_with_stride_0(recorded_launches):
    """A broadcast operand (one element over the batch) is read in place
    with element stride 0; a contiguous one with its element's size; any
    other layout is copied once."""
    a, c = _fp2s(4), _fp2s(1)[0]
    tower.fp2_mul(a, c)
    (_, _, (pa, sa, pc, sc, _, n, op)), = recorded_launches
    assert (pa, sa, pc, sc, n, op) == (a.data_ptr(), 24, c.data_ptr(), 0, 4, tower.FP2_MUL)
    recorded_launches.clear()
    strided = _fp2s(8)[::2]
    tower.fp2_sqr(strided)
    (_, _, (pa, sa, pb, sb, _, n, op)), = recorded_launches
    assert pa != strided.data_ptr() and (sa, pb, sb, n, op) == (24, pa, 24, 4, tower.FP2_SQR)
    recorded_launches.clear()
    f, lines = _fp12s(3), _fp2s(7)
    tower.fp12_mul_sparse035(f, lines[:3], lines[3:6], lines[6])
    (_, _, args), = recorded_launches
    assert args[:8] == (f.data_ptr(), 144, lines.data_ptr(), 24, lines[3:6].data_ptr(), 24, lines[6].data_ptr(), 0)
    assert args[9:] == (3, tower.FP12_SPARSE)
    recorded_launches.clear()
    tower.fp12_mul(f, f[1])
    (_, _, args), = recorded_launches
    assert args[:4] == (f.data_ptr(), 144, f[1].data_ptr(), 0) and args[9:] == (3, tower.FP12_FULL)
