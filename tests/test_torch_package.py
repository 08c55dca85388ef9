"""Package rules of lighthouse_tpu_torch: it imports neither jax nor
lighthouse_tpu, its entry points default to the CUDA device and fail
without one (no CPU fallback), and a CPU tensor runs the plain versions
without counting a kernel launch."""

import ast
import collections
import itertools
import os
import pathlib
import subprocess
import sys
import types

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


def test_consensus_host_import_does_not_load_jax_and_defaults_to_the_card():
    """A fresh process: the BLS seam and the chain load no jax and no
    lighthouse_tpu module; TransitionContext.minimal() with no argument
    (and no LIGHTHOUSE_TPU_BLS_BACKEND) takes the torch backend, whose
    verify raises where there is no GPU instead of running on the CPU."""
    code = (
        "import sys, torch\n"
        "import lighthouse_tpu_torch.crypto.bls as bls, lighthouse_tpu_torch.chain\n"
        "from lighthouse_tpu_torch.state_transition import TransitionContext\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lighthouse_tpu')]\n"
        "assert not bad, bad\n"
        "torch.cuda.is_available = lambda: False\n"
        "ctx = TransitionContext.minimal()\n"
        "assert ctx.bls is bls.backend('torch') and ctx.bls.__name__.endswith('torch_backend.api'), ctx.bls\n"
        "sk, pk = ctx.bls.interop_keypair(0)\n"
        "s = ctx.bls.SignatureSet(signature=sk.sign(b'\\x01' * 32), signing_keys=[pk], message=b'\\x01' * 32)\n"
        "try:\n"
        "    ctx.bls.verify_signature_sets([s])\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a verify ran without a GPU')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lighthouse_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "LIGHTHOUSE_TPU_BLS_BACKEND"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


# the gossip path, the op pool and the conformance runners, each at its JAX
# path under lighthouse_tpu_torch/
GOSSIP_MODULES = [
    "common.task_executor",
    "scheduler",
    "scheduler.beacon_processor",
    "scheduler.reprocess",
    "chain.attestation_processing",
    "op_pool",
    "op_pool.max_cover",
    "op_pool.pool",
    "op_pool.sync_pool",
    "conformance",
    "conformance.bls_cases",
    "conformance.kat_roots",
    "conformance.transition_cases",
]


@pytest.mark.parametrize("module", GOSSIP_MODULES)
def test_gossip_module_sits_at_its_jax_path(module):
    rel = module.replace(".", "/")
    for package in ("lighthouse_tpu_torch", "lighthouse_tpu"):
        base = ROOT / package / rel
        assert (base / "__init__.py").is_file() or base.with_suffix(".py").is_file(), f"{package}.{module}"


def test_gossip_modules_import_without_jax():
    """A fresh process imports the thirteen modules and loads no jax and no
    lighthouse_tpu module."""
    code = (
        "import importlib, sys\n"
        f"for m in {GOSSIP_MODULES!r}:\n"
        "    importlib.import_module('lighthouse_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lighthouse_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _same_family(name):
    from lighthouse_tpu.common import metrics as jax_metrics
    from lighthouse_tpu_torch.common import metrics

    got, want = getattr(metrics, name), getattr(jax_metrics, name)
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.help) == (want.name, want.help)
    assert getattr(got, "label_names", ()) == getattr(want, "label_names", ())
    assert getattr(got, "buckets", None) == getattr(want, "buckets", None)
    assert metrics.REGISTRY._metrics[got.name] is got


@pytest.mark.parametrize("name", ["PROCESSOR_QUEUE_DEPTH", "PROCESSOR_ITEMS_DROPPED", "PROCESSOR_HANDLE_SECONDS",
                                  "TASKS_FAILED_TOTAL"])
def test_processor_metric_families_match_the_jax_package(name):
    """The families the processor and the task executor record: the JAX
    package's name, type, help text and labels."""
    _same_family(name)


# the network layer, each module at its JAX path under lighthouse_tpu_torch/
NETWORK_MODULES = [
    "crypto.secp256k1",
    "network",
    "network.keccak",
    "network.enr",
    "network.discovery",
    "network.topics",
    "network.fork_id",
    "network.snappy",
    "network.peer_manager",
    "network.rpc",
    "network.gossip",
    "network.sync",
    "network.local",
    "network.service",
    "network.socket_net",
]


@pytest.mark.parametrize("module", NETWORK_MODULES)
def test_network_module_sits_at_its_jax_path(module):
    rel = module.replace(".", "/")
    for package in ("lighthouse_tpu_torch", "lighthouse_tpu"):
        base = ROOT / package / rel
        assert (base / "__init__.py").is_file() or base.with_suffix(".py").is_file(), f"{package}.{module}"


def test_network_modules_import_without_jax():
    """A fresh process imports the fifteen modules and loads no jax and no
    lighthouse_tpu module; the package exports what the JAX package's
    does."""
    code = (
        "import importlib, sys\n"
        f"for m in {NETWORK_MODULES!r}:\n"
        "    importlib.import_module('lighthouse_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lighthouse_tpu')]\n"
        "assert not bad, bad\n"
        "from lighthouse_tpu_torch import network\n"
        "assert network.__all__ == ['LocalNetwork', 'NetworkService', 'SocketNetwork', 'Topic'], network.__all__\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    import lighthouse_tpu.network as jax_network

    assert jax_network.__all__ == ["LocalNetwork", "NetworkService", "SocketNetwork", "Topic"]


@pytest.mark.parametrize("name", ["GOSSIP_INTERNAL_ERRORS_TOTAL", "DISCOVERY_INTERNAL_ERRORS_TOTAL"])
def test_network_metric_families_match_the_jax_package(name):
    """The families gossip's and discovery's receive loops count their own
    faults in: the JAX package's name, type and help text."""
    _same_family(name)


# the validator client, its keys and the Beacon API, each module at its JAX
# path under lighthouse_tpu_torch/
VC_MODULES = [
    "crypto.aes",
    "crypto.keystore",
    "crypto.key_derivation",
    "crypto.wallet",
    "networks",
    "http_api.json_codec",
    "http_api.server",
    "http_api",
    "validator_client.slashing_protection",
    "validator_client.doppelganger",
    "validator_client.lockfile",
    "validator_client.validator_client",
    "validator_client.web3signer",
    "validator_client.http_client",
    "validator_client.metrics_server",
    "validator_client",
]


def _module_path(package: str, module: str) -> pathlib.Path:
    base = ROOT / package / module.replace(".", "/")
    return base / "__init__.py" if (base / "__init__.py").is_file() else base.with_suffix(".py")


@pytest.mark.parametrize("module", VC_MODULES)
def test_vc_module_sits_at_its_jax_path(module):
    for package in ("lighthouse_tpu_torch", "lighthouse_tpu"):
        assert _module_path(package, module).is_file(), f"{package}.{module}"


def test_vc_modules_import_without_jax():
    """A fresh process imports the sixteen modules and loads no jax and no
    lighthouse_tpu module; both packages export the same names."""
    code = (
        "import importlib, sys\n"
        f"for m in {VC_MODULES!r}:\n"
        "    importlib.import_module('lighthouse_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lighthouse_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    import lighthouse_tpu.http_api as jax_http_api
    import lighthouse_tpu.validator_client as jax_vc
    from lighthouse_tpu_torch import http_api, validator_client

    assert http_api.__all__ == jax_http_api.__all__ and validator_client.__all__ == jax_vc.__all__


def _code_only(path: pathlib.Path) -> str:
    """The module's AST with every docstring dropped and the port's package
    name read as the JAX package's."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            node.value = node.value.replace("lighthouse_tpu_torch", "lighthouse_tpu")
        elif isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("lighthouse_tpu_torch", "lighthouse_tpu")
        elif isinstance(node, ast.alias):
            node.name = node.name.replace("lighthouse_tpu_torch", "lighthouse_tpu")
    return ast.dump(tree)


@pytest.mark.parametrize("module", VC_MODULES)
def test_vc_module_is_its_jax_namesake_but_for_docstrings(module):
    """Each of the sixteen is the JAX module's code: the same AST once
    docstrings are dropped and package names equated (comments do not
    reach the AST)."""
    port, jax = _module_path("lighthouse_tpu_torch", module), _module_path("lighthouse_tpu", module)
    assert _code_only(port) == _code_only(jax), f"{module}: the port's code differs from the JAX package's"


def test_code_only_sees_a_changed_line(tmp_path):
    """The comparison is not vacuous: a changed constant or call differs, a
    reworded docstring or comment does not."""
    src = _module_path("lighthouse_tpu", "validator_client.doppelganger").read_text()
    same = tmp_path / "same.py"
    same.write_text(src.replace('"""Doppelganger protection', '"""Reworded', 1).replace("# validator_index ->", "# ->"))
    changed = tmp_path / "changed.py"
    changed.write_text(src.replace("DEFAULT_REMAINING_DETECTION_EPOCHS = 1", "DEFAULT_REMAINING_DETECTION_EPOCHS = 2"))
    want = _code_only(_module_path("lighthouse_tpu", "validator_client.doppelganger"))
    assert _code_only(same) == want and _code_only(changed) != want


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


def _function(tree, name):
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def test_chip_smoke_gossip_goes_through_the_network_service():
    """chip_smoke's [gossip] no longer writes out the service's glue (no
    admit, route, handle_aggs or drain of its own, no direct processor
    drain or reprocess queue): it builds a NetworkService on a LocalNetwork
    and drains with process_pending at the slot tick; [sync] builds a
    SocketNetwork and runs after [gossip]."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    gossip = _function(tree, "run_gossip")
    nested = {n.name for n in ast.walk(gossip) if isinstance(n, ast.FunctionDef)} - {"run_gossip"}
    assert not nested & {"admit", "route", "handle_aggs", "drain"}, nested
    calls = {n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", None)
             for n in ast.walk(gossip) if isinstance(n, ast.Call)}
    assert {"NetworkService", "LocalNetwork", "slot_tick"} <= calls
    attrs = {n.attr for n in ast.walk(gossip) if isinstance(n, ast.Attribute)}
    assert {"publish_attestation", "publish_aggregate", "publish"} <= attrs
    assert not calls & {"ReprocessQueue", "drain", "park_early", "park_unknown_block", "insert_attestation"}, calls
    assert "process_pending" in {n.func.attr for n in ast.walk(_function(tree, "slot_tick"))
                                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    sync = _function(tree, "run_sync")
    sync_calls = {n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", None)
                  for n in ast.walk(sync) if isinstance(n, ast.Call)}
    assert {"SocketNetwork", "NetworkService", "exchange_status", "publish_block", "close"} <= sync_calls
    order = [n.func.id for n in sorted((n for n in ast.walk(_function(tree, "main")) if isinstance(n, ast.Call)),
                                       key=lambda n: n.lineno)
             if isinstance(n.func, ast.Name) and n.func.id.startswith("run_")]
    assert order[-4:] == ["run_conformance", "run_gossip", "run_sync", "run_vc"], order


def test_chip_smoke_vc_goes_through_the_beacon_api_and_the_keystores():
    """chip_smoke's [vc] drives the validator client over HTTP
    (`BeaconNodeHttpClient` against an `HttpApiServer`), signs through a
    `SlashingDatabase`, and takes its keys from keystores it decrypts with
    the port's `keystore.decrypt` (in host processes)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())

    def calls(fn):
        return {n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", None)
                for n in ast.walk(fn) if isinstance(n, ast.Call)}

    vc = _function(tree, "run_vc")
    assert {"BeaconNodeHttpClient", "HttpApiServer", "SlashingDatabase", "ValidatorStore", "ValidatorClient",
            "MockWeb3Signer", "MetricsServer", "Lockfile", "on_slot", "export_interchange"} <= calls(vc)
    assert "decrypt_keystore" in {n.id for n in ast.walk(vc) if isinstance(n, ast.Name)}
    decrypt = _function(tree, "decrypt_keystore")
    assert any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "decrypt"
               and isinstance(n.func.value, ast.Name) and n.func.value.id == "keystore" for n in ast.walk(decrypt))
    assert "encrypt" in calls(_function(tree, "encrypt_keystore"))


# a fake verify's device operations, as (runtime call, device event): the
# copy of a pageable host buffer first, the kernel after it, a fill among
# the launches, the copy back last
_VERIFY_OPS = ([("cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)"), ("cudaLaunchKernel", "direct_copy")]
               + [("cudaLaunchKernel", "k")] * 100 + [("cudaMemsetAsync", "Memset (Device)")]
               + [("cudaLaunchKernel", "k")] * 51 + [("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pinned)")])
# the same with a fill launched second, and with another copy first and
# the pageable one later
_FILL_SECOND = [_VERIFY_OPS[0], _VERIFY_OPS[102]] + _VERIFY_OPS[2:102] + [_VERIFY_OPS[1]] + _VERIFY_OPS[103:]
_OTHER_COPY_FIRST = ([("cudaMemcpyAsync", "Memcpy DtoD (Device -> Device)")] + _VERIFY_OPS[1:3] + _VERIFY_OPS[:1]
                     + _VERIFY_OPS[4:])
_ALL = tuple(range(155))


@pytest.mark.parametrize("traces,taken,lost", [
    ([((), 155)], 1, 0), ([(tuple(range(20, 32)), 155), ((), 155)], 2, 0),
    ([(_ALL, 155), (_ALL, 155), ((), 155)], 3, 0), ([(tuple(range(20, 32)), 155)], None, None),
    ([((0, 1), 155)], "all", 2), ([((0, 1), 155), ((0,), 155), ((0, 1), 155)], "all", 1),
    ([((20, 21), 155)], None, None), ([((0, 5), 155)], None, None), ([((1, 2), 155)], None, None),
    ([((0, 1, 2), 155)], None, None), ([((153, 154), 155)], None, None), ([((0, 1), 155, _FILL_SECOND)], None, None),
    ([((0, 1), 155, _OTHER_COPY_FIRST)], None, None), ([((), 154)], None, None), ([((0, 1), 154)], None, None)],
    ids=["whole", "partial_then_whole", "empty_then_whole", "always_partial", "always_short", "short_fewest_lost",
         "short_in_the_middle", "short_copy_and_a_later_kernel", "short_kernels_after_the_copy",
         "short_three", "short_at_the_end", "short_copy_and_a_fill", "short_another_copy_first", "enqueued_short",
         "short_and_enqueued_short"])
def test_traces_that_lost_device_events_are_taken_again(monkeypatch, traces, taken, lost):
    """chip_smoke's profiler traces: a trace of a verify whose device events,
    or whose runtime calls that enqueue device operations, are not the
    verify's 155 (or that holds no device event) is taken again. After
    TRACE_TRIES such traces, the one that lost fewest events is returned
    only where its runtime calls are 155 and it lost the window's first one
    or two operations, the pageable host-to-device copy and the kernel
    after it, and nothing else; any other loss fails the phase. A trace is
    (dropped device events by index into the window's operations, runtime
    calls recorded[, the window's operations where they are not
    _VERIFY_OPS]); the last repeats for as many traces as are taken."""
    import chip_smoke
    import torch.profiler

    it = itertools.chain(traces, itertools.repeat(traces[-1]))

    class Averages:
        def __init__(self, key, count, us):
            self.key, self.count, self.self_device_time_total = key, count, us

    class Event:
        def __init__(self, name, device, start):
            self.name, self.device_type = name, f"DeviceType.{device}"
            self.time_range = types.SimpleNamespace(start=start)

    class Profile:
        def __init__(self, activities):
            dropped, ncalls, ops = (*next(it), _VERIFY_OPS)[:3]
            self.calls = [Event(c, "CPU", 10 * i) for i, (c, _) in enumerate(ops[:ncalls])]
            self.device = [Event(d, "CUDA", 10 * i + 5) for i, (_, d) in enumerate(ops) if i not in dropped]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.calls + self.device

        def key_averages(self):
            calls = collections.Counter(e.name for e in self.calls)
            device = collections.Counter(e.name for e in self.device)
            return ([Averages(k, n, 0.0) for k, n in calls.items()]
                    + [Averages(k, n, 7.0 * n) for k, n in device.items()])

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "EMPTY_TRACES", 0)
    monkeypatch.setattr(chip_smoke, "PARTIAL_TRACES", 0)
    monkeypatch.setattr(chip_smoke, "TRACE_SETTLE_S", 0.0)
    windows = []
    if taken is None:
        with pytest.raises(RuntimeError, match="not the 155 expected"):
            chip_smoke.traced_device_events(lambda: windows.append(1), chip_smoke.VERIFY_DEVICE_OPS)
        assert len(windows) == chip_smoke.TRACE_TRIES
        return
    rows, _ = chip_smoke.traced_device_events(lambda: windows.append(1), chip_smoke.VERIFY_DEVICE_OPS)
    n = 155 - lost
    taken = chip_smoke.TRACE_TRIES if taken == "all" else taken
    assert sum(r[1] for r in rows) == n and sum(r[0] for r in rows) == 7.0 * n and len(windows) == taken
    assert any(k == "Memcpy HtoD (Pageable -> Device)" for _, _, k in rows) == (lost == 0)
    empty = sum(1 for d, *_ in traces[:taken] if d == _ALL)
    assert (chip_smoke.EMPTY_TRACES, chip_smoke.PARTIAL_TRACES) == (empty, taken - (0 if lost else 1) - empty)


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
    thirty-three kernels."""
    assert "tower_kernels.cu" in tkernels.SOURCES and "tower_kernels.cu" in tkernels.UNITS
    assert "lh_fp2_mul" in tkernels._SIGNATURES and "lh_fp12_mul" in tkernels._SIGNATURES
    assert len(tfp.KERNELS) == 33 and set(tfp.LAUNCHES) == set(tfp.KERNELS)
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
    arity = {"g1_tree_sum": 14, "g2_tree_sum": 14, "clear_cofactor": 19, "product_reduce": 5}
    for name, n in arity.items():
        assert len(tkernels._SIGNATURES[f"lh_{name}"]) == n and name in tfp.KERNELS


def test_final_exp_and_verify_glue_kernels_are_registered():
    """K19-K21: their sources and the header K19 shares with K9 are hashed
    into the build key, the .cu files compiled as units, the three
    launchers bound (one argument type per launcher parameter, the stream
    last) and counted."""
    assert "final_exp.cuh" in tkernels.SOURCES
    assert {"final_exponentiation_kernels.cu", "verify_kernels.cu"} <= set(tkernels.UNITS)
    arity = {"final_exponentiation": 6, "g2_psi_check": 16, "miller_inputs": 22}
    for name, n in arity.items():
        assert len(tkernels._SIGNATURES[f"lh_{name}"]) == n and name in tfp.KERNELS


def test_affine_and_fp6_kernels_are_registered():
    """K22-K25: their source is hashed into the build key and compiled as a
    unit, the four launchers bound (one argument type per launcher
    parameter, the stream last) and counted, and every kernel of
    fp.KERNELS has a bound launcher."""
    assert "affine_kernels.cu" in tkernels.SOURCES and "affine_kernels.cu" in tkernels.UNITS
    arity = {"g1_to_affine": 11, "g2_to_affine": 11, "fp6_mul": 7, "fp2_inv": 5}
    for name, n in arity.items():
        assert len(tkernels._SIGNATURES[f"lh_{name}"]) == n and name in tfp.KERNELS
    assert {f"lh_{k}" for k in tfp.KERNELS} <= set(tkernels._SIGNATURES)


def test_standalone_kernels_are_registered():
    """K26-K33: the new source is hashed into the build key and compiled as
    a unit (K30, K31 and K32 live in K19's and K13's sources beside the
    routines they launch), the eight launchers bound (one argument type
    per launcher parameter, the stream last) and counted, and every bound
    launcher is a kernel of fp.KERNELS."""
    assert "standalone_kernels.cu" in tkernels.SOURCES and "standalone_kernels.cu" in tkernels.UNITS
    arity = {"g1_add": 15, "g2_add": 15, "karabina_sqr": 5, "karabina_decompress": 5, "fp12_inv": 6,
             "frobenius": 6, "fp2_sqrt_candidate": 5, "fp_redc": 5}
    for name, n in arity.items():
        assert len(tkernels._SIGNATURES[f"lh_{name}"]) == n and name in tfp.KERNELS
    assert set(tkernels._SIGNATURES) == {f"lh_{k}" for k in tfp.KERNELS}


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


def test_native_hasher_builds_outside_the_package_and_matches_hashlib():
    """The port's merkleization hasher compiles tree_hash.c at first use
    into build/native/ (the port commits no binary) and hashes as
    hashlib does; a process that cannot build it falls back to hashlib."""
    import hashlib

    from lighthouse_tpu_torch import native

    pkg = pathlib.Path(lighthouse_tpu_torch.__file__).parent
    assert not list((pkg / "native").glob("*.so"))
    assert native._SO.parent == ROOT / "build" / "native"
    if not native.available():
        pytest.skip("no C compiler: the hashlib fallback is taken")
    data = bytes(range(256)) * 2
    want = b"".join(hashlib.sha256(data[i : i + 64]).digest() for i in range(0, len(data), 64))
    assert native.hash_pairs(data) == want
    assert native._SO.is_file()
