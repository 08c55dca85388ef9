"""The port's coalescer (lighthouse_tpu_torch/crypto/bls/batch_verifier.py)
held to the JAX package's.

- The stub-backend cases of tests/test_batch_verifier.py (coalescing,
  bisection blame, per-set verdicts, deadline flush, stopped service,
  kick) against the port's module, with the same stubs;
- the port's backend on the CPU through an installed coalescer: 2 sets,
  one tampered, blamed exactly as the oracle does; single-set verifies
  routed through the service;
- `device_fingerprint` with the JAX function's keys, and the port's metric
  families with the JAX families' names, types and help texts.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from lighthouse_tpu.common import metrics as jmetrics
from lighthouse_tpu.common import tracing as jtracing
from lighthouse_tpu.crypto.bls.jax_backend import api as japi
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu_torch.common import metrics as tmetrics
from lighthouse_tpu_torch.common import tracing as ttracing
from lighthouse_tpu_torch.crypto.bls import batch_verifier as bv
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from test_batch_verifier import GatedBackend, StubBackend, StubSet
from torch_parity import signature_sets


def _wait_for_calls(backend, n: int) -> None:
    deadline = time.monotonic() + 5.0
    while len(backend.calls) < n and time.monotonic() < deadline:
        time.sleep(0.001)


def _concurrent(n: int, fn) -> list:
    out = [None] * n
    barrier = threading.Barrier(n)

    def caller(i):
        barrier.wait()
        out[i] = fn(i)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert not any(t.is_alive() for t in threads)
    return out


def test_concurrent_submitters_coalesce_into_few_dispatches():
    backend = StubBackend(latency=0.03)
    svc = bv.BatchVerifier(backend, s_bucket=128, max_wait=0.1).start()
    d0 = tmetrics.BLS_COALESCED_DISPATCHES_TOTAL.value
    try:
        results = _concurrent(64, lambda i: svc.submit([StubSet()]).result(timeout=10.0))
        assert results == [[True]] * 64
        assert svc.dispatches <= 8, f"{svc.dispatches} dispatches for 64 callers"
        assert sum(backend.calls) == 64
        assert tmetrics.BLS_COALESCED_DISPATCHES_TOTAL.value - d0 == svc.dispatches
    finally:
        svc.stop()


def test_bisection_blames_exactly_the_invalid_sets():
    backend = StubBackend(latency=0.01)
    svc = bv.BatchVerifier(backend, s_bucket=128, max_wait=0.1).start()
    b0 = tmetrics.BLS_BISECTION_BATCHES_TOTAL.value
    k0 = tmetrics.BLS_BISECTION_BLAMED_SETS_TOTAL.value
    try:
        valid = [i % 5 != 0 for i in range(64)]
        futures = _concurrent(64, lambda i: svc.submit([StubSet(valid=valid[i])]))
        assert [f.result(timeout=10.0)[0] for f in futures] == valid
        assert tmetrics.BLS_BISECTION_BATCHES_TOTAL.value > b0
        assert tmetrics.BLS_BISECTION_BLAMED_SETS_TOTAL.value - k0 == valid.count(False)
    finally:
        svc.stop()


def test_multi_set_submission_gets_per_set_verdicts():
    svc = bv.BatchVerifier(StubBackend(), max_wait=0.01).start()
    try:
        sets = [StubSet(), StubSet(valid=False), StubSet(), StubSet(valid=False)]
        assert svc.submit(sets).result(timeout=10.0) == [True, False, True, False]
        assert svc.submit([]).result(timeout=10.0) == []
    finally:
        svc.stop()


def test_deadline_flush_pipelines_while_device_busy():
    backend = GatedBackend()
    svc = bv.BatchVerifier(backend, s_bucket=128, max_wait=0.05).start()
    try:
        f1 = svc.submit([StubSet()])
        _wait_for_calls(backend, 1)
        assert backend.calls == [1]
        f2, f3 = svc.submit([StubSet()]), svc.submit([StubSet()])
        _wait_for_calls(backend, 2)
        assert backend.calls == [1, 2]
        assert not f1.done()
        backend.gate.set()
        assert [f.result(timeout=10.0) for f in (f1, f2, f3)] == [[True]] * 3
    finally:
        svc.stop()


def test_stopped_service_falls_back_to_direct_verification():
    backend = StubBackend()
    svc = bv.BatchVerifier(backend)
    assert not svc.running
    assert svc.submit([StubSet()]).result(timeout=1.0) == [True]
    assert svc.submit([StubSet(valid=False)]).result(timeout=1.0) == [False]
    assert svc.submit([StubSet(), StubSet(valid=False)]).result(timeout=1.0) == [True, False]
    started = bv.BatchVerifier(backend).start()
    started.stop()
    assert started.submit([StubSet()]).result(timeout=1.0) == [True]


def test_kick_flushes_a_partial_batch_before_its_deadline():
    backend = GatedBackend()
    svc = bv.BatchVerifier(backend, s_bucket=128, max_wait=30.0).start()
    try:
        svc.submit([StubSet()])
        _wait_for_calls(backend, 1)
        f2 = svc.submit([StubSet()])
        time.sleep(0.05)
        assert len(backend.calls) == 1
        svc.kick()
        _wait_for_calls(backend, 2)
        assert len(backend.calls) == 2
        backend.gate.set()
        assert f2.result(timeout=10.0) == [True]
    finally:
        svc.stop()


def test_defaults_match_the_jax_coalescer():
    from lighthouse_tpu.crypto.bls import batch_verifier as jbv

    for name in ("DEFAULT_S_BUCKET", "DEFAULT_MAX_WAIT", "IN_FLIGHT_DEPTH"):
        assert getattr(bv, name) == getattr(jbv, name), name


@pytest.fixture
def cpu_api(monkeypatch):
    monkeypatch.setattr(tapi, "DEFAULT_DEVICE", "cpu")
    return tapi


def test_real_backend_blames_the_tampered_set(cpu_api):
    """2 sets through the installed coalescer on the port's backend (CPU):
    one batch fails, bisection verifies each set alone, and the verdicts
    equal the oracle's per-set verdicts."""
    spec = [((0,), 0), ((1,), 1)]
    sets = signature_sets(cpu_api, spec)
    sets[1] = cpu_api.SignatureSet(sets[1].signature, sets[1].signing_keys, b"\x99" * 32)
    oracle_sets = signature_sets(ref, spec)
    oracle_sets[1] = ref.SignatureSet(oracle_sets[1].signature, oracle_sets[1].signing_keys, b"\x99" * 32)
    want = [ref.verify_signature_sets([s]) for s in oracle_sets]
    errors0 = tmetrics.BLS_COALESCER_INTERNAL_ERRORS_TOTAL.value
    svc = bv.ensure_running(cpu_api, max_wait=0.005, rng=random.Random(4).getrandbits)
    try:
        assert bv.active_for(cpu_api) is svc
        d0 = svc.dispatches
        assert bv.verify_sets(cpu_api, sets) == want == [True, False]
        assert svc.dispatches == d0 + 1
    finally:
        bv.release(svc)
    assert bv.active_for(cpu_api) is None
    assert tmetrics.BLS_COALESCER_INTERNAL_ERRORS_TOTAL.value == errors0


def test_single_set_verify_routes_through_the_service(cpu_api, monkeypatch):
    """Signature.verify submits to the running service over this backend
    (and takes its verdict); an explicit device, or no service, goes direct."""
    sk, pk = cpu_api.interop_keypair(0)
    msg = b"\x42" * 32
    sig = sk.sign(msg)
    submitted = []
    svc = bv.ensure_running(cpu_api)
    try:

        def spy(sets, corr_meta=None):
            submitted.append(sets)
            fut = bv.BatchFuture()
            fut._resolve([False])  # a verdict the direct path would not give
            return fut

        monkeypatch.setattr(svc, "submit", spy)
        assert sig.verify(pk, msg) is False
        assert len(submitted) == 1 and submitted[0][0].signing_keys == [pk]
        direct = []
        monkeypatch.setattr(cpu_api, "verify_signature_sets", lambda sets, rng=None, device=None: direct.append(device))
        sig.verify(pk, msg, device="cpu")
        assert len(submitted) == 1 and direct == ["cpu"]
    finally:
        bv.release(svc)


def test_device_fingerprint_has_the_jax_keys(cpu_api):
    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    want = japi.device_fingerprint(refresh_gauge=False)
    got = cpu_api.device_fingerprint(refresh_gauge=False)
    assert keys(got) == keys(want)
    assert (got["platform"], got["device_kind"], got["chip_count"], got["backend"]) == ("cpu", "cpu", 1, "cpu")
    assert got["jit_cache"] == {"verify_kernels_cached": 0, "hits": 0, "misses": 0}
    assert got["coalescer"] == {"running": False, "s_bucket": 128, "max_wait": 0.01}
    svc = bv.ensure_running(cpu_api, s_bucket=32)
    try:
        assert cpu_api.device_fingerprint(refresh_gauge=False)["coalescer"] == {
            "running": True, "s_bucket": 32, "max_wait": 0.01,
        }
    finally:
        bv.release(svc)


def test_device_fingerprint_sets_the_provenance_gauge(cpu_api):
    cpu_api.device_fingerprint()
    child = tmetrics.DEVICE_PROVENANCE_INFO.children()[("cpu", "cpu", "1")]
    assert child.value == 1


@pytest.mark.parametrize("name", tmetrics.REGISTRY.names())
def test_metric_families_match_the_jax_families(name):
    """Every family of the port's registry (the api's, the coalescer's and
    the tracing stage histogram) is the JAX family of the same name: type,
    help text, labels and buckets."""
    assert jtracing.STAGE_SECONDS is jmetrics.REGISTRY._metrics["lighthouse_tpu_stage_seconds"]
    port, want = tmetrics.REGISTRY._metrics[name], jmetrics.REGISTRY._metrics[name]
    assert (port.typ, port.help, getattr(port, "label_names", ())) == (
        want.typ, want.help, getattr(want, "label_names", ()),
    )
    assert getattr(port, "buckets", None) == getattr(want, "buckets", None)


def test_verify_records_metrics_and_spans(cpu_api):
    """A structurally invalid batch records nothing; a verified one counts
    its sets, its padded size and one batch, under the JAX span names."""
    sets0 = tmetrics.BLS_SETS_TOTAL.value
    assert cpu_api.verify_signature_sets([]) is False
    assert tmetrics.BLS_SETS_TOTAL.value == sets0
    spans = ("bls_batch_verify", "bls_stage", "bls_device_execute", "bls_pack", "bls_h2c_host")
    before = {s: ttracing.STAGE_SECONDS.labels(stage=s).count for s in spans}
    padded, batches = tmetrics.BLS_BATCH_PADDED_SIZE.count, tmetrics.BLS_BATCH_SECONDS.count
    sets = signature_sets(cpu_api, [((0,), 0)])
    assert cpu_api.verify_signature_sets(sets, rng=random.Random(1).getrandbits) is True
    assert tmetrics.BLS_SETS_TOTAL.value == sets0 + 1
    assert tmetrics.BLS_BATCH_PADDED_SIZE.count == padded + 1
    assert tmetrics.BLS_BATCH_SECONDS.count == batches + 1
    assert all(ttracing.STAGE_SECONDS.labels(stage=s).count == before[s] + 1 for s in spans)
    root = ttracing.TRACER.slowest()
    assert any(t["name"] == "bls_batch_verify" for t in root)
