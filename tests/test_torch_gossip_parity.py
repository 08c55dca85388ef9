"""The port's gossip path against the JAX package's on the CPU: attestation
admission (`chain/attestation_processing.py`), the BeaconProcessor and the
reprocess queue (`scheduler/`), the op pool (`op_pool/`) and the task
executor (`common/task_executor.py`).

The chain tests build both packages' harnesses on `fake` (16 interop
validators, minimal preset, two slots, as tests/test_scheduler.py builds
it), make each gossip item once, carry it into the other package's types by
its SSZ bytes, and check that both packages' items have the same
hash_tree_root before comparing anything. A result is compared item by
item: True, or the same exception type and message. One small case signs
for real: two sets, one with a bad signature, through the port's "torch"
backend on the CPU against the JAX package on `ref`."""

import random

import pytest

from lighthouse_tpu.chain import BeaconChainHarness as JaxHarness
from lighthouse_tpu.chain import attestation_processing as jap
from lighthouse_tpu.common import metrics as jmetrics
from lighthouse_tpu.common.task_executor import TaskExecutor as JaxTaskExecutor
from lighthouse_tpu.crypto.bls import batch_verifier as jbv
from lighthouse_tpu.op_pool import OperationPool as JaxOperationPool
from lighthouse_tpu.op_pool import maximum_cover as jax_maximum_cover
from lighthouse_tpu.scheduler import BeaconProcessor as JaxBeaconProcessor
from lighthouse_tpu.scheduler import WorkType as JaxWorkType
from lighthouse_tpu.scheduler.reprocess import ReprocessQueue as JaxReprocessQueue
from lighthouse_tpu.state_transition import TransitionContext as JaxContext
from lighthouse_tpu.state_transition import process_slots as jax_process_slots
from lighthouse_tpu.types import compute_signing_root as jax_compute_signing_root
from lighthouse_tpu.types import get_domain as jax_get_domain
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.chain import attestation_processing as ap
from lighthouse_tpu_torch.common import metrics
from lighthouse_tpu_torch.common.task_executor import TaskExecutor
from lighthouse_tpu_torch.crypto.bls import batch_verifier as bv
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.op_pool import OperationPool, maximum_cover
from lighthouse_tpu_torch.scheduler import MAX_GOSSIP_ATTESTATION_BATCH_SIZE, BeaconProcessor, WorkType
from lighthouse_tpu_torch.scheduler.reprocess import ReprocessQueue
from lighthouse_tpu_torch.state_transition import TransitionContext, process_slots
from lighthouse_tpu_torch.state_transition.helpers import get_beacon_committee
from lighthouse_tpu_torch.types import MINIMAL_PRESET
from lighthouse_tpu_torch.types.containers import Checkpoint, SignedVoluntaryExit, VoluntaryExit

VALIDATORS = 16
SLOTS = 2


# -- helpers -------------------------------------------------------------------


def outcome(result):
    """True, or the rejection as (exception type name, message)."""
    return True if result is True else (type(result).__name__, str(result))


def outcomes(results):
    return [outcome(r) for r in results]


def to_jax(obj, jax_types, name: str):
    """A port container as the JAX package's, by its SSZ bytes; the two have
    the same hash_tree_root."""
    jcls = getattr(jax_types, name)
    jobj = jcls.deserialize(type(obj).serialize(obj))
    assert jcls.hash_tree_root(jobj) == type(obj).hash_tree_root(obj), name
    return jobj


@pytest.fixture
def pair():
    """(JAX harness, port harness), both on `fake`, each with its chain at
    slot 2 and the same head."""
    jh = JaxHarness(VALIDATORS, JaxContext.minimal("fake"))
    h = BeaconChainHarness(VALIDATORS, TransitionContext.minimal("fake"))
    jh.extend_chain(SLOTS)
    h.extend_chain(SLOTS)
    assert jh.chain.head_root == h.chain.head_root
    return jh, h


def gossip_attestations(h):
    """Valid and invalid gossip attestations at the port harness's head: the
    slot's committee attestation, each member's one-bit attestation, and
    one of each admission failure."""
    t, chain = h.ctx.types, h.chain
    head = chain.head_root
    state = chain.store.get_state(head)
    slot = int(state.slot)
    full = h.attestations_for_slot(state, head, slot)
    base = full[0]
    n = len(base.aggregation_bits)
    single = [t.Attestation(aggregation_bits=[i == j for i in range(n)], data=base.data,
                            signature=bytes(base.signature)) for j in range(n)]

    def variant(**changes):
        d = base.data
        fields = dict(slot=d.slot, index=d.index, beacon_block_root=d.beacon_block_root, source=d.source,
                      target=d.target)
        fields.update(changes)
        return t.Attestation(aggregation_bits=list(base.aggregation_bits), data=t.AttestationData(**fields),
                             signature=bytes(base.signature))

    parent = bytes(chain.store.get_block(head).message.parent_root)
    hostile = [
        variant(beacon_block_root=b"\xfe" * 32),  # unknown head block
        variant(slot=slot + 1),  # future slot
        variant(target=Checkpoint(epoch=1, root=base.data.target.root)),  # target epoch does not match
        variant(target=Checkpoint(epoch=0, root=b"\x42" * 32)),  # unknown target block
        variant(beacon_block_root=parent, target=Checkpoint(epoch=0, root=head)),  # head not from target
        t.Attestation(aggregation_bits=[False] * n, data=base.data, signature=bytes(base.signature)),  # empty
    ]
    return full + single + hostile


def signed_aggregates(h):
    """SignedAggregateAndProofs at the head: one from each committee member
    (all aggregators: committees of 2 select everyone), one from a validator
    outside the committee, and one with no attester."""
    t, chain = h.ctx.types, h.chain
    state = chain.head_state()
    att = h.attestations_for_slot(state, chain.head_root, int(state.slot))[0]
    committee = get_beacon_committee(state, int(att.data.slot), int(att.data.index), h.ctx.preset, h.ctx.spec)
    outsider = next(v for v in range(VALIDATORS) if v not in committee)
    empty = t.Attestation(aggregation_bits=[False] * len(committee), data=att.data, signature=bytes(att.signature))

    def signed(aggregator, aggregate, proof):
        return t.SignedAggregateAndProof(
            message=t.AggregateAndProof(aggregator_index=aggregator, aggregate=aggregate,
                                        selection_proof=bytes([proof]) * 96),
            signature=b"\x22" * 96)

    return [signed(v, att, 0x11 + i) for i, v in enumerate(committee)] + [
        signed(outsider, att, 0x31), signed(committee[0], empty, 0x41)]


# -- attestation admission -----------------------------------------------------


def test_gossip_attestations_match(pair):
    jh, h = pair
    items = gossip_attestations(h)
    jitems = [to_jax(a, jh.ctx.types, "Attestation") for a in items]
    got = outcomes(ap.batch_verify_gossip_attestations(h.chain, items))
    assert got == outcomes(jap.batch_verify_gossip_attestations(jh.chain, jitems))
    assert got.count(True) == 3 and len(set(map(str, got))) == 7, got
    # the same items again: the accepted ones are known now
    again = outcomes(ap.batch_verify_gossip_attestations(h.chain, items))
    assert again == outcomes(jap.batch_verify_gossip_attestations(jh.chain, jitems))
    assert ("AttestationError", "prior attestation known") in again and True not in again
    assert h.chain.fork_choice.votes and [
        (v.next_root, v.next_epoch) for v in h.chain.fork_choice.votes] == [
        (v.next_root, v.next_epoch) for v in jh.chain.fork_choice.votes]


def test_gossip_aggregates_match(pair):
    jh, h = pair
    items = signed_aggregates(h)
    jitems = [to_jax(s, jh.ctx.types, "SignedAggregateAndProof") for s in items]
    got = outcomes(ap.batch_verify_gossip_aggregates(h.chain, items))
    assert got == outcomes(jap.batch_verify_gossip_aggregates(jh.chain, jitems))
    assert got[:2] == [True, True] and ("AttestationError", "aggregator not in committee") in got
    assert ("AttestationError", "empty aggregate") in got
    again = outcomes(ap.batch_verify_gossip_aggregates(h.chain, items[:1]))
    assert again == outcomes(jap.batch_verify_gossip_aggregates(jh.chain, jitems[:1]))
    assert again == [("AttestationError", "aggregate already known")]


@pytest.mark.parametrize("coalesced", [False, True], ids=["direct", "coalescer"])
def test_pipelined_verifier_cross_batch_dedup_matches(pair, coalesced):
    """Two batches in one drain cycle, the second repeating an item of the
    first: the repeat is dropped before the backend, in both packages, with
    and without a coalescer over the backend (flight-recorder ids bound to
    each item's root at admission)."""
    jh, h = pair
    items = gossip_attestations(h)[:3]
    jitems = [to_jax(a, jh.ctx.types, "Attestation") for a in items]

    def run(chain, processing, svc_module, batches):
        svc = svc_module.ensure_running(chain.ctx.bls) if coalesced else None
        try:
            for batch in batches:
                for a in batch:
                    chain.flight_recorder.bind(bytes(type(a).hash_tree_root(a)), chain.flight_recorder.mint("att"))
            v = processing.PipelinedGossipVerifier(chain)
            for batch in batches:
                v.submit(batch)
            routed = []
            v.flush(lambda a, res: routed.append((bytes(type(a).hash_tree_root(a)), outcome(res))))
        finally:
            svc_module.release(svc)
        return routed

    got = run(h.chain, ap, bv, [items, items[1:2]])
    assert got == run(jh.chain, jap, jbv, [jitems, jitems[1:2]])
    assert [r for _, r in got] == [True, True, True, ("AttestationError", "prior attestation known")]
    if coalesced:
        verdicts = [e for e in h.chain.flight_recorder.events() if e["event"] == "set_verdict"]
        assert len(verdicts) == 3 and all(e["ok"] for e in verdicts)


# -- the scheduler -------------------------------------------------------------


def processor_trace(processor_cls, work_type_cls, seed: int, bounds: bool, steps: int = 600):
    """A seeded mix of submissions and batch pops: every submit's return,
    every batch (type and items), the stats, and what is left queued."""
    rng = random.Random(seed)
    types = list(work_type_cls)
    p = processor_cls(bounds={wt: rng.randint(1, 6) for wt in types} if bounds else None)
    trace = []
    for step in range(steps):
        if rng.random() < (0.7 if bounds else 0.95):
            wt = types[rng.randrange(len(types))]
            trace.append(("submit", wt.name, step, p.submit(wt, step)))
        else:
            b = p.next_batch()
            trace.append(("batch", None if b is None else (b.work_type.name, list(b.items))))
    stats = {name: {wt.name: n for wt, n in getattr(p.stats, name).items()}
             for name in ("submitted", "dropped", "drained")}
    return trace, stats, len(p)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("bounds", [True, False], ids=["small_bounds", "default_bounds"])
def test_processor_batches_and_drops_match(seed, bounds):
    got = processor_trace(BeaconProcessor, WorkType, seed, bounds)
    assert got == processor_trace(JaxBeaconProcessor, JaxWorkType, seed, bounds)
    trace, stats, _ = got
    if bounds:
        assert sum(stats["dropped"].values()) > 0, "the trace never reached a bound"
    sizes = [len(e[1][1]) for e in trace if e[0] == "batch" and e[1] is not None]
    assert max(sizes) <= MAX_GOSSIP_ATTESTATION_BATCH_SIZE


def test_processor_caps_a_batch_at_the_bucket():
    for cls, wt in ((BeaconProcessor, WorkType), (JaxBeaconProcessor, JaxWorkType)):
        p = cls()
        for i in range(2 * MAX_GOSSIP_ATTESTATION_BATCH_SIZE + 5):
            p.submit(wt.GOSSIP_ATTESTATION, i)
        sizes = [len(p.next_batch().items) for _ in range(3)]
        assert sizes == [MAX_GOSSIP_ATTESTATION_BATCH_SIZE, MAX_GOSSIP_ATTESTATION_BATCH_SIZE, 5]
        assert p.next_batch() is None


def drain_trace(processor_cls, work_type_cls, items_dropped):
    """A drain over isolated handlers that raise on items divisible by 7:
    the order of handled batches, the items dropped, and the queue depth."""
    p = processor_cls()
    for i in range(40):
        p.submit(work_type_cls.GOSSIP_ATTESTATION if i % 3 else work_type_cls.GOSSIP_BLOCK, i)
    seen = []

    def handler(kind):
        def run(items):
            if any(i % 7 == 0 for i in items):
                raise ValueError(kind)
            seen.append((kind, list(items)))
        return processor_cls.isolated(run)

    before = items_dropped.value
    n = p.drain({work_type_cls.GOSSIP_ATTESTATION: handler("att"), work_type_cls.GOSSIP_BLOCK: handler("block")})
    return n, seen, items_dropped.value - before, len(p)


def test_processor_drain_isolates_hostile_items_alike():
    got = drain_trace(BeaconProcessor, WorkType, metrics.PROCESSOR_ITEMS_DROPPED)
    assert got == drain_trace(JaxBeaconProcessor, JaxWorkType, jmetrics.PROCESSOR_ITEMS_DROPPED)
    n, _, dropped, left = got
    assert dropped == 6 and left == 0 and metrics.PROCESSOR_QUEUE_DEPTH.value == 0
    p = BeaconProcessor()
    p.submit(WorkType.RPC_BLOCK, "b")
    with pytest.raises(KeyError, match="no handler"):
        p.drain({})


# -- the reprocess queue -------------------------------------------------------


def test_reprocess_unit_early_unknown_and_expiry():
    q = ReprocessQueue(expiry_slots=2)
    assert q.park_early("a", ready_slot=5, current_slot=4)
    assert not q.park_early("z", ready_slot=10**9, current_slot=4)
    assert q.on_slot(4) == []
    assert [i for _, i in q.on_slot(5)] == ["a"]
    q.park_unknown_block("b", b"\x01" * 32, current_slot=3)
    q.park_unknown_block("c", b"\x02" * 32, current_slot=3)
    assert [i for _, i in q.on_block_imported(b"\x01" * 32)] == ["b"]
    assert q.on_block_imported(b"\x01" * 32) == []
    assert q.on_slot(4) == []
    assert len(q) == 1
    q.on_slot(6)
    assert len(q) == 0 and q.expired == 1


def reprocess_trace(queue_cls, work_type_cls, seed: int, steps: int = 500):
    rng = random.Random(seed)
    q = queue_cls(expiry_slots=rng.randint(1, 3))
    roots = [bytes([r]) * 32 for r in range(4)]
    slot, trace = 10, []
    for step in range(steps):
        op = rng.random()
        if op < 0.3:
            wt = rng.choice([None, work_type_cls.GOSSIP_AGGREGATE])
            trace.append(("early", q.park_early(step, slot + rng.randint(-1, 4), slot, work_type=wt)))
        elif op < 0.6:
            trace.append(("unknown", q.park_unknown_block(step, rng.choice(roots), slot)))
        elif op < 0.8:
            trace.append(("block", [(wt.name, i) for wt, i in q.on_block_imported(rng.choice(roots))]))
        else:
            slot += rng.randint(0, 2)
            trace.append(("slot", slot, [(wt.name, i) for wt, i in q.on_slot(slot)]))
        trace.append(len(q))
    return trace, q.expired


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reprocess_releases_match(seed):
    got = reprocess_trace(ReprocessQueue, WorkType, seed)
    assert got == reprocess_trace(JaxReprocessQueue, JaxWorkType, seed)
    assert got[1] > 0, "nothing expired in the trace"


# -- the op pool ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maximum_cover_matches(seed):
    rng = random.Random(seed)
    items = {f"i{n}": {rng.randrange(30): rng.randint(1, 9) for _ in range(rng.randint(0, 8))} for n in range(25)}
    limit = rng.randint(1, 12)
    got = maximum_cover(items, covering=lambda k: items[k], limit=limit)
    assert got == jax_maximum_cover(items, covering=lambda k: items[k], limit=limit)
    assert got and len(got) <= limit


def pool_roots(pool):
    return {bytes(r): [type(a).hash_tree_root(a) for a in bucket] for r, bucket in pool.attestations.items()}


def test_op_pool_packs_the_same_attestations(pair):
    jh, h = pair
    t = h.ctx.types
    head = h.chain.head_root
    state = h.chain.store.get_state(head)
    slot = int(state.slot)
    full = h.attestations_for_slot(state, head, slot)
    n = len(full[0].aggregation_bits)
    halves = [t.Attestation(aggregation_bits=[(i < n // 2) == first for i in range(n)], data=full[0].data,
                            signature=bytes(full[0].signature)) for first in (True, False)]
    inserts = halves + [halves[0]] + full
    pool, jpool = OperationPool(h.ctx), JaxOperationPool(jh.ctx)
    for a in inserts:
        pool.insert_attestation(a)
        jpool.insert_attestation(to_jax(a, jh.ctx.types, "Attestation"))
    assert pool_roots(pool) == pool_roots(jpool)
    pre, jpre = state.copy(), jh.chain.store.get_state(head).copy()
    process_slots(pre, slot + 1, h.ctx)
    jax_process_slots(jpre, slot + 1, jh.ctx)
    packed, jpacked = pool.get_attestations(pre), jpool.get_attestations(jpre)
    assert [type(a).hash_tree_root(a) for a in packed] == [type(a).hash_tree_root(a) for a in jpacked]
    assert len(packed) == len(full)
    future, jfuture = pre.copy(), jpre.copy()
    future.slot = jfuture.slot = slot + 10 * MINIMAL_PRESET.slots_per_epoch
    pool.prune(future)
    jpool.prune(jfuture)
    assert pool_roots(pool) == pool_roots(jpool) == {}


def test_op_pool_exit_dedup_and_filtering(pair):
    _, h = pair
    pool = OperationPool(h.ctx)
    ex = SignedVoluntaryExit(message=VoluntaryExit(epoch=0, validator_index=1), signature=b"\x00" * 96)
    pool.insert_voluntary_exit(ex)
    pool.insert_voluntary_exit(ex)
    assert len(pool.voluntary_exits) == 1
    assert pool.get_slashings_and_exits(h.chain.head_state().copy())[2] == []


# -- the task executor ---------------------------------------------------------


@pytest.mark.parametrize("executor_cls,failed", [(TaskExecutor, metrics.TASKS_FAILED_TOTAL),
                                                 (JaxTaskExecutor, jmetrics.TASKS_FAILED_TOTAL)],
                         ids=["port", "jax"])
def test_task_executor_supervision_and_shutdown(executor_cls, failed):
    """task_executor.rs semantics, as tests/test_common.py holds the JAX
    package's: a critical failure shuts the client down with the failure as
    the reason, the first reason wins, tasks observe the exit signal."""
    ex = executor_cls(name="t")
    observed = []
    before = failed.value

    def well_behaved():
        ex.exit.wait(10)
        observed.append("exited")

    def crasher():
        raise RuntimeError("boom")

    ex.spawn(well_behaved, "worker")
    h = ex.spawn(crasher, "fragile", critical=True)
    reason = ex.wait_shutdown(timeout=5)
    assert reason is not None and "fragile" in reason and "boom" in reason
    ex.shutdown("later reason")
    assert "fragile" in ex.shutdown_reason
    assert not ex.join_all(timeout=5)
    assert observed == ["exited"] and isinstance(h.error, RuntimeError)
    assert failed.value - before == 1
    assert all(th.daemon for th in (t.thread for t in ex.tasks))


def test_task_executor_noncritical_failure_keeps_running():
    for cls in (TaskExecutor, JaxTaskExecutor):
        ex = cls()
        h = ex.spawn(lambda: 1 / 0, "flaky")
        h.join(5)
        assert isinstance(h.error, ZeroDivisionError)
        assert ex.shutdown_reason is None and ex.tasks[0].thread.name == f"{ex.name}/flaky"


# -- one signed case: the port's "torch" backend on the CPU against `ref` ---------


def test_signed_gossip_attestations_torch_on_cpu_match_ref(monkeypatch):
    """Two one-bit attestations at genesis (8 validators: one attester a
    slot), the second signed by the wrong validator: the JAX package on
    `ref` and the port on "torch" with CPU tensors (the kernels' plain
    versions) both accept the first and blame the second."""
    monkeypatch.setattr(tapi, "DEFAULT_DEVICE", "cpu")
    jh = JaxHarness(8, JaxContext.minimal("ref"))
    h = BeaconChainHarness(8, TransitionContext.minimal("torch"))
    assert h.ctx.bls is tapi and h.chain.genesis_block_root == jh.chain.genesis_block_root
    jt, jchain = jh.ctx.types, jh.chain
    state, head = jchain.head_state(), jchain.head_root
    atts = []
    for slot, signer_slot in ((0, 0), (1, 0)):
        (v,) = get_beacon_committee(h.chain.head_state(), slot, 0, h.ctx.preset, h.ctx.spec)
        (signer,) = get_beacon_committee(h.chain.head_state(), signer_slot, 0, h.ctx.preset, h.ctx.spec)
        data = jt.AttestationData(slot=slot, index=0, beacon_block_root=head,
                                  source=state.current_justified_checkpoint, target=Checkpoint(epoch=0, root=head))
        root = jax_compute_signing_root(data, jax_get_domain(state, jh.ctx.spec.domain_beacon_attester, 0,
                                                             jh.ctx.preset))
        atts.append(jt.Attestation(aggregation_bits=[True], data=data,
                                   signature=jh.keypairs[signer][0].sign(root).to_bytes()))
    items = [h.ctx.types.Attestation.deserialize(jt.Attestation.serialize(a)) for a in atts]
    assert [type(a).hash_tree_root(a) for a in items] == [jt.Attestation.hash_tree_root(a) for a in atts]
    for chain in (jchain, h.chain):
        chain.slot_clock.set_slot(1)
    want = outcomes(jap.batch_verify_gossip_attestations(jchain, atts))
    assert want == [True, ("AttestationError", "invalid signature")]
    assert outcomes(ap.batch_verify_gossip_attestations(h.chain, items)) == want
