"""The port's execution layer, eth1 follower, slasher, safe_arith and
monitoring (execution_layer/, eth1/, slasher/, utils/safe_arith.py,
common/monitoring.py) against the JAX package's on the CPU.

Both packages get the same seeded inputs and every comparison is exact:
JWT strings, Engine-API JSON, SSZ bytes, roots and verdicts. Chains run on
`fake` (minimal preset, 8 interop validators, altair and bellatrix at
genesis); where a signature verdict decides the outcome they run on `ref`
in both packages, and the port also on "torch" (its plain versions on the
CPU). Each package's engine client talks to the other package's mock
engine. Servers listen on ephemeral localhost ports, and every wait is
bounded by HTTP_TIMEOUT_S."""

import dataclasses
import importlib
import json
import random
import threading
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

HTTP_TIMEOUT_S = 10.0
GENESIS_TIME = 1_600_000_000
VALIDATORS = 8
SECRET = bytes(range(32))
# nothing listens on port 1 of localhost: a dead endpoint
DEAD = "http://127.0.0.1:1"


def package(name: str):
    m = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    chain, st = m("chain"), m("state_transition")
    return types.SimpleNamespace(
        name=name, BeaconChain=chain.BeaconChain, Context=st.TransitionContext, genesis=st.interop_genesis_state,
        st=st, types=m("types"), containers=m("types.containers"), bls=m("crypto.bls"), el=m("execution_layer"),
        engine_api=m("execution_layer.engine_api"), eth1=m("eth1"), json_rpc=m("eth1.json_rpc"),
        eth1_genesis=m("state_transition.genesis"), helpers=m("state_transition.helpers"),
        slasher=m("slasher"), safe_arith=m("utils.safe_arith"), monitoring=m("common.monitoring"))


JAX, PORT = package("lighthouse_tpu"), package("lighthouse_tpu_torch")
BOTH = [JAX, PORT]
CROSS = [(JAX, PORT), (PORT, JAX)]
CROSS_IDS = ["jax_client-port_mock", "port_client-jax_mock"]


def merge_ctx(P, backend: str = "fake", engine=None):
    spec = dataclasses.replace(P.types.MINIMAL_SPEC, altair_fork_epoch=0, bellatrix_fork_epoch=0)
    ctx = P.Context(P.containers.minimal_types(), spec, P.bls.backend(backend))
    ctx.execution_engine = engine
    return ctx


def seeded_payload(P, seed: int):
    """An ExecutionPayload of P's types filled from a seed."""
    rng = random.Random(seed)
    b = lambda n: bytes(rng.getrandbits(8) for _ in range(n))  # noqa: E731
    return P.containers.minimal_types().ExecutionPayload(
        parent_hash=b(32), fee_recipient=b(20), state_root=b(32), receipts_root=b(32), logs_bloom=b(256),
        prev_randao=b(32), block_number=rng.getrandbits(64), gas_limit=rng.getrandbits(64),
        gas_used=rng.getrandbits(64), timestamp=rng.getrandbits(64), extra_data=b(rng.randrange(33)),
        base_fee_per_gas=rng.getrandbits(256), block_hash=b(32),
        transactions=[b(rng.randrange(1, 40)) for _ in range(rng.randrange(4))])


# -- execution layer -------------------------------------------------------------


@pytest.mark.parametrize("secret,iat", [(SECRET, 0), (b"\x42" * 32, GENESIS_TIME), (b"\xff" * 32, 2**40 - 1)])
def test_jwt_token_is_byte_equal(secret, iat):
    assert PORT.el.jwt_token(secret, iat) == JAX.el.jwt_token(secret, iat)


@pytest.mark.parametrize("seed", range(4))
def test_payload_json_round_trips_are_equal(seed):
    """payload_to_json gives the same JSON in both packages, and each
    package's json_to_payload reads it back to the same SSZ bytes."""
    jp, pp = seeded_payload(JAX, seed), seeded_payload(PORT, seed)
    jj, pj = JAX.engine_api.payload_to_json(jp), PORT.engine_api.payload_to_json(pp)
    assert json.dumps(pj) == json.dumps(jj)
    t_j, t_p = JAX.containers.minimal_types(), PORT.containers.minimal_types()
    back_j, back_p = JAX.engine_api.json_to_payload(t_j, pj), PORT.engine_api.json_to_payload(t_p, jj)
    assert t_p.ExecutionPayload.serialize(back_p) == t_j.ExecutionPayload.serialize(back_j) \
        == t_j.ExecutionPayload.serialize(jp)


@pytest.mark.parametrize("client_pkg,mock_pkg", CROSS, ids=CROSS_IDS)
def test_engine_client_works_against_the_other_packages_mock(client_pkg, mock_pkg):
    """One package's ExecutionLayer, its first engine dead, against the
    other package's MockExecutionEngine: JWT accepted (a wrong secret
    refused), notify_new_payload and build_payload past the dead engine,
    upcheck [False, True], and the mock's request log the one the same
    calls make against the client package's own mock."""
    logs = []
    for P in (mock_pkg, client_pkg):
        engine = P.el.MockExecutionEngine(jwt_secret=SECRET).start()
        try:
            C = client_pkg.el
            live = C.EngineApiClient(engine.url, jwt_secret=SECRET, timeout=HTTP_TIMEOUT_S)
            assert live.upcheck() and not C.EngineApiClient(engine.url, jwt_secret=b"\x00" * 32,
                                                            timeout=HTTP_TIMEOUT_S).upcheck()
            layer = C.ExecutionLayer([C.EngineApiClient(DEAD, jwt_secret=SECRET, timeout=HTTP_TIMEOUT_S), live])
            payload = seeded_payload(client_pkg, 7)
            assert layer.notify_new_payload(payload) is True and layer.last_status == C.PayloadStatus.VALID
            built = layer.build_payload(client_pkg.containers.minimal_types(), b"\x11" * 32, GENESIS_TIME,
                                        b"\x22" * 32, fee_recipient=b"\x33" * 20)
            assert bytes(built.parent_hash) == b"\x11" * 32 and int(built.timestamp) == GENESIS_TIME
            assert layer.upcheck() == [False, True]
            engine.next_status = "INVALID"
            assert layer.notify_new_payload(payload) is False
            logs.append((list(engine.requests), type(built).serialize(built)))
        finally:
            engine.stop()
    assert logs[0] == logs[1]


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_all_engines_down_raises(P):
    layer = P.el.ExecutionLayer([P.el.EngineApiClient(DEAD, timeout=HTTP_TIMEOUT_S),
                                 P.el.EngineApiClient(DEAD, timeout=HTTP_TIMEOUT_S)])
    with pytest.raises(P.el.EngineApiError, match="all engines failed"):
        layer.notify_new_payload(seeded_payload(P, 1))
    with pytest.raises(P.el.EngineApiError, match="all engines failed"):
        layer.forkchoice_updated(b"\x00" * 32, b"\x00" * 32, b"\x00" * 32)


def bellatrix_run(P, statuses, invalidate=None):
    """A chain of len(statuses) blocks on P's fake backend, each produced
    with a payload from P's own mock engine (answering newPayload with the
    status given for its slot) and imported; then `invalidate`'s block, if
    given, declared INVALID. -> (block roots, payload hashes, the engine's
    request log, per block its optimistic flag at import and at the end,
    the head root)."""
    engine = P.el.MockExecutionEngine(jwt_secret=SECRET).start()
    try:
        layer = P.el.ExecutionLayer([P.el.EngineApiClient(engine.url, jwt_secret=SECRET, timeout=HTTP_TIMEOUT_S)])
        ctx = merge_ctx(P, engine=layer)
        chain = P.BeaconChain(P.genesis(VALIDATORS, GENESIS_TIME, ctx), ctx)
        roots, hashes, at_import = [], [], []
        for slot, status in enumerate(statuses, start=1):
            engine.next_status = status
            chain.slot_clock.set_slot(slot)
            block, _ = chain.produce_block_on_state(chain.state_at_slot(slot), slot, bytes([slot]) * 96)
            roots.append(chain.process_block(chain.sign_block(block, ctx.bls.interop_secret_key(
                int(block.proposer_index)))))
            hashes.append(bytes(block.body.execution_payload.block_hash))
            at_import.append(chain.fork_choice.is_optimistic(roots[-1]))
        if invalidate is not None:
            chain.on_invalid_execution_payload(roots[invalidate])
        head = bytes(chain.head_root)
        post = chain.store.get_state(roots[-1])
        assert bytes(post.latest_execution_payload_header.block_hash) == hashes[-1]
        return (roots, hashes, list(engine.requests), at_import, [chain.fork_choice.is_optimistic(r) for r in roots],
                head)
    finally:
        engine.stop()


def test_bellatrix_chain_with_mock_engines_is_equal():
    """Four blocks from the merge-transition block on, produced and
    imported through each package with its own mock engine: equal block
    roots, payload hashes and engine request sequences, nothing
    optimistic. Each block asks the engine for its payload
    (forkchoiceUpdated, getPayload), and its payload goes to newPayload
    twice: once when production runs the block on the state for its state
    root, once at import."""
    want = bellatrix_run(JAX, ["VALID"] * 4)
    got = bellatrix_run(PORT, ["VALID"] * 4)
    assert got == want
    roots, hashes, requests, at_import, optimistic, _ = got
    assert len(set(hashes)) == 4 and not any(at_import) and not any(optimistic)
    assert requests == ["engine_forkchoiceUpdatedV1", "engine_getPayloadV1", "engine_newPayloadV1",
                        "engine_newPayloadV1"] * 4


def test_optimistic_import_then_invalidation_gives_the_same_head():
    """Block 2 imported while the engine is SYNCING (optimistic), block 3
    VALID (chained validity confirms block 2); in a second chain block 2
    SYNCING is then declared INVALID: the same flags and heads in both
    packages, the invalidated chain's head back on block 1."""
    confirmed = bellatrix_run(PORT, ["VALID", "SYNCING", "VALID"])
    assert confirmed == bellatrix_run(JAX, ["VALID", "SYNCING", "VALID"])
    roots, _, _, at_import, optimistic, head = confirmed
    assert at_import == [False, True, False] and optimistic == [False] * 3 and head == roots[-1]
    invalidated = bellatrix_run(PORT, ["VALID", "SYNCING"], invalidate=1)
    assert invalidated == bellatrix_run(JAX, ["VALID", "SYNCING"], invalidate=1)
    roots, _, _, at_import, _, head = invalidated
    assert at_import == [False, True] and head == roots[0]


def test_empty_sync_aggregate_block_verifies_alike_on_ref_and_torch():
    """A bellatrix block whose sync aggregate has no participants and the
    G2 infinity signature: `sync_aggregate_signature_set` returns no set in
    both packages, and the block (proposal and RANDAO signed for real)
    imports on `ref` in both and on the port's "torch" (plain versions on
    the CPU) to the same root; with the aggregate's signature replaced by a
    real one and still no participant, `sync_aggregate_signature_set`
    raises in every case."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi

    out = {}
    old_device = tapi.DEFAULT_DEVICE
    tapi.DEFAULT_DEVICE = "cpu"
    try:
        for P, backend in ((JAX, "ref"), (PORT, "ref"), (PORT, "torch")):
            ctx = merge_ctx(P, backend)
            chain = P.BeaconChain(P.genesis(4, GENESIS_TIME, ctx), ctx)
            chain.slot_clock.set_slot(1)
            state = chain.state_at_slot(1)
            proposer = P.helpers.get_beacon_proposer_index(state, ctx.preset, ctx.spec)
            sk = ctx.bls.interop_secret_key(proposer)
            sigsets = importlib.import_module(f"{P.name}.state_transition.signature_sets")
            reveal = sk.sign(sigsets._signing_root_for_uint64(0, P.types.schedule_domain(
                ctx.spec, ctx.spec.domain_randao, 0, bytes(state.genesis_validators_root)))).to_bytes()
            block, _ = chain.produce_block_on_state(state.copy(), 1, reveal)
            agg = block.body.sync_aggregate
            assert sigsets.sync_aggregate_signature_set(state, agg, ctx.bls, ctx.preset, ctx.spec) is None
            root = chain.process_block(chain.sign_block(block, sk))
            forged = type(block).deserialize(type(block).serialize(block))
            forged.body.sync_aggregate.sync_committee_signature = reveal
            with pytest.raises(Exception, match="non-infinity"):
                sigsets.sync_aggregate_signature_set(state, forged.body.sync_aggregate, ctx.bls, ctx.preset, ctx.spec)
            out[(P.name, backend)] = (root, bytes(block.body.execution_payload.block_hash))
    finally:
        tapi.DEFAULT_DEVICE = old_device
    assert len(set(out.values())) == 1, out


# -- eth1 ------------------------------------------------------------------------


def seeded_deposit_data(P, seed: int):
    rng = random.Random(seed)
    b = lambda n: bytes(rng.getrandbits(8) for _ in range(n))  # noqa: E731
    return P.containers.DepositData(pubkey=b(48), withdrawal_credentials=b(32), amount=rng.getrandbits(64),
                                    signature=b(96))


@pytest.mark.parametrize("seed,index", [(0, 0), (1, 7), (2, 2**64 - 1)])
def test_deposit_log_codec_is_byte_equal(seed, index):
    assert PORT.json_rpc.DEPOSIT_EVENT_TOPIC == JAX.json_rpc.DEPOSIT_EVENT_TOPIC
    data = PORT.json_rpc.encode_deposit_log(seeded_deposit_data(PORT, seed), index)
    assert data == JAX.json_rpc.encode_deposit_log(seeded_deposit_data(JAX, seed), index)
    (dp, ip), (dj, ij) = PORT.json_rpc.decode_deposit_log(data), JAX.json_rpc.decode_deposit_log(data)
    assert (PORT.containers.DepositData.serialize(dp), ip) == (JAX.containers.DepositData.serialize(dj), ij)
    for broken in (data[:450], data[:32 * 5] + (47).to_bytes(32, "big") + data[32 * 6:]):
        errors = []
        for P in (JAX, PORT):
            with pytest.raises(P.json_rpc.Eth1RpcError) as e:
                P.json_rpc.decode_deposit_log(broken)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def mock_eth1_chain(P, deposits):
    """P's in-memory eth1 chain holding `deposits` (SSZ), two a block, and
    one block after the last: the follow distance of 2 leaves the last
    deposit out of the vote."""
    backend = P.eth1.MockEth1Endpoint(genesis_timestamp=GENESIS_TIME)
    for j, raw in enumerate(deposits):
        backend.submit_deposit(P.containers.DepositData.deserialize(raw))
        if j % 2:
            backend.mine_block()
    backend.mine_block()
    return backend


def followed(P, service, n: int):
    """The follower's deposit root, its vote's SSZ, the proved deposits'
    SSZ and the vote's deposit count."""
    vote = service.eth1_data_for_block()
    proved = service.deposit_cache.deposits_for_block(0, n, vote.deposit_count)
    return (service.deposit_cache.root(), P.containers.Eth1Data.serialize(vote),
            [P.containers.Deposit.serialize(d) for d in proved], int(vote.deposit_count))


@pytest.mark.parametrize("client_pkg,server_pkg", CROSS, ids=["jax_service-port_server", "port_service-jax_server"])
def test_eth1_service_over_json_rpc_is_equal(client_pkg, server_pkg):
    """Five fake-signed deposits, mined two a block: one package's
    follower over its JsonRpcEth1Endpoint (a dead URL first) against the
    other package's MockEth1RpcServer gives the deposit root, the eth1
    vote and the proved deposits (bytes) that the JAX package's in-memory
    follower gives."""
    bls = JAX.bls.backend("fake")
    spec = JAX.types.MINIMAL_SPEC
    deposits = [JAX.containers.DepositData.serialize(
        JAX.eth1.make_deposit(bls, bls.interop_secret_key(i), spec.max_effective_balance, spec)) for i in range(5)]
    server = server_pkg.json_rpc.MockEth1RpcServer(mock_eth1_chain(server_pkg, deposits)).start()
    try:
        endpoint = client_pkg.eth1.JsonRpcEth1Endpoint([DEAD, server.url], timeout=HTTP_TIMEOUT_S)
        service = client_pkg.eth1.Eth1Service(endpoint, follow_distance=2)
        service.update()
        got = followed(client_pkg, service, len(deposits))
    finally:
        server.stop()
    service = JAX.eth1.Eth1Service(mock_eth1_chain(JAX, deposits), follow_distance=2)
    service.update()
    assert got == followed(JAX, service, len(deposits))
    assert got[3] == 4 and len(got[2]) == 4


@pytest.fixture(scope="module")
def ref_deposits():
    """Four deposits signed by the ref oracle through the JAX package's
    make_deposit (SSZ): keys 0, 1 and 3, and between them key 2's deposit
    signed by key 4."""
    bls = JAX.bls.backend("ref")
    spec = JAX.types.MINIMAL_SPEC
    out = []
    for owner, signer in ((0, 0), (1, 1), (2, 4), (3, 3)):
        dd = JAX.eth1.make_deposit(bls, bls.interop_secret_key(signer), spec.max_effective_balance, spec)
        if owner != signer:
            dd.pubkey = bls.interop_secret_key(owner).public_key().to_bytes()
        out.append(JAX.containers.DepositData.serialize(dd))
    return out


def test_make_deposit_is_byte_equal_on_ref(ref_deposits):
    bls = PORT.bls.backend("ref")
    spec = PORT.types.MINIMAL_SPEC
    dd = PORT.eth1.make_deposit(bls, bls.interop_secret_key(0), spec.max_effective_balance, spec)
    assert PORT.containers.DepositData.serialize(dd) == ref_deposits[0]


def test_eth1_genesis_with_a_bad_deposit_is_equal(ref_deposits):
    """initialize_beacon_state_from_eth1 over the four deposits: on `ref`
    in both packages and on the port's "torch" (plain versions on the
    CPU), the same state root, three validators, the bad deposit skipped
    after its one verify."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi

    roots = {}
    old_device = tapi.DEFAULT_DEVICE
    tapi.DEFAULT_DEVICE = "cpu"
    try:
        for P, backend in ((JAX, "ref"), (PORT, "ref"), (PORT, "torch")):
            ctx = P.Context.minimal(backend)
            deposits = [P.containers.DepositData.deserialize(raw) for raw in ref_deposits]
            state = P.eth1_genesis.initialize_beacon_state_from_eth1(b"\x22" * 32, GENESIS_TIME, deposits, ctx)
            assert len(state.validators) == 3 and int(state.eth1_deposit_index) == 4
            assert [bytes(v.pubkey) for v in state.validators] == [bytes(deposits[i].pubkey) for i in (0, 1, 3)]
            roots[(P.name, backend)] = type(state).hash_tree_root(state)
    finally:
        tapi.DEFAULT_DEVICE = old_device
    assert len(set(roots.values())) == 1, roots


# -- slasher ---------------------------------------------------------------------


def slasher_stream(P, seed: int):
    """A seeded stream of batches, each (indexed attestations, signed
    headers, current epoch), of P's containers: votes of 12 validators over
    epochs 0-9 with double votes and surrounds among them, and proposals
    with a few equivocations."""
    rng = random.Random(seed)
    t = P.containers.minimal_types()
    C = P.containers
    batches = []
    for epoch in range(10):
        atts, headers = [], []
        for _ in range(6):
            target = rng.randrange(max(0, epoch - 3), epoch + 1)
            source = rng.randrange(0, target + 1)
            data = C.AttestationData(slot=target * 8 + rng.randrange(8), index=0,
                                     beacon_block_root=bytes([rng.randrange(3)]) * 32,
                                     source=C.Checkpoint(epoch=source, root=b"\x0a" * 32),
                                     target=C.Checkpoint(epoch=target, root=b"\x0b" * 32))
            atts.append(t.IndexedAttestation(attesting_indices=sorted(rng.sample(range(12), rng.randrange(1, 4))),
                                             data=data, signature=bytes([rng.randrange(256)]) * 96))
        for _ in range(3):
            h = C.BeaconBlockHeader(slot=epoch * 8 + rng.randrange(2), proposer_index=rng.randrange(4),
                                    parent_root=b"\x01" * 32, state_root=bytes([rng.randrange(2)]) * 32,
                                    body_root=b"\x02" * 32)
            headers.append(C.SignedBeaconBlockHeader(message=h, signature=bytes([rng.randrange(256)]) * 96))
        batches.append((atts, headers, epoch))
    return batches


def run_slasher(P, batches, db_path=None, history_length=4096, restart_at=None):
    """Feed the batches to P's Slasher (in sqlite at db_path if given,
    closed and reopened before batch `restart_at`): the SSZ of every
    slashing it yields, batch by batch."""
    t = P.containers.minimal_types()
    ctx = P.Context.minimal("fake")
    config = P.slasher.SlasherConfig(history_length=history_length)
    s = P.slasher.Slasher(ctx, config, db_path=db_path)
    out = []
    for i, (atts, headers, epoch) in enumerate(batches):
        if i == restart_at:
            s.db.close()
            s = P.slasher.Slasher(ctx, config, db_path=db_path)
        for a in atts:
            s.accept_attestation(a)
        for h in headers:
            s.accept_block_header(h)
        att_sl, prop_sl = s.process_queued(epoch)
        out.append(([t.AttesterSlashing.serialize(x) for x in att_sl],
                    [t.ProposerSlashing.serialize(x) for x in prop_sl]))
    if s.db is not None:
        s.db.close()
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["memory", "sqlite_restart", "pruned"])
def test_slasher_yields_the_same_slashings(seed, mode, tmp_path):
    """The same stream through both packages' slashers gives the same
    slashings, byte for byte: in memory, in sqlite closed and reopened
    halfway, and with a history of two epochs (pruning, in sqlite)."""
    kwargs = {"memory": {}, "sqlite_restart": {"restart_at": 5}, "pruned": {"history_length": 2}}[mode]
    results = []
    for P in BOTH:
        if mode != "memory":
            kwargs["db_path"] = str(tmp_path / f"{P.name}.sqlite")
        results.append(run_slasher(P, slasher_stream(P, seed), **kwargs))
    assert results[0] == results[1]
    assert any(a or p for a, p in results[0]), "the stream yields no slashing"


# -- utils, monitoring -----------------------------------------------------------

U64 = 2**64 - 1
ARITH_EDGES = [(0, 0), (0, 1), (1, 0), (U64, 0), (U64, 1), (U64 - 1, 1), (2**32, 2**32), (2**32 - 1, 2**32 + 1),
               (U64, U64), (5, 7), (7, 5), (U64, 2)]


@pytest.mark.parametrize("fn", ["safe_add", "safe_sub", "safe_mul", "safe_div", "saturating_add",
                                "saturating_sub"])
def test_safe_arith_behaves_alike_on_edge_values(fn):
    def outcome(P, a, b):
        try:
            return getattr(P.safe_arith, fn)(a, b)
        except P.safe_arith.ArithError as e:
            return ("ArithError", str(e), isinstance(e, ArithmeticError))

    assert PORT.safe_arith.UINT64_MAX == JAX.safe_arith.UINT64_MAX == U64
    for a, b in ARITH_EDGES:
        assert outcome(PORT, a, b) == outcome(JAX, a, b), (fn, a, b)


def test_monitoring_pushes_the_same_records():
    """Each package's MonitoringService pushes to a localhost sink: the
    same record kinds and keys, and the same values but for the clocks and
    the process's own usage; a dead endpoint counts an error and never
    raises."""
    bodies = []

    class Sink(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

    server = HTTPServer(("127.0.0.1", 0), Sink)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for P in BOTH:
            ctx = P.Context.minimal("fake")
            chain = P.BeaconChain(P.genesis(VALIDATORS, GENESIS_TIME, ctx), ctx)
            svc = P.monitoring.MonitoringService(f"http://127.0.0.1:{server.server_port}", chain=chain)
            assert svc.send() is True and svc.tick() is None and (svc.sent, svc.errors) == (1, 0)
            dead = P.monitoring.MonitoringService(DEAD, chain=chain)
            assert dead.send() is False and dead.errors == 1
    finally:
        server.shutdown()
        server.server_close()
    volatile = {"timestamp", "cpu_process_seconds_total", "memory_process_bytes"}
    strip = lambda body: [{k: v for k, v in r.items() if k not in volatile} for r in body]  # noqa: E731
    assert len(bodies) == 2 and strip(bodies[0]) == strip(bodies[1])
    assert [r["process"] for r in bodies[1]] == ["beaconnode", "system"]
    assert all(set(a) == set(b) for a, b in zip(bodies[0], bodies[1]))
