"""The port's validator client and Beacon API (validator_client/, http_api/,
networks.py) against the JAX package's on the CPU.

Both packages on `fake` (minimal preset, 8 or 16 interop validators) get
the same inputs: the slashing database's scripted and seeded operations
(outcome by outcome, then the EIP-3076 interchange across packages), an
in-process validator client driving each package's chain for one epoch
in phase0 and in altair (the per-slot summaries and head roots equal),
the same over HTTP with the first candidate down, `json_codec` on seeded
containers byte for byte, both `HttpApiServer`s on identically built
chains answering the same GET routes and bad POSTs with the same status
and body bytes (`/metrics` left out: the port's registry holds families
of its own), the doppelganger service, the aggregator selections, and a
Web3Signer mock of each package serving the other's client. One case
signs for real: a validator-client attestation signed on "torch" (host
signing) equals the JAX store's on `ref`, and its set verifies through
the port's plain versions on the CPU. Servers listen on ephemeral ports
and every wait is bounded by HTTP_TIMEOUT_S."""

import dataclasses
import importlib
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

VALIDATORS = 16
HTTP_TIMEOUT_S = 10.0
GENESIS_TIME = 1_600_000_000


def package(name: str):
    m = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    chain, st = m("chain"), m("state_transition")
    return types.SimpleNamespace(
        name=name, BeaconChain=chain.BeaconChain, Harness=chain.BeaconChainHarness, Context=st.TransitionContext,
        genesis=st.interop_genesis_state, types=m("types"), containers=m("types.containers"), bls=m("crypto.bls"),
        vc=m("validator_client"), vcmod=m("validator_client.validator_client"),
        sp=m("validator_client.slashing_protection"), dop=m("validator_client.doppelganger"),
        w3s=m("validator_client.web3signer"), http_api=m("http_api"), codec=m("http_api.json_codec"),
        ssz=m("ssz.types"), networks=m("networks"), helpers=m("state_transition.helpers"))


JAX, PORT = package("lighthouse_tpu"), package("lighthouse_tpu_torch")


def outcome(fn, *args):
    """None, or the refusal as (exception type name, message)."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the outcome is compared, whatever it is
        return type(e).__name__, str(e)
    return None


def context(P, fork: str, backend: str = "fake"):
    if fork == "phase0":
        return P.Context.minimal(backend)
    spec = dataclasses.replace(P.types.MINIMAL_SPEC, altair_fork_epoch=0)
    return P.Context(P.containers.minimal_types(), spec, P.bls.backend(backend))


def node(P, fork: str, n: int = VALIDATORS, backend: str = "fake"):
    """(ctx, chain, BeaconNodeApi, ValidatorStore with every key)."""
    ctx = context(P, fork, backend)
    chain = P.BeaconChain(P.genesis(n, GENESIS_TIME, ctx), ctx)
    store = P.vc.ValidatorStore(ctx)
    for i in range(n):
        store.add_validator(ctx.bls.interop_keypair(i)[0])
    return ctx, chain, P.vc.BeaconNodeApi(chain), store


def tick(chain, slot: int) -> None:
    chain.slot_clock.set_slot(slot)
    chain.fork_choice.on_tick(slot)


# -- slashing protection -------------------------------------------------------

PK = [bytes([i]) * 48 for i in range(1, 4)]
SCRIPTED = [
    ("block", 0, 5, b"\xaa"), ("block", 0, 5, b"\xaa"), ("block", 0, 5, b"\xbb"), ("block", 0, 4, b"\xcc"),
    ("block", 0, 6, b"\xcc"), ("att", 1, 0, 1, b"\xaa"), ("att", 1, 0, 1, b"\xaa"), ("att", 1, 0, 1, b"\xbb"),
    ("att", 1, 2, 3, b"\xaa"), ("att", 1, 1, 4, b"\xbb"), ("att", 2, 1, 4, b"\xaa"), ("att", 2, 2, 3, b"\xbb"),
    ("att", 2, 5, 4, b"\xcc"), ("att", 2, 0, 2, b"\xdd"), ("att", 2, 3, 6, b"\xdd"), ("block", 9, 1, b"\x00"),
    ("att", 9, 0, 1, b"\x00"),
]


def seeded_ops(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        v, root = int(rng.integers(0, 3)), bytes([int(rng.integers(0, 3))])
        if rng.integers(0, 2):
            ops.append(("block", v, int(rng.integers(0, 6)), root))
        else:
            src = int(rng.integers(0, 5))
            ops.append(("att", v, src, src + int(rng.integers(-1, 4)), root))
    return ops


def apply_op(db, op):
    kind, v, *rest = op
    pk = PK[v] if v < len(PK) else bytes([0x99]) * 48
    if kind == "block":
        slot, root = rest
        return outcome(db.check_and_insert_block_proposal, pk, slot, root * 32)
    src, tgt, root = rest
    return outcome(db.check_and_insert_attestation, pk, src, tgt, root * 32)


@pytest.mark.parametrize("ops", [SCRIPTED, seeded_ops(3076), seeded_ops(3077)], ids=["scripted", "seed0", "seed1"])
def test_slashing_database_refuses_alike(ops):
    """Double proposals, blocks below the minimum, double votes, surround
    and surrounded votes, source after target and unregistered keys: the
    same outcome op by op; the interchange each exports equal, and either
    export imported by the other package refuses the same later ops."""
    gvr = bytes(range(32))
    dbs = []
    for P in (PORT, JAX):
        db = P.sp.SlashingDatabase()
        for pk in PK:
            db.register_validator(pk)
        dbs.append(db)
    got = [[apply_op(db, op) for op in ops] for db in dbs]
    assert got[0] == got[1]
    refusals = {o[1].split(" ")[0] for o in got[0] if o is not None}
    if ops is SCRIPTED:
        assert {"double", "block", "attestation", "source", "unregistered"} <= refusals, refusals
    exports = [db.export_interchange(gvr) for db in dbs]
    assert exports[0] == exports[1] and exports[0]["metadata"]["interchange_format_version"] == "5"
    assert json.loads(dbs[0].export_json()) == json.loads(dbs[1].export_json())
    later = seeded_ops(99, 30)
    again = []
    for P, dump in ((PORT, exports[1]), (JAX, exports[0])):
        db = P.sp.SlashingDatabase()
        db.import_interchange(dump)
        assert db.export_interchange(gvr) == exports[0]
        again.append([apply_op(db, op) for op in ops + later])
    assert again[0] == again[1]
    assert sum(o is not None for o in again[0]) > sum(o is not None for o in got[0])
    for P in (PORT, JAX):
        with pytest.raises(P.sp.SlashingProtectionError, match="unsupported interchange version"):
            P.sp.SlashingDatabase().import_interchange({**exports[0], "metadata": {"interchange_format_version": "4"}})


def test_slashing_database_file_persists(tmp_path):
    """A database file written by one package refuses, through the other,
    what it recorded."""
    path = str(tmp_path / "slashing_protection.sqlite")
    db = PORT.sp.SlashingDatabase(path)
    db.register_validator(PK[0])
    db.check_and_insert_block_proposal(PK[0], 7, b"\xaa" * 32)
    db.check_and_insert_attestation(PK[0], 1, 2, b"\xbb" * 32)
    db.close()
    db = JAX.sp.SlashingDatabase(path)
    assert outcome(db.check_and_insert_block_proposal, PK[0], 7, b"\xcc" * 32) == \
        ("SlashingProtectionError", "double block proposal at slot 7")
    assert outcome(db.check_and_insert_attestation, PK[0], 1, 2, b"\xdd" * 32) == \
        ("SlashingProtectionError", "double vote at target 2")
    db.close()


# -- the validator client, in process and over HTTP ----------------------------


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_vc_drives_each_chain_alike_for_an_epoch(fork):
    """One epoch of duties on each package's chain: the same summary slot by
    slot (block root, attestations, aggregates, sync messages and
    contributions), the same head roots, duty totals and interchange."""
    runs = []
    for P in (JAX, PORT):
        ctx, chain, api, store = node(P, fork)
        vc = P.vc.ValidatorClient(api, store)
        rows = []
        for slot in range(1, ctx.preset.slots_per_epoch + 1):
            tick(chain, slot)
            rows.append((vc.on_slot(slot), bytes(chain.head_root), int(chain.head_state().slot)))
        gvr = bytes(chain.head_state().genesis_validators_root)
        runs.append((rows, dict(vc.duty_totals), store.slashing_db.export_interchange(gvr)))
    assert runs[0] == runs[1]
    rows, totals, _ = runs[1]
    assert all(r[0]["proposed"] == r[1] and r[2] == slot for slot, r in enumerate(rows, 1))
    assert totals["proposed"] == len(rows) and totals["attested"] == VALIDATORS and totals["aggregated"] > 0
    if fork == "altair":
        assert totals["synced"] > 0 and totals["contributions"] > 0
    else:
        assert "synced" not in totals and "contributions" not in totals


def test_vc_over_http_with_the_first_candidate_down():
    """The port's client against the port's server, its first candidate
    unreachable: every duty type crosses the wire and the head follows;
    the JAX client against the JAX server runs the same two slots to the
    same summaries and heads; the dead candidate is marked unhealthy."""
    runs = []
    for P in (PORT, JAX):
        ctx, chain, api, store = node(P, "altair", 8)
        server = P.http_api.HttpApiServer(api).start()
        try:
            client = P.vc.BeaconNodeHttpClient(["http://127.0.0.1:1", f"http://127.0.0.1:{server.port}"], ctx,
                                               timeout=HTTP_TIMEOUT_S)
            vc = P.vc.ValidatorClient(client, store)
            rows = []
            for slot in (1, 2):
                tick(chain, slot)
                rows.append((vc.on_slot(slot), bytes(chain.head_root)))
            assert [c.healthy for c in client.candidates] == [False, True]
            assert client.health() == [False, True]
            assert client.genesis()["genesis_time"] == str(GENESIS_TIME)
            assert client.syncing()["head_slot"] == "2"
            block = chain.store.get_block(chain.head_root).message
            assert sum(block.body.sync_aggregate.sync_committee_bits) > 0
        finally:
            server.stop()
        runs.append(rows)
    assert runs[0] == runs[1]
    for summary, root in runs[0]:
        assert summary["proposed"] == root and summary["attested"] > 0 and summary["synced"] > 0
        assert summary["aggregated"] > 0
    client = PORT.vc.BeaconNodeHttpClient(["http://127.0.0.1:1", "http://127.0.0.1:2"], context(PORT, "phase0"),
                                          timeout=0.5)
    with pytest.raises(PORT.vc.BeaconApiError, match="all beacon nodes failed"):
        client.proposer_duties(0)


# -- json_codec -----------------------------------------------------------------


def seeded_value(P, td, rng):
    """A value of type descriptor `td` drawn from `rng` (lists kept short)."""
    ssz = P.ssz
    if isinstance(td, ssz._UintN):
        return int.from_bytes(rng.integers(0, 256, size=td.bits // 8, dtype=np.uint8).tobytes(), "little")
    if isinstance(td, ssz._Boolean):
        return bool(rng.integers(0, 2))
    if isinstance(td, ssz._ByteVector):
        return rng.integers(0, 256, size=td.length, dtype=np.uint8).tobytes()
    if isinstance(td, ssz.ByteList):
        return rng.integers(0, 256, size=int(rng.integers(0, min(td.limit, 8) + 1)), dtype=np.uint8).tobytes()
    if isinstance(td, ssz.Bitvector):
        return [bool(b) for b in rng.integers(0, 2, size=td.length)]
    if isinstance(td, ssz.Bitlist):
        return [bool(b) for b in rng.integers(0, 2, size=int(rng.integers(0, min(td.limit, 16) + 1)))]
    if isinstance(td, ssz.Vector):
        return [seeded_value(P, td.element, rng) for _ in range(td.length)]
    if isinstance(td, ssz.List):
        return [seeded_value(P, td.element, rng) for _ in range(int(rng.integers(0, min(td.limit, 2) + 1)))]
    if isinstance(td, type) and issubclass(td, ssz.Container):
        return td(**{name: seeded_value(P, ft, rng) for name, ft in zip(td._field_names, td._field_types)})
    raise TypeError(td)


CODEC_TYPES = [
    ("phase0", "Checkpoint"), ("phase0", "AttestationData"), ("phase0", "Attestation"),
    ("phase0", "SignedAggregateAndProof"), ("phase0", "SignedVoluntaryExit"), ("phase0", "ProposerSlashing"),
    ("phase0", "AttesterSlashing"), ("phase0", "Deposit"), ("phase0", "Validator"), ("phase0", "SignedBeaconBlock"),
    ("altair", "SignedBeaconBlock"), ("altair", "SyncCommitteeMessage"), ("altair", "SignedContributionAndProof"),
]


def codec_type(P, fork: str, name: str):
    t = P.containers.minimal_types()
    return getattr(t.for_fork(fork), name, None) or getattr(t, name)


@pytest.mark.parametrize("fork,name", CODEC_TYPES, ids=[f"{f}-{n}" for f, n in CODEC_TYPES])
def test_json_codec_matches_byte_for_byte(fork, name):
    """Seeded containers built in each package from the same draws: the
    same JSON bytes; each package decodes the other's JSON to a value
    that serializes to the same SSZ bytes and round-trips."""
    for seed in range(3):
        values = [seeded_value(P, codec_type(P, fork, name), np.random.default_rng(seed)) for P in (PORT, JAX)]
        tds = [codec_type(P, fork, name) for P in (PORT, JAX)]
        texts = [json.dumps(P.codec.encode(v, td)) for P, v, td in zip((PORT, JAX), values, tds)]
        assert texts[0] == texts[1]
        ssz_bytes = tds[0].serialize(values[0])
        assert ssz_bytes == tds[1].serialize(values[1])
        for P, td, text in ((PORT, tds[0], texts[1]), (JAX, tds[1], texts[0])):
            back = P.codec.decode(json.loads(text), td)
            assert td.serialize(back) == ssz_bytes and json.dumps(P.codec.encode(back, td)) == text
    for P in (PORT, JAX):
        with pytest.raises(TypeError, match="cannot JSON-encode"):
            P.codec.encode(1, object())
        with pytest.raises(TypeError, match="cannot JSON-decode"):
            P.codec.decode(1, object())


# -- the Beacon API server ------------------------------------------------------


def request(port: int, path: str, body=None):
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_api_servers_answer_alike():
    """Both packages' servers over identically built chains (10 blocks on
    `fake`): every GET route and every bad POST gets the same status and
    the same body bytes."""
    servers, heads = [], []
    for P in (PORT, JAX):
        h = P.Harness(VALIDATORS, P.Context.minimal("fake"))
        h.extend_chain(10)
        api = P.vc.BeaconNodeApi(h.chain)
        servers.append((P, h, P.http_api.HttpApiServer(api).start()))
        heads.append(bytes(h.chain.head_root))
    assert heads[0] == heads[1]
    head, h = heads[0], servers[0][1]
    genesis_root = h.chain.genesis_block_root
    state = h.chain.head_state()
    pk0 = "0x" + bytes(state.validators[0].pubkey).hex()
    reveal = "0x" + "11" * 96
    gets = [
        "/eth/v1/node/health", "/eth/v1/node/version", "/eth/v1/node/syncing", "/eth/v1/node/identity",
        "/eth/v1/beacon/genesis", "/eth/v1/config/spec", "/eth/v1/beacon/states/head/finality_checkpoints",
        "/eth/v1/beacon/states/head/root", "/eth/v1/beacon/states/genesis/root",
        "/eth/v1/beacon/states/finalized/root", "/eth/v1/beacon/states/justified/finality_checkpoints",
        f"/eth/v1/beacon/states/0x{head.hex()}/root", "/eth/v1/beacon/states/head/validators",
        f"/eth/v1/beacon/states/head/validators?id=0,3,{pk0}", "/eth/v1/beacon/states/head/validators?id=zz",
        "/eth/v1/beacon/states/head/committees", "/eth/v1/beacon/states/head/committees?epoch=1&slot=9&index=0",
        "/eth/v1/beacon/states/head/committees?epoch=9", "/eth/v1/beacon/states/head/committees?epoch=1&slot=2",
        "/eth/v1/beacon/states/head/committees?index=7", "/eth/v1/beacon/states/head/sync_committees",
        "/eth/v1/beacon/states/head/nonsense", "/eth/v1/beacon/states/nope/root",
        "/eth/v1/beacon/states/0x1234/root", f"/eth/v1/beacon/states/0x{'00' * 32}/root",
        "/eth/v1/beacon/headers/head", "/eth/v1/beacon/headers/genesis", "/eth/v1/beacon/headers/finalized",
        f"/eth/v1/beacon/headers/0x{genesis_root.hex()}", f"/eth/v1/beacon/headers/0x{'ab' * 32}",
        "/eth/v1/beacon/headers/0xzz", "/eth/v1/beacon/blocks/head/root", "/eth/v2/beacon/blocks/head",
        "/eth/v2/beacon/blocks/genesis", "/eth/v2/debug/beacon/heads", "/eth/v1/debug/fork_choice",
        "/eth/v2/debug/beacon/states/head", "/eth/v2/debug/beacon/states/genesis",
        "/eth/v1/beacon/pool/attestations", "/eth/v1/beacon/pool/voluntary_exits",
        "/eth/v1/beacon/pool/proposer_slashings", "/eth/v1/beacon/pool/attester_slashings",
        "/eth/v1/beacon/pool/other", "/eth/v1/validator/duties/proposer/1",
        "/eth/v1/validator/attestation_data?slot=10&committee_index=0",
        "/eth/v1/validator/aggregate_attestation?slot=10&committee_index=0",
        "/eth/v1/validator/sync_committee_contribution?slot=10&subcommittee_index=0"
        f"&beacon_block_root=0x{head.hex()}",
        f"/eth/v2/validator/blocks/11?randao_reveal={reveal}", "/eth/v2/validator/blocks/11",
        "/lighthouse/ui/validator_metrics", "/eth/v1/unknown",
    ]
    posts = [
        ("/eth/v1/beacon/pool/attestations", [{"aggregation_bits": "0x01"}]),
        ("/eth/v1/beacon/pool/attestations", b"not json"),
        ("/eth/v1/beacon/blocks", {"message": {"slot": "11"}}),
        ("/eth/v1/beacon/pool/voluntary_exits", {"message": {"epoch": "0", "validator_index": "999"},
                                                 "signature": "0x" + "00" * 96}),
        ("/eth/v1/validator/duties/attester/1", [0, 1, 2, 3, 999]),
        ("/eth/v1/validator/duties/sync/1", [0, 1]),
        ("/eth/v1/validator/aggregate_and_proofs", [{}]),
        ("/eth/v1/validator/contribution_and_proofs", [{}]),
        ("/eth/v1/beacon/pool/sync_committees", [{}]),
        ("/eth/v1/unknown", {}),
    ]
    try:
        for path in gets:
            answers = [request(srv.port, path) for _, _, srv in servers]
            assert answers[0] == answers[1], path
        for path, body in posts:
            answers = [request(srv.port, path, body) for _, _, srv in servers]
            assert answers[0] == answers[1], path
            assert answers[0][0] >= 400 or "duties" in path, (path, answers[0])
    finally:
        for _, _, srv in servers:
            srv.stop()
    assert [bytes(h.chain.head_root) for _, h, _ in servers] == heads


# -- doppelganger, aggregator selection, remote signing -------------------------


def test_doppelganger_and_aggregator_selection_match():
    """The doppelganger service's verdicts on a seeded script and the
    attestation and sync aggregator selections on seeded proofs: the
    same in both packages."""
    rng = np.random.default_rng(5)
    services = [P.dop.DoppelgangerService(detection_epochs=2) for P in (PORT, JAX)]
    log = [[], []]
    for _ in range(200):
        op, v, epoch = int(rng.integers(0, 3)), int(rng.integers(0, 6)), int(rng.integers(0, 8))
        for k, d in enumerate(services):
            if op == 0:
                log[k].append(d.register(v, epoch))
            elif op == 1:
                log[k].append(outcome(d.observe_attestation, v, epoch))
            else:
                log[k].append(d.allows_signing(v, epoch))
    assert log[0] == log[1] and services[0].detected() == services[1].detected()
    assert services[0].detected() and any(x is False for x in log[0]) and any(x is True for x in log[0])
    proofs = [rng.integers(0, 256, size=96, dtype=np.uint8).tobytes() for _ in range(256)]
    for size in (1, 4, 16, 32, 128, 512):
        sync = [PORT.vcmod.is_sync_aggregator(size, p) for p in proofs]
        att = [PORT.vcmod.is_aggregator(size, p) for p in proofs]
        assert sync == [JAX.vcmod.is_sync_aggregator(size, p) for p in proofs]
        assert att == [JAX.vcmod.is_aggregator(size, p) for p in proofs]
        if size < 32:
            assert all(sync) and all(att)
    assert 0 < sum(PORT.vcmod.is_aggregator(512, p) for p in proofs) < 64


def test_web3signer_mock_serves_the_other_packages_client():
    """Each package's Web3Signer mock, holding interop key 3 on its real
    backend ("torch": host signing; "ref"), serves the other package's
    client: the key listed, signatures byte for byte the local key's,
    an unknown key and an unreachable signer refused alike."""
    port_sk = PORT.bls.backend("torch").interop_keypair(3)[0]
    jax_sk = JAX.bls.backend("ref").interop_keypair(3)[0]
    pk = jax_sk.public_key().to_bytes()
    root = bytes(range(32))
    want = jax_sk.sign(root).to_bytes()
    signers = [PORT.w3s.MockWeb3Signer([port_sk]).start(), JAX.w3s.MockWeb3Signer([jax_sk]).start()]
    try:
        for signer, P in zip(signers, (JAX, PORT)):
            client = P.w3s.Web3SignerClient(signer.url, timeout=HTTP_TIMEOUT_S)
            assert client.upcheck() and client.public_keys() == [pk]
            assert client.sign(pk, root, duty_type="ATTESTATION") == want
            key = P.w3s.RemoteKey(pk, client).set_duty("BLOCK_V2")
            assert key.sign(root).to_bytes() == want
            with pytest.raises(P.w3s.Web3SignerError, match="signer returned 404"):
                client.sign(b"\x0b" * 48, root)
    finally:
        for signer in signers:
            signer.stop()
    for P in (PORT, JAX):
        client = P.w3s.Web3SignerClient("http://127.0.0.1:1", timeout=HTTP_TIMEOUT_S)
        assert not client.upcheck()
        with pytest.raises(P.w3s.Web3SignerError, match="signer unreachable"):
            client.sign(pk, root)


def test_networks_match():
    """The named networks and the Beacon API's config mapping, and the
    config text for each spec, the same in both packages."""
    assert sorted(PORT.networks.NETWORKS) == sorted(JAX.networks.NETWORKS)
    for name in PORT.networks.NETWORKS:
        (preset, spec), (jpreset, jspec) = PORT.networks.network_config(name), JAX.networks.network_config(name)
        assert preset == jpreset
        assert PORT.networks.dump_config_dict(spec) == JAX.networks.dump_config_dict(jspec)
        assert PORT.networks.dump_config_yaml(spec) == JAX.networks.dump_config_yaml(jspec)
        assert PORT.networks.resolve_spec("mainnet", name, None)[0] == preset
    for P in (PORT, JAX):
        with pytest.raises(ValueError, match="unknown network 'nope'"):
            P.networks.network_config("nope")


# -- one attestation signed for real ---------------------------------------------


def test_vc_attestation_signed_on_torch_equals_ref_and_verifies_on_the_cpu(monkeypatch):
    """Validator 0's attestation for slot 1 from each package's store (the
    port's on "torch", whose signing is host `ref` work; the JAX package's
    on `ref`): the same signature bytes; its set, as the chain builds it,
    verifies through the port's plain versions on the CPU, and launches
    no kernel."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api, fp

    monkeypatch.setattr(api, "DEFAULT_DEVICE", "cpu")
    sigs, sets = [], []
    for P, backend in ((PORT, "torch"), (JAX, "ref")):
        ctx, chain, bn, store = node(P, "phase0", 8, backend)
        state = chain.head_state()
        data = bn.attestation_data(1, 0)
        duty = next(d for d in bn.attester_duties(0, store.pubkeys()) if d.slot == 1 and d.committee_index == 0)
        pk = bytes(state.validators[duty.validator_index].pubkey)
        sig = store.sign_attestation(pk, data, state)
        att = ctx.types.Attestation(aggregation_bits=[i == duty.committee_position
                                                      for i in range(duty.committee_length)], data=data,
                                    signature=sig)
        indexed = P.helpers.get_indexed_attestation(state, att, ctx.types, ctx.preset, ctx.spec)
        sigsets = importlib.import_module(f"{P.name}.state_transition.signature_sets")
        sets.append(sigsets.indexed_attestation_signature_set(state, indexed, ctx.bls, ctx.pubkeys.resolver(state),
                                                              ctx.preset, ctx.spec))
        sigs.append(sig)
    assert sigs[0] == sigs[1]
    assert sets[0].message == sets[1].message
    fp.reset_launches()
    assert api.verify_signature_sets([sets[0]]) is True
    assert all(n == 0 for n in fp.LAUNCHES.values())
