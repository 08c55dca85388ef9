"""The port's network layer (network/ and crypto/secp256k1.py) against the
JAX package's on the CPU.

The pure functions (keccak, secp256k1 with RFC 6979 nonces, RLP and ENR,
snappy and CRC32C, the Req/Resp and gossip codecs, topics, fork ids, the
routing table) are compared byte for byte on seeded inputs. The node-level
tests build both packages' nodes as stand-ins (chain, processor, op pool,
no slasher, no HTTP API) from their harnesses on `fake` (16 interop
validators, minimal preset), check that both heads have the same root, and
drive both `NetworkService`s with the same publishes and ticks over a
`LocalNetwork`: outcomes item by item (True, or the same exception type and
message), op-pool roots, reprocess releases and drops; range sync's batches
and heads, its peer rotation, the unknown-parent trigger and backfill's
chain-break rejection. Three tests run over real localhost sockets, each
with ephemeral ports, waits of at most SOCKET_WAIT_S and `close()` in a
`finally`. One case signs for real: a range-synced segment through the
port's "torch" backend on the CPU against the JAX package on `ref`."""

import importlib
import random
import time
import types

import pytest

VALIDATORS = 16
SOCKET_WAIT_S = 10.0


def package(name: str):
    """One package's modules under the names the tests use."""
    m = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    chain = m("chain")
    return types.SimpleNamespace(
        name=name, keccak=m("network.keccak"), secp=m("crypto.secp256k1"), enr=m("network.enr"),
        discovery=m("network.discovery"), topics=m("network.topics"), fork_id=m("network.fork_id"),
        snappy=m("network.snappy"), peer_manager=m("network.peer_manager"), rpc=m("network.rpc"),
        gossip=m("network.gossip"), sync=m("network.sync"), local=m("network.local"), service=m("network.service"),
        socket_net=m("network.socket_net"), network=m("network"), metrics=m("common.metrics"),
        BeaconChain=chain.BeaconChain, Harness=chain.BeaconChainHarness, Clock=chain.ManualSlotClock,
        BlockError=chain.BlockError, Context=m("state_transition").TransitionContext,
        BeaconProcessor=m("scheduler").BeaconProcessor, OperationPool=m("op_pool").OperationPool,
        helpers=m("state_transition.helpers"), sigsets=m("state_transition.signature_sets"), types=m("types"),
        containers=m("types.containers"))


JAX, PORT = package("lighthouse_tpu"), package("lighthouse_tpu_torch")


def outcome(result):
    """True, or the rejection as (exception type name, message)."""
    return True if result is True else (type(result).__name__, str(result))


def root_of(obj) -> bytes:
    return bytes(type(obj).hash_tree_root(obj))


def node(P, chain):
    """What NetworkService reads of a node: the chain, its context, an op
    pool and a processor, no slasher, no HTTP API."""
    return types.SimpleNamespace(chain=chain, ctx=chain.ctx, op_pool=P.OperationPool(chain.ctx),
                                 processor=P.BeaconProcessor(), slasher=None, api=None)


def slot_tick(n, service, slot: int) -> None:
    """The JAX client's per_slot_task without a slasher."""
    n.chain.slot_clock.set_slot(slot)
    n.chain.fork_choice.on_tick(slot)
    service.process_pending()


def chains(n_slots: int, backend: str = "fake", validators: int = VALIDATORS):
    """(JAX harness, port harness), each extended n_slots, same head."""
    hs = []
    for P in (JAX, PORT):
        h = P.Harness(validators, P.Context.minimal(backend))
        h.extend_chain(n_slots)
        hs.append(h)
    assert hs[0].chain.head_root == hs[1].chain.head_root
    return hs


def chain_blocks(chain) -> list:
    """The chain's blocks from genesis to its head, in slot order."""
    out, root = [], bytes(chain.head_root)
    while root != chain.genesis_block_root:
        out.append(chain.store.get_block(root))
        root = bytes(out[-1].message.parent_root)
    return out[::-1]


def follower_of(P, chain):
    return P.BeaconChain(chain.store.get_state(chain.genesis_block_root).copy(), chain.ctx, slot_clock=P.Clock())


def wait_for(done, what: str) -> None:
    t0 = time.monotonic()
    while not done():
        assert time.monotonic() - t0 < SOCKET_WAIT_S, f"{what}: nothing within {SOCKET_WAIT_S} s"
        time.sleep(0.005)


# -- pure functions, byte for byte -----------------------------------------------------------------------------


def test_keccak_known_answers_and_seeded_inputs():
    import hashlib

    assert PORT.keccak.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert PORT.keccak.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    rng = random.Random(1)
    for n in (0, 1, 135, 136, 137, 272, 1000):
        data = rng.randbytes(n)
        assert PORT.keccak.keccak256(data) == JAX.keccak.keccak256(data), n
        assert PORT.keccak.sha3_256(data) == hashlib.sha3_256(data).digest(), n


def test_secp256k1_rfc6979_sign_and_verify_match():
    import hashlib

    sp, jsp = PORT.secp, JAX.secp
    assert sp.PrivateKey(1).public_key().to_compressed().hex() == \
        "0279be667ef9dcbbac55a06295ce870b07029bfcdb2dce28d959f2815b16f81798"
    d = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721
    digest = hashlib.sha256(b"sample").digest()
    assert next(sp._rfc6979_nonces(d, digest)) == 0xA6E3C57DD01ABE90086538398355DD4C3B17AA873382B0F24D6129493D8AAD60
    rng = random.Random(2)
    for _ in range(6):
        k, digest = rng.randrange(1, sp.N), rng.randbytes(32)
        key, jkey = sp.PrivateKey(k), jsp.PrivateKey(k)
        sig = key.sign_digest(digest)
        assert sig == jkey.sign_digest(digest)
        pub = key.public_key()
        assert pub.to_compressed() == jkey.public_key().to_compressed()
        back = sp.PublicKey.from_compressed(pub.to_compressed())
        assert (back.x, back.y) == (pub.x, pub.y)
        assert pub.verify_digest(*sig, digest)
        assert not pub.verify_digest(sig[0], (sig[1] + 1) % sp.N, digest)
        assert not pub.verify_digest(*sig, rng.randbytes(32))
        assert not pub.verify_digest(0, sig[1], digest)


def test_rlp_roundtrip_and_noncanonical_rejection():
    cases = [b"", b"\x00", b"\x7f", b"\x80", b"dog", [b"cat", b"dog"], [], [[], [[]], [b"a", [b"b"]]], b"x" * 100,
             [b"y" * 60, [b"z" * 60]], 0, 1, 1024]
    for case in cases:
        enc = PORT.enr.rlp_encode(case)
        assert enc == JAX.enr.rlp_encode(case)
        assert PORT.enr.rlp_decode(enc) == JAX.enr.rlp_decode(enc)
    for bad in (b"\x81\x05", b"\xb8\x01x", b"\x83ab", b"\xc3\x01", b"", b"\x01\x02"):
        for P in (PORT, JAX):
            with pytest.raises(ValueError):
                P.enr.rlp_decode(bad)


EIP778_TEXT = (
    "enr:-IS4QHCYrYZbAKWCBRlAy5zzaDZXJBGkcnh4MHcBFZntXNFrdvJjX04jRzjzCBOonrkTfj49"
    "9SZuOh8R33Ls8RRcy5wBgmlkgnY0gmlwhH8AAAGJc2VjcDI1NmsxoQPKY0yuDUmstAHYpMa2_oxV"
    "tw0RW_QAdpzBQA8yWM0xOIN1ZHCCdl8"
)
EIP778_NODE_ID = "a448f24c6d18e575453db13171562b71999873db5b286df957af199ec94617f7"
EIP778_PRIVKEY = bytes.fromhex("b71c71a67e1177ad4e901695e1b4b9ee17ae16c6668d313eac2f96dbcda3f291")


@pytest.mark.parametrize("have_cryptography", [False, True], ids=["pure", "cryptography"])
def test_enr_build_encode_decode_and_tamper(monkeypatch, have_cryptography):
    """Under both branches of enr's signing (the `cryptography` wheel, or the
    pure secp256k1): the EIP-778 example decodes, verifies and round-trips;
    records built from the same seeded keys carry the same content and node
    id in both packages (and the same bytes where the nonce is RFC 6979's),
    each package verifies the other's, and a tampered field fails."""
    if have_cryptography and not PORT.enr._HAVE_CRYPTOGRAPHY:
        pytest.skip("the cryptography wheel is not installed")
    for P in (PORT, JAX):
        monkeypatch.setattr(P.enr, "_HAVE_CRYPTOGRAPHY", have_cryptography)
    example = PORT.enr.Enr.from_text(EIP778_TEXT)
    assert example.verify() and example.node_id().hex() == EIP778_NODE_ID and example.to_text() == EIP778_TEXT
    assert (example.ip(), example.udp(), example.seq) == ("127.0.0.1", 30303, 1)
    ours = PORT.enr.Enr.build(PORT.enr.private_key_from_bytes(EIP778_PRIVKEY), seq=1, ip="127.0.0.1", udp=30303)
    assert ours.node_id().hex() == EIP778_NODE_ID and ours.pairs == example.pairs and ours.verify()
    rng = random.Random(3)
    for i in range(3):
        raw = rng.randbytes(32)
        fields = dict(seq=i + 1, ip=f"10.0.0.{i}", udp=9000 + i, tcp=9100 + i, extra={b"eth2": rng.randbytes(16)})
        rec = PORT.enr.Enr.build(PORT.enr.private_key_from_bytes(raw), **fields)
        jrec = JAX.enr.Enr.build(JAX.enr.private_key_from_bytes(raw), **fields)
        assert rec.pairs == jrec.pairs and rec.node_id() == jrec.node_id() and rec.verify()
        if not have_cryptography:
            assert rec.to_text() == jrec.to_text()
        assert JAX.enr.Enr.from_text(rec.to_text()).verify() and PORT.enr.Enr.from_text(jrec.to_text()).verify()
        back = PORT.enr.Enr.from_rlp(rec.to_rlp())
        assert back == rec and (back.ip(), back.udp(), back.tcp()) == (fields["ip"], fields["udp"], fields["tcp"])
        back.pairs[b"udp"] = (back.udp() + 1).to_bytes(2, "big")
        assert not back.verify()
    generated = PORT.enr.Enr.build(PORT.enr.generate_key(), seq=1, ip="10.1.0.1", udp=1)
    assert generated.verify()


def test_routing_table_matches():
    """The same seeded records (pure keys) in both packages' routing tables:
    the same buckets and the same closest() answers."""
    rng = random.Random(4)
    records = {}
    for P in (PORT, JAX):
        keys = [P.secp.PrivateKey(int.from_bytes(random.Random(5 + i).randbytes(32), "big") % (P.secp.N - 1) + 1)
                for i in range(24)]
        records[P.name] = [P.enr.Enr.build(k, seq=1, ip="127.0.0.1", udp=1000 + i) for i, k in enumerate(keys)]
    tables = {}
    for P in (PORT, JAX):
        recs = records[P.name]
        table = P.discovery.RoutingTable(recs[0].node_id())
        assert not table.insert(recs[0])
        tables[P.name] = (table, [table.insert(r) for r in recs[1:]])
    (table, ins), (jtable, jins) = tables[PORT.name], tables[JAX.name]
    assert ins == jins and len(table) == len(jtable) == sum(ins)
    for _ in range(4):
        target = rng.randbytes(32)
        got = [r.node_id() for r in table.closest(target, limit=6)]
        assert got == [r.node_id() for r in jtable.closest(target, limit=6)]
        assert [PORT.discovery.log2_distance(target, n) for n in got] == sorted(
            JAX.discovery.log2_distance(target, n) for n in got)


def test_snappy_block_frames_and_crc32c_match():
    sn, jsn = PORT.snappy, JAX.snappy
    assert sn.crc32c(b"\x00" * 32) == 0x8A9136AA and sn.crc32c(b"123456789") == 0xE3069283
    rng = random.Random(6)
    cases = [b"", b"a", b"hello world " * 1000, rng.randbytes(70_000), b"\x00" * 300_000,
             bytes(rng.randrange(4) for _ in range(50_000))]
    for data in cases:
        block, frames = sn.compress_block(data), sn.compress_frames(data)
        assert block == jsn.compress_block(data) and frames == jsn.compress_frames(data)
        assert sn.decompress_block(block) == data == sn.decompress_frames(frames)
        assert sn.crc32c(data) == jsn.crc32c(data)
    blob = bytearray(sn.compress_frames(b"hello" * 1000))
    blob[20] ^= 0xFF
    for P in (PORT, JAX):
        with pytest.raises(ValueError):
            P.snappy.decompress_frames(bytes(blob))
        with pytest.raises(ValueError):
            P.snappy.decompress_block(P.snappy._uvarint_encode(1 << 30) + b"\x00", max_output=1 << 20)


def test_rpc_codecs_and_status_match():
    rpc, jrpc = PORT.rpc, JAX.rpc
    rng = random.Random(7)
    for n in (0, 1, 100, 5000):
        data = rng.randbytes(n)
        enc = rpc.encode_payload(data)
        assert enc == jrpc.encode_payload(data) and rpc.decode_payload(enc) == jrpc.decode_payload(enc) == data
    with pytest.raises(ValueError):
        rpc.decode_payload(rpc.encode_payload(b"x" * 100), max_len=10)
    fields = dict(fork_digest=rng.randbytes(4), finalized_root=rng.randbytes(32), finalized_epoch=3,
                  head_root=rng.randbytes(32), head_slot=29)
    status = rpc.StatusMessage(**fields)
    wire = rpc.StatusMessage.serialize(status)
    assert wire == jrpc.StatusMessage.serialize(jrpc.StatusMessage(**fields))
    assert rpc.StatusMessage.hash_tree_root(rpc.StatusMessage.deserialize(wire)) == \
        jrpc.StatusMessage.hash_tree_root(jrpc.StatusMessage.deserialize(wire))
    req = rpc.BlocksByRangeRequest(start_slot=17, count=16, step=1)
    assert rpc.BlocksByRangeRequest.serialize(req) == jrpc.BlocksByRangeRequest.serialize(
        jrpc.BlocksByRangeRequest(start_slot=17, count=16, step=1))
    assert [getattr(rpc.Protocol, p) for p in ("STATUS", "BLOCKS_BY_RANGE", "BLOCKS_BY_ROOT", "PING")] == \
        [getattr(jrpc.Protocol, p) for p in ("STATUS", "BLOCKS_BY_RANGE", "BLOCKS_BY_ROOT", "PING")]


def test_gossip_codecs_match():
    g, jg = PORT.gossip, JAX.gossip
    rng = random.Random(8)
    topic = PORT.topics.Topic.BEACON_BLOCK.full_name(b"\x01\x02\x03\x04")
    for n in (0, 1, 300, 20_000):
        data = rng.randbytes(n)
        frame = g.encode_message(topic, data)
        assert g.message_id(data) == jg.message_id(data) and len(g.message_id(data)) == 20
        assert frame == jg.encode_message(topic, data)
        assert g.decode_message(frame) == jg.decode_message(frame) == (topic, data)
    for ctrl in ({"hello": "A"}, {"graft": [topic]}, {"ihave": {topic: ["00" * 20]}}, {"iwant": ["ab" * 20]}):
        assert g.encode_control(ctrl) == jg.encode_control(ctrl)
    with pytest.raises(ValueError):
        g.decode_message(g.encode_control({"prune": [topic]}))


def test_topics_and_subnets_match():
    T, JT = PORT.topics.Topic, JAX.topics.Topic
    digest = bytes.fromhex("a1b2c3d4")
    assert [t.value for t in T] == [t.value for t in JT]
    for t, jt in zip(T, JT):
        for subnet in (None, 0, 5, 63):
            name = t.full_name(digest, subnet)
            assert name == jt.full_name(digest, subnet)
            wire = name.split("/")[3]
            got, want = T.parse_wire_name(wire), JT.parse_wire_name(wire)
            assert (got and (got[0].value, got[1])) == (want and (want[0].value, want[1]))
            assert got is not None or subnet is not None
    assert T.parse_wire_name("sync_committee_contribution_and_proof") == (T.SYNC_COMMITTEE_CONTRIBUTION, None)
    assert T.parse_wire_name("nonsense") is None is JT.parse_wire_name("nonsense")
    rng = random.Random(9)
    for _ in range(200):
        args = (rng.randint(1, 64), rng.randrange(10_000), rng.randrange(64), rng.choice((8, 32)))
        assert PORT.topics.compute_subnet_for_attestation(*args) == JAX.topics.compute_subnet_for_attestation(*args)


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_fork_id_matches(preset):
    spec = getattr(PORT.Context, preset)("fake").spec
    jspec = getattr(JAX.Context, preset)("fake").spec
    rng = random.Random(10)
    gvr = rng.randbytes(32)
    for epoch in (0, 1, 74240, 10**9):
        fid = PORT.fork_id.enr_fork_id(spec, epoch, gvr)
        wire = PORT.fork_id.ENRForkID.serialize(fid)
        assert wire == JAX.fork_id.ENRForkID.serialize(JAX.fork_id.enr_fork_id(jspec, epoch, gvr))
        assert PORT.fork_id.eth2_enr_pair(spec, epoch, gvr) == {b"eth2": wire}
        assert PORT.fork_id.compatible(fid, wire) and not PORT.fork_id.compatible(fid, b"\x00")


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both peer managers' clocks stopped: no decay between calls and no
    refill of a rate bucket. A record stamps its creation with the running
    clock, a moment after the frozen one, so its first decay moves its
    score by a few microseconds' worth, downward only."""
    now = time.monotonic()
    for P in (PORT, JAX):
        monkeypatch.setattr(P.peer_manager, "time", types.SimpleNamespace(monotonic=lambda: now))


@pytest.mark.usefixtures("frozen_clock")
def test_peer_db_scores_and_rate_limits_match():
    """A seeded trace of penalties, connects and rate-limited requests (the
    clock frozen): the same verdicts in both packages."""
    traces = []
    for P in (PORT, JAX):
        pm = P.peer_manager
        rng = random.Random(11)
        db, limiter, trace = pm.PeerDB(), pm.RateLimiter(), []
        peers = [f"p{i}" for i in range(4)]
        for _ in range(300):
            peer, op = rng.choice(peers), rng.random()
            if op < 0.3:
                rec = db.penalize(peer, rng.choice((pm.PENALTY_INVALID_MESSAGE, pm.PENALTY_BROKEN_PROMISE)))
                trace.append(("pen", peer, round(rec.score, 3), rec.banned, rec.graylisted))
            elif op < 0.5:
                trace.append(("conn", peer, db.on_connect(peer), db.is_usable(peer)))
            else:
                trace.append(("rate", peer, limiter.allow(peer, rng.choice(("status", "ping", "other")))))
        traces.append((trace, sorted(db.connected_peers())))
    assert traces[0] == traces[1]
    trace = traces[0][0]
    assert {e[3] for e in trace if e[0] == "pen"} == {True, False}, "no peer was banned, or every one"
    assert {e[2] for e in trace if e[0] == "rate"} == {True, False}, "no request was rate-limited, or every one"



# -- NetworkService over LocalNetwork, item by item -------------------------------------------------------------


def gossip_items(h):
    """The [gossip] phase's traffic at the head of the port harness (head at
    an epoch's first slot): every validator's one-bit attestation, one
    SignedAggregateAndProof a committee, and the hostile items. Returns
    (items by name, the tick slot)."""
    t, ctx, chain = h.ctx.types, h.ctx, h.chain
    preset, spec = ctx.preset, ctx.spec
    spe = preset.slots_per_epoch
    state, head = chain.head_state(), bytes(chain.head_root)
    epoch = int(state.slot) // spe
    clock = (epoch + 1) * spe - 1
    gvr = bytes(state.genesis_validators_root)
    sk = [kp[0] for kp in h.keypairs]
    Checkpoint = PORT.containers.Checkpoint

    def data_at(slot, index, target_epoch=epoch):
        return t.AttestationData(slot=slot, index=index, beacon_block_root=head,
                                 source=state.current_justified_checkpoint,
                                 target=Checkpoint(epoch=target_epoch, root=head))

    def sign(v, obj, domain):
        return sk[v].sign(PORT.types.compute_signing_root(obj, domain)).to_bytes()

    att_domain = PORT.types.get_domain(state, spec.domain_beacon_attester, epoch, preset)
    duties = [(slot, index, list(PORT.helpers.get_beacon_committee(state, slot, index, preset, spec)))
              for slot in range(epoch * spe, clock + 1)
              for index in range(PORT.helpers.get_committee_count_per_slot(state, epoch, preset))]
    unagg = {c[j]: t.Attestation(aggregation_bits=[i == j for i in range(len(c))], data=data_at(slot, index),
                                 signature=sign(c[j], data_at(slot, index), att_domain))
             for slot, index, c in duties for j in range(len(c))}

    def selection(v, slot):
        domain = PORT.types.schedule_domain(spec, spec.domain_selection_proof, slot // spe, gvr)
        return sk[v].sign(PORT.sigsets._signing_root_for_uint64(slot, domain)).to_bytes()

    def signed_aggregate(aggregator, aggregate, proof):
        m = t.AggregateAndProof(aggregator_index=aggregator, selection_proof=proof, aggregate=aggregate)
        domain = PORT.types.schedule_domain(spec, spec.domain_aggregate_and_proof, epoch, gvr)
        return t.SignedAggregateAndProof(message=m, signature=sign(aggregator, m, domain))

    aggregates = []
    for slot, index, c in duties:
        sig = ctx.bls.aggregate_signatures([ctx.bls.Signature.from_bytes(bytes(unagg[v].signature)) for v in c])
        agg = t.Attestation(aggregation_bits=[True] * len(c), data=data_at(slot, index), signature=sig.to_bytes())
        aggregates.append(signed_aggregate(c[0], agg, selection(c[0], slot)))
    slot0, index0, c0 = duties[0]
    early_committee = list(PORT.helpers.get_beacon_committee(state, clock + 1, 0, preset, spec))
    early_data = data_at(clock + 1, 0, epoch + 1)
    early_domain = PORT.types.get_domain(state, spec.domain_beacon_attester, epoch + 1, preset)
    victim = c0[0]
    items = {
        "batch_a": [a for v, a in sorted(unagg.items()) if v != victim],
        "aggregates": aggregates,
        "tampered_signature": t.Attestation(aggregation_bits=list(unagg[victim].aggregation_bits),
                                            data=unagg[victim].data, signature=bytes(unagg[c0[1]].signature)),
        "unknown_head": t.Attestation(aggregation_bits=list(unagg[c0[1]].aggregation_bits),
                                      data=t.AttestationData(slot=slot0, index=index0, beacon_block_root=b"\xfe" * 32,
                                                             source=state.current_justified_checkpoint,
                                                             target=Checkpoint(epoch=epoch, root=head)),
                                      signature=bytes(unagg[c0[1]].signature)),
        "future_slot": t.Attestation(aggregation_bits=[i == 0 for i in range(len(early_committee))], data=early_data,
                                     signature=sign(early_committee[0], early_data, early_domain)),
        "bad_selection_proof": signed_aggregate(c0[1], aggregates[0].message.aggregate, selection(c0[0], slot0)),
        "victim": unagg[victim],
        "duplicate": t.Attestation.deserialize(t.Attestation.serialize(unagg[duties[-1][2][-1]])),
        "wrong_container": t.Attestation(aggregation_bits=[True] * len(c0), data=data_at(slot0, index0),
                                         signature=b"\xc0" + bytes(95)),
    }
    return items, clock


def carried(items: dict, jax_types) -> dict:
    """The port's items as the JAX package's, by their SSZ bytes."""
    def one(obj):
        name = type(obj).__name__
        jcls = getattr(jax_types, name, None) or getattr(jax_types, name.rsplit("_", 1)[0])
        jobj = jcls.deserialize(type(obj).serialize(obj))
        assert root_of(jobj) == root_of(obj)
        return jobj

    return {k: [one(o) for o in v] if isinstance(v, list) else one(v) for k, v in items.items()}


def run_service(P, h, items: dict, clock: int, monkeypatch) -> dict:
    """A peer publishes the items to node A's NetworkService over a
    LocalNetwork, as chip_smoke's [gossip] does: two ticks at `clock`, one
    at `clock + 1`. Returns what is compared between the packages."""
    chain = h.chain
    got, released = [], []
    svc = P.service
    verifier_cls, verify_aggregates = svc.PipelinedGossipVerifier, svc.batch_verify_gossip_aggregates

    class Recorded(verifier_cls):
        def flush(self, route):
            return super().flush(lambda a, ok: (got.append(("attestation", root_of(a), outcome(ok))), route(a, ok)))

    def recorded_aggregates(chain_, batch):
        results = verify_aggregates(chain_, batch)
        got.extend(("aggregate", root_of(s), outcome(r)) for s, r in zip(batch, results))
        return results

    monkeypatch.setattr(svc, "PipelinedGossipVerifier", Recorded)
    monkeypatch.setattr(svc, "batch_verify_gossip_aggregates", recorded_aggregates)
    n = node(P, chain)
    net = P.local.LocalNetwork()
    a = P.service.NetworkService("A", n, net)
    peer = P.service.NetworkService("P", types.SimpleNamespace(), net)
    on_slot = a.reprocess.on_slot

    def recorded_on_slot(slot):
        out = on_slot(slot)
        released.extend(out)
        return out

    a.reprocess.on_slot = recorded_on_slot
    dropped0 = P.metrics.PROCESSOR_ITEMS_DROPPED.value
    Topic = P.topics.Topic

    def tick(slot):
        slot_tick(n, a, slot)
        assert len(n.processor) == 0 and P.metrics.PROCESSOR_QUEUE_DEPTH.value == 0
        return list(got)

    for att in items["batch_a"] + [items["tampered_signature"], items["unknown_head"], items["future_slot"]]:
        peer.publish_attestation(att)
    for s in items["aggregates"] + [items["bad_selection_proof"]]:
        peer.publish_aggregate(s)
    first = tick(clock)
    peer.publish_attestation(items["victim"])
    peer.publish_attestation(items["duplicate"])
    net.publish("P", Topic.BEACON_AGGREGATE_AND_PROOF, items["wrong_container"])
    second = tick(clock)[len(first):]
    parked = len(a.reprocess)
    third = tick(clock + 1)[len(first) + len(second):]
    pool = {bytes(r): sorted(root_of(x) for x in bucket) for r, bucket in n.op_pool.attestations.items()}
    packed = n.op_pool.get_attestations(chain.state_at_slot(clock + 1))
    return {"first": first, "second": second, "third": third, "parked": parked, "left": len(a.reprocess),
            "released": [root_of(i) for _, i in released], "pool": pool, "packed": [root_of(x) for x in packed],
            "dropped": int(P.metrics.PROCESSOR_ITEMS_DROPPED.value - dropped0)}


def test_network_service_gossip_matches_item_by_item(monkeypatch):
    """[gossip]'s traffic on `fake` (every signature verifies there, so the
    tampered and stolen-proof items are accepted by both packages; the
    signed case below and chip_smoke hold real rejections): the same
    outcomes item by item, in the same order, the same releases, op pool
    and drops; the duplicate, published for a second process_pending,
    rejected as known, and the attestation on the aggregate topic dropped."""
    jh, h = chains(8)
    items, clock = gossip_items(h)
    jitems = carried(items, jh.ctx.types)
    got = run_service(PORT, h, items, clock, monkeypatch)
    assert got == run_service(JAX, jh, jitems, clock, monkeypatch)
    prior = ("AttestationError", "prior attestation known")
    assert ("attestation", root_of(items["duplicate"]), prior) in got["second"]
    assert ("attestation", root_of(items["unknown_head"]), ("AttestationError", "unknown head block")) in got["first"]
    assert ("attestation", root_of(items["future_slot"]), ("AttestationError", "future slot")) in got["first"]
    assert got["third"] == [("attestation", root_of(items["future_slot"]), True)]
    assert got["released"] == [root_of(items["future_slot"])] and (got["parked"], got["left"]) == (2, 1)
    assert got["dropped"] == 1 and len(got["packed"]) == len(items["aggregates"])
    accepted = [r for kind, r, ok in got["first"] if kind == "aggregate" and ok is True]
    assert len(accepted) == len(items["aggregates"]) + 1


# -- range sync over LocalNetwork ------------------------------------------------------------------------------


def sync_trace(P, h, dead: bool = False, trigger: str = "status") -> dict:
    """A fresh follower range-syncs from node A over a LocalNetwork:
    each download (peer, start, count, blocks or the error) and each
    segment import (slots), the head and the machine's state."""
    chain = h.chain
    f = follower_of(P, chain)
    net = P.local.LocalNetwork()
    a = P.service.NetworkService("A", node(P, chain), net)
    fn = node(P, f)
    fs = P.service.NetworkService("F", fn, net)
    downloads, segments = [], []
    by_range, segment = net.blocks_by_range_from, f.process_chain_segment

    def recorded_by_range(requester, peer, start, count):
        try:
            blocks = by_range(requester, peer, start, count)
        except P.sync.SyncPeerError as e:
            downloads.append((peer, start, count, str(e)))
            raise
        downloads.append((peer, start, count, len(blocks)))
        return blocks

    def recorded_segment(blocks):
        segments.append([int(b.message.slot) for b in blocks])
        return segment(blocks)

    net.blocks_by_range_from, f.process_chain_segment = recorded_by_range, recorded_segment
    head_slot = int(chain.head_state().slot)
    if dead:
        class Dead:
            client = types.SimpleNamespace(chain=chain)

            @staticmethod
            def serve_blocks_by_range(start, count):
                raise OSError("connection reset")

        net.peers["dead"] = Dead()
    if trigger == "status":
        f.slot_clock.set_slot(head_slot)
        f.fork_choice.on_tick(head_slot)
        fs.exchange_status()
    else:  # node A gossips its head block: unknown parent at F, range sync
        a.publish_block(chain.store.get_block(bytes(chain.head_root)))
        assert len(fn.processor) == 1
        slot_tick(fn, fs, head_slot)
    return {"head": bytes(f.head_root), "downloads": downloads, "segments": segments,
            "batches": fs.sync.range.batches_imported, "state": fs.sync.range.state.name}


@pytest.mark.parametrize("case", ["status", "dead_peer", "unknown_parent"])
def test_range_sync_matches(case):
    """Status-triggered range sync (20 slots: a batch of two epochs and a
    partial one), the rotation past a peer that fails every download
    (tests/test_sync.py's dead peer), and the unknown-parent trigger from a
    gossip block: the same downloads, segments and head in both packages."""
    jh, h = chains(20)
    kw = {"dead": case == "dead_peer", "trigger": "gossip" if case == "unknown_parent" else "status"}
    got = sync_trace(PORT, h, **kw)
    assert got == sync_trace(JAX, jh, **kw)
    assert got["head"] == bytes(h.chain.head_root) and got["state"] == "IDLE" and got["batches"] == 2
    assert [len(s) for s in got["segments"]] == [16, 4]
    if case == "dead_peer":
        assert [d[0] for d in got["downloads"]] == ["dead", "A", "dead", "A"]
        assert all(isinstance(d[3], str) == (d[0] == "dead") for d in got["downloads"])


def backfill_trace(P, h, hole: int) -> dict:
    """A follower booted from node A's head state walks history backward; A
    leaves out the block at slot `hole` first (a chain break), then serves
    everything."""
    chain = h.chain
    f = P.BeaconChain(chain.head_state().copy(), chain.ctx)
    net = P.local.LocalNetwork()
    a = P.service.NetworkService("A", node(P, chain), net)
    fs = P.service.NetworkService("F", node(P, f), net)
    serve = a.serve_blocks_by_range
    a.serve_blocks_by_range = lambda start, count: [b for b in serve(start, count) if int(b.message.slot) != hole]
    anchor = f.oldest_block_slot
    blocks = sorted(chain.store.blocks.values(), key=lambda b: int(b.message.slot))
    tampered = [b for b in blocks if 0 < int(b.message.slot) < anchor and int(b.message.slot) != hole]
    try:
        f.import_historical_block_batch(tampered)
        direct = None
    except P.BlockError as e:
        direct = outcome(e)
    fs.sync.backfill.tick()
    broken = (fs.sync.backfill.state.name, f.oldest_block_slot, f.backfill_complete)
    a.serve_blocks_by_range = serve
    fs.sync.backfill.tick()
    return {"anchor": anchor, "direct": direct, "broken": broken,
            "healed": (fs.sync.backfill.state.name, f.oldest_block_slot, f.backfill_complete),
            "batches": fs.sync.backfill.batches_imported}


def test_backfill_rejects_a_chain_break_alike():
    jh, h = chains(10)
    got = backfill_trace(PORT, h, hole=6)
    assert got == backfill_trace(JAX, jh, hole=6)
    assert got["direct"] is not None and got["direct"][0] == "BlockError"
    assert got["broken"] == ("FAILED", got["anchor"], False) and got["healed"] == ("IDLE", 1, True)


# -- over real sockets (at most three tests) ---------------------------------------------------------------------


def test_status_and_blocks_by_range_over_sockets_match():
    """Each package's Req/Resp server over TCP answers status and
    BlocksByRange with the same bytes, to its own client and to the other
    package's."""
    jh, h = chains(10)
    servers = []
    try:
        for P, hh in ((PORT, h), (JAX, jh)):
            servers.append(P.rpc.ReqRespServer(types.SimpleNamespace(chain=hh.chain, metadata_seq=3)).start())
        answers = []
        for server in servers:
            for P in (PORT, JAX):
                rpc = P.rpc
                status = rpc.request(server.addr, rpc.Protocol.STATUS, rpc.StatusMessage(head_slot=0),
                                     timeout=SOCKET_WAIT_S)
                req = rpc.BlocksByRangeRequest(start_slot=1, count=16, step=1)
                chunks = rpc.request(server.addr, rpc.Protocol.BLOCKS_BY_RANGE, req, timeout=SOCKET_WAIT_S)
                answers.append((status, chunks))
        assert all(a == answers[0] for a in answers)
        status = PORT.rpc.StatusMessage.deserialize(answers[0][0][0])
        assert (int(status.head_slot), bytes(status.head_root)) == (10, bytes(h.chain.head_root))
        ctx = h.ctx
        blocks = [PORT.types.decode_signed_block(c, ctx.types, ctx.spec, ctx.preset) for c in answers[0][1]]
        assert [root_of(b.message) for b in blocks] == [root_of(b.message) for b in chain_blocks(h.chain)]
    finally:
        for server in servers:
            server.stop()


def test_two_node_range_sync_over_sockets():
    """The port's follower range-syncs over SocketNetwork (status, then
    BlocksByRange with ssz_snappy) to the head the JAX package's harness
    reaches on the same chain, two batches, each one segment."""
    jh, h = chains(20)
    f = follower_of(PORT, h.chain)
    net = PORT.socket_net.SocketNetwork(h.ctx)
    try:
        PORT.service.NetworkService("A", node(PORT, h.chain), net)
        fs = PORT.service.NetworkService("F", node(PORT, f), net)
        segments, segment = [], f.process_chain_segment
        f.process_chain_segment = lambda blocks: segments.append(len(blocks)) or segment(blocks)
        f.slot_clock.set_slot(20)
        f.fork_choice.on_tick(20)
        fs.exchange_status()
        assert bytes(f.head_root) == bytes(jh.chain.head_root) and fs.sync.range.state.name == "IDLE"
        assert fs.sync.range.batches_imported == 2 and segments == [16, 4]
    finally:
        net.close()


def test_gossip_block_over_sockets_and_seen_cache():
    """Node A's next block over GossipNode (the spec topic with the fork
    digest, the spec message id) reaches the follower's processor and
    imports at its tick; a second publish is dropped by the seen cache."""
    _, h = chains(8)
    f = follower_of(PORT, h.chain)
    for b in chain_blocks(h.chain):
        f.process_block(b)
    net = PORT.socket_net.SocketNetwork(h.ctx)
    errors0 = PORT.metrics.GOSSIP_INTERNAL_ERRORS_TOTAL.value
    try:
        a = PORT.service.NetworkService("A", node(PORT, h.chain), net)
        fn = node(PORT, f)
        fs = PORT.service.NetworkService("F", fn, net)
        gossip_a, gossip_f = net._nodes["A"]["gossip"], net._nodes["F"]["gossip"]
        wait_for(lambda: len(gossip_a._peers) > 0, "node A's link to F")
        seen, delivered, mark_seen, deliver = [], [], gossip_f._mark_seen, gossip_f.deliver
        gossip_f._mark_seen = lambda mid: seen.append((mid, mark_seen(mid))) or seen[-1][1]
        gossip_f.deliver = lambda topic, payload, src: delivered.append(topic) or deliver(topic, payload, src)
        root, signed = h.add_block_at_slot(9)
        a.publish_block(signed)
        wait_for(lambda: len(fn.processor) > 0, "the gossip block")
        slot_tick(fn, fs, 9)
        assert bytes(f.head_root) == root
        state = h.chain.head_state()
        digest = PORT.types.compute_fork_digest(bytes(state.fork.current_version), bytes(state.genesis_validators_root))
        mid = JAX.gossip.message_id(type(signed).serialize(signed))
        assert delivered == [PORT.topics.Topic.BEACON_BLOCK.full_name(digest)] and seen == [(mid, True)]
        a.publish_block(signed)
        wait_for(lambda: len(seen) > 1, "the second copy")
        assert seen[1] == (mid, False) and len(delivered) == 1 and len(fn.processor) == 0
        assert PORT.metrics.GOSSIP_INTERNAL_ERRORS_TOTAL.value == errors0
    finally:
        net.close()


# -- one signed case: the port's "torch" backend on the CPU against `ref` -----------------------------------------


def test_signed_range_sync_torch_on_cpu_matches_ref(monkeypatch):
    """Three blocks of a `ref` chain (8 validators), served over a
    LocalNetwork to a follower of each package: the JAX follower on `ref`,
    the port's on "torch" with CPU tensors (the kernels' plain versions).
    A segment whose last proposal carries another block's signature is
    refused by both with one verify; the genuine batch range-syncs with one
    verify to the same head."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi

    monkeypatch.setattr(tapi, "DEFAULT_DEVICE", "cpu")
    jh = JAX.Harness(8, JAX.Context.minimal("ref"))
    jh.extend_chain(3)
    h = PORT.Harness(8, PORT.Context.minimal("torch"))
    assert h.ctx.bls is tapi and h.chain.genesis_block_root == jh.chain.genesis_block_root
    jblocks = chain_blocks(jh.chain)
    results = {}
    for P, f, blocks in ((JAX, follower_of(JAX, jh.chain), jblocks),
                         (PORT, follower_of(PORT, h.chain),
                          [PORT.types.decode_signed_block(type(b).serialize(b), h.ctx.types, h.ctx.spec, h.ctx.preset)
                           for b in jblocks])):
        bls = f.ctx.bls
        calls, verify = [], bls.verify_signature_sets
        monkeypatch.setattr(bls, "verify_signature_sets",
                            lambda sets, **kw: calls.append(len(sets)) or verify(sets, **kw))
        bad = blocks[:-1] + [type(blocks[-1])(message=blocks[-1].message, signature=bytes(blocks[0].signature))]
        try:
            f.process_chain_segment(bad)
            refused = None
        except P.BlockError as e:
            refused = outcome(e)
        assert bytes(f.head_root) == f.genesis_block_root
        net = P.local.LocalNetwork()
        served = types.SimpleNamespace(  # node A: serves the blocks, nothing else
            serve_blocks_by_range=lambda start, count: [b for b in blocks
                                                        if start <= int(b.message.slot) < start + count])
        net.register("A", served)
        fs = P.service.NetworkService("F", node(P, f), net)
        f.slot_clock.set_slot(3)
        f.fork_choice.on_tick(3)
        fs.sync.on_status(3)
        results[P.name] = (refused, bytes(f.head_root), fs.sync.range.batches_imported, list(calls))
    got = results[PORT.name]
    assert got == results[JAX.name]
    assert got[0] == ("BlockError", "segment signature verification failed")
    assert got[1] == bytes(jh.chain.head_root) and got[2] == 1 and got[3] == [got[3][0]] * 2
