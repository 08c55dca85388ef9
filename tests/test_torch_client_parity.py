"""The port's node assembly and binary (client.py, cli.py) against the JAX
package's on the CPU.

Both packages' `Client`s run on `fake` (minimal preset, 16 interop
validators) and are given the same inputs: gossip through the scheduler,
shutdown and resume from a datadir, a checkpoint boot from the other
package's HTTP server, the slasher's slashings at `per_slot_task`; the
binary's `lcli` commands and `beacon-node --run-slots`, run in process by
each package's `cli.main`, write the same bytes and print the same text.
`check-deposit-data` decides a real signature, so it runs on `ref`. Every
comparison is exact; servers listen on ephemeral localhost ports, and
every wait is bounded by HTTP_TIMEOUT_S."""

import importlib
import json
import pathlib
import re
import socket
import types
import urllib.request

import pytest

HTTP_TIMEOUT_S = 10.0
GENESIS_TIME = 1_600_000_000
VALIDATORS = 16


def package(name: str):
    m = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, client=m("client"), cli=m("cli"), chain=m("chain"), scheduler=m("scheduler"),
        containers=m("types.containers"), types=m("types"), bls=m("crypto.bls"), eth1=m("eth1"),
        keystore=m("crypto.keystore"), bv=m("crypto.bls.batch_verifier"), helpers=m("state_transition.helpers"))


JAX, PORT = package("lighthouse_tpu"), package("lighthouse_tpu_torch")
BOTH = [JAX, PORT]


def make_client(P, **kwargs):
    return P.client.Client(P.client.ClientConfig(**{"bls_backend": "fake", "http_enabled": False,
                                                  "genesis_time": GENESIS_TIME, **kwargs}))


def extend(client, slots: int):
    """client's chain extended by `slots` blocks of the harness (its keys
    the interop keys), -> (harness, head root)."""
    harness_cls = importlib.import_module(type(client).__module__.rsplit(".", 1)[0] + ".chain").BeaconChainHarness
    h = harness_cls.__new__(harness_cls)
    h.ctx = client.ctx
    h.keypairs = [client.ctx.bls.interop_keypair(i) for i in range(VALIDATORS)]
    h.chain = client.chain
    return h, h.extend_chain(slots)


def ssz(value) -> bytes:
    return type(value).serialize(value)


# -- the client ------------------------------------------------------------------


def gossip_run(P, tmp_path):
    """Two blocks, then slot 2's attestations as gossip through the
    scheduler and `process_pending`, then `per_slot_task(3)`: the op pool's
    attestations and the slasher's queue after the drain and after the
    tick, the head root."""
    c = make_client(P, datadir=str(tmp_path / P.name), slasher_enabled=True, interop_validators=VALIDATORS)
    try:
        h, head = extend(c, 2)
        state = c.chain.store.get_state(head)
        atts = h.attestations_for_slot(state, head, int(state.slot))
        assert all(c.submit_gossip_attestation(a) for a in atts)
        drained = c.process_pending()
        pool = sorted(ssz(a) for bucket in c.op_pool.attestations.values() for a in bucket)
        queued = [ssz(a) for a in c.slasher.queue]
        c.per_slot_task(int(state.slot) + 1)
        return drained, pool, queued, len(c.slasher.queue), bytes(c.chain.head_root), len(atts)
    finally:
        c.shutdown()


def test_gossip_through_the_scheduler_is_equal(tmp_path):
    want, got = gossip_run(JAX, tmp_path), gossip_run(PORT, tmp_path)
    assert got == want
    drained, pool, queued, after_tick, _, n_atts = got
    assert drained >= 1 and pool and len(queued) == n_atts and after_tick == 0


def resume_run(P, tmp_path):
    cfg = P.client.ClientConfig(bls_backend="fake", datadir=str(tmp_path / P.name), http_enabled=False,
                                interop_validators=VALIDATORS, genesis_time=GENESIS_TIME)
    c1 = P.client.Client(cfg)
    extend(c1, 3)
    head1, genesis1 = bytes(c1.chain.head_root), c1.chain.genesis_block_root
    c1.shutdown()
    c2 = P.client.Client(cfg)
    try:
        assert (c2.chain.genesis_block_root, bytes(c2.chain.head_root)) == (genesis1, head1)
        _, head2 = extend(c2, 1)
        state = c2.chain.head_state()
        return genesis1, head1, bytes(head2), int(state.slot), type(state).hash_tree_root(state)
    finally:
        c2.shutdown()


def test_shutdown_and_resume_are_equal(tmp_path):
    want, got = resume_run(JAX, tmp_path), resume_run(PORT, tmp_path)
    assert got == want and got[3] == 4


@pytest.mark.parametrize("server_pkg,boot_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["port_boots_from_jax", "jax_boots_from_port"])
def test_checkpoint_boot_from_the_other_packages_server(server_pkg, boot_pkg):
    """A node of one package serves its finalized state and block over
    HTTP; a node of the other package boots from them: its anchor is the
    finalized block, its state root the server's finalized state's, and the
    server's later blocks fed as gossip bring it to the same head."""
    a = make_client(server_pkg, http_enabled=True, interop_validators=VALIDATORS)
    try:
        extend(a, 4 * server_pkg.types.MINIMAL_PRESET.slots_per_epoch)
        fin = a.chain.head_state().finalized_checkpoint
        assert fin.epoch >= 1
        b = make_client(boot_pkg, checkpoint_url=f"http://127.0.0.1:{a.http.port}", interop_validators=VALIDATORS)
        try:
            assert bytes(b.chain.head_root) == bytes(fin.root)
            anchored = b.chain.head_state()
            served = a.chain.store.get_state(bytes(fin.root))
            assert type(anchored).hash_tree_root(anchored) == type(served).hash_tree_root(served)
            assert ssz(b.chain.store.get_block(bytes(fin.root))) == ssz(a.chain.store.get_block(bytes(fin.root)))
            later = sorted((s for s in a.chain.store.blocks.values() if s.message.slot > anchored.slot),
                           key=lambda s: s.message.slot)
            ctx = b.ctx
            for signed in later:
                b.submit_gossip_block(boot_pkg.types.decode_signed_block(ssz(signed), ctx.types, ctx.spec, ctx.preset))
                b.chain.slot_clock.set_slot(int(signed.message.slot))
                b.process_pending()
            assert bytes(b.chain.head_root) == bytes(a.chain.head_root)
        finally:
            b.shutdown()
    finally:
        a.shutdown()


def slasher_tick_run(P):
    """A slasher-enabled client after two blocks: a double vote (one of
    them as gossip, verified and queued by the drain; its twin straight to
    the slasher) and a double proposal (two headers of one proposer at one
    slot), then `per_slot_task`: the op pool's slashings as SSZ."""
    c = make_client(P, slasher_enabled=True, interop_validators=VALIDATORS)
    try:
        h, head = extend(c, 2)
        state = c.chain.store.get_state(head)
        att = h.attestations_for_slot(state, head, int(state.slot))[0]
        C, t = P.containers, c.ctx.types
        other = C.AttestationData(slot=att.data.slot, index=att.data.index, beacon_block_root=b"\x77" * 32,
                                  source=att.data.source, target=att.data.target)
        voter = P.helpers.get_indexed_attestation(state, att, t, c.ctx.preset, c.ctx.spec).attesting_indices[0]
        c.slasher.accept_attestation(t.IndexedAttestation(attesting_indices=[voter], data=other,
                                                          signature=b"\x00" * 96))
        assert c.submit_gossip_attestation(att)
        for root in (b"\x01", b"\x02"):
            c.slasher.accept_block_header(C.SignedBeaconBlockHeader(
                message=C.BeaconBlockHeader(slot=2, proposer_index=3, parent_root=root * 32,
                                            state_root=b"\x00" * 32, body_root=b"\x00" * 32),
                signature=b"\x00" * 96))
        c.per_slot_task(int(state.slot) + 1)
        return ([t.ProposerSlashing.serialize(s) for s in c.op_pool.proposer_slashings.values()],
                [t.AttesterSlashing.serialize(s) for s in c.op_pool.attester_slashings])
    finally:
        c.shutdown()


def test_per_slot_task_puts_the_same_slashings_in_the_op_pool():
    want, got = slasher_tick_run(JAX), slasher_tick_run(PORT)
    assert got == want and len(got[0]) == 1 and len(got[1]) == 1


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_constructor_failure_releases_the_coalescer(P):
    """A Client whose HTTP port is taken dies in its constructor and drops
    the coalescer reference it took: no coalescer outlives it."""
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        with pytest.raises(OSError):
            make_client(P, coalesce_bls=True, http_enabled=True, http_port=blocker.getsockname()[1],
                        interop_validators=8)
        assert P.bv._active is None
    finally:
        blocker.close()


def test_port_client_defaults_to_the_card():
    """A port Client built with no backend verifies on the card: its
    context's backend is the torch one and a coalescer runs over it (the
    JAX package's default, "ref", has no async path and runs none)."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import api

    c = PORT.client.Client(PORT.client.ClientConfig(http_enabled=False, interop_validators=8,
                                                    genesis_time=GENESIS_TIME))
    try:
        assert c.ctx.bls is api and c.coalescer is not None and PORT.bv.active_for(api) is c.coalescer
    finally:
        c.shutdown()
    assert PORT.bv._active is None


# -- the binary ------------------------------------------------------------------


def run_main(P, argv, capsys, base: pathlib.Path):
    """P's cli.main(argv) with every `{out}` in argv under base/P.name: (exit
    code, stdout with that directory written as `{out}` and any ephemeral
    port as PORT)."""
    out_dir = base / P.name
    out_dir.mkdir(exist_ok=True)
    rc = P.cli.main([a.replace("{out}", str(out_dir)) for a in argv])
    text = capsys.readouterr().out.replace(str(out_dir), "{out}")
    return rc, re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT", text)


def files(base: pathlib.Path) -> dict:
    return {str(p.relative_to(base)): p.read_bytes() for p in sorted(base.rglob("*")) if p.is_file()}


def both(argv, capsys, tmp_path):
    """The same command through both packages' cli.main: their exit codes,
    output and written files, each equal; -> the port's (rc, text, files)."""
    results = []
    for P in BOTH:
        rc, text = run_main(P, argv, capsys, tmp_path)
        results.append((rc, text, files(tmp_path / P.name)))
    assert results[1] == results[0]
    return results[1]


LCLI = ["lcli", "--preset", "minimal", "--bls-backend", "fake"]


def test_lcli_interop_genesis_and_hash_tree_root(capsys, tmp_path):
    rc, text, written = both(LCLI + ["interop-genesis", "--validators", "8", "--genesis-time", str(GENESIS_TIME),
                                     "--output", "{out}/genesis.ssz"], capsys, tmp_path)
    assert rc == 0 and "genesis.ssz" in written and text.startswith("genesis state (")
    root = text.rsplit("root ", 1)[1].strip()
    rc, text, _ = both(LCLI + ["hash-tree-root", "--type", "BeaconState", "--file", "{out}/genesis.ssz"], capsys,
                       tmp_path)
    assert rc == 0 and text.strip() == root


def test_lcli_transition_blocks(capsys, tmp_path):
    """A pre-state and a block of the JAX harness's chain through both
    binaries' transition-blocks: the same post-state bytes and root, with
    and without signature verification (fake signatures verify)."""
    chain = importlib.import_module("lighthouse_tpu.chain")
    st = importlib.import_module("lighthouse_tpu.state_transition")
    h = chain.BeaconChainHarness(8, st.TransitionContext.minimal("fake"))
    pre = h.chain.head_state().copy()
    h.extend_chain(1)
    block = h.chain.store.get_block(h.chain.head_root)
    for P in BOTH:
        (tmp_path / P.name).mkdir()
        (tmp_path / P.name / "pre.ssz").write_bytes(ssz(pre))
        (tmp_path / P.name / "block.ssz").write_bytes(ssz(block))
    for extra in (["--no-signature-verification"], []):
        rc, text, written = both(LCLI + ["transition-blocks", "--pre", "{out}/pre.ssz", "--block", "{out}/block.ssz",
                                         "--output", "{out}/post.ssz"] + extra, capsys, tmp_path)
        assert rc == 0 and written["post.ssz"] == ssz(h.chain.head_state())


@pytest.fixture(scope="module")
def deposit_files():
    """A deposit signed by the ref oracle and one whose key is another's,
    as SSZ."""
    bls = JAX.bls.backend("ref")
    spec = JAX.types.MINIMAL_SPEC
    good = JAX.eth1.make_deposit(bls, bls.interop_secret_key(0), spec.max_effective_balance, spec)
    bad = JAX.eth1.make_deposit(bls, bls.interop_secret_key(2), spec.max_effective_balance, spec)
    bad.pubkey = bls.interop_secret_key(1).public_key().to_bytes()
    return {"good": ssz(good), "bad": ssz(bad)}


@pytest.mark.parametrize("which,rc_want", [("good", 0), ("bad", 1)])
def test_lcli_check_deposit_data_on_ref(which, rc_want, capsys, tmp_path, deposit_files):
    for P in BOTH:
        (tmp_path / P.name).mkdir()
        (tmp_path / P.name / "deposit.ssz").write_bytes(deposit_files[which])
    rc, text, _ = both(["lcli", "--preset", "minimal", "--bls-backend", "ref", "check-deposit-data", "--file",
                        "{out}/deposit.ssz"], capsys, tmp_path)
    assert rc == rc_want and text.strip().endswith("signature " + ("VALID" if rc_want == 0 else "INVALID"))


def test_lcli_new_testnet_and_the_node_on_it(capsys, tmp_path):
    """new-testnet writes the same config.yaml and genesis.ssz in both
    packages, and `beacon-node --testnet-dir` on it prints the same genesis
    root in both."""
    rc, text, written = both(LCLI + ["new-testnet", "--testnet-dir", "{out}/net", "--validators", "8",
                                     "--altair-fork-epoch", "0", "--bellatrix-fork-epoch", "1"], capsys, tmp_path)
    assert rc == 0 and set(written) == {"net/config.yaml", "net/genesis.ssz"}
    rc, text, _ = both(["beacon-node", "--preset", "minimal", "--bls-backend", "fake", "--testnet-dir", "{out}/net",
                        "--run-slots", "1", "--http-port", "0", "--interop-validators", "8"], capsys, tmp_path)
    assert rc == 0 and "genesis root 0x" in text


def test_lcli_insecure_validators(capsys, tmp_path):
    """insecure-validators prints the same lines and writes keystores with
    the same fields and secrets in both packages (their salt, IV, checksum,
    cipher text and uuid are random)."""
    stores = []
    for P in BOTH:
        rc, text = run_main(P, LCLI + ["insecure-validators", "--count", "3", "--output-dir", "{out}/keys"], capsys,
                            tmp_path)
        assert rc == 0
        out = tmp_path / P.name / "keys"
        loaded = [P.keystore.load(str(out / f"validator_{i}.json")) for i in range(3)]
        stores.append((text, [(ks["pubkey"], ks["path"], ks["version"], ks["crypto"]["kdf"]["function"],
                               {k: v for k, v in ks["crypto"]["kdf"]["params"].items() if k != "salt"},
                               P.keystore.decrypt(ks, str(i))) for i, ks in enumerate(loaded)]))
    assert stores[1] == stores[0]
    bls = PORT.bls.backend("fake")
    assert [s[-1] for s in stores[1][1]] == [bls.interop_secret_key(i).to_bytes() for i in range(3)]


def test_beacon_node_run_slots_prints_the_same_genesis_root(capsys, tmp_path):
    """`beacon-node --run-slots 2 --bls-backend fake` in both packages:
    the same genesis root and head slot, an ephemeral HTTP port each."""
    outputs = []
    for P in BOTH:
        rc, text = run_main(P, ["beacon-node", "--bls-backend", "fake", "--genesis-time", str(GENESIS_TIME),
                                "--run-slots", "2", "--http-port", "0", "--datadir", "{out}/db"], capsys, tmp_path)
        assert rc == 0
        outputs.append(text)
    assert outputs[1] == outputs[0]
    assert re.search(r"^genesis root 0x[0-9a-f]{64}$", outputs[1], re.M) and "ran 2 slots; head slot 0" in outputs[1]


def test_beacon_node_resumes_from_the_other_packages_datadir(capsys, tmp_path):
    """A datadir written by one package's node boots the other package's
    binary with the same genesis root and head."""
    c = make_client(JAX, datadir=str(tmp_path / "db"), interop_validators=VALIDATORS)
    extend(c, 3)
    genesis, head_slot = c.chain.genesis_block_root, int(c.chain.head_state().slot)
    c.shutdown()
    rc = PORT.cli.main(["beacon-node", "--bls-backend", "fake", "--datadir", str(tmp_path / "db"), "--run-slots", "1",
                        "--http-port", "0", "--interop-validators", str(VALIDATORS)])
    text = capsys.readouterr().out
    assert rc == 0 and f"genesis root 0x{genesis.hex()}" in text and f"head slot {head_slot}" in text


def test_binary_http_api_answers(tmp_path):
    """The node the binary builds serves the Beacon API: a port Client's
    /eth/v1/node/version answers as the JAX one's does."""
    versions = []
    for P in BOTH:
        c = make_client(P, http_enabled=True, interop_validators=8)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{c.http.port}/eth/v1/node/version",
                                        timeout=HTTP_TIMEOUT_S) as r:
                versions.append(json.load(r))
        finally:
            c.shutdown()
    assert versions[1] == versions[0]
