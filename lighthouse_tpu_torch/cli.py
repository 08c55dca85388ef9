"""Root CLI: `python -m lighthouse_tpu_torch {beacon-node, validator-client,
account-manager, lcli}`.

Counterpart of lighthouse/lighthouse/src/main.rs:274-277 (the four
subcommands), account_manager/, and the lcli dev tools (lcli/src/main.rs:
54-603: interop-genesis, pretty-ssz, skip-slots).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=["minimal", "mainnet"], default="minimal")
    p.add_argument("--bls-backend", choices=["ref", "fake", "torch"], default="torch")


def _parse_jwt_secret(hex_str: str | None) -> bytes | None:
    if hex_str is None:
        return None
    raw = hex_str.removeprefix("0x")
    try:
        secret = bytes.fromhex(raw)
    except ValueError:
        raise SystemExit("--execution-jwt must be hex") from None
    if len(secret) != 32:
        raise SystemExit(f"--execution-jwt must decode to 32 bytes (got {len(secret)})")
    return secret


def cmd_beacon_node(args) -> int:
    from .client import Client, ClientConfig

    spec_override = None
    genesis_state_path = None
    if args.testnet_dir:
        gpath = pathlib.Path(args.testnet_dir) / "genesis.ssz"
        if gpath.exists():
            genesis_state_path = str(gpath)
        # shared resolution with the validator client (_vc_ctx): a named
        # network supplies the base spec, config.yaml overrides on top
        from .networks import resolve_spec

        _, spec_override = resolve_spec(args.preset, args.network, args.testnet_dir)
    cfg = ClientConfig(
        preset=args.preset,
        network=args.network,
        spec_override=spec_override,
        genesis_state_path=genesis_state_path,
        bls_backend=args.bls_backend,
        datadir=args.datadir,
        http_port=args.http_port,
        slasher_enabled=args.slasher,
        interop_validators=args.interop_validators,
        genesis_time=args.genesis_time or int(time.time()),
        checkpoint_url=args.checkpoint_sync_url,
        execution_endpoints=list(args.execution_endpoint),
        jwt_secret=_parse_jwt_secret(args.execution_jwt),
    )
    client = Client(cfg)
    print(f"beacon node up: preset={args.preset} bls={args.bls_backend}")
    print(f"genesis root 0x{client.chain.genesis_block_root.hex()}")
    if client.http:
        print(f"http api listening on 127.0.0.1:{client.http.port}")
    if args.run_slots is not None:
        clock = client.chain.slot_clock
        for slot in range(1, args.run_slots + 1):
            clock.set_slot(slot)
            client.per_slot_task(slot)
        print(f"ran {args.run_slots} slots; head slot {client.chain.head_state().slot}")
        client.shutdown()
        return 0
    # long-running profile: the slot timer runs as a supervised critical
    # task; its failure (or Ctrl-C) requests a client-wide shutdown with a
    # reason (common/task_executor.rs:281 spawn + shutdown-sender flow)
    from .common.task_executor import TaskExecutor

    executor = TaskExecutor(name="beacon-node")

    def slot_timer():
        spe = client.ctx.spec.seconds_per_slot
        while not executor.exit.wait(spe):
            slot = client.chain.slot() + 1
            client.per_slot_task(slot)

    executor.spawn(slot_timer, "slot-timer", critical=True)
    try:
        reason = executor.wait_shutdown()
    except KeyboardInterrupt:
        executor.shutdown("SIGINT")
        reason = executor.shutdown_reason
    print(f"shutting down: {reason}")
    # the store must not be persisted/migrated while a task still runs:
    # wait (generously) for stragglers before touching the DB
    stragglers = executor.join_all(timeout=30.0)
    if stragglers:
        print(f"WARNING: tasks still running: {[t.name for t in stragglers]}; "
              "skipping head persistence to avoid a torn write")
        return 1
    client.shutdown()
    return 0


def cmd_validator_client(args) -> int:
    import urllib.request

    from .crypto import bls as bls_pkg

    import contextlib

    bls = bls_pkg.backend(args.bls_backend)
    secret_keys = []
    with contextlib.ExitStack() as locks:
        if args.keystores:
            # Keystore-based key loading (account-manager output) — imported
            # lazily so interop-key runs work where the `cryptography`
            # dependency is unavailable.
            from .crypto import keystore as ks
            from .validator_client.lockfile import Lockfile

            password = args.password or ""
            for path in args.keystores:
                # one lock per keystore: a second VC on the same keys must
                # refuse to start (common/lockfile — anti-slashing); the
                # ExitStack unwinds partial acquisitions on any failure
                locks.enter_context(Lockfile(str(path) + ".lock"))
                secret_keys.append(
                    bls.SecretKey.from_bytes(ks.decrypt(ks.load(path), password))
                )
        else:
            for i in range(args.interop_validators):
                secret_keys.append(bls.interop_secret_key(i))
        urls = args.beacon_nodes or ["http://127.0.0.1:5052"]
        print(f"validator client: {len(secret_keys)} keys, beacon nodes {urls}")

        # duties over the typed HTTP client (common/eth2 +
        # beacon_node_fallback.rs): the VC is a pure API consumer — the
        # genesis fetch goes through the same fallback transport
        from .validator_client import (
            BeaconApiError,
            BeaconNodeHttpClient,
            MetricsServer,
            ValidatorClient,
            ValidatorStore,
        )

        ctx = _vc_ctx(args)
        client = BeaconNodeHttpClient(urls, ctx)
        genesis = client.genesis()
        genesis_time = int(genesis["genesis_time"])
        print(f"connected; genesis time {genesis_time}")
        store = ValidatorStore(ctx)
        for sk in secret_keys:
            store.add_validator(sk)
        vc = ValidatorClient(client, store)
        metrics_server = None
        if args.metrics_port is not None:
            # the VC's own scrape surface (separate from any BN's /metrics)
            metrics_server = MetricsServer(
                vc=vc, host=args.metrics_address, port=args.metrics_port
            ).start()
            print(f"vc metrics listening on {args.metrics_address}:{metrics_server.port}")
        locks.callback(lambda: metrics_server and metrics_server.stop())

        if args.run_slots is not None:
            start = int(client.syncing()["head_slot"])
            for slot in range(start + 1, start + args.run_slots + 1):
                summary = vc.on_slot(slot)
                print(f"slot {slot}: {summary}")
            return 0
        # production pacing: the wall clock + genesis_time define the slot
        # (slot_clock.rs), so duty latency cannot accumulate drift; a
        # transient all-BN outage is logged and ridden out, never fatal
        spe = ctx.spec.seconds_per_slot
        last_done = -1
        try:
            while True:
                slot = max(0, (int(time.time()) - genesis_time) // spe)
                if slot <= last_done:
                    time.sleep(max(0.2, (genesis_time + (slot + 1) * spe) - time.time()))
                    continue
                try:
                    summary = vc.on_slot(slot)
                    print(f"slot {slot}: {summary}")
                except BeaconApiError as e:
                    print(f"slot {slot}: beacon nodes unavailable ({e}); retrying")
                last_done = slot
        except KeyboardInterrupt:
            pass
    return 0


def _ctx_for(args):
    from .state_transition import TransitionContext

    return (
        TransitionContext.minimal(args.bls_backend)
        if args.preset == "minimal"
        else TransitionContext.mainnet(args.bls_backend)
    )


def _vc_ctx(args):
    """The validator-client's context, honoring --network/--testnet-dir
    through the SAME networks.resolve_spec the beacon node uses: the VC
    must sign duties in the fork domains the testnet's beacon nodes
    expect (an lcli-generated testnet moves fork epochs via config.yaml;
    signing against the preset default spec produces wrong-domain
    signatures the BN rejects). NOT shared with lcli, whose new-testnet
    --testnet-dir is an OUTPUT path."""
    from .networks import resolve_spec
    from .state_transition import TransitionContext

    preset_name, spec = resolve_spec(args.preset, args.network, args.testnet_dir)
    ctx = (
        TransitionContext.minimal(args.bls_backend)
        if preset_name == "minimal"
        else TransitionContext.mainnet(args.bls_backend)
    )
    if spec is not None:
        ctx.spec = spec
    return ctx


def cmd_account_manager(args) -> int:
    from .crypto import keystore as ks
    from .crypto.wallet import Wallet

    if args.account_cmd == "wallet-create":
        w = Wallet.create(args.name, args.password)
        with open(args.output, "w") as f:
            json.dump(w.data, f, indent=2)
        print(f"wallet {args.name} written to {args.output}")
        return 0
    if args.account_cmd == "validator-create":
        with open(args.wallet) as f:
            w = Wallet({**json.load(f)})
        store, index = w.next_validator(args.password, args.keystore_password)
        out = args.output or f"validator_{index}.json"
        ks.save(store, out)
        with open(args.wallet, "w") as f:
            json.dump(w.data, f, indent=2)
        print(f"validator {index} keystore written to {out} (path {store['path']})")
        return 0
    raise SystemExit(f"unknown account-manager command {args.account_cmd}")


def cmd_lcli(args) -> int:
    from .state_transition import interop_genesis_state, process_slots

    ctx = _ctx_for(args)
    if args.lcli_cmd == "interop-genesis":
        state = interop_genesis_state(args.validators, args.genesis_time, ctx)
        data = type(state).serialize(state)
        with open(args.output, "wb") as f:
            f.write(data)
        root = type(state).hash_tree_root(state)
        print(f"genesis state ({len(data)} bytes) -> {args.output}; root 0x{root.hex()}")
        return 0
    if args.lcli_cmd == "skip-slots":
        with open(args.state, "rb") as f:
            from .types import decode_beacon_state

            state = decode_beacon_state(f.read(), ctx.types, ctx.spec)
        process_slots(state, state.slot + args.slots, ctx)
        with open(args.output, "wb") as f:
            f.write(type(state).serialize(state))
        print(f"advanced to slot {state.slot} -> {args.output}")
        return 0
    if args.lcli_cmd == "pretty-ssz":
        from .http_api.json_codec import encode

        td = getattr(ctx.types, args.type)
        with open(args.file, "rb") as f:
            value = td.deserialize(f.read())
        print(json.dumps(encode(value, td), indent=2))
        return 0
    if args.lcli_cmd == "transition-blocks":
        # lcli/src/transition_blocks.rs: pre-state + block -> post-state
        from .state_transition import BlockSignatureStrategy, state_transition
        from .types import decode_beacon_state, decode_signed_block

        with open(args.pre, "rb") as f:
            state = decode_beacon_state(f.read(), ctx.types, ctx.spec)
        with open(args.block, "rb") as f:
            signed = decode_signed_block(f.read(), ctx.types, ctx.spec, ctx.preset)
        strategy = (
            BlockSignatureStrategy.NO_VERIFICATION
            if args.no_signature_verification
            else BlockSignatureStrategy.VERIFY_BULK
        )
        state_transition(state, signed, ctx, strategy=strategy)
        with open(args.output, "wb") as f:
            f.write(type(state).serialize(state))
        root = type(state).hash_tree_root(state)
        print(f"post-state slot {int(state.slot)} -> {args.output}; root 0x{root.hex()}")
        return 0
    if args.lcli_cmd == "hash-tree-root":
        # lcli parse_ssz's root mode: root of any named SSZ type
        td = getattr(ctx.types, args.type)
        with open(args.file, "rb") as f:
            value = td.deserialize(f.read())
        print("0x" + td.hash_tree_root(value).hex())
        return 0
    if args.lcli_cmd == "change-genesis-time":
        from .types import decode_beacon_state

        with open(args.state, "rb") as f:
            state = decode_beacon_state(f.read(), ctx.types, ctx.spec)
        state.genesis_time = args.genesis_time
        with open(args.state, "wb") as f:
            f.write(type(state).serialize(state))
        print(f"genesis time -> {args.genesis_time}")
        return 0
    if args.lcli_cmd == "check-deposit-data":
        # lcli/src/check_deposit_data.rs: decode + verify the deposit sig
        from .state_transition import signature_sets as sigsets
        from .types.containers import DepositData

        with open(args.file, "rb") as f:
            dd = DepositData.deserialize(f.read())
        s = sigsets.deposit_signature_set(dd, ctx.bls, ctx.spec)
        ok = ctx.bls.verify_signature_sets([s])
        print(f"pubkey 0x{bytes(dd.pubkey).hex()} amount {int(dd.amount)} "
              f"signature {'VALID' if ok else 'INVALID'}")
        return 0 if ok else 1
    if args.lcli_cmd == "generate-bootnode-enr":
        from .network.enr import Enr, generate_key

        enr = Enr.build(generate_key(), ip=args.ip, udp=args.port).to_text()
        with open(args.output, "w") as f:
            f.write(enr)
        print(enr)
        return 0
    if args.lcli_cmd == "new-testnet":
        # lcli/src/new_testnet.rs: write a testnet directory (config.yaml +
        # genesis.ssz) consumable by `beacon-node --testnet-dir`
        import dataclasses as _dc

        from .networks import dump_config_yaml
        from .state_transition import interop_genesis_state as _genesis

        out = pathlib.Path(args.testnet_dir)
        out.mkdir(parents=True, exist_ok=True)
        overrides = {"altair_fork_epoch": args.altair_fork_epoch}
        if args.bellatrix_fork_epoch is not None:
            overrides["bellatrix_fork_epoch"] = args.bellatrix_fork_epoch
        spec = _dc.replace(ctx.spec, **overrides)
        (out / "config.yaml").write_text(dump_config_yaml(spec))
        state = _genesis(args.validators, args.genesis_time, _dc.replace(ctx, spec=spec))
        (out / "genesis.ssz").write_bytes(type(state).serialize(state))
        root = type(state).hash_tree_root(state)
        print(f"testnet dir {out}: config.yaml + genesis.ssz (root 0x{root.hex()})")
        return 0
    if args.lcli_cmd == "insecure-validators":
        # lcli/src/insecure_validators.rs: interop keystores on disk for
        # testnets (NOT for real money — the password is the index)
        from .crypto import keystore as ks_mod

        out = pathlib.Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for i in range(args.count):
            sk = ctx.bls.interop_secret_key(i)
            # deliberately weak KDF + index password: testnet keys only
            store = ks_mod.encrypt(
                sk.to_bytes(),
                password=str(i),
                pubkey=sk.public_key().to_bytes().hex(),
                kdf_function="pbkdf2",
                kdf_params={"c": 2, "dklen": 32},
            )
            path = out / f"validator_{i}.json"
            ks_mod.save(store, str(path))
            print(f"wrote {path} pubkey 0x{sk.public_key().to_bytes().hex()[:16]}...")
        return 0
    raise SystemExit(f"unknown lcli command {args.lcli_cmd}")


def cmd_boot_node(args) -> int:
    """Standalone discovery server (the lighthouse boot_node subcommand,
    lighthouse/boot_node/src/lib.rs:1)."""
    import pathlib
    import time

    from .network.discovery import DiscoveryService
    from .network.enr import generate_key, private_key_from_bytes

    if args.key_file and pathlib.Path(args.key_file).exists():
        key = private_key_from_bytes(bytes.fromhex(pathlib.Path(args.key_file).read_text().strip()))
    else:
        key = generate_key()
        if args.key_file:
            raw = key.private_numbers().private_value.to_bytes(32, "big")
            pathlib.Path(args.key_file).write_text(raw.hex())
    svc = DiscoveryService(key, port=args.port, boot_mode=True)
    text = svc.enr.to_text()
    print(f"boot node listening on udp/{svc.addr[1]}")
    print(f"enr: {text}")
    if args.enr_file:
        pathlib.Path(args.enr_file).write_text(text)
    try:
        deadline = time.time() + args.run_seconds if args.run_seconds else None
        while deadline is None or time.time() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        svc.close()
    print(f"peers learned: {len(svc.table)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="lighthouse_tpu_torch")
    sub = root.add_subparsers(dest="command", required=True)

    bn = sub.add_parser("beacon-node", help="run a beacon node")
    _add_common(bn)
    from .networks import NETWORKS

    bn.add_argument(
        "--network",
        choices=sorted(NETWORKS),
        help="named network config",
    )
    bn.add_argument("--testnet-dir", help="directory with a config.yaml spec override")
    bn.add_argument("--datadir")
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--slasher", action="store_true")
    bn.add_argument("--interop-validators", type=int, default=16)
    bn.add_argument("--genesis-time", type=int)
    bn.add_argument("--checkpoint-sync-url", help="boot from a trusted node's finalized state")
    bn.add_argument("--execution-endpoint", action="append", default=[], help="engine API URL (repeatable)")
    bn.add_argument("--execution-jwt", help="hex-encoded 32-byte engine JWT secret")
    bn.add_argument("--run-slots", type=int, help="run N slots then exit (testing)")
    bn.set_defaults(fn=cmd_beacon_node)

    vc = sub.add_parser("validator-client", help="run a validator client")
    _add_common(vc)
    vc.add_argument(
        "--network",
        choices=sorted(NETWORKS),
        help="named network config (duty signatures use its fork domains)",
    )
    vc.add_argument(
        "--testnet-dir",
        help="directory with a config.yaml spec override (lcli new-testnet "
        "output) — required for correct duty-signature domains on testnets",
    )
    vc.add_argument(
        "--beacon-node", dest="beacon_nodes", action="append", default=[],
        help="beacon node URL (repeatable: health-ordered fallback)",
    )
    vc.add_argument("--keystores", nargs="*")
    vc.add_argument("--password")
    vc.add_argument("--interop-validators", type=int, default=0)
    vc.add_argument(
        "--metrics-port", type=int,
        help="serve the VC's own /metrics + /health on this port (0 = ephemeral)",
    )
    vc.add_argument(
        "--metrics-address", default="127.0.0.1",
        help="bind address for the VC metrics server (0.0.0.0 for remote scrapes)",
    )
    vc.add_argument("--run-slots", type=int, help="run N duty slots then exit (testing)")
    vc.set_defaults(fn=cmd_validator_client)

    am = sub.add_parser("account-manager", help="wallet and validator keys")
    am_sub = am.add_subparsers(dest="account_cmd", required=True)
    wc = am_sub.add_parser("wallet-create")
    wc.add_argument("--name", required=True)
    wc.add_argument("--password", required=True)
    wc.add_argument("--output", required=True)
    vcr = am_sub.add_parser("validator-create")
    vcr.add_argument("--wallet", required=True)
    vcr.add_argument("--password", required=True)
    vcr.add_argument("--keystore-password", required=True)
    vcr.add_argument("--output")
    am.set_defaults(fn=cmd_account_manager)

    bo = sub.add_parser("boot-node", help="standalone discovery boot node")
    bo.add_argument("--port", type=int, default=9000)
    bo.add_argument("--key-file", help="32-byte hex secp256k1 key (generated if absent)")
    bo.add_argument("--enr-file", help="write the textual ENR here")
    bo.add_argument("--run-seconds", type=float, help="serve N seconds then exit (testing)")
    bo.set_defaults(fn=cmd_boot_node)

    lc = sub.add_parser("lcli", help="dev tools")
    _add_common(lc)
    lc_sub = lc.add_subparsers(dest="lcli_cmd", required=True)
    ig = lc_sub.add_parser("interop-genesis")
    ig.add_argument("--validators", type=int, default=16)
    ig.add_argument("--genesis-time", type=int, default=1600000000)
    ig.add_argument("--output", required=True)
    sk = lc_sub.add_parser("skip-slots")
    sk.add_argument("--state", required=True)
    sk.add_argument("--slots", type=int, required=True)
    sk.add_argument("--output", required=True)
    tb = lc_sub.add_parser("transition-blocks")
    tb.add_argument("--pre", required=True)
    tb.add_argument("--block", required=True)
    tb.add_argument("--output", required=True)
    tb.add_argument("--no-signature-verification", action="store_true")
    hr = lc_sub.add_parser("hash-tree-root")
    hr.add_argument("--type", required=True)
    hr.add_argument("--file", required=True)
    cg = lc_sub.add_parser("change-genesis-time")
    cg.add_argument("--state", required=True)
    cg.add_argument("--genesis-time", type=int, required=True)
    cd = lc_sub.add_parser("check-deposit-data")
    cd.add_argument("--file", required=True)
    ge = lc_sub.add_parser("generate-bootnode-enr")
    ge.add_argument("--ip", default="127.0.0.1")
    ge.add_argument("--port", type=int, default=9000)
    ge.add_argument("--output", required=True)
    nt = lc_sub.add_parser("new-testnet")
    nt.add_argument("--testnet-dir", required=True)
    nt.add_argument("--validators", type=int, default=16)
    nt.add_argument("--genesis-time", type=int, default=1600000000)
    nt.add_argument("--altair-fork-epoch", type=int, default=0)
    nt.add_argument("--bellatrix-fork-epoch", type=int, default=None)
    iv = lc_sub.add_parser("insecure-validators")
    iv.add_argument("--count", type=int, required=True)
    iv.add_argument("--output-dir", required=True)
    ps = lc_sub.add_parser("pretty-ssz")
    ps.add_argument("--type", required=True)
    ps.add_argument("--file", required=True)
    lc.set_defaults(fn=cmd_lcli)
    return root


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
