"""Eth2 Beacon API HTTP server (subset) + Prometheus /metrics.

Counterpart of lighthouse/beacon_node/http_api (lib.rs:243 serve) and
http_metrics — stdlib ThreadingHTTPServer, no framework. The endpoint set
is the slice a validator client needs (duties, attestation data, block
production, publish) plus node/chain introspection:

  GET  /eth/v1/node/health | /eth/v1/node/version | /eth/v1/node/syncing
  GET  /eth/v1/beacon/genesis
  GET  /eth/v1/beacon/states/{state_id}/finality_checkpoints
  GET  /eth/v1/beacon/states/{state_id}/root
  GET  /eth/v1/beacon/headers/{block_id}
  POST /eth/v1/beacon/pool/attestations
  POST /eth/v1/beacon/blocks
  GET  /eth/v1/validator/duties/proposer/{epoch}
  POST /eth/v1/validator/duties/attester/{epoch}
  GET  /eth/v1/validator/attestation_data?slot=&committee_index=
  GET  /eth/v2/validator/blocks/{slot}?randao_reveal=
  GET  /metrics        (Prometheus text; http_metrics' scrape surface)
  GET  /lighthouse/ui/validator_metrics   (ValidatorMonitor attribution)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

# ThreadingHTTPServer handles requests concurrently, but the chain, fork
# choice, op pool, and container root memos are not thread-safe: one lock
# serializes route execution (the reference serializes mutation through the
# BeaconProcessor's single manager loop instead).
_CHAIN_LOCK = threading.Lock()


def _parse_root(hex_id: str, what: str) -> bytes:
    try:
        root = bytes.fromhex(hex_id.removeprefix("0x"))
    except ValueError as e:
        raise ApiError(400, f"invalid {what} id: {hex_id!r}") from e
    if len(root) != 32:
        raise ApiError(400, f"invalid {what} id length: {hex_id!r}")
    return root

from ..chain.beacon_chain import BlockError
from ..common.metrics import REGISTRY
from ..state_transition.helpers import StateTransitionError
from ..types import compute_epoch_at_slot
from ..types.containers import BeaconBlockHeader
from .json_codec import decode, encode


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _data(payload) -> bytes:
    return json.dumps({"data": payload}).encode()


class _Handler(BaseHTTPRequestHandler):
    api = None  # BeaconNodeApi, injected by serve()
    chain = None

    def log_message(self, *args):  # quiet
        pass

    def _send(self, status: int, body: bytes, content_type: str = "application/json"):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str):
        self._send(status, json.dumps({"code": status, "message": message}).encode())

    def _block_root_for(self, block_id: str) -> bytes:
        """Resolve a block id (head / genesis / finalized / 0x-root) to a
        root KNOWN to this chain, 404 otherwise — the shared front half of
        every block route."""
        chain = self.chain
        if block_id == "head":
            return chain.head_root
        if block_id == "genesis":
            return chain.genesis_block_root
        if block_id == "finalized":
            root = bytes(chain.fork_choice.finalized_checkpoint.root)
            # pre-finalization the checkpoint root is ZERO; the Beacon API
            # convention resolves that to genesis (otherwise the headers
            # route would serve the genesis header labeled 0x00…00)
            return root if root != b"\x00" * 32 else chain.genesis_block_root
        root = _parse_root(block_id, "block")
        if chain.store.get_block(root) is None and root != chain.genesis_block_root:
            raise ApiError(404, "block not found")
        return root

    def _state_for(self, state_id: str):
        chain = self.chain
        if state_id in ("head", "justified", "finalized"):
            if state_id == "head":
                return chain.head_state()
            cp = (
                chain.fork_choice.justified_checkpoint
                if state_id == "justified"
                else chain.fork_choice.finalized_checkpoint
            )
            st = chain.store.get_state(bytes(cp.root))
            if st is None:
                raise ApiError(404, "state not found")
            return st
        if state_id == "genesis":
            st = chain.store.get_state(chain.genesis_block_root)
            if st is None:
                raise ApiError(404, "state not found")
            return st
        if state_id.startswith("0x"):
            st = chain.store.get_state(_parse_root(state_id, "state"))
            if st is None:
                raise ApiError(404, "state not found")
            return st
        raise ApiError(400, f"unsupported state id {state_id}")

    # -- GET ---------------------------------------------------------------

    def do_GET(self):
        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            q = parse_qs(url.query)
            # Large downloads (the SSZ state) serialize under the lock but
            # stream to the socket outside it, so a slow checkpoint-sync
            # client cannot stall every other route.
            if len(parts) == 6 and parts[:4] == ["eth", "v2", "debug", "beacon"]:
                with _CHAIN_LOCK:
                    state = self._state_for(parts[5])
                    body = type(state).serialize(state)
                self._send(200, body, "application/octet-stream")
                return
            if parts == ["eth", "v1", "events"]:
                self._serve_events(q)  # long-lived stream: never holds the lock
                return
            with _CHAIN_LOCK:
                self._route_get(parts, q)
        except ApiError as e:
            self._error(e.status, str(e))
        except Exception as e:  # noqa: BLE001 - surface as 500, don't kill the server
            self._error(500, f"{type(e).__name__}: {e}")

    def _route_get(self, parts, q):
        chain, api, ctx = self.chain, self.api, self.chain.ctx
        t = ctx.types
        if parts == ["metrics"]:
            self._send(200, REGISTRY.gather().encode(), "text/plain; version=0.0.4")
        elif parts == ["lighthouse", "ui", "validator_metrics"]:
            # per-validator attribution for registered keys (the reference's
            # /lighthouse/ui/validator_metrics UI endpoint)
            self._send(200, _data(chain.validator_monitor.ui_payload()))
        elif parts == ["lighthouse", "ui", "slot_ledger"]:
            # per-slot budget attribution (common/slot_ledger.py)
            self._send(200, _data(chain.slot_ledger.ui_payload()))
        elif parts == ["lighthouse", "ui", "flight_recorder"]:
            # correlated event ring; ?corr_id= filters to one message's path
            corr_id = q.get("corr_id", [None])[0]
            self._send(200, _data(chain.flight_recorder.dump(corr_id)))
        elif parts == ["eth", "v1", "node", "health"]:
            self._send(200, b"")
        elif parts == ["eth", "v1", "node", "version"]:
            self._send(200, _data({"version": "lighthouse-tpu/0.4.0"}))
        elif parts == ["eth", "v1", "node", "syncing"]:
            self._send(
                200,
                _data(
                    {
                        "head_slot": str(chain.head_state().slot),
                        "sync_distance": "0",
                        "is_syncing": False,
                        "is_optimistic": bool(
                            chain.fork_choice.is_optimistic(chain.head_root)
                        ),
                    }
                ),
            )
        elif parts == ["eth", "v1", "node", "identity"]:
            # the subset of the identity payload this stack models (no
            # libp2p peer id; the gossip node id is the logical identity)
            self._send(
                200,
                _data(
                    {
                        "peer_id": getattr(self.api, "node_id", "lighthouse-tpu"),
                        "enr": "",
                        "p2p_addresses": [],
                        "discovery_addresses": [],
                        "metadata": {"seq_number": "1", "attnets": "0x00"},
                    }
                ),
            )
        elif len(parts) == 5 and parts[:4] == ["eth", "v1", "beacon", "pool"]:
            pool = api.op_pool
            kind = parts[4]
            if kind == "attestations":
                atts = [a for bucket in pool.attestations.values() for a in bucket]
                self._send(200, _data([encode(a, type(a)) for a in atts]))
            elif kind == "voluntary_exits":
                self._send(
                    200,
                    _data([encode(e, type(e)) for e in pool.voluntary_exits.values()]),
                )
            elif kind == "proposer_slashings":
                self._send(
                    200,
                    _data([encode(s, type(s)) for s in pool.proposer_slashings.values()]),
                )
            elif kind == "attester_slashings":
                self._send(
                    200, _data([encode(s, type(s)) for s in pool.attester_slashings])
                )
            else:
                raise ApiError(404, "unknown pool resource")
        elif parts == ["eth", "v2", "debug", "beacon", "heads"]:
            # viable fork-choice leaves: EL-refuted forks are NOT heads
            proto = chain.fork_choice.proto
            # an EL-invalid child must not hide its valid parent from the
            # head list (nor appear itself)
            children = {
                n.parent
                for n in proto.nodes
                if n.parent != -1 and n.execution_status != "invalid"
            }
            heads = [
                {"slot": str(n.slot), "root": "0x" + bytes(n.root).hex(),
                 "execution_optimistic": n.execution_status == "optimistic"}
                for i, n in enumerate(proto.nodes)
                if i not in children and n.execution_status != "invalid"
            ]
            self._send(200, _data(heads))
        elif (
            len(parts) == 6
            and parts[:4] == ["eth", "v1", "beacon", "blocks"]
            and parts[5] == "root"
        ):
            root = self._block_root_for(parts[4])
            self._send(200, _data({"root": "0x" + root.hex()}))
        elif parts == ["eth", "v1", "debug", "fork_choice"]:
            # fork-choice dump (the reference's /lighthouse/debug + the v1
            # debug endpoint): one node per proto-array entry
            nodes = [
                {
                    "slot": str(n.slot),
                    "block_root": "0x" + bytes(n.root).hex(),
                    "parent_root": (
                        "0x" + bytes(chain.fork_choice.proto.nodes[n.parent].root).hex()
                        if n.parent != -1
                        else "0x" + "00" * 32  # anchor: zero root (schema: string)
                    ),
                    "weight": str(n.weight),
                    "execution_status": n.execution_status,
                }
                for n in chain.fork_choice.proto.nodes
            ]

            def cp_json(cp):
                return {"epoch": str(cp.epoch), "root": "0x" + bytes(cp.root).hex()}

            self._send(
                200,
                json.dumps(
                    {
                        "justified_checkpoint": cp_json(
                            chain.fork_choice.justified_checkpoint
                        ),
                        "finalized_checkpoint": cp_json(
                            chain.fork_choice.finalized_checkpoint
                        ),
                        "fork_choice_nodes": nodes,
                    }
                ).encode(),
            )
        elif parts == ["eth", "v1", "config", "spec"]:
            from ..networks import dump_config_dict

            pairs = dump_config_dict(ctx.spec)
            pairs["SLOTS_PER_EPOCH"] = str(ctx.preset.slots_per_epoch)
            pairs["PRESET_BASE"] = ctx.preset.name
            self._send(200, _data(pairs))
        elif parts == ["eth", "v1", "beacon", "genesis"]:
            st = chain.store.get_state(chain.genesis_block_root)
            self._send(
                200,
                _data(
                    {
                        "genesis_time": str(st.genesis_time),
                        "genesis_validators_root": "0x"
                        + bytes(st.genesis_validators_root).hex(),
                        "genesis_fork_version": "0x" + bytes(st.fork.current_version).hex(),
                    }
                ),
            )
        elif len(parts) == 6 and parts[:4] == ["eth", "v1", "beacon", "states"]:
            state = self._state_for(parts[4])
            if parts[5] == "finality_checkpoints":
                cp = lambda c: {"epoch": str(c.epoch), "root": "0x" + bytes(c.root).hex()}
                self._send(
                    200,
                    _data(
                        {
                            "previous_justified": cp(state.previous_justified_checkpoint),
                            "current_justified": cp(state.current_justified_checkpoint),
                            "finalized": cp(state.finalized_checkpoint),
                        }
                    ),
                )
            elif parts[5] == "root":
                self._send(
                    200,
                    _data({"root": "0x" + type(state).hash_tree_root(state).hex()}),
                )
            elif parts[5] == "validators":
                # /eth/v1/beacon/states/{id}/validators (optional ?id= filter)
                from ..types import FAR_FUTURE_EPOCH

                wanted = None
                if "id" in q:
                    index_by_pk = {
                        bytes(v.pubkey): i for i, v in enumerate(state.validators)
                    }
                    wanted = set()
                    for item in q["id"]:
                        for tok in item.split(","):
                            tok = tok.strip()
                            if not tok:
                                continue
                            if tok.startswith("0x"):  # pubkey id (spec-legal)
                                try:
                                    raw = bytes.fromhex(tok[2:])
                                except ValueError:
                                    raise ApiError(
                                        400, f"bad validator id {tok!r}"
                                    ) from None
                                idx = index_by_pk.get(raw)
                                if idx is not None:
                                    wanted.add(idx)
                            elif tok.isdigit():
                                wanted.add(int(tok))
                            else:
                                raise ApiError(400, f"bad validator id {tok!r}")
                out = []
                epoch = compute_epoch_at_slot(int(state.slot), ctx.preset)
                for i, v in enumerate(state.validators):
                    if wanted is not None and i not in wanted:
                        continue
                    if v.activation_epoch > epoch:
                        status = "pending_queued"
                    elif epoch < v.exit_epoch:
                        if v.slashed:
                            status = "active_slashed"
                        elif int(v.exit_epoch) != FAR_FUTURE_EPOCH:
                            status = "active_exiting"
                        else:
                            status = "active_ongoing"
                    else:
                        status = "exited_slashed" if v.slashed else "exited_unslashed"
                    out.append(
                        {
                            "index": str(i),
                            "balance": str(int(state.balances[i])),
                            "status": status,
                            "validator": encode(v, type(v)),
                        }
                    )
                self._send(200, _data(out))
            elif parts[5] == "committees":
                # /eth/v1/beacon/states/{id}/committees[?epoch=&slot=&index=]
                from ..state_transition.helpers import (
                    get_beacon_committee,
                    get_committee_count_per_slot,
                )

                state_epoch = compute_epoch_at_slot(int(state.slot), ctx.preset)
                epoch = int(q["epoch"][0]) if "epoch" in q else state_epoch
                # the shuffling is determined for previous/current/next epoch
                # of this state; anything else needs a different state id
                if not state_epoch - 1 <= epoch <= state_epoch + 1:
                    raise ApiError(
                        400, f"epoch {epoch} outside this state's shuffling horizon"
                    )
                spe = ctx.preset.slots_per_epoch
                n = get_committee_count_per_slot(state, epoch, ctx.preset)
                slots = (
                    [int(q["slot"][0])]
                    if "slot" in q
                    else range(epoch * spe, (epoch + 1) * spe)
                )
                indices = [int(q["index"][0])] if "index" in q else range(n)
                out = []
                for slot in slots:
                    if compute_epoch_at_slot(slot, ctx.preset) != epoch:
                        raise ApiError(400, f"slot {slot} is not in epoch {epoch}")
                    for ci in indices:
                        if ci >= n:
                            raise ApiError(400, f"committee index {ci} out of range")
                        committee = get_beacon_committee(
                            state, slot, ci, ctx.preset, ctx.spec
                        )
                        out.append(
                            {
                                "index": str(ci),
                                "slot": str(slot),
                                "validators": [str(v) for v in committee],
                            }
                        )
                self._send(200, _data(out))
            elif parts[5] == "sync_committees":
                if ctx.types.fork_of(state) == "phase0":
                    raise ApiError(400, "state is pre-altair")
                index_of = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
                validators = []
                for pk in state.current_sync_committee.pubkeys:
                    idx = index_of.get(bytes(pk))
                    if idx is None:
                        raise ApiError(
                            500, "sync committee pubkey not in validator registry"
                        )
                    validators.append(str(idx))
                self._send(200, _data({"validators": validators}))
            else:
                raise ApiError(404, "unknown state endpoint")
        elif len(parts) == 5 and parts[:4] == ["eth", "v1", "beacon", "headers"]:
            root = self._block_root_for(parts[4])
            signed = chain.store.get_block(root)
            if signed is None:
                # genesis: rebuild the header with state_root filled so
                # hash_tree_root(header) == the returned root (the same
                # construction BeaconChain.__init__ uses)
                state = chain.store.get_state(chain.genesis_block_root)
                lh = state.latest_block_header
                header = BeaconBlockHeader(
                    slot=lh.slot,
                    proposer_index=lh.proposer_index,
                    parent_root=lh.parent_root,
                    state_root=type(state).hash_tree_root(state),
                    body_root=lh.body_root,
                )
            else:
                b = signed.message
                header = BeaconBlockHeader(
                    slot=b.slot,
                    proposer_index=b.proposer_index,
                    parent_root=b.parent_root,
                    state_root=b.state_root,
                    body_root=type(b.body).hash_tree_root(b.body),
                )
            self._send(
                200,
                _data(
                    {
                        "root": "0x" + root.hex(),
                        "canonical": True,
                        "header": {"message": encode(header, BeaconBlockHeader)},
                    }
                ),
            )
        elif len(parts) == 6 and parts[:5] == ["eth", "v1", "validator", "duties", "proposer"]:
            epoch = int(parts[5])
            duties = api.proposer_duties(epoch)
            state = chain.head_state()
            self._send(
                200,
                _data(
                    [
                        {
                            "pubkey": "0x" + bytes(state.validators[vi].pubkey).hex(),
                            "validator_index": str(vi),
                            "slot": str(slot),
                        }
                        for slot, vi in sorted(duties.items())
                    ]
                ),
            )
        elif parts == ["eth", "v1", "validator", "attestation_data"]:
            slot = int(q["slot"][0])
            ci = int(q["committee_index"][0])
            data = api.attestation_data(slot, ci)
            self._send(200, _data(encode(data, type(data))))
        elif parts == ["eth", "v1", "validator", "aggregate_attestation"]:
            slot = int(q["slot"][0])
            ci = int(q["committee_index"][0])
            agg = api.get_aggregate(slot, ci)
            if agg is None:
                raise ApiError(404, "no aggregate available")
            self._send(200, _data(encode(agg, type(agg))))
        elif parts == ["eth", "v1", "validator", "sync_committee_contribution"]:
            slot = int(q["slot"][0])
            sub = int(q["subcommittee_index"][0])
            root = bytes.fromhex(q["beacon_block_root"][0].removeprefix("0x"))
            contribution = api.produce_sync_contribution(slot, root, sub)
            if contribution is None:
                raise ApiError(404, "no contribution available")
            self._send(200, _data(encode(contribution, type(contribution))))
        elif len(parts) == 5 and parts[:4] == ["eth", "v2", "validator", "blocks"]:
            slot = int(parts[4])
            reveal = bytes.fromhex(q["randao_reveal"][0].removeprefix("0x"))
            block = api.produce_block(slot, reveal)
            self._send(
                200,
                json.dumps(
                    {
                        "version": type(block.body).fork_name,
                        "data": encode(block, type(block)),
                    }
                ).encode(),
            )
        elif len(parts) == 5 and parts[:4] == ["eth", "v2", "beacon", "blocks"]:
            # fork-versioned block envelope (the v2 block endpoint)
            root = self._block_root_for(parts[4])
            signed = self.chain.store.get_block(root)
            if signed is None:
                # genesis has no SignedBeaconBlock to serialize
                raise ApiError(404, "block not found")
            self._send(
                200,
                json.dumps(
                    {
                        "version": type(signed.message.body).fork_name,
                        "data": encode(signed, type(signed)),
                    }
                ).encode(),
            )

        else:
            raise ApiError(404, "unknown endpoint")

    def _serve_events(self, q):
        """SSE stream of chain events (events.rs -> http_api /eth/v1/events).
        `topics` query filters kinds; the stream ends when the client
        disconnects or after `max_events` (testing hook)."""
        import queue as _queue

        # accept both ?topics=a,b and the OpenAPI repeated-key ?topics=a&topics=b
        topics = {t for param in q.get("topics", []) for t in param.split(",")} - {""}
        max_events = int((q.get("max_events") or ["0"])[0])
        sub = self.chain.events.subscribe()
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            sent = 0
            while max_events == 0 or sent < max_events:
                try:
                    ev = sub.get(timeout=10.0)
                except _queue.Empty:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                if topics and ev.kind not in topics:
                    continue
                payload = json.dumps(ev.data)
                self.wfile.write(f"event: {ev.kind}\ndata: {payload}\n\n".encode())
                self.wfile.flush()
                sent += 1
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            self.chain.events.unsubscribe(sub)

    # -- POST --------------------------------------------------------------

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"null")
            parts = [p for p in urlparse(self.path).path.split("/") if p]
            with _CHAIN_LOCK:
                self._route_post(parts, body)
        except ApiError as e:
            self._error(e.status, str(e))
        except (StateTransitionError, BlockError) as e:
            self._error(400, str(e))
        except Exception as e:  # noqa: BLE001
            self._error(500, f"{type(e).__name__}: {e}")

    def _publish_batch(self, body, ssz_type, publish_fn, noun: str) -> None:
        """Shared pool-POST shape: decode each item, publish, report
        per-index failures with a 400 (the Beacon API batch convention)."""
        failures = []
        for i, obj in enumerate(body):
            if not publish_fn(decode(obj, ssz_type)):
                failures.append({"index": i, "message": f"{noun} rejected"})
        if failures:
            self._send(
                400,
                json.dumps(
                    {"code": 400, "message": f"some {noun}s failed", "failures": failures}
                ).encode(),
            )
        else:
            self._send(200, b"{}")

    def _route_post(self, parts, body):
        api, ctx = self.api, self.chain.ctx
        t = ctx.types
        if parts == ["eth", "v1", "beacon", "pool", "attestations"]:
            self._publish_batch(body, t.Attestation, api.publish_attestation, "attestation")
        elif parts == ["eth", "v1", "beacon", "blocks"]:
            slot = int(body["message"]["slot"])
            fork = ctx.spec.fork_name_at_epoch(slot // ctx.preset.slots_per_epoch)
            signed = decode(body, t.for_fork(fork).SignedBeaconBlock)
            root = api.publish_block(signed)
            self._send(200, json.dumps({"data": {"root": "0x" + root.hex()}}).encode())
        elif parts == ["eth", "v1", "beacon", "pool", "sync_committees"]:
            self._publish_batch(
                body, t.SyncCommitteeMessage, api.publish_sync_message, "sync message"
            )
        elif (
            len(parts) == 5
            and parts[:4] == ["eth", "v1", "beacon", "pool"]
            and parts[4] in ("voluntary_exits", "proposer_slashings", "attester_slashings")
        ):
            # single-object op endpoints: validate against a head-state copy
            # before pooling (the reference's verify_operation admission);
            # a StateTransitionError surfaces as do_POST's 400
            from ..state_transition import per_block

            ssz_type, process_fn, insert_fn = {
                "voluntary_exits": (
                    t.SignedVoluntaryExit,
                    per_block.process_voluntary_exit,
                    api.op_pool.insert_voluntary_exit,
                ),
                "proposer_slashings": (
                    t.ProposerSlashing,
                    per_block.process_proposer_slashing,
                    api.op_pool.insert_proposer_slashing,
                ),
                "attester_slashings": (
                    t.AttesterSlashing,
                    per_block.process_attester_slashing,
                    api.op_pool.insert_attester_slashing,
                ),
            }[parts[4]]
            op = decode(body, ssz_type)
            process_fn(self.chain.head_state().copy(), op, ctx, True)
            insert_fn(op)
            self._send(200, b"{}")
        elif parts == ["eth", "v1", "validator", "aggregate_and_proofs"]:
            self._publish_batch(
                body, t.SignedAggregateAndProof, api.publish_aggregate, "aggregate"
            )
        elif parts == ["eth", "v1", "validator", "contribution_and_proofs"]:
            self._publish_batch(
                body, t.SignedContributionAndProof, api.publish_contribution, "contribution"
            )
        elif len(parts) == 6 and parts[:5] == ["eth", "v1", "validator", "duties", "sync"]:
            epoch = int(parts[5])
            state = self.chain.head_state()
            indices = [int(i) for i in body]
            pubkeys = [
                bytes(state.validators[i].pubkey)
                for i in indices
                if i < len(state.validators)
            ]
            # duties for the REQUESTED epoch (period lookahead), not the
            # current slot: the committee serving that epoch's first slot
            duty_slot = epoch * ctx.preset.slots_per_epoch
            duties = api.sync_duties(pubkeys, max(duty_slot, int(state.slot)))
            index_of = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
            self._send(
                200,
                _data(
                    [
                        {
                            "pubkey": "0x" + pk.hex(),
                            "validator_index": str(index_of[pk]),
                            "validator_sync_committee_indices": [str(p) for p in positions],
                        }
                        for pk, positions in sorted(duties.items())
                    ]
                ),
            )
        elif len(parts) == 6 and parts[:5] == ["eth", "v1", "validator", "duties", "attester"]:
            epoch = int(parts[5])
            indices = [int(i) for i in body]
            state = self.chain.head_state()
            pubkeys = [
                bytes(state.validators[i].pubkey) for i in indices if i < len(state.validators)
            ]
            duties = api.attester_duties(epoch, pubkeys)
            self._send(
                200,
                _data(
                    [
                        {
                            "pubkey": "0x"
                            + bytes(state.validators[d.validator_index].pubkey).hex(),
                            "validator_index": str(d.validator_index),
                            "committee_index": str(d.committee_index),
                            "committee_length": str(d.committee_length),
                            "validator_committee_index": str(d.committee_position),
                            "slot": str(d.slot),
                        }
                        for d in duties
                    ]
                ),
            )
        else:
            raise ApiError(404, "unknown endpoint")


class HttpApiServer:
    """Owns the listening socket + serving thread."""

    def __init__(self, api, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"api": api, "chain": api.chain})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "HttpApiServer":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
