"""Typed Beacon-API HTTP client with multi-BN fallback for the VC.

The role of lighthouse/common/eth2/src/lib.rs (BeaconNodeHttpClient)
plus lighthouse/validator_client/src/beacon_node_fallback.rs: the
ValidatorClient drives the SAME surface as the in-process `BeaconNodeApi`,
but every call crosses HTTP to a beacon node's http_api server, and several
nodes can back one VC — calls go to the healthiest node first and fall
through on transport errors (CandidateBeaconNode health ordering).

State view: the signing helpers need a full BeaconState (domains, validator
registry), which the VC fetches over the v2 debug state endpoint (SSZ) and
caches by head root — refetched only when the head moves.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from ..http_api.json_codec import decode, encode
from .validator_client import AttesterDuty


class BeaconApiError(Exception):
    pass


class _Candidate:
    """One beacon node URL + health flag (beacon_node_fallback.rs
    CandidateBeaconNode)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = True


class RemoteChainView:
    """`api.chain`-shaped read surface over the Beacon API: the few chain
    reads the VC's signing helpers need (head root, head state, ctx)."""

    def __init__(self, client: "BeaconNodeHttpClient"):
        self._client = client
        self.ctx = client.ctx
        self._state_cache: tuple[bytes, object] | None = None

    @property
    def head_root(self) -> bytes:
        j = self._client._get_json("/eth/v1/beacon/headers/head")
        return bytes.fromhex(j["data"]["root"].removeprefix("0x"))

    def head_state(self):
        root = self.head_root
        if self._state_cache is not None and self._state_cache[0] == root:
            return self._state_cache[1]
        raw = self._client._get_bytes("/eth/v2/debug/beacon/states/head")
        from ..types import decode_beacon_state

        state = decode_beacon_state(raw, self.ctx.types, self.ctx.spec)
        self._state_cache = (root, state)
        return state


class BeaconNodeHttpClient:
    """Drop-in for `BeaconNodeApi`, over HTTP with N-node fallback."""

    def __init__(self, urls: list[str] | str, ctx, timeout: float = 10.0):
        if isinstance(urls, str):
            urls = [urls]
        self.candidates = [_Candidate(u) for u in urls]
        self.ctx = ctx
        self.timeout = timeout
        self.chain = RemoteChainView(self)

    # -- transport with fallback (beacon_node_fallback.rs first_success) ------

    def _request(self, path: str, body=None, raw: bool = False):
        # healthy candidates first, then retry the unhealthy ones (they may
        # have recovered; success flips them back)
        ordered = sorted(self.candidates, key=lambda c: not c.healthy)
        last: Exception | None = None
        for cand in ordered:
            try:
                data = (
                    json.dumps(body).encode() if body is not None else None
                )
                req = urllib.request.Request(
                    cand.url + path,
                    data=data,
                    headers={"Content-Type": "application/json"} if data else {},
                    method="POST" if data is not None else "GET",
                )
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    payload = r.read()
                cand.healthy = True
                return payload if raw else (json.loads(payload) if payload else {})
            except urllib.error.HTTPError as e:
                # the node answered: it is healthy, the request failed
                cand.healthy = True
                detail = e.read()[:200]
                raise BeaconApiError(f"{path}: HTTP {e.code}: {detail!r}") from e
            except OSError as e:  # transport failure: fall through
                cand.healthy = False
                last = e
        raise BeaconApiError(f"all beacon nodes failed for {path}: {last}")

    def _get_json(self, path: str):
        return self._request(path)

    def _get_bytes(self, path: str) -> bytes:
        return self._request(path, raw=True)

    def _post_json(self, path: str, body):
        return self._request(path, body=body)

    # -- BeaconNodeApi surface -------------------------------------------------

    def attester_duties(self, epoch: int, pubkeys: list[bytes]) -> list[AttesterDuty]:
        state = self.chain.head_state()
        index_by_pk = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        indices = [index_by_pk[pk] for pk in pubkeys if pk in index_by_pk]
        j = self._post_json(f"/eth/v1/validator/duties/attester/{epoch}", indices)
        return [
            AttesterDuty(
                validator_index=int(d["validator_index"]),
                slot=int(d["slot"]),
                committee_index=int(d["committee_index"]),
                committee_position=int(d["validator_committee_index"]),
                committee_length=int(d["committee_length"]),
            )
            for d in j["data"]
        ]

    def proposer_duties(self, epoch: int) -> dict[int, int]:
        j = self._get_json(f"/eth/v1/validator/duties/proposer/{epoch}")
        return {int(d["slot"]): int(d["validator_index"]) for d in j["data"]}

    def attestation_data(self, slot: int, committee_index: int):
        j = self._get_json(
            f"/eth/v1/validator/attestation_data?slot={slot}&committee_index={committee_index}"
        )
        return decode(j["data"], self.ctx.types.AttestationData)

    def produce_block(self, slot: int, randao_reveal: bytes):
        j = self._get_json(
            f"/eth/v2/validator/blocks/{slot}?randao_reveal=0x{bytes(randao_reveal).hex()}"
        )
        block_cls = self.ctx.types.for_fork(j["version"]).BeaconBlock
        return decode(j["data"], block_cls)

    def publish_block(self, signed_block) -> bytes:
        body = encode(signed_block, type(signed_block))
        j = self._post_json("/eth/v1/beacon/blocks", body)
        return bytes.fromhex(j["data"]["root"].removeprefix("0x"))

    def publish_attestation(self, attestation) -> bool:
        t = self.ctx.types
        try:
            self._post_json(
                "/eth/v1/beacon/pool/attestations", [encode(attestation, t.Attestation)]
            )
            return True
        except BeaconApiError:
            return False

    def get_aggregate(self, slot: int, committee_index: int):
        try:
            j = self._get_json(
                f"/eth/v1/validator/aggregate_attestation?slot={slot}"
                f"&committee_index={committee_index}"
            )
        except BeaconApiError:
            return None
        return decode(j["data"], self.ctx.types.Attestation)

    def publish_aggregate(self, signed_aggregate) -> bool:
        t = self.ctx.types
        try:
            self._post_json(
                "/eth/v1/validator/aggregate_and_proofs",
                [encode(signed_aggregate, t.SignedAggregateAndProof)],
            )
            return True
        except BeaconApiError:
            return False

    def sync_duties(self, pubkeys: list[bytes], slot: int) -> dict[bytes, list[int]]:
        state = self.chain.head_state()
        index_by_pk = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        indices = [index_by_pk[pk] for pk in pubkeys if pk in index_by_pk]
        epoch = int(slot) // self.ctx.preset.slots_per_epoch
        j = self._post_json(f"/eth/v1/validator/duties/sync/{epoch}", indices)
        return {
            bytes.fromhex(d["pubkey"].removeprefix("0x")): [
                int(p) for p in d["validator_sync_committee_indices"]
            ]
            for d in j["data"]
        }

    def publish_sync_message(self, message) -> bool:
        t = self.ctx.types
        try:
            self._post_json(
                "/eth/v1/beacon/pool/sync_committees",
                [encode(message, t.SyncCommitteeMessage)],
            )
            return True
        except BeaconApiError:
            return False

    def produce_sync_contribution(self, slot: int, block_root: bytes, subcommittee_index: int):
        try:
            j = self._get_json(
                f"/eth/v1/validator/sync_committee_contribution?slot={slot}"
                f"&subcommittee_index={subcommittee_index}"
                f"&beacon_block_root=0x{bytes(block_root).hex()}"
            )
        except BeaconApiError:
            return None
        return decode(j["data"], self.ctx.types.SyncCommitteeContribution)

    def publish_contribution(self, signed) -> bool:
        t = self.ctx.types
        try:
            self._post_json(
                "/eth/v1/validator/contribution_and_proofs",
                [encode(signed, t.SignedContributionAndProof)],
            )
            return True
        except BeaconApiError:
            return False

    def genesis(self) -> dict:
        """/eth/v1/beacon/genesis (string-valued payload)."""
        return self._get_json("/eth/v1/beacon/genesis")["data"]

    def syncing(self) -> dict:
        return self._get_json("/eth/v1/node/syncing")["data"]

    def health(self) -> list[bool]:
        """Per-candidate liveness probe (/eth/v1/node/health)."""
        out = []
        for cand in self.candidates:
            try:
                req = urllib.request.Request(cand.url + "/eth/v1/node/health")
                with urllib.request.urlopen(req, timeout=self.timeout):
                    cand.healthy = True
            except OSError:
                cand.healthy = False
            out.append(cand.healthy)
        return out
