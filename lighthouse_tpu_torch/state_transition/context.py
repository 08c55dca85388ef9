"""Transition context: the bundle every processing function needs.

Groups {container types, chain spec, bls backend, pubkey resolver} — the
runtime equivalent of the reference's generic parameters
(`per_block_processing<T: EthSpec>` + the &ChainSpec argument +
the compile-time-selected bls backend).

The default pubkey resolver decompresses validator pubkeys from the state
on first use and memoizes by (index, pubkey-bytes) — the in-process role of
the reference's ValidatorPubkeyCache
(lighthouse/beacon_node/beacon_chain/src/validator_pubkey_cache.rs:12-37).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ..crypto import bls as bls_pkg
from ..types import ChainSpec, MAINNET_SPEC, MINIMAL_SPEC, Preset
from ..types.containers import SpecTypes, mainnet_types, minimal_types


class PubkeyCache:
    """index -> decompressed backend PublicKey, memoized.

    Backends that stage batches on an accelerator (the torch backend) expose
    `precompute_pubkey_limbs`; the cache calls it on every admission so a
    resolved key also carries its packed device limb rows — computed once
    per validator lifetime and GATHERED (not re-derived) by `stage_sets`.
    Staleness is impossible by construction: the cache keys on
    (index, pubkey-bytes), so mutated pubkey bytes miss and decompress a
    fresh point, and the limb rows live on the point object itself."""

    def __init__(self, bls_mod):
        self.bls = bls_mod
        self._cache: dict[tuple[int, bytes], Any] = {}
        self._precompute = getattr(bls_mod, "precompute_pubkey_limbs", None)

    def resolver(self, state) -> Callable[[int], Any]:
        def resolve(index: int):
            if not 0 <= index < len(state.validators):
                return None
            raw = bytes(state.validators[index].pubkey)
            key = (index, raw)
            pk = self._cache.get(key)
            if pk is None:
                try:
                    pk = self.bls.PublicKey.from_bytes(raw)
                except self.bls.DecodeError:
                    return None
                if self._precompute is not None:
                    self._precompute(pk)
                self._cache[key] = pk
            return pk

        return resolve


@dataclass
class TransitionContext:
    types: SpecTypes
    spec: ChainSpec
    bls: Any
    pubkeys: PubkeyCache = None  # type: ignore[assignment]
    # Engine-API seam for bellatrix payload validation (None -> optimistic
    # accept; see state_transition.bellatrix.OptimisticEngine)
    execution_engine: Any = None

    def __post_init__(self):
        if self.pubkeys is None:
            self.pubkeys = PubkeyCache(self.bls)

    @property
    def preset(self) -> Preset:
        return self.types.preset

    @staticmethod
    def minimal(bls_name: str = "torch") -> "TransitionContext":
        return TransitionContext(minimal_types(), MINIMAL_SPEC, bls_pkg.backend(bls_name))

    @staticmethod
    def mainnet(bls_name: str = "torch") -> "TransitionContext":
        return TransitionContext(mainnet_types(), MAINNET_SPEC, bls_pkg.backend(bls_name))
