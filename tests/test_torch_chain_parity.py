"""The port's consensus host against the JAX package's, slot by slot: the
same harness (64 interop validators, minimal preset, 40 slots, every
validator attesting) on the `fake` backend in both packages, phase0 and
altair from epoch 0. The genesis state's SSZ bytes are identical, and
after every slot so are the head root, the head state's root and its
justified and finalized checkpoints; the final head state's bytes too."""

import dataclasses

import pytest

from lighthouse_tpu.chain import BeaconChainHarness as JaxHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.state_transition import TransitionContext as JaxContext
from lighthouse_tpu.types import MINIMAL_SPEC as JAX_MINIMAL_SPEC
from lighthouse_tpu.types.containers import minimal_types as jax_minimal_types
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.state_transition import TransitionContext
from lighthouse_tpu_torch.types import MINIMAL_SPEC
from lighthouse_tpu_torch.types.containers import minimal_types

VALIDATORS = 64
SLOTS = 40


def contexts(fork: str):
    """(JAX context, port context) on `fake`, with altair scheduled at
    epoch 0 for "altair" (as tests/test_altair.py builds it)."""
    jspec, spec = JAX_MINIMAL_SPEC, MINIMAL_SPEC
    if fork == "altair":
        jspec = dataclasses.replace(jspec, altair_fork_epoch=0)
        spec = dataclasses.replace(spec, altair_fork_epoch=0)
    return (JaxContext(jax_minimal_types(), jspec, jbls.backend("fake")),
            TransitionContext(minimal_types(), spec, bls.backend("fake")))


def ssz(state) -> bytes:
    return type(state).serialize(state)


def snapshot(h):
    st = h.chain.head_state()
    cp = lambda c: (int(c.epoch), bytes(c.root))  # noqa: E731
    return (bytes(h.chain.head_root), type(st).hash_tree_root(st), int(st.slot),
            cp(st.current_justified_checkpoint), cp(st.finalized_checkpoint))


def drive(h, slot: int, pending):
    """One slot of `extend_chain`: a block carrying the previous slot's
    attestations, then every committee's attestation to the new head."""
    root, _ = h.add_block_at_slot(slot, attestations=pending)
    return h.attestations_for_slot(h.chain.store.get_state(root), root, slot)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_chain_matches_the_jax_package_slot_by_slot(fork):
    jctx, ctx = contexts(fork)
    jh, h = JaxHarness(VALIDATORS, jctx), BeaconChainHarness(VALIDATORS, ctx)
    jgen = jh.chain.store.get_state(jh.chain.genesis_block_root)
    gen = h.chain.store.get_state(h.chain.genesis_block_root)
    assert ctx.types.fork_of(gen) == fork
    assert ssz(gen) == ssz(jgen)
    assert h.chain.genesis_block_root == jh.chain.genesis_block_root
    jpending, pending = [], []
    for slot in range(1, SLOTS + 1):
        jpending, pending = drive(jh, slot, jpending), drive(h, slot, pending)
        assert snapshot(h) == snapshot(jh), f"slot {slot}"
    assert ssz(h.chain.head_state()) == ssz(jh.chain.head_state())
    assert h.finalized_epoch() >= 2 and h.justified_epoch() >= 3, "too short a chain to compare finality"


def test_harness_extend_chain_matches():
    """The harness's own `extend_chain`, the path `chip_smoke.py [chain]`
    drives: the same head and finality as the JAX package's."""
    jctx, ctx = contexts("phase0")
    jh, h = JaxHarness(VALIDATORS, jctx), BeaconChainHarness(VALIDATORS, ctx)
    assert h.extend_chain(SLOTS) == jh.extend_chain(SLOTS)
    assert (h.finalized_epoch(), h.justified_epoch()) == (jh.finalized_epoch(), jh.justified_epoch())
