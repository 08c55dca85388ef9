"""Block import with real signatures, the port against the JAX package:
phase0, minimal preset, 8 interop validators, 4 slots. The blocks are
signed once, by the JAX package's harness on `ref`. Their SSZ bytes
decode into the port's types and encode back byte for byte; the port's
`BlockSignatureVerifier` gathers the JAX one's sets in the same order
(public key bytes, message, signature bytes); the port's chain on `ref`
imports them block by block and as one segment to the JAX head; and a
segment whose last block carries an attestation with another block's
aggregate signature (the block made again and signed by its proposer,
so that only that aggregate is wrong) is refused by both packages with
the head unchanged. `@slow`: the same imports on the "torch" backend on
the CPU, the plain versions of the kernels."""

import pytest

from lighthouse_tpu.chain import BeaconChain as JaxChain
from lighthouse_tpu.chain import BeaconChainHarness as JaxHarness
from lighthouse_tpu.chain import BlockError as JaxBlockError
from lighthouse_tpu.chain import ManualSlotClock as JaxClock
from lighthouse_tpu.state_transition import BlockSignatureStrategy as JaxStrategy
from lighthouse_tpu.state_transition import TransitionContext as JaxContext
from lighthouse_tpu.state_transition import per_block_processing as jax_per_block
from lighthouse_tpu.state_transition import process_slots as jax_process_slots
from lighthouse_tpu.state_transition.per_block import BlockSignatureVerifier as JaxVerifier
from lighthouse_tpu_torch.chain import BeaconChain, BlockError, ManualSlotClock
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.state_transition import (
    BlockSignatureStrategy,
    TransitionContext,
    per_block_processing,
    process_slots,
)
from lighthouse_tpu_torch.state_transition.per_block import BlockSignatureVerifier

VALIDATORS = 8
SLOTS = 4


def chain_blocks(chain):
    """The chain's blocks from slot 1 to its head, oldest first."""
    blocks, root = [], chain.head_root
    while root != chain.genesis_block_root:
        blocks.append(chain.store.get_block(root))
        root = bytes(blocks[-1].message.parent_root)
    return blocks[::-1]


@pytest.fixture(scope="module")
def signed():
    """The JAX harness's chain on `ref`, its blocks, their SSZ bytes, and
    the tampered last block (JAX objects and bytes)."""
    jh = JaxHarness(VALIDATORS, JaxContext.minimal("ref"))
    jh.extend_chain(SLOTS)
    jchain = jh.chain
    blocks = chain_blocks(jchain)
    assert [int(b.message.slot) for b in blocks] == list(range(1, SLOTS + 1))
    assert all(len(b.message.body.attestations) == 1 for b in blocks[1:])
    last, prev = blocks[-1].message, blocks[-2].message
    att = last.body.attestations[0]
    assert bytes(att.signature) != bytes(prev.body.attestations[0].signature)
    forged = jh.ctx.types.Attestation(aggregation_bits=list(att.aggregation_bits), data=att.data,
                                      signature=bytes(prev.body.attestations[0].signature))
    parent = jchain.store.get_state(bytes(last.parent_root)).copy()
    block, _ = jchain.produce_block_on_state(parent, int(last.slot), bytes(last.body.randao_reveal),
                                             attestations=[forged], graffiti=bytes(last.body.graffiti))
    tampered = jchain.sign_block(block, jh.keypairs[int(last.proposer_index)][0])
    return {
        "harness": jh,
        "blocks": blocks,
        "raw": [type(b).serialize(b) for b in blocks],
        "tampered": tampered,
        "tampered_raw": type(tampered).serialize(tampered),
    }


def port_chain(signed, bls_name: str) -> BeaconChain:
    """A fresh port chain on the JAX genesis state's bytes."""
    ctx = TransitionContext.minimal(bls_name)
    jgen = signed["harness"].chain.store.get_state(signed["harness"].chain.genesis_block_root)
    gen = ctx.types.BeaconState.deserialize(type(jgen).serialize(jgen))
    chain = BeaconChain(gen, ctx, slot_clock=ManualSlotClock())
    chain.slot_clock.set_slot(SLOTS)
    return chain


def decode(chain, raw: bytes):
    return chain.ctx.types.SignedBeaconBlock.deserialize(raw)


def test_blocks_round_trip_through_the_port_types(signed):
    t = TransitionContext.minimal("ref").types
    for raw, jblock in zip(signed["raw"], signed["blocks"]):
        block = t.SignedBeaconBlock.deserialize(raw)
        assert t.SignedBeaconBlock.serialize(block) == raw
        assert type(block.message).hash_tree_root(block.message) == type(jblock.message).hash_tree_root(
            jblock.message)


def test_signature_sets_equal_the_jax_ones_in_order(signed):
    jctx = signed["harness"].ctx
    ctx = TransitionContext.minimal("ref")
    jgen = signed["harness"].chain.store.get_state(signed["harness"].chain.genesis_block_root)
    jstate = jgen.copy()
    state = ctx.types.BeaconState.deserialize(type(jgen).serialize(jgen))
    for raw, jblock in zip(signed["raw"], signed["blocks"]):
        block = ctx.types.SignedBeaconBlock.deserialize(raw)
        slot = int(block.message.slot)
        jax_process_slots(jstate, slot, jctx)
        process_slots(state, slot, ctx)
        jv, v = JaxVerifier(jstate, jctx), BlockSignatureVerifier(state, ctx)
        jv.include_all_signatures(jblock)
        v.include_all_signatures(block)
        sets = lambda vv: [([pk.to_bytes() for pk in s.signing_keys], bytes(s.message),  # noqa: E731
                            s.signature.to_bytes()) for s in vv.sets]
        assert len(v.sets) == (2 if slot == 1 else 3)
        assert sets(v) == sets(jv), f"slot {slot}"
        # advance both states through the block (signatures checked above)
        jax_per_block(jstate, jblock, jctx, strategy=JaxStrategy.NO_VERIFICATION)
        per_block_processing(state, block, ctx, strategy=BlockSignatureStrategy.NO_VERIFICATION)
        assert type(state).hash_tree_root(state) == bytes(block.message.state_root)


def import_and_refuse(signed, bls_name: str):
    """The port's chain on `bls_name`: block by block, then a fresh chain by
    segments (two blocks, then the tampered rest, refused, then the
    genuine rest), each reaching the JAX head."""
    jhead = signed["harness"].chain.head_root
    chain = port_chain(signed, bls_name)
    for raw in signed["raw"]:
        chain.process_block(decode(chain, raw))
    assert chain.head_root == jhead

    chain = port_chain(signed, bls_name)
    first = chain.process_chain_segment([decode(chain, r) for r in signed["raw"][:2]])
    head = chain.head_root
    assert head == first[-1]
    bad = [decode(chain, r) for r in signed["raw"][2:-1]] + [decode(chain, signed["tampered_raw"])]
    with pytest.raises(BlockError, match="signature"):
        chain.process_chain_segment(bad)
    assert chain.head_root == head
    assert all(chain.store.get_block(type(b.message).hash_tree_root(b.message)) is None for b in bad)
    chain.process_chain_segment([decode(chain, r) for r in signed["raw"][2:]])
    assert chain.head_root == jhead


def test_port_chain_on_ref_imports_to_the_jax_head_and_refuses_the_tampered_segment(signed):
    import_and_refuse(signed, "ref")


def test_jax_chain_refuses_the_tampered_segment(signed):
    jh = signed["harness"]
    jgen = jh.chain.store.get_state(jh.chain.genesis_block_root)
    chain = JaxChain(jgen.copy(), jh.ctx, slot_clock=JaxClock())
    chain.slot_clock.set_slot(SLOTS)
    chain.process_chain_segment(signed["blocks"][:2])
    head = chain.head_root
    with pytest.raises(JaxBlockError, match="signature"):
        chain.process_chain_segment(signed["blocks"][2:-1] + [signed["tampered"]])
    assert chain.head_root == head
    chain.process_chain_segment(signed["blocks"][2:])
    assert chain.head_root == jh.chain.head_root


def test_tampered_block_differs_only_in_the_aggregate(signed):
    """The tampered block is self-consistent: its state root is that of
    its own body, and its proposal signature verifies on `ref`; only the
    attestation's signature is another block's."""
    ctx = TransitionContext.minimal("ref")
    chain = port_chain(signed, "ref")
    chain.process_chain_segment([decode(chain, r) for r in signed["raw"][:-1]])
    tampered = decode(chain, signed["tampered_raw"])
    state = chain.state_at_slot(int(tampered.message.slot))
    v = BlockSignatureVerifier(state, ctx)
    v.include_all_signatures(tampered)
    verdicts = [ctx.bls.verify_signature_sets([s]) for s in v.sets]
    assert verdicts == [True, True, False]


@pytest.mark.slow
def test_port_chain_on_torch_cpu_imports_to_the_jax_head(signed, monkeypatch):
    monkeypatch.setattr(tapi, "DEFAULT_DEVICE", "cpu")
    import_and_refuse(signed, "torch")
