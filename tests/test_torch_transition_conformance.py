"""The port's state-transition conformance cases
(lighthouse_tpu_torch/conformance/transition_cases.py) on the `fake`
backend: every case runs from serialized bytes through the port's runner
and meets its expectation, over phase0, altair and bellatrix. Each case's
pre-state, input and post-state root equal the JAX generator's, and every
post-state root equals the pinned table (conformance/kat_roots.py), which is
the JAX package's entry for entry."""

import pytest

from lighthouse_tpu.conformance.kat_roots import PINNED_POST_ROOTS as JAX_PINNED_POST_ROOTS
from lighthouse_tpu.conformance.transition_cases import generate_transition_cases as jax_generate_transition_cases
from lighthouse_tpu_torch.conformance.kat_roots import PINNED_POST_ROOTS
from lighthouse_tpu_torch.conformance.transition_cases import (
    FORK_MATRIX,
    generate_transition_cases,
    run_transition_case,
)

CASES = generate_transition_cases()
IDS = [f"{c.runner}-{c.fork}-{c.handler}-{c.name}" for c in CASES]


def key(c) -> str:
    return f"{c.runner}/{c.handler}/{c.fork}/{c.name}"


@pytest.fixture(scope="module")
def jax_cases():
    return {key(c): c for c in jax_generate_transition_cases()}


def test_vector_inventory():
    assert len(CASES) == 52
    assert {c.fork for c in CASES} == set(FORK_MATRIX) == {"phase0", "altair", "bellatrix"}
    runners = {(c.runner, c.fork) for c in CASES}
    for fork in FORK_MATRIX:
        assert ("operations", fork) in runners and ("sanity_blocks", fork) in runners
    assert ("sanity_slots", "altair") in runners
    assert any(c.post_root is None for c in CASES) and any(c.post_root is not None for c in CASES)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_transition_case(case):
    run_transition_case(case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_case_matches_the_jax_generator(case, jax_cases):
    jcase = jax_cases[key(case)]
    assert case.pre_ssz == jcase.pre_ssz
    assert case.input_ssz == jcase.input_ssz
    assert case.post_root == jcase.post_root


def test_pinned_kat_roots():
    """Every post-state root equals its pinned value, and the port's table
    is the JAX package's."""
    assert PINNED_POST_ROOTS == JAX_PINNED_POST_ROOTS
    got = {key(c): c.post_root.hex() for c in CASES if c.post_root is not None}
    assert set(got) == set(PINNED_POST_ROOTS), "case set changed; re-pin kat_roots.py deliberately"
    diffs = {k: (got[k], PINNED_POST_ROOTS[k]) for k in got if got[k] != PINNED_POST_ROOTS[k]}
    assert not diffs, f"post-state roots drifted from pinned values: {diffs}"
