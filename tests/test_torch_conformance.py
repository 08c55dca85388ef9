"""The port's BLS conformance cases (lighthouse_tpu_torch/conformance/
bls_cases.py) run through lighthouse_tpu_torch's API on the CPU: a subset in
tier-1 (the cases decided on the host, and one valid verify through the
device path), all of them in the slow tier. The port's generator is held to
the JAX package's case for case: name, type, input bytes and expected
outcome."""

import pytest

from lighthouse_tpu.conformance.bls_cases import generate_bls_cases as jax_generate_bls_cases
from lighthouse_tpu_torch.conformance.bls_cases import ALL_CASE_TYPES, ERROR, generate_bls_cases, run_case
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi

TIER1 = [
    "sign_basic",
    "sign_zero_privkey",
    "verify_valid",
    "verify_bad_flags_signature",
    "verify_infinity_pubkey",
    "verify_non_subgroup_pubkey",
    "verify_short_signature",
    "aggregate_two",
    "aggregate_empty",
    "aggregate_infinity",
    "aggregate_verify_empty",
    "fast_empty_pubkeys",
    "eth_agg_pk_two",
    "eth_agg_pk_infinity",
    "eth_fast_infinity_no_keys",
]
# the generator's cases per type, 39 in all
CASES_PER_TYPE = {"sign": 3, "verify": 9, "aggregate": 5, "aggregate_verify": 5, "fast_aggregate_verify": 8,
                  "eth_aggregate_pubkeys": 5, "eth_fast_aggregate_verify": 4}
NAMES = [
    "sign_basic", "sign_other_key", "sign_zero_privkey",
    "verify_valid", "verify_wrong_message", "verify_wrong_key", "verify_tampered_signature",
    "verify_bad_flags_signature", "verify_infinity_pubkey", "verify_non_subgroup_pubkey",
    "verify_non_subgroup_signature", "verify_short_signature",
    "aggregate_two", "aggregate_four", "aggregate_single", "aggregate_empty", "aggregate_infinity",
    "aggregate_verify_valid", "aggregate_verify_shuffled_messages", "aggregate_verify_missing_signer",
    "aggregate_verify_empty", "aggregate_verify_infinity_pubkey",
    "fast_valid_two", "fast_valid_four", "fast_extra_pubkey", "fast_wrong_message", "fast_empty_pubkeys",
    "fast_infinity_pubkey_in_list", "fast_tampered_signature", "fast_infinity_signature",
    "eth_agg_pk_two", "eth_agg_pk_single", "eth_agg_pk_empty", "eth_agg_pk_infinity", "eth_agg_pk_non_subgroup",
    "eth_fast_valid", "eth_fast_infinity_no_keys", "eth_fast_nonempty_infinity_sig", "eth_fast_wrong_message",
]


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in generate_bls_cases()}


@pytest.fixture(scope="module")
def jax_cases():
    return {c.name: c for c in jax_generate_bls_cases()}


@pytest.fixture
def port_api(monkeypatch):
    monkeypatch.setattr(tapi, "DEFAULT_DEVICE", "cpu")
    return tapi


@pytest.mark.parametrize("name", TIER1)
def test_conformance_case(cases, port_api, name):
    run_case(cases[name], port_api)


@pytest.mark.slow
def test_all_conformance_cases(cases, port_api):
    for case in cases.values():
        run_case(case, port_api)


def test_generator_inventory(cases, jax_cases):
    """39 cases, in the JAX generator's order, over the seven eth2 types."""
    assert list(cases) == NAMES == list(jax_cases)
    got = {t: sum(c.case_type == t for c in cases.values()) for t in ALL_CASE_TYPES}
    assert got == CASES_PER_TYPE


def _plain(value):
    """A case's input or expectation as plain Python values: bytes, bools,
    lists of bytes, and the error sentinel as a string."""
    if value is ERROR:
        return "<error>"
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    assert isinstance(value, bool), value
    return value


@pytest.mark.parametrize("name", NAMES)
def test_case_matches_the_jax_generator(cases, jax_cases, name):
    case, jcase = cases[name], jax_cases[name]
    assert (case.case_type, case.name) == (jcase.case_type, jcase.name)
    assert _plain(case.input) == _plain(jcase.input)
    assert _plain(case.expected) == _plain(jcase.expected)
