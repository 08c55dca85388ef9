"""Spec-conformance runners.

Counterpart of lighthouse/testing/ef_tests (handler.rs:10): typed test
cases executed identically against every BLS backend — the reference's
3-backend CI matrix (lighthouse/Makefile:98-103). Official
consensus-spec-tests archives are unavailable offline, so the BLS vectors
are generated locally against the pure-Python oracle plus hand-built edge
cases (infinity pubkeys, invalid encodings, non-subgroup points) covering
the same behaviors the official bls runner checks.
"""

from .bls_cases import ALL_CASE_TYPES, BlsCase, generate_bls_cases, run_case
from .transition_cases import (
    TransitionCase,
    generate_transition_cases,
    run_transition_case,
)

__all__ = [
    "ALL_CASE_TYPES",
    "BlsCase",
    "TransitionCase",
    "generate_bls_cases",
    "generate_transition_cases",
    "run_case",
    "run_transition_case",
]
