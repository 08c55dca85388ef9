"""lighthouse_tpu_torch batch verification (torch_backend/api.py).

- `stage_sets` byte-identical to the JAX package's, padding rows included;
- verdicts equal to the ref oracle's for valid, tampered-message,
  wrong-key and non-subgroup batches (S <= 4, K <= 2) and for the
  structural rules, all on the CPU (plain versions of the kernels);
- (slow) the S=4, K=2 pipeline partial and verdict bit-identical to the
  JAX package's jitted `verify_pipeline_local` / final exponentiation,
  whose CPU compile takes about ten minutes.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lighthouse_tpu.crypto.bls.jax_backend import api as japi
from lighthouse_tpu.crypto.bls.jax_backend import pairing as jpair
from lighthouse_tpu.crypto.bls.ref import api as ref
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as tpair
from torch_parity import SPEC, assert_same, base_sets, signature_sets, verdict_batch

@pytest.fixture(scope="module")
def both_sets():
    return list(base_sets(japi)), list(base_sets(tapi))


@pytest.mark.parametrize("rng_kind", ["seeded", "ones"])
def test_stage_sets_byte_identical_to_jax(both_sets, rng_kind):
    jsets, tsets = both_sets
    if rng_kind == "seeded":
        want = japi.stage_sets(jsets, rng=random.Random(42).getrandbits)
        got = tapi.stage_sets(tsets, rng=random.Random(42).getrandbits)
    else:
        want = japi.stage_sets(jsets, rng=japi._ONE_RNG)
        got = tapi.stage_sets(tsets, rng=tapi._ONE_RNG)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert np.array_equal(tapi._pack_staged(got), japi._pack_staged(want))


def test_stage_sets_entropy_draw_differs_only_in_scalars(both_sets):
    jsets, tsets = both_sets
    want, got = japi.stage_sets(jsets), tapi.stage_sets(tsets)
    for g, w in zip(got[:7], want[:7]):
        assert np.array_equal(g, w)
    assert got[7][:3].any(axis=1).all() and not got[7][3:].any()  # nonzero r, padding r = 0


def test_from_jax_staged_repacks_on_device(both_sets):
    jsets, _ = both_sets
    staged = japi.stage_sets(jsets, rng=random.Random(1).getrandbits)
    port = tapi.from_jax_staged(staged, "cpu")
    for p, s in zip(port, staged):
        if s.dtype == bool:
            assert np.array_equal(p.numpy(), s)
        elif s.shape[-1] == 32:
            assert_same(p, s)
        else:
            assert np.array_equal(p.numpy(), s)


@pytest.mark.parametrize("kind", ["valid", "tampered_message"])
def test_verdict_matches_ref(kind):
    want = ref.verify_signature_sets(verdict_batch(ref, kind), rng=random.Random(3).getrandbits)
    got = tapi.verify_signature_sets(verdict_batch(tapi, kind), rng=random.Random(3).getrandbits, device="cpu")
    assert got == want == (kind == "valid")


def test_structural_rules_match_ref(both_sets):
    _, tsets = both_sets
    inf_pk = ref.PublicKey(ref.g1_infinity())
    cases = {
        "empty_batch": [],
        "empty_keys": [tapi.SignatureSet(tsets[0].signature, [], tsets[0].message)],
        "infinity_pubkey": [tapi.SignatureSet(tsets[0].signature, [inf_pk], tsets[0].message)],
    }
    for name, sets in cases.items():
        assert tapi.verify_signature_sets(sets, device="cpu") is False, name
        assert ref.verify_signature_sets(sets) is False, name
    fut = tapi.verify_signature_sets_async([], device="cpu")
    assert fut.result() is False


@pytest.mark.slow
def test_pipeline_bit_identical_to_jax_s4k2():
    """The slice as a whole at S=4, K=2: the same staged batch through the
    JAX pipeline and the port's gives the same Miller partial and verdict."""
    jsets = signature_sets(japi, [((0, 1), 0), ((2, 3), 1), ((4,), 2), ((5, 6), 3)])
    staged = japi.stage_sets(jsets, rng=random.Random(7).getrandbits)

    @jax.jit
    def drive(*a):
        partial, ok = japi.verify_pipeline_local(*a)
        return partial, ok, jpair.final_exponentiation(partial)

    want_partial, want_ok, want_gt = drive(*(jnp.asarray(a) for a in staged))
    partial, ok = tapi.verify_pipeline_local(*tapi.from_jax_staged(staged, "cpu"))
    assert_same(partial, want_partial)
    assert bool(ok) == bool(want_ok)
    assert_same(tpair.final_exponentiation(partial), want_gt)


def test_backend_surface_exists():
    """Every name the JAX package requires of a backend (`_API`), plus the
    admission and staging-cache helpers, exists on the port's api."""
    from lighthouse_tpu.crypto.bls import _API

    names = (*_API, "batch_validate_public_keys", "precompute_pubkey_limbs", "drop_staging_caches")
    missing = [n for n in names if not hasattr(tapi, n)]
    assert not missing, missing


@pytest.mark.parametrize("kind", ["valid", "tampered_message"])
def test_verify_signature_set_matches_fast_aggregate_verify(kind):
    """The port's single-set verify against the ref oracle's
    fast_aggregate_verify of the same set (two signers)."""
    s, rs = verdict_batch(tapi, kind)[1], verdict_batch(ref, kind)[1]
    got = tapi.verify_signature_set(s, device="cpu")
    assert got == rs.signature.fast_aggregate_verify(rs.signing_keys, rs.message) == (kind == "valid")


def test_precomputed_limbs_stage_identically_and_hit_the_cache(monkeypatch):
    from lighthouse_tpu_torch.crypto.bls.torch_backend import pack as tpack

    cold = signature_sets(tapi, SPEC)
    warm = signature_sets(tapi, SPEC)
    tapi.drop_staging_caches(cold + warm)
    want = tapi.stage_sets(cold, rng=random.Random(9).getrandbits)
    for s in warm:
        for pk in s.signing_keys:
            tapi.precompute_pubkey_limbs(pk)
            assert pk.point._limbs is not None
        tpack.precompute_limbs(s.signature.point)
    tpack.precompute_limbs(tapi._pad_generator())

    def no_misses(xs):
        raise AssertionError("a precomputed point was packed again")

    monkeypatch.setattr(tpack, "to_mont_wire_bulk", no_misses)
    got = tapi.stage_sets(warm, rng=random.Random(9).getrandbits)
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    tapi.drop_staging_caches(warm)
    assert not any(hasattr(pk.point, "_limbs") for s in warm for pk in s.signing_keys)
