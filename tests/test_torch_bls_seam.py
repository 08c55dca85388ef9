"""The port's BLS backend seam (lighthouse_tpu_torch.crypto.bls) against the
JAX package's: the JAX seam tests' cases on the port's three backends,
the names the port refuses, the default backend, and `fake.py` giving
the same bytes as the JAX package's `fake.py`.

The "torch" backend runs here on the CPU (the plain versions of its
kernels) through `api.DEFAULT_DEVICE`; a verify at S = 4 takes about
10 s."""

import numpy as np
import pytest

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls.torch_backend import api as tapi

BACKENDS = ["torch", "ref", "fake"]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(tapi, "DEFAULT_DEVICE", "cpu")


@pytest.mark.parametrize("name", ["jax", "blst", ""])
def test_unknown_backend_rejected_naming_the_choices(name):
    with pytest.raises(ValueError, match=r"'torch', 'ref', 'fake'"):
        bls.backend(name)


def test_backend_names_and_modules():
    assert bls.BACKEND_NAMES == ("torch", "ref", "fake")
    assert bls.backend("torch") is tapi
    assert bls.backend("ref").__name__ == "lighthouse_tpu_torch.crypto.bls.ref.api"
    assert bls.backend("fake").__name__ == "lighthouse_tpu_torch.crypto.bls.fake"
    assert bls._API == jbls._API


def test_default_backend_is_torch(monkeypatch):
    monkeypatch.delenv("LIGHTHOUSE_TPU_BLS_BACKEND", raising=False)
    assert bls.default_backend_name() == "torch"
    assert bls.backend() is bls.backend("torch")
    # package-level re-exports point at the default backend
    assert bls.SecretKey is tapi.SecretKey and bls.verify_signature_sets is tapi.verify_signature_sets


@pytest.mark.parametrize("name", ["ref", "fake", "torch"])
def test_environment_variable_selects_the_default(monkeypatch, name):
    monkeypatch.setenv("LIGHTHOUSE_TPU_BLS_BACKEND", name)
    assert bls.default_backend_name() == name
    assert bls.backend() is bls.backend(name)
    assert bls.Signature is bls.backend(name).Signature


def test_bad_environment_variable_fails_at_use_only(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_BLS_BACKEND", "jax")
    with pytest.raises(ValueError):
        bls.backend()
    with pytest.raises(ValueError):
        bls.SecretKey  # noqa: B018
    assert bls.backend("ref").SecretKey is not None
    with pytest.raises(AttributeError):
        bls.not_an_api_member  # noqa: B018


def test_constants_are_the_jax_packages():
    for name in ("DST", "P", "R", "PUBLIC_KEY_BYTES_LEN", "SECRET_KEY_BYTES_LEN", "SIGNATURE_BYTES_LEN"):
        assert getattr(bls, name) == getattr(jbls, name), name


@pytest.mark.parametrize("name", BACKENDS)
def test_api_surface_complete(name):
    mod = bls.backend(name)
    for attr in bls._API:
        assert hasattr(mod, attr), f"{name} missing {attr}"


@pytest.mark.parametrize("name", BACKENDS)
def test_sign_verify_roundtrip(name, on_cpu):
    b = bls.backend(name)
    sk, pk = b.interop_keypair(7)
    msg = bytes(range(32))
    sig = b.Signature.from_bytes(sk.sign(msg).to_bytes())
    pk2 = b.PublicKey.from_bytes(pk.to_bytes())
    assert sig.verify(pk2, msg)


@pytest.mark.parametrize("name", BACKENDS)
def test_signature_set_batch_rules(name, on_cpu):
    b = bls.backend(name)
    sk, pk = b.interop_keypair(0)
    msg = b"\x11" * 32
    s = b.SignatureSet(signature=sk.sign(msg), signing_keys=[pk], message=msg)
    assert b.verify_signature_sets([s])
    # structural rules shared by all backends, including fake
    assert not b.verify_signature_sets([])
    empty_keys = b.SignatureSet(signature=sk.sign(msg), signing_keys=[], message=msg)
    assert not b.verify_signature_sets([empty_keys])


@pytest.mark.parametrize("name", BACKENDS)
def test_interop_keys_byte_identical_across_backends(name):
    b = bls.backend(name)
    r = jbls.backend("ref")
    for idx in (0, 1, 92):
        assert b.interop_secret_key(idx).to_bytes() == r.interop_secret_key(idx).to_bytes()


def test_fake_backend_always_verifies():
    f = bls.backend("fake")
    sk, pk = f.interop_keypair(3)
    sig = f.SecretKey.random().sign(b"\x00" * 32)
    assert sig.verify(pk, b"unrelated message..............00")
    blob = bytes(range(96))
    assert f.Signature.from_bytes(blob).to_bytes() == blob
    with pytest.raises(f.DecodeError):
        f.Signature.from_bytes(b"short")
    with pytest.raises(f.DecodeError):
        f.SecretKey.from_bytes(bytes(32))  # zero secret key rejected


def test_fake_eth_fast_aggregate_infinity_special_case():
    f = bls.backend("fake")
    assert f.Signature.infinity().eth_fast_aggregate_verify([], b"\x00" * 32)
    assert not f.Signature.infinity().fast_aggregate_verify([], b"\x00" * 32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fake_gives_the_jax_packages_bytes(seed):
    """Keys, signatures and aggregates made from a seed: byte-identical to
    the JAX package's fake backend, and so are the verdicts."""
    port, jax_fake = bls.backend("fake"), jbls.backend("fake")
    rng = np.random.default_rng(seed)
    secrets = [rng.integers(1, 256, size=32, dtype=np.uint8).tobytes() for _ in range(5)]
    msgs = [rng.integers(0, 256, size=32, dtype=np.uint8).tobytes() for _ in range(5)]
    out = {}
    for label, b in (("port", port), ("jax", jax_fake)):
        sks = [b.SecretKey.from_bytes(s) for s in secrets]
        pks = [sk.public_key() for sk in sks]
        sigs = [sk.sign(m) for sk, m in zip(sks, msgs)]
        same = [sk.sign(msgs[0]) for sk in sks]
        agg_sig = b.aggregate_signatures(same)
        agg_pk = b.aggregate_public_keys(pks)
        interop = [b.interop_keypair(i) for i in (0, 5, 63)]
        out[label] = (
            [sk.to_bytes() for sk in sks],
            [pk.to_bytes() for pk in pks],
            [s.to_bytes() for s in sigs],
            agg_sig.to_bytes(),
            agg_pk.to_bytes(),
            [(sk.to_bytes(), pk.to_bytes()) for sk, pk in interop],
            agg_sig.fast_aggregate_verify(pks, msgs[0]),
            b.verify_signature_sets([b.SignatureSet(signature=agg_sig, signing_keys=pks, message=msgs[0])]),
        )
    assert out["port"] == out["jax"]
