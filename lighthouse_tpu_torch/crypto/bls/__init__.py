"""BLS12-381 for the port, with runtime-pluggable backends: the crypto seam.

The counterpart of the JAX package's crypto/bls/__init__.py, over the
port's backends:

    from lighthouse_tpu_torch.crypto.bls import backend
    bls = backend("torch")    # batched verifier on the CUDA card (the product)
    bls = backend("ref")      # pure-Python correctness oracle (milagro role)
    bls = backend("fake")     # always-valid stub        (fake_crypto role)

Each backend module exposes the same surface (the Python rendering of the
reference's `TPublicKey`/`TSignature`/... trait family):

    SecretKey, PublicKey, Signature, SignatureSet, DecodeError,
    aggregate_public_keys, aggregate_signatures,
    verify_signature_set, verify_signature_sets,
    interop_secret_key, interop_keypair

The module-level names below re-export the *default* backend, resolved from
`$LIGHTHOUSE_TPU_BLS_BACKEND` (default: "torch": entry points run on the
card unless the caller asks for the CPU; "ref" and "fake" are that ask).
"""

from __future__ import annotations

import importlib
import os
import types

from .constants import (  # noqa: F401  (public parameter surface)
    DST,
    P,
    PUBLIC_KEY_BYTES_LEN,
    R,
    SECRET_KEY_BYTES_LEN,
    SIGNATURE_BYTES_LEN,
)

_BACKEND_MODULES = {
    "torch": "lighthouse_tpu_torch.crypto.bls.torch_backend.api",
    "ref": "lighthouse_tpu_torch.crypto.bls.ref.api",
    "fake": "lighthouse_tpu_torch.crypto.bls.fake",
}

BACKEND_NAMES = tuple(_BACKEND_MODULES)

# The per-backend API surface every backend module must provide.
_API = (
    "SecretKey",
    "PublicKey",
    "Signature",
    "SignatureSet",
    "DecodeError",
    "aggregate_public_keys",
    "aggregate_signatures",
    "verify_signature_set",
    "verify_signature_sets",
    "interop_secret_key",
    "interop_keypair",
)

_cache: dict[str, types.ModuleType] = {}


def backend(name: str | None = None) -> types.ModuleType:
    """Return the backend module for `name` (or the default backend).

    Raises ValueError for unknown names; import errors propagate so callers
    see the real cause.
    """
    if name is None:
        name = default_backend_name()
    if name not in _BACKEND_MODULES:
        raise ValueError(f"unknown BLS backend {name!r}; expected one of {BACKEND_NAMES}")
    mod = _cache.get(name)
    if mod is None:
        mod = importlib.import_module(_BACKEND_MODULES[name])
        missing = [a for a in _API if not hasattr(mod, a)]
        if missing:
            raise ImportError(f"backend {name!r} is missing API members: {missing}")
        _cache[name] = mod
    return mod


def default_backend_name() -> str:
    return os.environ.get("LIGHTHOUSE_TPU_BLS_BACKEND", "torch")


def __getattr__(attr: str):
    """PEP 562 lazy re-export of the default backend's types.

    Lazy so that a bad `$LIGHTHOUSE_TPU_BLS_BACKEND` (or a backend whose heavy
    deps are unavailable) only fails at the point of use: `backend("ref")`
    stays reachable regardless of the default selection.
    """
    if attr in _API:
        return getattr(backend(), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
