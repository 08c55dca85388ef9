"""Native (C) components, loaded via ctypes with graceful fallback.

The in-repo native piece is the batched merkleization hasher (tree_hash.c),
the same source as the JAX package's. It is compiled on first use with the
system C compiler into `build/native/` under the repository root (listed in
.gitignore; the port commits no binary). Import never fails: callers check
`available()` and fall back to hashlib.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "tree_hash.c"
_SO = _DIR.parents[1] / "build" / "native" / "_tree_hash.so"

_lib = None
_tried = False


def _build() -> bool:
    # each process compiles to its own name and renames it into place, so
    # concurrent first uses never load a half-written library
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}")
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["cc", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.lh_hash_pairs.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.lh_hash_pairs.restype = None
    lib.lh_merkleize.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.lh_merkleize.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def hash_pairs(data: bytes) -> bytes:
    """data: concatenated 64-byte pairs -> concatenated 32-byte digests."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hasher unavailable")
    n = len(data) // 64
    out = ctypes.create_string_buffer(n * 32)
    lib.lh_hash_pairs(data, n, out)
    return out.raw


def merkleize(chunks: bytes, n: int, depth: int, zero_hashes: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native hasher unavailable")
    out = ctypes.create_string_buffer(32)
    lib.lh_merkleize(chunks, n, depth, zero_hashes, out)
    return out.raw
