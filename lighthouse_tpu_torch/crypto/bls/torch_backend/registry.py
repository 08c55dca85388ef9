"""The port's kernel registry: the counterpart of the JAX package's
jax_backend/registry.py, without its jaxpr analysis.

One entry for each name the JAX registry holds (38), for SSWU (which the
JAX package does not register) and for the JAX package's three launch
entry points. Each entry holds

    fn          the port function, fn(*example(seed))
    plain       its plain version, PyTorch operations only (on CPU
                tensors); None for a "path" entry, whose parts each have
                their own
    example     seed -> the example inputs at the JAX spec's shapes, CPU
                tensors (and the S, K of a staged batch), made with numpy
    launches    the kernels (`fp.KERNELS` names) that one standalone call
                launches on the card, with their counts; never empty
    verify_path where the function's body runs on the verify path, and
                the kernel that runs it on its own

and one of two kinds:

    "kernel"    one standalone call launches a hand-written kernel of the
                port's own for the function (one, or K11 and K20 for the
                G2 subgroup check); its output is bit-identical to the
                plain version's
    "path"      a composite of several kernels: hash-to-G2, the verify
                program and the launch entry points

Every one of the JAX registry's 38 functions has a kernel of its own:
the entries that name no kernel do not exist. `chip_smoke.py [registry]`
calls every entry once on the card and holds the launches to `launches`,
and a "kernel" entry's output to its plain version;
tests/test_torch_affine_fp6_kernels.py holds the names to the JAX
registry's and the launches to a dispatch as if on the card.
"""

from __future__ import annotations

import functools
import random
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..constants import P
from ..ref.curves import g1_generator, g1_infinity, g2_generator, g2_infinity
from . import api, curve, fp, h2c, pairing, tower
from .curve import FP, FP2, FP2_PLAIN, FP_PLAIN, Proj, from_affine
from .pack import pack_g1_batch, pack_g2_batch

KINDS = ("kernel", "path")
SM_BATCH = 4  # the JAX curve specs' batch (`curve._SM_BATCH`)


@dataclass(frozen=True)
class PortKernel:
    name: str
    jax_def: str  # the JAX function, file:line under lighthouse_tpu/crypto/bls/
    fn: Callable
    plain: Callable | None
    example: Callable
    launches: dict[str, int]
    verify_path: str
    kind: str
    # runs in a torch.distributed group of the caller's (the sharded verify)
    needs_group: bool = False


# -- example inputs ------------------------------------------------------------------


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _fp(rng, *shape) -> torch.Tensor:
    """Canonical words (*shape, 12): random values below p."""
    n = int(np.prod(shape, dtype=np.int64))
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    return torch.from_numpy(fp.ints_to_words(vals)).reshape(*shape, fp.WORDS)


def _fp2(rng, *shape):
    return _fp(rng, *shape, 2)


def _wide(rng, *shape) -> torch.Tensor:
    """Double-width words (*shape, 24): random values below 2 p 2^384, the
    domain of `fp.mont_reduce` (the JAX spec's mult = 2)."""
    n = int(np.prod(shape, dtype=np.int64))
    buf = b"".join((int.from_bytes(rng.bytes(96), "little") % (2 * P << 384)).to_bytes(96, "little")
                   for _ in range(n))
    words = np.frombuffer(buf, dtype="<u4").view(np.int32).copy()
    return torch.from_numpy(words).reshape(*shape, fp.WIDE)


@functools.lru_cache(maxsize=None)
def _points(group: str, n: int, seed: int):
    """n affine points of G1 or G2 as (x, y, inf) CPU tensors in words,
    seeded multiples of the generator, the last one infinity."""
    gen, inf, pack = {"g1": (g1_generator, g1_infinity, pack_g1_batch),
                      "g2": (g2_generator, g2_infinity, pack_g2_batch)}[group]
    rng = random.Random(seed)
    pts = [gen().mul(rng.getrandbits(64) | 1) for _ in range(n - 1)] + [inf()]
    x, y, i = pack(pts)
    return fp.from_jax_limbs(x), fp.from_jax_limbs(y), torch.from_numpy(i)


def _affine(group: str, seed: int, batch: int | None = SM_BATCH):
    """(x, y, inf) of `batch` points, or of one point (batch None: the JAX
    add spec's unbatched coordinates, a finite point)."""
    x, y, i = _points(group, SM_BATCH, seed)
    if batch is None:
        return x[0], y[0], i[0]
    return x[:batch], y[:batch], i[:batch]


def _bits(rng, n: int, width: int) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 2, (n, width), dtype=np.int32))


@functools.lru_cache(maxsize=None)
def _staged(S: int, K: int, seed: int):
    """A staged batch of S sets of K interop keys each (one set, tiled) as
    (flat int32 CPU tensor, S, K). The signature is a seeded G2 point, not
    the keys' signature: the batch runs every kernel of the path and does
    not verify, and no secret-key signing runs on the host. `stage_sets`
    pads the key axis to at least 4; below that the padding (infinity
    keys) is cut off again, as the JAX spec's K = 2 batch has none."""
    keys = [api.interop_keypair(i)[1] for i in range(K)]
    sig = api.Signature(g2_generator().mul(random.Random(seed).getrandbits(64) | 1))
    msg = bytes([seed & 0xFF]) * 32
    sets = [api.SignatureSet(signature=sig, signing_keys=keys, message=msg)] * S
    staged = list(api.stage_sets(sets, rng=random.Random(seed).getrandbits))
    staged[:3] = [a[:, :K] for a in staged[:3]]
    assert staged[2].shape == (S, K), staged[2].shape
    return torch.from_numpy(api._pack_staged(staged)), S, K


def _staged_words(S: int, K: int, seed: int):
    flat, S, K = _staged(S, K, seed)
    return api._to_words(api._unpack_staged(flat, S, K))


def to_device(args, device):
    """The example's tensors on `device` (ints and other values as they are)."""
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


# -- the entries ---------------------------------------------------------------------

_ENTRIES: dict[str, PortKernel] = {}


def _reg(name, jax_def, fn, plain, example, launches, verify_path, kind, **kw):
    if name in _ENTRIES:
        raise ValueError(f"duplicate registry entry {name!r}")
    if kind not in KINDS or not launches or (plain is None) != (kind == "path"):
        raise ValueError(f"registry entry {name!r}: kind {kind!r}, launches {launches}, plain {plain}")
    _ENTRIES[name] = PortKernel(name, jax_def, fn, plain, example, launches, verify_path, kind, **kw)


_PLAIN = fp.PLAIN_OPS
_INSIDE_ALL = "inside K10-K21 (fp384.cuh)"

# Fp
_reg("fp.add", "jax_backend/fp.py:294", fp.add, _PLAIN.add, lambda s: (_fp(_rng(s)), _fp(_rng(s + 1))),
     {"fp_addsub": 1}, _INSIDE_ALL, "kernel")
_reg("fp.sub", "jax_backend/fp.py:299", fp.sub, _PLAIN.sub, lambda s: (_fp(_rng(s)), _fp(_rng(s + 1))),
     {"fp_addsub": 1}, _INSIDE_ALL, "kernel")
_reg("fp.neg", "jax_backend/fp.py:304", fp.neg, _PLAIN.neg, lambda s: (_fp(_rng(s)),),
     {"fp_addsub": 1}, _INSIDE_ALL, "kernel")
_reg("fp.mul", "jax_backend/fp.py:310", fp.mul, fp.mul_plain, lambda s: (_fp(_rng(s)), _fp(_rng(s + 1))),
     {"fp_mul": 1}, _INSIDE_ALL, "kernel")
_reg("fp.mul_mxu", "jax_backend/fp.py:373", fp.mul_mxu, fp.mul_mxu_plain,
     lambda s: (_fp(_rng(s)), _fp(_rng(s + 1))), {"fp_mul_mma": 1},
     "not on the verify path (the flag reaches no product of a verify)", "kernel")
_reg("fp.mul_mxu@B64", "jax_backend/fp.py:373", fp.mul_mxu, fp.mul_mxu_plain,
     lambda s: (_fp(_rng(s), 64), _fp(_rng(s + 1), 64)), {"fp_mul_mma": 1},
     "not on the verify path (the flag reaches no product of a verify)", "kernel")
_reg("fp.mont_reduce", "jax_backend/fp.py:261", fp.mont_reduce, fp.mont_reduce_plain, lambda s: (_wide(_rng(s)),),
     {"fp_redc": 1}, "inside K1 (fp_mul) and every kernel's lazy sums (fp_redc_wide); standalone K33", "kernel")
_reg("fp.inv", "jax_backend/fp.py:460", fp.inv, _PLAIN.inv, lambda s: (_fp(_rng(s)),),
     {"fp_pow": 1}, "inside K9, K13, K14, K19, K21 (fp_inv)", "kernel")
_reg("fp.batch_inv", "jax_backend/fp.py:466", fp.batch_inv, fp.batch_inv_plain, lambda s: (_fp(_rng(s), 4),),
     {"fp_batch_inv": 1}, "inside K21 (its product tree replaced it)", "kernel")

# tower
_F2_INSIDE = "inside K11-K14 and K16-K21 (g2.cuh, tower.cuh)"
_reg("tower.fp2_mul", "jax_backend/tower.py:61", tower.fp2_mul, tower.fp2_mul_plain,
     lambda s: (_fp2(_rng(s)), _fp2(_rng(s + 1))), {"fp2_mul": 1}, _F2_INSIDE, "kernel")
_reg("tower.fp2_sqr", "jax_backend/tower.py:77", tower.fp2_sqr, tower.fp2_sqr_plain,
     lambda s: (_fp2(_rng(s)),), {"fp2_mul": 1}, _F2_INSIDE, "kernel")
_reg("tower.fp2_inv", "jax_backend/tower.py:100", tower.fp2_inv, tower.fp2_inv_plain,
     lambda s: (_fp2(_rng(s)),), {"fp2_inv": 1}, "inside K13, K14, K19 (g2.cuh fp2_inv); standalone K25", "kernel")
_reg("tower.fp6_mul", "jax_backend/tower.py:155", tower.fp6_mul, tower.fp6_mul_plain,
     lambda s: (_fp(_rng(s), 3, 2), _fp(_rng(s + 1), 3, 2)), {"fp6_mul": 1},
     "not on the verify path; standalone K24", "kernel")
_F12_INSIDE = "inside K9, K18, K19 (tower.cuh fp12_mul_pairs) and K12 (fp12_mul_lane)"
_reg("tower.fp12_mul", "jax_backend/tower.py:292", tower.fp12_mul,
     lambda a, b: tower.fp12_product_plain(a, (b,), tower.FP12_FULL),
     lambda s: (_fp(_rng(s), 2, 3, 2), _fp(_rng(s + 1), 2, 3, 2)), {"fp12_mul": 1}, _F12_INSIDE, "kernel")
_reg("tower.fp12_sqr", "jax_backend/tower.py:352", tower.fp12_sqr,
     lambda a: tower.fp12_product_plain(a, (), tower.FP12_SQUARE),
     lambda s: (_fp(_rng(s), 2, 3, 2),), {"fp12_mul": 1}, _F12_INSIDE, "kernel")
_reg("tower.fp12_mul_sparse035", "jax_backend/tower.py:342", tower.fp12_mul_sparse035,
     lambda a, b0, b3, b5: tower.fp12_product_plain(a, (b0, b3, b5), tower.FP12_SPARSE),
     lambda s: (_fp(_rng(s), 2, 3, 2), *(_fp2(_rng(s + k)) for k in (1, 2, 3))), {"fp12_mul": 1}, _F12_INSIDE,
     "kernel")
_reg("tower.fp12_inv", "jax_backend/tower.py:546", tower.fp12_inv, tower.fp12_inv_plain,
     lambda s: (_fp(_rng(s), 2, 3, 2),), {"fp12_inv": 1}, "inside K19 (fp12_inv_block); standalone K30", "kernel")
_reg("tower.karabina_sqr", "jax_backend/tower.py:401", tower.karabina_sqr, tower.karabina_sqr_plain,
     lambda s: (_fp2(_rng(s), 4),), {"karabina_sqr": 1}, "inside K9 and K19; standalone K28", "kernel")
_reg("tower.karabina_decompress", "jax_backend/tower.py:481", tower.karabina_decompress,
     tower.karabina_decompress_plain, lambda s: (_fp2(_rng(s), 4),), {"karabina_decompress": 1},
     "inside K9 and K19; standalone K29", "kernel")

# curve


def _add_fn(F):
    def fn(x, y, inf, qx, qy, qinf):
        return curve.add(F, from_affine(F, x, y, inf), from_affine(F, qx, qy, qinf))

    return fn


def _add_example(group):
    return lambda s: (*_affine(group, s, None), *_affine(group, s + 1, None))


_reg("curve.add.g1", "jax_backend/curve.py:138", _add_fn(FP), _add_fn(FP_PLAIN), _add_example("g1"),
     {"g1_add": 1}, "inside K15 (and the group law of K5, K10); standalone K26", "kernel")
_reg("curve.add.g2", "jax_backend/curve.py:138", _add_fn(FP2), _add_fn(FP2_PLAIN), _add_example("g2"),
     {"g2_add": 1}, "inside K16 and K11, and on lane groups in K17; standalone K27", "kernel")


def _smul_fn(F):
    def fn(x, y, inf, bits):
        return curve.scalar_mul_bits(F, from_affine(F, x, y, inf), bits)

    return fn


def _smul_example(group):
    return lambda s: (*_affine(group, s), _bits(_rng(s), SM_BATCH, 64))


_reg("curve.scalar_mul_bits.g1", "jax_backend/curve.py:282", _smul_fn(FP), _smul_fn(FP_PLAIN), _smul_example("g1"),
     {"g1_scalar_mul": 1}, "standalone K10", "kernel")
_reg("curve.scalar_mul_bits.g2", "jax_backend/curve.py:282", _smul_fn(FP2), _smul_fn(FP2_PLAIN),
     _smul_example("g2"), {"g2_scalar_mul": 1}, "standalone K11", "kernel")


def _affine_fn(F):
    def fn(x, y, inf):
        return curve.to_affine(F, from_affine(F, x, y, inf))

    return fn


_reg("curve.to_affine.g1", "jax_backend/curve.py:120", _affine_fn(FP), _affine_fn(FP_PLAIN),
     lambda s: _affine("g1", s), {"g1_to_affine": 1}, "not on the verify path; standalone K22", "kernel")
_reg("curve.to_affine.g2", "jax_backend/curve.py:120", _affine_fn(FP2), _affine_fn(FP2_PLAIN),
     lambda s: _affine("g2", s), {"g2_to_affine": 1}, "not on the verify path; standalone K23", "kernel")
# K5 reports infinity False, the JAX function True
_reg("curve.g1_in_subgroup", "jax_backend/curve.py:438",
     lambda x, y, inf: curve.g1_in_subgroup_kernel(x, y, inf) | inf,
     lambda x, y, inf: curve.g1_subgroup_check_plain(x, y, inf) | inf,
     lambda s: _affine("g1", s), {"g1_subgroup_check": 1}, "admission: standalone K5", "kernel")


def _g2_in_subgroup_plain(x, y, inf):
    p = from_affine(FP2_PLAIN, x, y, inf)
    return curve.g2_psi_check_plain(p, curve.scalar_mul_bits_plain(FP2_PLAIN, p, curve._ABS_X_BITS))


_reg("curve.g2_in_subgroup", "jax_backend/curve.py:389",
     lambda x, y, inf: curve.g2_in_subgroup(from_affine(FP2, x, y, inf)), _g2_in_subgroup_plain,
     lambda s: _affine("g2", s), {"g2_scalar_mul": 1, "g2_psi_check": 1}, "standalone K11 then K20", "kernel")

# pairing
_reg("pairing.pow_abs_x", "jax_backend/pairing.py:239", pairing.pow_abs_x, pairing.pow_abs_x_plain,
     lambda s: (_fp(_rng(s), 2, 3, 2),), {"cyclotomic_pow_x": 1}, "inside K19 (final_exp.cuh); standalone K9",
     "kernel")
_reg("pairing.frobenius", "jax_backend/pairing.py:210", pairing.frobenius, pairing.frobenius_plain,
     lambda s: (_fp(_rng(s), 2, 3, 2),), {"frobenius": 1}, "inside K19 (frobenius_block); standalone K31", "kernel")
_reg("pairing.product_reduce", "jax_backend/pairing.py:282", pairing.product_reduce, pairing.product_reduce_plain,
     lambda s: (_fp(_rng(s), 5, 2, 3, 2),), {"product_reduce": 1}, "standalone K18", "kernel")
_reg("pairing.miller_loop", "jax_backend/pairing.py:163", pairing.miller_loop, pairing.miller_loop_plain,
     lambda s: (*_points("g1", 5, s), *_points("g2", 5, s + 1)), {"miller_loop": 1}, "standalone K12", "kernel")
_reg("pairing.final_exponentiation", "jax_backend/pairing.py:263", pairing.final_exponentiation,
     pairing.final_exponentiation_plain, lambda s: (_fp(_rng(s), 2, 3, 2),), {"final_exponentiation": 1},
     "standalone K19", "kernel")

# hash-to-G2
_reg("h2c.fp2_sqrt_candidate", "jax_backend/h2c.py:102", h2c.fp2_sqrt_candidate, h2c.fp2_sqrt_candidate_plain,
     lambda s: (_fp2(_rng(s)),), {"fp2_sqrt_candidate": 1}, "inside K13 (sqrt_candidate); standalone K32", "kernel")
_reg("h2c.sswu", "jax_backend/h2c.py:117", h2c.sswu, h2c.sswu_plain, lambda s: (_fp2(_rng(s)),), {"sswu": 1},
     "standalone K13", "kernel")
_reg("h2c.iso3_map", "jax_backend/h2c.py:146", h2c.iso3_map, h2c.iso3_map_plain,
     lambda s: (_fp2(_rng(s)), _fp2(_rng(s + 1))), {"iso3_map": 1}, "standalone K14", "kernel")
_reg("h2c.clear_cofactor", "jax_backend/h2c.py:189", lambda x, y, z: h2c.clear_cofactor(Proj(x, y, z)),
     lambda x, y, z: h2c.clear_cofactor_plain(Proj(x, y, z)),
     lambda s: tuple(_fp2(_rng(s + k), 4) for k in range(3)), {"clear_cofactor": 1}, "standalone K17", "kernel")
_reg("h2c.hash_to_g2_device", "jax_backend/h2c.py:311", h2c.hash_to_g2_device, None,
     lambda s: (_fp(_rng(s), 4, 2, 2),), {"sswu": 1, "iso3_map": 1, "clear_cofactor": 1}, "K13, K14, K17 once each",
     "path")

# the verify program and the launch entry points
_PIPELINE = {k: 1 for k in ("g1_scalar_mul", "g2_scalar_mul", "miller_loop", "sswu", "iso3_map", "g1_tree_sum",
                            "g2_tree_sum", "clear_cofactor", "product_reduce", "g2_psi_check", "miller_inputs")}
_VERIFY = {**_PIPELINE, "final_exponentiation": 1}
for S, K in ((4, 4), (8, 2)):
    _reg(f"api.verify_pipeline_local@S{S}K{K}", "jax_backend/api.py:240", api.verify_pipeline_local, None,
         lambda s, S=S, K=K: _staged_words(S, K, s), _PIPELINE,
         "the verify without its final exponentiation: K10-K18, K20, K21 once each", "path")
_reg("launch api._verify_kernel", "jax_backend/api.py:367", api.verify_staged, None, lambda s: _staged(4, 1, s),
     _VERIFY, "the verify: K10-K21 once each", "path")
_reg("launch api._pk_validate_kernel", "jax_backend/api.py:599", api.validate_staged_g1,
     curve.g1_subgroup_check_plain, lambda s: _affine("g1", s), {"g1_subgroup_check": 1}, "admission: K5",
     "kernel")


def _sharded_verify(flat, S, K):
    """`build_sharded_verify` over the caller's default group, this rank's
    device the staged buffer's."""
    from ....parallel import sharded

    return sharded.build_sharded_verify(device=flat.device)(flat, S, K)


_reg("launch parallel.build_sharded_verify", "parallel/sharded.py:43", _sharded_verify, None,
     lambda s: _staged(4, 1, s), {**_VERIFY, "product_reduce": 2},
     "the sharded verify: K10-K21 on every rank, K18 twice", "path", needs_group=True)


def entries() -> list[PortKernel]:
    """Every entry, in registration order."""
    return list(_ENTRIES.values())


def names() -> list[str]:
    return sorted(_ENTRIES)


def entry(name: str) -> PortKernel:
    return _ENTRIES[name]
