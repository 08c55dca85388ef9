"""The torch BLS backend: batched signature-set verification and pubkey
admission on a CUDA device.

The verification workload runs as one plain PyTorch function per batch over
the hand-written kernels (the field's K1-K4, the tower's K7 and K8, the
|z|-power chain K9, the scalar multiplications K10 and K11, the Miller
loop K12, hash-to-G2's K13, K14 and K17, the tree sums K15 and K16 and
the Miller values' product K18):

    host:   expand_message_xmd (SHA-256), point decompression (no subgroup
            check: deferred to the device), RLC scalar sampling, packing
    device: SSWU / isogeny / cofactor hash-to-G2; psi-criterion subgroup
            checks of every signature; r_i * aggpk_i and r_i * sig_i
            windowed multiplications; S + 1 Miller loops; one final
            exponentiation

Pubkey admission (`batch_validate_public_keys`) decompresses on the host
and runs the G1 subgroup check of the whole batch as one kernel launch (K5).

Semantics match the JAX package (lighthouse_tpu jax_backend/api.py) and the
ref oracle: independent nonzero 64-bit scalars per set, empty batch and
empty signing_keys fail, infinity public keys are rejected, signatures are
subgroup-checked.

Staging keeps the JAX package's wire layout (Montgomery 12-bit limbs, the
8 arrays of `_staged_specs`), so staged bytes compare directly between the
two packages; the batch crosses to the device as one int32 buffer and is
repacked into 32-bit words there (`from_jax_staged`).

Device: every entry point runs on `DEFAULT_DEVICE` ("cuda") unless given
`device=`. Without a GPU a call that does not ask for the CPU raises; it
never falls back to the CPU.

Host dispatch is the JAX package's: `verify_signature_sets` records the
`lighthouse_tpu_bls_*` metrics and the `bls_batch_verify` /
`bls_device_execute` spans (staging: `bls_stage`) and marks the device busy
for the coalescer (`batch_verifier.py`), and single-set verifies ride the
coalescer's shared batches when one is running over this module.
"""

from __future__ import annotations

import secrets
import sys
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ....common.metrics import (
    BLS_BATCH_PADDED_SIZE,
    BLS_BATCH_SECONDS,
    BLS_SETS_TOTAL,
    BLS_STAGE_SECONDS,
    DEVICE_PROVENANCE_INFO,
)
from ....common.tracing import span
from .. import batch_verifier
from ..ref import api as _ref
from ..ref.curves import Point, g1_infinity, g2_infinity
from . import fp, h2c, pairing
from .curve import FP, FP2, Proj, eq_points, from_affine, g1_in_subgroup_kernel, is_infinity, psi
from .curve import neg as p_neg, scalar_mul_bits, stack2, tree_sum, unstack
from .pack import G1_GEN_NEG_Y_L, G1_GEN_X_L, pack_g1_batch, pack_g2_batch, precompute_limbs
from .tower import fp2_mul, fp12_is_one

DecodeError = _ref.DecodeError
PublicKey = _ref.PublicKey
RAND_BITS = _ref.RAND_BITS
aggregate_public_keys = _ref.aggregate_public_keys

#: where entry points run when not given `device=`
DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """`device`, else DEFAULT_DEVICE; a CUDA device without a GPU raises."""
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lighthouse_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU (plain versions of the kernels)"
        )
    return dev


def _coalescer():
    """The process-wide BatchVerifier when it is running over THIS backend
    module (crypto/bls/batch_verifier.py), else None. Single-set entry
    points route through it so concurrent callers share device batches
    instead of each paying a whole verify."""
    return batch_verifier.active_for(sys.modules[__name__])


def device_fingerprint(refresh_gauge: bool = True) -> dict:
    """Backend provenance, with the JAX package's keys: the platform
    ("cuda" or "cpu") and device kind (the card's name) of DEFAULT_DEVICE,
    the chip count (`torch.cuda.device_count()` on "cuda", 1 on "cpu"), the
    backend, and the coalescer's state. `jit_cache` is all zeros: PyTorch
    runs the verify eagerly and compiles nothing per batch shape, so there
    is no cache of compiled programs to report. Sets the info gauge
    (value 1, identity in the labels) unless `refresh_gauge` is False.
    Raises, as every entry point does, when DEFAULT_DEVICE is a CUDA
    device and there is no GPU."""
    dev = resolve_device()
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        kind, count = dev.type, 1
    svc = _coalescer()
    info = {
        "platform": dev.type,
        "device_kind": kind,
        "chip_count": count,
        "backend": dev.type,
        "jit_cache": {"verify_kernels_cached": 0, "hits": 0, "misses": 0},
        "coalescer": {
            "running": svc is not None,
            "s_bucket": int(svc.s_bucket) if svc is not None else batch_verifier.DEFAULT_S_BUCKET,
            "max_wait": float(svc.max_wait) if svc is not None else batch_verifier.DEFAULT_MAX_WAIT,
        },
    }
    if refresh_gauge:
        DEVICE_PROVENANCE_INFO.labels(
            platform=info["platform"], device_kind=info["device_kind"], chip_count=str(info["chip_count"])
        ).set(1)
    return info


class Signature(_ref.Signature):
    """Signature whose verification runs on the device. from_bytes
    decompresses and on-curve-checks on the host and defers the subgroup
    check to the device batch."""

    @staticmethod
    def from_bytes(data: bytes) -> "Signature":
        return Signature(_ref.g2_from_compressed(data, subgroup_check=False))

    @staticmethod
    def infinity() -> "Signature":
        return Signature(g2_infinity())

    def verify(self, pk: PublicKey, message: bytes, device=None) -> bool:
        return self.fast_aggregate_verify([pk], message, device=device)

    def fast_aggregate_verify(self, pks: list[PublicKey], message: bytes, device=None) -> bool:
        if not pks:
            return False
        s = SignatureSet(signature=self, signing_keys=list(pks), message=message)
        svc = _coalescer() if device is None else None
        if svc is not None:
            # coalesced: the set rides a shared RLC batch (random nonzero
            # r_i keeps the single-set verdict exact); bisection blames it
            # individually if the shared batch fails
            return bool(svc.submit([s]).result()[0])
        return verify_signature_sets([s], rng=_ONE_RNG, device=device)

    def aggregate_verify(self, pks: list[PublicKey], messages: list[bytes], device=None) -> bool:
        """Distinct-message aggregate verify as n sets with r_i = 1: the
        aggregate signature rides on the first set, the rest carry infinity."""
        if not pks or len(pks) != len(messages):
            return False
        sets = [
            SignatureSet(
                signature=self if i == 0 else Signature.infinity(),
                signing_keys=[pk],
                message=msg,
            )
            for i, (pk, msg) in enumerate(zip(pks, messages))
        ]
        return verify_signature_sets(sets, rng=_ONE_RNG, device=device)

    def eth_fast_aggregate_verify(self, pks: list[PublicKey], message: bytes, device=None) -> bool:
        if not pks and self.is_infinity():
            return True
        return self.fast_aggregate_verify(pks, message, device=device)


class SecretKey(_ref.SecretKey):
    def sign(self, message: bytes) -> Signature:
        return Signature(super().sign(message).point)

    @staticmethod
    def from_bytes(data: bytes) -> "SecretKey":
        if len(data) != 32:
            raise DecodeError("secret key must be 32 bytes")
        return SecretKey(int.from_bytes(data, "big"))

    @staticmethod
    def random() -> "SecretKey":
        return SecretKey(secrets.randbelow(_ref.R - 1) + 1)


def aggregate_signatures(sigs: list[Signature]) -> Signature:
    if not sigs:
        raise ValueError("cannot aggregate empty signature list")
    acc = g2_infinity()
    for s in sigs:
        acc = acc + s.point
    return Signature(acc)


@dataclass
class SignatureSet:
    """{signature, signing_keys, message}, as the ref oracle's."""

    signature: Signature
    signing_keys: list[PublicKey]
    message: bytes


def verify_signature_set(s: SignatureSet, device=None) -> bool:
    return s.signature.fast_aggregate_verify(s.signing_keys, s.message, device=device)


# -- the device pipeline -------------------------------------------------------


def _next_pow2(n: int, floor: int = 4) -> int:
    """Bucket size: next power of two, at least `floor`."""
    return max(floor, 1 << max(0, (n - 1)).bit_length())


_ABS_X_BITS64 = pairing._ABS_X_BITS_MSB[-64:]


def verify_pipeline_local(pk_x, pk_y, pk_inf, sig_x, sig_y, sig_inf, u, r_bits):
    """Everything but the final exponentiation for S sets x K keys/set.

    Inputs are device tensors in words (see `from_jax_staged`). Returns
    (miller_partial, ok): the product of the S + 1 Miller values, the last
    pair being (-g1, sum_i r_i sig_i), and the AND of the subgroup and
    aggregate-infinity checks."""
    dev = pk_x.device
    S, K = pk_inf.shape

    # 1. Hash messages to G2 (the host already ran SHA-256).
    H = h2c.hash_to_g2_device(u)

    # 2. Aggregate each set's keys with a halving tree over the K axis (the
    #    JAX package's `_tree_fold`).
    agg = tree_sum(FP, from_affine(FP, pk_x, pk_y, pk_inf), axis=1)
    agg_inf = is_infinity(FP, agg)

    # 3. r_i * aggpk_i.
    r_pk = scalar_mul_bits(FP, agg, r_bits)

    # 4. Subgroup checks (psi(sig) == -[|z|] sig) and r_i * sig_i, one
    #    2-stacked multiplication.
    sigs = from_affine(FP2, sig_x, sig_y, sig_inf)
    absx = fp.const(_ABS_X_BITS64, dev).expand(r_bits.shape)
    both = scalar_mul_bits(FP2, stack2(sigs, sigs), torch.stack([absx, r_bits.to(absx.dtype)]))
    zsig, rsig = unstack(both, 0), unstack(both, 1)
    sub_ok = eq_points(FP2, psi(sigs), p_neg(FP2, zsig)) | is_infinity(FP2, sigs)

    # 5. sig_acc = sum_i r_i sig_i.
    sig_acc = tree_sum(FP2, rsig, axis=0)

    # 6. S + 1 Miller pairs, batch-affine: every denominator is one Fp value
    #    (a G1 z, or a G2 z's norm z0^2 + z1^2), all inverted by one K4
    #    launch. Infinity lanes carry z = 0 -> 0 -> zeroed affine coordinates.
    g2_z = torch.cat([H.z, sig_acc.z[None]])  # (S + 1, 2, W)
    z0, z1 = g2_z[..., 0, :], g2_z[..., 1, :]
    zsq = fp.sqr(torch.stack([z0, z1]))
    dens = torch.cat([r_pk.z, fp.add(zsq[0], zsq[1])])
    inv_all = fp.batch_inv(dens)  # (2S + 1, W)
    g1_aff = fp.mul(torch.stack([r_pk.x, r_pk.y]), inv_all[:S])
    pk_ainf = is_infinity(FP, r_pk)
    nm = fp.mul(torch.stack([z0, z1]), inv_all[S:])
    zinv2 = torch.stack([nm[0], fp.neg(nm[1])], dim=-2)  # conj(z) / norm
    g2_aff = fp2_mul(
        torch.stack([torch.cat([H.x, sig_acc.x[None]]), torch.cat([H.y, sig_acc.y[None]])]),
        zinv2,
    )
    px = torch.cat([g1_aff[0], fp.const(G1_GEN_X_L, dev)[None]])
    py = torch.cat([g1_aff[1], fp.const(G1_GEN_NEG_Y_L, dev)[None]])
    p_in = torch.cat([pk_ainf, torch.zeros(1, dtype=torch.bool, device=dev)])
    qx, qy = g2_aff[0], g2_aff[1]
    q_in = is_infinity(FP2, Proj(qx, qy, g2_z))

    f = pairing.miller_loop(px, py, p_in, qx, qy, q_in)
    partial = pairing.product_reduce(f)
    ok = sub_ok.all() & ~agg_inf.any()
    return partial, ok


def _staged_specs(S: int, K: int):
    """(shape, is_bool) of each staged array, in stage_sets order (wire limbs)."""
    L = fp.JAX_LIMBS
    return [
        ((S, K, L), False),  # pk_x
        ((S, K, L), False),  # pk_y
        ((S, K), True),  # pk_inf
        ((S, 2, L), False),  # sig_x
        ((S, 2, L), False),  # sig_y
        ((S,), True),  # sig_inf
        ((S, 2, 2, L), False),  # u
        ((S, 64), False),  # r_bits
    ]


def _pack_staged(staged) -> np.ndarray:
    """The staged arrays as ONE int32 buffer: one host-to-device copy."""
    return np.concatenate([np.ravel(np.asarray(a)).astype(np.int32) for a in staged])


def _unpack_staged(flat, S: int, K: int):
    out, off = [], 0
    for shape, is_bool in _staged_specs(S, K):
        n = int(np.prod(shape))
        a = flat[off : off + n].reshape(shape)
        out.append(a.bool() if is_bool else a)
        off += n
    return tuple(out)


def _to_words(staged):
    """Wire-limb staged tensors -> the pipeline's word layout (same device)."""
    pk_x, pk_y, pk_inf, sig_x, sig_y, sig_inf, u, r_bits = staged
    return (
        fp.from_jax_limbs(pk_x),
        fp.from_jax_limbs(pk_y),
        pk_inf,
        fp.from_jax_limbs(sig_x),
        fp.from_jax_limbs(sig_y),
        sig_inf,
        fp.from_jax_limbs(u),
        r_bits,
    )


def from_jax_staged(staged, device=None):
    """The JAX package's `stage_sets` output (8 numpy arrays, wire limbs) as
    the pipeline's device tensors (words): one host-to-device copy, the
    repack on the device."""
    dev = resolve_device(device)
    S, K = np.asarray(staged[2]).shape
    flat = torch.from_numpy(_pack_staged(staged)).to(dev)
    return _to_words(_unpack_staged(flat, S, K))


def verify_staged(flat: torch.Tensor, S: int, K: int) -> torch.Tensor:
    """The counterpart of the JAX package's `_verify_kernel(S, K)`: flat
    staged buffer (on the device) -> pipeline -> final exponentiation ->
    is_one & ok, a device bool tensor. A plain function: PyTorch runs it
    eagerly, launch by launch."""
    partial, ok = verify_pipeline_local(*_to_words(_unpack_staged(flat, S, K)))
    return fp12_is_one(pairing.final_exponentiation(partial)) & ok


_ONE_RNG = "ones"  # sentinel: r_i = 1 (single-set / aggregate-verify paths)


def _scalar_bits_batch(rs) -> np.ndarray:
    """(n, 64) int32 MSB-first bit rows of 64-bit scalars."""
    a = np.asarray(list(rs), dtype=">u8")
    if a.size == 0:
        return np.empty((0, 64), dtype=np.int32)
    return np.unpackbits(a.view(np.uint8)).reshape(-1, 64).astype(np.int32)


@lru_cache(maxsize=1)
def _pad_generator() -> Point:
    """One process-wide generator Point for padding rows (packed once)."""
    return _ref.g1_generator()


def _batched_nonzero_scalars(n: int) -> np.ndarray:
    """n independent nonzero 64-bit scalars from one entropy draw."""
    out = np.frombuffer(secrets.token_bytes(8 * n), dtype=np.uint64).copy()
    while True:
        zeros = np.flatnonzero(out == 0)
        if zeros.size == 0:
            return out
        out[zeros] = np.frombuffer(secrets.token_bytes(8 * zeros.size), dtype=np.uint64)


def stage_sets(sets: list[SignatureSet], rng=None, s_floor: int = 4):
    """Host staging: pad the batch to the S bucket (power of two, at least
    max(4, s_floor)) with generator-keyed, r = 0 no-op sets and each key
    list to the K bucket with infinity points. Returns (pk_x, pk_y, pk_inf,
    sig_x, sig_y, sig_inf, u, r_bits) numpy arrays in wire limbs,
    byte-identical to the JAX package's stage_sets for the same inputs, rng
    and s_floor. Timed as the `bls_stage` span /
    lighthouse_tpu_bls_stage_seconds."""
    S = _next_pow2(len(sets), floor=max(4, s_floor))
    K = _next_pow2(max(len(s.signing_keys) for s in sets))
    BLS_BATCH_PADDED_SIZE.observe(S)

    with BLS_STAGE_SECONDS.time(), span("bls_stage"):
        n = len(sets)
        pk_pts: list[Point] = []
        sig_pts: list[Point] = []
        msgs: list[bytes] = []
        inf1 = g1_infinity()
        for s in sets:
            keys = [pk.point for pk in s.signing_keys]
            keys += [inf1] * (K - len(keys))
            pk_pts.extend(keys)
            sig_pts.append(s.signature.point)
            msgs.append(s.message)
        if S > n:
            gen = _pad_generator()
            inf2 = g2_infinity()
            for _ in range(S - n):
                pk_pts.extend([gen] + [inf1] * (K - 1))
                sig_pts.append(inf2)
                msgs.append(b"")  # r stays 0: the padded set contributes the identity

        r_rows = np.zeros((S, 64), dtype=np.int32)
        if n:
            if rng is _ONE_RNG:
                rs = [1] * n
            elif rng is None:
                rs = _batched_nonzero_scalars(n)
            else:
                # seeded-rng seam: per-set draws in submission order
                rs = []
                for _ in range(n):
                    r = 0
                    while r == 0:
                        r = rng(RAND_BITS)
                    rs.append(r)
            r_rows[:n] = _scalar_bits_batch(rs)

        with span("bls_pack"):
            pk_x, pk_y, pk_inf = pack_g1_batch(pk_pts)
            sig_x, sig_y, sig_inf = pack_g2_batch(sig_pts)
        with span("bls_h2c_host"):
            u = h2c.hash_to_field_limbs(msgs)
    return pk_x.reshape(S, K, -1), pk_y.reshape(S, K, -1), pk_inf.reshape(S, K), sig_x, sig_y, sig_inf, u, r_rows


def drop_staging_caches(sets) -> None:
    """Forget every staging cache a batch could hit (the hash-to-field LRU
    and the limb rows of every point it references, the padding generator's
    included), so that the next `stage_sets` runs cold."""
    h2c.H2C_FIELD_CACHE.clear()
    pts = [_pad_generator()]
    for s in sets:
        pts += [pk.point for pk in s.signing_keys] + [s.signature.point]
    for pt in pts:
        try:
            del pt._limbs
        except AttributeError:
            pass


def precompute_pubkey_limbs(pk: PublicKey) -> None:
    """Pubkey-cache hook: attach a resolved validator key's limb rows now,
    so the first batch that stages it is already a cache hit."""
    precompute_limbs(pk.point)


class VerifyFuture:
    """Handle to an in-flight verification: the kernels are queued on the
    device stream and `result()` waits for the verdict."""

    def __init__(self, device_result):
        self._result = device_result

    def result(self) -> bool:
        r = self._result
        return bool(r.item()) if isinstance(r, torch.Tensor) else bool(r)


_INVALID = VerifyFuture(False)


def _structurally_valid(sets: list[SignatureSet]) -> bool:
    if not sets:
        return False
    for s in sets:
        if not s.signing_keys:
            return False
        if any(pk.point.inf for pk in s.signing_keys):
            return False
    return True


@torch.inference_mode()
def verify_signature_sets_async(sets: list[SignatureSet], rng=None, device=None) -> VerifyFuture:
    """Stage and queue a batch without waiting for the verdict."""
    if not _structurally_valid(sets):
        return _INVALID
    dev = resolve_device(device)
    staged = stage_sets(sets, rng=rng)
    S, K = staged[2].shape
    flat = torch.from_numpy(_pack_staged(staged)).to(dev)
    return VerifyFuture(verify_staged(flat, S, K))


def verify_signature_sets(sets: list[SignatureSet], rng=None, device=None) -> bool:
    """Batch verification by random linear combination: n + 1 Miller loops,
    one final exponentiation. Returns False (never raises) for structurally
    invalid batches.

    The timer and the `bls_batch_verify` span cover staging, dispatch and
    the wait for the verdict; `mark_device_busy` tells the coalescer's
    device-idle flush that a dedicated batch occupies the device, so
    concurrent single-set submissions accumulate instead of dispatching
    alone."""
    if not _structurally_valid(sets):
        return False  # structurally invalid: no device work, no metrics
    dev = resolve_device(device)
    with batch_verifier.mark_device_busy(), BLS_BATCH_SECONDS.time(), span("bls_batch_verify"):
        fut = verify_signature_sets_async(sets, rng=rng, device=dev)
        with span("bls_device_execute"):
            ok = fut.result()
    BLS_SETS_TOTAL.inc(len(sets))
    return ok


# -- pubkey admission ------------------------------------------------------------


def decompress_public_keys(keys: list[bytes]):
    """Decompress each compressed G1 key on the host (the on-curve check
    only: the subgroup check runs on the device) and pad to the S bucket
    with infinity. Returns (S points, decode mask (len(keys),)): the mask is
    False where the encoding is invalid, and such a key becomes infinity."""
    inf1 = g1_infinity()
    pts, decoded = [], np.zeros(len(keys), dtype=bool)
    for i, kb in enumerate(keys):
        try:
            pts.append(_ref.g1_from_compressed(kb, subgroup_check=False))
            decoded[i] = True
        except DecodeError:
            pts.append(inf1)
    pts += [inf1] * (_next_pow2(len(pts)) - len(pts))
    return pts, decoded


def stage_public_keys(keys: list[bytes]):
    """Host half of pubkey admission: (x, y, inf) wire limbs, (S, 32),
    (S, 32), (S,), as the JAX package stages them, and the decode mask."""
    pts, decoded = decompress_public_keys(keys)
    return (*pack_g1_batch(pts), decoded)


def validate_staged_g1(x: torch.Tensor, y: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """The counterpart of the JAX package's `_pk_validate_kernel(S)`:
    (S, 12) word coordinates and the (S,) infinity mask on the device ->
    g1_in_subgroup & ~inf, (S,) bool; one K5 launch on a CUDA device."""
    return g1_in_subgroup_kernel(x, y, inf)


@torch.inference_mode()
def batch_validate_public_keys(keys: list[bytes], device=None) -> list[bool]:
    """Decompress and subgroup-check a batch of compressed G1 pubkeys, the
    validator pubkey-cache admission path: one bool per key; invalid
    encodings and infinity are False. The staged batch crosses to the device
    as one int32 buffer and is repacked into words there."""
    dev = resolve_device(device)
    x, y, inf, decoded = stage_public_keys(keys)
    S, n = inf.shape[0], x.size
    flat = torch.from_numpy(_pack_staged([x, y, inf])).to(dev)
    ok = validate_staged_g1(
        fp.from_jax_limbs(flat[:n].reshape(S, -1)),
        fp.from_jax_limbs(flat[n : 2 * n].reshape(S, -1)),
        flat[2 * n :].bool(),
    )
    return (ok[: len(keys)].cpu().numpy() & decoded).tolist()


# -- interop keypairs ----------------------------------------------------------


def interop_secret_key(validator_index: int) -> SecretKey:
    return SecretKey(_ref.interop_secret_key(validator_index).k)


def interop_keypair(validator_index: int) -> tuple[SecretKey, PublicKey]:
    sk = interop_secret_key(validator_index)
    return sk, sk.public_key()
