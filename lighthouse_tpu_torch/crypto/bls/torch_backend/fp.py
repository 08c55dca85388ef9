"""Base-field (Fp, p = BLS12-381 modulus) arithmetic on 32-bit words.

Representation
--------------
An Fp element is a (..., 12) int32 tensor holding the u32 bit patterns of
12 little-endian words: value = sum(word[i] << (32*i)). Stored values are
canonical (value < p) and in Montgomery form with R = 2^384, exactly the
integers the JAX package keeps in 32 twelve-bit limbs (its fp.py uses the
same R), so the two agree after `from_jax_limbs` / `to_jax_limbs`.

Every function broadcasts over leading batch dimensions. The arithmetic
runs in hand-written CUDA kernels (csrc/fp_kernels.cu, csrc/fp_mma.cu):

    K1 fp_mul        mul, sqr, to_mont, from_mont
    K2 fp_addsub     add, sub, neg
    K3 fp_pow        inv, sqrt_candidate
    K4 fp_batch_inv  batch_inv
    K6 fp_mul_mma    mul_mxu; mul and sqr too when USE_MXU_MUL is set

Each wrapper takes its kernel for a CUDA tensor and its plain PyTorch
version (`*_plain`, below) for a CPU tensor, and raises for anything else.
There is no fallback from the kernel to the plain version. `LAUNCHES`
counts kernel launches per kernel, for these, for K5
(`curve.g1_in_subgroup_kernel`, csrc/g1_kernels.cu), for the tower
products K7 and K8 (`tower.fp2_product`, `tower.fp12_product`,
csrc/tower_kernels.cu), for the scalar multiplications K10 and K11
(`curve.scalar_mul_bits`, csrc/curve_kernels.cu), for the |z|-power
chain K9 (`pairing.pow_abs_x`, csrc/final_exp_kernels.cu), for the Miller
loop K12 (`pairing.miller_loop`, csrc/pairing_kernels.cu), for
hash-to-G2's SSWU map K13 and 3-isogeny K14 (`h2c.sswu`, `h2c.iso3_map`,
csrc/h2c_kernels.cu), for the tree sums K15 and K16 and the Fp12 product
K18 (`curve.tree_sum`, `pairing.product_reduce`, csrc/fold_kernels.cu),
for the cofactor clearing K17 (`h2c.clear_cofactor`,
csrc/cofactor_kernels.cu), for the final exponentiation K19
(`pairing.final_exponentiation`, csrc/final_exponentiation_kernels.cu) and
for the verify's G2 subgroup check K20 and batch-affine Miller inputs K21
(`curve.g2_psi_check`, `api.miller_inputs`, csrc/verify_kernels.cu), and
for the standalone functions off the verify path K22-K25 (`curve.to_affine`
G1 and G2, `tower.fp6_mul`, `tower.fp2_inv`, csrc/affine_kernels.cu) and
K26-K33, the standalone launches of routines that run inside the verify
path's kernels (`curve.add` G1 and G2, `tower.karabina_sqr` and
`karabina_decompress`, `mont_reduce` here, csrc/standalone_kernels.cu;
`tower.fp12_inv` and `pairing.frobenius`,
csrc/final_exponentiation_kernels.cu; `h2c.fp2_sqrt_candidate`,
csrc/h2c_kernels.cu).

K6 is the JAX package's opt-in matrix-unit product (`mul_mxu`, enabled by
LIGHTHOUSE_TPU_MXU_FP_MUL=1) on the tensor cores. K3, K4, K5 and K7 to
K33 keep their in-register CIOS products whatever the flag says: each is
one thread's chain of products, and an MMA needs a whole warp. The results
are the same either way, since both products are canonical.

int32 holds u32 bit patterns, so the plain versions widen to int64 and
mask with 0xFFFFFFFF before any shift or comparison; equality tests
(`eq`, `is_zero`) are bitwise and safe on the raw words.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import P

WORDS = 12
WORD_BITS = 32
BITS = WORDS * WORD_BITS  # 384
_MASK32 = 0xFFFFFFFF

# JAX wire format: 32 limbs of 12 bits (lighthouse_tpu jax_backend/fp.py).
JAX_LIMBS = 32

# -- host-side packing ---------------------------------------------------------


def int_to_words(x: int) -> np.ndarray:
    """A Python int in [0, 2^384) as (12,) int32 little-endian words."""
    if not 0 <= x < (1 << BITS):
        raise ValueError("value out of word range")
    return np.frombuffer(x.to_bytes(BITS // 8, "little"), dtype="<u4").view(np.int32).copy()


def ints_to_words(xs) -> np.ndarray:
    """Bulk `int_to_words`: (n, 12) int32."""
    xs = list(xs)
    if not xs:
        return np.empty((0, WORDS), dtype=np.int32)
    try:
        buf = b"".join(x.to_bytes(BITS // 8, "little") for x in xs)
    except (OverflowError, AttributeError) as e:
        raise ValueError("value out of word range") from e
    return np.frombuffer(buf, dtype="<u4").view(np.int32).reshape(len(xs), WORDS).copy()


def words_to_int(words) -> int:
    """(12,) words (numpy or tensor) -> Python int."""
    arr = np.asarray(words.cpu() if isinstance(words, torch.Tensor) else words)
    return int.from_bytes(arr.astype("<u4").tobytes(), "little")


R_MONT = (1 << BITS) % P
R2 = R_MONT * R_MONT % P
_R_INV = pow(R_MONT, -1, P)
P_INV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32 (CIOS)
N_PRIME = (-pow(P, -1, 1 << BITS)) % (1 << BITS)  # -p^-1 mod 2^384

P_WORDS = int_to_words(P)
R2_WORDS = int_to_words(R2)
ONE_MONT = int_to_words(R_MONT)
ZERO = np.zeros(WORDS, dtype=np.int32)
INV_EXP = P - 2
SQRT_EXP = (P + 1) // 4


def to_mont_host(x: int) -> np.ndarray:
    """Host-side Montgomery packing of one int (for constants)."""
    return int_to_words((x % P) * R_MONT % P)


def to_mont_host_bulk(xs) -> np.ndarray:
    return ints_to_words([(x % P) * R_MONT % P for x in xs])


def from_mont_host(words) -> int:
    return words_to_int(words) * _R_INV % P


# -- carrying state across from the JAX package --------------------------------
#
# Eight 12-bit limbs are 96 bits, i.e. three 32-bit words, so both repacks
# are exact, fixed bit shuffles over groups of (8 limbs <-> 3 words).


def _limbs_to_words_t(limbs: torch.Tensor) -> torch.Tensor:
    g = limbs.to(torch.int64).reshape(*limbs.shape[:-1], JAX_LIMBS // 8, 8)
    lo = g[..., 0] | (g[..., 1] << 12) | (g[..., 2] << 24) | (g[..., 3] << 36) | (g[..., 4] << 48)
    lo = lo | ((g[..., 5] & 0xF) << 60)  # bit 63 may set: int64 wraps, masks below still hold
    hi = (g[..., 5] >> 4) | (g[..., 6] << 8) | (g[..., 7] << 20)
    w = torch.stack([lo & _MASK32, (lo >> 32) & _MASK32, hi], dim=-1)
    return w.reshape(*limbs.shape[:-1], WORDS).to(torch.int32)


def _words_to_limbs_t(words: torch.Tensor) -> torch.Tensor:
    w = (words.to(torch.int64) & _MASK32).reshape(*words.shape[:-1], WORDS // 3, 3)
    lo = w[..., 0] | (w[..., 1] << 32)  # 64 bits (sign bit wraps; shifts below mask)
    hi = w[..., 2]
    m = 0xFFF
    limbs = torch.stack(
        [
            lo & m,
            (lo >> 12) & m,
            (lo >> 24) & m,
            (lo >> 36) & m,
            (lo >> 48) & m,
            ((lo >> 60) & 0xF) | ((hi & 0xFF) << 4),
            (hi >> 8) & m,
            (hi >> 20) & m,
        ],
        dim=-1,
    )
    return limbs.reshape(*words.shape[:-1], JAX_LIMBS).to(torch.int32)


def from_jax_limbs(limbs, device=None) -> torch.Tensor:
    """(..., 32) 12-bit limbs (numpy or tensor) -> (..., 12) int32 words,
    on `device` (default: where the tensor lies, or the CPU for numpy)."""
    t = limbs if isinstance(limbs, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(limbs, np.int32))
    if device is not None:
        t = t.to(device)
    return _limbs_to_words_t(t)


def to_jax_limbs(words) -> np.ndarray:
    """(..., 12) int32 words (tensor or numpy) -> (..., 32) int32 12-bit limbs."""
    t = words if isinstance(words, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(words, np.int32))
    return _words_to_limbs_t(t.cpu()).numpy()


# -- device constants ----------------------------------------------------------

_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on `device`, cached by the
    array's identity (so pass long-lived arrays, not temporaries)."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    key = (id(arr), device)
    hit = _CONSTS.get(key)
    if hit is None or hit[1] is not arr:
        hit = (torch.from_numpy(np.ascontiguousarray(arr)).to(device), arr)
        _CONSTS[key] = hit  # holds arr, so its id is not reused while cached
    return hit[0]


def one(shape, device) -> torch.Tensor:
    return const(ONE_MONT, device).expand(*shape, WORDS)


def zero(shape, device) -> torch.Tensor:
    return torch.zeros((*shape, WORDS), dtype=torch.int32, device=device)


#: Route every `mul` / `sqr` through `mul_mxu` (K6), as the JAX package's
#: flag of the same name does (its fp.py:310-314). Read once at import.
USE_MXU_MUL = os.environ.get("LIGHTHOUSE_TPU_MXU_FP_MUL", "") == "1"

# -- launch accounting ---------------------------------------------------------

#: every kernel of the library: K1-K4, K6 and K33 here, K5, K10, K11, K15,
#: K16, K20, K22, K23, K26 and K27 in curve.py, K7, K8, K24, K25, K28-K30 in
#: tower.py, K9, K12, K18, K19 and K31 in pairing.py, K13, K14, K17 and K32
#: in h2c.py, K21 in api.py
KERNELS = ("fp_mul", "fp_addsub", "fp_pow", "fp_batch_inv", "g1_subgroup_check", "fp_mul_mma", "fp2_mul",
           "fp12_mul", "cyclotomic_pow_x", "g1_scalar_mul", "g2_scalar_mul", "miller_loop", "sswu", "iso3_map",
           "g1_tree_sum", "g2_tree_sum", "clear_cofactor", "product_reduce", "final_exponentiation",
           "g2_psi_check", "miller_inputs", "g1_to_affine", "g2_to_affine", "fp6_mul", "fp2_inv", "g1_add",
           "g2_add", "karabina_sqr", "karabina_decompress", "fp12_inv", "frobenius", "fp2_sqrt_candidate",
           "fp_redc")
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _count(name: str) -> None:
    LAUNCHES[name] += 1


def _is_cpu(*ts: torch.Tensor) -> bool:
    """Dispatch: True when every operand lies on the CPU (plain version),
    False when all lie on one CUDA device (kernel). Every operand must be
    int32 (..., 12); a mix of devices, or any other device, raises."""
    for t in ts:
        if t.dtype != torch.int32 or t.shape[-1:] != (WORDS,):
            raise TypeError(f"Fp operand must be int32 (..., {WORDS}), got {t.dtype} {tuple(t.shape)}")
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        raise RuntimeError(f"Fp operands on different devices: {[str(t.device) for t in ts]}")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise RuntimeError(f"unsupported device {dev}: Fp kernels run on CUDA, plain versions on the CPU")


# -- plain versions (CPU tensors; the card's reference in chip_smoke.py) -------
#
# A 32 x 32-bit product does not fit signed int64, so the plain product
# splits each word into 16-bit digits: 24 digits, column sums < 2^37.
# Carries are resolved without a data-dependent ripple: a fixed number of
# shift-add passes leaves every carry at most 1, and the last one is
# resolved exactly by carry lookahead on 0/1 masks packed into one int64
# (bit j of ((G << 1) + P) ^ P is the carry into digit j).

_POW2 = {n: np.array([1 << i for i in range(n)], dtype=np.int64) for n in (12, 24, 48)}
_SHIFTS = {n: np.arange(n, dtype=np.int64) for n in (13, 25, 49)}


def _passes(v: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """n shift-add passes over int64 columns >= 0 (mutates v). The carry
    out of the top column is dropped: callers either have room there or
    want the value mod 2^(bits * columns)."""
    mask = (1 << bits) - 1
    for _ in range(n):
        c = v[..., :-1] >> bits
        v &= mask
        v[..., 1:] += c
    return v


def _lookahead(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry (or borrow) into each of n+1 digits from 0/1 generate and
    propagate flags over n digits: (..., n) -> (..., n + 1) int64.
    With G, P the flags as bit masks, (G << 1) + P = sum (2g + p) 2^i."""
    n = gen.shape[-1]
    w = const(_POW2[n], gen.device)
    p = prop.to(torch.int64)
    c = ((2 * gen + p) * w).sum(dim=-1) ^ (p * w).sum(dim=-1)
    return (c[..., None] >> const(_SHIFTS[n + 1], gen.device)) & 1


def _add_digits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact digits of columns in [0, 2^(bits+1) - 1) (a carry of at most
    one out of each): (..., n) -> (..., n + 1) with the carry on top."""
    mask = (1 << bits) - 1
    cin = _lookahead(v >> bits, v == mask)
    out = torch.nn.functional.pad(v, (0, 1)) + cin
    out[..., :-1] &= mask
    return out


def _sub_digits(x: torch.Tensor, y: torch.Tensor, bits: int):
    """x - y over exact digits: (digits mod 2^(bits*n), borrow-out bool)."""
    d = x - y
    b = _lookahead(d < 0, d == 0)
    return (d - b[..., :-1]) & ((1 << bits) - 1), b[..., -1] == 1


def _digits16(a: torch.Tensor) -> torch.Tensor:
    """(..., 12) words -> (..., 24) int64 16-bit digits, little-endian."""
    return a.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF


def _words16(d: torch.Tensor) -> torch.Tensor:
    return (d[..., 0::2] | (d[..., 1::2] << 16)).to(torch.int32)


def _conv(x: torch.Tensor, y: torch.Tensor, keep: int) -> torch.Tensor:
    """The first `keep` column sums of the digit product (..., n) x (..., n),
    by the pad/reshape anti-diagonal trick: pad each row of the outer
    product to 2n, flatten, drop the tail and re-read it with rows of
    2n - 1, which skews row i right by i."""
    n = x.shape[-1]
    outer = x[..., :, None] * y[..., None, :]  # (..., n, n)
    flat = torch.nn.functional.pad(outer, (0, n)).reshape(*outer.shape[:-2], 2 * n * n)
    skew = flat[..., : 2 * n * n - n].reshape(*outer.shape[:-2], n, 2 * n - 1)
    return skew[..., :keep].sum(dim=-2)


def _digits16_host(x: int) -> np.ndarray:
    return np.array([(x >> (16 * i)) & 0xFFFF for i in range(2 * WORDS)], dtype=np.int64)


_P16 = _digits16_host(P)
_NP16 = _digits16_host(N_PRIME)


def _redc16(t: torch.Tensor, subs: int = 1) -> torch.Tensor:
    """Montgomery reduction shared by the plain products: T * 2^-384 mod p,
    canonical words, for T < p^2 given as 47 or 48 sixteen-bit digit
    columns, each < 2^37 (the JAX package's `redc`, fp.py:261). With
    `subs` = 3 it takes T < 2 p 2^384 (`mont_reduce_plain`)."""
    p16, np16 = const(_P16, t.device), const(_NP16, t.device)
    n = 2 * WORDS
    # m = -T p^-1 mod 2^384, only up to a multiple of 2^384: digits are
    # left just above 16 bits (< 2^16 + 2^10) and the carry out of the top
    # is dropped. The low columns of T need no carrying first, since the
    # columns above them only add multiples of 2^384. Then
    # (T + m p) / 2^384 < p^2 / 2^384 + 1.02 p < 2p (T < 2 p 2^384: < 3.02 p,
    # three subtractions).
    m = _passes(_conv(t[..., :n], np16.expand_as(t[..., :n]), n), 16, 3)
    mp = _conv(m, p16.expand_as(m), 2 * n - 1)
    u = torch.nn.functional.pad(t, (0, 2 * n - t.shape[-1])) + torch.nn.functional.pad(mp, (0, 1))
    u = _passes(u, 16, 3)  # carries now <= 1; T + m p < 2^768 fits the 48 digits
    hi = _add_digits(u, 16)[..., n : 2 * n]  # (T + m p) / 2^384, exact
    for _ in range(subs):
        d, borrow = _sub_digits(hi, p16, 16)
        hi = torch.where(borrow[..., None], hi, d)
    return _words16(hi)


WIDE = 2 * WORDS  # a double-width value: 24 words


@torch.inference_mode()
def mont_reduce_plain(t: torch.Tensor) -> torch.Tensor:
    """K33's plain version: T * 2^-384 mod p, canonical words (..., 12), for
    T < 2 p 2^384 given as (..., 24) int32 words (the JAX package's
    `redc(cols, mult=2)`, fp.py:261, on the port's double-width words)."""
    return _redc16(_digits16(t), subs=3)


def mont_reduce(t: torch.Tensor) -> torch.Tensor:
    """T * 2^-384 mod p for T < 2 p 2^384 in (..., 24) words: one launch of
    K33 (csrc/standalone_kernels.cu, fp384.cuh's `fp_redc_wide`, the
    reduction inside K1 and every kernel's lazy sums) for a CUDA tensor,
    the plain version for a CPU tensor."""
    if t.shape[-1:] != (WIDE,):
        raise TypeError(f"mont_reduce operand must be int32 (..., {WIDE}), got {t.dtype} {tuple(t.shape)}")
    if _is_cpu(t.unflatten(-1, (2, WORDS))):
        return mont_reduce_plain(t)
    from . import kernels

    t = t.contiguous()
    out = torch.empty((*t.shape[:-1], WORDS), dtype=torch.int32, device=t.device)
    kernels.launch("lh_fp_redc", t.device, t.data_ptr(), WIDE, out.data_ptr(), out.numel() // WORDS)
    _count("fp_redc")
    return out


@torch.inference_mode()
def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1's plain version: Montgomery product a * b * 2^-384 mod p."""
    a, b = torch.broadcast_tensors(a, b)
    n = 2 * WORDS
    return _redc16(_conv(_digits16(a), _digits16(b), 2 * n - 1))  # (..., 47) columns < 2^37


# -- the tensor-core product (K6's plain version) ------------------------------
#
# The JAX package's `mul_mxu` (fp.py:373): byte limbs, each element's
# 48 x 95 band matrix of b, one contraction. Every column is at most
# 48 * 255^2 = 3,121,200 < 2^22, so it is exact in K6's s32 accumulator
# (48 * 255^2 < 2^31 is the bound that matters there) and here in int64.
# The JAX package derives its limb width from its float32 analyzer; 8 bits
# is the width whose products the card's u8 tensor-core MMA takes.

MXU_LIMB_BITS = 8
MXU_LIMBS = BITS // MXU_LIMB_BITS  # 48
_BAND_DIFF = np.arange(2 * MXU_LIMBS - 1)[None, :] - np.arange(MXU_LIMBS)[:, None]
_BAND_VALID = (_BAND_DIFF >= 0) & (_BAND_DIFF < MXU_LIMBS)
_BAND_IDX = np.clip(_BAND_DIFF, 0, MXU_LIMBS - 1)


def _bytes(a: torch.Tensor) -> torch.Tensor:
    """(..., 12) words -> (..., 48) int64 byte limbs, little-endian."""
    return a.contiguous().view(torch.uint8).to(torch.int64)


def _byte_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 95 byte columns c_k = sum_i a_i b_(k-i) of the product and a
    zero one: (..., 96) int64, what K6's MMAs leave in shared memory.
    The contraction is a broadcast product and a sum, which runs on every
    device (an integer einsum does not run on the card)."""
    a, b = torch.broadcast_tensors(a, b)
    bb = _bytes(b)
    band = torch.where(const(_BAND_VALID, a.device), bb[..., const(_BAND_IDX, a.device)], 0)  # (..., 48, 95)
    cols = (_bytes(a)[..., :, None] * band).sum(dim=-2)
    return torch.nn.functional.pad(cols, (0, 1))


@torch.inference_mode()
def mul_mxu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6's plain version: the same Montgomery product as `mul_plain`, by
    byte columns. Pairs of byte columns fold into 48 sixteen-bit digit
    columns d_k = c_2k + (c_2k+1 << 8) < 2^30 (the last one is
    c_94 = a_47 b_47 alone), which the shared reduction takes."""
    c = _byte_columns(a, b)
    return _redc16(c[..., 0::2] + (c[..., 1::2] << 8))


@torch.inference_mode()
def addsub_plain(a: torch.Tensor, b: torch.Tensor | None, op: int) -> torch.Tensor:
    """K2's plain version: op 0 = a + b, 1 = a - b, 2 = -a (mod p)."""
    pw = const(_P32, a.device)
    if op == 2:
        x = a.to(torch.int64) & _MASK32
        d, _ = _sub_digits(pw, x, 32)
        out = torch.where((a != 0).any(dim=-1, keepdim=True), d, torch.zeros_like(d))
    elif op in (0, 1):
        a, b = torch.broadcast_tensors(a, b)
        x = a.to(torch.int64) & _MASK32
        y = b.to(torch.int64) & _MASK32
        if op == 0:
            s = _add_digits(x + y, 32)[..., :WORDS]  # < 2p: no carry out
            d, borrow = _sub_digits(s, pw, 32)
            out = torch.where(borrow[..., None], s, d)
        else:
            d, borrow = _sub_digits(x, y, 32)
            out = torch.where(borrow[..., None], _add_digits(d + pw, 32)[..., :WORDS], d)
    else:
        raise ValueError(f"unknown op {op}")
    return out.to(torch.int32)


_P32 = P_WORDS.astype(np.int64) & _MASK32


POW_WINDOW = 4


def pow_windowed(base, e: int, mul_fn, sqr_fn, one_el):
    """base^e (e > 0) for a public exponent by fixed 2^4-ary windows over
    a 16-entry table, MSB-first; generic over the field so Fp (K3's plain
    version) and Fp2 (the hash-to-G2 square roots) share it."""
    table = [one_el, base]
    for _ in range(2, 1 << POW_WINDOW):
        table.append(mul_fn(table[-1], base))
    digits = []
    while e:
        digits.append(e & ((1 << POW_WINDOW) - 1))
        e >>= POW_WINDOW
    acc = table[digits[-1]]
    for d in reversed(digits[:-1]):
        for _ in range(POW_WINDOW):
            acc = sqr_fn(acc)
        if d:
            acc = mul_fn(acc, table[d])
    return acc


@torch.inference_mode()
def pow_plain(a: torch.Tensor, e: int) -> torch.Tensor:
    """K3's plain version: a^e (e > 0); 0 -> 0."""
    return pow_windowed(a, e, mul_plain, lambda x: mul_plain(x, x), one(a.shape[:-1], a.device))


@torch.inference_mode()
def batch_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """K4's plain version: Montgomery batch inversion along axis 0, zero
    entries stay zero."""
    zero_mask = is_zero(a)
    am = select(zero_mask, one(a.shape[:-1], a.device), a)
    prefix = [am[0]]
    for i in range(1, a.shape[0]):
        prefix.append(mul_plain(prefix[-1], am[i]))
    t = pow_plain(prefix[-1], INV_EXP)
    invs = [None] * a.shape[0]
    for i in range(a.shape[0] - 1, 0, -1):
        u = mul_plain(torch.stack([t, t]), torch.stack([prefix[i - 1], am[i]]))
        invs[i], t = u[0], u[1]
    invs[0] = t
    return select(zero_mask, torch.zeros_like(a), torch.stack(invs))


# -- kernel wrappers -----------------------------------------------------------


def _product(a: torch.Tensor, b: torch.Tensor, plain, launcher: str, name: str) -> torch.Tensor:
    """A Montgomery product wrapper: broadcast, then the plain version for
    CPU tensors or one launch of `launcher`, counted under `name`."""
    cpu = _is_cpu(a, b)
    a, b = torch.broadcast_tensors(a, b)
    if cpu:
        return plain(a, b)
    from . import kernels

    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // WORDS
    kernels.launch(launcher, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    _count(name)
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-384 mod p: K1, or K6 when
    USE_MXU_MUL is set."""
    if USE_MXU_MUL:
        return mul_mxu(a, b)
    return _product(a, b, mul_plain, "lh_fp_mul", "fp_mul")


def mul_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product on the tensor cores (K6, csrc/fp_mma.cu)."""
    return _product(a, b, mul_mxu_plain, "lh_fp_mul_mma", "fp_mul_mma")


def _addsub(a: torch.Tensor, b: torch.Tensor | None, op: int) -> torch.Tensor:
    cpu = _is_cpu(a) if b is None else _is_cpu(a, b)
    if b is not None:
        a, b = torch.broadcast_tensors(a, b)
    if cpu:
        return addsub_plain(a, b, op)
    from . import kernels

    a = a.contiguous()
    b = a if b is None else b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // WORDS
    kernels.launch("lh_fp_addsub", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, op)
    _count("fp_addsub")
    return out


_EXP_CACHE: dict = {}


def pow_fixed(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a public exponent e > 0 (K3); 0 -> 0."""
    if _is_cpu(a):
        return pow_plain(a, e)
    from . import kernels

    a = a.contiguous()
    key = (e, str(a.device))
    ew = _EXP_CACHE.get(key)
    if ew is None:
        ew = torch.from_numpy(int_to_words(e)).to(a.device)
        _EXP_CACHE[key] = ew
    out = torch.empty_like(a)
    n = a.numel() // WORDS
    kernels.launch("lh_fp_pow", a.device, a.data_ptr(), ew.data_ptr(), e.bit_length(), out.data_ptr(), n)
    _count("fp_pow")
    return out


def batch_inv(a: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion over the LEADING axis (K4): zero entries
    map to zero, every other entry to its inverse."""
    if _is_cpu(a):
        return batch_inv_plain(a)
    from . import kernels

    a = a.contiguous()
    out = torch.empty_like(a)
    steps = a.shape[0]
    lanes = a[0].numel() // WORDS if steps else 0
    kernels.launch("lh_fp_batch_inv", a.device, a.data_ptr(), out.data_ptr(), steps, lanes)
    _count("fp_batch_inv")
    return out


# -- field operations (Montgomery domain) -------------------------------------


def add(a, b):
    return _addsub(a, b, 0)


def sub(a, b):
    return _addsub(a, b, 1)


def neg(a):
    return _addsub(a, None, 2)


def sqr(a):
    return mul(a, a)


def inv(a):
    """a^-1 via Fermat (a^(p-2)); 0 -> 0 ("inv0", as the SSWU map needs)."""
    return pow_fixed(a, INV_EXP)


def sqrt_candidate(a):
    """a^((p+1)/4): the square root when a is a square (p = 3 mod 4)."""
    return pow_fixed(a, SQRT_EXP)


def to_mont(a):
    return mul(a, const(R2_WORDS, a.device))


def from_mont(a):
    return mul(a, const(_ONE_STD, a.device))


_ONE_STD = int_to_words(1)


def is_zero(a):
    return (a == 0).all(dim=-1)


def eq(a, b):
    return (a == b).all(dim=-1)


def select(cond, a, b):
    """Branch-free select: cond (...,) bool; a, b (..., 12)."""
    return torch.where(cond[..., None], a, b)


class FpOps(NamedTuple):
    """The Fp operations that a composed field operation is written over."""

    add: Callable
    sub: Callable
    neg: Callable
    mul: Callable
    inv: Callable


#: K2, K1 and K3: the composition that K7 and K8 replaced on the card
KERNEL_OPS = FpOps(add, sub, neg, mul, inv)
#: their plain versions, PyTorch operations only, on any device: the plain
#: versions of K5, K7 and K8 run over them
PLAIN_OPS = FpOps(
    add=lambda a, b: addsub_plain(a, b, 0),
    sub=lambda a, b: addsub_plain(a, b, 1),
    neg=lambda a: addsub_plain(a, None, 2),
    mul=mul_plain,
    inv=lambda a: pow_plain(a, INV_EXP),
)
