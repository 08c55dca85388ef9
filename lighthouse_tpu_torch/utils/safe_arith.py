"""Checked/saturating uint64 arithmetic.

Counterpart of lighthouse/consensus/safe_arith (SafeArith trait):
Python ints do not overflow, but consensus values are uint64 on the wire —
these helpers make overflow explicit where the spec's math must stay in
range, instead of failing later at SSZ serialization.
"""

from __future__ import annotations

UINT64_MAX = 2**64 - 1


class ArithError(ArithmeticError):
    pass


def safe_add(a: int, b: int) -> int:
    c = a + b
    if c > UINT64_MAX:
        raise ArithError(f"u64 add overflow: {a} + {b}")
    return c


def safe_sub(a: int, b: int) -> int:
    if b > a:
        raise ArithError(f"u64 sub underflow: {a} - {b}")
    return a - b


def safe_mul(a: int, b: int) -> int:
    c = a * b
    if c > UINT64_MAX:
        raise ArithError(f"u64 mul overflow: {a} * {b}")
    return c


def safe_div(a: int, b: int) -> int:
    if b == 0:
        raise ArithError("division by zero")
    return a // b


def saturating_add(a: int, b: int) -> int:
    return min(a + b, UINT64_MAX)


def saturating_sub(a: int, b: int) -> int:
    return max(a - b, 0)
