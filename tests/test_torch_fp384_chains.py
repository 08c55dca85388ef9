"""fp384.cuh's PTX carry chains on the CPU: the multi-word arithmetic inside
every kernel of the port.

The chains run only on the card, so this file reads each chain's `asm`
text (the `FP_ASM_*` macros) and each routine's `asm` statements with their
operand lists from `csrc/fp384.cuh`, and runs them in a Python interpreter
of the PTX they use: `add`, `addc`, `sub`, `subc`, `mad.lo`, `mad.hi`,
`madc.lo`, `madc.hi`, `mul.lo`, `mul.hi` and `and.b32`, with and without
`.cc`, on 32-bit words, the carry flag included. The flag starts
undefined in every statement, so a chain that reads a carry another
statement set fails. The C between the statements (copies, the select,
the loops) is mirrored by hand, and each mirror checks that the routine's
statements are the ones it runs, in order.

Every chain that ends without `.cc` must not carry out of its words (the
header's "Bound (reduction)" lines): the interpreter records a carry or a
borrow that such an instruction drops, and only the two that are meant to
drop one may (`FP_ASM_ADD_P_MASKED`'s sum wraps past 2^384 exactly on a
borrow; the masks come from `subc.u32 x, y, 0`).

Inputs: 0, 1, p - 1, R mod p, p - 2 and values whose words carry or
borrow through every chain, in every pairing, every operand at
p - 1, double-width T just below N p^2 for N = 9 and 19 (and 2^768 - 1 for
the sums), and seeded random values, 2,000 and more in all. Results are
held to Python integers, to the port's plain versions (`fp.mul_plain`,
`addsub_plain`, `mont_reduce_plain`) and, repacked to limbs, to the JAX
package's jitted `fp.mul`, `add`, `sub` and `neg`. A copy of the source
with a carry-in instruction read as its form without the carry must fail.
"""

from __future__ import annotations

import functools
import pathlib
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.jax_backend import fp as jfp
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as tfp

M32 = (1 << 32) - 1
W = 12
R_MONT = (1 << 384) % P
R_INV = pow(1 << 384, -1, P)
SOURCE = (pathlib.Path(tfp.__file__).parent / "csrc" / "fp384.cuh").read_text()
ROUTINES = ("fp_reduce_once", "fp_mul", "fp_add", "fp_sub", "fp_neg", "fp_mul_wide", "fp_add_wide",
            "fp_mac_wide", "fp_redc_wide")
# the instructions whose dropped carry or borrow is the point
DROPS_ALLOWED = {("FP_ASM_ADD_P_MASKED", 23), ("FP_ASM_SUB_P", 12), ("FP_ASM_SUB12", 12)}


# -- reading the source -----------------------------------------------------------


def _macro_bodies(src: str) -> dict[str, str]:
    """Every `#define NAME ...` and `#define NAME(x, ...) ...` with its
    continuation lines, the backslash-newlines removed."""
    out = {}
    for m in re.finditer(r"^#define (\w+(?:\([\w, ]+\))?)[ \t]*((?:.*\\\n)*.*)$", src, re.M):
        out[m.group(1)] = re.sub(r"\\\n", " ", m.group(2))
    return out


def _operand(tok: str):
    """An instruction operand: ('op', n) for %n, ('imm', v), ('reg', name)."""
    if tok.startswith("%"):
        return ("op", int(tok[1:]))
    if re.fullmatch(r"0x[0-9a-fA-F]+|\d+", tok):
        return ("imm", int(tok, 0))
    return ("reg", tok)


def parse_chain(body: str) -> list[tuple]:
    """A chain macro's string literals -> [(opcode, dest, sources)]."""
    text = "".join(bytes(s, "ascii").decode("unicode_escape") for s in re.findall(r'"((?:[^"\\]|\\.)*)"', body))
    instrs = []
    for stmt in text.replace("{", ";").replace("}", ";").split(";"):
        stmt = stmt.strip()
        if not stmt or stmt.startswith(".reg"):
            continue
        op, rest = stmt.split(None, 1)
        args = [_operand(t.strip()) for t in rest.split(",")]
        instrs.append((op, args[0], args[1:]))
    return instrs


@functools.lru_cache(maxsize=None)
def chains(src: str = SOURCE) -> dict[str, list[tuple]]:
    return {k: parse_chain(v) for k, v in _macro_bodies(src).items() if k.startswith("FP_ASM_")}


def _function_body(src: str, name: str) -> str:
    m = re.search(rf"\bvoid {name}\(", src)
    assert m, f"{name} not found in fp384.cuh"
    i = src.index("{", m.end())
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i + 1:j]
    raise AssertionError(f"{name}'s body does not close")


def _split_operands(text: str, macros: dict[str, str]) -> list[tuple[str, str]]:
    """`"+r"(e[0]), FP_R12(o), ...` -> [(constraint, expression)], the
    operand macros expanded."""
    funcs = {k.split("(")[0]: ([a.strip() for a in k[k.index("(") + 1:-1].split(",")], v)
             for k, v in macros.items() if "(" in k}

    def expand(m):
        params, body = funcs[m.group(1)]
        args = [a.strip() for a in m.group(2).split(",")]
        assert len(args) == len(params), m.group(0)
        bind = dict(zip(params, args))
        return re.sub(r"\b(" + "|".join(params) + r")\b", lambda p: bind[p.group(1)], body)

    for _ in range(4):
        text = re.sub(r"\b(FP_\w+)\(([^()]*)\)", lambda m: expand(m) if m.group(1) in funcs else m.group(0), text)
    items, pos = [], 0
    for m in re.finditer(r'"([=+]?r)"\(', text):
        if m.start() < pos:
            continue
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[j], 0)
            j += 1
        items.append((m.group(1), text[m.end():j - 1].strip()))
        pos = j
    return items


@functools.lru_cache(maxsize=None)
def statements(src: str, name: str) -> list[tuple[str, list, list]]:
    """Routine `name`'s asm statements in order: (chain macro, outputs, inputs)."""
    macros = _macro_bodies(src)
    out = []
    for m in re.finditer(r"\basm\((FP_ASM_\w+)\s*:(.*?)\);", _function_body(src, name), re.S):
        parts = m.group(2).split(":")
        outs = _split_operands(parts[0], macros)
        ins = _split_operands(parts[1], macros) if len(parts) > 1 else []
        out.append((m.group(1), outs, ins))
    return out


# -- the interpreter --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lvalue(expr: str):
    """An operand's lvalue, compiled: (None, its name) for a scalar, else
    (the expression of the list holding it, that of its index)."""
    expr = expr.strip()
    if re.fullmatch(r"\w+", expr):
        return None, expr
    assert expr.endswith("]"), f"cannot bind {expr!r}"
    depth = 0
    for j in range(len(expr) - 1, -1, -1):
        depth += {"]": 1, "[": -1}.get(expr[j], 0)
        if depth == 0:
            break
    return compile(expr[:j], "<operand>", "eval"), compile(expr[j + 1:-1], "<operand>", "eval")


class Drop(AssertionError):
    """A chain that ends without `.cc` lost a carry or a borrow."""


def run_chain(name: str, instrs, ops: list, drops: list) -> None:
    """Run one asm statement's instructions on operand values `ops` (None
    for an output not yet written), in place."""
    regs: dict[str, int] = {}
    cf = None  # the carry flag: undefined at the start of every statement

    def val(a):
        kind, x = a
        if kind == "imm":
            return x
        v = ops[x] if kind == "op" else regs[x]
        assert v is not None, f"{name} reads {a} before it is written"
        return v

    def cin():
        assert cf is not None, f"{name} reads a carry flag it did not set"
        return cf

    for k, (op, dest, srcs) in enumerate(instrs):
        parts = op.split(".")
        base, cc = parts[0], ".cc" in op
        a, b = val(srcs[0]), val(srcs[1])
        if base in ("add", "addc"):
            s = a + b + (cin() if base == "addc" else 0)
            carry = s >> 32
        elif base in ("sub", "subc"):
            s = a - b - (cin() if base == "subc" else 0)
            carry = 1 if s < 0 else 0
        elif base in ("mad", "madc"):
            prod = a * b
            half = prod & M32 if parts[1] == "lo" else prod >> 32
            s = half + val(srcs[2]) + (cin() if base == "madc" else 0)
            carry = s >> 32
        elif base == "mul":
            s, carry = (a * b) & M32 if parts[1] == "lo" else (a * b) >> 32, 0
        elif base == "and":
            s, carry = a & b, 0
        else:
            raise AssertionError(f"{name}: {op} is not in the interpreter's subset")
        if cc:
            cf = carry
        elif carry and base != "mul" and (name, k) not in DROPS_ALLOWED:
            raise Drop(f"{name} instruction {k} ({op}) drops a carry")
        elif carry:
            drops.append((name, k))
        if dest[0] == "op":
            ops[dest[1]] = s & M32
        else:
            regs[dest[1]] = s & M32


class Replay:
    """Runs a routine's statements (read from `src`) over an environment of
    Python lists and ints, as the C binds them."""

    def __init__(self, src: str, name: str):
        self.chains = chains(src)
        self.stmts = statements(src, name)
        self.name = name
        self.ran: list[str] = []
        self.drops: list = []

    def run(self, k: int, env: dict) -> None:
        chain, outs, ins = self.stmts[k]
        self.ran.append(chain)
        scope = {**env, "FP_WORDS": W, "FP_WIDE": 2 * W}
        refs = []
        for c, expr in outs + ins:
            box, idx = _lvalue(expr)
            refs.append((c, None if box is None else eval(box, {"__builtins__": {}}, scope),
                         idx if box is None else eval(idx, {"__builtins__": {}}, scope)))
        ops = [None if c == "=r" else (env[idx] if box is None else box[idx]) for c, box, idx in refs]
        run_chain(chain, self.chains[chain], ops, self.drops)
        for (c, box, idx), v in zip(refs, ops):
            if c in ("=r", "+r"):
                if box is None:
                    env[idx] = v
                else:
                    box[idx] = v

    def check_order(self, expected: list[str]) -> None:
        """The routine's statements are the chains the mirror ran, in order."""
        assert [s[0] for s in self.stmts] == expected, (self.name, [s[0] for s in self.stmts])


def _words(x: int, n: int = W) -> list[int]:
    return [(x >> (32 * i)) & M32 for i in range(n)]


def _val(ws) -> int:
    return sum(v << (32 * i) for i, v in enumerate(ws))


# -- the routines, as the C binds them --------------------------------------------


def reduce_once(src, t: list, top: int, bound_check=True):
    """fp_reduce_once(r, t, top): r = t - p or t."""
    rp = Replay(src, "fp_reduce_once")
    rp.check_order(["FP_ASM_SUB_P"])
    env = {"t": list(t), "top": top, "d": [None] * W, "keep": None}
    rp.run(0, env)
    if bound_check:
        assert _val(t) + (top << 384) < 2 * P, "fp_reduce_once's input is not below 2p"
    return [env["t"][i] if env["keep"] == M32 else env["d"][i] for i in range(W)]


def _rows(i: int) -> dict:
    """Row i's accumulators: x = i & 1 takes the pairs from position i."""
    return {"i": i, "x": i & 1, "y": (i & 1) ^ 1}


def _zeros():
    return [[0] * (2 * W + 1) for _ in range(2)]


def _top_words_clear(z, lo: int) -> None:
    """No accumulator word past the value's top is nonzero."""
    assert all(v == 0 for row in z for v in row[lo:]), "a word past the value's top is set"


def mul(src, a: int, b: int) -> int:
    rp = Replay(src, "fp_mul")
    rp.check_order(["FP_ASM_HALF_MUL", "FP_ASM_HALF_MUL", "FP_ASM_FOLD_RED", "FP_ASM_RED",
                    "FP_ASM_ROW", "FP_ASM_ROW", "FP_ASM_FOLD_RED", "FP_ASM_RED", "FP_ASM_ADD12_CARRY"])
    env = {"a": _words(a), "b": _words(b), "z": _zeros(), "m": None, "s": [None] * W}
    for k in range(4):
        rp.run(k, env)
    for i in range(1, W):
        env.update(_rows(i))
        for k in range(4, 8):
            rp.run(k, env)
        # CIOS: the value at positions i + 1 on is below 2p after every row
        z = env["z"]
        assert sum((z[0][k] + z[1][k]) << (32 * (k - i - 1)) for k in range(i + 1, 2 * W + 1)) < 2 * P
        _top_words_clear(z, i + 13)
    z = env["z"]
    env["top"] = (z[0][2 * W] + z[1][2 * W]) & M32
    rp.run(8, env)
    return _val(reduce_once(src, z[0][W:2 * W], env["top"]))


def add(src, a: int, b: int) -> int:
    rp = Replay(src, "fp_add")
    rp.check_order(["FP_ASM_ADD12"])
    env = {"s": _words(a), "b": _words(b)}
    rp.run(0, env)
    return _val(reduce_once(src, env["s"], 0))


def sub(src, a: int, b: int) -> int:
    rp = Replay(src, "fp_sub")
    rp.check_order(["FP_ASM_SUB12", "FP_ASM_ADD_P_MASKED"])
    env = {"d": _words(a), "b": _words(b), "mask": None}
    rp.run(0, env)
    rp.run(1, env)
    # the sum wraps past 2^384 exactly when p was added
    assert rp.drops == ([("FP_ASM_SUB12", 12), ("FP_ASM_ADD_P_MASKED", 23)] if a < b else [])
    return _val(env["d"])


def neg(src, a: int) -> int:
    rp = Replay(src, "fp_neg")
    rp.check_order(["FP_ASM_NEG_MASKED"])
    env = {"r": [None] * W, "a": _words(a), "mask": M32 if a else 0}
    rp.run(0, env)
    return _val(env["r"])


def mul_wide(src, a: int, b: int) -> int:
    rp = Replay(src, "fp_mul_wide")
    rp.check_order(["FP_ASM_HALF_MUL", "FP_ASM_HALF_MUL", "FP_ASM_ROW", "FP_ASM_FOLD_ROW", "FP_ASM_ADD12"])
    env = {"a": _words(a), "b": _words(b), "r": [None] * 24, "z": _zeros()}
    rp.run(0, env)
    rp.run(1, env)
    env["r"][0] = env["z"][0][0]
    for i in range(1, W):
        env.update(_rows(i))
        rp.run(2, env)
        rp.run(3, env)
        env["r"][i] = env["z"][env["x"]][i]
        _top_words_clear(env["z"], i + 13)
    rp.run(4, env)
    _top_words_clear(env["z"], 2 * W)
    env["r"][W:] = env["z"][0][W:2 * W]
    return _val(env["r"])


def add_wide(src, t: int, x: int) -> int:
    rp = Replay(src, "fp_add_wide")
    rp.check_order(["FP_ASM_ADD12_CARRY", "FP_ASM_ADD12_CARRY_IN"])
    env = {"t": _words(t, 24), "x": _words(x, 24), "c": 0}
    rp.run(0, env)
    rp.run(1, env)
    return _val(env["t"])


def mac_wide(src, t: int, a: int, b: int) -> int:
    rp = Replay(src, "fp_mac_wide")
    rp.check_order(["FP_ASM_ROW", "FP_ASM_HALF_MUL", "FP_ASM_ROW", "FP_ASM_FOLD_ROW", "FP_ASM_ADD12", "FP_ASM_ADD12"])
    env = {"t": _words(t, 24), "a": _words(a), "b": _words(b), "z": _zeros()}
    env["z"][0][:W] = env["t"][:W]
    rp.run(0, env)
    rp.run(1, env)
    env["t"][0] = env["z"][0][0]
    for i in range(1, W):
        env.update(_rows(i))
        rp.run(2, env)
        rp.run(3, env)
        env["t"][i] = env["z"][env["x"]][i]
        _top_words_clear(env["z"], i + 13)
    _top_words_clear(env["z"], 2 * W)
    rp.run(4, env)
    rp.run(5, env)
    return _val(env["t"])


def redc_wide(src, t: int, subs: int) -> int:
    rp = Replay(src, "fp_redc_wide")
    rp.check_order(["FP_ASM_REDC_ODD_FIRST", "FP_ASM_RED", "FP_ASM_FOLD_RED", "FP_ASM_RED", "FP_ASM_ADD12_CARRY",
                    "FP_ASM_ADD12_CARRY"])
    env = {"t": _words(t, 24), "z": _zeros(), "m": None, "s": [None] * W}
    env["z"][0][:W] = env["t"][:W]
    rp.run(0, env)
    rp.run(1, env)
    for i in range(1, W):
        env.update(_rows(i))
        rp.run(2, env)
        rp.run(3, env)
        _top_words_clear(env["z"], i + 13)
    z = env["z"]
    env["top"] = (z[0][2 * W] + z[1][2 * W]) & M32
    rp.run(4, env)
    rp.run(5, env)
    assert env["top"] == 0, "the reduced value left 12 words"
    r = reduce_once(src, z[0][W:2 * W], 0, bound_check=False)
    for _ in range(1, subs):
        r = reduce_once(src, r, 0, bound_check=False)
    return _val(r)


# -- inputs -------------------------------------------------------------------------

# 0, 1, p - 1, R mod p, p - 2, and values whose words carry or borrow
# through every chain: all ones below p's top word, p's words less one
EDGE = [0, 1, P - 1, R_MONT, P - 2, (1 << 352) - 1, (1 << 380) - 1, P - (1 << 352) - 1]
N_RANDOM = 320  # per routine: 9 x 320 = 2,880 random cases
PP = P * P


def _pairs(seed: int) -> list[tuple[int, int]]:
    rng = random.Random(seed)
    return [(x, y) for x in EDGE for y in EDGE] + [(rng.randrange(P), rng.randrange(P)) for _ in range(N_RANDOM)]


def _redc_inputs(seed: int) -> list[tuple[int, int]]:
    """(T, SUBS): T at the edges of N p^2 for N = 1, 9 (SUBS 1) and 19
    (SUBS 2), sums of N products of p - 1, and random T below N p^2."""
    rng = random.Random(seed)
    cases = [(0, 1), (1, 1), (PP - 1, 1), (9 * PP - 1, 1), (9 * (P - 1) ** 2, 1), (9 * PP - 1, 2),
             (19 * PP - 1, 2), (19 * (P - 1) ** 2, 2), (R_MONT * R_MONT, 1), (P << 384, 1)]
    for _ in range(N_RANDOM):
        n = rng.choice((1, 2, 4, 9, 12, 19))
        cases.append((rng.randrange(n * PP), 1 if n <= 9 else 2))
    return cases


def _wide_inputs(seed: int) -> list[tuple[int, int]]:
    """(t, x) pairs for fp_add_wide whose sum stays below 2^768."""
    rng = random.Random(seed)
    top = (1 << 768) - 1
    cases = [(0, 0), (top, 0), (0, top), (top - (1 << 384), 1 << 384), ((1 << 384) - 1, 1), (9 * PP, 10 * PP)]
    for _ in range(N_RANDOM):
        t = rng.randrange(1 << 768)
        cases.append((t, rng.randrange((1 << 768) - t)))
    return cases


def _mac_inputs(seed: int) -> list[tuple[int, int, int]]:
    """(t, a, b): t a sum of up to 18 products, a, b canonical."""
    rng = random.Random(seed)
    cases = [(0, x, y) for x, y in _pairs(seed)[:len(EDGE) ** 2]]
    cases += [(18 * (P - 1) ** 2, P - 1, P - 1), ((1 << 768) - 1 - (P - 1) ** 2, P - 1, P - 1)]
    for _ in range(N_RANDOM):
        cases.append((rng.randrange(rng.choice((1, 8, 18)) * PP), rng.randrange(P), rng.randrange(P)))
    return cases


# -- the per-routine cases ----------------------------------------------------------


def _replay_all(src: str, routine: str) -> list[tuple]:
    """(got, want) for every input of `routine`, replayed from `src`."""
    out = []
    if routine == "fp_reduce_once":
        rng = random.Random(41)
        vals = [(0, 0), (1, 0), (P - 1, 0), (P, 0), (P + 1, 0), (2 * P - 1, 0)]
        vals += [(v, 0) for v in (rng.randrange(2 * P) for _ in range(N_RANDOM))]
        for v, top in vals:
            out.append((_val(reduce_once(src, _words(v), top)), v - P if v >= P else v))
        # a top word takes the subtraction whatever the low words (outside
        # the 2p contract, which no caller reaches: the words wrap)
        for v in (0, P - 1, (1 << 384) - 1, rng.randrange(1 << 384)):
            out.append((_val(reduce_once(src, _words(v), 1, bound_check=False)), (v + (1 << 384) - P) & ((1 << 384) - 1)))
    elif routine in ("fp_mul", "fp_add", "fp_sub"):
        fn, ref = {"fp_mul": (mul, lambda x, y: x * y * R_INV % P), "fp_add": (add, lambda x, y: (x + y) % P),
                   "fp_sub": (sub, lambda x, y: (x - y) % P)}[routine]
        out = [(fn(src, x, y), ref(x, y)) for x, y in _pairs(ROUTINES.index(routine))]
    elif routine == "fp_neg":
        rng = random.Random(43)
        out = [(neg(src, x), -x % P) for x in EDGE + [rng.randrange(P) for _ in range(N_RANDOM)]]
    elif routine == "fp_mul_wide":
        out = [(mul_wide(src, x, y), x * y) for x, y in _pairs(44)]
    elif routine == "fp_add_wide":
        out = [(add_wide(src, t, x), t + x) for t, x in _wide_inputs(45)]
    elif routine == "fp_mac_wide":
        out = [(mac_wide(src, t, x, y), t + x * y) for t, x, y in _mac_inputs(46)]
    else:
        out = [(redc_wide(src, t, subs), t * R_INV % P) for t, subs in _redc_inputs(47)]
    return out


@pytest.mark.parametrize("routine", ROUTINES)
def test_chain_replay_matches_python_integers(routine):
    """Each routine's chains, read from fp384.cuh and interpreted, give the
    integer result on edge and random inputs with no carry dropped."""
    cases = _replay_all(SOURCE, routine)
    bad = [(g, w) for g, w in cases if g != w]
    assert not bad, f"{routine}: {len(bad)} of {len(cases)} cases differ"


def test_the_source_holds_every_routine_and_chain():
    """The nine routines exist, each runs only PTX chains (no 64-bit
    accumulator), and every chain macro is used and parses into the
    interpreter's subset."""
    got = chains()
    assert got and all(got.values()), "a chain macro is missing or empty"
    used = set()
    for name in ROUTINES:
        body = _function_body(SOURCE, name)
        assert "uint64_t" not in body, f"{name} still uses a 64-bit accumulator"
        stmts = statements(SOURCE, name)
        assert stmts, f"{name} runs no chain"
        used |= {s[0] for s in stmts}
    assert used == set(got), set(got) ^ used
    ops = {i[0] for c in got.values() for i in c}
    assert ops <= {"add.cc.u32", "addc.cc.u32", "addc.u32", "sub.cc.u32", "subc.cc.u32", "subc.u32",
                   "mad.lo.cc.u32", "madc.lo.cc.u32", "madc.hi.cc.u32", "madc.hi.u32", "mul.lo.u32",
                   "mul.hi.u32", "and.b32"}, ops
    # p's words and -p^-1 as the chains' immediates
    imms = {a[1] for c in got.values() for i in c for a in i[2] if a[0] == "imm"}
    assert {(P >> (32 * k)) & M32 for k in range(W)} | {tfp.P_INV32} <= imms


def _mutations():
    """(routine, chain, instruction index): every carry-in instruction of
    every chain a routine runs, read without its carry in."""
    cases = []
    for name in ROUTINES:
        for chain in dict.fromkeys(s[0] for s in statements(SOURCE, name)):
            instrs = chains()[chain]
            ks = [k for k, ins in enumerate(instrs) if ins[0].split(".")[0] in ("addc", "subc", "madc")]
            if ks:
                cases.append((name, chain, ks[0]))
    return cases


@pytest.mark.parametrize("routine,chain,k", _mutations())
def test_a_dropped_carry_in_is_caught(routine, chain, k):
    """Against vacuity: a copy of fp384.cuh whose chain reads one carry-in
    instruction (the first of `chain`) without the carry (`addc.cc` as
    `add.cc`, `madc` as `mad`, `subc` as `sub`) fails the replay."""
    lines = SOURCE.split("\n")
    start = next(i for i, l in enumerate(lines) if l.startswith(f"#define {chain} "))
    seen = -1
    for i in range(start + 1, len(lines)):
        m = re.match(r'(\s*")(\w+)(\.)', lines[i])
        if m and not lines[i].strip().startswith('".reg'):
            seen += 1
            if seen == k:
                op = m.group(2)
                assert op in ("addc", "subc", "madc")
                lines[i] = lines[i].replace(f'"{op}.', f'"{op[:-1]}.', 1)
                break
    broken = "\n".join(lines)
    assert chains(broken)[chain][k][0] == chains()[chain][k][0].replace("c.", ".", 1)
    try:
        cases = _replay_all(broken, routine)
    except AssertionError:
        return  # a dropped carry, a bound or an order check fired
    assert any(g != w for g, w in cases), f"{routine}: the copy with {chain}[{k}] broken still passes"


def test_bound_lines_hold_on_all_p_minus_1():
    """K1's and K2's "Bound (reduction)" lines on all-(p - 1) operands: the
    CIOS running value stays below 2p (one subtraction), a + b < 2p, the
    difference's borrow adds p back once, -a stays in (0, p), and the
    double-width routines carry nothing out of 24 words."""
    q = P - 1
    assert mul(SOURCE, q, q) == q * q * R_INV % P
    assert add(SOURCE, q, q) == (2 * q) % P and 2 * q < 2 * P < 1 << 382
    assert sub(SOURCE, 0, q) == 1 and sub(SOURCE, q, q) == 0
    assert neg(SOURCE, q) == 1 and neg(SOURCE, 0) == 0
    assert mul_wide(SOURCE, q, q) == q * q
    assert mac_wide(SOURCE, 18 * q * q, q, q) == 19 * q * q
    assert redc_wide(SOURCE, 9 * q * q, 1) == 9 * q * q * R_INV % P
    assert redc_wide(SOURCE, 19 * q * q, 2) == 19 * q * q * R_INV % P
    # fp_reduce_once's contract: t < 2p; at 2p - 1 one subtraction suffices
    assert _val(reduce_once(SOURCE, _words(2 * P - 1), 0)) == P - 1
    # where one subtraction is not enough: redc<1> above 9 p^2
    assert redc_wide(SOURCE, 19 * q * q, 1) != 19 * q * q * R_INV % P


@functools.lru_cache(maxsize=None)
def _jax_ops():
    return jax.jit(lambda a, b: (jfp.mul(a, b), jfp.add(a, b), jfp.sub(a, b), jfp.neg(a)))


def test_replay_matches_plain_versions_and_jax():
    """The replayed K1 and K2 routines against the port's plain versions
    and, repacked, the JAX package's jitted `fp.mul`, `add`, `sub`, `neg`
    (on stored values, as the kernels see them); and the replayed
    fp_redc_wide against `fp.mont_reduce_plain`."""
    pairs = _pairs(48)[:len(EDGE) ** 2 + 64]
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    got = {
        "mul": [mul(SOURCE, x, y) for x, y in pairs],
        "add": [add(SOURCE, x, y) for x, y in pairs],
        "sub": [sub(SOURCE, x, y) for x, y in pairs],
        "neg": [neg(SOURCE, x) for x in xs],
    }
    a, b = torch.from_numpy(tfp.ints_to_words(xs)), torch.from_numpy(tfp.ints_to_words(ys))
    plain = {"mul": tfp.mul_plain(a, b), "add": tfp.addsub_plain(a, b, 0), "sub": tfp.addsub_plain(a, b, 1),
             "neg": tfp.addsub_plain(a, None, 2)}
    jax_out = dict(zip(("mul", "add", "sub", "neg"),
                       _jax_ops()(jnp.asarray(jfp.ints_to_limbs(xs)), jnp.asarray(jfp.ints_to_limbs(ys)))))
    for op, vals in got.items():
        words = torch.from_numpy(tfp.ints_to_words(vals))
        assert torch.equal(words, plain[op]), op
        assert np.array_equal(tfp.to_jax_limbs(words), np.asarray(jax_out[op])), op
    ts = [t for t, subs in _redc_inputs(49) if t < P << 384][:64]
    want = tfp.mont_reduce_plain(torch.from_numpy(np.stack([np.array(_words(t, 24), dtype=np.uint32).view(np.int32)
                                                            for t in ts])))
    assert [redc_wide(SOURCE, t, 2) for t in ts] == [tfp.words_to_int(w) for w in want]


def _probe(name: str):
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_probes" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probes_reach_every_routine():
    """chip_probes/fp_chain_latency.py builds a chain and a one-call kernel
    for the routines, and chip_probes/fp_call_counts.py puts one counter at
    the top of each routine's body (fp_inv's too)."""
    lat = _probe("fp_chain_latency")
    src = lat.probe_source()
    for call in ("fp_mul(", "fp_mul_wide(", "fp_redc_wide<1>(", "fp_mac_wide(", "fp_redc_wide<2>(", "fp_add(",
                 "fp_sub(", "fp_neg(", "fp_reduce_once(", "fp_add_wide("):
        assert call in src, call
    assert src.count("__global__") == len(lat.CASES) + len(lat.ONCE)
    cnt = _probe("fp_call_counts")
    stamped = cnt.stamped_header(SOURCE)
    for k, name in enumerate(cnt.ROUTINES):
        body = _function_body(stamped, name)
        assert body.lstrip().startswith(f"FP_COUNT({k});"), name
    assert "lh_fp_calls_fp_kernels" in cnt.stamped_unit("", "fp_kernels")


def test_k1_k2_headers_state_their_reduction_bound():
    """fp_kernels.cu's K1 and K2 headers each carry a "Bound (reduction)"
    line (the one test_bound_lines_hold_on_all_p_minus_1 checks) and name
    the carry chains they run on."""
    src = (pathlib.Path(tfp.__file__).parent / "csrc" / "fp_kernels.cu").read_text()
    k1 = src[src.index("// K1 fp_mul_kernel"):src.index("// K2 fp_addsub_kernel")]
    k2 = src[src.index("// K2 fp_addsub_kernel"):src.index("// K3 fp_pow_kernel")]
    for block in (k1, k2):
        assert "Bound (reduction)" in block and "chain" in block
