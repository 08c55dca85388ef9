"""SSZ type descriptors: serialization, deserialization, hash_tree_root.

Python rendering of the reference's ssz + ssz_types + tree_hash crates
(lighthouse/consensus/ssz/src/ Encode/Decode,
lighthouse/consensus/ssz_types/src/ FixedVector/VariableList/Bitfield,
lighthouse/consensus/tree_hash/src/ TreeHash). Where Rust uses derive
macros over typenum-parameterized containers, the idiomatic Python shape is
first-class *type descriptor objects*:

    uint64, boolean                          # basic types
    Vector(uint8, 32), List(uint64, 1024)    # homogeneous composites
    Bitvector(64), Bitlist(2048)             # bitfields
    class Foo(Container):                    # heterogeneous containers
        fields = [("slot", uint64), ("root", Bytes32)]

Every descriptor implements:
    is_fixed_size() -> bool
    fixed_size()    -> int          (only when fixed)
    serialize(v)    -> bytes
    deserialize(b)  -> value        (strict: trailing/malformed bytes raise)
    hash_tree_root(v) -> bytes (32)

Deserialization enforces the spec's offset rules (first offset == fixed
length, offsets monotonic, in-bounds) — the same checks the reference's
decoder performs (consensus/ssz/src/decode.rs).
"""

from __future__ import annotations

from .hash import (
    BYTES_PER_CHUNK,
    merkleize,
    mix_in_length,
    mix_in_selector,
    pack_bytes,
)

OFFSET_BYTES = 4


class DeserializationError(ValueError):
    pass


# -- basic types ---------------------------------------------------------------


class _UintN:
    def __init__(self, bits: int):
        self.bits = bits
        self.bytes = bits // 8

    def __repr__(self):
        return f"uint{self.bits}"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.bytes

    def serialize(self, v: int) -> bytes:
        if not 0 <= v < (1 << self.bits):
            raise ValueError(f"uint{self.bits} out of range: {v}")
        return int(v).to_bytes(self.bytes, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.bytes:
            raise DeserializationError(f"uint{self.bits}: wrong length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, v: int) -> bytes:
        return self.serialize(v) + b"\x00" * (BYTES_PER_CHUNK - self.bytes)

    def default(self) -> int:
        return 0


uint8 = _UintN(8)
uint16 = _UintN(16)
uint32 = _UintN(32)
uint64 = _UintN(64)
uint128 = _UintN(128)
uint256 = _UintN(256)


class _Boolean:
    def __repr__(self):
        return "boolean"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return 1

    def serialize(self, v: bool) -> bytes:
        if v not in (True, False, 0, 1):
            raise ValueError("boolean out of range")
        return b"\x01" if v else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise DeserializationError("invalid boolean byte")

    def hash_tree_root(self, v: bool) -> bytes:
        return self.serialize(v) + b"\x00" * 31

    def default(self) -> bool:
        return False


boolean = _Boolean()

_BASIC = (_UintN, _Boolean)


def _is_basic(t) -> bool:
    return isinstance(t, _BASIC)


# -- homogeneous composites ----------------------------------------------------


class Vector:
    """Fixed-length homogeneous sequence (ssz_types::FixedVector)."""

    def __init__(self, element, length: int):
        if length <= 0:
            raise ValueError("Vector length must be positive")
        self.element = element
        self.length = length

    def __repr__(self):
        return f"Vector({self.element!r}, {self.length})"

    def is_fixed_size(self) -> bool:
        return self.element.is_fixed_size()

    def fixed_size(self) -> int:
        return self.element.fixed_size() * self.length

    def serialize(self, v) -> bytes:
        if len(v) != self.length:
            raise ValueError(f"Vector expects {self.length} elements, got {len(v)}")
        return _serialize_sequence(self.element, v)

    def deserialize(self, data: bytes):
        return _deserialize_homogeneous(self.element, data, exact_count=self.length)

    def hash_tree_root(self, v) -> bytes:
        if len(v) != self.length:
            raise ValueError("Vector length mismatch")
        if _is_basic(self.element):
            return merkleize(pack_bytes(b"".join(self.element.serialize(e) for e in v)))
        return merkleize([self.element.hash_tree_root(e) for e in v])

    def default(self):
        return [self.element.default() for _ in range(self.length)]


class List:
    """Variable-length homogeneous sequence with a hashing limit
    (ssz_types::VariableList)."""

    def __init__(self, element, limit: int):
        self.element = element
        self.limit = limit

    def __repr__(self):
        return f"List({self.element!r}, {self.limit})"

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, v) -> bytes:
        if len(v) > self.limit:
            raise ValueError(f"List exceeds limit {self.limit}")
        return _serialize_sequence(self.element, v)

    def deserialize(self, data: bytes):
        out = _deserialize_homogeneous(self.element, data, exact_count=None)
        if len(out) > self.limit:
            raise DeserializationError(f"List exceeds limit {self.limit}")
        return out

    def _chunk_limit(self) -> int:
        if _is_basic(self.element):
            per_chunk = BYTES_PER_CHUNK // self.element.fixed_size()
            return (self.limit + per_chunk - 1) // per_chunk
        return self.limit

    def hash_tree_root(self, v) -> bytes:
        if len(v) > self.limit:
            raise ValueError("List exceeds limit")
        if _is_basic(self.element):
            body = merkleize(
                pack_bytes(b"".join(self.element.serialize(e) for e in v)),
                limit=self._chunk_limit(),
            )
        else:
            body = merkleize(
                [self.element.hash_tree_root(e) for e in v], limit=self._chunk_limit()
            )
        return mix_in_length(body, len(v))

    def default(self):
        return []


def ByteVector(length: int) -> Vector:
    return _ByteVector(length)


class _ByteVector:
    """Vector(uint8, N) specialized to bytes values (common: roots, pubkeys)."""

    def __init__(self, length: int):
        self.length = length

    def __repr__(self):
        return f"ByteVector({self.length})"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.length

    def serialize(self, v: bytes) -> bytes:
        if len(v) != self.length:
            raise ValueError(f"ByteVector expects {self.length} bytes, got {len(v)}")
        return bytes(v)

    def deserialize(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise DeserializationError("ByteVector length mismatch")
        return bytes(data)

    def hash_tree_root(self, v: bytes) -> bytes:
        return merkleize(pack_bytes(self.serialize(v)))

    def default(self) -> bytes:
        return b"\x00" * self.length


class ByteList:
    """List(uint8, N) specialized to bytes values (e.g. graffiti-free
    variable blobs, execution payload transactions)."""

    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"ByteList({self.limit})"

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, v: bytes) -> bytes:
        if len(v) > self.limit:
            raise ValueError("ByteList exceeds limit")
        return bytes(v)

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise DeserializationError("ByteList exceeds limit")
        return bytes(data)

    def hash_tree_root(self, v: bytes) -> bytes:
        chunk_limit = (self.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return mix_in_length(merkleize(pack_bytes(bytes(v)), limit=chunk_limit), len(v))

    def default(self) -> bytes:
        return b""


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


# -- bitfields -----------------------------------------------------------------


class Bitvector:
    def __init__(self, length: int):
        if length <= 0:
            raise ValueError("Bitvector length must be positive")
        self.length = length

    def __repr__(self):
        return f"Bitvector({self.length})"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return (self.length + 7) // 8

    def serialize(self, bits) -> bytes:
        if len(bits) != self.length:
            raise ValueError("Bitvector length mismatch")
        return _bits_to_bytes(bits)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size():
            raise DeserializationError("Bitvector byte length mismatch")
        bits = _bytes_to_bits(data)[: self.length]
        # spec: padding bits beyond `length` must be zero
        if any(_bytes_to_bits(data)[self.length :]):
            raise DeserializationError("Bitvector has set padding bits")
        return bits

    def hash_tree_root(self, bits) -> bytes:
        chunk_limit = (self.length + 255) // 256
        return merkleize(pack_bytes(self.serialize(bits)), limit=chunk_limit)

    def default(self):
        return [False] * self.length


class Bitlist:
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"Bitlist({self.limit})"

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, bits) -> bytes:
        if len(bits) > self.limit:
            raise ValueError("Bitlist exceeds limit")
        # delimiter bit marks the length
        return _bits_to_bytes(list(bits) + [True])

    def deserialize(self, data: bytes):
        if not data:
            raise DeserializationError("Bitlist cannot be empty (delimiter)")
        if data[-1] == 0:
            raise DeserializationError("Bitlist missing delimiter bit")
        bits = _bytes_to_bits(data)
        # strip trailing zeros after the last set bit (the delimiter)
        last = len(bits) - 1 - bits[::-1].index(True)
        out = bits[:last]
        if len(out) > self.limit:
            raise DeserializationError("Bitlist exceeds limit")
        return out

    def hash_tree_root(self, bits) -> bytes:
        if len(bits) > self.limit:
            raise ValueError("Bitlist exceeds limit")
        chunk_limit = (self.limit + 255) // 256
        return mix_in_length(
            merkleize(pack_bytes(_bits_to_bytes(bits)), limit=chunk_limit), len(bits)
        )

    def default(self):
        return []


def _bits_to_bytes(bits) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _bytes_to_bits(data: bytes):
    return [bool((byte >> i) & 1) for byte in data for i in range(8)]


# -- union ---------------------------------------------------------------------


class Union:
    """SSZ Union: 1-byte selector prefix + encoded variant; tree root mixes
    the selector into the variant root (consensus/ssz/src/decode.rs union
    handling; used by the spec's Transaction and fork-multiplexed types).

    `options` is the ordered variant-type list; `None` as option 0 encodes
    the spec's `Union[None, T, ...]` null arm (empty body, zero-hash root).
    Values are (selector, value) pairs."""

    MAX_OPTIONS = 128

    def __init__(self, options: list):
        if not options:
            raise ValueError("Union needs at least one option")
        if len(options) > self.MAX_OPTIONS:
            raise ValueError("Union supports at most 128 options")
        if any(o is None for o in options[1:]):
            raise ValueError("None is only allowed as option 0")
        if options[0] is None and len(options) == 1:
            raise ValueError("Union[None] alone is not allowed")
        self.options = list(options)

    def __repr__(self):
        return f"Union({self.options!r})"

    def is_fixed_size(self) -> bool:
        return False  # selector makes every union variable-size

    def serialize(self, v) -> bytes:
        selector, value = v
        if not 0 <= selector < len(self.options):
            raise ValueError(f"Union selector {selector} out of range")
        opt = self.options[selector]
        if opt is None:
            if value is not None:
                raise ValueError("Union null arm carries no value")
            return bytes([0])
        return bytes([selector]) + opt.serialize(value)

    def deserialize(self, data: bytes):
        if not data:
            raise DeserializationError("Union: empty input")
        selector = data[0]
        if selector >= len(self.options):
            raise DeserializationError(f"Union: invalid selector {selector}")
        opt = self.options[selector]
        if opt is None:
            if len(data) != 1:
                raise DeserializationError("Union: null arm with trailing bytes")
            return (0, None)
        return (selector, opt.deserialize(data[1:]))

    def hash_tree_root(self, v) -> bytes:
        selector, value = v
        if not 0 <= selector < len(self.options):
            raise ValueError(f"Union selector {selector} out of range")
        opt = self.options[selector]
        body = b"\x00" * BYTES_PER_CHUNK if opt is None else opt.hash_tree_root(value)
        return mix_in_selector(body, selector)

    def default(self):
        opt = self.options[0]
        return (0, None if opt is None else opt.default())


# -- containers ----------------------------------------------------------------


class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields = ns.get("fields")
        if fields is not None:
            cls._field_names = [n for n, _ in fields]
            cls._field_types = [t for _, t in fields]
            # Instance-level root caching is SOUND only when every field is
            # an immutable leaf (uint/bool/byte-vector): then the only way
            # to change the value is attribute assignment, which
            # __setattr__ intercepts. Containers holding lists or nested
            # containers can be mutated without touching this instance's
            # attributes, so they stay uncached (cached_tree_hash's dirty
            # tracking, restricted to where Python can see the dirt).
            cls._leaf_cacheable = bool(fields) and all(
                isinstance(t, (_UintN, _Boolean, _ByteVector))
                for t in cls._field_types
            )
            if cls._leaf_cacheable and "__setattr__" not in ns:
                # install the invalidating setattr ONLY on cacheable
                # classes — everything else keeps object.__setattr__ (no
                # per-assignment overhead on the hot non-cached containers)
                def _invalidating_setattr(self, name, value, _set=object.__setattr__):
                    _set(self, name, value)
                    if name != "_root_cache":
                        _set(self, "_root_cache", None)

                cls.__setattr__ = _invalidating_setattr
        return cls


class Container(metaclass=_ContainerMeta):
    """Heterogeneous SSZ container. Subclass with a `fields` list of
    (name, type_descriptor) pairs; instances carry one attribute per field.

    The class itself doubles as its own type descriptor (classmethods), so a
    Container subclass can appear as a field/element type anywhere."""

    fields: list = []

    _leaf_cacheable = False

    def __init__(self, **kwargs):
        for n, t in zip(self._field_names, self._field_types):
            if n in kwargs:
                setattr(self, n, kwargs.pop(n))
            else:
                setattr(self, n, t.default() if hasattr(t, "default") else None)
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n in self._field_names
        )

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._field_names[:4])
        more = "..." if len(self._field_names) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)

    # -- descriptor protocol (classmethods) -----------------------------------

    @classmethod
    def is_fixed_size(cls) -> bool:
        return all(t.is_fixed_size() for t in cls._field_types)

    @classmethod
    def fixed_size(cls) -> int:
        return sum(t.fixed_size() for t in cls._field_types)

    @classmethod
    def serialize(cls, v: "Container") -> bytes:
        fixed_parts: list[bytes] = []
        var_parts: list[bytes] = []
        fixed_len = sum(
            t.fixed_size() if t.is_fixed_size() else OFFSET_BYTES for t in cls._field_types
        )
        offset = fixed_len
        for n, t in zip(cls._field_names, cls._field_types):
            val = getattr(v, n)
            if t.is_fixed_size():
                fixed_parts.append(t.serialize(val))
            else:
                ser = t.serialize(val)
                fixed_parts.append(offset.to_bytes(OFFSET_BYTES, "little"))
                var_parts.append(ser)
                offset += len(ser)
        return b"".join(fixed_parts) + b"".join(var_parts)

    @classmethod
    def deserialize(cls, data: bytes) -> "Container":
        values = {}
        fixed_len = sum(
            t.fixed_size() if t.is_fixed_size() else OFFSET_BYTES for t in cls._field_types
        )
        if len(data) < fixed_len:
            raise DeserializationError(f"{cls.__name__}: too short")
        pos = 0
        offsets: list[tuple[str, int]] = []
        for n, t in zip(cls._field_names, cls._field_types):
            if t.is_fixed_size():
                sz = t.fixed_size()
                values[n] = t.deserialize(data[pos : pos + sz])
                pos += sz
            else:
                off = int.from_bytes(data[pos : pos + OFFSET_BYTES], "little")
                offsets.append((n, off))
                pos += OFFSET_BYTES
        if offsets:
            if offsets[0][1] != fixed_len:
                raise DeserializationError(f"{cls.__name__}: bad first offset")
            bounds = [off for _, off in offsets] + [len(data)]
            for (n, off), end in zip(offsets, bounds[1:]):
                if end < off:
                    raise DeserializationError(f"{cls.__name__}: offsets not monotonic")
                t = dict(zip(cls._field_names, cls._field_types))[n]
                values[n] = t.deserialize(data[off:end])
        elif pos != len(data):
            raise DeserializationError(f"{cls.__name__}: trailing bytes")
        return cls(**values)

    # Root memoization (the role of the reference's cached_tree_hash crate,
    # restructured to stay sound under in-place mutation): subclasses set
    # `root_memo_limit > 0` to memoize hash_tree_root keyed by the value's
    # SERIALIZED BYTES — mutation changes the key, so stale hits are
    # impossible, while unchanged values (the overwhelming case for e.g.
    # Validator records across state copies) skip the merkle work entirely.
    root_memo_limit: int = 0
    _root_memo: dict | None = None

    @classmethod
    def hash_tree_root(cls, v: "Container") -> bytes:
        # fastest path: the instance's dirty-tracked cache (leaf-only
        # containers; __setattr__ invalidates) — no serialization at all
        if cls._leaf_cacheable:
            got = getattr(v, "_root_cache", None)
            if got is not None:
                return got
        memo = None
        key = None
        if cls.root_memo_limit:
            if cls._root_memo is None:
                cls._root_memo = {}
            memo = cls._root_memo
            key = cls.serialize(v)
            got = memo.get(key)
            if got is not None:
                if cls._leaf_cacheable:
                    object.__setattr__(v, "_root_cache", got)
                return got
        roots = [
            t.hash_tree_root(getattr(v, n))
            for n, t in zip(cls._field_names, cls._field_types)
        ]
        root = merkleize(roots)
        if memo is not None:
            if len(memo) >= cls.root_memo_limit:
                memo.clear()  # simple epoch-style reset; refill is cheap
            memo[key] = root
        if cls._leaf_cacheable:
            object.__setattr__(v, "_root_cache", root)
        return root

    @classmethod
    def default(cls) -> "Container":
        return cls()

    # -- convenience instance forms -------------------------------------------

    def encode(self) -> bytes:
        return type(self).serialize(self)

    @property
    def tree_root(self) -> bytes:
        return type(self).hash_tree_root(self)


# -- shared sequence helpers ---------------------------------------------------


def _serialize_sequence(elem, values) -> bytes:
    if elem.is_fixed_size():
        return b"".join(elem.serialize(v) for v in values)
    parts = [elem.serialize(v) for v in values]
    offset = OFFSET_BYTES * len(parts)
    head = []
    for p in parts:
        head.append(offset.to_bytes(OFFSET_BYTES, "little"))
        offset += len(p)
    return b"".join(head) + b"".join(parts)


def _deserialize_homogeneous(elem, data: bytes, exact_count: int | None):
    if elem.is_fixed_size():
        sz = elem.fixed_size()
        if len(data) % sz:
            raise DeserializationError("sequence length not a multiple of element size")
        count = len(data) // sz
        if exact_count is not None and count != exact_count:
            raise DeserializationError(f"expected {exact_count} elements, got {count}")
        return [elem.deserialize(data[i * sz : (i + 1) * sz]) for i in range(count)]
    if not data:
        if exact_count not in (None, 0):
            raise DeserializationError("expected elements, got none")
        return []
    first = int.from_bytes(data[:OFFSET_BYTES], "little")
    if first % OFFSET_BYTES or first > len(data):
        raise DeserializationError("bad first offset")
    count = first // OFFSET_BYTES
    if exact_count is not None and count != exact_count:
        raise DeserializationError(f"expected {exact_count} elements, got {count}")
    offs = [
        int.from_bytes(data[i * OFFSET_BYTES : (i + 1) * OFFSET_BYTES], "little")
        for i in range(count)
    ]
    bounds = offs + [len(data)]
    out = []
    for off, end in zip(offs, bounds[1:]):
        if end < off or off < first:
            raise DeserializationError("offsets not monotonic")
        out.append(elem.deserialize(data[off:end]))
    return out
