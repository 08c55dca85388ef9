"""Eth2 Beacon-API JSON encoding of SSZ values.

The wire conventions of lighthouse/consensus/serde_utils +
common/eth2's typed client: integers as decimal strings, byte blobs as
0x-hex, bitfields as 0x-hex of their SSZ encoding, containers as objects.
Driven by the same type descriptors the SSZ layer uses, so any container
round-trips without per-type code.
"""

from __future__ import annotations

from ..ssz.types import (
    Bitlist,
    Bitvector,
    ByteList,
    Container,
    List,
    Union,
    Vector,
    _Boolean,
    _ByteVector,
    _UintN,
)


def encode(value, td):
    if isinstance(td, _UintN):
        return str(value)
    if isinstance(td, _Boolean):
        return bool(value)
    if isinstance(td, (_ByteVector, ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(td, (Bitlist, Bitvector)):
        return "0x" + td.serialize(value).hex()
    if isinstance(td, (List, Vector)):
        return [encode(v, td.element) for v in value]
    if isinstance(td, Union):
        sel, inner = value
        opt = td.options[sel]
        return {"selector": str(sel), "value": None if opt is None else encode(inner, opt)}
    if isinstance(td, type) and issubclass(td, Container):
        return {
            name: encode(getattr(value, name), ft)
            for name, ft in zip(td._field_names, td._field_types)
        }
    raise TypeError(f"cannot JSON-encode type descriptor {td!r}")


def decode(obj, td):
    if isinstance(td, _UintN):
        return int(obj)
    if isinstance(td, _Boolean):
        return bool(obj)
    if isinstance(td, (_ByteVector, ByteList)):
        return bytes.fromhex(str(obj).removeprefix("0x"))
    if isinstance(td, (Bitlist, Bitvector)):
        return td.deserialize(bytes.fromhex(str(obj).removeprefix("0x")))
    if isinstance(td, (List, Vector)):
        return [decode(v, td.element) for v in obj]
    if isinstance(td, Union):
        sel = int(obj["selector"])
        opt = td.options[sel]
        return (sel, None if opt is None else decode(obj["value"], opt))
    if isinstance(td, type) and issubclass(td, Container):
        return td(
            **{
                name: decode(obj[name], ft)
                for name, ft in zip(td._field_names, td._field_types)
            }
        )
    raise TypeError(f"cannot JSON-decode type descriptor {td!r}")
