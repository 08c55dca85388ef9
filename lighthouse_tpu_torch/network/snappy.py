"""Snappy compression, pure Python: block format + streaming frame format.

The reference's wire encodings depend on snappy twice
(lighthouse/beacon_node/lighthouse_network/src/rpc/codec/,
`rust-snappy` via the `snap` crate):
  - gossip message payloads: snappy BLOCK format
  - Req/Resp response/request payloads: snappy FRAME format (identifier
    chunk + CRC-32C-masked compressed/uncompressed data chunks)

No snappy binding is available in this environment, so both formats are
implemented here from the format descriptions (snappy.txt / framing
format); decompress is format-complete, compress emits spec-valid output
(greedy hash-table matcher, 64 KiB blocks) that any conformant decoder —
including other Ethereum clients — can read.
"""

from __future__ import annotations

import struct

# -- varint --------------------------------------------------------------------


def _uvarint_encode(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _uvarint_decode(data: bytes, pos: int = 0) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise ValueError("varint too long")


# -- block format --------------------------------------------------------------

_MAX_OFFSET = 1 << 15  # compressor emits 2-byte-offset copies only
_MIN_MATCH = 4


def compress_block(data: bytes) -> bytes:
    """Snappy block-format compression: greedy matcher over a 4-byte hash
    table (the classic snappy strategy), literals for the rest."""
    out = bytearray(_uvarint_encode(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)

    table: dict[int, int] = {}
    pos = 0
    literal_start = 0

    def emit_literal(start: int, end: int) -> None:
        nonlocal out
        length = end - start
        while length > 0:
            run = min(length, (1 << 32) - 1)
            if run <= 60:
                out.append((run - 1) << 2)
            elif run < (1 << 8):
                out.append(60 << 2)
                out.append(run - 1)
            elif run < (1 << 16):
                out.append(61 << 2)
                out += struct.pack("<H", run - 1)
            elif run < (1 << 24):
                out.append(62 << 2)
                out += struct.pack("<I", run - 1)[:3]
            else:
                out.append(63 << 2)
                out += struct.pack("<I", run - 1)
            out += data[start : start + run]
            start += run
            length -= run

    def emit_copy(offset: int, length: int) -> None:
        nonlocal out
        # 2-byte-offset copies (tag 10), lengths 4..64 per copy; split long
        # matches so no residue drops below the 4-byte minimum
        while length >= 68:
            out.append((63 << 2) | 0b10)
            out += struct.pack("<H", offset)
            length -= 64
        if length > 64:
            out.append((59 << 2) | 0b10)
            out += struct.pack("<H", offset)
            length -= 60
        out.append(((length - 1) << 2) | 0b10)
        out += struct.pack("<H", offset)

    while pos + _MIN_MATCH <= n:
        key = data[pos : pos + 4]
        candidate = table.get(hash(key))
        table[hash(key)] = pos
        if (
            candidate is not None
            and pos - candidate <= _MAX_OFFSET
            and data[candidate : candidate + 4] == key
        ):
            # extend the match
            match_len = 4
            while (
                pos + match_len < n
                and data[candidate + match_len] == data[pos + match_len]
            ):
                match_len += 1
            if literal_start < pos:
                emit_literal(literal_start, pos)
            emit_copy(pos - candidate, match_len)
            pos += match_len
            literal_start = pos
        else:
            pos += 1
    if literal_start < n:
        emit_literal(literal_start, n)
    return bytes(out)


def decompress_block(data: bytes, max_output: int | None = None) -> bytes:
    """Format-complete snappy block decompression (all tags, all offset
    widths), with an output-size guard for untrusted inputs."""
    expected, pos = _uvarint_decode(data)
    if max_output is not None and expected > max_output:
        raise ValueError(f"snappy: declared size {expected} > cap {max_output}")
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0b00:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise ValueError("snappy: truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise ValueError("snappy: truncated literal")
            out += data[pos : pos + length]
            pos += length
        else:  # copy
            if kind == 0b01:
                if pos >= n:
                    raise ValueError("snappy: truncated copy-1")
                length = ((tag >> 2) & 0b111) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 0b10:
                if pos + 2 > n:
                    raise ValueError("snappy: truncated copy-2")
                length = (tag >> 2) + 1
                offset = struct.unpack_from("<H", data, pos)[0]
                pos += 2
            else:
                if pos + 4 > n:
                    raise ValueError("snappy: truncated copy-4")
                length = (tag >> 2) + 1
                offset = struct.unpack_from("<I", data, pos)[0]
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError("snappy: invalid copy offset")
            # overlapping copies are legal and byte-serial
            start = len(out) - offset
            for i in range(length):
                out.append(out[start + i])
        if len(out) > expected:
            raise ValueError("snappy: output exceeds declared size")
    if len(out) != expected:
        raise ValueError(f"snappy: output {len(out)} != declared {expected}")
    return bytes(out)


# -- CRC-32C (Castagnoli), table-driven ----------------------------------------

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """The framing format's masked CRC-32C."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- frame format --------------------------------------------------------------

_STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_STREAM_ID = 0xFF
_MAX_FRAME_DATA = 65536


def compress_frames(data: bytes) -> bytes:
    """Snappy framing-format stream: identifier + one chunk per <=64 KiB
    block (compressed if it shrinks, uncompressed otherwise)."""
    out = bytearray(_STREAM_IDENTIFIER)
    for i in range(0, len(data), _MAX_FRAME_DATA):
        block = data[i : i + _MAX_FRAME_DATA]
        crc = _masked_crc(block)
        comp = compress_block(block)
        if len(comp) < len(block):
            body = struct.pack("<I", crc) + comp
            out.append(_CHUNK_COMPRESSED)
        else:
            body = struct.pack("<I", crc) + block
            out.append(_CHUNK_UNCOMPRESSED)
        out += struct.pack("<I", len(body))[:3]
        out += body
    if not data:
        # zero-length payload: identifier only is legal, but emit one empty
        # uncompressed chunk so readers expecting >= 1 data chunk terminate
        crc = _masked_crc(b"")
        body = struct.pack("<I", crc)
        out.append(_CHUNK_UNCOMPRESSED)
        out += struct.pack("<I", len(body))[:3]
        out += body
    return bytes(out)


def decompress_frames(data: bytes, max_output: int | None = None) -> bytes:
    """Decode a framing-format stream (identifier, compressed, uncompressed,
    padding, reserved-skippable chunks), verifying masked CRCs."""
    pos = 0
    out = bytearray()
    seen_identifier = False
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise ValueError("snappy-frame: truncated chunk header")
        chunk_type = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + length > n:
            raise ValueError("snappy-frame: truncated chunk body")
        body = data[pos : pos + length]
        pos += length
        if chunk_type == _CHUNK_STREAM_ID:
            if body != _STREAM_IDENTIFIER[4:]:
                raise ValueError("snappy-frame: bad stream identifier")
            seen_identifier = True
        elif chunk_type == _CHUNK_COMPRESSED:
            if not seen_identifier:
                raise ValueError("snappy-frame: data before identifier")
            crc = struct.unpack_from("<I", body)[0]
            block = decompress_block(body[4:], max_output=_MAX_FRAME_DATA)
            if _masked_crc(block) != crc:
                raise ValueError("snappy-frame: CRC mismatch")
            out += block
        elif chunk_type == _CHUNK_UNCOMPRESSED:
            if not seen_identifier:
                raise ValueError("snappy-frame: data before identifier")
            crc = struct.unpack_from("<I", body)[0]
            block = body[4:]
            if _masked_crc(block) != crc:
                raise ValueError("snappy-frame: CRC mismatch")
            out += block
        elif 0x80 <= chunk_type <= 0xFD:
            continue  # reserved skippable
        elif chunk_type == 0xFE:
            continue  # padding
        else:
            raise ValueError(f"snappy-frame: reserved unskippable chunk {chunk_type:#x}")
        if max_output is not None and len(out) > max_output:
            raise ValueError("snappy-frame: output exceeds cap")
    return bytes(out)
