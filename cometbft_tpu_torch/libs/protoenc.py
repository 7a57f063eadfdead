"""Minimal protobuf (proto3) wire-format encoders, and the decoder of
field lists.

The encoders the canonical sign bytes and ``types/codec`` need
(reference: types/canonical.go:57 — votes are signed over a deterministic
protobuf encoding, so byte-stable encoding is consensus-critical), and the
decoders: ``iter_fields`` for the codec and the stores, ``fields_dict``,
which the SecretConnection handshake reads its peer's AuthSig with.

proto3 semantics: scalar fields equal to their zero value are omitted.
"""

from __future__ import annotations

# Wire types
VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5


def uvarint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uvarint requires n >= 0")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return uvarint((field << 3) | wire)


def t_varint(field: int, value: int) -> bytes:
    """int64/uint64 varint field; omitted when zero.  Negative values use the
    proto3 int64 two's-complement 10-byte encoding."""
    if value == 0:
        return b""
    if value < 0:
        value &= (1 << 64) - 1
    return tag(field, VARINT) + uvarint(value)


def t_sfixed64(field: int, value: int) -> bytes:
    if value == 0:
        return b""
    return tag(field, FIXED64) + (value & ((1 << 64) - 1)).to_bytes(8, "little")


def t_bytes(field: int, value: bytes) -> bytes:
    if not value:
        return b""
    return tag(field, BYTES) + uvarint(len(value)) + value


def t_string(field: int, value: str) -> bytes:
    return t_bytes(field, value.encode())


def t_message(field: int, encoded: bytes, *, always: bool = False) -> bytes:
    """Embedded message; omitted when empty unless ``always`` (present-but-
    empty submessages are meaningful in canonical encodings)."""
    if not encoded and not always:
        return b""
    return tag(field, BYTES) + uvarint(len(encoded)) + encoded


def length_prefixed(encoded: bytes) -> bytes:
    """protoio delimited framing: uvarint length prefix (reference:
    libs/protoio — sign bytes are the delimited encoding)."""
    return uvarint(len(encoded)) + encoded


def decode_uvarint(data: bytes, pos: int = 0) -> tuple[int, int]:
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
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a proto message body:
    an int for VARINT, bytes for BYTES, a little-endian int for FIXED64 and
    FIXED32."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = decode_uvarint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == VARINT:
            value, pos = decode_uvarint(data, pos)
        elif wire == BYTES:
            ln, pos = decode_uvarint(data, pos)
            if pos + ln > n:
                raise ValueError("truncated bytes field")
            value = data[pos : pos + ln]
            pos += ln
        elif wire in (FIXED64, FIXED32):
            width = 8 if wire == FIXED64 else 4
            if pos + width > n:
                raise ValueError("truncated fixed field")
            value = int.from_bytes(data[pos : pos + width], "little")
            pos += width
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def fields_dict(data: bytes) -> dict[int, list]:
    out: dict[int, list] = {}
    for field, _, value in iter_fields(data):
        out.setdefault(field, []).append(value)
    return out


def to_int64(v: int) -> int:
    """Interpret a varint as a signed int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def sfixed64_to_int(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v
