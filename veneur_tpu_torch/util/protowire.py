"""Minimal protobuf wire-format reading for the port's hand-rolled
decoders (the OTLP source's), a copy of veneur_tpu/util/protowire.py.

stdlib-only. Varints are bounded (10 bytes / 70 bits of shift) so a
malicious stream cannot spin the decode loop into unbounded bigints.
"""

from __future__ import annotations

from typing import Iterator, Tuple


class WireError(ValueError):
    pass


def get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode one varint at `pos`; returns (value, next_pos)."""
    val = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 70:
            raise WireError("varint overflow")


def zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def read_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, payload): int for varint (wire
    0), raw 8/4-byte slices for fixed64/fixed32 (wires 1/5), bytes for
    length-delimited (wire 2)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag_wire, pos = get_varint(buf, pos)
        field, wire = tag_wire >> 3, tag_wire & 7
        if wire == 0:
            val, pos = get_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:
            if pos + 8 > n:
                raise WireError("truncated fixed64")
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = get_varint(buf, pos)
            if pos + ln > n:
                raise WireError("truncated length-delimited field")
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            if pos + 4 > n:
                raise WireError("truncated fixed32")
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wire}")
