"""SSF wire protocol: framing for streaming SSF spans (a copy of
veneur_tpu/protocol/wire.py).

Frame layout (parity with reference protocol/wire.go:1-230):

    [ 8 bits  - version/type of message; only 0 is defined ]
    [32 bits  - big-endian length of the SSF message in octets ]
    [<length> - protobuf-encoded ssf.SSFSpan ]

Lengths above MAX_SSF_PACKET_LENGTH (16 MB) are rejected. The protocol has
no resync hints, so any framing error is fatal to the stream: callers must
close the connection when `is_framing_error` returns True.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

from google.protobuf.message import DecodeError

from veneur_tpu_torch.ssf.protos import ssf_pb2

MAX_SSF_PACKET_LENGTH = 16 * 1024 * 1024
SSF_FRAME_LENGTH = 1 + 4
_VERSION_0 = 0
_HDR = struct.Struct(">BI")


class FramingError(IOError):
    """The stream is desynchronized and must be closed."""


class SSFDecodeError(ValueError):
    """A correctly-framed message failed protobuf decoding; the stream
    itself is still synchronized and usable."""


class InvalidTrace(ValueError):
    def __init__(self, span):
        super().__init__(f"not a valid trace span: id={span.id} "
                         f"trace_id={span.trace_id} name={span.name!r}")
        self.span = span


def is_framing_error(err: BaseException) -> bool:
    return isinstance(err, FramingError)


def valid_trace(span: ssf_pb2.SSFSpan) -> bool:
    """True iff the span can participate in a trace (wire.go:82-88)."""
    return (span.id != 0 and span.trace_id != 0
            and span.start_timestamp != 0 and span.end_timestamp != 0
            and span.name != "")


def validate_trace(span: ssf_pb2.SSFSpan) -> None:
    if not valid_trace(span):
        raise InvalidTrace(span)


def parse_ssf(packet: bytes) -> ssf_pb2.SSFSpan:
    """Decode one SSFSpan and normalize it (wire.go ParseSSF):
    a "name" tag fills an empty span name; zero sample rates become 1."""
    span = ssf_pb2.SSFSpan()
    try:
        span.ParseFromString(packet)
    except DecodeError as e:
        raise SSFDecodeError(f"invalid SSF protobuf: {e}") from e
    if not span.name and "name" in span.tags:
        span.name = span.tags["name"]
        del span.tags["name"]
    for sample in span.metrics:
        if sample.sample_rate == 0:
            sample.sample_rate = 1.0
    return span


def _read_exact(stream: BinaryIO, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def read_ssf(stream: BinaryIO,
             max_length: int = MAX_SSF_PACKET_LENGTH,
             ) -> Optional[ssf_pb2.SSFSpan]:
    """Read one framed span. Returns None on clean EOF at a frame
    boundary; raises FramingError on any mid-frame or header corruption.
    max_length caps the accepted frame body (config
    trace_max_length_bytes, reference server.go:498)."""
    first = stream.read(1)
    if not first:
        return None  # clean hang-up between messages
    version = first[0]
    if version != _VERSION_0:
        raise FramingError(f"unknown SSF frame version {version}")
    hdr = _read_exact(stream, 4)
    if hdr is None:
        raise FramingError("EOF inside SSF frame header")
    (length,) = struct.unpack(">I", hdr)
    if length > max_length:
        raise FramingError(f"SSF frame length {length} exceeds "
                           f"{max_length}")
    body = _read_exact(stream, length)
    if body is None:
        raise FramingError("EOF inside SSF frame body")
    return parse_ssf(body)


def write_ssf(stream: BinaryIO, span: ssf_pb2.SSFSpan) -> int:
    """Frame and write one span; returns bytes written."""
    frame = frame_ssf(span)
    stream.write(frame)
    return len(frame)


def frame_ssf(span: ssf_pb2.SSFSpan) -> bytes:
    body = span.SerializeToString()
    if len(body) > MAX_SSF_PACKET_LENGTH:
        raise FramingError(f"span encodes to {len(body)} bytes, over the "
                           f"{MAX_SSF_PACKET_LENGTH} frame cap")
    return _HDR.pack(_VERSION_0, len(body)) + body
