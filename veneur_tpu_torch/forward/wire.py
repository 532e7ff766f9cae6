"""Forward-plane wire helpers of the forward client and the import server
(the part of veneur_tpu/forward/wire.py the port uses): metricpb frame
assembly, the FlowCounts response codec, the idempotency token, the
interval stamp of replayed segments and the V1-then-V2 transport policy.
Free of torch: nothing here aggregates. The shard and trace metadata
are not ported yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import grpc


def _serialize_metric(m) -> bytes:
    """Entries are either pre-serialized wire bytes (the native digest
    encoder's output) or metricpb.Metric objects."""
    return m if type(m) is bytes else m.SerializeToString()


def _append_varint(out: bytearray, value: int) -> None:
    """Append one protobuf varint: the encode loop every hand-rolled
    frame shares."""
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)


def _frame_v1(m) -> bytes:
    """Wraps one serialized Metric as a MetricList `metrics` entry (field
    1, length-delimited); concatenating the frames IS the MetricList wire
    body."""
    b = _serialize_metric(m)
    out = bytearray(b"\x0a")
    _append_varint(out, len(b))
    out += b
    return bytes(out)


# -- flow-count responses ---------------------------------------------
#
# The import server answers with a proto-compatible message instead of
# google.protobuf.Empty, so the sender learns the receiver's side of the
# books:
#
#   message FlowCounts {
#     uint64 received  = 1;  // metrics parsed out of the request
#     uint64 merged    = 2;  // metrics accepted into the pipeline
#     bool   duplicate = 3;  // whole payload dropped by token dedupe
#   }
#
# A reference peer parsing this as Empty ignores the unknown fields; a
# reference server answering a genuine Empty gives zero bytes, which
# decode_flow_counts maps to None ("counts unreported").

def encode_flow_counts(received: int, merged: int,
                       duplicate: bool = False) -> bytes:
    out = bytearray()

    def field(tag: int, value: int) -> None:
        out.append(tag << 3)  # wire type 0 (varint)
        _append_varint(out, value)

    # field 1 is always present (even at 0) so any response bytes at all
    # mean "counts reported"
    field(1, max(0, int(received)))
    if merged:
        field(2, int(merged))
    if duplicate:
        field(3, 1)
    return bytes(out)


def decode_flow_counts(body) -> "dict | None":
    """FlowCounts wire bytes -> {received, merged, duplicate}; None for an
    empty, absent or undecodable response (an un-upgraded peer)."""
    if not body or not isinstance(body, (bytes, bytearray)):
        return None
    out = {"received": 0, "merged": 0, "duplicate": False}
    i, n = 0, len(body)
    seen_received = False
    while i < n:
        tag = body[i]
        i += 1
        if tag & 0x07 != 0:  # only varint fields are ours; bail on rest
            return None
        value = shift = 0
        while True:
            if i >= n:
                return None
            byte = body[i]
            i += 1
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
            if shift > 63:
                return None
        fnum = tag >> 3
        if fnum == 1:
            out["received"] = value
            seen_received = True
        elif fnum == 2:
            out["merged"] = value
        elif fnum == 3:
            out["duplicate"] = bool(value)
        # unknown varint fields: ignored (forward compatibility)
    return out if seen_received else None


# gRPC metadata key carrying the sender's idempotency token: the import
# server remembers recent tokens and acks-and-drops a repeat, so a V1
# body that landed but errored client-side cannot merge twice through
# the V2 fallback. Lowercase per the gRPC metadata contract.
IDEMPOTENCY_KEY = "x-veneur-idempotency-token"


def token_metadata(token: str):
    """Metadata tuple for one send attempt; None disables the header."""
    return ((IDEMPOTENCY_KEY, token),) if token else None


# gRPC metadata key carrying the interval-start unix timestamp (seconds,
# "%.3f") of a replayed segment, so a receiving tier can bucket stale
# backfill under the interval it belongs to instead of folding it into
# the current flush. Absent from un-upgraded peers; extraction degrades
# to 0.0 and the receiver merges into the live interval.
INTERVAL_KEY = "x-veneur-interval"

# metricpb.Metric's interval field (field 11, int64 unix seconds): the
# per-metric copy of the same stamp, set on WAL segment bytes so a
# segment is self-describing even off its spool. proto3 unknown-field
# rules make it invisible to reference Go peers and the native V1
# parser alike.
INTERVAL_FIELD_NUMBER = 11


def interval_metadata(interval_unix: float):
    """Metadata tuple stamping one send's interval; None when
    unstamped."""
    if not interval_unix:
        return None
    return ((INTERVAL_KEY, format(float(interval_unix), ".3f")),)


def extract_interval(ctx) -> float:
    """Interval-start unix seconds from a gRPC ServicerContext's
    invocation metadata; 0.0 when absent or undecodable."""
    value = metadata_value(ctx, INTERVAL_KEY)
    if not value:
        return 0.0
    try:
        return float(value)
    except (TypeError, ValueError):
        return 0.0


def stamp_interval_wire(metric_bytes: bytes, interval_unix: float) -> bytes:
    """Append metricpb.Metric's interval field (field 11, varint) to
    one already-serialized Metric — field concatenation is valid proto3
    wire format (last value wins), so the native digest encoder's
    output never needs to know about the stamp."""
    value = int(interval_unix)
    if value <= 0:
        return metric_bytes
    out = bytearray(metric_bytes)
    out.append(INTERVAL_FIELD_NUMBER << 3)  # wire type 0 (varint)
    _append_varint(out, value)
    return bytes(out)


def metadata_value(ctx, key: str):
    """One metadata entry's value (None when absent)."""
    try:
        for k, value in (ctx.invocation_metadata() or ()):
            if k == key:
                return value
    except Exception:
        pass
    return None


def combine_metadata(*parts):
    """Concatenate metadata tuples, skipping Nones; None when empty (the
    gRPC call layer treats None as 'no metadata')."""
    out = []
    for part in parts:
        if part:
            out.extend(part)
    return tuple(out) if out else None


class TokenDeduper:
    """Receiver-side idempotency-token bookkeeping.

    `begin` returns (token, disposition): "fresh" (process it), "done" (a
    COMPLETED attempt already applied this token: ack and drop), or
    "inflight" (the first attempt is still processing: the caller must
    fail retryably, NOT ack, since the racing first attempt can still
    fail). `end` records the outcome; a failed attempt forgets the token
    so a retry passes."""

    def __init__(self, cache_max: int = 8192):
        self.cache_max = cache_max
        self._lock = threading.Lock()
        self._done: "OrderedDict[str, None]" = OrderedDict()
        self._inflight: set = set()
        self.duplicates_dropped_total = 0

    def begin(self, ctx):
        token = ""
        for key, value in (ctx.invocation_metadata() or ()):
            if key == IDEMPOTENCY_KEY:
                token = value
                break
        if not token:
            return "", "fresh"
        with self._lock:
            if token in self._done:
                self.duplicates_dropped_total += 1
                return token, "done"
            if token in self._inflight:
                return token, "inflight"
            self._inflight.add(token)
        return token, "fresh"

    def end(self, token: str, ok: bool) -> None:
        if not token:
            return
        with self._lock:
            self._inflight.discard(token)
            if ok:
                self._done[token] = None
                while len(self._done) > self.cache_max:
                    self._done.popitem(last=False)


def send_batch(send_v1, send_v2, batch, timeout, v1_ok: bool,
               pin_codes, metadata=None):
    """One batch over the V1 bulk body when the peer takes it, else the
    V2 stream.

    `pin_codes` are structural refusals: the batch is retried over V2 and
    the returned flag turns False so the caller stays on V2. Any other
    error propagates for the caller's failure accounting. Returns (the
    updated V1-preference flag, the raw response bytes: the receiver's
    FlowCounts when it is this framework's importer, empty otherwise).

    `metadata` (the token) rides on every attempt, INCLUDING the V2 retry
    of a failed V1 body: a V1 attempt the receiver applied before erroring
    client-side must not merge twice through the fallback."""
    if v1_ok:
        try:
            body = b"".join(_frame_v1(m) for m in batch)
            return True, send_v1(body, timeout=timeout, metadata=metadata)
        except grpc.RpcError as e:
            if e.code() not in pin_codes:
                raise
            return False, send_v2(iter(batch), timeout=timeout,
                                  metadata=metadata)
    return False, send_v2(iter(batch), timeout=timeout, metadata=metadata)
