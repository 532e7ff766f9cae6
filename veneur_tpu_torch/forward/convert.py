"""Conversions between a flush's forwardable state and metricpb protos
(port of veneur_tpu/forward/convert.py).

Export parity with reference worker.go:180-217 (ForwardableMetrics) and
the samplers' Metric() methods; import parity with worker.go:410-467
(ImportMetric), scope coercions included. `forwardable_to_wire` gives
bytes identical to the JAX package's, so a Go or JAX global reads a port
local's forward.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterable, List, Optional, Tuple

import numpy as np
from google.protobuf.internal import api_implementation

from veneur_tpu_torch import native
from veneur_tpu_torch.core.flusher import ForwardableState
from veneur_tpu_torch.forward import hllwire, llhistwire
from veneur_tpu_torch.forward.protos import metric_pb2, tdigest_pb2
from veneur_tpu_torch.forward.wire import _append_varint
from veneur_tpu_torch.ops import batch_tdigest
from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import (MetricKey, MetricScope,
                                               update_tags)

_SCOPE_TO_PB = {
    MetricScope.MIXED: metric_pb2.Mixed,
    MetricScope.LOCAL_ONLY: metric_pb2.Local,
    MetricScope.GLOBAL_ONLY: metric_pb2.Global,
}
_SCOPE_FROM_PB = {v: k for k, v in _SCOPE_TO_PB.items()}

_TYPE_NAME_TO_PB = {
    m.COUNTER: metric_pb2.Counter,
    m.GAUGE: metric_pb2.Gauge,
    m.HISTOGRAM: metric_pb2.Histogram,
    m.SET: metric_pb2.Set,
    m.TIMER: metric_pb2.Timer,
    m.LLHIST: metric_pb2.LLHist,
}
_TYPE_PB_TO_NAME = {v: k for k, v in _TYPE_NAME_TO_PB.items()}

COMPRESSION = batch_tdigest.COMPRESSION

# rows forwardable_to_wire serialized through proto objects instead of the
# hand-packed and native encoders (the chip smoke asserts it stays 0)
proto_fallback_rows = 0


def forwardable_to_protos(fwd: ForwardableState) -> List[metric_pb2.Metric]:
    """Serialize a flush's forwardable snapshot into metricpb Metrics."""
    out: List[metric_pb2.Metric] = []
    for meta, value in fwd.counters:
        out.append(metric_pb2.Metric(
            name=meta.name, tags=list(meta.tags), type=metric_pb2.Counter,
            scope=metric_pb2.Global,
            counter=metric_pb2.CounterValue(value=int(value))))
    for meta, value in fwd.gauges:
        out.append(metric_pb2.Metric(
            name=meta.name, tags=list(meta.tags), type=metric_pb2.Gauge,
            scope=metric_pb2.Global,
            gauge=metric_pb2.GaugeValue(value=float(value))))
    for meta, means, weights, dmin, dmax, drecip in fwd.histograms:
        nz = weights > 0
        digest = tdigest_pb2.MergingDigestData(
            compression=COMPRESSION, min=float(dmin), max=float(dmax),
            reciprocalSum=float(drecip))
        for mean, weight in zip(means[nz].tolist(), weights[nz].tolist()):
            digest.main_centroids.add(mean=mean, weight=weight)
        mtype = (metric_pb2.Timer if meta.wire_type == m.TIMER
                 else metric_pb2.Histogram)
        out.append(metric_pb2.Metric(
            name=meta.name, tags=list(meta.tags), type=mtype,
            scope=_SCOPE_TO_PB[meta.scope],
            histogram=metric_pb2.HistogramValue(t_digest=digest)))
    for meta, bins in fwd.llhists:
        # exact-merge family: the registers ride as the llhistwire payload
        # and the importer ADDS them
        out.append(metric_pb2.Metric(
            name=meta.name, tags=list(meta.tags), type=metric_pb2.LLHist,
            scope=_SCOPE_TO_PB[meta.scope],
            llhist=metric_pb2.LLHistValue(bins=llhistwire.marshal(bins))))
    for meta, registers in fwd.sets:
        # axiomhq binary form: a Go global veneur can UnmarshalBinary and
        # merge this directly (reference samplers.go:279-311)
        out.append(metric_pb2.Metric(
            name=meta.name, tags=list(meta.tags), type=metric_pb2.Set,
            scope=_SCOPE_TO_PB[meta.scope],
            set=metric_pb2.SetValue(
                hyper_log_log=hllwire.marshal(
                    np.asarray(registers, np.uint8)))))
    return out


def _pb_frame(meta) -> Tuple[bytes, bytes]:
    """Per-row metricpb wire frame of a digest row: (serialized fields
    1-3, serialized field 9), cached on the meta for the row's lifetime."""
    frame = meta.pb_frame
    if frame is None:
        mtype = (metric_pb2.Timer if meta.wire_type == m.TIMER
                 else metric_pb2.Histogram)
        head = metric_pb2.Metric(
            name=meta.name, tags=list(meta.tags),
            type=mtype).SerializeToString()
        tail = metric_pb2.Metric(
            scope=_SCOPE_TO_PB[meta.scope]).SerializeToString()
        frame = meta.pb_frame = (head, tail)
    return frame


_MASK64 = (1 << 64) - 1
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1
_ZERO8 = b"\x00" * 8


def _upb() -> bool:
    """The hand-packed frames below are calibrated against upb's BITWISE
    implicit-presence rule (-0.0 is emitted, 0.0 omitted); the
    pure-Python backend compares by value, so fall back to protos
    there."""
    return api_implementation.Type() == "upb"


def _wire_frame(meta, type_code: int, scope_code: int) -> Tuple[bytes, bytes]:
    """Hand-packed metricpb frame: (fields 1-3 bytes, field-9 bytes),
    cached on meta.pb_frame like the digest rows' `_pb_frame` (a meta
    lives in exactly one family table, so the slot never collides)."""
    frame = meta.pb_frame
    if frame is None:
        head = bytearray()
        nb = meta.name.encode()
        head += b"\x0a"
        _append_varint(head, len(nb))
        head += nb
        for t in meta.tags:
            tb = t.encode()
            head += b"\x12"
            _append_varint(head, len(tb))
            head += tb
        if type_code:  # proto3 implicit presence: enum 0 omitted
            head += b"\x18"
            _append_varint(head, type_code)
        tail = b"" if scope_code == 0 else bytes((0x48, scope_code))
        frame = meta.pb_frame = (bytes(head), tail)
    return frame


def _scalars_to_wire(counters, gauges) -> Optional[List[bytes]]:
    """Counters and gauges straight to metricpb wire bytes, no proto
    objects. Forwarded scalars are always Global scope (worker.go:420-423
    coerces on import anyway)."""
    if not _upb():
        return None
    global_code = int(metric_pb2.Global)
    out: List[bytes] = []
    for meta, value in counters:
        v = int(value)
        if not _INT64_MIN <= v <= _INT64_MAX:
            return None  # protos raise on int64 overflow; keep that
        head, tail = _wire_frame(meta, int(metric_pb2.Counter), global_code)
        if v:
            cv = bytearray(b"\x08")
            _append_varint(cv, v & _MASK64)
        else:
            cv = b""  # oneof: an empty CounterValue is still emitted
        frame = bytearray(head)
        frame += b"\x2a"
        _append_varint(frame, len(cv))
        frame += cv
        frame += tail
        out.append(bytes(frame))
    for meta, value in gauges:
        head, tail = _wire_frame(meta, int(metric_pb2.Gauge), global_code)
        vb = struct.pack("<d", float(value))
        gv = b"" if vb == _ZERO8 else b"\x09" + vb
        frame = bytearray(head)
        frame += b"\x32"
        _append_varint(frame, len(gv))
        frame += gv
        frame += tail
        out.append(bytes(frame))
    return out


def _payload_family_to_wire(entries, type_code: int, field_tag: int,
                            marshal) -> Optional[List[bytes]]:
    """Sets/llhists to wire: per-row `marshal(state)` bytes wrapped as
    field 1 of the value submessage, framed with the cached name/tags/type
    head and scope bytes. upb serializes in field-number order, so the
    scope (field 9) lands BEFORE an llhist value (field 10) but AFTER a
    set value (field 8)."""
    if not _upb():
        return None
    value_after_scope = field_tag > 0x48  # field number > 9
    out: List[bytes] = []
    for meta, state in entries:
        payload = marshal(state)
        head, tail = _wire_frame(meta, type_code,
                                 int(_SCOPE_TO_PB[meta.scope]))
        if payload:
            sv = bytearray(b"\x0a")
            _append_varint(sv, len(payload))
            sv += payload
        else:
            sv = b""
        frame = bytearray(head)
        if value_after_scope:
            frame += tail
        frame.append(field_tag)
        _append_varint(frame, len(sv))
        frame += sv
        if not value_after_scope:
            frame += tail
        out.append(bytes(frame))
    return out


def _histograms_to_wire(histograms) -> Optional[List[bytes]]:
    """Native bulk serialization of the digest rows (vnt_digest_encode
    and vnt_metric_wrap): bytes identical to forwardable_to_protos +
    SerializeToString. Returns None when a row is not a float32 (C,) grid
    or the protobuf backend is not upb (the caller then takes protos)."""
    if not _upb():
        return None
    lib = native.load()
    K = len(histograms)
    C = histograms[0][1].shape[0]
    f32 = np.dtype(np.float32)
    means = np.empty((K, C), np.float32)
    weights = np.empty((K, C), np.float32)
    mins = np.empty(K, np.float64)
    maxs = np.empty(K, np.float64)
    recips = np.empty(K, np.float64)
    heads: List[bytes] = []
    tails: List[bytes] = []
    for k, (meta, mrow, wrow, dmin, dmax, drecip) in enumerate(histograms):
        # byte-identity contract: refuse anything the float32 copy below
        # could round, instead of emitting bytes that diverge from protos
        if (mrow.dtype != f32 or wrow.dtype != f32
                or mrow.shape != (C,) or wrow.shape != (C,)):
            return None
        means[k] = mrow
        weights[k] = wrow
        mins[k] = dmin
        maxs[k] = dmax
        recips[k] = drecip
        head, tail = _pb_frame(meta)
        heads.append(head)
        tails.append(tail)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def _p(arr, ct):
        return arr.ctypes.data_as(ct)

    nnz = int(np.count_nonzero(weights > 0))
    dig_cap = nnz * 20 + K * 36 + 64
    dig_buf = np.empty(dig_cap, np.uint8)
    dig_offs = np.empty(K + 1, np.int64)
    dig_total = lib.vnt_digest_encode(
        _p(means, f32p), _p(weights, f32p), K, C, _p(mins, f64p),
        _p(maxs, f64p), _p(recips, f64p), float(COMPRESSION),
        _p(dig_buf, u8p), dig_cap, _p(dig_offs, i64p))
    if dig_total < 0:
        raise RuntimeError(f"vnt_digest_encode failed ({dig_total}) for "
                           f"{K} digests")
    head_buf = b"".join(heads)
    tail_buf = b"".join(tails)
    head_offs = np.zeros(K + 1, np.int64)
    np.cumsum([len(h) for h in heads], out=head_offs[1:])
    tail_offs = np.zeros(K + 1, np.int64)
    np.cumsum([len(t) for t in tails], out=tail_offs[1:])
    out_cap = dig_total + len(head_buf) + len(tail_buf) + K * 16
    out_buf = np.empty(out_cap, np.uint8)
    out_offs = np.empty(K + 1, np.int64)
    head_arr = np.frombuffer(head_buf, np.uint8)
    tail_arr = np.frombuffer(tail_buf, np.uint8)
    total = lib.vnt_metric_wrap(
        _p(dig_buf, u8p), _p(dig_offs, i64p),
        _p(head_arr, u8p) if head_buf else _p(dig_buf, u8p),
        _p(head_offs, i64p),
        _p(tail_arr, u8p) if tail_buf else _p(dig_buf, u8p),
        _p(tail_offs, i64p), K, _p(out_buf, u8p), out_cap,
        _p(out_offs, i64p))
    if total < 0:
        raise RuntimeError(f"vnt_metric_wrap failed ({total}) for {K} "
                           f"digests")
    mv = memoryview(out_buf)
    offs = out_offs.tolist()
    return [bytes(mv[offs[k]:offs[k + 1]]) for k in range(K)]


def _protos_wire(fwd: ForwardableState) -> List[bytes]:
    """The proto-object fallback of forwardable_to_wire, counted."""
    global proto_fallback_rows
    proto_fallback_rows += len(fwd)
    return [p.SerializeToString() for p in forwardable_to_protos(fwd)]


def forwardable_to_wire(fwd: ForwardableState) -> List[bytes]:
    """Serialize a flush's forwardable snapshot straight to metricpb wire
    bytes, one entry per Metric, in the order counters, gauges, digests,
    sets, llhists. Byte-identical to forwardable_to_protos +
    SerializeToString."""
    out: List[bytes] = []
    if fwd.counters or fwd.gauges:
        wired = _scalars_to_wire(fwd.counters, fwd.gauges)
        if wired is None:  # non-upb backend / int64 overflow
            wired = _protos_wire(ForwardableState(counters=fwd.counters,
                                                  gauges=fwd.gauges))
        out.extend(wired)
    if fwd.histograms:
        wired = _histograms_to_wire(fwd.histograms)
        if wired is None:  # non-upb backend / odd dtype
            wired = _protos_wire(ForwardableState(histograms=fwd.histograms))
        out.extend(wired)
    if fwd.sets:
        wired = _payload_family_to_wire(
            fwd.sets, int(metric_pb2.Set), 0x42,
            lambda r: hllwire.marshal(np.asarray(r, np.uint8)))
        if wired is None:
            wired = _protos_wire(ForwardableState(sets=fwd.sets))
        out.extend(wired)
    if fwd.llhists:
        wired = _payload_family_to_wire(
            fwd.llhists, int(metric_pb2.LLHist), 0x52, llhistwire.marshal)
        if wired is None:
            wired = _protos_wire(ForwardableState(llhists=fwd.llhists))
        out.extend(wired)
    return out


def metric_key_of_proto(pbm: metric_pb2.Metric, ignored_tags: Iterable = ()
                        ) -> Tuple[MetricKey, int, int, list]:
    """The (key, digest32, digest64, tags) identity of an imported metric
    (reference NewMetricKeyFromMetric, parser.go:106-131, and
    IngestMetricProto's hashing, server.go:340-355), without the tags
    that match one of `ignored_tags` (TagMatchers). Raises KeyError for
    an unknown type enum."""
    type_name = _TYPE_PB_TO_NAME[pbm.type]
    tags = [t for t in pbm.tags
            if not any(im.match(t) for im in ignored_tags)]
    final, joined, h32, h64 = update_tags(pbm.name, type_name, tags, None)
    return MetricKey(pbm.name, type_name, joined), h32, h64, final


def import_scope(pbm: metric_pb2.Metric) -> MetricScope:
    """Scope coercion on import: counters and gauges become global-only
    (reference worker.go:420-423)."""
    if pbm.type in (metric_pb2.Counter, metric_pb2.Gauge):
        return MetricScope.GLOBAL_ONLY
    return _SCOPE_FROM_PB.get(pbm.scope, MetricScope.MIXED)
