"""Cortex sink: Prometheus remote-write.

Behavioral parity with reference sinks/cortex/cortex.go (464 LoC):
InterMetrics -> prometheus WriteRequest protobuf, snappy-compressed,
POSTed with X-Prometheus-Remote-Write-Version headers and optional
basic/bearer auth. Metric and label names sanitize to the Prometheus
charset ([a-zA-Z_:][a-zA-Z0-9_:]*), duplicate labels keep the last value.

The WriteRequest message is hand-encoded protobuf wire format (the schema
is 5 tiny messages; no codegen needed):
  WriteRequest{ repeated TimeSeries timeseries = 1 }
  TimeSeries{ repeated Label labels = 1; repeated Sample samples = 2;
              repeated Exemplar exemplars = 3 }
  Label{ string name = 1; string value = 2 }
  Sample{ double value = 1; int64 timestamp = 2 }  # ms
  Exemplar{ repeated Label labels = 1; double value = 2;
            int64 timestamp = 3 }  # ms

Exemplars carry the cross-tier self-trace plane's per-series
`(trace_id, raw value, timestamp)` (trace/store.py) as a
`trace_id` exemplar label — the native remote-write form of the
OpenMetrics `# {trace_id="..."}` clause the text sinks render.

Copied from veneur_tpu/sinks/cortex.py. Exemplars come from the owning
server's `trace_plane`, which the port does not have yet, so a port
server renders none.
"""

from __future__ import annotations

import base64
import logging
import re
import struct
from typing import Dict, List, Sequence, Tuple

from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.cortex")

_INVALID_NAME = re.compile(r"[^a-zA-Z0-9_:]")
_INVALID_LABEL = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    out = _INVALID_NAME.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def sanitize_label(name: str) -> str:
    out = _INVALID_LABEL.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


# -- protobuf wire helpers -------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field_bytes(tag: int, payload: bytes) -> bytes:
    return _varint((tag << 3) | 2) + _varint(len(payload)) + payload


def _encode_label(name: str, value: str) -> bytes:
    return (_field_bytes(1, name.encode()) +
            _field_bytes(2, value.encode()))


def _encode_sample(value: float, timestamp_ms: int) -> bytes:
    # fixed64 double field 1, varint int64 field 2
    body = bytes([(1 << 3) | 1]) + struct.pack("<d", value)
    body += bytes([2 << 3]) + _varint(timestamp_ms & ((1 << 64) - 1))
    return body


def _encode_exemplar(trace_id_hex: str, value: float,
                     ts_ms: int) -> bytes:
    body = _field_bytes(1, _encode_label("trace_id", trace_id_hex))
    body += bytes([(2 << 3) | 1]) + struct.pack("<d", value)
    body += bytes([3 << 3]) + _varint(ts_ms & ((1 << 64) - 1))
    return body


def encode_write_request(series: Sequence[tuple]) -> bytes:
    """series: [(labels, value, timestamp_ms)] or
    [(labels, value, timestamp_ms, (trace_id_hex, exemplar_value,
    exemplar_ts_ms))] -> WriteRequest bytes."""
    out = bytearray()
    for entry in series:
        labels, value, ts_ms = entry[0], entry[1], entry[2]
        exemplar = entry[3] if len(entry) > 3 else None
        ts_body = bytearray()
        for name, value_str in labels:
            ts_body += _field_bytes(1, _encode_label(name, value_str))
        ts_body += _field_bytes(2, _encode_sample(value, ts_ms))
        if exemplar is not None:
            ts_body += _field_bytes(3, _encode_exemplar(*exemplar))
        out += _field_bytes(1, bytes(ts_body))
    return bytes(out)


def decode_write_request(data: bytes):
    """Minimal decoder for tests/fakes: returns [(labels_dict, value, ts)]."""
    def read_fields(buf):
        pos = 0
        while pos < len(buf):
            tag_wire = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                tag_wire |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            tag, wire = tag_wire >> 3, tag_wire & 7
            if wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = buf[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                yield tag, buf[pos:pos + ln]
                pos += ln
            elif wire == 0:
                v = 0
                shift = 0
                while True:
                    b = buf[pos]
                    pos += 1
                    v |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                yield tag, v
            elif wire == 1:
                yield tag, buf[pos:pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    result = []
    for tag, ts_buf in read_fields(data):
        assert tag == 1
        labels: Dict[str, str] = {}
        value, ts = 0.0, 0
        for ftag, fval in read_fields(ts_buf):
            if ftag == 1:
                fields = dict(read_fields(fval))
                labels[fields[1].decode()] = fields[2].decode()
            elif ftag == 2:
                for stag, sval in read_fields(fval):
                    if stag == 1:
                        value = struct.unpack("<d", sval)[0]
                    elif stag == 2:
                        ts = sval
        result.append((labels, value, ts))
    return result


class CortexMetricSink(MetricSink):
    def __init__(self, name: str, url: str, hostname: str,
                 auth_token: str = "", basic_auth: Tuple[str, str] = ("", ""),
                 batch_write_size: int = 0, timeout: float = 30.0,
                 excluded_tags: Sequence[str] = (),
                 proxy_url: str = "",
                 convert_counters_to_monotonic: bool = False):
        self._name = name
        self.url = url
        self.hostname = hostname
        self.timeout = timeout
        self.batch_write_size = batch_write_size
        self.excluded_tags = set(excluded_tags)
        # HTTP(S) proxy for the remote-write transport (cortex.go:176-183)
        self.proxy_url = proxy_url
        # monotonic mode: counter deltas accumulate across flushes per
        # (name, sorted tags, hostname) and every flush re-emits the
        # running totals as Prometheus-style monotonic series
        # (cortex.go:337-363; like the reference, entries live for the
        # process lifetime — high-churn tag sets grow the map)
        self.convert_counters_to_monotonic = convert_counters_to_monotonic
        self._monotonic: Dict[Tuple[str, Tuple[str, ...], str], float] = {}
        self._exemplars = None  # ExemplarStore, bound in start()
        self._encoder = None    # CortexColumnarEncoder, built lazily
        self.headers = {
            "Content-Encoding": "snappy",
            "X-Prometheus-Remote-Write-Version": "0.1.0",
            "User-Agent": "veneur-tpu/cortex",
        }
        if auth_token:
            self.headers["Authorization"] = f"Bearer {auth_token}"
        elif basic_auth[0]:
            cred = base64.b64encode(
                f"{basic_auth[0]}:{basic_auth[1]}".encode()).decode()
            self.headers["Authorization"] = f"Basic {cred}"

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "cortex"

    def start(self, server) -> None:
        self.bind_server(server)
        # self-trace exemplars (trace/store.py): per-series
        # (trace_id, value, ts) riding the remote-write TimeSeries
        plane = getattr(server, "trace_plane", None)
        self._exemplars = getattr(plane, "exemplars", None)

    def _exemplar_entry(self, m: InterMetric, exemplified: set):
        """Same attachment contract as the Prometheus sink
        (sinks/prometheus.py exemplar_clause_for): COUNTER series only,
        one per exemplar base name per write, suffix-resolved entries
        only on their `.bucket` family (tightest containing bucket:
        buckets emit smallest-le first and for_series checks the
        bound), exact-name entries on their own line."""
        if self._exemplars is None or m.type != MetricType.COUNTER:
            return None
        from veneur_tpu_torch.trace.store import exemplar_base
        base = exemplar_base(m.name)
        if base in exemplified:
            return None
        if base != m.name and m.name != base + ".bucket":
            return None
        entry = self._exemplars.for_series(m.name, m.tags)
        if entry is not None:
            exemplified.add(base)
        return entry

    def _series(self, m: InterMetric):
        labels: Dict[str, str] = {"__name__": sanitize_name(m.name)}
        for t in m.tags:
            k, _, v = t.partition(":")
            if k in self.excluded_tags:
                continue
            labels[sanitize_label(k)] = v  # last write wins on dupes
        if m.hostname or self.hostname:
            labels.setdefault("host", m.hostname or self.hostname)
        ordered = sorted(labels.items())
        return ordered, float(m.value), m.timestamp * 1000

    def flush(self, metrics: List[InterMetric]) -> None:
        import time as _time

        t0 = _time.perf_counter()
        series = []
        exemplified = set()
        max_ts = 0  # folded into the encode pass (no second scan)
        for m in metrics:
            if m.timestamp > max_ts:
                max_ts = m.timestamp
            if m.type == MetricType.STATUS:
                continue
            if (m.type == MetricType.COUNTER
                    and self.convert_counters_to_monotonic):
                key = (m.name, tuple(sorted(m.tags)), m.hostname)
                self._monotonic[key] = (
                    self._monotonic.get(key, 0.0) + float(m.value))
                continue
            row = self._series(m)
            entry = self._exemplar_entry(m, exemplified)
            if entry is not None:
                from veneur_tpu_torch.trace.store import trace_id_hex
                tid, ev, ets = entry
                row = row + ((trace_id_hex(tid), float(ev),
                              int(ets * 1000)),)
            series.append(row)
        if self.convert_counters_to_monotonic:
            series.extend(self._monotonic_series(max_ts))
        if not series:
            return
        encode_s = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        batch = self.batch_write_size or len(series)
        for i in range(0, len(series), batch):
            self._post_body(vhttp.snappy_encode(
                encode_write_request(series[i:i + batch])))
        self.note_egress(encode_s, _time.perf_counter() - t1,
                         encoder="legacy")

    def _monotonic_series(self, max_ts: int) -> List[tuple]:
        """Re-emit the running monotonic totals, stamped with the
        flush's own metric timestamp so they align with the gauges in
        the same remote-write batch; wall clock only when the flush
        carried no timestamped metrics at all."""
        import time as _time

        stamp = max_ts or int(_time.time())
        return [self._series(InterMetric(
            name=mname, timestamp=stamp, value=total,
            tags=list(tags), type=MetricType.COUNTER, hostname=mhost))
            for (mname, tags, mhost), total in self._monotonic.items()]

    def _post_body(self, body: bytes) -> None:
        try:
            vhttp.post(self.url, body,
                       content_type="application/x-protobuf",
                       headers=self.headers, timeout=self.timeout,
                       proxy_url=self.proxy_url)
        except Exception as e:
            logger.error("cortex remote write failed: %s", e)

    def flush_batch(self, batch) -> None:
        try:
            self.flush_columnar(batch)
        except Exception:
            logger.exception("cortex columnar flush failed; "
                             "falling back to materialize()")
            self.flush(batch.materialize())

    def flush_columnar(self, batch) -> None:
        """Columnar fast path: TimeSeries frames hand-packed from the
        FlushBatch arrays (core/egress.py); concatenated frame chunks
        are byte-identical to encode_write_request over the legacy
        series list, so chunking/snappy/POST are unchanged."""
        import time as _time

        from veneur_tpu_torch.core.egress import CortexColumnarEncoder

        t0 = _time.perf_counter()
        enc = self._encoder
        if enc is None:
            enc = self._encoder = CortexColumnarEncoder(self)
        frames, max_ts = enc.encode(batch)
        if self.convert_counters_to_monotonic:
            frames.extend(encode_write_request([row])
                          for row in self._monotonic_series(max_ts))
        if not frames:
            return
        encode_s = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        size = self.batch_write_size or len(frames)
        for i in range(0, len(frames), size):
            self._post_body(vhttp.snappy_encode(
                b"".join(frames[i:i + size])))
        self.note_egress(encode_s, _time.perf_counter() - t1)


@register_metric_sink("cortex")
def _factory(sink_config, server_config):
    c = sink_config.config
    auth = c.get("authorization", {}) or {}
    basic = c.get("basic_auth", {}) or {}
    return CortexMetricSink(
        sink_config.name or "cortex",
        url=c.get("url", ""),
        hostname=server_config.hostname,
        auth_token=str(auth.get("credentials", "")),
        basic_auth=(str(basic.get("username", "")),
                    str(basic.get("password", ""))),
        batch_write_size=int(c.get("batch_write_size", 0)),
        timeout=float(c.get("remote_timeout", 30.0)),
        excluded_tags=c.get("excluded_tags", []) or [],
        proxy_url=c.get("proxy_url", ""),
        convert_counters_to_monotonic=bool(
            c.get("convert_counters_to_monotonic", False)))
