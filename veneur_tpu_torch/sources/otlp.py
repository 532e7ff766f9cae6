"""OTLP/HTTP ingest source: OpenTelemetry metrics onto the column store
(a port of veneur_tpu/sources/otlp.py; the decoders are copies).

An embedded HTTP server accepts `POST /v1/metrics` in both OTLP/HTTP
encodings: `application/x-protobuf` (ExportMetricsServiceRequest,
decoded by the generic wire reader of util/protowire.py, for the handful
of fields used) and `application/json` (the OTLP/JSON mapping, with its
stringified int64), each optionally gzip (inflated under a bound).

Mapping onto the aggregation families:

- `Sum` monotonic+cumulative -> per-interval counter delta through the
  shared `sources.CumulativeDeltaCache` (a reset emits the 0-clamped new
  count); delta temporality ingests directly; a non-monotonic sum is a
  gauge.
- `Gauge` -> gauge (last write wins).
- `ExponentialHistogram` -> the llhist family: each base-2 bucket's
  count lands at the bucket's geometric midpoint `2^((i+0.5)/2^scale)`,
  the zero bucket at 0.0, through the slow path's pending buffer and
  kernel K3. Cumulative points become per-interval deltas through a
  per-series bucket cache (a downscale re-buckets the previous point; an
  upscale or any shrinking bucket is a reset: the current buckets stand).

Unsupported kinds (explicit-bounds Histogram, Summary) are counted and
dropped; the `otlp.*` self-metrics go through the server's statsd
client. `stop()` waits for the requests in flight, so none ingests after
the server's final flush.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Tuple

from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import (
    MetricKey, MetricScope, UDPMetric, update_tags)
from veneur_tpu_torch.sources import (
    CumulativeDeltaCache, Ingest, Source, register_source)
from veneur_tpu_torch.util.protowire import (
    get_varint as _get_varint, read_fields as _read_fields,
    zigzag as _zigzag)

logger = logging.getLogger("veneur_tpu_torch.sources.otlp")

# OTLP aggregation temporality enum
TEMPORALITY_DELTA = 1
TEMPORALITY_CUMULATIVE = 2


# --------------------------------------------------------------------------
# protobuf wire reading (shared machinery in util/protowire)
# --------------------------------------------------------------------------


def _f64(data: bytes) -> float:
    return struct.unpack("<d", data)[0]


def _packed_varints(data: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(data):
        val, pos = _get_varint(data, pos)
        out.append(val)
    return out


def _decode_any_value(buf: bytes) -> str:
    """AnyValue -> attribute string (string/bool/int/double supported;
    anything else renders as its raw length)."""
    for f, w, v in _read_fields(buf):
        if f == 1 and w == 2:
            return v.decode("utf-8", "replace")
        if f == 2 and w == 0:
            return "true" if v else "false"
        if f == 3 and w == 0:  # int64 varint, two's complement
            return str(v - (1 << 64) if v >= 1 << 63 else v)
        if f == 4 and w == 1:
            return format(_f64(v), "g")
    return ""


def _decode_attributes(fields: List[bytes]) -> Dict[str, str]:
    attrs: Dict[str, str] = {}
    for kv in fields:
        key = ""
        val = ""
        for f, w, v in _read_fields(kv):
            if f == 1 and w == 2:
                key = v.decode("utf-8", "replace")
            elif f == 2 and w == 2:
                val = _decode_any_value(v)
        if key:
            attrs[key] = val
    return attrs


def _decode_number_point(buf: bytes) -> Tuple[Dict[str, str], float]:
    attrs: List[bytes] = []
    value = 0.0
    for f, w, v in _read_fields(buf):
        if f == 7 and w == 2:
            attrs.append(v)
        elif f == 4 and w == 1:  # as_double
            value = _f64(v)
        elif f == 6 and w == 1:  # as_int (sfixed64)
            value = float(struct.unpack("<q", v)[0])
    return _decode_attributes(attrs), value


def _decode_buckets(buf: bytes) -> Tuple[int, List[int]]:
    offset = 0
    counts: List[int] = []
    for f, w, v in _read_fields(buf):
        if f == 1 and w == 0:  # sint32 offset (zigzag)
            offset = _zigzag(v)
        elif f == 2 and w == 2:  # packed uint64 bucket_counts
            counts.extend(_packed_varints(v))
        elif f == 2 and w == 0:  # unpacked straggler
            counts.append(v)
    return offset, counts


def _decode_ehist_point(buf: bytes) -> dict:
    point = {"attrs": {}, "scale": 0, "zero_count": 0,
             "pos": (0, []), "neg": (0, [])}
    attrs: List[bytes] = []
    for f, w, v in _read_fields(buf):
        if f == 1 and w == 2:
            attrs.append(v)
        elif f == 6 and w == 0:  # sint32 scale
            point["scale"] = _zigzag(v)
        elif f == 7 and w == 1:  # fixed64 zero_count
            point["zero_count"] = struct.unpack("<Q", v)[0]
        elif f == 8 and w == 2:
            point["pos"] = _decode_buckets(v)
        elif f == 9 and w == 2:
            point["neg"] = _decode_buckets(v)
    point["attrs"] = _decode_attributes(attrs)
    return point


def parse_export_request(body: bytes) -> Iterator[tuple]:
    """ExportMetricsServiceRequest wire bytes -> point tuples:
      ("gauge", name, attrs, value)
      ("sum", name, attrs, value, temporality, is_monotonic)
      ("ehist", name, attrs, point_dict, temporality)
      ("unsupported", kind_name)
    """
    for f, w, rm in _read_fields(body):
        if f != 1 or w != 2:  # resource_metrics
            continue
        for f2, w2, sm in _read_fields(rm):
            if f2 != 2 or w2 != 2:  # scope_metrics
                continue
            for f3, w3, metric in _read_fields(sm):
                if f3 != 2 or w3 != 2:  # metrics
                    continue
                yield from _decode_metric(metric)


def _decode_metric(buf: bytes) -> Iterator[tuple]:
    name = ""
    datas: List[Tuple[int, bytes]] = []
    for f, w, v in _read_fields(buf):
        if f == 1 and w == 2:
            name = v.decode("utf-8", "replace")
        elif f in (5, 7, 9, 10, 11) and w == 2:
            datas.append((f, v))
    for f, data in datas:
        if f == 5:  # Gauge
            for df, dw, dp in _read_fields(data):
                if df == 1 and dw == 2:
                    attrs, value = _decode_number_point(dp)
                    yield ("gauge", name, attrs, value)
        elif f == 7:  # Sum
            temporality = TEMPORALITY_CUMULATIVE
            monotonic = False
            points = []
            for df, dw, dp in _read_fields(data):
                if df == 1 and dw == 2:
                    points.append(dp)
                elif df == 2 and dw == 0:
                    temporality = dp
                elif df == 3 and dw == 0:
                    monotonic = bool(dp)
            for dp in points:
                attrs, value = _decode_number_point(dp)
                yield ("sum", name, attrs, value, temporality, monotonic)
        elif f == 10:  # ExponentialHistogram
            temporality = TEMPORALITY_CUMULATIVE
            points = []
            for df, dw, dp in _read_fields(data):
                if df == 1 and dw == 2:
                    points.append(dp)
                elif df == 2 and dw == 0:
                    temporality = dp
            for dp in points:
                yield ("ehist", name, _decode_ehist_point(dp), temporality)
        else:
            yield ("unsupported",
                   {9: "histogram", 11: "summary"}.get(f, str(f)))


# --------------------------------------------------------------------------
# OTLP/JSON
# --------------------------------------------------------------------------


def _json_num(dp: dict) -> float:
    if "asDouble" in dp:
        return float(dp["asDouble"])
    return float(dp.get("asInt", 0))  # int64 rides as a string

_JSON_TEMPORALITY = {
    "AGGREGATION_TEMPORALITY_DELTA": TEMPORALITY_DELTA,
    "AGGREGATION_TEMPORALITY_CUMULATIVE": TEMPORALITY_CUMULATIVE,
}


def _json_temporality(v) -> int:
    if isinstance(v, str):
        return _JSON_TEMPORALITY.get(v, TEMPORALITY_CUMULATIVE)
    return int(v or TEMPORALITY_CUMULATIVE)


def _json_attrs(dp: dict) -> Dict[str, str]:
    out = {}
    for kv in dp.get("attributes", []) or []:
        key = kv.get("key", "")
        val = kv.get("value", {}) or {}
        if "stringValue" in val:
            out[key] = str(val["stringValue"])
        elif "boolValue" in val:
            out[key] = "true" if val["boolValue"] else "false"
        elif "intValue" in val:
            out[key] = str(val["intValue"])
        elif "doubleValue" in val:
            out[key] = format(float(val["doubleValue"]), "g")
    return out


def parse_export_json(body: bytes) -> Iterator[tuple]:
    """OTLP/JSON ExportMetricsServiceRequest -> the same point tuples as
    parse_export_request."""
    doc = json.loads(body)
    for rm in doc.get("resourceMetrics", []) or []:
        for sm in rm.get("scopeMetrics", []) or []:
            for metric in sm.get("metrics", []) or []:
                name = metric.get("name", "")
                if "gauge" in metric:
                    for dp in metric["gauge"].get("dataPoints", []) or []:
                        yield ("gauge", name, _json_attrs(dp),
                               _json_num(dp))
                elif "sum" in metric:
                    s = metric["sum"]
                    temp = _json_temporality(s.get("aggregationTemporality"))
                    mono = bool(s.get("isMonotonic", False))
                    for dp in s.get("dataPoints", []) or []:
                        yield ("sum", name, _json_attrs(dp), _json_num(dp),
                               temp, mono)
                elif "exponentialHistogram" in metric:
                    eh = metric["exponentialHistogram"]
                    temp = _json_temporality(
                        eh.get("aggregationTemporality"))
                    for dp in eh.get("dataPoints", []) or []:
                        point = {
                            "attrs": _json_attrs(dp),
                            "scale": int(dp.get("scale", 0)),
                            "zero_count": int(dp.get("zeroCount", 0)),
                            "pos": (int((dp.get("positive") or {})
                                        .get("offset", 0)),
                                    [int(c) for c in (dp.get("positive")
                                     or {}).get("bucketCounts", [])]),
                            "neg": (int((dp.get("negative") or {})
                                        .get("offset", 0)),
                                    [int(c) for c in (dp.get("negative")
                                     or {}).get("bucketCounts", [])]),
                        }
                        yield ("ehist", name, point, temp)
                elif "histogram" in metric:
                    yield ("unsupported", "histogram")
                elif "summary" in metric:
                    yield ("unsupported", "summary")


# --------------------------------------------------------------------------
# the source
# --------------------------------------------------------------------------


class _EHistCache:
    """Per-series previous-state cache turning CUMULATIVE exponential
    histogram points into per-interval deltas.

    A DOWNSCALE (new scale < previous — standard SDK behavior as the
    observed range grows) is NOT a reset: the previous point still
    counts, so it is re-bucketed onto the coarser scale (2^d adjacent
    buckets merge into one: index i -> i >> d) and the delta is taken
    there — treating it as a reset would re-ingest the entire
    cumulative history. An UPSCALE (finer bins — only possible after a
    restart) or any shrinking bucket IS a reset: the current point
    stands as the delta (the CumulativeDeltaCache rule, bucket-wise)."""

    def __init__(self, max_series: int = 100_000):
        self.max_series = max_series
        self._prev: Dict[tuple, dict] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _downscale(buckets: Tuple[int, List[int]],
                   d: int) -> Tuple[int, List[int]]:
        """Re-bucket (offset, counts) at scale s onto scale s-d: OTLP
        bucket index i covers (base^i, base^(i+1)] with base=2^(1/2^s),
        so at the coarser scale the covering index is floor(i / 2^d)."""
        off, counts = buckets
        if d <= 0 or not counts:
            return (off >> d if counts else 0, list(counts))
        new_off = off >> d
        out = [0] * (((off + len(counts) - 1) >> d) - new_off + 1)
        for i, c in enumerate(counts):
            out[((off + i) >> d) - new_off] += c
        return (new_off, out)

    @staticmethod
    def _delta_buckets(cur: Tuple[int, List[int]],
                       prev: Tuple[int, List[int]]):
        """Bucket-wise cur - prev by absolute index; None on any
        negative delta (a reset)."""
        c_off, c_counts = cur
        p_off, p_counts = prev
        out = []
        prev_map = {p_off + i: c for i, c in enumerate(p_counts)}
        for i, c in enumerate(c_counts):
            d = c - prev_map.get(c_off + i, 0)
            if d < 0:
                return None
            out.append(d)
        # a bucket present before but absent now is also a reset
        for idx, c in prev_map.items():
            if c and not (c_off <= idx < c_off + len(c_counts)):
                return None
        return (c_off, out)

    def delta(self, key: tuple, point: dict) -> dict:
        with self._lock:
            prev = self._prev.get(key)
            if prev is None and len(self._prev) >= self.max_series:
                logger.warning("ehist delta cache cleared at %d series",
                               len(self._prev))
                self._prev.clear()
            self._prev[key] = point
        if prev is None or prev["scale"] < point["scale"]:
            return point  # prime / upscale (restart): current stands
        d = prev["scale"] - point["scale"]
        prev_pos = self._downscale(prev["pos"], d)
        prev_neg = self._downscale(prev["neg"], d)
        dz = point["zero_count"] - prev["zero_count"]
        pos = self._delta_buckets(point["pos"], prev_pos)
        neg = self._delta_buckets(point["neg"], prev_neg)
        if dz < 0 or pos is None or neg is None:
            return point  # reset: current stands (0-clamped by nature)
        return {"attrs": point["attrs"], "scale": point["scale"],
                "zero_count": dz, "pos": pos, "neg": neg}


class OTLPSource(Source):
    """OTLP/HTTP listener (`POST /v1/metrics`, protobuf + JSON)."""

    def __init__(self, name: str, listen_address: str = "127.0.0.1:4318",
                 tags: Optional[List[str]] = None,
                 scope: MetricScope = MetricScope.MIXED):
        self._name = name
        self.listen_address = listen_address
        self.tags = list(tags or [])
        self.scope = scope
        self._ingest: Optional[Ingest] = None
        self._statsd = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._sums = CumulativeDeltaCache()
        self._ehists = _EHistCache()
        # the requests in flight, which stop() waits for (under _cv)
        self._inflight = 0
        self._cv = threading.Condition()

    def name(self) -> str:
        return self._name

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def wait_started(self, timeout: float = 10.0) -> int:
        """Block until the listener is bound; returns its port. Raises
        the bind's error, or TimeoutError."""
        if not self._started.wait(timeout):
            raise TimeoutError(f"otlp source {self._name} did not start")
        if self._start_error is not None:
            raise self._start_error
        return self.port

    # -- lifecycle -------------------------------------------------------

    def start(self, ingest: Ingest) -> None:
        self._ingest = ingest
        # the server's ScopedClient when the Ingest is a Server; sources
        # are duck-typed so a bare Ingest (tests) just skips self-metrics
        self._statsd = getattr(ingest, "statsd", None)
        host, _, port = self.listen_address.rpartition(":")
        source = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):  # noqa: N802
                source._handle(self)

        try:
            self._httpd = ThreadingHTTPServer(
                (host or "127.0.0.1", int(port)), Handler)
        except BaseException as e:
            self._start_error = e
            self._started.set()
            raise
        self._started.set()
        logger.info("otlp source %s listening on %s:%d", self._name,
                    self._httpd.server_address[0], self.port)
        self._httpd.serve_forever(poll_interval=0.2)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop serving and wait up to `timeout` for the requests in
        flight (the handler threads are daemons that server_close does
        not join)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    logger.error("otlp source %s: %d requests still in "
                                 "flight at stop", self._name,
                                 self._inflight)
                    break
                self._cv.wait(left)

    # -- self-metrics ----------------------------------------------------

    def _count(self, name_: str, n: int = 1, tags=()) -> None:
        statsd = self._statsd
        if statsd is not None:
            statsd.count(name_, n, tags=list(tags))

    # -- request handling ------------------------------------------------

    # decompressed-size guard for gzip request bodies: a 4 KB zip bomb
    # expands ~1000x, so the cap is enforced DURING streaming inflate,
    # never after (the real OTLP default collector limit neighborhood)
    GZIP_MAX_DECOMPRESSED = 64 * 1024 * 1024

    def _gunzip_bounded(self, body: bytes) -> bytes:
        """Inflate a gzip request body, raising ValueError past the
        decompressed-size bound (checked incrementally — the bomb never
        materializes in memory)."""
        import zlib
        limit = self.GZIP_MAX_DECOMPRESSED
        d = zlib.decompressobj(wbits=31)  # gzip framing
        out = d.decompress(body, limit + 1)
        if len(out) > limit or (d.unconsumed_tail
                                and len(out) >= limit):
            raise ValueError(
                f"gzip body inflates past {limit} bytes")
        return out

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        with self._cv:
            self._inflight += 1
        try:
            self._handle_request(req)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def _handle_request(self, req: BaseHTTPRequestHandler) -> None:
        if req.path.rstrip("/") != "/v1/metrics":
            req.send_error(404)
            return
        length = int(req.headers.get("Content-Length", 0) or 0)
        body = req.rfile.read(length)
        # sample-age stamp at request receipt (duck-typed: bare Ingest
        # test harnesses have no observatory)
        latency = getattr(getattr(self, "_ingest", None), "latency", None)
        if latency is not None:
            latency.note_arrival("otlp")
        encoding = (req.headers.get("Content-Encoding") or "").strip().lower()
        if encoding == "gzip":
            # real collector peers ship gzip by default
            # (otlphttpexporter compression: gzip) — without this the
            # OTLP edge only spoke to curl
            import zlib
            try:
                body = self._gunzip_bounded(body)
            except (ValueError, zlib.error) as e:
                logger.warning("rejected gzip OTLP body (%d bytes): %s",
                               len(body), e)
                self._count("otlp.gzip_rejected_total")
                req.send_error(400, explain=str(e))
                return
            self._count("otlp.gzip_requests_total")
        elif encoding and encoding != "identity":
            self._count("otlp.unsupported_encoding_total")
            req.send_error(415, explain=f"unsupported Content-Encoding: "
                                        f"{encoding}")
            return
        ctype = (req.headers.get("Content-Type") or "").split(";")[0].strip()
        is_json = ctype == "application/json"
        self._count("otlp.requests_total", 1,
                    [f"encoding:{'json' if is_json else 'protobuf'}"])
        try:
            if is_json:
                points = list(parse_export_json(body))
            else:
                points = list(parse_export_request(body))
        except Exception as e:
            logger.warning("undecodable OTLP body (%d bytes): %s",
                           len(body), e)
            self._count("otlp.parse_errors_total")
            req.send_error(400, explain=str(e))
            return
        accepted = self._ingest_points(points)
        if is_json:
            payload = b"{}"
            req.send_response(200)
            req.send_header("Content-Type", "application/json")
        else:
            payload = b""  # empty ExportMetricsServiceResponse
            req.send_response(200)
            req.send_header("Content-Type", "application/x-protobuf")
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)
        logger.debug("otlp: accepted %d points", accepted)

    # -- conversion ------------------------------------------------------

    def _emit(self, name: str, mtype: str, value, tags: List[str],
              sample_rate: float = 1.0) -> None:
        final, joined, h32, h64 = update_tags(name, mtype, tags, None)
        self._ingest.ingest_metric(UDPMetric(
            key=MetricKey(name=name, type=mtype, joined_tags=joined),
            digest=h32, digest64=h64, value=value,
            sample_rate=sample_rate, tags=final, scope=self.scope))

    def _tags(self, attrs: Dict[str, str]) -> List[str]:
        return sorted([f"{k}:{v}" for k, v in attrs.items()] + self.tags)

    def _ingest_points(self, points) -> int:
        accepted = 0
        for point in points:
            kind = point[0]
            if kind == "gauge":
                _, name, attrs, value = point
                self._emit(name, m.GAUGE, value, self._tags(attrs))
                self._count("otlp.points_total", 1, ["kind:gauge"])
                accepted += 1
            elif kind == "sum":
                _, name, attrs, value, temporality, monotonic = point
                tags = self._tags(attrs)
                if not monotonic:
                    self._emit(name, m.GAUGE, value, tags)
                elif temporality == TEMPORALITY_DELTA:
                    self._emit(name, m.COUNTER, value, tags)
                else:
                    delta = self._sums.delta((name, ",".join(tags)), value)
                    if delta is None:
                        continue  # first observation primes the cache
                    self._emit(name, m.COUNTER, delta, tags)
                self._count("otlp.points_total", 1, ["kind:sum"])
                accepted += 1
            elif kind == "ehist":
                _, name, pt, temporality = point
                tags = self._tags(pt["attrs"])
                if temporality == TEMPORALITY_CUMULATIVE:
                    pt = self._ehists.delta((name, ",".join(tags)), pt)
                self._ingest_ehist(name, pt, tags)
                self._count("otlp.points_total", 1,
                            ["kind:exponential_histogram"])
                accepted += 1
            else:
                self._count("otlp.points_dropped_total", 1,
                            [f"kind:{point[1]}"])
        return accepted

    def _ingest_ehist(self, name: str, point: dict,
                      tags: List[str]) -> None:
        """Exponential-histogram buckets -> llhist samples: bucket i at
        scale s covers (2^(i/2^s), 2^((i+1)/2^s)]; its count lands at
        the geometric midpoint 2^((i+0.5)/2^s). Relative bucket width
        is <= 2^(1/2^s)-1, below the llhist's own 10% bin width for
        every scale >= 3, so the mapping does not dominate the family's
        representation error."""
        base = 2.0 ** (2.0 ** -float(point["scale"]))
        if point["zero_count"] > 0:
            self._emit_weighted(name, 0.0, tags, point["zero_count"])
        for sign, (offset, counts) in (
                (1.0, point["pos"]), (-1.0, point["neg"])):
            for i, cnt in enumerate(counts):
                if cnt <= 0:
                    continue
                rep = sign * base ** (offset + i + 0.5)
                self._emit_weighted(name, rep, tags, cnt)

    # the sample_rate channel carries the bucket count as 1/count, and
    # the columnstore's rate floor (1e-9) silently caps a single
    # sample's weight at 1e9 — a cumulative prime of a long-lived
    # series can exceed that, so bigger counts emit in chunks
    _MAX_WEIGHT = 10 ** 9

    def _emit_weighted(self, name: str, value: float, tags: List[str],
                       count: int) -> None:
        while count > 0:
            chunk = min(count, self._MAX_WEIGHT)
            self._emit(name, m.LLHIST, value, tags,
                       sample_rate=1.0 / chunk)
            count -= chunk


@register_source("otlp")
def _factory(source_config, server_config):
    c = source_config.config
    scope = {"local": MetricScope.LOCAL_ONLY,
             "global": MetricScope.GLOBAL_ONLY}.get(
        c.get("scope", ""), MetricScope.MIXED)
    return OTLPSource(
        source_config.name or "otlp",
        listen_address=c.get("listen_address", "127.0.0.1:4318"),
        tags=list(source_config.tags or []),
        scope=scope)
