"""Datadog sink: metrics, events, service checks, and APM spans.

Behavioral parity with reference sinks/datadog/datadog.go (660 LoC),
copied from veneur_tpu/sinks/datadog.py:
- InterMetrics serialize to DDMetric JSON; counters convert to Datadog
  "rate" (value/interval) (datadog.go DDMetric conversion), gauges stay
  gauges, status checks go to /api/v1/check_run.
- A flush is chunked across `flush_max_per_body` and POSTed in parallel
  (reference chunks across num_workers goroutines, datadog.go:182-207).
- `device:` / `host:` magic tags move into dedicated DDMetric fields.
- Events (from flush_other_samples) post to the events intake.
- `flush_batch` encodes straight from the FlushBatch columns
  (core/egress.py) and falls back to `materialize()` if that raises.
- Spans buffer in a bounded ring (2^14, reference datadog.go spanBuffer)
  and flush to the APM traces endpoint.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Sequence

from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import (MetricSink, SpanSink, register_metric_sink,
                                    register_span_sink)
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.datadog")

DATADOG_SPAN_BUFFER_CAP = 1 << 14  # reference datadog.go datadogSpanBufferSize


class DatadogMetricSink(MetricSink):
    def __init__(self, name: str, api_key: str, api_url: str, hostname: str,
                 interval: float, flush_max_per_body: int = 25_000,
                 num_workers: int = 4, tags: Sequence[str] = (),
                 metric_name_prefix_drops: Sequence[str] = (),
                 excluded_tag_prefixes: Sequence[str] = (),
                 exclude_tags_prefix_by_prefix_metric: Dict[str, Sequence[str]] = None,
                 timeout: float = 10.0):
        self._name = name
        self.api_key = api_key
        self.api_url = api_url.rstrip("/")
        self.hostname = hostname
        self.interval = max(interval, 1e-9)
        self.flush_max_per_body = flush_max_per_body
        self.num_workers = num_workers
        self.tags = list(tags)
        # reference datadog.go:313-317: drop whole metrics by name prefix
        self.metric_name_prefix_drops = list(metric_name_prefix_drops)
        # reference datadog.go:345-352: drop tags by prefix, globally
        self.excluded_tag_prefixes = list(excluded_tag_prefixes)
        # reference datadog.go:323-331: per-metric-prefix tag exclusion
        self.exclude_tags_prefix_by_prefix_metric = dict(
            exclude_tags_prefix_by_prefix_metric or {})
        self.timeout = timeout
        self._encoder = None  # DatadogColumnarEncoder, built lazily

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "datadog"

    # -- serialization ----------------------------------------------------

    def _dd_metric(self, m: InterMetric) -> Dict[str, Any]:
        tags = list(self.tags)
        host = m.hostname or self.hostname
        device = ""
        per_metric_excludes: Sequence[str] = ()
        for prefix, excludes in self.exclude_tags_prefix_by_prefix_metric.items():
            if m.name.startswith(prefix):
                per_metric_excludes = excludes
                break
        for t in m.tags:
            if t.startswith("host:"):
                host = t[5:]
            elif t.startswith("device:"):
                device = t[7:]
            elif (any(t.startswith(p) for p in self.excluded_tag_prefixes)
                  or any(t.startswith(p) for p in per_metric_excludes)):
                continue
            else:
                tags.append(t)
        if m.type == MetricType.COUNTER:
            # Datadog rate: counts divide by the flush interval
            dd_type, value = "rate", m.value / self.interval
        else:
            dd_type, value = "gauge", m.value
        out = {
            "metric": m.name,
            "points": [[m.timestamp, value]],
            "type": dd_type,
            "host": host,
            "interval": int(self.interval) or 1,
            "tags": tags,
        }
        if device:
            out["device"] = device
        return out

    # -- flush ------------------------------------------------------------

    def flush(self, metrics: List[InterMetric]) -> None:
        import time as _time

        # single encode pass: name-prefix drop, status split, and
        # series conversion fold into one scan of the metric list
        t0 = _time.perf_counter()
        drops = self.metric_name_prefix_drops
        checks: List[InterMetric] = []
        series: List[dict] = []
        for m in metrics:
            if drops and any(m.name.startswith(p) for p in drops):
                continue
            if m.type == MetricType.STATUS:
                checks.append(m)
            else:
                series.append(self._dd_metric(m))
        encode_s = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        if series:
            chunks = [series[i:i + self.flush_max_per_body]
                      for i in range(0, len(series), self.flush_max_per_body)]
            self._post_parallel(chunks, self._post_series_safe)
        self._post_checks(checks)
        self.note_egress(encode_s, _time.perf_counter() - t1,
                         encoder="legacy")

    def flush_batch(self, batch) -> None:
        try:
            self.flush_columnar(batch)
        except Exception:
            logger.exception("datadog columnar flush failed; "
                             "falling back to materialize()")
            self.flush(batch.materialize())

    def flush_columnar(self, batch) -> None:
        """Columnar fast path: pre-encoded JSON series parts straight
        from the FlushBatch arrays (core/egress.py), gzip-POSTed as raw
        bodies — no per-InterMetric dicts, no json.dumps of the flush.
        The egress report's `gzip_s` is the series bodies' gzip seconds,
        summed over the bodies (a part of `send_s`). While the span
        recorder (core/profiling.py) is armed, the encode is the span
        `sink.encode`; util/http.py's post adds `sink.gzip` and
        `sink.post` for each body."""
        import time as _time

        from veneur_tpu_torch.core.egress import DatadogColumnarEncoder

        t0 = _time.perf_counter()
        enc = self._encoder
        if enc is None:
            enc = self._encoder = DatadogColumnarEncoder(self)
        parts, checks = enc.encode(batch)
        t1 = _time.perf_counter()
        if profiling.armed:
            profiling.record("sink.encode", t0, t1, {"series": len(parts)})
        gzip_seconds: List[float] = []
        if parts:
            bodies = [b'{"series":[' +
                      b",".join(parts[i:i + self.flush_max_per_body]) +
                      b"]}"
                      for i in range(0, len(parts),
                                     self.flush_max_per_body)]
            self._post_parallel(bodies, lambda body: (
                self._post_series_body_safe(body, gzip_seconds)))
        self._post_checks(checks)
        self.note_egress(t1 - t0, _time.perf_counter() - t1,
                         gzip_s=sum(gzip_seconds))

    def _post_parallel(self, chunks, post_one) -> None:
        # concurrency capped at num_workers POSTs (reference
        # datadog.go:182-207 chunks a flush across num_workers)
        it = iter(chunks)

        def worker():
            while True:
                try:
                    chunk = next(it)
                except StopIteration:
                    return
                post_one(chunk)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, len(chunks)) - 1)]
        for t in threads:
            t.start()
        worker()
        for t in threads:
            t.join()

    def _post_checks(self, checks: List[InterMetric]) -> None:
        for check in checks:
            self._post_safe("/api/v1/check_run", {
                "check": check.name,
                "host_name": check.hostname or self.hostname,
                "status": int(check.value),
                "message": check.message,
                "timestamp": check.timestamp,
                "tags": list(self.tags) + list(check.tags),
            })

    def _post_series_body_safe(self, body: bytes,
                               gzip_seconds: List[float]) -> None:
        url = f"{self.api_url}/api/v1/series?api_key={self.api_key}"
        try:
            vhttp.post(url, body, compress="gzip", timeout=self.timeout,
                       gzip_seconds=gzip_seconds)
        except Exception as e:
            logger.error("datadog POST /api/v1/series failed: %s", e)

    def _post_series_safe(self, series: List[dict]) -> None:
        self._post_safe("/api/v1/series", {"series": series})

    def _post_safe(self, path: str, payload: dict) -> None:
        url = f"{self.api_url}{path}?api_key={self.api_key}"
        try:
            vhttp.post_json(url, payload, compress="gzip",
                            timeout=self.timeout)
        except Exception as e:
            logger.error("datadog POST %s failed: %s", path, e)

    # -- events / service checks -----------------------------------------

    def flush_other_samples(self, samples: Sequence[Any]) -> None:
        """DogStatsD events -> the nonpublic events intake (reference
        datadog.go FlushOtherSamples)."""
        events = []
        for s in samples:
            tags = dict(getattr(s, "tags", {}) or {})
            events.append({
                "title": getattr(s, "name", ""),
                "text": getattr(s, "message", ""),
                "date_happened": getattr(s, "timestamp", 0),
                "hostname": tags.pop("host", self.hostname),
                "aggregation_key": tags.pop("aggregation_key", ""),
                "priority": tags.pop("priority", "normal"),
                "source_type_name": tags.pop("source_type_name", ""),
                "alert_type": tags.pop("alert_type", "info"),
                "tags": [f"{k}:{v}" if v else k for k, v in tags.items()]
                + list(self.tags),
            })
        if events:
            self._post_safe("/intake", {"events": {self._name: events}})


# timestamp plausibility window, adapted to this pipeline's nanosecond
# span timestamps (the reference's constants at datadog.go:536-538 target
# second-scale values): spans outside 2001..2100 count as scale errors
_SPAN_TS_TOO_EARLY = 978_307_200 * 10**9
_SPAN_TS_TOO_LATE = 4_102_444_800 * 10**9

_DD_SPAN_TYPE = "web"  # reference datadog.go:31 datadogSpanType
_DD_RESOURCE_KEY = "resource"  # datadog.go:27


class DatadogSpanSink(SpanSink):
    """Bounded span ring -> Datadog APM traces (reference datadog.go
    span path, :453-660): the ring overwrites its oldest entry when full
    (overflow is counted, not blocked on), flush converts each span to
    the DD trace-span shape — resource tag promoted out of meta with an
    "unknown" default, root spans get parent_id 0, errors map to code 2,
    span type "web" — groups spans by trace id, and PUTs the
    two-dimensional trace array uncompressed (the traces endpoint does
    not accept compressed bodies). Flush self-metrics match the
    reference sink keys: sink.spans_flushed_total (tagged per service)
    and sink.span_flush_total_duration_ns."""

    def __init__(self, name: str, trace_api_url: str, hostname: str,
                 buffer_size: int = DATADOG_SPAN_BUFFER_CAP,
                 timeout: float = 10.0):
        self._name = name
        self.trace_api_url = trace_api_url.rstrip("/")
        self.hostname = hostname
        self.buffer: "collections.deque" = collections.deque(maxlen=buffer_size)
        self.timeout = timeout
        self._lock = threading.Lock()
        self.overwritten_total = 0  # ring overflow accounting
        self.timestamp_errors = 0

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "datadog"

    def ingest(self, span) -> None:
        if not span.trace_id:
            return
        with self._lock:
            if len(self.buffer) == self.buffer.maxlen:
                # ring semantics: the append below evicts the oldest
                self.overwritten_total += 1
            self.buffer.append(span)

    def ingest_many(self, spans) -> None:
        good = [s for s in spans if s.trace_id]
        if not good:
            return
        with self._lock:
            room = self.buffer.maxlen - len(self.buffer)
            if len(good) > room:
                self.overwritten_total += len(good) - room
            self.buffer.extend(good)

    def _to_dd_span(self, s) -> dict:
        meta = dict(s.tags)
        resource = meta.pop(_DD_RESOURCE_KEY, "") or "unknown"
        if (s.start_timestamp < _SPAN_TS_TOO_EARLY
                or s.start_timestamp > _SPAN_TS_TOO_LATE):
            self.timestamp_errors += 1
        return {
            "trace_id": s.trace_id,
            "span_id": s.id,
            "parent_id": max(s.parent_id, 0),  # root spans -> 0
            "service": s.service,
            "name": s.name or "unknown",
            "resource": resource,
            "start": s.start_timestamp,
            "duration": max(s.end_timestamp - s.start_timestamp, 0),
            "type": _DD_SPAN_TYPE,
            "error": 2 if s.error else 0,
            "meta": meta,
            # numeric span tags; always present in the DD wire shape
            # (reference DatadogTraceSpan.Metrics, datadog.go:434)
            "metrics": {},
        }

    def flush(self) -> None:
        flush_start = time.perf_counter()
        with self._lock:
            spans, self.buffer = list(self.buffer), collections.deque(
                maxlen=self.buffer.maxlen)
        if not spans:
            return
        traces: Dict[int, List[dict]] = {}
        service_counts: Dict[str, int] = {}
        for s in spans:
            traces.setdefault(s.trace_id, []).append(self._to_dd_span(s))
            service_counts[s.service] = service_counts.get(s.service, 0) + 1
        try:
            vhttp.put_json(f"{self.trace_api_url}/v0.3/traces",
                           list(traces.values()), timeout=self.timeout)
        except Exception as e:
            logger.error("datadog trace PUT failed: %s", e)
            return
        statsd = getattr(self, "_statsd", None)
        if statsd is not None:
            # per-service flushed counts are datadog-specific (reference
            # datadog.go:654); duration + ring-overwrite drops go through
            # the shared helper
            for service, count in service_counts.items():
                statsd.count(
                    "sink.spans_flushed_total", count,
                    tags=[f"sink:{self._name}", f"service:{service}"])
            ts_errors, self.timestamp_errors = self.timestamp_errors, 0
            if ts_errors:
                statsd.count(
                    "worker.trace.sink.timestamp_error", ts_errors,
                    tags=[f"sink:{self._name}"])
            dropped, self.overwritten_total = self.overwritten_total, 0
            if dropped:
                statsd.count("sink.spans_dropped_total", dropped,
                             tags=[f"sink:{self._name}"])
            statsd.gauge(
                "sink.span_flush_total_duration_ns",
                int((time.perf_counter() - flush_start) * 1e9),
                tags=[f"sink:{self._name}"])


@register_metric_sink("datadog")
def _metric_factory(sink_config, server_config):
    c = sink_config.config
    return DatadogMetricSink(
        sink_config.name or "datadog",
        api_key=str(c.get("datadog_api_key", c.get("api_key", ""))),
        api_url=c.get("datadog_api_hostname",
                      c.get("api_hostname",
                            "https://app.datadoghq.com")),
        hostname=server_config.hostname,
        interval=server_config.interval,
        flush_max_per_body=int(c.get("datadog_flush_max_per_body", 25_000)),
        num_workers=int(c.get("datadog_num_workers",
                              server_config.num_workers) or 4),
        tags=c.get("tags", []) or [],
        metric_name_prefix_drops=c.get(
            "datadog_metric_name_prefix_drops", []) or [],
        excluded_tag_prefixes=c.get("datadog_excluded_tags", []) or [],
        exclude_tags_prefix_by_prefix_metric={
            str(e.get("metric_prefix", "")): list(e.get("tags", []) or [])
            for e in (c.get(
                "datadog_exclude_tags_prefix_by_prefix_metric", []) or [])})


@register_span_sink("datadog")
def _span_factory(sink_config, server_config):
    c = sink_config.config
    return DatadogSpanSink(
        sink_config.name or "datadog",
        trace_api_url=c.get("datadog_trace_api_address",
                            "http://127.0.0.1:8126"),
        hostname=server_config.hostname,
        buffer_size=int(c.get("datadog_span_buffer_size",
                              DATADOG_SPAN_BUFFER_CAP)))
