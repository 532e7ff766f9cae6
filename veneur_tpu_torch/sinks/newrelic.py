"""New Relic sink: metrics and spans via the telemetry ingest APIs.

Behavioral parity with reference sinks/newrelic/*.go (484 LoC), which
wraps the NR telemetry SDK. The telemetry SDK's wire format is plain
JSON over HTTPS, implemented here directly:
- metrics -> POST https://metric-api.newrelic.com/metric/v1
  [{"common": {...}, "metrics": [{name, type, value, timestamp, attributes}]}]
- spans   -> POST https://trace-api.newrelic.com/trace/v1
  [{"common": {...}, "spans": [{id, trace.id, timestamp, attributes}]}]
Both carry the Api-Key header; counters submit as NR "count" with the
flush interval, gauges as "gauge".

A copy of veneur_tpu/sinks/newrelic.py.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Sequence

from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import (MetricSink, SpanSink, register_metric_sink,
                                    register_span_sink)
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.newrelic")


def _attributes(tags: Sequence[str]) -> dict:
    out = {}
    for t in tags:
        k, _, v = t.partition(":")
        out[k] = v or True
    return out


DEFAULT_EVENT_TYPE = "veneur"  # reference newrelic.go:15
DEFAULT_SERVICE_CHECK_EVENT_TYPE = "veneurCheck"  # newrelic.go:16
_STATUS_NAMES = {0: "OK", 1: "WARNING", 2: "CRITICAL"}  # else UNKNOWN


class NewRelicMetricSink(MetricSink):
    def __init__(self, name: str, insert_key: str, hostname: str,
                 interval: float, metric_url: str, tags: Sequence[str] = (),
                 timeout: float = 10.0, account_id: int = 0,
                 event_type: str = DEFAULT_EVENT_TYPE,
                 service_check_event_type: str =
                 DEFAULT_SERVICE_CHECK_EVENT_TYPE,
                 event_url: str = ""):
        self._name = name
        self.insert_key = insert_key
        self.hostname = hostname
        self.interval = interval
        self.metric_url = metric_url
        self.common_tags = _attributes(tags)
        self.timeout = timeout
        # custom-event plane: service checks and DogStatsD events go to
        # the account-scoped Events API (reference metric.go:92,173-196;
        # the NR SDK's BatchMode needs the account id)
        self.account_id = account_id
        self.event_type = event_type or DEFAULT_EVENT_TYPE
        self.service_check_event_type = (
            service_check_event_type or DEFAULT_SERVICE_CHECK_EVENT_TYPE)
        self.event_url = event_url or (
            f"https://insights-collector.newrelic.com/v1/accounts/"
            f"{account_id}/events" if account_id else "")

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "newrelic"

    def _post_events(self, events: List[dict], what: str) -> None:
        if not events:
            return
        if not self.event_url:
            logger.warning("%d %s queued but New Relic event client "
                           "disabled (no account_id), dropping",
                           len(events), what)
            return
        try:
            vhttp.post_json(self.event_url, events,
                            headers={"Api-Key": self.insert_key},
                            compress="gzip", timeout=self.timeout)
        except Exception as e:
            logger.error("newrelic event POST failed: %s", e)

    def flush(self, metrics: List[InterMetric]) -> None:
        out = []
        checks = []
        for m in metrics:
            if m.type == MetricType.STATUS:
                # service checks -> custom events with status name
                # (reference metric.go:173-196)
                code = int(m.value)
                checks.append({
                    "eventType": self.service_check_event_type,
                    "name": m.name,
                    "timestamp": m.timestamp,
                    "statusCode": code,
                    "status": _STATUS_NAMES.get(code, "UNKNOWN"),
                    "host": m.hostname or self.hostname,
                    **_attributes(m.tags),
                })
                continue
            entry = {
                "name": m.name,
                "value": m.value,
                "timestamp": m.timestamp,
                "attributes": {"host": m.hostname or self.hostname,
                               **_attributes(m.tags)},
            }
            if m.type == MetricType.COUNTER:
                entry["type"] = "count"
                entry["interval.ms"] = int(self.interval * 1000)
            else:
                entry["type"] = "gauge"
            out.append(entry)
        self._post_events(checks, "service checks")
        if not out:
            return
        payload = [{"common": {"attributes": self.common_tags},
                    "metrics": out}]
        try:
            vhttp.post_json(self.metric_url, payload,
                            headers={"Api-Key": self.insert_key},
                            compress="gzip", timeout=self.timeout)
        except Exception as e:
            logger.error("newrelic metric POST failed: %s", e)

    def flush_other_samples(self, samples: Sequence) -> None:
        """DogStatsD events -> NR custom events with the configured
        eventType and flattened tags (reference metric.go:210-246)."""
        events = []
        for s in samples:
            evt = {
                "eventType": self.event_type,
                "name": getattr(s, "name", ""),
                "timestamp": getattr(s, "timestamp", 0),
                "message": getattr(s, "message", ""),
            }
            for k, v in dict(getattr(s, "tags", {}) or {}).items():
                evt[k] = v
            events.append(evt)
        self._post_events(events, "events")


class NewRelicSpanSink(SpanSink):
    def __init__(self, name: str, insert_key: str, trace_url: str,
                 common_tags: Sequence[str] = (), timeout: float = 10.0,
                 max_buffered: int = 16384):
        self._name = name
        self.insert_key = insert_key
        self.trace_url = trace_url
        self.common_tags = _attributes(common_tags)
        self.timeout = timeout
        self._spans: List[dict] = []
        self._lock = threading.Lock()
        # bounded between flushes; overflow drops (and counts) rather
        # than growing without limit under sustained span load
        self.max_buffered = max_buffered
        self.dropped_total = 0

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "newrelic"

    def ingest(self, span) -> None:
        with self._lock:
            if len(self._spans) >= self.max_buffered:
                self.dropped_total += 1
                return
        duration_ms = max(span.end_timestamp - span.start_timestamp, 0) / 1e6
        entry = {
            "id": format(span.id & ((1 << 64) - 1), "x"),
            "trace.id": format(span.trace_id & ((1 << 64) - 1), "x"),
            "timestamp": span.start_timestamp // 10**6,
            "attributes": {
                "name": span.name,
                "service.name": span.service,
                "duration.ms": duration_ms,
                "error": bool(span.error),
                **dict(span.tags),
            },
        }
        if span.parent_id:
            entry["attributes"]["parent.id"] = format(
                span.parent_id & ((1 << 64) - 1), "x")
        with self._lock:
            if len(self._spans) >= self.max_buffered:
                self.dropped_total += 1
                return
            self._spans.append(entry)
        # (bound re-checked above after building the entry: another
        # thread may have filled the buffer in between)

    def flush(self) -> None:
        flush_start = time.perf_counter()
        dropped = 0
        with self._lock:
            spans, self._spans = self._spans, []
            # reset only once the count can actually be reported, so an
            # operator inspecting dropped_total without a statsd client
            # still sees the cumulative number
            if (getattr(self, "_statsd", None) is not None
                    and self.dropped_total):
                dropped, self.dropped_total = self.dropped_total, 0
        if not spans:
            self.emit_flush_self_metrics(0, flush_start, dropped)
            return
        payload = [{"common": {"attributes": self.common_tags},
                    "spans": spans}]
        try:
            vhttp.post_json(self.trace_url, payload,
                            headers={"Api-Key": self.insert_key},
                            compress="gzip", timeout=self.timeout)
        except Exception as e:
            logger.error("newrelic trace POST failed: %s", e)
            self.emit_flush_self_metrics(0, flush_start,
                                         dropped + len(spans))
            return
        self.emit_flush_self_metrics(len(spans), flush_start, dropped)


@register_metric_sink("newrelic")
def _metric_factory(sink_config, server_config):
    c = sink_config.config
    return NewRelicMetricSink(
        sink_config.name or "newrelic",
        insert_key=str(c.get("insert_key", "")),
        hostname=server_config.hostname,
        interval=server_config.interval,
        metric_url=c.get("metric_url",
                         "https://metric-api.newrelic.com/metric/v1"),
        tags=c.get("common_tags", []) or [],
        account_id=int(c.get("account_id", 0)),
        event_type=c.get("event_type", DEFAULT_EVENT_TYPE),
        service_check_event_type=c.get(
            "service_check_event_type", DEFAULT_SERVICE_CHECK_EVENT_TYPE),
        event_url=c.get("event_url", ""))


@register_span_sink("newrelic")
def _span_factory(sink_config, server_config):
    c = sink_config.config
    # trace_observer_url (Infinite Tracing) overrides the standard trace
    # API endpoint when set (reference span.go:22,62)
    trace_url = (c.get("trace_observer_url", "")
                 or c.get("trace_url",
                          "https://trace-api.newrelic.com/trace/v1"))
    return NewRelicSpanSink(
        sink_config.name or "newrelic",
        insert_key=str(c.get("insert_key", "")),
        trace_url=trace_url,
        common_tags=c.get("common_tags", []) or [],
        max_buffered=int(c.get("span_buffer_max", 16384)))
