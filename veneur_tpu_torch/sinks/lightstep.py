"""LightStep sink: spans to a LightStep / ServiceNow Cloud Observability
collector over OTLP/HTTP JSON.

Behavioral parity with reference sinks/lightstep/lightstep.go (264 LoC)
for buffering, striping, and accounting: the reference wraps the
official LightStep tracer library (one buffer per tracer client,
`lightstep_num_clients` stripes keyed by trace id, MaxBufferedSpans
overflow drops, flush-time delivery). The tracer's proprietary
collector protocol was retired by the vendor in favor of OTLP, which
current LightStep/ServiceNow collectors ingest natively at /v1/traces
(access token in the `lightstep-access-token` header) — so this rebuild
speaks OTLP/HTTP JSON, the OpenTelemetry ExportTraceServiceRequest
shape. The payload schema is pinned in tests/test_vendor_payloads.py.

A copy of veneur_tpu/sinks/lightstep.py."""

from __future__ import annotations

import logging
import threading
from typing import List

from veneur_tpu_torch.sinks import SpanSink, register_span_sink
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sinks.lightstep")


def _hex_id(value: int, width: int) -> str:
    """OTLP JSON carries trace/span ids as fixed-width lowercase hex
    (16 bytes / 8 bytes); SSF ids are 64-bit, so trace ids zero-extend
    into the high 8 bytes."""
    return format(value & ((1 << 64) - 1), f"0{width}x")


def span_to_otlp(span) -> dict:
    """One SSF span -> one OTLP JSON Span object (trace.v1.Span)."""
    attributes = [
        {"key": k, "value": {"stringValue": str(v)}}
        for k, v in dict(span.tags).items()
    ]
    out = {
        "traceId": _hex_id(span.trace_id, 32),
        "spanId": _hex_id(span.id, 16),
        "name": span.name or "unknown",
        # SPAN_KIND_INTERNAL: SSF spans carry no client/server direction
        "kind": 1,
        "startTimeUnixNano": str(span.start_timestamp),
        "endTimeUnixNano": str(span.end_timestamp),
        "attributes": attributes,
    }
    if span.parent_id:
        out["parentSpanId"] = _hex_id(span.parent_id, 16)
    if span.error:
        out["status"] = {"code": 2}  # STATUS_CODE_ERROR
    if span.indicator:
        attributes.append(
            {"key": "indicator", "value": {"boolValue": True}})
    return out


class LightStepSpanSink(SpanSink):
    def __init__(self, name: str, access_token: str, collector_url: str,
                 num_clients: int = 1, timeout: float = 10.0,
                 maximum_spans: int = 0):
        self._name = name
        self.access_token = access_token
        # one buffer per "client" stripe, keyed by trace id, mirroring the
        # reference's multiple tracer clients (lightstep.go)
        self.num_clients = max(1, num_clients)
        # explicit YAML null reaches here as None; flush() skips falsy
        self.collector_url = (collector_url or "").rstrip("/")
        self.timeout = timeout
        self._buffers: List[List[dict]] = [[] for _ in range(self.num_clients)]
        self._lock = threading.Lock()
        self.spans_handled = 0
        # lightstep_maximum_spans -> the tracer's MaxBufferedSpans
        # (lightstep.go:117); enforced per client stripe between flushes
        self.maximum_spans = maximum_spans
        self.dropped_total = 0

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "lightstep"

    def ingest(self, span) -> None:
        otlp = span_to_otlp(span)
        otlp["_service"] = span.service or "unknown"  # grouped at flush
        with self._lock:
            buf = self._buffers[span.trace_id % self.num_clients]
            if self.maximum_spans and len(buf) >= self.maximum_spans:
                self.dropped_total += 1
                return
            buf.append(otlp)
            self.spans_handled += 1

    def _report_of(self, spans: List[dict]) -> dict:
        """Buffered spans -> one ExportTraceServiceRequest: spans group
        into a resourceSpans entry per service.name (OTLP's resource is
        the emitting entity; SSF carries it per span)."""
        by_service: dict = {}
        for s in spans:
            by_service.setdefault(s.pop("_service"), []).append(s)
        return {"resourceSpans": [
            {
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": service}},
                ]},
                "scopeSpans": [{
                    "scope": {"name": "veneur-tpu"},
                    "spans": group,
                }],
            }
            for service, group in sorted(by_service.items())
        ]}

    def flush(self) -> None:
        import time as _time

        flush_start = _time.perf_counter()
        with self._lock:
            buffers = self._buffers
            self._buffers = [[] for _ in range(self.num_clients)]
        sent = 0
        total = sum(len(spans) for spans in buffers)
        for spans in buffers:
            if not spans or not self.collector_url:
                continue
            payload = self._report_of(spans)
            try:
                vhttp.post_json(f"{self.collector_url}/v1/traces",
                                payload, compress="gzip",
                                timeout=self.timeout,
                                headers={"lightstep-access-token":
                                         self.access_token})
                sent += len(spans)
            except Exception as e:
                logger.error("lightstep report failed: %s", e)
        # spans swapped out but not delivered are gone: count as drops,
        # along with ingest-side maximum_spans overflow
        with self._lock:
            overflow, self.dropped_total = self.dropped_total, 0
        self.emit_flush_self_metrics(
            sent, flush_start, (total - sent) + overflow)


@register_span_sink("lightstep")
def _factory(sink_config, server_config):
    c = sink_config.config
    # lightstep_reconnect_period tunes the reference tracer's transport
    # recycling; this HTTP reporter opens a fresh connection per flush,
    # so the knob is accepted for config compatibility and has nothing
    # to recycle
    return LightStepSpanSink(
        sink_config.name or "lightstep",
        access_token=str(c.get("lightstep_access_token",
                               c.get("access_token", ""))),
        collector_url=c.get("lightstep_collector_host",
                            c.get("collector_host", "")),
        num_clients=int(c.get("lightstep_num_clients",
                              c.get("num_clients", 1))),
        maximum_spans=int(c.get("lightstep_maximum_spans", 0)))
