"""AWS X-Ray sink: spans as segment JSON over UDP to the X-Ray daemon.

Behavioral parity with reference sinks/xray/xray.go (307 LoC): each span
becomes an X-Ray segment document prefixed with the daemon header line
`{"format": "json", "version": 1}\\n`, sent as one UDP datagram to the
local daemon. Trace ids render in X-Ray's `1-<epoch hex>-<24 hex>`
format; spans sample by trace id percentage; annotations come from a
configured tag allowlist.

A copy of veneur_tpu/sinks/xray.py."""

from __future__ import annotations

import json
import logging
import socket
from typing import Optional, Sequence

from veneur_tpu_torch.sinks import SpanSink, register_span_sink

logger = logging.getLogger("veneur_tpu_torch.sinks.xray")

HEADER = b'{"format": "json", "version": 1}\n'


def xray_trace_id(span) -> str:
    """X-Ray trace id: 1-{epoch:8hex}-{traceid:24hex}. Segments only
    assemble into one trace when their ids match, so the timestamp
    component comes from the root span when the client sent one
    (exact, like the reference), else from a ~4-minute bucket of the
    span's own start (low byte of the epoch seconds cleared). Exact
    parity with reference xray.go:290-306, including its caveats:
    bucketing is probabilistic (spans straddling a 256 s boundary split)
    and a trace whose root lacks root_start_timestamp while children
    carry it splits — clients fix both by always setting the field."""
    root_ns = getattr(span, "root_start_timestamp", 0)
    if root_ns:
        epoch = root_ns // 10**9
    else:
        epoch = (span.start_timestamp // 10**9) & 0xFFFFFFFFFFFF00
    tid = span.trace_id & ((1 << 96) - 1)
    return f"1-{epoch & 0xFFFFFFFF:08x}-{tid:024x}"


def span_to_segment(span, annotation_tags: Sequence[str]) -> dict:
    tags = dict(span.tags)
    seg = {
        "name": (span.service or "unknown")[:200],
        "id": format(span.id & ((1 << 64) - 1), "016x"),
        "trace_id": xray_trace_id(span),
        "start_time": span.start_timestamp / 1e9,
        "end_time": span.end_timestamp / 1e9,
        "error": bool(span.error),
        "annotations": {k.replace("-", "_"): v for k, v in tags.items()
                        if k in annotation_tags},
        "metadata": {"name": span.name, "tags": tags},
    }
    if span.parent_id:
        seg["parent_id"] = format(span.parent_id & ((1 << 64) - 1), "016x")
        seg["type"] = "subsegment"
    return seg


class XRaySpanSink(SpanSink):
    def __init__(self, name: str, daemon_address: str,
                 sample_percentage: float = 100.0,
                 annotation_tags: Sequence[str] = ()):
        self._name = name
        host, _, port = daemon_address.rpartition(":")
        self.daemon_addr = (host or "127.0.0.1", int(port))
        self.sample_threshold = int(sample_percentage * 100)
        self.annotation_tags = list(annotation_tags)
        self._sock: Optional[socket.socket] = None
        self.spans_handled = 0
        self.spans_dropped = 0

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "xray"

    def start(self, server) -> None:
        super().start(server)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def ingest(self, span) -> None:
        if self._sock is None:
            return
        if (span.trace_id % 10_000) >= self.sample_threshold:
            self.spans_dropped += 1
            return
        seg = span_to_segment(span, self.annotation_tags)
        try:
            self._sock.sendto(
                HEADER + json.dumps(seg, separators=(",", ":")).encode(),
                self.daemon_addr)
            self.spans_handled += 1
        except OSError as e:
            logger.error("xray daemon send failed: %s", e)
            self.spans_dropped += 1

    def stop(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


@register_span_sink("xray")
def _factory(sink_config, server_config):
    c = sink_config.config
    return XRaySpanSink(
        sink_config.name or "xray",
        daemon_address=c.get("address", "127.0.0.1:2000"),
        sample_percentage=float(c.get("sample_percentage", 100.0)),
        annotation_tags=c.get("annotation_tags", []) or [])
