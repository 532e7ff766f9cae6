"""Sink plugin boundary.

Interface parity with reference sinks/sinks.go:42-103: metric sinks receive
plain host-side InterMetrics per flush (the device column store is invisible
to them), span sinks ingest SSF spans (in chunks, from the server's span
sink workers) and flush per interval. Factories register by kind in
MetricSinkTypes and SpanSinkTypes (reference server.go:62-91).

A sink that encodes straight from the FlushBatch columns reports its
encode-vs-send split through `note_egress` (with the gzip's share of the
send, where the sink measures it); the server copies the last report
into its `last_flush_timings` under `sink:<name>`, and the owning
server's latency observatory takes it as the sink's `egress.encode_s` /
`egress.send_s` rows (and `egress.gzip_s`). (The JAX package also tags
the ambient flush span with it.)
"""

from __future__ import annotations

import abc
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from veneur_tpu_torch.samplers.metrics import InterMetric

_logger = logging.getLogger("veneur_tpu_torch.sinks")


class MetricSink(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def kind(self) -> str: ...

    # the last flush's (encode_s, send_s, encoder, gzip_s), or None
    last_egress: Optional[
        Tuple[float, float, str, Optional[float]]] = None
    # the owning server's latency observatory, bound at start()
    _latency = None

    def start(self, server) -> None:  # noqa: B027
        self.bind_server(server)

    def bind_server(self, server) -> None:
        """Capture what the sink reads of its owning server: its latency
        observatory. Sinks that override start() call this first."""
        self._latency = getattr(server, "latency", None)

    @abc.abstractmethod
    def flush(self, metrics: List[InterMetric]) -> None: ...

    def flush_batch(self, batch) -> None:
        """Receive a columnar FlushBatch (core/flusher.py). The default
        materializes the InterMetric list (built once, shared across
        sinks) and calls flush(); sinks that can consume columns directly
        (or discard them — blackhole) override this."""
        self.flush(batch.materialize())

    def note_egress(self, encode_s: float, send_s: float,
                    encoder: str = "columnar",
                    gzip_s: Optional[float] = None) -> None:
        """Report one flush's encode-vs-send split, which encoder ran
        ("columnar", or "legacy" for the per-InterMetric path) and, where
        the sink measures it, the gzip's seconds inside the send."""
        self.last_egress = (encode_s, send_s, encoder, gzip_s)
        if self._latency is not None:
            self._latency.note_egress(self.name(), encode_s, send_s,
                                      gzip_s)

    def flush_other_samples(self, samples: Sequence[Any]) -> None:  # noqa: B027
        """Receive events/service-check samples that aren't InterMetrics."""

    def stop(self) -> None:  # noqa: B027
        pass


class SpanSink(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    def kind(self) -> str:
        return self.name()

    def start(self, server) -> None:  # noqa: B027
        # bind the server's self-metrics client so flush() can emit the
        # standard span-sink keys (reference sinks.go:58-67)
        self._statsd = getattr(server, "statsd", None)

    def emit_flush_self_metrics(self, flushed: int, flush_start: float,
                                dropped: int = 0) -> None:
        """Standard per-sink flush self-metrics (reference sinks.go:58-67:
        sink.spans_flushed_total / sink.span_flush_total_duration_ns,
        plus drop accounting), tagged with the sink name."""
        statsd = getattr(self, "_statsd", None)
        if statsd is None or (not flushed and not dropped):
            return
        tags = [f"sink:{self.name()}"]
        if flushed:
            statsd.count("sink.spans_flushed_total", flushed, tags=tags)
        if dropped:
            statsd.count("sink.spans_dropped_total", dropped, tags=tags)
        statsd.gauge(
            "sink.span_flush_total_duration_ns",
            int((time.perf_counter() - flush_start) * 1e9), tags=tags)

    @abc.abstractmethod
    def ingest(self, span) -> None: ...

    def ingest_many(self, spans) -> None:
        """Batch ingest: the span sink workers hand over whole decoded
        chunks, so a sink that can take spans wholesale overrides this
        and pays one Python call per chunk. The default delegates per
        span and isolates failures, so one poison span costs exactly one
        span."""
        for span in spans:
            try:
                self.ingest(span)
            except Exception:
                _logger.exception("span sink %s ingest failed",
                                  self.name())

    def flush(self) -> None:  # noqa: B027
        pass

    def stop(self) -> None:  # noqa: B027
        pass


# kind -> factory(config: SinkConfig, server_config: Config) -> sink
MetricSinkTypes: Dict[str, Callable] = {}
SpanSinkTypes: Dict[str, Callable] = {}


def register_metric_sink(kind: str):
    def deco(factory):
        MetricSinkTypes[kind] = factory
        return factory
    return deco


def register_span_sink(kind: str):
    def deco(factory):
        SpanSinkTypes[kind] = factory
        return factory
    return deco


def register_builtin_sinks() -> None:
    """Import every built-in sink module for its registration side effect."""
    from veneur_tpu_torch.sinks import (  # noqa: F401
        blackhole, channel, cloudwatch, cortex, datadog, debug, falconer,
        kafka, lightstep, localfile, newrelic, prometheus, s3, signalfx,
        splunk, xray,
    )
