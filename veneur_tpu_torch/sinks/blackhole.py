"""Blackhole sink: accepts and drops everything (reference
sinks/blackhole/blackhole.go). The test/benchmark baseline."""

from __future__ import annotations

from veneur_tpu_torch.sinks import (MetricSink, SpanSink, register_metric_sink,
                                    register_span_sink)


class BlackholeMetricSink(MetricSink):
    def __init__(self, name: str = "blackhole"):
        self._name = name

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "blackhole"

    def flush(self, metrics) -> None:
        pass

    def flush_batch(self, batch) -> None:
        # columnar fast path: never materialize per-metric objects
        pass


class BlackholeSpanSink(SpanSink):
    def __init__(self, name: str = "blackhole"):
        self._name = name

    def name(self) -> str:
        return self._name

    def ingest(self, span) -> None:
        pass

    def ingest_many(self, spans) -> None:
        pass


@register_metric_sink("blackhole")
def _metric_factory(sink_config, server_config):
    return BlackholeMetricSink(sink_config.name or "blackhole")


@register_span_sink("blackhole")
def _span_factory(sink_config, server_config):
    return BlackholeSpanSink(sink_config.name or "blackhole")
