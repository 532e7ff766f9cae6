"""Debug sink: logs every metric/span (reference sinks/debug/debug.go)."""

from __future__ import annotations

import logging

from veneur_tpu_torch.sinks import (MetricSink, SpanSink, register_metric_sink,
                                    register_span_sink)

logger = logging.getLogger("veneur_tpu_torch.sinks.debug")


class DebugMetricSink(MetricSink):
    def __init__(self, name: str = "debug"):
        self._name = name
        self.flushed_total = 0

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "debug"

    def flush(self, metrics) -> None:
        self.flushed_total += len(metrics)
        for metric in metrics:
            logger.info(
                "flushed metric name=%s value=%s type=%s tags=%s ts=%d",
                metric.name, metric.value, metric.type.name, metric.tags,
                metric.timestamp)

    def flush_other_samples(self, samples) -> None:
        for s in samples:
            logger.info("flushed other sample %r", s)


class DebugSpanSink(SpanSink):
    def __init__(self, name: str = "debug"):
        self._name = name
        self.ingested_total = 0

    def name(self) -> str:
        return self._name

    def ingest(self, span) -> None:
        self.ingested_total += 1
        logger.info("ingested span %r", span)


@register_metric_sink("debug")
def _metric_factory(sink_config, server_config):
    return DebugMetricSink(sink_config.name or "debug")


@register_span_sink("debug")
def _span_factory(sink_config, server_config):
    return DebugSpanSink(sink_config.name or "debug")
