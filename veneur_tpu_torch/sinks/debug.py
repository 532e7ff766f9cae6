"""Debug sink: logs every metric (reference sinks/debug/debug.go)."""

from __future__ import annotations

import logging

from veneur_tpu_torch.sinks import MetricSink, register_metric_sink

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


@register_metric_sink("debug")
def _metric_factory(sink_config, server_config):
    return DebugMetricSink(sink_config.name or "debug")
