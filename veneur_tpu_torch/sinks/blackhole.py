"""Blackhole sink: accepts and drops everything (reference
sinks/blackhole/blackhole.go). The test/benchmark baseline."""

from __future__ import annotations

from veneur_tpu_torch.sinks import MetricSink, register_metric_sink


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


@register_metric_sink("blackhole")
def _metric_factory(sink_config, server_config):
    return BlackholeMetricSink(sink_config.name or "blackhole")
