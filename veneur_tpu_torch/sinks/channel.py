"""Channel sink: delivers each flush into a queue the test reads — the
universal flush observer (pattern from reference server_test.go:183-216)."""

from __future__ import annotations

import queue
from typing import List, Optional

from veneur_tpu_torch.samplers.metrics import InterMetric
from veneur_tpu_torch.sinks import MetricSink, register_metric_sink


class ChannelMetricSink(MetricSink):
    def __init__(self, name: str = "channel", q: Optional[queue.Queue] = None):
        self._name = name
        self.queue: queue.Queue = q if q is not None else queue.Queue()

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return "channel"

    def flush(self, metrics: List[InterMetric]) -> None:
        self.queue.put(list(metrics))

    def wait_flush(self, timeout: float = 5.0) -> List[InterMetric]:
        return self.queue.get(timeout=timeout)

    def drain(self) -> List[InterMetric]:
        """Non-blocking: every metric from every flush delivered so far."""
        out: List[InterMetric] = []
        while True:
            try:
                out.extend(self.queue.get_nowait())
            except queue.Empty:
                return out


@register_metric_sink("channel")
def _factory(sink_config, server_config):
    return ChannelMetricSink(sink_config.name or "channel")
