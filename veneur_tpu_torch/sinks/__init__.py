"""Metric sink plugin boundary.

Interface parity with reference sinks/sinks.go:42-103: metric sinks receive
plain host-side InterMetrics per flush (the device column store is invisible
to them). Factories register by kind in MetricSinkTypes (reference
server.go:62-91). This slice carries metric sinks only; span sinks arrive
with the SSF plane.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Sequence

from veneur_tpu_torch.samplers.metrics import InterMetric


class MetricSink(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def kind(self) -> str: ...

    def start(self, server) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    def flush(self, metrics: List[InterMetric]) -> None: ...

    def flush_batch(self, batch) -> None:
        """Receive a columnar FlushBatch (core/flusher.py). The default
        materializes the InterMetric list (built once, shared across
        sinks) and calls flush(); sinks that can consume columns directly
        (or discard them — blackhole) override this."""
        self.flush(batch.materialize())

    def flush_other_samples(self, samples: Sequence[Any]) -> None:  # noqa: B027
        """Receive events/service-check samples that aren't InterMetrics."""

    def stop(self) -> None:  # noqa: B027
        pass


# kind -> factory(config: SinkConfig, server_config: Config) -> sink
MetricSinkTypes: Dict[str, Callable] = {}


def register_metric_sink(kind: str):
    def deco(factory):
        MetricSinkTypes[kind] = factory
        return factory
    return deco


def register_builtin_sinks() -> None:
    """Import every built-in sink module for its registration side effect."""
    from veneur_tpu_torch.sinks import blackhole, channel, debug  # noqa: F401
