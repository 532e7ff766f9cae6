"""Metric sink plugin boundary.

Interface parity with reference sinks/sinks.go:42-103: metric sinks receive
plain host-side InterMetrics per flush (the device column store is invisible
to them). Factories register by kind in MetricSinkTypes (reference
server.go:62-91). This slice carries metric sinks only; span sinks arrive
with the SSF plane.

A sink that encodes straight from the FlushBatch columns reports its
encode-vs-send split through `note_egress`; the server copies the last
report into its `last_flush_timings` under `sink:<name>`. (The JAX
package also feeds it to the latency observatory and the ambient flush
span, which arrive with their planes.)
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from veneur_tpu_torch.samplers.metrics import InterMetric


class MetricSink(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def kind(self) -> str: ...

    # the last flush's (encode_s, send_s, encoder), or None
    last_egress: Optional[Tuple[float, float, str]] = None

    def start(self, server) -> None:  # noqa: B027
        self.bind_server(server)

    def bind_server(self, server) -> None:
        """Capture what the sink reads of its owning server. Sinks that
        override start() call this first. The port has no self-metrics
        client or latency observatory yet, so nothing is bound."""

    @abc.abstractmethod
    def flush(self, metrics: List[InterMetric]) -> None: ...

    def flush_batch(self, batch) -> None:
        """Receive a columnar FlushBatch (core/flusher.py). The default
        materializes the InterMetric list (built once, shared across
        sinks) and calls flush(); sinks that can consume columns directly
        (or discard them — blackhole) override this."""
        self.flush(batch.materialize())

    def note_egress(self, encode_s: float, send_s: float,
                    encoder: str = "columnar") -> None:
        """Report one flush's encode-vs-send split and which encoder ran
        ("columnar", or "legacy" for the per-InterMetric path)."""
        self.last_egress = (encode_s, send_s, encoder)

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
    from veneur_tpu_torch.sinks import (  # noqa: F401
        blackhole, channel, cloudwatch, cortex, datadog, debug, kafka,
        localfile, newrelic, prometheus, s3, signalfx,
    )
