"""Metric-extraction span sink: the bridge from the span pipeline back
into the aggregation path (a copy of veneur_tpu/sinks/ssfmetrics.py).

Parity with reference sinks/ssfmetrics/metrics.go:45-161: every ingested
span has its embedded SSFSamples converted to UDPMetrics and fed to the
column store; spans that are valid traces additionally yield SLI
indicator/objective timers (reference parser.go:180-232) and a sampled
span-name-uniqueness Set (parser.go:238-259), kept at `uniqueness_rate`
by rolls of the generator the server gives it.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Callable

from veneur_tpu_torch import protocol
from veneur_tpu_torch.samplers.metrics import UDPMetric
from veneur_tpu_torch.sinks import SpanSink

logger = logging.getLogger("veneur_tpu_torch.sinks.ssfmetrics")


class MetricExtractionSink(SpanSink):
    def __init__(self, processor: Callable[[UDPMetric], None], parser,
                 rng: random.Random,
                 indicator_timer_name: str = "",
                 objective_timer_name: str = "",
                 uniqueness_rate: float = 0.01):
        self._process = processor
        self._parser = parser
        self._rng = rng
        self._indicator = indicator_timer_name
        self._objective = objective_timer_name
        self.uniqueness_rate = uniqueness_rate
        self._lock = threading.Lock()
        self.spans_processed = 0
        self.metrics_generated = 0

    def name(self) -> str:
        return "metric_extraction"

    def kind(self) -> str:
        return "metric_extraction"

    def ingest(self, span) -> None:
        metrics, invalid = self._parser.convert_metrics(span)
        if invalid:
            logger.warning("could not parse %d samples from SSF span",
                           len(invalid))
        if protocol.valid_trace(span):
            metrics.extend(self._parser.convert_indicator_metrics(
                span, self._indicator, self._objective))
            with self._lock:  # span workers share the generator
                metrics.extend(self._parser.convert_span_uniqueness_metrics(
                    span, self._rng, self.uniqueness_rate))
        for metric in metrics:
            self._process(metric)
        self.count(1, len(metrics))

    def count(self, spans: int, metrics: int) -> None:
        """Add to the processed-span and generated-metric totals (the
        native SSF path counts its batches here too)."""
        with self._lock:
            self.spans_processed += spans
            self.metrics_generated += metrics
