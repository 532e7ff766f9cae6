"""Pull sources: the boundary between a source and the server's ingest
(a copy of veneur_tpu/sources/__init__.py).

A Source has a name, a blocking `start(ingest)` loop that the server runs
on a thread of its own, and `stop()`; `ingest.ingest_metric` takes each
UDPMetric into the aggregation path (the server's slow path). Factories
register by kind in SourceTypes. The server starts its sources after the
import server, and stops and joins them before its listeners close and
before the final flush, so nothing a source took arrives after it.
"""

from __future__ import annotations

import abc
import logging
import threading
from typing import Callable, Dict, Optional

from veneur_tpu_torch.samplers.metrics import UDPMetric

logger = logging.getLogger("veneur_tpu_torch.sources")


class Ingest(abc.ABC):
    @abc.abstractmethod
    def ingest_metric(self, metric: UDPMetric) -> None: ...


class CumulativeDeltaCache:
    """Cumulative counter -> per-interval delta, shared by every pull
    source that reads monotonic series (OpenMetrics counters and buckets,
    OTLP cumulative Sums).

    - the first observation primes the cache and emits nothing (None);
    - a growing counter emits `value - prev`;
    - a reset (value < prev: the scraped process restarted) emits the new
      cumulative count clamped to >= 0: the post-reset counts are real
      traffic, and a broken exporter that goes negative never produces a
      negative spike downstream.

    Bounded: past `max_series` the cache is cleared whole (logged); it
    refills within one scrape, at the cost of one primed interval.
    Thread-safe: the OTLP source's handler threads share one instance.
    """

    def __init__(self, max_series: int = 1_000_000):
        self.max_series = max(1, int(max_series))
        self._prev: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def delta(self, key: tuple, value: float) -> Optional[float]:
        with self._lock:
            prev = self._prev.get(key)
            if prev is None and len(self._prev) >= self.max_series:
                logger.warning("cumulative-delta cache cleared at %d "
                               "series", len(self._prev))
                self._prev.clear()
            self._prev[key] = value
        if prev is None:
            return None  # the first observation primes the cache
        if value < prev:  # a reset: the new count, 0-clamped
            return max(0.0, value)
        return value - prev


class Source(abc.ABC):
    # seconds the server waits for this source's thread after stop()
    join_timeout = 2.0

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def start(self, ingest: Ingest) -> None:
        """Run the source; blocks until stop() (called on its own thread)."""

    @abc.abstractmethod
    def stop(self) -> None: ...


# kind -> factory(config: SourceConfig, server_config: Config) -> Source
SourceTypes: Dict[str, Callable] = {}


def register_source(kind: str):
    def deco(factory):
        SourceTypes[kind] = factory
        return factory
    return deco


def register_builtin_sources() -> None:
    from veneur_tpu_torch.sources import openmetrics, otlp  # noqa: F401
