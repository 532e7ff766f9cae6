"""Runtime diagnostics self-metrics (port of
veneur_tpu/core/diagnostics.py, under `features.diagnostics_metrics_enabled`).

Behavioral parity with reference diagnostics/diagnostics_metrics.go:11-40
(periodic Go memstats -> statsd gauges + uptime counter), translated to
the Python/PyTorch runtime: RSS and CPU from `/proc` + `resource`, GC
stats from `gc`, thread count, uptime, and per-device CUDA memory from
`torch.cuda.memory_stats()`.
"""

from __future__ import annotations

import gc
import logging
import sys
import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch.core.overload import current_rss_bytes
from veneur_tpu_torch.util.scopedstatsd import ScopedClient

logger = logging.getLogger("veneur_tpu_torch.diagnostics")

# getrusage reports ru_maxrss in kilobytes on Linux/BSD but bytes on macOS
_RU_MAXRSS_SCALE = 1 if sys.platform == "darwin" else 1024


def collect(stats: ScopedClient, start_time: float,
            include_device: bool = True,
            last_tick: Optional[float] = None) -> float:
    """Emit one round of runtime gauges. Returns the tick time so the
    loop can thread it back in as `last_tick` — uptime_ms counts only
    the interval delta (reference diagnostics_metrics.go counts the
    interval, not the total; summing totals grows quadratically)."""
    import resource
    now = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # ru_maxrss is the PEAK high-water mark, not the current footprint;
    # report it under its own name and the live value from /proc
    rss = current_rss_bytes()
    max_rss = ru.ru_maxrss * _RU_MAXRSS_SCALE
    if rss is not None and rss > max_rss:
        # the kernel updates the hiwater mark lazily (batched rss_stat
        # accounting), so a growing process can read a live RSS above
        # the reported peak; clamp so the export keeps the invariant
        # operators (and dashboards dividing the two) rely on
        max_rss = rss
    stats.gauge("mem.rss_bytes", rss if rss is not None else max_rss)
    stats.gauge("mem.max_rss_bytes", max_rss)
    stats.gauge("cpu.user_seconds", ru.ru_utime)
    stats.gauge("cpu.system_seconds", ru.ru_stime)
    counts = gc.get_count()
    stats.gauge("gc.gen0_collections", counts[0])
    # O(1) allocation telemetry; gc.get_objects() would materialize a list
    # of every live object while holding the GIL
    gen_stats = gc.get_stats()
    stats.gauge("gc.collections_total",
                sum(g["collections"] for g in gen_stats))
    stats.gauge("gc.collected_total",
                sum(g["collected"] for g in gen_stats))
    stats.gauge("threads.count", threading.active_count())
    since = now - (last_tick if last_tick is not None else start_time)
    stats.count("uptime_ms", int(max(since, 0.0) * 1000))
    if include_device:
        # imported here: the proxy's loop (include_device=False) runs in
        # a process that imports no torch
        from veneur_tpu_torch.core.deviceobs import cuda_memory_stats
        for i, dev_stats in cuda_memory_stats():
            in_use = dev_stats.get("allocated_bytes.all.current")
            if in_use is not None:
                # same tag set as telemetry.device_memory_rows so the
                # scrape-time collector overwrites this teed value on
                # /metrics instead of duplicating the series
                stats.gauge("device.bytes_in_use", in_use,
                            tags=[f"device:{i}", "platform:gpu"])
    return now


class DiagnosticsLoop:
    """Emits `collect` every interval on a daemon thread."""

    # a persistently failing collector logs once per this many seconds
    ERROR_LOG_INTERVAL_S = 60.0

    def __init__(self, stats: ScopedClient, interval: float,
                 include_device: bool = True,
                 extra: Optional[Callable[[], None]] = None):
        self.stats = stats
        self.interval = interval
        self.include_device = include_device
        self.extra = extra  # e.g. the proxy's per-interval RPC aggregates
        self.start_time = time.time()
        self.errors = 0
        self._last_error_log = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="diagnostics", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        last_tick: Optional[float] = None
        while not self._stop.wait(self.interval):
            try:
                last_tick = collect(self.stats, self.start_time,
                                    self.include_device,
                                    last_tick=last_tick)
                if self.extra is not None:
                    self.extra()
            except Exception:
                # rate-limited: a collector that fails every interval
                # stays visible without flooding the log
                self.errors += 1
                now = time.monotonic()
                if now - self._last_error_log >= self.ERROR_LOG_INTERVAL_S:
                    self._last_error_log = now
                    logger.exception(
                        "diagnostics collection failed (%d failures so "
                        "far)", self.errors)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
