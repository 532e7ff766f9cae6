"""Per-RPC latency and error accounting for gRPC servers (a copy of
veneur_tpu/util/grpcstats.py, plus lifetime totals for /metrics).

Parity with reference proxy/grpcstats/server.go: every RPC is timed and
counted by method and outcome, and the aggregates are emitted as
self-metrics (rpc.count / rpc.duration_ns / rpc.errors in the reference).
Handlers are wrapped explicitly (the servers here build their method
handlers by hand), which keeps the recorder independent of grpc's
interceptor API.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List


class RpcStats:
    """Thread-safe per-method RPC aggregates."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}
        # the same aggregates over the process lifetime (never drained):
        # what telemetry_rows serves at scrape time
        self._totals: Dict[str, Dict[str, float]] = {}

    def record(self, method: str, duration_s: float, ok: bool) -> None:
        with self._lock:
            for table in (self._stats, self._totals):
                s = table.setdefault(method, {
                    "count": 0, "errors": 0, "total_s": 0.0, "max_s": 0.0})
                s["count"] += 1
                if not ok:
                    s["errors"] += 1
                s["total_s"] += duration_s
                s["max_s"] = max(s["max_s"], duration_s)

    def telemetry_rows(self, prefix: str = "rpc") -> List[tuple]:
        """Lifetime (name, kind, value, tags) rows per method for the
        /metrics registry: calls, errors, seconds in the handler and the
        longest call."""
        with self._lock:
            totals = {k: dict(v) for k, v in self._totals.items()}
        rows: List[tuple] = []
        for method, s in sorted(totals.items()):
            tags = [f"method:{method}"]
            rows.append((f"{prefix}.calls", "counter", float(s["count"]),
                         tags))
            rows.append((f"{prefix}.failed", "counter", float(s["errors"]),
                         tags))
            rows.append((f"{prefix}.seconds", "counter", s["total_s"], tags))
            rows.append((f"{prefix}.max_seconds", "gauge", s["max_s"], tags))
        return rows

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def drain(self) -> Dict[str, Dict[str, float]]:
        """Snapshot-and-reset: the interval's deltas (so repeated emits
        never re-count earlier RPCs)."""
        with self._lock:
            out, self._stats = self._stats, {}
            return out

    def emit(self, statsd, prefix: str = "rpc") -> None:
        """Emit one interval's deltas through a scopedstatsd-style client
        (gauge / count interface), tagged by method — the reference's
        grpcstats metric surface. Resets the aggregates, so each flush
        emits only what happened since the previous one."""
        for method, s in self.drain().items():
            tags = [f"method:{method}"]
            statsd.count(f"{prefix}.count", int(s["count"]), tags=tags)
            statsd.count(f"{prefix}.errors", int(s["errors"]), tags=tags)
            avg_ns = (s["total_s"] / s["count"] * 1e9) if s["count"] else 0
            statsd.gauge(f"{prefix}.avg_duration_ns", int(avg_ns), tags=tags)
            statsd.gauge(f"{prefix}.max_duration_ns",
                         int(s["max_s"] * 1e9), tags=tags)

    def timed(self, method: str, behavior: Callable) -> Callable:
        """Wrap a gRPC method behavior (request, context) -> response."""
        def wrapped(request_or_iterator, context):
            t0 = time.perf_counter()
            try:
                out = behavior(request_or_iterator, context)
            except Exception:
                self.record(method, time.perf_counter() - t0, ok=False)
                raise
            self.record(method, time.perf_counter() - t0, ok=True)
            return out

        return wrapped
