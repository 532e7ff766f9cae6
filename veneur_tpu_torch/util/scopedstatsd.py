"""Scoped self-metrics client (port of veneur_tpu/util/scopedstatsd.py;
its packets are the JAX client's, byte for byte).

Behavioral parity with reference scopedstatsd/client.go:13-119: a statsd
client wrapper that appends the `veneurlocalonly` / `veneurglobalonly`
magic tag to each metric according to per-method scope configuration
(`veneur_metrics_scopes`: gauges default local, counts default global),
plus `veneur_metrics_additional_tags` on everything. Metrics emit as
DogStatsD packets to `stats_address`, or into a callback (the server's
internal loopback, so self-metrics re-enter its own pipeline).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, Optional, Sequence

from veneur_tpu_torch.protocol.render import render_metric_packet

TAG_LOCAL_ONLY = "veneurlocalonly"
TAG_GLOBAL_ONLY = "veneurglobalonly"

_SCOPE_TAGS = {"local": TAG_LOCAL_ONLY, "global": TAG_GLOBAL_ONLY}


class ScopedClient:
    def __init__(self, address: str = "",
                 packet_cb: Optional[Callable[[bytes], None]] = None,
                 scopes: Optional[Dict[str, str]] = None,
                 additional_tags: Sequence[str] = (),
                 registry=None):
        """scopes maps metric kind to "local"/"global"/"" using the
        reference's YAML keys — "counter"/"gauge"/"histogram" (config.go
        VeneurMetricsScopes; timings scope by Histogram, scopedstatsd/
        client.go:91-110). The pre-parity aliases "count"/"timing" stay
        accepted.

        `registry` is an optional core.telemetry.Registry every emission
        tees into (with the caller's tags, before scope/additional tags)
        so the pull endpoints see each self-metric without any call-site
        rewrites — including on NullClient, which drops the push half.
        `packets_sent` counts the packets handed to the socket or the
        callback."""
        scopes = dict(scopes or {})
        for ref_key, alias in (("counter", "count"), ("histogram", "timing")):
            if ref_key not in scopes and alias in scopes:
                scopes[ref_key] = scopes[alias]
        self.scopes = scopes
        self.additional_tags = list(additional_tags)
        self.registry = registry
        self._cb = packet_cb
        self.packets_sent = 0
        self._sent_lock = threading.Lock()
        self._sock = None
        self._addr = None
        if address and packet_cb is None:
            host, _, port = address.rpartition(":")
            self._addr = (host or "127.0.0.1", int(port))
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _emit(self, name: str, value, kind: str, tags: Sequence[str],
              rate: float) -> None:
        final = list(tags) + self.additional_tags
        scope_tag = _SCOPE_TAGS.get(self.scopes.get(
            {"c": "counter", "g": "gauge", "ms": "histogram"}[kind], ""))
        if scope_tag:
            final.append(scope_tag)
        packet = render_metric_packet(name, value, kind, final, rate)
        if self._cb is not None:
            self._count_sent()
            self._cb(packet)
        elif self._sock is not None:
            try:
                self._sock.sendto(packet, self._addr)
            except OSError:
                return
            self._count_sent()

    def _count_sent(self) -> None:
        with self._sent_lock:
            self.packets_sent += 1

    def count(self, name: str, value: int = 1,
              tags: Sequence[str] = (), rate: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.record_statsd(name, int(value), "c", tags, rate)
        self._emit(name, int(value), "c", tags, rate)

    def gauge(self, name: str, value: float,
              tags: Sequence[str] = (), rate: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.record_statsd(name, value, "g", tags, rate)
        self._emit(name, value, "g", tags, rate)

    def timing(self, name: str, seconds: float,
               tags: Sequence[str] = (), rate: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.record_statsd(
                name, seconds * 1000, "ms", tags, rate)
        self._emit(name, f"{seconds * 1000:.3f}", "ms", tags, rate)

    def timer(self, name: str, tags: Sequence[str] = ()):
        """Context manager: times the with-block."""
        client = self

        class _Timer:
            def __enter__(self):
                self.start = time.perf_counter()
                return self

            def __exit__(self, *exc):
                client.timing(name, time.perf_counter() - self.start, tags)

        return _Timer()

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class NullClient(ScopedClient):
    """Drops every packet (trace.NeutralizeClient analog for tests); a
    registry, when given, still captures — the pull endpoints stay live
    even with no stats_address configured."""

    def __init__(self, registry=None):
        super().__init__(registry=registry)

    def _emit(self, *a, **kw) -> None:
        pass
