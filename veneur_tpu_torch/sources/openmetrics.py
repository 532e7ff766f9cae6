"""OpenMetrics source: scrapes a Prometheus /metrics endpoint (a port
of veneur_tpu/sources/openmetrics.py).

Every scrape_interval, GET the endpoint, parse the text exposition
format, and convert the families to UDPMetrics:
- counter: monotonic cumulative -> per-interval delta through a value
  cache (the first observation primes it and emits nothing); a reset
  emits the new value, 0-clamped;
- gauge/untyped: gauge;
- summary: quantile samples become gauges tagged `quantile:<q>`; _sum
  and _count become gauge + counter delta;
- histogram: bucket counts become counter deltas tagged `le:<bound>`,
  plus _sum/_count.
An optional allowlist/denylist regex filters family names; label names
can be dropped by pattern or renamed (veneur-prometheus's flags).

A failed scrape is logged and the loop carries on, as in the JAX
package; the port also counts it (`scrape_failures`, beside `scrapes`),
and the server reports both in `stats_snapshot()`.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import (
    MetricScope, UDPMetric, update_tags)
from veneur_tpu_torch.sources import (
    CumulativeDeltaCache, Ingest, Source, register_source)
from veneur_tpu_torch.util import http as vhttp

logger = logging.getLogger("veneur_tpu_torch.sources.openmetrics")

_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>[^ ]+)(?:\s+\d+)?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
# OpenMetrics exemplar clause appended after a sample value
# (`... # {trace_id="..."} value [ts]`) — stripped as a SECOND try
# only when the raw line fails to match, so scraping an exemplified
# exposition (this framework's own /metrics under Accept:
# application/openmetrics-text) doesn't silently lose the series,
# while lines whose quoted label values happen to contain ` # {...}`
# keep parsing exactly as before
_EXEMPLAR = re.compile(r"\s+#\s+\{.*\}\s+\S+(?:\s+\S+)?$")
_ESCAPE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label_value(v: str) -> str:
    """Single-pass exposition unescape (\\\\, \\\", \\n). The old
    sequential str.replace pair mangled a backslash adjacent to a
    quote; this is the exact inverse of
    sinks.prometheus.escape_label_value."""
    return _ESCAPE.sub(
        lambda mo: _UNESCAPES.get(mo.group(1), mo.group(0)), v)


def parse_exposition(text: str) -> Iterator[Tuple[str, str, Dict[str, str],
                                                  float]]:
    """Yield (family_type, name, labels, value) from the text format."""
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        match = _LINE.match(line) or _LINE.match(_EXEMPLAR.sub("", line))
        if not match:
            continue
        name = match.group("name")
        labels = {k: _unescape_label_value(v)
                  for k, v in _LABEL.findall(match.group("labels") or "")}
        try:
            value = float(match.group("value"))
        except ValueError:
            continue
        base = name
        for suffix in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        yield types.get(base, types.get(name, "untyped")), name, labels, value


def _tags(labels: Dict[str, str], extra: List[str]) -> List[str]:
    return sorted([f"{k}:{v}" for k, v in labels.items()] + extra)


class OpenMetricsSource(Source):
    def __init__(self, name: str, url: str, scrape_interval: float,
                 tags: Optional[List[str]] = None,
                 allowlist: Optional[str] = None,
                 denylist: Optional[str] = None,
                 scope: MetricScope = MetricScope.MIXED,
                 timeout: float = 10.0,
                 ignored_labels: Optional[List[str]] = None,
                 rename_labels: Optional[Dict[str, str]] = None,
                 ssl_context=None):
        self._name = name
        self.url = url
        self.scrape_interval = scrape_interval
        self.tags = list(tags or [])
        self.allow = re.compile(allowlist) if allowlist else None
        self.deny = re.compile(denylist) if denylist else None
        self.scope = scope
        self.timeout = timeout
        # label filters/renames mirroring veneur-prometheus's
        # -ignored-labels / -r flags (reference
        # cmd/veneur-prometheus/main.go:17-21)
        self.ignored_labels = [re.compile(p)
                               for p in (ignored_labels or [])]
        self.rename_labels = dict(rename_labels or {})
        # client-cert scrape transport (reference main.go:25-27 mTLS)
        self.ssl_context = ssl_context
        self._stop = threading.Event()
        # cumulative-counter cache: (name, tag-string) -> last value
        # (shared reset semantics with the OTLP source — see
        # sources.CumulativeDeltaCache)
        self._counter_cache = CumulativeDeltaCache()
        # scrapes that ran to their end, and those that raised
        self.scrapes = 0
        self.scrape_failures = 0
        # an in-flight scrape finishes its ingest before the server's
        # final flush: the server waits up to its timeout plus the ingest
        self.join_timeout = timeout + 30.0

    def name(self) -> str:
        return self._name

    def stop(self) -> None:
        self._stop.set()

    def start(self, ingest: Ingest, max_scrapes: int = 0) -> None:
        """Scrape every scrape_interval until stop(), or until
        `max_scrapes` scrapes have run (0 = no limit)."""
        runs = 0
        while not self._stop.wait(self.scrape_interval):
            try:
                self.scrape_once(ingest)
                self.scrapes += 1
            except Exception as e:
                self.scrape_failures += 1
                logger.error("openmetrics scrape of %s failed: %s",
                             self.url, e)
            runs += 1
            if max_scrapes and runs >= max_scrapes:
                return

    # -- conversion -------------------------------------------------------

    def _emit(self, ingest: Ingest, name: str, mtype: str, value: float,
              tags: List[str]) -> None:
        final, joined, h32, h64 = update_tags(name, mtype, tags, None)
        ingest.ingest_metric(UDPMetric(
            key=m.MetricKey(name=name, type=mtype, joined_tags=joined),
            digest=h32, digest64=h64, value=value, sample_rate=1.0,
            tags=final, scope=self.scope))

    def _counter_delta(self, name: str, tags: List[str],
                       value: float) -> Optional[float]:
        """Cumulative -> delta; a reset emits the 0-clamped new count
        (never a negative spike), per CumulativeDeltaCache."""
        return self._counter_cache.delta((name, ",".join(tags)), value)

    def scrape_once(self, ingest: Ingest) -> int:
        status, body = vhttp.get(self.url, timeout=self.timeout,
                                 ssl_context=self.ssl_context)
        count = 0
        for ftype, name, labels, value in parse_exposition(body.decode()):
            if self.allow and not self.allow.search(name):
                continue
            if self.deny and self.deny.search(name):
                continue
            if self.ignored_labels or self.rename_labels:
                labels = {
                    self.rename_labels.get(k, k): v
                    for k, v in labels.items()
                    if not any(p.search(k) for p in self.ignored_labels)}
            tags = _tags(labels, self.tags)
            if ftype == "counter":
                delta = self._counter_delta(name, tags, value)
                if delta is not None:
                    self._emit(ingest, name, m.COUNTER, delta, tags)
                    count += 1
            elif ftype in ("gauge", "untyped"):
                self._emit(ingest, name, m.GAUGE, value, tags)
                count += 1
            elif ftype in ("histogram", "summary"):
                if name.endswith("_sum"):
                    self._emit(ingest, name, m.GAUGE, value, tags)
                    count += 1
                elif name.endswith(("_count", "_bucket")):
                    delta = self._counter_delta(name, tags, value)
                    if delta is not None:
                        self._emit(ingest, name, m.COUNTER, delta, tags)
                        count += 1
                else:  # summary quantile sample
                    self._emit(ingest, name, m.GAUGE, value, tags)
                    count += 1
        return count


@register_source("openmetrics")
def _factory(source_config, server_config):
    c = source_config.config
    scope = {"local": MetricScope.LOCAL_ONLY,
             "global": MetricScope.GLOBAL_ONLY}.get(
        c.get("scope", ""), MetricScope.MIXED)
    from veneur_tpu_torch.config import parse_duration
    return OpenMetricsSource(
        source_config.name or "openmetrics",
        url=c.get("url", ""),
        scrape_interval=parse_duration(c.get("scrape_interval", "10s")),
        tags=list(source_config.tags or []),
        allowlist=c.get("allowlist") or None,
        denylist=c.get("denylist") or None,
        scope=scope,
        timeout=parse_duration(c.get("scrape_timeout", "10s")))
