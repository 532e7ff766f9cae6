"""Pull-side self-telemetry: internal registry + flight recorder (port
of veneur_tpu/core/telemetry.py).

The server's self-metrics are push-only (util/scopedstatsd.py fires them
at `stats_address`); this module is the pull side of that loop:

- `Registry`: counters / gauges / fixed-bin histograms keyed by
  (name, tags). Every `ScopedClient` emission tees in here, and
  `render_prometheus` serves the whole registry, plus the scrape-time
  collectors, as text exposition for `GET /metrics`.
- `EventRecorder`: a ring-buffer flight recorder of notable events
  (startup, flush rounds, alert transitions, reloads, shutdown) for
  `GET /debug/events`.
- `FlushRecorder`: the last N flush rounds with per-phase and per-sink
  latency for `GET /debug/flush`.

OpenMetrics exemplars come from the registry's `exemplar_source` (the
server's self-trace plane) on counter lines, once per name, when the
scraper asks for OpenMetrics; every recorded event carries the active
interval's trace id (`trace_source`). A failing source raises into the
scrape or the recording caller. `device_memory_rows` reads torch.cuda.
"""

from __future__ import annotations

import bisect
import json
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger("veneur_tpu_torch.telemetry")

# Fixed histogram bucket ladder (seconds-oriented, but unit-agnostic):
# 1-2-5 decades from 100µs to 100s. 19 bins + overflow, allocated once
# per series — the capped-bin design the Circllhist paper motivates.
HISTOGRAM_BOUNDS: Tuple[float, ...] = tuple(
    round(m * 10.0 ** e, 10)
    for e in range(-4, 2) for m in (1.0, 2.0, 5.0)
) + (100.0,)

# Series cap: a registry is fed by self-metrics only (bounded-cardinality
# names + tags), so the cap exists to bound a bug, not normal operation.
DEFAULT_MAX_SERIES = 4096

# Overflow attribution cap: at most this many distinct metric NAMES get
# their own series_dropped_by_name counter; later names pool into the
# "_other" bucket. Bounds the debugging aid the same way the registry
# itself is bounded.
MAX_DROPPED_NAMES = 64


def _tags_key(tags: Sequence[str]) -> Tuple[str, ...]:
    return tuple(sorted(tags)) if tags else ()


class _Histogram:
    """Fixed-bound bucket counts + sum/count/min/max. No locking of its
    own; the owning Registry serializes mutation."""

    __slots__ = ("buckets", "count", "sum")

    def __init__(self):
        self.buckets = [0] * (len(HISTOGRAM_BOUNDS) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.buckets[bisect.bisect_left(HISTOGRAM_BOUNDS, value)] += 1
        self.count += 1
        self.sum += value


class Registry:
    """Thread-safe counter/gauge/histogram store with a hard series cap.

    `record_statsd` is the ScopedClient tee: statsd kinds map onto the
    registry types (c -> counter with 1/rate scaling, g -> gauge,
    ms -> histogram, observed in seconds).
    """

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES):
        self.max_series = max_series
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        self._gauges: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        self._histograms: Dict[Tuple[str, Tuple[str, ...]], _Histogram] = {}
        self.series_dropped = 0
        # overflow attribution: name -> drops since the cap was hit, so
        # a silent lossy drop becomes debuggable (which emitter blew the
        # cap?). Bounded at MAX_DROPPED_NAMES; the first drop per name
        # is logged once (rate-limited by construction).
        self.dropped_by_name: Dict[str, int] = {}
        # collectors: zero-arg callables returning (name, kind, value,
        # tags) rows rendered fresh at scrape time (live counters the
        # registry doesn't own, device memory, ...)
        self._collectors: List[Callable[[], Iterable[tuple]]] = []
        # OpenMetrics exemplars: callable(name, tags) -> the rendered
        # exemplar clause or None, consulted per counter line at
        # exposition time (the server wires its trace plane's
        # exemplar_for here)
        self.exemplar_source = None

    # -- writes ----------------------------------------------------------

    def _slot(self, table: dict, name: str, tags: Sequence[str]):
        key = (name, _tags_key(tags))
        if key not in table and self._series_count() >= self.max_series:
            self.series_dropped += 1
            dropped = self.dropped_by_name
            if name in dropped:
                dropped[name] += 1
            elif len(dropped) < MAX_DROPPED_NAMES:
                dropped[name] = 1
                logger.warning(
                    "telemetry registry full (max_series=%d): dropping "
                    "new series for %r (first drop for this name; "
                    "telemetry.series_dropped_by_name counts the rest)",
                    self.max_series, name)
            else:
                dropped["_other"] = dropped.get("_other", 0) + 1
            return None
        return key

    def _series_count(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))

    def count(self, name: str, value: float = 1.0,
              tags: Sequence[str] = ()) -> None:
        with self._lock:
            key = self._slot(self._counters, name, tags)
            if key is not None:
                self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float,
              tags: Sequence[str] = ()) -> None:
        with self._lock:
            key = self._slot(self._gauges, name, tags)
            if key is not None:
                self._gauges[key] = float(value)

    def observe(self, name: str, value: float,
                tags: Sequence[str] = ()) -> None:
        with self._lock:
            key = self._slot(self._histograms, name, tags)
            if key is not None:
                hist = self._histograms.get(key)
                if hist is None:
                    hist = self._histograms[key] = _Histogram()
                hist.observe(value)

    def record_statsd(self, name: str, value, kind: str,
                      tags: Sequence[str], rate: float) -> None:
        """Tee one statsd emission (kind in c/g/ms) into the registry."""
        try:
            if kind == "c":
                scale = 1.0 / rate if 0.0 < rate < 1.0 else 1.0
                self.count(name, float(value) * scale, tags)
            elif kind == "g":
                self.gauge(name, float(value), tags)
            elif kind == "ms":
                # ScopedClient.timing renders ms; the registry keeps
                # seconds so the exposition is Prometheus-idiomatic
                self.observe(name, float(value) / 1000.0, tags)
        except (TypeError, ValueError):
            pass

    # -- collectors ------------------------------------------------------

    def add_collector(self, fn: Callable[[], Iterable[tuple]]) -> None:
        """Register a scrape-time row source. `fn` returns rows of
        (name, kind, value, tags) with kind "counter" or "gauge"; a
        collector that raises is skipped for that scrape."""
        with self._lock:
            self._collectors.append(fn)

    # -- reads -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {self._flat(k): v
                             for k, v in self._counters.items()},
                "gauges": {self._flat(k): v
                           for k, v in self._gauges.items()},
                "histograms": {self._flat(k): h.count
                               for k, h in self._histograms.items()},
                "series_dropped": self.series_dropped,
                "series_dropped_by_name": dict(self.dropped_by_name),
            }

    @staticmethod
    def _flat(key: Tuple[str, Tuple[str, ...]]) -> str:
        name, tags = key
        return f"{name}|{','.join(tags)}" if tags else name

    def render_prometheus(self, exemplars: bool = False) -> str:
        """The whole registry (plus collectors) as Prometheus text
        exposition format 0.0.4. With `exemplars` (the scraper asked for
        OpenMetrics; the HTTP layer switches the content type and adds
        `# EOF`) the first counter line per name that the exemplar
        source knows gains its exemplar clause (exemplars on gauges are
        invalid OpenMetrics)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = {k: (list(h.buckets), h.count, h.sum)
                          for k, h in self._histograms.items()}
            collectors = list(self._collectors)
            dropped = self.series_dropped
            dropped_by_name = dict(self.dropped_by_name)
        for fn in collectors:
            try:
                for name, kind, value, tags in fn():
                    key = (name, _tags_key(tags))
                    if kind == "counter":
                        counters[key] = counters.get(key, 0.0) + value
                    else:
                        gauges[key] = value
            except Exception:
                continue
        gauges[("telemetry.series_dropped", ())] = float(dropped)
        for name, n in dropped_by_name.items():
            counters[("telemetry.series_dropped_by_name",
                      (f"name:{name}",))] = float(n)

        exemplar_source = self.exemplar_source if exemplars else None
        exemplified: set = set()

        def exemplar_clause(name: str, tags, ptype: str) -> str:
            if (exemplar_source is None or ptype != "counter"
                    or name in exemplified):
                return ""
            clause = exemplar_source(name, tags) or ""
            if clause:
                exemplified.add(name)
            return clause

        out: List[str] = []
        for table, ptype in ((counters, "counter"), (gauges, "gauge")):
            grouped: Dict[str, list] = {}
            for (name, tags), value in table.items():
                grouped.setdefault(name, []).append((tags, value))
            for metric in sorted(grouped):
                pname = prom_name(metric, ptype)
                out.append(f"# TYPE {pname} {ptype}")
                for tags, value in sorted(grouped[metric]):
                    out.append(f"{pname}{prom_labels(tags)} {fnum(value)}"
                               f"{exemplar_clause(metric, tags, ptype)}")
        hgrouped: Dict[str, list] = {}
        for (name, tags), series in histograms.items():
            hgrouped.setdefault(name, []).append((tags, series))
        for metric in sorted(hgrouped):
            pname = prom_name(metric, "histogram")
            out.append(f"# TYPE {pname} histogram")
            for tags, (buckets, count, total) in sorted(hgrouped[metric]):
                cum = 0
                for bound, n in zip(HISTOGRAM_BOUNDS, buckets):
                    cum += n
                    out.append(f"{pname}_bucket"
                               f"{prom_labels(tags, le=fnum(bound))} {cum}")
                out.append(f"{pname}_bucket"
                           f"{prom_labels(tags, le='+Inf')} {count}")
                out.append(f"{pname}_sum{prom_labels(tags)} {fnum(total)}")
                out.append(f"{pname}_count{prom_labels(tags)} {count}")
        return "\n".join(out) + "\n"


# -- Prometheus text helpers ----------------------------------------------

def fnum(value: float) -> str:
    """Shortest faithful rendering: integers without the trailing .0."""
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def prom_name(name: str, ptype: str = "gauge") -> str:
    """Dotted self-metric name -> valid Prometheus metric name, under the
    veneur_ namespace; counters gain the conventional _total suffix."""
    cleaned = "".join(ch if ch.isalnum() or ch == "_" else "_"
                      for ch in name)
    if cleaned and cleaned[0].isdigit():
        cleaned = "_" + cleaned
    full = f"veneur_{cleaned}"
    if ptype == "counter" and not full.endswith("_total"):
        full += "_total"
    return full


def prom_label_escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def prom_labels(tags: Sequence[str], le: Optional[str] = None) -> str:
    """DogStatsD tags ("k:v" or bare "flag") -> a Prometheus label set."""
    pairs: List[Tuple[str, str]] = []
    for tag in tags:
        k, sep, v = tag.partition(":")
        if not sep:
            k, v = "tag", tag
        k = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in k)
        if not k or k[0].isdigit():
            k = "tag_" + k
        pairs.append((k, prom_label_escape(v)))
    if le is not None:
        pairs.append(("le", le))
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


# -- flight recorder ------------------------------------------------------

class EventRecorder:
    """Bounded ring buffer of notable events — the black-box recorder.

    `record` costs one deque append under a lock; the ring drops the
    oldest event on overflow (memory stays bounded under sustained event
    load by construction). Events carry a wall-clock timestamp and a
    monotonic sequence number so a reader can detect gaps after a wrap.
    """

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0

    def record(self, kind: str, **fields) -> dict:
        event = {"seq": 0, "ts": time.time(), "kind": kind}
        event.update(fields)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
        return event

    def snapshot(self, limit: int = 0, kind: str = "",
                 trace_id: str = "") -> List[dict]:
        """Newest-last; `limit` > 0 keeps only the most recent events;
        `kind` filters to one event kind (e.g. overload_state,
        pipeline_stall) BEFORE the limit applies, so an operator can
        pull the last N ladder transitions even when chatty events
        (watchdog ticks, flush rounds) dominate the ring. `trace_id`
        (hex) keeps only events stamped with that interval trace, so a
        /debug/ledger or /debug/traces finding cross-links to exactly
        the events of its interval."""
        with self._lock:
            events = list(self._events)
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        if trace_id:
            events = [e for e in events if e.get("trace_id") == trace_id]
        return events[-limit:] if limit > 0 else events

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class FlushRecorder:
    """The last N flush rounds, each a dict with phase timings and
    per-sink outcomes. Sink threads keep a reference to their round's
    dict, so a straggler that finishes after its round was recorded
    still lands its final status (flagged `late`)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._rounds: deque = deque(maxlen=capacity)

    def record(self, round_info: dict) -> None:
        with self._lock:
            self._rounds.append(round_info)

    def snapshot(self, limit: int = 0) -> List[dict]:
        with self._lock:
            # per-sink outcome dicts are still mutated by straggler sink
            # threads (that sharing is what lets a late finish land), so
            # copy them too — a reader iterating a shared dict while the
            # straggler inserts a key would blow up mid-serialization
            rounds = [dict(r, sinks={k: dict(v)
                                     for k, v in r.get("sinks", {}).items()})
                      for r in self._rounds]
        return rounds[-limit:] if limit > 0 else rounds

    def __len__(self) -> int:
        with self._lock:
            return len(self._rounds)


class Telemetry:
    """One server's (or proxy's) pull-side telemetry: the registry the
    statsd tee feeds, the event flight recorder, and the flush-round
    table. Constructed unconditionally — recording is cheap enough to be
    always-on, which is the whole point of a flight recorder."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES,
                 event_capacity: int = 512, flush_capacity: int = 64):
        self.registry = Registry(max_series=max_series)
        self.events = EventRecorder(capacity=event_capacity)
        self.flushes = FlushRecorder(capacity=flush_capacity)
        # zero-arg callable -> the active interval's trace id (hex, ''
        # when unsampled): every recorded event carries it, so the
        # flight recorder cross-links to /debug/traces
        self.trace_source = None

    def record_event(self, kind: str, **fields) -> dict:
        if self.trace_source is not None and "trace_id" not in fields:
            tid = self.trace_source()
            if tid:
                fields["trace_id"] = tid
        return self.events.record(kind, **fields)

    def events_json(self, limit: int = 0, kind: str = "",
                    trace_id: str = "") -> bytes:
        return json.dumps({
            "capacity": self.events.capacity,
            "total_recorded": self.events.total_recorded,
            "events": self.events.snapshot(limit, kind=kind,
                                           trace_id=trace_id),
        }, indent=2, default=str).encode()

    def flushes_json(self, limit: int = 0) -> bytes:
        return json.dumps({
            "capacity": self.flushes.capacity,
            "rounds": self.flushes.snapshot(limit),
        }, indent=2, default=str).encode()


def device_memory_rows() -> List[tuple]:
    """Per-device memory gauges for the /metrics collector, one row set
    per visible CUDA device (none without CUDA), under the JAX package's
    names: the caching allocator's bytes in use and their peak, and the
    card's total memory (deviceobs.backend_memory_stats)."""
    from veneur_tpu_torch.core.deviceobs import backend_memory_stats
    rows: List[tuple] = []
    for dev in backend_memory_stats():
        tags = [f"device:{dev['device']}", "platform:gpu"]
        for name in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
            rows.append((f"device.{name}", "gauge", float(dev[name]), tags))
    return rows
