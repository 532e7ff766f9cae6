"""Configuration of the port's server: the YAML keys of veneur_tpu's
config that this port implements, with the same names and defaults.

A key the port does not implement (for example `forward_only`,
`forward_tls_certificate`, `ssf_listen_addresses`, `grpc_tls_certificate`,
`reshard_spool_dir`, `chaos_forward_fail_rate` or `tpu.shards`) raises
with the key's name: a configuration is never half-applied in silence.
Durations accept Go-style strings ("10s", "500ms") or numbers of
seconds.
"""

from __future__ import annotations

import re
import socket
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

import yaml

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
                   "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(v: Any) -> float:
    """Go-style duration to seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    matches = _DURATION_RE.findall(s)
    if not matches or "".join(f"{n}{u}" for n, u in matches) != s:
        raise ValueError(f"invalid duration: {v!r}")
    return sum(float(n) * _DURATION_UNITS[u] for n, u in matches)


@dataclass
class SinkConfig:
    kind: str = ""
    name: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    # per-sink filters (reference flusher.go:138-213): a metric whose
    # name or any tag is longer than the limit, or with more tags than
    # max_tags, is dropped for this sink; strip_tags are TagMatcher
    # configs (util/matcher.py); add_tags are key -> value. Any of them
    # set sends this sink the materialised InterMetric list.
    max_name_length: int = 0
    max_tag_length: int = 0
    max_tags: int = 0
    strip_tags: List[Dict[str, Any]] = field(default_factory=list)
    add_tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SinkRoutingConfig:
    """One `metric_sink_routing` entry: metrics matching any rule in
    `match` go to the `matched` sinks, the rest to `not_matched`
    (YAML: `sinks: {matched: [...], not_matched: [...]}`)."""

    name: str = ""
    match: List[Dict[str, Any]] = field(default_factory=list)
    matched: List[str] = field(default_factory=list)
    not_matched: List[str] = field(default_factory=list)


@dataclass
class Features:
    """The `features:` block: the routing switch and the runtime
    diagnostics self-metrics (core/diagnostics.py)."""

    diagnostics_metrics_enabled: bool = False
    enable_metric_sink_routing: bool = False


@dataclass
class AlertsConfig:
    """The `alerts:` block, the alert engine's rule table
    (core/alerts.py). Each rule is a mapping — {id, metric, kind, op,
    threshold, q, for, tags, lo, hi} — validated when the engine loads
    it, so a SIGHUP reload of a bad table reports the offending rule."""

    enabled: bool = True
    interval: float = 1.0  # duration between evaluation rounds
    rules: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class TpuConfig:
    """Column-store sizing (the `tpu:` block, kept under its name so one
    YAML file serves both packages)."""

    counter_capacity: int = 4096
    gauge_capacity: int = 4096
    histo_capacity: int = 4096
    set_capacity: int = 1024
    batch_cap: int = 8192
    # set keys promote from the host tier to the device bank after this
    # many samples in one interval; 0 = auto (16 on a card, 2048 on the
    # CPU)
    set_promote_samples: int = 0
    # hard cap on promoted device rows (16 KB each)
    set_max_dev_slots: int = 65536
    # log-linear histogram rows (each is 18 KB of int32 bins on the
    # device); size to the llhist-keyed cardinality, not total keys
    llhist_capacity: int = 1024
    # take the numpy columnar decoder instead of the native C++ parser
    # and pump (the native library builds with g++ at first use, and a
    # failed build raises rather than falling back)
    disable_native_parser: bool = False


@dataclass
class Config:
    aggregates: List[str] = field(
        default_factory=lambda: ["min", "max", "count"])
    # the global's backfill plane: at most this many historical intervals
    # open (0 disables it: stale imports merge into the live interval)
    backfill_max_open_intervals: int = 8
    # durable carryover spill (util/spool.py): carryover past its bound
    # is serialized into this directory instead of shed, drained oldest-
    # first when the global recovers, and replayed on restart; empty =
    # shed at the bound. Its bounds, and those of the quarantine/
    # subdirectory that takes undeliverable segments:
    carryover_spool_dir: str = ""
    carryover_spool_max_bytes: int = 256 * 1024 * 1024
    carryover_spool_max_segments: int = 1024
    carryover_spool_quarantine_max_bytes: int = 64 * 1024 * 1024
    carryover_spool_quarantine_max_segments: int = 256
    # failed forward intervals merge into the next snapshot for at most
    # this many consecutive intervals (0 disables the carryover)
    carryover_max_intervals: int = 3
    # the forward's circuit breaker: consecutive failures to open, and
    # how long it stays open before its one half-open probe (duration)
    circuit_breaker_failure_threshold: int = 3
    circuit_breaker_recovery: float = 30.0
    # tags added to every metric the DogStatsD slow path parses (the
    # columnar path leaves them out, as the JAX package's does)
    extend_tags: List[str] = field(default_factory=list)
    features: Features = field(default_factory=Features)
    # run a last flush in shutdown()
    flush_on_shutdown: bool = False
    # not ready (/healthcheck/ready 503), and the process aborts, after
    # this many intervals without a flush (0 disables the watchdog)
    flush_watchdog_missed_flushes: int = 0
    # host:port of the global server's import endpoint; set, this server
    # is local and forwards its mergeable state there every interval
    forward_address: str = ""
    # forward retry: jittered exponential backoff inside the interval's
    # budget (base and max are durations)
    forward_retry_max_attempts: int = 3
    forward_retry_base: float = 0.2
    forward_retry_max: float = 2.0
    # with carryover_spool_dir set, append every forwardable interval to
    # the spool (fsync'd, stamped with its interval start) before it is
    # sent; the spool's drain is the only send path
    forward_wal: bool = False
    # host:port the import server (gRPC /forwardrpc.Forward) listens on
    grpc_address: str = ""
    # the family DogStatsD histogram/timer samples aggregate in:
    # "tdigest" (reference parity) or "circllhist" (log-linear bins,
    # exact merges); `|l` samples always use the circllhist family
    histogram_encoding: str = "tdigest"
    hostname: str = ""
    # host:port of the operator HTTP API (core/httpapi.py); empty = none
    http_address: str = ""
    # serve POST /quitquitquit (shuts the server down)
    http_quit: bool = False
    # pump chunk size in samples (bounds the hand-off batch and the
    # per-chunk native memory)
    ingest_batch_max_samples: int = 65536
    # chunks each native reader cycles through its SPSC rings (min 3); a
    # full ring blocks the reader, counted as a stall
    ingest_ring_slots: int = 4
    interval: float = 10.0
    # longest datagram taken; longer ones are dropped and counted as
    # rejected lines
    metric_max_length: int = 4096
    # per-metric sink selection, applied when
    # features.enable_metric_sink_routing is on
    metric_sink_routing: List[SinkRoutingConfig] = field(
        default_factory=list)
    metric_sinks: List[SinkConfig] = field(default_factory=list)
    # SO_REUSEPORT sockets (and native reader threads) per UDP address
    num_readers: int = 1
    # keep the configured hostname empty instead of defaulting it
    omit_empty_hostname: bool = False
    # concurrent POSTs of one Datadog flush (the sink's
    # datadog_num_workers overrides it)
    num_workers: int = 1
    percentiles: List[float] = field(
        default_factory=lambda: [0.5, 0.75, 0.99])
    # SO_RCVBUF of each UDP listener socket
    read_buffer_size_bytes: int = 2 * 1024 * 1024
    # host:port the statsd self-metrics go to over UDP ("internal":
    # straight back into this server's parser); empty = none sent
    stats_address: str = ""
    statsd_listen_addresses: List[str] = field(default_factory=list)
    # align flush ticks to multiples of the interval on the wall clock
    synchronize_with_interval: bool = False
    # tag prefixes the import server strips from imported metrics
    tags_exclude: List[str] = field(default_factory=list)
    tpu: TpuConfig = field(default_factory=TpuConfig)
    # the statsd self-metrics' extra tags, and their scope per kind
    # ("counter"/"gauge"/"histogram" -> "local"/"global"/"")
    veneur_metrics_additional_tags: List[str] = field(default_factory=list)
    veneur_metrics_scopes: Dict[str, str] = field(default_factory=dict)
    # WAL segments (and, at the global, stamped imports) older than this
    # many intervals are backfill: drained behind fresh segments under the
    # replay limiter, bucketed by their original interval at the global
    wal_stale_after_intervals: float = 2.0
    # the replay limiter, metrics per second (0 = full speed), and its
    # burst in seconds of that rate
    wal_replay_rate_limit: float = 0.0
    wal_replay_burst: float = 2.0
    alerts: AlertsConfig = field(default_factory=AlertsConfig)

    @property
    def is_local(self) -> bool:
        """A server is local iff it forwards (reference server.go:1447)."""
        return self.forward_address != ""

    def apply_defaults(self) -> "Config":
        if not self.aggregates:
            self.aggregates = ["min", "max", "count"]
        if not self.hostname and not self.omit_empty_hostname:
            self.hostname = socket.gethostname()
        if self.interval <= 0:
            self.interval = 10.0
        if self.metric_max_length <= 0:
            self.metric_max_length = 4096
        return self


_DURATION_FIELDS = {"interval", "forward_retry_base", "forward_retry_max",
                    "circuit_breaker_recovery"}


def _known(cls) -> set:
    return {f.name for f in fields(cls)}


def _check_keys(raw: dict, cls, where: str) -> None:
    for key in raw:
        if key not in _known(cls):
            raise ValueError(
                f"config key {where}{key!r} is not supported by "
                f"veneur_tpu_torch")


def _routing_config(item) -> SinkRoutingConfig:
    """One metric_sink_routing entry, parsed as the JAX package parses
    it (veneur_tpu/config.py:533-541)."""
    item = dict(item or {})
    for key in item:
        if key not in ("name", "match", "sinks"):
            raise ValueError(
                f"config key 'metric_sink_routing.{key}' is not supported "
                f"by veneur_tpu_torch")
    sinks = dict(item.get("sinks", {}) or {})
    for key in sinks:
        if key not in ("matched", "not_matched"):
            raise ValueError(
                f"config key 'metric_sink_routing.sinks.{key}' is not "
                f"supported by veneur_tpu_torch")
    return SinkRoutingConfig(
        name=item.get("name", ""), match=item.get("match", []) or [],
        matched=sinks.get("matched", []) or [],
        not_matched=sinks.get("not_matched", []) or [])


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """A Config from parsed YAML; raises on any key the port lacks."""
    raw = dict(raw or {})
    _check_keys(raw, Config, "")
    cfg = Config()
    for key, value in raw.items():
        if key in _DURATION_FIELDS:
            value = parse_duration(value)
        elif key == "tpu":
            value = dict(value or {})
            _check_keys(value, TpuConfig, "tpu.")
            value = TpuConfig(**value)
        elif key == "metric_sinks":
            sinks = []
            for item in value or []:
                item = dict(item or {})
                _check_keys(item, SinkConfig, "metric_sinks.")
                sinks.append(SinkConfig(**item))
            value = sinks
        elif key == "features":
            value = dict(value or {})
            _check_keys(value, Features, "features.")
            value = Features(**value)
        elif key == "alerts":
            value = dict(value or {})
            _check_keys(value, AlertsConfig, "alerts.")
            value = AlertsConfig(**value)
            value.interval = parse_duration(value.interval) or 1.0
        elif key == "metric_sink_routing":
            value = [_routing_config(item) for item in value or []]
        elif key == "percentiles":
            value = [float(p) for p in value]
        setattr(cfg, key, value)
    return cfg.apply_defaults()


def read_config(path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Load a YAML config file (plus `overrides`); see config_from_dict."""
    raw: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if overrides:
        raw.update(overrides)
    return config_from_dict(raw)
