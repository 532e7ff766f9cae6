"""Configuration of the port's server: the YAML keys of veneur_tpu's
config that this port implements, with the same names and defaults.

A key the port does not implement (`jax_compilation_cache_dir`,
`tpu.pallas_tdigest_flush`) raises with the key's name: a configuration
is never half-applied in silence.
Durations accept Go-style strings ("10s", "500ms") or numbers of
seconds; the private keys (`grpc_tls_key`, `forward_tls_key`,
`tls_key`, `sentry_dsn`) become StringSecrets, redacted in
/config/json.

`read_config` overlays the environment on the file, as the JAX package
does: `VENEUR_<KEY>` sets a top-level key and `VENEUR_TPU_<FIELD>` a
field of `tpu:`, each string coerced by the type of the key's current
value (bool, int, float, a comma-separated list, a duration). A
`VENEUR_*` variable that names a JAX key the port lacks raises with its
name, as that key would in the file; a structured key (a block, a list
of blocks, a mapping) cannot come from the environment and raises too.
Any other `VENEUR_*` name is ignored.
"""

from __future__ import annotations

import os
import re
import socket
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

import yaml

from veneur_tpu_torch.util.secret import StringSecret

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
class SourceConfig:
    """One `sources` entry: a pull source of kind `otlp` or
    `openmetrics` (veneur_tpu_torch/sources), its own `config` mapping,
    and tags added to everything it ingests."""

    kind: str = ""
    name: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    tags: List[str] = field(default_factory=list)


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
    # shards of the column store: every family's interval state
    # partitions into this many shards, all on the store's device
    # (core/sharded_tables.py, parallel/collectives.py); 0/1 = one table
    # per family, at most 128
    shards: int = 1
    # "digest": a key's 64-bit digest picks its home shard at mint time,
    # all five families shard and the merged flush equals a one-table
    # store's; "roundrobin": batches rotate over the shards, and only the
    # histogram and set families shard
    shard_routing: str = "digest"
    # take the numpy columnar decoder instead of the native C++ parser
    # and pump (the native library builds with g++ at first use, and a
    # failed build raises rather than falling back)
    disable_native_parser: bool = False
    # idle-row reclamation: a key idle for this many flushes loses its
    # row (its dictionary entry and intern mappings go at once, the row
    # id is recycled one flush later); 0 keeps every row for good
    idle_key_intervals: int = 5
    # hard cap on the rows of each family: a new key past it is dropped
    # and counted (intern.keys_dropped_total, the ledger's agg.rejected)
    # until reclamation frees rows; 0 = unlimited
    max_rows_per_family: int = 2_000_000


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
    # the cardinality observatory (core/cardinality.py): per-NAME budgets
    # of new-key mints per interval (0 = off). Past soft, a name's further
    # mints are kept 1 in round(1/degraded_keep); past hard they are
    # refused; both are shed (reason cardinality_degraded / cardinality).
    # Existing rows always update. The tracker keeps top_k names; the
    # hll_names top offenders get per-tag-key HLLs once a name mints
    # hll_min_mints keys in one interval.
    cardinality_soft_limit: int = 0
    cardinality_hard_limit: int = 0
    cardinality_degraded_keep: float = 0.1
    cardinality_top_k: int = 512
    cardinality_hll_names: int = 8
    cardinality_hll_min_mints: int = 64
    # fault injection at the egress seams (util/chaos.py): seeded
    # probabilistic errors and delays at forward_send, sink_flush,
    # http_post and health_probe (`chaos_seams`, empty = all), and a
    # deterministic delay of every forward_send
    chaos_enabled: bool = False
    chaos_error_rate: float = 0.0
    chaos_delay_rate: float = 0.0
    chaos_delay: float = 0.0  # duration per injected delay
    chaos_seams: List[str] = field(default_factory=list)
    chaos_seed: int = 0
    chaos_forward_latency_ms: float = 0.0
    # ingest chaos (with chaos_enabled): per-datagram drop / truncate /
    # duplicate rolls before parsing, simulated RSS the watermark ladder
    # adds to the real one, and every Nth admitted slow-path sample
    # dropped with no accounting (the flow ledger's drill; 0 = off)
    chaos_ingest_drop_rate: float = 0.0
    chaos_ingest_truncate_rate: float = 0.0
    chaos_ingest_duplicate_rate: float = 0.0
    chaos_ingest_rss_bytes: int = 0
    chaos_ledger_leak: int = 0
    # reshard crossings (deterministic, util/chaos.py): the plan
    # thread's prewarm delay, every Nth range-segment append faulted,
    # and a delay between the durable segments and their merge-back
    chaos_reshard_prewarm_delay_s: float = 0.0
    chaos_reshard_append_fault_nth: int = 0
    chaos_reshard_cutover_delay_s: float = 0.0
    # the forward's circuit breaker: consecutive failures to open, and
    # how long it stays open before its one half-open probe (duration)
    circuit_breaker_failure_threshold: int = 3
    circuit_breaker_recovery: float = 30.0
    # emit flush.unique_timeseries_total: the series touched in each
    # interval, counted exactly from the tables' touched masks
    count_unique_timeseries: bool = False
    # set by the CLI's -debug, as in the JAX package; nothing reads it
    debug: bool = False
    # tags added to every metric the DogStatsD slow path parses (the
    # columnar path leaves them out, as the JAX package's does)
    extend_tags: List[str] = field(default_factory=list)
    features: Features = field(default_factory=Features)
    # overlap the flush with the next interval (core/flushexec.py): each
    # tick swaps its interval out, reads it out on the readout executor,
    # and delivers the previous interval's readout
    flush_async: bool = False
    # run a last flush in shutdown()
    flush_on_shutdown: bool = False
    # not ready (/healthcheck/ready 503), and the process aborts, after
    # this many intervals without a flush (0 disables the watchdog)
    flush_watchdog_missed_flushes: int = 0
    # host:port of the global server's import endpoint; set, this server
    # is local and forwards its mergeable state there every interval
    forward_address: str = ""
    # metrics that declare no scope become global-only: a local then
    # aggregates nothing itself and forwards everything
    forward_only: bool = False
    # forward retry: jittered exponential backoff inside the interval's
    # budget (base and max are durations)
    forward_retry_max_attempts: int = 3
    forward_retry_base: float = 0.2
    forward_retry_max: float = 2.0
    # with carryover_spool_dir set, append every forwardable interval to
    # the spool (fsync'd, stamped with its interval start) before it is
    # sent; the spool's drain is the only send path
    forward_wal: bool = False
    # the elastic reshard's range-segment WAL (parallel/reshard.py):
    # every migrating range cell is appended here before it merges into
    # the new topology, so a crash mid-cutover replays it at the next
    # start. Empty falls back to <carryover_spool_dir>/reshard; with
    # neither, a cutover merges from memory without crash cover.
    reshard_spool_dir: str = ""
    # a plan + cutover not done this long after begin() fails readiness
    reshard_deadline: float = 30.0  # duration
    # mTLS of the forward client (inline PEM or file paths); the
    # authority verifies the global, a certificate and key present it
    forward_tls_certificate: str = ""
    forward_tls_key: StringSecret = field(default_factory=StringSecret)
    forward_tls_authority_certificate: str = ""
    # host:port the import server (gRPC /forwardrpc.Forward) listens on
    grpc_address: str = ""
    # DogStatsD packets and SSF spans over gRPC (core/grpc_ingest.py):
    # host:port per server
    grpc_listen_addresses: List[str] = field(default_factory=list)
    # TLS of the import server at grpc_address (inline PEM or file
    # paths); with an authority, clients must present certificates
    grpc_tls_certificate: str = ""
    grpc_tls_key: StringSecret = field(default_factory=StringSecret)
    grpc_tls_authority_certificate: str = ""
    # the family DogStatsD histogram/timer samples aggregate in:
    # "tdigest" (reference parity) or "circllhist" (log-linear bins,
    # exact merges); `|l` samples always use the circllhist family
    histogram_encoding: str = "tdigest"
    hostname: str = ""
    # host:port of the operator HTTP API (core/httpapi.py); empty = none
    http_address: str = ""
    # serve POST /quitquitquit (shuts the server down)
    http_quit: bool = False
    # SLI timers derived from indicator spans: one per service and error
    # flag, and one global-only per span name ("objective"); empty = off
    indicator_span_timer_name: str = ""
    objective_span_timer_name: str = ""
    # pump chunk size in samples (bounds the hand-off batch and the
    # per-chunk native memory)
    ingest_batch_max_samples: int = 65536
    # admission (core/overload.py): token-bucket rate limits, statsd in
    # samples per second (one take per parsed batch) and spans per
    # second (0 = unlimited), each bucket holding this duration of its
    # rate. An over-limit statsd batch keeps its counter and gauge
    # samples and sheds its histogram, llhist and set samples.
    ingest_rate_limit_statsd: float = 0.0
    ingest_rate_limit_spans: float = 0.0
    ingest_rate_limit_burst: float = 1.0
    # chunks each native reader cycles through its SPSC rings (min 3); a
    # full ring blocks the reader, counted as a stall
    ingest_ring_slots: int = 4
    interval: float = 10.0
    # the latency observatory (core/latency.py): sample age per plane,
    # queue dwell and depth; false hands out plain queues
    latency_observatory: bool = True
    # the flow ledger (core/ledger.py): per-interval conservation checks
    # closed at every flush; strict raises LedgerImbalance out of the
    # flush (for tests and soaks); closed intervals kept for
    # /debug/ledger
    ledger_enabled: bool = True
    ledger_strict: bool = False
    ledger_history: int = 32
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
    # threads that extract span metrics and fan spans out to span sinks
    num_span_workers: int = 1
    # keep the configured hostname empty instead of defaulting it
    omit_empty_hostname: bool = False
    # concurrent POSTs of one Datadog flush (the sink's
    # datadog_num_workers overrides it)
    num_workers: int = 1
    # the RSS watermark ladder (core/overload.py; 0 = off): at soft the
    # server is degraded (spans paused, histogram/set samples kept at
    # degraded_keep), at hard it sheds every histogram/set sample;
    # counter and gauge deltas are always kept. poll is a duration.
    overload_watermark_soft_bytes: int = 0
    overload_watermark_hard_bytes: int = 0
    overload_watermark_poll: float = 1.0
    overload_watermark_degraded_keep: float = 0.25
    # the device watermark rung: the same ladder over the device
    # observatory's HBM-ledger bytes instead of host RSS (0 = off); the
    # combined state is the severity max of the two rungs
    overload_device_soft_bytes: int = 0
    overload_device_hard_bytes: int = 0
    # the device observatory (core/deviceobs.py): HBM generation ledger
    # and kernel registry, served at /debug/device
    device_observatory: bool = True
    # the profiling plane (core/profiling.py): a continuous all-threads
    # stack sampler from startup (/debug/profile/cpu), and a port that
    # serves torch.profiler device-trace captures (`GET ?seconds=N`)
    enable_profiling: bool = False
    profile_server_port: int = 0
    # Go-runtime profiler rates, accepted for config compatibility only
    # (a warning at start): the /debug/pprof routes are the analog
    block_profile_rate: int = 0
    mutex_profile_fraction: int = 0
    # crash reporting: the CLIs send ERROR records and thread panics to
    # Sentry when sentry-sdk is installed
    sentry_dsn: StringSecret = field(default_factory=StringSecret)
    percentiles: List[float] = field(
        default_factory=lambda: [0.5, 0.75, 0.99])
    # launch each family's next capacity rung ahead of need, at startup
    # and after every resize (core/flushexec.py ShapeLadderPrewarmer)
    prewarm_ladder: bool = False
    # SO_RCVBUF of each UDP listener socket
    read_buffer_size_bytes: int = 2 * 1024 * 1024
    # pull sources (veneur_tpu_torch/sources): OTLP/HTTP listeners and
    # OpenMetrics scrapes, each on a thread of its own
    sources: List[SourceConfig] = field(default_factory=list)
    # spans the channel to the span workers holds; a full channel drops
    span_channel_capacity: int = 100
    # spans each span sink's isolation buffer holds; 0 = max(4096, 8 x
    # span_channel_capacity)
    span_sink_queue_capacity: int = 0
    span_sinks: List[SinkConfig] = field(default_factory=list)
    # SSF listeners: udp:// (a span per datagram), unix:// and tcp://
    # (framed spans)
    ssf_listen_addresses: List[str] = field(default_factory=list)
    # host:port the statsd self-metrics go to over UDP ("internal":
    # straight back into this server's parser); empty = none sent
    stats_address: str = ""
    statsd_listen_addresses: List[str] = field(default_factory=list)
    # the pipeline supervisor (durations; 0 = off): a thread whose
    # heartbeat is older than the deadline is a stall, and one stalled
    # past the escalation deadline aborts the process
    supervisor_deadline: float = 0.0
    supervisor_poll: float = 1.0
    supervisor_escalation_deadline: float = 0.0
    # align flush ticks to multiples of the interval on the wall clock
    synchronize_with_interval: bool = False
    # tag prefixes the import server strips from imported metrics
    tags_exclude: List[str] = field(default_factory=list)
    # TLS of the TCP statsd listeners (inline PEM or file paths); with
    # an authority, clients must present certificates
    tls_authority_certificate: str = ""
    tls_certificate: str = ""
    tls_key: StringSecret = field(default_factory=StringSecret)
    tpu: TpuConfig = field(default_factory=TpuConfig)
    # the self-trace plane (trace/store.py): exemplars kept (names)
    trace_exemplar_names: int = 64
    # longest SSF frame (and UDP span datagram) taken
    trace_max_length_bytes: int = 16 * 1024 * 1024
    # share of flush intervals traced (deterministic 1-in-N), and the
    # /debug/traces store's bounds: traces kept, spans per trace
    trace_self_sample_rate: float = 1.0
    trace_store_traces: int = 128
    trace_store_spans: int = 256
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
        if self.read_buffer_size_bytes <= 0:
            self.read_buffer_size_bytes = 2 * 1024 * 1024
        if self.span_channel_capacity <= 0:
            self.span_channel_capacity = 100
        if self.span_sink_queue_capacity <= 0:
            self.span_sink_queue_capacity = max(
                4096, 8 * self.span_channel_capacity)
        if self.trace_max_length_bytes <= 0:
            self.trace_max_length_bytes = 16 * 1024 * 1024
        if self.tpu.shard_routing not in ("digest", "roundrobin"):
            raise ValueError(
                f"config key 'tpu.shard_routing' must be digest or "
                f"roundrobin, got {self.tpu.shard_routing!r}")
        if not 0 <= self.tpu.shards <= 128:
            raise ValueError(f"config key 'tpu.shards' must be 0..128, got "
                             f"{self.tpu.shards}")
        return self


_DURATION_FIELDS = {"interval", "forward_retry_base", "forward_retry_max",
                    "circuit_breaker_recovery", "chaos_delay",
                    "ingest_rate_limit_burst", "overload_watermark_poll",
                    "supervisor_deadline", "supervisor_poll",
                    "supervisor_escalation_deadline", "reshard_deadline"}
_SECRET_FIELDS = {"grpc_tls_key", "forward_tls_key", "tls_key",
                  "sentry_dsn"}


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


def _config_from_raw(raw: Dict[str, Any]) -> Config:
    """A Config from parsed YAML, before the defaults; raises on any key
    the port lacks."""
    raw = dict(raw or {})
    _check_keys(raw, Config, "")
    cfg = Config()
    for key, value in raw.items():
        if key in _DURATION_FIELDS:
            value = parse_duration(value)
        elif key in _SECRET_FIELDS:
            value = StringSecret(str(value) if value is not None else "")
        elif key == "tpu":
            value = dict(value or {})
            _check_keys(value, TpuConfig, "tpu.")
            value = TpuConfig(**value)
        elif key in ("metric_sinks", "span_sinks", "sources"):
            cls = SourceConfig if key == "sources" else SinkConfig
            items = []
            for item in value or []:
                item = dict(item or {})
                _check_keys(item, cls, f"{key}.")
                items.append(cls(**item))
            value = items
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
    return cfg


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """A Config from parsed YAML; raises on any key the port lacks."""
    return _config_from_raw(raw).apply_defaults()


# the JAX package's keys that the port does not implement: a VENEUR_*
# variable naming one raises, as the key does in a file
_JAX_ONLY_KEYS = frozenset({"jax_compilation_cache_dir"})
_JAX_ONLY_TPU_KEYS = frozenset({"pallas_tdigest_flush"})


def _env_value(raw: str, current: Any, key: str) -> Any:
    """An environment string coerced by the type of the key's current
    value (the JAX package's rule)."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if key in _DURATION_FIELDS:
        return parse_duration(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, StringSecret):
        return StringSecret(raw)
    if isinstance(current, list):
        vals = [v for v in raw.split(",") if v]
        if key == "percentiles":
            return [float(v) for v in vals]
        return vals
    if isinstance(current, str):
        return raw
    raise ValueError(f"config key {key!r} cannot be set from the "
                     f"environment")


_LIST_OF_BLOCKS = frozenset({"metric_sinks", "span_sinks", "sources",
                             "metric_sink_routing"})


def _overlay_env(cfg: Config, env) -> Config:
    """VENEUR_<KEY> over the top-level keys and VENEUR_TPU_<FIELD> over
    `tpu:`; a JAX key the port lacks raises by name."""
    for env_key, raw in env.items():
        if not env_key.startswith("VENEUR_"):
            continue
        key = env_key[len("VENEUR_"):].lower()
        if key.startswith("tpu_"):
            field_name = key[len("tpu_"):]
            if field_name in _JAX_ONLY_TPU_KEYS:
                raise ValueError(
                    f"config key 'tpu.{field_name}' ({env_key}) is not "
                    f"supported by veneur_tpu_torch")
            if field_name in _known(TpuConfig):
                setattr(cfg.tpu, field_name, _env_value(
                    str(raw), getattr(cfg.tpu, field_name), field_name))
                continue
        if key in _JAX_ONLY_KEYS:
            raise ValueError(f"config key {key!r} ({env_key}) is not "
                             f"supported by veneur_tpu_torch")
        if key not in _known(Config):
            continue
        if key in _LIST_OF_BLOCKS:
            raise ValueError(f"config key {key!r} cannot be set from the "
                             f"environment")
        setattr(cfg, key, _env_value(str(raw), getattr(cfg, key), key))
    return cfg


def read_config(path: Optional[str] = None,
                overrides: Optional[dict] = None,
                env: Optional[Dict[str, str]] = None) -> Config:
    """Load a YAML config file (plus `overrides`), overlay the VENEUR_*
    variables of `env` (os.environ when None), then apply the defaults;
    see config_from_dict and the module note."""
    raw: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if overrides:
        raw.update(overrides)
    cfg = _config_from_raw(raw)
    return _overlay_env(cfg, os.environ if env is None else env
                        ).apply_defaults()
