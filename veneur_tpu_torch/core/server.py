"""The port's server: DogStatsD over UDP into the device column store,
flushed every interval to the metric sinks (the aggregation loop of
veneur_tpu/core/server.py), and the two ends of the forward tier.

With `forward_address` set the server is local: each flush also collects
the mergeable state of its non-local rows (forward/convert.py encodes it)
and sends it, on a thread of its own, to the global server's import
endpoint (forward/client.py, with retry, circuit breaker, carryover and
the optional durable spool and WAL); the flush waits for that thread up
to one interval from its start. With `grpc_address` set it runs that
endpoint (forward/server.py), which merges what the locals send into
this server's tables on its device, and stale replayed intervals into
the backfill plane (forward/backfill.py), whose closed buckets flush
with their original timestamps beside the live series.

Each metric sink flushes on a thread of its own (the sink plane of
veneur_tpu/core/server.py): at most one thread per sink, a sink whose
previous flush still runs is skipped, each sink has a circuit breaker
built from the `circuit_breaker_*` keys, a failed batch is retried once
with the next interval, and the flush waits for the sink threads and the
forward thread together, outside its lock, until one interval after it
began. Sinks without per-sink filters or routing take the columnar
`flush_batch`; the others get the materialised InterMetric list.

The operator surface: a `Telemetry` registry (core/telemetry.py) fed by
the statsd self-metrics client (util/scopedstatsd.py, to
`stats_address`) and by scrape-time collectors, the flight recorder of
events and flush rounds, the live query plane (core/query.py) and the
alert engine (core/alerts.py) over it, the runtime diagnostics
(core/diagnostics.py) and, with `http_address`, the HTTP API
(core/httpapi.py) that serves them all.

The flow ledger (core/ledger.py) checks four conservation identities at
the end of every flush, as the JAX server declares them: `ingest`
(samples admitted = applied + rejected), `forward` (snapshotted = acked
+ merged away + shed, with the carryover, the in-flight send, the spool
and its quarantine as stocks), `backfill` (merged = closed, the open
buckets as stock) and `forward_tier` (acked = what the receiver reports
merged, rejected or deduplicated). `ledger_strict` makes an imbalance
raise out of `flush()`. `forward_only` makes every unscoped metric
global-only. With `chaos_enabled` the egress seams inject faults
(util/chaos.py); `forward_tls_*` and `grpc_tls_*` put the forward tier
under (m)TLS (util/grpctls.py).

DogStatsD reaches the store through the batch ingest plane
(core/ingest.py): UDP datagrams by default through the native C++ pump,
UNIX datagrams through the native reader, TCP lines (optionally under
mutual TLS) and gRPC `SendPacket` bodies through the parse path;
`tpu.disable_native_parser: true` selects the numpy columnar decoder
instead. The native library builds with g++ at first use, and a build
failure raises here.

The overload plane (core/overload.py): the statsd and span token buckets
(`ingest_rate_limit_*`), the RSS watermark ladder (`overload_watermark_*`:
ok, degraded, shedding), the kernel-drop monitor of every UDP socket and
the pipeline supervisor (`supervisor_*`) over the pump dispatchers, span
workers, flush loop and alert loop. Spans shed first, histogram and set
samples next, counter and gauge deltas never; every shed sample is in
the shed table, the flow ledger's `ingress.shed` stage. Not ready while
shedding. The chaos plan's ingest seams (drop, truncate, duplicate,
simulated RSS, the ledger leak) sit in the packet intake and
`ingest_metric`.

The self-trace plane (trace/store.py): every flush is a `flush` span
with `flush.family` and `flush.sink` children, sent through the trace
client into this server's own span pipeline; a sampled interval's
spans also land in the bounded store behind /debug/traces. A local's
forward carries the interval's lineage and exemplars (`x-veneur-trace`,
`x-veneur-exemplars-bin`), and a global's next flush parents under the
import that adopted it. `|l` samples on the slow path are exemplar
candidates; events and ledger intervals carry the active trace id.

Pull sources (sources/): `sources:` builds each by kind from the
registry (an unknown kind raises): OTLP/HTTP listeners and OpenMetrics
scrapes, each on a thread of its own, started after the import server
and stopped and joined first on shutdown, before the listeners close and
the last flush, so nothing a source took arrives after it. They ingest
through `ingest_metric`, the slow path.

The table lifecycle (core/columnstore.py): after each flush an idle row
(no sample for `tpu.idle_key_intervals` flushes) is tombstoned: its key
leaves the tables' dictionaries and, in one sweep per flush over every
family, the intern table (native or numpy); its row is recycled one
flush later for a new key. `tpu.max_rows_per_family` caps each family's
rows: a new key past it is dropped and counted. With
`count_unique_timeseries` each flush counts the series of its interval
exactly (`flush.unique_timeseries_total`).

The span plane (reference server.go:654-736, worker.go:547-686): SSF
arrives over UDP (one span per datagram; with the native library the
reader decodes the spans and extracts their metrics in C++), over UNIX
and TCP streams of framed spans, and through gRPC `SendSpan`. Spans go
on a bounded channel (a full channel drops and counts) to the span
workers, which extract the metrics of the spans not yet extracted
(MetricExtractionSink: samples, indicator and objective timers,
`ssf.names_unique`) and hand every span in chunks to one isolation
buffer and thread per span sink (`_SpanSinkWorker`). Span sinks flush on
the sink plane's threads, keyed `span:<name>`. `drain_spans` waits until
every span handed to the channel is extracted and ingested by every
sink. The uniqueness rolls draw from generators derived from the
server's `rng`.

The device observatory (core/deviceobs.py, `device_observatory`, on by
default): the HBM ledger books every table generation through swap,
readout, recycle, resize and prewarm, the kernel registry every device
call; `device_report()` is /debug/device, and the ledger's total feeds
the overload ladder's device rung. The profiling plane
(core/profiling.py): `enable_profiling` runs the all-threads sampler
from start() to shutdown(), `profile_server_port` serves device-trace
captures. start() ends with `restart.mark_ready()`, the SIGUSR2
handoff's ready-file handshake (core/restart.py).

    server = Server(read_config("config.yaml"))   # tables on cuda:0
    server.start()
    ...
    server.shutdown()

`Server(cfg, device="cpu")` runs the tables on the CPU, with every
kernel's plain PyTorch version; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import queue
import random
import threading
import time
from concurrent.futures import TimeoutError as JoinTimeout
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from veneur_tpu_torch import native, protocol
from veneur_tpu_torch import sinks as sinks_mod
from veneur_tpu_torch import sources as sources_mod
from veneur_tpu_torch.config import Config, SinkConfig, read_config
from veneur_tpu_torch.core import telemetry as telemetry_mod
from veneur_tpu_torch.core.alerts import AlertEngine
from veneur_tpu_torch.core import restart
from veneur_tpu_torch.core.cardinality import CardinalityAccountant
from veneur_tpu_torch.core.columnstore import ColumnStore
from veneur_tpu_torch.core.deviceobs import DeviceObservatory
from veneur_tpu_torch.core.diagnostics import DiagnosticsLoop
from veneur_tpu_torch.core.flushexec import (FlushReadoutExecutor,
                                             ShapeLadderPrewarmer)
from veneur_tpu_torch.core.flusher import (FlushBatch, readout_columnstore,
                                           swap_columnstore)
from veneur_tpu_torch.core.grpc_ingest import GrpcIngestServer
from veneur_tpu_torch.core.httpapi import HTTPApi
from veneur_tpu_torch.core.ingest import BatchIngester, PyBatchIngester
from veneur_tpu_torch.core.latency import LatencyObservatory
from veneur_tpu_torch.core.ledger import FlowLedger
from veneur_tpu_torch.core.networking import Listener, start_ssf, start_statsd
from veneur_tpu_torch.core import overload as overload_mod
from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.core.overload import OverloadManager, TokenBucket
from veneur_tpu_torch.core.query import LiveQueryPlane
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.forward.backfill import BackfillPlane
from veneur_tpu_torch.forward.client import ForwardClient
from veneur_tpu_torch.forward.convert import forwardable_to_wire
from veneur_tpu_torch.forward.server import ImportServer
from veneur_tpu_torch import trace as trace_mod
from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import (HistogramAggregates,
                                               InterMetric, MetricScope,
                                               UDPMetric)
from veneur_tpu_torch.samplers.parser import ParseError, Parser
from veneur_tpu_torch.sinks.ssfmetrics import MetricExtractionSink
from veneur_tpu_torch.trace import context as trace_ctx
from veneur_tpu_torch.trace.store import SelfTracePlane, trace_id_hex
from veneur_tpu_torch.util import chaos as chaos_mod
from veneur_tpu_torch.util.grpctls import GrpcTLS
from veneur_tpu_torch.util.resilience import (Carryover, CircuitBreaker,
                                              RetryPolicy)
from veneur_tpu_torch.util.matcher import SinkRoutingMatcher, TagMatcher
from veneur_tpu_torch.util.scopedstatsd import NullClient, ScopedClient
from veneur_tpu_torch.util.spool import CarryoverSpool

logger = logging.getLogger("veneur_tpu_torch.server")

# wire type -> overload shed class (counter, gauge and status samples
# are never shed)
_SHED_CLASS = {
    m.HISTOGRAM: overload_mod.CLASS_HISTOGRAM,
    m.TIMER: overload_mod.CLASS_HISTOGRAM,
    m.LLHIST: overload_mod.CLASS_HISTOGRAM,
    m.SET: overload_mod.CLASS_SET,
}

# column-store family -> the intern table's family code (statuses are
# never registered there)
_NATIVE_FAMILY = {
    "counter": native.FAM_COUNTER,
    "gauge": native.FAM_GAUGE,
    "histogram": native.FAM_HISTO,
    "llhist": native.FAM_LLHIST,
    "set": native.FAM_SET,
}


class RawSpan:
    """A span still in wire form: the native SSF path already extracted
    its metrics, so it is decoded (for the span sinks) in a span worker
    instead of on the ingest path."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


class _SpanSinkWorker:
    """Per-sink span ingest isolation (reference worker.go:588-656): each
    span sink gets a bounded buffer and one thread, so a slow or hung
    sink drops its own spans instead of stalling the span workers. Spans
    move in chunks: the span workers submit whole batches and this thread
    swaps the pending list out in one lock window. Capacity counts spans;
    a chunk that would overflow is dropped whole (counted), except that
    an empty buffer always takes one chunk. `accepted` and `completed`
    (chunks ingested, or failed and logged) let the server's drain wait
    for the buffer to empty; `progress` is called after each round.
    With the latency observatory the buffer is the queue
    `span_sink:<name>`: its depth in spans, and each chunk's
    enqueue-to-drain dwell."""

    def __init__(self, sink, capacity: int, progress: Callable[[], None],
                 observatory=None):
        self.sink = sink
        self.capacity = max(16, capacity)
        self._progress = progress
        self._pending: list = []  # (enqueue monotonic, chunk) pairs
        self._pending_spans = 0
        self._dwell = None
        if observatory is not None and observatory.enabled:
            qname = f"span_sink:{sink.name()}"
            self._dwell = observatory.queue_hist(qname)
            observatory.register_queue(
                qname, lambda: self._pending_spans, self.capacity)
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self.dropped = 0
        self.ingested = 0
        self.accepted = 0
        self.completed = 0
        self._stop = threading.Event()
        self.thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.thread = threading.Thread(
            target=self._loop, name=f"span-sink-{self.sink.name()}",
            daemon=True)
        self.thread.start()

    def submit_many(self, spans) -> None:
        n = len(spans)
        if n == 0:
            return
        with self._lock:
            if self._pending and self._pending_spans + n > self.capacity:
                self.dropped += n
                return
            self._pending.append((time.monotonic(), spans))
            self._pending_spans += n
            self.accepted += n
            self._ready.notify()

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending:
                    if self._stop.is_set():
                        return
                    self._ready.wait(timeout=0.5)
                chunks, self._pending = self._pending, []
                self._pending_spans = 0
            dwell = self._dwell
            now = time.monotonic() if dwell is not None else 0.0
            for enqueued, chunk in chunks:
                if dwell is not None:
                    dwell.observe(now - enqueued)
                try:
                    self.sink.ingest_many(chunk)
                    self.ingested += len(chunk)
                except Exception:
                    logger.exception("span sink %s ingest failed",
                                     self.sink.name())
                with self._lock:
                    self.completed += len(chunk)
            self._progress()

    def stop(self, timeout: float = 2.0) -> None:
        """Signal, then join: the loop drains what was submitted before
        it sees the stop flag on its next empty wait."""
        self._stop.set()
        with self._lock:
            self._ready.notify()
        if self.thread is not None:
            self.thread.join(timeout)


class Server:
    def __init__(self, config: Config, device=None,
                 extra_metric_sinks: Optional[List] = None,
                 extra_span_sinks: Optional[List] = None,
                 rng: Optional[random.Random] = None, shard_groups=None):
        """`shard_groups` places a sharded store's shards over these
        devices, shard i in group i mod G (default: the first
        min(shards, cards) cards); tests and the smoke pass it to run
        the multi-card path on one device."""
        self.config = config
        self.device = pick_device(device)
        # the uniqueness rolls of the span plane draw from generators
        # derived from this one
        self.rng = rng if rng is not None else random.Random()
        self.interval = config.interval
        # forward_only: metrics that declare no scope become global-only,
        # so a local aggregates nothing itself and forwards everything
        # (reference server.go:547-552)
        self.parser = Parser(
            extend_tags=config.extend_tags,
            default_scope=(MetricScope.GLOBAL_ONLY if config.forward_only
                           else MetricScope.MIXED))
        tpu = config.tpu
        self.store = ColumnStore(
            counter_capacity=tpu.counter_capacity,
            gauge_capacity=tpu.gauge_capacity,
            histo_capacity=tpu.histo_capacity,
            set_capacity=tpu.set_capacity,
            batch_cap=tpu.batch_cap,
            set_promote_samples=tpu.set_promote_samples,
            set_max_dev_slots=tpu.set_max_dev_slots,
            llhist_capacity=tpu.llhist_capacity,
            histogram_encoding=config.histogram_encoding,
            max_rows=tpu.max_rows_per_family,
            device=self.device,
            shard_devices=tpu.shards,
            shard_routing=tpu.shard_routing,
            shard_groups=shard_groups)
        self._build_ledger()
        # the latency observatory (core/latency.py): per-plane sample age
        # from socket read to sink ack, and the dwell and depth of every
        # bounded hand-off; arrivals stamp the ledger's ingress.observed
        self.latency = LatencyObservatory(
            enabled=config.latency_observatory)
        self.latency.ledger = self.ledger if self.ledger.enabled else None
        self.aggregates = HistogramAggregates.from_names(config.aggregates)
        self.percentiles = tuple(config.percentiles)
        sinks_mod.register_builtin_sinks()
        self.metric_sinks: List = list(extra_metric_sinks or [])
        for sc in config.metric_sinks:
            factory = sinks_mod.MetricSinkTypes.get(sc.kind)
            if factory is None:
                raise ValueError(f"unknown metric sink kind: {sc.kind}")
            self.metric_sinks.append(factory(sc, config))
        # per-sink filters, only for sinks with an active one (an entry
        # here sends that sink the materialised list), and the routing
        # rules
        self.span_sinks: List = list(extra_span_sinks or [])
        for sc in config.span_sinks:
            factory = sinks_mod.SpanSinkTypes.get(sc.kind)
            if factory is None:
                raise ValueError(f"unknown span sink kind: {sc.kind}")
            self.span_sinks.append(factory(sc, config))
        # pull sources, started by start() on a thread each
        sources_mod.register_builtin_sources()
        self.sources: List = []
        for src_cfg in config.sources:
            factory = sources_mod.SourceTypes.get(src_cfg.kind)
            if factory is None:
                raise ValueError(f"unknown source kind: {src_cfg.kind}")
            self.sources.append(factory(src_cfg, config))
        self._source_threads: List[threading.Thread] = []
        # keys the row cap refused, as of the last intern.keys_dropped_total
        self._keys_dropped_reported = 0
        self._sink_filters: Dict[str, SinkConfig] = {
            sc.name or sc.kind: sc for sc in config.metric_sinks
            if (sc.strip_tags or sc.add_tags or sc.max_name_length
                or sc.max_tag_length or sc.max_tags)}
        self._routing: Optional[List[SinkRoutingMatcher]] = None
        if config.features.enable_metric_sink_routing:
            self._routing = [SinkRoutingMatcher(rc)
                             for rc in config.metric_sink_routing]
        # the sink plane, keyed `metric:<sink name>`: the last flush
        # thread per sink (a sink whose thread is alive is skipped, so a
        # hung sink holds one thread), its consecutive skips, its
        # breaker, the batch awaiting its one retry, and its counters
        # under the JAX package's self-metric names. _sink_lock guards
        # the spill, the counters and the per-flush records the threads
        # write.
        self._sink_flush_threads: Dict[str, threading.Thread] = {}
        self._sink_skip_depth: Dict[str, int] = {}
        self._sink_breakers: Dict[str, CircuitBreaker] = {}
        self._sink_spill: Dict[str, List[InterMetric]] = {}
        self._sink_counts: Dict[str, Dict[str, int]] = {
            name: {} for name in _SINK_COUNTERS}
        self._sink_lock = threading.Lock()
        # DogStatsD lines: received = parsed + rejected (parse errors and
        # oversized datagrams), plus pump chunks whose apply raised
        self.stats: Dict[str, int] = {"lines_received": 0,
                                      "lines_parsed": 0,
                                      "lines_rejected": 0,
                                      "ingest_dispatch_errors": 0,
                                      # SSF packets (datagrams, frames,
                                      # gRPC spans) and those that did
                                      # not decode or were oversized
                                      "ssf_packets_received": 0,
                                      "ssf_parse_errors": 0,
                                      # spans dropped at a full channel
                                      "spans_dropped": 0,
                                      # TCP lines over metric_max_length
                                      # (the connection is closed)
                                      "tcp_overlong_dropped": 0,
                                      # intervals stashed into the
                                      # carryover because the previous
                                      # forward was still running
                                      "forward_undispatched": 0}
        self._stats_lock = threading.Lock()
        # in-flight readouts dropped (raised, or wedged past the limit)
        self.readout_failed_total = 0
        self._dispatch_error: Optional[BaseException] = None
        # the columnar ingester: native unless explicitly disabled, and a
        # native build failure raises
        self._ingester = (PyBatchIngester(self)
                          if tpu.disable_native_parser
                          else BatchIngester(
                              self, random.Random(self.rng.getrandbits(64))))
        # the span pipeline: the metric extraction sink (always attached,
        # reference server.go:654-664, called inline by the span workers),
        # the bounded channel, the workers, and one isolation buffer per
        # span sink. _span_cv guards the channel's in/out counts the
        # drain waits on.
        self.metric_extraction = MetricExtractionSink(
            self.ingest_metric, self.parser,
            random.Random(self.rng.getrandbits(64)),
            indicator_timer_name=config.indicator_span_timer_name,
            objective_timer_name=config.objective_span_timer_name)
        self.span_chan: "queue.Queue" = self.latency.instrument_queue(
            "span_channel", maxsize=config.span_channel_capacity)
        self._span_workers: List[threading.Thread] = []
        self._span_sink_workers: List[_SpanSinkWorker] = []
        self._span_cv = threading.Condition()
        self._spans_in = 0
        self._spans_out = 0
        # seconds the span workers spent on their batches, summed over
        # the workers (they share the interpreter lock with ingest)
        self.span_worker_seconds = 0.0
        self._ssf_listeners: List[Listener] = []
        self.grpc_ingest_servers: List[GrpcIngestServer] = []
        self._events: List = []
        self._events_lock = threading.Lock()
        self._listeners: List[Listener] = []
        self._flush_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None
        # the forward tier's two ends, built by start()
        self.forward_client: Optional[ForwardClient] = None
        self.import_server: Optional[ImportServer] = None
        # the forward thread of the last dispatched interval, and the
        # first exception a forward thread raised (re-raised by flush()
        # and shutdown())
        self._forward_thread: Optional[threading.Thread] = None
        self._forward_error: Optional[BaseException] = None
        # the running interval's start (the previous flush boundary): the
        # WAL stamps it onto the interval's forwardable snapshot
        self._interval_start_unix = time.time()
        # timestamp-faithful backfill: imports stamped with an interval
        # older than backfill_after_s merge into per-interval buckets and
        # flush with their original timestamps. Built here, not in
        # start(), so that a manually wired ImportServer finds it.
        self.backfill: Optional[BackfillPlane] = None
        self.backfill_after_s = 0.0
        if config.backfill_max_open_intervals > 0:
            self.backfill = bf = BackfillPlane(
                percentiles=self.percentiles,
                max_open=config.backfill_max_open_intervals,
                ledger=self.ledger if self.ledger.enabled else None)
            self.backfill_after_s = (config.wal_stale_after_intervals
                                     * self.interval)
            self.ledger.stock("backfill_open", lambda: bf.open_metrics)
        # egress fault injection (util/chaos.py), installed at start()
        self.chaos = chaos_mod.Chaos.from_config(config)
        # per-phase wall seconds of the last flush (swap / dispatch /
        # device_sync, with its llhist_bins copy / assembly / sinks, from
        # the sink threads' dispatch to their join, on a global server
        # backfill_drain, and on a local server forward_encode / forward
        # (the forward thread, when it ended within the flush's wait)
        # with its carryover_merge / wal_append / spool_drain / total),
        # and per metric sink a `sink:<name>` record: status, duration_s,
        # cpu_s (the sink thread's own CPU seconds: the sink threads share
        # the interpreter lock, so a wall time includes the others' turns)
        # and the sink's note_egress (encode_s, send_s, encoder, gzip_s),
        # and per span sink a `span_sink:<name>` record of the same shape.
        # A sink thread that outlives the flush lands its record later,
        # marked `late`.
        self.last_flush_timings: Dict[str, Any] = {}
        # the overlapped flush (`flush_async`, core/flushexec.py): the
        # readout executor, made at the first async tick; the intervals
        # swapped and submitted to it, oldest first (their touched rows
        # are the ledger's flush_inflight_snapshot stock); and with
        # `prewarm_ladder`, the shape-ladder prewarmer started by start()
        self._flush_executor: Optional[FlushReadoutExecutor] = None
        self._inflight_flushes: List[dict] = []
        self.prewarmer: Optional[ShapeLadderPrewarmer] = None
        # the profiling plane, started by start(): the enable_profiling
        # sampler and the profile_server_port endpoint
        self.profiler = None
        self.profile_server = None
        self._build_operator_surface()
        self._build_overload_and_trace()
        self.ledger.on_event = self.telemetry.record_event
        self.telemetry.registry.add_collector(self.ledger.telemetry_rows)
        # rejected DogStatsD lines, an informational stage
        self.ledger.probe("ingress.parse_errors",
                          lambda: self.stats["lines_rejected"])
        if self.backfill is not None:
            self.backfill.on_event = self.telemetry.record_event

    def _build_ledger(self) -> None:
        """The flow ledger and its identities, declared as the JAX server
        declares them (veneur_tpu/core/server.py:310-370): every
        crossing below stamps it, and it closes at the end of each
        flush."""
        config = self.config
        self.ledger = ledger = FlowLedger(
            enabled=config.ledger_enabled, strict=config.ledger_strict,
            history=config.ledger_history)
        # ingested = aggregated + rejected; the migrating rows of a
        # reshard cutover, captured out of the old topology and not yet
        # merged into the new one, are a stock (0 at every close: the
        # cutover holds the flush lock)
        ledger.declare("ingest", inputs=("ingest.admitted",),
                       outputs=("agg.applied", "agg.rejected"),
                       stocks=("reshard_inflight",))
        # snapshotted = acked + merged-away + shed, with the carryover,
        # the durable spool and the in-flight send as inventory stocks
        ledger.declare(
            "forward", inputs=("forward.snapshot",),
            outputs=("forward.acked", "forward.merged_away",
                     "forward.shed"),
            stocks=("forward_carryover", "forward_spool",
                    "forward_inflight", "spool_quarantine"))
        # the backfill plane: every metric merged into a historical
        # bucket is retired when its bucket closes
        ledger.declare("backfill", inputs=("backfill.merged",),
                       outputs=("backfill.closed",),
                       stocks=("backfill_open",))
        # cross-tier reconciliation: what this local acked against what
        # the receiver reports (FlowCounts responses)
        ledger.declare(
            "forward_tier", inputs=("forward.acked_reported",),
            outputs=("forward.remote_merged", "forward.remote_rejected",
                     "forward.remote_deduped"))
        # an interval swapped out of the tables but not yet delivered
        # (flush_async) is inventory, not loss: its touched rows
        self._inflight_rows = 0
        ledger.stock("flush_inflight_snapshot",
                     lambda: float(self._inflight_rows))
        self.store.attach_ledger(ledger if ledger.enabled else None)

    def _build_operator_surface(self) -> None:
        """The telemetry registry and its collectors, the statsd
        self-metrics client, the diagnostics loop, the live query plane
        and the alert engine (all built here, so that tests can query
        and evaluate without start(); start() runs their threads and the
        HTTP API)."""
        config = self.config
        self.telemetry = telemetry_mod.Telemetry()
        registry = self.telemetry.registry
        registry.add_collector(self._live_telemetry_rows)
        registry.add_collector(self._ring_telemetry_rows)
        registry.add_collector(self.store.telemetry_rows)
        registry.add_collector(self.latency.telemetry_rows)
        if self.device.type == "cuda":
            registry.add_collector(telemetry_mod.device_memory_rows)
        if self.backfill is not None:
            registry.add_collector(self.backfill.telemetry_rows)
        # self-metrics: UDP to stats_address, or straight back into this
        # server's parser ("internal"); every emission tees into the
        # registry (reference scopedstatsd + server.go:518-524)
        scoped = dict(scopes=config.veneur_metrics_scopes,
                      additional_tags=config.veneur_metrics_additional_tags,
                      registry=registry)
        if config.stats_address == "internal":
            self.statsd = ScopedClient(packet_cb=self._self_packet, **scoped)
        elif config.stats_address:
            self.statsd = ScopedClient(address=config.stats_address,
                                       **scoped)
        else:
            self.statsd = NullClient(registry=registry)
        self.diagnostics: Optional[DiagnosticsLoop] = None
        if config.features.diagnostics_metrics_enabled:
            self.diagnostics = DiagnosticsLoop(
                self.statsd, self.interval,
                include_device=self.device.type == "cuda")
        # live query plane and alert engine: read-only captures of the
        # live generation. _readout_lock orders a query's captures against
        # the flush's swap, so one bundle never mixes two intervals, and
        # the launches of a query's readout against the flush's device
        # readout (the flush's host assembly runs outside it)
        self._readout_lock = threading.Lock()
        self.query_plane = LiveQueryPlane(self)
        registry.add_collector(self.query_plane.telemetry_rows)
        self.alerts = AlertEngine(self, self.query_plane,
                                  interval_s=config.alerts.interval)
        try:
            self.alerts.configure(config.alerts.rules)
        except Exception:
            # a bad rule table must not keep the server down: start with
            # an empty table, loudly; SIGHUP reloads it once fixed
            logger.exception("invalid alerts.rules; starting with an "
                             "empty rule table")
        registry.add_collector(self.alerts.telemetry_rows)
        # the elastic reshard (parallel/reshard.py): built here, not in
        # start(), so in-process callers can begin() and recover()
        from veneur_tpu_torch.parallel.reshard import ReshardController
        self.reshard = ReshardController(self)
        self.ledger.stock("reshard_inflight", self.reshard.inflight_metrics)
        registry.add_collector(self.reshard.telemetry_rows)
        self.http_api: Optional[HTTPApi] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self.flush_count = 0
        self.last_flush_unix = time.time()
        # set once shutdown() completes (a CLI exits on it when
        # /quitquitquit shut the server down)
        self.shutdown_complete = threading.Event()

    def _build_overload_and_trace(self) -> None:
        """The overload plane (admission buckets, the watermark ladder,
        kernel-drop polling, the supervisor; its shed table is the
        ledger's `ingress.shed` stage) and the self-trace plane (the
        interval trace id, the trace store behind /debug/traces, the
        exemplars), and the trace client whose spans (the flush's own)
        loop into this server's span pipeline and tee into the store.
        Their generators derive from the server's `rng`."""
        config = self.config
        registry = self.telemetry.registry
        self.overload = OverloadManager(
            config, chaos=self.chaos,
            on_transition=self._overload_transition,
            on_stall=self._supervisor_stall)
        registry.add_collector(self.overload.telemetry_rows)
        self.ledger.probe_map("ingress.shed", self.overload.shed_snapshot)
        # the cardinality observatory (core/cardinality.py), fed by every
        # table's mint path: heavy-hitter names, per-tag-key HLLs of the
        # top offenders, and the cardinality rung of the shed ladder (a
        # refused mint lands in the shed table, reason cardinality*)
        self.cardinality = CardinalityAccountant(
            soft_limit=config.cardinality_soft_limit,
            hard_limit=config.cardinality_hard_limit,
            degraded_keep=config.cardinality_degraded_keep,
            top_k=config.cardinality_top_k,
            hll_names=config.cardinality_hll_names,
            hll_min_mints=config.cardinality_hll_min_mints,
            on_shed=self.overload.shed,
            on_event=self.telemetry.record_event)
        self.store.attach_cardinality(self.cardinality)
        registry.add_collector(self.cardinality.telemetry_rows)
        # the device observatory (core/deviceobs.py): HBM generation
        # ledger and kernel registry, served at /debug/device, feeding
        # the overload ladder's device watermark rung
        self.deviceobs = DeviceObservatory(enabled=config.device_observatory)
        if self.deviceobs.enabled:
            self.store.attach_deviceobs(self.deviceobs)
            registry.add_collector(self.deviceobs.telemetry_rows)
            self.overload.attach_device_source(self.deviceobs.total_bytes)
        self.store.attach_resize_hook(self._store_resize)
        self.trace_plane = SelfTracePlane(
            service="veneur-tpu",
            sample_rate=config.trace_self_sample_rate,
            max_traces=config.trace_store_traces,
            max_spans=config.trace_store_spans,
            exemplar_names=config.trace_exemplar_names,
            rng=random.Random(self.rng.getrandbits(64)))
        registry.add_collector(self.trace_plane.telemetry_rows)
        registry.exemplar_source = self.trace_plane.exemplar_for
        self.telemetry.trace_source = self.trace_plane.active_trace_hex
        self.ledger.trace_source = self.trace_plane.active_trace_hex
        # a global's next flush adopts the latest fresh import's trace
        self._adopted_trace: Optional[tuple] = None
        self.trace_client = trace_mod.Client(
            trace_mod.ChannelBackend(self.ingest_span),
            capacity=config.span_channel_capacity,
            rng=random.Random(self.rng.getrandbits(64)),
            tee=self.trace_plane.record_proto)

    def _overload_transition(self, old: str, new: str, rss: int) -> None:
        """Flight-recorder hook for every watermark ladder edge."""
        self.telemetry.record_event(
            "overload_state", old=old, new=new, rss_bytes=rss)

    def _supervisor_stall(self, component: str, age: float) -> None:
        """Flight-recorder hook for every freshly detected stall."""
        self.telemetry.record_event(
            "pipeline_stall", component=component,
            heartbeat_age_s=round(age, 3))

    def adopt_flush_trace(self, trace_id: int, parent_span_id: int) -> None:
        """The import server's hook for a fresh import that carried a
        trace: this global's next flush parents under it (latest wins;
        duplicates were dropped by token before here). The flush itself
        sets the plane's active trace when it takes the adoption."""
        self._adopted_trace = (int(trace_id), int(parent_span_id))

    def _store_resize(self, family: str, old_cap: int, new_cap: int,
                      seconds: float, kind: str = "resize",
                      prewarmed: bool = False) -> None:
        """Flight-recorder hook for every capacity doubling (kind
        "resize", fired under the table's buffer lock: an event and an
        enqueue only) and for the first batch apply after it (kind
        "first_apply", the apply's seconds to the device's completion,
        tagged `prewarmed` when the shape-ladder prewarmer launched this
        rung first). With the prewarmer, a resize queues the rung after
        the one just reached."""
        if kind == "resize" and self.prewarmer is not None:
            self.prewarmer.note_resize(family, new_cap)
        self.telemetry.record_event(
            f"columnstore_{kind}", family=family, old_capacity=old_cap,
            new_capacity=new_cap, duration_s=round(seconds, 6),
            **({"prewarmed": True} if prewarmed else {}))

    def device_report(self) -> dict:
        """The /debug/device payload: the HBM generation ledger (by family
        and lifecycle state, with its forecast and the allocator's
        reconciliation), the kernel registry, and the overload ladder's
        device watermark rung."""
        out = self.deviceobs.report()
        dw = self.overload.device_watermarks
        out["watermarks"] = {
            "state": dw.state,
            "soft_bytes": dw.soft_bytes,
            "hard_bytes": dw.hard_bytes,
            "last_bytes": dw.last_rss,
            "transitions": dw.transitions,
        }
        return out

    def cardinality_report(self, top: int = 20, name: str = "") -> dict:
        """The /debug/cardinality payload (the JAX server's): with
        `name`, one name's exact per-family rows and its tag-key HLL
        estimates; otherwise the top names by live rows and by mint
        activity, the tables' capacity and churn, and the limits. The
        per-name scan is proportional to capacity: operator-triggered
        only."""
        if name:
            detail = self.cardinality.name_report(name)
            exact = self.store.live_rows_by_name().get(name)
            if exact is not None:
                detail.update(exact)
            else:
                detail.setdefault("live_rows", 0)
            return detail
        per_name = self.store.live_rows_by_name()
        tracked = {r["name"]: r for r in self.cardinality.top(top)}
        # the top names by exact live rows and the tracker's top by mint
        # activity: a refused storm has few admitted rows, but its mint
        # rate is what the operator came to see
        by_rows = sorted(
            per_name, key=lambda nm: (per_name[nm]["live_rows"],
                                      per_name[nm]["touched_rows"]),
            reverse=True)[:max(0, top)]
        top_list = []
        for nm in set(by_rows) | set(tracked):
            row = {"name": nm}
            row.update(per_name.get(
                nm, {"live_rows": 0, "touched_rows": 0, "families": {}}))
            rec = tracked.get(nm)
            if rec is not None:
                for field in ("mints_interval", "mints_last_interval",
                              "mint_rate_per_s", "shed_total"):
                    row[field] = rec[field]
            tag_report = self.cardinality.tag_report(nm)
            if tag_report is not None:
                row["tags"] = tag_report
            top_list.append(row)
        top_list.sort(
            key=lambda r: (r["live_rows"] + r.get("mints_interval", 0)
                           + r.get("mints_last_interval", 0)),
            reverse=True)
        del top_list[max(0, top):]
        return {
            "generated_unix": round(time.time(), 3),
            "interval_s": round(self.cardinality.interval_s, 3),
            "total_names": len(per_name),
            "tables": self.store.capacity_report(),
            "top": top_list,
            "limits": self.cardinality.limits_report(),
        }

    def _self_packet(self, packet: bytes) -> None:
        """Loop a self-metric packet straight back into the parse path."""
        try:
            self.parser.parse_metric_fast(packet, self.ingest_metric)
        except ParseError:
            pass

    def ingest_metric(self, metric: UDPMetric) -> None:
        """The slow path's one way into the column store. A histogram or
        set sample passes the shed ladder (counter and gauge samples are
        always kept); an admitted sample stamps the flow ledger's
        ingest.admitted, which the table's agg.applied or agg.rejected
        must balance. The chaos_ledger_leak seam sits between the stamp
        and the store. An `|l` sample is offered to the interval's
        exemplar capture."""
        cls = _SHED_CLASS.get(metric.key.type)
        if cls is not None and not self.overload.admit_sample(cls):
            return
        self.ledger.note("ingest.admitted", 1, key="python")
        chaos = self.chaos
        if chaos is not None and chaos.leak_sample():
            return  # the drill: gone with no accounting at all
        if metric.value is not None:
            self.trace_plane.maybe_capture(
                metric.key.name, metric.value,
                always=metric.key.type == m.LLHIST)
        self.store.process(metric)

    def _ingest_metric_essential(self, metric: UDPMetric) -> None:
        """Essential-only intake of an over-limit packet: histogram and
        set samples are shed (counted), counter and gauge samples kept."""
        cls = _SHED_CLASS.get(metric.key.type)
        if cls is not None and not self.overload.admit_sample(
                cls, over_limit=True):
            return
        self.ledger.note("ingest.admitted", 1, key="python")
        self.store.process(metric)

    def _live_telemetry_rows(self) -> List[tuple]:
        """Scrape-time /metrics rows for live counters the registry does
        not own: the line counters, the flush rounds, and per sink the
        breaker state (0 closed / 1 open / 2 half-open) and opens, the
        pileup depth and the pending spill."""
        with self._stats_lock:
            stats = dict(self.stats)
        rows = [(key if key.startswith("ingest") else f"ingest.{key}",
                 "counter", float(value), ())
                for key, value in stats.items()]
        # the trace client's own drops (its bounded buffer), apart from
        # the span channel's
        rows.append(("trace.spans_dropped", "counter",
                     float(self.trace_client.spans_dropped), ()))
        for worker in self._span_sink_workers:
            tags = [f"sink:{worker.sink.name()}"]
            rows.append(("ingest.span_sink_dropped", "counter",
                         float(worker.dropped), tags))
            rows.append(("ingest.span_sink_ingested", "counter",
                         float(worker.ingested), tags))
        rows.append(("flush.rounds", "counter", float(self.flush_count), ()))
        rows.append(("flush.last_unix_seconds", "gauge",
                     self.last_flush_unix, ()))
        for key, breaker in list(self._sink_breakers.items()):
            tags = [f"target:{key}"]
            rows.append(("resilience.breaker_state", "gauge",
                         float(breaker.state_code), tags))
            rows.append(("resilience.breaker_opens", "counter",
                         float(breaker.open_total), tags))
        for key, depth in list(self._sink_skip_depth.items()):
            rows.append(("flush.sink_pileup_depth", "gauge", float(depth),
                         [f"sink:{key}"]))
        with self._sink_lock:
            for key, spill in self._sink_spill.items():
                rows.append(("flush.spill_pending", "gauge",
                             float(len(spill)), [f"sink:{key}"]))
        return rows

    def _ring_telemetry_rows(self) -> List[tuple]:
        """Scrape-time rows for the native pump's SPSC rings: per reader
        the ready-ring depth and capacity, sealed chunks and stalls."""
        rows = []
        for listener in list(self._listeners):
            pump = listener.pump
            if pump is None:
                continue
            depths, caps, sealed, stalls = pump.ring_stats()
            label = ":".join(str(part) for part in listener.address)
            for i in range(len(depths)):
                tags = [f"ring:{label}:{i}"]
                rows.append(("ingest.ring.depth", "gauge",
                             float(depths[i]), tags))
                rows.append(("ingest.ring.capacity", "gauge",
                             float(caps[i]), tags))
                rows.append(("ingest.ring.sealed_total", "counter",
                             float(sealed[i]), tags))
                rows.append(("ingest.ring.stalls_total", "counter",
                             float(stalls[i]), tags))
        return rows

    def _breaker_transition(self, name: str, old: str, new: str) -> None:
        """Flight-recorder hook for every breaker edge (forward + sinks)."""
        self.telemetry.record_event(
            "breaker_transition", target=name, old=old, new=new)

    def ready_state(self):
        """(ready, reason) for /healthcheck/ready: not ready while the
        overload ladder is shedding, while a reshard is past its
        deadline, or while the flush watchdog's budget is blown (a wedged
        flush loop means this instance is about to abort)."""
        if self.overload.state == overload_mod.SHEDDING:
            return False, (f"overload state {overload_mod.SHEDDING} "
                           f"(rss {self.overload.watermarks.last_rss} bytes)")
        if self.reshard.past_deadline():
            # a reshard past its deadline is a wedged topology swap: stop
            # routing here until it completes or is abandoned
            return False, (f"reshard past deadline: state "
                           f"{self.reshard.state}, deadline "
                           f"{self.reshard.deadline_unix:.0f}")
        if self.config.flush_watchdog_missed_flushes > 0:
            allowed = self.config.flush_watchdog_missed_flushes * self.interval
            since = time.time() - self.last_flush_unix
            if since > allowed:
                return False, (f"flush watchdog tripped: no flush for "
                               f"{since:.1f}s (allowed {allowed:.1f}s)")
        return True, ""

    def reload_alerts(self, config_path: Optional[str] = None) -> int:
        """SIGHUP hot reload of the `alerts:` block: re-read the config
        file (when given), swap the rule table in place (in-flight state
        survives for rule ids in both tables) and record the reload.
        Returns the new rule count; raises, keeping the old table, on a
        bad rule."""
        rules = self.config.alerts.rules
        interval_s = self.config.alerts.interval
        if config_path:
            fresh = read_config(config_path)
            rules = fresh.alerts.rules
            interval_s = fresh.alerts.interval
            self.config.alerts = fresh.alerts
        n = self.alerts.configure(rules, interval_s=interval_s)
        self.telemetry.record_event("alerts_reload", rules=n,
                                    interval_s=round(interval_s, 3))
        logger.info("alerts reloaded: %d rule(s), interval %.3fs",
                    n, interval_s)
        return n

    # -- ingest ----------------------------------------------------------

    def count_lines(self, received: int, parsed: int) -> None:
        """Count DogStatsD lines: received = parsed + rejected."""
        with self._stats_lock:
            self.stats["lines_received"] += received
            self.stats["lines_parsed"] += parsed
            self.stats["lines_rejected"] += received - parsed

    def note_dispatch_error(self, exc: BaseException) -> None:
        """A pump chunk's apply raised: count it and keep the first
        exception for flush() and shutdown() to re-raise."""
        with self._stats_lock:
            self.stats["ingest_dispatch_errors"] += 1
            if self._dispatch_error is None:
                self._dispatch_error = exc

    def _raise_dispatch_error(self) -> None:
        exc = self._dispatch_error
        if exc is not None:
            raise RuntimeError(
                f"{self.stats['ingest_dispatch_errors']} ingest chunk(s) "
                f"failed to apply; the first error follows") from exc

    def handle_packet_batch(self, datagrams) -> None:
        """Parse a batch of datagrams (newline-separated DogStatsD lines,
        reference server.go:1116-1140) through the columnar ingester into
        the column store. The chaos ingest faults (drop, truncate,
        duplicate) apply here first; admission gates the parsed batch in
        the ingester. A datagram longer than metric_max_length is one
        rejected line. The call is the span `ingest.batch` while the span
        recorder is armed, with the thread's CPU seconds."""
        armed = profiling.armed
        if armed:
            t0, cpu0 = time.perf_counter(), time.thread_time()
        chaos = self.chaos
        if chaos is not None and chaos.ingest_faults_planned:
            datagrams = chaos.mangle_packets(datagrams)
        self.latency.note_arrival("dogstatsd", len(datagrams))
        good = [d for d in datagrams
                if len(d) <= self.config.metric_max_length]
        if len(good) < len(datagrams):
            self.count_lines(len(datagrams) - len(good), 0)
        if good:
            self._ingester.ingest_buffer(b"\n".join(good))
        if armed:
            profiling.record("ingest.batch", t0, time.perf_counter(),
                             {"cpu_s": time.thread_time() - cpu0})

    def handle_metric_packet(self, packet: bytes,
                             shed_nonessential: bool = False) -> None:
        """Parse and process one slow-path line: an event, a service
        check, or a metric line (reference server.go:949-1000). With
        `shed_nonessential` (an over-limit line) its histogram and set
        samples are shed; counter and gauge samples are kept."""
        parsed = 0
        try:
            if packet.startswith(b"_sc"):
                self.ingest_metric(self.parser.parse_service_check(packet))
            elif packet.startswith(b"_e{"):
                event = self.parser.parse_event(packet)
                with self._events_lock:
                    self._events.append(event)
            else:
                self.parser.parse_metric_fast(
                    packet, self._ingest_metric_essential
                    if shed_nonessential else self.ingest_metric)
            parsed = 1
        except ParseError as e:
            logger.debug("could not parse %r: %s", packet[:100], e)
        self.count_lines(1, parsed)

    def handle_packet_buffer(self, buf: bytes,
                             shed_nonessential: bool = False) -> None:
        """Newline-split one multi-line datagram through the slow path
        (reference server.go:1116-1140). A buffer longer than
        metric_max_length is one rejected line (the JAX server's
        `parse_errors`); a buffer over the statsd rate limit sheds its
        histogram and set samples."""
        if len(buf) > self.config.metric_max_length:
            self.count_lines(1, 0)
            return
        if not shed_nonessential and not self.overload.admit_statsd_packet():
            shed_nonessential = True
        for line in buf.split(b"\n"):
            if line:
                self.handle_metric_packet(
                    line, shed_nonessential=shed_nonessential)

    # -- spans -----------------------------------------------------------

    def count_ssf(self, packets: int, errors: int) -> None:
        """Count SSF packets received and those that did not decode."""
        with self._stats_lock:
            self.stats["ssf_packets_received"] += packets
            self.stats["ssf_parse_errors"] += errors

    def handle_ssf_packet(self, packet: bytes) -> None:
        """One unframed SSF datagram through the Python decode (reference
        server.go:1053-1100): the span goes on the channel, and the span
        workers extract its metrics."""
        self.latency.note_arrival("ssf")
        try:
            span = protocol.parse_ssf(packet)
        except protocol.SSFDecodeError:
            logger.debug("could not parse SSF packet (%d bytes)", len(packet))
            self.count_ssf(1, 1)
            return
        self.ingest_span(span)
        self.count_ssf(1, 0)

    def handle_ssf_batch(self, packets) -> None:
        """A batch of unframed SSF datagrams, as handle_ssf_buffer over
        their concatenation."""
        n = len(packets)
        if not n:
            return
        lens = np.fromiter((len(p) for p in packets), np.int64, n)
        offs = np.zeros(n, np.int64)
        if n > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        self.handle_ssf_buffer(b"".join(packets), offs, lens)

    def handle_ssf_buffer(self, buf: bytes, offs, lens) -> None:
        """A batch of unframed SSF datagrams as one buffer with
        per-datagram (offset, length), the shape the native reader
        produces. With the native ingester the spans decode and their
        metrics extract in C++, and only when span sinks exist does each
        decoded span go on the channel, in wire form (RawSpan), for the
        span workers to decode; with the numpy decoder each datagram
        takes handle_ssf_packet. The packets are counted after their
        spans are on the channel."""
        ing = self._ingester
        if not isinstance(ing, BatchIngester):
            # handle_ssf_packet stamps each datagram's arrival
            for off, ln in zip(offs, lens):
                self.handle_ssf_packet(buf[int(off):int(off) + int(ln)])
            return
        self.latency.note_arrival("ssf", len(offs))
        decoded = ing.ingest_ssf_buffer(buf, offs, lens)
        idxs = np.flatnonzero(decoded)
        # batch admission decides the span hand-off only (the metrics
        # were extracted above), and only where span sinks take them
        if (self._span_sink_workers and len(idxs)
                and self.overload.admit_spans(len(idxs))):
            for i in idxs:
                start = int(offs[i])
                self.ingest_span(RawSpan(buf[start:start + int(lens[i])]),
                                 preadmitted=True)
        self.count_ssf(len(offs), len(offs) - len(idxs))

    def handle_ssf_span(self, span) -> None:
        """One decoded span from a framed stream or gRPC `SendSpan`: on
        the channel, then counted."""
        self.ingest_span(span)
        self.count_ssf(1, 0)

    def ingest_span(self, span, preadmitted: bool = False) -> None:
        """Put a span on the channel for the span workers; a full channel
        drops it and counts it instead of blocking ingest (with its
        metrics, when they were not extracted yet, as in the JAX
        package). Spans are the first rung of the shed ladder: any
        degraded state, or an empty span bucket, sheds them here, unless
        a batch admission upstream already passed them (`preadmitted`)."""
        if not preadmitted and not self.overload.admit_span():
            return
        with self._span_cv:
            try:
                self.span_chan.put_nowait(span)
            except queue.Full:
                with self._stats_lock:
                    self.stats["spans_dropped"] += 1
                return
            self._spans_in += 1

    def _span_worker_loop(self) -> None:
        """Fan spans out to the span sinks (reference worker.go:587-662)
        in batches of up to 256: a span still in wire form (its metrics
        extracted natively) is decoded; any other has its metrics
        extracted here; then each sink's isolation buffer takes the
        batch. A failure is counted as a dispatch error, which flush()
        re-raises. Beats the supervisor at least every 0.5 s. Exits on
        its None sentinel."""
        beat = self.overload.supervisor.beat
        name = threading.current_thread().name
        while True:
            beat(name)
            try:
                first = self.span_chan.get(timeout=0.5)
            except queue.Empty:
                continue
            if first is None:
                return
            t0 = time.perf_counter()
            batch = [first]
            done = False
            while len(batch) < 256:
                try:
                    nxt = self.span_chan.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:  # one sentinel each: siblings get theirs
                    done = True
                    break
                batch.append(nxt)
            try:
                out = []
                for span in batch:
                    if isinstance(span, RawSpan):
                        out.append(protocol.parse_ssf(span.data))
                    else:
                        self.metric_extraction.ingest(span)
                        out.append(span)
                for worker in self._span_sink_workers:
                    worker.submit_many(out)
            except Exception as e:
                logger.exception("span batch failed")
                self.note_dispatch_error(e)
            with self._span_cv:
                self._spans_out += len(batch)
                self.span_worker_seconds += time.perf_counter() - t0
                self._span_cv.notify_all()
            if done:
                return

    def _span_progress(self) -> None:
        with self._span_cv:
            self._span_cv.notify_all()

    def _spans_settled(self) -> bool:
        if self._spans_in != self._spans_out:
            return False
        for worker in self._span_sink_workers:
            with worker._lock:
                if worker.completed != worker.accepted:
                    return False
        return True

    def drain_spans(self, timeout: float = 30.0) -> None:
        """Wait until every span put on the channel so far has been
        extracted and taken by every span sink's buffer, and every chunk
        those buffers accepted has been ingested by its sink (spans a
        full buffer dropped are counted, not waited for). Counts, not a
        quiet period: it returns as soon as the counts meet, and raises
        TimeoutError with them after `timeout` seconds."""
        with self._span_cv:
            if not self._span_cv.wait_for(self._spans_settled, timeout):
                raise TimeoutError(
                    f"span plane not drained after {timeout} s: "
                    f"{self._spans_in} spans in, {self._spans_out} out; "
                    + ", ".join(f"{w.sink.name()} {w.completed}/"
                                f"{w.accepted}"
                                for w in self._span_sink_workers))

    def stats_snapshot(self) -> Dict[str, int]:
        """Line counters, SSF packet counters, spans dropped at the
        channel and per span sink, the extraction's totals, dispatch
        errors, the llhist family's sample and
        clamp totals, samples of unknown wire type, the pumps' reader
        stalls and lines lost at shutdown, the table lifecycle's counts,
        the pull sources' scrapes and failed scrapes, the forward tier's
        counts: metrics forwarded and failed sends (a local server),
        metrics imported and failed merges (a global one), and the sink
        plane's (see _sink_plane_stats)."""
        with self._stats_lock:
            out = dict(self.stats)
        out.update(self._sink_plane_stats())
        llhists = self.store.llhists
        out["llhist_samples"] = llhists.samples_total
        out["llhist_clamped"] = llhists.clamped_total
        out["unknown_rejected"] = self.store.unknown_rejected
        pumps = [lst.pump for lst in self._listeners if lst.pump is not None]
        for worker in self._span_sink_workers:
            out[f"span_sink_dropped#sink:{worker.sink.name()}"] = \
                worker.dropped
            out[f"span_sink_ingested#sink:{worker.sink.name()}"] = \
                worker.ingested
        ext = self.metric_extraction
        out["spans_extracted"] = ext.spans_processed
        out["span_metrics_generated"] = ext.metrics_generated
        out["stalls"] = sum(p.stalls() for p in pumps)
        # the table lifecycle: keys refused by the row cap, rows
        # tombstoned and recycled, the intern table's entries
        tables = [t for _f, t in self.store.tables()]
        out["keys_dropped"] = sum(t.keys_dropped for t in tables)
        out["rows_tombstoned"] = sum(t.tombstoned_total for t in tables)
        out["rows_recycled"] = sum(t.recycled_total for t in tables)
        out["intern_table_size"] = self._ingester.size()
        # pull sources: scrapes run and failed (OpenMetrics)
        out["source_scrapes"] = sum(getattr(src, "scrapes", 0)
                                    for src in self.sources)
        out["source_scrape_failures"] = sum(
            getattr(src, "scrape_failures", 0) for src in self.sources)
        out["lost_lines"] = sum(p.lost_lines() for p in pumps)
        out["readout_failed"] = self.readout_failed_total
        fc, imp = self.forward_client, self.import_server
        out["forwarded_total"] = fc.stats["forwarded_total"] if fc else 0
        out["forward_errors"] = fc.errors if fc else 0
        out["imported_total"] = imp.imported_total if imp else 0
        out["import_errors"] = imp.errors if imp else 0
        if fc is not None:
            co, spool = fc.carryover, fc.spool
            out.update(
                forward_retries=fc.stats["retries_total"],
                forward_breaker_refused=fc.stats["breaker_refused_total"],
                carryover_depth=co.depth,
                carryover_pending=co.pending_metrics,
                carryover_merged=co.merged_total,
                carryover_shed=co.shed_total,
                carryover_spilled=co.spilled_total,
                spool_depth=spool.depth if spool is not None else 0,
                wal_appended=fc.wal_appended_metrics,
                wal_acked=fc.wal_acked_metrics)
        if self.backfill is not None:
            out["backfill_open_intervals"] = self.backfill.open_intervals
            out["backfill_merged"] = self.backfill.merged_total
        return out

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        cfg = self.config
        for sink in self.metric_sinks:
            sink.start(self)
        self._start_span_plane()
        if self.chaos is not None:
            # the plan backs the object-less seams too (util/http.py)
            chaos_mod.install(self.chaos)
            self.telemetry.registry.add_collector(self.chaos.telemetry_rows)
            self.telemetry.record_event(
                "chaos_enabled", error_rate=self.chaos.error_rate,
                delay_rate=self.chaos.delay_rate,
                seams=sorted(self.chaos.seams))
        if cfg.forward_address:
            self.forward_client = fc = self._build_forward_client()
            self.telemetry.registry.add_collector(fc.telemetry_rows)
            # inventory stocks of the forward identity: metrics held in
            # the carryover, in flight inside a send, on disk in the
            # spool (segments replayed from a dead process are opening
            # stock) and set aside in its quarantine
            self.ledger.stock("forward_carryover",
                              lambda: fc.carryover.pending_metrics)
            self.ledger.stock("forward_inflight",
                              lambda: fc.inflight_metrics)
            # the forward plane's bounded hand-offs in the observatory:
            # the carryover (depth in intervals) and the spool
            self.latency.register_queue(
                "forward_carryover", lambda: fc.carryover.depth,
                cfg.carryover_max_intervals)
            if fc.spool is not None:
                spool = fc.spool
                self.ledger.stock("forward_spool",
                                  lambda: spool.pending_metrics)
                self.ledger.stock("spool_quarantine",
                                  lambda: spool.quarantined_metrics)
                self.latency.register_queue(
                    "forward_spool", lambda: spool.depth,
                    cfg.carryover_spool_max_segments)
        if cfg.grpc_address:
            self.import_server = imp = ImportServer(
                self, cfg.grpc_address,
                ignored_tags=[TagMatcher(kind="prefix", value=t)
                              for t in cfg.tags_exclude],
                tls=GrpcTLS(certificate=cfg.grpc_tls_certificate,
                            key=cfg.grpc_tls_key.reveal(),
                            authority=cfg.grpc_tls_authority_certificate)
                or None)
            self.import_server.start()
            self.telemetry.registry.add_collector(imp.telemetry_rows)
            self.ledger.probe("import.deduped",
                              lambda: imp.duplicates_dropped_total,
                              key="forward")
        for source in self.sources:
            thread = threading.Thread(target=source.start, args=(self,),
                                      name=f"source-{source.name()}",
                                      daemon=True)
            thread.start()
            self._source_threads.append(thread)
        for address in cfg.statsd_listen_addresses:
            self._listeners.append(start_statsd(
                address, self, cfg.num_readers,
                cfg.read_buffer_size_bytes))
        for address in cfg.ssf_listen_addresses:
            self._ssf_listeners.append(start_ssf(
                address, self, cfg.read_buffer_size_bytes))
        for address in cfg.grpc_listen_addresses:
            ingest = GrpcIngestServer(self, address)
            ingest.start()
            self.grpc_ingest_servers.append(ingest)
        if cfg.http_address:
            self.http_api = HTTPApi(cfg, server=self,
                                    address=cfg.http_address,
                                    http_quit=cfg.http_quit,
                                    on_quit=self.shutdown)
            self.http_api.start()
        if cfg.enable_profiling:
            # the continuous all-threads sampler (reference
            # server.go:1382-1390), read at /debug/profile/cpu
            from veneur_tpu_torch.core.profiling import StackSampler
            self.profiler = StackSampler()
            self.profiler.start()
        if cfg.profile_server_port:
            from veneur_tpu_torch.core.profiling import start_profile_server
            self.profile_server = start_profile_server(
                cfg.profile_server_port, self.device)
        if cfg.block_profile_rate or cfg.mutex_profile_fraction:
            logger.warning(
                "block_profile_rate/mutex_profile_fraction are Go-runtime "
                "knobs with no Python analog; accepted for config compat "
                "only — use /debug/pprof and enable_profiling instead")
        if self.diagnostics is not None:
            self.diagnostics.start()
        # replay the range segments an interrupted reshard cutover left,
        # before the flush loop starts, so the rows land in the first
        # interval and the ledger books them there
        try:
            self.reshard.recover()
        except Exception:
            logger.exception("reshard recovery failed; the segments stay "
                             "for the next start")
        if cfg.prewarm_ladder:
            # each family's next capacity rung launched ahead of need, at
            # startup and after every resize (core/flushexec.py)
            self.prewarmer = ShapeLadderPrewarmer(
                self.store, percentiles=self.percentiles,
                need_export=cfg.is_local and self.forward_client is not None,
                on_event=self.telemetry.record_event)
            self.telemetry.registry.add_collector(
                self.prewarmer.telemetry_rows)
            self.prewarmer.start()
            self.prewarmer.prewarm_initial()
        supervisor = self.overload.supervisor
        self._flush_thread = threading.Thread(
            target=self._flush_loop, name="flush-loop", daemon=True)
        # the flush loop beats once per interval, and a flush holds the
        # interpreter for seconds at full width: its deadline clears both
        supervisor.register("flush-loop", deadline=max(
            supervisor.deadline, 2.5 * self.interval, 60.0))
        self._flush_thread.start()
        if cfg.alerts.enabled:
            # one tick's capture can wait behind a flush's readout
            supervisor.register("alert-loop", deadline=max(
                supervisor.deadline, 10 * self.alerts.interval_s, 60.0))
            self.alerts.start()
        self.overload.start()
        if cfg.flush_watchdog_missed_flushes > 0:
            self._watchdog_thread = threading.Thread(
                target=self._flush_watchdog, name="flush-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        # the graceful-restart handshake: a parent mid-SIGUSR2 waits for
        # the ready file, written only now, with every listener bound
        restart.mark_ready()
        startup = {"pid": os.getpid(),
                   "mode": "local" if cfg.is_local else "global"}
        if self.store.shard_plane is not None:
            # the shard topology in the flight recorder: how many shards,
            # on which device, under which routing
            startup["mesh"] = self.store.shard_plane.describe()
        self.telemetry.record_event("startup", **startup)

    def _start_span_plane(self) -> None:
        """Start the span sinks, one isolation buffer and thread each, and
        the span workers."""
        self.metric_extraction.start(self)
        for sink in self.span_sinks:
            sink.start(self)
            worker = _SpanSinkWorker(sink,
                                     self.config.span_sink_queue_capacity,
                                     self._span_progress,
                                     observatory=self.latency)
            worker.start()
            self._span_sink_workers.append(worker)
        for i in range(max(1, self.config.num_span_workers)):
            thread = threading.Thread(target=self._span_worker_loop,
                                      name=f"span-worker-{i}", daemon=True)
            self.overload.supervisor.register(thread.name)
            thread.start()
            self._span_workers.append(thread)

    def _stop_span_plane(self) -> None:
        """Let the span workers drain the channel (their sentinels queue
        behind every span), then the sink buffers."""
        for _ in self._span_workers:
            self.span_chan.put(None)
        for thread in self._span_workers:
            thread.join(timeout=30.0)
        for worker in self._span_sink_workers:
            worker.stop()

    def _build_forward_client(self) -> ForwardClient:
        """The forward client with its retry policy, breaker, carryover,
        and (with `carryover_spool_dir`) the durable spool, whose
        constructor re-scans segments a previous process left behind."""
        cfg = self.config
        ledger = self.ledger if self.ledger.enabled else None
        spool = None
        if cfg.carryover_spool_dir:
            spool = CarryoverSpool(
                cfg.carryover_spool_dir,
                max_bytes=cfg.carryover_spool_max_bytes,
                max_segments=cfg.carryover_spool_max_segments,
                quarantine_max_bytes=cfg.carryover_spool_quarantine_max_bytes,
                quarantine_max_segments=(
                    cfg.carryover_spool_quarantine_max_segments),
                dwell_hist=self.latency.queue_hist("forward_spool"),
                ledger=ledger)
        replay_limiter = None
        if cfg.forward_wal and cfg.wal_replay_rate_limit > 0:
            replay_limiter = TokenBucket(
                cfg.wal_replay_rate_limit,
                cfg.wal_replay_rate_limit * cfg.wal_replay_burst)
        return ForwardClient(
            cfg.forward_address, deadline=self.interval,
            tls=GrpcTLS(certificate=cfg.forward_tls_certificate,
                        key=cfg.forward_tls_key.reveal(),
                        authority=cfg.forward_tls_authority_certificate)
            or None,
            chaos=self.chaos, ledger=ledger,
            retry=RetryPolicy(max_attempts=cfg.forward_retry_max_attempts,
                              base_delay=cfg.forward_retry_base,
                              max_delay=cfg.forward_retry_max),
            breaker=CircuitBreaker(
                failure_threshold=cfg.circuit_breaker_failure_threshold,
                recovery_time=cfg.circuit_breaker_recovery,
                name="forward", on_transition=self._breaker_transition),
            carryover=Carryover(cfg.carryover_max_intervals, ledger=ledger),
            spool=spool, wal=cfg.forward_wal,
            replay_limiter=replay_limiter,
            replay_stale_after=cfg.wal_stale_after_intervals * self.interval,
            trace_plane=self.trace_plane,
            shards=(self.store.shard_plane.n
                    if self.store.shard_plane is not None else 0))

    @property
    def listen_addresses(self) -> List[tuple]:
        """The statsd listeners' bound addresses, in config order."""
        return [listener.address for listener in self._listeners]

    @property
    def ssf_addresses(self) -> List:
        """The SSF listeners' bound addresses, in config order."""
        return [listener.address for listener in self._ssf_listeners]

    def local_addr(self, scheme: str = "udp"):
        """The bound address of the first listener of `scheme` ("udp",
        "tcp", "unixgram", "ssf-udp", "ssf-tcp", "ssf-unix"), or None."""
        for listener in self._listeners + self._ssf_listeners:
            if listener.scheme == scheme:
                return listener.address
        return None

    def _tick_delay(self) -> float:
        """Clock-aligned tick (reference server.go:1458
        CalculateTickDelay)."""
        return self.interval - (time.time() % self.interval)

    def _flush_loop(self) -> None:
        beat = self.overload.supervisor.beat
        while not self._shutdown.wait(
                self._tick_delay() if self.config.synchronize_with_interval
                else self.interval):
            beat("flush-loop")
            try:
                self.flush()
            except Exception:
                logger.exception("flush failed")
            # a slow flush that ends clears its staleness at once
            beat("flush-loop")

    def _flush_watchdog(self) -> None:
        """Die loudly if flushes stall (reference server.go:877-919)."""
        allowed = self.config.flush_watchdog_missed_flushes * self.interval
        while not self._shutdown.wait(self.interval):
            since = time.time() - self.last_flush_unix
            self.telemetry.record_event(
                "watchdog_tick", since_last_flush_s=round(since, 3),
                allowed_s=allowed)
            if since > allowed:
                logger.critical(
                    "flush watchdog: no flush for %ds; aborting", allowed)
                self.telemetry.record_event(
                    "watchdog_abort", since_last_flush_s=round(since, 3))
                faulthandler.dump_traceback(all_threads=True)
                os._exit(2)

    # a readout still running at this many consecutive joins is dropped
    READOUT_MISS_LIMIT = 3

    def flush(self) -> None:
        """One flush pass (reference flusher.go:26-122), in three stages
        (the JAX server's): swap every table out at one interval boundary,
        read the swapped generation out on the device (the readout: its
        kernels, the device sync, the host copies and the assembly, plus
        the backfill plane's closed intervals and the forward's wire
        encoding), and deliver: start every sink's flush thread and, on a
        local server, the forward thread, then wait for all of them,
        outside the flush lock, up to one interval from the flush's
        start. Raises afterwards if an ingest chunk failed to apply or a
        forward thread raised.

        With `flush_async` the readout runs on the readout executor
        (core/flushexec.py) instead of inline: each tick swaps its
        interval out and submits it, joins the intervals still in flight
        (oldest first, each for at most min(5, max(1, interval/4)) s;
        one not done is carried to the next tick, and dropped after
        READOUT_MISS_LIMIT ticks, as is one whose readout raised, both
        counted in `flush.readout_failed_total`), and delivers them. So
        interval N is delivered at tick N+1, and the device work leaves
        the flush loop's critical path.

        The flush is a span, `flush`, whose children are one
        `flush.family` per family readout and one `flush.sink` per sink
        thread (the forward's included, whose thread carries it as the
        ambient span, so the send carries its lineage); a delivered
        interval's children parent under the span of the tick that
        swapped it. On a local the span roots the interval's trace, on a
        global it parents under the import that a local's trace reached.
        They go into this server's span pipeline, and into its trace
        store when the interval is sampled. The trace plane rolls to the
        next interval's id last, watching the cardinality observatory's
        top names. While the span recorder (core/profiling.py) is armed,
        the phases' readings in `last_flush_timings` are also spans:
        core/flusher.py's, and `flush.sinks` from the sinks' dispatch to
        their join."""
        self._flush()

    def _flush(self, deliver_only: bool = False) -> None:
        """flush(); `deliver_only` (the shutdown drain without
        `flush_on_shutdown`) swaps nothing: it joins and delivers the
        intervals already in flight, so a swapped interval still reaches
        the WAL, the forward and the sinks."""
        t0 = time.perf_counter()
        timings: Dict[str, Any] = {}
        with self._flush_lock:
            fc = self.forward_client
            interval_start = self._interval_start_unix
            self.last_flush_unix = self._interval_start_unix = time.time()
            self.flush_count += 1
            flush_span, traced = self._open_flush_span()
            if self.config.count_unique_timeseries:
                # the series touched this interval, exact (reference
                # flusher.go:43)
                self.statsd.count(
                    "flush.unique_timeseries_total",
                    self.store.unique_timeseries(),
                    tags=[f"global_veneur:"
                          f"{str(not self.config.is_local).lower()}"])
            # the sample-age watermarks roll at the swap's boundary
            watermarks = self.latency.take_watermarks()
            drain = deliver_only or self._shutdown.is_set()
            async_on = bool(self.config.flush_async) and not drain
            record = None
            if not deliver_only:
                t_lock = time.perf_counter()
                with self._readout_lock:
                    timings["readout_lock_wait_s"] = \
                        time.perf_counter() - t_lock
                    swap = swap_columnstore(
                        self.store, self.config.is_local, self.percentiles,
                        collect_forward=fc is not None, timings=timings)
                record = {"swap": swap, "flush": self.flush_count,
                          "interval_start": interval_start,
                          "watermarks": watermarks, "span": flush_span,
                          "traced": traced}
            delivered = self._join_readouts(
                drain, timings,
                book=bool(self.config.flush_async) or deliver_only)
            inline_device_s = 0.0
            if async_on:
                record["pending"] = self._readout_executor().submit(
                    lambda rec=record: self._run_readout(rec))
                self._inflight_flushes.append(record)
            elif record is not None:
                self._run_readout(record)
                r_timings = record["result"][2]
                inline_device_s = sum(
                    r_timings.get(k, 0.0)
                    for k in ("dispatch_s", "device_sync_s", "assembly_s"))
                delivered.append(record)
            self._inflight_rows = sum(r["swap"]["rows"]
                                      for r in self._inflight_flushes)
            with self._events_lock:
                events, self._events = self._events, []
            t_sinks = time.perf_counter()
            metrics = 0
            dispatched: List[tuple] = []
            forwards: List[tuple] = []
            # a tick that delivers nothing (the first async tick, or a
            # readout carried or dropped) still delivers its events and
            # the sinks' spill on time
            for i, rec in enumerate(delivered or [None]):
                if i:
                    # a drain delivering two intervals: one thread per
                    # sink and one forward, so the second round waits for
                    # the first's, under one shared grace
                    self._join_round(dispatched, forwards,
                                     time.perf_counter()
                                     + self._delivery_grace())
                n, round_dispatched, forward = self._deliver_round(
                    rec, events if i == 0 else [], timings, i == 0,
                    flush_span, traced)
                metrics += n
                dispatched.extend(round_dispatched)
                if forward is not None:
                    forwards.append(forward)
            dispatched.extend(self._dispatch_span_sinks(timings, flush_span,
                                                        traced))
        # bounded wait outside the flush lock: a hung sink or send holds
        # up neither the next flush nor shutdown past the interval; the
        # stragglers run on and are skipped next interval
        deadline = t0 + self.interval
        for _key, thread, _record in dispatched:
            thread.join(max(0.0, deadline - time.perf_counter()))
        t_joined = time.perf_counter()
        timings["sinks_s"] = t_joined - t_sinks
        if profiling.armed:
            profiling.record("flush.sinks", t_sinks, t_joined)
        stuck = self._sweep_timed_out(dispatched)
        for thread, record in forwards:
            thread.join(max(0.0, deadline - time.perf_counter()))
            if thread.is_alive():
                stuck += 1
                self._count("flush.timeout_total", "forward")
                self.telemetry.record_event("sink_timeout", sink="forward",
                                            flush=self.flush_count)
                logger.error("forward still running %.1f s into the "
                             "flush", time.perf_counter() - t0)
            else:
                for key, value in record.items():
                    timings[key] = timings.get(key, 0.0) + value
        if stuck:
            self.statsd.count("flush.timeout_total", stuck)
        imp = self.import_server
        if imp is not None:
            imp.rpc_stats.emit(self.statsd, prefix="import.rpc")
        # the sink joins are the ack point of the delivered intervals
        self._after_delivery(delivered, time.time())
        flush_span.finish()
        timings["total_s"] = time.perf_counter() - t0
        self.last_flush_timings = timings
        self._record_flush(
            timings, metrics,
            trace_id_hex(flush_span.trace_id) if traced else "",
            async_on=async_on, inline_device_s=inline_device_s,
            delivered=delivered[0] if delivered else None)
        self._reclaim_idle_rows()
        try:
            # the flow ledger's interval close: fold the probe deltas,
            # read the stocks, check every identity (strict: raise on
            # imbalance); it stamps this interval's trace id
            self.ledger.close_interval()
        finally:
            # the next interval's trace id, a fresh exemplar budget, and
            # the heavy-hitter names the exemplar capture watches
            self.trace_plane.roll(
                [r["name"] for r in self.cardinality.top(16)])
        self._raise_dispatch_error()
        self._raise_forward_error()

    def _join_readouts(self, drain: bool, timings: Dict[str, Any],
                       book: bool) -> List[dict]:
        """Join the in-flight readouts, oldest first; returns those to
        deliver. A head not done within the join timeout is carried to
        the next tick (at most READOUT_MISS_LIMIT ticks); one that raised,
        or stays wedged, or is not done at a drain's longer timeout is
        dropped and counted. Books `join_s` when `book`."""
        t_join = time.perf_counter()
        inflight = self._inflight_flushes
        delivered: List[dict] = []
        timeout = (max(self.interval, 60.0) if drain
                   else min(5.0, max(1.0, self.interval / 4)))
        while inflight:
            head = inflight[0]
            head["async"] = True
            try:
                head["pending"].result(timeout=timeout)
            except JoinTimeout:
                if not drain:
                    head["join_misses"] = head.get("join_misses", 0) + 1
                    if head["join_misses"] < self.READOUT_MISS_LIMIT:
                        break  # carried to the next tick
                logger.error("flush readout for interval %s wedged; "
                             "dropping it", head["flush"])
                self._readout_failed()
                inflight.pop(0)
                continue
            except Exception:
                logger.exception("flush readout for interval %s failed; "
                                 "the interval is lost", head["flush"])
                self._readout_failed()
                inflight.pop(0)
                continue
            inflight.pop(0)
            delivered.append(head)
        if book:
            timings["join_s"] = time.perf_counter() - t_join
        return delivered

    def _readout_failed(self) -> None:
        with self._stats_lock:
            self.readout_failed_total += 1
        self.statsd.count("flush.readout_failed_total", 1)

    def _run_readout(self, record: dict) -> tuple:
        """The readout of one swapped interval (inline, or on the readout
        executor under `flush_async`): the device readout under
        `_readout_lock` (its launches and sync order against a query's,
        core/flusher.py), the assembly, the backfill plane's closed
        intervals (their series carry their original timestamps), and
        the forward's wire encoding unless a pending carryover will merge
        into the snapshot. Sets and returns record["result"]: (batch,
        fwd, readout timings)."""
        record["readout_start_unix"] = time.time()
        r_timings: Dict[str, Any] = {}
        fc = self.forward_client
        batch, fwd = readout_columnstore(
            self.store, record["swap"], self.config.is_local,
            self.aggregates, collect_forward=fc is not None,
            timings=r_timings, device_lock=self._readout_lock)
        if self.backfill is not None:
            t_bf = time.perf_counter()
            backfilled = self.backfill.drain()
            batch.extras.extend(backfilled)
            r_timings["backfill_drain_s"] = time.perf_counter() - t_bf
            if backfilled:
                self.statsd.count("flush.backfilled_series_total",
                                  len(backfilled))
        # a pending carryover merges into fwd on the forward thread and
        # invalidates frames encoded here
        if fc is not None and len(fwd) and not fc.carryover.pending_metrics:
            t_enc = time.perf_counter()
            fwd.wire = forwardable_to_wire(fwd)
            r_timings["forward_encode_s"] = time.perf_counter() - t_enc
        record["result"] = (batch, fwd, r_timings)
        return record["result"]

    def _readout_executor(self) -> FlushReadoutExecutor:
        """Get-or-create the readout executor, supervised like the flush
        loop: a wedged readout trips the same stall ladder."""
        if self._flush_executor is None:
            supervisor = self.overload.supervisor
            supervisor.register("flush-readout", deadline=max(
                supervisor.deadline, 2.5 * self.interval, 60.0))
            self._flush_executor = FlushReadoutExecutor(
                beat=supervisor.beat)
        return self._flush_executor

    def _deliver_round(self, rec: Optional[dict], events: List,
                       timings: Dict[str, Any], primary: bool, flush_span,
                       traced: bool) -> tuple:
        """Hand one read-out interval to the forward and the metric sinks
        (caller holds _flush_lock); None delivers only `events` and the
        sinks' spill. Only the primary round's readout timings land in
        this tick's. Returns (metrics delivered, the sinks dispatched,
        the forward dispatched or None)."""
        if rec is None:
            empty = FlushBatch(int(self.last_flush_unix), [], [])
            return 0, self._dispatch_sinks(empty, events, timings,
                                           flush_span, traced), None
        batch, fwd, r_timings = rec["result"]
        if primary:
            for key, value in r_timings.items():
                if key == "readout_lock_wait_s":
                    timings[key] = timings.get(key, 0.0) + value
                else:
                    timings[key] = value
        # informational stages: what the interval's snapshot produced
        self.ledger.note("flush.emitted", len(batch))
        self.ledger.note("flush.forward_rows", len(fwd))
        forward = None
        fc = self.forward_client
        if fc is not None:
            forward = self._dispatch_forward(
                fc, fwd, rec["interval_start"], rec["span"], rec["traced"])
        dispatched = self._dispatch_sinks(batch, events, timings,
                                          rec["span"], rec["traced"])
        return len(batch), dispatched, forward

    def _delivery_grace(self) -> float:
        """Seconds a delivery that must not be skipped may take: a
        drain's earlier round, and the sinks' running and last
        deliveries at shutdown."""
        return max(self.interval, 30.0)

    def _join_sink_threads(self, deadline: float) -> None:
        """Wait, until `deadline`, for every sink's running flush
        thread."""
        for thread in list(self._sink_flush_threads.values()):
            thread.join(max(0.0, deadline - time.perf_counter()))

    def _join_round(self, dispatched: List[tuple], forwards: List[tuple],
                    deadline: float) -> None:
        """Wait, until `deadline`, for the sink and forward threads a
        drain's earlier round started."""
        threads = [t for _k, t, _r in dispatched] + [t for t, _r in forwards]
        for thread in threads:
            thread.join(max(0.0, deadline - time.perf_counter()))

    def _after_delivery(self, delivered: List[dict], ack_unix: float) -> None:
        """Each delivered interval's sample ages, observed at the sinks'
        ack (with its worst case as the `pipeline.sample_age` exemplar
        of a traced interval), and its `flush.family` spans under the
        span of the tick that swapped it, marked as the async lane when
        its readout ran on the executor."""
        for rec in delivered:
            marks = rec["watermarks"]
            self.latency.observe_sample_age(marks, ack_unix)
            if rec["traced"] and marks:
                oldest = min(mark[0] for mark in marks.values())
                self.trace_plane.exemplars.capture(
                    "pipeline.sample_age", max(0.0, ack_unix - oldest),
                    rec["span"].trace_id, ts=ack_unix)
            families = rec["result"][2].get("families", {})
            if rec.get("async"):
                for frec in families.values():
                    frec["lane"] = "async"
            self._record_family_spans(rec["span"], families)

    def _reclaim_idle_rows(self) -> None:
        """Idle-row reclamation and the intern self-metrics, once per
        flush (after the flush's assembly read its snapshot's meta): each
        family tombstones its idle rows, then one combined sweep erases
        their intern mappings, so the pump readers wait on the intern
        lock once per flush; the rows are recycled one flush later
        (ColumnStore tables' reclaim_idle). Under `flush_async` it runs
        at the end of every tick, as in the JAX server, after the join
        that delivered the previous interval; while an older readout is
        still carried in flight it waits, since a row that interval
        touched could otherwise be recycled before its assembly read the
        row's cached names. Then the cardinality accountant rolls its
        interval (the mint budgets reset)."""
        idle = self.config.tpu.idle_key_intervals
        tables = self.store.tables()
        if idle > 0 and len(self._inflight_flushes) <= 1:
            pairs = []
            for family, table in tables:
                evicted = table.reclaim_idle(idle)
                fam = _NATIVE_FAMILY.get(family)
                if evicted and fam is not None:
                    pairs.extend((fam, row) for row in evicted)
            if pairs:
                self._ingester.unregister_rows_multi(pairs)
        self.statsd.gauge("intern.rows_total",
                          sum(len(t.rows) for _f, t in tables))
        self.statsd.gauge("intern.native_table_size", self._ingester.size())
        dropped = sum(t.keys_dropped for _f, t in tables)
        if dropped > self._keys_dropped_reported:
            self.statsd.count("intern.keys_dropped_total",
                              dropped - self._keys_dropped_reported)
            self._keys_dropped_reported = dropped
        # after the reclaim, so its live-row decrements land in the
        # interval they happened in
        self.cardinality.roll_interval()

    def _open_flush_span(self):
        """The interval's `flush` span and whether its trace is sampled
        (the plane's active trace then): on a local, the plane's
        pre-minted interval trace id, which this interval's exemplars
        carry; on a global that adopted a local's trace since its last
        flush, a child of that import's span."""
        plane = self.trace_plane
        adopted, self._adopted_trace = self._adopted_trace, None
        tags = {"mode": "local" if self.config.is_local else "global",
                "interval": str(self.flush_count)}
        if adopted and not self.config.is_local:
            span = trace_mod.Span(
                self.trace_client, "flush", "veneur-tpu",
                trace_id=adopted[0], parent_id=adopted[1], tags=tags)
        else:
            span = trace_mod.Span(
                self.trace_client, "flush", "veneur-tpu",
                trace_id=plane.interval_trace_id, tags=tags)
        traced = plane.is_sampled(span.trace_id)
        plane.set_active(span.trace_id if traced else 0)
        return span, traced

    @staticmethod
    def _record_family_spans(flush_span, families: Dict[str, dict]) -> None:
        """One `flush.family` child per family readout, its start and end
        rebuilt from the readout's measured segments, tagged with the
        JAX server's keys: family, dispatch_s, transfer_s and per device
        sync_s.<device> (the port's one device sync, which the device
        families share). The port recompiles nothing, so no retrace
        tags."""
        for family, rec in families.items():
            base = rec["base_unix"]
            start_off = rec["dispatch_start_s"]
            end_off = start_off + rec["dispatch_s"]
            dev_start = rec.get("device_start_s")
            if dev_start is not None:
                end_off = dev_start + rec["transfer_s"] + sum(
                    d["sync_s"] for d in rec["devices"].values())
            tags = {"family": family,
                    "dispatch_s": f"{rec['dispatch_s']:.6f}",
                    "transfer_s": f"{rec['transfer_s']:.6f}"}
            for dev, seg in rec["devices"].items():
                tags[f"sync_s.{dev}"] = f"{seg['sync_s']:.6f}"
            child = flush_span.child("flush.family", tags=tags)
            child.proto.start_timestamp = int((base + start_off) * 1e9)
            child.finish(end_time=base + end_off)

    def _record_flush(self, timings: Dict[str, Any], metrics: int,
                      trace_hex: str = "", async_on: bool = False,
                      inline_device_s: float = 0.0,
                      delivered: Optional[dict] = None) -> None:
        """The flush's self-metrics (the JAX flush's names), its round in
        the flight recorder and its event. The critical path is the wall
        time less the device readout that ran inline this tick (dispatch,
        sync, assembly; none under `flush_async`), as the JAX package
        computes it. The round carries the family segments of the first
        interval it delivered (the waterfall's tree) and, when that
        interval's readout ran on the executor, its flush number; an
        async tick is marked."""
        duration = timings["total_s"]
        phases = {k: v for k, v in timings.items()
                  if isinstance(v, (int, float))}
        phases["critical_path_s"] = max(0.0, duration - inline_device_s)
        self.statsd.timing("flush.critical_path_s", phases["critical_path_s"])
        self.statsd.gauge("flush.total_duration_ns", int(duration * 1e9))
        self.statsd.timing("flush.total_duration", duration)
        for phase, secs in phases.items():
            self.statsd.timing("flush.phase_duration", secs,
                               tags=[f"phase:{phase}"])
        self.statsd.count("flush.metrics_total", metrics)
        # sink records stay shared: a straggler's late status lands
        sinks = {f"metric:{key[len('sink:'):]}": rec
                 for key, rec in timings.items() if key.startswith("sink:")}
        sinks.update({f"span:{key[len('span_sink:'):]}": rec
                      for key, rec in timings.items()
                      if key.startswith("span_sink:")})
        round_info = {
            "flush": self.flush_count, "start_unix": self.last_flush_unix,
            "mode": "local" if self.config.is_local else "global",
            "sinks": sinks, "duration_s": round(duration, 6),
            "metrics_flushed": metrics,
            "phases": {k: round(v, 6) for k, v in phases.items()}}
        if trace_hex:
            # /debug/flush points at the interval's /debug/traces entry
            round_info["trace_id"] = trace_hex
        if async_on:
            round_info["async"] = True
        if delivered is not None:
            if delivered.get("async"):
                round_info["delivered_flush"] = delivered["flush"]
            families = delivered["result"][2].get("families")
            if families:
                round_info["families"] = _round_family_tree(families)
        self.telemetry.flushes.record(round_info)
        self.telemetry.record_event(
            "flush", flush=self.flush_count,
            duration_s=round_info["duration_s"], metrics=metrics,
            phases=round_info["phases"],
            sinks={k: v.get("status", "running") for k, v in sinks.items()})
        # cumulative process counters emit as gauges (they never reset)
        with self._stats_lock:
            processed = self.stats["lines_received"]
            spans_dropped = self.stats["spans_dropped"]
        self.statsd.gauge("worker.metrics_processed_total", processed)
        for worker in self._span_sink_workers:
            spans_dropped += worker.dropped
            if worker.dropped or worker.ingested:
                tags = [f"sink:{worker.sink.name()}"]
                self.statsd.gauge("worker.ssf.sink.dropped_total",
                                  worker.dropped, tags=tags)
                self.statsd.gauge("worker.ssf.sink.ingested_total",
                                  worker.ingested, tags=tags)
        if spans_dropped:
            self.statsd.gauge("worker.ssf.spans_dropped_total", spans_dropped)

    # -- the sink plane --------------------------------------------------

    def _count(self, name: str, key: str, n: int = 1) -> None:
        """Count a sink-plane event for one sink: in stats_snapshot() and,
        except the timeouts (counted per flush by flush()), through the
        statsd client tagged with the sink, as the JAX package counts."""
        with self._sink_lock:
            per = self._sink_counts[name]
            per[key] = per.get(key, 0) + n
        if name != "flush.timeout_total":
            self.statsd.count(name, n, tags=[f"sink:{key}"])

    def _sink_breaker(self, key: str) -> CircuitBreaker:
        """Get-or-create the per-sink breaker (same knobs as forward)."""
        breaker = self._sink_breakers.get(key)
        if breaker is None:
            cfg = self.config
            breaker = self._sink_breakers[key] = CircuitBreaker(
                failure_threshold=cfg.circuit_breaker_failure_threshold,
                recovery_time=cfg.circuit_breaker_recovery, name=key,
                on_transition=self._breaker_transition)
        return breaker

    def _sink_plane_stats(self) -> Dict[str, int]:
        """The sink plane's counts under the JAX package's self-metric
        names (they also go out through the statsd client): each
        counter's total,
        and per sink `<name>#sink:metric:<sink>` — the skips, the
        intervals refused by an open breaker, the spilled metrics retried
        and shed, the threads still running at the flush deadline
        (`flush.timeout_total#sink:forward` counts the forward thread's)
        — and per sink the gauges `resilience.breaker_state
        #target:<key>` (0 closed, 1 open, 2 half-open),
        `flush.sink_pileup_depth` and `flush.spill_pending`."""
        out: Dict[str, int] = {}
        with self._sink_lock:
            for name, per in self._sink_counts.items():
                out[name] = sum(per.values())
                for key, n in per.items():
                    out[f"{name}#sink:{key}"] = n
            for key, spill in self._sink_spill.items():
                out[f"flush.spill_pending#sink:{key}"] = len(spill)
        for key, depth in list(self._sink_skip_depth.items()):
            out[f"flush.sink_pileup_depth#sink:{key}"] = depth
        for key, breaker in list(self._sink_breakers.items()):
            out[f"resilience.breaker_state#target:{key}"] = \
                breaker.state_code
        return out

    def _dispatch_sinks(self, batch: FlushBatch, events: List,
                        timings: Dict[str, Any], flush_span,
                        traced: bool) -> List[tuple]:
        """Start each metric sink's flush thread for one delivered
        interval (the caller holds _flush_lock); returns [(key, thread,
        record)]. A metric sink is dispatched only when there is
        something for it: metrics, events, or its spill."""
        if self._routing is not None and len(batch):
            # routing annotates each metric with its sinks, so it needs
            # objects; materialised once, shared by every sink thread
            for metric in batch.materialize():
                route = set()
                for rule in self._routing:
                    route.update(rule.route(metric.name, metric.tags))
                metric.sinks = route
        dispatched: List[tuple] = []
        for sink in self.metric_sinks:
            key = f"metric:{sink.name()}"
            record = timings[f"sink:{sink.name()}"] = _sink_record()
            with self._sink_lock:
                spilled = key in self._sink_spill
            if not (len(batch) or events or spilled):
                record["status"] = "idle"
                continue
            self._start_sink_thread(
                key, sink, record, dispatched,
                lambda k=key, s=sink: self._flush_sink_safe(k, s, batch,
                                                            events),
                flush_span, traced)
        return dispatched

    def _dispatch_span_sinks(self, timings: Dict[str, Any], flush_span,
                             traced: bool) -> List[tuple]:
        """Start each span sink's flush thread, once per tick, as in the
        JAX package (its buffer is its own)."""
        dispatched: List[tuple] = []
        for sink in self.span_sinks:
            key = f"span:{sink.name()}"
            record = timings[f"span_sink:{sink.name()}"] = _sink_record()
            self._start_sink_thread(
                key, sink, record, dispatched,
                lambda s=sink: self._flush_span_sink_safe(s),
                flush_span, traced)
        return dispatched

    def _start_sink_thread(self, key: str, sink, record: Dict[str, Any],
                           dispatched: List[tuple],
                           deliver: Callable[[], Optional[bool]],
                           flush_span, traced: bool) -> None:
        """Start one sink's flush thread, unless its previous flush still
        runs (skipped) or its breaker is open."""
        prev = self._sink_flush_threads.get(key)
        if prev is not None and prev.is_alive():
            # one flush thread per sink: a hung sink's interval is
            # skipped, and every skip is a failure its hung thread will
            # never report, so it feeds the breaker
            depth = self._sink_skip_depth.get(key, 0) + 1
            self._sink_skip_depth[key] = depth
            logger.warning("sink %s: previous flush still running; "
                           "skipping (pileup depth %d)", key, depth)
            self._count("flush.sink_skipped_total", key)
            record.update(status="skipped", pileup_depth=depth)
            self._sink_breaker(key).record_failure()
            self.telemetry.record_event(
                "sink_skipped", sink=key, flush=self.flush_count,
                pileup_depth=depth)
            return
        self._sink_skip_depth.pop(key, None)
        if not self._sink_breaker(key).allow():
            # open breaker: no thread; the interval is dropped (counted)
            # until the half-open probe closes it again
            self._count("flush.sink_breaker_open_total", key)
            record["status"] = "breaker_open"
            self.telemetry.record_event(
                "sink_breaker_open", sink=key, flush=self.flush_count)
            return
        thread = threading.Thread(
            target=self._timed_sink_flush,
            args=(key, sink, record, deliver, flush_span, traced),
            name=f"flush-{key}", daemon=True)
        self._sink_flush_threads[key] = thread
        thread.start()
        dispatched.append((key, thread, record))

    def _sweep_timed_out(self, dispatched: List[tuple]) -> int:
        """Mark every sink thread that has not finished by the deadline
        `timed_out`, count it and feed its breaker (the hang is a failure
        it will not report itself; when it later fails, that does not
        count again). Returns how many were still running."""
        stuck = []
        with self._sink_lock:
            for key, _thread, record in dispatched:
                if "status" in record:
                    continue
                record["status"] = "timed_out"
                stuck.append(key)
                per = self._sink_counts["flush.timeout_total"]
                per[key] = per.get(key, 0) + 1
                self._sink_breakers[key].record_failure()
        for key in stuck:
            self.telemetry.record_event("sink_timeout", sink=key,
                                        flush=self.flush_count)
        if stuck:
            logger.error("flush exceeded the %.1f s interval; %d sink(s) "
                         "still running", self.interval, len(stuck))
        return len(stuck)

    def _timed_sink_flush(self, key: str, sink, record: Dict[str, Any],
                          deliver: Callable[[], Optional[bool]],
                          flush_span, traced: bool) -> None:
        """Body of one sink flush thread: the delivery under its
        `flush.sink` span, its duration and egress report, and the
        breaker fed by what the delivery showed."""
        before = getattr(sink, "last_egress", None)
        start, cpu0 = time.perf_counter(), time.thread_time()
        with self._sink_span(flush_span, key, traced) as child:
            try:
                ok = deliver()
            except Exception:
                logger.exception("sink %s: flush thread failed", key)
                ok = False
            if ok is False:
                child.error()
        duration = time.perf_counter() - start
        cpu = time.thread_time() - cpu0
        egress = getattr(sink, "last_egress", None)
        with self._sink_lock:
            was_timed_out = record.get("status") == "timed_out"
            # None: nothing was delivered, so the breaker learns nothing
            # (a quiet interval must not reset a failure streak or close
            # a half-open breaker without a real probe)
            if ok:
                self._sink_breakers[key].record_success()
            elif ok is False and not was_timed_out:
                self._sink_breakers[key].record_failure()
            if was_timed_out:
                record["late"] = True
            record["status"] = "error" if ok is False else "ok"
            record["duration_s"] = duration
            record["cpu_s"] = cpu
            if egress is not None and egress is not before:
                (record["encode_s"], record["send_s"], record["encoder"],
                 record["gzip_s"]) = egress

    @contextlib.contextmanager
    def _sink_span(self, flush_span, key: str, traced: bool):
        """A sink thread's `flush.sink` child of the flush span, the
        thread's ambient span while the interval is traced (the forward
        client reads it for the x-veneur-trace sidecar)."""
        child = flush_span.child("flush.sink", tags={"sink": key})
        token = trace_ctx._current_span.set(child) if traced else None
        try:
            yield child
        finally:
            if token is not None:
                trace_ctx._current_span.reset(token)
            child.finish()

    def _flush_span_sink_safe(self, sink) -> bool:
        try:
            sink.flush()
            return True
        except Exception:
            logger.exception("span sink %s flush failed", sink.name())
            return False

    def _flush_sink_safe(self, key: str, sink, batch: FlushBatch,
                         events=()) -> Optional[bool]:
        """Deliver events and metrics to one sink. True/False for a
        delivery attempt, None when there was nothing to deliver. A
        batch that fails is kept for one retry, prepended to the next
        interval's; a retry that fails is shed."""
        ok = True
        if events:
            try:
                sink.flush_other_samples(events)
            except Exception:
                logger.exception("sink %s flush_other_samples failed",
                                 sink.name())
                ok = False
        with self._sink_lock:
            spill = self._sink_spill.pop(key, None)
        if spill:
            self._count("flush.spill_retry_total", key, len(spill))
        if not len(batch) and not spill:
            return ok if events else None
        name = sink.name()
        sc = self._sink_filters.get(name)
        current: Optional[List[InterMetric]] = None
        try:
            if self.chaos is not None:
                self.chaos.inject("sink_flush")
            if sc is None and self._routing is None and not spill:
                # columnar path: no filter, no routing, no spill (a
                # duck-typed sink with only flush() gets the list)
                flush_batch = getattr(sink, "flush_batch", None)
                if flush_batch is not None:
                    flush_batch(batch)
                else:
                    sink.flush(batch.materialize())
                return ok
            selected = [m for m in batch.materialize()
                        if m.sinks is None or name in m.sinks]
            if sc is not None:
                selected = _apply_sink_filters(selected, sc)
            current = selected
            sink.flush(spill + selected if spill else selected)
            return ok
        except Exception:
            logger.exception("sink %s flush failed", name)
            if spill:
                self._count("flush.spill_shed_total", key, len(spill))
                logger.error("sink %s: shedding %d spilled metrics after "
                             "a failed retry", key, len(spill))
            if current is None:
                # failed before selection: spill only this sink's share
                try:
                    current = [m for m in batch.materialize()
                               if m.sinks is None or name in m.sinks]
                    if sc is not None:
                        current = _apply_sink_filters(current, sc)
                except Exception:
                    logger.exception("sink %s: selection failed while "
                                     "spilling; shedding the interval", key)
                    current = []
            if current:
                with self._sink_lock:
                    self._sink_spill[key] = current
            return False

    def _dispatch_forward(self, fc: ForwardClient, fwd,
                          interval_start: float, flush_span, traced: bool):
        """Start the forward thread for this interval's snapshot; returns
        (thread, timings record), or None when nothing was dispatched.
        A snapshot that is empty still goes while carryover or spool
        state is pending. While the previous forward is still running,
        no second thread starts: the snapshot is stashed into the
        carryover, as a failed send's is, and counted."""
        # pending rows, not the carryover's depth: a send that succeeds
        # while this flush stashes resets the depth, not the rows
        pending = (fc.carryover.pending_metrics > 0
                   or (fc.spool is not None and fc.spool.depth > 0))
        if not len(fwd) and not pending:
            return None
        prev = self._forward_thread
        if prev is not None and prev.is_alive():
            with self._stats_lock:
                self.stats["forward_undispatched"] += 1
            if len(fwd):
                self.ledger.note("forward.snapshot", len(fwd))
                fc.carryover.stash(fwd)
                self.statsd.count("flush.forward_undispatched_total", 1)
            logger.warning("previous forward still running: %d metrics "
                           "carried over", len(fwd))
            return None
        # everything snapshotted for the forward plane is owed an outcome
        # (ack, merge-away, shed or inventory)
        self.ledger.note("forward.snapshot", len(fwd))
        record: Dict[str, float] = {}
        thread = threading.Thread(
            target=self._forward_safe,
            args=(fc, fwd, interval_start, record, flush_span, traced),
            name="flush-forward", daemon=True)
        self._forward_thread = thread
        thread.start()
        return thread, record

    def _forward_safe(self, fc: ForwardClient, fwd, interval_start: float,
                      record: Dict[str, float], flush_span,
                      traced: bool) -> None:
        t0 = time.perf_counter()
        with self._sink_span(flush_span, "forward", traced) as child:
            try:
                fc.forward(fwd, interval_start)
            except Exception as e:
                child.error()
                logger.exception("forward failed")
                with self._stats_lock:
                    if self._forward_error is None:
                        self._forward_error = e
        record.update(fc.last_timings)
        record["forward_s"] = time.perf_counter() - t0

    def _raise_forward_error(self) -> None:
        with self._stats_lock:
            exc, self._forward_error = self._forward_error, None
        if exc is not None:
            raise RuntimeError("a forward thread raised") from exc

    def shutdown(self) -> None:
        """Stop the alert loop, the listeners, the gRPC ingest, the span
        plane (after it drained what it holds) and the flush loop, run the
        last flush when `flush_on_shutdown` asks for it (without it, under
        `flush_async`, a pass that delivers the intervals already swapped
        and opens none), stop the readout executor and the prewarmer,
        then the forward tier and the HTTP API, and stop the sinks. The
        sinks' running deliveries are waited for before the last flush,
        and its own after it, within one grace of max(interval, 30 s).
        Raises afterwards if an ingest chunk failed to apply, a forward
        thread raised or the last flush failed."""
        self.telemetry.record_event("shutdown", pid=os.getpid())
        self._shutdown.set()
        # supervision stops first: threads leaving on the shutdown path
        # are not stalls
        self.overload.stop()
        self.alerts.stop()
        # sources first: an in-flight scrape or request finishes its
        # ingest before the listeners close and the last flush runs
        for source in self.sources:
            source.stop()
        for source, thread in zip(self.sources, self._source_threads):
            thread.join(timeout=source.join_timeout)
            if thread.is_alive():
                logger.error("source %s still running %.1f s after stop",
                             source.name(), source.join_timeout)
        for listener in self._listeners + self._ssf_listeners:
            listener.close()
        for ingest in self.grpc_ingest_servers:
            ingest.stop()
        if self._span_workers:
            self._stop_span_plane()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=self.interval + 60.0)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5.0)
        # the last flush delivers to every sink: a delivery still running
        # (a slow sink, or one stalled past its flush's deadline) is
        # waited for first, or the last flush would skip that sink as a
        # pileup and lose the interval. One grace bounds this wait and
        # the one for the last delivery below.
        sinks_deadline = time.perf_counter() + self._delivery_grace()
        self._join_sink_threads(sinks_deadline)
        final_error: Optional[BaseException] = None
        try:
            if self.config.flush_on_shutdown:
                # a full last flush: it delivers the interval in flight
                # and the partial one
                self.flush()
            elif self.config.flush_async:
                # no partial interval, but an interval already swapped
                # is complete: join and deliver it (WAL, forward, sinks)
                self._flush(deliver_only=True)
        except Exception as e:  # re-raised once everything stopped
            final_error = e
        if self._flush_executor is not None:
            self._flush_executor.stop()
        if self.prewarmer is not None:
            self.prewarmer.stop()
        if self._forward_thread is not None:
            # the send is bounded by its deadline, the interval
            self._forward_thread.join(timeout=self.interval)
        if self.import_server is not None:
            self.import_server.stop()
        if self.forward_client is not None:
            self.forward_client.close()
            # the forward plane's queues leave the observatory with it
            self.latency.unregister_queue("forward_carryover")
            self.latency.unregister_queue("forward_spool")
        if self.http_api is not None:
            self.http_api.stop()
            self.http_api = None
        if self.profiler is not None:
            self.profiler.stop()
        if self.profile_server is not None:
            self.profile_server.stop()
            self.profile_server = None
        if self.diagnostics is not None:
            self.diagnostics.stop()
        # a sink's last delivery ends before the sink stops
        self._join_sink_threads(sinks_deadline)
        for sink in self.metric_sinks + self.span_sinks:
            sink.stop()
        self.trace_client.close()
        self.statsd.close()
        if self.chaos is not None and chaos_mod.active() is self.chaos:
            chaos_mod.install(None)
        stats = self.stats_snapshot()
        logger.info("shutdown of pid %d complete: %d lines received, %d "
                    "parsed, %d rejected", os.getpid(),
                    stats["lines_received"], stats["lines_parsed"],
                    stats["lines_rejected"])
        self.shutdown_complete.set()
        self._raise_dispatch_error()
        self._raise_forward_error()
        if final_error is not None:
            raise final_error


def _round_family_tree(families: dict) -> dict:
    """The readout's per-family segments for the flight recorder and the
    waterfall (floats to the microsecond, structure kept), as the JAX
    server records them."""
    out = {}
    for family, rec in families.items():
        entry = {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in rec.items() if k != "devices"}
        entry["devices"] = {
            dev: {k: round(v, 6) for k, v in seg.items()}
            for dev, seg in rec.get("devices", {}).items()}
        out[family] = entry
    return out


def _sink_record() -> Dict[str, Any]:
    """One sink's record in a flush's timings, before its thread runs."""
    return {"duration_s": 0.0, "cpu_s": 0.0, "encode_s": None,
            "send_s": None, "encoder": None, "gzip_s": None}


# the sink plane's counters (JAX self-metric names)
_SINK_COUNTERS = ("flush.sink_skipped_total", "flush.sink_breaker_open_total",
                  "flush.spill_retry_total", "flush.spill_shed_total",
                  "flush.timeout_total")


def _apply_sink_filters(metrics: List[InterMetric], sc: SinkConfig
                        ) -> List[InterMetric]:
    """Per-sink filtering: max name/tag limits, strip/add tags
    (reference flusher.go:138-213; veneur_tpu/core/server.py
    _apply_sink_filters)."""
    strip = [TagMatcher.from_config(t) for t in sc.strip_tags]
    out = []
    for metric in metrics:
        if sc.max_name_length and len(metric.name) > sc.max_name_length:
            continue
        tags = metric.tags
        if strip:
            tags = [t for t in tags
                    if not any(sm.match(t) for sm in strip)]
        if sc.add_tags:
            tags = sorted(set(tags) | {
                f"{k}:{v}" if v else k for k, v in sc.add_tags.items()})
        if sc.max_tag_length and any(len(t) > sc.max_tag_length
                                     for t in tags):
            continue
        if sc.max_tags and len(tags) > sc.max_tags:
            continue
        if tags is not metric.tags:
            metric = InterMetric(
                name=metric.name, timestamp=metric.timestamp,
                value=metric.value, tags=tags, type=metric.type,
                message=metric.message, hostname=metric.hostname,
                sinks=metric.sinks, backfilled=metric.backfilled)
        out.append(metric)
    return out
