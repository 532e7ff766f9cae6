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

UDP datagrams reach the store through the batch ingest plane
(core/ingest.py): by default the native C++ pump parses them into
columns; `tpu.disable_native_parser: true` selects the numpy columnar
decoder instead. The native library builds with g++ at first use, and a
build failure raises here.

    server = Server(read_config("config.yaml"))   # tables on cuda:0
    server.start()
    ...
    server.shutdown()

`Server(cfg, device="cpu")` runs the tables on the CPU, with every
kernel's plain PyTorch version; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from veneur_tpu_torch import sinks as sinks_mod
from veneur_tpu_torch.config import Config, SinkConfig, read_config
from veneur_tpu_torch.core import telemetry as telemetry_mod
from veneur_tpu_torch.core.alerts import AlertEngine
from veneur_tpu_torch.core.columnstore import ColumnStore
from veneur_tpu_torch.core.diagnostics import DiagnosticsLoop
from veneur_tpu_torch.core.flusher import FlushBatch, flush_columnstore_batch
from veneur_tpu_torch.core.httpapi import HTTPApi
from veneur_tpu_torch.core.ingest import BatchIngester, PyBatchIngester
from veneur_tpu_torch.core.networking import Listener, start_statsd
from veneur_tpu_torch.core.overload import TokenBucket
from veneur_tpu_torch.core.query import LiveQueryPlane
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.forward.backfill import BackfillPlane
from veneur_tpu_torch.forward.client import ForwardClient
from veneur_tpu_torch.forward.convert import forwardable_to_wire
from veneur_tpu_torch.forward.server import ImportServer
from veneur_tpu_torch.samplers.metrics import HistogramAggregates, InterMetric
from veneur_tpu_torch.samplers.parser import ParseError, Parser
from veneur_tpu_torch.util.resilience import (Carryover, CircuitBreaker,
                                              RetryPolicy)
from veneur_tpu_torch.util.matcher import SinkRoutingMatcher, TagMatcher
from veneur_tpu_torch.util.scopedstatsd import NullClient, ScopedClient
from veneur_tpu_torch.util.spool import CarryoverSpool

logger = logging.getLogger("veneur_tpu_torch.server")


class Server:
    def __init__(self, config: Config, device=None,
                 extra_metric_sinks: Optional[List] = None):
        self.config = config
        self.device = pick_device(device)
        self.interval = config.interval
        self.parser = Parser(extend_tags=config.extend_tags)
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
            device=self.device)
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
                                      # intervals stashed into the
                                      # carryover because the previous
                                      # forward was still running
                                      "forward_undispatched": 0}
        self._stats_lock = threading.Lock()
        self._dispatch_error: Optional[BaseException] = None
        # the columnar ingester: native unless explicitly disabled, and a
        # native build failure raises
        self._ingester = (PyBatchIngester(self)
                          if tpu.disable_native_parser
                          else BatchIngester(self))
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
            self.backfill = BackfillPlane(
                percentiles=self.percentiles,
                max_open=config.backfill_max_open_intervals)
            self.backfill_after_s = (config.wal_stale_after_intervals
                                     * self.interval)
        # per-phase wall seconds of the last flush (swap / dispatch /
        # device_sync, with its llhist_bins copy / assembly / sinks, from
        # the sink threads' dispatch to their join, on a global server
        # backfill_drain, and on a local server forward_encode / forward
        # (the forward thread, when it ended within the flush's wait)
        # with its carryover_merge / wal_append / spool_drain / total),
        # and per metric sink a `sink:<name>` record: status, duration_s,
        # cpu_s (the sink thread's own CPU seconds: the sink threads share
        # the interpreter lock, so a wall time includes the others' turns)
        # and the sink's note_egress (encode_s, send_s, encoder). A sink
        # thread that outlives the flush lands its record later, marked
        # `late`.
        self.last_flush_timings: Dict[str, Any] = {}
        self._build_operator_surface()

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
        self.http_api: Optional[HTTPApi] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self.flush_count = 0
        self.last_flush_unix = time.time()
        # set once shutdown() completes (a CLI exits on it when
        # /quitquitquit shut the server down)
        self.shutdown_complete = threading.Event()

    def _self_packet(self, packet: bytes) -> None:
        """Loop a self-metric packet straight back into the parse path."""
        try:
            self.parser.parse_metric_fast(packet, self.store.process)
        except ParseError:
            pass

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
        flush watchdog's budget is blown (a wedged flush loop means this
        instance is about to abort)."""
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
        the column store. A datagram longer than metric_max_length is one
        rejected line."""
        good = [d for d in datagrams
                if len(d) <= self.config.metric_max_length]
        if len(good) < len(datagrams):
            self.count_lines(len(datagrams) - len(good), 0)
        if good:
            self._ingester.ingest_buffer(b"\n".join(good))

    def handle_metric_packet(self, packet: bytes) -> None:
        """Parse and process one slow-path line: an event, a service
        check, or a metric line (reference server.go:949-1000)."""
        parsed = 0
        try:
            if packet.startswith(b"_sc"):
                self.store.process(self.parser.parse_service_check(packet))
            elif packet.startswith(b"_e{"):
                event = self.parser.parse_event(packet)
                with self._events_lock:
                    self._events.append(event)
            else:
                self.parser.parse_metric_fast(packet, self.store.process)
            parsed = 1
        except ParseError as e:
            logger.debug("could not parse %r: %s", packet[:100], e)
        self.count_lines(1, parsed)

    def stats_snapshot(self) -> Dict[str, int]:
        """Line counters, dispatch errors, the llhist family's sample and
        clamp totals, samples of unknown wire type, the pumps' reader
        stalls and lines lost at shutdown, the forward tier's counts:
        metrics forwarded and failed sends (a local server), metrics
        imported and failed merges (a global one), and the sink plane's
        (see _sink_plane_stats)."""
        with self._stats_lock:
            out = dict(self.stats)
        out.update(self._sink_plane_stats())
        llhists = self.store.llhists
        out["llhist_samples"] = llhists.samples_total
        out["llhist_clamped"] = llhists.clamped_total
        out["unknown_rejected"] = self.store.unknown_rejected
        pumps = [lst.pump for lst in self._listeners if lst.pump is not None]
        out["stalls"] = sum(p.stalls() for p in pumps)
        out["lost_lines"] = sum(p.lost_lines() for p in pumps)
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
        if cfg.forward_address:
            self.forward_client = self._build_forward_client()
            self.telemetry.registry.add_collector(
                self.forward_client.telemetry_rows)
        if cfg.grpc_address:
            self.import_server = ImportServer(
                self, cfg.grpc_address,
                ignored_tags=[TagMatcher(kind="prefix", value=t)
                              for t in cfg.tags_exclude])
            self.import_server.start()
            self.telemetry.registry.add_collector(
                self.import_server.telemetry_rows)
        for address in cfg.statsd_listen_addresses:
            self._listeners.append(start_statsd(
                address, self, cfg.num_readers,
                cfg.read_buffer_size_bytes))
        if cfg.http_address:
            self.http_api = HTTPApi(cfg, server=self,
                                    address=cfg.http_address,
                                    http_quit=cfg.http_quit,
                                    on_quit=self.shutdown)
            self.http_api.start()
        if self.diagnostics is not None:
            self.diagnostics.start()
        self._flush_thread = threading.Thread(
            target=self._flush_loop, name="flush-loop", daemon=True)
        self._flush_thread.start()
        if cfg.alerts.enabled:
            self.alerts.start()
        if cfg.flush_watchdog_missed_flushes > 0:
            self._watchdog_thread = threading.Thread(
                target=self._flush_watchdog, name="flush-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        self.telemetry.record_event(
            "startup", pid=os.getpid(),
            mode="local" if cfg.is_local else "global")

    def _build_forward_client(self) -> ForwardClient:
        """The forward client with its retry policy, breaker, carryover,
        and (with `carryover_spool_dir`) the durable spool, whose
        constructor re-scans segments a previous process left behind."""
        cfg = self.config
        spool = None
        if cfg.carryover_spool_dir:
            spool = CarryoverSpool(
                cfg.carryover_spool_dir,
                max_bytes=cfg.carryover_spool_max_bytes,
                max_segments=cfg.carryover_spool_max_segments,
                quarantine_max_bytes=cfg.carryover_spool_quarantine_max_bytes,
                quarantine_max_segments=(
                    cfg.carryover_spool_quarantine_max_segments))
        replay_limiter = None
        if cfg.forward_wal and cfg.wal_replay_rate_limit > 0:
            replay_limiter = TokenBucket(
                cfg.wal_replay_rate_limit,
                cfg.wal_replay_rate_limit * cfg.wal_replay_burst)
        return ForwardClient(
            cfg.forward_address, deadline=self.interval,
            retry=RetryPolicy(max_attempts=cfg.forward_retry_max_attempts,
                              base_delay=cfg.forward_retry_base,
                              max_delay=cfg.forward_retry_max),
            breaker=CircuitBreaker(
                failure_threshold=cfg.circuit_breaker_failure_threshold,
                recovery_time=cfg.circuit_breaker_recovery,
                name="forward", on_transition=self._breaker_transition),
            carryover=Carryover(cfg.carryover_max_intervals),
            spool=spool, wal=cfg.forward_wal,
            replay_limiter=replay_limiter,
            replay_stale_after=cfg.wal_stale_after_intervals * self.interval)

    @property
    def listen_addresses(self) -> List[tuple]:
        return [listener.address for listener in self._listeners]

    def _tick_delay(self) -> float:
        """Clock-aligned tick (reference server.go:1458
        CalculateTickDelay)."""
        return self.interval - (time.time() % self.interval)

    def _flush_loop(self) -> None:
        while not self._shutdown.wait(
                self._tick_delay() if self.config.synchronize_with_interval
                else self.interval):
            try:
                self.flush()
            except Exception:
                logger.exception("flush failed")

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

    def flush(self) -> None:
        """One flush pass (reference flusher.go:26-122): swap every table
        out, read it out on the device, add the backfill plane's closed
        intervals, start every sink's flush thread and, on a local
        server, the forward thread with the forwardable state, then wait
        for all of them, outside the flush lock, up to one interval from
        the flush's start. Raises afterwards if an ingest chunk failed to
        apply or a forward thread raised."""
        t0 = time.perf_counter()
        timings: Dict[str, Any] = {}
        with self._flush_lock:
            fc = self.forward_client
            interval_start = self._interval_start_unix
            self.last_flush_unix = self._interval_start_unix = time.time()
            self.flush_count += 1
            batch, fwd = flush_columnstore_batch(
                self.store, self.config.is_local, self.percentiles,
                self.aggregates, collect_forward=fc is not None,
                timings=timings, device_lock=self._readout_lock)
            if self.backfill is not None:
                t_bf = time.perf_counter()
                backfilled = self.backfill.drain()
                batch.extras.extend(backfilled)
                timings["backfill_drain_s"] = time.perf_counter() - t_bf
                if backfilled:
                    self.statsd.count("flush.backfilled_series_total",
                                      len(backfilled))
            # a pending carryover merges into fwd on the forward thread
            # and invalidates frames encoded here
            if (fc is not None and len(fwd)
                    and not fc.carryover.pending_metrics):
                t_enc = time.perf_counter()
                fwd.wire = forwardable_to_wire(fwd)
                timings["forward_encode_s"] = time.perf_counter() - t_enc
            forward = None
            if fc is not None:
                forward = self._dispatch_forward(fc, fwd, interval_start)
            with self._events_lock:
                events, self._events = self._events, []
            t_sinks = time.perf_counter()
            dispatched = self._dispatch_sinks(batch, events, timings)
        # bounded wait outside the flush lock: a hung sink or send holds
        # up neither the next flush nor shutdown past the interval; the
        # stragglers run on and are skipped next interval
        deadline = t0 + self.interval
        for _key, thread, _record in dispatched:
            thread.join(max(0.0, deadline - time.perf_counter()))
        timings["sinks_s"] = time.perf_counter() - t_sinks
        stuck = self._sweep_timed_out(dispatched)
        if forward is not None:
            thread, record = forward
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
        timings["total_s"] = time.perf_counter() - t0
        self.last_flush_timings = timings
        self._record_flush(timings, len(batch))
        self._raise_dispatch_error()
        self._raise_forward_error()

    def _record_flush(self, timings: Dict[str, Any], metrics: int) -> None:
        """The flush's self-metrics (the JAX flush's names), its round in
        the flight recorder and its event. The critical path is the wall
        time less the inline device readout (dispatch, sync, assembly),
        as the JAX package computes it for a flush that reads out
        inline."""
        duration = timings["total_s"]
        phases = {k: v for k, v in timings.items()
                  if isinstance(v, (int, float))}
        phases["critical_path_s"] = max(0.0, duration - sum(
            timings.get(k, 0.0)
            for k in ("dispatch_s", "device_sync_s", "assembly_s")))
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
        round_info = {
            "flush": self.flush_count, "start_unix": self.last_flush_unix,
            "mode": "local" if self.config.is_local else "global",
            "sinks": sinks, "duration_s": round(duration, 6),
            "metrics_flushed": metrics,
            "phases": {k: round(v, 6) for k, v in phases.items()}}
        self.telemetry.flushes.record(round_info)
        self.telemetry.record_event(
            "flush", flush=self.flush_count,
            duration_s=round_info["duration_s"], metrics=metrics,
            phases=round_info["phases"],
            sinks={k: v.get("status", "running") for k, v in sinks.items()})
        # cumulative process counters emit as gauges (they never reset)
        with self._stats_lock:
            processed = self.stats["lines_received"]
        self.statsd.gauge("worker.metrics_processed_total", processed)

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
                        timings: Dict[str, Any]) -> List[tuple]:
        """Start each metric sink's flush thread for this interval (the
        caller holds _flush_lock); returns [(key, thread, record)]. A
        sink is dispatched only when there is something for it: metrics,
        events, or its spill."""
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
            record: Dict[str, Any] = {"duration_s": 0.0, "cpu_s": 0.0,
                                      "encode_s": None, "send_s": None,
                                      "encoder": None}
            timings[f"sink:{sink.name()}"] = record
            with self._sink_lock:
                spilled = key in self._sink_spill
            if not (len(batch) or events or spilled):
                record["status"] = "idle"
                continue
            prev = self._sink_flush_threads.get(key)
            if prev is not None and prev.is_alive():
                # one flush thread per sink: a hung sink's interval is
                # skipped, and every skip is a failure its hung thread
                # will never report, so it feeds the breaker
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
                continue
            self._sink_skip_depth.pop(key, None)
            if not self._sink_breaker(key).allow():
                # open breaker: no thread; the interval is dropped
                # (counted) until the half-open probe closes it again
                self._count("flush.sink_breaker_open_total", key)
                record["status"] = "breaker_open"
                self.telemetry.record_event(
                    "sink_breaker_open", sink=key, flush=self.flush_count)
                continue
            thread = threading.Thread(
                target=self._timed_sink_flush,
                args=(key, sink, record, batch, events),
                name=f"flush-{key}", daemon=True)
            self._sink_flush_threads[key] = thread
            thread.start()
            dispatched.append((key, thread, record))
        return dispatched

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
                          batch: FlushBatch, events: List) -> None:
        """Body of one sink flush thread: the delivery, its duration and
        egress report, and the breaker fed by what the delivery showed."""
        before = getattr(sink, "last_egress", None)
        start, cpu0 = time.perf_counter(), time.thread_time()
        try:
            ok = self._flush_sink_safe(key, sink, batch, events)
        except Exception:
            logger.exception("sink %s: flush thread failed", key)
            ok = False
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
                record["encode_s"], record["send_s"], record["encoder"] = \
                    egress

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
                          interval_start: float):
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
                fc.carryover.stash(fwd)
                self.statsd.count("flush.forward_undispatched_total", 1)
            logger.warning("previous forward still running: %d metrics "
                           "carried over", len(fwd))
            return None
        record: Dict[str, float] = {}
        thread = threading.Thread(
            target=self._forward_safe, args=(fc, fwd, interval_start, record),
            name="flush-forward", daemon=True)
        self._forward_thread = thread
        thread.start()
        return thread, record

    def _forward_safe(self, fc: ForwardClient, fwd, interval_start: float,
                      record: Dict[str, float]) -> None:
        t0 = time.perf_counter()
        try:
            fc.forward(fwd, interval_start)
        except Exception as e:
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
        """Stop the alert loop, the listeners and the flush loop, run the
        last flush when `flush_on_shutdown` asks for it, then stop the
        forward tier and the HTTP API, wait up to one interval for the
        sink threads, and stop the sinks. Raises afterwards if an ingest
        chunk failed to apply, a forward thread raised or the last flush
        failed."""
        self.telemetry.record_event("shutdown", pid=os.getpid())
        self._shutdown.set()
        self.alerts.stop()
        for listener in self._listeners:
            listener.close()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=self.interval + 60.0)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5.0)
        final_error: Optional[BaseException] = None
        if self.config.flush_on_shutdown:
            try:
                self.flush()
            except Exception as e:  # re-raised once everything stopped
                final_error = e
        if self._forward_thread is not None:
            # the send is bounded by its deadline, the interval
            self._forward_thread.join(timeout=self.interval)
        if self.import_server is not None:
            self.import_server.stop()
        if self.forward_client is not None:
            self.forward_client.close()
        if self.http_api is not None:
            self.http_api.stop()
            self.http_api = None
        if self.diagnostics is not None:
            self.diagnostics.stop()
        # a sink's last delivery ends before the sink stops
        deadline = time.perf_counter() + self.interval
        for thread in list(self._sink_flush_threads.values()):
            thread.join(max(0.0, deadline - time.perf_counter()))
        for sink in self.metric_sinks:
            sink.stop()
        self.statsd.close()
        self.shutdown_complete.set()
        self._raise_dispatch_error()
        self._raise_forward_error()
        if final_error is not None:
            raise final_error


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
