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

import logging
import threading
import time
from typing import Dict, List, Optional

from veneur_tpu_torch import sinks as sinks_mod
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.core.columnstore import ColumnStore
from veneur_tpu_torch.core.flusher import flush_columnstore_batch
from veneur_tpu_torch.core.ingest import BatchIngester, PyBatchIngester
from veneur_tpu_torch.core.networking import Listener, start_statsd
from veneur_tpu_torch.core.overload import TokenBucket
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.forward.backfill import BackfillPlane
from veneur_tpu_torch.forward.client import ForwardClient
from veneur_tpu_torch.forward.convert import forwardable_to_wire
from veneur_tpu_torch.forward.server import ImportServer
from veneur_tpu_torch.samplers.metrics import HistogramAggregates
from veneur_tpu_torch.samplers.parser import ParseError, Parser
from veneur_tpu_torch.util.resilience import (Carryover, CircuitBreaker,
                                              RetryPolicy)
from veneur_tpu_torch.util.spool import CarryoverSpool

logger = logging.getLogger("veneur_tpu_torch.server")


class Server:
    def __init__(self, config: Config, device=None,
                 extra_metric_sinks: Optional[List] = None):
        self.config = config
        self.device = pick_device(device)
        self.interval = config.interval
        self.parser = Parser()
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
        # device_sync, with its llhist_bins copy / assembly / sinks, on a
        # global server backfill_drain, and on a local server
        # forward_encode / forward (the forward thread, when it ended
        # within the flush's wait) with its carryover_merge / wal_append /
        # spool_drain / total)
        self.last_flush_timings: Dict[str, float] = {}

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
        stalls and lines lost at shutdown, and the forward tier's
        counts: metrics forwarded and failed sends (a local server),
        metrics imported and failed merges (a global one)."""
        with self._stats_lock:
            out = dict(self.stats)
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
        for sink in self.metric_sinks:
            sink.start(self)
        if self.config.forward_address:
            self.forward_client = self._build_forward_client()
        if self.config.grpc_address:
            self.import_server = ImportServer(self, self.config.grpc_address)
            self.import_server.start()
        for address in self.config.statsd_listen_addresses:
            self._listeners.append(start_statsd(
                address, self, self.config.num_readers,
                self.config.read_buffer_size_bytes))
        self._flush_thread = threading.Thread(
            target=self._flush_loop, name="flush-loop", daemon=True)
        self._flush_thread.start()

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
                name="forward"),
            carryover=Carryover(cfg.carryover_max_intervals),
            spool=spool, wal=cfg.forward_wal,
            replay_limiter=replay_limiter,
            replay_stale_after=cfg.wal_stale_after_intervals * self.interval)

    @property
    def listen_addresses(self) -> List[tuple]:
        return [listener.address for listener in self._listeners]

    def _flush_loop(self) -> None:
        while not self._shutdown.wait(self.interval):
            try:
                self.flush()
            except Exception:
                logger.exception("flush failed")

    def flush(self) -> None:
        """One flush pass (reference flusher.go:26-122): swap every table
        out, read it out on the device, add the backfill plane's closed
        intervals, hand the batch to every sink and, on a local server,
        the forwardable state to the forward thread, which it waits for
        up to one interval from the flush's start. Raises afterwards if
        an ingest chunk failed to apply or a forward thread raised."""
        t0 = time.perf_counter()
        timings: Dict[str, float] = {}
        with self._flush_lock:
            fc = self.forward_client
            interval_start = self._interval_start_unix
            self._interval_start_unix = time.time()
            batch, fwd = flush_columnstore_batch(
                self.store, self.config.is_local, self.percentiles,
                self.aggregates, collect_forward=fc is not None,
                timings=timings)
            if self.backfill is not None:
                t_bf = time.perf_counter()
                batch.extras.extend(self.backfill.drain())
                timings["backfill_drain_s"] = time.perf_counter() - t_bf
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
            for sink in self.metric_sinks:
                try:
                    sink.flush_batch(batch)
                    if events:
                        sink.flush_other_samples(events)
                except Exception:
                    logger.exception("sink %s flush failed", sink.name())
            timings["sinks_s"] = time.perf_counter() - t_sinks
        if forward is not None:
            # bounded wait outside the flush lock: a hung send holds up
            # neither the next flush nor shutdown past the interval
            thread, record = forward
            thread.join(max(0.0, t0 + self.interval - time.perf_counter()))
            if thread.is_alive():
                logger.error("forward still running %.1f s into the "
                             "flush", time.perf_counter() - t0)
            else:
                for key, value in record.items():
                    timings[key] = timings.get(key, 0.0) + value
        timings["total_s"] = time.perf_counter() - t0
        self.last_flush_timings = timings
        self._raise_dispatch_error()
        self._raise_forward_error()

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
        """Stop the listeners and the flush loop, then the forward tier
        and the sinks. Raises afterwards if an ingest chunk failed to
        apply."""
        self._shutdown.set()
        for listener in self._listeners:
            listener.close()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=self.interval + 60.0)
        if self._forward_thread is not None:
            # the send is bounded by its deadline, the interval
            self._forward_thread.join(timeout=self.interval)
        if self.import_server is not None:
            self.import_server.stop()
        if self.forward_client is not None:
            self.forward_client.close()
        for sink in self.metric_sinks:
            sink.stop()
        self._raise_dispatch_error()
        self._raise_forward_error()
