"""The port's server: DogStatsD over UDP into the device column store,
flushed every interval to the metric sinks (the local aggregation loop
of veneur_tpu/core/server.py, without forwarding).

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
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.samplers.metrics import HistogramAggregates
from veneur_tpu_torch.samplers.parser import ParseError, Parser

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
                                      "ingest_dispatch_errors": 0}
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
        # per-phase wall seconds of the last flush (swap / dispatch /
        # device_sync, with its llhist_bins copy / assembly / sinks /
        # total)
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
        clamp totals, samples of unknown wire type, and the pumps'
        reader stalls and lines lost at shutdown."""
        with self._stats_lock:
            out = dict(self.stats)
        llhists = self.store.llhists
        out["llhist_samples"] = llhists.samples_total
        out["llhist_clamped"] = llhists.clamped_total
        out["unknown_rejected"] = self.store.unknown_rejected
        pumps = [lst.pump for lst in self._listeners if lst.pump is not None]
        out["stalls"] = sum(p.stalls() for p in pumps)
        out["lost_lines"] = sum(p.lost_lines() for p in pumps)
        return out

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        for sink in self.metric_sinks:
            sink.start(self)
        for address in self.config.statsd_listen_addresses:
            self._listeners.append(start_statsd(
                address, self, self.config.num_readers,
                self.config.read_buffer_size_bytes))
        self._flush_thread = threading.Thread(
            target=self._flush_loop, name="flush-loop", daemon=True)
        self._flush_thread.start()

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
        out, read it out on the device, hand the batch to every sink.
        Raises afterwards if an ingest chunk failed to apply."""
        with self._flush_lock:
            t0 = time.perf_counter()
            timings: Dict[str, float] = {}
            batch = flush_columnstore_batch(
                self.store, self.percentiles, self.aggregates,
                timings=timings)
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
            end = time.perf_counter()
            timings["sinks_s"] = end - t_sinks
            timings["total_s"] = end - t0
            self.last_flush_timings = timings
        self._raise_dispatch_error()

    def shutdown(self) -> None:
        """Stop the listeners and the flush loop, then the sinks. Raises
        afterwards if an ingest chunk failed to apply."""
        self._shutdown.set()
        for listener in self._listeners:
            listener.close()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=self.interval + 60.0)
        for sink in self.metric_sinks:
            sink.stop()
        self._raise_dispatch_error()
