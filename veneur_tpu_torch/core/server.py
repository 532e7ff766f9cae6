"""The port's server: DogStatsD over UDP into the device column store,
flushed every interval to the metric sinks (the aggregation loop of
veneur_tpu/core/server.py), and the two ends of the forward tier.

With `forward_address` set the server is local: each flush also collects
the mergeable state of its non-local rows (forward/convert.py encodes it)
and, after the sinks, sends it to the global server's import endpoint
(forward/client.py). With `grpc_address` set it runs that endpoint
(forward/server.py), which merges what the locals send into this
server's tables on its device.

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
from veneur_tpu_torch.forward.client import ForwardClient
from veneur_tpu_torch.forward.convert import forwardable_to_wire
from veneur_tpu_torch.forward.server import ImportServer
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
        # the forward tier's two ends, built by start()
        self.forward_client: Optional[ForwardClient] = None
        self.import_server: Optional[ImportServer] = None
        # per-phase wall seconds of the last flush (swap / dispatch /
        # device_sync, with its llhist_bins copy / assembly / sinks, and
        # on a local server forward_encode / forward / total)
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
        return out

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        for sink in self.metric_sinks:
            sink.start(self)
        if self.config.forward_address:
            self.forward_client = ForwardClient(self.config.forward_address,
                                                deadline=self.interval)
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
        out, read it out on the device, hand the batch to every sink and,
        on a local server, the forwardable state to the global one.
        Raises afterwards if an ingest chunk failed to apply."""
        with self._flush_lock:
            t0 = time.perf_counter()
            timings: Dict[str, float] = {}
            fc = self.forward_client
            batch, fwd = flush_columnstore_batch(
                self.store, self.config.is_local, self.percentiles,
                self.aggregates, collect_forward=fc is not None,
                timings=timings)
            if fc is not None:
                t_enc = time.perf_counter()
                fwd.wire = forwardable_to_wire(fwd)
                timings["forward_encode_s"] = time.perf_counter() - t_enc
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
            if fc is not None:
                fc.forward(fwd)
                timings["forward_s"] = time.perf_counter() - end
            timings["total_s"] = time.perf_counter() - t0
            self.last_flush_timings = timings
        self._raise_dispatch_error()

    def shutdown(self) -> None:
        """Stop the listeners and the flush loop, then the forward tier
        and the sinks. Raises afterwards if an ingest chunk failed to
        apply."""
        self._shutdown.set()
        for listener in self._listeners:
            listener.close()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=self.interval + 60.0)
        if self.import_server is not None:
            self.import_server.stop()
        if self.forward_client is not None:
            self.forward_client.close()
        for sink in self.metric_sinks:
            sink.stop()
        self._raise_dispatch_error()
