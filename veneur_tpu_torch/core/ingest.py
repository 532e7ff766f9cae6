"""Batched ingest: parsed DogStatsD columns into the device column store
(torch port of veneur_tpu/core/ingest.py, without SSF).

Packet buffers are parsed into per-family COO columns — by the native
C++ batch parser (a pump chunk or a `NativeParser.parse` result) or by
the numpy columnar decoder (core/batchdecode.py), the same duck type —
and the columns append straight into the tables' pending buffers: one
lock acquisition and one copy per family per buffer instead of one
object, one dict lookup and one lock per sample.

Slow-path contract: lines the parser defers (unknown keys, events,
service checks, malformed lines, non-ASCII set members) are replayed
through the port's Python parser, which keeps exact parse/error
semantics; metric lines that intern a new key are then registered with
the intern table, so each unique timeseries pays the Python path once.

Where the JAX package logs and drops a chunk whose apply raised, the port
counts the failure in the server's `ingest_dispatch_errors`, keeps the
first exception, and `Server.flush()` / `Server.shutdown()` re-raise it:
a kernel launch error never loses a chunk's samples without a trace.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from veneur_tpu_torch import native
from veneur_tpu_torch.core import batchdecode
from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.parser import ParseError

logger = logging.getLogger("veneur_tpu_torch.ingest")

_FAMILY_BY_TYPE = {
    m.COUNTER: native.FAM_COUNTER,
    m.GAUGE: native.FAM_GAUGE,
    m.HISTOGRAM: native.FAM_HISTO,
    m.TIMER: native.FAM_HISTO,
    m.SET: native.FAM_SET,
    m.LLHIST: native.FAM_LLHIST,
}


class _ColumnarIngesterBase:
    """Shared columnar apply path: parsed per-family COO columns land in
    the column store as batch applies, with the ordered gauge
    replay-merge and the slow-path deferral contract. Subclasses provide
    the parse step and the intern-table registration hook
    (`_register_entry`)."""

    server = None
    store = None
    parser = None  # the scalar (Python) parser, for the slow path

    def _table_for_family(self, family: int):
        return {
            native.FAM_COUNTER: self.store.counters,
            native.FAM_GAUGE: self.store.gauges,
            native.FAM_HISTO: self.store.histos,
            native.FAM_SET: self.store.sets,
            native.FAM_LLHIST: self.store.llhists,
        }[family]

    def _register_entry(self, meta_key: bytes, family: int, row: int,
                        rate: float) -> None:
        raise NotImplementedError

    def _ingest(self, res) -> int:
        """Apply one parsed buffer or chunk; returns its column samples."""
        store = self.store
        server = self.server
        unknown = res.unknown
        # columnar lines were parsed; deferred metric lines are counted as
        # the replay below parses or rejects them
        received = parsed = res.lines - len(unknown)

        # Counters/histograms/sets merge commutatively, so replay order
        # vs. column order is irrelevant for them. Gauges are
        # last-write-wins: a deferred line can fall anywhere relative to
        # the columnar lines of the same row, so replayed gauge samples
        # are captured (not applied) and merged with the gauge columns
        # by line index before one ordered add_batch.
        gauge_rows: list = []
        gauge_vals: list = []
        gauge_lines: list = []
        if unknown:
            line_no = 0

            def capture(metric):
                if metric.key.type == m.GAUGE:
                    gauge_rows.append(store.gauges.intern(metric))
                    gauge_vals.append(metric.value)
                    gauge_lines.append(line_no)
                else:
                    store.process(metric)

            for line, line_no in zip(unknown, res.unknown_lines):
                if line.startswith(b"_e{") or line.startswith(b"_sc"):
                    server.handle_metric_packet(line)  # counts itself
                    continue
                received += 1
                try:
                    self.parser.parse_metric_fast(line, capture)
                except ParseError as e:
                    logger.debug("could not parse line %r: %s",
                                 line[:100], e)
                    continue
                parsed += 1
                self._register_line(line)

        if len(res.c_rows):
            store.counters.add_batch(res.c_rows, res.c_vals, res.c_rates)
        if gauge_rows:
            all_rows = np.concatenate(
                [res.g_rows, np.asarray(gauge_rows, np.int32)])
            all_vals = np.concatenate(
                [res.g_vals, np.asarray(gauge_vals, np.float32)])
            all_lines = np.concatenate(
                [res.g_lines, np.asarray(gauge_lines, np.int32)])
            # stable sort: a line is either columnar or deferred, never
            # both, and multi-value samples share a line index, so append
            # order breaks ties correctly
            order = np.argsort(all_lines, kind="stable")
            store.gauges.add_batch(all_rows[order], all_vals[order])
        elif len(res.g_rows):
            store.gauges.add_batch(res.g_rows, res.g_vals)
        if len(res.h_rows):
            store.histos.add_batch(res.h_rows, res.h_vals, res.h_wts)
        if len(res.l_rows):
            store.llhists.add_batch_binned(
                res.l_rows, res.l_bins, res.l_wts, res.l_clamped)
        if len(res.s_rows):
            store.sets.add_batch(res.s_rows, res.s_idx, res.s_rho)
        # processed and line stamps LAST: the columns are in pending
        # buffers now, so a waiter that sees the count and flushes emits
        # them
        store.count_processed(res.samples + len(gauge_rows))
        server.count_lines(received, parsed)
        return res.samples

    def _register_line(self, line: bytes) -> None:
        """After the slow path interned a metric line's key, teach the
        intern table its (family, row, rate) so the next occurrence
        stays on the columnar fast path. Under `histogram_encoding:
        circllhist` a histogram/timer key registers as an llhist key: the
        parser then bins its values in float64 exactly as
        LLHistTable.add does (the JAX package leaves such lines on the
        slow path for good)."""
        type_start = line.find(b"|")
        if type_start < 0:
            return
        value_start = line.find(b":", 0, type_start)
        if value_start < 0:
            return
        meta_key = line[:value_start] + line[type_start:]
        cached = self.parser._meta_cache.get(meta_key)
        if cached is None:
            return  # line never parsed cleanly; stays on the slow path
        key, _h32, h64, rate, _tags, scope = cached
        family = _FAMILY_BY_TYPE.get(key.type)
        if family is None:
            return
        if (family == native.FAM_HISTO
                and self.store.histogram_encoding == "circllhist"):
            family = native.FAM_LLHIST
        table = self._table_for_family(family)
        row = table.rows.get((h64 << 2) | int(scope))
        if row is None:
            return
        self._register_entry(meta_key, family, row, rate)


class PyBatchIngester(_ColumnarIngesterBase):
    """The numpy columnar decoder's ingester (`tpu.disable_native_parser:
    true`): the same batch pipeline as the native ingester — intern-table
    columnar parse, one add_batch per family, slow-path deferral — with
    the parse step in Python (core/batchdecode.py)."""

    def __init__(self, server):
        self.server = server
        self.store = server.store
        self.parser = server.parser
        self.decoder = batchdecode.ColumnarDecoder()

    def ingest_buffer(self, buf: bytes) -> int:
        """Parse and aggregate one newline-joined packet buffer; returns
        the number of column samples taken."""
        return self._ingest(self.decoder.parse(buf))

    def _register_entry(self, meta_key: bytes, family: int, row: int,
                        rate: float) -> None:
        self.decoder.register(meta_key, family, row, rate)


class BatchIngester(_ColumnarIngesterBase):
    """One native intern table per server, with per-thread parse buffers
    for `ingest_buffer` and one pump per UDP listener. Building it builds
    the native library, and a failure raises."""

    def __init__(self, server):
        self.server = server
        self.store = server.store
        self.parser = server.parser
        self._engine = native.Engine()  # shared intern table
        self._tls = threading.local()   # per-thread parse buffers

    def ingest_buffer(self, buf: bytes) -> int:
        """Parse and aggregate one newline-joined packet buffer; returns
        the number of column samples taken (slow-path lines not
        counted)."""
        parser = getattr(self._tls, "parser", None)
        if parser is None:
            parser = self._tls.parser = native.NativeParser(
                engine=self._engine)
        return self._ingest(parser.parse(buf))

    def _register_entry(self, meta_key: bytes, family: int, row: int,
                        rate: float) -> None:
        self._engine.register(meta_key, family, row, rate)

    # ---- C++-resident pump ------------------------------------------------

    def start_pump(self, socks) -> native.Pump:
        """A native pump over the listener's sockets: the whole
        socket -> parse -> accumulate loop runs in C++ reader threads
        (one per socket, GIL-free) behind per-reader SPSC rings, and
        Python takes a chunk of up to `ingest_batch_max_samples` samples
        at a time."""
        cfg = self.server.config
        max_len = cfg.metric_max_length
        return native.Pump(
            self._engine, [s.fileno() for s in socks],
            max_dgram=max_len + 1, max_len=max_len,
            chunk_cap=max(1024, int(cfg.ingest_batch_max_samples)),
            ring_slots=max(3, int(cfg.ingest_ring_slots)))

    def run_pump_dispatch(self, pump: native.Pump, listener) -> None:
        """Dispatcher thread body: drain sealed chunks into the column
        store until the listener closes, then stop the readers and drain
        whatever they sealed on the way out."""
        while not listener.closed:
            self._dispatch_one(pump, timeout_ms=200)
        # readers may be blocked waiting for a free chunk: keep draining
        # while they wind down so their partial chunks (and the samples in
        # them) reach the store before the final flush
        pump.signal_stop()
        while pump.live_readers() > 0:
            self._dispatch_one(pump, timeout_ms=50)
        pump.stop()  # join (Listener.close may be doing the same)
        while self._dispatch_one(pump, timeout_ms=0):
            pass
        lost = pump.lost_lines()
        if lost:
            logger.warning("pump discarded %d in-flight lines at shutdown",
                           lost)

    def _dispatch_one(self, pump: native.Pump, timeout_ms: int) -> bool:
        chunk = pump.next(timeout_ms)
        if chunk is None:
            return False
        server = self.server
        try:
            if chunk.dropped:
                # oversized datagrams, dropped in C++ (metric_max_length):
                # each is one received line that did not parse
                server.count_lines(chunk.dropped, 0)
            self._ingest(chunk)
        except Exception as e:  # surfaced by Server.flush/shutdown
            server.note_dispatch_error(e)
            logger.exception("pump chunk dispatch failed")
        finally:
            # every column was copied into a pending buffer (or a private
            # array) above: the views die here
            pump.release(chunk)
        return True
