"""Batched ingest: parsed DogStatsD columns and SSF samples into the
device column store (torch port of veneur_tpu/core/ingest.py).

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

Admission and the shed ladder (core/overload.py): each parsed batch
takes one debit from the server's statsd token bucket; an over-limit
batch, or the shedding state, drops its histogram, llhist and set
columns, and the degraded state keeps every N-th sample of them.
Counter and gauge columns always land. Every shed sample is counted in
the overload manager's shed table by class and reason.

Flow ledger: the columns that reach the store and every slow-path
sample stamp `ingest.admitted` on the server's ledger (the columns
under the ingester's key, the slow path under "python"); the tables
stamp what they accept as `agg.applied` (core/columnstore.py). Shed
samples are never admitted: the ledger reads them as `ingress.shed`.

SSF datagrams take the same route through the native library
(`BatchIngester.ingest_ssf_buffer`): spans decode and their samples
extract in C++ against the same intern table, under a canonical key
(`ssf_meta_key`, byte-identical to dogstatsd.cc's `ssf_key`); samples it
defers replay through the Python SSF converter, which registers their
keys, and the uniqueness and indicator metrics the flags say are owed
derive in Python.

While the span recorder (core/profiling.py) is armed, a buffer's parse
is the span `ingest.parse` (the native parse's args carry its lines and
its intern-table lookups, misses and probe steps), the slow path's
replay `ingest.slow_path` and each family's append into its table
`ingest.append.<family>` (the applies and copies the append sets off
nest inside it).

Where the JAX package logs and drops a chunk whose apply raised, the port
counts the failure in the server's `ingest_dispatch_errors`, keeps the
first exception, and `Server.flush()` / `Server.shutdown()` re-raise it:
a kernel launch error never loses a chunk's samples without a trace.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

import numpy as np
from google.protobuf.message import DecodeError

from veneur_tpu_torch import native, protocol, ssf
from veneur_tpu_torch.core import batchdecode
from veneur_tpu_torch.core import overload as overload_mod
from veneur_tpu_torch.core import profiling
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

# SSF metric enum -> DogStatsD family char (dogstatsd.cc kFamilyChar)
_SSF_TC = {0: b"c", 1: b"g", 2: b"h", 3: b"s"}


def ssf_meta_key(sample) -> Optional[bytes]:
    """Canonical intern key for an SSF sample, byte-identical to
    dogstatsd.cc ssf_key: DogStatsD line-key form with sorted tag keys,
    a "|@rate" chunk when the rate is not 1, and a "|$N" suffix for an
    enum-forced scope. Identical identities unify with rows interned by
    the DogStatsD plane."""
    tc = _SSF_TC.get(sample.metric)
    if tc is None:
        return None
    parts = [sample.name.encode(), b"|", tc]
    rate = sample.sample_rate or 1.0
    if rate != 1.0:
        parts.append(b"|@%g" % rate)
    if sample.tags:
        kv = ",".join(f"{k}:{sample.tags[k]}" for k in sorted(sample.tags))
        parts.append(b"|#" + kv.encode())
    if sample.scope in (1, 2):
        parts.append(b"|$%d" % sample.scope)
    return b"".join(parts)


class _ColumnarIngesterBase:
    """Shared columnar apply path: parsed per-family COO columns land in
    the column store as batch applies, with the ordered gauge
    replay-merge and the slow-path deferral contract. Subclasses provide
    the parse step and the intern-table registration hook
    (`_register_entry`)."""

    server = None
    store = None
    parser = None  # the scalar (Python) parser, for the slow path
    # flow-ledger key of the admitted columns (which parse plane took
    # the sample, as in the JAX package)
    LEDGER_KEY = "native"

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

    def _ingest(self, res, shed_nonessential: bool = False) -> int:
        """Apply one parsed buffer or chunk; returns its column samples.

        Admission takes one token-bucket debit per batch, costing its
        sample count plus its deferred lines; an over-limit batch still
        takes the columnar path, in essential-only mode: its counter and
        gauge columns land, its histogram, llhist and set columns are
        shed with exact per-class counts (`_add_histo_set`). The whole
        apply is one ledger transit, so an interval close never books
        its admitted samples without their applied ones."""
        with self.server.ledger.transit():
            return self._ingest_columns(res, shed_nonessential)

    def _ingest_columns(self, res, shed_nonessential: bool) -> int:
        store = self.store
        server = self.server
        overload = server.overload
        n_ask = res.samples + len(res.unknown)
        if (not shed_nonessential and n_ask
                and not overload.admit_statsd_batch(n_ask)):
            shed_nonessential = True
        unknown = res.unknown
        # columnar lines were parsed; deferred metric lines are counted as
        # the replay below parses or rejects them
        received = parsed = res.lines - len(unknown)
        ledger = server.ledger
        # the counter/gauge columns are admitted here; the histogram,
        # llhist and set columns in _add_histo_set, where the shed ladder
        # decides what reaches the store
        ledger.note("ingest.admitted", len(res.c_rows) + len(res.g_rows),
                    key=self.LEDGER_KEY)

        # Counters/histograms/sets merge commutatively, so replay order
        # vs. column order is irrelevant for them. Gauges are
        # last-write-wins: a deferred line can fall anywhere relative to
        # the columnar lines of the same row, so replayed gauge samples
        # are captured (not applied) and merged with the gauge columns
        # by line index before one ordered add_batch.
        gauge_rows: list = []
        gauge_vals: list = []
        gauge_lines: list = []
        armed = profiling.armed
        if unknown:
            if armed:
                t_slow = time.perf_counter()
            line_no = 0
            metric_cb = (server._ingest_metric_essential
                         if shed_nonessential else server.ingest_metric)

            def capture(metric):
                if metric.key.type == m.GAUGE:
                    # admitted before the intern: a row-cap rejection
                    # stamps agg.rejected inside row_for
                    ledger.note("ingest.admitted", 1, key="python")
                    row = store.gauges.intern(metric)
                    if row < 0:  # the row cap: dropped, already counted
                        return
                    gauge_rows.append(row)
                    gauge_vals.append(metric.value)
                    gauge_lines.append(line_no)
                else:
                    metric_cb(metric)

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
            if armed:
                profiling.record("ingest.slow_path", t_slow,
                                 time.perf_counter(), {"lines": len(unknown)})

        if len(res.c_rows):
            if armed:
                t_app = time.perf_counter()
            store.counters.add_batch(res.c_rows, res.c_vals, res.c_rates)
            if armed:
                profiling.record("ingest.append.counter", t_app,
                                 time.perf_counter(),
                                 {"samples": len(res.c_rows)})
        if armed:
            n_gauges = len(res.g_rows) + len(gauge_rows)
            t_app = time.perf_counter()
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
        if armed and n_gauges:
            profiling.record("ingest.append.gauge", t_app,
                             time.perf_counter(), {"samples": n_gauges})
        self._add_histo_set(res, shed_nonessential, armed)
        # processed and line stamps LAST: the columns are in pending
        # buffers now, so a waiter that sees the count and flushes emits
        # them
        store.count_processed(res.samples + len(gauge_rows))
        server.count_lines(received, parsed)
        return res.samples

    def _add_histo_set(self, res, shed_nonessential: bool,
                       armed: bool = False) -> None:
        """Append the histogram, llhist and set columns under the shed
        ladder in batch form: shedding (or an over-limit batch) drops
        the columns whole, degraded keeps every `stride`-th sample of
        each column (a strided view; every table copies it into its
        pending buffer or packed block). Each shed sample is counted with
        its class and reason. The llhist clamped credit is kept only at
        stride 1: a subsampled batch cannot attribute it."""
        store = self.store
        overload = self.server.overload
        ledger = self.server.ledger
        keep = 0.0 if shed_nonessential else overload.histo_set_keep()
        stride = max(1, round(1.0 / keep)) if keep > 0 else 0
        shed_reason = "rate_limit" if shed_nonessential else "overload"
        groups = (
            ("ingest.append.histogram", overload_mod.CLASS_HISTOGRAM,
             res.h_rows,
             lambda k, s: store.histos.add_batch(
                 k, res.h_vals[::s], res.h_wts[::s])),
            ("ingest.append.llhist", overload_mod.CLASS_HISTOGRAM,
             res.l_rows,
             lambda k, s: store.llhists.add_batch_binned(
                 k, res.l_bins[::s], res.l_wts[::s],
                 res.l_clamped if s == 1 else 0)),
            ("ingest.append.set", overload_mod.CLASS_SET, res.s_rows,
             lambda k, s: store.sets.add_batch(
                 k, res.s_idx[::s], res.s_rho[::s])),
        )
        for span, cls, rows, apply_fn in groups:
            n = len(rows)
            if not n:
                continue
            if stride == 0:
                overload.shed(cls, n, reason=shed_reason)
                continue
            kept = rows[::stride]
            if keep < 1.0:
                # booked even when 0, as the JAX ladder books it
                overload.shed(cls, n - len(kept), reason="degraded")
            ledger.note("ingest.admitted", len(kept), key=self.LEDGER_KEY)
            if armed:
                t_app = time.perf_counter()
            apply_fn(kept, stride)
            if armed:
                profiling.record(span, t_app, time.perf_counter(),
                                 {"samples": len(kept)})

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

    LEDGER_KEY = "columnar"

    def __init__(self, server):
        self.server = server
        self.store = server.store
        self.parser = server.parser
        self.decoder = batchdecode.ColumnarDecoder()

    def ingest_buffer(self, buf: bytes) -> int:
        """Parse and aggregate one newline-joined packet buffer; returns
        the number of column samples taken."""
        armed = profiling.armed
        if armed:
            t0 = time.perf_counter()
        res = self.decoder.parse(buf)
        if armed:
            profiling.record("ingest.parse", t0, time.perf_counter(),
                             {"lines": res.lines})
        return self._ingest(res)

    def _register_entry(self, meta_key: bytes, family: int, row: int,
                        rate: float) -> None:
        self.decoder.register(meta_key, family, row, rate)

    def unregister_rows_multi(self, pairs) -> None:
        """Idle-row reclamation's intern sweep (the contract of
        native.Engine.unregister_rows_multi)."""
        self.decoder.unregister_rows({(int(f), int(r)) for f, r in pairs})

    def size(self) -> int:
        """Intern-table size (the native.Engine duck type)."""
        return self.decoder.size()


class BatchIngester(_ColumnarIngesterBase):
    """One native intern table per server, with per-thread parse buffers
    for `ingest_buffer` and one pump per UDP listener. Building it builds
    the native library, and a failure raises."""

    def __init__(self, server, rng: Optional[random.Random] = None):
        self.server = server
        self.store = server.store
        self.parser = server.parser
        self._engine = native.Engine()  # shared intern table
        self._tls = threading.local()   # per-thread parse buffers
        # seeds the C++ uniqueness rolls of each SSF batch
        self._rng = rng if rng is not None else random.Random()
        self._rng_lock = threading.Lock()

    def _parser(self) -> native.NativeParser:
        parser = getattr(self._tls, "parser", None)
        if parser is None:
            parser = self._tls.parser = native.NativeParser(
                engine=self._engine)
        return parser

    def ingest_buffer(self, buf: bytes) -> int:
        """Parse and aggregate one newline-joined packet buffer; returns
        the number of column samples taken (slow-path lines not
        counted)."""
        armed = profiling.armed
        if armed:
            t0 = time.perf_counter()
        res = self._parser().parse(buf)
        if armed:
            profiling.record("ingest.parse", t0, time.perf_counter(),
                             {"lines": res.lines, "lookups": res.lookups,
                              "misses": res.misses, "probes": res.probes})
        return self._ingest(res)

    def ingest_ptr(self, ptr, length: int) -> int:
        """ingest_buffer over a NativeReader's joined buffer, in place."""
        return self._ingest(self._parser().parse_ptr(ptr, length))

    # ---- SSF -------------------------------------------------------------

    def ingest_ssf_buffer(self, buf: bytes, offs, lens) -> np.ndarray:
        """Native SSF span decode and metric extraction (reference
        protocol/wire.go:108-186 and sinks/ssfmetrics/metrics.go:89-146)
        of the datagrams at (offs, lens) in `buf`. Samples the C++ path
        defers replay through the Python SSF converter, which registers
        their canonical keys; the uniqueness and indicator metrics owed
        by the flags derive in Python. Returns the per-packet decoded
        mask (the caller counts the packets and hands the spans on). One
        ledger transit, as `_ingest`."""
        with self.server.ledger.transit():
            return self._ingest_ssf(buf, offs, lens)

    def _ingest_ssf(self, buf: bytes, offs, lens) -> np.ndarray:
        server = self.server
        store = self.store
        cfg = server.config
        ledger = server.ledger
        ext = server.metric_extraction
        indicator_enabled = bool(cfg.indicator_span_timer_name
                                 or cfg.objective_span_timer_name)
        uniq_rate = ext.uniqueness_rate
        with self._rng_lock:
            seed = self._rng.getrandbits(63) | 1
        res = self._parser().parse_ssf(buf, offs, lens, indicator_enabled,
                                       uniq_rate, seed)
        flags = res.flags
        spans_cache: dict = {}

        def get_span(idx: int):
            span = spans_cache.get(idx)
            if span is None:
                start = int(offs[idx])
                span = spans_cache[idx] = protocol.parse_ssf(
                    buf[start:start + int(lens[idx])])
            return span

        replayed = 0
        gauge_rows: list = []
        gauge_vals: list = []
        gauge_lines: list = []
        for _pkt, raw, line_no in res.deferred:
            sample = ssf.SSFSample()
            try:
                sample.ParseFromString(raw)
                metric = self.parser.parse_metric_ssf(sample)
            except (DecodeError, ParseError) as e:
                logger.debug("invalid SSF sample (%d bytes): %s", len(raw), e)
                continue
            if not metric.name or metric.value is None:
                continue  # invalid sample (reference parser.go:154-171)
            if metric.key.type == m.GAUGE:
                # captured, not applied: merged with the native gauge
                # columns by line index so last-write-wins holds
                ledger.note("ingest.admitted", 1, key="python")
                gauge_rows.append(store.gauges.intern(metric))
                gauge_vals.append(metric.value)
                gauge_lines.append(line_no)
            else:
                server.ingest_metric(metric)
            replayed += 1
            self._register_ssf_sample(sample, metric)

        ledger.note("ingest.admitted",
                    len(res.c_rows) + len(res.g_rows) + len(res.h_rows)
                    + len(res.s_rows), key=self.LEDGER_KEY)
        if len(res.c_rows):
            store.counters.add_batch(res.c_rows, res.c_vals, res.c_rates)
        if gauge_rows:
            all_rows = np.concatenate(
                [res.g_rows, np.asarray(gauge_rows, np.int32)])
            all_vals = np.concatenate(
                [res.g_vals, np.asarray(gauge_vals, np.float32)])
            all_lines = np.concatenate(
                [res.g_lines, np.asarray(gauge_lines, np.int32)])
            order = np.argsort(all_lines, kind="stable")
            store.gauges.add_batch(all_rows[order], all_vals[order])
        elif len(res.g_rows):
            store.gauges.add_batch(res.g_rows, res.g_vals)
        if len(res.h_rows):
            store.histos.add_batch(res.h_rows, res.h_vals, res.h_wts)
        if len(res.s_rows):
            store.sets.add_batch(res.s_rows, res.s_idx, res.s_rho)
        store.count_processed(res.samples + len(gauge_rows))

        # the derived metrics the C++ path left to Python
        for idx in np.nonzero((flags & native.SSF_NEEDS_UNIQ) != 0)[0]:
            span = get_span(int(idx))
            sample = ssf.set_sample("ssf.names_unique", span.name, {
                "indicator": "true" if span.indicator else "false",
                "service": span.service,
                "root_span": ("true" if span.id == span.trace_id
                              else "false")})
            # the keep/drop roll already happened in C++; only the
            # rate-scaling half of ssf.randomly_sample applies here
            if 0 < uniq_rate <= 1:
                sample.sample_rate = uniq_rate
            metric = self.parser.parse_metric_ssf(sample)
            server.ingest_metric(metric)
            replayed += 1
            self._register_ssf_sample(sample, metric)
        if indicator_enabled:
            for idx in np.nonzero(
                    (flags & native.SSF_NEEDS_INDICATOR) != 0)[0]:
                for metric in self.parser.convert_indicator_metrics(
                        get_span(int(idx)), cfg.indicator_span_timer_name,
                        cfg.objective_span_timer_name):
                    server.ingest_metric(metric)
                    replayed += 1

        decoded = (flags & native.SSF_DECODED) != 0
        ext.count(int(decoded.sum()), res.samples + replayed)
        return decoded

    def _register_ssf_sample(self, sample, metric) -> None:
        """Bind an SSF sample's canonical key to the row the Python path
        just interned, so its next occurrence stays in C++."""
        key = ssf_meta_key(sample)
        family = _FAMILY_BY_TYPE.get(metric.key.type)
        if key is None or family is None:
            return
        table = self._table_for_family(family)
        row = table.rows.get((metric.digest64 << 2) | int(metric.scope))
        if row is None:
            return
        self._engine.register(key, family, row, metric.sample_rate or 1.0)

    def _register_entry(self, meta_key: bytes, family: int, row: int,
                        rate: float) -> None:
        self._engine.register(meta_key, family, row, rate)

    def unregister_rows_multi(self, pairs) -> None:
        """Idle-row reclamation's intern sweep: one pass over the native
        table for every family's tombstoned rows."""
        self._engine.unregister_rows_multi(pairs)

    def size(self) -> int:
        """Intern-table size: DogStatsD and SSF keys."""
        return self._engine.size()

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
        whatever they sealed on the way out. It beats the pipeline
        supervisor every loop (the 200 ms chunk wait bounds the beat
        interval), under a component name of its own listener, with the
        pump's native stall counter as a probe. With the latency
        observatory each reader's ready ring is the queue
        `ingest_ring:<host:port>:<reader>`: its depth, read from the
        native counters at scrape, and each chunk's seal-to-dispatch
        dwell, stamped by the C++ side."""
        server = self.server
        supervisor = server.overload.supervisor
        sup_name = f"ingest-pump:{listener.address}"
        supervisor.register(sup_name)
        supervisor.add_probe(sup_name, pump.stalls)
        latency = server.latency
        ring_names: list = []
        ring_hists: list = []
        if latency.enabled:
            caps = pump.ring_stats()[1]
            label = ":".join(str(part) for part in listener.address)
            for i in range(len(caps)):
                name = f"ingest_ring:{label}:{i}"
                ring_names.append(name)
                ring_hists.append(latency.queue_hist(name))
                latency.register_queue(
                    name, lambda idx=i: int(pump.ring_stats()[0][idx]),
                    int(caps[i]))
        while not listener.closed:
            supervisor.beat(sup_name)
            self._dispatch_one(pump, timeout_ms=200, ring_hists=ring_hists)
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
        # a listener closed on purpose is not a stall
        supervisor.unregister(sup_name)
        for name in ring_names:
            latency.unregister_queue(name)

    def _dispatch_one(self, pump: native.Pump, timeout_ms: int,
                      ring_hists=()) -> bool:
        chunk = pump.next(timeout_ms)
        if chunk is None:
            return False
        server = self.server
        # the sample-age stamp nearest the C++ socket read (a reader seals
        # within its seal age of the first sample), one per chunk
        server.latency.note_arrival("dogstatsd", chunk.samples or 1)
        if ring_hists:
            ring_hists[chunk.reader].observe(chunk.dwell_ms / 1000.0)
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
