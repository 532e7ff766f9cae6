"""The port's span recorder (core/profiling.py `arm` / `record` /
`disarm`) and its sites, on the CPU: a server fed DogStatsD batches and
flushed into a Datadog sink (posting to a loopback HTTP stand-in) while
armed records every span of the CPU path, properly nested on each
thread; disarmed, no site records; a full buffer counts its drops; the
applies' spans are the kernel registry's own readings; and a device-trace
capture carries the spans on its `veneur host spans` track."""

from __future__ import annotations

import io
import json
import threading
import time
import zipfile
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.core.server import Server

FAMILIES = ("counter", "gauge", "histogram", "set")

# every span the CPU path reaches: the K1/K2 spans come from their
# wrappers' plain versions; the server below takes no llhist family (the
# circllhist server's spans are LLHIST_SPANS)
CPU_SPANS = {
    "ingest.batch", "ingest.parse", "ingest.slow_path",
    *(f"ingest.append.{f}" for f in FAMILIES),
    *(f"store.apply.{f}" for f in ("counter", "gauge", "histogram")),
    "store.copy_in", "store.copy_out",
    "flush.swap", "flush.sync", "flush.assembly", "flush.sinks",
    *(f"flush.readout.{f}" for f in (*FAMILIES, "llhist", "status")),
    "sink.encode", "sink.gzip", "sink.post",
    "kernel.k1", "kernel.k2",
}
# the llhist family's spans, on a server whose timers are circllhist
LLHIST_SPANS = {"ingest.append.llhist", "kernel.k3", "flush.readout.llhist",
                "flush.llhist.compact", "flush.llhist.assembly"}


class _Intake(BaseHTTPRequestHandler):
    """Datadog's intake stand-in: reads each body, answers 202."""

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.send_response(202)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture
def intake():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Intake)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def _server_config(intake, **extra):
    raw = {
        "interval": "10s", "hostname": "spans",
        "percentiles": [0.5, 0.99], "aggregates": ["min", "max", "count"],
        "flush_on_shutdown": False,
        "metric_sinks": [{"kind": "datadog", "name": "datadog", "config": {
            "datadog_api_key": "spans", "datadog_api_hostname": intake,
            "datadog_flush_max_per_body": 40}}],
        "tpu": {"counter_capacity": 128, "gauge_capacity": 128,
                "histo_capacity": 128, "set_capacity": 64,
                "llhist_capacity": 64, "batch_cap": 64,
                "set_promote_samples": 4},
    }
    raw.update(extra)
    return config_from_dict(raw)


@pytest.fixture
def server(intake):
    srv = Server(_server_config(intake), device="cpu")
    for sink in srv.metric_sinks:
        sink.start(srv)
    try:
        yield srv
    finally:
        profiling.disarm()
        srv.shutdown()


def _batches(n: int, seed: int = 0):
    """`n` batches of 16 datagrams x 8 lines over 20 keys a family."""
    out = []
    k = seed
    for _ in range(n):
        grams = []
        for _ in range(16):
            lines = []
            for _ in range(8):
                i = (k // 4) % 20
                lines += [f"sp.c{i}:{k % 7 + 1}|c|#env:a",
                          f"sp.g{i}:{k % 11}|g",
                          f"sp.t{i}:{(k * 37) % 101}|ms",
                          f"sp.s{i}:m{k % 13}|s"][k % 4:k % 4 + 1]
                k += 1
            grams.append("\n".join(lines).encode())
        out.append(grams)
    return out


def _by_thread(records):
    out = defaultdict(list)
    for name, ident, start, end, args in records:
        out[ident].append((start, end, name, args))
    return out


def _nesting_faults(records):
    """Spans of one thread that overlap without one holding the other."""
    faults = []
    for spans in _by_thread(records).values():
        stack = []
        for start, end, name, _args in sorted(spans,
                                              key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= start:
                stack.pop()
            if stack and end > stack[-1][1]:
                faults.append((stack[-1][2], name))
            stack.append((start, end, name))
    return faults


def test_armed_server_records_every_cpu_span_nested(server):
    profiling.arm(100_000)
    for grams in _batches(6):
        server.handle_packet_batch(grams)
    server.flush()
    records, dropped = profiling.disarm()
    assert dropped == 0
    names = {r[0] for r in records}
    assert CPU_SPANS <= names, sorted(CPU_SPANS - names)
    assert not _nesting_faults(records)
    for name, _ident, start, end, args in records:
        assert end >= start, name
    batches = [r for r in records if r[0] == "ingest.batch"]
    assert len(batches) == 6
    assert all(0.0 <= r[4]["cpu_s"] for r in batches)
    parses = [r for r in records if r[0] == "ingest.parse"]
    assert sum(r[4]["lines"] for r in parses) == 6 * 16 * 8
    appended = sum(r[4]["samples"] for r in records
                   if r[0].startswith("ingest.append."))
    assert 0 < appended <= 6 * 16 * 8
    copies = [r for r in records if r[0] == "store.copy_in"]
    assert all(r[4]["bytes"] > 0 for r in copies)
    k1 = [r for r in records if r[0] == "kernel.k1"]
    assert k1 and len(k1[0][4]["shape"]) == 3
    gz = [r for r in records if r[0] == "sink.gzip"]
    assert gz and all(0 < r[4]["bytes_out"] for r in gz)
    assert len(gz) > 1  # several bodies, gzipped on the sink's workers
    assert len(gz) == len([r for r in records if r[0] == "sink.post"])
    # the sink record carries the gzip seconds of its bodies
    rec = server.last_flush_timings["sink:datadog"]
    assert rec["gzip_s"] == pytest.approx(
        sum(r[3] - r[2] for r in gz), rel=1e-6, abs=1e-5)
    assert 0 < rec["gzip_s"] <= rec["send_s"]


def test_disarmed_sites_record_nothing(server, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a site recorded while disarmed")
    monkeypatch.setattr(profiling, "record", refuse)
    assert profiling.armed is False
    for grams in _batches(4):
        server.handle_packet_batch(grams)
    server.flush()
    gzip_s = server.last_flush_timings["sink:datadog"]["gzip_s"]
    assert gzip_s > 0
    # the operator's view of the counter: the latency observatory's
    # egress.gzip_s rows, beside encode_s and send_s
    assert server.latency.report()["egress"]["datadog"]["gzip"][
        "count"] == 1
    rows = {(n, tuple(tags)) for n, _k, _v, tags
            in server.latency.telemetry_rows()}
    assert ("egress.gzip_s.p99", ("sink:datadog",)) in rows
    assert profiling.disarm() == ([], 0)


def test_parse_span_carries_the_table_lookups(server, monkeypatch):
    """Armed, each `ingest.parse` carries its parse's intern-table
    lookups, misses and probe steps, which add up to the engine's totals;
    disarmed, the site records nothing and the engine still counts."""
    engine = server._ingester._engine
    before = engine.stats()
    profiling.arm(100_000)
    for grams in _batches(3):
        server.handle_packet_batch(grams)
    records, dropped = profiling.disarm()
    assert dropped == 0
    parses = [r[4] for r in records if r[0] == "ingest.parse"]
    assert len(parses) == 3
    assert all(set(a) == {"lines", "lookups", "misses", "probes"}
               for a in parses)
    # every line is a metric line; the slow path interns the first
    # batch's keys after its parse, so only the first batch misses
    assert [a["lookups"] for a in parses] == [a["lines"] for a in parses]
    assert [a["misses"] for a in parses] == [parses[0]["lines"], 0, 0]
    assert all(a["lookups"] <= a["probes"] for a in parses)
    after = engine.stats()
    for name in ("lookups", "misses", "probes"):
        assert after[name] - before[name] == sum(a[name] for a in parses)

    def refuse(*a, **kw):
        raise AssertionError("a site recorded while disarmed")
    monkeypatch.setattr(profiling, "record", refuse)
    server.handle_packet_batch(_batches(1, seed=5)[0])
    assert engine.stats()["lookups"] == after["lookups"] + 16 * 8


def test_full_buffer_counts_its_drops(server):
    profiling.arm(5)
    with pytest.raises(RuntimeError):
        profiling.arm(5)  # one capture at a time
    for grams in _batches(3):
        server.handle_packet_batch(grams)
    records, dropped = profiling.disarm()
    assert len(records) == 5 and dropped > 0
    profiling.arm(3)
    for i in range(10):
        profiling.record("x", float(i), float(i) + 0.5)
    records, dropped = profiling.disarm()
    assert [r[2] for r in records] == [0.0, 1.0, 2.0] and dropped == 7
    profiling.record("after", 0.0, 1.0)  # disarmed: nowhere to go
    assert profiling.disarm() == ([], 0)


def test_apply_spans_are_the_kernel_registry_readings(server):
    profiling.arm(100_000)
    for grams in _batches(8, seed=3):
        server.handle_packet_batch(grams)
    records, _dropped = profiling.disarm()
    hists = server.deviceobs._kernel_hists
    seen = 0
    for family in FAMILIES:
        spans = [r for r in records if r[0] == f"store.apply.{family}"]
        hist = hists.get(("apply", family))
        if hist is None:
            assert not spans
            continue
        total = 0.0
        for _name, _ident, start, end, _args in spans:
            total += end - start
        assert len(spans) == hist.count
        assert total == hist.sum  # the same readings, summed in order
        seen += len(spans)
    assert seen > 0


def test_device_trace_capture_holds_the_host_span_track(server):
    for grams in _batches(3, seed=7):  # the keys interned ahead
        server.handle_packet_batch(grams)
    fed = threading.Event()

    def feed():
        deadline = time.monotonic() + 60
        while not profiling.armed and time.monotonic() < deadline:
            time.sleep(0.002)
        for grams in _batches(3, seed=7):
            server.handle_packet_batch(grams)
        fed.set()

    thread = threading.Thread(target=feed)
    thread.start()
    body = profiling.capture_device_trace(1.0, "cpu")
    thread.join(timeout=60)
    assert fed.is_set() and not thread.is_alive()
    zf = zipfile.ZipFile(io.BytesIO(body))
    summary = json.loads(zf.read("summary.json"))
    assert summary["host_spans"] > 0 and summary["host_spans_dropped"] == 0
    assert summary["host_span_clock"] == "probe range"
    events = json.loads(zf.read("trace.json"))["traceEvents"]
    track = [e for e in events if e.get("ph") == "M"
             and e.get("name") == "process_name"
             and e["args"]["name"] == profiling.HOST_SPAN_TRACK]
    assert len(track) == 1
    spans = [e for e in events if e.get("cat") == "host_span"]
    assert len(spans) == summary["host_spans"]
    assert {e["pid"] for e in spans} == {track[0]["pid"]}
    assert "ingest.batch" in {e["name"] for e in spans}
    # placed on the profiler's clock: inside the capture's own events
    probe = next(e for e in events if e.get("name") == profiling.PROBE_RANGE)
    batch = next(e for e in spans if e["name"] == "ingest.batch")
    assert probe["ts"] - 1e4 <= batch["ts"] <= probe["ts"] + 1e6
    assert profiling.armed is False


def test_circllhist_server_records_the_llhist_spans_and_timings(intake):
    """Timers as circllhist: K3's launches, the flush's compaction (its
    rows, nonzero bins and bytes copied) and assembly are spans, and
    their readings are in the flush's timings."""
    srv = Server(_server_config(intake, histogram_encoding="circllhist"),
                 device="cpu")
    for sink in srv.metric_sinks:
        sink.start(srv)
    try:
        profiling.arm(100_000)
        for grams in _batches(6):
            srv.handle_packet_batch(grams)
        srv.flush()
        records, dropped = profiling.disarm()
        timings = srv.last_flush_timings
    finally:
        profiling.disarm()
        srv.shutdown()
    assert dropped == 0
    names = {r[0] for r in records}
    assert LLHIST_SPANS <= names, sorted(LLHIST_SPANS - names)
    assert not _nesting_faults(records)
    k3 = [r[4] for r in records if r[0] == "kernel.k3"]
    assert k3 and all(a["rows"] == 64 and a["samples"] > 0 for a in k3)
    # 6 batches x 128 lines, a quarter of them timers, each one sample
    assert sum(a["samples"] for a in k3) >= 6 * 16 * 8 // 4
    (compact,) = [r for r in records if r[0] == "flush.llhist.compact"]
    assert compact[4]["rows"] == 20
    assert compact[4]["nonzero_bins"] == timings["llhist_nonzero_bins"] > 0
    assert compact[4]["bytes"] == timings["llhist_copy_bytes"] > 0
    # the bins copied are the nonzero ones, not 20 rows of dense bins
    assert timings["llhist_copy_bytes"] < 20 * 4501 * 4 / 20
    (assembly,) = [r for r in records if r[0] == "flush.llhist.assembly"]
    assert timings["llhist_assembly_s"] == assembly[3] - assembly[2]
    assert compact[3] - compact[2] == pytest.approx(
        timings["llhist_bins_s"], abs=1e-3)
    (sync,) = [r for r in records if r[0] == "flush.sync"]
    (whole,) = [r for r in records if r[0] == "flush.assembly"]
    assert sync[2] <= compact[2] <= compact[3] <= sync[3]
    assert whole[2] <= assembly[2] <= assembly[3] <= whole[3]
