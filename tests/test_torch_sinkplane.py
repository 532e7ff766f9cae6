"""The port's sink plane (veneur_tpu_torch/core/server.py) against the
JAX package's (veneur_tpu/core/server.py):

- both servers take the same DogStatsD lines over UDP and flush into a
  datadog sink pointed at a capturing fake of their own: the series
  posted are the same;
- the same scenarios, with the same duck-typed test sinks, run on a JAX
  server and on a port server (device="cpu"), flushed by hand with short
  intervals: what the sinks received after each flush, the breaker's
  state, the skip depth and the pending spill must be equal. They cover
  one thread per sink with skip counting, the breaker opening and its
  half-open probe, the spill retry and then the shed, and the deadline
  join returning while a sink hangs;
- per-sink filters and metric_sink_routing equal the JAX
  `_apply_sink_filters` and `SinkRoutingMatcher` on the same metrics,
  alone and through both servers;
- the port books the JAX self-metric counts in stats_snapshot() and a
  `sink:<name>` record in last_flush_timings.
"""

from __future__ import annotations

import gzip
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.config import SinkConfig as JSinkConfig
from veneur_tpu.config import SinkRoutingConfig as JRoutingConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.server import _apply_sink_filters as j_apply_filters
from veneur_tpu.samplers.metrics import InterMetric as JInterMetric
from veneur_tpu.samplers.metrics import MetricType as JMetricType
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu.util.matcher import SinkRoutingMatcher as JRouting
from veneur_tpu_torch.config import SinkConfig, config_from_dict
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.server import _apply_sink_filters
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks.channel import ChannelMetricSink
from veneur_tpu_torch.util.matcher import SinkRoutingMatcher
from veneur_tpu_torch.util.resilience import CLOSED, HALF_OPEN, OPEN

SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256)
PACKAGES = pytest.mark.parametrize("package", ["jax", "torch"])


def _jax_config(**extra) -> JConfig:
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.percentiles = [0.5, 0.99]
    cfg.aggregates = ["min", "max", "count"]
    for key, value in SIZES.items():
        setattr(cfg.tpu, key, value)
    for key, value in extra.items():
        setattr(cfg, key, value)
    return cfg.apply_defaults()


def _server(package, sinks=(), **extra):
    """A server of either package with `extra` config keys (the port's
    YAML spelling; for the JAX package metric_sinks and routing become
    its dataclasses)."""
    if package == "jax":
        if "metric_sinks" in extra:
            extra["metric_sinks"] = [JSinkConfig(**dict(s))
                                     for s in extra["metric_sinks"]]
        if "metric_sink_routing" in extra:
            extra["metric_sink_routing"] = [
                JRoutingConfig(name=r["name"], match=r["match"],
                               matched=r["sinks"].get("matched", []),
                               not_matched=r["sinks"].get("not_matched",
                                                          []))
                for r in extra["metric_sink_routing"]]
        features = extra.pop("features", {})
        cfg = _jax_config(**extra)
        for key, value in features.items():
            setattr(cfg.features, key, value)
        return JServer(cfg, extra_metric_sinks=list(sinks))
    cfg = config_from_dict({"hostname": "test", "percentiles": [0.5, 0.99],
                            "aggregates": ["min", "max", "count"],
                            "tpu": SIZES, **extra})
    return Server(cfg, device="cpu", extra_metric_sinks=list(sinks))


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- the datadog series of both servers ---------------------------------------


class CapturingHTTPServer:
    """Records every request (path, body) and returns 200."""

    def __init__(self):
        outer = self
        self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "gzip":
                    body = gzip.decompress(body)
                outer.requests.append((self.path, body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        host, port = self.httpd.server_address
        return f"http://{host}:{port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _udp_lines(seed=5):
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(20):
        lines.append(f"dd.c{k}:{rng.integers(1, 99)}|c|#env:t,k:{k % 3}")
        lines.append(f"dd.g{k}:{rng.normal(0, 9):.4f}|g|#host:h{k % 2}")
        for v in rng.gamma(2.0, 20.0, 12):
            lines.append(f"dd.t{k}:{v:.3f}|ms|#device:sd{k % 2}")
        for j in range(10 + k):
            lines.append(f"dd.s{k}:u{j}|s")
        for v in rng.lognormal(0, 2, 6):
            lines.append(f"dd.l{k}:{v:.5g}|l")
    lines.append("_sc|dd.check|1|#svc:web|m:slow")
    return [line.encode() for line in lines]


def _received(server, package):
    if package == "jax":
        return server.stats["packets_received"]
    return server.stats_snapshot()["lines_received"]


def _datadog_series(package, lines):
    fake = CapturingHTTPServer()
    sink_cfg = {"kind": "datadog", "name": "datadog",
                "config": {"datadog_api_key": "k",
                           "datadog_api_hostname": fake.url,
                           "datadog_flush_max_per_body": 50,
                           "tags": ["team:core"]}}
    server = _server(package, interval=3600.0, metric_sinks=[sink_cfg],
                     statsd_listen_addresses=["udp://127.0.0.1:0"])
    server.start()
    try:
        addr = (server.local_addr("udp") if package == "jax"
                else server.listen_addresses[0])
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for i in range(0, len(lines), 20):
                tx.sendto(b"\n".join(lines[i:i + 20]), addr)
                time.sleep(0.002)
        assert _wait_for(lambda: _received(server, package) == len(lines))
        server.flush()
        assert _wait_for(lambda: any("check_run" in p
                                     for p, _b in fake.requests))
    finally:
        server.shutdown()
        fake.close()
    series, checks = {}, []
    for path, body in fake.requests:
        if path.startswith("/api/v1/series"):
            for s in json.loads(body)["series"]:
                key = (s["metric"], s["type"], s["host"], s.get("device"),
                       tuple(s["tags"]), s["interval"])
                assert key not in series
                series[key] = s["points"][0][1]
        elif path.startswith("/api/v1/check_run"):
            check = json.loads(body)
            check.pop("timestamp")
            checks.append(check)
    return series, checks


def test_datadog_series_over_udp_equal_jax():
    lines = _udp_lines()
    want, want_checks = _datadog_series("jax", lines)
    got, got_checks = _datadog_series("torch", lines)
    assert set(got) == set(want)
    assert got_checks == want_checks and len(got_checks) == 1
    for key, value in want.items():
        name = key[0]
        if "percentile" in name or name.endswith((".median", ".avg")):
            # t-digest and llhist quantiles: the port's plain versions
            # against the JAX package's (ROADMAP queue 3, float order)
            assert got[key] == pytest.approx(value, rel=2e-5, abs=1e-9), key
        else:
            assert got[key] == value, key
    assert any(k[0].endswith(".bucket") for k in got)


# -- the thread plane, scenario by scenario -----------------------------------


class HangingSink:
    """flush() blocks from its `hang_from`-th call until released."""

    def __init__(self, hang_from=1):
        self.hang_from = hang_from
        self.release = threading.Event()
        self.calls = 0
        self.received = []

    def name(self):
        return "hang"

    def start(self, server):
        pass

    def stop(self):
        pass

    def flush(self, metrics):
        self.calls += 1
        if self.calls >= self.hang_from:
            self.release.wait(timeout=60.0)
        self.received.append(sorted(m.name for m in metrics))

    def flush_other_samples(self, samples):
        pass


class FailingSink:
    """Fails `fail_times` flushes, then records what it receives."""

    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.calls = 0
        self.received = []

    def name(self):
        return "flaky"

    def start(self, server):
        pass

    def stop(self):
        pass

    def flush(self, metrics):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("sink down")
        self.received.append(sorted(m.name for m in metrics))

    def flush_other_samples(self, samples):
        pass


def _plane_state(server, key):
    breaker = server._sink_breakers.get(key)
    return (breaker.state if breaker else None,
            server._sink_skip_depth.get(key, 0),
            sorted(m.name for m in server._sink_spill.get(key, [])))


def _live_threads(key):
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name == f"flush-{key}"]


def _hung_sink_scenario(package):
    """Flush 1 times out on the hung sink, flushes 2-5 skip it: one live
    thread, the breaker opened by the timeout and the skips, and every
    flush back within interval + 0.5 s."""
    sink = HangingSink()
    observer = (JChannel() if package == "jax" else ChannelMetricSink())
    server = _server(package, [observer, sink], interval=0.4,
                     circuit_breaker_failure_threshold=3,
                     circuit_breaker_recovery=3600.0)
    trace = []
    try:
        for i in range(5):
            server.handle_metric_packet(b"hang.c%d:1|c" % i)
            t0 = time.perf_counter()
            server.flush()
            took = time.perf_counter() - t0
            assert took < server.interval + 0.5, (package, i, took)
            delivered = sorted(m.name for m in observer.wait_flush(5.0))
            trace.append((delivered, sink.calls,
                          _plane_state(server, "metric:hang")))
        assert len(_live_threads("metric:hang")) == 1
        # read while the sink still hangs: its late success closes the
        # breaker again
        stats = server.stats_snapshot() if package == "torch" else None
    finally:
        sink.release.set()
        server.shutdown()
    return trace, server, stats


@PACKAGES
def test_hung_sink_is_skipped_and_opens_its_breaker(package):
    trace, server, stats = _hung_sink_scenario(package)
    assert [t[1] for t in trace] == [1] * 5  # never re-entered
    assert [t[2][0] for t in trace] == [CLOSED, CLOSED, OPEN, OPEN, OPEN]
    assert [t[2][1] for t in trace] == [0, 1, 2, 3, 4]
    assert [t[0] for t in trace] == [[f"hang.c{i}"] for i in range(5)]
    if package == "torch":
        assert stats["flush.sink_skipped_total"] == 4
        assert stats["flush.sink_skipped_total#sink:metric:hang"] == 4
        assert stats["flush.timeout_total"] == 1
        assert stats["resilience.breaker_state#target:metric:hang"] == 1
        assert stats["flush.sink_pileup_depth#sink:metric:hang"] == 4
        record = server.last_flush_timings["sink:hang"]
        assert record["status"] == "skipped" and record["pileup_depth"] == 4
        assert server._sink_breakers["metric:hang"].state == CLOSED


def test_hung_sink_plane_equals_jax():
    assert (_hung_sink_scenario("torch")[0]
            == _hung_sink_scenario("jax")[0])


def _spill_scenario(package, fail_times, flushes, **extra):
    sink = FailingSink(fail_times)
    server = _server(package, [sink], interval=2.0, **extra)
    trace = []
    try:
        for i, pause in enumerate(flushes):
            time.sleep(pause)
            server.handle_metric_packet(b"sp.m%d:1|c" % i)
            server.flush()
            trace.append((sink.calls, list(sink.received),
                          _plane_state(server, "metric:flaky")))
    finally:
        server.shutdown()
    return trace, server


SPILLS = {
    # one failure: the batch is retried with the next interval's
    "retry": dict(fail_times=1, flushes=(0, 0, 0)),
    # two failures: the retry fails and is shed, the newer batch spills
    "shed": dict(fail_times=2, flushes=(0, 0, 0)),
    # threshold 2: the breaker opens, refuses one interval without a
    # thread, and after its recovery the half-open probe delivers and
    # closes it
    "breaker": dict(fail_times=2, flushes=(0, 0, 0, 0.7),
                    circuit_breaker_failure_threshold=2,
                    circuit_breaker_recovery=0.5),
}


@pytest.mark.parametrize("case", sorted(SPILLS))
def test_spill_and_breaker_equal_jax(case):
    got, server = _spill_scenario("torch", **SPILLS[case])
    want, _ = _spill_scenario("jax", **SPILLS[case])
    assert got == want
    stats = server.stats_snapshot()
    if case == "retry":
        assert got[1][1] == [["sp.m0", "sp.m1"]]
        assert stats["flush.spill_retry_total"] == 1
        assert stats["flush.spill_shed_total"] == 0
    elif case == "shed":
        assert got[1][2][2] == ["sp.m1"]
        assert got[2][1] == [["sp.m1", "sp.m2"]]  # sp.m0 was shed
        assert stats["flush.spill_shed_total"] == 1
    else:
        assert [t[2][0] for t in got] == [CLOSED, OPEN, OPEN, CLOSED]
        assert got[2][0] == got[1][0]  # open: no thread, no call
        assert got[3][1] == [["sp.m1", "sp.m3"]]  # the probe's delivery
        assert stats["flush.sink_breaker_open_total"] == 1
        assert stats["resilience.breaker_state#target:metric:flaky"] == 0


def test_half_open_breaker_takes_one_probe():
    """Open, then half-open after the recovery: the probe is the one
    dispatched flush; while it hangs the breaker stays half-open and the
    next interval is skipped; a failed probe re-opens it."""
    sink = HangingSink(hang_from=3)
    server = _server("torch", [sink], interval=0.3,
                     circuit_breaker_failure_threshold=1,
                     circuit_breaker_recovery=0.2)
    sink.flush = _fail_first(sink.flush, 1)
    try:
        server.handle_metric_packet(b"p.a:1|c")
        server.flush()  # fails: opens at threshold 1
        assert server._sink_breakers["metric:hang"].state == OPEN
        time.sleep(0.3)
        assert server._sink_breakers["metric:hang"].state == HALF_OPEN
        server.handle_metric_packet(b"p.b:1|c")
        server.flush()  # the probe: delivers spill + p.b, closes
        assert server._sink_breakers["metric:hang"].state == CLOSED
        assert sink.received == [["p.a", "p.b"]]
    finally:
        sink.release.set()
        server.shutdown()


def _fail_first(flush, n):
    calls = {"n": 0}

    def wrapped(metrics):
        calls["n"] += 1
        if calls["n"] <= n:
            raise RuntimeError("down")
        return flush(metrics)
    return wrapped


def test_deadline_join_returns_while_a_sink_hangs_and_records_it():
    """The flush returns by t0 + interval (+ slack) while one sink hangs;
    the other sinks delivered, the hung one is `timed_out`, counted and
    fed to its breaker once; when it then fails late it is not counted
    again, and its record turns `error` and `late`."""
    hang = HangingSink()
    observer = ChannelMetricSink()
    server = _server("torch", [observer, hang], interval=0.3,
                     circuit_breaker_failure_threshold=5)

    def hang_then_fail(metrics):
        hang.calls += 1
        hang.release.wait(timeout=60.0)
        raise RuntimeError("late failure")
    hang.flush = hang_then_fail
    try:
        server.handle_metric_packet(b"d.a:1|c")
        t0 = time.perf_counter()
        server.flush()
        assert time.perf_counter() - t0 < server.interval + 0.5
        timings = server.last_flush_timings
        assert timings["sink:channel"]["status"] == "ok"
        assert timings["sink:hang"]["status"] == "timed_out"
        assert timings["sinks_s"] < server.interval + 0.5
        assert [m.name for m in observer.wait_flush(5.0)] == ["d.a"]
        breaker = server._sink_breakers["metric:hang"]
        assert breaker.consecutive_failures == 1
        hang.release.set()
        assert _wait_for(lambda: timings["sink:hang"].get("late"))
        assert timings["sink:hang"]["status"] == "error"
        assert breaker.consecutive_failures == 1  # not counted twice
        assert server.stats_snapshot()["flush.timeout_total"] == 1
        # the late failure spilled its batch for one retry
        assert [m.name for m in server._sink_spill["metric:hang"]] == [
            "d.a"]
    finally:
        hang.release.set()
        server.shutdown()


def test_one_thread_per_sink_and_records():
    """Each sink flushes on its own thread (named flush-metric:<name>),
    the records carry the egress split of a columnar sink, and a sink
    with nothing to deliver is not dispatched."""
    seen = {}

    class Recorder(ChannelMetricSink):
        def flush_batch(self, batch):
            seen[self.name()] = threading.current_thread().name
            self.note_egress(0.25, 0.5)
            super().flush_batch(batch)

    sinks = [Recorder("a"), Recorder("b")]
    server = _server("torch", sinks, interval=5.0)
    try:
        server.flush()  # empty: nothing dispatched
        assert seen == {}
        assert server.last_flush_timings["sink:a"]["status"] == "idle"
        server.handle_metric_packet(b"r.x:1|c")
        server.flush()
        assert seen == {"a": "flush-metric:a", "b": "flush-metric:b"}
        for name in ("a", "b"):
            rec = server.last_flush_timings[f"sink:{name}"]
            assert (rec["status"], rec["encode_s"], rec["send_s"],
                    rec["encoder"]) == ("ok", 0.25, 0.5, "columnar")
            assert rec["duration_s"] >= 0.0
    finally:
        server.shutdown()


def test_events_ride_the_sink_threads():
    got = []

    class EventSink(ChannelMetricSink):
        def flush_other_samples(self, samples):
            got.extend(s.name for s in samples)

    server = _server("torch", [EventSink()], interval=5.0)
    try:
        server.handle_metric_packet(b"_e{5,4}:title|text|#a:b")
        server.flush()  # no metrics, one event: dispatched
    finally:
        server.shutdown()
    assert got == ["title"]


def test_flush_still_raises_after_the_join_on_a_dispatch_error():
    server = _server("torch", [ChannelMetricSink()], interval=0.3)
    try:
        server.note_dispatch_error(RuntimeError("chunk failed"))
        server.handle_metric_packet(b"e.a:1|c")
        with pytest.raises(RuntimeError, match="ingest chunk"):
            server.flush()
        assert server.last_flush_timings["sink:channel"]["status"] == "ok"
    finally:
        server._dispatch_error = None
        server.shutdown()


# -- filters and routing ------------------------------------------------------

_FILTER_METRICS = [
    ("short", ["a:1", "tmp:x"]), ("a.very.long.metric.name", ["a:1"]),
    ("tagged", ["a:1", "b:2", "c:3"]), ("longtag", ["k:" + "v" * 30]),
    ("plain", []), ("a.route", ["env:prod"]), ("b.route", ["env:dev"]),
]

_FILTERS = [
    dict(max_name_length=10),
    dict(max_tags=2),
    dict(max_tag_length=12),
    dict(strip_tags=[{"kind": "prefix", "value": "tmp"}],
         add_tags={"team": "core", "flag": ""}),
    dict(strip_tags=[{"kind": "regex", "value": "^[ab]:"}], max_tags=1),
]


def _filter_metrics(cls, types_):
    return [cls(name=n, timestamp=1, value=1.0, tags=list(t),
                type=types_["COUNTER"], hostname="h")
            for n, t in _FILTER_METRICS]


def _as_rows(metrics):
    return [(m.name, list(m.tags), m.value) for m in metrics]


@pytest.mark.parametrize("flt", _FILTERS, ids=lambda f: ",".join(sorted(f)))
def test_apply_sink_filters_equals_jax(flt):
    want = j_apply_filters(
        _filter_metrics(JInterMetric, JMetricType.__members__),
        JSinkConfig(kind="x", **flt))
    got = _apply_sink_filters(
        _filter_metrics(InterMetric, MetricType.__members__),
        SinkConfig(kind="x", **flt))
    assert _as_rows(got) == _as_rows(want)


_ROUTING = [
    {"name": "by-name", "match": [{"name": {"kind": "prefix",
                                            "value": "a."}}],
     "sinks": {"matched": ["ra"], "not_matched": ["rb"]}},
    {"name": "by-tag", "match": [{"name": {"kind": "any"},
                                  "tags": [{"kind": "exact",
                                            "value": "env:dev"}]}],
     "sinks": {"matched": ["rb", "rc"], "not_matched": []}},
]


def test_routing_matcher_equals_jax():
    tcfg = config_from_dict({"metric_sink_routing": _ROUTING})
    jrules = [JRouting(JRoutingConfig(
        name=r["name"], match=r["match"], matched=r["sinks"]["matched"],
        not_matched=r["sinks"]["not_matched"])) for r in _ROUTING]
    trules = [SinkRoutingMatcher(rc) for rc in tcfg.metric_sink_routing]
    for name, tags in _FILTER_METRICS:
        assert ([r.route(name, tags) for r in trules]
                == [r.route(name, tags) for r in jrules])


@PACKAGES
def test_filters_and_routing_through_the_server_equal_jax(package):
    """Three config-declared channel sinks behind routing, one with
    filters; what each receives, against the JAX server's."""
    def run(pkg):
        sinks = [{"kind": "channel", "name": "ra",
                  "max_tags": 2, "add_tags": {"via": "ra"}},
                 {"kind": "channel", "name": "rb"},
                 {"kind": "channel", "name": "rc",
                  "strip_tags": [{"kind": "exact", "value": "env:dev"}]}]
        server = _server(pkg, interval=5.0, metric_sinks=sinks,
                         metric_sink_routing=_ROUTING,
                         features={"enable_metric_sink_routing": True})
        try:
            for name, tags in _FILTER_METRICS:
                line = f"{name}:1|c" + (f"|#{','.join(tags)}" if tags
                                        else "")
                server.handle_metric_packet(line.encode())
            server.flush()
            out = {}
            for sink in server.metric_sinks:
                out[sink.name()] = sorted(
                    (m.name, tuple(sorted(m.tags)))
                    for m in sink.wait_flush(5.0))
            return out
        finally:
            server.shutdown()
    got = run(package)
    assert got == run("jax")
    assert {n for n, _t in got["ra"]} == {"a.route", "a.very.long.metric.name"}
    assert ("b.route", ()) in got["rc"]  # env:dev stripped


def test_sink_threads_lose_no_count_under_contention():
    """24 sink threads (more than cores), each failing its first flush,
    with a tiny switch interval: every spill is retried once and counted,
    and every record and breaker lands."""
    import sys

    sinks = []
    for i in range(24):
        sink = FailingSink(fail_times=1)
        sink.name = (lambda n=f"s{i}": n)
        sinks.append(sink)
    server = _server("torch", sinks, interval=20.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for flush in range(2):
            for k in range(50):
                server.handle_metric_packet(b"st.f%d.c%d:1|c" % (flush, k))
            server.flush()
    finally:
        sys.setswitchinterval(old)
        server.shutdown()
    stats = server.stats_snapshot()
    assert stats["flush.spill_retry_total"] == 24 * 50
    assert stats["flush.spill_shed_total"] == 0
    for sink in sinks:
        assert sink.calls == 2 and len(sink.received[0]) == 100
        key = f"metric:{sink.name()}"
        assert stats[f"flush.spill_retry_total#sink:{key}"] == 50
        assert server._sink_breakers[key].state == CLOSED
        assert server.last_flush_timings[f"sink:{sink.name()}"][
            "status"] == "ok"
