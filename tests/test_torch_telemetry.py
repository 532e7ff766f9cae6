"""The port's self-telemetry (veneur_tpu_torch/core/telemetry.py,
util/scopedstatsd.py, core/diagnostics.py, core/latency.py) against the
JAX package's, on the CPU:

- `Registry.render_prometheus` text equal to the JAX registry's for the
  same writes, statsd tees and collectors;
- `EventRecorder`/`FlushRecorder` JSON equal after the same calls (up to
  the wall-clock stamps);
- `ScopedClient` packets equal byte for byte for the same tags and
  scopes, over a callback and over UDP;
- `diagnostics.collect` emits the same gauge and counter names;
- `LatencyHist`, `bin_index_scalar` and the flush waterfall equal;
- the server's statsd self-metrics: sent to `stats_address`, they come
  out of the next flush as series, and the sink plane's counts go out
  with the JAX package's names and tags.
"""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import pytest

from veneur_tpu.core import diagnostics as jdiag
from veneur_tpu.core import latency as jlatency
from veneur_tpu.core import telemetry as jtel
from veneur_tpu.util.scopedstatsd import NullClient as JNullClient
from veneur_tpu.util.scopedstatsd import ScopedClient as JScopedClient
from veneur_tpu_torch.core import diagnostics, latency, telemetry
from veneur_tpu_torch.util.scopedstatsd import NullClient, ScopedClient

from test_torch_query import mk_server


def _writes(seed):
    """A seeded sequence of registry calls."""
    rng = np.random.default_rng(seed)
    names = ["flush.total_duration", "sink.errors", "queue.depth-x",
             "9lives", "a.b_c"]
    tags = [(), ("sink:dd",), ("env:prod", "sink:dd"), ("flag",),
            ("we ird:va\"l\\ue\n",)]
    calls = []
    for _ in range(60):
        op = rng.choice(["count", "gauge", "observe", "statsd"])
        name = str(rng.choice(names))
        tag = tags[int(rng.integers(len(tags)))]
        value = float(np.round(rng.gamma(1.0, 3.0), 3))
        if op == "statsd":
            kind = str(rng.choice(["c", "g", "ms"]))
            rate = float(rng.choice([1.0, 0.5, 0.1]))
            calls.append(("record_statsd", (name, value, kind, tag, rate)))
        else:
            calls.append((op, (name, value, tag)))
    return calls


def _collector_rows():
    return [("device.bytes_in_use", "gauge", 1.5e9, ["device:0"]),
            ("forward.sent", "counter", 7.0, ()),
            ("forward.sent", "counter", 3.0, ()),
            ("big", "gauge", 1e16, ["x:y"])]


def _failing_collector():
    raise RuntimeError("skipped for this scrape")


@pytest.mark.parametrize("seed", range(4))
def test_render_prometheus_equal_jax(seed):
    registries = (jtel.Registry(max_series=12),
                  telemetry.Registry(max_series=12))
    for registry in registries:
        for fn, args in _writes(seed):
            getattr(registry, fn)(*args)
        registry.add_collector(_collector_rows)
        registry.add_collector(_failing_collector)
    want, got = (r.render_prometheus() for r in registries)
    assert got == want
    assert registries[1].snapshot() == registries[0].snapshot()
    assert registries[1].series_dropped > 0  # the cap was exercised


@pytest.mark.parametrize("name,ptype", [
    ("flush.total_duration_ns", "gauge"), ("http.route.count", "counter"),
    ("already_total", "counter"), ("9x", "gauge")])
def test_prom_helpers_equal_jax(name, ptype):
    assert telemetry.prom_name(name, ptype) == jtel.prom_name(name, ptype)
    tags = ["a:b", "flag", "1bad:v", "k:with\"quote"]
    assert telemetry.prom_labels(tags, le="0.5") == \
        jtel.prom_labels(tags, le="0.5")
    assert telemetry.fnum(3.0) == jtel.fnum(3.0) == "3"
    assert telemetry.fnum(0.25) == jtel.fnum(0.25)


def _strip_ts(obj):
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items()
                if k not in ("ts", "start_unix")}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def test_recorders_json_equal_jax():
    tels = (jtel.Telemetry(event_capacity=4, flush_capacity=3),
            telemetry.Telemetry(event_capacity=4, flush_capacity=3))
    for tel in tels:
        for i in range(6):
            tel.record_event("flush" if i % 2 else "sink_skipped", flush=i,
                             sink="metric:dd", phases={"swap_s": 0.5})
        for i in range(5):
            tel.flushes.record({"flush": i, "start_unix": time.time(),
                                "sinks": {"metric:dd": {"status": "ok"}},
                                "phases": {"swap_s": 0.25 * i}})
    for limit, kind in ((0, ""), (2, ""), (0, "flush"), (1, "sink_skipped")):
        want, got = (json.loads(t.events_json(limit, kind=kind))
                     for t in tels)
        assert _strip_ts(got) == _strip_ts(want)
    for limit in (0, 2):
        want, got = (json.loads(t.flushes_json(limit)) for t in tels)
        assert _strip_ts(got) == _strip_ts(want)
    assert len(tels[1].events) == 4 and tels[1].events.total_recorded == 6
    rounds = [tel.flushes.snapshot() for tel in tels]
    assert _strip_ts(latency.waterfall_rounds(rounds[1])) == \
        _strip_ts(jlatency.waterfall_rounds(rounds[0]))


SCOPES = [({}, ()), ({"counter": "global", "gauge": "local"}, ("a:b",)),
          ({"count": "local", "timing": "global"}, ("x:1", "y:2")),
          ({"histogram": "local", "gauge": ""}, ())]


def _emit(client):
    client.count("flush.metrics_total", 12, tags=["phase:x"])
    client.count("sampled", 3, rate=0.5)
    client.gauge("flush.total_duration_ns", 123456789)
    client.gauge("ratio", 0.125, tags=["sink:metric:dd"])
    client.timing("flush.total_duration", 0.0123456)
    client.timing("flush.phase_duration", 2.5, tags=["phase:swap_s"])


@pytest.mark.parametrize("scopes,extra", SCOPES)
def test_scoped_client_packets_equal_jax(scopes, extra):
    got, want = [], []
    jreg, treg = jtel.Registry(), telemetry.Registry()
    _emit(JScopedClient(packet_cb=want.append, scopes=scopes,
                        additional_tags=extra, registry=jreg))
    client = ScopedClient(packet_cb=got.append, scopes=scopes,
                          additional_tags=extra, registry=treg)
    _emit(client)
    assert got == want and len(got) == 6
    assert client.packets_sent == 6
    assert treg.render_prometheus() == jreg.render_prometheus()


def test_scoped_client_udp_and_null_client():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        addr = "%s:%d" % rx.getsockname()
        packets = []
        for cls in (JScopedClient, ScopedClient):
            client = cls(address=addr, additional_tags=["k:v"])
            client.gauge("g", 1.5)
            client.close()
            packets.append(rx.recv(2048))
        assert packets[0] == packets[1] == b"g:1.5|g|#k:v"
    jreg, treg = jtel.Registry(), telemetry.Registry()
    _emit(JNullClient(registry=jreg))
    null = NullClient(registry=treg)
    _emit(null)
    assert null.packets_sent == 0
    assert treg.render_prometheus() == jreg.render_prometheus()


class _Names:
    """A statsd client stand-in that records (kind, name, tags)."""

    def __init__(self):
        self.seen = []

    def gauge(self, name, value, tags=(), rate=1.0):
        self.seen.append(("g", name, tuple(tags)))

    def count(self, name, value, tags=(), rate=1.0):
        self.seen.append(("c", name, tuple(tags)))


def test_diagnostics_collect_names_equal_jax():
    want, got = _Names(), _Names()
    start = time.time() - 5.0
    jdiag.collect(want, start, include_device=True)
    tick = diagnostics.collect(got, start, include_device=True)
    assert sorted(got.seen) == sorted(want.seen)
    assert ("g", "mem.rss_bytes", ()) in got.seen
    # uptime counts only the delta since the last tick
    assert diagnostics.collect(got, start, last_tick=tick) >= tick


def test_diagnostics_loop_emits_and_stops():
    names = _Names()
    loop = diagnostics.DiagnosticsLoop(names, 0.05, include_device=False)
    loop.start()
    try:
        deadline = time.monotonic() + 10.0
        while not names.seen and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        loop.stop()
    assert ("c", "uptime_ms", ()) in names.seen
    assert not loop._thread.is_alive()


@pytest.mark.parametrize("seed", range(3))
def test_latency_hist_equal_jax(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(-5, 3, 400),
                             [0.0, -1.5, 1e-12, 1e20, float("inf"),
                              float("nan")]])
    for v in values:
        assert latency.bin_index_scalar(float(v)) == \
            jlatency.bin_index_scalar(float(v))
    hists = (jlatency.LatencyHist("x"), latency.LatencyHist("x"))
    for h in hists:
        for v in values[:-1]:  # no NaN in a sum
            h.observe(float(v))
    assert hists[1].snapshot() == hists[0].snapshot()
    np.testing.assert_array_equal(hists[1].quantiles([0.1, 0.5, 0.9]),
                                  hists[0].quantiles([0.1, 0.5, 0.9]))


def test_device_memory_rows_without_cuda_equal_jax():
    # no CUDA here, and the JAX package's CPU devices report no stats
    assert telemetry.device_memory_rows() == jtel.device_memory_rows() == []


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_self_metrics_through_stats_address_come_out_next_flush():
    """stats_address pointed at the server's own UDP listener: the first
    flush's self-metrics are series of the second flush."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    server, obs = mk_server(
        interval="1h", statsd_listen_addresses=[f"udp://127.0.0.1:{port}"],
        stats_address=f"127.0.0.1:{port}",
        veneur_metrics_additional_tags=["svc:veneur"],
        features={"diagnostics_metrics_enabled": True})
    server.start()
    try:
        server.handle_packet_batch([b"app.hits:1|c"])
        server.flush()
        first = {m.name for m in obs.drain()}
        assert "app.hits" in first and "flush.total_duration_ns" not in first
        sent = server.statsd.packets_sent
        assert sent > 0
        assert _wait_for(lambda: server.stats_snapshot()["lines_received"]
                         == 1 + sent)
        server.flush()
        second = {m.name: m for m in obs.drain()}
        for name in ("flush.total_duration_ns", "flush.metrics_total",
                     "worker.metrics_processed_total",
                     "flush.total_duration.count",
                     "flush.phase_duration.count"):
            assert name in second, name
        assert "svc:veneur" in second["flush.total_duration_ns"].tags
        # the registry took the same emissions
        text = server.telemetry.registry.render_prometheus()
        assert "veneur_flush_total_duration_ns" in text
        assert "veneur_flush_metrics_total" in text
    finally:
        server.shutdown()
    events = [e["kind"] for e in server.telemetry.events.snapshot()]
    assert events[0] == "startup" and events[-1] == "shutdown"
    assert events.count("flush") == 2


class _Raising:
    def name(self):
        return "bad"

    def start(self, server):
        pass

    def stop(self):
        pass

    def flush(self, metrics):
        raise RuntimeError("down")

    def flush_other_samples(self, samples):
        pass


def test_sink_plane_counts_go_out_through_statsd():
    """A failing sink's spill retry and shed are counted through the
    statsd client, tagged with the sink, as the JAX package counts them,
    and still booked in stats_snapshot()."""
    server, _obs = mk_server(interval="0.5s")
    server.metric_sinks.append(_Raising())
    packets = []
    server.statsd = ScopedClient(packet_cb=packets.append,
                                 registry=server.telemetry.registry)
    try:
        for _ in range(2):
            server.handle_packet_batch([b"x:1|c"])
            server.flush()
        lines = b"\n".join(packets).decode()
        assert "flush.spill_retry_total:1|c|#sink:metric:bad" in lines
        assert "flush.spill_shed_total:1|c|#sink:metric:bad" in lines
        stats = server.stats_snapshot()
        assert stats["flush.spill_shed_total#sink:metric:bad"] == 1
        rounds = server.telemetry.flushes.snapshot()
        assert [r["sinks"]["metric:bad"]["status"] for r in rounds] == \
            ["error", "error"]
    finally:
        server.shutdown()
