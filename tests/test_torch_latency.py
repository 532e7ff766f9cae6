"""The port's latency observatory (veneur_tpu_torch/core/latency.py)
against the JAX package's: `InstrumentedQueue` dwell, `note_arrival` /
`take_watermarks` / `observe_sample_age` on a scripted clock, egress
bookkeeping, `report()` and `telemetry_rows()`; then the wiring:
`/debug/latency` on a server fed over UDP and on the proxy, whose
destination queues it reports next to the JAX proxy's. The JAX
package's retrace plane (`note_retrace`, the report's
`pending_retraces`) has no counterpart in the port, which recompiles
nothing: the reports are compared less that key."""

from __future__ import annotations

import json
import random
import socket
import time
import types
import urllib.request

import numpy as np
import pytest

from veneur_tpu.core import latency as jlat
from veneur_tpu.proxy.proxy import create_static_proxy as jcreate_proxy
from veneur_tpu.testing.forwardtest import ForwardTestServer
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import latency as tlat
from veneur_tpu_torch.core.httpapi import HTTPApi
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.forward.protos import metric_pb2
from veneur_tpu_torch.proxy.proxy import create_static_proxy as tcreate_proxy
from veneur_tpu_torch.sinks.channel import ChannelMetricSink


class _Clock:
    """A scripted stand-in for the `time` module's two clocks."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic, time=c.time,
                                 perf_counter=c.monotonic)
    monkeypatch.setattr(tlat, "time", fake)
    monkeypatch.setattr(jlat, "time", fake)
    return c


# the JAX report's retrace plane, which the port does not have
JAX_ONLY = {"pending_retraces"}


def _strip(report: dict) -> dict:
    out = {k: v for k, v in report.items() if k not in JAX_ONLY}
    out.pop("generated_unix")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instrumented_queue_dwell_matches_jax(clock, seed):
    rng = np.random.default_rng(seed)
    steps = [(bool(rng.random() < 0.6), float(rng.gamma(1.5, 0.02)))
             for _ in range(400)]
    snaps = []
    for mod in (tlat, jlat):
        obs = mod.LatencyObservatory()
        q = obs.instrument_queue("chan", maxsize=64)
        depths = []
        for put, dt in steps:
            clock.now += dt
            if put and not q.full():
                q.put_nowait(object())
            elif not q.empty():
                q.get_nowait()
            depths.append(q.qsize())
        snaps.append((obs.queue_hist("chan").bins.tolist(),
                      obs.queue_hist("chan").snapshot(), depths,
                      _strip(obs.report()), obs.telemetry_rows()))
    assert snaps[0] == snaps[1]
    assert snaps[0][1]["count"] > 100


def _planes_script(obs, clock, rng):
    """Arrivals on three planes over four intervals, one plane going
    quiet (its age series rolls after AGE_IDLE_SUPPRESS takes)."""
    takes = []
    for interval in range(6):
        for _ in range(int(rng.integers(5, 30))):
            clock.now += float(rng.gamma(2.0, 0.05))
            plane = ("dogstatsd", "ssf", "forward")[int(rng.integers(3))]
            if plane == "forward" and interval >= 2:
                continue
            obs.note_arrival(plane, int(rng.integers(1, 500)))
        marks = obs.take_watermarks()
        takes.append(marks)
        clock.now += 0.3
        obs.observe_sample_age(marks, clock.now)
        obs.note_egress("datadog", 0.01 * interval, 0.02)
        if interval == 3 and hasattr(obs, "note_retrace"):
            obs.note_retrace("histogram", 0.5, cache="miss")
    return takes


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_age_and_report_match_jax(clock, seed):
    out = []
    for mod in (tlat, jlat):
        clock.now = 1000.0
        obs = mod.LatencyObservatory()
        obs.register_queue("carry", lambda: 2, 3)
        obs.queue_hist("carry").observe(0.25)
        takes = _planes_script(obs, clock, np.random.default_rng(seed))
        obs.note_arrival("otlp", 7, t=clock.now - 1.0)  # pending mark
        out.append((takes, _strip(obs.report()), obs.telemetry_rows()))
    assert out[0] == out[1]
    takes, report, _rows = out[0]
    assert "forward" not in report["sample_age"]  # rolled after going idle
    assert set(report["sample_age"]) == {"dogstatsd", "ssf"}
    assert report["pending_watermarks"]["otlp"]["samples"] == 7
    assert report["queues"]["carry"] == {
        "dwell": report["queues"]["carry"]["dwell"], "depth": 2,
        "capacity": 3}
    assert not hasattr(tlat.LatencyObservatory, "note_retrace")


def test_disabled_observatory_hands_out_plain_queues():
    for mod in (tlat, jlat):
        obs = mod.LatencyObservatory(enabled=False)
        q = obs.instrument_queue("x", maxsize=4)
        assert type(q).__name__ == "Queue"
        obs.note_arrival("dogstatsd")
        assert obs.take_watermarks() == {}
        obs.register_queue("y", lambda: 1, 2)
        assert obs.telemetry_rows() == []
        assert obs.report()["queues"] == {}
        assert obs.report()["enabled"] is False


def test_unregister_and_family_segments_match_jax():
    fam = {"histogram": {"dispatch_s": 0.25, "transfer_s": 0.125,
                         "devices": {"cuda:0": {"sync_s": 0.5}}},
           "counter": {"dispatch_s": 0.0625, "transfer_s": 0.0,
                       "devices": {}}}
    assert tlat.family_segments_sum(fam) == jlat.family_segments_sum(fam)
    for mod in (tlat, jlat):
        obs = mod.LatencyObservatory()
        obs.register_queue("gone", lambda: 1, 1)
        obs.queue_hist("gone").observe(1.0)
        obs.unregister_queue("gone")
        assert obs.report()["queues"] == {}


# -- wiring ----------------------------------------------------------------


def _wait(pred, timeout: float = 20.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _get_json(address, path: str):
    host, port = address
    with urllib.request.urlopen(f"http://{host}:{port}{path}") as r:
        assert r.status == 200
        return json.loads(r.read())


@pytest.mark.parametrize("native", [True, False])
def test_debug_latency_on_a_server_fed_over_udp(native):
    cfg = config_from_dict({
        "hostname": "t", "interval": "1h", "http_address": "127.0.0.1:0",
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "num_readers": 2, "ledger_strict": True,
        "tpu": {"disable_native_parser": not native}})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(1))
    server.start()
    try:
        addr = server.listen_addresses[0]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(50):
                s.sendto(b"lat.c%d:1|c\nlat.t:%d|ms" % (i, i), addr)
        assert _wait(lambda: server.stats_snapshot()["lines_received"]
                     >= 100)
        server.flush()
        report = _get_json(server.http_api.address, "/debug/latency")
        assert set(report) == \
            set(jlat.LatencyObservatory().report()) - JAX_ONLY
        assert report["enabled"] is True
        age = report["sample_age"]["dogstatsd"]
        assert age["count"] == 2 and 0.0 <= age["p50"] <= age["max"]
        queues = report["queues"]
        assert queues["span_channel"]["capacity"] == \
            cfg.span_channel_capacity
        rings = sorted(q for q in queues if q.startswith("ingest_ring:"))
        assert len(rings) == (2 if native else 0)
        if native:
            assert sum(queues[q]["dwell"]["count"] for q in rings) >= 1
        text = server.telemetry.registry.render_prometheus()
        assert 'veneur_pipeline_sample_age_p99{plane="dogstatsd"}' in text
        assert 'veneur_queue_depth{queue="span_channel"}' in text
    finally:
        server.shutdown()


def test_latency_observatory_off_serves_an_empty_report():
    cfg = config_from_dict({"interval": "1h", "latency_observatory": False,
                            "http_address": "127.0.0.1:0"})
    server = Server(cfg, device="cpu")
    server.start()
    try:
        assert type(server.span_chan).__name__ == "Queue"
        server.handle_packet_batch([b"off.c:1|c"])
        server.flush()
        report = _get_json(server.http_api.address, "/debug/latency")
        assert report["enabled"] is False
        assert report["sample_age"] == {} and report["queues"] == {}
    finally:
        server.shutdown()


def _metrics(n: int) -> list:
    return [metric_pb2.Metric(name=f"px.{i}", type=metric_pb2.Counter,
                              tags=[f"k:{i % 7}"],
                              counter=metric_pb2.CounterValue(value=i + 1))
            for i in range(n)]


def test_debug_latency_on_the_proxy_like_jax():
    received = []
    ft = ForwardTestServer(received.extend)
    ft.start()
    reports = []
    try:
        for create in (tcreate_proxy, jcreate_proxy):
            received.clear()
            proxy = create([ft.address], health_check_interval=0)
            proxy.start()
            try:
                for m in _metrics(120):
                    proxy.handle_metric(m)
                assert _wait(lambda: len(received) == 120)
                if create is tcreate_proxy:
                    api = HTTPApi({}, address="127.0.0.1:0",
                                  latency=proxy.latency.report)
                    api.start()
                    try:
                        report = _get_json(api.address, "/debug/latency")
                    finally:
                        api.stop()
                else:
                    report = json.loads(json.dumps(proxy.latency.report()))
                reports.append(report)
            finally:
                proxy.stop()
    finally:
        ft.stop()
    name = f"proxy_dest:{ft.address}"
    for report in reports:
        assert report["enabled"] is True
        assert report["queues"][name]["dwell"]["count"] == 120
    assert set(reports[0]) == set(reports[1]) - JAX_ONLY
    assert set(reports[0]["queues"]) == set(reports[1]["queues"])
    assert reports[0]["queues"][name]["capacity"] == \
        reports[1]["queues"][name]["capacity"]


def test_proxy_cli_reads_latency_observatory():
    from veneur_tpu_torch.cmd import veneur_proxy as tcli
    raw = tcli.check_keys({"latency_observatory": False})
    assert raw["latency_observatory"] is False
    import inspect
    from veneur_tpu.proxy.proxy import ProxyServer as JProxyServer
    from veneur_tpu_torch.proxy.proxy import ProxyServer
    assert inspect.signature(ProxyServer).parameters[
        "latency_observatory"].default == inspect.signature(
        JProxyServer).parameters["latency_observatory"].default
