"""The port's egress chaos seams against the JAX package's, on the CPU:
the same seed gives the same injection sequence at every seam, the
deterministic forward latency, the config keys, and each seam where the
port reaches it: `forward_send` in the forward client (retried, then
carried over, under the strict ledger), `sink_flush` in the server's
sink threads (the batch spills for one retry), `http_post` in
util/http.py, `health_probe` in the proxy's ring health."""

from __future__ import annotations

import threading
import time

import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.testing.forwardtest import ForwardTestServer
from veneur_tpu.util.chaos import Chaos as JChaos
from veneur_tpu.util.chaos import ChaosError as JChaosError
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.proxy.destinations import Destinations
from veneur_tpu_torch.proxy.health import RingHealth
from veneur_tpu_torch.util import chaos as chaos_mod
from veneur_tpu_torch.util import http as vhttp
from veneur_tpu_torch.util.chaos import SEAMS, Chaos, ChaosError
from veneur_tpu_torch.util.resilience import RetryPolicy

from test_torch_forward import _tserver


def _sequence(chaos, error_cls, seams, n=300):
    """Each inject's outcome: 'e' raised, 'd' slept, '.' passed."""
    slept = []
    chaos._sleep = slept.append
    out = []
    for i in range(n):
        seam = seams[i % len(seams)]
        before = len(slept)
        try:
            chaos.inject(seam)
            out.append("d" if len(slept) > before else ".")
        except error_cls:
            out.append("e")
    return "".join(out), dict(chaos.injected_errors), \
        dict(chaos.injected_delays)


@pytest.mark.parametrize("seam", SEAMS)
@pytest.mark.parametrize("seed", [0, 17])
def test_same_seed_same_sequence_as_jax(seam, seed):
    kw = dict(error_rate=0.3, delay_rate=0.2, delay=0.01, seed=seed)
    got = _sequence(Chaos(**kw), ChaosError, [seam])
    want = _sequence(JChaos(**kw), JChaosError, [seam])
    assert got == want
    assert "e" in got[0] and "d" in got[0]


def test_interleaved_seams_and_a_subset_match_jax():
    kw = dict(error_rate=0.5, seed=3, seams=("forward_send", "http_post"))
    got = _sequence(Chaos(**kw), ChaosError, list(SEAMS))
    want = _sequence(JChaos(**kw), JChaosError, list(SEAMS))
    assert got == want
    assert got[1].keys() <= {"forward_send", "http_post"}


def test_forward_latency_is_deterministic():
    slept = []
    c = Chaos(forward_latency_ms=40.0, sleep=slept.append)
    for _ in range(5):
        c.inject("forward_send")
    c.inject("sink_flush")  # other seams unaffected
    assert slept == [0.04] * 5
    assert c.injected_delays == {"forward_send": 5}
    rows = {(r[0], tuple(r[3])): r[2] for r in c.telemetry_rows()}
    assert rows[("chaos.injected_delays", ("seam:forward_send",))] == 5.0


def test_chaos_keys_build_the_jax_plan():
    raw = {"chaos_enabled": True, "chaos_error_rate": 0.25,
           "chaos_delay_rate": 0.5, "chaos_delay": "20ms",
           "chaos_seams": ["sink_flush"], "chaos_seed": 9,
           "chaos_forward_latency_ms": 12.5}
    t = Chaos.from_config(config_from_dict(raw))
    jcfg = JConfig()
    for k, v in raw.items():
        setattr(jcfg, k, 0.02 if k == "chaos_delay" else v)
    j = JChaos.from_config(jcfg)
    for attr in ("error_rate", "delay_rate", "delay", "seams",
                 "forward_latency_ms"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert Chaos.from_config(config_from_dict({})) is None
    with pytest.raises(ValueError, match="unknown chaos seam"):
        Chaos(seams=("ingest",))
    # the reshard seams' keys are read, into the JAX plan's fields
    reshard = {"chaos_reshard_prewarm_delay_s": 0.5,
               "chaos_reshard_cutover_delay_s": 1.5,
               "chaos_reshard_append_fault_nth": 2}
    t = Chaos.from_config(config_from_dict(dict(raw, **reshard)))
    for k, v in reshard.items():
        setattr(jcfg, k, v)
    j = JChaos.from_config(jcfg)
    for attr in ("reshard_prewarm_delay_s", "reshard_cutover_delay_s",
                 "reshard_append_fault_nth"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for k in reshard:
        setattr(jcfg, k, 0)
    # the ingest seams' keys are read, into the JAX plan's fields
    raw.update(chaos_ingest_drop_rate=0.1, chaos_ingest_truncate_rate=0.2,
               chaos_ingest_duplicate_rate=0.3, chaos_ingest_rss_bytes=7,
               chaos_ledger_leak=5)
    t = Chaos.from_config(config_from_dict(raw))
    for k, v in raw.items():
        setattr(jcfg, k, 0.02 if k == "chaos_delay" else v)
    j = JChaos.from_config(jcfg)
    for attr in ("ingest_drop_rate", "ingest_truncate_rate",
                 "ingest_duplicate_rate", "ledger_leak"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.simulated_rss_bytes() == j.simulated_rss_bytes() == 7


def test_forward_send_seam_retries_then_carries_over():
    received = []
    ft = ForwardTestServer(received.extend)
    ft.start()
    server, _sink = _tserver(forward_address=ft.address,
                             chaos_enabled=True, chaos_error_rate=1.0,
                             chaos_seams=["forward_send"],
                             forward_retry_max_attempts=2,
                             forward_retry_base="1ms",
                             ledger_strict=True)
    try:
        assert chaos_mod.active() is server.chaos
        server.handle_packet_batch([b"cf:2|c|#veneurglobalonly"])
        server.flush()
        stats = server.stats_snapshot()
        assert stats["forward_retries"] == 1
        assert stats["carryover_depth"] == 1 and not received
        assert server.chaos.injected_errors["forward_send"] == 2
        server.chaos.enabled = False
        server.handle_packet_batch([b"cf:3|c|#veneurglobalonly"])
        server.flush()
        assert sum(m.counter.value for m in received) == 5
        assert all(not any(i.values())
                   for i in server.ledger.history_imbalances())
    finally:
        server.shutdown()
        ft.stop()
    assert chaos_mod.active() is None


class _Sink:
    """A duck-typed metric sink recording what it was given."""

    def __init__(self):
        self.batches = []

    def name(self):
        return "rec"

    def start(self, server):
        pass

    def stop(self):
        pass

    def flush(self, metrics):
        self.batches.append([m.name for m in metrics])

    def flush_other_samples(self, samples):
        pass


def test_sink_flush_seam_spills_for_one_retry():
    from veneur_tpu_torch.core.server import Server
    cfg = config_from_dict({"interval": "1h", "hostname": "t",
                            "chaos_enabled": True, "chaos_error_rate": 1.0,
                            "chaos_seams": ["sink_flush"]})
    sink = _Sink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink])
    # the server's own flush spans reach its span extraction, whose 1 in
    # 100 ssf.names_unique roll can add a row to the batch: off
    server.metric_extraction.uniqueness_rate = 0.0
    server.start()
    try:
        server.handle_packet_batch([b"sf:1|c"])
        server.flush()
        assert server.last_flush_timings["sink:rec"]["status"] == "error"
        assert server.stats_snapshot()[
            "flush.spill_pending#sink:metric:rec"] == 1
        server.chaos.enabled = False
        server.handle_packet_batch([b"sf2:1|c"])
        server.flush()
        assert sorted(sink.batches[-1]) == ["sf", "sf2"]
    finally:
        server.shutdown()


def test_http_post_seam_and_retry():
    chaos_mod.install(Chaos(error_rate=1.0, seams=("http_post",)))
    try:
        with pytest.raises(ChaosError):
            vhttp.post("http://127.0.0.1:1/x", b"{}")
        t0 = time.monotonic()
        with pytest.raises(ChaosError):
            vhttp.post_with_retry("http://127.0.0.1:1/x", b"{}",
                                  retry=RetryPolicy(max_attempts=3,
                                                    base_delay=0.001),
                                  budget=2.0)
        assert time.monotonic() - t0 < 2.0
        assert chaos_mod.active().injected_errors["http_post"] == 4
    finally:
        chaos_mod.install(None)


def test_health_probe_seam_ejects_deterministically():
    ft = ForwardTestServer(lambda ms: None)
    ft.start()
    dests = Destinations(flush_interval=0.1)
    dests.set_destinations([ft.address])
    health = RingHealth(dests, interval=0.05, unhealthy_after=2,
                        healthy_after=1)
    chaos_mod.install(Chaos(error_rate=1.0, seams=("health_probe",)))
    try:
        health.run_round()
        health.run_round()
        assert dests.ejected_addresses() == [ft.address]
        chaos_mod.install(None)
        health.run_round()
        assert dests.ejected_addresses() == []
        assert health.probe_failures_total == 2
    finally:
        chaos_mod.install(None)
        dests.clear()
        ft.stop()


def test_proxy_destination_forward_send_seam_opens_its_breaker():
    got = []
    ft = ForwardTestServer(got.extend)
    ft.start()
    closed = threading.Event()
    dests = Destinations(flush_interval=0.05, max_consecutive_failures=2)
    dests.set_destinations([ft.address])
    chaos_mod.install(Chaos(error_rate=1.0, seams=("forward_send",)))
    try:
        from veneur_tpu_torch.forward.protos import metric_pb2
        dest = dests._pool[ft.address]
        orig = dest._on_close
        dest._on_close = lambda d: (orig(d), closed.set())
        for i in range(2):
            m = metric_pb2.Metric(name=f"x{i}", type=metric_pb2.Counter)
            m.counter.value = 1
            assert dest.send(m)
            deadline = time.monotonic() + 5
            while dest.dropped_total <= i and time.monotonic() < deadline:
                time.sleep(0.01)
        assert closed.wait(5)
        totals = dests.flow_totals()
        assert totals["enqueued"] == totals["dropped_enqueued"] == 2
        assert not got
    finally:
        chaos_mod.install(None)
        dests.clear()
        ft.stop()
