"""The port's veneur-emit CLI (veneur_tpu_torch/cmd/veneur_emit.py)
against the JAX package's: for the same arguments both CLIs send the
same bytes — DogStatsD metrics, events and service checks over UDP and
TCP, SSF spans and SSF samples over UDP — with the clock pinned. The
JAX CLI's gRPC mode raises (it names enum values that metric.proto does
not define), so the port's metricpb Metrics, captured by a fake
/forwardrpc.Forward server, are held to the Metric the JAX package's
metric_pb2 builds for the same arguments. Also `-command` (its exit
code and its timer), the replay driver, and the CLI run as a subprocess
into a port server.
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import sys
import time
from concurrent import futures

import grpc
import pytest

from veneur_tpu.cmd import veneur_emit as jemit
from veneur_tpu.forward.protos import metric_pb2 as jmetric_pb2
from veneur_tpu_torch import ssf
from veneur_tpu_torch.cmd import veneur_emit as temit
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW_NS = 1_700_000_000_123_456_789


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: NOW_NS)
    monkeypatch.setattr(time, "time", lambda: NOW_NS / 1e9)


class _Receiver:
    """A UDP or TCP socket on 127.0.0.1 that collects what it is sent."""

    def __init__(self, scheme: str):
        self.scheme = scheme
        kind = socket.SOCK_DGRAM if scheme == "udp" else socket.SOCK_STREAM
        self.sock = socket.socket(socket.AF_INET, kind)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(10)
        if scheme == "tcp":
            self.sock.listen(4)

    @property
    def hostport(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.sock.getsockname()[1]}"

    def take(self) -> bytes:
        if self.scheme == "udp":
            return self.sock.recv(65536)
        conn, _ = self.sock.accept()
        with conn:
            conn.settimeout(10)
            out = b""
            while chunk := conn.recv(65536):
                out += chunk
            return out

    def close(self):
        self.sock.close()


ARGS = [
    ["-name", "a.b.c", "-count", "3", "-tag", "foo:bar", "-tag", "x"],
    ["-name", "g", "-gauge", "1.5", "-rate", "0.5"],
    ["-name", "t", "-timing", "30ms"],
    ["-name", "s", "-set", "member-1"],
    ["-mode", "event", "-e_title", "deploy", "-e_text", "v2 shipped",
     "-e_time", "1700000000", "-e_aggr_key", "k", "-e_priority", "low",
     "-e_alert_type", "info", "-e_event_tags", "a:b,c"],
    ["-mode", "sc", "-sc_name", "db.up", "-sc_status", "2",
     "-sc_msg", "down", "-sc_time", "2023-11-14T22:13:20",
     "-sc_tags", "svc:db"],
    ["-mode", "span", "-name", "op", "-span_service", "svc",
     "-span_duration", "0.25", "-trace_id", "5", "-parent_span_id", "3",
     "-span_tags", "a:b,c:d", "-indicator", "-error"],
    ["-mode", "span", "-name", "op2", "-span_starttime", "1700000000.5"],
    ["-ssf", "-name", "st", "-timing", "30ms", "-tag", "a:b"],
    ["-ssf", "-name", "sc", "-count", "2", "-rate", "0.25"],
    ["-ssf", "-name", "sg", "-gauge", "7"],
    ["-ssf", "-name", "ss", "-set", "u1"],
]


# SSF goes over UDP only, in both CLIs; DogStatsD over UDP and TCP
CASES = [(scheme, args) for args in ARGS for scheme in ("udp", "tcp")
         if scheme == "udp" or not ("-ssf" in args or "span" in args)]


@pytest.mark.parametrize("scheme,args", CASES, ids=lambda v: v if isinstance(
    v, str) else "_".join(x.strip("-") for x in v[:3]))
def test_emit_sends_the_jax_bytes(scheme, args, pinned_clock):
    got = []
    for emit in (jemit, temit):
        rx = _Receiver(scheme)
        try:
            assert emit.main(["-hostport", rx.hostport, *args]) == 0
            got.append(rx.take())
        finally:
            rx.close()
    assert got[0] == got[1]
    if "-ssf" in args or "span" in args:
        span = ssf.SSFSpan.FromString(got[1])
        assert span.end_timestamp > 0


class _ForwardFake:
    """A gRPC server taking /forwardrpc.Forward/SendMetricsV2; records the
    serialized metrics of each stream."""

    def __init__(self):
        self.streams = []
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=2))

        def send(request_iterator, context):
            self.streams.append([bytes(m) for m in request_iterator])
            return b""

        self._grpc.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("forwardrpc.Forward", {
                "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                    send, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)}),))
        self.port = self._grpc.add_insecure_port("127.0.0.1:0")
        self._grpc.start()

    def close(self):
        self._grpc.stop(0).wait()


@pytest.mark.parametrize("args,kind,value,tags", [
    (["-name", "grpc.c", "-count", "4", "-tag", "a:b"], "counter", 4,
     ["a:b"]),
    (["-name", "grpc.g", "-gauge", "2.5", "-proxy", "veneur.example"],
     "gauge", 2.5, []),
])
def test_grpc_mode_sends_the_metricpb_metric(args, kind, value, tags):
    fake = _ForwardFake()
    try:
        assert temit.main(["-grpc", "-hostport", f"127.0.0.1:{fake.port}",
                           *args]) == 0
    finally:
        fake.close()
    want = jmetric_pb2.Metric(name=args[1], scope=jmetric_pb2.Global,
                              tags=tags)
    if kind == "gauge":
        want.type = jmetric_pb2.Gauge
        want.gauge.value = value
    else:
        want.type = jmetric_pb2.Counter
        want.counter.value = value
    [metrics] = fake.streams
    assert [jmetric_pb2.Metric.FromString(m) for m in metrics] == [want]


def test_command_mode_propagates_the_exit_code_and_times_it():
    for code in (0, 3):
        rx = _Receiver("udp")
        try:
            rc = temit.main(["-hostport", rx.hostport, "-name", "job",
                             "-tag", "t:1", "-command", sys.executable,
                             "-c", f"import sys; sys.exit({code})"])
            packet = rx.take()
        finally:
            rx.close()
        assert rc == code
        name, rest = packet.split(b":", 1)
        assert name == b"job"
        value, kind, tags = rest.split(b"|")
        assert float(value) > 0 and kind == b"ms"
        assert tags == b"#t:1,status:%d" % code


def test_replay_paces_the_packet_and_refuses_tcp():
    rx = _Receiver("udp")
    try:
        sent, rate = temit.replay(rx.hostport, b"r:1|c", 2000.0, 0.05)
        assert sent > 0 and rate > 0
        assert rx.take() == b"r:1|c"
    finally:
        rx.close()
    with pytest.raises(ValueError, match="tcp"):
        temit.replay("tcp://127.0.0.1:1", b"r:1|c", 10.0, 0.01)


def test_cli_subprocesses_into_a_port_server():
    """The CLI as an operator runs it: a DogStatsD counter and an SSF
    timer into a port server's UDP listeners."""
    cfg = config_from_dict({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "ssf_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": "1h", "hostname": "test"})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(0))
    server.start()
    try:
        statsd = server.listen_addresses[0]
        ssf_addr = server.ssf_addresses[0]
        env = dict(os.environ, PYTHONPATH=REPO)
        for argv in (["-hostport", f"udp://127.0.0.1:{statsd[1]}",
                      "-name", "emit.c", "-count", "5"],
                     ["-ssf", "-hostport", f"udp://127.0.0.1:{ssf_addr[1]}",
                      "-name", "emit.t", "-timing", "40ms"]):
            subprocess.run([sys.executable, "-m",
                            "veneur_tpu_torch.cmd.veneur_emit", *argv],
                           check=True, cwd=REPO, env=env, timeout=120)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            stats = server.stats_snapshot()
            if stats["lines_received"] == 1 \
                    and stats["ssf_packets_received"] == 1:
                break
            time.sleep(0.01)
        server.drain_spans(timeout=20)
        server.flush()
        got = {m.name: m.value for m in sink.drain()}
    finally:
        server.shutdown()
    assert got["emit.c"] == 5.0
    assert got["emit.t.max"] == pytest.approx(40.0)
