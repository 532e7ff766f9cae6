"""The port's other ingest listeners against the JAX package's, on the
CPU: DogStatsD over TCP (plain and under mutual TLS, certificates made
with openssl as tests/test_ingest_planes.py:82 makes them), over a UNIX
datagram socket (a path and an `@` abstract name, through the native
reader and the numpy decoder), and DogStatsD packets and SSF spans over
gRPC (`SendPacket`, `SendSpan`). Each feeds the same numpy-seeded traffic
to a JAX server and a port server through their sockets and compares
the flushes: counters, gauges, sets and llhist registers exactly, timer
percentiles within the K1 tolerance of tests/test_pallas.py:97.

Every wait is bounded and counts what arrived; none waits for a quiet
period.
"""

from __future__ import annotations

import random
import socket
import ssl
import subprocess
import tempfile
import time

import grpc
import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu.util.secret import StringSecret as JSecret
from veneur_tpu_torch import ssf
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.protos import dogstatsd_pb2
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256, llhist_capacity=32)


def _lines(seed: int, n: int = 240):
    """DogStatsD lines of every family, `|l` included, seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 6
        v = float(np.round(rng.gamma(2.0, 20.0), 3))
        out.append([f"ip.c{i % 7}:{int(v) + 1}|c|#env:test",
                    f"ip.g{i % 5}:{v}|g",
                    f"ip.t{i % 4}:{v}|ms",
                    f"ip.s{i % 3}:m{int(rng.integers(40))}|s",
                    f"ip.l{i % 3}:{v}|l",
                    f"ip.c{i % 7}:2|c|@0.5|#env:test"][k].encode())
    return out


def _jax(**extra):
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.interval = 3600.0
    for key, value in SIZES.items():
        setattr(cfg.tpu, key, value)
    for key, value in extra.items():
        setattr(cfg, key, value)
    sink = JChannel()
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    server.metric_extraction._uniqueness_rate = 0.0
    return server, sink


def _port(**extra):
    tpu = dict(SIZES, **extra.pop("tpu", {}))
    cfg = config_from_dict({"hostname": "test", "interval": "1h",
                            "tpu": tpu, **extra})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(5))
    server.metric_extraction.uniqueness_rate = 0.0
    return server, sink


def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _rows(server, sink):
    """The flush as {(name, tags): value}, leaving out the JAX flush's
    own self-trace series (the port has no self-trace plane yet)."""
    server.flush()
    return {(m.name, tuple(m.tags)): m.value
            for m in sink.wait_flush(timeout=30)
            if "service:veneur-tpu" not in m.tags}


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if "percentile" in key[0] and not key[0].startswith("ip.l"):
            np.testing.assert_allclose(got[key], value, rtol=2e-5,
                                       atol=1e-4, err_msg=str(key))
        elif key[0].endswith(".sum"):
            # the llhist .sum is a dot product whose last bit follows the
            # flushed batch (in both packages)
            np.testing.assert_allclose(got[key], value, rtol=1e-12)
        else:
            assert got[key] == value, key


# -- TCP ----------------------------------------------------------------------


def _send_tcp(addr, lines, connections, wrap=None):
    for c in range(connections):
        raw = socket.create_connection(addr, timeout=10)
        conn = wrap(raw) if wrap is not None else raw
        with conn:
            conn.sendall(b"\n".join(lines[c::connections]) + b"\n")


def test_tcp_lines_flush_like_jax():
    lines = _lines(1)
    jserver, jsink = _jax(statsd_listen_addresses=["tcp://127.0.0.1:0"])
    tserver, tsink = _port(statsd_listen_addresses=["tcp://127.0.0.1:0"])
    jserver.start()
    tserver.start()
    try:
        _send_tcp(jserver.local_addr("tcp"), lines, 3)
        _send_tcp(tserver.listen_addresses[0], lines, 3)
        assert _wait_for(lambda: jserver.stats["packets_received"]
                         == len(lines))
        assert _wait_for(lambda: tserver.stats_snapshot()["lines_received"]
                         == len(lines))
        _assert_same(_rows(tserver, tsink), _rows(jserver, jsink))
    finally:
        tserver.shutdown()
        jserver.shutdown()


def test_overlong_tcp_line_closes_the_connection_and_counts():
    tserver, _ = _port(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                       metric_max_length=64)
    tserver.start()
    try:
        with socket.create_connection(tserver.listen_addresses[0],
                                      timeout=10) as conn:
            conn.sendall(b"ok:1|c\n" + b"x" * 200)
            assert conn.recv(1) == b""  # closed by the server
        assert _wait_for(lambda: tserver.stats_snapshot()[
            "tcp_overlong_dropped"] == 1)
        assert tserver.stats_snapshot()["lines_received"] == 1
    finally:
        tserver.shutdown()


def _openssl(*args):
    subprocess.run(["openssl", *args], check=True, capture_output=True,
                   timeout=60)


@pytest.fixture(scope="module")
def tls_certs(tmp_path_factory):
    """A self-signed CA, a server certificate for 127.0.0.1 and a client
    certificate (as tests/test_ingest_planes.py:82 makes them)."""
    d = tmp_path_factory.mktemp("tls")
    ca_key, ca_crt = d / "ca.key", d / "ca.crt"
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(ca_key), "-out", str(ca_crt),
             "-days", "1", "-subj", "/CN=test-ca")
    for who, cn in (("server", "127.0.0.1"), ("client", "test-client")):
        key, csr, crt = d / f"{who}.key", d / f"{who}.csr", d / f"{who}.crt"
        _openssl("req", "-newkey", "rsa:2048", "-nodes",
                 "-keyout", str(key), "-out", str(csr), "-subj", f"/CN={cn}")
        ext = d / f"{who}.ext"
        ext.write_text("subjectAltName=IP:127.0.0.1\n" if who == "server"
                       else "extendedKeyUsage=clientAuth\n")
        _openssl("x509", "-req", "-in", str(csr), "-CA", str(ca_crt),
                 "-CAkey", str(ca_key), "-CAcreateserial",
                 "-out", str(crt), "-days", "1", "-extfile", str(ext))
    return d


def _client_ctx(certs, with_cert: bool):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cafile=str(certs / "ca.crt"))
    if with_cert:
        ctx.load_cert_chain(str(certs / "client.crt"),
                            str(certs / "client.key"))
    return lambda raw: ctx.wrap_socket(raw, server_hostname="127.0.0.1")


def test_mutual_tls_tcp_flushes_like_jax(tls_certs):
    lines = _lines(2, 120)
    cert = (tls_certs / "server.crt").read_text()
    key = (tls_certs / "server.key").read_text()
    ca = (tls_certs / "ca.crt").read_text()
    jserver, jsink = _jax(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                          tls_certificate=cert, tls_key=JSecret(key),
                          tls_authority_certificate=ca)
    # the port takes file paths as well as inline PEM
    tserver, tsink = _port(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                           tls_certificate=str(tls_certs / "server.crt"),
                           tls_key=key,
                           tls_authority_certificate=str(
                               tls_certs / "ca.crt"))
    jserver.start()
    tserver.start()
    try:
        wrap = _client_ctx(tls_certs, with_cert=True)
        _send_tcp(jserver.local_addr("tcp"), lines, 2, wrap)
        _send_tcp(tserver.listen_addresses[0], lines, 2, wrap)
        # without a client certificate the handshake fails
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            conn = _client_ctx(tls_certs, with_cert=False)(
                socket.create_connection(tserver.listen_addresses[0],
                                         timeout=10))
            conn.sendall(b"refused:1|c\n")
            conn.recv(1)
        assert _wait_for(lambda: jserver.stats["packets_received"]
                         == len(lines))
        assert _wait_for(lambda: tserver.stats_snapshot()["lines_received"]
                         == len(lines))
        got, want = _rows(tserver, tsink), _rows(jserver, jsink)
        _assert_same(got, want)
        assert not any(k[0] == "refused" for k in got)
        assert tserver.config.tls_key.reveal() == key
    finally:
        tserver.shutdown()
        jserver.shutdown()


@pytest.mark.parametrize("raw", [
    {"tls_certificate": "cert.pem"},
    {"tls_key": "key.pem"},
    {"tls_authority_certificate": "ca.pem"},
])
def test_half_a_tls_configuration_raises(raw):
    tserver, _ = _port(statsd_listen_addresses=["tcp://127.0.0.1:0"], **raw)
    with pytest.raises(ValueError, match="tls_"):
        tserver.start()
    tserver.shutdown()


# -- UNIX datagrams -----------------------------------------------------------


@pytest.mark.parametrize("disable_native", [False, True],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("abstract", [False, True], ids=["path", "abstract"])
def test_unix_datagrams_flush_like_jax(disable_native, abstract):
    lines = _lines(3)
    with tempfile.TemporaryDirectory() as tmp:
        tag = f"{random.getrandbits(40):x}"

        def address(who):
            return (f"unixgram://@vt-{who}-{tag}" if abstract
                    else f"unixgram://{tmp}/{who}.sock")

        jserver, jsink = _jax(statsd_listen_addresses=[address("jax")])
        jserver.config.tpu.disable_native_parser = disable_native
        tserver, tsink = _port(statsd_listen_addresses=[address("port")],
                               tpu={"disable_native_parser": disable_native})
        jserver.start()
        tserver.start()
        try:
            for target in (jserver.local_addr("unixgram"),
                           tserver.listen_addresses[0]):
                with socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM) as tx:
                    for i in range(0, len(lines), 8):
                        tx.sendto(b"\n".join(lines[i:i + 8]), target)
            assert _wait_for(lambda: tserver.stats_snapshot()[
                "lines_received"] == len(lines))
            assert _wait_for(lambda: jserver.store.processed >= len(lines))
            _assert_same(_rows(tserver, tsink), _rows(jserver, jsink))
            if abstract:
                assert tserver.listen_addresses[0].startswith("\0")
        finally:
            tserver.shutdown()
            jserver.shutdown()


def test_unknown_statsd_scheme_raises_with_its_name():
    tserver, _ = _port(statsd_listen_addresses=["quic://127.0.0.1:0"])
    with pytest.raises(ValueError, match="quic"):
        tserver.start()
    tserver.shutdown()


# -- gRPC ---------------------------------------------------------------------


def _grpc_send(address, packets, spans):
    with grpc.insecure_channel(address) as chan:
        send_packet = chan.unary_unary(
            "/dogstatsd.DogstatsdGRPC/SendPacket",
            request_serializer=lambda body: dogstatsd_pb2.DogstatsdPacket(
                packetBytes=body).SerializeToString(),
            response_deserializer=lambda b: b)
        send_span = chan.unary_unary(
            "/ssf.SSFGRPC/SendSpan", request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        for p in packets:
            send_packet(p, timeout=10)
        for s in spans:
            send_span(s, timeout=10)


def test_grpc_send_packet_and_send_span_flush_like_jax():
    lines = _lines(4)
    packets = [b"\n".join(lines[i:i + 20]) for i in range(0, len(lines), 20)]
    spans = []
    for i in range(30):
        span = ssf.SSFSpan(id=i + 1, trace_id=i + 1, name="g",
                           service="grpc-svc", start_timestamp=10**18,
                           end_timestamp=10**18 + 7)
        span.metrics.append(ssf.count("grpc.count", 1, {"b": "2", "a": "1"}))
        span.metrics.append(ssf.gauge("grpc.gauge", float(i)))
        spans.append(span.SerializeToString())
    jserver, jsink = _jax(grpc_listen_addresses=["127.0.0.1:0"])
    tserver, tsink = _port(grpc_listen_addresses=["127.0.0.1:0"],
                           span_channel_capacity=1000)
    jserver.start()
    tserver.start()
    try:
        _grpc_send(jserver.grpc_ingest_servers[0].address, packets, spans)
        _grpc_send(tserver.grpc_ingest_servers[0].address, packets, spans)
        # each gRPC call returns after its packet parsed or its span is on
        # the channel; the JAX span workers count each span they extract
        assert _wait_for(lambda: jserver.metric_extraction.spans_processed
                         == len(spans))
        tserver.drain_spans(timeout=30)
        got, want = _rows(tserver, tsink), _rows(jserver, jsink)
        _assert_same(got, want)
        assert got[("grpc.count", ("a:1", "b:2"))] == 30.0
        assert got[("grpc.gauge", ())] == 29.0
        assert tserver.stats_snapshot()["ssf_packets_received"] == 30
    finally:
        tserver.shutdown()
        jserver.shutdown()


# -- the slice's config keys --------------------------------------------------


def test_the_slice_keys_parse_like_jax():
    from veneur_tpu.config import Config as JC
    raw = {"ssf_listen_addresses": ["udp://127.0.0.1:0"],
           "grpc_listen_addresses": ["127.0.0.1:0"],
           "tls_certificate": "c.pem", "tls_key": "k.pem",
           "tls_authority_certificate": "ca.pem",
           "span_sinks": [{"kind": "datadog", "name": "dd", "config": {}}],
           "num_span_workers": 4, "span_channel_capacity": 0,
           "span_sink_queue_capacity": 0,
           "indicator_span_timer_name": "sli",
           "objective_span_timer_name": "slo",
           "trace_max_length_bytes": 0}
    tcfg = config_from_dict(raw)
    jcfg = JC()
    for key in ("span_channel_capacity", "span_sink_queue_capacity",
                "trace_max_length_bytes"):
        setattr(jcfg, key, raw[key])
    jcfg.apply_defaults()
    for key in ("span_channel_capacity", "span_sink_queue_capacity",
                "trace_max_length_bytes"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.tls_key.reveal() == "k.pem" and str(tcfg.tls_key) != "k.pem"
    assert tcfg.span_sinks[0].kind == "datadog"
    assert (tcfg.num_span_workers, tcfg.indicator_span_timer_name,
            tcfg.objective_span_timer_name) == (4, "sli", "slo")
    assert tcfg.grpc_listen_addresses == ["127.0.0.1:0"]


def test_unknown_span_sink_kind_raises_with_its_name():
    with pytest.raises(ValueError, match="zipkin"):
        _port(span_sinks=[{"kind": "zipkin"}])
