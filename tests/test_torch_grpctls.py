"""mTLS on the port's forward plane, against the JAX package's, on the
CPU: the credential bundle's rules, a TLS local -> TLS global pair
(plaintext and certificate-less clients refused), TLS interop with the
JAX package's client and import server both ways, the proxy's dual
plaintext and TLS listeners, the proxy dialing TLS destinations, and the
import server's RPC stats. Certificates: tests/testdata/{ca,server,
client}.{pem,key}."""

from __future__ import annotations

import os
import time

import grpc
import pytest

from veneur_tpu.forward.client import ForwardClient as JClient
from veneur_tpu.forward.server import ImportServer as JImport
from veneur_tpu.util.grpcstats import RpcStats as JRpcStats
from veneur_tpu.util.grpctls import GrpcTLS as JTLS
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.httpapi import config_to_dict
from veneur_tpu_torch.forward.client import ForwardClient as TClient
from veneur_tpu_torch.forward.protos import metric_pb2 as tmetric_pb2
from veneur_tpu_torch.forward.wire import _frame_v1
from veneur_tpu_torch.proxy.proxy import create_static_proxy
from veneur_tpu_torch.util.grpcstats import RpcStats
from veneur_tpu_torch.util.grpctls import (RECONNECT_BACKOFF_OPTIONS, GrpcTLS,
                                           secure_or_insecure_channel)
from veneur_tpu_torch.util.secret import StringSecret

from test_torch_forward import (_fwd_rows, _jfwd, _series, _tfwd, _tserver)

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")


def td(name):
    return os.path.join(TESTDATA, name)


SERVER = dict(certificate=td("server.pem"), key=td("server.key"),
              authority=td("ca.pem"))
CLIENT = dict(certificate=td("client.pem"), key=td("client.key"),
              authority=td("ca.pem"))


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _counter(name, value):
    m = tmetric_pb2.Metric(name=name, type=tmetric_pb2.Counter,
                           scope=tmetric_pb2.Global)
    m.counter.value = value
    return m


def test_bundle_rules_match_jax():
    assert RECONNECT_BACKOFF_OPTIONS == \
        __import__("veneur_tpu.util.grpctls", fromlist=["x"]) \
        .RECONNECT_BACKOFF_OPTIONS
    assert not GrpcTLS() and not JTLS()
    assert GrpcTLS(authority=td("ca.pem"))
    with pytest.raises(ValueError, match="certificate and key"):
        GrpcTLS(certificate=td("server.pem")).server_credentials()
    with pytest.raises(ValueError, match="together"):
        GrpcTLS(certificate=td("client.pem")).channel_credentials()
    # inline PEM and StringSecret keys read as the files do
    with open(td("server.key")) as f:
        inline = GrpcTLS(certificate=td("server.pem"),
                         key=StringSecret(f.read()))
    assert inline.server_credentials() is not None


def test_tls_keys_are_accepted_and_redacted():
    cfg = config_from_dict({
        "grpc_tls_certificate": SERVER["certificate"],
        "grpc_tls_key": SERVER["key"],
        "grpc_tls_authority_certificate": SERVER["authority"],
        "forward_tls_certificate": CLIENT["certificate"],
        "forward_tls_key": CLIENT["key"],
        "forward_tls_authority_certificate": CLIENT["authority"]})
    assert cfg.grpc_tls_key.reveal() == SERVER["key"]
    dumped = config_to_dict(cfg)
    assert dumped["grpc_tls_key"] == "REDACTED"
    assert dumped["forward_tls_key"] == "REDACTED"
    assert dumped["grpc_tls_certificate"] == SERVER["certificate"]


def _tls_global(authority=True):
    tls = {"grpc_tls_certificate": SERVER["certificate"],
           "grpc_tls_key": SERVER["key"]}
    if authority:
        tls["grpc_tls_authority_certificate"] = SERVER["authority"]
    return _tserver(grpc_address="localhost:0", **tls)


def test_mutual_tls_local_global_pair():
    gserver, gsink = _tls_global()
    local, _ = _tserver(
        forward_address=gserver.import_server.address,
        forward_tls_certificate=CLIENT["certificate"],
        forward_tls_key=CLIENT["key"],
        forward_tls_authority_certificate=CLIENT["authority"],
        ledger_strict=True)
    try:
        local.handle_packet_batch([b"tls.c:7|c|#veneurglobalonly",
                                   b"tls.l:3|l"])
        local.flush()
        assert local.stats_snapshot()["forward_errors"] == 0
        assert local.forward_client.last_flow == {
            "received": 2, "merged": 2, "duplicate": False}
        gserver.flush()
        got = _series(gsink.drain())
        assert got[("tls.c", (), "COUNTER")] == 7.0
        assert got[("tls.l.count", (), "COUNTER")] == 1.0
    finally:
        local.shutdown()
        gserver.shutdown()


@pytest.mark.parametrize("client", ["plaintext", "no_certificate"])
def test_tls_import_server_refuses_the_wrong_client(client):
    gserver, _ = _tls_global()
    address = gserver.import_server.address
    tls = None if client == "plaintext" else GrpcTLS(
        authority=CLIENT["authority"])
    fc = TClient(address, deadline=3.0, tls=tls)
    try:
        body = _frame_v1(_counter("no.c", 1).SerializeToString())
        with pytest.raises(grpc.RpcError):
            fc._send_v1(body, timeout=3.0)
        assert gserver.import_server.imported_total == 0
    finally:
        fc.close()
        gserver.shutdown()


def test_jax_tls_client_into_port_tls_import_server():
    gserver, gsink = _tls_global()
    try:
        client = JClient(gserver.import_server.address, deadline=10.0,
                         tls=JTLS(**CLIENT))
        assert client.forward(_jfwd()) == len(_fwd_rows())
        client.close()
        assert gserver.import_server.imported_total == len(_fwd_rows())
    finally:
        gserver.shutdown()


def test_port_tls_client_into_jax_tls_import_server():
    from types import SimpleNamespace
    from veneur_tpu.core.columnstore import ColumnStore as JStore
    from test_torch_forward import SIZES
    store = JStore(**SIZES)
    imp = JImport(SimpleNamespace(store=store), "localhost:0",
                  tls=JTLS(**SERVER))
    imp.start()
    try:
        client = TClient(f"localhost:{imp.port}", deadline=10.0,
                         tls=GrpcTLS(**CLIENT))
        assert client.forward(_tfwd()) == len(_fwd_rows())
        assert client.last_flow["merged"] == len(_fwd_rows())
        client.close()
    finally:
        imp.stop()


def test_proxy_serves_plaintext_and_tls_listeners_at_once():
    gserver, gsink = _tserver(grpc_address="127.0.0.1:0")
    proxy = create_static_proxy(
        [gserver.import_server.address], listen_address="localhost:0",
        tls=GrpcTLS(**SERVER), tls_listen_address="localhost:0",
        health_check_interval=0)
    proxy.start()
    try:
        assert proxy.port and proxy.tls_port and proxy.port != proxy.tls_port
        plain = TClient(f"localhost:{proxy.port}", deadline=5.0)
        secure = TClient(f"localhost:{proxy.tls_port}", deadline=5.0,
                         tls=GrpcTLS(**CLIENT))
        plain._send_v1(_frame_v1(_counter("dual.p", 2).SerializeToString()),
                       timeout=5.0)
        secure._send_v1(_frame_v1(_counter("dual.s", 3).SerializeToString()),
                        timeout=5.0)
        # the TLS port does not speak plaintext
        wrong = TClient(f"localhost:{proxy.tls_port}", deadline=3.0)
        with pytest.raises(grpc.RpcError):
            wrong._send_v1(_frame_v1(_counter("x", 1).SerializeToString()),
                           timeout=3.0)
        for c in (plain, secure, wrong):
            c.close()
        assert _wait_for(lambda: gserver.import_server.imported_total == 2)
        gserver.flush()
        got = _series(gsink.drain())
        assert got[("dual.p", (), "COUNTER")] == 2.0
        assert got[("dual.s", (), "COUNTER")] == 3.0
        assert proxy.stats["received_total"] == 2
    finally:
        proxy.stop()
        gserver.shutdown()


def test_proxy_dials_tls_destinations():
    gserver, gsink = _tls_global()
    proxy = create_static_proxy([gserver.import_server.address],
                                destination_tls=GrpcTLS(**CLIENT),
                                health_check_interval=0)
    proxy.start()
    try:
        client = TClient(proxy.address, deadline=5.0)
        client._send_v1(_frame_v1(_counter("pt.c", 9).SerializeToString()),
                        timeout=5.0)
        client.close()
        assert _wait_for(lambda: gserver.import_server.imported_total == 1)
        gserver.flush()
        assert _series(gsink.drain())[("pt.c", (), "COUNTER")] == 9.0
    finally:
        proxy.stop()
        gserver.shutdown()


def test_half_configured_proxy_tls_raises():
    with pytest.raises(ValueError, match="grpc_tls_address"):
        create_static_proxy(["127.0.0.1:1"], tls_listen_address="localhost:0",
                            health_check_interval=0)


def test_rpc_stats_match_jax_and_count_the_import_server():
    t, j = RpcStats(), JRpcStats()
    for stats in (t, j):
        stats.record("SendMetrics", 0.25, ok=True)
        stats.record("SendMetrics", 0.5, ok=False)
        stats.record("SendMetricsV2", 0.125, ok=True)
    assert t.snapshot() == j.snapshot()
    assert t.drain() == j.drain() and t.snapshot() == {}
    rows = {(r[0], tuple(r[3])): r[2]
            for r in t.telemetry_rows(prefix="import.rpc")}
    assert rows[("import.rpc.calls", ("method:SendMetrics",))] == 2.0
    assert rows[("import.rpc.failed", ("method:SendMetrics",))] == 1.0
    assert rows[("import.rpc.seconds", ("method:SendMetrics",))] == 0.75
    gserver, _ = _tserver(grpc_address="127.0.0.1:0")
    try:
        client = TClient(gserver.import_server.address, deadline=5.0)
        client._send_v1(_frame_v1(_counter("rs.c", 1).SerializeToString()),
                        timeout=5.0)
        client.close()
        snap = gserver.import_server.rpc_stats.snapshot()
        assert snap["SendMetrics"]["count"] == 1
        names = {r[0] for r in gserver.import_server.telemetry_rows()}
        assert "import.rpc.calls" in names
    finally:
        gserver.shutdown()


def test_secure_channel_is_dialed_only_with_tls():
    ch = secure_or_insecure_channel("127.0.0.1:1", None)
    assert isinstance(ch, grpc.Channel)
    ch.close()
    ch = secure_or_insecure_channel("localhost:1", GrpcTLS(**CLIENT),
                                    options=list(RECONNECT_BACKOFF_OPTIONS))
    assert isinstance(ch, grpc.Channel)
    ch.close()
