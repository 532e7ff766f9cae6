"""The port's metric sinks against the JAX package's: each sink of both
packages gets the same InterMetric list (and the same events), each
posts to its own capturing fake on 127.0.0.1 (the httptest pattern of
tests/test_sinks.py), and the captured bodies must be equal — decoded
JSON for datadog, signalfx and newrelic, the exposition text and the
repeater's datagrams for prometheus, the decoded remote-write for
cortex, the TSV for localfile, the query and its SigV4 signature at a
pinned time for cloudwatch, and the objects and messages of the JAX
tests' fakes for s3 and kafka. Also the registry and the sink config
keys."""

from __future__ import annotations

import datetime
import functools
import gzip
import json
import socket
import threading
import time
import types
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veneur_tpu.samplers.metrics import InterMetric as JInterMetric
from veneur_tpu.samplers.metrics import MetricType as JMetricType
from veneur_tpu.samplers.parser import Event as JEvent
from veneur_tpu.util import http as jhttp
from veneur_tpu_torch import sinks as tsinks
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType
from veneur_tpu_torch.samplers.parser import EVENT_IDENTIFIER_KEY, Event
from veneur_tpu_torch.util import http as thttp


class CapturingHTTPServer:
    """Records every request (path, headers, body) and returns 200."""

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
                outer.requests.append(
                    (self.path, dict(self.headers), body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            do_GET = do_POST  # noqa: N815
            do_PUT = do_POST  # noqa: N815

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


@pytest.fixture
def fakes():
    pair = CapturingHTTPServer(), CapturingHTTPServer()
    yield pair
    for fake in pair:
        fake.close()


_METRICS = [
    dict(name="a.b.c", value=50.0, type="COUNTER",
         tags=["a:b", "host:other", "device:sda", "customer:acme"]),
    dict(name="g1", value=7.25, type="GAUGE", tags=["env:prod", "shard:3"]),
    dict(name="db.queries", value=3.0, type="COUNTER",
         tags=["shard:3", "env:prod", "noisy:x", "multihost:yes"]),
    dict(name="veneur.flush.total", value=1.0, type="COUNTER", tags=[]),
    dict(name="h.99percentile", value=0.125, type="GAUGE",
         tags=["bad-label:x", "cloudwatch_standard_unit:Seconds"]),
    dict(name="check.up", value=2.0, type="STATUS", tags=["svc:web"],
         message="oh no"),
    dict(name="noattr", value=4.0, type="GAUGE", tags=["flag"],
         hostname=""),
]


def _metrics(cls, types_):
    return [cls(name=m["name"], timestamp=1_700_000_000, value=m["value"],
                tags=list(m["tags"]), type=types_[m["type"]],
                message=m.get("message", ""),
                hostname=m.get("hostname", "h1")) for m in _METRICS]


def _events(cls):
    return [cls(name="deploy", message="%%% \nv2 shipped\n %%%",
                timestamp=123, tags={EVENT_IDENTIFIER_KEY: "",
                                     "alert_type": "warning",
                                     "env": "prod"})]


JAX = (JInterMetric, JMetricType.__members__, JEvent)
TORCH = (InterMetric, MetricType.__members__, Event)


def _flush_both(make, fakes, events=True):
    """Build each package's sink with `make(pkg, url)`, flush the same
    metrics and events into it, and return both packages' requests
    (`fakes` of one server: both post to it, one after the other)."""
    out = []
    for i, (pkg, (cls, types_, ev)) in enumerate(zip(("jax", "torch"),
                                                     (JAX, TORCH))):
        fake = fakes[i % len(fakes)]
        seen = len(fake.requests)
        sink = make(pkg, fake.url)
        sink.flush(_metrics(cls, types_))
        if events:
            sink.flush_other_samples(_events(ev))
        out.append(fake.requests[seen:])
    return out


def _by_path(requests):
    """(path, decoded JSON) pairs in a fixed order."""
    return sorted(((path, json.loads(body)) for path, _h, body in requests),
                  key=lambda r: (r[0], json.dumps(r[1])))


def _mod(pkg, name):
    root = "veneur_tpu" if pkg == "jax" else "veneur_tpu_torch"
    return __import__(f"{root}.sinks.{name}", fromlist=["_"])


# -- the HTTP JSON sinks -----------------------------------------------------


def test_datadog_bodies_equal_jax(fakes):
    def make(pkg, url):
        return _mod(pkg, "datadog").DatadogMetricSink(
            "datadog", api_key="k", api_url=url, hostname="dh",
            interval=10.0, flush_max_per_body=2, num_workers=1,
            tags=["glob:t"], metric_name_prefix_drops=["veneur."],
            excluded_tag_prefixes=["noisy"],
            exclude_tags_prefix_by_prefix_metric={"db.": ["shard"]})
    jreq, treq = _flush_both(make, fakes)
    assert _by_path(treq) == _by_path(jreq)
    paths = [p.split("?")[0] for p, _h, _b in treq]
    assert sorted(paths) == ["/api/v1/check_run", "/api/v1/series",
                             "/api/v1/series", "/api/v1/series", "/intake"]


def test_signalfx_bodies_equal_jax(fakes):
    def make(pkg, url):
        return _mod(pkg, "signalfx").SignalFxMetricSink(
            "signalfx", api_key="default-tok", endpoint=url, hostname="sh",
            vary_key_by="customer", per_tag_tokens={"acme": "acme-tok"},
            excluded_tags=["noisy"], drop_host_with_tag_key="multihost",
            flush_max_per_body=3)

    def tokens(requests):
        return sorted((p, {k.lower(): v for k, v in h.items()}["x-sf-token"],
                       json.dumps(json.loads(b), sort_keys=True))
                      for p, h, b in requests)
    jreq, treq = _flush_both(make, fakes)
    assert tokens(treq) == tokens(jreq)
    assert {t[1] for t in tokens(treq)} == {"acme-tok", "default-tok"}


def test_newrelic_bodies_equal_jax(fakes):
    def make(pkg, url):
        return _mod(pkg, "newrelic").NewRelicMetricSink(
            "newrelic", insert_key="ik", hostname="nh", interval=10.0,
            metric_url=url + "/metric/v1", tags=["team:core"],
            account_id=7, event_url=url + "/events")
    jreq, treq = _flush_both(make, fakes)
    assert _by_path(treq) == _by_path(jreq)
    assert {p for p, _h, _b in treq} == {"/metric/v1", "/events"}


def test_cortex_remote_write_equal_jax(fakes):
    def make(pkg, url):
        return _mod(pkg, "cortex").CortexMetricSink(
            "cortex", url=url + "/push", hostname="ch", auth_token="tok",
            batch_write_size=2, excluded_tags=["noisy"])

    def decoded(requests, http, cortex):
        return [(h["Content-Encoding"], h["Authorization"],
                 cortex.decode_write_request(http.snappy_decode(b)))
                for _p, h, b in requests]
    jreq, treq = _flush_both(make, fakes, events=False)
    want = decoded(jreq, jhttp, _mod("jax", "cortex"))
    assert decoded(treq, thttp, _mod("torch", "cortex")) == want
    assert [b for _p, _h, b in treq] == [b for _p, _h, b in jreq]
    assert len(treq) == 3  # six series, two per body


def test_cloudwatch_query_and_signature_equal_jax(fakes, monkeypatch):
    pinned = datetime.datetime(2026, 1, 2, 3, 4, 5,
                               tzinfo=datetime.timezone.utc)
    for pkg in ("jax", "torch"):
        mod = _mod(pkg, "cloudwatch")
        monkeypatch.setattr(mod, "sigv4_headers", functools.partial(
            mod.sigv4_headers, now=pinned))

    def make(pkg, url):
        return _mod(pkg, "cloudwatch").CloudWatchMetricSink(
            "cloudwatch", endpoint=url + "/", namespace="ns",
            region="us-east-1", credentials=("AKID", "SECRET"))
    # one fake for both: the signature covers the host and port
    jreq, treq = _flush_both(make, fakes[:1], events=False)

    def signed(requests):
        return [(urllib.parse.parse_qsl(b.decode()), h["Authorization"],
                 h["X-Amz-Date"]) for _p, h, b in requests]
    assert signed(treq) == signed(jreq)
    params = dict(signed(treq)[0][0])
    assert params["MetricData.member.5.Unit"] == "Seconds"
    assert signed(treq)[0][2] == "20260102T030405Z"


# -- prometheus: exposition and the repeater ---------------------------------


@pytest.mark.parametrize("network", ["udp", "tcp"])
def test_prometheus_exposition_and_repeater_equal_jax(network):
    got = []
    for cls, types_, _ev in (JAX, TORCH):
        pkg = "jax" if cls is JInterMetric else "torch"
        kind = (socket.SOCK_DGRAM if network == "udp"
                else socket.SOCK_STREAM)
        recv = socket.socket(socket.AF_INET, kind)
        recv.bind(("127.0.0.1", 0))
        recv.settimeout(5.0)
        if network == "tcp":
            recv.listen(1)
        port = recv.getsockname()[1]
        sink = _mod(pkg, "prometheus").PrometheusMetricSink(
            "prometheus", repeater_address=f"127.0.0.1:{port}",
            network=network, expose_address="127.0.0.1:0")
        sink.start(None)
        try:
            sink.flush(_metrics(cls, types_))
            if network == "udp":
                data, _ = recv.recvfrom(65536)
            else:
                conn, _ = recv.accept()
                with conn:
                    conn.settimeout(5.0)
                    data = b""
                    while not data.endswith(b"\n"):
                        data += conn.recv(65536)
            status, body = thttp.get(
                f"http://127.0.0.1:{sink.expose_port}/metrics")
            assert status == 200
            got.append((data, body))
        finally:
            sink.stop()
            recv.close()
    assert got[1] == got[0]
    assert b"a_b_c{" in got[1][1] and b"check_up" not in got[1][1]


# -- localfile, s3 and kafka -------------------------------------------------


def test_localfile_tsv_equal_jax(tmp_path):
    rows = []
    for pkg, (cls, types_, _ev) in zip(("jax", "torch"), (JAX, TORCH)):
        path = tmp_path / f"{pkg}.tsv"
        sink = _mod(pkg, "localfile").LocalFileSink(
            "localfile", path=str(path), hostname="lh", interval=10.0)
        sink.flush(_metrics(cls, types_))
        sink.flush([])  # nothing: no write
        rows.append(path.read_text())
    assert rows[1] == rows[0]
    assert rows[1].count("\n") == len(_METRICS)


def test_s3_objects_equal_jax(monkeypatch):
    objects = []
    for pkg, (cls, types_, _ev) in zip(("jax", "torch"), (JAX, TORCH)):
        mod = _mod(pkg, "s3")
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1_700_000_005.5, strftime=time.strftime))
        uploader = mod.InMemoryUploader()
        mod.S3MetricSink("s3", uploader, bucket="b", hostname="s3h",
                         interval=10.0).flush(_metrics(cls, types_))
        objects.append([(b, k, gzip.decompress(body))
                        for b, k, body in uploader.objects])
    assert objects[1] == objects[0]
    assert objects[1][0][1] == "s3h/1700000005.tsv.gz"


def test_kafka_messages_equal_jax():
    messages = []
    for pkg, (cls, types_, ev) in zip(("jax", "torch"), (JAX, TORCH)):
        mod = _mod(pkg, "kafka")
        producer = mod.InMemoryProducer()
        sink = mod.KafkaMetricSink("kafka", producer, metric_topic="metrics",
                                   check_topic="checks",
                                   event_topic="events")
        sink.flush(_metrics(cls, types_))
        sink.flush_other_samples(_events(ev))
        messages.append(producer.messages)
    assert messages[1] == messages[0]
    assert [m[0] for m in messages[1]].count("checks") == 1


def test_kafka_and_s3_import_their_clients_only_when_used():
    """boto3 and kafka-python are imported by the transports, not by the
    modules: without them the factories still build a sink, with no
    transport (the JAX package's behaviour)."""
    cfg = config_from_dict({"hostname": "h", "metric_sinks": [
        {"kind": "kafka", "config": {"metric_topic": "m"}},
        {"kind": "s3", "config": {"s3_bucket": "b"}}]})
    tsinks.register_builtin_sinks()
    built = [tsinks.MetricSinkTypes[sc.kind](sc, cfg)
             for sc in cfg.metric_sinks]
    assert [s.kind() for s in built] == ["kafka", "s3"]
    for s in built:
        s.flush(_metrics(*TORCH[:2]))  # no transport: nothing sent


# -- registry and config -----------------------------------------------------


PORTED = ["blackhole", "channel", "cloudwatch", "cortex", "datadog", "debug",
          "kafka", "localfile", "newrelic", "prometheus", "s3", "signalfx"]


def test_registry_holds_every_ported_metric_sink():
    from veneur_tpu import sinks as jsinks
    jsinks.register_builtin_sinks()
    tsinks.register_builtin_sinks()
    assert sorted(tsinks.MetricSinkTypes) == PORTED
    # every JAX metric sink kind is ported
    assert set(jsinks.MetricSinkTypes) <= set(PORTED)


@pytest.mark.parametrize("kind", PORTED)
def test_every_kind_starts_a_port_server(kind, tmp_path):
    from veneur_tpu_torch.core.server import Server
    config = {"expose_address": "127.0.0.1:0"} if kind == "prometheus" \
        else {"flush_file": str(tmp_path / "f.tsv")}
    cfg = config_from_dict({"interval": "1h", "hostname": "h",
                            "metric_sinks": [{"kind": kind, "name": kind,
                                              "config": config}]})
    server = Server(cfg, device="cpu")
    server.start()
    try:
        assert [s.kind() for s in server.metric_sinks] == [kind]
    finally:
        server.shutdown()


def test_sink_config_keys_parse_like_jax():
    from veneur_tpu.config import read_config as jread
    raw = {
        "num_workers": 3,
        "features": {"enable_metric_sink_routing": True},
        "metric_sinks": [{"kind": "datadog", "name": "dd",
                          "max_name_length": 9, "max_tag_length": 8,
                          "max_tags": 2, "add_tags": {"team": "core"},
                          "strip_tags": [{"kind": "prefix",
                                          "value": "tmp"}]}],
        "metric_sink_routing": [{
            "name": "r", "match": [{"name": {"kind": "prefix",
                                             "value": "a."}}],
            "sinks": {"matched": ["dd"], "not_matched": []}}],
    }
    tcfg, jcfg = config_from_dict(dict(raw)), jread(overrides=dict(raw))
    assert tcfg.num_workers == jcfg.num_workers == 3
    assert (tcfg.features.enable_metric_sink_routing
            is jcfg.features.enable_metric_sink_routing is True)
    for field in ("kind", "name", "max_name_length", "max_tag_length",
                  "max_tags", "add_tags", "strip_tags"):
        assert (getattr(tcfg.metric_sinks[0], field)
                == getattr(jcfg.metric_sinks[0], field)), field
    for field in ("name", "match", "matched", "not_matched"):
        assert (getattr(tcfg.metric_sink_routing[0], field)
                == getattr(jcfg.metric_sink_routing[0], field)), field


@pytest.mark.parametrize("raw,key", [
    ({"features": {"proxy_enabled": True}}, "proxy_enabled"),
    ({"span_sinks": []}, "span_sinks"),
    ({"metric_sinks": [{"kind": "datadog", "flush_timeout": 1}]},
     "flush_timeout"),
    ({"metric_sink_routing": [{"name": "r", "drop": True}]}, "drop"),
    ({"metric_sink_routing": [{"sinks": {"maybe": []}}]}, "maybe"),
])
def test_keys_the_port_lacks_raise_with_their_name(raw, key):
    with pytest.raises(ValueError, match=key):
        config_from_dict(raw)
