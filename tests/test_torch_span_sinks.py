"""The port's span sinks against the JAX package's: each span sink of
both packages, built by its registered factory from the same config,
ingests the same numpy-seeded spans and flushes to a capturing fake of
its own on 127.0.0.1 (HTTP for datadog, splunk, lightstep and newrelic,
a UDP socket for xray, a gRPC server for falconer, an InMemoryProducer
for kafka), and what each fake received must be equal: the decoded
bodies, the datagrams, the serialized spans, the records. Also the span
halves of blackhole, debug and channel, the registry, and the sampling
of splunk, xray and kafka.
"""

from __future__ import annotations

import gzip
import json
import socket
import threading
import types
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc
import numpy as np
import pytest

from veneur_tpu import sinks as jsinks
from veneur_tpu.config import SinkConfig as JSinkConfig
from veneur_tpu.sinks import kafka as jkafka
from veneur_tpu_torch import sinks as tsinks
from veneur_tpu_torch import ssf
from veneur_tpu_torch.config import SinkConfig
from veneur_tpu_torch.sinks import kafka as tkafka
from veneur_tpu_torch.sinks.channel import ChannelSpanSink

jsinks.register_builtin_sinks()
tsinks.register_builtin_sinks()
SERVER_CONFIG = types.SimpleNamespace(hostname="h1", interval=10.0,
                                      num_workers=1)


class CapturingHTTPServer:
    """Records every request (method, path, headers, decoded body)."""

    def __init__(self):
        outer = self
        self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _capture(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "gzip":
                    body = gzip.decompress(body)
                headers = {k.lower(): v for k, v in self.headers.items()}
                outer.requests.append((self.command, self.path, headers,
                                       body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            do_POST = _capture  # noqa: N815
            do_PUT = _capture  # noqa: N815

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


def _spans(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        span = ssf.SSFSpan(
            id=int(rng.integers(1, 1 << 62)),
            trace_id=int(rng.integers(1, 1 << 62)) if i % 9 else 0,
            parent_id=int(rng.integers(0, 1 << 62)) if i % 3 else 0,
            start_timestamp=1_700_000_000_000_000_000 + i * 1000,
            end_timestamp=1_700_000_000_000_000_000 + i * 1000
            + int(rng.integers(0, 10**9)),
            name=f"op{i % 4}" if i % 7 else "", service=f"svc{i % 3}",
            error=bool(i % 5 == 0), indicator=bool(i % 4 == 0))
        if i % 2:
            span.tags["resource"] = f"/r{i % 3}"
        span.tags["zz"] = str(i)
        span.tags["aa"] = "x"
        if i % 6 == 0:
            span.root_start_timestamp = span.start_timestamp - 5 * 10**9
        out.append(span.SerializeToString())
    return out


def _build(kind, name, config):
    j = jsinks.SpanSinkTypes[kind](JSinkConfig(kind=kind, name=name,
                                               config=dict(config)),
                                   SERVER_CONFIG)
    t = tsinks.SpanSinkTypes[kind](SinkConfig(kind=kind, name=name,
                                              config=dict(config)),
                                   SERVER_CONFIG)
    return j, t


def _drive(sink, packets, via_many: bool):
    spans = [ssf.SSFSpan.FromString(p) for p in packets]
    sink.start(types.SimpleNamespace(statsd=None))
    if via_many:
        sink.ingest_many(spans)
    else:
        for span in spans:
            sink.ingest(span)
    sink.flush()


def _http_pair(kind, config_of, via_many=False, packets=None):
    """Each package's sink against its own fake; returns both fakes'
    requests with the decoded bodies."""
    packets = packets or _spans(1)
    fakes = CapturingHTTPServer(), CapturingHTTPServer()
    try:
        for fake, sink in zip(fakes, _build_each(kind, config_of, fakes)):
            _drive(sink, packets, via_many)
            sink.stop()
        return [[(m, p, b) for m, p, _h, b in f.requests] for f in fakes], \
            [[h for _m, _p, h, _b in f.requests] for f in fakes]
    finally:
        for fake in fakes:
            fake.close()


def _build_each(kind, config_of, fakes):
    j = jsinks.SpanSinkTypes[kind](JSinkConfig(
        kind=kind, name=kind, config=config_of(fakes[0].url)), SERVER_CONFIG)
    t = tsinks.SpanSinkTypes[kind](SinkConfig(
        kind=kind, name=kind, config=config_of(fakes[1].url)), SERVER_CONFIG)
    return j, t


@pytest.mark.parametrize("via_many", [False, True])
def test_datadog_traces_match_jax(via_many):
    (jreq, treq), _ = _http_pair(
        "datadog", lambda url: {"datadog_trace_api_address": url},
        via_many)
    assert jreq and treq == jreq
    method, path, body = treq[0]
    assert (method, path) == ("PUT", "/v0.3/traces")
    traces = json.loads(body)
    spans = [s for t in traces for s in t]
    assert len(spans) == len([p for p in _spans(1)
                              if ssf.SSFSpan.FromString(p).trace_id])
    assert {s["resource"] for s in spans} >= {"unknown", "/r1"}


def test_datadog_ring_overwrites_the_oldest_like_jax():
    (jreq, treq), _ = _http_pair(
        "datadog", lambda url: {"datadog_trace_api_address": url,
                                "datadog_span_buffer_size": 8})
    assert treq == jreq
    assert sum(len(t) for t in json.loads(treq[0][2])) == 8


@pytest.mark.parametrize("config", [
    {},
    {"span_sample_rate": 3},
    {"hec_batch_size": 7, "hec_submission_workers": 3},
])
def test_splunk_events_match_jax(config):
    (jreq, treq), (jh, th) = _http_pair(
        "splunk", lambda url: {"hec_address": url, "hec_token": "tok",
                               "hec_index": "idx", **config})
    # parallel submissions may arrive in any order
    assert sorted(treq) == sorted(jreq) and treq
    assert all(h["authorization"] == "Splunk tok" for h in th)
    events = [json.loads(line) for _m, _p, b in treq
              for line in b.splitlines()]
    assert {e["index"] for e in events} == {"idx"}


def test_lightstep_reports_match_jax():
    (jreq, treq), (jh, th) = _http_pair(
        "lightstep", lambda url: {"lightstep_collector_host": url,
                                  "lightstep_access_token": "tok",
                                  "lightstep_num_clients": 3})
    assert sorted(treq) == sorted(jreq) and len(treq) == 3
    assert all(h["lightstep-access-token"] == "tok" for h in th)


def test_newrelic_spans_match_jax():
    (jreq, treq), (jh, th) = _http_pair(
        "newrelic", lambda url: {"insert_key": "k", "trace_url":
                                 url + "/trace/v1",
                                 "common_tags": ["env:prod", "flag"]})
    assert treq == jreq and treq
    assert all(h["api-key"] == "k" for h in th)
    payload = json.loads(treq[0][2])
    assert payload[0]["common"]["attributes"]["env"] == "prod"


@pytest.mark.parametrize("percentage", [100.0, 40.0])
def test_xray_segments_match_jax(percentage):
    packets = _spans(2)
    got = []
    for package in (jsinks, tsinks):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
            rx.bind(("127.0.0.1", 0))
            rx.settimeout(10)
            host, port = rx.getsockname()
            cfg_cls = JSinkConfig if package is jsinks else SinkConfig
            sink = package.SpanSinkTypes["xray"](cfg_cls(
                kind="xray", name="xray", config={
                    "address": f"{host}:{port}",
                    "sample_percentage": percentage,
                    "annotation_tags": ["aa", "resource"]}), SERVER_CONFIG)
            _drive(sink, packets, False)
            dgrams = [rx.recv(65536) for _ in range(sink.spans_handled)]
            got.append((dgrams, sink.spans_handled, sink.spans_dropped))
            sink.stop()
    assert got[0] == got[1]
    assert got[1][0][0].startswith(b'{"format": "json", "version": 1}\n')


class _FalconerFake:
    """A gRPC server taking /falconer.SpanSink/SendSpan; records each
    request's bytes and trace-id metadata."""

    def __init__(self):
        self.received = []
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=2))

        def send(request, context):
            meta = dict(context.invocation_metadata())
            self.received.append((request, meta["x-veneur-trace-id"]))
            return b""

        self._grpc.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("falconer.SpanSink", {
                "SendSpan": grpc.unary_unary_rpc_method_handler(
                    send, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)}),))
        self.port = self._grpc.add_insecure_port("127.0.0.1:0")
        self._grpc.start()

    def close(self):
        self._grpc.stop(0).wait()


def test_falconer_sends_match_jax():
    packets = _spans(3)
    got = []
    for package, cfg_cls in ((jsinks, JSinkConfig), (tsinks, SinkConfig)):
        fake = _FalconerFake()
        try:
            sink = package.SpanSinkTypes["falconer"](cfg_cls(
                kind="falconer", name="falconer",
                config={"target": f"127.0.0.1:{fake.port}"}), SERVER_CONFIG)
            _drive(sink, packets, False)
            sink.stop()
            got.append((fake.received, sink.spans_handled, sink.errors))
        finally:
            fake.close()
    assert got[0] == got[1]
    assert got[1][1] > 0  # only valid traces are sent


@pytest.mark.parametrize("config", [
    {},
    {"span_serialization_format": "json"},
    {"span_sample_rate_percent": 30.0},
    {"span_sample_rate_percent": 50.0, "span_sample_tag": "resource"},
    {"span_buffer_max": 5},
])
def test_kafka_span_records_match_jax(config):
    packets = _spans(4)
    got = []
    for package, mod, cfg_cls in ((jsinks, jkafka, JSinkConfig),
                                  (tsinks, tkafka, SinkConfig)):
        producer = mod.InMemoryProducer()
        sink = package.SpanSinkTypes["kafka"](cfg_cls(
            kind="kafka", name="kafka", config={
                "producer": producer, "span_topic": "spans", **config}),
            SERVER_CONFIG)
        _drive(sink, packets, False)
        got.append((producer.messages, sink.dropped_total))
    assert got[0] == got[1] and got[1][0]
    if not config:
        # the protobuf records decode to the spans sent
        assert [ssf.SSFSpan.FromString(v) for _t, _k, v in got[1][0]] == \
            [ssf.SSFSpan.FromString(p) for p in packets]


def test_blackhole_debug_and_channel_span_halves():
    packets = _spans(5, 10)
    for kind in ("blackhole", "debug"):
        j, t = _build(kind, kind, {})
        for sink in (j, t):
            _drive(sink, packets, False)
        assert t.name() == j.name() == kind
    assert t.ingested_total == j.ingested_total == 10
    chan = ChannelSpanSink()
    _drive(chan, packets, True)
    chan.ingest(ssf.SSFSpan(id=77))
    chan.flush()
    assert chan.queue.get(timeout=5) == [ssf.SSFSpan.FromString(p)
                                         for p in packets]
    assert [s.id for s in chan.drain()] == [77]


def test_span_sink_registry_matches_jax():
    assert sorted(tsinks.SpanSinkTypes) == sorted(jsinks.SpanSinkTypes)


def test_flush_self_metrics_match_jax():
    """The span sink self-metrics (reference sinks.go:58-67) go to the
    bound statsd client with the JAX names and tags."""
    class Recorder:
        def __init__(self):
            self.calls = []

        def count(self, name, value, tags=()):
            self.calls.append(("count", name, value, tuple(tags)))

        def gauge(self, name, value, tags=()):
            self.calls.append(("gauge", name, tuple(tags)))

    got = []
    for package, mod, cfg_cls in ((jsinks, jkafka, JSinkConfig),
                                  (tsinks, tkafka, SinkConfig)):
        sink = package.SpanSinkTypes["kafka"](cfg_cls(
            kind="kafka", name="k", config={
                "producer": mod.InMemoryProducer(), "span_buffer_max": 3}),
            SERVER_CONFIG)
        rec = Recorder()
        sink.start(types.SimpleNamespace(statsd=rec))
        for p in _spans(6, 5):
            sink.ingest(ssf.SSFSpan.FromString(p))
        sink.flush()
        got.append(rec.calls)
    assert got[0] == got[1]
    assert ("count", "sink.spans_dropped_total", 2, ("sink:k",)) in got[1]
