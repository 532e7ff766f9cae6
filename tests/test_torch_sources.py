"""The port's pull sources against the JAX package's: the protobuf and
JSON decoders, both cumulative -> delta caches (with the downscale and
reset rules), the llhist weight chunking, the OTLP/HTTP answers, the
OpenMetrics parse and scrape, veneur-prometheus's flags and packets, and
servers with `sources:` whose flushes equal the JAX server's on the same
payloads (numpy-seeded)."""

from __future__ import annotations

import gzip
import json
import random
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.config import SourceConfig as JSourceConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.cmd import veneur_prometheus as jax_prom
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu import sources as jax_sources
from veneur_tpu.sources import openmetrics as jax_om
from veneur_tpu.sources import otlp as jax_otlp
from veneur_tpu.util import protowire as jax_wire
from veneur_tpu_torch.cmd import veneur_prometheus as port_prom
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink
from veneur_tpu_torch import sources as port_sources
from veneur_tpu_torch.sources import openmetrics as port_om
from veneur_tpu_torch.sources import otlp as port_otlp
from veneur_tpu_torch.util import protowire as port_wire

SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256, llhist_capacity=32)
DELTA = port_otlp.TEMPORALITY_DELTA
CUMULATIVE = port_otlp.TEMPORALITY_CUMULATIVE


# -- a protobuf writer for ExportMetricsServiceRequest (tests/test_otlp.py)

def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value)


def _f64(field: int, value: float) -> bytes:
    return bytes([(field << 3) | 1]) + struct.pack("<d", value)


def _zz(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _kv(key: str, value: str) -> bytes:
    return _ld(1, key.encode()) + _ld(2, _ld(1, value.encode()))


def _number_point(value: float, attrs=(), as_int: bool = False) -> bytes:
    out = b"".join(_ld(7, _kv(k, v)) for k, v in attrs)
    if as_int:
        return out + bytes([(6 << 3) | 1]) + struct.pack("<q", int(value))
    return out + _f64(4, value)


def _ehist_point(scale, zero_count, pos, neg, attrs=()) -> bytes:
    out = b"".join(_ld(1, _kv(k, v)) for k, v in attrs)
    out += _vi(6, _zz(scale))
    out += bytes([(7 << 3) | 1]) + struct.pack("<Q", zero_count)
    for field, (offset, counts) in ((8, pos), (9, neg)):
        out += _ld(field, _vi(1, _zz(offset))
                   + _ld(2, b"".join(_varint(c) for c in counts)))
    return out


def _metric(name: str, kind: str, points, temporality=CUMULATIVE,
            monotonic=True) -> bytes:
    body = b"".join(_ld(1, p) for p in points)
    if kind == "gauge":
        return _ld(1, name.encode()) + _ld(5, body)
    if kind == "sum":
        body += _vi(2, temporality) + _vi(3, 1 if monotonic else 0)
        return _ld(1, name.encode()) + _ld(7, body)
    body += _vi(2, temporality)
    return _ld(1, name.encode()) + _ld(10, body)


def _request(*metrics: bytes) -> bytes:
    return _ld(1, _ld(2, b"".join(_ld(2, mm) for mm in metrics)))


def _ehist(rng, scale: int):
    """One exponential-histogram point's (offset, counts) pairs, seeded."""
    pos = (int(rng.integers(-40, 40)),
           [int(c) for c in rng.integers(0, 50, int(rng.integers(1, 12)))])
    neg = (int(rng.integers(-10, 10)),
           [int(c) for c in rng.integers(0, 9, int(rng.integers(0, 4)))])
    return {"attrs": {"svc": f"s{int(rng.integers(3))}"}, "scale": scale,
            "zero_count": int(rng.integers(0, 5)), "pos": pos, "neg": neg}


def _ehist_bytes(pt) -> bytes:
    return _ehist_point(pt["scale"], pt["zero_count"], pt["pos"], pt["neg"],
                        sorted(pt["attrs"].items()))


def _payload(seed: int) -> bytes:
    """A request with every kind the decoder takes, seeded."""
    rng = np.random.default_rng(seed)
    metrics = [
        _metric("cpu", "gauge", [
            _number_point(float(rng.normal()), [("core", str(i))])
            for i in range(3)]),
        _metric("reqs", "sum", [
            _number_point(int(rng.integers(1, 1000)), [("code", c)],
                          as_int=True) for c in ("200", "500")]),
        _metric("inflight", "sum", [_number_point(3.5)], monotonic=False),
        _metric("delta.reqs", "sum", [_number_point(7.0)],
                temporality=DELTA),
        _metric("lat", "ehist", [_ehist_bytes(_ehist(rng, 3))
                                 for _ in range(2)]),
        _ld(1, b"h") + _ld(9, b""),   # an explicit-bounds histogram
        _ld(1, b"s") + _ld(11, b""),  # a summary
    ]
    return _request(*metrics)


def _json_payload(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    pt = _ehist(rng, 2)
    doc = {"resourceMetrics": [{"scopeMetrics": [{"metrics": [
        {"name": "cpu", "gauge": {"dataPoints": [
            {"asDouble": float(rng.normal()),
             "attributes": [{"key": "core", "value": {"intValue": "0"}},
                            {"key": "ok", "value": {"boolValue": True}},
                            {"key": "f", "value": {"doubleValue": 0.25}}]}]}},
        {"name": "reqs", "sum": {
            "isMonotonic": True,
            "aggregationTemporality": "AGGREGATION_TEMPORALITY_CUMULATIVE",
            "dataPoints": [{"asInt": str(int(rng.integers(1, 99)))}]}},
        {"name": "lat", "exponentialHistogram": {
            "aggregationTemporality": 2,
            "dataPoints": [{
                "scale": pt["scale"], "zeroCount": str(pt["zero_count"]),
                "attributes": [{"key": "svc",
                                "value": {"stringValue": "api"}}],
                "positive": {"offset": pt["pos"][0],
                             "bucketCounts": [str(c) for c in pt["pos"][1]]},
                "negative": {"offset": pt["neg"][0],
                             "bucketCounts": [str(c)
                                              for c in pt["neg"][1]]}}]}},
        {"name": "h", "histogram": {}},
    ]}]}]}
    return json.dumps(doc).encode()


# -- the wire reader and the decoders ------------------------------------


@pytest.mark.parametrize("buf", [
    _varint(300) + _varint(2**63), _ld(3, b"abc") + _vi(1, 5),
    bytes([(2 << 3) | 1]) + b"12345678" + bytes([(4 << 3) | 5]) + b"abcd"],
    ids=["varints", "length-delimited", "fixed"])
def test_protowire_matches_jax(buf):
    assert list(port_wire.read_fields(_ld(1, buf))) == \
        list(jax_wire.read_fields(_ld(1, buf)))
    assert port_wire.get_varint(buf, 0) == jax_wire.get_varint(buf, 0)
    assert [port_wire.zigzag(v) for v in range(-5, 6)] == \
        [jax_wire.zigzag(v) for v in range(-5, 6)]


@pytest.mark.parametrize("buf", [b"\x80", _ld(1, b"x")[:-1],
                                 bytes([(1 << 3) | 3])],
                         ids=["truncated-varint", "truncated-field",
                              "wire-type-3"])
def test_protowire_errors_match_jax(buf):
    with pytest.raises(jax_wire.WireError):
        list(jax_wire.read_fields(buf))
    with pytest.raises(port_wire.WireError):
        list(port_wire.read_fields(buf))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_protobuf_and_json_decoders_match_jax(seed):
    body = _payload(seed)
    assert list(port_otlp.parse_export_request(body)) == \
        list(jax_otlp.parse_export_request(body))
    doc = _json_payload(seed)
    assert list(port_otlp.parse_export_json(doc)) == \
        list(jax_otlp.parse_export_json(doc))


# -- the delta caches -------------------------------------------------------


@pytest.mark.parametrize("values", [
    [100.0, 130.0, 130.0, 7.0, -50.0, -20.0],
    [1.0, 2.0, 0.5, 0.5, 9.0],
])
def test_cumulative_delta_cache_matches_jax(values):
    port, jax = port_sources.CumulativeDeltaCache(), \
        jax_sources.CumulativeDeltaCache()
    assert [port.delta(("k",), v) for v in values] == \
        [jax.delta(("k",), v) for v in values]


def test_cumulative_delta_cache_bound_matches_jax():
    port, jax = port_sources.CumulativeDeltaCache(2), \
        jax_sources.CumulativeDeltaCache(2)
    seq = [("a", 1.0), ("b", 1.0), ("c", 1.0), ("c", 4.0), ("a", 9.0)]
    assert [port.delta((k,), v) for k, v in seq] == \
        [jax.delta((k,), v) for k, v in seq]


def _ehist_sequence(seed: int):
    """Cumulative points of one series: growth, a downscale, a reset and
    an upscale, seeded."""
    rng = np.random.default_rng(seed)
    pt = _ehist(rng, 4)
    seq = [pt]
    for step in range(6):
        prev = seq[-1]
        off, counts = prev["pos"]
        grown = [c + int(rng.integers(0, 5)) for c in counts]
        nxt = dict(prev, zero_count=prev["zero_count"]
                   + int(rng.integers(0, 3)), pos=(off, grown))
        if step == 2:  # the SDK downscales by one
            nxt = dict(nxt, scale=prev["scale"] - 1,
                       pos=port_otlp._EHistCache._downscale(nxt["pos"], 1),
                       neg=port_otlp._EHistCache._downscale(nxt["neg"], 1))
        if step == 4:  # a restart: every bucket shrinks
            nxt = dict(nxt, pos=(off, [c // 3 for c in grown]))
        if step == 5:  # finer bins again: a restart
            nxt = dict(nxt, scale=prev["scale"] + 1)
        seq.append(nxt)
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ehist_cache_matches_jax(seed):
    port, jax = port_otlp._EHistCache(), jax_otlp._EHistCache()
    for pt in _ehist_sequence(seed):
        assert port.delta(("k",), pt) == jax.delta(("k",), pt)


@pytest.mark.parametrize("buckets, d", [
    ((-3, [1, 2, 3, 4]), 1), ((5, []), 2), ((5, [7]), 0),
    ((10, [5, 3, 0, 7]), 2), ((-17, [1] * 9), 3)])
def test_downscale_matches_jax(buckets, d):
    assert port_otlp._EHistCache._downscale(buckets, d) == \
        jax_otlp._EHistCache._downscale(buckets, d)


# -- conversion ---------------------------------------------------------------


class _Statsd:
    """The source's self-metrics client, recording its counts."""

    def __init__(self):
        self.counts = {}

    def count(self, name, n=1, tags=()):
        key = (name, tuple(tags))
        self.counts[key] = self.counts.get(key, 0) + n


class _Collect:
    def __init__(self):
        self.metrics = []
        self.statsd = _Statsd()

    def ingest_metric(self, metric):
        self.metrics.append(metric)

    def rows(self):
        return [(mm.key.name, mm.key.type, mm.key.joined_tags, mm.digest,
                 mm.digest64, mm.value, mm.sample_rate, tuple(mm.tags),
                 int(mm.scope)) for mm in self.metrics]


@pytest.mark.parametrize("seed", [0, 1])
def test_otlp_points_convert_like_jax(seed):
    """The same points through each package's source: the same
    UDPMetrics, pushes 2 and 3 as deltas of push 1's cumulative counts."""
    outs = []
    for mod in (port_otlp, jax_otlp):
        src = mod.OTLPSource("o", tags=["team:obs"])
        src._ingest = ingest = _Collect()
        for push in range(3):
            src._ingest_points(list(mod.parse_export_request(
                _payload(seed + push))))
        outs.append(ingest.rows())
    assert outs[0] == outs[1]
    assert any(row[1] == "llhist" for row in outs[0])


def test_weight_chunking_matches_jax():
    """A bucket count past 1e9 splits into chunks the llhist weight
    survives exactly, in both packages."""
    point = {"attrs": {}, "scale": 0, "zero_count": 2_500_000_000,
             "pos": (0, [3, 1_000_000_007]), "neg": (0, [])}
    outs = []
    for mod in (port_otlp, jax_otlp):
        src = mod.OTLPSource("o")
        src._ingest = ingest = _Collect()
        src._ingest_ehist("big", point, [])
        outs.append(ingest.rows())
    assert outs[0] == outs[1]
    weights = [round(1 / row[6]) for row in outs[0]]
    assert sum(weights) == 2_500_000_000 + 3 + 1_000_000_007
    assert max(weights) <= 10 ** 9


# -- the HTTP plane -----------------------------------------------------------


def _serve(mod, ingest):
    src = mod.OTLPSource("otlp-test", listen_address="127.0.0.1:0")
    thread = threading.Thread(target=src.start, args=(ingest,), daemon=True)
    thread.start()
    assert src._started.wait(5)
    return src, thread


def _post(port: int, body: bytes, ctype: str, encoding: str = "",
          path: str = "/v1/metrics"):
    headers = {"Content-Type": ctype}
    if encoding:
        headers["Content-Encoding"] = encoding
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, b"", ""


_BOMB = gzip.compress(b"\0" * (2 * 1024 * 1024), mtime=0)


@pytest.mark.parametrize("body, ctype, encoding, path", [
    (_payload(0), "application/x-protobuf", "", "/v1/metrics"),
    (_json_payload(0), "application/json; charset=utf-8", "", "/v1/metrics"),
    (gzip.compress(_payload(1), mtime=0), "application/x-protobuf", "gzip",
     "/v1/metrics/"),
    (gzip.compress(_json_payload(1), mtime=0), "application/json", "gzip",
     "/v1/metrics"),
    (_BOMB, "application/x-protobuf", "gzip", "/v1/metrics"),
    (b"not gzip", "application/x-protobuf", "gzip", "/v1/metrics"),
    (b"x", "application/x-protobuf", "zstd", "/v1/metrics"),
    (b"\xff\xff\xff", "application/x-protobuf", "", "/v1/metrics"),
    (b"{", "application/json", "", "/v1/metrics"),
    (b"", "application/x-protobuf", "", "/v1/traces"),
], ids=["protobuf", "json", "gzip-protobuf", "gzip-json", "gzip-bomb",
        "garbage-gzip", "zstd", "bad-protobuf", "bad-json", "wrong-path"])
def test_http_answers_match_jax(monkeypatch, body, ctype, encoding, path):
    """Each package's listener answers a request the same way (status,
    body, content type), ingests the same metrics and counts the same
    self-metrics."""
    for mod in (port_otlp, jax_otlp):
        monkeypatch.setattr(mod.OTLPSource, "GZIP_MAX_DECOMPRESSED",
                            1024 * 1024)
    answers, rows, counts = [], [], []
    for mod in (port_otlp, jax_otlp):
        ingest = _Collect()
        src, thread = _serve(mod, ingest)
        try:
            answers.append(_post(src.port, body, ctype, encoding, path))
            rows.append(ingest.rows())
            counts.append(ingest.statsd.counts)
        finally:
            src.stop()
            thread.join(5)
    assert answers[0] == answers[1]
    assert rows[0] == rows[1]
    assert counts[0] == counts[1]
    status = answers[0][0]
    errors = [k for k in counts[0] if k[0].endswith(
        ("rejected_total", "errors_total", "unsupported_encoding_total"))]
    assert bool(errors) == (status in (400, 415))


def test_stop_waits_for_a_request_in_flight():
    """A request whose ingest is still running when stop() is called
    completes its ingest before stop() returns."""
    started, release = threading.Event(), threading.Event()

    class Slow(_Collect):
        def ingest_metric(self, metric):
            started.set()
            release.wait(5)
            super().ingest_metric(metric)

    ingest = Slow()
    src, thread = _serve(port_otlp, ingest)
    poster = threading.Thread(target=_post, args=(
        src.port, _request(_metric("g", "gauge", [_number_point(1.0)])),
        "application/x-protobuf"))
    poster.start()
    assert started.wait(5)
    stopper = threading.Thread(target=src.stop)
    stopper.start()
    time.sleep(0.3)
    assert stopper.is_alive()  # waiting for the handler
    release.set()
    stopper.join(5)
    assert not stopper.is_alive() and len(ingest.metrics) == 1
    poster.join(5)
    thread.join(5)


# -- OpenMetrics ----------------------------------------------------------


def _exposition(seed: int, scrape: int) -> str:
    """A seeded exposition: counters (one resets at scrape 2), a
    histogram, a summary, gauges, an untyped line, escapes and an
    exemplar clause."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 1000, 8)
    lines = ["# HELP reqs_total Requests.", "# TYPE reqs_total counter"]
    for i in range(4):
        v = int(base[i]) + 10 * scrape * (i + 1)
        if i == 3 and scrape == 2:
            v = 3
        lines.append(f'reqs_total{{code="{200 + i}",path="a\\\\b\\"c"}} {v}')
    lines += ["# TYPE lat histogram"]
    cum = 0
    for le in ("0.1", "1", "+Inf"):
        cum += int(base[4]) + scrape
        lines.append(f'lat_bucket{{le="{le}"}} {cum}')
    lines += [f"lat_sum {1.5 * cum}", f"lat_count {cum}",
              "# TYPE rpc summary", f'rpc{{quantile="0.5"}} {0.01 * scrape}',
              f"rpc_sum {2.5 + scrape}", f"rpc_count {100 + scrape}",
              "# TYPE temp gauge",
              f'temp{{room="a\\nb",drop_me="x"}} {float(base[5])}',
              f'temp{{room="c"}} {float(base[6])} # {{trace_id="ab"}} 1.0 17',
              f"untyped_thing {int(base[7])}", "garbage line !", ""]
    return "\n".join(lines)


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_exposition_matches_jax(seed):
    for scrape in range(3):
        text = _exposition(seed, scrape)
        assert list(port_om.parse_exposition(text)) == \
            list(jax_om.parse_exposition(text))


class _FakeExposition:
    """A 127.0.0.1 /metrics that serves scrape n's exposition on GET n."""

    def __init__(self, seed: int):
        outer = self
        self.gets = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                data = _exposition(seed, outer.gets).encode()
                outer.gets += 1
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         kwargs={"poll_interval": 0.05}).start()
        self.url = "http://127.0.0.1:%d/metrics" % self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("kwargs", [
    {},
    {"allowlist": "^(reqs|lat)", "denylist": "_sum$"},
    {"ignored_labels": ["^drop"], "rename_labels": {"room": "where"},
     "tags": ["dc:1"]},
])
def test_scrape_once_matches_jax(kwargs):
    outs = []
    for mod in (port_om, jax_om):
        fake = _FakeExposition(3)
        try:
            src = mod.OpenMetricsSource("om", url=fake.url,
                                        scrape_interval=60, **kwargs)
            ingest = _Collect()
            counts = [src.scrape_once(ingest) for _ in range(3)]
        finally:
            fake.close()
        outs.append((counts, ingest.rows()))
    assert outs[0] == outs[1]


def test_failed_scrapes_are_counted_and_the_loop_carries_on():
    fake = _FakeExposition(0)
    url = fake.url
    fake.close()  # nothing listens: every scrape fails
    src = port_om.OpenMetricsSource("om", url=url, scrape_interval=0.01,
                                    timeout=1.0)
    src.start(_Collect(), max_scrapes=3)
    assert (src.scrapes, src.scrape_failures) == (0, 3)


# -- veneur-prometheus ------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["-h", "http://127.0.0.1:9/m", "-s", "127.0.0.1:9999", "-i", "2s",
     "-p", "svc.", "-ignored-labels", "^a,^b", "-ignored-metrics",
     "x_,y_", "-r", "old=new,k=v", "-a", "k=v,k2:v2", "-d"],
    ["-metrics-host", "http://h:1/metrics", "-statsd-host", ":8125",
     "-interval", "500ms", "-prefix", "p.", "-rename-labels", "a=b",
     "-added-labels", "t=1"],
])
def test_cli_flags_parse_like_jax(monkeypatch, argv):
    """Both CLIs build the same source and emitter from the same flags."""
    built = []
    for mod in (port_prom, jax_prom):
        seen = {}

        class FakeSource:
            def __init__(self, name, **kw):
                seen["source"] = dict(kw, name=name)

            def start(self, emitter, **_kw):
                seen["emitter"] = (emitter.prefix, emitter.addr)

            scrapes = scrape_failures = 0

        monkeypatch.setattr(mod, "OpenMetricsSource", FakeSource)
        assert mod.main(list(argv)) == 0
        built.append(seen)
    assert built[0] == built[1]


def test_cli_scrapes_and_sends_like_jax_emitter():
    """`-scrapes 3` against a fake: the packets it sends equal what the
    JAX package's emitter renders from the same scrapes."""
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(5)
    fake = _FakeExposition(5)
    try:
        import contextlib
        import io
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert port_prom.main([
                "-h", fake.url, "-s", "127.0.0.1:%d" % recv.getsockname()[1],
                "-i", "10ms", "-p", "pre.", "-scrapes", "3"]) == 0
        report = json.loads(out.getvalue().strip().splitlines()[-1])
        got = [recv.recv(65536) for _ in range(report["sent"])]
    finally:
        fake.close()
    want_fake = _FakeExposition(5)
    try:
        emitter = jax_prom.StatsdEmitter("127.0.0.1:9", "pre.")
        sent = []
        emitter.sock = type("S", (), {"sendto": lambda self, p, a:
                                      sent.append(p)})()
        src = jax_om.OpenMetricsSource("p", url=want_fake.url,
                                       scrape_interval=60)
        for _ in range(3):
            src.scrape_once(emitter)
    finally:
        want_fake.close()
    assert report == {"scrapes": 3, "scrape_failures": 0, "sent": len(sent)}
    assert got == sent


# -- servers with sources ---------------------------------------------------


def _jax_server(sources):
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.interval = 3600.0
    for key, value in SIZES.items():
        setattr(cfg.tpu, key, value)
    cfg.sources = [JSourceConfig(**s) for s in sources]
    sink = JChannel()
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    server.metric_extraction._uniqueness_rate = 0.0
    return server, sink


def _port_server(sources):
    cfg = config_from_dict({"hostname": "test", "interval": "1h",
                            "tpu": SIZES, "sources": sources,
                            "ledger_strict": True})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(5))
    server.metric_extraction.uniqueness_rate = 0.0
    return server, sink


def _flushed(server, sink):
    server.flush()
    return {(mm.name, tuple(mm.tags)): mm.value
            for mm in sink.wait_flush(timeout=30)
            if "service:veneur-tpu" not in mm.tags}


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key[0].endswith(".sum"):
            # a dot product whose last bit follows the flushed batch
            np.testing.assert_allclose(got[key], value, rtol=1e-12)
        else:
            assert got[key] == value, key


def test_otlp_server_flushes_like_jax():
    """Three pushes (protobuf, JSON, gzip) into a server with an otlp
    source, each flushed: every series equals the JAX server's, the
    histograms' counts above 1e9 included."""
    sources = [{"kind": "otlp", "name": "otlp", "tags": ["src:otlp"],
                "config": {"listen_address": "127.0.0.1:0"}}]
    big = _request(_metric("big", "ehist", [_ehist_point(
        3, 1_500_000_000, (8, [2_000_000_001, 5]), (0, []))],
        temporality=DELTA))
    pushes = [(_payload(7), "application/x-protobuf", ""),
              (_json_payload(7), "application/json", ""),
              (gzip.compress(_payload(8) + big, mtime=0),
               "application/x-protobuf", "gzip")]
    flushes = []
    for build in (_port_server, _jax_server):
        server, sink = build(sources)
        server.start()
        try:
            src = server.sources[0]
            assert src._started.wait(5)
            rounds = []
            for body, ctype, encoding in pushes:
                assert _post(src.port, body, ctype, encoding)[0] == 200
                rounds.append(_flushed(server, sink))
            flushes.append(rounds)
        finally:
            server.shutdown()
    for got, want in zip(*flushes):
        _assert_same(got, want)
    assert flushes[0][2][("big.count", ("src:otlp",))] == \
        1_500_000_000 + 2_000_000_001 + 5


def test_openmetrics_server_flushes_like_jax():
    """A server with an openmetrics source (allow and deny patterns)
    flushed after each of three scrapes, against the JAX server's."""
    flushes = []
    for build in (_port_server, _jax_server):
        fake = _FakeExposition(9)
        sources = [{"kind": "openmetrics", "name": "om", "tags": ["s:om"],
                    "config": {"url": fake.url, "scrape_interval": "1h",
                               "allowlist": "^(reqs|lat|temp)",
                               "denylist": "_sum$"}}]
        server, sink = build(sources)
        try:
            src = server.sources[0]
            rounds = []
            for _ in range(3):
                src.scrape_once(server)
                rounds.append(_flushed(server, sink))
            flushes.append(rounds)
        finally:
            fake.close()
            server.shutdown()
    for got, want in zip(*flushes):
        _assert_same(got, want)
    assert not any(name.endswith("_sum") for name, _ in flushes[0][2])


def test_server_starts_sources_and_stops_them_first():
    """The port server's source lifecycle: a thread per source started
    by start(), stopped and joined by shutdown() before its final flush,
    which holds what the source ingested."""
    fake = _FakeExposition(2)
    try:
        server, sink = _port_server([
            {"kind": "otlp", "config": {"listen_address": "127.0.0.1:0"}},
            {"kind": "openmetrics",
             "config": {"url": fake.url, "scrape_interval": "50ms"}}])
        server.config.flush_on_shutdown = True
        server.start()
        otlp_src, om_src = server.sources
        port = otlp_src.wait_started()
        assert _post(port, _request(_metric("g", "gauge", [
            _number_point(4.0)])), "application/x-protobuf")[0] == 200
        deadline = time.monotonic() + 10
        while om_src.scrapes < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        server.shutdown()
        assert not any(t.is_alive() for t in server._source_threads)
        stats = server.stats_snapshot()
        assert stats["source_scrapes"] >= 2
        assert stats["source_scrape_failures"] == 0
        got = {mm.name for mm in sink.drain()}
        assert "g" in got and "temp" in got
    finally:
        fake.close()


def test_unknown_source_kind_raises_with_its_name():
    with pytest.raises(ValueError, match="bogus"):
        _port_server([{"kind": "bogus"}])
