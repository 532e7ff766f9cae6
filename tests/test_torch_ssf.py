"""The port's SSF plane against the JAX package's, on the CPU:

- the framing of protocol/wire.py (roundtrip, several frames, a clean
  EOF, a bad version, an oversized or truncated frame, a decode error
  that leaves the stream usable), byte for byte against the JAX framing;
- `parse_metric_ssf` and the indicator, objective and uniqueness
  conversions against the JAX parser on a numpy-seeded corpus, and
  `randomly_sample` on an explicit generator;
- `ssf_meta_key` against the JAX helper and against the C++ `ssf_key`
  (a key registered from Python extracts natively), with tags in
  unsorted order and non-ASCII names;
- `NativeParser.parse_ssf` columns, flags and deferred samples against
  the JAX binding on the same buffer;
- a Server flush of the same SSF packets against the JAX Server's, with
  the native parser and with `disable_native_parser`, uniqueness rate
  1.0: counters and gauges exact, timers within the K1 tolerance of
  tests/test_pallas.py:97, sets exact; the port's flow ledger, strict,
  balances every interval.
"""

from __future__ import annotations

import io
import random

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu import protocol as jprotocol
from veneur_tpu import ssf as jssf
from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import ingest as jingest
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch import native, protocol, ssf
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import ingest
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.samplers.parser import Parser
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256)
PROTOCOLS = pytest.mark.parametrize("proto", [jprotocol, protocol],
                                    ids=["jax", "torch"])


def mkspan(mod=ssf, **kw):
    defaults = dict(id=5, trace_id=6, parent_id=2,
                    start_timestamp=1_000_000_000,
                    end_timestamp=5_000_000_000, name="spanner",
                    service="svc")
    defaults.update(kw)
    return mod.SSFSpan(**defaults)


# -- framing ------------------------------------------------------------------


@PROTOCOLS
def test_frame_roundtrip(proto):
    span = mkspan()
    span.metrics.append(ssf.count("x", 1))
    buf = io.BytesIO()
    n = proto.write_ssf(buf, span)
    assert n == len(buf.getvalue())
    assert buf.getvalue() == jprotocol.frame_ssf(span)
    buf.seek(0)
    got = proto.read_ssf(buf)
    assert (got.name, got.metrics[0].name) == ("spanner", "x")


@PROTOCOLS
def test_multiple_frames_then_clean_eof(proto):
    buf = io.BytesIO()
    for i in range(3):
        proto.write_ssf(buf, mkspan(id=i + 1))
    buf.seek(0)
    ids = []
    while (span := proto.read_ssf(buf)) is not None:
        ids.append(span.id)
    assert ids == [1, 2, 3]
    assert proto.read_ssf(io.BytesIO(b"")) is None


@PROTOCOLS
@pytest.mark.parametrize("raw", [
    b"\x01\x00\x00\x00\x00",                                     # version 1
    b"\x00" + (16 * 1024 * 1024 + 1).to_bytes(4, "big"),         # oversize
    b"\x00\x00\x00\x00\x10abc",                                  # truncated
    b"\x00\x00\x00",                                             # header cut
], ids=["bad_version", "oversize", "truncated_body", "truncated_header"])
def test_framing_errors(proto, raw):
    with pytest.raises(proto.FramingError):
        proto.read_ssf(io.BytesIO(raw))


@PROTOCOLS
def test_frame_cap_follows_max_length(proto):
    frame = proto.frame_ssf(mkspan(name="x" * 100))
    with pytest.raises(proto.FramingError):
        proto.read_ssf(io.BytesIO(frame), max_length=64)
    assert proto.read_ssf(io.BytesIO(frame), max_length=len(frame)).name \
        == "x" * 100


@PROTOCOLS
def test_decode_error_is_not_a_framing_error(proto):
    body = b"\xff\xff\xff"
    buf = io.BytesIO(b"\x00" + len(body).to_bytes(4, "big") + body
                     + proto.frame_ssf(mkspan(id=9)))
    with pytest.raises(proto.SSFDecodeError) as err:
        proto.read_ssf(buf)
    assert not proto.is_framing_error(err.value)
    assert proto.read_ssf(buf).id == 9  # the stream is still in sync


def test_parse_normalization_and_valid_trace_match_jax():
    span = mkspan(name="")
    span.tags["name"] = "from-tag"
    span.metrics.append(ssf.count("c", 1))
    span.metrics[0].sample_rate = 0
    data = span.SerializeToString()
    got, want = protocol.parse_ssf(data), jprotocol.parse_ssf(data)
    assert got.SerializeToString() == want.SerializeToString()
    assert got.name == "from-tag" and got.metrics[0].sample_rate == 1.0
    for kw in ({}, {"id": 0}, {"trace_id": 0}, {"start_timestamp": 0},
               {"end_timestamp": 0}, {"name": ""}):
        s = mkspan(**kw)
        assert protocol.valid_trace(s) == jprotocol.valid_trace(s)


# -- conversions --------------------------------------------------------------


def _sample_corpus(seed: int, n: int = 300):
    """SSFSamples of every metric kind, with sample rates, scopes, magic
    tags, tags in unsorted insertion order and non-ASCII names."""
    rng = np.random.default_rng(seed)
    out = []
    kinds = [ssf.COUNTER, ssf.GAUGE, ssf.HISTOGRAM, ssf.SET, ssf.STATUS]
    for i in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        name = f"conv.{['a', 'b', 'café', 'z'][int(rng.integers(4))]}{i % 17}"
        s = ssf.SSFSample(metric=kind, name=name,
                          value=float(np.float32(rng.normal(0, 100))),
                          message=f"m{int(rng.integers(50))}",
                          status=int(rng.integers(4)),
                          sample_rate=float(rng.choice([0.0, 1.0, 0.5, 0.25])),
                          scope=int(rng.integers(3)))
        for k in rng.permutation(["zz", "aa", "mm", "ñu"])[:int(
                rng.integers(0, 4))]:
            s.tags[str(k)] = f"v{int(rng.integers(9))}"
        if i % 13 == 0:
            s.tags["veneurglobalonly"] = "true"
        if i % 19 == 0:
            s.tags["veneurlocalonly"] = ""
        out.append(s)
    return out


def _udp_fields(m):
    return (m.key.name, m.key.type, m.key.joined_tags, m.digest,
            m.digest64, m.value, m.sample_rate, list(m.tags), int(m.scope))


def test_parse_metric_ssf_matches_jax_on_a_seeded_corpus():
    tp, jp = Parser(), JParser()
    corpus = _sample_corpus(1)
    for s in corpus:
        assert _udp_fields(tp.parse_metric_ssf(s)) == _udp_fields(
            jp.parse_metric_ssf(jssf.SSFSample.FromString(
                s.SerializeToString())))
    bad = ssf.SSFSample(metric=7, name="x")
    with pytest.raises(ValueError):
        tp.parse_metric_ssf(bad)
    span = ssf.SSFSpan()
    span.metrics.extend(corpus[:40] + [bad, ssf.SSFSample(name="")])
    got, got_bad = tp.convert_metrics(span)
    want, want_bad = jp.convert_metrics(span)
    assert [_udp_fields(m) for m in got] == [_udp_fields(m) for m in want]
    assert len(got_bad) == len(want_bad) == 2


def test_timer_values_are_in_resolution_units():
    for resolution, unit in ((1e-9, "ns"), (1e-3, "ms"), (1.0, "s")):
        got = ssf.timing("t", 2.5, resolution)
        want = jssf.timing("t", 2.5, resolution)
        assert (got.value, got.unit) == (want.value, want.unit)
        assert got.unit == unit
    assert Parser().parse_metric_ssf(ssf.timing("t", 0.25, 1e-3)).value \
        == 250.0


@pytest.mark.parametrize("seed", [2, 3])
def test_indicator_and_objective_timers_match_jax(seed):
    rng = np.random.default_rng(seed)
    tp, jp = Parser(), JParser()
    for i in range(60):
        span = mkspan(id=int(rng.integers(1, 1 << 40)),
                      trace_id=int(rng.integers(1, 1 << 40)),
                      start_timestamp=10**18,
                      end_timestamp=10**18 + int(rng.integers(1, 10**9)),
                      name=f"op{i % 4}", service=f"svc{i % 3}",
                      indicator=bool(i % 2), error=bool(i % 5 == 0))
        if i % 7 == 0:
            span.tags["ssf_objective"] = "override"
        if i % 11 == 0:
            span.name = ""  # not a valid trace: nothing derives
        for ind, obj in (("sli", "slo"), ("sli", ""), ("", "slo")):
            got = tp.convert_indicator_metrics(span, ind, obj)
            want = jp.convert_indicator_metrics(span, ind, obj)
            assert [_udp_fields(m) for m in got] == \
                [_udp_fields(m) for m in want]
            if span.indicator and span.name and ind:
                # the span's duration in nanoseconds, as the float32 of
                # an SSFSample's value
                assert got[0].value == float(np.float32(
                    span.end_timestamp - span.start_timestamp))


def test_uniqueness_metrics_match_jax_and_use_the_given_generator():
    tp, jp = Parser(), JParser()
    span = mkspan(id=6, trace_id=6, indicator=True)
    got = tp.convert_span_uniqueness_metrics(span, random.Random(0), 1.0)
    want = jp.convert_span_uniqueness_metrics(span, 1.0)
    assert [_udp_fields(m) for m in got] == [_udp_fields(m) for m in want]
    assert got[0].tags == ["indicator:true", "root_span:true", "service:svc"]
    assert tp.convert_span_uniqueness_metrics(mkspan(service=""),
                                              random.Random(0), 1.0) == []
    kept = [len(tp.convert_span_uniqueness_metrics(span, random.Random(7),
                                                   0.3)) for _ in range(3)]
    assert kept == [len(tp.convert_span_uniqueness_metrics(
        span, random.Random(7), 0.3)) for _ in range(3)]
    # randomly_sample: one roll per sample, survivors scaled by the rate
    samples = [ssf.count(f"r{i}", 1) for i in range(200)]
    a = ssf.randomly_sample(random.Random(5), 0.5, *samples)
    roll = random.Random(5)
    assert [s.name for s in a] == [s.name for s in samples
                                   if roll.random() <= 0.5]
    assert {s.sample_rate for s in a} == {0.5}


# -- the canonical key and the native decoder ---------------------------------


def test_ssf_meta_key_matches_jax_and_the_native_key():
    eng = native.Engine()
    parser = native.NativeParser(engine=eng)
    corpus = [s for s in _sample_corpus(4, 200) if s.metric != ssf.STATUS]
    for row, s in enumerate(corpus):
        key = ingest.ssf_meta_key(s)
        assert key == jingest.ssf_meta_key(s)
        # registered under the Python key, the sample must extract in C++
        # (a set member is ASCII here), so ssf_key built the same bytes
        fam = {ssf.COUNTER: native.FAM_COUNTER, ssf.GAUGE: native.FAM_GAUGE,
               ssf.HISTOGRAM: native.FAM_HISTO, ssf.SET: native.FAM_SET
               }[s.metric]
        eng.register(key, fam, row, s.sample_rate or 1.0)
        span = ssf.SSFSpan()
        span.metrics.append(s)
        data = span.SerializeToString()
        res = parser.parse_ssf(data, [0], [len(data)], False, 0.0, 1)
        assert not res.deferred, (key, s)
        assert res.samples == 1
    assert ingest.ssf_meta_key(ssf.status("x", ssf.OK)) is None


def _native_spans(seed: int, n: int = 80):
    rng = np.random.default_rng(seed)
    packets = []
    for i in range(n):
        span = ssf.SSFSpan(
            id=i + 1, trace_id=(i % 7) + 1, name=f"op{i % 5}",
            service=["svc", "café-svc", ""][i % 3],
            start_timestamp=100 + i, end_timestamp=200 + i,
            indicator=(i % 3 == 0))
        span.metrics.append(ssf.count(f"np.c{i % 4}",
                                      float(rng.integers(1, 9)),
                                      {"zz": "1", "aa": str(i % 2)}))
        span.metrics.append(ssf.gauge(f"np.g{i % 4}", float(i)))
        t = ssf.timing(f"np.t{i % 4}", 0.001 * i, 1e-3)
        t.sample_rate = 0.5
        span.metrics.append(t)
        span.metrics.append(ssf.set_sample(
            "np.users", f"user{i}", {"veneurglobalonly": "true"}))
        if i % 10 == 0:
            span.metrics.append(ssf.status("np.check", ssf.WARNING, "w"))
        if i % 11 == 0:
            span.metrics.append(ssf.set_sample("np.non", "café"))
        packets.append(span.SerializeToString())
    packets.append(b"\x07garbage\xff\xff")
    return packets


def _result_fields(res):
    cols = ("c_rows", "c_vals", "c_rates", "g_rows", "g_vals", "g_lines",
            "h_rows", "h_vals", "h_wts", "s_rows", "s_idx", "s_rho", "flags")
    return ({c: np.array(getattr(res, c)).tolist() for c in cols},
            res.decoded, res.samples,
            [(p, bytes(raw), line) for p, raw, line in res.deferred])


@pytest.mark.parametrize("uniq_rate", [1.0, 0.5, 0.0])
def test_native_parse_ssf_matches_the_jax_binding(uniq_rate):
    packets = _native_spans(5)
    buf = b"".join(packets)
    lens = np.array([len(p) for p in packets], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    teng, jeng = native.Engine(), jnative.Engine()
    tpar = native.NativeParser(engine=teng)
    jpar = jnative.NativeParser(engine=jeng)
    # the first pass interns nothing and defers every sample
    first = (_result_fields(tpar.parse_ssf(buf, offs, lens, True, uniq_rate,
                                           99)),
             _result_fields(jpar.parse_ssf(buf, offs, lens, True, uniq_rate,
                                           rng_seed=99)))
    assert first[0] == first[1]
    # register every deferred sample's key in both engines, as the
    # ingesters do, then the second pass extracts natively
    tp = Parser()
    for row, (_pkt, raw, _line) in enumerate(first[0][3]):
        sample = ssf.SSFSample.FromString(raw)
        key = ingest.ssf_meta_key(sample)
        if key is None:
            continue
        metric = tp.parse_metric_ssf(sample)
        fam = ingest._FAMILY_BY_TYPE[metric.key.type]
        teng.register(key, fam, row, metric.sample_rate)
        jeng.register(key, fam, row, metric.sample_rate)
    for rate in (1.0, 0.5):
        key = ingest.ssf_meta_key(ssf.SSFSample(
            metric=ssf.SET, name="ssf.names_unique", sample_rate=rate,
            tags={"indicator": "false", "root_span": "false",
                  "service": "svc"}))
        teng.register(key, native.FAM_SET, 31, rate)
        jeng.register(key, native.FAM_SET, 31, rate)
    got = _result_fields(tpar.parse_ssf(buf, offs, lens, True, uniq_rate,
                                        12345))
    want = _result_fields(jpar.parse_ssf(buf, offs, lens, True, uniq_rate,
                                         rng_seed=12345))
    assert got == want
    flags = np.array(got[0]["flags"])
    assert got[1] == len(packets) - 1
    assert flags[-1] == native.SSF_BAD
    assert (flags[:-1] & native.SSF_DECODED).all()
    assert got[2] > 4 * 70  # most samples now extract natively


# -- two servers --------------------------------------------------------------


def _jax_server(disable_native: bool, sink):
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.interval = 3600.0
    cfg.indicator_span_timer_name = "sli.t"
    cfg.objective_span_timer_name = "slo.t"
    cfg.tpu.disable_native_parser = disable_native
    for key, value in SIZES.items():
        setattr(cfg.tpu, key, value)
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    server.metric_extraction._uniqueness_rate = 1.0
    return server


def _port_server(disable_native: bool, sink):
    cfg = config_from_dict({
        "hostname": "test", "interval": "1h",
        "indicator_span_timer_name": "sli.t",
        "objective_span_timer_name": "slo.t",
        "span_channel_capacity": 4096, "ledger_strict": True,
        "tpu": {**SIZES, "disable_native_parser": disable_native}})
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(11))
    server.metric_extraction.uniqueness_rate = 1.0
    return server


def _feed_jax(server, packets, disable_native):
    """The JAX server's own paths: the native batch (synchronous when no
    span sink is attached), or per packet onto its span channel, whose
    spans are then extracted here in channel order, as its span workers
    would (deterministic: no worker thread, no quiet-period poll). The
    JAX flush also puts its own `flush` span (service veneur-tpu) on the
    channel; the port has no self-trace plane yet, so those are left
    out."""
    if not disable_native:
        server.handle_ssf_batch(packets)
        return
    for p in packets:
        server.handle_ssf_packet(p)
    while not server.span_chan.empty():
        span = server.span_chan.get_nowait()
        if span.service != "veneur-tpu":
            server.metric_extraction.ingest(span)


def _rows(sink):
    return {(m.name, tuple(m.tags)): (m.type.name, m.value)
            for m in sink.wait_flush(timeout=30)}


def _assert_flushes_agree(got, want):
    assert set(got) == set(want)
    for key, (kind, value) in want.items():
        gkind, gvalue = got[key]
        assert gkind == kind, key
        if "percentile" in key[0]:
            np.testing.assert_allclose(gvalue, value, rtol=2e-5, atol=1e-4,
                                       err_msg=str(key))
        else:
            assert gvalue == value, key


@pytest.mark.parametrize("disable_native", [False, True],
                         ids=["native", "numpy"])
def test_server_flush_of_ssf_packets_matches_jax(disable_native):
    packets = _native_spans(6)
    jsink, tsink = JChannel(), ChannelMetricSink()
    jserver = _jax_server(disable_native, jsink)
    tserver = _port_server(disable_native, tsink)
    tserver.start()
    try:
        for interval in range(2):
            _feed_jax(jserver, packets, disable_native)
            if disable_native:
                for p in packets:
                    tserver.handle_ssf_packet(p)
            else:
                tserver.handle_ssf_batch(packets)
            tserver.drain_spans(timeout=30)
            jserver.flush()
            tserver.flush()
            got, want = _rows(tsink), _rows(jsink)
            _assert_flushes_agree(got, want)
            # the indicator and objective timers count each of the 27
            # indicator spans once, whichever path derived them
            assert got[("sli.t.count", ("error:false", "service:svc"))][1] \
                == 27.0
        stats = tserver.stats_snapshot()
        assert stats["ssf_packets_received"] == 2 * len(packets)
        assert stats["ssf_parse_errors"] == 2
        assert stats["ingest_dispatch_errors"] == 0
    finally:
        tserver.shutdown()
        jserver.shutdown()
