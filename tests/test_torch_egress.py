"""The port's columnar egress encoders (veneur_tpu_torch/core/egress.py)
against the JAX package's, and against the port's own per-InterMetric
paths.

One line corpus (that of tests/test_egress.py: counters, gauges, timers,
sets, llhists, tag-free rows, host:/device: magic tags, a drop-prefix
candidate) goes into a JAX ColumnStore and a port ColumnStore
(device="cpu"), each flushed by its own flusher, global and local, with
the same extras (a hostname-carrying counter, a status check, two
backfilled rows). The batch timestamps are pinned to one value.

- Prometheus exposition and Cortex remote-write frames: the port's equal
  the JAX package's byte for byte (the two flushers emit the same rows
  in the same order, and the values agree to the bit at this corpus).
- Datadog series: equal as parsed JSON, in the same order.
- The port's columnar output equals the port's legacy path
  (render_exposition, _dd_metric, encode_write_request over
  materialize()), as tests/test_egress.py holds it for the JAX package.
- A raising encoder falls back to materialize() and still delivers.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from veneur_tpu.core.columnstore import ColumnStore as JStore
from veneur_tpu.core.egress import (
    CortexColumnarEncoder as JCortexEnc,
    DatadogColumnarEncoder as JDatadogEnc,
    PrometheusColumnarRenderer as JPromRenderer,
)
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
from veneur_tpu.samplers.metrics import InterMetric as JInterMetric
from veneur_tpu.samplers.metrics import MetricType as JMetricType
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu.sinks.cortex import CortexMetricSink as JCortexSink
from veneur_tpu.sinks.datadog import DatadogMetricSink as JDatadogSink
from veneur_tpu_torch.core import egress as tegress
from veneur_tpu_torch.core.columnstore import ColumnStore as TStore
from veneur_tpu_torch.core.egress import (
    CortexColumnarEncoder, DatadogColumnarEncoder,
    PrometheusColumnarRenderer,
)
from veneur_tpu_torch.core.flusher import flush_columnstore_batch as tflush
from veneur_tpu_torch.samplers.metrics import (
    HistogramAggregates, InterMetric, MetricType,
)
from veneur_tpu_torch.samplers.parser import Parser
from veneur_tpu_torch.sinks import cortex as cxmod
from veneur_tpu_torch.sinks import datadog as ddmod
from veneur_tpu_torch.sinks.cortex import (
    CortexMetricSink, decode_write_request, encode_write_request,
)
from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
from veneur_tpu_torch.sinks.prometheus import (
    PrometheusMetricSink, render_exposition,
)

PCTS = (0.5, 0.99)
AGG_NAMES = ["min", "max", "count"]
SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256)
TS = 1_700_000_100
MODES = pytest.mark.parametrize("is_local", [False, True],
                                ids=["global", "local"])


def _lines():
    lines = []
    for i in range(5):
        lines.append(b"c.%d:%d|c|#env:t,i:%d" % (i, i + 1, i))
        lines.append(b"g.%d:%.2f|g|#env:t" % (i, i * 1.5))
        lines.append(b"t.%d:%.2f|ms|#env:t" % (i, 10.0 + i))
        lines.append(b"t.%d:%.2f|ms|#env:t" % (i, 20.0 + i))
        lines.append(b"s.%d:user%d|s|#env:t" % (i, i))
        lines.append(b"ll.%d:%.3f|l|#env:t,svc:x" % (i, 5.0 + i))
        lines.append(b"ll.%d:%.3f|l|#env:t,svc:x" % (i, 500.0 + i))
    return lines + [b"bare:3|c", b"hosted:4|c|#host:other,device:sda,env:t",
                    b"dropme.x:1|c|#env:t", b"ll.bare:42.5|l"]


_EXTRAS = [
    dict(name="extra.count", timestamp=1700000000, value=4.0, tags=["q:r"],
         type="COUNTER", hostname="hX"),
    dict(name="svc.ok", timestamp=1700000001, value=1.0, tags=["chk:y"],
         type="STATUS", hostname="hX", message="degraded"),
    dict(name="backfill.g", timestamp=1699990000, value=7.5, tags=["o:p"],
         type="GAUGE", hostname="hB", backfilled=True),
    dict(name="backfill.c", timestamp=1699990000, value=2.0, tags=[],
         type="COUNTER", backfilled=True),
]


def _extras(cls, types):
    return [cls(**dict(e, tags=list(e["tags"]), type=types[e["type"]]))
            for e in _EXTRAS]


def _jax_batch(is_local=False, extras=True):
    store, parser = JStore(**SIZES), JParser()
    for line in _lines():
        parser.parse_metric_fast(line, store.process)
    store.apply_all_pending()
    batch, _ = jflush(store, is_local, PCTS, JAggs.from_names(AGG_NAMES),
                      collect_forward=is_local)
    batch.timestamp = TS
    if extras:
        batch.extras.extend(_extras(JInterMetric, JMetricType.__members__))
    return batch


def _torch_batch(is_local=False, extras=True):
    store, parser = TStore(device="cpu", **SIZES), Parser()
    for line in _lines():
        parser.parse_metric_fast(line, store.process)
    store.apply_all_pending()
    batch, _ = tflush(store, is_local, PCTS,
                      HistogramAggregates.from_names(AGG_NAMES),
                      collect_forward=is_local)
    batch.timestamp = TS
    if extras:
        batch.extras.extend(_extras(InterMetric, MetricType.__members__))
    return batch


_DD_KW = dict(tags=["glob:t"], metric_name_prefix_drops=["dropme."],
              excluded_tag_prefixes=["i:"], num_workers=1)


def _dd(cls):
    return cls("datadog", "key", "https://dd.example", "me", 10.0, **_DD_KW)


# -- against the JAX package -------------------------------------------------


@MODES
def test_prometheus_exposition_equals_jax_bytes(is_local):
    jbatch, tbatch = _jax_batch(is_local), _torch_batch(is_local)
    want = JPromRenderer().render(jbatch)
    got = PrometheusColumnarRenderer().render(tbatch)
    assert got == want
    # a local server forwards its llhist rows instead of emitting buckets
    assert ('le="+Inf"' in got) is not is_local
    assert (PrometheusColumnarRenderer().render(tbatch, openmetrics=True)
            == JPromRenderer().render(jbatch, openmetrics=True))


@MODES
def test_cortex_frames_equal_jax_bytes(is_local):
    jbatch, tbatch = _jax_batch(is_local), _torch_batch(is_local)
    jsink = JCortexSink("cortex", "http://c/api", "myhost",
                        excluded_tags=["i"])
    tsink = CortexMetricSink("cortex", "http://c/api", "myhost",
                             excluded_tags=["i"])
    jframes, jmax = JCortexEnc(jsink).encode(jbatch)
    tframes, tmax = CortexColumnarEncoder(tsink).encode(tbatch)
    assert tframes == jframes
    assert tmax == jmax == TS
    rows = decode_write_request(b"".join(tframes))
    assert any(labels.get("le") == "+Inf"
               for labels, _v, _t in rows) is not is_local


@MODES
def test_cortex_monotonic_frames_equal_jax(is_local):
    jbatch, tbatch = _jax_batch(is_local), _torch_batch(is_local)
    jsink = JCortexSink("cortex", "http://c/api", "myhost",
                        convert_counters_to_monotonic=True)
    tsink = CortexMetricSink("cortex", "http://c/api", "myhost",
                             convert_counters_to_monotonic=True)
    for _ in range(2):  # the totals accumulate across flushes
        jframes, jmax = JCortexEnc(jsink).encode(jbatch)
        tframes, tmax = CortexColumnarEncoder(tsink).encode(tbatch)
        assert tframes == jframes
        assert ([encode_write_request([r])
                 for r in tsink._monotonic_series(tmax)]
                == [encode_write_request([r])
                    for r in jsink._monotonic_series(jmax)])


@MODES
def test_datadog_series_equal_jax_json(is_local):
    jbatch, tbatch = _jax_batch(is_local), _torch_batch(is_local)
    jparts, jchecks = JDatadogEnc(_dd(JDatadogSink)).encode(jbatch)
    tparts, tchecks = DatadogColumnarEncoder(_dd(DatadogMetricSink)).encode(
        tbatch)
    assert [json.loads(p) for p in tparts] == [json.loads(p) for p in jparts]
    assert [c.name for c in tchecks] == [c.name for c in jchecks] == [
        "svc.ok"]


# -- against the port's own legacy path ---------------------------------------


@MODES
def test_columnar_equals_port_legacy(is_local):
    batch = _torch_batch(is_local)
    legacy = batch.materialize()
    assert PrometheusColumnarRenderer().render(batch) == render_exposition(
        legacy)
    sink = _dd(DatadogMetricSink)
    parts, _checks = DatadogColumnarEncoder(sink).encode(batch)
    assert [json.loads(p) for p in parts] == json.loads(json.dumps([
        sink._dd_metric(m) for m in legacy
        if m.type != MetricType.STATUS and not m.name.startswith("dropme.")]))
    cx = CortexMetricSink("cortex", "http://c/api", "myhost")
    frames, _ = CortexColumnarEncoder(cx).encode(batch)
    assert b"".join(frames) == encode_write_request(
        [cx._series(m) for m in legacy if m.type != MetricType.STATUS])


def test_warm_fragment_cache_stays_exact():
    """A second flush of the same store through long-lived encoders: the
    rows' tags lists are the same objects (the cache hits) and the bytes
    still equal a cold encoder's."""
    store, parser = TStore(device="cpu", **SIZES), Parser()
    sink = _dd(DatadogMetricSink)
    dd, prom = DatadogColumnarEncoder(sink), PrometheusColumnarRenderer()
    cx = CortexColumnarEncoder(CortexMetricSink("cortex", "u", "h"))
    tags_ids, cached = [], []
    for _ in range(2):
        for line in _lines():
            parser.parse_metric_fast(line, store.process)
        store.apply_all_pending()
        batch, _ = tflush(store, False, PCTS,
                          HistogramAggregates.from_names(AGG_NAMES))
        tags_ids.append({id(t) for s in batch.sections for t in s.tags}
                        | {id(t) for b in batch.bucket_sections
                           for t in b.tags})
        assert dd.encode(batch)[0] == DatadogColumnarEncoder(sink).encode(
            batch)[0]
        assert prom.render(batch) == PrometheusColumnarRenderer().render(
            batch)
        assert cx.encode(batch)[0] == CortexColumnarEncoder(
            CortexMetricSink("cortex", "u", "h")).encode(batch)[0]
        cached.append((len(dd._frags), len(prom._labels), len(cx._blocks)))
    assert tags_ids[0] == tags_ids[1]
    assert cached[0] == cached[1]  # the warm flush rendered no new row


# -- sinks end to end, and the fallback ---------------------------------------


def _capture(monkeypatch, mod):
    posted = []
    monkeypatch.setattr(mod.vhttp, "post",
                        lambda url, body, **kw: posted.append(
                            (url, bytes(body))))
    if hasattr(mod.vhttp, "post_json"):
        monkeypatch.setattr(mod.vhttp, "post_json",
                            lambda url, obj, **kw: posted.append(
                                (url, json.dumps(obj).encode())))
    return posted


def test_datadog_flush_batch_posts_legacy_series(monkeypatch):
    posted = _capture(monkeypatch, ddmod)
    batch = _torch_batch()
    sink = _dd(DatadogMetricSink)
    sink.flush_batch(batch)
    assert sink.last_egress[2] == "columnar"
    col = [json.loads(b) for _u, b in posted]
    posted.clear()
    sink.flush(batch.materialize())
    assert sink.last_egress[2] == "legacy"
    assert col == [json.loads(b) for _u, b in posted]


def test_cortex_flush_batch_posts_legacy_bytes(monkeypatch):
    posted = _capture(monkeypatch, cxmod)
    batch = _torch_batch()
    sink = CortexMetricSink("cortex", "http://c/api", "h", batch_write_size=7)
    sink.flush_batch(batch)
    assert sink.last_egress[2] == "columnar"
    col = list(posted)
    posted.clear()
    CortexMetricSink("cortex", "http://c/api", "h",
                     batch_write_size=7).flush(batch.materialize())
    assert col == posted and len(col) > 1


@pytest.mark.parametrize("kind", ["datadog", "prometheus", "cortex"])
def test_encoder_failure_falls_back_to_materialize(monkeypatch, kind):
    batch = _torch_batch()

    def boom(*_a, **_k):
        raise RuntimeError("encoder failed")

    if kind == "datadog":
        posted = _capture(monkeypatch, ddmod)
        monkeypatch.setattr(tegress.DatadogColumnarEncoder, "encode", boom)
        sink = _dd(DatadogMetricSink)
    elif kind == "cortex":
        posted = _capture(monkeypatch, cxmod)
        monkeypatch.setattr(tegress.CortexColumnarEncoder, "encode", boom)
        sink = CortexMetricSink("cortex", "http://c/api", "h")
    else:
        posted = None
        monkeypatch.setattr(tegress.PrometheusColumnarRenderer, "render",
                            boom)
        sink = PrometheusMetricSink("prometheus")
    sink.flush_batch(batch)  # does not raise: the legacy path delivers
    assert sink.last_egress[2] == "legacy"
    assert batch._materialized is not None
    if posted is not None:
        assert posted
    else:
        assert sink.exposition_plain() == render_exposition(
            batch.materialize())


# -- the compact bucket section, at many bins a row ---------------------------


def _wide_llhist_lines():
    """llhist keys over many bins: gamma latencies, negative values, the
    zero bin, magnitudes collapsed to zero or clamped to the top bin,
    sampled lines, and one key with a single sample."""
    rng = np.random.default_rng(24)
    lines = []
    for k in range(12):
        vals = np.concatenate([rng.gamma(2.0, 25.0, 60),
                               -rng.lognormal(0.0, 3.0, 8),
                               [0.0, 1e-12, 3e16, -3e16]])
        suffix = b"|@0.5" if k % 3 == 0 else b""
        lines += [b"wl.%d:%.6g|l%s|#env:t,k:%d" % (k, v, suffix, k % 4)
                  for v in vals]
    return lines + [b"wl.one:7.5|l|#env:t"]


def _wide_batches():
    out = []
    for store, parser, flush, aggs in (
            (JStore(**SIZES), JParser(), jflush, JAggs),
            (TStore(device="cpu", **SIZES), Parser(), tflush,
             HistogramAggregates)):
        for line in _wide_llhist_lines():
            parser.parse_metric_fast(line, store.process)
        store.apply_all_pending()
        batch, _ = flush(store, False, PCTS, aggs.from_names(AGG_NAMES),
                         collect_forward=False)
        batch.timestamp = TS
        out.append(batch)
    return out


def _buckets_only(lines):
    return [x for x in lines if "bucket" in x]


def test_compact_buckets_materialize_as_jax_dense_ones():
    jbatch, tbatch = _wide_batches()
    (bs,) = tbatch.bucket_sections
    assert bs.bins.shape == bs.cum.shape and bs.offsets[-1] == bs.cum.size
    assert bs.cum.size > 12 * 30  # many nonzero bins a row
    want = [(m.name, m.value, m.tags, m.type.name)
            for m in jbatch.materialize() if m.name.endswith(".bucket")]
    got = [(m.name, m.value, m.tags, m.type.name)
           for m in tbatch.materialize() if m.name.endswith(".bucket")]
    assert got == want
    assert len(tbatch) == len(jbatch)
    assert sum(b.line_count() for b in tbatch.bucket_sections) == len(got)


def test_compact_buckets_encode_as_jax_dense_ones():
    jbatch, tbatch = _wide_batches()
    assert _buckets_only(PrometheusColumnarRenderer().render(
        tbatch).splitlines()) == _buckets_only(
        JPromRenderer().render(jbatch).splitlines())
    jparts, _ = JDatadogEnc(_dd(JDatadogSink)).encode(jbatch)
    tparts, _ = DatadogColumnarEncoder(_dd(DatadogMetricSink)).encode(tbatch)
    assert _buckets_only([p.decode() for p in tparts]) == _buckets_only(
        [p.decode() for p in jparts])
    for mono in (False, True):
        jsink = JCortexSink("cortex", "http://c/api", "h",
                            convert_counters_to_monotonic=mono)
        tsink = CortexMetricSink("cortex", "http://c/api", "h",
                                 convert_counters_to_monotonic=mono)
        jframes, jmax = JCortexEnc(jsink).encode(jbatch)
        tframes, tmax = CortexColumnarEncoder(tsink).encode(tbatch)
        if mono:  # the buckets are counters: totals kept per series
            jframes = [encode_write_request([r])
                       for r in jsink._monotonic_series(jmax)]
            tframes = [encode_write_request([r])
                       for r in tsink._monotonic_series(tmax)]
        rows = [r for r in decode_write_request(b"".join(tframes))
                if "le" in r[0]]
        assert len(rows) > 12 * 30
        assert rows == [r for r in decode_write_request(b"".join(jframes))
                        if "le" in r[0]]


def test_compact_buckets_equal_the_legacy_path():
    _jbatch, batch = _wide_batches()
    legacy = batch.materialize()
    assert PrometheusColumnarRenderer().render(batch) == render_exposition(
        legacy)
    sink = _dd(DatadogMetricSink)
    parts, _checks = DatadogColumnarEncoder(sink).encode(batch)
    assert [json.loads(p) for p in parts] == json.loads(json.dumps([
        sink._dd_metric(m) for m in legacy]))
    cx = CortexMetricSink("cortex", "http://c/api", "myhost")
    frames, _ = CortexColumnarEncoder(cx).encode(batch)
    assert b"".join(frames) == encode_write_request(
        [cx._series(m) for m in legacy])
