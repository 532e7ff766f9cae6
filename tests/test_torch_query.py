"""The port's live query plane (veneur_tpu_torch/core/query.py and the
tables' capture_readonly/query_readout) against the JAX package's
(veneur_tpu/core/query.py), on the CPU:

- the consistency pin of tests/test_query.py, single device: a query
  between flushes equals (==) the next flush's reading of the same row,
  for every family and both histogram encodings, with the set family on
  both tiers (promoted rows estimated by K2's plain version, host-tier
  rows on the host); tag filters and errors; a capacity resize between
  queries; queries racing ingest;
- the same specs give the same `value` in both packages over the same
  UDP corpus;
- a capture followed by an apply, before its readout is finished, reads
  the pre-apply values (counters, gauges, t-digest, llhist, sets), and a
  flush after queries is identical to a flush of a server that took
  none.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time

import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.query import QuerySpec as JQuerySpec
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.query import (LiveQueryPlane, QueryError,
                                         QuerySpec, parse_tags)
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

SIZES = dict(counter_capacity=128, gauge_capacity=128, histo_capacity=128,
             set_capacity=64, llhist_capacity=64, batch_cap=512,
             set_promote_samples=2)


def corpus(round_no: int = 0):
    """tests/test_query.py's corpus, plus one-member sets that stay on
    the host tier (the two-member sets promote at their second sample)."""
    lines = []
    for i in range(8):
        lines.append(b"c.%d:%d|c|#env:t" % (i, i + 1 + round_no))
        lines.append(b"g.%d:%.2f|g" % (i, i * 1.5 + round_no))
        lines.append(b"t.%d:%.2f|ms" % (i, 10.0 + i + round_no))
        lines.append(b"t.%d:%.2f|ms" % (i, 40.0 + i))
        lines.append(b"s.%d:m%d|s" % (i, i))
        lines.append(b"s.%d:m%d|s" % (i, i + 50 + round_no))
        lines.append(b"h.%d:m%d|s" % (i, i + round_no))
        lines.append(b"ll.%d:%.2f|l" % (i, 3.0 + i + round_no))
    return lines


def mk_server(**extra):
    tpu = dict(SIZES, **extra.pop("tpu", {}))
    cfg = config_from_dict({"interval": "60s", "hostname": "test",
                            "tpu": tpu, **extra})
    obs = ChannelMetricSink()
    return Server(cfg, device="cpu", extra_metric_sinks=[obs]), obs


def _feed(server, lines):
    for line in lines:
        server.handle_metric_packet(line)
    server.store.apply_all_pending()


def _q(server, metric, kind, **kw):
    return server.query_plane.query(
        QuerySpec.build(metric=metric, kind=kind, **kw))


def _flushed(metrics):
    """{(name, sorted tags): value} for exact-equality lookups."""
    return {(m.name, tuple(sorted(m.tags))): float(m.value)
            for m in metrics}


def _assert_queries_match_flush(queries: dict, flushed: dict):
    """The pin: every pre-flush query value equals (==, not approx: the
    readout is the same, so the floats are the same bits) the next
    flush's reading of the same row."""
    for label, (fname, ftags, qval) in queries.items():
        assert (fname, ftags) in flushed, \
            f"{label}: {fname}{ftags} missing from flush output"
        got = flushed[(fname, ftags)]
        assert qval == got, f"{label}: query {qval!r} != flush {got!r}"


def _query_all(server):
    """One query per family against the corpus; returns {label:
    (flush_name, flush_tags, query_value)} for the pin."""
    out = {
        "t50": ("t.0.50percentile", (),
                _q(server, "t.0", "quantile", q=0.5)["value"]),
        "t99": ("t.0.99percentile", (),
                _q(server, "t.0", "quantile", q=0.99)["value"]),
        "ll50": ("ll.0.50percentile", (),
                 _q(server, "ll.0", "quantile", q=0.5)["value"]),
        "count": ("c.0", ("env:t",),
                  _q(server, "c.0", "count",
                     tags=parse_tags("env:t"))["value"]),
        "gauge": ("g.0", (), _q(server, "g.0", "value")["value"]),
        "card": ("s.0", (), _q(server, "s.0", "cardinality")["value"]),
        "card_host": ("h.0", (),
                      _q(server, "h.0", "cardinality")["value"]),
    }
    for i in (3, 7):
        out[f"t99.{i}"] = (f"t.{i}.99percentile", (),
                           _q(server, f"t.{i}", "quantile",
                              q=0.99)["value"])
        out[f"ll50.{i}"] = (f"ll.{i}.50percentile", (),
                            _q(server, f"ll.{i}", "quantile",
                               q=0.5)["value"])
        out[f"card.{i}"] = (f"s.{i}", (),
                            _q(server, f"s.{i}", "cardinality")["value"])
    return out


@pytest.mark.parametrize("encoding", ["tdigest", "circllhist"])
def test_query_matches_next_flush(encoding):
    """Queries between flushes == the next flush's readout of the same
    generation, all five families, exact; both set tiers are live."""
    server, obs = mk_server(histogram_encoding=encoding)
    try:
        _feed(server, corpus())
        assert server.store.sets._nslots == 8  # s.* promoted, h.* not
        queries = _query_all(server)
        r = _q(server, "c.0", "count", tags=parse_tags("env:t"))
        assert r["stale_pending_samples"] == 0
        assert r["matched_rows"] == 1
        expect_family = "histogram" if encoding == "tdigest" else "llhist"
        assert _q(server, "t.0", "quantile", q=0.5)["family"] == \
            expect_family
        server.flush()
        _assert_queries_match_flush(queries, _flushed(obs.drain()))
    finally:
        server.shutdown()


def test_tag_filter_and_errors():
    server, _obs = mk_server()
    try:
        _feed(server, [b"m:1|c|#env:prod,svc:a", b"m:2|c|#env:dev"])
        prod = _q(server, "m", "count", tags=parse_tags("env:prod"))
        assert prod["matched_rows"] == 1 and prod["value"] == 1.0
        both = _q(server, "m", "count")
        assert both["matched_rows"] == 2 and both["value"] == 3.0
        assert _q(server, "nope", "count")["value"] is None
        with pytest.raises(QueryError):
            QuerySpec.build(metric="", kind="count")
        with pytest.raises(QueryError):
            QuerySpec.build(metric="m", kind="nope")
        with pytest.raises(QueryError):
            QuerySpec.build(metric="m", kind="quantile")  # no q
        with pytest.raises(QueryError):
            QuerySpec.build(metric="m", kind="bin_occupancy",
                            lo=2.0, hi=1.0)
        assert server.query_plane.queries_total == 3
    finally:
        server.shutdown()


@pytest.mark.parametrize("bad", [
    dict(metric="", kind="count"), dict(metric="m", kind="nope"),
    dict(metric="m", kind="quantile"), dict(metric="m", kind="quantile",
                                            q=1.5),
    dict(metric="m", kind="bin_occupancy", lo=2.0, hi=1.0),
    dict(metric="m", kind="bin_occupancy", lo=1.0)])
def test_spec_errors_equal_jax(bad):
    """QuerySpec.build rejects what the JAX package's rejects, with the
    same message."""
    from veneur_tpu.core.query import QueryError as JQueryError
    with pytest.raises(JQueryError) as want:
        JQuerySpec.build(**bad)
    with pytest.raises(QueryError) as got:
        QuerySpec.build(**bad)
    assert str(got.value) == str(want.value)


def test_query_across_resize_boundary():
    """Growing a family past its capacity mid-interval leaves the query
    plane consistent: queries after the resize match the next flush."""
    server, obs = mk_server(tpu={"histo_capacity": 32})
    try:
        _feed(server, corpus())
        before = _q(server, "t.0", "quantile", q=0.5)["value"]
        _feed(server, [b"resize.%d:%d|ms" % (i, i) for i in range(64)])
        assert server.store.histos.capacity > 32
        after = _q(server, "t.0", "quantile", q=0.5)
        assert after["value"] == before  # the resize itself moves nothing
        queries = _query_all(server)
        server.flush()
        _assert_queries_match_flush(queries, _flushed(obs.drain()))
    finally:
        server.shutdown()


def test_query_with_concurrent_ingest():
    """Readers race ingest to other rows, more threads than cores with a
    short switch interval: the queries stay exact for the rows they
    match, and the final values still equal the flush."""
    server, obs = mk_server()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _feed(server, corpus())
        stop = threading.Event()
        errors = []

        def _ingest():
            i = 0
            while not stop.is_set():
                server.handle_metric_packet(b"other.%d:1|c" % (i % 16))
                server.handle_metric_packet(b"ll.other:%d|l" % (i % 97))
                i += 1

        def _read():
            while not stop.is_set():
                try:
                    assert _q(server, "t.0", "quantile",
                              q=0.5)["value"] == 25.0
                    assert _q(server, "c.0", "count",
                              tags=parse_tags("env:t"))["value"] == 1.0
                    _q(server, "ll.other", "quantile", q=0.5)
                except Exception as e:  # pragma: no cover
                    errors.append(e)
                    return

        threads = [threading.Thread(target=_ingest) for _ in range(2)] + \
            [threading.Thread(target=_read)
             for _ in range(max(3, os.cpu_count() or 1))]
        for t in threads:
            t.start()
        time.sleep(0.8)
        stop.set()
        for t in threads:
            t.join(10.0)
            assert not t.is_alive()
        assert not errors
        server.store.apply_all_pending()
        queries = _query_all(server)
        queries["other"] = ("other.3", (),
                            _q(server, "other.3", "count")["value"])
        queries["ll.other"] = ("ll.other.50percentile", (),
                               _q(server, "ll.other", "quantile",
                                  q=0.5)["value"])
        server.flush()
        _assert_queries_match_flush(queries, _flushed(obs.drain()))
    finally:
        sys.setswitchinterval(switch)
        server.shutdown()


def test_bin_occupancy_and_rate():
    server, _obs = mk_server()
    try:
        _feed(server, [b"ll.b:%d|l" % v for v in (1, 2, 50, 500)]
              + [b"r:10|c"])
        occ = _q(server, "ll.b", "bin_occupancy", lo=0.0, hi=100.0)
        assert occ["value"] == 0.75 and occ["matched_rows"] == 1
        start = server._interval_start_unix
        lo = time.time() - start
        rate = _q(server, "r", "rate")["value"]
        hi = time.time() - start
        assert 10.0 / hi <= rate <= 10.0 / lo
    finally:
        server.shutdown()


# -- the same specs in both packages over UDP ---------------------------------

SPECS = [
    ("t.0", "quantile", dict(q=0.5)), ("t.5", "quantile", dict(q=0.99)),
    ("ll.2", "quantile", dict(q=0.5)), ("c.3", "count",
                                        dict(tags=("env:t",))),
    ("g.4", "value", {}), ("s.1", "cardinality", {}),
    ("h.6", "cardinality", {}),
    ("ll.3", "bin_occupancy", dict(lo=0.0, hi=5.0)),
]


def _received(server, package):
    if package == "jax":
        return server.stats["packets_received"]
    return server.stats_snapshot()["lines_received"]


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture(scope="module")
def both_over_udp():
    """A JAX server and a port server, each fed the corpus over UDP and
    left unflushed; the values of SPECS from each."""
    lines = corpus()
    jcfg = JConfig()
    jcfg.interval = 3600.0
    jcfg.hostname = "test"
    jcfg.statsd_listen_addresses = ["udp://127.0.0.1:0"]
    for key, value in SIZES.items():
        if key != "set_promote_samples":
            setattr(jcfg.tpu, key, value)
    jserver = JServer(jcfg.apply_defaults(), extra_metric_sinks=[JChannel()])
    tserver, _obs = mk_server(interval="1h",
                              statsd_listen_addresses=["udp://127.0.0.1:0"])
    out = {}
    for package, server in (("jax", jserver), ("torch", tserver)):
        server.start()
        try:
            addr = (server.local_addr("udp") if package == "jax"
                    else server.listen_addresses[0])
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for i in range(0, len(lines), 8):
                    tx.sendto(b"\n".join(lines[i:i + 8]), addr)
                    time.sleep(0.002)
            assert _wait_for(lambda: _received(server, package)
                             == len(lines))
            server.store.apply_all_pending()
            spec_cls = JQuerySpec if package == "jax" else QuerySpec
            out[package] = [
                server.query_plane.query(spec_cls.build(
                    metric=metric, kind=kind, **kw))
                for metric, kind, kw in SPECS]
        finally:
            server.config.flush_on_shutdown = False
            server.shutdown()
    return out


@pytest.mark.parametrize("i", range(len(SPECS)),
                         ids=[f"{m}-{k}" for m, k, _ in SPECS])
def test_same_value_as_jax_over_udp(both_over_udp, i):
    want = both_over_udp["jax"][i]
    got = both_over_udp["torch"][i]
    assert got["matched_rows"] == want["matched_rows"] == 1
    assert got["family"] == want["family"]
    assert got["value"] is not None
    if got["kind"] == "quantile":
        # the port's t-digest cumsums and llhist ranks against the JAX
        # package's CPU path (ROADMAP queue 3, float order)
        assert got["value"] == pytest.approx(want["value"], rel=2e-5,
                                             abs=1e-4)
    else:
        assert got["value"] == want["value"]


# -- a capture is a snapshot of the live state --------------------------------

APPLY = {
    "counter": ("count", b"c.0:5|c|#env:t", "c.0", dict(tags=("env:t",))),
    "gauge": ("value", b"g.0:99|g", "g.0", {}),
    "histogram": ("quantile", b"t.0:1000|ms", "t.0", dict(q=0.99)),
    "llhist": ("quantile", b"ll.0:1000|l", "ll.0", dict(q=0.99)),
    "set": ("cardinality", b"s.0:new-member|s", "s.0", {}),
}


@pytest.mark.parametrize("family", sorted(APPLY))
def test_capture_then_apply_reads_pre_apply_state(family):
    """capture_readonly, then an apply to the same row before the
    readout is finished: the capture reads the pre-apply value, a later
    query the post-apply one."""
    kind, line, metric, kw = APPLY[family]
    server, _obs = mk_server()
    try:
        _feed(server, corpus())
        before = _q(server, metric, kind, **kw)["value"]
        plane = server.query_plane
        spec = QuerySpec.build(metric=metric, kind=kind, **kw)
        ps = plane.ps_for((spec,))
        table = plane._tables()[family]
        snap = table.capture_readonly(ps=ps)
        _feed(server, [line] * 3)  # lands in the live state
        snap = table.query_readout(snap, time.monotonic() + 30.0)
        bundle = {"as_of_unix": time.time(),
                  family: LiveQueryPlane._finish(family, table, snap)}
        assert plane.evaluate(bundle, spec, ps)["value"] == before
        after = _q(server, metric, kind, **kw)["value"]
        assert after != before
    finally:
        server.shutdown()


def _exact(metrics):
    """Every flushed series by identity, its value as float64 bits."""
    return sorted((m.name, tuple(m.tags), str(m.type), m.hostname,
                   struct.pack("<d", float(m.value)))
                  for m in metrics)


@pytest.mark.parametrize("encoding", ["tdigest", "circllhist"])
def test_flush_after_queries_identical_to_flush_without(encoding):
    """Two servers take the same samples; one answers every kind of query
    (and alert ticks) in between. Their flushes are identical, and so is
    the interval after."""
    quiet, quiet_obs = mk_server(histogram_encoding=encoding)
    busy, busy_obs = mk_server(histogram_encoding=encoding)
    busy.alerts.configure([
        {"id": "a", "metric": "t.1", "kind": "quantile", "q": 0.5,
         "op": ">", "threshold": 0.0},
        {"id": "b", "metric": "s.1", "kind": "cardinality", "op": ">",
         "threshold": 0.0},
        {"id": "c", "metric": "ll.1", "kind": "bin_occupancy", "lo": 0,
         "hi": 10, "op": ">", "threshold": 0.5}])
    try:
        for round_no in range(2):
            lines = corpus(round_no)
            half = len(lines) // 2
            for server in (quiet, busy):
                for line in lines[:half]:
                    server.handle_metric_packet(line)
            # pending samples fold into the live state here, on the busy
            # server only
            _query_all(busy)
            _q(busy, "ll.1", "bin_occupancy", lo=0.0, hi=10.0)
            _q(busy, "t.2", "quantile", q=0.3)  # a q outside the flush's
            busy.alerts.evaluate_once()
            for server in (quiet, busy):
                for line in lines[half:]:
                    server.handle_metric_packet(line)
            _query_all(busy)
            quiet.flush()
            busy.flush()
            want = _exact(quiet_obs.drain())
            assert want and _exact(busy_obs.drain()) == want
    finally:
        quiet.shutdown()
        busy.shutdown()


def test_name_index_matches_match_rows():
    """evaluate() finds its rows through the table's name index: the
    same rows, in the same order, as the JAX package's match_rows scan,
    also for rows interned after the capture."""
    from veneur_tpu.core.query import match_rows
    from veneur_tpu_torch.core.query import _named_rows
    server, _obs = mk_server()
    try:
        _feed(server, corpus() + [b"c.0:1|c|#env:u", b"c.0:1|c|#env:t,x:y",
                                  b"c.9:1|c"])
        server.flush()
        _feed(server, [b"c.0:2|c|#env:t", b"c.1:2|c"])  # some rows idle
        bundle = server.query_plane.capture(("counter", "set"))
        _feed(server, [b"c.0:2|c|#env:late", b"late:1|c"])
        for family in ("counter", "set"):
            fam = bundle[family]
            names = {m.name for m in fam["meta"]} | {"absent", "late"}
            for name in names:
                for tags in ((), ("env:t",), ("env:t", "x:y"), ("nope",),
                             ("env:late",)):
                    want = match_rows(fam["meta"], fam["touched"], name,
                                      tags)
                    assert _named_rows(fam, name, tags) == want, \
                        (family, name, tags)
                    spec = QuerySpec.build(metric=name, kind="count"
                                           if family == "counter"
                                           else "cardinality", tags=tags)
                    res = server.query_plane.evaluate(bundle, spec)
                    assert res["matched_rows"] == len(want)
        assert _q(server, "c.0", "count",
                  tags=("env:late",))["matched_rows"] == 1
    finally:
        server.shutdown()


def _get(address, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://{address[0]}:{address[1]}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_capture_times_out_behind_a_held_readout_lock():
    """A capture waits at most the plane's timeout for the readout lock
    (the JAX plane's readout future has the same bound); /query then
    answers 500 and the next query, with the lock free, answers."""
    server, _obs = mk_server(http_address="127.0.0.1:0")
    server.start()
    try:
        _feed(server, corpus())
        server.query_plane._timeout_s = 0.2
        with server._readout_lock:
            t0 = time.monotonic()
            with pytest.raises(TimeoutError):
                _q(server, "c.0", "count")
            assert 0.2 <= time.monotonic() - t0 < 5.0
            status, body = _get(server.http_api.address,
                                "/query?metric=c.0&kind=count")
            assert status == 500 and b"error" in body
        status, _body = _get(server.http_api.address,
                             "/query?metric=c.0&kind=count")
        assert status == 200
        assert _q(server, "c.0", "count")["matched_rows"] == 1
    finally:
        server.shutdown()


def test_flush_holds_the_readout_lock_over_swap_and_device_half_only(
        monkeypatch):
    """The flush holds the readout lock over its swap and, again, over its
    device readout (launch, sync, copies), and has released it before it
    assembles the batch."""
    from veneur_tpu_torch.core import flusher
    server, _obs = mk_server()
    events = []

    class Recording:
        def __enter__(self):
            events.append("enter")

        def __exit__(self, *exc):
            events.append("exit")

    sync, batch_cls = server.store.synchronize, flusher.FlushBatch
    monkeypatch.setattr(server.store, "synchronize",
                        lambda: (events.append("sync"), sync())[1])
    monkeypatch.setattr(server, "_readout_lock", Recording())
    monkeypatch.setattr(flusher, "FlushBatch", lambda *a, **kw: (
        events.append("assemble"), batch_cls(*a, **kw))[1])
    try:
        _feed(server, corpus())
        server.flush()
    finally:
        server.shutdown()
    assert events == ["enter", "exit", "enter", "sync", "exit", "assemble"]
