"""The port's overlapped flush (`flush_async`, core/flushexec.py) against
the JAX package's single-device cases (tests/test_flush_async.py): the
overlapped readout is the synchronous one, bit for bit where the JAX
package is exact; interval N is delivered at tick N+1, equal to a JAX
server's delivery, under `ledger_strict`; the waterfall's async lane and
the family spans under their origin interval; the shutdown drains with
and without `flush_on_shutdown`, into the WAL; a readout that raises and
one that stays wedged; the shape-ladder prewarmer; a query under the
overlap; and key churn with reclamation, series by series against the
JAX server. The mesh case waits for the port's sharded plane."""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest

from veneur_tpu.core.columnstore import ColumnStore as JColumnStore
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.columnstore import ColumnStore
from veneur_tpu_torch.core.flushexec import (FlushReadoutExecutor,
                                             ShapeLadderPrewarmer)
from veneur_tpu_torch.core.flusher import (flush_columnstore_batch,
                                           readout_columnstore,
                                           swap_columnstore)
from veneur_tpu_torch.core.latency import waterfall_rounds
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.samplers.metrics import HistogramAggregates
from veneur_tpu_torch.samplers.parser import Parser
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

from test_flush_async import corpus, mk_server as jmk_server
from test_torch_query import (_assert_queries_match_flush, _flushed, _q,
                              _query_all)
from test_torch_query import corpus as query_corpus

PCTS = (0.5, 0.99)
AGGS = ["min", "max", "median", "avg", "count", "sum"]
CAPS = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
            set_capacity=32, llhist_capacity=64, batch_cap=128)
SIZES = dict(counter_capacity=128, gauge_capacity=128, histo_capacity=128,
             set_capacity=64, llhist_capacity=64, batch_cap=512)


def _wait(pred, timeout: float = 20.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _feed(store, parser, lines):
    for line in lines:
        parser.parse_metric_fast(line, store.process)
    store.apply_all_pending()


def _series(metrics) -> dict:
    return {(m.name, tuple(sorted(m.tags)), int(m.type)): float(m.value)
            for m in metrics}


def _assert_series(got: dict, want: dict) -> None:
    """Exact, except the t-digest quantiles and aggregates (K1's
    tolerance) and the llhist `.sum` (a float64 dot product)."""
    assert set(got) == set(want)
    for key, value in want.items():
        if key[0].startswith("t."):
            np.testing.assert_allclose(got[key], value, rtol=2e-5,
                                       atol=1e-4, err_msg=str(key))
        elif key[0].startswith("ll.") and key[0].endswith(".sum"):
            np.testing.assert_allclose(got[key], value, rtol=1e-12)
        else:
            assert got[key] == value, key


def _fwd_keys(fwd) -> dict:
    return {
        "counters": sorted((m.name, v) for m, v in fwd.counters),
        "gauges": sorted((m.name, v) for m, v in fwd.gauges),
        "sets": sorted((m.name, np.asarray(r).tobytes())
                       for m, r in fwd.sets),
        "llhists": sorted((m.name, np.asarray(b).tobytes())
                          for m, b in fwd.llhists),
        "histos": sorted((m.name, np.asarray(w).sum()) for m, _mu, w, *_
                         in fwd.histograms),
    }


def _overlapped(store, parser, is_local):
    """Swap here, read out on another thread while this one ingests the
    next interval: the shape the server runs under flush_async."""
    swap = swap_columnstore(store, is_local, PCTS)
    out = {}

    def readout():
        out["r"] = readout_columnstore(
            store, swap, is_local, HistogramAggregates.from_names(AGGS))

    t = threading.Thread(target=readout)
    t.start()
    _feed(store, parser, corpus(round_no=7))
    t.join(30.0)
    assert not t.is_alive()
    return out["r"]


@pytest.mark.parametrize("is_local", [False, True])
def test_overlapped_readout_equals_sync_and_jax(is_local):
    port, jstore = ColumnStore(device="cpu", **CAPS), JColumnStore(**CAPS)
    sync = ColumnStore(device="cpu", **CAPS)
    parser = Parser()
    for store in (port, sync):
        _feed(store, parser, corpus())
    _feed(jstore, JParser(), corpus())
    batch, fwd = _overlapped(port, parser, is_local)
    sbatch, sfwd = flush_columnstore_batch(
        sync, is_local, PCTS, HistogramAggregates.from_names(AGGS))
    jbatch, _jfwd = jflush(jstore, is_local, PCTS, JAggs.from_names(AGGS))
    assert _series(batch.materialize()) == _series(sbatch.materialize())
    assert _fwd_keys(fwd) == _fwd_keys(sfwd)
    _assert_series(_series(batch.materialize()),
                   _series(jbatch.materialize()))
    # interval 2 over the recycled generations equals a fresh store's
    _feed(sync, parser, corpus(round_no=7))
    b2, f2 = flush_columnstore_batch(port, is_local, PCTS,
                                     HistogramAggregates.from_names(AGGS))
    s2, sf2 = flush_columnstore_batch(sync, is_local, PCTS,
                                      HistogramAggregates.from_names(AGGS))
    assert _series(b2.materialize()) == _series(s2.materialize())
    assert _fwd_keys(f2) == _fwd_keys(sf2)


# -- the server ----------------------------------------------------------


def mk_server(**extra):
    tpu = dict(SIZES, **extra.pop("tpu", {}))
    cfg = config_from_dict({"interval": "60s", "hostname": "test",
                            "ledger_strict": True, "tpu": tpu, **extra})
    obs = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[obs],
                    rng=random.Random(7))
    server.metric_extraction.uniqueness_rate = 0.0
    return server, obs


def _server_feed(server, lines):
    for line in lines:
        server.handle_metric_packet(line)
    server.store.apply_all_pending()


def _own(metrics) -> list:
    """Drop what a server says of itself (its flush spans' metrics)."""
    return [m for m in metrics if "service:veneur-tpu" not in m.tags
            and not m.name.startswith(("veneur.", "flush.", "intern."))]


def _stop(server):
    server.config.flush_on_shutdown = False
    server.shutdown()


def test_async_delivers_previous_interval_like_jax():
    port, pobs = mk_server(flush_async=True)
    jax, jobs = jmk_server(flush_async=True)
    try:
        got = []
        for server, obs in ((port, pobs), (jax, jobs)):
            _server_feed(server, corpus())
            server.flush()  # tick 1: swap + submit, nothing delivered
            assert _own(obs.drain()) == []
            assert server._inflight_flushes and server._inflight_rows > 0
            _wait(lambda s=server: s._inflight_flushes[0]["pending"].done())
            _server_feed(server, corpus(round_no=3))
            server.flush()  # tick 2: delivers interval 1
            got.append(_series(_own(obs.drain())))
        _assert_series(got[0], got[1])
        assert port._inflight_rows == jax._inflight_rows
        ri = port.telemetry.flushes.snapshot()[-1]
        assert ri["async"] is True and ri["delivered_flush"] == 1
        assert ri["phases"]["join_s"] >= 0.0
        assert ri["phases"]["critical_path_s"] <= ri["duration_s"]
        # the in-flight interval is the ledger's stock, and strict holds
        hist = port.ledger._history
        assert hist[-1]["stocks"]["closing"]["flush_inflight_snapshot"] \
            == port._inflight_rows
        assert all(v == 0.0 for v in hist[-1]["imbalance"].values())
    finally:
        _stop(port)
        _stop(jax)


def test_sync_flush_keeps_its_timings_and_same_tick_delivery():
    server, obs = mk_server()
    try:
        _server_feed(server, corpus())
        server.flush()
        assert _own(obs.drain())
        timings = server.last_flush_timings
        for key in ("readout_lock_wait_s", "swap_s", "dispatch_s",
                    "device_sync_s", "assembly_s", "sinks_s", "total_s"):
            assert key in timings
        assert "join_s" not in timings
        assert server._flush_executor is None
        assert "async" not in server.telemetry.flushes.snapshot()[-1]
    finally:
        _stop(server)


def test_waterfall_renders_the_async_lane():
    server, _obs = mk_server(flush_async=True)
    try:
        _server_feed(server, corpus())
        server.flush()
        _wait(lambda: server._inflight_flushes[0]["pending"].done())
        server.flush()
        tree = waterfall_rounds(server.telemetry.flushes.snapshot())[-1]
        assert tree["async_readout"] is True
        assert tree["delivered_flush"] == 1
        assert tree["critical_path_s"] >= 0.0
        assert tree["families"]
        for rec in tree["families"].values():
            assert rec["lane"] == "async"
        assert tree["segments_sum_s"] <= tree["device_total_s"] * 1.10
    finally:
        _stop(server)


def test_async_family_spans_parent_under_origin_interval():
    server, _obs = mk_server(flush_async=True)
    try:
        _server_feed(server, corpus())
        server.flush()
        tid1 = server.telemetry.flushes.snapshot()[-1].get("trace_id")
        assert tid1
        _wait(lambda: server._inflight_flushes[0]["pending"].done())
        server.flush()
        trace = server.trace_plane.store.get(int(tid1, 16))
        spans = trace["spans"]
        assert len(trace["roots"]) == 1
        root = next(s for s in spans if s["span_id"] == trace["roots"][0])
        assert root["name"] == "flush"
        fam = [s for s in spans if s["name"] == "flush.family"]
        assert {s["tags"]["family"] for s in fam} >= {
            "counter", "gauge", "histogram", "llhist", "set"}
        assert all(s["parent_id"] == root["span_id"] for s in fam)
    finally:
        _stop(server)


def test_shutdown_with_flush_on_shutdown_delivers_both_intervals():
    server, obs = mk_server(flush_async=True, flush_on_shutdown=True)
    jax, jobs = jmk_server(flush_async=True, flush_on_shutdown=True)
    got = []
    for srv, o in ((server, obs), (jax, jobs)):
        _server_feed(srv, corpus())
        srv.flush()
        assert srv._inflight_flushes
        _server_feed(srv, corpus(round_no=3))
        srv.shutdown()
        got.append(_own(o.drain()))
    assert len(got[0]) == len(got[1])
    # the two intervals share names: compare them as multisets
    key = lambda m: (m.name, tuple(sorted(m.tags)), float(m.value))  # noqa
    port_vals = sorted(key(m) for m in got[0] if not m.name.startswith("t."))
    jax_vals = sorted(key(m) for m in got[1] if not m.name.startswith("t."))
    assert port_vals == jax_vals
    assert server._inflight_flushes == []


def test_shutdown_without_flush_on_shutdown_delivers_the_swapped_interval():
    server, obs = mk_server(flush_async=True)
    _server_feed(server, corpus())
    server.flush()
    _server_feed(server, corpus(round_no=3))  # the partial interval
    server.shutdown()
    delivered = _series(_own(obs.drain()))
    sync, sobs = mk_server()
    _server_feed(sync, corpus())
    sync.flush()
    _assert_series(delivered, _series(_own(sobs.drain())))
    _stop(sync)


def test_shutdown_drain_reaches_the_wal(tmp_path):
    server, _obs = mk_server(
        flush_async=True, forward_only=True, forward_address="127.0.0.1:1",
        forward_wal=True, carryover_spool_dir=str(tmp_path),
        forward_retry_max_attempts=1, interval="1h")
    server.start()
    fc = server.forward_client
    _server_feed(server, corpus())
    server.flush()  # swapped and submitted: nothing on disk yet
    assert server._inflight_flushes
    assert fc.wal_appended_metrics == 0
    server.shutdown()  # deliver-only: join, deliver, WAL append
    assert fc.wal_appended_metrics > 0
    assert fc.spool.depth >= 1


def test_readout_that_raises_is_reraised_at_the_join_and_survives():
    beats = []
    ex = FlushReadoutExecutor(beat=beats.append)
    try:
        boom = ex.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            boom.result(5.0)
        assert ex.submit(lambda: 42).result(5.0) == 42
        assert beats
    finally:
        ex.stop()
    server, obs = mk_server(flush_async=True)
    real = server._run_readout
    calls = []

    def failing(record):
        calls.append(record["flush"])
        if len(calls) == 1:
            raise RuntimeError("readout failed on the device")
        return real(record)

    server._run_readout = failing
    try:
        _server_feed(server, corpus())
        server.flush()  # interval 1's readout raises on the executor
        _server_feed(server, corpus(round_no=3))
        server.flush()  # dropped and counted; interval 2 submitted
        assert server.stats_snapshot()["readout_failed"] == 1
        assert _own(obs.drain()) == []
        _wait(lambda: server._inflight_flushes[0]["pending"].done())
        server.flush()  # interval 2 delivered
        sync, sobs = mk_server()
        _server_feed(sync, corpus(round_no=3))
        sync.flush()
        _assert_series(_series(_own(obs.drain())),
                       _series(_own(sobs.drain())))
        _stop(sync)
        # the supervisor watches the readout executor
        assert "flush-readout" in server.overload.supervisor._beats
    finally:
        _stop(server)


def test_a_wedged_readout_is_carried_then_dropped():
    server, obs = mk_server(flush_async=True, interval="2s")
    real = server._run_readout
    gate = threading.Event()

    def wedged(record):
        if record["flush"] == 1:
            gate.wait(30.0)
        return real(record)

    server._run_readout = wedged
    try:
        for tick in range(4):
            _server_feed(server, corpus(round_no=tick))
            server.flush()
            carried = [r["flush"] for r in server._inflight_flushes]
            if tick < 3:
                # the head is carried at its first two misses
                assert carried == list(range(1, tick + 2))
        # the third miss dropped interval 1; the worker still holds it
        assert server.stats_snapshot()["readout_failed"] == 1
        assert carried == [2, 3, 4]
        assert _own(obs.drain()) == []
        gate.set()
        assert _wait(lambda: all(r["pending"].done()
                                 for r in server._inflight_flushes))
        server.flush()
        got = _own(obs.drain())
        sync, sobs = mk_server()
        want = []
        for tick in (1, 2, 3):
            _server_feed(sync, corpus(round_no=tick))
            sync.flush()
            want += _own(sobs.drain())
        _stop(sync)
        key = lambda m: (m.name, tuple(sorted(m.tags)))  # noqa: E731
        assert sorted(map(key, got)) == sorted(map(key, want))
    finally:
        gate.set()
        _stop(server)


def test_query_under_flush_async():
    server, obs = mk_server(flush_async=True)
    try:
        _server_feed(server, query_corpus())
        queries = _query_all(server)
        server.flush()  # tick 1: swap + submit
        assert _own(obs.drain()) == []
        # after the swap the live generation is fresh and empty
        r = _q(server, "t.0", "quantile", q=0.5)
        assert r["matched_rows"] == 0 and r["value"] is None
        _wait(lambda: server._inflight_flushes[0]["pending"].done())
        server.flush()  # tick 2: the interval's delivered readout
        _assert_queries_match_flush(queries, _flushed(obs.drain()))
    finally:
        _stop(server)


# -- churn with reclamation ----------------------------------------------

_LINES = {
    "counter": "ch.c.k{k}:{v}|c|#w:{w}",
    "timer": "ch.t.k{k}:{v}|ms",
    "set": "ch.s.k{k}:m{m}|s",
    "llhist": "ch.l.k{k}:{v}|l",
}


def _wave(family, wave, rng, keys=40):
    out = []
    for k in range(wave * keys // 2, wave * keys // 2 + keys):
        for _ in range(3):
            v = float(np.round(rng.gamma(2.0, 20.0), 3)) + 1.0
            out.append(_LINES[family].format(
                k=k, v=v, w=k % 3, m=int(rng.integers(50))).encode())
    return [b"\n".join(out[i:i + 30]) for i in range(0, len(out), 30)]


def _tick_series(server, obs) -> dict:
    server.flush()
    return {(m.name, tuple(m.tags)): m.value for m in _own(obs.drain())}


@pytest.mark.parametrize("family", sorted(_LINES))
@pytest.mark.parametrize("idle", [1, 2])
def test_churn_with_reclamation_under_flush_async_like_jax(family, idle):
    runs = []
    for build in (mk_server, jmk_server):
        if build is mk_server:
            server, obs = mk_server(
                flush_async=True,
                tpu=dict(SIZES, idle_key_intervals=idle))
        else:
            server, obs = jmk_server(flush_async=True,
                                     **{"tpu.idle_key_intervals": idle})
            server.metric_extraction._uniqueness_rate = 0.0
        rng = np.random.default_rng(11)
        ticks = []
        for wave in range(6):
            server.handle_packet_batch(_wave(family, wave, rng))
            ticks.append(_tick_series(server, obs))
        server.config.flush_on_shutdown = True
        server.shutdown()
        ticks.append({(m.name, tuple(m.tags)): m.value
                      for m in _own(obs.drain())})
        runs.append((ticks, server))
    (port_ticks, port), (jax_ticks, _jax) = runs
    assert [len(t) for t in port_ticks] == [len(t) for t in jax_ticks]
    for got, want in zip(port_ticks, jax_ticks):
        assert set(got) == set(want)
        for key, value in want.items():
            if family == "timer" and "percentile" in key[0]:
                np.testing.assert_allclose(got[key], value, rtol=2e-5,
                                           atol=1e-4)
            elif key[0].endswith(".sum") and family == "llhist":
                np.testing.assert_allclose(got[key], value, rtol=1e-12)
            else:
                assert got[key] == value, key
    assert sum(t.recycled_total for _f, t in port.store.tables()) > 0


# -- the shape-ladder prewarmer ------------------------------------------


def _force_resize(table, n=80):
    parser = Parser()
    for i in range(n):
        parser.parse_metric_fast(b"pw.%d:1|c" % i, table.add)
    table.apply_pending()


@pytest.mark.parametrize("prewarm", [True, False])
def test_first_apply_after_a_resize_reports_the_prewarm(prewarm):
    store = ColumnStore(device="cpu", **CAPS)
    table = store.counters
    events = []
    table.on_resize = lambda *a, **kw: events.append((a, kw))
    if prewarm:
        assert table.prewarm_rung(128, PCTS)
        assert 128 in table._prewarmed_caps
    _force_resize(table)
    kinds = [kw.get("kind") for _a, kw in events]
    assert kinds == ["resize", "first_apply"]
    assert events[0][0][:3] == ("counter", 64, 128)
    assert events[1][1]["prewarmed"] is prewarm
    assert table.first_apply_last_seconds > 0.0
    vals, touched, meta = table.snapshot_and_reset()
    got = {meta[r].name: vals[r] for r in np.flatnonzero(touched)}
    assert got == {f"pw.{i}": 1.0 for i in range(80)}


def test_prewarmer_thread_works_through_queued_rungs():
    store = ColumnStore(device="cpu", **CAPS)
    events = []
    pw = ShapeLadderPrewarmer(
        store, percentiles=PCTS, need_export=True,
        on_event=lambda kind, **kw: events.append((kind, kw)))
    pw.start()
    try:
        pw.prewarm_initial()
        assert _wait(lambda: all(
            128 in t._prewarmed_caps for t in (
                store.counters, store.gauges, store.histos, store.llhists)),
            timeout=60.0)
        assert not store.sets._prewarmed_caps  # its rung is a no-op
        assert store.sets.prewarm_rung(64) is False
        pw.note_resize("counter", 128)
        assert _wait(lambda: 256 in store.counters._prewarmed_caps,
                     timeout=60.0)
        assert pw.compiled_total >= 5
        rows = {name: v for name, _k, v, _t in pw.telemetry_rows()}
        assert rows["prewarm.compiled_total"] >= 5
        assert {kind for kind, _kw in events} == {"shape_prewarm"}
        # the throwaway rungs left the live state alone
        assert store.counters.capacity == 64
        assert not store.counters.touched.any()
    finally:
        pw.stop()


def test_server_prewarm_ladder_and_resize_events():
    server, obs = mk_server(prewarm_ladder=True, interval="1h")
    server.start()
    try:
        pw = server.prewarmer
        assert pw is not None
        assert _wait(lambda: 2 * SIZES["counter_capacity"]
                     in server.store.counters._prewarmed_caps, 60.0)
        _server_feed(server, [b"rz.%d:1|c" % i for i in range(200)])
        events = server.telemetry.events.snapshot(kind="columnstore_resize")
        assert events and events[-1]["new_capacity"] == 256
        first = server.telemetry.events.snapshot(
            kind="columnstore_first_apply")
        assert first and first[-1]["prewarmed"] is True
        # the resize queued the next rung
        assert _wait(lambda: 512 in server.store.counters._prewarmed_caps,
                     60.0)
    finally:
        _stop(server)
