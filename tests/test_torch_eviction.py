"""The port's table lifecycle against the JAX package's: idle-row
reclamation (tombstone, then recycle one flush later, with the straggler
re-arm), the row cap, the exact unique-series count, and servers under
key churn whose tables stop growing while every flushed series equals
the JAX server's (numpy-seeded)."""

from __future__ import annotations

import random
import socket
import time

import numpy as np
import pytest
import torch

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.columnstore import CounterTable as JCounterTable
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.columnstore import CounterTable
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.samplers.parser import Parser
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

CPU = torch.device("cpu")
SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256, llhist_capacity=32)


def _metric(parser, name: str, value: float = 1.0):
    out = []
    parser.parse_metric_fast(b"%s:%f|c" % (name.encode(), value), out.append)
    return out[0]


def _tables(capacity: int = 64, max_rows: int = 0):
    """A port counter table and the JAX package's, with a parser each."""
    return ((CounterTable(CPU, capacity, max_rows=max_rows), Parser()),
            (JCounterTable(capacity, max_rows=max_rows), JParser()))


def _cycle(table, idle: int):
    """One flush generation, as the servers run it: snapshot, reclaim."""
    table.snapshot_and_reset()
    return table.reclaim_idle(idle)


def _coo(rows, vals):
    return (np.asarray(rows, np.int32), np.asarray(vals, np.float32),
            np.ones(len(rows), np.float32))


def _state(table):
    """The lifecycle state both packages keep, comparable."""
    return (sorted(table.rows.values()),
            [None if mm is None else mm.name for mm in table.meta],
            sorted(table._free_rows), table.keys_dropped,
            table._generation)


def test_idle_rows_tombstoned_then_recycled_like_jax():
    states = []
    for table, parser in _tables():
        table.add(_metric(parser, "a"))
        table.add(_metric(parser, "b"))
        trace = [_cycle(table, 2) for _ in range(4)]
        states.append((trace, _state(table)))
    assert states[0] == states[1]
    trace, (live, meta, free, _dropped, _gen) = states[0]
    assert trace == [[], [], [0, 1], []]
    assert live == [] and meta == [None, None] and free == [0, 1]


def test_active_rows_survive_like_jax():
    for table, parser in _tables():
        for _ in range(6):
            table.add(_metric(parser, "live"))
            assert _cycle(table, 2) == []
        assert len(table.rows) == 1


def test_key_comeback_reuses_free_row_like_jax():
    outs = []
    for table, parser in _tables():
        table.add(_metric(parser, "x"))
        for _ in range(4):
            _cycle(table, 2)
        assert table._free_rows
        table.add(_metric(parser, "y", 7.0))
        row = table.rows[next(iter(table.rows))]
        vals, touched, meta = table.snapshot_and_reset()
        outs.append((row, meta[row].name, bool(touched[row]),
                     float(vals[row]), _state(table)))
    assert outs[0] == outs[1]
    assert outs[0][1:4] == ("y", True, 7.0)


def test_straggler_touch_defers_recycle_like_jax():
    outs = []
    for table, parser in _tables():
        table.add(_metric(parser, "s"))
        _cycle(table, 1)
        assert _cycle(table, 1) == [0]           # tombstoned
        table.add_batch(*_coo([0], [5.0]))       # an in-flight chunk
        vals, touched, meta = table.snapshot_and_reset()
        emitted = (bool(touched[0]), float(vals[0]), meta[0].name)
        deferred = table.reclaim_idle(1) == [] and table.meta[0] is not None
        _cycle(table, 1)
        outs.append((emitted, deferred, table.meta[0] is None))
    assert outs[0] == outs[1] == [((True, 5.0, "s"), True, True)][0]


def test_straggler_between_snapshot_and_reclaim_like_jax():
    outs = []
    for table, parser in _tables():
        table.add(_metric(parser, "s"))
        _cycle(table, 1)
        assert _cycle(table, 1) == [0]
        table.snapshot_and_reset()                # a quiet interval
        table.add_batch(*_coo([0], [5.0]))        # lands in the gap
        not_recycled = (table.reclaim_idle(1) == []
                        and table.meta[0] is not None
                        and not table._free_rows)
        vals, touched, _meta = table.snapshot_and_reset()
        emitted = (bool(touched[0]), float(vals[0]))
        _cycle(table, 1)
        _cycle(table, 1)
        outs.append((not_recycled, emitted, table.meta[0] is None))
    assert outs[0] == outs[1] == (True, (True, 5.0), True)


def test_row_cap_drops_and_counts_like_jax():
    outs = []
    for table, parser in _tables(max_rows=4):
        for i in range(10):
            table.add(_metric(parser, f"k{i}"))
        vals, touched, meta = table.snapshot_and_reset()
        outs.append((len(table.rows), table.keys_dropped,
                     int(touched.sum())))
    assert outs[0] == outs[1] == (4, 6, 4)


def test_recycled_row_drops_its_cached_flush_names():
    """A recycled row's cached flush name and tags are cleared when a
    new key takes it, so its first flush renders the new key."""
    table, parser = _tables()[0]
    table.add(_metric(parser, "old"))
    vals, touched, meta = table.snapshot_and_reset()
    rows = np.flatnonzero(touched)
    assert list(table.flush_names("", rows, meta, lambda m: m.name)) == \
        ["old"]
    table.flush_tags(rows, meta)
    for _ in range(3):
        _cycle(table, 1)
    table.add(_metric(parser, "new", 2.0))
    vals, touched, meta = table.snapshot_and_reset()
    rows = np.flatnonzero(touched)
    assert list(rows) == [0]
    assert list(table.flush_names("", rows, meta, lambda m: m.name)) == \
        ["new"]
    assert table.name_rows == {"new": [0]}


# -- servers ------------------------------------------------------------


def _jax(idle: int, max_rows: int = 2_000_000, **extra):
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.interval = 3600.0
    for key, value in SIZES.items():
        setattr(cfg.tpu, key, value)
    cfg.tpu.idle_key_intervals = idle
    cfg.tpu.max_rows_per_family = max_rows
    for key, value in extra.items():
        setattr(cfg, key, value)
    sink = JChannel()
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    server.metric_extraction._uniqueness_rate = 0.0
    return server, sink


def _port(idle: int, max_rows: int = 2_000_000, **extra):
    tpu = dict(SIZES, idle_key_intervals=idle, max_rows_per_family=max_rows,
               **extra.pop("tpu", {}))
    cfg = config_from_dict({"hostname": "test", "interval": "1h",
                            "tpu": tpu, "ledger_strict": True, **extra})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(5))
    server.metric_extraction.uniqueness_rate = 0.0
    return server, sink


def _flushed(server, sink):
    server.flush()
    return {(mm.name, tuple(mm.tags)): mm.value for mm in sink.drain()
            if "service:veneur-tpu" not in mm.tags
            and not mm.name.startswith(("veneur.", "intern.", "flush."))}


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if "percentile" in key[0] and key[0].startswith("ch.h"):
            np.testing.assert_allclose(got[key], value, rtol=2e-5,
                                       atol=1e-4, err_msg=str(key))
        elif key[0].endswith(".sum") and key[0].startswith("ch.l"):
            np.testing.assert_allclose(got[key], value, rtol=1e-12)
        else:
            assert got[key] == value, key


_FAMILY_LINE = {
    "counter": "ch.c.k{k}:{v}|c|#w:{w}",
    "gauge": "ch.g.k{k}:{v}|g",
    "timer": "ch.h.k{k}:{v}|ms",
    "set": "ch.s.k{k}:m{m}|s",
    "llhist": "ch.l.k{k}:{v}|l",
}


def _wave(family: str, wave: int, keys: int, rng) -> list:
    """Interval `wave`'s lines of one family: key ids [wave*keys/2,
    wave*keys/2 + keys), so half the keys are new and half return from
    the interval before; three samples a key."""
    lines = []
    start = wave * keys // 2
    for k in range(start, start + keys):
        for _ in range(3):
            v = float(np.round(rng.gamma(2.0, 20.0), 3)) + 1.0
            lines.append(_FAMILY_LINE[family].format(
                k=k, v=v, w=k % 3, m=int(rng.integers(50))).encode())
    return lines


@pytest.mark.parametrize("disable_native", [False, True])
@pytest.mark.parametrize("family", sorted(_FAMILY_LINE))
def test_churn_flushes_like_jax_and_stays_bounded(family, disable_native):
    """Eight intervals of churn on one family through each package's
    server: every flush equals the JAX server's, the port's tables stop
    growing and its intern table stays within the rows' bound."""
    keys, waves, idle = 40, 8, 1
    flushes = []
    port_server = None
    for build in (_port, _jax):
        extra = {"tpu": {"disable_native_parser": disable_native}} \
            if build is _port else {}
        server, sink = build(idle, **extra)
        if build is _jax:
            server.config.tpu.disable_native_parser = disable_native
        rng = np.random.default_rng(11)
        rounds = []
        caps = []
        for wave in range(waves):
            server.handle_packet_batch([b"\n".join(_wave(family, wave,
                                                         keys, rng))])
            rounds.append(_flushed(server, sink))
            caps.append(max(t.capacity for _f, t in server.store.tables()))
        flushes.append(rounds)
        if build is _port:
            port_server, port_caps = server, caps
    for got, want in zip(*flushes):
        _assert_same(got, want)
    tables = [t for _f, t in port_server.store.tables()]
    assert port_caps[-3:] == [port_caps[-3]] * 3
    assert sum(t.recycled_total for t in tables) > 0
    live = sum(len(t.rows) for t in tables)
    assert live <= 2 * keys
    assert port_server._ingester.size() <= 2 * keys
    port_server.shutdown()


def test_unique_timeseries_counts_the_interval_like_jax():
    """`count_unique_timeseries`: each flush counts the series of its
    interval, equal to the JAX server's count."""
    lines = [b"u.c%d:1|c" % i for i in range(7)] + \
        [b"u.g%d:2|g" % i for i in range(5)] + \
        [b"u.h:3|ms", b"u.s:x|s", b"u.l:4|l", b"u.c0:1|c|@0.5"]
    counts = []
    for build in (_port, _jax):
        server, _sink = build(5, count_unique_timeseries=True)
        got = []
        for batch in (lines, lines[:6], []):
            if batch:
                server.handle_packet_batch([b"\n".join(batch)])
            got.append(server.store.unique_timeseries())
            server.flush()
        counts.append(got)
    assert counts[0] == counts[1] == [15, 6, 0]
    port, _ = _port(5, count_unique_timeseries=True)
    port.handle_packet_batch([b"\n".join(lines)])
    port.flush()
    text = port.telemetry.registry.render_prometheus()
    assert 'veneur_flush_unique_timeseries_total{global_veneur="true"} 15' \
        in text.splitlines()


@pytest.mark.parametrize("disable_native", [False, True])
def test_row_cap_flushes_like_jax_and_balances_the_ledger(disable_native):
    """`tpu.max_rows_per_family: 20` with 30 counter and 30 `|l` keys:
    the first 20 of each flush exactly like the JAX server's, the
    samples of the other keys count as dropped and as the ledger's
    agg.rejected, and the strict ledger balances."""
    lines = [b"cap.c%d:%d|c" % (i, i + 1) for i in range(30)] + \
        [b"cap.l%d:%d|l" % (i, i + 1) for i in range(30)]
    flushes = []
    for build in (_port, _jax):
        server, sink = build(5, max_rows=20,
                             **({"tpu": {"disable_native_parser":
                                         disable_native}}
                                if build is _port else {}))
        server.handle_packet_batch([b"\n".join(lines)])
        flushes.append(_flushed(server, sink))
        if build is _port:
            port = server
    _assert_same(flushes[0], flushes[1])
    assert len({n for n, _ in flushes[0] if n.startswith("cap.c")}) == 20
    assert port.store.counters.keys_dropped == 10
    assert port.store.llhists.keys_dropped == 10
    assert port.stats_snapshot()["keys_dropped"] == 20
    rejected = port.ledger._history[-1]["stages"]["agg.rejected"]
    assert rejected == {"counter": 10.0, "llhist": 10.0}


def test_evicted_key_returns_through_the_pump():
    """The lifecycle over real UDP on the pump: a key interned through
    the slow path is tombstoned (its native mapping erased), recycled,
    and returns: it re-interns cleanly and aggregates exactly."""
    server, sink = _port(1, statsd_listen_addresses=["udp://127.0.0.1:0"])
    server.start()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        addr = server.listen_addresses[0]

        def send_and_wait(count, want):
            for _ in range(count):
                sock.sendto(b"cycle.key:2|c", addr)
            deadline = time.monotonic() + 10
            while (server.stats_snapshot()["lines_received"] < want
                   and time.monotonic() < deadline):
                time.sleep(0.02)

        send_and_wait(10, 10)
        assert _flushed(server, sink)[("cycle.key", ())] == 20.0
        engine_size = server._ingester.size()
        assert engine_size >= 1
        server.flush()   # idle: tombstoned, native mapping erased
        assert server._ingester.size() < engine_size
        server.flush()   # recycled
        assert server.store.counters._free_rows
        send_and_wait(5, 15)
        assert _flushed(server, sink)[("cycle.key", ())] == 10.0
        assert server._ingester.size() >= 1  # registered again
    finally:
        sock.close()
        server.shutdown()


def test_recycled_rows_emit_correct_values_like_jax():
    outs = []
    for build in (_port, _jax):
        server, sink = build(1)
        server.handle_metric_packet(b"old.key:3|c")
        first = _flushed(server, sink)
        for _ in range(3):
            server.flush()
        sink.drain()
        server.handle_metric_packet(b"new.key:9|c")
        outs.append((first, _flushed(server, sink),
                     server.store.counters.rows[
                         next(iter(server.store.counters.rows))]))
    assert outs[0] == outs[1]
    assert outs[0][1] == {("new.key", ()): 9.0} and outs[0][2] == 0


def test_query_skips_a_recycled_row():
    """The live query plane's name index never answers a name with a
    row that another key took since."""
    from veneur_tpu_torch.core.query import QuerySpec
    server, _sink = _port(1)
    server.handle_metric_packet(b"q.old:3|c")
    server.flush()
    for _ in range(2):
        server.flush()
    server.handle_metric_packet(b"q.new:5|c")
    old = server.query_plane.query(QuerySpec.build("q.old", "count"))
    new = server.query_plane.query(QuerySpec.build("q.new", "count"))
    assert old["matched_rows"] == 0
    assert new["matched_rows"] == 1 and new["value"] == 5.0
