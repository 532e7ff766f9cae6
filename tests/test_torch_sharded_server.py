"""The port's sharded serving plane in a server, on the CPU: the flush of
a server with `tpu.shards` against a single-store server of the port and
a sharded server of the JAX package (8 virtual CPU devices,
tests/conftest.py), the x-veneur-shards metadata and the peer-shards
gauge over real gRPC, the config keys, the startup event, and the
overlapped flush on sharded tables.

Mirrors tests/test_sharded_store.py's TestShardedServerEquivalence and
test_mesh_plane.py's TestShardedServerFlush and TestPeerShardsWindow.
Tolerances as in tests/test_torch_sharded.py: counters, gauges and
llhist series bit for bit; t-digest series within rtol 2e-5 / atol 1e-4
of the JAX sharded server (tests/test_pallas.py:97) and within
tests/test_sharded_store.py's slack of a single store."""

from __future__ import annotations

import time

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JSink
from veneur_tpu_torch.config import config_from_dict, read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.sharded_tables import (ShardedCounterTable,
                                                  ShardedHistoTable,
                                                  ShardedSetTable)
from veneur_tpu_torch.forward.server import ImportServer
from veneur_tpu_torch.forward.wire import (SHARDS_KEY, extract_shards,
                                           shards_metadata)
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

from test_torch_forward import (AGGS, PS, SIZES, _assert_series_agree,
                                _pair_corpus, _series, _wait_for)

K1_TOL = dict(rtol=2e-5, atol=1e-4)


def _tpu(shards, **extra):
    tpu = dict(counter_capacity=256, gauge_capacity=256,
               histo_capacity=256, set_capacity=128, batch_cap=128,
               shards=shards)
    tpu.update(extra)
    return tpu


def _port(shards, **extra):
    tpu = _tpu(shards, **extra.pop("tpu", {}))
    cfg = config_from_dict({"interval": "60s", "hostname": "test",
                            "percentiles": [0.5, 0.9, 0.99],
                            "statsd_listen_addresses": [], "tpu": tpu,
                            **extra})
    sink = ChannelMetricSink()
    return Server(cfg, device="cpu", extra_metric_sinks=[sink]), sink


def _jax(shards, **extra):
    cfg = JConfig()
    cfg.interval = 60.0
    cfg.hostname = "test"
    cfg.num_readers = 1
    cfg.statsd_listen_addresses = []
    cfg.percentiles = [0.5, 0.9, 0.99]
    for k, v in _tpu(shards, **extra.pop("tpu", {})).items():
        setattr(cfg.tpu, k, v)
    for k, v in extra.items():
        setattr(cfg, k, v)
    sink = JSink()
    return JServer(cfg.apply_defaults(), extra_metric_sinks=[sink]), sink


def _flush_map(server, sink):
    server.flush()
    return {(m.name, tuple(sorted(m.tags))): m.value
            for m in sink.wait_flush()}


def _close(*servers):
    for server in servers:
        server.config.flush_on_shutdown = False
        server.shutdown()


def _traffic(seed=99):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        for _ in range(8):
            out.append(b"sh.timer.%d:%.3f|ms" % (i % 10, rng.normal(100, 15)))
            out.append(b"sh.set.%d:user%d|s" % (i % 5, rng.integers(0, 500)))
            out.append(b"sh.count:2|c")
            out.append(b"sh.gauge.%d:%.2f|g" % (i % 7, rng.normal()))
            out.append(b"sh.ll.%d:%.3f|l" % (i % 6, rng.lognormal(2, 1)))
    return out


def _feed(server, packets):
    for pkt in packets:
        server.handle_metric_packet(pkt)
    server.store.apply_all_pending()


def test_flush_matches_single_device():
    """tests/test_sharded_store.py's server equivalence: 8 shards flush
    what one store flushes (the documented quantile slack for the
    t-digest, exact otherwise) and what the JAX sharded server flushes."""
    single, s1 = _port(1)
    sharded, s8 = _port(8)
    jsharded, j8 = _jax(8)
    try:
        assert isinstance(sharded.store.histos, ShardedHistoTable)
        assert isinstance(sharded.store.sets, ShardedSetTable)
        assert isinstance(sharded.store.counters, ShardedCounterTable)
        assert len(sharded.store.histos.states) == 8
        assert sharded.store.shard_plane.routing == "digest"
        for server in (single, sharded, jsharded):
            _feed(server, _traffic())
        got1 = _flush_map(single, s1)
        got8 = _flush_map(sharded, s8)
        jgot = _flush_map(jsharded, j8)
        assert set(got1) == set(got8) == set(jgot)
        for key in got1:
            name = key[0]
            approx = ("percentile" in name or name.endswith(
                (".avg", ".median")) or name.startswith("sh.timer"))
            if approx:
                assert got8[key] == pytest.approx(got1[key], rel=0.05,
                                                  abs=1.5), key
                np.testing.assert_allclose(got8[key], jgot[key],
                                           err_msg=str(key), **K1_TOL)
            elif name.endswith(".sum") and name.startswith("sh.ll"):
                assert got8[key] == got1[key], key
                # the llhist sum is a dot product over the rows read out
                assert got8[key] == pytest.approx(jgot[key], rel=1e-12)
            else:
                assert got8[key] == got1[key] == jgot[key], key
    finally:
        _close(single, sharded, jsharded)


def test_flush_parity_with_circllhist_encoding():
    """A `circllhist` server (timers in the llhist family) flushes bit
    for bit what a single store flushes, sharded or not."""
    extra = {"histogram_encoding": "circllhist"}
    single, s1 = _port(1, **extra, tpu={"llhist_capacity": 128})
    sharded, s4 = _port(4, **extra, tpu={"llhist_capacity": 128})
    jsharded, j4 = _jax(4, **extra, tpu={"llhist_capacity": 128})
    try:
        rng = np.random.default_rng(7)
        pkts = []
        for i in range(200):
            v = rng.lognormal(3, 1)
            pkts += [b"mp.srv.t%d:%.4f|ms" % (i % 16, v), b"mp.srv.c:3|c",
                     b"mp.srv.g%d:%d|g" % (i % 4, i)]
        for server in (single, sharded, jsharded):
            _feed(server, pkts)
        got1 = _flush_map(single, s1)
        got4 = _flush_map(sharded, s4)
        jgot = _flush_map(jsharded, j4)
        assert set(got1) == set(got4) == set(jgot)
        for key in got1:
            assert got1[key] == got4[key], key
            if key[0].endswith(".sum"):
                assert got4[key] == pytest.approx(jgot[key], rel=1e-12)
            else:
                assert got4[key] == jgot[key], key
    finally:
        _close(single, sharded, jsharded)


def test_recycled_spare_keeps_per_shard_state():
    """Repeated flush rounds recycle each drained generation as the next
    spare: the per-shard lists keep one state per shard on the store's
    device, and every round flushes its own interval alone."""
    server, sink = _port(2, tpu={"histo_capacity": 128,
                                 "set_capacity": 64})
    try:
        seen = {}
        for rnd in range(4):
            pkts = []
            for i in range(20):
                pkts += [b"mp.spare.t:%0.1f|ms" % (i + 1.0),
                         b"mp.spare.s:m%d|s" % (i % 5),
                         b"mp.spare.c:1|c"]
            _feed(server, pkts)
            got = _flush_map(server, sink)
            assert got[("mp.spare.t.count", ())] == 20.0, rnd
            assert got[("mp.spare.t.max", ())] == 20.0, rnd
            assert got[("mp.spare.s", ())] == 5.0, rnd
            assert got[("mp.spare.c", ())] == 20.0, rnd
            for table in (server.store.histos, server.store.sets):
                assert len(table.states) == 2
                ids = tuple(id(st) for st in table.states)
                seen.setdefault(table.family, []).append(ids)
            counters = server.store.counters
            assert counters._spare is not None
            assert counters._spare["sum"].shape == (2, 256)
        # from round 2 the live generation is a recycled one
        for family, ids in seen.items():
            assert ids[2] == ids[0] and ids[3] == ids[1], family
    finally:
        _close(server)


# -- the shard metadata and the peer-shards gauge ---------------------------


class _Ctx:
    def __init__(self, n):
        self._md = ((SHARDS_KEY, str(n)),) if n else ()

    def invocation_metadata(self):
        return self._md


def test_peer_shards_gauge_decays():
    """mesh.peer_shards is a rolling two-window max: a sender that falls
    back to single tables (header gone) rolls the window with its
    notes and the gauge drops to 0."""
    imp = ImportServer.__new__(ImportServer)
    imp.PEER_SHARDS_WINDOW_S = 60.0
    imp._peer_shards_cur = 0
    imp._peer_shards_prev = 0
    imp._peer_shards_t0 = time.monotonic()
    imp._note_peer_shards(_Ctx(4))
    assert imp.peer_shards == 4
    imp._peer_shards_t0 -= 61.0
    imp._note_peer_shards(_Ctx(0))
    assert imp.peer_shards == 4  # the previous window is still in view
    imp._peer_shards_t0 -= 61.0
    imp._note_peer_shards(_Ctx(0))
    assert imp.peer_shards == 0  # decayed
    # a gap longer than two windows clears both slots at once
    imp._note_peer_shards(_Ctx(8))
    imp._peer_shards_t0 -= 121.0
    imp._note_peer_shards(_Ctx(0))
    assert imp.peer_shards == 0


def test_shard_metadata_equals_jax():
    from veneur_tpu.forward import wire as jwire
    for n in (0, 1, 2, 8, 128):
        assert shards_metadata(n) == jwire.shards_metadata(n)
    for md in ((), ((SHARDS_KEY, "4"),), ((SHARDS_KEY, "x"),),
               ((SHARDS_KEY, "-3"),), (("other", "5"),)):
        class Ctx:
            def invocation_metadata(self, md=md):
                return md
        assert extract_shards(Ctx()) == jwire.extract_shards(Ctx())


def _pair(make, shards: int):
    """Two locals of `shards` shards forwarding to one global of the same
    package over gRPC; the series of the global flush and its peer
    shard count."""
    gserver, gsink = make(shards, grpc_address="127.0.0.1:0")
    corpus = _pair_corpus()
    locals_ = [make(shards, forward_address=gserver.import_server.address)
               for _ in corpus]
    try:
        for (server, _), (lines, _n) in zip(locals_, corpus):
            for line in lines:
                server.handle_metric_packet(line)
        for server, sink in locals_:
            server.flush()
            sink.wait_flush(timeout=20)
        expected = sum(n for _lines, n in corpus)
        assert _wait_for(
            lambda: gserver.import_server.imported_total == expected), \
            gserver.import_server.imported_total
        gserver.flush()
        series = _series(gsink.wait_flush(timeout=20))
        peer = gserver.import_server.peer_shards
    finally:
        for server, _ in locals_:
            server.shutdown()
        gserver.shutdown()
    return series, peer, gserver


def _pair_port(shards, **extra):
    tpu = dict(SIZES, shards=shards)
    cfg = config_from_dict({"interval": "1h", "hostname": "test",
                            "percentiles": list(PS),
                            "aggregates": list(AGGS), "tpu": tpu, **extra})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink])
    server.metric_extraction.uniqueness_rate = 0.0
    server.start()
    return server, sink


def _pair_jax(shards, **extra):
    cfg = JConfig()
    cfg.interval = 3600.0
    cfg.hostname = "test"
    cfg.percentiles = list(PS)
    cfg.aggregates = list(AGGS)
    for k, v in dict(SIZES, shards=shards).items():
        setattr(cfg.tpu, k, v)
    for k, v in extra.items():
        setattr(cfg, k, v)
    sink = JSink()
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    server.metric_extraction._uniqueness_rate = 0.0
    server.start()
    return server, sink


def test_sharded_locals_forward_to_a_sharded_global_like_jax():
    """Two 4-shard locals into a 4-shard global over gRPC: every send
    carries x-veneur-shards, the global's mesh.peer_shards reads 4, and
    its flush equals the JAX package's sharded trio's; an unsharded
    trio's global reads 0 and flushes the same counters, gauges, sets
    and llhists."""
    got, peer, gserver = _pair(_pair_port, 4)
    want, jpeer, _ = _pair(_pair_jax, 4)
    assert peer == jpeer == 4
    rows = {r[0]: r[2] for r in gserver.import_server.telemetry_rows()}
    assert rows["mesh.peer_shards"] == 4.0
    _assert_series_agree(got, want)
    single, peer1, _ = _pair(_pair_port, 1)
    assert peer1 == 0
    assert set(single) == set(got)
    for key, value in single.items():
        name = key[0]
        if not (name.startswith("h") or "percentile" in name
                or name.endswith((".avg", ".median"))):
            assert got[key] == value, key


# -- config, startup, overlapped flush ---------------------------------------


@pytest.mark.parametrize("text, env", [
    ("tpu:\n  shards: 4\n  shard_routing: roundrobin\n", {}),
    ("tpu:\n  shards: 4\n", {"VENEUR_TPU_SHARDS": "8",
                              "VENEUR_TPU_SHARD_ROUTING": "roundrobin"}),
    ("", {"VENEUR_TPU_SHARDS": "2"}),
    ("", {}),
])
def test_shard_keys_load_like_jax(tmp_path, text, env):
    from veneur_tpu import config as jax_config
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    port_cfg = read_config(str(path), env=env)
    jax_cfg = jax_config.read_config(str(path), env=env)
    assert port_cfg.tpu.shards == jax_cfg.tpu.shards
    assert port_cfg.tpu.shard_routing == jax_cfg.tpu.shard_routing


@pytest.mark.parametrize("tpu, match", [
    ({"shard_routing": "modulo"}, "shard_routing"),
    ({"shards": 129}, "shards"),
    ({"shards": -1}, "shards"),
    ({"pallas_tdigest_flush": True}, "pallas_tdigest_flush"),
])
def test_shard_keys_refuse_what_the_port_cannot_do(tpu, match):
    with pytest.raises(ValueError, match=match):
        config_from_dict({"tpu": tpu})


def test_startup_event_carries_the_shard_topology():
    server, _sink = _port(4, tpu={"shard_routing": "roundrobin"})
    try:
        server.start()
        events = server.telemetry.events.snapshot(kind="startup")
        assert events[-1]["mesh"] == {
            "shards": 4, "routing": "roundrobin",
            "devices": ["cpu:0"] * 4}
        assert server.forward_client is None
    finally:
        _close(server)
    plain, _ = _port(1)
    try:
        plain.start()
        assert "mesh" not in plain.telemetry.events.snapshot(
            kind="startup")[-1]
    finally:
        _close(plain)


def test_flush_async_on_sharded_tables_delivers_like_a_sync_single_store():
    """`flush_async` on a 4-shard server: the readout of interval N runs
    on the executor beside interval N+1's ingest, and each interval is
    delivered with the series a synchronous single store flushes."""
    sync, s_sink = _port(1)
    over, o_sink = _port(4, flush_async=True)
    try:
        want_prev = None
        for rnd in range(3):
            pkts = _traffic(seed=rnd)
            _feed(sync, pkts)
            _feed(over, pkts)
            want = _flush_map(sync, s_sink)
            over.flush()
            assert _wait_for(
                lambda: over._inflight_flushes[0]["pending"].done())
            if want_prev is None:
                assert o_sink.drain() == []
                want_prev = want
                continue
            got = {(m.name, tuple(sorted(m.tags))): m.value
                   for m in o_sink.wait_flush()}
            # interval 1 is delivered at the tick after it
            assert set(got) == set(want_prev)
            for key, value in want_prev.items():
                if key[0].startswith("sh.timer"):
                    assert got[key] == pytest.approx(value, rel=0.05,
                                                     abs=1.5), key
                else:
                    assert got[key] == value, key
            want_prev = want
        assert over.store.shard_plane.merge_rounds >= 10
    finally:
        _close(sync, over)


@pytest.mark.parametrize("encoding", ["tdigest", "circllhist"])
def test_queries_on_a_sharded_server_match_the_next_flush(encoding):
    """The live query plane over sharded tables: each family's query
    merges the live shards without zeroing them, and equals the next
    flush's readout of the same generation, exactly."""
    from test_torch_query import (_assert_queries_match_flush, _flushed,
                                  _query_all, corpus)
    from test_torch_query import mk_server as query_server
    server, obs = query_server(histogram_encoding=encoding,
                               tpu={"shards": 4})
    try:
        assert server.store.shard_plane.n == 4
        _feed(server, corpus())
        rounds = server.store.shard_plane.merge_rounds
        queries = _query_all(server)
        assert server.store.shard_plane.merge_rounds > rounds
        server.flush()
        _assert_queries_match_flush(queries, _flushed(obs.drain()))
    finally:
        _close(server)


def test_prewarm_ladder_climbs_sharded_tables():
    """The shape-ladder prewarmer launches each sharded family's next
    rung (the set family's too: its dense per-shard banks track the row
    capacity) without touching the live shards or the routed counts."""
    server, sink = _port(4, prewarm_ladder=True,
                         tpu={"counter_capacity": 64, "gauge_capacity": 64,
                              "histo_capacity": 64, "set_capacity": 64,
                              "llhist_capacity": 64})
    try:
        server.start()
        assert _wait_for(lambda: all(
            128 in table._prewarmed_caps
            for _f, table in server.store.tables() if _f != "status"),
            timeout=60)
        routed = dict(server.store.shard_plane._samples)
        assert routed == {}
        _feed(server, _traffic(seed=3))
        got = _flush_map(server, sink)
        assert got[("sh.count", ())] == 320 * 2.0
    finally:
        _close(server)
