"""The port's proxy tier against the JAX package's, on the CPU: the
consistent-hash rings (every key's member through add, remove,
set_members and walk_at), the native route walk (byte for byte), the
proxy's routing of the same V1 body, locals -> proxy -> two globals
against the JAX trio, interop through each package's proxy, ring health
(hand-driven ejection and readmission, readiness), failover, hedged
sends deduplicated by their token, V1 -> V2 pinning, a kill and restore
of the forward target under the strict flow ledger, and the proxy CLI's
config handling."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.forward.protos import forward_pb2 as jforward_pb2
from veneur_tpu.proxy import ring as jring
from veneur_tpu.proxy.proxy import create_static_proxy as jcreate_proxy
from veneur_tpu.testing.forwardtest import ForwardTestServer
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.cmd import veneur_proxy as tcli
from veneur_tpu_torch.core.httpapi import HTTPApi
from veneur_tpu_torch.forward.client import ForwardClient as TClient
from veneur_tpu_torch.forward.protos import metric_pb2 as tmetric_pb2
from veneur_tpu_torch.forward.wire import _frame_v1, token_metadata
from veneur_tpu_torch.proxy import ring as tring
from veneur_tpu_torch.proxy.destinations import Destination, Destinations
from veneur_tpu_torch.proxy.health import RingHealth
from veneur_tpu_torch.proxy.proxy import create_static_proxy as tcreate_proxy
from veneur_tpu_torch.util.matcher import TagMatcher

from test_torch_forward import (_assert_series_agree, _jserver, _pair_corpus,
                                _run_pair, _series, _tserver)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBERS = [f"10.0.{i // 4}.{i % 4}:8128" for i in range(6)]


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _ring_keys(n=10_000, seed=0):
    """Seeded ring keys in the proxy's shape: name + type + joined tags."""
    rng = np.random.default_rng(seed)
    types_ = ["counter", "gauge", "timer", "set", "llhist", "histogram"]
    out = []
    for i in range(n):
        tags = ",".join(f"t{j}:{rng.integers(0, 50)}"
                        for j in range(rng.integers(0, 4)))
        out.append(f"m.{rng.integers(0, 10**6)}.{i}"
                   f"{types_[i % len(types_)]}{tags}")
    return out


KEYS = _ring_keys()


def _rings(kind):
    if kind == "consistent":
        return jring.ConsistentRing(), tring.ConsistentRing()
    return jring.ShardGroupRing(3), tring.ShardGroupRing(3)


def _placement(ring, keys):
    return [ring.get(k) for k in keys]


@pytest.mark.parametrize("kind,step", [
    (kind, step) for kind in ("consistent", "shard_group")
    for step in ("add", "remove", "set_members", "walk_at")]
    + [("shard_group", "regroup")])
def test_ring_places_every_key_as_jax(kind, step):
    jr, tr = _rings(kind)
    for ring in (jr, tr):
        if kind == "shard_group":
            ring.assign(MEMBERS[0], 2)  # a `#2` discovery pin
        ring.set_members(MEMBERS[:4])
    assert _placement(tr, KEYS) == _placement(jr, KEYS)
    if step == "add":
        for ring in (jr, tr):
            ring.add(MEMBERS[4])
    elif step == "remove":
        for ring in (jr, tr):
            ring.remove(MEMBERS[1])
    elif step == "set_members":
        for ring in (jr, tr):
            ring.set_members(MEMBERS[2:])
    elif step == "regroup":
        assert tr.regroup(2) == jr.regroup(2)
    if step == "walk_at":
        for key in KEYS[:2000]:
            point = tr.point_of(key)
            assert point == jr.point_of(key)
            assert tr.walk_at(point, 3) == jr.walk_at(point, 3)
    assert tr.members() == jr.members()
    assert _placement(tr, KEYS) == _placement(jr, KEYS)


def test_ring_points_and_suffixes_match_jax():
    for member in MEMBERS:
        for i in range(20):
            assert (tring.ConsistentRing()._point(member, i)
                    == jring.ConsistentRing()._point(member, i))
    for address in ("h:1#3", "h:1", "h#x", "[::1]:8128#0"):
        assert tring.parse_shard_suffix(address) == \
            jring.parse_shard_suffix(address)
    jr, tr = _rings("shard_group")
    for ring in (jr, tr):
        ring.set_members(MEMBERS)
    for member in MEMBERS:
        assert tr.group_siblings(member, 4) == jr.group_siblings(member, 4)
    with pytest.raises(tring.EmptyRingError):
        tring.ConsistentRing().get("x")


# -- the native route walk ------------------------------------------------

def _metric(rng, i):
    kind = i % 5
    m = tmetric_pb2.Metric(name=f"r.{rng.integers(0, 10**6)}.{i}",
                           scope=int(rng.integers(0, 3)))
    m.tags.extend(f"k{j}:{rng.integers(0, 9)}"
                  for j in range(rng.integers(0, 4)))
    if kind == 0:
        m.type = tmetric_pb2.Counter
        m.counter.value = int(rng.integers(-5, 10**9))
    elif kind == 1:
        m.type = tmetric_pb2.Gauge
        m.gauge.value = float(rng.normal())
    elif kind == 2:
        m.type = tmetric_pb2.Timer
        d = m.histogram.t_digest
        for _ in range(rng.integers(1, 6)):
            c = d.main_centroids.add()
            c.mean, c.weight = float(rng.gamma(2.0)), 1.0
        d.min, d.max = 0.0, 9.0
    elif kind == 3:
        m.type = tmetric_pb2.Set
        m.set.hyper_log_log = bytes(rng.integers(0, 255, 40, np.uint8))
    else:
        m.type = tmetric_pb2.LLHist
        m.llhist.bins = bytes(rng.integers(0, 255, 24, np.uint8))
    return m


def _body(metrics):
    return b"".join(_frame_v1(m.SerializeToString()) for m in metrics)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_parse_matches_jax_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    body = _body([_metric(rng, i) for i in range(300)])
    got = tnative.route_parse(body)
    assert got is not None
    assert got == jnative.route_parse(body)
    keys, raws = got
    assert len(keys) == 300 and all(keys)
    assert b"".join(_frame_v1(r) for r in raws) == body


def test_route_parse_wide_enum_and_invalid_utf8_match_jax():
    wide = tmetric_pb2.Metric(name="wide",
                              counter=tmetric_pb2.CounterValue(value=1))
    wide.type = 300  # past the identity key's one-byte field
    fine = tmetric_pb2.Metric(name="fine", type=tmetric_pb2.Counter,
                              counter=tmetric_pb2.CounterValue(value=2))
    poison = b"\x0a\x01\xff\x2a\x02\x08\x01"  # name = b"\xff"
    for body in (_body([fine, wide]),
                 _frame_v1(fine.SerializeToString()) + _frame_v1(poison)):
        got = tnative.route_parse(body)
        assert got == jnative.route_parse(body)
    keys, _raws = tnative.route_parse(_body([fine, wide]))
    assert keys[1] == b""  # the upb path decides the wide enum
    assert tnative.route_parse(b"") is None
    assert tnative.route_parse(b"\x0a\x7f") == jnative.route_parse(b"\x0a\x7f")


# -- routing through both proxies -------------------------------------------

def _capture_servers(n):
    received = [[] for _ in range(n)]
    servers = []
    for i in range(n):
        server = ForwardTestServer(received[i].extend)
        server.start()
        servers.append(server)
    return servers, received


def _route_through(create, body, addresses, received, ignore=None,
                   stream=False):
    proxy = create(addresses, health_check_interval=0,
                   ignore_tags=ignore or [])
    proxy.start()
    try:
        if stream:
            for m in jforward_pb2.MetricList.FromString(body).metrics:
                proxy.handle_metric(m)
        else:
            proxy._route_native(body)
        want = len(jforward_pb2.MetricList.FromString(body).metrics)
        assert _wait_for(lambda: sum(len(r) for r in received) == want)
        return [sorted(m.SerializeToString() for m in r) for r in received]
    finally:
        proxy.stop()


@pytest.mark.parametrize("path", ["native", "stream", "ignored_tags"])
def test_proxy_routes_every_metric_where_jax_does(path):
    rng = np.random.default_rng(7)
    body = _body([_metric(rng, i) for i in range(400)])
    servers, received = _capture_servers(3)
    addresses = [s.address for s in servers]
    ignore = ([TagMatcher(kind="prefix", value="k1")]
              if path == "ignored_tags" else None)
    try:
        placements = []
        for create, matcher in ((jcreate_proxy, "jax"),
                                (tcreate_proxy, "torch")):
            for r in received:
                r.clear()
            ig = None
            if ignore is not None:
                from veneur_tpu.util.matcher import TagMatcher as JMatcher
                ig = ([JMatcher(kind="prefix", value="k1")]
                      if matcher == "jax" else ignore)
            placements.append(_route_through(
                create, body, addresses, received, ig,
                stream=path == "stream"))
        assert placements[0] == placements[1]
        assert sum(len(p) > 0 for p in placements[1]) == 3
    finally:
        for s in servers:
            s.stop()


def test_route_cache_key_is_the_jax_ring_key():
    servers, received = _capture_servers(1)
    proxy = tcreate_proxy([servers[0].address], health_check_interval=0,
                          ignore_tags=[TagMatcher(kind="prefix",
                                                  value="drop")])
    proxy.start()
    try:
        m = tmetric_pb2.Metric(name="ik", tags=["drop:a", "keep:1"],
                               type=tmetric_pb2.Counter,
                               counter=tmetric_pb2.CounterValue(value=1))
        assert proxy._route_native(_body([m])) == (1, 1)
        (_key, (point, key_hash)), = proxy._route_cache.items()
        assert point == jring.ConsistentRing.point_of("ikcounterkeep:1")
        from veneur_tpu.ops import hll_ref as jhll
        assert key_hash == jhll.hash_member(b"ikcounterkeep:1")
    finally:
        proxy.stop()
        servers[0].stop()


def test_invalid_utf8_is_rejected_and_never_forwarded():
    servers, received = _capture_servers(1)
    proxy = tcreate_proxy([servers[0].address], health_check_interval=0)
    proxy.start()
    try:
        ok = tmetric_pb2.Metric(name="clean", type=tmetric_pb2.Counter,
                                counter=tmetric_pb2.CounterValue(value=1))
        body = (_frame_v1(ok.SerializeToString())
                + _frame_v1(b"\x0a\x01\xff\x2a\x02\x08\x01"))
        with pytest.raises(Exception):
            proxy._route_native(body)
        assert _wait_for(lambda: received[0])
        time.sleep(0.2)
        assert [m.name for m in received[0]] == ["clean"]
        assert proxy.stats["routed_total"] == 1
    finally:
        proxy.stop()
        servers[0].stop()


# -- locals -> proxy -> two globals ------------------------------------------

def _run_trio(package: str):
    """Two locals -> one proxy -> two globals of one package (the
    corpus of test_torch_forward's pair); the globals' series united,
    and each global's series."""
    make = _jserver if package == "jax" else _tserver
    create = jcreate_proxy if package == "jax" else tcreate_proxy
    extra = {} if package == "jax" else {"ledger_strict": True}
    globals_ = [make(grpc_address="127.0.0.1:0", **extra) for _ in range(2)]
    proxy = create([g.import_server.address for g, _ in globals_],
                   health_check_interval=0, ledger_strict=True)
    proxy.start()
    corpus = _pair_corpus()
    locals_ = [make(forward_address=proxy.address, **extra)
               for _ in corpus]
    try:
        for (server, _), (lines, _n) in zip(locals_, corpus):
            for line in lines:
                server.handle_metric_packet(line)
        # one local's forward at a time: a global's digest merge depends
        # on whether the proxy batched both locals' digests of a key into
        # one import (test_trio_rows_do_not_depend_on_the_proxy_s_batching)
        expected = 0
        for (server, _sink), (_lines, n) in zip(locals_, corpus):
            server.flush()
            expected += n
            assert _wait_for(lambda: sum(
                g.import_server.imported_total
                for g, _ in globals_) == expected)
        per_global = []
        for g, sink in globals_:
            g.flush()
            per_global.append(_series(sink.drain()))
        proxy.ledger.close_interval()  # strict: raises on an imbalance
        if package == "torch":
            for server, _ in locals_:
                assert server.forward_client.last_flow == {
                    "received": 25, "merged": 25, "duplicate": False}
                assert not any(any(i.values()) for i in
                               server.ledger.history_imbalances())
            assert proxy.stats["received_total"] == 50
            assert proxy.stats["routed_total"] == 50
    finally:
        for server, _ in locals_:
            server.shutdown()
        proxy.stop()
        for g, _ in globals_:
            g.shutdown()
    union = {}
    for series in per_global:
        assert not set(series) & set(union)
        union.update(series)
    return union, per_global


def _agree_across_placements(got, want):
    """_assert_series_agree, except the llhist `.sum`: both packages
    compute it as one float64 dot product of the exact registers with
    the bin midpoints over the flushed batch (numpy's BLAS), whose
    summation order follows the batch's row count, and the two trios'
    globals hold different row sets (their ring members differ by port).
    The registers themselves (`.count`, every `.bucket`) stay exact."""
    sums = {k for k in want if k[0].startswith("l") and k[0].endswith(".sum")}
    assert sums
    for key in sums:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key
    _assert_series_agree({k: v for k, v in got.items() if k not in sums},
                         {k: v for k, v in want.items() if k not in sums})


def test_locals_proxy_two_globals_flush_like_the_jax_trio():
    jseries, jper = _run_trio("jax")
    tseries, tper = _run_trio("torch")
    _agree_across_placements(tseries, jseries)
    # both globals took a share; counters summed over both locals
    assert all(tper) and all(jper)
    assert ("fc0", (), "COUNTER") in tseries


def test_trio_rows_do_not_depend_on_the_proxy_s_batching(monkeypatch):
    """A global merges the digests of one import batch that share a key
    slot by slot before one recompress, and two imports with a recompress
    each (both packages: `merge_centroid_rows`), so a key's quantiles
    follow how the proxy's sender batched the two locals' forwards. The
    trio sends one local's forward only once the globals have imported
    the other's, so no batch holds both; here the port proxy's senders
    wait before each drain, which would put both locals' digests in one
    batch if the second local flushed early, and the rows must still be
    the JAX trio's."""
    drain = Destination._drain_batch

    def late_drain(self):
        # hold the first metric's batch open for a second
        deadline = time.monotonic() + self._flush_interval
        while self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        if not self._queue.empty():
            time.sleep(1.0)
        return drain(self)

    jseries, _jper = _run_trio("jax")
    monkeypatch.setattr(Destination, "_drain_batch", late_drain)
    tseries, _tper = _run_trio("torch")
    _agree_across_placements(tseries, jseries)


def test_jax_local_through_the_port_proxy():
    _locals, want = _run_pair("jax")
    gserver, gsink = _tserver(grpc_address="127.0.0.1:0",
                              ledger_strict=True)
    proxy = tcreate_proxy([gserver.import_server.address],
                          health_check_interval=0, ledger_strict=True)
    proxy.start()
    corpus = _pair_corpus()
    locals_ = [_jserver(forward_address=proxy.address) for _ in corpus]
    try:
        for (server, _), (lines, _n) in zip(locals_, corpus):
            for line in lines:
                server.handle_metric_packet(line)
            server.flush()
        assert _wait_for(lambda: gserver.import_server.imported_total == 50)
        gserver.flush()
        got = _series(gsink.drain())
        proxy.ledger.close_interval()
    finally:
        for server, _ in locals_:
            server.shutdown()
        proxy.stop()
        gserver.shutdown()
    _assert_series_agree(got, want)


def test_port_local_through_the_jax_proxy():
    _locals, want = _run_pair("jax")
    gserver, gsink = _jserver(grpc_address="127.0.0.1:0")
    proxy = jcreate_proxy([gserver.import_server.address],
                          health_check_interval=0)
    proxy.start()
    corpus = _pair_corpus()
    locals_ = [_tserver(forward_address=proxy.address, ledger_strict=True)
               for _ in corpus]
    try:
        for (server, _), (lines, _n) in zip(locals_, corpus):
            for line in lines:
                server.handle_metric_packet(line)
            server.flush()
            assert server.forward_client.last_flow["merged"] == 25
        assert _wait_for(lambda: gserver.import_server.imported_total == 50)
        gserver.flush()
        got = _series(gsink.drain())
    finally:
        for server, _ in locals_:
            server.shutdown()
        proxy.stop()
        gserver.shutdown()
    _assert_series_agree(got, want)


# -- ring health, failover, readiness ----------------------------------------

def _mkmetric(name, value=1):
    m = tmetric_pb2.Metric(name=name, type=tmetric_pb2.Counter,
                           scope=tmetric_pb2.Global)
    m.counter.value = value
    return m


def test_hand_driven_ejection_and_readmission():
    ft1 = ForwardTestServer(lambda ms: None)
    ft1.start()
    ft2 = ForwardTestServer(lambda ms: None)
    ft2.start()
    dests = Destinations(flush_interval=0.1)
    dests.set_destinations([ft1.address, ft2.address])
    events = []
    health = RingHealth(dests, interval=0.05, timeout=0.5,
                        unhealthy_after=2, healthy_after=2,
                        on_event=lambda kind, **f: events.append((kind, f)))
    keys = [f"k{i}" for i in range(200)]
    before = {k: dests.get(k).address for k in keys}
    try:
        health.run_round()
        assert dests.ejected_addresses() == []
        port = ft1.port
        ft1.stop()
        health.run_round()
        assert dests.ejected_addresses() == []  # 1 failure < threshold
        health.run_round()
        assert dests.ejected_addresses() == [ft1.address]
        assert ft1.address in dests.addresses()  # still probed
        assert ("ring_ejection", {"destination": ft1.address,
                                  "consecutive_failures": 2}) in events
        assert all(dests.get(k).address == ft2.address for k in keys)
        ft1 = ForwardTestServer(lambda ms: None, address=f"127.0.0.1:{port}")
        ft1.start()
        health.run_round()
        assert dests.ejected_addresses() == [ft1.address]
        health.run_round()
        assert dests.ejected_addresses() == []
        assert {k: dests.get(k).address for k in keys} == before
        rows = {r[0]: r[2] for r in health.telemetry_rows()}
        assert rows["proxy.ring.ejections"] == 1.0
        assert rows["proxy.ring.readmissions"] == 1.0
    finally:
        dests.clear()
        ft1.stop()
        ft2.stop()



def test_readmission_waits_for_the_members_channel(monkeypatch):
    """A member whose probes pass again is readmitted only once its gRPC
    channel is connected: while channel_ready says no (the reconnect
    backoff of the outage), it stays ejected round after round, and the
    member table reports it ejected while the prober waits on its
    channel."""
    ft = ForwardTestServer(lambda ms: None)
    ft.start()
    dests = Destinations(flush_interval=0.1)
    dests.set_destinations([ft.address])
    health = RingHealth(dests, interval=0.05, timeout=0.5,
                        unhealthy_after=1, healthy_after=1)
    ready, table = [], []
    real = dests.channel_ready

    def channel_ready(address, timeout):
        ready.append(address)
        table.append([m["ejected"] for m in health.member_table()])
        return len(ready) > 2 and real(address, timeout)
    monkeypatch.setattr(dests, "channel_ready", channel_ready)
    try:
        dests.eject(ft.address)
        for _ in range(2):
            health.run_round()
            assert dests.ejected_addresses() == [ft.address]
        health.run_round()
        assert dests.ejected_addresses() == []
        assert ready == [ft.address] * 3
        assert table == [[True]] * 3
        assert health.member_table()[0]["ejected"] is False
        assert ft.address in dests.ring.members()
        rows = {r[0]: r[2] for r in health.telemetry_rows()}
        assert rows["proxy.ring.readmissions"] == 1.0
    finally:
        dests.clear()
        ft.stop()

def test_discovery_readd_does_not_bypass_ejection():
    ft = ForwardTestServer(lambda ms: None)
    ft.start()
    dests = Destinations(flush_interval=0.1)
    dests.set_destinations([ft.address])
    try:
        dests.eject(ft.address)
        dests.set_destinations([ft.address])
        assert ft.address not in dests.ring.members()
        dests.readmit(ft.address)
        assert ft.address in dests.ring.members()
    finally:
        dests.clear()
        ft.stop()


def test_open_breaker_rehomes_key_to_next_healthy():
    ft1 = ForwardTestServer(lambda ms: None)
    ft1.start()
    ft2 = ForwardTestServer(lambda ms: None)
    ft2.start()
    dests = Destinations(flush_interval=0.1)
    dests.set_destinations([ft1.address, ft2.address])
    try:
        key = next(f"k{i}" for i in range(1000)
                   if dests.ring.get(f"k{i}") == ft1.address)
        primary = dests._pool[ft1.address]
        for _ in range(primary.breaker.failure_threshold):
            primary.breaker.record_failure()
        assert dests.get(key).address == ft2.address
        assert dests.failover_routed_total > 0
        primary.breaker.record_success()
        assert dests.get(key) is primary
    finally:
        dests.clear()
        ft1.stop()
        ft2.stop()


def test_ready_503_while_more_than_half_the_ring_is_ejected():
    fts = [ForwardTestServer(lambda ms: None) for _ in range(3)]
    for ft in fts:
        ft.start()
    proxy = tcreate_proxy([ft.address for ft in fts],
                          health_check_interval=0)
    proxy.start()
    proxy.ring_health = health = RingHealth(
        proxy.destinations, interval=0.05, unhealthy_after=1,
        healthy_after=1)
    api = HTTPApi({}, address="127.0.0.1:0", ready=proxy.ready_state)
    api.start()
    host, port = api.address
    url = f"http://{host}:{port}/healthcheck/ready"

    def status():
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.status, None
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        health.run_round()
        assert status() == (200, None)
        fts[0].stop()
        health.run_round()  # 1 of 3 ejected: not a majority
        assert status() == (200, None)
        fts[1].stop()
        health.run_round()  # 2 of 3
        code, body = status()
        assert code == 503 and body["ready"] is False
        assert body["destinations"] == 3 and body["ejected"] == 2
        assert "ejected" in body["reason"]
    finally:
        api.stop()
        proxy.stop()
        fts[2].stop()


# -- hedging, dedupe, pinning -------------------------------------------------

def test_slow_primary_hedges_to_peer_with_the_same_token():
    slow_got, fast_got, tokens = [], [], []

    def slow_handler(ms):
        time.sleep(1.0)
        slow_got.extend(ms)

    slow = ForwardTestServer(slow_handler)
    slow.start()
    fast = ForwardTestServer(fast_got.extend)
    fast.start()
    peer = Destination(fast.address, on_close=lambda d: None,
                       flush_interval=0.1)
    dest = Destination(slow.address, on_close=lambda d: None,
                       flush_interval=0.1, hedge_after=0.15,
                       hedge_peer=lambda: peer)
    try:
        # the V2-only test servers pin both senders to the stream
        dest.send_now([_mkmetric("pin.a")], token="")
        peer.send_now([_mkmetric("pin.b")], token="")
        assert not dest._v1_ok and not peer._v1_ok
        dest.send(_mkmetric("hedged.m", 7))
        # the win is credited, and the blown budget fed the primary's
        # breaker, after the peer's send returns
        assert _wait_for(lambda: dest.breaker.consecutive_failures == 1)
        assert any(m.name == "hedged.m" for m in fast_got)
        assert dest.hedge_fired_total == 1 and dest.hedge_wins_total == 1
        assert peer.sent_total >= 1
        assert _wait_for(lambda: any(m.name == "hedged.m"
                                     for m in slow_got), timeout=10)
        tokens = [dict(md).get("x-veneur-idempotency-token")
                  for srv in (slow, fast) for md in srv.call_metadata
                  if dict(md).get("x-veneur-idempotency-token", "")
                  .startswith("dest:")]
        assert len(tokens) == 2 and tokens[0] == tokens[1]
    finally:
        dest.close()
        peer.close()
        slow.stop()
        fast.stop()


def test_hedged_duplicate_merges_once_at_the_port_global():
    gserver, gsink = _tserver(grpc_address="127.0.0.1:0",
                              ledger_strict=True)
    try:
        imp = gserver.import_server
        client = TClient(imp.address, deadline=5.0)
        body = _frame_v1(_mkmetric("dedupe.c", 5).SerializeToString())
        md = token_metadata("dest:abc:1")
        client._send_v1(body, timeout=5.0, metadata=md)
        client._send_v1(body, timeout=5.0, metadata=md)  # the hedge
        client._send_v1(body, timeout=5.0,
                        metadata=token_metadata("dest:abc:2"))
        client.close()
        assert imp.duplicates_dropped_total == 1
        assert imp.imported_total == 2
        gserver.flush()
        got = _series(gsink.drain())
        assert got[("dedupe.c", (), "COUNTER")] == 10.0
    finally:
        gserver.shutdown()


def test_proxy_dedupes_a_retried_send():
    got = []
    ft = ForwardTestServer(got.extend)
    ft.start()
    proxy = tcreate_proxy([ft.address], health_check_interval=0)
    proxy.start()
    try:
        client = TClient(proxy.address, deadline=5.0)
        body = _frame_v1(_mkmetric("pd.c", 4).SerializeToString())
        md = token_metadata("ptok:1")
        client._send_v1(body, timeout=5.0, metadata=md)
        client._send_v1(body, timeout=5.0, metadata=md)
        client.close()
        assert _wait_for(lambda: sum(m.name == "pd.c" for m in got) == 1)
        time.sleep(0.2)
        assert sum(m.name == "pd.c" for m in got) == 1
        assert proxy.stats["duplicates_dropped_total"] == 1
    finally:
        proxy.stop()
        ft.stop()


def test_destination_pins_to_v2_on_unimplemented_and_stays():
    got = []
    ft = ForwardTestServer(got.extend)  # SendMetricsV2 only
    ft.start()
    dest = Destination(ft.address, on_close=lambda d: None,
                       flush_interval=0.1)
    try:
        assert dest._v1_ok
        dest.send(_mkmetric("v.a"))
        # credited once the V2 retry returns
        assert _wait_for(lambda: dest.sent_total == 1)
        assert not dest._v1_ok and len(got) == 1
        dest.send(_mkmetric("v.b"))
        assert _wait_for(lambda: dest.sent_total == 2)
        assert len(got) == 2 and dest.dropped_total == 0
    finally:
        dest.close()
        ft.stop()


# -- kill and restore under the strict ledger ---------------------------------

def test_kill_restore_fast_under_the_strict_ledger(tmp_path):
    """The port's counterpart of the JAX package's test_kill_restore_fast:
    a local's forward target down for 2 of 6 intervals; zero counter
    loss through the carryover and the spool, llhist bins exact, the
    spool empty, every ledger interval balanced."""
    from veneur_tpu_torch.forward import llhistwire
    from veneur_tpu_torch.ops import llhist_ref
    received = []
    ft = ForwardTestServer(received.extend)
    ft.start()
    port = ft.port
    server, _sink = _tserver(
        forward_address=ft.address, forward_retry_max_attempts=1,
        carryover_max_intervals=1, carryover_spool_dir=str(tmp_path),
        circuit_breaker_failure_threshold=10_000, ledger_strict=True,
        ledger_history=64, interval="10s")
    sent_counter = 0
    sent_bins = np.zeros(llhist_ref.BINS, np.int64)
    try:
        for rnd in range(6):
            if rnd == 2:
                ft.stop()
            if rnd == 4:
                ft = ForwardTestServer(received.extend,
                                       address=f"127.0.0.1:{port}")
                ft.start()
            delta = 3 + rnd
            server.handle_metric_packet(
                b"soak.count:%d|c|#veneurglobalonly" % delta)
            sent_counter += delta
            server.handle_metric_packet(b"soak.lat:%d|l" % (rnd + 1))
            sent_bins[llhist_ref.bin_index(float(rnd + 1))] += 1
            server.flush()
        fc = server.forward_client
        for _ in range(20):
            server.flush()
            if fc.carryover.depth == 0 and fc.spool.depth == 0:
                break
            time.sleep(0.5)
        assert fc.carryover.depth == 0 and fc.spool.depth == 0
        assert _wait_for(lambda: sum(
            m.counter.value for m in received
            if m.name == "soak.count") == sent_counter)
        got_bins = np.zeros(llhist_ref.BINS, np.int64)
        for m in received:
            if m.name == "soak.lat":
                got_bins += llhistwire.unmarshal(m.llhist.bins)
        assert np.array_equal(got_bins, sent_bins)
        assert all(v == 0.0 for iv in server.ledger.history_imbalances()
                   for v in iv.values())
        assert server.ledger.intervals_closed >= 7
    finally:
        server.shutdown()
        ft.stop()


# -- the CLI and the import boundary ------------------------------------------

def _args(**kw):
    base = dict(destinations="", discovery_interval="10s",
                listen="127.0.0.1:0", http="", forward_service="g",
                tls_cert="", tls_key="", tls_ca="", dest_tls_ca="",
                dest_tls_cert="", dest_tls_key="")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("shape", ["v2", "legacy", "flags"])
def test_cli_builds_both_config_shapes(shape):
    import logging
    a, b = "127.0.0.1:1", "127.0.0.1:2"
    raw = {"v2": {"forward_addresses": [a, b], "discovery_interval": "5s",
                  "http_address": "127.0.0.1:0", "health_check_interval": 0,
                  "ignore_tags": [{"kind": "prefix", "value": "x"}],
                  "ledger_history": 8},
           "legacy": {"forward_address": f"{a},{b}",
                      "consul_refresh_interval": "5s",
                      "health_check_interval": 0},
           "flags": {"health_check_interval": 0}}[shape]
    args = _args(destinations=f"{a},{b}")
    proxy, stats_loop, api = tcli.build_from_config(
        raw, args, logging.getLogger("t"))
    try:
        assert proxy.destinations.addresses() == sorted([a, b])
        assert proxy.discovery_interval == (10.0 if shape == "flags"
                                            else 5.0)
        assert stats_loop is None
        if shape == "v2":
            host, port = api.address
            with urllib.request.urlopen(
                    f"http://{host}:{port}/debug/ledger") as r:
                report = json.loads(r.read())
            assert set(report["identities"]) == {
                "proxy_route", "proxy_egress", "proxy_tier"}
            with urllib.request.urlopen(
                    f"http://{host}:{port}/query?metric=forward.keys&kind=count") as r:
                assert json.loads(r.read())["family"] == "proxy"
    finally:
        proxy.stop()
        if api is not None:
            api.stop()


@pytest.mark.parametrize("key", ["flush_async",
                                 "cardinality_soft_limit",
                                 "chaos_reshard_append_fault_nth",
                                 "no_such_key"])
def test_cli_raises_on_keys_it_does_not_implement(key):
    with pytest.raises(ValueError, match=key):
        tcli.check_keys({key: 1})
    with pytest.raises(ValueError, match="statsd.prefix"):
        tcli.check_keys({"statsd": {"prefix": "x"}})


@pytest.mark.parametrize("key,value", [("trace_self_sample_rate", 0.25),
                                       ("trace_store_spans", 64)])
def test_cli_reads_the_trace_keys(key, value):
    raw = tcli.check_keys({key: value})
    assert raw[key] == value
    # the ProxyServer takes them under the JAX proxy's names and defaults
    import inspect
    from veneur_tpu.proxy.proxy import ProxyServer as JProxyServer
    from veneur_tpu_torch.proxy.proxy import ProxyServer
    tdef = inspect.signature(ProxyServer).parameters[key].default
    jdef = inspect.signature(JProxyServer).parameters[key].default
    assert tdef == jdef


def test_cli_redacts_private_keys():
    raw = tcli.check_keys({"tls_key": "secret", "forward_tls_key": "s2"})
    assert str(raw["tls_key"]) == "REDACTED"
    assert raw["forward_tls_key"].reveal() == "s2"


def test_proxy_modules_import_no_torch():
    code = r"""
import sys
import veneur_tpu_torch.proxy, veneur_tpu_torch.cmd.veneur_proxy
import veneur_tpu_torch.util.chaos, veneur_tpu_torch.util.grpcstats
import veneur_tpu_torch.util.grpctls, veneur_tpu_torch.core.ledger
import veneur_tpu_torch.proxy.discovery
bad = sorted(n for n in sys.modules if n == "torch" or n.startswith("torch.")
             or n == "jax" or n.startswith("jax.") or n == "veneur_tpu"
             or n.startswith("veneur_tpu."))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_proxy_cli_process_serves_its_api():
    """The CLI module run as a program (`-f proxy.yaml`) starts,
    answers /healthcheck/ready and /metrics, and exits 0 on SIGTERM."""
    import socket
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "proxy.yaml")
        with open(path, "w") as f:
            f.write(f"forward_addresses: ['127.0.0.1:1']\n"
                    f"grpc_address: 127.0.0.1:{ports[0]}\n"
                    f"http_address: 127.0.0.1:{ports[1]}\n"
                    f"health_check_interval: 0\n")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, runpy; "
             "sys.argv = ['veneur_proxy', '-f', sys.argv[1]]; "
             "runpy.run_module('veneur_tpu_torch.cmd.veneur_proxy', "
             "run_name='__main__')", path],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            url = f"http://127.0.0.1:{ports[1]}"

            def ready():
                try:
                    with urllib.request.urlopen(
                            url + "/healthcheck/ready", timeout=2) as r:
                        return r.status == 200
                except OSError:
                    return False

            assert _wait_for(ready, timeout=60)
            with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
                text = r.read().decode()
            assert "veneur_proxy_received_total 0" in text
            assert "veneur_ledger_intervals_closed_total" in text
        finally:
            proc.terminate()
            out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out


# -- the server's keys of this slice ------------------------------------------

_SLICE_KEYS = {"forward_only": True, "grpc_tls_certificate": "c.pem",
               "grpc_tls_key": "k.pem", "grpc_tls_authority_certificate": "a",
               "forward_tls_certificate": "c.pem", "forward_tls_key": "k.pem",
               "forward_tls_authority_certificate": "a",
               "chaos_enabled": True, "chaos_error_rate": 0.5,
               "chaos_delay_rate": 0.5, "chaos_delay": "5ms",
               "chaos_seams": ["http_post"], "chaos_seed": 3,
               "chaos_forward_latency_ms": 2.0, "ledger_enabled": False,
               "ledger_strict": True, "ledger_history": 4}


@pytest.mark.parametrize("key", sorted(_SLICE_KEYS))
def test_server_config_accepts_the_slice_keys(key):
    from veneur_tpu_torch.config import config_from_dict
    from veneur_tpu_torch.util.secret import StringSecret
    value = getattr(config_from_dict({key: _SLICE_KEYS[key]}), key)
    if key == "chaos_delay":
        assert value == 0.005
    elif key.endswith("_key"):
        assert isinstance(value, StringSecret)
        assert value.reveal() == _SLICE_KEYS[key]
    else:
        assert value == _SLICE_KEYS[key]


@pytest.mark.parametrize("key,value", [
    ("reshard_spool_dir", 1), ("reshard_deadline", 1),
    ("jax_compilation_cache_dir", 1), ("tpu", {"pallas_tdigest_flush": True}),
    ("tpu", {"shard_routing": "modulo"}),
    ("chaos_reshard_prewarm_delay_s", 1),
    ("chaos_reshard_append_fault_nth", 1),
    ("chaos_reshard_cutover_delay_s", 1)])
def test_server_config_still_raises_the_missing_planes(key, value):
    """The server's config raises by name on what the port lacks; the
    reshard keys, ported with the elastic reshard, read like the JAX
    package's Config (the proxy CLI still raises on them, above)."""
    from veneur_tpu_torch.config import config_from_dict
    if "reshard" in key:
        from veneur_tpu.config import read_config as jread_config
        assert getattr(config_from_dict({key: value}), key) == \
            getattr(jread_config(overrides={key: value}), key)
        return
    name = next(iter(value)) if isinstance(value, dict) else key
    with pytest.raises(ValueError, match=name):
        config_from_dict({key: value})


@pytest.mark.parametrize("key,value", [
    ("ingest_rate_limit_statsd", 1000.0),
    ("overload_watermark_soft_bytes", 1 << 30),
    ("supervisor_deadline", 5.0),
    ("trace_store_spans", 64),
    ("chaos_ingest_truncate_rate", 0.1),
    ("chaos_ledger_leak", 100)])
def test_server_config_reads_the_overload_and_trace_keys(key, value):
    from veneur_tpu.config import Config as JConfig
    from veneur_tpu_torch.config import config_from_dict
    assert getattr(config_from_dict({}), key) == getattr(JConfig(), key)
    assert getattr(config_from_dict({key: value}), key) == value


def test_forward_only_forwards_every_unscoped_metric_like_jax():
    lines = [b"fo.c:3|c", b"fo.g:2|g", b"fo.t:5|ms", b"fo.s:m|s",
             b"fo.l:7|l", b"fo.lo:1|c|#veneurlocalonly"]
    out = {}
    for package, make in (("jax", _jserver), ("torch", _tserver)):
        gserver, gsink = make(grpc_address="127.0.0.1:0")
        local, lsink = make(forward_address=gserver.import_server.address,
                            forward_only=True)
        try:
            for line in lines:
                local.handle_metric_packet(line)
            local.flush()
            assert _wait_for(
                lambda: gserver.import_server.imported_total == 5)
            gserver.flush()
            out[package] = (_series(lsink.drain()), _series(gsink.drain()))
        finally:
            local.shutdown()
            gserver.shutdown()
    (jloc, jglob), (tloc, tglob) = out["jax"], out["torch"]
    _assert_series_agree(tloc, jloc)
    _assert_series_agree(tglob, jglob)
    assert set(k[0] for k in tloc) == {"fo.lo"}
    assert ("fo.c", (), "COUNTER") in tglob


def test_proxy_ledger_balances_while_closes_race_the_senders():
    """A strict proxy ledger closed over and over while a thread routes
    bodies and the destination sends them: no close may find a metric
    between the queue and its counters (a short switch interval makes
    the threads interleave at every bytecode boundary)."""
    import threading
    from veneur_tpu_torch.core.ledger import LedgerImbalance
    ft = ForwardTestServer(lambda ms: None)
    ft.start()
    proxy = tcreate_proxy([ft.address], health_check_interval=0,
                          ledger_strict=True)
    proxy.start()
    body = _body([_mkmetric(f"race.{i}") for i in range(64)])
    stop = threading.Event()
    errors = []

    def route():
        while not stop.is_set():
            proxy._route_native(body)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    router = threading.Thread(target=route, daemon=True)
    router.start()
    try:
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            try:
                proxy.ledger.close_interval()
            except LedgerImbalance as e:
                errors.append(e.imbalances)
        stop.set()
        router.join(timeout=10)
        assert not router.is_alive()
        proxy.destinations.flush_wait()
        proxy.ledger.close_interval()
    finally:
        sys.setswitchinterval(old)
        proxy.stop()
        ft.stop()
    assert not errors, errors[:3]
    assert proxy.stats["routed_total"] > 64
    assert proxy.ledger.intervals_closed > 10


def test_note_all_books_every_stage_in_one_interval():
    from veneur_tpu_torch.core.ledger import FlowLedger
    ledger = FlowLedger(strict=True)
    ledger.declare("tier", inputs=("a",), outputs=("b", "c"))
    ledger.note_all((("a", 5), ("b", 3), ("c", 2), ("d", 0)), key="k")
    record = ledger.close_interval()
    assert record["imbalance"] == {"tier": 0.0}
    assert record["stages"] == {"a": {"k": 5.0}, "b": {"k": 3.0},
                                "c": {"k": 2.0}}


def test_a_dead_destination_s_drops_are_counted_and_balance():
    """No probes: a body routed while one of two globals is dead. What
    the dead one took is dropped (its sends fail, its breaker opens and
    it closes, the rest fails over), and every metric is accounted:
    received == delivered + the destinations' drops + no-destination,
    under the strict ledger."""
    got = []
    alive = ForwardTestServer(got.extend)
    alive.start()
    dead = ForwardTestServer(lambda ms: None)
    dead.start()
    proxy = tcreate_proxy([alive.address, dead.address],
                          health_check_interval=0, ledger_strict=True,
                          max_consecutive_failures=2)
    proxy.start()
    dead.stop()
    try:
        body = _body([_mkmetric(f"dd.{i}") for i in range(400)])
        for _ in range(3):
            proxy._route_native(body)
        dests = proxy.destinations
        assert _wait_for(lambda: all(
            d._queue.empty() and not d.inflight_batch
            for d in list(dests._pool.values())))
        totals = dests.flow_totals()
        assert totals["enqueued"] == (totals["sent"]
                                      + totals["dropped_enqueued"])
        rows = {(r[0], tuple(r[3])): r[2] for r in dests.telemetry_rows()}
        dropped = dests.retired_dropped_total + sum(
            v for (name, _t), v in rows.items()
            if name == "proxy.dest.dropped")
        stats = proxy.stats
        assert stats["received_total"] == 1200
        assert dropped > 0
        assert _wait_for(lambda: len(got) == totals["sent"])
        assert (stats["received_total"] - len(got) - dropped
                - stats["no_destination_total"]) == 0
        proxy.ledger.close_interval()  # strict: raises on an imbalance
    finally:
        proxy.stop()
        alive.stop()


def test_bookings_after_the_retirement_fold_land_in_the_pool_s_rows(
        monkeypatch):
    """The window behind a dead destination's lost drop: once the pool
    has folded a closed destination into its retired counters, what the
    destination books afterwards (a route that raced its close, its
    sender's leftover batch) must land in the pool's rows, and the
    in-flight stock it held at the fold must stay in the flow totals
    until it is booked. The sender thread is stubbed out so the test
    takes the queue's items itself."""
    monkeypatch.setattr(Destination, "_run", lambda self: None)
    dests = Destinations(flush_interval=0.05)
    dests.set_destinations(["127.0.0.1:1"])
    dest = dests._pool["127.0.0.1:1"]
    try:
        for i in range(3):
            assert dest.send(_mkmetric(f"rf.{i}"))
        dest._queue.get_nowait()  # two taken by the "sender", one queued
        dest._queue.get_nowait()
        dest.close(notify=True)  # drains the queued one, then retires
        assert "127.0.0.1:1" not in dests._pool
        totals = dests.flow_totals()
        assert totals["enqueued"] == (totals["sent"]
                                      + totals["dropped_enqueued"]
                                      + totals["queued"]), totals
        dest._book(dropped=2)  # the sender's leftover, after the fold
        assert not dest.send(_mkmetric("rf.late"))  # a route that raced
        totals = dests.flow_totals()
        assert totals == {"enqueued": 3.0, "sent": 0.0,
                          "dropped_enqueued": 3.0, "queued": 0.0}
        rows = {r[0]: r[2] for r in dests.telemetry_rows() if not r[3]}
        assert rows["proxy.dest.retired_dropped"] == 4.0
        assert rows["proxy.dest.retired_dropped_enqueued"] == 3.0
        with pytest.raises(Exception):
            dest._queue.put_nowait((_mkmetric("rf.sealed"), 0.0))
    finally:
        dests.clear()


# -- discovery and the HTTP probe ---------------------------------------------

def _json_server(routes):
    """A 127.0.0.1 HTTP server answering GET path -> (status, JSON)."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            status, payload = routes.get(self.path.split("?")[0],
                                         (404, None))
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_discoverers_find_what_the_jax_ones_find():
    from veneur_tpu.proxy import discovery as jd
    from veneur_tpu_torch.proxy import discovery as td
    consul = [{"Node": {"Address": "10.0.0.1"}, "Service": {"Port": 8128}},
              {"Node": {"Address": "10.0.0.2"}, "Service": {"Port": 8129}},
              {"Node": {}, "Service": {"Port": 1}}]
    http_json = ["10.0.1.1:8128",
                 {"Service": {"Address": "10.0.1.2", "Port": 8128}}]
    pods = {"items": [
        {"status": {"phase": "Running", "podIP": "10.1.0.1"},
         "spec": {"containers": [{"ports": [{"name": "grpc",
                                             "containerPort": 8128}]}]},
         "metadata": {"name": "a"}},
        {"status": {"phase": "Running", "podIP": "10.1.0.2"},
         "spec": {"containers": [{"ports": [{"name": "http",
                                             "containerPort": 80}]}]},
         "metadata": {"name": "b"}},
        {"status": {"phase": "Pending", "podIP": "10.1.0.3"},
         "spec": {"containers": [{"ports": [{"name": "grpc",
                                             "containerPort": 8128}]}]}}]}
    httpd = _json_server({"/v1/health/service/veneur-global": (200, consul),
                          "/list/veneur-global": (200, http_json),
                          "/api/v1/pods": (200, pods)})
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        for make in (
                lambda m: m.ConsulDiscoverer(base_url=base),
                lambda m: m.HttpJsonDiscoverer(base + "/list/{service}"),
                lambda m: m.KubernetesDiscoverer(api_base=base, token="t"),
                lambda m: m.StaticDiscoverer(["h:1", "h:2"]),
                lambda m: m.DnsDiscoverer()):
            service = ("localhost:8128" if make(td).__class__.__name__
                       == "DnsDiscoverer" else "veneur-global")
            got = make(td).get_destinations_for_service(service)
            assert got == make(jd).get_destinations_for_service(service)
            assert got
    finally:
        httpd.shutdown()


def test_http_probe_ejects_a_global_answering_503():
    ft = ForwardTestServer(lambda ms: None)
    ft.start()
    status = {"/healthcheck": (200, "ok")}
    httpd = _json_server(status)
    dests = Destinations(flush_interval=0.1)
    dests.set_destinations([ft.address])
    health = RingHealth(
        dests, interval=0.05, timeout=1.0, unhealthy_after=1,
        healthy_after=1, probe="http",
        http_url_template=("http://{host}:%d/healthcheck"
                           % httpd.server_port))
    try:
        health.run_round()
        assert dests.ejected_addresses() == []
        status["/healthcheck"] = (503, "shedding")
        health.run_round()
        assert dests.ejected_addresses() == [ft.address]
        status["/healthcheck"] = (200, "ok")
        health.run_round()
        assert dests.ejected_addresses() == []
        with pytest.raises(ValueError, match="template"):
            RingHealth(dests, probe="http")
    finally:
        dests.clear()
        httpd.shutdown()
        ft.stop()
