"""The port's cardinality observatory (veneur_tpu_torch/core/cardinality.py)
and its mint gate against the JAX package's: the same numpy-seeded mint,
eviction and roll sequence through both accountants gives the same
verdicts, sheds, top names, reports, tag-key HLL estimates and telemetry
rows; a storm through both servers' `row_for` sheds exactly the same
mints, books the same `agg.rejected` and flushes the same series; and a
port server serves `/debug/cardinality`."""

from __future__ import annotations

import json
import random
import urllib.request

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core import cardinality as jcard
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import cardinality as tcard
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

# fields measured on the wall or monotonic clock: never comparable
_CLOCKED = ("first_seen_unix", "mint_rate_per_s", "since_unix")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _CLOCKED}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _accountants(**kw):
    """The port's accountant and the JAX package's, each recording its
    shed callbacks and limit events."""
    out = []
    for mod in (tcard, jcard):
        sheds, events = [], []
        acc = mod.CardinalityAccountant(
            on_shed=lambda fam, n, reason, s=sheds: s.append(
                (fam, n, reason)),
            on_event=lambda kind, e=events, **f: e.append((kind, f)), **kw)
        out.append((acc, sheds, events))
    return out


def _script(seed: int, steps: int = 1500):
    """A numpy-seeded mint/evict/roll sequence: a few heavy names (one of
    them with an exploding `pod` tag), a spray of singletons, evictions
    of earlier mints, and interval rolls."""
    rng = np.random.default_rng(seed)
    heavy = [f"heavy.{i}" for i in range(4)]
    ops = []
    minted = []
    for i in range(steps):
        r = rng.random()
        if r < 0.6:
            name = heavy[int(rng.integers(len(heavy)))]
            tags = [f"pod:p{int(rng.integers(5000))}",
                    f"az:{int(rng.integers(3))}"]
            fam = ("counter", "llhist")[int(rng.integers(2))]
            ops.append(("mint", fam, name, tags))
            minted.append((fam, name))
        elif r < 0.88:
            name = f"spray.{int(rng.integers(400))}"
            ops.append(("mint", "gauge", name, [f"k{int(rng.integers(20))}"]))
            minted.append(("gauge", name))
        elif r < 0.995 and minted:
            k = int(rng.integers(1, 6))
            fam = minted[int(rng.integers(len(minted)))][0]
            names = [minted[int(j)][1]
                     for j in rng.integers(len(minted), size=k)]
            ops.append(("evict", fam, names))
        else:
            ops.append(("roll",))
    return ops


def _run(acc, ops) -> list:
    verdicts = []
    for op in ops:
        if op[0] == "mint":
            _kind, fam, name, tags = op
            ok = acc.admit_mint(fam, name, tags)
            if ok:
                acc.note_mint(fam, name)
            verdicts.append(ok)
        elif op[0] == "evict":
            acc.note_evicted(op[1], op[2])
        else:
            acc.roll_interval()
    return verdicts


@pytest.mark.parametrize("seed,kw", [
    (1, {}),
    (2, {"soft_limit": 12, "hard_limit": 30}),
    (3, {"soft_limit": 8, "hard_limit": 0, "degraded_keep": 0.25}),
    (4, {"soft_limit": 0, "hard_limit": 20, "top_k": 16,
         "hll_names": 2, "hll_min_mints": 8}),
    (5, {"soft_limit": 5, "hard_limit": 15, "degraded_keep": 0.0,
         "top_k": 8, "hll_names": 1, "hll_min_mints": 4}),
])
def test_accountant_matches_jax_on_one_sequence(seed, kw):
    ops = _script(seed)
    results = []
    for acc, sheds, events in _accountants(**kw):
        verdicts = _run(acc, ops)
        heavy = [f"heavy.{i}" for i in range(4)]
        results.append({
            "verdicts": verdicts,
            "sheds": sheds,
            "events": events,
            "top": _strip(acc.top(12)),
            "names": [_strip(acc.name_report(n))
                      for n in heavy + ["spray.3", "absent"]],
            "tags": [_strip(acc.tag_report(n)) for n in heavy],
            "limits": acc.limits_report(),
            "rows": acc.telemetry_rows(),
            "totals": (acc.minted_total, acc.shed_soft_total,
                       acc.shed_hard_total, acc.tracker.evictions),
        })
    assert results[0] == results[1]
    if kw.get("hard_limit") or kw.get("soft_limit"):
        assert not all(results[0]["verdicts"])
        assert results[0]["sheds"]


@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_space_saving_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    names = [f"n{int(x)}" for x in rng.zipf(1.3, size=3000) % 500]
    out = []
    for mod in (tcard, jcard):
        ss = mod.SpaceSaving(capacity)
        for i, name in enumerate(names):
            rec = ss.get_or_track(name)
            rec.weight += 1.0
            if i % 7 == 0:
                rec.live_rows += 1
            if i % 500 == 499:
                ss.decay(0.8)
        out.append(([(r.name, r.weight, r.error, r.live_rows)
                     for r in ss.top(capacity)], ss.evictions))
    assert out[0] == out[1]


def test_tag_cardinality_estimates_equal_jax():
    rng = np.random.default_rng(9)
    out = []
    for mod in (tcard, jcard):
        tc = mod.TagCardinality(max_names=2)
        tc.start("a")
        tc.start("b")
        tc.start("c")  # past max_names: not tracked
        for _ in range(4000):
            tags = [f"pod:{int(rng.integers(100000))}", "env:prod", "bare"]
            tags += [f"x{j}:{j}" for j in range(int(rng.integers(20)))]
            tc.observe("a", tags)
            tc.observe("b", tags[:1])
        for _ in range(tcard.TAG_IDLE_INTERVALS):
            tc.roll_interval()
        tc.observe("a", ["pod:again"])
        tc.roll_interval()
        out.append((_strip(tc.report("a")), tc.report("b"),
                    tc.report("c"), tc.tracked_names()))
        rng = np.random.default_rng(9)
    assert out[0] == out[1]
    # "b" went idle for longer than TAG_IDLE_INTERVALS and was released
    assert out[0][1] is None and out[0][3] == ["a"]
    assert out[0][0]["tag_keys_overflow"] > 0


# -- servers -----------------------------------------------------------

SIZES = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
             set_capacity=32, batch_cap=256, llhist_capacity=32)
LIMITS = dict(cardinality_soft_limit=30, cardinality_hard_limit=90,
              cardinality_degraded_keep=0.2, cardinality_hll_min_mints=16)


def _jax_server(disable_native: bool):
    cfg = JConfig()
    cfg.hostname = "test"
    cfg.interval = 3600.0
    for key, value in SIZES.items():
        setattr(cfg.tpu, key, value)
    cfg.tpu.disable_native_parser = disable_native
    for key, value in LIMITS.items():
        setattr(cfg, key, value)
    sink = JChannel()
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    server.metric_extraction._uniqueness_rate = 0.0
    return server, sink


def _port_server(disable_native: bool, **extra):
    cfg = config_from_dict({
        "hostname": "test", "interval": "1h", "ledger_strict": True,
        "tpu": dict(SIZES, disable_native_parser=disable_native),
        **LIMITS, **extra})
    sink = ChannelMetricSink()
    server = Server(cfg, device="cpu", extra_metric_sinks=[sink],
                    rng=random.Random(3))
    server.metric_extraction.uniqueness_rate = 0.0
    return server, sink


def _storm(interval: int, rng) -> list:
    """One interval of a storm: `storm.lat` (|l) minting 200 new pod
    values, `storm.c` (|c) minting 120, and a steady key set that never
    hits a budget; interval 2 re-sends interval 1's first pods."""
    lines = []
    base = interval * 1000
    for p in range(200):
        v = float(np.round(rng.gamma(2.0, 10.0), 3)) + 0.5
        lines.append(b"storm.lat:%.3f|l|#pod:p%d" % (v, base + p))
    for p in range(120):
        lines.append(b"storm.c:1|c|#pod:p%d,az:a%d" % (base + p, p % 3))
    for k in range(20):
        lines.append(b"steady.c%d:%d|c" % (k, k + 1))
        lines.append(b"steady.t%d:%.2f|ms" % (k, 1.0 + k))
    if interval:
        # existing rows are never gated
        for p in range(10):
            lines.append(b"storm.lat:7|l|#pod:p%d" % p)
    return lines


def _datagrams(lines, per: int = 40) -> list:
    """Newline-joined datagrams of `per` lines (each under the default
    metric_max_length)."""
    return [b"\n".join(lines[i:i + per]) for i in range(0, len(lines), per)]


def _flushed(server, sink) -> dict:
    server.flush()
    return {(m.name, tuple(m.tags)): m.value for m in sink.drain()
            if "service:veneur-tpu" not in m.tags
            and not m.name.startswith(("veneur.", "intern.", "flush."))}


def _sheds(snapshot: dict) -> dict:
    return {k: v for k, v in snapshot.items() if "cardinality" in k}


@pytest.mark.parametrize("disable_native", [False, True])
def test_storm_through_row_for_sheds_like_jax(disable_native):
    runs = []
    for build in (_port_server, _jax_server):
        server, sink = build(disable_native)
        rng = np.random.default_rng(21)
        per_interval = []
        for interval in range(2):
            server.handle_packet_batch(_datagrams(_storm(interval, rng)))
            flushed = _flushed(server, sink)
            stages = server.ledger._history[-1]["stages"]
            per_interval.append((
                flushed, _sheds(dict(server.overload.shed_total)),
                stages.get("agg.rejected", {}),
                _strip(server.cardinality.top(4)),
                _strip(server.cardinality.tag_report("storm.lat"))))
        runs.append(per_interval)
        if build is _port_server:
            server.shutdown()
    for got, want in zip(*runs):
        assert set(got[0]) == set(want[0])
        for key, value in want[0].items():
            if key[0].startswith("steady.t") and "percentile" in key[0]:
                np.testing.assert_allclose(got[0][key], value, rtol=2e-5,
                                           atol=1e-4)
            elif key[0] == "storm.lat.sum":
                np.testing.assert_allclose(got[0][key], value, rtol=1e-12)
            else:
                assert got[0][key] == value, key
        assert got[1:] == want[1:]
    # each interval admits 30 + (90 - 30) / 5 = 42 mints per storm name
    sheds = runs[0][0][1]
    assert sheds["llhist|cardinality"] == 110
    assert sheds["llhist|cardinality_degraded"] == 48
    assert sheds["counter|cardinality"] == 30


def test_debug_cardinality_served_on_a_server():
    server, _sink = _port_server(False, http_address="127.0.0.1:0")
    server.start()
    try:
        rng = np.random.default_rng(4)
        server.handle_packet_batch(_datagrams(_storm(0, rng)))
        host, port = server.http_api.address
        with urllib.request.urlopen(
                f"http://{host}:{port}/debug/cardinality?top=3") as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert set(body) == {"generated_unix", "interval_s", "total_names",
                             "tables", "top", "limits"}
        assert body["top"][0]["name"] == "storm.lat"
        assert body["top"][0]["mints_interval"] == 200
        assert body["limits"]["over_hard"] == ["storm.c", "storm.lat"]
        assert body["tables"]["llhist"]["live_rows"] == 42
        with urllib.request.urlopen(
                f"http://{host}:{port}/debug/cardinality?name=storm.c") as r:
            one = json.loads(r.read())
        assert one["tracked"] and one["live_rows"] == 42
        assert one["families"] == {"counter": 42}
        assert set(one["tags"]["tag_keys"]) == {"az", "pod"}
        assert one["tags"]["tag_keys"]["az"] == 3
    finally:
        server.shutdown()


def test_roll_feeds_the_exemplar_watch_list():
    """The trace plane's watch list is the accountant's top names after
    each flush (JAX server.py:2031-2033)."""
    server, sink = _port_server(False)
    try:
        rng = np.random.default_rng(4)
        server.handle_packet_batch(_datagrams(_storm(0, rng)))
        _flushed(server, sink)
        top = [r["name"] for r in server.cardinality.top(16)]
        assert top[0] == "storm.lat"
        assert set(server.trace_plane._watch) == set(top)
    finally:
        server.shutdown()


def test_reclaim_feeds_evictions_and_roll_resets_budgets():
    server, sink = _port_server(False, tpu=dict(SIZES,
                                                idle_key_intervals=1))
    try:
        lines = [b"ev.c:1|c|#k:%d" % i for i in range(50)]
        server.handle_packet_batch(_datagrams(lines))
        _flushed(server, sink)
        rec = server.cardinality.name_report("ev.c")
        # 30 under the soft limit, then 1 in 5 of the next 20
        assert rec["live_rows"] == 34
        _flushed(server, sink)   # idle: tombstoned, live rows drop
        assert server.cardinality.name_report("ev.c")["live_rows"] == 0
        assert server.cardinality.name_report("ev.c")[
            "mints_interval"] == 0
    finally:
        server.shutdown()
