"""The port's alert engine (veneur_tpu_torch/core/alerts.py) against the
JAX package's (veneur_tpu/core/alerts.py), on the CPU:

- `_compare_rules`, a torch op in the port and a jitted vmap of
  jnp.select in the JAX package, on random values, op codes and
  thresholds with NaN and ±inf among them;
- rule validation: the same rule tables are refused with the same
  messages; a `shard_skew` rule parses to the JAX rule and walks idle ->
  pending -> firing on the same skew over sharded stores;
- the pending -> firing -> resolved lifecycle with a `for:` hold-down,
  the flight-recorder trail, the transition log's rate limit and the
  hot reload, mirrored from tests/test_query.py, and the server's
  `alerts:` config block and SIGHUP-shaped reload.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from veneur_tpu.core.alerts import AlertRule as JAlertRule
from veneur_tpu.core.alerts import _compare_rules as j_compare
from veneur_tpu.core.alerts import _pad_len as j_pad_len
from veneur_tpu.core.query import QueryError as JQueryError
from veneur_tpu_torch.config import AlertsConfig, config_from_dict
from veneur_tpu_torch.core.alerts import (AlertRule, _compare_rules,
                                          _pad_len)
from veneur_tpu_torch.core.query import QueryError

from test_torch_query import _feed, corpus, mk_server


@pytest.mark.parametrize("seed", range(6))
def test_compare_rules_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    width = _pad_len(n)
    assert width == j_pad_len(n)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0],
                       np.float32)
    values = rng.normal(0, 10, width).astype(np.float32)
    values[rng.random(width) < 0.2] = rng.choice(special)
    thresholds = np.where(rng.random(width) < 0.3, values,
                          rng.normal(0, 10, width)).astype(np.float32)
    thresholds[rng.random(width) < 0.1] = rng.choice(special)
    ops = rng.integers(0, 7, width).astype(np.int32)  # 6: outside the table
    valid = rng.random(width) < 0.9
    want = np.asarray(j_compare(values, ops, thresholds, valid))
    got = _compare_rules(*(torch.from_numpy(a) for a in
                           (values, ops, thresholds, valid))).numpy()
    np.testing.assert_array_equal(got, want)


BAD_RULES = [
    "not a mapping",
    {"metric": "m", "threshold": 1},
    {"id": "  ", "metric": "m", "threshold": 1},
    {"id": "r", "metric": "m", "kind": "count", "op": "~", "threshold": 1},
    {"id": "r", "metric": "m", "kind": "count"},
    {"id": "r", "metric": "", "kind": "count", "threshold": 1},
    {"id": "r", "metric": "m", "kind": "nope", "threshold": 1},
    {"id": "r", "metric": "m", "kind": "quantile", "threshold": 1},
    {"id": "r", "metric": "m", "kind": "quantile", "q": 2,
     "threshold": 1},
    {"id": "r", "metric": "m", "kind": "bin_occupancy", "lo": 3, "hi": 1,
     "threshold": 1},
]


@pytest.mark.parametrize("rule", BAD_RULES)
def test_rule_validation_messages_equal_jax(rule):
    with pytest.raises(JQueryError) as want:
        JAlertRule.parse(rule)
    with pytest.raises(QueryError) as got:
        AlertRule.parse(rule)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rule", [
    {"id": "a", "metric": "m", "kind": "quantile", "q": 0.99,
     "op": ">=", "threshold": 100, "for": "30s", "tags": "env:t,a:b"},
    {"id": "b", "metric": "m", "kind": "bin_occupancy", "lo": 0,
     "hi": 5, "threshold": 0.5, "for": 2},
    {"id": "c", "metric": "m", "kind": "percentile", "q": 0.5,
     "op": "!=", "threshold": 1, "for": "1m30s"},
])
def test_rule_parse_equal_jax(rule):
    want, got = JAlertRule.parse(rule), AlertRule.parse(rule)
    for field in ("id", "metric", "kind", "op", "threshold", "for_s", "q",
                  "tags", "lo", "hi"):
        assert getattr(got, field) == getattr(want, field), field


def test_shard_skew_is_refused_by_name():
    """The `shard_skew` kind (the device observatory's max/mean live
    rows over the shards) against the JAX package's: the same parse, a
    malformed rule refused with the same message, and on a port and a
    JAX server of two shards fed the same skewed key space the same
    value and the same idle -> pending -> firing walk."""
    from veneur_tpu.core.server import Server as JServer
    from veneur_tpu.parallel.collectives import home_shards
    from veneur_tpu.sinks.channel import ChannelMetricSink as JSink
    from veneur_tpu_torch.samplers.parser import Parser
    from test_deviceobs import mk_server as jmk_server

    rule = {"id": "skew", "kind": "shard_skew", "op": ">",
            "threshold": 1.5, "for": "0.2s"}
    want, got = JAlertRule.parse(rule), AlertRule.parse(rule)
    for field in ("id", "metric", "kind", "op", "threshold", "for_s",
                  "spec", "tags"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.metric == "device.shard.skew"
    bad = {"id": "s", "kind": "shard_skew", "op": "~", "threshold": 1}
    with pytest.raises(JQueryError) as jerr:
        JAlertRule.parse(bad)
    with pytest.raises(QueryError, match="~") as perr:
        AlertRule.parse(bad)
    assert str(perr.value) == str(jerr.value)

    names, i = [], 0
    parser = Parser()
    while len(names) < 36:
        line = b"skew.%d:1|c" % i
        stubs = []
        parser.parse_metric_fast(line, stubs.append)
        home = int(home_shards(stubs[0].digest64, 2))
        if (home == 0) == (len(names) < 30):
            names.append(line)
        i += 1
    server, _obs = mk_server(tpu={"shards": 2})
    jserver, _jobs = jmk_server(**{"tpu.shards": 2})
    try:
        _feed(server, names)
        for line in names:
            jserver.handle_metric_packet(line)
        jserver.store.apply_all_pending()
        skew = server.deviceobs.shard_skew()
        assert skew == jserver.deviceobs.shard_skew() == 30 / 18
        now = time.time()
        walks = []
        for srv in (server, jserver):
            srv.alerts.configure([rule])
            walks.append([
                [(t["from_state"], t["to_state"], t["value"])
                 for t in srv.alerts.evaluate_once(now=now + dt)]
                for dt in (0.0, 0.1, 0.3)])
        assert walks[0] == walks[1]
        assert [[w[:2] for w in step] for step in walks[0]] == [
            [("idle", "pending")], [], [("pending", "firing")]]
        assert walks[0][0][0][2] == pytest.approx(skew)
    finally:
        for srv in (server, jserver):
            srv.config.flush_on_shutdown = False
            srv.shutdown()


def test_lifecycle_pending_firing_resolved():
    """The state machine with a `for:` hold-down, and its trail in the
    flight recorder and the telemetry rows."""
    server, _obs = mk_server()
    try:
        _feed(server, corpus())
        server.alerts.configure([
            {"id": "hits", "metric": "c.0", "kind": "count",
             "op": ">", "threshold": 0.5, "for": "0.2s",
             "tags": "env:t"}])
        now = time.time()
        trs = server.alerts.evaluate_once(now=now)
        assert [(t["from_state"], t["to_state"]) for t in trs] == \
            [("idle", "pending")]
        assert server.alerts.evaluate_once(now=now + 0.1) == []
        trs = server.alerts.evaluate_once(now=now + 0.3)
        assert [(t["from_state"], t["to_state"]) for t in trs] == \
            [("pending", "firing")]
        rep = server.alerts.report()
        assert rep["rules"][0]["state"] == "firing"
        assert rep["rules"][0]["value"] == 1.0
        server.flush()  # resets the counter generation
        trs = server.alerts.evaluate_once(now=now + 0.5)
        assert [(t["from_state"], t["to_state"]) for t in trs] == \
            [("firing", "resolved")]
        events = server.telemetry.events.snapshot(kind="alert_transition")
        assert [e["to_state"] for e in events] == \
            ["pending", "firing", "resolved"]
        assert all(e["rule"] == "hits" for e in events)
        rows = {r[0] for r in server.alerts.telemetry_rows()}
        assert {"alert.rules", "alert.state", "alert.firing",
                "alert.evals_total", "alert.transitions_total"} <= rows
    finally:
        server.shutdown()


def test_hot_reload_preserves_surviving_state():
    server, _obs = mk_server()
    try:
        _feed(server, corpus())
        server.alerts.configure([
            {"id": "a", "metric": "c.0", "kind": "count",
             "op": ">", "threshold": 0.0, "tags": "env:t"},
            {"id": "b", "metric": "g.0", "kind": "value",
             "op": ">", "threshold": 1e9}])
        server.alerts.evaluate_once()
        assert server.alerts.report()["rules"][0]["state"] == "firing"
        n = server.alerts.configure([
            {"id": "a", "metric": "c.0", "kind": "count",
             "op": ">", "threshold": 0.0, "tags": "env:t"},
            {"id": "c", "metric": "s.0", "kind": "cardinality",
             "op": ">=", "threshold": 1.0}])
        assert n == 2
        rep = {r["id"]: r for r in server.alerts.report()["rules"]}
        assert rep["a"]["state"] == "firing"
        assert rep["c"]["state"] == "idle"
        assert "b" not in rep
        with pytest.raises(QueryError):  # a bad reload keeps the table
            server.alerts.configure([{"id": "x", "metric": "m",
                                      "kind": "count", "op": "~",
                                      "threshold": 1}])
        assert {r["id"] for r in
                server.alerts.report()["rules"]} == {"a", "c"}
        server.reload_alerts()
        assert server.telemetry.events.snapshot(kind="alerts_reload")
    finally:
        server.shutdown()


def test_transition_log_rate_limit():
    """First transition per rule per flush interval is logged, the rest
    only counted; the recorder keeps every one."""
    server, _obs = mk_server()
    try:
        _feed(server, corpus())
        server.alerts.configure([
            {"id": "flap", "metric": "c.0", "kind": "count",
             "op": ">", "threshold": 0.5, "tags": "env:t"}])
        now = time.time()
        server.alerts.evaluate_once(now=now)        # -> firing
        server.alerts.configure([
            {"id": "flap", "metric": "c.0", "kind": "count",
             "op": ">", "threshold": 1e9, "tags": "env:t"}])
        server.alerts.evaluate_once(now=now + 0.1)  # -> resolved
        assert server.alerts.suppressed_logs_total == 1
        assert len(server.telemetry.events.snapshot(
            kind="alert_transition")) == 2
    finally:
        server.shutdown()


def test_every_kind_evaluates_like_the_query():
    """One tick over a rule per kind: each rule's value is the query's."""
    server, _obs = mk_server()
    try:
        _feed(server, corpus())
        rules = [
            {"id": "q", "metric": "t.1", "kind": "quantile", "q": 0.99,
             "op": ">", "threshold": 0},
            {"id": "l", "metric": "ll.1", "kind": "quantile", "q": 0.5,
             "op": ">", "threshold": 0},
            {"id": "c", "metric": "c.1", "kind": "count", "op": ">",
             "threshold": 0},
            {"id": "g", "metric": "g.1", "kind": "value", "op": "<",
             "threshold": 0},
            {"id": "s", "metric": "s.1", "kind": "cardinality",
             "op": "==", "threshold": 2},
            {"id": "b", "metric": "ll.1", "kind": "bin_occupancy", "lo": 0,
             "hi": 100, "op": ">=", "threshold": 1},
            {"id": "none", "metric": "absent", "kind": "count", "op": "<",
             "threshold": 1}]
        server.alerts.configure(rules)
        server.alerts.evaluate_once()
        rep = {r["id"]: r for r in server.alerts.report()["rules"]}
        assert {k: v["state"] for k, v in rep.items()} == {
            "q": "firing", "l": "firing", "c": "firing", "g": "idle",
            "s": "firing", "b": "firing", "none": "idle"}
        assert rep["none"]["value"] is None
        from test_torch_query import _q
        for rid, metric, kind, kw in (
                ("q", "t.1", "quantile", dict(q=0.99)),
                ("c", "c.1", "count", {}), ("s", "s.1", "cardinality", {})):
            want = _q(server, metric, kind, **kw)["value"]
            assert rep[rid]["value"] == round(float(np.float32(want)), 6)
    finally:
        server.shutdown()


def test_alerts_config_block_and_reload_from_file(tmp_path):
    cfg = config_from_dict({"alerts": {"interval": "500ms", "rules": [
        {"id": "r1", "metric": "m", "kind": "quantile", "q": 0.99,
         "op": ">", "threshold": 100, "for": "30s"}]}})
    assert isinstance(cfg.alerts, AlertsConfig)
    assert cfg.alerts.interval == 0.5
    with pytest.raises(ValueError, match="alerts.'nope'"):
        config_from_dict({"alerts": {"nope": 1}})
    server, _obs = mk_server(alerts={"interval": "500ms",
                                     "rules": cfg.alerts.rules})
    try:
        assert server.alerts.interval_s == 0.5
        rule = server.alerts.report()["rules"][0]
        assert rule["for_s"] == 30.0 and rule["q"] == 0.99
        path = tmp_path / "veneur.yaml"
        path.write_text("alerts:\n  interval: 2s\n  rules:\n"
                        "    - {id: a, metric: m, kind: count, "
                        "threshold: 1}\n"
                        "    - {id: b, metric: m, kind: value, "
                        "threshold: 1}\n")
        assert server.reload_alerts(str(path)) == 2
        assert server.alerts.interval_s == 2.0
        assert [r["id"] for r in server.alerts.report()["rules"]] == \
            ["a", "b"]
    finally:
        server.shutdown()


def test_bad_rule_table_starts_empty():
    server, _obs = mk_server(alerts={"rules": [{"id": "x"}]})
    try:
        assert server.alerts.report()["rules"] == []
    finally:
        server.shutdown()
