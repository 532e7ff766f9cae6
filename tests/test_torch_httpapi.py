"""The port's operator HTTP API (veneur_tpu_torch/core/httpapi.py)
against the JAX package's (veneur_tpu/core/httpapi.py), on the CPU:

- standalone (no server behind it), every GET route of the JAX package
  answers the same status and, where neither version strings, configs,
  devices nor thread stacks differ by nature, the same body; the
  profiling routes answer 200 with valid profiles, as the JAX routes
  answer;
- a JAX server and a port server started on the same config and fed the
  same packets over UDP: readiness before and after the first flush,
  /query (values and errors), /alerts, /debug/events, /debug/flush,
  /metrics and /config/json answer alike;
- the flush watchdog's readiness trip, /config/json redaction,
  /quitquitquit, and the per-route http.route rows.
"""

from __future__ import annotations

import json
import re
import socket
import time
import urllib.error
import urllib.request

import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.config import SinkConfig as JSinkConfig
from veneur_tpu.core.httpapi import HTTPApi as JHTTPApi
from veneur_tpu.core.httpapi import _TIMED_ROUTES as J_ROUTES
from veneur_tpu.core.httpapi import config_to_dict as j_config_to_dict
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu.util.secret import StringSecret as JStringSecret
from veneur_tpu_torch.config import SinkConfig, config_from_dict
from veneur_tpu_torch.core.httpapi import (_PROFILING_ROUTES, _TIMED_ROUTES,
                                           HTTPApi, config_to_dict)
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink
from veneur_tpu_torch.util.secret import StringSecret

from test_torch_query import SIZES, corpus


def _get(address, path, method="GET"):
    host, port = address
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_route_tables_equal_jax():
    assert _TIMED_ROUTES == J_ROUTES
    assert _PROFILING_ROUTES < _TIMED_ROUTES


# routes whose body differs by nature between the packages
_BODY_DIFFERS = {"/version", "/config/json", "/config/yaml",
                 "/debug/memory", "/debug/threads", "/metrics",
                 # the help text names the port's torch.profiler trace
                 "/debug/pprof", "/debug/pprof/"}
_GET_ROUTES = sorted(r for r in _TIMED_ROUTES
                     if r not in _PROFILING_ROUTES)


@pytest.fixture(scope="module")
def standalone():
    """A standalone API of each package on the same kind of config."""
    japi = JHTTPApi(JConfig().apply_defaults(), address="127.0.0.1:0")
    tapi = HTTPApi(config_from_dict({}), address="127.0.0.1:0")
    japi.start()
    tapi.start()
    yield japi, tapi
    japi.stop()
    tapi.stop()


@pytest.mark.parametrize("route", _GET_ROUTES)
def test_standalone_get_route_equal_jax(standalone, route):
    japi, tapi = standalone
    want = _get(japi.address, route)
    got = _get(tapi.address, route)
    assert got[0] == want[0], (route, got, want)
    if route not in _BODY_DIFFERS:
        assert got[1] == want[1], route


@pytest.mark.parametrize("route", ["/quitquitquit", "/reshard", "/nope"])
def test_standalone_post_route_equal_jax(standalone, route):
    japi, tapi = standalone
    assert _get(tapi.address, route, "POST") == \
        _get(japi.address, route, "POST")


@pytest.mark.parametrize("route", sorted(_PROFILING_ROUTES))
def test_profiling_routes_answer_501(standalone, route):
    """Each profiling route's real answer (core/profiling.py; before it
    was ported they answered 501): 200 with a valid gzipped pprof, the
    text CPU profile or the device-trace zip, the status the JAX
    package's route answers (its device trace is not asked here)."""
    import gzip
    import io
    import zipfile
    japi, tapi = standalone
    path = route + "?seconds=0.1"
    status, body = _get(tapi.address, path)
    assert status == 200, (route, body)
    if route == "/debug/profile/device":
        zf = zipfile.ZipFile(io.BytesIO(body))
        assert set(zf.namelist()) == {"trace.json", "summary.json"}
        return
    assert _get(japi.address, path)[0] == status
    if route == "/debug/profile/cpu":
        assert body.startswith(b"cpu profile: ")
    else:
        assert body[:2] == b"\x1f\x8b" and gzip.decompress(body)


def test_standalone_metrics_and_version(standalone):
    _japi, tapi = standalone
    import veneur_tpu_torch
    assert _get(tapi.address, "/version") == \
        (200, veneur_tpu_torch.__version__.encode())
    status, body = _get(tapi.address, "/metrics")
    assert status == 200
    text = body.decode()
    assert "veneur_http_route_count_total" in text
    # Prometheus text: every sample line is `name{labels} value`
    for line in text.splitlines():
        if not line.startswith("#"):
            assert re.fullmatch(r"[a-zA-Z_:][\w:]*(\{.*\})? \S+", line), line
    status, body = _get(tapi.address, "/metrics?exemplars=1")
    assert status == 200 and body.endswith(b"# EOF\n")
    assert json.loads(_get(tapi.address, "/debug/memory")[1]) == []


# -- two servers behind their APIs --------------------------------------------

RULES = [
    {"id": "hits", "metric": "c.0", "kind": "count", "op": ">",
     "threshold": 0.5, "tags": "env:t"},
    {"id": "slow", "metric": "t.1", "kind": "quantile", "q": 0.99,
     "op": ">", "threshold": 1e9},
    {"id": "uniq", "metric": "s.2", "kind": "cardinality", "op": ">=",
     "threshold": 2},
]


def _jax_server(**extra):
    cfg = JConfig()
    cfg.interval = 3600.0
    cfg.hostname = "test"
    for key, value in SIZES.items():
        if key != "set_promote_samples":
            setattr(cfg.tpu, key, value)
    cfg.alerts.rules = RULES
    cfg.alerts.interval = 3600.0
    for key, value in extra.items():
        setattr(cfg, key, value)
    server = JServer(cfg.apply_defaults(), extra_metric_sinks=[JChannel()])
    # a server's own spans reach its span extraction, whose 1 in 100
    # ssf.names_unique roll can add a flushed row: off on both servers
    server.metric_extraction._uniqueness_rate = 0.0
    return server


def _port_server(**extra):
    cfg = config_from_dict({
        "interval": "1h", "hostname": "test", "tpu": SIZES,
        "alerts": {"interval": "1h", "rules": RULES}, **extra})
    server = Server(cfg, device="cpu",
                    extra_metric_sinks=[ChannelMetricSink()])
    server.metric_extraction.uniqueness_rate = 0.0
    return server


def _received(server):
    if isinstance(server, JServer):
        return server.stats["packets_received"]
    return server.stats_snapshot()["lines_received"]


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


QUERIES = [
    "/query?metric=c.0&kind=count&tags=env:t",
    "/query?metric=t.0&kind=percentile&q=0.5",
    "/query?metric=g.3&kind=value",
    "/query?metric=s.1&kind=cardinality",
    "/query?metric=ll.2&kind=bin_occupancy&lo=0&hi=6",
    "/query?metric=absent&kind=count",
    "/query?kind=count",
    "/query?metric=x&kind=quantile",
    "/query?metric=x&kind=nope",
]


@pytest.fixture(scope="module")
def served():
    """Both servers on the same config, fed the same corpus over UDP,
    read before the first flush, flushed once, then read again."""
    extra = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 http_address="127.0.0.1:0")
    servers = {"jax": _jax_server(**extra), "torch": _port_server(**extra)}
    lines = corpus()
    out = {}
    try:
        for package, server in servers.items():
            server.start()
            addr = (server.local_addr("udp") if package == "jax"
                    else server.listen_addresses[0])
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for i in range(0, len(lines), 8):
                    tx.sendto(b"\n".join(lines[i:i + 8]), addr)
                    time.sleep(0.002)
            assert _wait_for(lambda: _received(server) == len(lines))
            server.store.apply_all_pending()
            api = server.http_api.address
            rec = {"ready_before": _get(api, "/healthcheck/ready"),
                   "queries": [_get(api, q) for q in QUERIES]}
            server.alerts.evaluate_once()
            rec["alerts"] = json.loads(_get(api, "/alerts")[1])
            server.flush()
            rec["ready_after"] = _get(api, "/healthcheck/ready")
            rec["events"] = json.loads(_get(api, "/debug/events")[1])
            rec["flush"] = json.loads(_get(api, "/debug/flush")[1])
            rec["waterfall"] = json.loads(
                _get(api, "/debug/flush?waterfall=1")[1])
            rec["config"] = json.loads(_get(api, "/config/json")[1])
            rec["metrics"] = _get(api, "/metrics")[1].decode()
            out[package] = rec
    finally:
        for server in servers.values():
            server.config.flush_on_shutdown = False
            server.shutdown()
    return out


def test_readiness_before_and_after_first_flush(served):
    for package in ("jax", "torch"):
        assert served[package]["ready_before"] == (200, b"ready\n")
        assert served[package]["ready_after"] == (200, b"ready\n")


@pytest.mark.parametrize("i", range(len(QUERIES)), ids=QUERIES)
def test_query_route_equal_jax(served, i):
    want_status, want = served["jax"]["queries"][i]
    got_status, got = served["torch"]["queries"][i]
    assert got_status == want_status
    want, got = json.loads(want), json.loads(got)
    if want_status != 200:
        assert got == want
        return
    for key in ("metric", "kind", "family", "matched_rows", "rows", "q",
                "lo", "hi", "tags", "stale_pending_samples"):
        assert got.get(key) == want.get(key), key
    if got["kind"] == "quantile":
        assert got["value"] == pytest.approx(want["value"], rel=2e-5)
    else:
        assert got["value"] == want["value"]


def test_alerts_route_equal_jax(served):
    want, got = served["jax"]["alerts"], served["torch"]["alerts"]
    for rep in (want, got):
        rep.pop("generated_unix")
        for rule in rep["rules"]:
            rule.pop("since_unix")
    assert got == want
    assert [r["state"] for r in got["rules"]] == ["firing", "idle", "firing"]


def test_events_and_flush_routes_equal_jax(served):
    kinds = {p: [e["kind"] for e in served[p]["events"]["events"]]
             for p in ("jax", "torch")}
    for kind in ("startup", "alert_transition", "flush"):
        assert kinds["torch"].count(kind) == kinds["jax"].count(kind), kind
    want, got = (served[p]["flush"]["rounds"] for p in ("jax", "torch"))
    assert len(got) == len(want) == 1
    for key in ("flush", "mode", "metrics_flushed"):
        assert got[0][key] == want[0][key], key
    # the JAX server also flushes its span sinks (the port has none)
    assert {k: v["status"] for k, v in got[0]["sinks"].items()} == \
        {k: v["status"] for k, v in want[0]["sinks"].items()
         if k.startswith("metric:")}
    assert "critical_path_s" in got[0]["phases"]
    tree = served["torch"]["waterfall"]["rounds"][0]
    assert set(tree) >= set(served["jax"]["waterfall"]["rounds"][0]) - {
        "trace_id"}


def test_config_json_equal_jax_where_both_have_the_key(served):
    want, got = served["jax"]["config"], served["torch"]["config"]
    for key in ("interval", "hostname", "percentiles", "aggregates",
                "http_address", "http_quit", "stats_address",
                "flush_watchdog_missed_flushes", "alerts"):
        assert got[key] == want[key], key
    assert set(got["tpu"]) - {"set_promote_samples", "set_max_dev_slots"} \
        <= set(want["tpu"])


def _metric_names(text):
    return {line.split(" ")[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_route_rows(served):
    got = _metric_names(served["torch"]["metrics"])
    want = _metric_names(served["jax"]["metrics"])
    shared = {"veneur_http_route_p50", "veneur_http_route_count_total",
              "veneur_query_requests_total", "veneur_query_errors_total",
              "veneur_query_eval_p99", "veneur_alert_rules",
              "veneur_alert_state", "veneur_alert_evals_total",
              "veneur_flush_rounds_total",
              "veneur_columnstore_row_capacity",
              "veneur_columnstore_live_rows", "veneur_llhist_samples_total",
              "veneur_ingest_ring_depth", "veneur_flush_total_duration_ns",
              "veneur_flush_metrics_total"}
    assert shared <= want
    assert shared <= got
    text = served["torch"]["metrics"]
    assert 'path="/query"' in text and 'path="/alerts"' in text


def test_watchdog_trips_readiness_like_jax():
    extra = dict(flush_watchdog_missed_flushes=2)
    jserver = _jax_server(interval=1.0, **extra)
    tserver = _port_server(**dict(extra, interval="1s"))
    bodies = []
    for server, api_cls in ((jserver, JHTTPApi), (tserver, HTTPApi)):
        api = api_cls(server.config, server=server, address="127.0.0.1:0")
        api.start()
        try:
            assert _get(api.address, "/healthcheck/ready")[0] == 200
            server.last_flush_unix = time.time() - 30.0
            status, body = _get(api.address, "/healthcheck/ready")
            assert status == 503
            bodies.append(re.sub(rb"[0-9.]+s", b"Ns", body))
        finally:
            api.stop()
            server.config.flush_on_shutdown = False
            server.shutdown()
    assert bodies[1] == bodies[0]
    assert json.loads(bodies[1])["reason"].startswith(
        "flush watchdog tripped")


def test_config_redaction_equal_jax():
    jcfg = JConfig().apply_defaults()
    jcfg.metric_sinks = [JSinkConfig(kind="datadog", name="dd", config={
        "datadog_api_key": JStringSecret("supersecret")})]
    tcfg = config_from_dict({})
    tcfg.metric_sinks = [SinkConfig(kind="datadog", name="dd", config={
        "datadog_api_key": StringSecret("supersecret")})]
    want = j_config_to_dict(jcfg)["metric_sinks"]
    got = config_to_dict(tcfg)["metric_sinks"]
    assert got == want
    assert got[0]["config"]["datadog_api_key"] == "REDACTED"
    api = HTTPApi(tcfg, address="127.0.0.1:0")
    api.start()
    try:
        for route in ("/config/json", "/config/yaml"):
            status, body = _get(api.address, route)
            assert status == 200 and b"REDACTED" in body
            assert b"supersecret" not in body
    finally:
        api.stop()
    assert str(StringSecret("")) == "" and not StringSecret("")
    assert StringSecret("x").reveal() == "x"


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_quitquitquit_shuts_the_server_down(package):
    extra = dict(http_address="127.0.0.1:0", http_quit=True)
    server = (_jax_server(**extra) if package == "jax"
              else _port_server(**extra))
    server.start()
    try:
        assert _get(server.http_api.address, "/quitquitquit", "POST") == \
            (200, b"bye\n")
        assert server.shutdown_complete.wait(30.0)
    finally:
        if not server.shutdown_complete.is_set():
            server.config.flush_on_shutdown = False
            server.shutdown()


@pytest.mark.parametrize("raw", [
    {"http_address": "127.0.0.1:0", "http_quit": True},
    {"stats_address": "internal"},
    {"alerts": {"enabled": False, "interval": "2s", "rules": []}},
    {"flush_on_shutdown": True, "synchronize_with_interval": True},
    {"flush_watchdog_missed_flushes": 3, "omit_empty_hostname": True},
    {"tags_exclude": ["host"], "extend_tags": ["env:prod"]},
    {"veneur_metrics_additional_tags": ["a:b"],
     "veneur_metrics_scopes": {"counter": "global"}},
    {"features": {"diagnostics_metrics_enabled": True}},
])
def test_operator_keys_are_accepted(raw):
    cfg = config_from_dict(raw)
    for key, value in raw.items():
        if key not in ("alerts", "features"):
            assert getattr(cfg, key) == value


@pytest.mark.parametrize("key", ["chaos_reshard_append_fault_nth",
                                 "chaos_reshard_cutover_delay_s",
                                 "chaos_reshard_prewarm_delay_s",
                                 "jax_compilation_cache_dir",
                                 "reshard_spool_dir", "reshard_deadline"])
def test_unported_keys_still_raise(key):
    """jax_compilation_cache_dir has no torch meaning and raises by name;
    the reshard keys, ported with the elastic reshard, read like the JAX
    package's Config."""
    if key == "jax_compilation_cache_dir":
        with pytest.raises(ValueError, match=key):
            config_from_dict({key: 1})
        return
    from veneur_tpu.config import Config as JConfig
    from veneur_tpu.config import read_config as jread_config
    value = "45s" if key == "reshard_deadline" else 1
    assert getattr(config_from_dict({}), key) == getattr(JConfig(), key)
    assert getattr(config_from_dict({key: value}), key) == \
        getattr(jread_config(overrides={key: value}), key)


@pytest.mark.parametrize("key,value", [("ingest_rate_limit_spans", 250.0),
                                       ("trace_self_sample_rate", 0.5)])
def test_overload_and_trace_keys_are_read_like_jax(key, value):
    from veneur_tpu.config import Config as JConfig
    assert getattr(config_from_dict({}), key) == getattr(JConfig(), key)
    assert getattr(config_from_dict({key: value}), key) == value
