"""The port's operator drivers on the CPU: the crash-replay SIGKILL soak
(veneur_tpu_torch/cmd/crash_replay_soak.py), the ring-failover soak
(cmd/ring_failover_soak.py), the alert drill (cmd/alert_drill.py), and
the JAX package's HTTP-only report scripts (scripts/flow_report.py,
scripts/device_report.py) read against a port server.

The crash soak's control global is also held to the reference: an
in-process JAX Server fed the same rounds of lines holds the same
counter sums and the same llhist registers.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu_torch.cmd import alert_drill, crash_replay_soak
from veneur_tpu_torch.cmd import ring_failover_soak
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.server import Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    """A module of scripts/ (they speak only HTTP)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the crash-replay soak ---------------------------------------------------

def _crash_soak_cli(capsys, kills: int) -> dict:
    """Run the soak's CLI on the CPU and return the report it prints."""
    assert crash_replay_soak.main(["--kills", str(kills),
                                   "-device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(f"ok: {kills} kill(s), {kills} restart(s)")
    return json.loads("\n".join(out[:-1]))


def _jax_reference(rounds: int) -> tuple:
    """Counter sums and nonzero llhist registers of a JAX Server fed
    `rounds` rounds of the soak's lines."""
    cfg = JConfig()
    cfg.hostname = "ref"
    cfg.interval = 3600.0
    cfg.statsd_listen_addresses = []
    for key, value in crash_replay_soak._TPU.items():
        setattr(cfg.tpu, key, value)
    server = JServer(cfg.apply_defaults())
    try:
        for r in range(rounds):
            for line in crash_replay_soak.lines_for(r):
                server.handle_metric_packet(line.encode())
        server.store.apply_all_pending()
        vals, touched, meta = server.store.counters.snapshot_and_reset()
        counters = {meta[r].name: float(np.asarray(vals)[r])
                    for r in np.flatnonzero(np.asarray(touched)).tolist()}
        _out, bins, touched, meta = server.store.llhists.snapshot_and_reset(
            (0.5,))
        bins = np.asarray(bins)
        llhist = {meta[row].name: {str(b): int(bins[i][b])
                                   for b in np.flatnonzero(bins[i])}
                  for i, row in enumerate(
                      np.flatnonzero(np.asarray(touched)).tolist())}
    finally:
        server.shutdown()
    return counters, llhist


def test_crash_replay_soak_one_kill_on_the_cpu_equals_the_jax_server(
        capsys):
    """One SIGKILL mid-send after the WAL append, a restart that replays
    the segment: the faulted global equals the control (the soak's own
    assertions), and the control equals a JAX Server fed the same two
    rounds of lines: counter sums exact, llhist registers bit for bit."""
    report = _crash_soak_cli(capsys, kills=1)
    assert (report["kills"], report["restarts"]) == (1, 1)
    assert report["device"] == "cpu"
    counters, llhist = _jax_reference(rounds=2)
    # 2 rounds x 40 counter lines of 3 over 8 names
    assert counters == {f"soak.cnt.{i}": 30.0 for i in range(8)}
    assert report["counters"] == counters
    assert report["llhist"] == llhist
    # a CPU run launches no kernel
    assert set(report["launches"].values()) == {0}


@pytest.mark.slow
def test_crash_replay_soak_two_kills_on_the_cpu(capsys):
    report = _crash_soak_cli(capsys, kills=2)
    assert (report["kills"], report["restarts"]) == (2, 2)
    counters, llhist = _jax_reference(rounds=3)
    assert report["counters"] == counters
    assert report["llhist"] == llhist


# -- the ring-failover soak --------------------------------------------------
#
# at the JAX tests' shapes (tests/test_ha.py TestRingFailoverSoak); the
# waits get the margin a loaded host under -n 6 needs

def _check_ring_report(report: dict) -> None:
    assert report["loss_unaccounted"] == 0, report
    assert report["proxy"]["received_total"] == report["sent"]
    assert report["settled"]
    assert report["destinations"]["<retired>"]["inflight"] == 0
    assert any(e["event"] == "ejected" and e["confirmed"]
               for e in report["events"])
    assert any(e["event"] == "readmitted" for e in report["events"])


def test_ring_failover_soak_quick(capsys):
    """The CLI at test_driver_quick's shape: every metric accounted for,
    an ejection and a readmission."""
    argv = ["--rounds", "6", "--per-round", "40", "--kill-round", "2",
            "--restore-round", "4", "--probe-interval", "0.05"]
    assert ring_failover_soak.main(argv) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["sent"] == 6 * 40
    _check_ring_report(report)


@pytest.mark.slow
def test_ring_failover_soak_at_the_soak_shape():
    report = ring_failover_soak.run_soak(
        rounds=16, per_round=250, kill_round=4, restore_round=10,
        probe_interval=0.05)
    _check_ring_report(report)
    # loss is confined to the kill -> ejection detection window
    assert report["detection_window_loss"] <= 2 * 250, report


# -- the alert drill ---------------------------------------------------------

def test_alert_drill_self_contained_on_the_cpu(capsys):
    """The drill's own server on the CPU walks the p99 rule pending ->
    firing -> resolved, and the trail's three assertions hold."""
    assert alert_drill.main(["-device", "cpu", "--interval", "1.0"]) == 0
    out = capsys.readouterr().out
    assert "self-contained server on cpu" in out
    assert "PASS: 'drill-p99' walked pending -> firing -> resolved" in out


def test_alert_drill_fails_on_a_missing_rule(capsys):
    """Aimed at a running server without the rule, the drill exits 1."""
    server = Server(config_from_dict({
        "interval": "3600s", "http_address": "127.0.0.1:0",
        "statsd_listen_addresses": ["udp://127.0.0.1:0"]}), device="cpu")
    server.start()
    try:
        host, port = server.local_addr("udp")
        http = "%s:%d" % server.http_api.address
        assert alert_drill.main(["--http", http, "--statsd",
                                 f"udp://{host}:{port}",
                                 "--rule", "absent"]) == 1
    finally:
        server.shutdown()
    assert "FAIL: rule 'absent' not present in /alerts" in \
        capsys.readouterr().out


# -- the report scripts against a port server --------------------------------

def _report_servers(leak: int):
    """A JAX and a port server with the HTTP API, each fed the same slow
    path lines and flushed; `leak` > 0 drops every leak-th admitted
    sample after its ledger stamp (an unexplained imbalance)."""
    lines = [b"rep.c%d:1|c" % i for i in range(8)]
    cfg = JConfig()
    cfg.hostname = "rep"
    cfg.interval = 3600.0
    cfg.statsd_listen_addresses = []
    cfg.http_address = "127.0.0.1:0"
    cfg.chaos_enabled = bool(leak)
    cfg.chaos_ledger_leak = leak
    jserver = JServer(cfg.apply_defaults())
    server = Server(config_from_dict({
        "hostname": "rep", "interval": "3600s",
        "statsd_listen_addresses": [], "http_address": "127.0.0.1:0",
        "chaos_enabled": bool(leak), "chaos_ledger_leak": leak}),
        device="cpu")
    for srv in (jserver, server):
        srv.start()
        for line in lines:
            srv.handle_metric_packet(line)
        srv.flush()
    return jserver, server


@pytest.mark.parametrize("leak", [0, 4])
def test_flow_and_device_reports_read_a_port_server_like_a_jax_one(
        leak, capsys):
    """flow_report.py and device_report.py over HTTP: the same exit
    codes for a port server as for a JAX server, balanced (0) and with
    a leak (flow_report 1)."""
    flow, device = _script("flow_report"), _script("device_report")
    jserver, server = _report_servers(leak)
    try:
        codes = {}
        for name, srv in (("jax", jserver), ("port", server)):
            base = "http://%s:%d" % srv.http_api.address
            codes[name] = (flow.main([base + "/debug/ledger"]),
                           device.main([base + "/debug/device"]))
            text = capsys.readouterr().out
            assert "flow ledger" in text
    finally:
        jserver.shutdown()
        server.shutdown()
    assert codes["port"] == codes["jax"] == ((1 if leak else 0), 0)
