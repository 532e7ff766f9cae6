"""The port's flow ledger against the JAX package's, on the CPU: the same
stage feed through both FlowLedgers gives equal reports and imbalances;
the server's identities balance under `ledger_strict` on the columnar
ingest path (native and numpy decoders), the slow path, the import
merges, an outage with the carryover and the spool, and the backfill
plane; an unaccounted drop is caught; the ledger's /debug/ledger route,
telemetry rows and config keys."""

from __future__ import annotations

import json
import socket
import time
import urllib.request

import pytest

from veneur_tpu.core.ledger import FlowLedger as JLedger
from veneur_tpu.core.ledger import LedgerImbalance as JImbalance
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.ledger import LEDGER_ROWS, FlowLedger
from veneur_tpu_torch.core.ledger import LedgerImbalance
from veneur_tpu_torch.forward.server import ImportServer

from test_torch_forward import _series, _tserver


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- the ledger itself against the JAX package's -----------------------------

def _feed(ledger, scenario, counters):
    """One scenario's declarations and stage feed (three intervals)."""
    ledger.declare("ingest", inputs=("in",), outputs=("ok", "rej"))
    ledger.declare("fwd", inputs=("snap",), outputs=("acked", "shed"),
                   stocks=("carry", "spool"))
    ledger.probe("ok", lambda: counters["applied"], key="probe")
    ledger.probe_map("rej", lambda: dict(counters["rejected"]))
    ledger.stock("carry", lambda: counters["carry"])
    records = []
    for interval in range(3):
        ledger.note("in", 10 + interval, key="native")
        counters["applied"] += 9 + interval
        counters["rejected"]["gate"] = counters["rejected"].get("gate", 0) + 1
        ledger.note("snap", 5)
        if scenario == "outage" and interval == 1:
            counters["carry"] += 5  # held, not lost
        else:
            ledger.note("acked", 5 + (counters["carry"]
                                      if interval == 2 else 0))
        if scenario == "leak" and interval == 2:
            ledger.note("in", 3, key="python")  # never applied
        if scenario == "outage" and interval == 2:
            counters["carry"] = 0
        try:
            records.append(ledger.close_interval())
        except (LedgerImbalance, JImbalance) as e:
            records.append({"raised": dict(e.imbalances)})
    return records


def _strip(record):
    record = dict(record)
    record.pop("closed_unix", None)
    return record


@pytest.mark.parametrize("scenario", ["balanced", "outage", "leak"])
@pytest.mark.parametrize("strict", [False, True])
def test_same_feed_same_report_as_jax(scenario, strict):
    out = []
    for cls in (JLedger, FlowLedger):
        events = []
        ledger = cls(strict=strict, history=8, clock=lambda: 1000.0,
                     on_event=lambda kind, **f: events.append((kind, f)))
        counters = {"applied": 0, "rejected": {}, "carry": 0}
        records = [_strip(r) for r in _feed(ledger, scenario, counters)]
        report = ledger.report(intervals=2)
        report.pop("generated_unix")
        report["intervals"] = [_strip(r) for r in report["intervals"]]
        out.append((records, report, ledger.history_imbalances(),
                    ledger.telemetry_rows(), events,
                    dict(ledger.imbalance_net)))
    assert out[0] == out[1]
    imbalances = out[1][2]
    if scenario == "leak":
        assert imbalances[-1]["ingest"] == 3.0
        assert out[1][4][-1][0] == "ledger_imbalance"
    else:
        assert all(not any(i.values()) for i in imbalances)


def test_disabled_ledger_books_nothing_like_jax():
    for cls in (JLedger, FlowLedger):
        ledger = cls(enabled=False)
        ledger.declare("x", inputs=("a",), outputs=("b",))
        ledger.note("a", 5)
        assert ledger.close_interval() == {}
        assert ledger.telemetry_rows() == []
    assert LEDGER_ROWS == __import__(
        "veneur_tpu.core.ledger", fromlist=["x"]).LEDGER_ROWS


# -- the server's identities -------------------------------------------------

_LINES = [b"a:1|c|#veneurglobalonly", b"b:2|g", b"b:3|g", b"t:3|ms",
          b"t:4|h", b"s:x|s", b"s:y|s", b"l:4|l", b"l:5|l|@0.5",
          b"_sc|chk|0", b"_e{1,1}:a|b", b"bad line", b"c2:5|c|@0.1",
          b"u:1|c|#k:v"]


def _stage(server, stage):
    return sum(server.ledger.report()["stage_totals"].get(stage, {})
               .values())


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_ingest_identity_balances_on_both_paths(decoder):
    """The first pass interns every key on the slow path, the second
    takes the columnar path; strict flushes raise on any imbalance."""
    tpu = {"disable_native_parser": decoder == "numpy"}
    server, _sink = _tserver(ledger_strict=True, tpu={
        "counter_capacity": 8, "gauge_capacity": 8, "histo_capacity": 8,
        "set_capacity": 8, "llhist_capacity": 4, "batch_cap": 64, **tpu})
    try:
        for _ in range(2):
            server.handle_packet_batch(_LINES)
            server.flush()
        report = server.ledger.report()
        admitted = report["stage_totals"]["ingest.admitted"]
        assert admitted["python"] > 0
        assert admitted["native" if decoder == "native" else "columnar"] > 0
        assert sum(admitted.values()) == _stage(server, "agg.applied")
        assert all(not any(i.values())
                   for i in server.ledger.history_imbalances())
        # the rejected lines surface as an informational stage
        assert _stage(server, "ingress.parse_errors") == 2
    finally:
        server.shutdown()


def test_ingest_over_udp_through_the_pump_balances():
    server, _sink = _tserver(ledger_strict=True,
                             statsd_listen_addresses=["udp://127.0.0.1:0"])
    try:
        addr = server.listen_addresses[0]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sk:
            for rnd in range(2):
                for i in range(40):
                    sk.sendto(b"p%d:1|c\nq:%d|h\nw:%d|s\nz:%d|l"
                              % (i, i, i, i), addr)
                want = 160 * (rnd + 1)
                assert _wait_for(lambda: server.stats_snapshot()[
                    "lines_received"] == want)
                server.flush()
        assert _stage(server, "ingest.admitted") == 320
        assert _stage(server, "agg.applied") == 320
    finally:
        server.shutdown()


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_flush_racing_a_chunk_in_transit_balances(decoder, monkeypatch):
    """A flush whose interval close lands while a chunk is between its
    admitted stamp and its table's applied stamp (the histogram apply
    held here until the flush is well under way): the close waits for
    the chunk, so the strict ledger books both sides in one interval.
    Without the wait it books the admitted samples alone and raises."""
    import threading
    tpu = {"disable_native_parser": decoder == "numpy"}
    server, _sink = _tserver(ledger_strict=True, tpu={
        "counter_capacity": 8, "gauge_capacity": 8, "histo_capacity": 8,
        "set_capacity": 8, "llhist_capacity": 4, "batch_cap": 64, **tpu})
    try:
        server.handle_packet_batch(_LINES)  # interns every key
        server.flush()
        held, release = threading.Event(), threading.Event()
        add_batch = server.store.histos.add_batch

        def slow_add_batch(*cols):
            held.set()
            release.wait(10)
            add_batch(*cols)
        monkeypatch.setattr(server.store.histos, "add_batch", slow_add_batch)
        ingest = threading.Thread(target=server.handle_packet_batch,
                                  args=(_LINES,))
        ingest.start()
        assert held.wait(10)
        errors = []

        def flush():
            try:
                server.flush()
            except Exception as e:
                errors.append(e)
        flusher = threading.Thread(target=flush)
        flusher.start()
        time.sleep(0.5)  # the flush reaches its interval close
        release.set()
        ingest.join(10)
        flusher.join(20)
        assert not errors, errors
        server.flush()
        assert all(not any(i.values())
                   for i in server.ledger.history_imbalances())
        assert _stage(server, "ingest.admitted") == \
            _stage(server, "agg.applied")
    finally:
        server.shutdown()


def test_unaccounted_drop_is_caught(monkeypatch):
    server, _sink = _tserver(ledger_strict=True)
    try:
        server.handle_packet_batch([b"x:1|c"])
        server.flush()
        # a table that silently drops a sample: admitted, never applied
        monkeypatch.setattr(server.store.counters, "_note_applied",
                            lambda n: None)
        server.handle_packet_batch([b"x:1|c"])
        with pytest.raises(LedgerImbalance, match="ingest"):
            server.flush()
        events = json.loads(server.telemetry.events_json(
            kind="ledger_imbalance"))["events"]
        assert events and events[-1]["imbalance"] == {"ingest": 1.0}
    finally:
        server.shutdown()


def test_unknown_type_is_an_explained_rejection():
    from veneur_tpu_torch.samplers.metrics import MetricKey, UDPMetric
    server, _sink = _tserver(ledger_strict=True)
    try:
        server.ingest_metric(UDPMetric(key=MetricKey("odd", "weird", ""),
                                       value=1.0))
        server.flush()
        assert _stage(server, "agg.rejected") == 1
        assert server.store.unknown_rejected == 1
    finally:
        server.shutdown()


def test_forward_identities_balance_through_an_outage(tmp_path):
    """Local -> global over gRPC under ledger_strict on both ends: the
    global's import stamps, then an outage (the carryover, then the
    spool, hold the intervals) and the recovery."""
    port = _free_port()
    address = f"127.0.0.1:{port}"
    gserver, gsink = _tserver(grpc_address=address, ledger_strict=True)
    local, _ = _tserver(forward_address=address, ledger_strict=True,
                        forward_retry_max_attempts=1,
                        carryover_max_intervals=1,
                        carryover_spool_dir=str(tmp_path),
                        circuit_breaker_failure_threshold=1000)
    try:
        for rnd in range(6):
            if rnd == 1:
                gserver.import_server.stop()
            if rnd == 4:
                gserver.import_server = ImportServer(gserver, address)
                gserver.import_server.start()
            local.handle_packet_batch(
                [b"f:%d|c|#veneurglobalonly" % (rnd + 1), b"t:%d|ms" % rnd,
                 b"s:m%d|s" % rnd, b"l:%d|l" % (rnd + 1)])
            local.flush()
            gserver.flush()
        fc = local.forward_client
        for _ in range(20):
            if fc.carryover.depth == 0 and fc.spool.depth == 0:
                break
            time.sleep(0.5)
            local.flush()
        assert fc.carryover.depth == 0 and fc.spool.depth == 0
        gserver.flush()
        series = {}
        for m in gsink.drain():
            if m.name == "f":
                series["f"] = series.get("f", 0.0) + m.value
        assert series["f"] == sum(range(1, 7))
        report = local.ledger.report()
        assert report["stage_totals"]["forward.acked"]
        assert _stage(local, "forward.snapshot") > 0
        assert _stage(local, "forward.remote_merged") > 0
        for server in (local, gserver):
            assert all(not any(i.values())
                       for i in server.ledger.history_imbalances())
        assert _stage(gserver, "import.received") == \
            _stage(gserver, "ingest.admitted")
    finally:
        local.shutdown()
        gserver.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_backfill_identity_balances(tmp_path):
    """A WAL segment replayed as a stale interval merges into the
    global's backfill plane: backfill.merged, then backfill.closed once
    its bucket drains, with the open buckets as the stock."""
    stale = 0.5 / 3600.0
    dead, _ = _tserver(forward_address="127.0.0.1:1", forward_wal=True,
                       carryover_spool_dir=str(tmp_path),
                       wal_stale_after_intervals=stale, ledger_strict=True)
    dead.handle_packet_batch([b"bf:1|c|#veneurglobalonly", b"bl:2|l"])
    dead.flush()
    dead.shutdown()
    time.sleep(1.0)  # the segment's interval is now stale
    gserver, gsink = _tserver(grpc_address="127.0.0.1:0",
                              wal_stale_after_intervals=stale,
                              ledger_strict=True)
    local, _ = _tserver(forward_address=gserver.import_server.address,
                        forward_wal=True, carryover_spool_dir=str(tmp_path),
                        wal_stale_after_intervals=stale, ledger_strict=True)
    try:
        local.flush()
        assert _wait_for(lambda: gserver.backfill.open_intervals == 1)
        gserver.flush()
        gserver.flush()
        assert _stage(gserver, "backfill.merged") == 2
        assert _stage(gserver, "backfill.closed") == 2
        assert gserver.backfill.open_intervals == 0
        assert any(m.backfilled for m in gsink.drain())
        for server in (local, gserver):
            assert all(not any(i.values())
                       for i in server.ledger.history_imbalances())
    finally:
        local.shutdown()
        gserver.shutdown()


def test_debug_ledger_route_and_telemetry_rows():
    server, _sink = _tserver(http_address="127.0.0.1:0", ledger_history=2)
    try:
        for _ in range(3):
            server.handle_packet_batch([b"r:1|c"])
            server.flush()
        host, port = server.http_api.address
        with urllib.request.urlopen(
                f"http://{host}:{port}/debug/ledger?intervals=5") as r:
            report = json.loads(r.read())
        assert set(report["identities"]) == {
            "ingest", "forward", "backfill", "forward_tier"}
        assert report["intervals_closed"] == 3
        assert len(report["intervals"]) == 2  # ledger_history
        with urllib.request.urlopen(f"http://{host}:{port}/metrics") as r:
            text = r.read().decode()
        assert 'veneur_ledger_imbalance{identity="ingest"} 0' in text
        assert "veneur_ledger_intervals_closed_total 3" in text
    finally:
        server.shutdown()


def test_ledger_keys_are_accepted():
    cfg = config_from_dict({"ledger_enabled": False, "ledger_strict": True,
                            "ledger_history": 7})
    assert (cfg.ledger_enabled, cfg.ledger_strict, cfg.ledger_history) == \
        (False, True, 7)
    server, _sink = _tserver(ledger_enabled=False)
    try:
        server.handle_packet_batch([b"n:1|c"])
        server.flush()
        assert server.ledger.intervals_closed == 0
        assert _series(_sink.drain())[("n", (), "COUNTER")] == 1.0
    finally:
        server.shutdown()
