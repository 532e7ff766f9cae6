"""The port's durable spool, WAL and backfill plane against the JAX
package's, on the CPU: the spool's on-disk format and its restart,
ordering and quarantine rules; spool directories that drain through the
other package's client; the backfill plane's emitted series; and, over
real gRPC on 127.0.0.1, a global that goes down for one interval, a WAL
crash drill with a deduplicated second replay, a stale replay filed under
its original interval, and the replay throttle."""

from __future__ import annotations

import json
import os
import re
import shutil
import socket
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.columnstore import ColumnStore as JStore
from veneur_tpu.core.columnstore import RowMeta as JRowMeta
from veneur_tpu.core.flusher import ForwardableState as JFwd
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import backfill as jbackfill
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.forward import wire as jwire
from veneur_tpu.forward.client import ForwardClient as JClient
from veneur_tpu.forward.protos import metric_pb2 as jmetric_pb2
from veneur_tpu.forward.server import ImportServer as JImport
from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
from veneur_tpu.samplers.metrics import MetricScope as JScope
from veneur_tpu.sinks.channel import ChannelMetricSink as JSink
from veneur_tpu.testing.forwardtest import ForwardTestServer
from veneur_tpu.util import resilience as jres
from veneur_tpu.util import spool as jspool
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.columnstore import ColumnStore as TStore
from veneur_tpu_torch.core.columnstore import RowMeta as TRowMeta
from veneur_tpu_torch.core.flusher import ForwardableState as TFwd
from veneur_tpu_torch.core.flusher import flush_columnstore_batch as tflush
from veneur_tpu_torch.core.overload import TokenBucket
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.forward import backfill as tbackfill
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward import llhistwire
from veneur_tpu_torch.forward import wire as twire
from veneur_tpu_torch.forward.client import ForwardClient as TClient
from veneur_tpu_torch.forward.protos import metric_pb2 as tmetric_pb2
from veneur_tpu_torch.forward.server import ImportServer as TImport
from veneur_tpu_torch.ops import hll_ref, llhist_ref
from veneur_tpu_torch.samplers.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.samplers.metrics import MetricScope as TScope
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TSink
from veneur_tpu_torch.util import resilience as tres
from veneur_tpu_torch.util import spool as tspool

# the kernel tolerance of tests/test_torch_tdigest.py (tests/test_pallas.py)
TOL = dict(rtol=2e-5, atol=1e-4)
PS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum", "avg"]
SIZES = dict(counter_capacity=16, gauge_capacity=16, histo_capacity=16,
             set_capacity=8, llhist_capacity=8, batch_cap=64)
SPOOLS = {"jax": jspool, "torch": tspool}
DEAD = "127.0.0.1:1"  # nothing listens: every send fails UNAVAILABLE


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- the spool's format and rules ---------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_spool_directory_reads_across_packages(tmp_path, writer, reader):
    spool = SPOOLS[writer].CarryoverSpool(str(tmp_path))
    spool.append([b"m1", b"m2" * 100], interval_unix=1700000123.5)
    spool.append([b"m3"])  # an unstamped spill
    replayed = SPOOLS[reader].CarryoverSpool(str(tmp_path))
    assert replayed.replayed_total == 2
    first, second = replayed.segments()
    assert first.interval_unix == pytest.approx(1700000123.5)
    assert second.interval_unix == 0.0
    assert first.read_metrics() == [b"m1", b"m2" * 100]
    assert (first.count, second.read_metrics()) == (2, [b"m3"])


def test_spool_segment_bytes_match_jax(tmp_path):
    """A segment is one JSON header line and a MetricList body: the same
    header (bar the creation time) and body bytes in both packages."""
    metrics = [b"\x0a\x03abc", b"x" * 300]
    files = {}
    for name, mod in SPOOLS.items():
        spool = mod.CarryoverSpool(str(tmp_path / name))
        spool.append(metrics, interval_unix=1700000000.25,
                     extra={"cell": 3})
        seg = spool.oldest()
        assert os.path.basename(seg.path).startswith("spill-00000001-")
        with open(seg.path, "rb") as f:
            header = json.loads(f.readline())
            body = f.read()
        header.pop("created_unix")
        files[name] = (header, body, seg.nbytes - len(body) > 0)
    assert files["torch"] == files["jax"]
    assert files["torch"][1] == tspool.frame_metrics(metrics)
    assert tspool.unframe_metrics(files["torch"][1]) == metrics


def _corrupt_head_restarts(mod, directory):
    """Three restarts with appends between them and a corrupt head
    segment (the JAX package's pin, tests/test_wal.py)."""
    a = mod.CarryoverSpool(directory)
    a.append([b"s1a", b"s1b"], interval_unix=100.0)
    a.append([b"s2"], interval_unix=110.0)
    b = mod.CarryoverSpool(directory)
    b.append([b"s3"], interval_unix=120.0)
    with open(b.oldest().path, "r+b") as f:
        f.readline()
        f.write(b"\xff\xff\xff\xff")
    c = mod.CarryoverSpool(directory)
    c.append([b"s4"], interval_unix=130.0)
    seqs = [int(os.path.basename(s.path).split("-")[1])
            for s in c.segments()]
    drained = []
    for seg in c.segments():
        try:
            drained.append(seg.read_metrics())
        except ValueError:
            c.discard(seg)
    d = mod.CarryoverSpool(directory)
    d.append([b"s5"])
    last = int(os.path.basename(d.segments()[-1].path).split("-")[1])
    return (b.replayed_total, c.replayed_total, seqs, drained,
            c.quarantine_depth, c.quarantined_metrics, d.quarantine_depth,
            d.quarantined_metrics, last)


def test_spool_oldest_first_across_restarts_with_corrupt_head(tmp_path):
    got = _corrupt_head_restarts(tspool, str(tmp_path / "t"))
    assert got == _corrupt_head_restarts(jspool, str(tmp_path / "j"))
    assert got[2] == [1, 2, 3, 4]
    assert got[3] == [[b"s2"], [b"s3"], [b"s4"]]
    assert got[4:8] == (1, 2, 1, 2) and got[8] == 5


def test_unreadable_segment_is_quarantined_at_scan(tmp_path):
    for name, mod in SPOOLS.items():
        directory = tmp_path / name
        directory.mkdir()
        (directory / "spill-00000001-junk.vspool").write_bytes(
            b"not a header\n\xff")
        spool = mod.CarryoverSpool(str(directory))
        assert (spool.depth, spool.quarantine_depth,
                spool.quarantined_metrics) == (0, 1, 0), name
        assert os.listdir(directory / tspool.QUARANTINE_DIR) == [
            "spill-00000001-junk.vspool"]


@pytest.mark.parametrize("bound", [dict(quarantine_max_segments=2),
                                   dict(quarantine_max_bytes=400,
                                        quarantine_max_segments=100)])
def test_quarantine_bounds_match_jax(tmp_path, bound):
    out = {}
    for name, mod in SPOOLS.items():
        spool = mod.CarryoverSpool(str(tmp_path / name), **bound)
        for i in range(3):
            spool.append([b"x%d" % i, b"z" * 100])
        for seg in spool.segments():
            spool.discard(seg)
        rows = {row[0]: row[2] for row in spool.telemetry_rows()}
        # a header's length moves with its creation time: bytes are held
        # to the bound, not compared
        assert spool.quarantined_bytes <= bound.get(
            "quarantine_max_bytes", 1 << 20)
        out[name] = (spool.quarantine_depth, spool.quarantined_metrics,
                     spool.quarantine_purged_total,
                     spool.quarantine_purged_metrics_total,
                     rows["carryover.spool.quarantine_purged"])
    assert out["torch"] == out["jax"] == (2, 4, 1, 2, 2.0)


def test_spool_bound_sheds_oldest_segment(tmp_path):
    out = {}
    for name, mod in SPOOLS.items():
        spool = mod.CarryoverSpool(str(tmp_path / name), max_segments=2)
        for i in range(4):
            spool.append([b"s%d" % i], interval_unix=100.0 + i)
        out[name] = ([s.read_metrics() for s in spool.segments()],
                     spool.shed_total, spool.shed_metrics_total)
    assert out["torch"] == out["jax"] == ([[b"s2"], [b"s3"]], 2, 2)


def test_stamp_interval_wire_matches_jax():
    pbm = tmetric_pb2.Metric(name="a", type=tmetric_pb2.Counter)
    pbm.counter.value = 3
    raw = pbm.SerializeToString()
    for stamp in (0.0, 1.0, 1700000000.9, 2.0**40):
        got = twire.stamp_interval_wire(raw, stamp)
        assert got == jwire.stamp_interval_wire(raw, stamp)
        assert tmetric_pb2.Metric.FromString(got).interval == int(stamp)
    assert twire.interval_metadata(1700000000.25) == \
        jwire.interval_metadata(1700000000.25)
    assert twire.interval_metadata(0) is None
    assert twire.combine_metadata(None, (("a", "1"),), None) == (("a", "1"),)


# -- spool directories drain through the other package's client ---------------

def _state_rows(seed: int = 3):
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(4):
        rows.append(("counter", f"c{k}", [f"k:{k}"], "counter",
                     float(rng.integers(1, 10**6) + (2**40 if k == 0 else 0))))
        rows.append(("gauge", f"g{k}", [], "gauge", float(rng.normal(0, 9))))
    for k in range(4):
        means = np.zeros(128, np.float32)
        weights = np.zeros(128, np.float32)
        n = int(rng.integers(1, 60))
        means[:n] = np.sort(rng.gamma(2.0, 20.0, n))
        weights[:n] = rng.choice([1.0, 2.0], n)
        rows.append(("histogram", f"h{k}", ["a:b"] if k % 2 else [], "timer",
                     (means, weights, float(means[:n].min()),
                      float(means[:n].max()), 0.5)))
    for k in range(3):
        h = hll_ref.HLL()
        for j in range(5 + 300 * k):
            h.insert(f"m{seed}-{k}-{j}".encode())
        rows.append(("set", f"s{k}", [], "set", h.regs.astype(np.int8)))
    for k in range(3):
        bins = np.zeros(llhist_ref.BINS, np.int64)
        np.add.at(bins, llhist_ref.bin_index(rng.lognormal(0, 3, 80)), 1 + k)
        rows.append(("llhist", f"l{k}", [f"z:{k}"], "llhist", bins))
    return rows


def _state(rows, fwd_cls, meta_cls, scope_cls):
    fwd = fwd_cls()
    for i, (family, name, tags, wire_type, payload) in enumerate(rows):
        meta = meta_cls(name=name, tags=list(tags),
                        joined_tags=",".join(tags), digest32=i,
                        scope=scope_cls.GLOBAL_ONLY, wire_type=wire_type)
        if family == "histogram":
            fwd.histograms.append((meta, *payload))
        else:
            getattr(fwd, family + "s").append((meta, payload))
    return fwd


def _series(metrics):
    return {(m.name, tuple(m.tags), m.type.name): m.value for m in metrics}


def _assert_series_agree(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        if "percentile" in name or name.endswith((".avg", ".sum")):
            np.testing.assert_allclose(got[key], value, err_msg=str(key),
                                       equal_nan=True, **TOL)
        else:
            assert got[key] == value, key


def _wal_client(cls, res, spool_mod, address, directory, **kw):
    return cls(address, deadline=10.0,
               spool=spool_mod.CarryoverSpool(str(directory)), wal=True,
               retry=res.RetryPolicy(max_attempts=1),
               breaker=res.CircuitBreaker(failure_threshold=10_000), **kw)


def _write_wal(package, directory, stamp):
    """One interval written ahead of a send that cannot land, by one
    package's forward client in WAL mode; returns the metrics appended."""
    rows = _state_rows()
    if package == "jax":
        client = _wal_client(JClient, jres, jspool, DEAD, directory)
        fwd = _state(rows, JFwd, JRowMeta, JScope)
    else:
        client = _wal_client(TClient, tres, tspool, DEAD, directory)
        fwd = _state(rows, TFwd, TRowMeta, TScope)
    assert client.forward(fwd, interval_start=stamp) == 0
    assert client.spool.depth == 1 and client.wal_appended_metrics == len(rows)
    client.close()
    return len(rows)


def test_jax_spool_drains_through_port_client_into_port_global(tmp_path):
    n = _write_wal("jax", tmp_path, time.time())
    store = TStore(device="cpu", **SIZES)
    imp = TImport(SimpleNamespace(store=store), "127.0.0.1:0")
    imp.start()
    try:
        client = _wal_client(TClient, tres, tspool, imp.address, tmp_path)
        assert client.spool.replayed_total == 1
        assert client.forward(TFwd()) == n  # the pending WAL alone sends
        assert client.spool.depth == 0 and client.wal_acked_metrics == n
        assert client.last_flow == {"received": n, "merged": n,
                                    "duplicate": False}
        client.close()
    finally:
        imp.stop()
    # the same state imported directly into the JAX package's store
    want_store = JStore(**SIZES)
    want_imp = JImport(SimpleNamespace(store=want_store), "127.0.0.1:0")
    want_imp._send_metrics_v2(iter(
        jmetric_pb2.Metric.FromString(m) for m in jconvert.forwardable_to_wire(
            _state(_state_rows(), JFwd, JRowMeta, JScope))), _V2Ctx())
    got, _ = tflush(store, False, PS, TAggs.from_names(AGGS))
    want, _ = jflush(want_store, False, PS, JAggs.from_names(AGGS))
    _assert_series_agree(_series(got.materialize()),
                         _series(want.materialize()))


def test_port_spool_drains_into_jax_import_server(tmp_path):
    n = _write_wal("torch", tmp_path, time.time())
    store = JStore(**SIZES)
    imp = JImport(SimpleNamespace(store=store), "127.0.0.1:0")
    imp.start()
    try:
        client = _wal_client(JClient, jres, jspool, imp.address, tmp_path)
        assert client.spool.replayed_total == 1
        assert client.forward(JFwd()) == n
        assert client.spool.depth == 0
        client.close()
    finally:
        imp._grpc.stop(0).wait()
    want_store = TStore(device="cpu", **SIZES)
    TImport(SimpleNamespace(store=want_store), "127.0.0.1:0")._send_metrics_v2(
        iter(tmetric_pb2.Metric.FromString(m) for m in
             tconvert.forwardable_to_wire(
                 _state(_state_rows(), TFwd, TRowMeta, TScope))), _V2Ctx())
    got, _ = jflush(store, False, PS, JAggs.from_names(AGGS))
    want, _ = tflush(want_store, False, PS, TAggs.from_names(AGGS))
    _assert_series_agree(_series(got.materialize()),
                         _series(want.materialize()))


class _V2Ctx:
    def invocation_metadata(self):
        return ()

    def abort(self, code, details):
        raise grpc.RpcError(f"{code}: {details}")


# -- the backfill plane -------------------------------------------------------

T1, T2 = 1700000000, 1700000060


def _pb(pkg_pb2, name, kind, value, tags=(), interval=0):
    pbm = pkg_pb2.Metric(name=name, tags=list(tags))
    if kind == "counter":
        pbm.type = pkg_pb2.Counter
        pbm.counter.value = int(value)
    elif kind == "gauge":
        pbm.type = pkg_pb2.Gauge
        pbm.gauge.value = float(value)
    elif kind == "llhist":
        pbm.type = pkg_pb2.LLHist
        pbm.llhist.bins = llhistwire.marshal(value)
    elif kind == "set":
        pbm.type = pkg_pb2.Set
        pbm.set.hyper_log_log = np.asarray(value, np.int8).tobytes()
    elif kind == "histogram":
        pbm.type = pkg_pb2.Histogram
        d = pbm.histogram.t_digest
        for mean, weight in zip(*value):
            c = d.main_centroids.add()
            c.mean, c.weight = float(mean), float(weight)
        d.min, d.max = float(min(value[0])), float(max(value[0]))
        d.compression = 100.0
    if interval:
        pbm.interval = int(interval)
    return pbm


def _bins(values, weight=1):
    bins = np.zeros(llhist_ref.BINS, np.int64)
    np.add.at(bins, llhist_ref.bin_index(np.asarray(values, float)), weight)
    return bins


def _regs(members):
    h = hll_ref.HLL()
    for m in members:
        h.insert(m.encode())
    return h.regs


_BACKFILL_SCENARIOS = {
    # (metric name, kind, value, rpc stamp, field-11 stamp); drains
    "counters_sum_gauges_last_write_wins": (
        [("bf.c", "counter", 3, T1, 0), ("bf.c", "counter", 4, T1, 0),
         ("bf.c", "counter", 9, T2, 0), ("bf.g", "gauge", 1.5, T1, 0),
         ("bf.g", "gauge", 2.5, T1, 0)], dict()),
    "field11_beats_rpc_stamp": (
        [("bf.f11", "counter", 2, T1, T1 + 300)], dict()),
    "llhist_register_add_is_exact": (
        [("bf.ll", "llhist", _bins([12.0], 5), T1, 0),
         ("bf.ll", "llhist", _bins([12.0, 12.0, 120.0]), T1, 0),
         ("bf.ll2", "llhist", _bins(np.geomspace(1e-3, 1e5, 300), 3), T2,
          0)], dict()),
    "sets_and_digests": (
        [("bf.s", "set", _regs([f"u{j}" for j in range(50)]), T1, 0),
         ("bf.s", "set", _regs([f"u{j}" for j in range(25, 90)]), T1, 0),
         ("bf.h", "histogram", ([1.0, 2.0, 5.0], [1.0, 2.0, 1.0]), T1, 0),
         ("bf.h", "histogram", ([0.5, 9.0], [3.0, 1.0]), T1, 0)], dict()),
    "bound_closes_oldest_first": (
        [(f"bf.b{i}", "counter", 1, T1 + 60 * i, 0) for i in range(3)],
        dict(max_open=2)),
    "older_than_every_bucket_still_emits": (
        [("bf.new1", "counter", 1, T1 + 1000, 0),
         ("bf.new2", "counter", 1, T1 + 2000, 0),
         ("bf.ancient", "counter", 1, T1 + 500, 0)], dict(max_open=2)),
    "unstamped_and_junk_rejected": (
        [("bf.u", "counter", 1, 0, 0), ("bf.nv", "none", 0, T1, 0)],
        dict()),
}


def _run_backfill(package, scenario):
    mod, pb2 = ((jbackfill, jmetric_pb2) if package == "jax"
                else (tbackfill, tmetric_pb2))
    metrics, kw = _BACKFILL_SCENARIOS[scenario]
    plane = mod.BackfillPlane(percentiles=(0.5, 0.9), **kw)
    accepted = [plane.merge_proto(
        _pb(pb2, name, kind, value, interval=f11), rpc_stamp)
        for name, kind, value, rpc_stamp, f11 in metrics]
    opened = plane.open_intervals
    out = plane.drain() + plane.drain() + plane.drain(force=True)
    emitted = sorted((m.name, tuple(m.tags), m.type.name, m.timestamp,
                      m.value, m.backfilled) for m in out)
    return (accepted, opened, emitted, plane.merged_total,
            plane.rejected_total, plane.closed_total,
            plane.bound_closed_total, plane.open_intervals,
            [row[:3] for row in plane.telemetry_rows()])


@pytest.mark.parametrize("scenario", sorted(_BACKFILL_SCENARIOS))
def test_backfill_plane_matches_jax(scenario):
    got = _run_backfill("torch", scenario)
    assert got == _run_backfill("jax", scenario)
    accepted, opened, emitted = got[:3]
    by = {(name, ts): value for name, _t, _k, ts, value, bf in emitted}
    assert all(row[-1] is True for row in emitted) and got[7] == 0
    if scenario == "counters_sum_gauges_last_write_wins":
        assert by[("bf.c", T1)] == 7.0 and by[("bf.c", T2)] == 9.0
        assert by[("bf.g", T1)] == 2.5 and opened == 2
    elif scenario == "field11_beats_rpc_stamp":
        assert list(by) == [("bf.f11", T1 + 300)]
    elif scenario == "llhist_register_add_is_exact":
        assert by[("bf.ll.count", T1)] == 8.0
        inf = [r for r in emitted if r[0] == "bf.ll.bucket"
               and "le:+Inf" in r[1]]
        assert inf[0][4] == 8.0
    elif scenario == "sets_and_digests":
        assert by[("bf.s", T1)] == hll_ref.estimate_from_registers(
            _regs([f"u{j}" for j in range(90)]))
        assert (by[("bf.h.count", T1)], by[("bf.h.min", T1)],
                by[("bf.h.max", T1)]) == (8.0, 0.5, 9.0)
    elif scenario == "bound_closes_oldest_first":
        assert got[6] == 1 and opened == 2
        assert [r[3] for r in emitted] == [T1, T1 + 60, T1 + 120]
    elif scenario == "older_than_every_bucket_still_emits":
        assert sorted(r[0] for r in emitted) == ["bf.ancient", "bf.new1",
                                                 "bf.new2"]
        assert got[3] == got[5] == 3
    else:
        assert accepted == [False, False] and got[4] == 2 and not emitted


# -- end to end over gRPC on 127.0.0.1 ----------------------------------------

def _server(package, **extra):
    if package == "jax":
        cfg = JConfig()
        cfg.interval = 3600.0
        cfg.hostname = "test"
        cfg.percentiles = list(PS)
        cfg.aggregates = list(AGGS)
        for k, v in SIZES.items():
            setattr(cfg.tpu, k, v)
        for k, v in extra.items():
            setattr(cfg, k, v)
        sink = JSink()
        server = JServer(cfg.apply_defaults(), extra_metric_sinks=[sink])
    else:
        cfg = config_from_dict({"interval": "1h", "hostname": "test",
                                "percentiles": list(PS),
                                "aggregates": list(AGGS), "tpu": SIZES,
                                **extra})
        sink = TSink()
        server = TServer(cfg, device="cpu", extra_metric_sinks=[sink])
    server.start()
    return server, sink


def _stop_import(server):
    server.import_server._grpc.stop(0).wait()


def _restart_import(server, package, address):
    """A fresh import server bound to the address the stopped one held
    (a gRPC server does not start twice)."""
    cls = JImport if package == "jax" else TImport
    server.import_server = cls(server, address)
    server.import_server.start()


def _interval_lines(seed: int):
    """One interval of a local: global-only counters and gauges, timers,
    sets whose members move with the seed, llhists. 18 forwarded rows."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(5):
        lines.append(f"fc{k}:{rng.integers(1, 99)}|c|#veneurglobalonly")
        lines.append(f"mc{k}:{rng.integers(1, 99)}|c")
    for k in range(3):
        lines.append(f"fg{k}:{rng.normal(0, 9):.4f}|g|#veneurglobalonly")
    for k in range(4):
        for v in rng.gamma(2.0, 20.0, 30 + 10 * k):
            lines.append(f"ht{k}:{v:.3f}|ms|#z:{k % 2}")
    for k in range(3):
        for j in range(seed * 40, seed * 40 + 60):
            lines.append(f"s{k}:u{k}-{j}|s")
    for k in range(3):
        for v in rng.lognormal(0, 3, 40):
            lines.append(f"l{k}:{v:.5g}|l")
    return [line.encode() for line in lines]


FORWARDED = 5 + 3 + 4 + 3 + 3


def _feed(server, lines):
    for line in lines:
        server.handle_metric_packet(line)


def _run_outage(package, seeds=(1, 2, 3)):
    """Interval 1 with the global up, interval 2 with its import server
    down, interval 3 with it back at the same address: the global's
    series after intervals 1 and 3, and the local's stats."""
    address = f"127.0.0.1:{_free_port()}"
    gserver, gsink = _server(package, grpc_address=address)
    local, lsink = _server(package, forward_address=address)
    out, stats = [], []
    try:
        for i, seed in enumerate(seeds):
            if i == 1:
                _stop_import(gserver)
            if i == 2:
                _restart_import(gserver, package, address)
                grpc.channel_ready_future(
                    local.forward_client._channel).result(timeout=20)
            _feed(local, _interval_lines(seed))
            local.flush()
            lsink.wait_flush(timeout=20)
            if package == "torch":
                stats.append(local.stats_snapshot())
            if i == 1:
                continue
            assert _wait_for(lambda: gserver.import_server.imported_total
                             == FORWARDED)
            gserver.flush()
            out.append(_series(gsink.wait_flush(timeout=20)))
    finally:
        local.shutdown()
        gserver.shutdown()
    return out, stats


def test_outage_interval_is_delivered_merged_like_jax():
    jout, _ = _run_outage("jax")
    tout, stats = _run_outage("torch")
    for got, want in zip(tout, jout):
        _assert_series_agree(got, want)
    down, back = stats[1], stats[2]
    assert down["forward_errors"] == 1 and down["forward_retries"] == 2
    assert (down["carryover_depth"], down["carryover_pending"],
            down["carryover_shed"]) == (1, FORWARDED, 0)
    assert (back["carryover_depth"], back["carryover_merged"],
            back["carryover_shed"], back["forward_errors"]) == (
                0, FORWARDED, 0, 1)
    assert back["forwarded_total"] == 2 * FORWARDED
    # interval 3's global flush holds the union of intervals 2 and 3
    sums = {}
    for seed in (2, 3):
        for line in _interval_lines(seed):
            name, rest = line.decode().split(":", 1)
            if name.startswith("fc"):
                sums[name] = sums.get(name, 0.0) + float(rest.split("|")[0])
    for name, value in sums.items():
        assert tout[1][(name, (), "COUNTER")] == value
    union = hll_ref.estimate_from_registers(
        _regs([f"u0-{j}" for j in range(80, 180)]))
    assert tout[1][("s0", (), "GAUGE")] == union
    assert tout[1][("l0.count", (), "COUNTER")] == 80.0


def _llhist_and_counters(series):
    return {k: v for k, v in series.items()
            if k[0].startswith(("fc", "l")) and "percentile" not in k[0]
            and not k[0].endswith(".sum")}


def test_wal_crash_drill_equals_unfaulted_control(tmp_path):
    """Three rounds of append-then-die (the send never lands, the
    process is shut down) and a restart on the spool that replays the
    interval; the faulted global's series equal an unfaulted control's.
    A segment put back after its replay (an ack lost to the crash)
    replays again and is deduplicated."""
    wal = str(tmp_path / "wal")
    faulted, fsink = _server("torch", grpc_address="127.0.0.1:0")
    control, csink = _server("torch", grpc_address="127.0.0.1:0")
    c_local, _ = _server("torch",
                         forward_address=control.import_server.address)
    f_addr = faulted.import_server.address
    try:
        for round_no in range(3):
            lines = _interval_lines(round_no + 1)
            _feed(c_local, lines)
            c_local.flush()
            dead, _ = _server("torch", forward_address=DEAD,
                              forward_wal=True, carryover_spool_dir=wal)
            _feed(dead, lines)
            dead.flush()
            assert dead.stats_snapshot()["spool_depth"] == 1
            assert dead.stats_snapshot()["wal_appended"] == FORWARDED
            dead.shutdown()  # the crash
            saved = None
            if round_no == 2:
                seg = tspool.CarryoverSpool(wal).oldest()
                saved = (seg.path, seg.path + ".saved")
                shutil.copyfile(*saved)
            restarted, _ = _server("torch", forward_address=f_addr,
                                   forward_wal=True, carryover_spool_dir=wal)
            assert restarted.forward_client.spool.replayed_total == 1
            restarted.flush()  # no traffic: the pending WAL alone sends
            stats = restarted.stats_snapshot()
            assert stats["spool_depth"] == 0
            assert stats["wal_acked"] == FORWARDED
            restarted.shutdown()
            if saved is not None:
                os.replace(saved[1], saved[0])  # the ack never reached disk
        assert _wait_for(lambda: faulted.import_server.imported_total
                         == control.import_server.imported_total
                         == 3 * FORWARDED)
        before = faulted.import_server.duplicates_dropped_total
        again, _ = _server("torch", forward_address=f_addr,
                           forward_wal=True, carryover_spool_dir=wal)
        again.flush()
        assert again.forward_client.last_flow["duplicate"] is True
        assert again.stats_snapshot()["spool_depth"] == 0
        again.shutdown()
        assert faulted.import_server.duplicates_dropped_total == before + 1
        assert faulted.import_server.imported_total == 3 * FORWARDED
        faulted.flush()
        control.flush()
        got = _series(fsink.wait_flush(timeout=20))
        want = _series(csink.wait_flush(timeout=20))
    finally:
        c_local.shutdown()
        faulted.shutdown()
        control.shutdown()
    _assert_series_agree(got, want)
    exact = _llhist_and_counters(got)
    assert exact == _llhist_and_counters(want)
    assert any(k[0] == "l0.bucket" for k in exact)
    assert got[("fc0", (), "COUNTER")] > 0


def _stale_replay(package, directory, stale):
    """A global with a backfill plane, and a fresh local on a WAL
    directory whose one segment is older than the staleness bound: the
    replay, then two global flushes (the generation roll, then the idle
    bucket's close). Returns both flushes' metrics and the open buckets
    after the replay."""
    extra = dict(wal_stale_after_intervals=stale)
    gserver, gsink = _server(package, grpc_address="127.0.0.1:0", **extra)
    address = gserver.import_server.address
    local, _ = _server(package, forward_address=address, forward_wal=True,
                       carryover_spool_dir=directory, **extra)
    try:
        local.flush()
        assert _wait_for(lambda: gserver.import_server.imported_total
                         == FORWARDED)
        opened = gserver.backfill.open_intervals
        flushed = []
        for _ in range(2):
            gserver.flush()  # the JAX server skips sinks on an empty batch
            flushed.extend(gsink.drain())
    finally:
        local.shutdown()
        gserver.shutdown()
    return flushed, opened


def test_stale_replay_is_backfilled_under_its_original_interval(tmp_path):
    stale = 0.5 / 3600.0  # half a second of the 1 h interval
    dead, _ = _server("torch", forward_address=DEAD, forward_wal=True,
                      carryover_spool_dir=str(tmp_path / "t"),
                      wal_stale_after_intervals=stale)
    _feed(dead, _interval_lines(1))
    dead.flush()
    stamp = dead.forward_client.spool.oldest().interval_unix
    dead.shutdown()
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    time.sleep(max(0.0, stamp + 0.6 - time.time()))
    results = {p: _stale_replay(p, str(tmp_path / p[0]), stale)
               for p in ("torch", "jax")}
    backfilled = {}
    for package, (flushed, opened) in results.items():
        assert opened == 1, package
        filed = [m for m in flushed if m.backfilled]
        assert filed and all(m.timestamp == int(stamp) for m in filed)
        live = [m.name for m in flushed if not m.backfilled]
        assert not [n for n in live if re.match(r"(fc|fg|ht|s|l)\d", n)]
        backfilled[package] = _series(filed)
    _assert_series_agree(backfilled["torch"], backfilled["jax"])
    want = {}
    for line in _interval_lines(1):
        name, rest = line.decode().split(":", 1)
        if name.startswith("fc"):
            want[name] = float(rest.split("|")[0])
    for name, value in want.items():
        assert backfilled["torch"][(name, (), "COUNTER")] == value
    assert backfilled["torch"][("l1.count", (), "COUNTER")] == 40.0


def test_stale_replay_is_throttled_behind_fresh_segments(tmp_path):
    """Fresh segments drain first at full speed; stale ones drain behind
    them under the replay limiter, the first of each drain exempt."""
    received = []
    ft = ForwardTestServer(received.extend)
    ft.start()
    spool = tspool.CarryoverSpool(str(tmp_path))
    now = time.time()
    for i in range(6):
        stamp = now - 3600 + i * 10
        pbm = tmetric_pb2.Metric(name=f"stale.{i}", type=tmetric_pb2.Counter)
        pbm.counter.value = 1
        spool.append([twire.stamp_interval_wire(pbm.SerializeToString(),
                                                stamp)], interval_unix=stamp)
    clock = [0.0]
    limiter = TokenBucket(1.0, 1.0, clock=lambda: clock[0])
    client = TClient(ft.address, deadline=10.0, spool=spool, wal=True,
                     retry=tres.RetryPolicy(max_attempts=1),
                     breaker=tres.CircuitBreaker(failure_threshold=10_000),
                     replay_limiter=limiter, replay_stale_after=60.0)
    fwd = _state([("counter", "live.cnt", [], "counter", 2.0)], TFwd,
                 TRowMeta, TScope)
    try:
        assert client.forward(fwd, interval_start=now) == 2
        # the live interval first, then the stale segment the bucket's
        # burst admits; the rest wait
        assert [p.name for p in received] == ["live.cnt", "stale.0"]
        assert spool.depth == 5 and client.wal_replay_throttled == 1
        assert ft.call_metadata[0][twire.INTERVAL_KEY] == f"{now:.3f}"
        assert ft.call_metadata[1][twire.IDEMPOTENCY_KEY].startswith(
            "spool:spill-")
        delivered = []
        while spool.depth:
            clock[0] += 1.0  # one token a second
            # the first segment of each drain is exempt, one token more
            delivered.append(client.forward(TFwd()))
        assert delivered == [2, 2, 1]
        assert [p.name for p in received[2:]] == [f"stale.{i}"
                                                  for i in range(1, 6)]
        assert all(p.interval for p in received)
    finally:
        client.close()
        ft.stop()
