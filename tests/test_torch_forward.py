"""The port's forward tier against the JAX package's, on the CPU: the wire
codecs and the forward encoder (byte for byte), the import merges (exact
for counters, gauges, HLL and llhist registers; t-digests within the
kernel tolerance), the forwarding flush, the import server on V1 and V2
bodies, local -> global pairs over real gRPC, and interop both ways."""

from __future__ import annotations

import sys
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest
import torch

from veneur_tpu.config import Config as JConfig
from veneur_tpu.core.columnstore import ColumnStore as JStore
from veneur_tpu.core.columnstore import RowMeta as JRowMeta
from veneur_tpu.core.flusher import ForwardableState as JFwd
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.forward import hllwire as jhllwire
from veneur_tpu.forward import llhistwire as jllhistwire
from veneur_tpu.forward.client import ForwardClient as JClient
from veneur_tpu.forward.protos import metric_pb2 as jmetric_pb2
from veneur_tpu.forward.server import ImportServer as JImport
from veneur_tpu.forward.wire import _frame_v1
from veneur_tpu import native as jnative
from veneur_tpu.ops import batch_hll as jbhll
from veneur_tpu.ops import batch_llhist as jbll
from veneur_tpu.ops import batch_tdigest as jbtd
from veneur_tpu.ops import scalars as jscalars
from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
from veneur_tpu.samplers.metrics import MetricScope as JScope
from veneur_tpu.sinks.channel import ChannelMetricSink as JSink
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.columnstore import ColumnStore as TStore
from veneur_tpu_torch.core.columnstore import RowMeta as TRowMeta
from veneur_tpu_torch.core.flusher import ForwardableState as TFwd
from veneur_tpu_torch.core.flusher import flush_columnstore_batch as tflush
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward import hllwire as thllwire
from veneur_tpu_torch.forward import llhistwire as tllhistwire
from veneur_tpu_torch.forward.client import ForwardClient as TClient
from veneur_tpu_torch.forward.protos import metric_pb2 as tmetric_pb2
from veneur_tpu_torch.forward.server import ImportServer as TImport
from veneur_tpu_torch.ops import batch_hll as tbhll
from veneur_tpu_torch.ops import batch_llhist as tbll
from veneur_tpu_torch.ops import batch_tdigest as tbtd
from veneur_tpu_torch.ops import hll_ref, llhist_ref
from veneur_tpu_torch.ops import scalars as tscalars
from veneur_tpu_torch.samplers.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.samplers.metrics import MetricScope as TScope
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TSink

# the kernel tolerance of tests/test_torch_tdigest.py (tests/test_pallas.py)
TOL = dict(rtol=2e-5, atol=1e-4)
PS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum", "avg"]
SIZES = dict(counter_capacity=8, gauge_capacity=8, histo_capacity=8,
             set_capacity=8, llhist_capacity=4, batch_cap=64)


class _Ctx:
    """A servicer context with the given invocation metadata."""

    def __init__(self, metadata=()):
        self._md = tuple(metadata)

    def invocation_metadata(self):
        return self._md

    def abort(self, code, details):
        raise grpc.RpcError(f"{code}: {details}")


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- one seeded forwardable state, built with each package's RowMeta ------

def _fwd_rows(seed: int = 5):
    """Row specs (family, name, tags, scope name, wire type, payload) for
    a ForwardableState: counters (one past 2^53's float32 reach), gauges,
    mixed and global-only timers and histograms, sets small and large,
    llhists sparse and dense."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(4):
        rows.append(("counter", f"fc{k}", [f"k:{k}"], "GLOBAL_ONLY",
                     "counter", float(rng.integers(1, 10**6)
                                      + (2**40 if k == 0 else 0))))
        rows.append(("gauge", f"fg{k}", [], "GLOBAL_ONLY", "gauge",
                     float(rng.normal(0, 100)) if k else -0.0))
    for k in range(6):
        samples = rng.gamma(2.0, 20.0, int(rng.integers(1, 400)))
        means, weights = jbtd.pack_centroids(
            samples, rng.choice([1.0, 2.0], samples.size))
        recip = float(np.sum(weights / np.where(means, means, 1.0)))
        rows.append(("histogram", f"h{k}", ["a:b"] if k % 2 else [],
                     "MIXED" if k < 3 else "GLOBAL_ONLY",
                     "timer" if k % 2 else "histogram",
                     (means, weights, float(samples.min()),
                      float(samples.max()), recip)))
    for k in range(4):
        h = hll_ref.HLL()
        for j in range(3 if k == 0 else 400 * k):
            h.insert(f"m{k}-{j}".encode())
        rows.append(("set", f"s{k}", [], "MIXED" if k % 2 else "GLOBAL_ONLY",
                     "set", h.regs.astype(np.int8)))
    for k in range(3):
        bins = np.zeros(llhist_ref.BINS, np.int64)
        vals = rng.lognormal(0, 3, 20 if k < 2 else 5000)
        np.add.at(bins, llhist_ref.bin_index(vals), 1 + k)
        rows.append(("llhist", f"l{k}", [f"z:{k}"],
                     "MIXED" if k else "GLOBAL_ONLY", "llhist", bins))
    return rows


def _forwardable(rows, fwd_cls, meta_cls, scope_cls):
    fwd = fwd_cls()
    for i, (family, name, tags, scope, wire_type, payload) in \
            enumerate(rows):
        meta = meta_cls(name=name, tags=list(tags),
                        joined_tags=",".join(tags), digest32=i,
                        scope=scope_cls[scope], wire_type=wire_type)
        if family == "histogram":
            fwd.histograms.append((meta, *payload))
        else:
            getattr(fwd, family + "s").append((meta, payload))
    return fwd


def _jfwd(rows=None):
    return _forwardable(rows or _fwd_rows(), JFwd, JRowMeta, JScope)


def _tfwd(rows=None):
    return _forwardable(rows or _fwd_rows(), TFwd, TRowMeta, TScope)


# -- codecs and the forward encoder -------------------------------------------

@pytest.mark.parametrize("members", [0, 5, 3000, 200_000])
def test_hllwire_matches_jax(members):
    h = hll_ref.HLL()
    for j in range(members):
        h.insert(f"u{j}".encode())
    regs = h.regs.astype(np.uint8)
    for kind in ("marshal", "marshal_dense", "marshal_sparse"):
        want = getattr(jhllwire, kind)(regs)
        assert getattr(thllwire, kind)(regs) == want, kind
        got_regs, got_p = thllwire.unmarshal(want)
        want_regs, want_p = jhllwire.unmarshal(want)
        assert got_p == want_p
        np.testing.assert_array_equal(got_regs, want_regs)


@pytest.mark.parametrize("samples", [0, 30, 20_000])
def test_llhistwire_matches_jax(samples):
    rng = np.random.default_rng(samples)
    bins = np.zeros(llhist_ref.BINS, np.int64)
    np.add.at(bins, llhist_ref.bin_index(rng.lognormal(0, 5, samples)),
              rng.integers(1, 2**33, samples))
    want = jllhistwire.marshal(bins)
    assert tllhistwire.marshal(bins) == want
    np.testing.assert_array_equal(tllhistwire.unmarshal(want),
                                  jllhistwire.unmarshal(want))


def test_forwardable_to_wire_is_byte_identical():
    jwire = jconvert.forwardable_to_wire(_jfwd())
    before = tconvert.proto_fallback_rows
    twire = tconvert.forwardable_to_wire(_tfwd())
    assert tconvert.proto_fallback_rows == before  # the bulk encoders
    assert twire == jwire
    # and the proto-object path gives the same bytes (it emits llhists
    # before sets)
    assert sorted(p.SerializeToString() for p in
                  tconvert.forwardable_to_protos(_tfwd())) == sorted(jwire)


def test_native_import_parse_matches_jax():
    body = b"".join(_frame_v1(m)
                    for m in jconvert.forwardable_to_wire(_jfwd()))
    want = jnative.parse_metric_list(body, jbtd.C, jbtd.COMPRESSION)
    got = tnative.parse_metric_list(body, tbtd.C, tbtd.COMPRESSION)
    for slot in type(want).__slots__:
        a, b = getattr(got, slot), getattr(want, slot)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=slot)
        else:
            assert a == b, slot
    for key in want.h_keys + want.s_keys:
        assert tnative.decode_import_key(key) == \
            jnative.decode_import_key(key)
    assert tnative.parse_metric_list(b"\x0a\xff", tbtd.C,
                                     tbtd.COMPRESSION) is None


def test_pack_centroids_many_matches_jax():
    rng = np.random.default_rng(2)
    means = [rng.gamma(2, 10, int(n)) for n in rng.integers(0, 300, 20)]
    weights = [rng.choice([1.0, 0.5, 3.0], m.size) for m in means]
    for got, want in zip(tbtd.pack_centroids_many(means, weights),
                         jbtd.pack_centroids_many(means, weights)):
        np.testing.assert_array_equal(got, want)


# -- the merges ------------------------------------------------------------

def _merge_rows(rng, num_keys, n):
    """Target rows with duplicates and one row past the table (dropped)."""
    rows = rng.integers(0, num_keys, n).astype(np.int32)
    rows[:3] = rows[3]
    rows[-1] = num_keys
    return rows


def test_merge_gauges_is_exact():
    rng = np.random.default_rng(0)
    rows = _merge_rows(rng, 10, 30)
    vals = rng.normal(0, 50, 30).astype(np.float32)
    jstate = jscalars.merge_gauges(jscalars.init_gauges(10), rows, vals)
    tstate = tscalars.merge_gauges(tscalars.init_gauges(10, "cpu"),
                                   torch.from_numpy(rows),
                                   torch.from_numpy(vals))
    for k in ("value", "set"):
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]))


def test_hll_merge_rows_is_exact():
    rng = np.random.default_rng(1)
    base = rng.integers(0, 20, (10, hll_ref.M)).astype(np.int8)
    rows = _merge_rows(rng, 10, 12)
    incoming = rng.integers(0, 30, (12, hll_ref.M)).astype(np.int8)
    want = np.asarray(jbhll.merge_rows(base.copy(), rows, incoming))
    got = tbhll.merge_rows(torch.from_numpy(base.copy()),
                           torch.from_numpy(rows),
                           torch.from_numpy(incoming))
    np.testing.assert_array_equal(got.numpy(), want)


def test_llhist_merge_rows_is_exact():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 50, (6, tbll.BINS_PAD)).astype(np.int32)
    rows = _merge_rows(rng, 6, 10)
    # counts past int32 clip, as the JAX package's do
    raw = rng.integers(0, 2**33, (10, llhist_ref.BINS))
    incoming = tbll.pad_rows_to_device(raw)
    np.testing.assert_array_equal(incoming, jbll.pad_rows_to_device(raw))
    incoming //= 8  # duplicate rows must not overflow int32 either
    want = np.asarray(jbll.merge_rows(base.copy(), rows, incoming))
    got = tbll.merge_rows(torch.from_numpy(base.copy()),
                          torch.from_numpy(rows), torch.from_numpy(incoming))
    np.testing.assert_array_equal(got.numpy(), want)


def _digest_states(num_keys=12):
    """The same t-digest table in both packages: staged and compacted
    rows, untouched rows, fractional weights."""
    rng = np.random.default_rng(4)
    jstate = jbtd.init_state(num_keys)
    counts = np.zeros(num_keys, np.int32)
    for b in range(3):
        rows = rng.integers(0, num_keys - 3, 300).astype(np.int32)
        vals = rng.gamma(2.0, 10.0, 300).astype(np.float32)
        wts = (1.0 / rng.choice([1.0, 0.5, 0.25], 300)).astype(np.float32)
        slots, overflow = jbtd.host_slots(rows, vals, wts, counts)
        if overflow:
            jstate = jbtd.compact(jstate)
            counts[:] = 0
            slots, _ = jbtd.host_slots(rows, vals, wts, counts)
        jstate = jbtd.apply_batch(jstate, rows, vals, wts, slots)
        if b == 1:
            jstate = jbtd.compact(jstate)
            counts[:] = 0
    arrays = {k: np.array(v) for k, v in jstate.items()}
    return arrays, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def test_merge_centroid_rows_then_flush_matches_jax():
    num_keys = 12
    arrays, tstate = _digest_states(num_keys)
    rng = np.random.default_rng(8)
    rows = _merge_rows(rng, num_keys, 10)
    grids = [jbtd.pack_centroids(rng.gamma(3, 7, 80), np.ones(80))
             for _ in range(10)]
    means = np.stack([g[0] for g in grids])
    weights = np.stack([g[1] for g in grids])
    mins = means.min(axis=1).astype(np.float32)
    maxs = (means.max(axis=1) + 1).astype(np.float32)
    recips = rng.uniform(1, 5, 10).astype(np.float32)
    jstate = jbtd.merge_centroid_rows(
        {k: np.array(v) for k, v in arrays.items()}, rows, means, weights,
        mins, maxs, recips)
    tbtd.merge_centroid_rows(tstate, *(torch.from_numpy(a) for a in (
        rows, means, weights, mins, maxs, recips)))
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   err_msg=k, **TOL)
    # rows with neither incoming nor staged weight kept their grids
    kept = ~np.isin(np.arange(num_keys), rows) & (
        arrays["sweights"].sum(axis=1) == 0)
    assert kept.any()
    for k in ("wv", "weights"):
        np.testing.assert_array_equal(tstate[k].numpy()[kept],
                                      arrays[k][kept])
    want = np.asarray(jbtd.flush_quantiles_packed(jstate, tuple(PS)))
    got = tbtd.flush_quantiles_packed(tstate, PS).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_flush_export_packed_matches_jax():
    arrays, tstate = _digest_states(128)  # the Pallas kernel's row tile
    want_flush, want_export = jbtd.flush_export_packed_pallas(
        arrays, tuple(PS), interpret=True)
    got_flush, got_export = tbtd.flush_export_packed(tstate, PS)
    np.testing.assert_allclose(got_flush.numpy(), np.asarray(want_flush),
                               equal_nan=True, **TOL)
    np.testing.assert_allclose(got_export.numpy(), np.asarray(want_export),
                               **TOL)
    jparts = jbtd.unpack_export(np.asarray(want_export))
    tparts = tbtd.unpack_export(got_export.numpy())
    for got, want in zip(tparts, jparts):
        assert got.dtype == np.float32 and got.shape == want.shape


# -- the import server and the global flush --------------------------------

def _series(batch):
    return {(m.name, tuple(m.tags), m.type.name): m.value
            for m in (batch if isinstance(batch, list)
                      else batch.materialize())}


def _assert_series_agree(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        name = key[0]
        approx = ("percentile" in name or name.endswith((".avg", ".median"))
                  or (name.startswith("h") and name.endswith(".sum")))
        if approx:
            np.testing.assert_allclose(got[key], value, err_msg=str(key),
                                       equal_nan=True, **TOL)
        else:
            assert got[key] == value, key


def _global_flush(store, flush, aggs_cls):
    batch, _ = flush(store, False, PS, aggs_cls.from_names(AGGS))
    return _series(batch)


def _import_through(kind: str, package: str):
    """The seeded forwardable state, encoded by the JAX package, through
    one package's ImportServer (V1 body or V2 stream) into a fresh store,
    then that store's global flush."""
    wire = jconvert.forwardable_to_wire(_jfwd())
    if package == "jax":
        store = JStore(**SIZES)
        imp = JImport(SimpleNamespace(store=store), "127.0.0.1:0")
        parse = jmetric_pb2.Metric.FromString
    else:
        store = TStore(device="cpu", **SIZES)
        imp = TImport(SimpleNamespace(store=store), "127.0.0.1:0")
        parse = tmetric_pb2.Metric.FromString
    if kind == "v1":
        resp = imp._send_metrics_v1(b"".join(_frame_v1(m) for m in wire),
                                    _Ctx())
    else:
        resp = imp._send_metrics_v2(iter([parse(m) for m in wire]), _Ctx())
    assert imp.imported_total == len(wire)
    flush = jflush if package == "jax" else tflush
    aggs = JAggs if package == "jax" else TAggs
    return resp, _global_flush(store, flush, aggs)


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_import_server_merges_like_jax(kind):
    want_resp, want = _import_through(kind, "jax")
    got_resp, got = _import_through(kind, "torch")
    assert got_resp == want_resp
    _assert_series_agree(got, want)
    # every family arrived: exact counters (2^40 + n in float64), sets,
    # llhist buckets
    assert got[("fc0", ("k:0",), "COUNTER")] >= 2**40
    assert any(k[0] == "l1.bucket" for k in got)
    assert ("s2", (), "GAUGE") in got


def test_counter_import_accumulates_in_float64():
    store = TStore(device="cpu", **SIZES)
    imp = TImport(SimpleNamespace(store=store), "127.0.0.1:0")
    fwd = TFwd()
    meta = TRowMeta(name="big", tags=[], joined_tags="", digest32=0,
                    scope=TScope.GLOBAL_ONLY, wire_type="counter")
    fwd.counters.append((meta, float(2**53 - 1)))
    body = b"".join(_frame_v1(m) for m in tconvert.forwardable_to_wire(fwd))
    for token in ("a", "b", "a"):  # the repeated token merges once
        imp._send_metrics_v1(body, _Ctx([("x-veneur-idempotency-token",
                                          token)]))
    assert imp.duplicates_dropped_total == 1
    assert _global_flush(store, tflush, TAggs)[
        ("big", (), "COUNTER")] == float(2 * (2**53 - 1))


def test_imports_racing_flushes_lose_nothing():
    """Import RPCs on many threads against back-to-back flushes: every
    counter and llhist sample merged lands in exactly one flush (a merge
    into a generation already read out, or an accumulator swapped away
    under it, would lose it)."""
    store = TStore(device="cpu", **SIZES)
    imp = TImport(SimpleNamespace(store=store), "127.0.0.1:0")
    fwd = TFwd()
    bins = np.zeros(llhist_ref.BINS, np.int64)
    bins[llhist_ref.bin_index(np.array([1.0, 30.0, 500.0]))] = [1, 2, 3]
    for k in range(3):
        fwd.counters.append((TRowMeta(
            name=f"c{k}", tags=[], joined_tags="", digest32=k,
            scope=TScope.GLOBAL_ONLY, wire_type="counter"), float(k + 1)))
        fwd.llhists.append((TRowMeta(
            name=f"l{k}", tags=[], joined_tags="", digest32=k,
            scope=TScope.GLOBAL_ONLY, wire_type="llhist"), bins))
    body = b"".join(_frame_v1(m) for m in tconvert.forwardable_to_wire(fwd))
    threads, sends = 12, 15
    totals: dict = {}

    def flush_once():
        for key, value in _global_flush(store, tflush, TAggs).items():
            if key[0].startswith("c") or key[0].endswith(".count"):
                totals[key[0]] = totals.get(key[0], 0.0) + value

    def sender():
        for _ in range(sends):
            imp._send_metrics_v1(body, _Ctx())

    workers = [threading.Thread(target=sender) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for w in workers:
            w.start()
        while any(w.is_alive() for w in workers):
            flush_once()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    flush_once()
    n = threads * sends
    assert imp.imported_total == 6 * n and imp.errors == 0
    for k in range(3):
        assert totals[f"c{k}"] == (k + 1) * n
        assert totals[f"l{k}.count"] == 6 * n


def test_failing_merge_answers_internal_and_is_counted():
    cfg = config_from_dict({"grpc_address": "127.0.0.1:0", "interval": "1h",
                            "hostname": "g", "tpu": SIZES})
    server = TServer(cfg, device="cpu", extra_metric_sinks=[TSink()])
    server.start()
    try:
        def broken(*_a, **_k):
            raise RuntimeError("merge exploded")
        server.store.counters.merge_batch = broken
        client = TClient(server.import_server.address, deadline=10.0)
        assert client.forward(_tfwd()) == 0
        assert client.stats["errors_send"] == 1 and client.errors == 1
        stats = server.stats_snapshot()
        assert stats["import_errors"] == 1 and stats["imported_total"] == 0
        client.close()
    finally:
        server.shutdown()


# -- local -> global pairs over gRPC ---------------------------------------

def _pair_corpus():
    """Per local: the lines it is sent, and how many metrics it forwards.
    Global-only counters on both locals, each global-only gauge on one,
    mixed counters and gauges, mixed, global-only and local-only timers
    and histograms, sets overlapping by half, llhists of every scope."""
    rng = np.random.default_rng(21)
    per_local = []
    for loc in range(2):
        lines = []
        for k in range(5):
            lines.append(f"fc{k}:{rng.integers(1, 99)}|c|#veneurglobalonly")
            lines.append(f"mc{k}:{rng.integers(1, 99)}|c|@0.5")
            lines.append(f"mg{k}:{rng.normal():.4f}|g")
        for k in range(loc * 3, loc * 3 + 3):
            lines.append(f"fg{k}:{rng.normal(0, 9):.4f}|g|#veneurglobalonly")
        for k in range(4):
            for v in rng.gamma(2.0, 20.0, 60 + 30 * k):
                lines.append(f"ht{k}:{v:.3f}|ms|#z:{k % 2}")
                lines.append(f"hg{k}:{v * 2:.3f}|h|#veneurglobalonly")
                lines.append(f"hl{k}:{v:.2f}|h|#veneurlocalonly")
        for k in range(3):
            for j in range(loc * 100, loc * 100 + 200):
                lines.append(f"s{k}:u{k}-{j}|s")
        lines.append(f"sl:u{loc}|s|#veneurlocalonly")
        for k in range(3):
            for v in rng.lognormal(0, 3, 40):
                lines.append(f"l{k}:{v:.5g}|l")
                lines.append(f"lg{k}:{v:.5g}|l|#veneurglobalonly")
                lines.append(f"ll{k}:{v:.5g}|l|#veneurlocalonly")
        order = rng.permutation(len(lines))
        # forwarded: fc 5, fg 3, ht 4 + hg 4, s 3, l 3 + lg 3
        per_local.append(([lines[i].encode() for i in order], 25))
    return per_local


def _jserver(**extra):
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
    server.start()
    return server, sink


def _tserver(**extra):
    cfg = config_from_dict({"interval": "1h", "hostname": "test",
                            "percentiles": list(PS),
                            "aggregates": list(AGGS), "tpu": SIZES,
                            **extra})
    sink = TSink()
    server = TServer(cfg, device="cpu", extra_metric_sinks=[sink])
    server.start()
    return server, sink


def _run_pair(package: str):
    """Two locals and one global of one package, the same packets; the
    series of both local flushes and of the global flush."""
    make = _jserver if package == "jax" else _tserver
    gserver, gsink = make(grpc_address="127.0.0.1:0")
    corpus = _pair_corpus()
    locals_ = [make(forward_address=gserver.import_server.address)
               for _ in corpus]
    try:
        for (server, _), (lines, _n) in zip(locals_, corpus):
            for line in lines:
                server.handle_metric_packet(line)
        local_series = []
        for server, sink in locals_:
            server.flush()
            local_series.append(_series(sink.wait_flush(timeout=20)))
        expected = sum(n for _lines, n in corpus)
        assert _wait_for(
            lambda: gserver.import_server.imported_total == expected), \
            gserver.import_server.imported_total
        gserver.flush()
        global_series = _series(gsink.wait_flush(timeout=20))
    finally:
        for server, _ in locals_:
            server.shutdown()
        gserver.shutdown()
    if package == "torch":
        for server, _ in locals_:
            stats = server.stats_snapshot()
            assert stats["forwarded_total"] == 25
            assert stats["forward_errors"] == 0
            assert server.forward_client.last_flow == {
                "received": 25, "merged": 25, "duplicate": False}
        assert gserver.stats_snapshot()["imported_total"] == 50
    return local_series, global_series


def test_local_global_pair_flushes_like_jax():
    jlocals, jglobal = _run_pair("jax")
    tlocals, tglobal = _run_pair("torch")
    for got, want in zip(tlocals, jlocals):
        _assert_series_agree(got, want)
    _assert_series_agree(tglobal, jglobal)
    # the locals flush no forwarded row; the global holds the sums and
    # the union, and no local-only row
    assert not any(k[0].startswith(("fc", "fg", "hg", "lg")) for k in
                   tlocals[0])
    assert not any(k[0].startswith(("hl", "ll", "sl")) for k in tglobal)
    assert ("fc0", (), "COUNTER") in tglobal
    assert 290 <= tglobal[("s0", (), "GAUGE")] <= 310  # 300 members


# -- interop -----------------------------------------------------------------

def test_jax_client_into_port_global():
    want_resp, want = _import_through("v1", "jax")
    store = TStore(device="cpu", **SIZES)
    imp = TImport(SimpleNamespace(store=store), "127.0.0.1:0")
    imp.start()
    try:
        client = JClient(imp.address, deadline=10.0)
        assert client.forward(_jfwd()) == len(_fwd_rows())
        client.close()
    finally:
        imp.stop()
    assert imp.imported_total == len(_fwd_rows())
    _assert_series_agree(_global_flush(store, tflush, TAggs), want)


def test_port_client_into_jax_import_server():
    _resp, want = _import_through("v1", "jax")
    store = JStore(**SIZES)
    imp = JImport(SimpleNamespace(store=store), "127.0.0.1:0")
    imp.start()
    try:
        client = TClient(imp.address, deadline=10.0)
        assert client.forward(_tfwd()) == len(_fwd_rows())
        assert client.last_flow["merged"] == len(_fwd_rows())
        client.close()
    finally:
        imp.stop()
    _assert_series_agree(_global_flush(store, jflush, JAggs), want)


def test_config_accepts_the_forward_addresses():
    cfg = config_from_dict({"forward_address": "g:8128",
                            "grpc_address": "127.0.0.1:0"})
    assert cfg.is_local and cfg.grpc_address == "127.0.0.1:0"
    assert not config_from_dict({}).is_local
