"""The port's device observatory (core/deviceobs.py) against the JAX
package's (tests/test_deviceobs.py's portable cases), on the CPU.

The same numpy-seeded ingest goes through a JAX store or server
(`JAX_PLATFORMS=cpu`) and the port's (`device="cpu"`). At every step the
comparison is: the ledger's token count per (family, lifecycle state)
equal between the packages; the port's ledger total equal to the exact
byte sum of its own tensors (live and parked spare generations, plus the
snapshot in flight mid-overlap); and the ledger's bytes per family equal
to the JAX ledger's, every family keeping the JAX package's shapes and
dtypes. Where the packages differ by design the test says so: the port
re-books the set family's dense bank when it grows on its 8x ladder (the
JAX ledger keeps the old size), and it books a compile only for a
kernel's first-use build or load, none for a resize or a prewarm rung.
The kernel registry's dispatch rows equal the JAX registry's, and its
launch counts equal the kernel wrappers' own counts. The shard-balance
plane is held to the JAX package's in tests/test_torch_sharded.py; here,
a live 2 -> 3 reshard's ledger (the captured generations booked
`reshard_capture` through the merge-back, then dropped) and the
`reshard_plan` entry, each against the JAX package's."""

from __future__ import annotations

import json
import random
import threading
import urllib.request

import numpy as np
import pytest

from veneur_tpu.core.deviceobs import DeviceObservatory as JObs
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.core.flusher import readout_columnstore as jreadout
from veneur_tpu.core.flusher import swap_columnstore as jswap
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core import deviceobs
from veneur_tpu_torch.core.columnstore import ColumnStore
from veneur_tpu_torch.core.deviceobs import (DeviceObservatory, HIST_ROWS,
                                             KERNEL_KINDS, nbytes_of)
from veneur_tpu_torch.core.flusher import (flush_columnstore_batch,
                                           readout_columnstore,
                                           swap_columnstore)
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import (_cuda, count_launch, hll_estimate,
                                  llhist_apply, tdigest_flush)
from veneur_tpu_torch.samplers.metrics import HistogramAggregates
from veneur_tpu_torch.samplers.parser import Parser
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

from test_deviceobs import (AGGS as JAGGS, PCTS, _feed as jfeed_server,
                            _feed_store as jfeed, _mk_store as jmk_store,
                            _skewed_names, corpus, mk_server as jmk_server)

AGGS = HistogramAggregates.from_names(
    ["min", "max", "median", "avg", "count", "sum"])
CAPS = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
            set_capacity=32, llhist_capacity=64, batch_cap=128)


def mk_store(**kw):
    return ColumnStore(device="cpu", **dict(CAPS, **kw))


def feed(store, lines):
    parser = Parser()
    for line in lines:
        parser.parse_metric_fast(line, store.process)
    store.apply_all_pending()


def pair(**kw):
    """A JAX store and a port store, each with its observatory attached."""
    jstore, jobs = jmk_store(**kw), JObs()
    jstore.attach_deviceobs(jobs)
    pstore, pobs = mk_store(**kw), DeviceObservatory()
    pstore.attach_deviceobs(pobs)
    return jstore, jobs, pstore, pobs


def walk(store, inflight=()) -> int:
    """The port's own byte sum: every table's live and parked spare
    tensors, plus the captured generations of swaps not yet recycled."""
    total = sum(nbytes_of(t._devobs_state()) + nbytes_of(t._spare)
                for _family, t in store.tables())
    return total + sum(nbytes_of(state) for state in inflight)


def token_counts(obs) -> dict:
    counts: dict = {}
    for tok in obs._tokens.values():
        key = (tok.family, tok.state)
        counts[key] = counts.get(key, 0) + 1
    return counts


def family_bytes(obs) -> dict:
    """Per family, per state, the nonzero bytes."""
    return {family: {s: n for s, n in states.items() if n}
            for family, states in obs.ledger()["by_family"].items()}


def assert_same_ledger(jobs, pobs, store, inflight=()):
    assert token_counts(pobs) == token_counts(jobs)
    assert family_bytes(pobs) == family_bytes(jobs)
    assert pobs.total_bytes() == jobs.total_bytes() == walk(store, inflight)


def swapped_states(swap) -> list:
    return [swap[f]["state"] for f in ("histogram", "llhist", "counter",
                                       "gauge", "set")
            if "state" in swap[f]]


class TestLedgerConservation:
    def test_attach_registers_exact(self):
        jstore, pstore = jmk_store(), mk_store()
        jfeed(jstore, corpus())
        feed(pstore, corpus())
        jobs, pobs = JObs(), DeviceObservatory()
        jstore.attach_deviceobs(jobs)
        pstore.attach_deviceobs(pobs)
        assert_same_ledger(jobs, pobs, pstore)
        led = pobs.ledger()
        assert led["total_bytes"] > 0
        assert led["live_bytes"] == led["total_bytes"]
        assert led["forecast_next_resize_bytes"] == 2 * led["live_bytes"]

    @pytest.mark.parametrize("is_local", [False, True])
    def test_swap_under_overlapped_flush(self, is_local):
        """Swap on this thread, readout on another while ingest goes on:
        mid-overlap the old generations are booked in flight, after the
        readout they are the parked spares, and the next interval swaps
        into them; equal to the JAX ledger at each step."""
        jstore, jobs, pstore, pobs = pair()
        jfeed(jstore, corpus())
        feed(pstore, corpus())
        jsw = jswap(jstore, is_local, PCTS)
        psw = swap_columnstore(pstore, is_local, PCTS)
        inflight = swapped_states(psw)
        assert_same_ledger(jobs, pobs, pstore, inflight)
        assert sum(s["inflight"] for s in pobs.ledger()[
            "by_family"].values()) == walk(pstore, inflight) - walk(pstore)

        t = threading.Thread(target=lambda: readout_columnstore(
            pstore, psw, is_local, AGGS))
        t.start()
        feed(pstore, corpus(round_no=7))
        t.join(30.0)
        assert not t.is_alive()
        jreadout(jstore, jsw, is_local, JAGGS)
        jfeed(jstore, corpus(round_no=7))
        assert_same_ledger(jobs, pobs, pstore)
        assert any(s.get("spare") for s in family_bytes(pobs).values())
        jflush(jstore, is_local, PCTS, JAGGS)
        flush_columnstore_batch(pstore, is_local, PCTS, AGGS)
        assert_same_ledger(jobs, pobs, pstore)

    def test_resize_grow_rebooks_live_generation(self):
        jstore, jobs, pstore, pobs = pair()
        before = pobs.total_bytes()
        lines = [b"rz.%d:1|c" % i for i in range(100)]
        jfeed(jstore, lines)
        feed(pstore, lines)
        assert pstore.counters.capacity == jstore.counters.capacity > 64
        assert pobs.total_bytes() > before
        assert_same_ledger(jobs, pobs, pstore)
        jflush(jstore, True, PCTS, JAGGS)
        flush_columnstore_batch(pstore, True, PCTS, AGGS)
        assert_same_ledger(jobs, pobs, pstore)
        # a resize with a parked spare: the spare leaves as the live
        # generation doubles
        more = [b"rz2.%d:1|c" % i for i in range(100)]
        jfeed(jstore, more)
        feed(pstore, more)
        assert pstore.counters.capacity == jstore.counters.capacity
        assert_same_ledger(jobs, pobs, pstore)

    def test_prewarm_rung_token_is_transient(self):
        jstore, jobs, pstore, pobs = pair()
        before = pobs.total_bytes()
        mid = {}
        for store, obs, key in ((jstore, jobs, "jax"),
                                (pstore, pobs, "port")):
            table = store.counters
            real = table._prewarm_apply

            def spy(state, cols, capacity, real=real, obs=obs, key=key):
                mid[key] = (obs.total_bytes(), token_counts(obs).get(
                    ("counter", "prewarm")), nbytes_of(state)
                    if key == "port" else None)
                return real(state, cols, capacity)
            table._prewarm_apply = spy
            assert table.prewarm_rung(128, PCTS)
        # booked `prewarm` while it ran (the rung's bytes on top), then
        # dropped: equal to the JAX ledger at both points
        assert mid["port"][:2] == mid["jax"][:2] == (
            before + mid["port"][2], 1)
        assert_same_ledger(jobs, pobs, pstore)
        assert pobs.total_bytes() == before
        kinds = {(k["kind"], k["family"])
                 for k in pobs.kernel_report()["kernels"]}
        assert ("prewarm", "counter") in kinds
        # the JAX package books the rung's XLA compile; the port compiles
        # nothing per capacity
        assert jobs.kernel_report()["compiles"].get("counter", 0) >= 1
        assert pobs.kernel_report()["compiles"] == {}

    def test_set_bank_growth_rebooks(self):
        """The set family's dense bank grows on its own 8x ladder as keys
        promote. The port re-books the live generation; the JAX ledger
        keeps the bank's size at registration, short by the growth."""
        lines = [b"s.%d:m%d|s" % (k, i) for k in range(40) for i in range(3)]
        jstore, jobs, pstore, pobs = pair(set_promote_samples=2)
        assert pstore.sets._dev_cap == jstore.sets._dev_cap == 32
        small = {f: nbytes_of(t._devobs_state()) for f, t in pstore.tables()}
        jfeed(jstore, lines)
        feed(pstore, lines)
        assert pstore.sets._dev_cap == jstore.sets._dev_cap == 256
        assert pobs.total_bytes() == walk(pstore)
        grown = nbytes_of(pstore.sets.state) - small["set"]
        assert grown == 224 * 16384
        assert jobs.total_bytes() == pobs.total_bytes() - grown
        assert token_counts(pobs) == token_counts(jobs)

    def test_disabled_observatory_is_inert(self):
        server = Server(config_from_dict({
            "interval": "1h", "hostname": "test",
            "device_observatory": False, "tpu": dict(CAPS)}),
            device="cpu", extra_metric_sinks=[ChannelMetricSink()])
        jserver, _ = jmk_server(device_observatory=False)
        try:
            for srv in (server, jserver):
                for line in corpus():
                    srv.handle_metric_packet(line)
                srv.store.apply_all_pending()
                srv.flush()
                assert srv.deviceobs.total_bytes() == 0
                assert srv.deviceobs.telemetry_rows() == []
                assert srv.device_report()["enabled"] is False
            assert server.deviceobs.kernel_report()["kernels"] == []
        finally:
            for srv in (server, jserver):
                srv.config.flush_on_shutdown = False
                srv.shutdown()


class _CountingPlain:
    """The kernels' plain versions, each counted as a launch on its
    module's `launches` and the thread's tally, as the card's wrappers
    count theirs: the registry's launch accounting, held on the CPU."""

    def __init__(self, monkeypatch):
        for mod, name in ((tdigest_flush, "flush_packed_plain"),
                          (hll_estimate, "estimate_plain"),
                          (llhist_apply, "apply_plain")):
            real = getattr(mod, name)
            # the count goes back to its value after the test
            monkeypatch.setattr(mod, "launches", mod.launches)

            def counted(*args, real=real, mod=mod):
                mod.launches += 1
                count_launch()
                return real(*args)
            monkeypatch.setattr(mod, name, counted)
        self.start = self.read()

    @staticmethod
    def read() -> dict:
        return {"tdigest_flush": tdigest_flush.launches,
                "hll_estimate": hll_estimate.launches,
                "llhist_apply": llhist_apply.launches}

    def delta(self) -> dict:
        now = self.read()
        return {k: now[k] - self.start[k] for k in now}


class TestKernelRegistry:
    def test_flush_populates_dispatches_and_hists(self, monkeypatch):
        plain = _CountingPlain(monkeypatch)
        jstore, jobs, pstore, pobs = pair(set_promote_samples=1)
        for round_no in (0, 1):
            jfeed(jstore, corpus(round_no))
            feed(pstore, corpus(round_no))
            jflush(jstore, True, PCTS, JAGGS)
            flush_columnstore_batch(pstore, True, PCTS, AGGS)
        jrep, prep = jobs.kernel_report(), pobs.kernel_report()

        def rows(rep):
            return {(k["kind"], k["family"]): k["dispatches"]
                    for k in rep["kernels"]}
        assert rows(prep) == rows(jrep)
        assert {("apply", "counter"), ("readout", "counter"),
                ("reset", "counter")} <= set(rows(prep))
        # every launch the tables made is booked, by the call that made it
        launched = plain.delta()
        assert min(launched.values()) > 0
        assert prep["kernel_launches"] == launched
        timed = [k for k in prep["kernels"] if k.get("wall")]
        assert timed and all(k["wall"]["count"] >= 1 for k in timed)
        rows_ = {r[0] for r in pobs.telemetry_rows()}
        assert {"device.mem.total_bytes", "device.mem.peak_bytes",
                "device.mem.generations", "device.mem.bytes",
                "device.kernel.dispatches",
                "device.kernel.launches"} <= rows_
        hist_rows = {r for r in rows_ if ".kernel." in r
                     and r not in ("device.kernel.dispatches",
                                   "device.kernel.launches")}
        assert {r.rsplit(".", 1)[0] for r in hist_rows} <= set(HIST_ROWS)
        from veneur_tpu.core import deviceobs as jdeviceobs
        assert HIST_ROWS == jdeviceobs.HIST_ROWS
        assert KERNEL_KINDS == jdeviceobs.KERNEL_KINDS

    def test_import_merges_are_booked(self, monkeypatch):
        """The import path's device merges are `merge` rows (the JAX
        package books merges only on its sharded tables)."""
        plain = _CountingPlain(monkeypatch)
        store, obs = mk_store(), DeviceObservatory()
        store.attach_deviceobs(obs)
        rng = np.random.default_rng(3)
        stubs = []
        parser = Parser()
        for i in range(4):
            parser.parse_metric_fast(b"m.%d:1|l" % i, stubs.append)
        bins = rng.integers(0, 5, (4, 4501)).astype(np.int64)
        store.llhists.merge_batch(stubs, bins)
        rows = {(k["kind"], k["family"]): k["dispatches"]
                for k in obs.kernel_report()["kernels"]}
        assert rows == {("merge", "llhist"): 1}
        # a register add, not K3
        assert plain.delta()["llhist_apply"] == 0

    def test_kernel_builds_are_compiles(self):
        """A kernel's first-use build or load (ops/_cuda.py) is booked as
        a compile under the kernel's name, in every live observatory and
        in one made later."""
        obs = DeviceObservatory()
        try:
            with _cuda._lock:
                _cuda._notify_load("test_kernel", 0.25)
            rep = obs.kernel_report()
            assert rep["compiles"] == {"test_kernel": 1}
            assert rep["last_compile_seconds"] == {"test_kernel": 0.25}
            later = DeviceObservatory()
            assert later.kernel_report()["compiles"] == {"test_kernel": 1}
            assert DeviceObservatory(enabled=False).kernel_report()[
                "compiles"] == {}
            assert ("device.compile.count", "counter", 1.0,
                    ("kernel:test_kernel",)) in later.telemetry_rows()
        finally:
            _cuda.load_seconds.pop("test_kernel", None)


def test_unsharded_store_has_no_balance():
    jstore, jobs, pstore, pobs = pair()
    jfeed(jstore, corpus())
    feed(pstore, corpus())
    assert jobs.shard_balance() is None and jobs.shard_skew() is None
    assert "shard_balance" not in jobs.report()
    assert "shard_balance" not in pobs.report()
    assert not any(r[0] == "device.shard.skew"
                   for r in pobs.telemetry_rows())


def test_debug_device_http_surface():
    server = Server(config_from_dict({
        "interval": "1h", "hostname": "test", "ledger_strict": True,
        "http_address": "127.0.0.1:0", "tpu": dict(CAPS)}), device="cpu",
        extra_metric_sinks=[ChannelMetricSink()], rng=random.Random(1))
    jserver, _ = jmk_server()
    try:
        server.start()
        for srv in (server, jserver):
            jfeed_server(srv, corpus())
            srv.flush()
        host, port = server.http_api.address
        with urllib.request.urlopen(f"http://{host}:{port}/debug/device",
                                    timeout=10) as r:
            assert r.status == 200
            body = json.loads(r.read())
        want = jserver.device_report()
        assert set(body) == set(want) | {"kernel_launches"}
        assert body["enabled"] is True
        assert body["ledger"]["total_bytes"] == walk(server.store)
        assert body["kernels"]
        assert body["backend_devices"] == [] and body["reconciliation"] \
            is None  # the CPU reports no allocator, as JAX's CPU backend
        assert body["watermarks"] == want["watermarks"] == {
            "state": "ok", "soft_bytes": 0, "hard_bytes": 0,
            "last_bytes": 0, "transitions": 0}
    finally:
        for srv in (server, jserver):
            srv.config.flush_on_shutdown = False
            srv.shutdown()


def _pserver(**kw):
    from test_torch_reshard import mk_server
    return mk_server(**kw)[0]


def test_live_reshard_2_to_3_conserves(tmp_path):
    """tests/test_deviceobs.py's live reshard on both packages: the
    captured generations ride `reshard_capture` through the WAL'd
    merge-back and are dropped at the cutover, the 3-shard generations
    register fresh; the ledger equals the tensors at every quiescent
    point, and its tokens and bytes equal the JAX ledger's, mid-cutover
    too."""
    server = _pserver(**{"tpu.shards": 2},
                      reshard_spool_dir=str(tmp_path / "wal"))
    jserver, _ = jmk_server(**{"tpu.shards": 2},
                            reshard_spool_dir=str(tmp_path / "jwal"))
    mid = {}

    def spy(srv, key):
        inner = srv.reshard._wal_and_merge

        def wal_and_merge(cells, chaos):
            mid[key] = (token_counts(srv.deviceobs),
                        family_bytes(srv.deviceobs))
            return inner(cells, chaos)
        srv.reshard._wal_and_merge = wal_and_merge

    try:
        obs, jobs = server.deviceobs, jserver.deviceobs
        for srv in (server, jserver):
            jfeed_server(srv, corpus())
        assert obs.total_bytes() == walk(server.store)
        for srv in (server, jserver):
            srv.flush()
        assert obs.total_bytes() == walk(server.store)
        assert family_bytes(obs) == family_bytes(jobs)
        spy(server, "port")
        spy(jserver, "jax")
        for srv in (server, jserver):
            jfeed_server(srv, corpus(round_no=1))
            srv.reshard.begin(shards=3, block=True)
        # mid-cutover: every family's capture booked reshard_capture
        assert mid["port"] == mid["jax"]
        assert {f for f, st in mid["port"][1].items()
                if st.get("reshard_capture")} == {
            "counter", "gauge", "histogram", "llhist", "set"}
        led = obs.ledger()
        assert all(st.get("reshard_capture", 0) == 0
                   and st.get("inflight", 0) == 0
                   for st in led["by_family"].values())
        assert obs.total_bytes() == walk(server.store) > 0
        assert token_counts(obs) == token_counts(jobs)
        assert family_bytes(obs) == family_bytes(jobs)
        for srv in (server, jserver):
            jfeed_server(srv, corpus(round_no=3))
            srv.flush()
        assert obs.total_bytes() == walk(server.store)
        assert family_bytes(obs) == family_bytes(jobs)
        bal = obs.shard_balance()
        assert bal is not None and bal["n_shards"] == 3
    finally:
        for srv in (server, jserver):
            srv.config.flush_on_shutdown = False
            srv.shutdown()


def test_hot_shard_detection_and_reshard_plan():
    """All rows on one of four shards: skew 4.0, shard 0 hot, and the
    reshard plan equal to the JAX planner's over the same candidate
    range (the JAX package's device count)."""
    import jax
    server = _pserver(**{"tpu.shards": 4})
    jserver, _ = jmk_server(**{"tpu.shards": 4})
    try:
        server.deviceobs.reshard_plan_max_shards = len(jax.devices())
        names = _skewed_names(4, 0, 24)
        for srv in (server, jserver):
            jfeed_server(srv, names)
        bal = server.deviceobs.shard_balance()
        assert bal["rows_per_shard"] == [24, 0, 0, 0]
        assert bal["skew"] == pytest.approx(4.0)
        assert bal["hot_shards"] == [0]
        plan = bal["reshard_plan"]
        assert plan == jserver.deviceobs.shard_balance()["reshard_plan"]
        assert plan["from_shards"] == 4 and plan["to_shards"] != 4
        assert plan["migration_cells"] >= 1
        # the server's default range is the port's own setting
        server.deviceobs.reshard_plan_max_shards = 1
        assert "reshard_plan" not in server.deviceobs.shard_balance()
    finally:
        for srv in (server, jserver):
            srv.config.flush_on_shutdown = False
            srv.shutdown()


_RUNG_STEPS = (
    ("start", lambda s: None),
    ("interval 1", lambda s: jfeed_server(s, corpus())),
    ("flush 1", lambda s: s.flush()),
    # counters are never shed: their doubling lands in every state
    ("resize", lambda s: jfeed_server(
        s, [b"rz.%d:1|c" % i for i in range(200)])),
    ("flush 2", lambda s: s.flush()),
    ("flush 3", lambda s: s.flush()))


def _walk_rung(server) -> list:
    """(step, rung state ticked after it, ledger total) per step."""
    dw = server.overload.device_watermarks
    seen = []
    for label, step in _RUNG_STEPS:
        step(server)
        seen.append((label, dw.tick(), server.deviceobs.total_bytes()))
    assert server.device_report()["watermarks"]["transitions"] == \
        dw.transitions
    return seen


def test_device_rung_transitions_equal_jax():
    """The same config and ingest through both servers walk the device
    watermark rung through the same states, ticked by hand after each
    step: soft just above the tables' first footprint (the spares parked
    by flush 1 cross it), hard just above flush 1's total (the counter
    table's doubled double buffer at flush 2 crosses it)."""
    dry, _ = jmk_server()
    totals = dict((label, n) for label, _s, n in _walk_rung(dry))
    dry.config.flush_on_shutdown = False
    dry.shutdown()
    keys = {"overload_device_soft_bytes": totals["start"] + 1,
            "overload_device_hard_bytes": totals["flush 1"] + 1}
    jserver, _ = jmk_server(**keys)
    server = Server(config_from_dict({
        "interval": "1h", "hostname": "test", "ledger_strict": True,
        "tpu": {"counter_capacity": 128, "gauge_capacity": 128,
                "histo_capacity": 128, "set_capacity": 64,
                "llhist_capacity": 64, "batch_cap": 512}, **keys}),
        device="cpu", extra_metric_sinks=[ChannelMetricSink()])
    try:
        walked = _walk_rung(server)
        assert walked == _walk_rung(jserver)
        assert [state for _label, state, _n in walked] == [
            "ok", "ok", "degraded", "degraded", "shedding", "shedding"]
        assert server.deviceobs.total_bytes() == walk(server.store)
        rows = {r[0]: r[2] for r in server.overload.telemetry_rows()}
        assert rows["overload.device_transitions"] == 2.0
        assert rows["overload.device_bytes"] == walked[-1][2]
        events = server.telemetry.events.snapshot(kind="overload_state")
        assert [(e["old"], e["new"]) for e in events] == [
            ("ok", "degraded"), ("degraded", "shedding")]
    finally:
        for srv in (server, jserver):
            srv.config.flush_on_shutdown = False
            srv.shutdown()


def test_backend_stats_on_the_cpu_are_empty():
    assert deviceobs.backend_memory_stats() == []
    assert deviceobs.cuda_memory_stats() == []
