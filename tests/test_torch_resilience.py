"""The port's forward resilience layer (veneur_tpu_torch/util/resilience.py)
against the JAX package's on the same inputs, on the CPU: retry delays and
circuit-breaker transitions under one fake clock, bit-identical centroid
merges, merged forwardable state that encodes to the same wire bytes, the
carryover's stash, drain, shed and spill, and the server's forward thread
(an undispatched interval is carried over, never dropped)."""

from __future__ import annotations

import random
import threading

import numpy as np
import pytest

from veneur_tpu.core.columnstore import RowMeta as JRowMeta
from veneur_tpu.core.flusher import ForwardableState as JFwd
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.ops import batch_tdigest as jbtd
from veneur_tpu.samplers.metrics import MetricScope as JScope
from veneur_tpu.util import resilience as jres
from veneur_tpu.util import spool as jspool
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.columnstore import RowMeta as TRowMeta
from veneur_tpu_torch.core.flusher import ForwardableState as TFwd
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.ops import batch_tdigest as tbtd
from veneur_tpu_torch.ops import hll_ref, llhist_ref
from veneur_tpu_torch.samplers.metrics import MetricScope as TScope
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TSink
from veneur_tpu_torch.util import resilience as tres
from veneur_tpu_torch.util import spool as tspool

JAX = dict(res=jres, fwd=JFwd, meta=JRowMeta, scope=JScope,
           convert=jconvert, spool=jspool)
TORCH = dict(res=tres, fwd=TFwd, meta=TRowMeta, scope=TScope,
             convert=tconvert, spool=tspool)
PACKAGES = {"jax": JAX, "torch": TORCH}


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def test_resilience_constants_match_jax():
    assert (tbtd.C, tbtd.COMPRESSION) == (jbtd.C, jbtd.COMPRESSION)
    assert tres.STATE_CODES == jres.STATE_CODES


# -- RetryPolicy --------------------------------------------------------------

@pytest.mark.parametrize("attempts,base,cap,budget,advance", [
    (3, 0.2, 5.0, 100.0, 0.0),    # the count is bounded by the attempts
    (10, 1.0, 1.0, 2.5, 0.5),     # the budget stops the delays
    (8, 0.1, 0.8, 1e6, 0.0),      # growth up to the cap
    (1, 0.2, 2.0, 10.0, 0.0),     # one attempt: no retry
])
def test_retry_delays_match_jax(attempts, base, cap, budget, advance):
    out = {}
    for name, pkg in PACKAGES.items():
        clock = FakeClock()
        policy = pkg["res"].RetryPolicy(
            max_attempts=attempts, base_delay=base, max_delay=cap,
            rng=random.Random(7), clock=clock)
        delays = []
        for d in policy.delays(budget):
            delays.append(d)
            clock.now += d + advance
        out[name] = delays
    assert out["torch"] == out["jax"]
    delays = out["torch"]
    assert len(delays) <= attempts - 1
    # each delay ends inside the budget (the attempt after it may not)
    assert sum(delays) + advance * max(0, len(delays) - 1) < budget
    caps = [min(cap, base * 2.0 ** n) for n in range(len(delays))]
    assert all(0.0 <= d <= c for d, c in zip(delays, caps))


# -- CircuitBreaker -----------------------------------------------------------

# scripted calls: ("allow"|"ok"|"fail"|"dispatchable"|"state"|"wait", arg)
_BREAKER_SCRIPTS = {
    "full_cycle": [("allow", 0), ("fail", 0), ("fail", 0), ("state", 0),
                   ("fail", 0), ("state", 0), ("allow", 0), ("wait", 29.0),
                   ("allow", 0), ("wait", 1.5), ("state", 0), ("allow", 0),
                   ("ok", 0), ("state", 0), ("allow", 0)],
    "single_probe": [("fail", 0)] * 3 + [("wait", 31.0), ("allow", 0),
                                         ("allow", 0), ("allow", 0),
                                         ("state", 0)],
    "failed_probe_reopens": [("fail", 0)] * 3 + [
        ("wait", 31.0), ("allow", 0), ("fail", 0), ("state", 0),
        ("allow", 0), ("wait", 31.0), ("state", 0)],
    "success_resets_streak": [("fail", 0), ("fail", 0), ("ok", 0),
                              ("fail", 0), ("fail", 0), ("state", 0),
                              ("fail", 0), ("state", 0)],
    "dispatchable_keeps_probe": [("fail", 0)] * 3 + [
        ("dispatchable", 0), ("wait", 31.0), ("dispatchable", 0),
        ("dispatchable", 0), ("allow", 0), ("dispatchable", 0),
        ("allow", 0)],
}


@pytest.mark.parametrize("script", sorted(_BREAKER_SCRIPTS))
def test_circuit_breaker_matches_jax(script):
    out = {}
    for name, pkg in PACKAGES.items():
        clock = FakeClock()
        transitions = []
        br = pkg["res"].CircuitBreaker(
            failure_threshold=3, recovery_time=30.0, name="t", clock=clock,
            on_transition=lambda *a: transitions.append(a))
        trace = []
        for op, arg in _BREAKER_SCRIPTS[script]:
            if op == "allow":
                trace.append(br.allow())
            elif op == "ok":
                br.record_success()
            elif op == "fail":
                br.record_failure()
            elif op == "dispatchable":
                trace.append(br.is_dispatchable)
            elif op == "state":
                trace.append((br.state, br.state_code,
                              br.consecutive_failures))
            else:
                clock.now += arg
        out[name] = (trace, transitions, br.open_total, br.refused_total)
    assert out["torch"] == out["jax"]
    if script == "single_probe":
        assert out["torch"][0][:3] == [True, False, False]
    if script == "dispatchable_keeps_probe":
        assert out["torch"][0] == [False, True, True, True, True, False]


# -- merges -------------------------------------------------------------------

def _centroids(rng, n, scale):
    means = np.zeros(jbtd.C, np.float32)
    weights = np.zeros(jbtd.C, np.float32)
    means[:n] = np.sort(rng.gamma(2.0, scale, n)).astype(np.float32)
    weights[:n] = rng.choice([1.0, 0.5, 2.0, 10.0], n).astype(np.float32)
    return means, weights


@pytest.mark.parametrize("na,nb", [(40, 30), (128, 128), (1, 0), (0, 7),
                                   (0, 0), (100, 5)])
def test_merge_centroids_is_bit_identical(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    ma, wa = _centroids(rng, na, 10.0)
    mb, wb = _centroids(rng, nb, 40.0)
    want = jres.merge_centroids(ma, wa, mb, wb, jbtd.C, jbtd.COMPRESSION)
    got = tres.merge_centroids(ma, wa, mb, wb, tbtd.C, tbtd.COMPRESSION)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (jbtd.C,)
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() == pytest.approx(wa.sum() + wb.sum())


def _interval_rows(seed: int, shift: int):
    """Row specs of one interval with every family; `shift` moves the key
    window, so that two intervals share some keys and not others."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(shift, shift + 5):
        rows.append(("counter", f"c{k}", [f"k:{k % 2}"], "counter",
                     float(rng.integers(1, 10**6))))
        rows.append(("gauge", f"g{k}", [], "gauge", float(rng.normal())))
    for k in range(shift, shift + 4):
        means, weights = _centroids(rng, int(rng.integers(1, 90)), 20.0)
        live = weights > 0
        rows.append(("histogram", f"h{k}", ["a:b"] if k % 2 else [], "timer",
                     (means, weights, float(means[live].min()),
                      float(means[live].max()),
                      float(np.sum(weights[live] / means[live])))))
    for k in range(shift, shift + 3):
        h = hll_ref.HLL()
        for j in range(int(rng.integers(1, 600))):
            h.insert(f"m{seed}-{k}-{j}".encode())
        rows.append(("set", f"s{k}", [], "set", h.regs.astype(np.int8)))
    for k in range(shift, shift + 3):
        bins = np.zeros(llhist_ref.BINS, np.int64)
        np.add.at(bins, llhist_ref.bin_index(rng.lognormal(0, 3, 50)), 1)
        rows.append(("llhist", f"l{k}", [f"z:{k}"], "llhist", bins))
    return rows


def _state(pkg, rows):
    fwd = pkg["fwd"]()
    for i, (family, name, tags, wire_type, payload) in enumerate(rows):
        meta = pkg["meta"](name=name, tags=list(tags),
                           joined_tags=",".join(tags), digest32=i,
                           scope=pkg["scope"].GLOBAL_ONLY,
                           wire_type=wire_type)
        if family == "histogram":
            fwd.histograms.append((meta, *(p.copy() if isinstance(
                p, np.ndarray) else p for p in payload)))
        else:
            getattr(fwd, family + "s").append(
                (meta, payload.copy() if isinstance(payload, np.ndarray)
                 else payload))
    return fwd


def test_merge_forwardable_encodes_to_the_jax_bytes():
    newer, older = _interval_rows(1, 0), _interval_rows(2, 2)
    wires = {}
    for name, pkg in PACKAGES.items():
        merged = pkg["res"].merge_forwardable(_state(pkg, newer),
                                              _state(pkg, older))
        wires[name] = pkg["convert"].forwardable_to_wire(merged)
    assert wires["torch"] == wires["jax"]
    # shared keys merged into one row each: 3 of 5 counters, gauges,
    # 2 of 4 digests, 1 of 3 sets and llhists
    assert len(wires["torch"]) == 7 + 7 + 6 + 5 + 5


# -- Carryover ----------------------------------------------------------------

def _run_carryover(pkg, max_intervals, steps, spill_dir=None):
    """Drive a Carryover through `steps` ("fail" stashes the drained
    interval, "ok" drains it and clears the age) over the intervals of
    _interval_rows; returns the wire bytes of each delivered interval
    and the counters."""
    spool = None
    if spill_dir is not None:
        spool = pkg["spool"].CarryoverSpool(str(spill_dir))
    co = pkg["res"].Carryover(
        max_intervals,
        spill=(None if spool is None else
               lambda f: spool.append(pkg["convert"].forwardable_to_wire(f))))
    delivered = []
    for i, step in enumerate(steps):
        fwd = co.drain_into(_state(pkg, _interval_rows(10 + i, i % 3)))
        if step == "fail":
            co.stash(fwd)
        else:
            delivered.append(pkg["convert"].forwardable_to_wire(fwd))
            co.clear_age()
    counts = (co.depth, co.pending_metrics, co.stashed_total,
              co.merged_total, co.shed_total, co.spilled_total)
    segments = ([seg.read_metrics() for seg in spool.segments()]
                if spool is not None else [])
    return delivered, counts, segments


@pytest.mark.parametrize("max_intervals,steps", [
    (3, ["fail", "ok"]),                    # stash, drain round trip
    (3, ["fail", "fail", "fail", "ok"]),    # three held, merged into one
    (2, ["fail", "fail", "fail", "ok"]),    # the third sheds them all
    (0, ["fail", "ok"]),                    # 0 disables the carryover
])
def test_carryover_matches_jax(max_intervals, steps):
    got = _run_carryover(TORCH, max_intervals, steps)
    want = _run_carryover(JAX, max_intervals, steps)
    assert got == want
    delivered, (depth, pending, stashed, merged, shed, _spilled), _ = got
    assert depth == 0 and pending == 0
    assert stashed == (steps.count("fail") if max_intervals else 0)
    if max_intervals == 0:
        assert shed > 0 and merged == 0
    elif steps.count("fail") > max_intervals:
        assert shed > 0
        # what was shed is gone: the last delivery is one interval alone
        assert delivered[-1] == tconvert.forwardable_to_wire(
            _state(TORCH, _interval_rows(10 + len(steps) - 1,
                                         (len(steps) - 1) % 3)))
    else:
        assert shed == 0 and merged > 0


def test_carryover_spills_to_the_spool_past_its_bound(tmp_path):
    steps = ["fail", "fail", "fail", "ok"]
    got = _run_carryover(TORCH, 2, steps, tmp_path / "torch")
    want = _run_carryover(JAX, 2, steps, tmp_path / "jax")
    assert got == want
    delivered, counts, segments = got
    assert counts[4] == 0 and counts[5] > 0   # spilled, nothing shed
    assert len(segments) == 1 and len(segments[0]) == counts[5]


def test_carryover_spill_failure_sheds_loudly():
    def broken(_fwd):
        raise OSError("disk full")
    co = tres.Carryover(1, spill=broken)
    co.stash(_state(TORCH, _interval_rows(1, 0)))
    co.stash(co.drain_into(_state(TORCH, _interval_rows(2, 0))))
    assert co.spilled_total == 0 and co.shed_total > 0 and co.depth == 0


def test_fail_then_succeed_equals_never_failing():
    """Two intervals delivered as one carryover-merged send carry exactly
    what merging them directly gives (the JAX package's pin,
    tests/test_resilience.py::TestCarryover), in both packages."""
    first, second = _interval_rows(1, 0), _interval_rows(2, 1)
    out = {}
    for name, pkg in PACKAGES.items():
        co = pkg["res"].Carryover(max_intervals=5)
        co.stash(_state(pkg, first))
        delivered = co.drain_into(_state(pkg, second))
        assert delivered.wire is None
        control = pkg["res"].merge_forwardable(_state(pkg, second),
                                               _state(pkg, first))
        wire = pkg["convert"].forwardable_to_wire(delivered)
        assert wire == pkg["convert"].forwardable_to_wire(control)
        out[name] = wire
    assert out["torch"] == out["jax"]


def test_stash_invalidates_pre_encoded_frames():
    co = tres.Carryover(3)
    fwd = _state(TORCH, _interval_rows(1, 0))
    fwd.wire = [b"stale"]
    co.stash(fwd)
    nxt = _state(TORCH, _interval_rows(2, 0))
    nxt.wire = [b"unmerged"]
    assert co.drain_into(nxt).wire is None


# -- the server's forward thread ----------------------------------------------

def test_undispatched_interval_is_carried_over():
    """A forward still running when the next flush comes: that flush
    starts no second thread; its snapshot goes into the carryover and is
    counted, and the next send delivers it merged."""
    cfg = config_from_dict({
        "interval": "1h", "hostname": "t", "forward_address": "127.0.0.1:1",
        "tpu": dict(counter_capacity=8, gauge_capacity=8, histo_capacity=8,
                    set_capacity=8, llhist_capacity=4, batch_cap=64)})
    server = TServer(cfg, device="cpu", extra_metric_sinks=[TSink()])
    # the server's own flush spans reach its span extraction, whose 1 in
    # 100 ssf.names_unique roll adds a forwarded set row when a span
    # worker takes one before the next swap: off, so the carryover holds
    # the traffic's rows alone
    server.metric_extraction.uniqueness_rate = 0.0
    server.start()
    release = threading.Event()
    sent = []
    fc = server.forward_client

    def hung_forward(fwd, interval_start=0.0):
        fwd = fc.carryover.drain_into(fwd)
        release.wait(30)
        sent.append({m.name: v for m, v in fwd.counters})
        fc.carryover.clear_age()
        return len(fwd)

    fc.forward = hung_forward
    server.interval = 0.2  # the flush's wait for the forward thread
    try:
        server.handle_metric_packet(b"a:2|c|#veneurglobalonly")
        server.flush()
        assert server._forward_thread.is_alive()
        server.handle_metric_packet(b"a:5|c|#veneurglobalonly")
        server.handle_metric_packet(b"b:1|c|#veneurglobalonly")
        server.flush()
        stats = server.stats_snapshot()
        assert stats["forward_undispatched"] == 1
        assert stats["carryover_depth"] == 1
        assert stats["carryover_pending"] == 2
        release.set()
        server._forward_thread.join(10)
        server.flush()  # empty, but the carryover is pending: dispatched
        server._forward_thread.join(10)
        assert sent == [{"a": 2.0}, {"a": 5.0, "b": 1.0}]
        assert server.stats_snapshot()["carryover_depth"] == 0
    finally:
        release.set()
        server.shutdown()


def test_config_accepts_the_resilience_keys():
    cfg = config_from_dict({
        "forward_retry_max_attempts": 5, "forward_retry_base": "250ms",
        "forward_retry_max": "3s", "circuit_breaker_failure_threshold": 4,
        "circuit_breaker_recovery": "1m", "carryover_max_intervals": 2,
        "carryover_spool_dir": "spool", "carryover_spool_max_bytes": 1 << 20,
        "carryover_spool_max_segments": 9,
        "carryover_spool_quarantine_max_bytes": 1 << 10,
        "carryover_spool_quarantine_max_segments": 3, "forward_wal": True,
        "wal_stale_after_intervals": 0.5, "wal_replay_rate_limit": 100.0,
        "wal_replay_burst": 1.5, "backfill_max_open_intervals": 2})
    assert (cfg.forward_retry_base, cfg.forward_retry_max,
            cfg.circuit_breaker_recovery) == (0.25, 3.0, 60.0)
    assert cfg.forward_wal and cfg.carryover_spool_dir == "spool"
    # the JAX package's defaults
    from veneur_tpu.config import Config as JConfig
    jcfg, tcfg = JConfig(), config_from_dict({})
    for key in ("forward_retry_max_attempts", "forward_retry_base",
                "forward_retry_max", "circuit_breaker_failure_threshold",
                "circuit_breaker_recovery", "carryover_max_intervals",
                "carryover_spool_dir", "carryover_spool_max_bytes",
                "carryover_spool_max_segments",
                "carryover_spool_quarantine_max_bytes",
                "carryover_spool_quarantine_max_segments", "forward_wal",
                "wal_stale_after_intervals", "wal_replay_rate_limit",
                "wal_replay_burst", "backfill_max_open_intervals"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key


@pytest.mark.parametrize("key", ["reshard_deadline", "reshard_spool_dir",
                                 "chaos_forward_fail_rate",
                                 "chaos_reshard_cutover_delay_s"])
def test_config_still_rejects_what_the_port_lacks(key):
    """An unknown key raises by name; the reshard keys, ported with the
    elastic reshard, read like the JAX package's Config."""
    if "reshard" not in key:
        with pytest.raises(ValueError, match=key):
            config_from_dict({key: 1})
        return
    from veneur_tpu.config import read_config as jread_config
    assert getattr(config_from_dict({key: 1}), key) == \
        getattr(jread_config(overrides={key: 1}), key)


@pytest.mark.parametrize("key,value", [("trace_store_traces", 16),
                                       ("chaos_ingest_drop_rate", 0.5)])
def test_config_reads_the_ingest_chaos_and_trace_keys(key, value):
    from veneur_tpu.config import Config as JConfig
    assert getattr(config_from_dict({}), key) == getattr(JConfig(), key)
    assert getattr(config_from_dict({key: value}), key) == value
