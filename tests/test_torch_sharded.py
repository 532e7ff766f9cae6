"""The port's sharded column store (core/sharded_tables.py,
parallel/collectives.py, parallel/sharded_server.py) against the JAX
package's, on the CPU.

The port's shards live on the store's device (here the CPU, 8 shards)
unless the store is given placement groups (four groups, all the CPU,
run the multi-card path: per-group applies, partial merges, copies);
the JAX package's run on the 8 virtual CPU devices that
tests/conftest.py sets up. The same numpy-seeded packets go through a
JAX sharded store, a port sharded store and a port single store.
Tolerances: counters, gauges, llhist registers and quantiles, HLL
registers bit for bit (against both); HLL estimates equal to the port's
single store and within rtol 1e-5 of the JAX package's (K2's float64
sum, tests/test_pallas.py:24); the sharded t-digest flush within rtol
2e-5 / atol 1e-4 of the JAX sharded flush (tests/test_pallas.py:97),
and within tests/test_sharded_store.py's slack of a single store.

Mirrors tests/test_sharded_store.py and test_mesh_plane.py's
TestDigestRouting, TestScalarShardExactness and
TestLLHistShardExactness, plus the routing function, K3 on the sharded
apply, the HBM ledger and the query and lifecycle paths."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from veneur_tpu.core.columnstore import ColumnStore as JStore
from veneur_tpu.core.deviceobs import DeviceObservatory as JObs
from veneur_tpu.parallel import collectives as jcoll
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu_torch.core.columnstore import (ColumnStore, CounterTable,
                                               GaugeTable, LLHistTable)
from veneur_tpu_torch.core.deviceobs import DeviceObservatory, nbytes_of
from veneur_tpu_torch.core.sharded_tables import (
    ShardedCounterTable, ShardedGaugeTable, ShardedHistoTable,
    ShardedLLHistTable, ShardedSetTable)
from veneur_tpu_torch.ops import batch_tdigest, llhist_apply, llhist_ref
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel.sharded_server import (ShardedServingPlane,
                                                      build_plane)
from veneur_tpu_torch.samplers.parser import Parser

N = 8  # conftest's virtual CPU devices
K1_TOL = dict(rtol=2e-5, atol=1e-4)
K2_RTOL = 1e-5


def pstore(shards=N, **kw):
    return ColumnStore(device="cpu", shard_devices=shards, **kw)


def jstore(shards=N, **kw):
    return JStore(shard_devices=shards, **kw)


def feed(store, packets, apply=True):
    parser = JParser() if isinstance(store, JStore) else Parser()
    for pkt in packets:
        parser.parse_metric_fast(pkt, store.process)
    if apply:
        store.apply_all_pending()


def stubs_of(packets, jax=False):
    parser = JParser() if jax else Parser()
    out = []
    for pkt in packets:
        parser.parse_metric_fast(pkt, out.append)
    return out


def row_of(table, stub):
    return table.rows[(stub.digest64 << 2) | int(stub.scope)]


def _mixed(seed, keys=37, rounds=300):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rounds):
        k = i % keys
        out.append(b"mx.c%d:%d|c|@0.5" % (k, rng.integers(1, 50)))
        out.append(b"mx.g%d:%.3f|g" % (k, rng.normal()))
        out.append(b"mx.t%d:%.3f|ms" % (k, rng.gamma(2, 10)))
        out.append(b"mx.l%d:%.3f|l" % (k, rng.lognormal(3, 1)))
        out.append(b"mx.s%d:m%d|s" % (k % 11, rng.integers(0, 500)))
    return out


# -------------------------------------------------------------------------
# the routing function
# -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 100, 128])
def test_home_shards_and_range_bounds_equal_jax(n):
    rng = np.random.default_rng(n)
    digests = np.concatenate([
        rng.integers(0, 2**63, 4096, dtype=np.uint64) * np.uint64(2)
        + rng.integers(0, 2, 4096, dtype=np.uint64),
        np.array([0, 2**64 - 1, 2**63, 2**32 - 1, 2**32], np.uint64)])
    got = collectives.home_shards(digests, n)
    np.testing.assert_array_equal(got, jcoll.home_shards(digests, n))
    assert got.dtype == np.int32
    assert collectives.range_bounds(n) == jcoll.range_bounds(n)
    # the plane's scalar home agrees with the vectorised one
    if n > 1:
        plane = ShardedServingPlane(n, torch.device("cpu"))
        assert [plane.home(int(d)) for d in digests[-5:]] == \
            got[-5:].tolist()
        np.testing.assert_array_equal(plane.homes(digests), got)
        assert got.min() >= 0 and got.max() < n
    # every bound is the smallest digest of its shard
    for i, b in enumerate(collectives.range_bounds(n)):
        assert (b * n) >> 64 == i
        if b:
            assert ((b - 1) * n) >> 64 == i - 1


# -------------------------------------------------------------------------
# placement: every family sharded on the store's device, no fallback
# -------------------------------------------------------------------------


def test_digest_routing_shards_all_five_families_on_the_store_device():
    store = pstore(4, counter_capacity=64, llhist_capacity=64,
                   batch_cap=32)
    plane = store.shard_plane
    assert plane is not None and plane.n == 4
    assert plane.describe() == {"shards": 4, "routing": "digest",
                                "devices": ["cpu:0"] * 4}
    for cls, table in ((ShardedCounterTable, store.counters),
                       (ShardedGaugeTable, store.gauges),
                       (ShardedHistoTable, store.histos),
                       (ShardedLLHistTable, store.llhists),
                       (ShardedSetTable, store.sets)):
        assert isinstance(table, cls)
        assert table._plane is plane
        for t in ([table.state] if table.state is not None
                  else table.states):
            for leaf in (t.values() if isinstance(t, dict) else [t]):
                assert leaf.device == torch.device("cpu")
    assert store.counters.state["sum"].shape == (4, 64)
    assert store.llhists.state.shape == (4, 64, llhist_apply.BINS_PAD)
    assert len(store.histos.states) == len(store.sets.states) == 4


@pytest.mark.parametrize("shards", [0, 1])
def test_zero_or_one_shard_is_a_single_store(shards):
    store = pstore(shards)
    assert store.shard_plane is None
    assert type(store.counters) is CounterTable


def test_plane_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="routing"):
        build_plane(4, "cpu", "modulo")
    with pytest.raises(ValueError, match="routing"):
        build_plane(1, "cpu", "modulo")
    with pytest.raises(ValueError, match="128"):
        ColumnStore(device="cpu", shard_devices=129)
    with pytest.raises(ValueError, match="shards"):
        ShardedCounterTable(torch.device("cpu"), 8, plane=ShardedServingPlane(
            2, torch.device("cuda", 0)))
    # a stacked table past K3's int32 rows raises before it allocates
    with pytest.raises(ValueError, match="int32"):
        collectives.check_flat_rows(128, 2**24)


# -------------------------------------------------------------------------
# tests/test_sharded_store.py, the port beside the JAX package
# -------------------------------------------------------------------------


def test_set_estimates_exact_across_shards():
    """HLL register max is associative: the sharded registers and
    estimate equal a single store's bit for bit, and the JAX sharded
    store's registers."""
    pkts = [b"sh.ex.set:m%d|s" % (i % 211) for i in range(300)]
    s1 = ColumnStore(device="cpu", set_capacity=64, batch_cap=32)
    s8 = pstore(set_capacity=64, batch_cap=32)
    j8 = jstore(set_capacity=64, batch_cap=32)
    for store in (s1, s8, j8):
        feed(store, pkts)
    est1, regs1, t1, _ = s1.sets.snapshot_and_reset()
    est8, regs8, t8, _ = s8.sets.snapshot_and_reset()
    jest, jregs, jt, _ = j8.sets.snapshot_and_reset()
    np.testing.assert_array_equal(t1, t8)
    np.testing.assert_array_equal(t8, jt)
    for row in np.flatnonzero(t1):
        np.testing.assert_array_equal(regs1[row], regs8[row])
        np.testing.assert_array_equal(regs8[row], jregs[row])
    np.testing.assert_array_equal(est1[t1], est8[t8])
    np.testing.assert_allclose(est8[t8], jest[jt], rtol=K2_RTOL)


def test_state_resets_between_intervals():
    store = pstore(4, histo_capacity=64, set_capacity=64, batch_cap=32)
    feed(store, [b"sh.r.t:%d|ms" % i for i in range(100)])
    out, _, touched, _ = store.histos.snapshot_and_reset(ps=(0.5,))
    row = int(np.nonzero(touched)[0][0])
    assert out["count"][row] == pytest.approx(100.0)
    out2, _, touched2, _ = store.histos.snapshot_and_reset(ps=(0.5,))
    assert not touched2.any()
    assert float(out2["count"][row]) == 0.0


def test_capacity_growth_while_sharded():
    store = pstore(4, histo_capacity=8, set_capacity=8, batch_cap=16)
    pkts = []
    for i in range(40):
        pkts += [b"grow.t.%d:5|ms" % i, b"grow.s.%d:x|s" % i]
    feed(store, pkts)
    out, _, touched, _ = store.histos.snapshot_and_reset(ps=(0.5,))
    assert int(touched.sum()) == 40
    np.testing.assert_allclose(out["count"][touched], 1.0)
    est, _, stouched, _ = store.sets.snapshot_and_reset()
    assert int(stouched.sum()) == 40
    np.testing.assert_allclose(est[stouched], 1.0, rtol=1e-2)
    assert store.histos.capacity >= 40 and store.sets.capacity >= 40
    assert all(st["wv"].shape[0] == store.histos.capacity
               for st in store.histos.states)
    assert store.histos._shard_of.shape[0] == store.histos.capacity


def test_roundrobin_shards_only_sketch_families():
    """Roundrobin keeps the scalar and llhist families single tables
    (rotation breaks gauge order) while histograms and sets shard, each
    whole batch on the next shard."""
    store = pstore(4, histo_capacity=64, set_capacity=64, batch_cap=32,
                   shard_routing="roundrobin")
    assert isinstance(store.histos, ShardedHistoTable)
    assert isinstance(store.sets, ShardedSetTable)
    assert type(store.counters) is CounterTable
    assert type(store.gauges) is GaugeTable
    assert type(store.llhists) is LLHistTable
    feed(store, [b"rr.t:%d|ms" % i for i in range(100)])
    # 100 samples in batches of 32: four batches over four shards
    counts = [float(st["lweight"].sum()) for st in store.histos.states]
    assert counts == [32.0, 32.0, 32.0, 4.0]
    out, _, touched, _ = store.histos.snapshot_and_reset(ps=(0.5,))
    row = int(np.nonzero(touched)[0][0])
    assert out["count"][row] == pytest.approx(100.0)
    j = jstore(4, histo_capacity=64, set_capacity=64, batch_cap=32,
               shard_routing="roundrobin")
    feed(j, [b"rr.t:%d|ms" % i for i in range(100)])
    jout, _, _, _ = j.histos.snapshot_and_reset((0.5,))
    np.testing.assert_allclose(out["quantiles"][row],
                               jout["quantiles"][row], **K1_TOL)


def _exp_packets(seed=17):
    rng = np.random.default_rng(seed)
    return [b"sh.exp.t%d:%.3f|ms" % (i % 29, rng.normal(100, 15))
            for i in range(600)]


@pytest.mark.parametrize("need_export", [False, True])
def test_sharded_tdigest_flush_equals_jax_and_conserves(need_export):
    """The sharded t-digest flush (concat + recompress over shards, K1's
    plain version) within K1's tolerance of the JAX sharded flush, and
    the export's mass and moments equal to a single store's (the
    test_sharded_store.py slack)."""
    pkts = _exp_packets()
    s1 = ColumnStore(device="cpu", histo_capacity=128, batch_cap=64)
    s8 = pstore(histo_capacity=128, batch_cap=64)
    j8 = jstore(histo_capacity=128, batch_cap=64)
    for store in (s1, s8, j8):
        feed(store, pkts)
    ps = (0.5, 0.9, 0.99)
    out1, exp1, t1, _ = s1.histos.snapshot_and_reset(
        ps=ps, need_export=need_export)
    out8, exp8, t8, _ = s8.histos.snapshot_and_reset(
        ps=ps, need_export=need_export)
    jout, jexp, jt, _ = j8.histos.snapshot_and_reset(
        ps, need_export=need_export)
    np.testing.assert_array_equal(t1, t8)
    np.testing.assert_array_equal(t8, jt)
    rows = np.flatnonzero(t8)
    for key in ("quantiles", "count", "sum", "min", "max", "hmean"):
        np.testing.assert_allclose(out8[key][rows], jout[key][rows],
                                   err_msg=key, **K1_TOL)
    for key in ("count", "min", "max"):
        np.testing.assert_array_equal(out8[key][rows], out1[key][rows])
    np.testing.assert_allclose(out8["quantiles"][rows],
                               out1["quantiles"][rows], rtol=0.05, atol=1.5)
    if not need_export:
        assert exp8 is None
        return
    m1, w1, min1, max1, r1 = exp1
    m8, w8, min8, max8, r8 = exp8
    np.testing.assert_allclose(w8[rows].sum(axis=-1),
                               w1[rows].sum(axis=-1), rtol=1e-5)
    np.testing.assert_allclose((m8[rows] * w8[rows]).sum(axis=-1),
                               (m1[rows] * w1[rows]).sum(axis=-1), rtol=1e-4)
    np.testing.assert_allclose(min8[rows], min1[rows], rtol=1e-6)
    np.testing.assert_allclose(max8[rows], max1[rows], rtol=1e-6)
    np.testing.assert_allclose(r8[rows], r1[rows], rtol=1e-5)
    jm, jw = jexp[0], jexp[1]
    np.testing.assert_allclose(w8[rows], jw[rows], **K1_TOL)
    np.testing.assert_allclose(m8[rows], jm[rows], **K1_TOL)


# -------------------------------------------------------------------------
# test_mesh_plane.py TestDigestRouting
# -------------------------------------------------------------------------


def test_home_assignment_stamped_at_mint():
    store = pstore(4, counter_capacity=64, llhist_capacity=64,
                   batch_cap=32)
    jst = jstore(4, counter_capacity=64, llhist_capacity=64, batch_cap=32)
    plane = store.shard_plane
    pkts = [b"mp.home.%d:1|c" % i for i in range(40)]
    for stub in stubs_of(pkts):
        store.counters.add(stub)
    for stub in stubs_of(pkts, jax=True):
        jst.counters.add(stub)
    table = store.counters
    for stub in stubs_of(pkts):
        assert table._shard_of[row_of(table, stub)] == plane.home(
            stub.digest64)
    np.testing.assert_array_equal(table._shard_of[:40],
                                  jst.counters._shard_of[:40])
    assert len(set(table._shard_of[:40].tolist())) == 4


def test_recycled_row_is_restamped():
    """A row that reclamation recycles for another key takes that key's
    home shard."""
    store = pstore(4, counter_capacity=16, batch_cap=8)
    first = stubs_of([b"rc.old.%d:1|c" % i for i in range(12)])
    for stub in first:
        store.counters.add(stub)
    for _ in range(3):
        store.counters.snapshot_and_reset()
        store.counters.reclaim_idle(1)
    freed = list(store.counters._free_rows)
    assert freed
    new = stubs_of([b"rc.new.%d:1|c" % i for i in range(len(freed))])
    for stub in new:
        store.counters.add(stub)
        row = row_of(store.counters, stub)
        assert row in freed
        assert store.counters._shard_of[row] == \
            store.shard_plane.home(stub.digest64)
    vals, touched, meta = store.counters.snapshot_and_reset()
    assert {meta[r].name for r in np.flatnonzero(touched)} == \
        {s.key.name for s in new}
    np.testing.assert_array_equal(vals[touched], 1.0)


def test_llhist_state_partitioned_by_home():
    store = pstore(4, llhist_capacity=64, batch_cap=16)
    jst = jstore(4, llhist_capacity=64, batch_cap=16)
    pkts = [b"mp.part.%d:%d|l" % (i, i + 1) for i in range(30)]
    feed(store, pkts)
    feed(jst, pkts)
    table = store.llhists
    state = table.state.numpy()  # (4, K, BINS_PAD)
    per_shard_mass = state.sum(axis=2)
    for row in range(30):
        nz = np.flatnonzero(per_shard_mass[:, row])
        assert nz.tolist() == [int(table._shard_of[row])]
    np.testing.assert_array_equal(state, np.asarray(jst.llhists.state))


def test_mesh_telemetry_rows_equal_jax():
    store = pstore(2, counter_capacity=64, batch_cap=16)
    jst = jstore(2, counter_capacity=64, batch_cap=16)
    pkts = [b"mp.tel.%d:1|c" % i for i in range(8)]
    feed(store, pkts)
    feed(jst, pkts)

    def mesh_rows(s):
        return sorted((name, kind, value, tuple(tags))
                      for name, kind, value, tags in s.telemetry_rows()
                      if name.startswith(("mesh.", "shard.")))
    got = mesh_rows(store)
    assert got == mesh_rows(jst)
    rows = {name: value for name, _kind, value, _tags in got}
    assert rows["mesh.shards"] == 2.0
    assert rows["mesh.batches_dispatched"] >= 1
    assert sum(v for name, _k, v, _t in got
               if name == "shard.samples_routed") == 8


# -------------------------------------------------------------------------
# test_mesh_plane.py TestScalarShardExactness
# -------------------------------------------------------------------------


def test_counters_bit_identical():
    rng = np.random.default_rng(5)
    pkts = [b"mp.c.%d:%.4f|c|@0.5" % (i % 20, rng.random() * 50)
            for i in range(60) for _ in range(6)]
    merge = [b"mp.c.%d:1|c" % i for i in range(20)]
    stores = (ColumnStore(device="cpu", counter_capacity=128, batch_cap=32),
              pstore(4, counter_capacity=128, batch_cap=32),
              jstore(4, counter_capacity=128, batch_cap=32))
    outs = []
    for i, store in enumerate(stores):
        feed(store, pkts, apply=False)
        stubs = stubs_of(merge, jax=i == 2)
        store.counters.merge_batch(stubs, [7.0] * len(stubs))
        store.apply_all_pending()
        outs.append(store.counters.snapshot_and_reset())
    (v1, t1, _), (v4, t4, _), (jv, jt, _) = outs
    np.testing.assert_array_equal(t1, t4)
    np.testing.assert_array_equal(v1[t1], v4[t4])
    np.testing.assert_array_equal(v4[t4], jv[jt])


def test_gauges_last_write_wins_across_dispatches():
    pkts = [b"mp.g.%d:%d|g" % (key, step * 10 + key)
            for step in range(50) for key in range(10)]
    stores = (ColumnStore(device="cpu", gauge_capacity=64, batch_cap=8),
              pstore(4, gauge_capacity=64, batch_cap=8),
              jstore(4, gauge_capacity=64, batch_cap=8))
    outs = []
    for store in stores:
        feed(store, pkts)
        outs.append(store.gauges.snapshot_and_reset())
    (v1, t1, _), (v4, t4, _), (jv, jt, _) = outs
    np.testing.assert_array_equal(t1, t4)
    np.testing.assert_array_equal(v1[t1], v4[t4])
    np.testing.assert_array_equal(v4[t4], jv[jt])


def test_gauge_import_merge_routed_to_home():
    s4 = pstore(4, gauge_capacity=64, batch_cap=8)
    j4 = jstore(4, gauge_capacity=64, batch_cap=8)
    pkts = [b"mp.gi.%d:0|g" % i for i in range(12)]
    vals = [float(i * 3) for i in range(12)]
    s4.gauges.merge_batch(stubs_of(pkts), vals)
    j4.gauges.merge_batch(stubs_of(pkts, jax=True), vals)
    # each value sits on its row's home shard only
    state = s4.gauges.state["value"].numpy()
    for i, stub in enumerate(stubs_of(pkts)):
        row = row_of(s4.gauges, stub)
        home = int(s4.gauges._shard_of[row])
        assert state[home, row] == vals[i]
        assert np.count_nonzero(state[:, row]) == (1 if vals[i] else 0)
    np.testing.assert_array_equal(state, np.asarray(
        j4.gauges.state["value"]))
    v4, t4, _ = s4.gauges.snapshot_and_reset()
    got = {i: v4[row_of(s4.gauges, stub)]
           for i, stub in enumerate(stubs_of(pkts))}
    assert got == {i: i * 3.0 for i in range(12)}


# -------------------------------------------------------------------------
# test_mesh_plane.py TestLLHistShardExactness
# -------------------------------------------------------------------------


def _feed_llhist(store):
    jax = isinstance(store, JStore)
    rng = np.random.default_rng(11)
    pkts = [b"mp.ll.%d:%.4f|l" % (i, v)
            for i in range(25) for v in rng.lognormal(3, 1, 6)]
    feed(store, pkts, apply=False)
    rows = [store.llhists.intern(stub) for stub in stubs_of(
        [b"mp.ll.%d:1|l" % i for i in range(25)], jax=jax)]
    vals = rng.lognormal(3, 1, len(rows)).astype(np.float32)
    store.llhists.add_batch(np.asarray(rows, np.int32), vals,
                            np.ones(len(rows), np.float32))
    stubs = stubs_of([b"mp.ll.%d:1|l" % i for i in range(25)], jax=jax)
    bins = np.zeros((len(stubs), llhist_ref.BINS), np.int64)
    bins[:, llhist_ref.bin_index(np.full(len(stubs), 42.0))] = 5
    store.llhists.merge_batch(stubs, bins)
    store.apply_all_pending()


def test_llhist_registers_and_quantiles_bit_identical():
    stores = (ColumnStore(device="cpu", llhist_capacity=64, batch_cap=32),
              pstore(4, llhist_capacity=64, batch_cap=32),
              jstore(4, llhist_capacity=64, batch_cap=32))
    for store in stores:
        _feed_llhist(store)
    np.testing.assert_array_equal(stores[1].llhists.state.numpy(),
                                  np.asarray(stores[2].llhists.state))
    ps = (0.5, 0.9, 0.99)
    (o1, b1, t1, _), (o4, b4, t4, _) = (
        s.llhists.snapshot_and_reset(ps=ps) for s in stores[:2])
    jo, jb, jt, _ = stores[2].llhists.snapshot_and_reset(ps)
    np.testing.assert_array_equal(t1, t4)
    np.testing.assert_array_equal(t4, jt)
    np.testing.assert_array_equal(b1, b4)
    rows = np.flatnonzero(jt)
    # the port's readout is compact (touched rows in order), the JAX
    # package's spans every row
    np.testing.assert_array_equal(b4, jb[rows])
    for key in ("count", "quantiles"):
        np.testing.assert_array_equal(o1[key], o4[key])
        np.testing.assert_array_equal(o4[key], np.asarray(jo[key])[rows])


def test_llhist_capacity_growth_while_sharded():
    store = pstore(4, llhist_capacity=8, batch_cap=16)
    feed(store, [b"mp.grow.%d:5|l" % i for i in range(40)])
    out, bins, touched, _ = store.llhists.snapshot_and_reset(ps=(0.5,))
    assert int(touched.sum()) == 40
    assert bins.sum() == 40
    assert store.llhists.capacity >= 40
    assert store.llhists.state.shape[:2] == (4, store.llhists.capacity)


def test_sharded_llhist_apply_is_one_k3_call_per_block(monkeypatch):
    """The sharded llhist apply goes through K3's wrapper once per
    pack()ed block, on the flat (n*K, BINS_PAD) view, and the stacked
    registers equal the JAX package's vmapped scatter over its masked,
    tiled batches."""
    calls = []
    real = llhist_apply.apply

    def counting(regs, rows, bins, wts):
        calls.append((tuple(regs.shape), int(rows.shape[0])))
        return real(regs, rows, bins, wts)

    monkeypatch.setattr(llhist_apply, "apply", counting)
    cap, batch_cap = 64, 256
    store = pstore(4, llhist_capacity=cap, batch_cap=batch_cap)
    jst = jstore(4, llhist_capacity=cap, batch_cap=batch_cap)
    rng = np.random.default_rng(3)
    pkts = [b"k3.%d:%.3f|l" % (i % 50, v)
            for i, v in enumerate(rng.lognormal(2, 1.5, 1000))]
    for store_ in (store, jst):
        rows = [store_.llhists.intern(s) for s in stubs_of(
            pkts, jax=store_ is jst)]
        vals = np.asarray([float(p.split(b":")[1].split(b"|")[0])
                           for p in pkts], np.float32)
        store_.llhists.add_batch(np.asarray(rows, np.int32), vals,
                                 np.ones(len(rows), np.float32))
    # 1000 samples: one whole-chunk launch of 768 and 232 pending
    assert calls == [((4 * cap, llhist_apply.BINS_PAD), 768)]
    store.apply_all_pending()
    jst.apply_all_pending()
    assert len(calls) == 2 and calls[1][1] == 232
    np.testing.assert_array_equal(store.llhists.state.numpy(),
                                  np.asarray(jst.llhists.state))
    routed = store.shard_plane._samples["llhist"]
    assert int(routed.sum()) == 1000
    np.testing.assert_array_equal(routed, jst.shard_plane._samples["llhist"])


# -------------------------------------------------------------------------
# the HBM ledger, the kernel registry and the shard balance
# -------------------------------------------------------------------------


def _walk(store, inflight=()):
    total = sum(nbytes_of(t._devobs_state()) + nbytes_of(t._spare)
                for _family, t in store.tables())
    return total + sum(nbytes_of(s) for s in inflight)


def _family_bytes(obs):
    return {family: {s: n for s, n in states.items() if n}
            for family, states in obs.ledger()["by_family"].items()}


def test_ledger_books_the_shards_like_jax():
    """The stacked tensors and the per-shard lists are booked through
    swap, readout, recycle and resize: the port's total equals its own
    tensor walk and the JAX ledger's, family by family."""
    from veneur_tpu_torch.core.flusher import (readout_columnstore,
                                               swap_columnstore)
    from veneur_tpu_torch.samplers.metrics import HistogramAggregates
    from veneur_tpu.core.flusher import (readout_columnstore as jreadout,
                                         swap_columnstore as jswap)
    from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
    caps = dict(counter_capacity=16, gauge_capacity=16, histo_capacity=16,
                set_capacity=16, llhist_capacity=16, batch_cap=64)
    store, jst = pstore(4, **caps), jstore(4, **caps)
    obs, jobs = DeviceObservatory(), JObs()
    store.attach_deviceobs(obs)
    jst.attach_deviceobs(jobs)

    def same(inflight=()):
        assert obs.total_bytes() == _walk(store, inflight)
        assert _family_bytes(obs) == _family_bytes(jobs)
        assert obs.total_bytes() == jobs.total_bytes()

    same()
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    jaggs = JAggs.from_names(["min", "max", "count"])
    for round_no in range(3):
        # round 1 grows every table past its capacity
        pkts = _mixed(round_no, keys=12 + 10 * round_no, rounds=80)
        feed(store, pkts)
        feed(jst, pkts)
        same()
        swap = swap_columnstore(store, True, (0.5,))
        jsw = jswap(jst, True, (0.5,))
        inflight = [swap[f]["state"] for f in ("histogram", "llhist",
                                               "counter", "gauge", "set")
                    if "state" in swap[f]]
        same(inflight)
        readout_columnstore(store, swap, True, aggs)
        jreadout(jst, jsw, True, jaggs)
        same()
    kinds = {(r["kind"], r["family"]) for r in obs.kernel_report()["kernels"]}
    jkinds = {(r["kind"], r["family"])
              for r in jobs.kernel_report()["kernels"]}
    for family in ("counter", "gauge", "llhist", "histogram", "set"):
        assert ("merge", family) in kinds
        assert ("merge", family) in jkinds
    # the stacked families' merge zeroes them: no separate reset
    assert {k for k in kinds if k[0] == "reset"} == \
        {k for k in jkinds if k[0] == "reset"}


def _skewed_packets(n_shards, shard, count, salt):
    out, i = [], 0
    while len(out) < count:
        pkt = b"%s.%d:1|c" % (salt.encode(), i)
        stub = stubs_of([pkt])[0]
        if (stub.digest64 * n_shards) >> 64 == shard:
            out.append(pkt)
        i += 1
    return out


def test_shard_balance_equals_jax():
    """shard_balance() on every key the JAX package reports, its reshard
    plan included (the port's candidate range set to the JAX package's
    device count), and shard_skew(), on a skewed key space."""
    pkts = (_skewed_packets(4, 0, 120, "hot") + _skewed_packets(4, 2, 6, "cold")
            + _mixed(9, keys=20, rounds=40))
    caps = dict(counter_capacity=64, gauge_capacity=64, histo_capacity=64,
                set_capacity=32, llhist_capacity=64, batch_cap=64)
    store, jst = pstore(4, **caps), jstore(4, **caps)
    obs, jobs = DeviceObservatory(), JObs()
    obs.reshard_plan_max_shards = len(jax.devices())
    store.attach_deviceobs(obs)
    jst.attach_deviceobs(jobs)
    feed(store, pkts)
    feed(jst, pkts)
    got, want = obs.shard_balance(), jobs.shard_balance()
    assert got["reshard_plan"]["from_shards"] == 4
    assert got == want
    assert got["hot_shards"] == [0]
    assert obs.shard_skew() == jobs.shard_skew() == got["skew"]
    rows = {r[0]: r[2] for r in obs.telemetry_rows()}
    assert rows["device.shard.skew"] == got["skew"]
    assert obs.report()["shard_balance"] == got


# -------------------------------------------------------------------------
# the query plane, prewarm and the table lifecycle on sharded tables
# -------------------------------------------------------------------------


def test_capture_readonly_equals_the_next_flush():
    """A live query's merge (which zeroes nothing) reads what the next
    flush's merge reads, bit for bit, and leaves the live shards whole."""
    caps = dict(counter_capacity=32, gauge_capacity=32, histo_capacity=32,
                set_capacity=16, llhist_capacity=32, batch_cap=64)
    store = pstore(4, **caps)
    feed(store, _mixed(4, keys=20, rounds=120), apply=False)
    ps = (0.5, 0.99)
    caps_ = {
        "counter": store.counters.capture_readonly(),
        "gauge": store.gauges.capture_readonly(),
        "histogram": store.histos.capture_readonly(ps=ps,
                                                   need_export=False),
        "llhist": store.llhists.capture_readonly(ps=ps, need_bins=True),
        "set": store.sets.capture_readonly(),
    }
    q = {f: getattr(store, t).snapshot_finish(caps_[f]) for f, t in (
        ("counter", "counters"), ("gauge", "gauges"),
        ("histogram", "histos"), ("llhist", "llhists"), ("set", "sets"))}
    live_llhist = store.llhists.state.clone()
    store.apply_all_pending()
    assert torch.equal(store.llhists.state, live_llhist)
    f = {"counter": store.counters.snapshot_and_reset(),
         "gauge": store.gauges.snapshot_and_reset(),
         "histogram": store.histos.snapshot_and_reset(ps=ps),
         "llhist": store.llhists.snapshot_and_reset(ps=ps),
         "set": store.sets.snapshot_and_reset()}
    for fam in ("counter", "gauge"):
        t = f[fam][1]
        np.testing.assert_array_equal(q[fam][0][t], f[fam][0][t])
    t = f["histogram"][2]
    for key in ("quantiles", "count", "min", "max"):
        np.testing.assert_array_equal(q["histogram"][0][key][t],
                                      f["histogram"][0][key][t])
    np.testing.assert_array_equal(q["llhist"][1], f["llhist"][1])
    np.testing.assert_array_equal(q["llhist"][0]["quantiles"],
                                  f["llhist"][0]["quantiles"])
    t = f["set"][2]
    np.testing.assert_array_equal(q["set"][0][t], f["set"][0][t])


@pytest.mark.parametrize("family", ["counter", "gauge", "histogram",
                                    "llhist", "set"])
def test_prewarm_rung_touches_no_live_state(family):
    store = pstore(4, counter_capacity=16, gauge_capacity=16,
                   histo_capacity=16, set_capacity=16, llhist_capacity=16,
                   batch_cap=32)
    obs = DeviceObservatory()
    store.attach_deviceobs(obs)
    feed(store, _mixed(2, keys=8, rounds=40))
    table = dict(store.tables())[family]
    before = obs.total_bytes()
    routed = {f: a.copy() for f, a in store.shard_plane._samples.items()}
    assert table.prewarm_rung(64, (0.5,)) is True
    assert 64 in table._prewarmed_caps
    assert obs.total_bytes() == before == _walk(store)
    for f, a in store.shard_plane._samples.items():
        np.testing.assert_array_equal(a, routed[f])
    assert table.capacity == 16


def test_row_cap_and_reclamation_on_sharded_tables():
    store = pstore(4, counter_capacity=16, batch_cap=8, max_rows=10)
    feed(store, [b"cap.%d:2|c" % i for i in range(14)])
    vals, touched, _ = store.counters.snapshot_and_reset()
    assert int(touched.sum()) == 10
    np.testing.assert_array_equal(vals[touched], 2.0)
    assert store.counters.keys_dropped == 4
    for _ in range(3):
        store.counters.snapshot_and_reset()
        store.counters.reclaim_idle(1)
    assert store.counters.recycled_total == 10
    feed(store, [b"cap.new.%d:3|c" % i for i in range(10)])
    vals, touched, meta = store.counters.snapshot_and_reset()
    assert int(touched.sum()) == 10
    np.testing.assert_array_equal(vals[touched], 3.0)
    for row in np.flatnonzero(touched):
        stub = stubs_of([b"%s:1|c" % meta[row].name.encode()])[0]
        assert store.counters._shard_of[row] == \
            store.shard_plane.home(stub.digest64)


# -------------------------------------------------------------------------
# shards over several devices: placement groups (four groups, all the CPU,
# run the per-group applies, the partial merges and the copies here)
# -------------------------------------------------------------------------

GROUPS = [torch.device("cpu")] * 4


def gstore(shards=4, groups=GROUPS, **kw):
    return ColumnStore(device="cpu", shard_devices=shards,
                       shard_groups=groups, **kw)


def _group_corpus(seed):
    """Mixed traffic with enough keys to grow every table past its
    capacity."""
    return _mixed(seed, keys=24, rounds=150)


def _imports(store, seed):
    """One import merge of every family, each stub's row on its home
    shard."""
    rng = np.random.default_rng(seed)
    c = stubs_of([b"gi.c.%d:1|c" % i for i in range(9)])
    store.counters.merge_batch(c, [float(i + 1) for i in range(9)])
    g = stubs_of([b"gi.g.%d:1|g" % i for i in range(9)])
    store.gauges.merge_batch(g, [float(i) * 1.5 for i in range(9)])
    ll = stubs_of([b"gi.l.%d:1|l" % i for i in range(9)])
    bins = np.zeros((len(ll), llhist_ref.BINS), np.int64)
    bins[:, llhist_ref.bin_index(np.full(len(ll), 7.0))] = 3
    store.llhists.merge_batch(ll, bins)
    s = stubs_of([b"gi.s.%d:1|s" % i for i in range(5)])
    regs = rng.integers(0, 6, (len(s), 16384)).astype(np.int8)
    store.sets.merge_batch(s, regs)
    h = stubs_of([b"gi.h.%d:1|ms" % i for i in range(5)])
    means = [np.sort(rng.normal(50, 9, 12)) for _ in h]
    pm, pw = batch_tdigest.pack_centroids_many(
        means, [np.ones(12) for _ in h])
    store.histos.merge_batch(h, pm, pw, [float(m.min()) for m in means],
                             [float(m.max()) for m in means],
                             [float((1 / m).sum()) for m in means])


_FAMILY_TABLE = {"counter": "counters", "gauge": "gauges",
                 "histogram": "histos", "llhist": "llhists", "set": "sets"}
PS = (0.5, 0.99)


def _flush(table, family):
    if family in ("histogram", "llhist"):
        return table.snapshot_and_reset(ps=PS)
    return table.snapshot_and_reset()


def _assert_family_equal(family, got, want, exact=True):
    """One family's flush (or capture) of two stores, keyed by metric
    name (row numbers may differ between stores that grew apart)."""
    def by_name(out):
        meta = out[-1]
        touched = out[-2]
        return {meta[r].name + "|" + ",".join(meta[r].tags): r
                for r in np.flatnonzero(touched)}
    ga, wa = by_name(got), by_name(want)
    assert set(ga) == set(wa)
    order_g = [ga[k] for k in sorted(ga)]
    order_w = [wa[k] for k in sorted(wa)]
    if family in ("counter", "gauge"):
        np.testing.assert_array_equal(got[0][order_g], want[0][order_w])
    elif family == "set":
        np.testing.assert_array_equal(got[0][order_g], want[0][order_w])
        if got[1] is not None and want[1] is not None:  # a flush's
            for rg, rw in zip(order_g, order_w):
                np.testing.assert_array_equal(got[1][rg], want[1][rw])
    elif family == "llhist":
        # compact readouts: index by the position among touched rows
        pos_g = {r: i for i, r in enumerate(np.flatnonzero(got[2]))}
        pos_w = {r: i for i, r in enumerate(np.flatnonzero(want[2]))}
        ig = [pos_g[r] for r in order_g]
        iw = [pos_w[r] for r in order_w]
        np.testing.assert_array_equal(got[1][ig], want[1][iw])
        for key in ("count", "quantiles"):
            np.testing.assert_array_equal(got[0][key][ig],
                                          want[0][key][iw])
    else:
        for key in ("quantiles", "count", "sum", "min", "max"):
            if exact:
                np.testing.assert_allclose(got[0][key][order_g],
                                           want[0][key][order_w],
                                           rtol=1e-6, err_msg=key)
            else:
                np.testing.assert_allclose(
                    got[0][key][order_g], want[0][key][order_w],
                    rtol=0.05, atol=1.5, err_msg=key)


@pytest.mark.parametrize("family", ["counter", "gauge", "histogram",
                                    "llhist", "set"])
def test_four_groups_equal_one_group_and_a_single_store(family):
    """A 4-shard store over four placement groups, a 4-shard store on
    one device and a single store take the same traffic and import
    merges over two intervals, growing past their capacities: the live
    query's capture and both flushes agree, counters, gauges, llhist
    and HLL registers bit for bit, the t-digest rows of the two sharded
    stores within rtol 1e-6 (the single store's within the sharded
    slack)."""
    caps = dict(counter_capacity=16, gauge_capacity=16, histo_capacity=16,
                set_capacity=8, llhist_capacity=16, batch_cap=64)
    stores = (gstore(**caps), pstore(4, **caps),
              ColumnStore(device="cpu", **caps))
    attr = _FAMILY_TABLE[family]
    for interval in range(2):
        for store in stores:
            feed(store, _group_corpus(interval), apply=False)
            _imports(store, interval)
        kw = {"ps": PS} if family in ("histogram", "llhist") else {}
        if family == "histogram":
            kw["need_export"] = False
        if family == "llhist":
            kw["need_bins"] = True
        caps_ = [getattr(s, attr).snapshot_finish(
            getattr(s, attr).capture_readonly(**kw)) for s in stores]
        flushed = [_flush(getattr(s, attr), family) for s in stores]
        for outs in (caps_, flushed):
            _assert_family_equal(family, outs[0], outs[1])
            _assert_family_equal(family, outs[0], outs[2],
                                 exact=family != "histogram")
    # the traffic grew the grouped table past its first capacity
    start = caps["histo_capacity" if family == "histogram"
                 else f"{family}_capacity"]
    assert getattr(stores[0], attr).capacity > start


def test_groups_place_the_shards_and_keep_recycled_spares_in_place():
    """Shard i lives in group i mod G: a stacked family holds one
    (n_j, K, ...) state per group on the group's device, a per-shard
    family each shard's state on its shard's device, and the spare a
    flush recycles keeps that placement round after round (the JAX
    pin tests/test_mesh_plane.py:267-306)."""
    groups = [torch.device("cpu")] * 3
    store = gstore(shards=7, groups=groups, counter_capacity=16,
                   gauge_capacity=16, histo_capacity=16, set_capacity=8,
                   llhist_capacity=16, batch_cap=32)
    plane = store.shard_plane
    assert plane.group_shards == [[0, 3, 6], [1, 4], [2, 5]]
    assert plane.describe()["devices"] == ["cpu:0"] * 7

    def check():
        for table in (store.counters, store.gauges, store.llhists):
            states = collectives.groups_of(table.state)
            assert len(states) == 3
            for st, shards, dev in zip(states, plane.group_shards, groups):
                leaves = st.values() if isinstance(st, dict) else [st]
                for leaf in leaves:
                    assert leaf.shape[:2] == (len(shards), table.capacity)
                    assert leaf.device == dev
        for table in (store.histos, store.sets):
            for gen in (table.states, table._spare):
                if gen is None:
                    continue
                assert len(gen) == 7
                for st, dev in zip(gen, plane.devices):
                    leaf = st["wv"] if isinstance(st, dict) else st
                    assert leaf.device == dev

    for rnd in range(4):
        feed(store, _mixed(rnd, keys=6, rounds=20))
        for family, attr in _FAMILY_TABLE.items():
            _flush(getattr(store, attr), family)
        check()
    # the recycled generations are parked, placed like the live ones
    assert len(collectives.groups_of(store.counters._spare)) == 3
    assert store.histos._spare is not None
    check()


def test_k3_is_called_once_per_block_per_group(monkeypatch):
    """The grouped llhist apply cuts each pack()ed block by group: one
    K3 call per block and group, on that group's (n_j*K, BINS_PAD) flat
    view, and the registers equal the one-group store's."""
    calls = []
    real = llhist_apply.apply

    def counting(regs, rows, bins, wts):
        calls.append((tuple(regs.shape), int((rows >= 0).sum())))
        return real(regs, rows, bins, wts)

    monkeypatch.setattr(llhist_apply, "apply", counting)
    cap, batch_cap = 64, 256
    stores = (gstore(llhist_capacity=cap, batch_cap=batch_cap),
              pstore(4, llhist_capacity=cap, batch_cap=batch_cap))
    rng = np.random.default_rng(3)
    pkts = [b"k3.%d:%.3f|l" % (i % 50, v)
            for i, v in enumerate(rng.lognormal(2, 1.5, 1000))]
    vals = np.asarray([float(p.split(b":")[1].split(b"|")[0])
                       for p in pkts], np.float32)
    for store in stores:
        rows = [store.llhists.intern(s) for s in stubs_of(pkts)]
        store.llhists.add_batch(np.asarray(rows, np.int32), vals,
                                np.ones(len(rows), np.float32))
    # one whole-chunk block of 768: four calls on the groups' (1*K)
    # views, then one on the one-group store's (4*K) view
    assert [c[0] for c in calls] == [(cap, llhist_apply.BINS_PAD)] * 4 \
        + [(4 * cap, llhist_apply.BINS_PAD)]
    assert sum(c[1] for c in calls[:4]) == calls[4][1] == 768
    del calls[:]
    for store in stores:
        store.apply_all_pending()
    assert len(calls) == 5
    grouped = torch.cat(collectives.groups_of(stores[0].llhists.state))
    # group j holds shard j: the groups' concatenation is the stack
    np.testing.assert_array_equal(grouped.numpy(),
                                  stores[1].llhists.state.numpy())


def test_ledger_books_each_group_s_bytes_on_its_device():
    """The HBM ledger books a grouped store through swap, readout,
    recycle and growth: its total and its per-device split equal the
    tensors' walk, and equal the one-group store's."""
    from veneur_tpu_torch.core.deviceobs import bytes_by_device
    caps = dict(counter_capacity=16, gauge_capacity=16, histo_capacity=16,
                set_capacity=16, llhist_capacity=16, batch_cap=64)
    stores = (gstore(**caps), pstore(4, **caps))
    obses = (DeviceObservatory(), DeviceObservatory())
    for store, obs in zip(stores, obses):
        store.attach_deviceobs(obs)

    def walk_by_device(store):
        out = {}
        for _family, t in store.tables():
            for tree in (t._devobs_state(), t._spare):
                for dev, n in bytes_by_device(tree).items():
                    out[dev] = out.get(dev, 0) + n
        return out

    for rnd in range(3):
        for store, obs in zip(stores, obses):
            feed(store, _mixed(rnd, keys=12 + 10 * rnd, rounds=60))
            for family, attr in _FAMILY_TABLE.items():
                _flush(getattr(store, attr), family)
            assert obs.total_bytes() == _walk(store)
            assert obs.ledger()["by_device"] == walk_by_device(store)
        assert obses[0].total_bytes() == obses[1].total_bytes()
    assert set(obses[0].ledger()["by_device"]) == {"cpu:0"}
