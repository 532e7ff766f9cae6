"""One packet corpus through a veneur_tpu ColumnStore and a
veneur_tpu_torch ColumnStore(device="cpu"), each flushed with its own
flush_columnstore_batch: the flushed series must agree."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu.core.columnstore import ColumnStore as JStore
from veneur_tpu.core.flusher import flush_columnstore_batch as jflush
from veneur_tpu.samplers.metrics import HistogramAggregates as JAggs
from veneur_tpu.samplers.parser import Parser as JParser
from veneur_tpu_torch import convert
from veneur_tpu_torch.core.columnstore import ColumnStore as TStore
from veneur_tpu_torch.core.flusher import flush_columnstore_batch as tflush
from veneur_tpu_torch.samplers.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.samplers.metrics import MetricKey, UDPMetric
from veneur_tpu_torch.samplers.parser import Parser as TParser

PS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "avg", "sum", "median", "hmean"]
TOL = dict(rtol=2e-5, atol=1e-4)
# small capacities and batches: rows grow past capacity, batches dispatch
# mid-interval, and set keys with >= 4 samples take the dense path
SIZES = dict(counter_capacity=8, gauge_capacity=8, histo_capacity=8,
             set_capacity=8, batch_cap=64, set_promote_samples=4)


def _corpus(seed, num_keys=40):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(num_keys):
        for _ in range(int(rng.integers(1, 5))):
            lines.append(f"c{i}:{rng.integers(1, 100)}|c|@0.5|#t:{i % 3}")
        lines.append(f"g{i}:{rng.normal():.4f}|g")
        for _ in range(int(rng.integers(1, 300))):
            lines.append(f"t{i}:{rng.gamma(2, 10):.3f}|ms|#t:{i % 2}")
        for j in range(int(rng.integers(1, 40))):
            lines.append(f"s{i}:m{j}|s")
    lines += ["t_local:5|h|#veneurlocalonly", "t_local:9|h|#veneurlocalonly",
              "t_glob:7|h|#veneurglobalonly", "c_glob:3|c|#veneurglobalonly",
              "t_zero:0|ms", "_sc|svc.ok|0|m:all good"]
    order = rng.permutation(len(lines))
    return [lines[i].encode() for i in order]


def _feed(store, parser, lines):
    for line in lines:
        if line.startswith(b"_sc"):
            store.process(parser.parse_service_check(line))
        else:
            parser.parse_metric_fast(line, store.process)


def _series(batch):
    return {(m.name, tuple(m.tags), m.type.name): m.value
            for m in batch.materialize()}


def _assert_flushes_agree(jbatch, tbatch):
    want, got = _series(jbatch), _series(tbatch)
    assert set(got) == set(want)
    for key, value in want.items():
        tvalue = got[key]
        name = key[0]
        if name.startswith(("c", "g", "s", "svc")) and "." not in name[1:]:
            assert tvalue == value, key  # counters, gauges, sets: exact
        else:
            np.testing.assert_allclose(tvalue, value, err_msg=str(key),
                                       equal_nan=True, **TOL)


def _stores():
    return JStore(**SIZES), TStore(device="cpu", **SIZES)


def test_two_intervals_flush_like_jax():
    jstore, tstore = _stores()
    jparser, tparser = JParser(), TParser()
    for seed in (0, 1):  # the second interval runs on recycled spares
        lines = _corpus(seed)
        _feed(jstore, jparser, lines)
        _feed(tstore, tparser, lines)
        jbatch, _ = jflush(jstore, False, PS, JAggs.from_names(AGGS))
        tbatch, _ = tflush(tstore, False, PS, TAggs.from_names(AGGS))
        _assert_flushes_agree(jbatch, tbatch)
        assert len(tbatch) == len(jbatch)
    assert tstore.sets._dev_cap > 8  # the dense bank climbed its ladder
    assert tstore.counters.capacity > 8  # rows outgrew the capacity


def test_llhist_samples_are_counted_not_lost_silently():
    """`|l` samples land in the llhist family (and, under circllhist,
    timers too); a wire type no family takes is counted apart and not as
    processed."""
    tstore = TStore(device="cpu", histogram_encoding="circllhist", **SIZES)
    parser = TParser()
    for line in (b"ll:3|l", b"ll:4|l", b"c:1|c", b"t:5|ms"):
        parser.parse_metric_fast(line, tstore.process)
    tstore.process(UDPMetric(key=MetricKey("odd", "unknown-type")))
    assert tstore.unknown_rejected == 1
    assert tstore.processed == 4
    assert int(tstore.counters.touched.sum()) == 1
    assert int(tstore.llhists.touched.sum()) == 2  # ll and t
    assert not tstore.histos.touched.any()
    _out, bins, touched, _meta = tstore.llhists.snapshot_and_reset(
        ps=(0.5,))
    assert bins.sum() == 3 and touched.sum() == 2


def test_histogram_encoding_is_checked():
    with pytest.raises(ValueError, match="histogram_encoding"):
        TStore(device="cpu", histogram_encoding="hdr")


def test_llhist_table_snapshot_matches_jax():
    """Per-sample adds, value batches and pre-binned batches through both
    tables, over several buffer dispatches: the same touched rows, bins
    and clamp accounting, and percentiles at float32 precision."""
    sizes = dict(SIZES, llhist_capacity=4)
    jstore, tstore = JStore(**sizes), TStore(device="cpu", **sizes)
    rng = np.random.default_rng(9)
    lines = [f"l{k}:{v:.5g}|l|@0.5".encode() for k in range(10)
             for v in rng.lognormal(0, 6, 30) * rng.choice([-1, 1], 30)]
    _feed(jstore, JParser(), lines)
    _feed(tstore, TParser(), lines)
    rows = rng.integers(0, 10, 500).astype(np.int32)
    vals = rng.lognormal(0, 3, 500)
    wts = 1.0 / rng.choice([1.0, 0.5, 0.1], 500)
    bins = rng.integers(0, 4501, 500).astype(np.int32)
    for store in (jstore, tstore):
        store.llhists.add_batch(rows, vals, wts)
        store.llhists.add_batch_binned(rows, bins, np.ones(500, np.int32),
                                       clamped=3)
    jout, jbins, jtouched, _ = jstore.llhists.snapshot_and_reset(PS)
    tout, tbins, ttouched, _ = tstore.llhists.snapshot_and_reset(
        ps=tuple(PS))
    np.testing.assert_array_equal(ttouched, jtouched)
    np.testing.assert_array_equal(tbins, jbins)
    touched = np.flatnonzero(jtouched)
    np.testing.assert_array_equal(tout["count"],
                                  np.asarray(jout["count"])[touched])
    np.testing.assert_allclose(tout["quantiles"],
                               np.asarray(jout["quantiles"])[touched],
                               rtol=1e-6)
    assert tstore.llhists.samples_total == jstore.llhists.samples_total
    assert tstore.llhists.clamped_total == jstore.llhists.clamped_total
    assert tstore.llhists.capacity > 4  # rows outgrew the capacity


def test_set_snapshot_estimates_and_registers_match_jax():
    """Both tiers: promoted keys (>= 4 samples) read the device bank,
    which escapes into the lazy register view un-recycled; small keys
    estimate and materialize from the host COO."""
    jstore, tstore = _stores()
    lines = [f"s{k}:m{j}|s".encode() for k in range(12)
             for j in range(k * 3)]
    _feed(jstore, JParser(), lines)
    _feed(tstore, TParser(), lines)
    jest, jregs, jtouched, _ = jstore.sets.snapshot_and_reset()
    test, tregs, ttouched, _ = tstore.sets.snapshot_and_reset()
    np.testing.assert_array_equal(ttouched, jtouched)
    np.testing.assert_array_equal(test, np.asarray(jest))
    for row in np.flatnonzero(jtouched).tolist():
        np.testing.assert_array_equal(tregs[row], jregs[row])
    # the last key (33 members) was promoted and still reads its bank
    assert tregs[int(np.flatnonzero(ttouched)[-1])].any()


def test_add_batch_matches_jax_add_batch():
    """Column batches into interned rows; the set batches route per key
    to the host COO or, past set_promote_samples, the device bank, and
    run over several buffer dispatches."""
    jstore, tstore = _stores()
    rng = np.random.default_rng(5)
    jparser, tparser = JParser(), TParser()
    # intern the rows through both parsers, then feed columns
    for kind in ("c", "g", "ms", "s"):
        lines = [f"{kind[0]}{i}:1|{kind}".encode() for i in range(20)]
        _feed(jstore, jparser, lines)
        _feed(tstore, tparser, lines)
    rows = rng.integers(0, 20, 300).astype(np.int32)
    vals = rng.normal(0, 10, 300).astype(np.float32)
    ones = np.ones(300, np.float32)
    set_rows = np.repeat(np.arange(20, dtype=np.int32), np.arange(20))
    set_idx = rng.integers(0, 1 << 14, set_rows.size).astype(np.int32)
    set_rho = rng.integers(1, 20, set_rows.size).astype(np.int32)
    for store in (jstore, tstore):
        store.counters.add_batch(rows, vals, ones)
        store.gauges.add_batch(rows, vals)
        store.histos.add_batch(rows, vals, ones)
        store.sets.add_batch(set_rows, set_idx, set_rho)
    assert tstore.sets._nslots == jstore.sets._nslots > 0
    jbatch, _ = jflush(jstore, False, PS, JAggs.from_names(AGGS))
    tbatch, _ = tflush(tstore, False, PS, TAggs.from_names(AGGS))
    _assert_flushes_agree(jbatch, tbatch)


def test_jax_state_carried_into_the_port_flushes_equal():
    """convert: the JAX store's device state, as numpy, loaded into a port
    store that interned the same rows, flushes to the same series."""
    jstore, tstore = _stores()
    lines = _corpus(7, num_keys=12)
    _feed(jstore, JParser(), lines)
    _feed(tstore, TParser(), lines)
    jstore.apply_all_pending()
    tstore.apply_all_pending()
    for family, jtab, ttab in (("counter", jstore.counters, tstore.counters),
                               ("gauge", jstore.gauges, tstore.gauges),
                               ("histogram", jstore.histos, tstore.histos)):
        arrays = {k: np.asarray(v) for k, v in jtab.state.items()}
        ttab.state = convert.state_from_numpy(family, arrays, "cpu")
        back = convert.state_to_numpy(family, ttab.state)
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v)
    regs = np.asarray(jstore.sets.state)
    tstore.sets.state = convert.state_from_numpy("set", regs, "cpu")
    np.testing.assert_array_equal(
        convert.state_to_numpy("set", tstore.sets.state), regs)
    # llhist registers: the store's corpus has none, so carry a table
    # filled through the JAX package's own scatter
    from veneur_tpu.ops import batch_llhist as jbl
    rng = np.random.default_rng(3)
    jregs = np.asarray(jbl._apply_batch_jnp(
        jbl.init_state(8), rng.integers(0, 8, 300).astype(np.int32),
        rng.integers(0, 4501, 300).astype(np.int32),
        rng.integers(1, 9, 300).astype(np.int32)))
    tregs = convert.state_from_numpy("llhist", jregs, "cpu")
    assert tregs.dtype == torch.int32 and tuple(tregs.shape) == (8, 4608)
    np.testing.assert_array_equal(convert.state_to_numpy("llhist", tregs),
                                  jregs)
    jbatch, _ = jflush(jstore, False, PS, JAggs.from_names(AGGS))
    tbatch, _ = tflush(tstore, False, PS, TAggs.from_names(AGGS))
    _assert_flushes_agree(jbatch, tbatch)


@pytest.mark.parametrize("family,state,error", [
    ("counter", {"sum": np.zeros(3, np.float32)}, ValueError),
    ("gauge", {"value": np.zeros(3, np.float64),
               "set": np.zeros(3, bool)}, TypeError),
    ("set", np.zeros((2, 100), np.int8), ValueError),
    ("llhist", np.zeros((2, 4501), np.int32), ValueError),
    ("llhist", np.zeros((2, 4608), np.int64), TypeError),
])
def test_convert_rejects_foreign_layouts(family, state, error):
    with pytest.raises(error):
        convert.state_from_numpy(family, state, "cpu")
