"""The circllhist cell's pieces on the CPU: the plain reference against
the program's stated layout, the judge against planted faults, the
bfloat16 control, the new metric readers, K3's byte count and the K3
seam of the cell's driver."""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import control, control_llhist, judge_llhist, spec
from portbench import roofline_llhist
from portbench.common import ROOT
from portbench.drivers import statsd_llhist
from portbench.reference import llhist as llref
from portbench.tests.small import small_cell

CELL = "local_circllhist.ingest"


def _corpus(seed=3, n=20_000):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.gamma(2.0, 25.0, n).round(3),
        rng.lognormal(0.0, 6.0, n) * rng.choice([-1.0, 1.0], n),
        [0.0, -0.0, 1e-12, 1e-9, 9.99e-10, 1.2, 0.3, 12.0, 99.9, 100.0,
         1e15, 9.99e15, 1e16, 3e16, -1e16, 1e300, -1.2, 0.1, 1.0, 10.0]])
    return vals


def test_reference_bins_are_the_programs():
    from veneur_tpu_torch.ops import llhist_ref
    vals = _corpus()
    rank = np.empty(llhist_ref.BINS, np.int64)
    rank[llhist_ref.ORDER] = np.arange(llhist_ref.BINS)
    assert np.array_equal(llref.sorted_bin(vals).numpy(),
                          rank[llhist_ref.bin_index(vals)])


def test_reference_geometry_is_the_programs():
    from veneur_tpu_torch.core import flusher
    from veneur_tpu_torch.ops import llhist_ref
    assert llref.LE_TAGS == list(flusher.LE_TAGS)
    # the program's table takes numpy's array power, whose 10^-5 lies an
    # ulp from the correctly rounded double the reference takes
    for mine, its in ((llref.MID, llhist_ref.MID_SORTED),
                      (llref.LEFT, llhist_ref.LEFT_SORTED),
                      (llref.WIDTH, llhist_ref.WIDTH_SORTED)):
        np.testing.assert_array_max_ulp(mine.numpy(), its, maxulp=2)


def _timers(seed=5, keys=40):
    rng = np.random.default_rng(seed)
    n = 6000
    key = np.concatenate([np.arange(keys), rng.integers(0, keys, n)])
    vals = _corpus(seed, 3000)[rng.integers(0, 6020, key.size)]
    batch = rng.integers(0, 4, key.size)
    return llref.Timers(key, batch, vals, keys + 2), key, vals, batch


def test_reference_readout_is_the_programs_on_the_same_registers():
    """Quantiles bit for bit (float32, no contraction on the CPU), the
    midpoint sum within 1e-12, counts and buckets exact."""
    from veneur_tpu_torch.ops import batch_llhist, llhist_ref
    timers, key, vals, batch = _timers()
    w = np.array([2, 0, 1, 3])
    reg = timers.interval(w)
    regs = np.zeros((timers.num_keys, batch_llhist.BINS_PAD), np.int32)
    np.add.at(regs, (key, llhist_ref.bin_index(vals)), w[batch])
    ps = (0.0, 0.5, 0.75, 0.99, 1.0)
    out = batch_llhist.flush_packed(torch.from_numpy(regs), ps)
    assert np.array_equal(timers.quantiles(reg, ps), out["quantiles"].numpy())
    assert np.array_equal(reg["total"], out["count"].numpy())
    dense = regs[:, :llhist_ref.BINS].astype(np.int64)
    want = dense.astype(np.float64) @ llhist_ref.BIN_MID
    np.testing.assert_allclose(timers.midpoint_sums(reg), want, rtol=1e-12)
    csum = np.cumsum(dense[:, llhist_ref.ORDER], axis=1)
    k, b = np.nonzero(dense[:, llhist_ref.ORDER])
    assert np.array_equal(reg["key"], k) and np.array_equal(reg["bin"], b)
    assert np.array_equal(reg["cum"], csum[k, b])


def test_rank_bins_hold_the_exact_quantile():
    timers, key, vals, batch = _timers(7)
    w = np.array([1, 1, 0, 2])
    reg = timers.interval(w)
    keys = np.flatnonzero(reg["present"])
    for p in (0.5, 0.99):
        span = timers.rank_bins(reg, keys, np.full(keys.size, p))
        for i, k in enumerate(keys.tolist()):
            live = (key == k) & (w[batch] > 0)
            xs = np.sort(np.repeat(vals[live], w[batch][live]))
            x = np.quantile(xs, p, method="lower")
            b = int(llref.sorted_bin([x])[0])
            assert span["lo"][i] <= b <= span["hi"][i]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import portbench.reference.llhist\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'veneur_tpu_torch', 'veneur_tpu', 'jax'}))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def llhist_run():
    """A program run of the circllhist cell and its record."""
    cell = small_cell(CELL)
    rec = spec.driver(cell.traffic).run(cell.config, cell.traffic, 2**32 + 9,
                                        3.0, False, time.perf_counter(),
                                        device="cpu")
    return cell, rec


def _failing(checks):
    return {k: v["value"] for k, v in checks.items()
            if v["limit"] is not None and v["value"] > v["limit"]}


def test_program_run_is_correct(llhist_run):
    cell, rec = llhist_run
    checks = judge_llhist.judge(rec, cell.config, cell.limits)
    assert not _failing(checks), checks
    assert checks["series_judged"]["value"] > 0
    assert rec["sinks_skipped"] == 0


def test_reference_in_the_programs_place_is_correct(llhist_run):
    cell, rec = llhist_run
    groups = control_llhist.reference_series(rec, cell.config)
    checks = judge_llhist.judge(rec, cell.config, cell.limits,
                                series_groups=groups)
    assert not _failing(checks), checks
    assert checks["llhist_quantile_ulps_max"]["value"] == 0


def test_control_is_not_correct(llhist_run):
    cell, rec = llhist_run
    reads = control_llhist.readings(rec, cell, control.bf16)
    assert reads["counter_wrong"] > 0 and reads["llhist_bucket_wrong"] > 0
    assert reads["llhist_quantile_wrong"] > 0


def _bucket(groups, le_inf: bool):
    for series in groups:
        for i, s in enumerate(series):
            if s["metric"].endswith(".bucket") and \
                    (s["tags"][-1] == "le:+Inf") == le_inf:
                return series, i
    raise AssertionError("no bucket series")


def _off_by_one(groups, interval):
    series, i = _bucket(groups, False)
    series[i]["points"][0][1] += 1.0 / interval


def _no_inf(groups, interval):
    series, i = _bucket(groups, True)
    del series[i]


def _bin_shifted(groups, interval):
    """Every bucket of the first flush one mantissa step up."""
    for s in groups[0]:
        tags = s["tags"]
        if s["metric"].endswith(".bucket") and tags[-1] != "le:+Inf":
            tags[-1] = llref.LE_TAGS[llref.LE_INDEX[tags[-1]] + 1]


def _each(suffix, cast):
    def fault(groups, interval):
        for series in groups:
            for s in series:
                if s["metric"].endswith(suffix):
                    s["points"][0][1] = float(cast(s["points"][0][1]))
    return fault


@pytest.mark.parametrize("fault,check", [
    (_off_by_one, "llhist_bucket_wrong"),
    (_no_inf, "series_missing"),
    (_bin_shifted, "series_missing"),
    (_each("percentile", control.bf16), "llhist_quantile_wrong"),
    (_each(".sum", np.float32), "llhist_sum_wrong"),
], ids=["bucket_off_by_one", "no_le_inf", "bin_shifted",
        "quantiles_bf16", "sum_float32"])
def test_judge_catches_a_planted_fault(llhist_run, fault, check):
    cell, rec = llhist_run
    groups = control_llhist.reference_series(rec, cell.config)
    interval = float(cell.config["server"]["interval"].rstrip("s"))
    fault(groups, interval)
    checks = judge_llhist.judge(rec, cell.config, cell.limits,
                                series_groups=groups)
    assert check in _failing(checks), checks


def test_retagged_bucket_series(llhist_run):
    """A bucket whose `le:` tag is not last is read as a list; a tag
    list that differs from the key's is wrong."""
    cell, rec = llhist_run
    groups = control_llhist.reference_series(rec, cell.config)
    series, i = _bucket(groups, False)
    series[i]["tags"] = series[i]["tags"][-1:] + series[i]["tags"][:-1]
    checks = judge_llhist.judge(rec, cell.config, cell.limits,
                                series_groups=copy.deepcopy(groups))
    assert not _failing(checks), checks
    series[i]["tags"] = series[i]["tags"][1:]
    checks = judge_llhist.judge(rec, cell.config, cell.limits,
                                series_groups=groups)
    assert set(_failing(checks)) == {"series_missing", "series_extra"}


def test_readers_on_synthetic_records():
    run = {"flush_timings": [
        {"llhist_copy_bytes": 3_000_000, "llhist_bins_s": 0.25,
         "llhist_assembly_s": 0.5, "families": {"llhist": {
             "dispatch_s": 0.25}}},
        {"llhist_copy_bytes": 5_000_000, "llhist_bins_s": 0.5,
         "llhist_assembly_s": 0.5, "families": {"llhist": {
             "dispatch_s": 0.0}}}]}
    assert spec.reader("llhist_copy_mb")(run) == pytest.approx(4.0)
    assert spec.reader("llhist_readout_s")(run) == pytest.approx(1.0)
    parent = {"flush_timings": [{"llhist_bins_s": 0.7, "families": {}}]}
    assert spec.reader("llhist_copy_mb")(parent) is None
    assert spec.reader("llhist_readout_s")(parent) is None
    card = "NVIDIA H100 80GB HBM3"
    traced = {"card": card,
              "trace_out": {"by_name": {"llhist_apply_kernel": 2e-6,
                                        "other": 1.0}},
              "launches": [("k3", 0.0, "cuda", (8192, 1000)),
                           ("k1", 0.0, "cuda", (1, 1, 1)),
                           ("k3", 0.0, "cpu", (8192, 1000))]}
    want = (8192 * 12 + 1000 * 8) / 3.35e12 / 2e-6 * 100
    assert spec.reader("k3_roofline_pct")(traced) == pytest.approx(want)
    assert spec.reader("k3_roofline_pct")(
        dict(traced, trace_out=None)) is None


def test_k3_bytes_are_the_programs():
    from veneur_tpu_torch.ops import llhist_apply
    assert roofline_llhist.k3_bytes(8192, 3000) == \
        llhist_apply.bound_bytes(8192, 3000)


def test_k3_seam_counts_samples_and_distinct_registers():
    from veneur_tpu_torch.ops import batch_llhist, llhist_apply
    launches = []
    restore = statsd_llhist.note_k3(launches)
    try:
        regs = torch.zeros((5, llhist_apply.BINS_PAD), dtype=torch.int32)
        cols = (np.array([0, 0, 4, 2, 2, 2, 9], np.int32),
                np.array([3, 3, 7, 1, 2, 1, 0], np.int32),
                np.ones(7, np.int32))
        batch_llhist.apply_packed(regs, batch_llhist.pack([cols]))
    finally:
        restore()
    assert batch_llhist.apply_packed.__name__ == "apply_packed"
    (name, _t, dev, (samples, block, rows)), = launches
    assert (name, dev, samples, rows) == ("k3", "cpu", 8, 5)
    assert statsd_llhist.distinct_registers(block, rows) == 4
    assert int(regs.sum()) == 6  # row 9 lies past the table: dropped
    assert statsd_llhist.BINS_PAD == llhist_apply.BINS_PAD


def test_traced_cpu_run_notes_k3():
    cell = small_cell(CELL)
    rec = statsd_llhist.run(cell.config, cell.traffic, 11, 2.0, True,
                            time.perf_counter(), device="cpu")
    k3 = [x for x in rec["launches"] if x[0] == "k3"]
    assert k3 and all(isinstance(x[3][1], int) and 0 < x[3][1] <= x[3][0]
                      for x in k3)
    json.dumps([x[3] for x in k3])
