"""A whole run of each cell, cut to a CPU size (the port's plain versions
in place of its kernels): the result line's shape, the control, every
fault the check has to catch, and a driver found by its name."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import control, run as prun, spec
from portbench.common import ROOT
from portbench.tests.small import small_cell

CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


def _run(name, seconds=3.0):
    return prun.run_cell(small_cell(name), 2**31 + 11, seconds, False,
                         "cpu", device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    line = _run(name)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = small_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_driver_found_by_its_entry(tmp_path, monkeypatch):
    """A traffic mix's `entry` names a module of portbench/drivers, found
    by that name alone: a driver no code of the harness mentions."""
    import portbench.drivers
    (tmp_path / "unseen_entry.py").write_text(
        "def run(*a, **kw):\n    return {'ran': a}\n"
        "def judge(rec, config, limits):\n    return {}\n")
    monkeypatch.setattr(portbench.drivers, "__path__",
                        [*portbench.drivers.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "portbench.drivers.unseen_entry",
                        raising=False)
    mod = spec.driver({"entry": "unseen_entry"})
    assert mod.run(1)["ran"] == (1,)
    assert spec.driver({"entry": "statsd_local"}).run is not None
    with pytest.raises(ValueError):
        spec.driver({"entry": "../run"})


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    if _has_card():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == b""


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def test_harness_imports_neither_jax_nor_the_jax_package():
    """A run loads no module whose top-level name is jax, jaxlib, flax or
    veneur_tpu (veneur_tpu_torch starts with veneur_tpu: names compared
    whole), and the reference loads nothing of the program."""
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        "import portbench.reference.statsd, portbench.reference.hll\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'veneur_tpu_torch' not in tops, 'reference'\n"
        "from portbench import common, run, control\n"
        "from portbench.tests.small import small_cell\n"
        "run.run_cell(small_cell(), 7, 1.0, False, 'cpu',\n"
        "             device='cpu', t_start=time.perf_counter())\n"
        "print(sorted(common.forbidden_loaded()))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture(scope="module")
def local_run():
    """A program run of the local cell and its record (for the control)."""
    cell = small_cell()
    rec = spec.driver(cell.traffic).run(cell.config, cell.traffic, 5, 3.0,
                           False, time.perf_counter(), device="cpu")
    return cell, rec


def _failing(readings, cell):
    """The numbers over their limits (the exact ones' limit is 0)."""
    return {k: v for k, v in readings.items()
            if k != "series_judged" and v > cell.limits.get(k, 0)}


def test_reference_in_the_programs_place_is_correct(local_run):
    cell, rec = local_run
    assert not _failing(control.readings(rec, cell, lambda x: x), cell)


def test_control_is_not_correct(local_run):
    cell, rec = local_run
    failing = _failing(control.readings(rec, cell, control.bf16), cell)
    assert {"counter_wrong", "timer_agg_wrong"} <= set(failing)


def _half_batch(orig):
    def handle(self, datagrams):
        return orig(self, datagrams[: len(datagrams) // 2])
    return handle


def _estimate_plus_one(orig):
    def estimate(regs):
        return orig(regs) + 1
    return estimate


def _percentiles_scaled(orig):
    def flush_packed_plain(sm, sw, scal, ps):
        out = orig(sm, sw, scal, ps).clone()
        out[:, :len(ps)] *= 1.25
        return out
    return flush_packed_plain


def _state_unchanged(orig):
    def apply_counters(state, rows, values, rates):
        return state
    return apply_counters


@pytest.mark.parametrize("fault", [
    ("local_100k.ingest", "veneur_tpu_torch.core.server", "Server",
     "handle_packet_batch", _half_batch),
    ("local_100k.ingest", "veneur_tpu_torch.ops.hll_estimate", None,
     "estimate_plain", _estimate_plus_one),
    ("local_100k.ingest", "veneur_tpu_torch.ops.tdigest_flush", None,
     "flush_packed_plain", _percentiles_scaled),
    ("local_100k.ingest", "veneur_tpu_torch.ops.scalars", None,
     "apply_counters", _state_unchanged),
], ids=["half_batch", "k2_answer_altered", "k1_answer_altered",
        "state_unchanged"])
def test_fault_is_not_correct(monkeypatch, fault):
    """The timed path broken underneath: the run's check says so."""
    name, module, cls, attr, make = fault
    mod = __import__(module, fromlist=[attr if cls is None else cls])
    owner = getattr(mod, cls) if cls else mod
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    line = _run(name, 2.0)
    assert line["correct"] is False, line["checks"]


@pytest.mark.card
def test_program_correct_and_control_not_on_card():
    """On the card, at the cell's own size: the program's run is correct
    and the control's is not (`python -m pytest portbench/tests -m card`
    on the chip)."""
    if not _has_card():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", CELLS[0],
         "--seconds", "12", "--seeds", str(2**31 + 99)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cell = spec.load_cell(CELLS[0])
    limits = {**{k: 0 for k in out["program"]}, **cell.limits}
    assert all(v <= limits[k] for k, v in out["program"].items()
               if k != "series_judged")
    assert any(v > limits[k] for k, v in out["control"].items()
               if k != "series_judged")
    assert np.isfinite(out["seconds"])
