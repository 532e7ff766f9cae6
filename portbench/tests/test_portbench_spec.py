"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import re

import pytest

from portbench import spec
from portbench.common import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells fits in 43 200 s
    assert ((2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    assert 1 <= cells <= 24
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_sources(bench):
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_every_cell_loads_by_name(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        cell = spec.load_cell(w["name"], bench)
        driver = spec.driver(cell.traffic)
        assert callable(driver.run) and callable(driver.judge)
        assert cell.limits
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = cell.per_layer
        assert layers
        # each per-layer metric moves an end-to-end metric of the cell
        assert {m["moves"] for m in layers} <= e2e


def test_every_config_file(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(ROOT / c["file"]) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank"))


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.reader(m["name"]))
