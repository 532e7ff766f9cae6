"""A cell of BENCHMARK.json and everything found by its names: the
configuration file, the traffic mix (`traffic/<traffic>.json`) and the
driver its `entry` names (`drivers/<entry>.py`), the cell's limits
(`workloads/<cell>.json`) and each metric's reader (`metrics/<metric>.py`,
a module with `read(run) -> float | None`)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from portbench.common import BENCH_DIR, ROOT


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "workloads" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def driver(traffic: dict):
    """The module `drivers/<entry>.py` that runs the traffic mix."""
    entry = traffic["entry"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", entry):
        raise ValueError(f"a traffic mix's entry is a module name: {entry!r}")
    return importlib.import_module(f"portbench.drivers.{entry}")


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """The `read` function of `metrics/<metric>.py`."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    mod_name = "portbench_metric_" + metric.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run: dict) -> Dict[str, dict]:
    """Each metric's reading, left out where its reader finds nothing."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
