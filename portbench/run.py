"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (a torch.profiler trace over the
window). The numbers compared by the check of `correct` are printed, each
beside its limit, as the last lines of standard error and under `checks`,
the last key of the result line. Exit codes: 0 with a result; 2 without
the cards the cell needs; 3 when a forbidden module was loaded; 1 on any
other failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common, spec  # noqa: E402


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             card: str, device: str = "cuda",
             t_start: float = T_START) -> dict:
    """Drive the cell, judge it and read its metrics: the result line."""
    driver = spec.driver(cell.traffic)
    rec = driver.run(cell.config, cell.traffic, seed, seconds, trace,
                     t_start, device=device)
    rec["card"] = card
    t_judge = time.perf_counter()
    checks = driver.judge(rec, cell.config, cell.limits)
    print("portbench: set-up " + json.dumps(
        {k: round(v, 3) for k, v in rec.get("setup_parts", {}).items()})
          + f"; after the window {rec.get('after_s', 0.0):.3f} s; "
          f"check {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    correct = all(c["limit"] is None or c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = spec.read_metrics(cell.per_layer if trace
                                else cell.end_to_end, rec)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": card, "count": cell.chips,
           "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    breakdown = None
    out = rec.get("trace_out")
    if trace and out and out.get("device_events"):
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
        breakdown = out["breakdown"]
    return common.result_line(correct, rec["attempted"], rec["failed"],
                              metrics, dev, checks, breakdown)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    cell = spec.load_cell(args.workload)
    try:
        card = common.require_cards(cell.chips)
    except common.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), card)
    found = common.forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    checks = line["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
