"""The control of the check of `correct` for a circllhist cell: the
reference put in the program's place, its outputs rounded to the
precision below the one the configuration states (bfloat16 for the
port's float32 values), judged by judge_llhist. It has to come out not
correct.

    python3 portbench/control_llhist.py --workload <cell> --seconds <s> \\
        --seeds <n>,<n>,...

runs the program once per seed in one process, at the cell's own size,
and prints per seed one JSON line: the numbers the program's run reads
and those the control reads. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common, control, judge_llhist, spec  # noqa: E402
from portbench.reference import llhist as llref  # noqa: E402
from portbench.reference import statsd as ref  # noqa: E402


def reference_series(rec: dict, config: dict, cast=lambda x: x):
    """What each flush should have delivered, every value passed through
    `cast`: counters, gauges and sets as control.reference_series gives
    them, and each timer key's circllhist series."""
    pool = rec["pool"]
    interval = float(str(config["server"]["interval"]).rstrip("s"))
    ps = config["server"]["percentiles"]
    timer_names = set(pool.names["timer"])
    others = control.reference_series(rec, config, cast)
    timers = judge_llhist.timers_of(pool, config)
    log = np.asarray(rec["log"], np.int64).reshape(-1, 2)
    n_batches = pool.fam.shape[0]
    groups = []
    for epoch, series in enumerate(others):
        out = [s for s in series
               if s["metric"].rsplit(".", 1)[0] not in timer_names]
        reg = timers.interval(ref.interval_weights(log, n_batches, epoch))
        q32 = timers.quantiles(reg, ps)
        sums = timers.midpoint_sums(reg)
        start = reg["start"]

        def put(name, tags, value):
            out.append({"metric": name, "tags": tags,
                        "points": [[0, float(value)]]})
        for k in np.flatnonzero(reg["present"]).tolist():
            name, tags = pool.names["timer"][k], list(pool.tags["timer"][k])
            for j, p in enumerate(ps):
                put(f"{name}.{int(p * 100)}percentile", tags,
                    cast(float(q32[k, j])))
            put(name + ".sum", tags, cast(sums[k]))
            put(name + ".count", tags, cast(reg["total"][k]) / interval)
            for j in range(start[k], start[k + 1]):
                put(name + ".bucket", tags + [llref.LE_TAGS[reg["bin"][j]]],
                    cast(reg["cum"][j]) / interval)
            put(name + ".bucket", tags + ["le:+Inf"],
                cast(reg["total"][k]) / interval)
        groups.append(out)
    return groups


def readings(rec: dict, cell, cast) -> dict:
    """The numbers compared when the reference, through `cast`, stands
    in the program's place."""
    groups = reference_series(rec, cell.config, cast)
    checks = judge_llhist.judge(rec, cell.config, cell.limits,
                                series_groups=groups)
    return {k: v["value"] for k, v in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    cell = spec.load_cell(args.workload)
    card = common.require_cards(cell.chips)
    driver = spec.driver(cell.traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = driver.run(cell.config, cell.traffic, seed,
                         args.seconds, False, t0)
        rec["card"] = card
        program = {k: v["value"] for k, v in driver.judge(
            rec, cell.config, cell.limits).items()}
        control_reads = readings(rec, cell, control.bf16)
        print(json.dumps({"seed": seed, "program": program,
                          "control": control_reads,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
