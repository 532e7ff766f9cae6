"""The control of the check of `correct`: the reference put in the
program's place, its outputs rounded to the precision below the one the
configuration states (bfloat16 for the port's float32 values), judged by
the same comparison. It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seconds <s> \
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

from portbench import common, judge_statsd, spec  # noqa: E402
from portbench.reference import statsd as ref  # noqa: E402


def bf16(x):
    """Round float32 values to bfloat16 (to nearest, ties to even)."""
    a = np.atleast_1d(np.asarray(x, np.float32)).copy()
    bits = a.view(np.uint32)
    bits += np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    bits &= np.uint32(0xFFFF0000)
    out = a.astype(np.float64)
    return out if np.ndim(x) else float(out[0])


def _weighted_quantile(values: np.ndarray, weights: np.ndarray,
                       q: float) -> float:
    """The q-quantile of the samples `values` taken `weights` times,
    interpolated between closest ranks."""
    n = weights.sum()
    cum = np.cumsum(weights)
    pos = q * (n - 1)
    lo = np.searchsorted(cum, np.floor(pos), "right")
    hi = np.searchsorted(cum, np.ceil(pos), "right")
    frac = pos - np.floor(pos)
    return float(values[lo] * (1 - frac) + values[hi] * frac)


def reference_series(rec: dict, config: dict, cast=lambda x: x):
    """What each flush should have delivered, from the reference, with
    every value passed through `cast`: the control in the program's
    place (`cast=bf16`), or the reference itself (the identity)."""
    pool = rec["pool"]
    interval = float(str(config["server"]["interval"]).rstrip("s"))
    ps = config["server"]["percentiles"]
    traffic = ref.Traffic(pool.fam, pool.key, pool.val, pool.values,
                          pool.rates, pool.members, config["keys"])
    log = np.asarray(rec["log"], np.int64).reshape(-1, 2)
    groups = []
    for epoch in range(rec["flushes"]):
        w = ref.interval_weights(log, traffic.n_batches, epoch)
        exp = traffic.interval(w)
        series = []

        def put(name, tags, value):
            series.append({"metric": name, "tags": list(tags),
                           "points": [[0, float(value)]]})
        for k in np.flatnonzero(exp["counter"]["present"]).tolist():
            put(pool.names["counter"][k], pool.tags["counter"][k],
                cast(exp["counter"]["sum"][k]) / interval)
        pairs = exp["gauge"]["pairs"]
        nv = len(traffic.gauge_f32)
        last = np.flatnonzero(pairs[1:] // nv != pairs[:-1] // nv)
        for code in pairs[np.append(last, pairs.size - 1)
                          if pairs.size else last].tolist():
            k = code // nv
            put(pool.names["gauge"][k], pool.tags["gauge"][k],
                cast(float(traffic.gauge_f32[code % nv])))
        t = exp["timer"]
        _, tv, tb = traffic.fam["timer"]
        for k in np.flatnonzero(t["present"]).tolist():
            name, tags = pool.names["timer"][k], pool.tags["timer"][k]
            put(name + ".min", tags, cast(t["min"][k]))
            put(name + ".max", tags, cast(t["max"][k]))
            put(name + ".count", tags, cast(t["count"][k]) / interval)
            lo, hi = traffic.seg["timer"][k], traffic.seg["timer"][k + 1]
            wk = w[tb[lo:hi]].astype(np.float64)
            vals = traffic.timer_sorted[tv[lo:hi]]
            for p in ps:
                put(f"{name}.{int(p * 100)}percentile", tags,
                    cast(_weighted_quantile(vals, wk, p)))
        s = exp["set"]
        for k in np.flatnonzero(s["present"]).tolist():
            put(pool.names["set"][k], pool.tags["set"][k],
                cast(s["estimate"][k]))
        groups.append(series)
    return groups


def readings(rec: dict, cell, cast) -> dict:
    """The numbers compared when the reference, through `cast`, stands
    in the program's place."""
    groups = reference_series(rec, cell.config, cast)
    checks = judge_statsd.judge(rec, cell.config, cell.limits,
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
        control = readings(rec, cell, bf16)
        print(json.dumps({"seed": seed, "program": program,
                          "control": control,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
