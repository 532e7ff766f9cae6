#!/usr/bin/env python3
"""Run some of chip_smoke.py's server phases from two checkouts in turns
on one card, so that two versions are compared inside one call: the
other checkout, this one, this one, the other (host phases move by tens
of percent between calls, and by less within one).

    python3 chip_compare.py --other build/parent [--phases a,j1]

Each turn is a process of its own, started in that checkout's root: it
builds the kernels and the native parser there, runs the named phase
functions of that checkout's chip_smoke.py (`_phase_<name>`, each of
which checks its own series and fails on a wrong one), and prints one
JSON line of each phase's per-interval rate (`lines_per_s`) and flush
seconds. The last line is a JSON object with every turn's results and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from veneur_tpu_torch import native
from veneur_tpu_torch.ops import _cuda
_cuda.build_all()
native.load()
out = {}
for name in sys.argv[1].split(","):
    t0 = time.perf_counter()
    rep = getattr(cs, "_phase_" + name)()
    out[name] = {"seconds": time.perf_counter() - t0,
                 "lines_per_s": [iv["lines_per_s"] for iv in rep["intervals"]],
                 "flush_s": [iv["flush"]["total_s"] for iv in rep["intervals"]]}
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_compare.py")
    ap.add_argument("--other", required=True,
                    help="root of the other checkout (e.g. the parent "
                         "commit unpacked with git archive)")
    ap.add_argument("--phases", default="a,j1",
                    help="chip_smoke phase functions, without _phase_")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"other": os.path.abspath(args.other), "this": here}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for label in ("other", "this", "this", "other"):
        done = subprocess.run([sys.executable, "-c", _TURN, args.phases],
                              cwd=roots[label], capture_output=True,
                              text=True, timeout=1800)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-8000:], file=sys.stderr)
            return done.returncode
        result = json.loads(done.stdout.strip().splitlines()[-1])
        print(label, json.dumps(result), flush=True)
        turns.append({"checkout": label, **result})
    print(json.dumps({"card": smi, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
