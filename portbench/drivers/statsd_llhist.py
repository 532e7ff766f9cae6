"""The local tier's traffic with the timers aggregated as circllhist: the
run of drivers/statsd_local.py (one closed-loop feeder into
`Server.handle_packet_batch`, `Server.flush()` at every interval, a
Datadog sink posting to a loopback receiver), judged by judge_llhist.

In a traced run a seam around K3's launch (`batch_llhist.apply_packed`:
the copy of one packed block and one launch of `ops/llhist_apply.apply`)
also notes every launch's samples and, after the run, the distinct
registers it added to, for `k3_roofline_pct`.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import seams
from portbench.drivers import statsd_local
from portbench.judge_llhist import judge  # noqa: F401  (the cell's check)

BINS_PAD = 4608  # the register table's width (ops/llhist_apply.BINS_PAD)


def note_k3(launches: list):
    """Append ("k3", host time, device type, (samples, block, rows)) per
    launch of K3 through `batch_llhist.apply_packed`, whose private host
    block (rows, bins, weights) is kept for distinct_registers, so that
    the count takes no device time and waits for nothing in the window."""
    from veneur_tpu_torch.ops import batch_llhist
    apply_packed = batch_llhist.apply_packed

    def seam(regs, block):
        launches.append(("k3", time.perf_counter(), regs.device.type,
                         (int(block.shape[1]), block, int(regs.shape[0]))))
        return apply_packed(regs, block)
    batch_llhist.apply_packed = seam

    def restore():
        batch_llhist.apply_packed = apply_packed
    return restore


def distinct_registers(block: np.ndarray, rows: int,
                       width: int = BINS_PAD) -> int:
    """The in-range (row, bin) registers a launch's block adds to."""
    r, b = block[0].astype(np.int64), block[1].astype(np.int64)
    keep = (r >= 0) & (r < rows) & (b >= 0) & (b < width)
    return int(np.unique(r[keep] * width + b[keep]).size)


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, t_start: float, device: str = "cuda") -> dict:
    """One run of the local cell (statsd_local.run), with K3's launches
    noted beside K1's and K2's in a traced run; returns the run's record,
    which also counts the sinks a flush skipped (`sinks_skipped`)."""
    note_kernels = seams.note_kernels

    def note_all(launches: list):
        undo = [note_kernels(launches)]
        if trace:
            undo.append(note_k3(launches))

        def restore():
            for fn in reversed(undo):
                fn()
        return restore
    seams.note_kernels = note_all
    try:
        rec = statsd_local.run(config, traffic, seed, seconds, trace,
                               t_start, device=device)
    finally:
        seams.note_kernels = note_kernels
    rec["launches"] = [
        (k, t, dev, (shape[0], distinct_registers(shape[1], shape[2]))
         if k == "k3" else shape) for k, t, dev, shape in rec["launches"]]
    rec["sinks_skipped"] = sum(
        1 for t in rec["flush_timings"] for key, r in t.items()
        if key.startswith("sink:") and isinstance(r, dict)
        and r.get("status") == "skipped")
    return rec
