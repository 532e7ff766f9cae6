"""Internal latency distributions over Circllhist registers, and the
flush waterfall (the parts of veneur_tpu/core/latency.py the operator
surface needs).

`LatencyHist` times the HTTP routes (`http.route`), the query plane
(`query.eval`) and the alert engine (`alert.eval`): one pure-Python bin
computation plus three adds under a lock per observation, quantiles at
scrape time from ops/llhist_ref. `waterfall_rounds` renders the flight
recorder's flush rounds for `/debug/flush?waterfall=1`.

The latency observatory itself (`LatencyObservatory`, the sample-age
and queue-dwell planes, `InstrumentedQueue`) is not ported yet, so
`/debug/latency` answers 404 "no latency source", as the JAX package
does for a server without one.
"""

from __future__ import annotations

import math
import threading
from typing import List, Sequence

import numpy as np

from veneur_tpu_torch.ops import llhist_ref

# quantiles exported per llhist series (1.0 = the occupied-bin maximum)
_EXPORT_QUANTILES = ((0.5, "p50"), (0.99, "p99"), (1.0, "max"))

_MANT_NEXP = llhist_ref.MANT * llhist_ref.NEXP


def bin_index_scalar(value: float) -> int:
    """Pure-Python scalar of llhist_ref.bin_index (a numpy scalar round
    trip costs ~10x more on a per-request path)."""
    a = abs(value)
    if not (a >= llhist_ref.MIN_MAG):  # 0, tiny magnitudes, NaN
        return llhist_ref.ZERO_BIN
    if a >= llhist_ref.MAX_MAG:  # includes +/-inf
        e = llhist_ref.EXP_MAX
        mant = 99
    else:
        e = math.floor(math.log10(a))
        # float-log correction: force 10^e <= a < 10^(e+1)
        if a < 10.0 ** e:
            e -= 1
        elif a >= 10.0 ** (e + 1):
            e += 1
        e = min(max(e, llhist_ref.EXP_MIN), llhist_ref.EXP_MAX)
        mant = min(max(math.floor(a / 10.0 ** (e - 1)), 10), 99)
    idx = llhist_ref.POS_BASE + (e - llhist_ref.EXP_MIN) * llhist_ref.MANT \
        + (mant - 10)
    return idx + _MANT_NEXP if value < 0 else idx


class LatencyHist:
    """One internal latency distribution over Circllhist registers.
    Thread-safe; quantiles and snapshots are scrape-time only."""

    __slots__ = ("name", "bins", "count", "sum", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.bins = np.zeros(llhist_ref.BINS, np.int64)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bin_index_scalar(value)
        with self._lock:
            self.bins[idx] += 1
            self.count += 1
            self.sum += value

    def quantiles(self, ps: Sequence[float]) -> np.ndarray:
        with self._lock:
            bins = self.bins.copy()
        return llhist_ref.quantiles(bins, ps)

    def snapshot(self) -> dict:
        with self._lock:
            bins = self.bins.copy()
            count, total = self.count, self.sum
        qs = llhist_ref.quantiles(bins, [p for p, _ in _EXPORT_QUANTILES])
        out = {"count": count, "sum": round(total, 6)}
        for (_p, label), q in zip(_EXPORT_QUANTILES, qs):
            out[label] = round(float(q), 6)
        return out


# -- flush waterfall -------------------------------------------------------

def family_segments_sum(families: dict) -> float:
    """Sum of every attributed segment in one round's family tree."""
    total = 0.0
    for rec in (families or {}).values():
        total += rec.get("dispatch_s", 0.0) + rec.get("transfer_s", 0.0)
        for dev in rec.get("devices", {}).values():
            total += dev.get("sync_s", 0.0)
    return total


def waterfall_rounds(rounds: List[dict]) -> List[dict]:
    """FlushRecorder rounds as the segment trees of
    `/debug/flush?waterfall=1`: per round, the phase totals, the
    per-family device segments and the per-sink delivery segments,
    newest last. The port's flush records no per-family tree yet, so
    `families` is empty and `segments_sum_s` 0."""
    out = []
    for r in rounds:
        phases = r.get("phases", {}) or {}
        families = r.get("families") or {}
        tree = {
            "flush": r.get("flush"),
            **({"async_readout": True} if r.get("async") else {}),
            **({"delivered_flush": r["delivered_flush"]}
               if r.get("delivered_flush") is not None else {}),
            **({"critical_path_s": phases["critical_path_s"]}
               if isinstance(phases.get("critical_path_s"),
                             (int, float)) else {}),
            **({"trace_id": r["trace_id"]} if r.get("trace_id") else {}),
            "start_unix": r.get("start_unix"),
            "duration_s": r.get("duration_s"),
            "phases": {k: v for k, v in phases.items()
                       if isinstance(v, (int, float))},
            "families": families,
            "segments_sum_s": round(family_segments_sum(families), 6),
            "device_total_s": round(
                float(phases.get("dispatch_s", 0.0))
                + float(phases.get("device_sync_s", 0.0)), 6),
            "sinks": {k: {"status": v.get("status"),
                          "duration_s": v.get("duration_s")}
                      for k, v in (r.get("sinks") or {}).items()},
        }
        out.append(tree)
    return out
