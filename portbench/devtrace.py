"""The device trace of a `--trace 1` run: torch.profiler over the measured
window, reduced to the device's busy time, each kernel's device seconds,
the device operations that took most time and the idle gaps by what the
harness was doing meanwhile.

The profiler's clock is placed on the host's `time.perf_counter` by a
marker: right after the profiler starts, with nothing else on the card, a
one-element fill is launched and synchronised; its device start lies
between the host's readings around it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


def _ns(event, what: str) -> float:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(event, f"{what}_us")()) * 1e3


class Tracer:
    """torch.profiler over the window, or nothing when off."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.marker_host = 0.0

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        marker = torch.empty(1, device="cuda")
        t_a = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        self.marker_host = (t_a + t_b) / 2

    def stop(self, t0: float, t_end: float, spans) -> Optional[dict]:
        """Stop and reduce over [t0, t_end] (host seconds)."""
        if not self.on:
            return None
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        device: List[Tuple[str, float, float]] = []
        for ev in events:
            # the harness's record_function ranges are mirrored onto the
            # device's timeline as annotations: not device work
            if ("cuda" not in str(ev.device_type()).lower()
                    or ev.name().startswith("bench.")):
                continue
            start = _ns(ev, "start")
            device.append((ev.name(), start, start + _ns(ev, "duration")))
        self.prof = None
        if not device:
            return {"device_events": 0}
        device.sort(key=lambda x: x[1])
        marker = next((d for d in device if "fill" in d[0].lower()),
                      device[0])
        shift = self.marker_host - marker[1] * 1e-9
        placed = [(n, s * 1e-9 + shift, e * 1e-9 + shift)
                  for n, s, e in device if s > marker[1]]
        return reduce(placed, t0, t_end, spans)


def _merged(intervals: List[Tuple[float, float]]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labels(spans, mids: List[float]) -> List[str]:
    """What the harness was doing at each host time in `mids`: a flush or
    an ingest batch (in that order of precedence), or none."""
    import numpy as np
    mids_a = np.asarray(mids, float)
    out = np.full(mids_a.shape, "none", dtype=object)
    for name in ("ingest_batch", "flush"):
        merged = _merged([(s, e) for n, s, e in spans.items if n == name])
        if not merged:
            continue
        starts = np.array([m[0] for m in merged])
        ends = np.array([m[1] for m in merged])
        i = np.searchsorted(starts, mids_a, side="right") - 1
        inside = (i >= 0) & (mids_a <= ends[np.maximum(i, 0)])
        out[inside] = name
    return list(out)


def reduce(device: List[Tuple[str, float, float]], t0: float, t_end: float,
           spans) -> dict:
    """Busy seconds (the union of every kernel, copy and set on the card,
    clipped to the window), device seconds by operation name, and idle
    seconds by what the harness was doing."""
    clipped = [(n, max(s, t0), min(e, t_end)) for n, s, e in device
               if e > t0 and s < t_end]
    by_name: Dict[str, float] = {}
    for n, s, e in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    busy = _merged([(s, e) for _, s, e in clipped])
    busy_s = sum(e - s for s, e in busy)
    gaps = []
    prev = t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t_end > prev:
        gaps.append((prev, t_end))
    idle_by: Dict[str, float] = {}
    longest: Dict[str, float] = {}
    for (s, e), label in zip(gaps, _labels(spans, [(s + e) / 2
                                                   for s, e in gaps])):
        idle_by[label] = idle_by.get(label, 0.0) + (e - s)
        longest[label] = max(longest.get(label, 0.0), e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by.items(), key=lambda kv: -kv[1])
    idle_gaps = ([[f"idle while {k}", v] for k, v in idle]
                 + [[f"longest gap while {k}", v]
                    for k, v in sorted(longest.items(),
                                       key=lambda kv: -kv[1])])[:10]
    return {"device_events": len(clipped), "busy_s": busy_s,
            "window_s": t_end - t0, "by_name": by_name,
            "breakdown": {"device_ops": [[n, v] for n, v in top_ops],
                          "idle_gaps": idle_gaps}}


def kernel_seconds(trace_out: Optional[dict], needle: str) -> float:
    """Device seconds of the kernels whose name holds `needle`."""
    if not trace_out or "by_name" not in trace_out:
        return 0.0
    return sum(v for n, v in trace_out["by_name"].items() if needle in n)


def idle_pct(run: dict) -> Optional[float]:
    """The traced window's idle share, in percent; None untraced."""
    out = run.get("trace_out")
    if not out or not out.get("device_events"):
        return None
    return (1.0 - out["busy_s"] / out["window_s"]) * 100.0
