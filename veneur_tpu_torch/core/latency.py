"""Pipeline latency observatory (torch port of
veneur_tpu/core/latency.py): end-to-end sample age, queue dwell and
internal latency distributions over Circllhist registers, and the flush
waterfall.

- **End-to-end sample age**: ingest batches are stamped at socket read
  per plane (dogstatsd / ssf / otlp / forward) with one `note_arrival`
  per batch; the flush takes the per-plane oldest/newest watermark at
  its swap (`take_watermarks`) and observes the age through to sink ack
  into a `pipeline.sample_age` llhist per plane.
- **Queue dwell**: every bounded hand-off (the span channel, the span
  sinks' isolation buffers, the proxy's destination queues, the forward
  carryover and spool, the pump's per-reader rings) has a depth gauge
  read at scrape time and an enqueue->dequeue dwell llhist
  (`InstrumentedQueue`, or `register_queue` + `queue_hist`).
- **Egress**: each sink's encode-vs-send split (`note_egress`), and
  the gzip's share of the send where the sink measures it.

The JAX package's retrace plane (`note_retrace`, the report's
`pending_retraces`) has no counterpart: the port recompiles nothing.

`LatencyHist` also times the HTTP routes (`http.route`), the query
plane (`query.eval`) and the alert engine (`alert.eval`): one
pure-Python bin computation plus three adds under a lock per
observation, quantiles at scrape time from ops/llhist_ref.
`waterfall_rounds` renders the flight recorder's flush rounds for
`/debug/flush?waterfall=1`. `latency_observatory: false` hands out plain
queues and makes every note_* call an early return.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

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


class InstrumentedQueue(queue.Queue):
    """A queue.Queue that measures enqueue->dequeue dwell into a
    LatencyHist. The `_put`/`_get` hooks run under the queue's own
    mutex, so the parallel timestamp deque stays exactly aligned with
    the FIFO item order; depth is read at scrape time via qsize()."""

    def __init__(self, name: str, hist: LatencyHist, maxsize: int = 0):
        super().__init__(maxsize)
        self.name = name
        self.hist = hist
        self._stamps: deque = deque()

    def _put(self, item) -> None:
        self._stamps.append(time.monotonic())
        super()._put(item)

    def _get(self):
        try:
            t0 = self._stamps.popleft()
        except IndexError:  # pre-existing items (never happens in practice)
            t0 = None
        if t0 is not None:
            self.hist.observe(time.monotonic() - t0)
        return super()._get()


class _PlaneMark:
    """Per-plane arrival watermark for the current flush interval."""

    __slots__ = ("oldest", "newest", "batches", "samples")

    def __init__(self):
        self.oldest = 0.0
        self.newest = 0.0
        self.batches = 0
        self.samples = 0


class LatencyObservatory:
    """One server's (or proxy's) latency observatory. Disabled
    (`latency_observatory: false`) it hands out plain queues, skips the
    per-family flush attribution, and every note_* call is a cheap
    early return — the <2% overhead guard's off switch."""

    # consecutive flushes a plane may idle (no arrivals) before its
    # sample-age series is ROLLED: the cumulative llhist would otherwise
    # render its last p50/p99/max forever — a gone-quiet forward plane
    # reading hours-stale ages is exactly the dashboard lie the
    # observatory exists to prevent. Traffic returning re-creates the
    # series fresh (count restarts from 0).
    AGE_IDLE_SUPPRESS = 3

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._age_hists: Dict[str, LatencyHist] = {}
        # plane -> consecutive takes with no arrivals (idle-roll state)
        self._age_idle: Dict[str, int] = {}
        # optional flow ledger (core/ledger.py): arrivals stamp the
        # informational ingress.observed stage per plane
        self.ledger = None
        self._queue_hists: Dict[str, LatencyHist] = {}
        # name -> (depth_fn, capacity)
        self._queues: Dict[str, tuple] = {}
        self._marks: Dict[str, _PlaneMark] = {}
        # (phase, sink) -> hist; phase is "encode" or "send" — the
        # per-sink flush split reported by MetricSink.note_egress
        self._egress_hists: Dict[tuple, LatencyHist] = {}

    # -- queue dwell -----------------------------------------------------

    def queue_hist(self, name: str) -> LatencyHist:
        """Get-or-create the dwell llhist for one named hand-off."""
        with self._lock:
            hist = self._queue_hists.get(name)
            if hist is None:
                hist = self._queue_hists[name] = LatencyHist(
                    f"queue.dwell:{name}")
            return hist

    def instrument_queue(self, name: str, maxsize: int = 0) -> queue.Queue:
        """A bounded queue with dwell+depth telemetry under `name`;
        plain queue.Queue when the observatory is disabled."""
        if not self.enabled:
            return queue.Queue(maxsize=maxsize)
        q = InstrumentedQueue(name, self.queue_hist(name), maxsize=maxsize)
        self.register_queue(name, q.qsize, maxsize)
        return q

    def register_queue(self, name: str, depth_fn: Callable[[], int],
                       capacity: int) -> None:
        """Register a depth gauge for a hand-off that isn't a
        queue.Queue (span-sink chunk buffers, the forward carryover);
        pair with queue_hist(name) for its dwell distribution."""
        if not self.enabled:
            return
        with self._lock:
            self._queues[name] = (depth_fn, capacity)

    def unregister_queue(self, name: str) -> None:
        """Drop a retired hand-off's depth gauge and dwell series (a
        proxy destination that left the pool) so discovery churn can't
        grow the observatory unboundedly."""
        with self._lock:
            self._queues.pop(name, None)
            self._queue_hists.pop(name, None)

    # -- sample age ------------------------------------------------------

    def note_arrival(self, plane: str, n: int = 1,
                     t: Optional[float] = None) -> None:
        """Stamp an ingest batch at socket read: updates the plane's
        oldest/newest arrival watermark for the current interval. One
        call per BATCH, not per sample — the stamp is a watermark, so
        batch granularity loses nothing but a count."""
        if not self.enabled:
            return
        if t is None:
            t = time.time()
        led = self.ledger
        if led is not None:
            led.note("ingress.observed", n, key=plane)
        with self._lock:
            mark = self._marks.get(plane)
            if mark is None:
                mark = self._marks[plane] = _PlaneMark()
            if not mark.batches or t < mark.oldest:
                mark.oldest = t
            if t > mark.newest:
                mark.newest = t
            mark.batches += 1
            mark.samples += n

    def take_watermarks(self) -> Dict[str, tuple]:
        """Snapshot-and-reset every plane's watermark — called at flush
        snapshot so the interval boundary matches the column store's.
        Returns {plane: (oldest_unix, newest_unix)}."""
        if not self.enabled:
            return {}
        with self._lock:
            out = {plane: (mark.oldest, mark.newest)
                   for plane, mark in self._marks.items() if mark.batches}
            self._marks.clear()
            # idle-plane roll: a plane with no arrivals for
            # AGE_IDLE_SUPPRESS consecutive flushes loses its age
            # series — stale quantiles (the last interval's age,
            # growing meaningless as the plane stays quiet) must not
            # keep rendering in /metrics and /debug/latency. The series
            # is recreated fresh when traffic returns.
            for plane in list(self._age_hists):
                if plane in out:
                    self._age_idle[plane] = 0
                    continue
                idle = self._age_idle.get(plane, 0) + 1
                if idle >= self.AGE_IDLE_SUPPRESS:
                    del self._age_hists[plane]
                    self._age_idle.pop(plane, None)
                else:
                    self._age_idle[plane] = idle
        return out

    def observe_sample_age(self, watermarks: Dict[str, tuple],
                           ack_unix: float) -> None:
        """Feed each plane's sample-age llhist once the flush's sinks
        have acked: one observation for the interval's oldest sample
        (worst case) and one for its newest (best case) bracket the
        whole interval's staleness."""
        if not self.enabled or not watermarks:
            return
        for plane, (oldest, newest) in watermarks.items():
            hist = self._age_hist(plane)
            hist.observe(max(0.0, ack_unix - oldest))
            hist.observe(max(0.0, ack_unix - newest))

    def _age_hist(self, plane: str) -> LatencyHist:
        with self._lock:
            hist = self._age_hists.get(plane)
            if hist is None:
                hist = self._age_hists[plane] = LatencyHist(
                    f"pipeline.sample_age:{plane}")
            return hist

    # -- egress encode/send split ----------------------------------------

    def note_egress(self, sink: str, encode_s: float, send_s: float,
                    gzip_s: Optional[float] = None) -> None:
        """Record one sink flush's encode-vs-send wall split (fed by
        MetricSink.note_egress): the waterfall's answer to whether a
        slow sink burns CPU (encode) or waits on the network (send).
        `gzip_s`, where the sink measures it, is the compression's share
        of the send (its `egress.gzip_s` row)."""
        if not self.enabled:
            return
        phases = [("encode", encode_s), ("send", send_s)]
        if gzip_s is not None:
            phases.append(("gzip", gzip_s))
        for phase, v in phases:
            with self._lock:
                hist = self._egress_hists.get((phase, sink))
                if hist is None:
                    hist = self._egress_hists[(phase, sink)] = LatencyHist(
                        f"egress.{phase}_s:{sink}")
            hist.observe(max(0.0, float(v)))

    # -- export ----------------------------------------------------------

    def telemetry_rows(self) -> List[tuple]:
        """Scrape-time /metrics rows: per-queue depth/capacity gauges
        and dwell quantiles, per-plane sample-age quantiles."""
        if not self.enabled:
            return []
        with self._lock:
            queues = dict(self._queues)
            q_hists = dict(self._queue_hists)
            age_hists = dict(self._age_hists)
            egress_hists = dict(self._egress_hists)
        rows: List[tuple] = []
        for name, (depth_fn, capacity) in queues.items():
            tags = [f"queue:{name}"]
            try:
                depth = float(depth_fn())
            except Exception:
                continue
            rows.append(("queue.depth", "gauge", depth, tags))
            rows.append(("queue.capacity", "gauge", float(capacity), tags))
        # each llhist series renders <base>.{p50,p99,max} gauges and a
        # <base>.count counter
        for base, tag_key, hists in (
                ("queue.dwell", "queue", q_hists),
                ("pipeline.sample_age", "plane", age_hists),
                ("egress.encode_s", "sink",
                 {s: h for (ph, s), h in egress_hists.items()
                  if ph == "encode"}),
                ("egress.send_s", "sink",
                 {s: h for (ph, s), h in egress_hists.items()
                  if ph == "send"}),
                ("egress.gzip_s", "sink",
                 {s: h for (ph, s), h in egress_hists.items()
                  if ph == "gzip"})):
            for key, hist in hists.items():
                snap = hist.snapshot()
                tags = [f"{tag_key}:{key}"]
                for label in ("p50", "p99", "max"):
                    rows.append((f"{base}.{label}", "gauge",
                                 snap[label], tags))
                rows.append((f"{base}.count", "counter",
                             float(snap["count"]), tags))
        return rows

    def report(self) -> dict:
        """The GET /debug/latency payload: full llhist summaries per
        plane and per queue, and live depths."""
        with self._lock:
            queues = dict(self._queues)
            q_hists = dict(self._queue_hists)
            age_hists = dict(self._age_hists)
            egress_hists = dict(self._egress_hists)
            marks = {plane: {"oldest_unix": round(m.oldest, 3),
                             "newest_unix": round(m.newest, 3),
                             "batches": m.batches, "samples": m.samples}
                     for plane, m in self._marks.items()}
        planes = {plane: hist.snapshot() for plane, hist in age_hists.items()}
        qs = {}
        for name, hist in q_hists.items():
            qs[name] = {"dwell": hist.snapshot()}
        for name, (depth_fn, capacity) in queues.items():
            entry = qs.setdefault(name, {})
            try:
                entry["depth"] = int(depth_fn())
            except Exception:
                entry["depth"] = None
            entry["capacity"] = capacity
        egress: Dict[str, dict] = {}
        for (phase, sink), hist in egress_hists.items():
            egress.setdefault(sink, {})[phase] = hist.snapshot()
        return {
            "enabled": self.enabled,
            "generated_unix": round(time.time(), 3),
            "sample_age": planes,
            "pending_watermarks": marks,
            "queues": qs,
            "egress": egress,
        }


# -- flush waterfall -------------------------------------------------------

def family_segments_sum(families: dict) -> float:
    """Sum of every attributed segment in one round's family tree: the
    number the waterfall pins against the recorded `dispatch_s` +
    `device_sync_s` totals. It holds for overlapped rounds too, whose
    family segments and phase totals are both measured inside the same
    background readout."""
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
    newest last. Overlapped rounds (`flush_async`) are marked
    `async_readout`, `delivered_flush` names the interval whose readout
    the tick delivered, each family segment carries `lane: "async"`, and
    `critical_path_s` is the wall time left on the flush loop."""
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
