"""Backfill plane: interval-bucketed merges of stale forwarded state (port
of veneur_tpu/forward/backfill.py).

The durable WAL (util/spool.py) lets a local replay intervals hours
after they happened — a crashed peer's spool directory restored to a
fresh node, a long regional outage's backlog. Before this module, the
global's import path folded everything into the CURRENT flush interval,
so a recovered fleet reported a false traffic spike instead of
backfilled history. Here, imports stamped with an interval-start
timestamp (`x-veneur-interval` metadata, or metricpb field 11 on the
segment bytes) that is older than the live window are merged into
per-interval host-side buckets instead of the device store, and each
bucket flushes `InterMetric`s carrying its ORIGINAL interval timestamp
— which the Datadog/Cortex/Prometheus-shaped sinks emit as
timestamped backfill series.

Merge semantics per family match the device store's (the Circllhist
paper's guarantee — register adds are exact regardless of arrival
order — is what makes replay correctness a plumbing problem):

- counters SUM; gauges last-write-wins;
- llhists ADD registers (bit-exact with a live merge of the same
  segments, the property the crash drill pins);
- sets MAX HyperLogLog registers (estimate emitted at close);
- t-digest histograms concatenate centroids (min/max/sum exact;
  percentiles interpolated over the merged centroid set).

Buckets are bounded: at most `max_open` historical intervals stay open,
oldest-first close when a new interval would exceed the bound; an open
bucket closes at the first flush that saw no new merges for it. The
`ledger` (the server's core/ledger.py FlowLedger) books
`backfill.merged` and `backfill.closed` notes, the two sides of the
server's `backfill` identity, with the open buckets as its stock.

Everything here is host-side numpy: a replay never touches the device
store.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from veneur_tpu_torch.forward import hllwire, llhistwire
from veneur_tpu_torch.ops import hll_ref, llhist_ref
from veneur_tpu_torch.samplers.metrics import InterMetric, MetricType

logger = logging.getLogger("veneur_tpu_torch.forward.backfill")


def _percentile_name(name: str, p: float) -> str:
    return f"{name}.{int(p * 100)}percentile"


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else format(bound, ".12g")


def _decode_hll_payload(data: bytes) -> Optional[np.ndarray]:
    """Forwarded HLL payload -> registers (axiomhq binary or the raw
    register dump); None when undecodable."""
    if len(data) == hll_ref.M:
        return np.frombuffer(data, np.int8).copy()
    try:
        regs, p = hllwire.unmarshal(data)
    except hllwire.HLLWireError:
        return None
    if p != hll_ref.P:
        return None
    return regs.astype(np.int8)


class _Bucket:
    """One historical interval's mergeable state, keyed by
    (name, tags tuple) per family."""

    __slots__ = ("interval_unix", "accepted", "generation",
                 "counters", "gauges", "llhists", "sets", "histograms")

    def __init__(self, interval_unix: int, generation: int):
        self.interval_unix = interval_unix
        self.accepted = 0
        self.generation = generation
        self.counters: Dict[tuple, float] = {}
        self.gauges: Dict[tuple, float] = {}
        self.llhists: Dict[tuple, np.ndarray] = {}
        self.sets: Dict[tuple, np.ndarray] = {}
        # key -> [means list, weights list, min, max, sum-ish via
        # centroid mass; reciprocalSum tracked for parity]
        self.histograms: Dict[tuple, list] = {}


class BackfillPlane:
    """Bounded per-interval merge buckets + original-timestamp
    emission. Thread-safe: merges arrive on gRPC handler threads,
    drains on the flush loop."""

    def __init__(self, percentiles=(0.5, 0.75, 0.99),
                 max_open: int = 8, ledger=None, on_event=None,
                 clock=time.time):
        self.percentiles = tuple(percentiles)
        self.max_open = max(1, int(max_open))
        self.ledger = ledger
        self.on_event = on_event
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[int, _Bucket] = {}
        self._generation = 0
        # emissions from bound-forced closes, delivered at next drain
        self._pending: List[InterMetric] = []
        self.merged_total = 0
        self.rejected_total = 0
        self.closed_total = 0          # metrics retired via bucket close
        self.emitted_series_total = 0  # InterMetric rows emitted
        self.bound_closed_total = 0    # buckets force-closed at the bound

    # -- merge -----------------------------------------------------------

    @property
    def open_metrics(self) -> int:
        """Accepted metrics across open buckets — the ledger's
        backfill_open inventory stock."""
        with self._lock:
            return sum(b.accepted for b in self._buckets.values())

    @property
    def open_intervals(self) -> int:
        with self._lock:
            return len(self._buckets)

    def _note(self, stage: str, n: int, key: str = "") -> None:
        led = self.ledger
        if led is not None and n:
            led.note(stage, n, key=key)

    def merge_proto(self, pbm, interval_unix: float) -> bool:
        """Merge one upb metricpb.Metric into the bucket of
        `interval_unix` (the per-metric field 11 stamp wins over the
        RPC-level stamp when present). Returns True when accepted."""
        stamp = int(pbm.interval) or int(interval_unix)
        if stamp <= 0:
            self.rejected_total += 1
            self._note("backfill.rejected", 1, key="unstamped")
            return False
        which = pbm.WhichOneof("value")
        if which is None:
            self.rejected_total += 1
            self._note("backfill.rejected", 1, key="no_value")
            return False
        key = (pbm.name, tuple(pbm.tags))
        forced: List[InterMetric] = []
        forced_metrics = 0
        with self._lock:
            bucket = self._buckets.get(stamp)
            if bucket is None:
                bucket = self._buckets[stamp] = _Bucket(
                    stamp, self._generation)
            bucket.generation = self._generation
            ok = self._merge_locked(bucket, key, which, pbm)
            if ok:
                bucket.accepted += 1
                self.merged_total += 1
            # bound AFTER the merge: when the incoming stamp is older
            # than every open bucket, its fresh bucket IS the oldest —
            # evicting it before the merge would orphan the metric
            # (merged but never emitted nor booked closed). Closing it
            # right after instead emits a one-metric interval.
            while len(self._buckets) > self.max_open:
                oldest = min(self._buckets)
                victim = self._buckets.pop(oldest)
                self.bound_closed_total += 1
                forced_metrics += victim.accepted
                forced.extend(self._emit_locked(victim))
        if forced:
            with self._lock:
                self._pending.extend(forced)
            # a bound-forced close retires its metrics from the open
            # stock NOW — booked immediately so a ledger close landing
            # before the next drain still balances
            self._note("backfill.closed", forced_metrics, key="bound")
            logger.warning(
                "backfill bucket bound (%d open): oldest interval "
                "closed early with %d series pending emission",
                self.max_open, len(forced))
        if ok:
            self._note("backfill.merged", 1)
        else:
            self.rejected_total += 1
            self._note("backfill.rejected", 1, key="undecodable")
        return ok

    def _merge_locked(self, bucket: _Bucket, key: tuple, which: str,
                      pbm) -> bool:
        if which == "counter":
            bucket.counters[key] = (bucket.counters.get(key, 0.0)
                                    + float(pbm.counter.value))
            return True
        if which == "gauge":
            bucket.gauges[key] = float(pbm.gauge.value)
            return True
        if which == "llhist":
            try:
                bins = llhistwire.unmarshal(pbm.llhist.bins)
            except llhistwire.LLHistWireError:
                return False
            have = bucket.llhists.get(key)
            if have is None:
                bucket.llhists[key] = np.asarray(bins, np.int64).copy()
            else:
                have += bins  # exact register ADD
            return True
        if which == "set":
            regs = _decode_hll_payload(pbm.set.hyper_log_log)
            if regs is None:
                return False
            have = bucket.sets.get(key)
            if have is None:
                bucket.sets[key] = regs
            else:
                np.maximum(have, regs, out=have)
            return True
        if which == "histogram":
            d = pbm.histogram.t_digest
            if not d.main_centroids:
                return False
            means = [c.mean for c in d.main_centroids]
            weights = [c.weight for c in d.main_centroids]
            have = bucket.histograms.get(key)
            if have is None:
                bucket.histograms[key] = [means, weights,
                                          float(d.min), float(d.max)]
            else:
                have[0].extend(means)
                have[1].extend(weights)
                have[2] = min(have[2], float(d.min))
                have[3] = max(have[3], float(d.max))
            return True
        return False

    # -- close / emission ------------------------------------------------

    def drain(self, force: bool = False) -> List[InterMetric]:
        """Close and emit every bucket not touched since the previous
        drain (every bucket with `force`), oldest first, plus anything a
        bound-forced close left pending. Called once per flush by the
        owning server; the emitted metrics carry the bucket's ORIGINAL
        interval timestamp and the `backfilled` flag the sinks render
        as timestamped series."""
        out: List[InterMetric] = []
        closed_buckets: List[_Bucket] = []
        with self._lock:
            out, self._pending = self._pending, []
            for stamp in sorted(self._buckets):
                bucket = self._buckets[stamp]
                if force or bucket.generation < self._generation:
                    closed_buckets.append(self._buckets.pop(stamp))
            self._generation += 1
            for bucket in closed_buckets:
                out.extend(self._emit_locked(bucket))
        closed_metrics = sum(b.accepted for b in closed_buckets)
        self._note("backfill.closed", closed_metrics)
        if out and self.on_event is not None:
            try:
                self.on_event(
                    "backfill_emitted", series=len(out),
                    intervals=[b.interval_unix for b in closed_buckets])
            except Exception:
                pass
        return out

    def _emit_locked(self, bucket: _Bucket) -> List[InterMetric]:
        """InterMetrics for one closed bucket, timestamped at the
        bucket's interval start. Counter/llhist emission is exact;
        set estimates and digest percentiles carry their families'
        usual approximation."""
        ts = bucket.interval_unix
        out: List[InterMetric] = []

        def emit(name, value, tags, mtype=MetricType.GAUGE):
            out.append(InterMetric(
                name=name, timestamp=ts, value=float(value),
                tags=list(tags), type=mtype, backfilled=True))

        for (name, tags), value in bucket.counters.items():
            emit(name, value, tags, MetricType.COUNTER)
        for (name, tags), value in bucket.gauges.items():
            emit(name, value, tags)
        for (name, tags), regs in bucket.sets.items():
            emit(name, hll_ref.estimate_from_registers(regs), tags)
        ps = self.percentiles
        order = llhist_ref.ORDER
        upper = llhist_ref.UPPER_SORTED
        for (name, tags), bins in bucket.llhists.items():
            if ps:
                qs = llhist_ref.quantiles(bins, ps)
                for p, q in zip(ps, qs):
                    emit(_percentile_name(name, p), q, tags)
            emit(f"{name}.sum",
                 float(bins.astype(np.float64) @ llhist_ref.BIN_MID), tags)
            emit(f"{name}.count", float(bins.sum()), tags,
                 MetricType.COUNTER)
            c_sorted = bins[order]
            csum = np.cumsum(c_sorted)
            for k in np.flatnonzero(c_sorted).tolist():
                out.append(InterMetric(
                    name=f"{name}.bucket", timestamp=ts,
                    value=float(csum[k]),
                    tags=list(tags) + [f"le:{_fmt_le(upper[k])}"],
                    type=MetricType.COUNTER, backfilled=True))
            out.append(InterMetric(
                name=f"{name}.bucket", timestamp=ts, value=float(csum[-1]),
                tags=list(tags) + ["le:+Inf"],
                type=MetricType.COUNTER, backfilled=True))
        for (name, tags), (means, weights, dmin, dmax) in \
                bucket.histograms.items():
            w = np.asarray(weights, np.float64)
            mn = np.asarray(means, np.float64)
            total = float(w.sum())
            if total <= 0:
                continue
            emit(f"{name}.min", dmin, tags)
            emit(f"{name}.max", dmax, tags)
            emit(f"{name}.count", total, tags, MetricType.COUNTER)
            emit(f"{name}.sum", float(mn @ w), tags)
            emit(f"{name}.avg", float(mn @ w) / total, tags)
            if ps:
                order_h = np.argsort(mn, kind="stable")
                cw = np.cumsum(w[order_h])
                sorted_means = mn[order_h]
                for p in ps:
                    target = p * total
                    idx = int(np.searchsorted(cw, target, side="left"))
                    idx = min(idx, sorted_means.size - 1)
                    emit(_percentile_name(name, p), sorted_means[idx],
                         tags)
        self.closed_total += bucket.accepted
        self.emitted_series_total += len(out)
        return out

    # -- telemetry -------------------------------------------------------

    def telemetry_rows(self) -> List[tuple]:
        with self._lock:
            open_intervals = len(self._buckets)
            open_metrics = sum(b.accepted for b in self._buckets.values())
        return [
            ("wal.backfill.open_intervals", "gauge",
             float(open_intervals), ()),
            ("wal.backfill.open_metrics", "gauge", float(open_metrics), ()),
            ("wal.backfill.merged", "counter", float(self.merged_total), ()),
            ("wal.backfill.rejected", "counter",
             float(self.rejected_total), ()),
            ("wal.backfill.closed", "counter", float(self.closed_total), ()),
            ("wal.backfill.emitted", "counter",
             float(self.emitted_series_total), ()),
            ("wal.backfill.bound_closed", "counter",
             float(self.bound_closed_total), ()),
        ]
