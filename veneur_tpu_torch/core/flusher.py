"""Flush generation: device snapshots -> columnar FlushBatch (torch port of
the columnar flush in veneur_tpu/core/flusher.py).

The port's server does not forward, so it flushes as a server without a
forward_address does in the reference (flusher.go:26-122,
samplers.go:359-514):

* Mixed-scope and local-only histograms/timers emit percentiles AND the
  configured aggregates from the locally-ingested stats; global-only
  rows emit them from the digest ("global" aggregate values).
* Log-linear histograms emit the configured percentiles, the midpoint
  `.sum`, the exact `.count`, and Prometheus-shaped cumulative
  `.bucket` counters tagged `le:<bound>` (JAX flusher.py:818-875).
* Sets emit their HLL estimate as a gauge.
* Counters, gauges and status checks emit every touched row.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from veneur_tpu_torch.core.columnstore import ColumnStore
from veneur_tpu_torch.ops import llhist_ref
from veneur_tpu_torch.samplers.metrics import (
    Aggregate, HistogramAggregates, InterMetric, MetricScope, MetricType,
)


def _percentile_name(name: str, p: float) -> str:
    # reference naming truncates: 0.999 -> "99percentile" (samplers.go:498)
    return f"{name}.{int(p * 100)}percentile"


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else format(bound, ".12g")


# `le:<bound>` tag strings for every sorted llhist bin plus the final
# `le:+Inf`, index-aligned with BucketSection.csum columns
LE_TAGS = tuple([f"le:{_fmt_le(u)}" for u in llhist_ref.UPPER_SORTED]
                + ["le:+Inf"])


# plain-int aggregate masks (IntFlag's __and__ allocates per test)
_A_MIN = int(Aggregate.MIN)
_A_MAX = int(Aggregate.MAX)
_A_MEDIAN = int(Aggregate.MEDIAN)
_A_AVERAGE = int(Aggregate.AVERAGE)
_A_COUNT = int(Aggregate.COUNT)
_A_SUM = int(Aggregate.SUM)
_A_HMEAN = int(Aggregate.HARMONIC_MEAN)


@dataclass
class FlushSection:
    """One homogeneous column group: parallel names/values/tags arrays
    sharing a metric type. `tags` entries are per-row list refs shared
    with RowMeta — consumers must copy before mutating (materialize
    does)."""

    names: np.ndarray   # object ndarray of str
    values: np.ndarray  # float64
    tags: np.ndarray    # object ndarray of List[str] (shared refs)
    mtype: MetricType


@dataclass
class BucketSection:
    """Cumulative llhist bucket columns: one row per emitted llhist, the
    full cumulative sum over its value-sorted bins. A row materializes
    as COUNTER `<name>` lines tagged `le:<bound>` for every NONZERO
    sorted bin (mask `nz`) plus an unconditional `le:+Inf` line carrying
    `csum[:, -1]`. The `le:` tag strings are shared and index-aligned via
    `LE_TAGS`; `tags` rows are base tag-list refs (copy before
    mutating)."""

    names: np.ndarray  # object ndarray of str ("<base>.bucket")
    tags: np.ndarray   # object ndarray of List[str] (base tags, no le:)
    csum: np.ndarray   # (rows, bins) float64 cumulative counts
    nz: np.ndarray     # (rows, bins) bool — sorted bin is nonzero

    def line_count(self) -> int:
        return int(self.nz.sum()) + self.names.shape[0]


class FlushBatch:
    """Columnar flush result. len() counts metrics; materialize() yields
    the List[InterMetric] (cached, thread-safe — sink flush threads share
    one materialization)."""

    def __init__(self, timestamp: int, sections: List[FlushSection],
                 extras: List[InterMetric],
                 bucket_sections: Optional[List[BucketSection]] = None):
        self.timestamp = timestamp
        self.sections = sections
        self.bucket_sections: List[BucketSection] = bucket_sections or []
        self.extras = extras  # statuses: carry message/hostname fields
        self._materialized: Optional[List[InterMetric]] = None
        self._mat_lock = threading.Lock()

    def __len__(self) -> int:
        return (sum(s.names.shape[0] for s in self.sections)
                + sum(b.line_count() for b in self.bucket_sections)
                + len(self.extras))

    def materialize(self) -> List[InterMetric]:
        with self._mat_lock:
            if self._materialized is None:
                ts = self.timestamp
                out: List[InterMetric] = []
                for sec in self.sections:
                    tp = sec.mtype
                    out.extend(
                        InterMetric(name=n, timestamp=ts, value=v,
                                    tags=list(t), type=tp)
                        for n, v, t in zip(sec.names.tolist(),
                                           sec.values.tolist(),
                                           sec.tags.tolist()))
                les = LE_TAGS
                for bs in self.bucket_sections:
                    nz, csum = bs.nz, bs.csum
                    for i, (nm, base) in enumerate(zip(bs.names.tolist(),
                                                       bs.tags.tolist())):
                        row = csum[i]
                        tags = list(base)
                        for k in np.flatnonzero(nz[i]).tolist():
                            out.append(InterMetric(
                                name=nm, timestamp=ts, value=float(row[k]),
                                tags=tags + [les[k]],
                                type=MetricType.COUNTER))
                        out.append(InterMetric(
                            name=nm, timestamp=ts, value=float(row[-1]),
                            tags=tags + ["le:+Inf"],
                            type=MetricType.COUNTER))
                out.extend(self.extras)
                self._materialized = out
            return self._materialized


def swap_columnstore(store: ColumnStore, percentiles: Sequence[float],
                     timings: Optional[dict] = None) -> dict:
    """Critical-path half of the flush: swap every family's pending
    columns and device generation out at ONE interval boundary, with no
    device readout work (each table's swap_out is O(1) under its locks).
    Ingest continues into the fresh generations the moment this returns.
    Statuses are host-only and snapshot in full here."""
    t0 = time.perf_counter()
    full_ps = tuple(percentiles)
    all_ps = tuple(sorted(set(full_ps) | {0.5}))  # median always computable
    swap = {
        "now": int(time.time()),
        "full_ps": full_ps,
        "all_ps": all_ps,
        "histogram": store.histos.swap_out(ps=all_ps),
        "llhist": store.llhists.swap_out(ps=full_ps),
        "counter": store.counters.swap_out(),
        "gauge": store.gauges.swap_out(),
        "set": store.sets.swap_out(),
        "status": store.statuses.snapshot_and_reset(),
    }
    if timings is not None:
        timings["swap_s"] = time.perf_counter() - t0
    return swap


def readout_columnstore(store: ColumnStore, swap: dict,
                        aggregates: HistogramAggregates,
                        timings: Optional[dict] = None) -> FlushBatch:
    """Readout half of the flush: launch every swapped generation's
    readout kernels, synchronise once, copy to the host, and assemble the
    FlushBatch. Touches no live table state beyond the recycle of the
    drained generations, so it may run concurrently with ingest.
    `timings`, when given, receives per-phase wall seconds (dispatch /
    device_sync / assembly, and inside device_sync the llhist family's
    device-to-host copy of its touched rows' bins, llhist_bins_s)."""
    t0 = time.perf_counter()
    now = swap["now"]
    sections: List[FlushSection] = []
    full_ps = swap["full_ps"]
    ps_index = {p: i for i, p in enumerate(swap["all_ps"])}
    full_bits = int(aggregates.value)
    global_code = int(MetricScope.GLOBAL_ONLY)

    # ---- phase 1: launch every device readout, wait for nothing --------
    h_snap = store.histos.readout(swap["histogram"])
    ll_snap = store.llhists.readout(swap["llhist"])
    c_snap = store.counters.readout(swap["counter"])
    g_snap = store.gauges.readout(swap["gauge"])
    # sets are host-dominant: the estimate of the promoted rows is copied
    # to the host inside readout
    set_snap = store.sets.readout(swap["set"])
    estimates, _registers, s_touched, s_meta = \
        store.sets.snapshot_finish(set_snap)
    st_vals, st_touched, st_meta = swap["status"]
    t_dispatch = time.perf_counter()

    # ---- phase 2: drain the device queue once, then copy ---------------
    store.synchronize()
    c_vals, c_touched, c_meta = store.counters.snapshot_finish(c_snap)
    g_vals, g_touched, g_meta = store.gauges.snapshot_finish(g_snap)
    out, h_touched, h_meta = store.histos.snapshot_finish(h_snap)
    t_bins = time.perf_counter()
    ll_out, ll_bins, ll_touched, ll_meta = \
        store.llhists.snapshot_finish(ll_snap)
    t_sync = time.perf_counter()
    # copies done: reset the drained generations in place as the next
    # interval's spares (no-op for the set snap, whose bank escaped into
    # the register view)
    store.counters.recycle(c_snap)
    store.gauges.recycle(g_snap)
    store.histos.recycle(h_snap)
    store.llhists.recycle(ll_snap)
    store.sets.recycle(set_snap)

    # ---- counters & gauges ---------------------------------------------
    def scalar_family(table, vals, touched, meta_list, mtype):
        rows = np.flatnonzero(touched)
        if rows.size:
            sections.append(FlushSection(
                table.flush_names("", rows, meta_list, lambda m: m.name),
                np.asarray(vals, np.float64)[rows],
                table.flush_tags(rows, meta_list), mtype))

    scalar_family(store.counters, c_vals, c_touched, c_meta,
                  MetricType.COUNTER)
    scalar_family(store.gauges, g_vals, g_touched, g_meta, MetricType.GAUGE)

    # ---- histograms & timers -------------------------------------------
    hr = np.flatnonzero(h_touched)
    if hr.size:
        htab = store.histos
        use_global = htab.scope_code[hr] == global_code
        cols = {k: np.asarray(out[k], np.float64)[hr]
                for k in ("lmin", "lmax", "lsum", "lweight", "lrecip",
                          "min", "max", "sum", "count", "hmean")}
        quants = np.asarray(out["quantiles"], np.float64)[hr]
        tags_hr = htab.flush_tags(hr, h_meta)

        def agg_section(suffix, bit, mask, values, mtype=MetricType.GAUGE):
            if not (full_bits & bit) or not mask.any():
                return
            sections.append(FlushSection(
                htab.flush_names(
                    suffix, hr[mask], h_meta,
                    lambda m, s=suffix: f"{m.name}.{s}"),
                values[mask], tags_hr[mask], mtype))

        lmin, lmax = cols["lmin"], cols["lmax"]
        lsum, lweight, lrecip = cols["lsum"], cols["lweight"], cols["lrecip"]
        dmin, dmax = cols["min"], cols["max"]
        dsum, dcount = cols["sum"], cols["count"]
        with np.errstate(divide="ignore", invalid="ignore"):
            avg = np.where(use_global, dsum / np.where(dcount, dcount, 1.0),
                           lsum / np.where(lweight, lweight, 1.0))
            hmean = np.where(use_global, cols["hmean"],
                             lweight / np.where(lrecip, lrecip, 1.0))
        agg_section("max", _A_MAX, ~np.isinf(lmax) | use_global,
                    np.where(use_global, dmax, lmax))
        agg_section("min", _A_MIN, ~np.isinf(lmin) | use_global,
                    np.where(use_global, dmin, lmin))
        agg_section("sum", _A_SUM, (lsum != 0) | use_global,
                    np.where(use_global, dsum, lsum))
        agg_section("avg", _A_AVERAGE,
                    use_global | ((lsum != 0) & (lweight != 0)), avg)
        agg_section("count", _A_COUNT, (lweight != 0) | use_global,
                    np.where(use_global, dcount, lweight),
                    MetricType.COUNTER)
        agg_section("median", _A_MEDIAN, np.ones(hr.size, bool),
                    quants[:, ps_index[0.5]])
        agg_section("hmean", _A_HMEAN,
                    use_global | ((lrecip != 0) & (lweight != 0)), hmean)
        for p in full_ps:
            sections.append(FlushSection(
                htab.flush_names(
                    p, hr, h_meta,
                    lambda m, p=p: _percentile_name(m.name, p)),
                quants[:, ps_index[p]], tags_hr, MetricType.GAUGE))

    # ---- sets -----------------------------------------------------------
    sr = np.flatnonzero(s_touched)
    if sr.size:
        stab = store.sets
        sections.append(FlushSection(
            stab.flush_names("", sr, s_meta, lambda m: m.name),
            np.asarray(estimates, np.float64)[sr],
            stab.flush_tags(sr, s_meta), MetricType.GAUGE))

    # ---- log-linear histograms ------------------------------------------
    # percentiles/sum/count columnarize like every other family; the
    # variable-length cumulative buckets become a BucketSection, exploded
    # per row only by materialize(). The readout and the bins are both
    # compact over the touched rows, in ascending row order.
    bucket_sections: List[BucketSection] = []
    llr = np.flatnonzero(ll_touched)
    if llr.size:
        lltab = store.llhists
        tags_ll = lltab.flush_tags(llr, ll_meta)
        quants = np.asarray(ll_out["quantiles"], np.float64)
        for j, p in enumerate(full_ps):
            sections.append(FlushSection(
                lltab.flush_names(
                    p, llr, ll_meta,
                    lambda m, p=p: _percentile_name(m.name, p)),
                quants[:, j], tags_ll, MetricType.GAUGE))
        # count and sum from the HOST-side int64 bins: the count must
        # equal the le:+Inf bucket exactly (both are the same registers)
        sections.append(FlushSection(
            lltab.flush_names("sum", llr, ll_meta,
                              lambda m: f"{m.name}.sum"),
            ll_bins.astype(np.float64) @ llhist_ref.BIN_MID,
            tags_ll, MetricType.GAUGE))
        sections.append(FlushSection(
            lltab.flush_names("count", llr, ll_meta,
                              lambda m: f"{m.name}.count"),
            ll_bins.sum(axis=1).astype(np.float64),
            tags_ll, MetricType.COUNTER))
        c_sorted = ll_bins[:, llhist_ref.ORDER]
        bucket_sections.append(BucketSection(
            lltab.flush_names("bucket", llr, ll_meta,
                              lambda m: f"{m.name}.bucket"),
            tags_ll,
            np.cumsum(c_sorted, axis=1, dtype=np.float64),
            c_sorted != 0))

    # ---- status checks --------------------------------------------------
    extras: List[InterMetric] = []
    for row in np.flatnonzero(st_touched).tolist():
        meta = st_meta[row]
        entry = st_vals[row]
        extras.append(InterMetric(
            name=meta.name, timestamp=now, value=entry.value,
            tags=list(meta.tags), type=MetricType.STATUS,
            message=entry.message, hostname=entry.hostname))

    if timings is not None:
        timings["dispatch_s"] = t_dispatch - t0
        timings["device_sync_s"] = t_sync - t_dispatch
        timings["llhist_bins_s"] = t_sync - t_bins
        timings["assembly_s"] = time.perf_counter() - t_sync
    return FlushBatch(now, sections, extras, bucket_sections)


def flush_columnstore_batch(store: ColumnStore,
                            percentiles: Sequence[float],
                            aggregates: HistogramAggregates,
                            timings: Optional[dict] = None) -> FlushBatch:
    """Synchronous flush: swap + readout in one call."""
    swap = swap_columnstore(store, percentiles, timings=timings)
    return readout_columnstore(store, swap, aggregates, timings=timings)
