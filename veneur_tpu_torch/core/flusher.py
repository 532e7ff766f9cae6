"""Flush generation: device snapshots -> columnar FlushBatch + forwardable
state (torch port of the columnar flush in veneur_tpu/core/flusher.py).

Semantic parity with reference flusher.go:26-122 and samplers.go:359-514.
A server is local iff it forwards (`forward_address` set):

* Counters and gauges: global-only rows forward on a local server and
  flush on the global one; mixed and local-only rows flush locally.
* Histograms/timers: on a local server a global-only row emits nothing,
  mixed rows emit only the configured aggregates (from the locally
  ingested stats), and local-only rows emit percentiles and aggregates;
  every non-local row's digest is exported. A global server emits
  percentiles and aggregates for every row, global-only rows with
  digest-derived ("global") aggregate values.
* Sets emit their HLL estimate as a gauge: on a local server only the
  local-only rows, and the others forward their registers.
* Log-linear histograms emit the configured percentiles, the midpoint
  `.sum`, the exact `.count`, and Prometheus-shaped cumulative `.bucket`
  counters tagged `le:<bound>` (JAX flusher.py:818-875); on a local
  server the non-local rows forward their bins instead.
* Status checks emit every touched row.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from veneur_tpu_torch.core.columnstore import ColumnStore, RowMeta
from veneur_tpu_torch.ops import llhist_ref
from veneur_tpu_torch.samplers.metrics import (
    Aggregate, HistogramAggregates, InterMetric, MetricScope, MetricType,
)


@dataclass
class ForwardableState:
    """Host-side snapshot of mergeable state bound for the global tier
    (the equivalent of reference worker.go:180-217 ForwardableMetrics)."""

    counters: List[Tuple[RowMeta, float]] = field(default_factory=list)
    gauges: List[Tuple[RowMeta, float]] = field(default_factory=list)
    # (meta, means, weights, min, max, reciprocal_sum)
    histograms: List[Tuple[RowMeta, np.ndarray, np.ndarray, float, float,
                           float]] = field(default_factory=list)
    # (meta, registers)
    sets: List[Tuple[RowMeta, np.ndarray]] = field(default_factory=list)
    # (meta, llhist bins int64): exact-merge family, registers ADD
    llhists: List[Tuple[RowMeta, np.ndarray]] = field(default_factory=list)
    # pre-serialized metricpb frames (forward/convert.forwardable_to_wire);
    # a carryover merge invalidates them (util/resilience.py)
    wire: Optional[List[bytes]] = None

    def __len__(self):
        return (len(self.counters) + len(self.gauges) + len(self.histograms)
                + len(self.sets) + len(self.llhists))

    def invalidate_wire(self) -> None:
        self.wire = None


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


def swap_columnstore(store: ColumnStore, is_local: bool,
                     percentiles: Sequence[float],
                     collect_forward: bool = True,
                     timings: Optional[dict] = None) -> dict:
    """Critical-path half of the flush: swap every family's pending
    columns and device generation out at ONE interval boundary, with no
    device readout work (each table's swap_out is O(1) under its locks).
    Ingest continues into the fresh generations the moment this returns.
    Statuses are host-only and snapshot in full here. A local server that
    collects forwardable state asks the t-digest table for the export."""
    t0 = time.perf_counter()
    full_ps = tuple(percentiles)
    all_ps = tuple(sorted(set(full_ps) | {0.5}))  # median always computable
    swap = {
        "now": int(time.time()),
        "full_ps": full_ps,
        "all_ps": all_ps,
        "histogram": store.histos.swap_out(
            ps=all_ps, need_export=is_local and collect_forward),
        "llhist": store.llhists.swap_out(ps=full_ps),
        "counter": store.counters.swap_out(),
        "gauge": store.gauges.swap_out(),
        "set": store.sets.swap_out(),
        "status": store.statuses.snapshot_and_reset(),
    }
    if timings is not None:
        timings["swap_s"] = time.perf_counter() - t0
    return swap


def readout_columnstore(store: ColumnStore, swap: dict, is_local: bool,
                        aggregates: HistogramAggregates,
                        collect_forward: bool = True,
                        timings: Optional[dict] = None,
                        device_lock=None
                        ) -> Tuple[FlushBatch, ForwardableState]:
    """Readout half of the flush: launch every swapped generation's
    readout kernels, synchronise once, copy to the host, and assemble the
    FlushBatch and the ForwardableState (empty unless `is_local` and
    `collect_forward`). Touches no live table state beyond the recycle of
    the drained generations, so it may run concurrently with ingest.
    `device_lock`, when given, is held over the device half (launch,
    sync, host copies, recycle) and released before the assembly; the
    wait for it adds to `readout_lock_wait_s`.
    `timings`, when given, receives per-phase wall seconds (dispatch /
    device_sync / assembly, and inside device_sync the llhist family's
    device-to-host copy of its touched rows' bins, llhist_bins_s)."""
    t0 = time.perf_counter()
    now = swap["now"]
    fwd = ForwardableState()
    sections: List[FlushSection] = []
    full_ps = swap["full_ps"]
    ps_index = {p: i for i, p in enumerate(swap["all_ps"])}
    need_export = is_local and collect_forward
    full_bits = int(aggregates.value)
    local_code = int(MetricScope.LOCAL_ONLY)
    global_code = int(MetricScope.GLOBAL_ONLY)

    with device_lock if device_lock is not None else nullcontext():
        t_locked = time.perf_counter()
        # ---- phase 1: launch every device readout, wait for nothing ----
        h_snap = store.histos.readout(swap["histogram"])
        ll_snap = store.llhists.readout(swap["llhist"])
        c_snap = store.counters.readout(swap["counter"])
        g_snap = store.gauges.readout(swap["gauge"])
        # sets are host-dominant: the estimate of the promoted rows is
        # copied to the host right away
        set_snap = store.sets.readout(swap["set"])
        estimates, registers, s_touched, s_meta = \
            store.sets.snapshot_finish(set_snap)
        st_vals, st_touched, st_meta = swap["status"]
        t_dispatch = time.perf_counter()

        # ---- phase 2: drain the device queue once, then copy -----------
        store.synchronize()
        c_vals, c_touched, c_meta = store.counters.snapshot_finish(c_snap)
        g_vals, g_touched, g_meta = store.gauges.snapshot_finish(g_snap)
        out, export, h_touched, h_meta = store.histos.snapshot_finish(h_snap)
        t_bins = time.perf_counter()
        ll_out, ll_bins, ll_touched, ll_meta = \
            store.llhists.snapshot_finish(ll_snap)
        t_sync = time.perf_counter()
        # copies done: reset the drained generations in place as the
        # next interval's spares (no-op for the set snap, whose bank
        # escaped into the register view)
        store.counters.recycle(c_snap)
        store.gauges.recycle(g_snap)
        store.histos.recycle(h_snap)
        store.llhists.recycle(ll_snap)
        store.sets.recycle(set_snap)

    # ---- counters & gauges ---------------------------------------------
    def scalar_family(table, vals, touched, meta_list, mtype, fwd_list):
        rows = np.flatnonzero(touched)
        vals_sel = np.asarray(vals, np.float64)[rows]
        if is_local and rows.size:
            fwd_mask = table.scope_code[rows] == global_code
            if collect_forward:
                fwd_list.extend(
                    (meta_list[r], v)
                    for r, v in zip(rows[fwd_mask].tolist(),
                                    vals_sel[fwd_mask].tolist()))
            rows, vals_sel = rows[~fwd_mask], vals_sel[~fwd_mask]
        if rows.size:
            sections.append(FlushSection(
                table.flush_names("", rows, meta_list, lambda m: m.name),
                vals_sel, table.flush_tags(rows, meta_list), mtype))

    scalar_family(store.counters, c_vals, c_touched, c_meta,
                  MetricType.COUNTER, fwd.counters)
    scalar_family(store.gauges, g_vals, g_touched, g_meta, MetricType.GAUGE,
                  fwd.gauges)

    # ---- histograms & timers -------------------------------------------
    hr = np.flatnonzero(h_touched)
    if hr.size:
        htab = store.histos
        scope = htab.scope_code[hr]
        local_only = scope == local_code
        global_only = scope == global_code
        # on a local server a global-only row emits no aggregates, and
        # only local-only rows emit percentiles
        a_on = np.where(global_only & is_local, 0, full_bits)
        use_global = global_only & (not is_local)
        emit_ps = local_only | (not is_local)
        cols = {k: np.asarray(out[k], np.float64)[hr]
                for k in ("lmin", "lmax", "lsum", "lweight", "lrecip",
                          "min", "max", "sum", "count", "hmean")}
        quants = np.asarray(out["quantiles"], np.float64)[hr]
        tags_hr = htab.flush_tags(hr, h_meta)

        def agg_section(suffix, bit, mask, values, mtype=MetricType.GAUGE):
            mask = mask & ((a_on & bit) != 0)
            if not mask.any():
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
        if full_ps and emit_ps.any():
            pr, pq, ptags = hr[emit_ps], quants[emit_ps], tags_hr[emit_ps]
            for p in full_ps:
                sections.append(FlushSection(
                    htab.flush_names(
                        p, pr, h_meta,
                        lambda m, p=p: _percentile_name(m.name, p)),
                    pq[:, ps_index[p]], ptags, MetricType.GAUGE))

        fr = hr[~local_only]
        if need_export and fr.size:
            # one fancy-index copy into compact float32 matrices, then row
            # views: each row is the (C,) float32 row the native digest
            # encoder takes
            exp_means, exp_weights, exp_min, exp_max, exp_recip = export
            cm, cw = exp_means[fr], exp_weights[fr]
            cmin, cmax = exp_min[fr].tolist(), exp_max[fr].tolist()
            crecip = exp_recip[fr].tolist()
            fwd.histograms.extend(
                (h_meta[row], cm[j], cw[j], cmin[j], cmax[j], crecip[j])
                for j, row in enumerate(fr.tolist()))

    # ---- sets -----------------------------------------------------------
    sr = np.flatnonzero(s_touched)
    if sr.size:
        stab = store.sets
        er = sr
        if is_local:
            s_local = stab.scope_code[sr] == local_code
            if collect_forward:
                fwd.sets.extend((s_meta[row], registers[row].copy())
                                for row in sr[~s_local].tolist())
            er = sr[s_local]
        if er.size:
            sections.append(FlushSection(
                stab.flush_names("", er, s_meta, lambda m: m.name),
                np.asarray(estimates, np.float64)[er],
                stab.flush_tags(er, s_meta), MetricType.GAUGE))

    # ---- log-linear histograms ------------------------------------------
    # percentiles/sum/count columnarize like every other family; the
    # variable-length cumulative buckets become a BucketSection, exploded
    # per row only by materialize(). The readout and the bins are both
    # compact over the touched rows, in ascending row order.
    bucket_sections: List[BucketSection] = []
    llr = np.flatnonzero(ll_touched)
    quants = np.asarray(ll_out.get("quantiles", ()), np.float64)
    if is_local and llr.size:
        # bins and readout are compact over llr: split both by scope
        fwd_mask = store.llhists.scope_code[llr] != local_code
        if need_export:
            fwd.llhists.extend(
                (ll_meta[row], ll_bins[j])
                for j, row in zip(np.flatnonzero(fwd_mask).tolist(),
                                  llr[fwd_mask].tolist()))
        llr, ll_bins, quants = (llr[~fwd_mask], ll_bins[~fwd_mask],
                                quants[~fwd_mask])
    if llr.size:
        lltab = store.llhists
        tags_ll = lltab.flush_tags(llr, ll_meta)
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
        if device_lock is not None:
            timings["readout_lock_wait_s"] = (
                timings.get("readout_lock_wait_s", 0.0) + t_locked - t0)
        timings["dispatch_s"] = t_dispatch - t_locked
        timings["device_sync_s"] = t_sync - t_dispatch
        timings["llhist_bins_s"] = t_sync - t_bins
        timings["assembly_s"] = time.perf_counter() - t_sync
    return FlushBatch(now, sections, extras, bucket_sections), fwd


def flush_columnstore_batch(store: ColumnStore, is_local: bool,
                            percentiles: Sequence[float],
                            aggregates: HistogramAggregates,
                            collect_forward: bool = True,
                            timings: Optional[dict] = None,
                            device_lock=None
                            ) -> Tuple[FlushBatch, ForwardableState]:
    """Synchronous flush: swap + readout in one call. `device_lock`, when
    given, is held over the swap and, separately, over the readout's
    device half (readout_columnstore)."""
    t0 = time.perf_counter()
    with device_lock if device_lock is not None else nullcontext():
        if timings is not None and device_lock is not None:
            timings["readout_lock_wait_s"] = time.perf_counter() - t0
        swap = swap_columnstore(store, is_local, percentiles,
                                collect_forward=collect_forward,
                                timings=timings)
    return readout_columnstore(store, swap, is_local, aggregates,
                               collect_forward=collect_forward,
                               timings=timings, device_lock=device_lock)
