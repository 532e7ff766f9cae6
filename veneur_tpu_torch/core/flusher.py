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
  server the non-local rows forward their bins instead. The device
  compacts the readout to each row's nonzero value-sorted bins and their
  cumulative counts, and only those are copied to the host
  (batch_llhist.CompactBuckets); a forwarded row's registers are
  rebuilt from them exactly.
* Status checks emit every touched row.

While the span recorder (core/profiling.py) is armed, the phases' clock
readings, taken for the flush's timings anyway, are also its spans:
`flush.swap`, one `flush.readout.<family>` per family's dispatch,
`flush.sync` (the device sync and the host copies), inside it
`flush.llhist.compact` (the llhist family's compaction and copy, with
its rows, nonzero bins and bytes), and `flush.assembly`, inside it
`flush.llhist.assembly`.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.core.columnstore import ColumnStore, RowMeta
from veneur_tpu_torch.ops import llhist_ref, thread_launches
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
# `le:+Inf`, indexed by BucketSection.bins (and -1 for `le:+Inf`)
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
    """Cumulative llhist bucket columns, compact: one row per emitted
    llhist, whose NONZERO value-sorted bins are bins[offsets[i]:
    offsets[i + 1]] with cumulative counts cum[...] (a
    batch_llhist.CompactBuckets' columns). A row materializes as COUNTER
    `<name>` lines tagged `le:<bound>` for each of those bins plus an
    unconditional `le:+Inf` line carrying `total[i]`. The `le:` tag
    strings are shared and indexed by `bins` via `LE_TAGS`; `tags` rows
    are base tag-list refs (copy before mutating)."""

    names: np.ndarray    # object ndarray of str ("<base>.bucket")
    tags: np.ndarray     # object ndarray of List[str] (base tags, no le:)
    offsets: np.ndarray  # (rows + 1,) int64 — each row's span of bins
    bins: np.ndarray     # (nnz,) int64 — sorted bin, an index of LE_TAGS
    cum: np.ndarray      # (nnz,) float64 cumulative counts
    total: np.ndarray    # (rows,) float64 — the `le:+Inf` count

    def line_count(self) -> int:
        return self.cum.shape[0] + self.names.shape[0]


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
                    off, bins = bs.offsets.tolist(), bs.bins.tolist()
                    cum, total = bs.cum.tolist(), bs.total.tolist()
                    for i, (nm, base) in enumerate(zip(bs.names.tolist(),
                                                       bs.tags.tolist())):
                        tags = list(base)
                        for j in range(off[i], off[i + 1]):
                            out.append(InterMetric(
                                name=nm, timestamp=ts, value=cum[j],
                                tags=tags + [les[bins[j]]],
                                type=MetricType.COUNTER))
                        out.append(InterMetric(
                            name=nm, timestamp=ts, value=total[i],
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
        "llhist": store.llhists.swap_out(ps=full_ps, compact=True),
        "counter": store.counters.swap_out(),
        "gauge": store.gauges.swap_out(),
        "set": store.sets.swap_out(),
        "status": store.statuses.snapshot_and_reset(),
    }
    # the touched rows of the device families: the in-flight snapshot's
    # size, the ledger's flush_inflight_snapshot stock under flush_async
    swap["rows"] = int(sum(
        np.count_nonzero(swap[f].get("touched", ()))
        for f in ("histogram", "counter", "gauge", "llhist", "set")))
    t1 = time.perf_counter()
    if timings is not None:
        timings["swap_s"] = t1 - t0
    if profiling.armed:
        profiling.record("flush.swap", t0, t1)
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
    device_sync / assembly; inside device_sync the llhist family's
    compaction and device-to-host copy of its touched rows' nonzero
    bins, llhist_bins_s, with its bytes, llhist_copy_bytes, and nonzero
    bins, llhist_nonzero_bins; inside assembly the llhist family's,
    llhist_assembly_s) and
    per family a segment record under `families` (the flush's
    `flush.family` spans): the readout's wall-clock start (`base_unix`),
    the family's dispatch seconds and start offset, and for the device
    families its host-copy seconds (`transfer_s`), start offset and the
    one device sync they share, keyed by the device."""
    t0 = time.perf_counter()
    start_unix = time.time()
    now = swap["now"]
    fwd = ForwardableState()
    sections: List[FlushSection] = []
    full_ps = swap["full_ps"]
    ps_index = {p: i for i, p in enumerate(swap["all_ps"])}
    need_export = is_local and collect_forward
    full_bits = int(aggregates.value)
    local_code = int(MetricScope.LOCAL_ONLY)
    global_code = int(MetricScope.GLOBAL_ONLY)

    families: Dict[str, dict] = {}
    deviceobs = store.deviceobs
    launched = [thread_launches()]

    def mark(family: str, start: float) -> float:
        """Close one family's dispatch segment; returns the next start."""
        end = time.perf_counter()
        if deviceobs is not None and family != "status":
            # the kernel registry's readout row: the family's dispatch
            # seconds, and the kernels its readout launched
            n = thread_launches()
            deviceobs.note_kernel("readout", family, end - start,
                                  launches=n - launched[0])
            launched[0] = n
        families[family] = {"dispatch_s": end - start,
                             "dispatch_start_s": start - t0,
                             "transfer_s": 0.0, "devices": {},
                             "base_unix": start_unix}
        if profiling.armed:
            profiling.record(f"flush.readout.{family}", start, end)
        return end

    with device_lock if device_lock is not None else nullcontext():
        t_locked = time.perf_counter()
        # ---- phase 1: launch every device readout, wait for nothing ----
        tf = t_locked
        h_snap = store.histos.readout(swap["histogram"])
        tf = mark("histogram", tf)
        c_snap = store.counters.readout(swap["counter"])
        tf = mark("counter", tf)
        g_snap = store.gauges.readout(swap["gauge"])
        tf = mark("gauge", tf)
        ll_snap = store.llhists.readout(swap["llhist"])
        tf = mark("llhist", tf)
        # sets are host-dominant: the estimate of the promoted rows is
        # copied to the host right away
        set_snap = store.sets.readout(swap["set"])
        estimates, registers, s_touched, s_meta = \
            store.sets.snapshot_finish(set_snap)
        tf = mark("set", tf)
        st_vals, st_touched, st_meta = swap["status"]
        mark("status", tf)
        t_dispatch = time.perf_counter()

        # ---- phase 2: drain the device queue once, then copy -----------
        store.synchronize()
        t_synced = time.perf_counter()
        device = {str(store.device): {"sync_s": t_synced - t_dispatch}}

        def finish(family: str, fn):
            f_start = time.perf_counter()
            result = fn()
            rec = families[family]
            rec["device_start_s"] = f_start - t0
            rec["transfer_s"] = time.perf_counter() - f_start
            rec["devices"] = device
            return result

        c_vals, c_touched, c_meta = finish(
            "counter", lambda: store.counters.snapshot_finish(c_snap))
        g_vals, g_touched, g_meta = finish(
            "gauge", lambda: store.gauges.snapshot_finish(g_snap))
        out, export, h_touched, h_meta = finish(
            "histogram", lambda: store.histos.snapshot_finish(h_snap))
        t_bins = time.perf_counter()
        ll_out, ll_bins, ll_touched, ll_meta = finish(
            "llhist", lambda: store.llhists.snapshot_finish(ll_snap))
        t_sync = time.perf_counter()
        ll_copy = {"rows": int(np.count_nonzero(ll_touched)),
                   "nonzero_bins": ll_snap.get("nonzero_bins", 0),
                   "bytes": ll_snap.get("copy_bytes", 0)}
        if profiling.armed:
            profiling.record("flush.llhist.compact", t_bins, t_sync,
                             ll_copy)
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
        rows = _valid_rows(touched, meta_list)
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
    hr = _valid_rows(h_touched, h_meta)
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
    sr = _valid_rows(s_touched, s_meta)
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
    # per row only by materialize(). The readout and the compact bins
    # are both over the touched rows, in ascending row order.
    t_ll = time.perf_counter()
    bucket_sections: List[BucketSection] = []
    llr = np.flatnonzero(ll_touched)
    quants = np.asarray(ll_out.get("quantiles", ()), np.float64)
    counts = ll_bins.totals().astype(np.float64)
    if llr.size:
        # the readout and bins are compact over llr: drop stragglers
        # from all of them together
        keep = _live_mask(llr, ll_meta)
        if not keep.all():
            llr, quants, counts = llr[keep], quants[keep], counts[keep]
            ll_bins = ll_bins.take(keep)
    if is_local and llr.size:
        # bins and readout are compact over llr: split both by scope; a
        # forwarded row's registers are rebuilt from its compact bins
        fwd_mask = store.llhists.scope_code[llr] != local_code
        if need_export and fwd_mask.any():
            regs = ll_bins.take(fwd_mask).dense()
            fwd.llhists.extend(
                (ll_meta[row], regs[j])
                for j, row in enumerate(llr[fwd_mask].tolist()))
        llr, quants, counts = (llr[~fwd_mask], quants[~fwd_mask],
                               counts[~fwd_mask])
        ll_bins = ll_bins.take(~fwd_mask)
    if llr.size:
        lltab = store.llhists
        tags_ll = lltab.flush_tags(llr, ll_meta)
        for j, p in enumerate(full_ps):
            sections.append(FlushSection(
                lltab.flush_names(
                    p, llr, ll_meta,
                    lambda m, p=p: _percentile_name(m.name, p)),
                quants[:, j], tags_ll, MetricType.GAUGE))
        # count and sum from the exact int64 counts of the compact bins:
        # the count equals the le:+Inf bucket exactly (both are the same
        # registers)
        sections.append(FlushSection(
            lltab.flush_names("sum", llr, ll_meta,
                              lambda m: f"{m.name}.sum"),
            ll_bins.midpoint_sums(), tags_ll, MetricType.GAUGE))
        sections.append(FlushSection(
            lltab.flush_names("count", llr, ll_meta,
                              lambda m: f"{m.name}.count"),
            counts, tags_ll, MetricType.COUNTER))
        bucket_sections.append(BucketSection(
            lltab.flush_names("bucket", llr, ll_meta,
                              lambda m: f"{m.name}.bucket"),
            tags_ll, ll_bins.offsets, ll_bins.bins,
            ll_bins.cum.astype(np.float64), counts))
    t_ll_end = time.perf_counter()
    if profiling.armed:
        profiling.record("flush.llhist.assembly", t_ll, t_ll_end)

    # ---- status checks --------------------------------------------------
    extras: List[InterMetric] = []
    for row in np.flatnonzero(st_touched).tolist():
        meta = st_meta[row]
        if meta is None:  # recycled mid-interval (a reclaim straggler)
            continue
        entry = st_vals[row]
        extras.append(InterMetric(
            name=meta.name, timestamp=now, value=entry.value,
            tags=list(meta.tags), type=MetricType.STATUS,
            message=entry.message, hostname=entry.hostname))

    t_end = time.perf_counter()
    if profiling.armed:
        profiling.record("flush.sync", t_dispatch, t_sync)
        profiling.record("flush.assembly", t_sync, t_end)
    if timings is not None:
        if device_lock is not None:
            timings["readout_lock_wait_s"] = (
                timings.get("readout_lock_wait_s", 0.0) + t_locked - t0)
        timings["dispatch_s"] = t_dispatch - t_locked
        timings["device_sync_s"] = t_sync - t_dispatch
        timings["llhist_bins_s"] = t_sync - t_bins
        timings["llhist_copy_bytes"] = ll_copy["bytes"]
        timings["llhist_nonzero_bins"] = ll_copy["nonzero_bins"]
        timings["llhist_assembly_s"] = t_ll_end - t_ll
        timings["assembly_s"] = t_end - t_sync
        timings["families"] = families
    return FlushBatch(now, sections, extras, bucket_sections), fwd


def _live_mask(rows: np.ndarray, meta_list) -> np.ndarray:
    """Which of the touched `rows` hold a key in the snapshot's meta. A
    touched row whose meta is None was recycled between the swap and
    its tombstone's straggler (core/columnstore.py reclaim_idle): it has
    no key to be emitted under, so it is skipped."""
    return np.fromiter((meta_list[r] is not None for r in rows.tolist()),
                       bool, rows.size)


def _valid_rows(touched: np.ndarray, meta_list) -> np.ndarray:
    """The touched rows whose snapshot meta holds a key (_live_mask)."""
    rows = np.flatnonzero(touched)
    return rows[_live_mask(rows, meta_list)] if rows.size else rows


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
