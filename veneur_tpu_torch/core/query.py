"""Sub-interval live query plane: serve reads between flushes (port of
veneur_tpu/core/query.py).

`GET /query` answers percentile / count / rate / cardinality / value /
bin-occupancy lookups for a metric name + tag filter against the LIVE
generation, and the alert engine (core/alerts.py) evaluates its rules
over the same captures.

Mechanics (core/columnstore.py owns the capture protocol):

  capture   `_BaseTable.capture_readonly()` — fold the pending columns
            into the live state through the ingest dispatch path (K3 on
            the llhist table), then, under the table locks, copy
            touched/meta/extras and queue the flush readout over the
            live state: clones of the counter and gauge columns, K1 over
            the t-digest grids, K2 over the promoted set rows, the
            llhist readout over the touched rows. No swap, no reset, no
            recycle; residual pending samples after the bounded fold are
            the query's reported staleness.
  readout   `query_readout()` — the device sync, on the calling thread
            (the port has no flush executor yet). The captures run under
            the server's readout lock, which the flush holds over its
            swap and its device readout; the lock and the sync each wait
            at most the plane's timeout.
  finish    the family's ordinary `snapshot_finish` copies, then
            host-side row matching (name + tag subset).

Consistency contract (tests/test_torch_query.py): a query taken between
flushes returns values bit-identical to the next flush's readout of the
same rows, absent further ingest on them, and leaves that flush
byte-identical to one without queries. `ProxyQueryView` is the proxy
tier's aggregate view (cmd/veneur_proxy.py).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from veneur_tpu_torch.core.latency import LatencyHist
from veneur_tpu_torch.ops import llhist_ref

logger = logging.getLogger("veneur_tpu_torch.core.query")

# canonical kinds; "percentile" is accepted as an alias for "quantile"
QUERY_KINDS = ("quantile", "count", "rate", "cardinality", "value",
               "bin_occupancy")

# kind -> the families searched, in order (quantile falls through the
# t-digest family to llhist so `histogram_encoding: circllhist` stores
# answer transparently)
_KIND_FAMILIES = {
    "quantile": ("histogram", "llhist"),
    "count": ("counter",),
    "rate": ("counter",),
    "cardinality": ("set",),
    "value": ("gauge",),
    "bin_occupancy": ("llhist",),
}


class QueryError(ValueError):
    """A malformed or unanswerable query (surfaced as HTTP 400)."""


class ReshardRetry(QueryError):
    """A reshard cutover is swapping the serving topology under this
    capture — retry once it settles (surfaced as HTTP 503 + retry:
    true, never a shape error). A QueryError, so the alert loop's
    per-tick catch covers it."""


def parse_tags(raw: Optional[str]) -> Tuple[str, ...]:
    """'env:prod,region:us' -> a sorted tag tuple (empty for None)."""
    if not raw:
        return ()
    return tuple(sorted(t.strip() for t in raw.split(",") if t.strip()))


@dataclass(frozen=True)
class QuerySpec:
    """One validated query: metric name, kind, and kind parameters."""

    metric: str
    kind: str
    q: Optional[float] = None
    tags: Tuple[str, ...] = ()
    lo: Optional[float] = None
    hi: Optional[float] = None

    @classmethod
    def build(cls, metric: str, kind: str, q=None, tags=(),
              lo=None, hi=None) -> "QuerySpec":
        if not metric:
            raise QueryError("metric is required")
        kind = {"percentile": "quantile"}.get(kind or "", kind)
        if kind not in _KIND_FAMILIES:
            raise QueryError(
                f"unknown kind {kind!r} (expected one of {QUERY_KINDS})")
        if kind == "quantile":
            if q is None:
                raise QueryError("quantile queries require q=")
            # 4-decimal rounding, as the JAX package rounds (its flush
            # kernels compile once per percentile tuple)
            q = round(float(q), 4)
            if not 0.0 <= q <= 1.0:
                raise QueryError(f"q must be in [0, 1], got {q}")
        else:
            q = None
        if kind == "bin_occupancy":
            if lo is None or hi is None:
                raise QueryError("bin_occupancy queries require lo= and hi=")
            lo, hi = float(lo), float(hi)
            if not hi > lo:
                raise QueryError(f"need hi > lo, got [{lo}, {hi})")
        else:
            lo = hi = None
        return cls(metric=metric, kind=kind, q=q,
                   tags=tuple(sorted(tags or ())), lo=lo, hi=hi)


def _named_rows(fam: dict, name: str, tags: Tuple[str, ...]) -> List[int]:
    """Touched rows whose meta matches `name` and carries every
    requested tag (subset match, the standard dashboard filter), found
    through the table's name index instead of a scan of every row (an
    alert tick evaluates 64 specs over tables of tens of thousands of
    rows). The index is live, so a row is matched against the
    capture's own meta: a row recycled since (another key's now, or
    free) is skipped, and the rows come back in ascending order."""
    meta, touched = fam["meta"], fam["touched"]
    want = set(tags)
    return sorted({row for row in fam["name_rows"].get(name, ())
                   if row < len(meta) and touched[row]
                   and meta[row] is not None and meta[row].name == name
                   and (not want or want.issubset(meta[row].tags or ()))})


class LiveQueryPlane:
    """The server's live read surface: consistent read-only captures of
    the device families, evaluated with the flush readout kernels, on
    demand. One instance per server; thread-safe (captures serialize on
    the table locks and the server's readout lock)."""

    def __init__(self, server, timeout_s: float = 30.0):
        self._server = server
        self._timeout_s = timeout_s
        # monotonic counters (GIL point increments; a torn read is one
        # scrape stale, never corrupt)
        self.queries_total = 0
        self.errors_total = 0
        self._eval_hist = LatencyHist("query.eval")

    # -- capture ---------------------------------------------------------

    def _tables(self) -> Dict[str, object]:
        store = self._server.store
        return {"counter": store.counters, "gauge": store.gauges,
                "histogram": store.histos, "llhist": store.llhists,
                "set": store.sets}

    def capture(self, families: Sequence[str], ps: Tuple[float, ...] = (),
                need_bins: bool = False) -> dict:
        """One consistent read-only snapshot per requested family: the
        captures queue their readouts under the server's readout lock,
        then, off it (the snaps hold only fresh tensors), each readout is
        synchronised on this thread and finished into host arrays.
        Returns {family: {values/flush/..., touched, meta,
        stale_pending}}. Raises TimeoutError when the lock or a readout
        takes longer than the plane's timeout."""
        if self._server._shutdown.is_set():
            raise QueryError("server is shutting down")
        reshard = getattr(self._server, "reshard", None)
        if reshard is not None and reshard.state == "cutover":
            # the topology swap is in flight: captures taken now could
            # straddle two topologies, or read a new plane whose rows
            # have not merged back yet
            raise ReshardRetry("reshard cutover in progress")
        deadline = time.monotonic() + self._timeout_s
        tables = self._tables()
        bundle: dict = {"as_of_unix": time.time()}
        snaps = {}
        lock = self._server._readout_lock
        if not lock.acquire(timeout=self._timeout_s):
            raise TimeoutError(f"query capture waited {self._timeout_s} s "
                               f"for the flush's readout")
        try:
            for family in families:
                table = tables[family]
                if family == "histogram":
                    snap = table.capture_readonly(ps=ps, need_export=False)
                elif family == "llhist":
                    snap = table.capture_readonly(ps=ps,
                                                  need_bins=need_bins)
                else:
                    snap = table.capture_readonly()
                snaps[family] = snap
        finally:
            lock.release()
        epochs = {snap["topo_epoch"] for snap in snaps.values()
                  if "topo_epoch" in snap}
        for family, snap in snaps.items():
            table = tables[family]
            table.query_readout(snap, deadline)
            bundle[family] = self._finish(family, table, snap)
        if len(epochs) > 1 or (reshard is not None
                               and reshard.state == "cutover"):
            # a cutover began mid-capture: the bundle mixes topology
            # generations (each sharded capture stamps its table's
            # topology epoch)
            raise ReshardRetry("reshard cutover landed mid-capture")
        return bundle

    @staticmethod
    def _finish(family: str, table, snap: dict) -> dict:
        stale = int(snap.get("stale_pending", 0))
        if family in ("counter", "gauge"):
            values, touched, meta = table.snapshot_finish(snap)
            fam = {"values": values}
        elif family == "histogram":
            flush, _export, touched, meta = table.snapshot_finish(snap)
            fam = {"flush": flush}
        elif family == "llhist":
            flush, bins, touched, meta = table.snapshot_finish(snap)
            fam = {"flush": flush, "bins": bins}
        elif family == "set":
            estimates, _regs, touched, meta = table.snapshot_finish(snap)
            fam = {"values": estimates}
        else:  # pragma: no cover - guarded by _KIND_FAMILIES
            raise QueryError(f"unqueryable family {family!r}")
        fam.update(touched=touched, meta=meta, stale_pending=stale,
                   name_rows=snap["name_rows"])
        return fam

    # -- evaluation (pure host work over a finished bundle) --------------

    def evaluate(self, bundle: dict, spec: QuerySpec,
                 ps: Tuple[float, ...] = ()) -> dict:
        """Evaluate one spec against a capture bundle. Usable for many
        specs over ONE bundle (the alert engine's path)."""
        matched_family = None
        rows: List[int] = []
        fam: Optional[dict] = None
        for family in _KIND_FAMILIES[spec.kind]:
            fam = bundle.get(family)
            if fam is None:
                continue
            rows = _named_rows(fam, spec.metric, spec.tags)
            matched_family = family
            if rows:
                break
        out_rows, agg = (self._values_for(matched_family, fam, rows,
                                          spec, ps)
                         if rows else ([], None))
        result = {
            "metric": spec.metric,
            "kind": spec.kind,
            "family": matched_family,
            "matched_rows": len(rows),
            "rows": out_rows,
            "value": agg,
            "as_of_unix": round(bundle["as_of_unix"], 3),
            "stale_pending_samples": int(fam["stale_pending"]) if fam
            else 0,
        }
        if spec.kind == "quantile":
            result["q"] = spec.q
        if spec.kind == "bin_occupancy":
            result["lo"], result["hi"] = spec.lo, spec.hi
        if spec.tags:
            result["tags"] = list(spec.tags)
        return result

    def _values_for(self, family: str, fam: dict, rows: List[int],
                    spec: QuerySpec, ps: Tuple[float, ...]):
        out: List[dict] = []

        def row_entry(row: int, value: float) -> dict:
            rm = fam["meta"][row]
            return {"tags": list(rm.tags or ()), "value": value}

        if spec.kind in ("count", "rate"):
            values = fam["values"]
            elapsed = max(
                time.time() - self._server._interval_start_unix, 1e-9)
            for row in rows:
                v = float(values[row])
                if spec.kind == "rate":
                    v = v / elapsed
                out.append(row_entry(row, v))
            return out, float(sum(e["value"] for e in out))

        if spec.kind in ("value", "cardinality"):
            values = fam["values"]
            for row in rows:
                out.append(row_entry(row, float(values[row])))
            if spec.kind == "cardinality":
                # per-series estimates sum (series are distinct keys;
                # their member streams are reported per tag-set)
                return out, float(sum(e["value"] for e in out))
            return out, max(e["value"] for e in out)

        if spec.kind == "quantile":
            flush = fam["flush"]
            quant = flush.get("quantiles")
            if quant is None or spec.q not in ps:  # idle llhist capture
                return [], None
            qi = ps.index(spec.q)
            # the llhist readout is compact over the touched rows (the
            # t-digest's spans the table)
            pos = (np.cumsum(fam["touched"]) - 1 if family == "llhist"
                   else np.arange(quant.shape[0]))
            for row in rows:
                out.append(row_entry(row, float(quant[pos[row], qi])))
            finite = [e["value"] for e in out
                      if not np.isnan(e["value"])]
            return out, (max(finite) if finite else None)

        if spec.kind == "bin_occupancy":
            bins = fam.get("bins")
            if bins is None or not bins.shape[0]:
                return [], None
            tpos = {int(r): i for i, r in
                    enumerate(np.flatnonzero(fam["touched"]))}
            mids = llhist_ref.BIN_MID
            mask = (mids >= spec.lo) & (mids < spec.hi)
            in_total = 0.0
            all_total = 0.0
            for row in rows:
                i = tpos.get(row)
                if i is None:
                    continue
                total = float(bins[i].sum())
                in_range = float(bins[i][mask].sum())
                frac = in_range / total if total > 0 else 0.0
                out.append(row_entry(row, frac))
                in_total += in_range
                all_total += total
            agg = in_total / all_total if all_total > 0 else 0.0
            return out, agg

        raise QueryError(f"unknown kind {spec.kind!r}")

    # -- the one-shot path (/query) --------------------------------------

    def ps_for(self, specs: Sequence[QuerySpec]) -> Tuple[float, ...]:
        """The percentile tuple one capture dispatches for a set of
        specs: the server's configured percentiles when they cover every
        requested q (the flush kernels are then textually identical to
        the flush's — the bit-identity pin), extended otherwise."""
        server_ps = tuple(self._server.config.percentiles)
        want = {s.q for s in specs if s.kind == "quantile"}
        if want <= set(server_ps):
            return server_ps
        return tuple(sorted(set(server_ps) | want))

    def query(self, spec: QuerySpec) -> dict:
        t0 = time.perf_counter()
        self.queries_total += 1
        try:
            ps = self.ps_for((spec,))
            bundle = self.capture(
                _KIND_FAMILIES[spec.kind], ps=ps,
                need_bins=(spec.kind == "bin_occupancy"))
            result = self.evaluate(bundle, spec, ps)
        except Exception:
            self.errors_total += 1
            raise
        result["eval_s"] = round(time.perf_counter() - t0, 6)
        self._eval_hist.observe(result["eval_s"])
        return result

    # -- export ----------------------------------------------------------

    def telemetry_rows(self) -> List[tuple]:
        rows: List[tuple] = [
            ("query.requests_total", "counter",
             float(self.queries_total), ()),
            ("query.errors_total", "counter",
             float(self.errors_total), ()),
        ]
        snap = self._eval_hist.snapshot()
        for label in ("p50", "p99", "max"):
            rows.append((f"query.eval.{label}", "gauge", snap[label], ()))
        rows.append(("query.eval.count", "counter",
                     float(snap["count"]), ()))
        return rows


class ProxyQueryView:
    """The proxy-side aggregate query surface. A proxy holds no column
    store — its queryable state is the per-destination routing plane:
    forwarded-key HLL cardinalities, queue depths, and forward volume.
    `GET /query` on a proxy therefore serves aggregate views
    (kind=cardinality over forwarded key digests, kind=count over
    forwarded metrics) rather than per-metric values."""

    def __init__(self, proxy):
        self._proxy = proxy
        self._started_unix = time.time()
        self.queries_total = 0
        self.errors_total = 0

    def query(self, spec: QuerySpec) -> dict:
        self.queries_total += 1
        if spec.kind not in ("cardinality", "count", "rate"):
            self.errors_total += 1
            raise QueryError(
                "a proxy serves aggregate views only: kind must be "
                "cardinality, count, or rate")
        try:
            report = self._proxy.cardinality_report(top=4096)
        except Exception:
            self.errors_total += 1
            raise
        rows = []
        total = 0.0
        for entry in report.get("destinations", ()):
            if spec.kind == "cardinality":
                v = float(entry.get("forwarded_keys_estimate", 0))
            else:
                v = float(entry.get("sent_total", 0))
            rows.append({"tags": [f"destination:{entry.get('address')}"],
                         "value": v})
            total += v
        if spec.kind == "rate":
            # cumulative counters over the proxy's lifetime -> mean rate
            # since this view came up alongside the proxy
            elapsed = max(time.time() - self._started_unix, 1e-9)
            for e in rows:
                e["value"] = e["value"] / elapsed
            total = sum(e["value"] for e in rows)
        return {
            "metric": spec.metric or "forward.keys",
            "kind": spec.kind,
            "family": "proxy",
            "matched_rows": len(rows),
            "rows": rows,
            "value": total,
            "as_of_unix": round(time.time(), 3),
        }

    def telemetry_rows(self) -> List[tuple]:
        return [
            ("query.requests_total", "counter",
             float(self.queries_total), ()),
            ("query.errors_total", "counter",
             float(self.errors_total), ()),
        ]
