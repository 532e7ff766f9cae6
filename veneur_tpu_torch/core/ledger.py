"""End-to-end sample flow ledger: conservation accounting from socket
to sink ack (a copy of veneur_tpu/core/ledger.py, plus `note_all` and
`transit`).

veneur's value proposition is lossless-by-construction aggregation, and
the last several PRs each added an independent loss-or-defer mechanism
(the overload shed ladder, forward carryover, the on-disk spool, hedge
dedupe) with its own counters — but nothing reconciled them, so a
silent drop anywhere in the pipeline was invisible unless a bespoke
chaos test happened to count that exact seam. This module turns the
existing counters into *checked invariants*: a `FlowLedger` of
per-interval monotonic stage counters stamped at every pipeline
crossing, reconciled at interval close with classic double-entry
bookkeeping:

    inflow + opening stock == outflow + closing stock

per declared *identity* (a named conservation law). Anything left over
is **unexplained imbalance** — a sample that entered a stage and never
came out anywhere the code accounts for. The server checks:

- ``ingest``:  samples admitted past admission control equal samples
  applied to the column store plus mints rejected at the cardinality /
  capacity gates. A sample lost between the parse callback and the
  store shows up here within one flush interval.
- ``forward``: every metric snapshotted for the forward tier is acked,
  merged away (the explained shrinkage when two intervals' rows merge
  associatively in carryover), or shed loudly — with the carryover, the
  on-disk spool, and the in-flight send as inventory stocks, so a
  mid-outage interval balances without delivering anything.
- ``forward_tier``: the global ``ImportServer`` (and the proxy) return
  (received, merged, duplicate) counts in the gRPC response, so a local
  reconciles *sent vs merged* across the tier — a receiver that parsed
  fewer metrics than the sender framed is a wire-level loss this
  identity catches.

The proxy runs its own ledger over the routing and destination-pool
stages (received == routed + dropped + no-destination; enqueued ==
sent + dropped-after-enqueue + queued), with retired-destination folds
so ring churn never resets the books.

Stage counts are fed three ways:

- ``note(stage, n, key=...)`` — an event stamp at a pipeline crossing;
- ``probe(stage, fn)`` / ``probe_map(stage, fn)`` — cumulative counters
  the codebase already maintains, folded in as per-interval deltas at
  close (so pre-existing accounting becomes ledger input unmodified);
- ``stock(name, fn)`` — inventory levels (carryover depth in metrics,
  spool metrics on disk, destination queue depths) read at every close.

``close_interval`` (called from the flush path; from the discovery loop
on the proxy) computes per-identity imbalances, exports them as
``ledger.imbalance{identity:}`` gauges, keeps a bounded history for
``GET /debug/ledger``, records a flight-recorder event on any nonzero
unexplained imbalance, and — with ``ledger_strict`` on (tests) —
raises ``LedgerImbalance`` so a conservation bug fails the suite
instead of fading into a dashboard.

Locking: the ledger lock is a leaf — ``note`` takes only it, and
``close_interval`` evaluates probe/stock callables *outside* it, so
components may note from inside their own locks without ordering
hazards.

Transits (a port addition): an ingest chunk stamps ``ingest.admitted``
before it applies its columns and the tables stamp ``agg.applied`` as
they take them, so a close that lands between the two books one side
in this interval and the other in the next, and a strict ledger raises
for samples that were never lost. A caller wraps such a pair in
``with ledger.transit():``; ``close_interval`` waits for the open
transits (at most ``TRANSIT_WAIT_S``) and holds new ones back while it
reads the books.

stdlib-only; no torch, no grpc (the proxy imports this without
dragging in the device stack).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# self-metric rows this module renders into /metrics, declared literally
# so scripts/check_metric_names.py lints them against the README
# inventory (the same contract core/latency.py's HIST_ROWS carries)
LEDGER_ROWS = (
    "ledger.intervals_closed",
    "ledger.imbalance",
    "ledger.imbalance_net",
    "ledger.unexplained_total",
    "ledger.stage_total",
    "ledger.stock",
)

# floats only enter via probe callables; counts are integers, so any
# residual beyond this is a real imbalance, not float noise
_EPS = 1e-6

# the longest an interval close waits for the open transits before it
# reads the books anyway
TRANSIT_WAIT_S = 10.0


class LedgerImbalance(RuntimeError):
    """Raised at interval close (``ledger_strict`` only) when any
    identity fails its conservation check."""

    def __init__(self, imbalances: Dict[str, float]):
        self.imbalances = imbalances
        detail = ", ".join(f"{k}: {v:+g}" for k, v in imbalances.items()
                           if abs(v) > _EPS)
        super().__init__(f"flow ledger imbalance — {detail}")


class FlowLedger:
    """One node's conservation book. Thread-safe; every mutator is a
    few dict operations under one leaf lock, so it is cheap enough to
    stamp per-sample on the Python ingest path and per-batch on the
    native one (the overhead soak pins <2% of flush wall time)."""

    def __init__(self, enabled: bool = True, strict: bool = False,
                 history: int = 32,
                 on_event: Optional[Callable] = None,
                 clock: Callable[[], float] = time.time):
        self.enabled = bool(enabled)
        self.strict = bool(strict)
        self.on_event = on_event
        # active interval trace stamp (trace/store.py plane): when set,
        # each closed interval's record carries the trace id (hex) of
        # the flush that closed it, so a ledger finding cross-links to
        # the exact /debug/traces entry
        self.trace_source = None
        self._clock = clock
        self._lock = threading.Lock()
        # stage -> key -> count, current interval / lifetime totals
        self._counts: Dict[str, Dict[str, float]] = {}
        self._totals: Dict[str, Dict[str, float]] = {}
        # cumulative-counter probes: [stage, key, fn, last_seen]
        self._probes: List[list] = []
        # dict-valued probes: [stage, fn, {key: last_seen}]
        self._probe_maps: List[list] = []
        # inventory stocks: name -> level fn; opening = level at the
        # previous close (or at registration, so pre-existing inventory
        # — e.g. spool segments replayed at startup — is opening stock,
        # never unexplained inflow)
        self._stocks: Dict[str, Callable[[], float]] = {}
        self._opening: Dict[str, float] = {}
        # identity name -> {"in": (...), "out": (...), "stocks": (...)}
        self._identities: Dict[str, dict] = {}
        self._history: deque = deque(maxlen=max(1, int(history)))
        self.intervals_closed = 0
        self.imbalance_last: Dict[str, float] = {}
        self.imbalance_net: Dict[str, float] = {}
        self.unexplained_total: Dict[str, float] = {}
        # open transits, and whether a close holds new ones back
        self._transit_cv = threading.Condition(threading.Lock())
        self._open_transits = 0
        self._closing = False

    # -- declaration -----------------------------------------------------

    def declare(self, name: str, inputs: Sequence[str],
                outputs: Sequence[str],
                stocks: Sequence[str] = ()) -> None:
        """Declare one conservation identity. Stocks that are never
        registered read as 0 (a server without a spool still balances)."""
        with self._lock:
            self._identities[name] = {
                "in": tuple(inputs), "out": tuple(outputs),
                "stocks": tuple(stocks)}
            self.imbalance_last.setdefault(name, 0.0)
            self.imbalance_net.setdefault(name, 0.0)
            self.unexplained_total.setdefault(name, 0.0)

    # -- feeds -----------------------------------------------------------

    def note(self, stage: str, n: float = 1, key: str = "") -> None:
        """Stamp n units crossing `stage` this interval."""
        if not self.enabled or not n:
            return
        with self._lock:
            per_key = self._counts.get(stage)
            if per_key is None:
                per_key = self._counts[stage] = {}
            per_key[key] = per_key.get(key, 0.0) + n

    def note_all(self, entries: Sequence[Tuple[str, float]],
                 key: str = "") -> None:
        """Stamp several (stage, n) crossings in one lock hold, so an
        interval close never books one side of them without the other
        (a port addition: the FlowCounts reconciliations note a sent
        figure and its outcome together)."""
        if not self.enabled:
            return
        with self._lock:
            for stage, n in entries:
                if not n:
                    continue
                per_key = self._counts.get(stage)
                if per_key is None:
                    per_key = self._counts[stage] = {}
                per_key[key] = per_key.get(key, 0.0) + n

    @contextlib.contextmanager
    def transit(self):
        """Stamp an inflow and its outflows (an ingest chunk's admitted
        and applied samples) inside this block: no interval close reads
        the books while it is open (module note)."""
        if not self.enabled:
            yield
            return
        with self._transit_cv:
            while self._closing:
                self._transit_cv.wait()
            self._open_transits += 1
        try:
            yield
        finally:
            with self._transit_cv:
                self._open_transits -= 1
                if not self._open_transits:
                    self._transit_cv.notify_all()

    def _quiesce(self) -> None:
        """Hold new transits back and wait for the open ones to end."""
        deadline = time.monotonic() + TRANSIT_WAIT_S
        with self._transit_cv:
            self._closing = True
            while self._open_transits:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._transit_cv.wait(left)

    def _release_transits(self) -> None:
        with self._transit_cv:
            self._closing = False
            self._transit_cv.notify_all()

    def probe(self, stage: str, fn: Callable[[], float],
              key: str = "") -> None:
        """Feed `stage` from a cumulative counter: each close folds in
        the delta since the previous close. The baseline is read NOW, so
        counts accrued before registration are not attributed to the
        first interval."""
        if not self.enabled:
            return
        try:
            last = float(fn())
        except Exception:
            last = 0.0
        with self._lock:
            self._probes.append([stage, key, fn, last])

    def probe_map(self, stage: str, fn: Callable[[], Dict[str, float]]
                  ) -> None:
        """Like probe(), for a fn returning {key: cumulative} (the
        overload shed table, the proxy routing stats)."""
        if not self.enabled:
            return
        try:
            seen = {k: float(v) for k, v in (fn() or {}).items()}
        except Exception:
            seen = {}
        with self._lock:
            self._probe_maps.append([stage, fn, seen])

    def stock(self, name: str, fn: Callable[[], float]) -> None:
        """Register an inventory level; its current value becomes the
        opening stock of the running interval."""
        if not self.enabled:
            return
        try:
            level = float(fn())
        except Exception:
            level = 0.0
        with self._lock:
            self._stocks[name] = fn
            self._opening[name] = level

    def unstock(self, name: str) -> None:
        with self._lock:
            self._stocks.pop(name, None)
            self._opening.pop(name, None)

    # -- interval close --------------------------------------------------

    def close_interval(self) -> dict:
        """Fold probes, read stocks, run every identity's conservation
        check, roll the interval. Returns the interval record (also
        appended to history). Raises LedgerImbalance in strict mode when
        any identity is off."""
        if not self.enabled:
            return {}
        self._quiesce()
        try:
            return self._close_quiesced()
        finally:
            self._release_transits()

    def _close_quiesced(self) -> dict:
        with self._lock:
            probes = list(self._probes)
            probe_maps = list(self._probe_maps)
            stocks = dict(self._stocks)
        # probe/stock callables run OUTSIDE the ledger lock: they may
        # take their owners' locks (carryover, spool, destinations), and
        # those owners call note() under the same locks
        probe_vals: List[Tuple[int, float]] = []
        for i, (_stage, _key, fn, _last) in enumerate(probes):
            try:
                probe_vals.append((i, float(fn())))
            except Exception:
                continue
        map_vals: List[Tuple[int, Dict[str, float]]] = []
        for i, (_stage, fn, _seen) in enumerate(probe_maps):
            try:
                map_vals.append(
                    (i, {k: float(v) for k, v in (fn() or {}).items()}))
            except Exception:
                continue
        closing: Dict[str, float] = {}
        for name, fn in stocks.items():
            try:
                closing[name] = float(fn())
            except Exception:
                closing[name] = 0.0
        with self._lock:
            for i, cur in probe_vals:
                entry = self._probes[i]
                delta = cur - entry[3]
                entry[3] = cur
                if delta:
                    per_key = self._counts.setdefault(entry[0], {})
                    per_key[entry[1]] = per_key.get(entry[1], 0.0) + delta
            for i, cur_map in map_vals:
                entry = self._probe_maps[i]
                seen = entry[2]
                per_key = self._counts.setdefault(entry[0], {})
                for k, v in cur_map.items():
                    delta = v - seen.get(k, 0.0)
                    if delta:
                        per_key[k] = per_key.get(k, 0.0) + delta
                    seen[k] = v
            counts = self._counts
            opening = dict(self._opening)
            imbalances: Dict[str, float] = {}
            for name, spec in self._identities.items():
                inflow = sum(sum(counts.get(s, {}).values())
                             for s in spec["in"])
                outflow = sum(sum(counts.get(s, {}).values())
                              for s in spec["out"])
                s_open = sum(opening.get(s, 0.0) for s in spec["stocks"])
                s_close = sum(closing.get(s, 0.0) for s in spec["stocks"])
                imb = inflow + s_open - outflow - s_close
                if abs(imb) <= _EPS:
                    imb = 0.0
                imbalances[name] = imb
                self.imbalance_last[name] = imb
                self.imbalance_net[name] = \
                    self.imbalance_net.get(name, 0.0) + imb
                if imb:
                    self.unexplained_total[name] = \
                        self.unexplained_total.get(name, 0.0) + abs(imb)
            self.intervals_closed += 1
            trace_id = ""
            if self.trace_source is not None:
                try:
                    trace_id = self.trace_source() or ""
                except Exception:
                    trace_id = ""
            record = {
                "interval": self.intervals_closed,
                "closed_unix": round(self._clock(), 3),
                **({"trace_id": trace_id} if trace_id else {}),
                "stages": {s: dict(per_key)
                           for s, per_key in counts.items()},
                "stocks": {"opening": opening, "closing": dict(closing)},
                "imbalance": dict(imbalances),
            }
            self._history.append(record)
            for stage, per_key in counts.items():
                tot = self._totals.setdefault(stage, {})
                for k, v in per_key.items():
                    tot[k] = tot.get(k, 0.0) + v
            self._counts = {}
            self._opening = dict(closing)
        bad = {k: v for k, v in imbalances.items() if v}
        if bad:
            if self.on_event is not None:
                try:
                    self.on_event("ledger_imbalance",
                                  interval=record["interval"],
                                  imbalance={k: round(v, 6)
                                             for k, v in bad.items()})
                except Exception:
                    pass
            if self.strict:
                raise LedgerImbalance(bad)
        return record

    # -- export ----------------------------------------------------------

    def telemetry_rows(self) -> List[tuple]:
        """(name, kind, value, tags) rows for /metrics: per-identity
        imbalance gauges + lifetime stage totals (the LEDGER_ROWS set)."""
        if not self.enabled:
            return []
        with self._lock:
            last = dict(self.imbalance_last)
            net = dict(self.imbalance_net)
            unexplained = dict(self.unexplained_total)
            totals = {s: dict(k) for s, k in self._totals.items()}
            closed = self.intervals_closed
            stocks = dict(self._stocks)
        rows: List[tuple] = [
            ("ledger.intervals_closed", "counter", float(closed), ())]
        for ident in sorted(last):
            tags = [f"identity:{ident}"]
            rows.append(("ledger.imbalance", "gauge", last[ident], tags))
            rows.append(("ledger.imbalance_net", "gauge",
                         net.get(ident, 0.0), tags))
            rows.append(("ledger.unexplained_total", "counter",
                         unexplained.get(ident, 0.0), tags))
        for stage in sorted(totals):
            for key, v in sorted(totals[stage].items()):
                tags = [f"stage:{stage}"] + ([f"key:{key}"] if key else [])
                rows.append(("ledger.stage_total", "counter", v, tags))
        for name, fn in stocks.items():
            try:
                level = float(fn())
            except Exception:
                continue
            rows.append(("ledger.stock", "gauge", level,
                         [f"stock:{name}"]))
        return rows

    def report(self, intervals: int = 0) -> dict:
        """The GET /debug/ledger payload: identity table, lifetime stage
        totals, live stocks, and the last N closed intervals (newest
        last) as the per-interval waterfall."""
        with self._lock:
            identities = {
                name: {"inputs": list(spec["in"]),
                       "outputs": list(spec["out"]),
                       "stocks": list(spec["stocks"]),
                       "imbalance_last": self.imbalance_last.get(name, 0.0),
                       "imbalance_net": self.imbalance_net.get(name, 0.0),
                       "unexplained_total":
                           self.unexplained_total.get(name, 0.0)}
                for name, spec in self._identities.items()}
            totals = {s: dict(k) for s, k in self._totals.items()}
            pending = {s: dict(k) for s, k in self._counts.items()}
            history = list(self._history)
            stocks = dict(self._stocks)
            closed = self.intervals_closed
        levels = {}
        for name, fn in stocks.items():
            try:
                levels[name] = float(fn())
            except Exception:
                levels[name] = None
        if intervals > 0:
            history = history[-intervals:]
        return {
            "enabled": self.enabled,
            "strict": self.strict,
            "generated_unix": round(time.time(), 3),
            "intervals_closed": closed,
            "identities": identities,
            "stage_totals": totals,
            "pending_stages": pending,
            "stocks": levels,
            "intervals": history,
        }

    # -- test/soak helpers -----------------------------------------------

    def history_imbalances(self) -> List[Dict[str, float]]:
        """Per-interval imbalance dicts, oldest first (what the chaos
        soaks assert over)."""
        with self._lock:
            return [dict(r["imbalance"]) for r in self._history]
