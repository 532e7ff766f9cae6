"""On-device alert predicates over the live query plane (port of
veneur_tpu/core/alerts.py).

Declarative rule tables — threshold on a t-digest quantile, llhist
bin-range occupancy, counter rate/count, HLL cardinality — evaluated
every `alerts.interval` seconds against ONE consistent read-only
capture of the live generation (core/query.py). Rule values come out
of the same readout kernels the flush runs; the threshold compare over
all rules is one vectorised torch expression on the server's device
(the JAX package's jitted vmap of jnp.select), padded to a power-of-two
rule count as the JAX package pads it.

Each rule runs a Prometheus-style state machine with a `for:` hold-down:

    idle --breach--> pending --held for `for_s`--> firing
    pending --clear--> idle          firing --clear--> idle (resolved)

Every state change lands in the flight recorder as an
`alert_transition` event (rule id, value, threshold), and the current state
exports as `alert.*` rows in /metrics. Transition LOG lines are
rate-limited to the first per rule per flush interval; events and rows
are never suppressed. Rules hot-reload via SIGHUP
(`Server.reload_alerts`), preserving in-flight state for rule ids that
survive the reload.

The `shard_skew` kind reads no query: its value each tick is the device
observatory's `shard_skew()` (max/mean live rows over the store's
shards), and a rule set of such rules alone captures nothing.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from veneur_tpu_torch.config import parse_duration
from veneur_tpu_torch.core.latency import LatencyHist
from veneur_tpu_torch.core.query import (QueryError, QuerySpec,
                                         _KIND_FAMILIES, parse_tags)

logger = logging.getLogger("veneur_tpu_torch.core.alerts")

# rule comparison operators -> the op codes the device compare selects on
_OPS = {">": 0, ">=": 1, "<": 2, "<=": 3, "==": 4, "!=": 5}

# exported state codes for the alert.state gauge
STATE_CODES = {"idle": 0.0, "pending": 1.0, "firing": 2.0}


def _duration_s(v) -> float:
    """'400ms' / '30s' / '1h30m' / bare numbers -> seconds, via the
    config module's Go-style parser (AlertsConfig.interval already goes
    through it, so `for:` accepts the same grammar)."""
    try:
        return parse_duration(v)
    except ValueError:
        return float(v)  # bare numeric strings ("5") mean seconds


def _compare_rules(values: torch.Tensor, ops: torch.Tensor,
                   thresholds: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The threshold compare of every rule at once: (N,) rule values
    against (N,) thresholds under per-rule op codes (the select of the
    JAX package's vmapped jnp.select; op codes outside 0-4 mean !=).
    Rules whose value could not be resolved this round (no live rows)
    carry valid=False and never breach."""
    v, t = values, thresholds
    pred = torch.where(ops == 0, v > t, torch.where(
        ops == 1, v >= t, torch.where(ops == 2, v < t, torch.where(
            ops == 3, v <= t, torch.where(ops == 4, v == t, v != t)))))
    return valid & pred


def _pad_len(n: int) -> int:
    """Power-of-two padding (floor 8), the JAX package's compare widths."""
    return max(8, 1 << (max(n, 1) - 1).bit_length())


@dataclass(frozen=True)
class AlertRule:
    """One validated rule; `spec` is its query-plane lookup (None for a
    `shard_skew` rule)."""

    id: str
    metric: str
    kind: str
    op: str
    threshold: float
    for_s: float
    spec: Optional[QuerySpec]
    q: Optional[float] = None
    tags: Tuple[str, ...] = ()
    lo: Optional[float] = None
    hi: Optional[float] = None

    @classmethod
    def parse(cls, d: dict) -> "AlertRule":
        if not isinstance(d, dict):
            raise QueryError(f"alert rule must be a mapping, got {d!r}")
        rid = str(d.get("id") or "").strip()
        if not rid:
            raise QueryError("alert rule requires an id")
        op = str(d.get("op", ">"))
        if op not in _OPS:
            raise QueryError(
                f"rule {rid!r}: unknown op {op!r} "
                f"(expected one of {sorted(_OPS)})")
        if "threshold" not in d:
            raise QueryError(f"rule {rid!r}: threshold is required")
        tags = d.get("tags") or ()
        if isinstance(tags, str):
            tags = parse_tags(tags)
        if str(d.get("kind", "quantile")) == "shard_skew":
            # the device observatory's shard_skew() each tick, no lookup
            return cls(id=rid,
                       metric=str(d.get("metric") or "device.shard.skew"),
                       kind="shard_skew", op=op,
                       threshold=float(d["threshold"]),
                       for_s=_duration_s(d.get("for", 0.0)), spec=None,
                       tags=tuple(tags))
        spec = QuerySpec.build(
            metric=str(d.get("metric") or ""),
            kind=str(d.get("kind", "quantile")),
            q=d.get("q"), tags=tuple(tags),
            lo=d.get("lo"), hi=d.get("hi"))
        return cls(id=rid, metric=spec.metric, kind=spec.kind, op=op,
                   threshold=float(d["threshold"]),
                   for_s=_duration_s(d.get("for", 0.0)), spec=spec,
                   q=spec.q, tags=spec.tags, lo=spec.lo, hi=spec.hi)


@dataclass
class _RuleState:
    state: str = "idle"
    since_unix: float = 0.0       # entered the current state at
    pending_since: float = 0.0
    last_value: float = float("nan")
    breaching: bool = False
    transitions: int = 0
    last_log_flush: int = -1      # log rate-limit marker (flush id)


class AlertEngine:
    """The server's alert evaluator: one daemon loop, one capture + one
    vectorised compare per tick, Python state machines per rule."""

    def __init__(self, server, query_plane, interval_s: float = 1.0,
                 rules: Sequence[dict] = ()):
        self._server = server
        self._plane = query_plane
        self.interval_s = max(float(interval_s), 0.05)
        self._lock = threading.Lock()
        self._rules: List[AlertRule] = []
        self._states: Dict[str, _RuleState] = {}
        self.evals_total = 0
        self.transitions_total = 0
        self.suppressed_logs_total = 0
        self.reloads_total = 0
        self.rule_errors_total = 0
        self._eval_hist = LatencyHist("alert.eval")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if rules:
            self.configure(rules)

    # -- rule table management (initial load + SIGHUP hot reload) --------

    def configure(self, rule_dicts: Sequence[dict],
                  interval_s: Optional[float] = None) -> int:
        """(Re)load the rule table. In-flight state machines survive for
        rule ids present in both tables; rules that vanish are dropped
        (a firing rule that is deleted resolves silently — deleting the
        rule IS the operator's acknowledgment). Returns the rule
        count."""
        rules = [AlertRule.parse(d) for d in rule_dicts or ()]
        seen = set()
        for r in rules:
            if r.id in seen:
                raise QueryError(f"duplicate alert rule id {r.id!r}")
            seen.add(r.id)
        with self._lock:
            old = self._states
            self._rules = rules
            self._states = {r.id: old.get(r.id, _RuleState())
                            for r in rules}
            if interval_s is not None:
                self.interval_s = max(float(interval_s), 0.05)
            self.reloads_total += 1
        return len(rules)

    # -- the evaluation loop ---------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="alert-loop", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    def _loop(self) -> None:
        # supervised like every pipeline thread (core/overload.py)
        beat = self._server.overload.supervisor.beat
        beat("alert-loop")
        while not self._stop.wait(self.interval_s):
            beat("alert-loop")
            try:
                self.evaluate_once()
            except QueryError:
                pass  # shutdown race: the capture refused, loop exits soon
            except Exception:
                self.rule_errors_total += 1
                logger.exception("alert evaluation failed")

    def evaluate_once(self, now: Optional[float] = None) -> List[dict]:
        """One tick: capture -> per-rule lookup -> one device compare ->
        state machines. Returns the transitions recorded (for the drill
        script and tests)."""
        with self._lock:
            rules = list(self._rules)
        if not rules:
            return []
        t0 = time.perf_counter()
        self.evals_total += 1
        specs = [r.spec for r in rules if r.spec is not None]
        families: List[str] = []
        for s in specs:
            for fam in _KIND_FAMILIES[s.kind]:
                if fam not in families:
                    families.append(fam)
        ps = self._plane.ps_for(specs)
        need_bins = any(s.kind == "bin_occupancy" for s in specs)
        bundle = None
        if specs:  # a rule set of shard_skew rules alone reads no table
            bundle = self._plane.capture(families, ps=ps,
                                         need_bins=need_bins)
        values = np.full(len(rules), np.nan, np.float32)
        for i, rule in enumerate(rules):
            if rule.kind == "shard_skew":
                obs = getattr(self._server, "deviceobs", None)
                skew = obs.shard_skew() if obs is not None else None
                if skew is not None and not np.isnan(skew):
                    values[i] = np.float32(skew)
                continue
            try:
                res = self._plane.evaluate(bundle, rule.spec, ps)
            except Exception:
                self.rule_errors_total += 1
                logger.exception("alert rule %s evaluation failed",
                                 rule.id)
                continue
            if res["value"] is not None:
                values[i] = np.float32(res["value"])
        breaches = self._compare(rules, values)
        if now is None:
            now = time.time()
        transitions = self._advance(rules, values, breaches, now)
        self._eval_hist.observe(time.perf_counter() - t0)
        for tr in transitions:
            self._record_transition(tr)
        return transitions

    def _compare(self, rules: List[AlertRule],
                 values: np.ndarray) -> np.ndarray:
        n = len(rules)
        width = _pad_len(n)
        vals = np.zeros(width, np.float32)
        vals[:n] = np.nan_to_num(values, nan=0.0)
        ops = np.zeros(width, np.int32)
        ops[:n] = [_OPS[r.op] for r in rules]
        thr = np.zeros(width, np.float32)
        thr[:n] = [r.threshold for r in rules]
        valid = np.zeros(width, bool)
        valid[:n] = ~np.isnan(values)
        device = self._server.device
        out = _compare_rules(*(torch.from_numpy(a).to(device)
                               for a in (vals, ops, thr, valid)))
        return out.cpu().numpy()[:n]

    def _advance(self, rules, values, breaches, now: float) -> List[dict]:
        transitions: List[dict] = []
        with self._lock:
            for rule, value, breach in zip(rules, values, breaches):
                st = self._states.get(rule.id)
                if st is None:  # raced a reload; next tick sees it
                    continue
                st.last_value = float(value)
                st.breaching = bool(breach)
                old = st.state
                new = old
                if breach:
                    if old == "idle":
                        st.pending_since = now
                        new = ("firing" if rule.for_s <= 0.0
                               else "pending")
                    elif old == "pending" and \
                            now - st.pending_since >= rule.for_s:
                        new = "firing"
                else:
                    if old in ("pending", "firing"):
                        new = "idle"
                if new != old:
                    st.state = new
                    st.since_unix = now
                    st.transitions += 1
                    self.transitions_total += 1
                    transitions.append({
                        "rule": rule.id,
                        "from_state": old,
                        "to_state": ("resolved" if old == "firing"
                                     and new == "idle" else new),
                        "value": round(float(value), 6),
                        "threshold": rule.threshold,
                        "op": rule.op,
                        "metric": rule.metric,
                        "unix": round(now, 3),
                    })
        return transitions

    def _record_transition(self, tr: dict) -> None:
        telemetry = getattr(self._server, "telemetry", None)
        if telemetry is not None:
            telemetry.record_event(
                "alert_transition", rule=tr["rule"],
                from_state=tr["from_state"], to_state=tr["to_state"],
                value=tr["value"], threshold=tr["threshold"],
                metric=tr["metric"])
        # LOG rate limit: first transition per rule per flush interval;
        # the rest are counted, never logged (events/rows still record)
        flush_id = int(getattr(self._server, "flush_count", 0))
        with self._lock:
            st = self._states.get(tr["rule"])
            if st is None:
                return
            if st.last_log_flush == flush_id:
                self.suppressed_logs_total += 1
                return
            st.last_log_flush = flush_id
        logger.info(
            "alert %s: %s -> %s (value=%s %s threshold=%s, metric=%s)",
            tr["rule"], tr["from_state"], tr["to_state"], tr["value"],
            tr["op"], tr["threshold"], tr["metric"])

    # -- export ----------------------------------------------------------

    def report(self) -> dict:
        """The GET /alerts payload."""
        with self._lock:
            rules = list(self._rules)
            states = {rid: (st.state, st.since_unix, st.last_value,
                            st.breaching, st.transitions)
                      for rid, st in self._states.items()}
        out_rules = []
        for r in rules:
            state, since, value, breaching, transitions = states.get(
                r.id, ("idle", 0.0, float("nan"), False, 0))
            entry = {
                "id": r.id, "metric": r.metric, "kind": r.kind,
                "op": r.op, "threshold": r.threshold,
                "for_s": r.for_s, "state": state,
                "since_unix": round(since, 3),
                "breaching": breaching,
                "transitions": transitions,
            }
            if r.q is not None:
                entry["q"] = r.q
            if r.tags:
                entry["tags"] = list(r.tags)
            if r.lo is not None:
                entry["lo"], entry["hi"] = r.lo, r.hi
            entry["value"] = (None if np.isnan(value)
                              else round(float(value), 6))
            out_rules.append(entry)
        return {
            "interval_s": self.interval_s,
            "rules": out_rules,
            "evals_total": self.evals_total,
            "transitions_total": self.transitions_total,
            "reloads_total": self.reloads_total,
            "generated_unix": round(time.time(), 3),
        }

    def telemetry_rows(self) -> List[tuple]:
        with self._lock:
            rules = list(self._rules)
            states = {rid: (st.state, st.last_value)
                      for rid, st in self._states.items()}
        rows: List[tuple] = [
            ("alert.rules", "gauge", float(len(rules)), ()),
            ("alert.evals_total", "counter", float(self.evals_total), ()),
            ("alert.transitions_total", "counter",
             float(self.transitions_total), ()),
            ("alert.rule_errors_total", "counter",
             float(self.rule_errors_total), ()),
            ("alert.suppressed_logs_total", "counter",
             float(self.suppressed_logs_total), ()),
        ]
        for r in rules:
            state, value = states.get(r.id, ("idle", float("nan")))
            tags = [f"rule:{r.id}"]
            rows.append(("alert.state", "gauge",
                         STATE_CODES.get(state, 0.0), tags))
            rows.append(("alert.firing", "gauge",
                         1.0 if state == "firing" else 0.0, tags))
            if not np.isnan(value):
                rows.append(("alert.value", "gauge", float(value), tags))
        snap = self._eval_hist.snapshot()
        for label in ("p50", "p99", "max"):
            rows.append((f"alert.eval.{label}", "gauge", snap[label], ()))
        rows.append(("alert.eval.count", "counter",
                     float(snap["count"]), ()))
        return rows
