"""Forward resilience: retry, circuit breaking, lossless carryover (port
of veneur_tpu/util/resilience.py, byte for byte in what it computes).

A dropped forward interval loses counter deltas for good, so the forward
client (forward/client.py) wraps every send in these:

- `RetryPolicy`: jittered exponential backoff whose total spend is
  bounded by the remaining flush-interval budget — a retry storm can
  never push a flush past its interval.
- `CircuitBreaker`: per-destination closed/open/half-open with a single
  probe in half-open (the classic Nygard shape). Deliberately free of
  I/O: callers ask `allow()` and report `record_success`/
  `record_failure`.
- `Carryover`: because every forwarded family merges associatively
  (counters sum, t-digest centroids concatenate-and-recompress — Dunning
  is explicit that the merge is lossless up to compression — HLL
  registers max, llhist bins add, gauges last-write-wins), a FAILED
  forward interval is folded into the next interval's snapshot instead
  of dropped. Bounded to N intervals; beyond that it spills to the
  durable spool (util/spool.py) or sheds loudly.

Everything here is host numpy and stdlib and thread-safe; the merges
run on host `ForwardableState` rows, never on the device.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger("veneur_tpu_torch.util.resilience")


# --------------------------------------------------------------------------
# RetryPolicy
# --------------------------------------------------------------------------


class RetryPolicy:
    """Jittered exponential backoff bounded by a wall-clock budget.

    `delays(budget)` yields the sleep before each RETRY (so a policy with
    max_attempts=3 yields at most 2 delays). A delay that would overrun
    the remaining budget is never yielded — the caller's last attempt
    always lands inside its flush interval. Full jitter (AWS-style):
    each delay is uniform in (0, min(cap, base * mult**n)], which spreads
    a thundering herd of locals re-forwarding after a global-tier blip.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.2,
                 max_delay: float = 5.0, multiplier: float = 2.0,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = max(0.0, float(base_delay))
        self.max_delay = max(self.base_delay, float(max_delay))
        self.multiplier = max(1.0, float(multiplier))
        self._rng = rng or random.Random()
        self._clock = clock

    def delays(self, budget: float) -> Iterator[float]:
        """Backoff delays for one operation, stopping when either the
        attempt count or the remaining `budget` (seconds) is exhausted.
        The deadline anchors HERE, not at the first next() — generators
        run lazily, and anchoring on first use would restart the budget
        after the first (possibly budget-consuming) attempt."""
        deadline = self._clock() + max(0.0, budget)

        def gen():
            for n in range(self.max_attempts - 1):
                cap = min(self.max_delay,
                          self.base_delay * self.multiplier ** n)
                delay = self._rng.uniform(0.0, cap) if cap > 0 else 0.0
                if self._clock() + delay >= deadline:
                    return
                yield delay

        return gen()


# --------------------------------------------------------------------------
# CircuitBreaker
# --------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
# gauge encoding for /metrics: closed=0, open=1, half-open=2
STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Per-destination closed/open/half-open breaker, single half-open probe.

    - CLOSED: calls flow; `failure_threshold` consecutive failures open it.
    - OPEN: calls are refused for `recovery_time` seconds.
    - HALF_OPEN: exactly one caller wins the probe (`allow()` returns True
      once); its success closes the breaker, its failure re-opens it.

    `is_dispatchable` is the non-consuming check ("would a call stand any
    chance?") for producers that only want to shed while open — it never
    claims the half-open probe.
    """

    def __init__(self, failure_threshold: int = 3,
                 recovery_time: float = 30.0, name: str = "",
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[str, str, str], None]] = None):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.recovery_time = max(0.0, float(recovery_time))
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.open_total = 0        # lifetime open transitions
        self.refused_total = 0     # calls refused while open/probing

    # -- state -----------------------------------------------------------

    def _transition(self, new_state: str) -> None:
        old, self._state = self._state, new_state
        if old != new_state:
            if new_state == OPEN:
                self.open_total += 1
                self._opened_at = self._clock()
            logger.info("circuit breaker %s: %s -> %s",
                        self.name or "?", old, new_state)
            if self._on_transition is not None:
                try:
                    self._on_transition(self.name, old, new_state)
                except Exception:
                    pass

    def _tick_locked(self) -> None:
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.recovery_time):
            self._probe_inflight = False
            self._transition(HALF_OPEN)

    @property
    def state(self) -> str:
        with self._lock:
            self._tick_locked()
            return self._state

    @property
    def state_code(self) -> int:
        return STATE_CODES[self.state]

    @property
    def is_dispatchable(self) -> bool:
        """Non-consuming: False only while OPEN (a half-open breaker is
        dispatchable — somebody may still win the probe)."""
        with self._lock:
            self._tick_locked()
            return self._state != OPEN

    @property
    def likely_dispatchable(self) -> bool:
        """Lock-free fast path for per-metric ROUTING decisions: the
        common healthy case (CLOSED) answers with a single racy state
        read and zero lock round-trips; only an OPEN breaker pays the
        lock (to tick into half-open when recovery has elapsed). Racy
        by design — the send path re-checks `is_dispatchable`
        authoritatively, so a stale answer costs at worst one metric
        routed to a node that sheds it (counted)."""
        if self._state != OPEN:
            return True
        return self.is_dispatchable

    @property
    def consecutive_failures(self) -> int:
        """Current failure streak (0 while healthy) — producers use it
        to stop extending courtesies (blocking waits) to a peer that is
        already failing but hasn't tripped yet."""
        with self._lock:
            return self._failures

    # -- calls -----------------------------------------------------------

    def allow(self) -> bool:
        """May this call proceed? Consumes the half-open probe slot."""
        with self._lock:
            self._tick_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            self.refused_total += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._transition(OPEN)


# --------------------------------------------------------------------------
# Carryover: associative merge of ForwardableState
# --------------------------------------------------------------------------


def _meta_key(meta) -> Tuple[str, str, str]:
    """Row identity stable across evict/re-intern cycles (RowMeta objects
    are per-row caches and may be recreated between intervals)."""
    return (meta.name, meta.joined_tags, meta.wire_type)


def merge_centroids(means_a: np.ndarray, weights_a: np.ndarray,
                    means_b: np.ndarray, weights_b: np.ndarray,
                    slots: int, compression: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate two centroid sets and recompress onto the arcsine
    k-scale (the same bucketing batch_tdigest.compact uses on device):
    sort by mean, bucket by floor(k) of each centroid's weighted midpoint
    quantile, segment-reduce. At most `compression`+1 buckets survive, so
    the result always fits back into `slots` (C=128 >= 101). Weight is
    conserved exactly up to float32 summation — the property the
    carryover-equivalence tests pin."""
    means = np.concatenate([np.asarray(means_a, np.float64),
                            np.asarray(means_b, np.float64)])
    weights = np.concatenate([np.asarray(weights_a, np.float64),
                              np.asarray(weights_b, np.float64)])
    live = weights > 0
    means, weights = means[live], weights[live]
    out_m = np.zeros(slots, np.float32)
    out_w = np.zeros(slots, np.float32)
    if weights.size == 0:
        return out_m, out_w
    order = np.argsort(means, kind="stable")
    means, weights = means[order], weights[order]
    total = weights.sum()
    mid_q = (np.cumsum(weights) - weights / 2.0) / total
    k = np.floor(compression * (np.arcsin(np.clip(2.0 * mid_q - 1.0,
                                                  -1.0, 1.0)) / np.pi
                                + 0.5)).astype(np.int64)
    _, inv = np.unique(k, return_inverse=True)
    n = int(inv.max()) + 1
    w_out = np.zeros(n, np.float64)
    wv_out = np.zeros(n, np.float64)
    np.add.at(w_out, inv, weights)
    np.add.at(wv_out, inv, weights * means)
    n = min(n, slots)
    out_w[:n] = w_out[:n]
    out_m[:n] = (wv_out[:n] / w_out[:n])
    return out_m, out_w


def merge_forwardable(newer, older):
    """Merge `older` (a previously failed interval's ForwardableState)
    into `newer` (this interval's snapshot), in place on `newer`:

    - counters: values SUM (they are deltas; this is the lossless part),
    - gauges: last-write-wins — `newer` wins; old-only rows are carried,
    - histograms: centroids concatenate-and-recompress; min/max fold,
      reciprocal sums add,
    - sets: HLL registers take the elementwise max.

    Returns `newer`."""
    from veneur_tpu_torch.ops.batch_tdigest import C, COMPRESSION

    def index(rows) -> Dict[tuple, int]:
        return {_meta_key(meta_val[0]): i
                for i, meta_val in enumerate(rows)}

    idx = index(newer.counters)
    for meta, value in older.counters:
        i = idx.get(_meta_key(meta))
        if i is None:
            newer.counters.append((meta, value))
        else:
            m, v = newer.counters[i]
            newer.counters[i] = (m, v + value)

    idx = index(newer.gauges)
    for meta, value in older.gauges:
        if _meta_key(meta) not in idx:
            newer.gauges.append((meta, value))

    idx = index(newer.histograms)
    for entry in older.histograms:
        meta, means, weights, dmin, dmax, drecip = entry
        i = idx.get(_meta_key(meta))
        if i is None:
            newer.histograms.append(entry)
            continue
        nm, nmeans, nweights, ndmin, ndmax, ndrecip = newer.histograms[i]
        slots = max(C, nmeans.shape[0], means.shape[0])
        mm, ww = merge_centroids(nmeans, nweights, means, weights,
                                 slots, COMPRESSION)
        newer.histograms[i] = (nm, mm, ww, min(ndmin, dmin),
                               max(ndmax, dmax), ndrecip + drecip)

    idx = index(newer.sets)
    for meta, registers in older.sets:
        i = idx.get(_meta_key(meta))
        if i is None:
            newer.sets.append((meta, registers))
        else:
            m, regs = newer.sets[i]
            newer.sets[i] = (m, np.maximum(regs, registers))

    idx = index(newer.llhists)
    for meta, bins in older.llhists:
        # log-linear histograms are the family the carryover story is
        # EXACT for: registers add in int64, no recompression loss
        i = idx.get(_meta_key(meta))
        if i is None:
            newer.llhists.append((meta, bins))
        else:
            m, cur = newer.llhists[i]
            newer.llhists[i] = (m, np.asarray(cur, np.int64)
                                + np.asarray(bins, np.int64))
    return newer


class Carryover:
    """Holds the mergeable state of failed forward intervals and folds it
    into the next interval's snapshot. Bounded: after `max_intervals`
    consecutive failed intervals the pending state is SHED (loudly,
    counted) — under a long outage memory stays O(one interval of keys)
    and staleness is bounded.

    Thread-safe; the forward path is single-threaded per server, but the
    telemetry scraper reads `depth` concurrently.
    """

    def __init__(self, max_intervals: int = 3, spill=None, ledger=None):
        self.max_intervals = max(0, int(max_intervals))
        # flow ledger (core/ledger.py; the server passes its own, the
        # forward client hands it on): the carryover is an inventory
        # stock of the forward conservation identity; the EXPLAINED
        # shrinkage when two intervals' rows merge associatively (same
        # key -> one row) is stamped as forward.merged_away, sheds as
        # forward.shed. Notes always fire OUTSIDE self._lock (the
        # ledger lock is a leaf; the ledger's stock probe takes
        # self._lock at interval close).
        self.ledger = ledger
        # optional durable overflow (util/spool.py, wired by the forward
        # client): state that would be SHED at the age bound is handed
        # to `spill(state)` instead — serialized to the on-disk spool
        # and re-delivered when the destination recovers. A spill that
        # raises falls back to the loud shed, never silent loss of the
        # loss-accounting.
        self.spill = spill
        self._lock = threading.Lock()
        self._pending = None          # merged ForwardableState of failures
        self._age = 0                 # consecutive failed intervals held
        self.stashed_total = 0        # intervals stashed
        self.merged_total = 0         # metrics re-merged into a snapshot
        self.shed_total = 0           # metrics dropped at the age bound
        self.spilled_total = 0        # metrics handed to the spill hook

    @property
    def depth(self) -> int:
        """Consecutive failed intervals currently held (0 = clean)."""
        with self._lock:
            return self._age

    @property
    def pending_metrics(self) -> int:
        """Metric rows currently held — the ledger's stock level."""
        with self._lock:
            return len(self._pending) if self._pending is not None else 0

    def _note(self, stage: str, n: int, key: str = "") -> None:
        led = self.ledger
        if led is not None and n:
            led.note(stage, n, key=key)

    def stash(self, fwd) -> None:
        """Remember a failed interval's state. Merges into any pending
        state rather than replacing it: besides the forward thread's
        drain-merge-send-stash cycle, the flush loop stashes intervals
        it could not even dispatch (previous forward still hung), and
        those writers race."""
        overflow = None
        merged_away = 0
        with self._lock:
            if self.max_intervals <= 0:
                self.shed_total += len(fwd)
                logger.error(
                    "carryover disabled: dropping %d forwardable metrics",
                    len(fwd))
                self._note("forward.shed", len(fwd),
                           key="carryover_disabled")
                return
            if self._pending is not None:
                before = len(fwd) + len(self._pending)
                fwd = merge_forwardable(fwd, self._pending)
                merged_away = before - len(fwd)
            # any pre-encoded wire frames describe the UNMERGED state
            if hasattr(fwd, "invalidate_wire"):
                fwd.invalidate_wire()
            self._pending = fwd
            self._age += 1
            self.stashed_total += 1
            if self._age > self.max_intervals:
                overflow, self._pending = self._pending, None
                self._age = 0
        self._note("forward.merged_away", merged_away, key="stash")
        if overflow is None:
            return
        # past the age bound: spill to the durable spool when one is
        # wired, shed loudly otherwise. The spill (serialization + disk
        # write) runs OUTSIDE the lock — telemetry scrapers reading
        # `depth` must never wait on an fsync.
        if self.spill is not None:
            try:
                spilled = self.spill(overflow)
                with self._lock:
                    self.spilled_total += len(overflow)
                if spilled is not None and spilled < len(overflow):
                    # serialization dropped rows (empty digests and the
                    # like): they left the pipeline here, account them
                    self._note("forward.shed", len(overflow) - spilled,
                               key="convert")
                logger.warning(
                    "carryover exceeded %d intervals: spilled %d "
                    "forwardable metrics to the durable spool",
                    self.max_intervals, len(overflow))
                return
            except Exception:
                logger.exception("carryover spill failed; shedding")
        with self._lock:
            self.shed_total += len(overflow)
        self._note("forward.shed", len(overflow), key="carryover_bound")
        logger.error(
            "carryover exceeded %d intervals: shedding %d "
            "forwardable metrics (counter deltas in them are "
            "permanently lost)", self.max_intervals, len(overflow))

    def drain_into(self, fwd):
        """Fold any pending carryover into this interval's snapshot and
        clear it; the caller now owns the merged state (and must stash it
        back if the send fails). Returns `fwd`."""
        with self._lock:
            pending, self._pending = self._pending, None
            age = self._age
        if pending is None:
            return fwd
        self.merged_total += len(pending)
        logger.info("carryover: merging %d metrics from %d failed "
                    "interval(s) into this flush", len(pending), age)
        before = len(fwd) + len(pending)
        fwd = merge_forwardable(fwd, pending)
        # the merge changed row contents: any wire frames pre-encoded on
        # the readout executor are stale, force a re-encode at send time
        if hasattr(fwd, "invalidate_wire"):
            fwd.invalidate_wire()
        self._note("forward.merged_away", before - len(fwd), key="drain")
        return fwd

    def clear_age(self) -> None:
        """A successful send ends the failure streak."""
        with self._lock:
            self._age = 0
