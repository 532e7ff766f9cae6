"""Cardinality observatory: per-name series accounting + shed rung
(a copy of veneur_tpu/core/cardinality.py; host code, its imports
changed).

veneur's whole job is surviving other people's metrics, and the thing
that kills a metrics aggregator is a cardinality explosion: one bad tag
mints unbounded keys. On the device column store the cost is worse than
host memory — every capacity doubling is permanent device-memory
growth. This module makes series cardinality itself observable and
actionable, reusing the paper's own sketch machinery:

- `SpaceSaving`: a bounded-memory heavy-hitter tracker (space-saving,
  with SALSA-style self-adjusting decay at each flush) keyed by metric
  NAME. Fed from the column store's interning path — mints are already
  the slow path, so the hot columnar ingest never pays for it.
  Per-name records carry live-row counts (exact while tracked: mints
  increment, idle-evictions decrement), interval mint counts, and shed
  counts.
- `TagCardinality`: for the current top offenders, per-tag-key
  HyperLogLog distinct-value estimates (ops/hll_ref, p=14), so an
  operator sees WHICH tag is exploding, not just which name. Fed on
  mint attempts — including rejected ones, which is exactly when you
  need the diagnosis.
- the **cardinality watermark rung** of the overload ladder: past
  `cardinality_soft_limit` new-key mints per name per interval, further
  mints for that name are admitted deterministically 1-in-N
  (`cardinality_degraded_keep`); past `cardinality_hard_limit` they are
  rejected outright. Existing rows always keep updating — only NEW keys
  are gated, so pre-existing series never lose a sample. Every shed
  mint is accounted through the server's `ingest.shed_total` path with
  `reason:cardinality` / `reason:cardinality_degraded`. Budgets reset
  at every flush (`roll_interval`), so recovery after a storm is
  immediate: within one interval of the storm stopping, new keys mint
  again.

Everything is thread-safe and allocation-bounded: the tracker holds at
most `top_k` records, tag tracking at most `hll_names` names x
`MAX_TAG_KEYS` HLLs (16 KB each).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from veneur_tpu_torch.ops import hll_ref

logger = logging.getLogger("veneur_tpu_torch.cardinality")

# hard bound on distinct tag KEYS tracked per offending name; a name
# whose samples carry more distinct tag keys than this overflows into
# `tag_keys_overflow` (counted, never allocated)
MAX_TAG_KEYS = 16

# a tag-tracked name idle (no mint attempts) for this many intervals
# releases its HLL slot to the next offender
TAG_IDLE_INTERVALS = 5


class NameRecord:
    """One tracked metric name's accounting. Mutated only under the
    owning accountant's lock."""

    __slots__ = ("name", "weight", "error", "mints_total",
                 "mints_interval", "mints_last_interval", "live_rows",
                 "families", "shed_total", "shed_interval",
                 "first_seen_unix")

    def __init__(self, name: str, error: float = 0.0):
        self.name = name
        # decayed mint score: the space-saving ordering key. `error` is
        # the classic space-saving overestimate bound inherited from the
        # evicted record this one replaced.
        self.weight = 0.0
        self.error = error
        self.mints_total = 0
        self.mints_interval = 0
        self.mints_last_interval = 0
        self.live_rows = 0
        self.families: Dict[str, int] = {}
        self.shed_total = 0
        self.shed_interval = 0
        self.first_seen_unix = time.time()

    def as_dict(self, interval_s: float) -> dict:
        rate = (self.mints_last_interval / interval_s
                if interval_s > 0 else 0.0)
        return {
            "name": self.name,
            "live_rows": self.live_rows,
            "families": dict(self.families),
            "mints_total": self.mints_total,
            "mints_interval": self.mints_interval,
            "mints_last_interval": self.mints_last_interval,
            "mint_rate_per_s": round(rate, 3),
            "shed_total": self.shed_total,
            "weight": round(self.weight, 3),
            "weight_error": round(self.error, 3),
            "first_seen_unix": round(self.first_seen_unix, 3),
        }


class SpaceSaving:
    """Space-saving heavy hitters over metric names, bounded at
    `capacity` records. Not thread-safe on its own — the accountant
    serializes access.

    Eviction is amortized: hitting capacity purges the lowest-scored
    quarter in one O(K log K) pass (score = weight + live rows — a name
    that still owns live rows stays resident even when its mint stream
    went quiet), so a unique-name flood costs O(log K) per mint instead
    of an O(K) min-scan each. Records minted after a purge inherit the
    highest purged score as their error bound — the space-saving
    guarantee, batched: a name minting more than any purged record can
    never be silently lost, and `error` bounds how much of its count
    predates tracking."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(8, int(capacity))
        self.records: Dict[str, NameRecord] = {}
        self.evictions = 0
        self._pending_error = 0.0  # max score purged in the last sweep

    @staticmethod
    def _score(rec: NameRecord) -> float:
        return rec.weight + float(rec.live_rows)

    def get_or_track(self, name: str) -> NameRecord:
        rec = self.records.get(name)
        if rec is None:
            if len(self.records) >= self.capacity:
                ranked = sorted(self.records.values(), key=self._score)
                purge = ranked[:max(1, self.capacity // 4)]
                for victim in purge:
                    del self.records[victim.name]
                self.evictions += len(purge)
                # takeover inherits only the purged WEIGHT (the mint
                # count being bounded), never the live-row gauge — or a
                # brand-new name minted after purging a row-heavy victim
                # would instantly fake a top-offender score
                self._pending_error = max(v.weight for v in purge)
            rec = NameRecord(name, error=self._pending_error)
            rec.weight = self._pending_error  # space-saving takeover
            self.records[name] = rec
        return rec

    def decay(self, factor: float) -> None:
        """SALSA-style self-adjustment, run once per interval: old mint
        activity fades so the tracker follows the CURRENT storm, and
        rows with no weight and no live rows release their slots."""
        drop = [name for name, rec in self.records.items()
                if rec.weight * factor < 0.5 and rec.live_rows <= 0]
        for name in drop:
            del self.records[name]
        for rec in self.records.values():
            rec.weight *= factor
            rec.error *= factor
        self._pending_error *= factor

    def top(self, n: int) -> List[NameRecord]:
        return sorted(self.records.values(), key=self._score,
                      reverse=True)[:max(0, n)]


class TagCardinality:
    """Per-tag-key HLL distinct-value estimates for a bounded set of
    offender names. 16 KB per (name, tag key); bounded at
    `max_names` x MAX_TAG_KEYS."""

    def __init__(self, max_names: int = 8):
        self.max_names = max(0, int(max_names))
        # name -> {tag_key: HLL}
        self._hlls: Dict[str, Dict[str, hll_ref.HLL]] = {}
        self._overflow: Dict[str, int] = {}  # name -> tag keys not tracked
        self._idle: Dict[str, int] = {}      # name -> idle interval count
        self._since: Dict[str, float] = {}   # name -> tracking start unix

    def tracking(self, name: str) -> bool:
        return name in self._hlls

    def can_track(self) -> bool:
        return len(self._hlls) < self.max_names

    def start(self, name: str) -> None:
        if name not in self._hlls and self.can_track():
            self._hlls[name] = {}
            self._overflow[name] = 0
            self._idle[name] = 0
            self._since[name] = time.time()
            logger.info("cardinality: tag tracking started for %r", name)

    def observe(self, name: str, tags: Sequence[str]) -> None:
        per_key = self._hlls.get(name)
        if per_key is None:
            return
        self._idle[name] = 0
        for tag in tags:
            key, sep, value = tag.partition(":")
            if not sep:
                key, value = tag, ""
            hll = per_key.get(key)
            if hll is None:
                if len(per_key) >= MAX_TAG_KEYS:
                    self._overflow[name] += 1
                    continue
                hll = per_key[key] = hll_ref.HLL()
            hll.insert(value.encode())

    def roll_interval(self) -> None:
        """Release slots held by names whose storm has been quiet for
        TAG_IDLE_INTERVALS intervals."""
        for name in list(self._hlls):
            self._idle[name] = self._idle.get(name, 0) + 1
            if self._idle[name] > TAG_IDLE_INTERVALS:
                del self._hlls[name]
                self._overflow.pop(name, None)
                self._idle.pop(name, None)
                self._since.pop(name, None)
                logger.info(
                    "cardinality: tag tracking released for %r (idle)",
                    name)

    def report(self, name: str) -> Optional[dict]:
        per_key = self._hlls.get(name)
        if per_key is None:
            return None
        return {
            "since_unix": round(self._since.get(name, 0.0), 3),
            "tag_keys": {k: int(h.estimate())
                         for k, h in sorted(per_key.items())},
            "tag_keys_overflow": self._overflow.get(name, 0),
        }

    def tracked_names(self) -> List[str]:
        return sorted(self._hlls)


class CardinalityAccountant:
    """The server's cardinality posture: the heavy-hitter tracker, tag
    HLLs, per-name mint budgets (the shed rung), and the telemetry
    collector that exports all of it.

    Hot-path contract: `admit_mint` / `note_mint` / `note_evicted` are
    called from the column-store interning and reclaim paths (under the
    table's buffer lock). They take only this accountant's own lock and
    never call back into store or telemetry locks — dict increments plus,
    for the few tracked offenders, HLL register updates."""

    DECAY = 0.8  # per-interval weight decay (SALSA self-adjustment)

    def __init__(self, soft_limit: int = 0, hard_limit: int = 0,
                 degraded_keep: float = 0.1, top_k: int = 512,
                 hll_names: int = 8, hll_min_mints: int = 64,
                 on_shed: Optional[Callable[[str, int, str], None]] = None,
                 on_event: Optional[Callable[..., None]] = None):
        self.soft_limit = max(0, int(soft_limit))
        self.hard_limit = max(0, int(hard_limit))
        self.degraded_keep = min(1.0, max(0.0, float(degraded_keep)))
        self._keep_every = (max(1, round(1.0 / self.degraded_keep))
                            if self.degraded_keep > 0 else 0)
        self.hll_min_mints = max(1, int(hll_min_mints))
        # on_shed(family_class, n, reason): the server wires this to
        # OverloadManager.shed so rejected mints land in
        # ingest.shed_total{reason:cardinality} like every other shed
        self.on_shed = on_shed
        # on_event(kind, **fields): flight-recorder hook for limit edges
        self.on_event = on_event
        self._lock = threading.Lock()
        self.tracker = SpaceSaving(top_k)
        self.tags = TagCardinality(hll_names)
        self.minted_total = 0
        self.shed_hard_total = 0
        self.shed_soft_total = 0
        self.interval_s = 0.0  # measured flush-to-flush, for rates
        self._last_roll = time.monotonic()
        # names currently over a limit (for /debug/cardinality and the
        # one-edge-per-interval event dedup)
        self._over_soft: Dict[str, bool] = {}
        self._over_hard: Dict[str, bool] = {}

    @property
    def enabled(self) -> bool:
        return self.soft_limit > 0 or self.hard_limit > 0

    # -- hot path (column-store interning) -------------------------------

    def admit_mint(self, family: str, name: str,
                   tags: Sequence[str]) -> bool:
        """One new-key mint ATTEMPT for `name`. Records the attempt
        (tracker weight + tag HLLs — rejected mints still feed the
        diagnosis; that is when the operator needs it), then applies the
        per-name interval budget. Returns False when the mint must be
        rejected; the caller drops the sample and this accountant has
        already counted the shed."""
        events = []
        with self._lock:
            rec = self.tracker.get_or_track(name)
            rec.weight += 1.0
            rec.mints_total += 1
            rec.mints_interval += 1
            mints = rec.mints_interval
            if (not self.tags.tracking(name)
                    and mints >= self.hll_min_mints
                    and self.tags.can_track()):
                self.tags.start(name)
            self.tags.observe(name, tags)
            verdict = True
            reason = ""
            if self.hard_limit and mints > self.hard_limit:
                verdict, reason = False, "cardinality"
                rec.shed_total += 1
                rec.shed_interval += 1
                self.shed_hard_total += 1
                if not self._over_hard.get(name):
                    self._over_hard[name] = True
                    events.append(("cardinality_hard_limit", name, mints))
            elif self.soft_limit and mints > self.soft_limit:
                if not self._over_soft.get(name):
                    self._over_soft[name] = True
                    events.append(("cardinality_soft_limit", name, mints))
                # deterministic keep-1-in-N past the soft watermark:
                # the key stream stays statistically visible while the
                # mint (and device-memory) rate is cut
                keep = (self._keep_every
                        and (mints - self.soft_limit) % self._keep_every
                        == 0)
                if not keep:
                    verdict, reason = False, "cardinality_degraded"
                    rec.shed_total += 1
                    rec.shed_interval += 1
                    self.shed_soft_total += 1
        if not verdict and self.on_shed is not None:
            self.on_shed(family, 1, reason)
        for kind, nm, mints in events:
            logger.warning(
                "cardinality: %s crossed for %r (%d mints this interval)",
                kind, nm, mints)
            if self.on_event is not None:
                try:
                    self.on_event(kind, name=nm, family=family,
                                  mints_interval=mints)
                except Exception:
                    logger.exception("cardinality event hook failed")
        return verdict

    def note_mint(self, family: str, name: str) -> None:
        """A mint that actually allocated a row (admission and the
        max_rows cap both passed)."""
        with self._lock:
            self.minted_total += 1
            rec = self.tracker.records.get(name)
            if rec is not None:
                rec.live_rows += 1
                rec.families[family] = rec.families.get(family, 0) + 1

    def note_evicted(self, family: str, names: Sequence[str]) -> None:
        """Idle-reclaim tombstoned these rows; live counts shrink."""
        if not names:
            return
        with self._lock:
            for name in names:
                rec = self.tracker.records.get(name)
                if rec is not None and rec.live_rows > 0:
                    rec.live_rows -= 1
                    fams = rec.families
                    if fams.get(family, 0) > 1:
                        fams[family] -= 1
                    else:
                        fams.pop(family, None)

    # -- interval rollover (flush path) ----------------------------------

    def roll_interval(self) -> None:
        """Reset per-interval mint budgets (the shed rung's immediate
        recovery), decay the tracker, age out idle tag tracking. Called
        once per flush by the server."""
        now = time.monotonic()
        with self._lock:
            self.interval_s = max(1e-6, now - self._last_roll)
            self._last_roll = now
            # budgets reset -> every over-limit name recovers NOW; a
            # storm that continues re-crosses within the next interval
            # and emits a fresh limit event (one edge pair per interval
            # per name, bounded by the tracker capacity)
            recovered = sorted(set(self._over_hard) | set(self._over_soft))
            self._over_hard.clear()
            self._over_soft.clear()
            for rec in self.tracker.records.values():
                rec.mints_last_interval = rec.mints_interval
                rec.mints_interval = 0
                rec.shed_interval = 0
            self.tracker.decay(self.DECAY)
            self.tags.roll_interval()
        for name in recovered:
            if self.on_event is not None:
                try:
                    self.on_event("cardinality_recovered", name=name)
                except Exception:
                    logger.exception("cardinality event hook failed")

    # -- reads ------------------------------------------------------------

    def top(self, n: int) -> List[dict]:
        with self._lock:
            interval = self.interval_s
            return [rec.as_dict(interval) for rec in self.tracker.top(n)]

    def name_report(self, name: str) -> dict:
        with self._lock:
            rec = self.tracker.records.get(name)
            out = {"name": name,
                   "tracked": rec is not None}
            if rec is not None:
                out.update(rec.as_dict(self.interval_s))
            tag_report = self.tags.report(name)
            if tag_report is not None:
                out["tags"] = tag_report
            return out

    def tag_report(self, name: str) -> Optional[dict]:
        """Per-tag-key HLL estimates for `name`, or None if untracked."""
        with self._lock:
            return self.tags.report(name)

    def limits_report(self) -> dict:
        with self._lock:
            return {
                "soft_limit": self.soft_limit,
                "hard_limit": self.hard_limit,
                "degraded_keep": self.degraded_keep,
                "shed_soft_total": self.shed_soft_total,
                "shed_hard_total": self.shed_hard_total,
                "over_soft": sorted(self._over_soft),
                "over_hard": sorted(self._over_hard),
            }

    def telemetry_rows(self) -> List[tuple]:
        """(name, kind, value, tags) rows for the /metrics collector.
        Per-name rows are bounded to the top 5 offenders."""
        with self._lock:
            rows = [
                ("cardinality.names_tracked", "gauge",
                 float(len(self.tracker.records)), ()),
                ("cardinality.tracker_evictions", "counter",
                 float(self.tracker.evictions), ()),
                ("cardinality.mints_total", "counter",
                 float(self.minted_total), ()),
                ("cardinality.tag_tracked_names", "gauge",
                 float(len(self.tags.tracked_names())), ()),
            ]
            for rec in self.tracker.top(5):
                tags = [f"name:{rec.name}"]
                rows.append(("cardinality.top_name_live_rows", "gauge",
                             float(rec.live_rows), tags))
                rows.append(("cardinality.top_name_mints_interval",
                             "gauge", float(rec.mints_last_interval),
                             tags))
        return rows
