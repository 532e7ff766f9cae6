"""The comparison that decides `correct` for a local cell whose timers
aggregate as circllhist: every series the Datadog receiver got, flush by
flush, against the reference's state of the interval that produced it
(portbench/reference/statsd.py for counters, gauges and sets,
portbench/reference/llhist.py for the timers). Returns the numbers
compared, each with its limit.

A timer key's series are its percentiles, `.sum`, `.count` and its
`.bucket` counters, one a nonzero bin tagged `le:<bound>` and one tagged
`le:+Inf`:

- `.count` and every bucket are exact counts over the interval
  (`llhist_count_wrong`, `llhist_bucket_wrong`);
- `.sum` lies within a relative `llhist_sum_rel` of the float64 midpoint
  sum (`llhist_sum_wrong`);
- a percentile lies within `llhist_quantile_ulps` float32 ulps of the
  stated float32 rule (`llhist_quantile_wrong`);
- a percentile's bin lies at most one bin outside the bins of the
  samples at the exact weighted quantile's two closest ranks, widened by
  one sample on either side (`llhist_bin_err`): the binning checked
  against what was sent, independently of the registers.
"""

from __future__ import annotations

import gzip
import json
import re
from itertools import repeat
from typing import Dict, List

import numpy as np

from portbench.judge_statsd import _wrong
from portbench.reference import llhist as llref
from portbench.reference import statsd as ref

TIMER = ref.FAMILIES.index("timer")
# each `le:` tag as the Datadog sink writes it -> its sorted bin
_LE_RAW = {json.dumps(t).encode(): i for t, i in llref.LE_INDEX.items()}


_METRIC = re.compile(rb'"metric":\s*"([^"\\]*)"')
_POINT = re.compile(rb'"points":\s*\[\[[^,\]]*,\s*([^\]\s]*)\s*\]')
_TAGS = re.compile(rb'"tags":\s*\[([^\]]*)\]')


def _raw_tags(tags) -> bytes:
    """A tag list as the inside of its JSON array, as the Datadog sink
    writes it."""
    return json.dumps(list(tags), separators=(",", ":"))[1:-1].encode()


def flush_columns(group: List[bytes]):
    """The series of one flush's bodies as columns: names (bytes), values
    (float64) and each series' tags as the raw inside of its JSON array.
    A body whose series cannot be read field by field (each with exactly
    one name, one point and one tag array) is read as JSON instead."""
    names: List[bytes] = []
    vals: List[bytes] = []
    tags: List[bytes] = []
    for body in group:
        if body[:2] == b"\x1f\x8b":
            body = gzip.decompress(body)
        n, v, t = (_METRIC.findall(body), _POINT.findall(body),
                   _TAGS.findall(body))
        if not (len(n) == len(v) == len(t) == body.count(b'"metric"')):
            series = json.loads(body)["series"]
            n = [x["metric"].encode() for x in series]
            v = [json.dumps(x["points"][0][1]).encode() for x in series]
            t = [_raw_tags(x.get("tags", ())) for x in series]
        names += n
        vals += v
        tags += t
    return names, np.fromiter(map(float, vals), np.float64, len(vals)), tags


def series_body(series: List[dict]) -> bytes:
    """A list of series dicts as one (uncompressed) body."""
    return json.dumps({"series": series}, separators=(",", ":")).encode()


class _Names:
    """Series name (bytes) -> code of (family, key, suffix): suffix 0 is a
    bare name; a timer's are its percentiles, then `sum`, `count`,
    `bucket`. Each key's tags as the raw inside of a JSON array."""

    def __init__(self, pool, percentiles):
        self.pct = [f"{int(p * 100)}percentile" for p in percentiles]
        self.suffixes = ("",) + tuple(self.pct) + ("sum", "count", "bucket")
        self.nsuf = len(self.suffixes)
        self.sum, self.count, self.bucket = (self.nsuf - 3, self.nsuf - 2,
                                             self.nsuf - 1)
        self.kmax = max(len(v) for v in pool.names.values()) + 1
        self.full = {}
        for family, names in pool.names.items():
            code = ref.FAMILIES.index(family)
            for k, name in enumerate(names):
                base = (code * self.kmax + k) * self.nsuf
                if family == "timer":
                    for i, suffix in enumerate(self.suffixes[1:], 1):
                        self.full[f"{name}.{suffix}".encode()] = base + i
                else:
                    self.full[name.encode()] = base
        self.tags = [[list(t) for t in pool.tags.get(f, ())]
                     for f in ref.FAMILIES]
        self.raw = [np.array([_raw_tags(t) for t in pool.tags.get(f, ())]
                             + [b""], dtype=object)[:-1]
                    for f in ref.FAMILIES]

    def split(self, codes: np.ndarray):
        return (codes // (self.kmax * self.nsuf),
                (codes // self.nsuf) % self.kmax, codes % self.nsuf)


def timers_of(pool, config) -> llref.Timers:
    """The reference's view of the pool's timer lines."""
    n_batches, per = pool.fam.shape
    at = np.flatnonzero(pool.fam.reshape(-1) == TIMER)
    return llref.Timers(pool.key.reshape(-1)[at], at // per,
                        pool.values["timer"][pool.val.reshape(-1)[at]],
                        int(config["keys"].get("timer", 0)))


def _ulps(got: np.ndarray, want32: np.ndarray) -> np.ndarray:
    """float32 ulps between `got` (float64 as received) and the float32
    `want32`; inf where `got` is not a float32."""
    g32 = got.astype(np.float32)
    exact = g32.astype(np.float64) == got

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(ordered(g32) - ordered(want32.astype(np.float32)))
    return np.where(exact, d, np.inf)


def judge(rec: dict, config: dict, limits: Dict[str, float],
          series_groups=None) -> Dict[str, dict]:
    """The numbers compared and their limits. `series_groups` replaces
    what the receiver got (the control puts the reference's own output,
    at a lower precision, in the program's place)."""
    pool = rec["pool"]
    ps = config["server"]["percentiles"]
    interval = float(str(config["server"]["interval"]).rstrip("s"))
    sum_rel = float(limits["llhist_sum_rel"])
    max_ulps = float(limits["llhist_quantile_ulps"])
    traffic = ref.Traffic(pool.fam, pool.key, pool.val, pool.values,
                          pool.rates, pool.members, config["keys"])
    timers = timers_of(pool, config)
    names = _Names(pool, ps)
    flushes = rec["flushes"]
    groups = (rec["groups"] if series_groups is None
              else [[series_body(g)] for g in series_groups])
    # bodies after the last flush's cut came late: counted as unmatched
    late = sum(len(flush_columns(g)[0]) for g in groups[flushes:])
    groups = groups[:flushes]
    log = np.asarray(rec["log"], np.int64).reshape(-1, 2)
    n = {"feed_errors": len(rec["feed_errors"]),
         "flushes_unmatched": abs(len(groups) - flushes) + late,
         "counter_wrong": 0, "gauge_wrong": 0, "set_wrong": 0,
         "llhist_count_wrong": 0, "llhist_bucket_wrong": 0,
         "llhist_sum_wrong": 0, "llhist_quantile_wrong": 0,
         "llhist_bin_err": 0, "series_missing": 0, "series_extra": 0,
         "tags_wrong": 0}
    worst = {"llhist_sum_rel_max": 0.0, "llhist_quantile_ulps_max": 0.0}
    n_series = 0
    for epoch, group in enumerate(groups):
        w = ref.interval_weights(log, traffic.n_batches, epoch)
        exp = traffic.interval(w)
        reg = timers.interval(w)
        n_series += _judge_flush(flush_columns(group), names, traffic, exp,
                                 timers, reg, ps, interval, sum_rel,
                                 max_ulps, n, worst)
    n["sinks_skipped"] = rec.get("sinks_skipped", 0)
    checks = {name: {"value": int(value), "limit": 0}
              for name, value in n.items()}
    checks["llhist_sum_rel_max"] = {"value": worst["llhist_sum_rel_max"],
                                    "limit": None}
    checks["llhist_quantile_ulps_max"] = {
        "value": worst["llhist_quantile_ulps_max"], "limit": None}
    checks["series_judged"] = {"value": n_series, "limit": None}
    return checks


def _judge_flush(columns, names, traffic, exp, timers, reg, ps, interval,
                 sum_rel, max_ulps, n, worst) -> int:
    """Judge one flush's series into the counts `n`; returns how many
    series named a key of the cell."""
    got_names, got_vals, got_tags = columns
    codes = np.fromiter(map(names.full.get, got_names, repeat(-1)),
                        np.int64, len(got_names))
    mine = np.flatnonzero(codes >= 0)
    fam, key, suf = names.split(codes[mine])
    val = got_vals[mine]
    raw = [got_tags[j] for j in mine.tolist()]
    bucket = names.bucket
    le = np.full(mine.size, -1, np.int64)
    # a bucket's tags as the sink writes them: its key's, then its `le:`
    at_b = np.flatnonzero(suf == bucket)
    parts = [raw[j].rpartition(b",") for j in at_b.tolist()]
    le[at_b] = np.fromiter((_LE_RAW.get(p[2], -1) for p in parts),
                           np.int64, len(parts))
    for j, p in zip(at_b.tolist(), parts):
        raw[j] = p[0]
    exp_raw = np.empty(mine.size, object)
    for code in np.unique(fam).tolist():
        at = fam == code
        exp_raw[at] = names.raw[code][key[at]]
    differ = np.flatnonzero(np.asarray(raw + [None], object)[:-1] != exp_raw)
    is_bucket = suf == bucket
    for j in differ.tolist():
        # not the sink's own rendering: compare the tags as a list
        try:
            got = json.loads(b"[" + got_tags[mine[j]] + b"]")
        except ValueError:
            n["tags_wrong"] += 1
            continue
        if is_bucket[j]:
            les = [t for t in got if str(t).startswith("le:")]
            le[j] = llref.LE_INDEX.get(les[0], -1) if len(les) == 1 else -1
            got = [t for t in got if not str(t).startswith("le:")]
        if got != names.tags[fam[j]][key[j]]:
            n["tags_wrong"] += 1
    # counters, gauges, sets: as the t-digest cell judges them
    for code, family in enumerate(ref.FAMILIES):
        nk = traffic.num_keys[family]
        if family == "timer" or not nk:
            continue
        at = np.flatnonzero((fam == code) & (suf == 0))
        k, v = _present(key[at], val[at], exp[family]["present"], nk, n)
        n[f"{family}_wrong"] += _wrong(traffic, exp, family, "", k, v,
                                       interval)
    if not timers.num_keys:
        return int(fam.size)
    tm = fam == TIMER
    present = reg["present"]
    nk = timers.num_keys
    q32 = timers.quantiles(reg, ps)
    for j, p in enumerate(ps):
        at = np.flatnonzero(tm & (suf == 1 + j))
        k, v = _present(key[at], val[at], present, nk, n)
        ulps = _ulps(v, q32[k, j])
        n["llhist_quantile_wrong"] += int(np.count_nonzero(ulps > max_ulps))
        if ulps.size:
            worst["llhist_quantile_ulps_max"] = max(
                worst["llhist_quantile_ulps_max"], float(ulps.max()))
        span = timers.rank_bins(reg, k, np.full(k.size, p))
        b = llref.sorted_bin(v).numpy()
        err = np.maximum(np.maximum(span["lo"] - b, b - span["hi"]), 0)
        n["llhist_bin_err"] += int(np.count_nonzero(err > 1))
    at = np.flatnonzero(tm & (suf == names.sum))
    k, v = _present(key[at], val[at], present, nk, n)
    want = timers.midpoint_sums(reg)[k]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(v == want, 0.0, np.abs(v - want) / np.abs(want))
    rel = np.where(np.isnan(rel), np.inf, rel)
    n["llhist_sum_wrong"] += int(np.count_nonzero(rel > sum_rel))
    if rel.size:
        worst["llhist_sum_rel_max"] = max(worst["llhist_sum_rel_max"],
                                          float(rel.max()))
    at = np.flatnonzero(tm & (suf == names.count))
    k, v = _present(key[at], val[at], present, nk, n)
    n["llhist_count_wrong"] += int(np.count_nonzero(
        v != reg["total"][k] / interval))
    # buckets: (key, sorted bin) and (key, +Inf) against the registers
    at = np.flatnonzero(tm & (suf == bucket))
    width = llref.BINS + 1
    got_code = key[at] * width + le[at]
    bad_le = le[at] < 0
    n["series_extra"] += int(np.count_nonzero(bad_le))
    got_code, got_val = got_code[~bad_le], val[at][~bad_le]
    keys_p = np.flatnonzero(present)
    want_code = np.concatenate([reg["key"] * width + reg["bin"],
                                keys_p * width + llref.BINS])
    want_val = np.concatenate([reg["cum"], reg["total"][keys_p]]
                              ).astype(np.float64) / interval
    order = np.argsort(want_code)
    want_code, want_val = want_code[order], want_val[order]
    uniq, first, seen = np.unique(got_code, return_index=True,
                                  return_counts=True)
    n["series_extra"] += int(np.sum(seen - 1))
    pos = np.clip(np.searchsorted(want_code, uniq), 0,
                  max(want_code.size - 1, 0))
    found = (want_code[pos] == uniq) if want_code.size else \
        np.zeros(uniq.size, bool)
    n["series_extra"] += int(np.count_nonzero(~found))
    n["series_missing"] += int(want_code.size - np.count_nonzero(found))
    n["llhist_bucket_wrong"] += int(np.count_nonzero(
        got_val[first[found]] != want_val[pos[found]]))
    return int(fam.size)


def _present(k: np.ndarray, v: np.ndarray, present: np.ndarray, nk: int,
             n: dict):
    """Count the missing and extra series of one kind (one a present key
    is due), and keep those of present keys."""
    seen = np.bincount(k, minlength=nk)
    n["series_missing"] += int(np.count_nonzero(present & (seen == 0)))
    n["series_extra"] += int(np.sum(np.where(present,
                                             np.maximum(seen - 1, 0), seen)))
    ok = present[k]
    return k[ok], v[ok]
