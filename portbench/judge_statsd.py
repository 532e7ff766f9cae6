"""The comparison that decides `correct` for a cell of DogStatsD traffic:
every series the Datadog receiver got, flush by flush, against the
reference's state of the interval that produced it. Returns the numbers
compared, each with its limit."""

from __future__ import annotations

import gzip
import json
from typing import Dict, List

import numpy as np

from portbench.reference import statsd as ref

_AGGREGATES = ("min", "max", "count")
# the family a check is about: left out where the cell has no such keys
_FAMILY_CHECK = {"counter_wrong": "counter", "gauge_wrong": "gauge",
                 "timer_agg_wrong": "timer", "set_wrong": "set"}


def decode(groups: List[List[bytes]]) -> List[List[dict]]:
    """The series of each flush's bodies: the receiver closes a group
    after every flush has joined its sinks."""
    return [[s for body in group
             for s in json.loads(gzip.decompress(body))["series"]]
            for group in groups]


class _Names:
    """Series name -> (family code, key, suffix code); suffix 0 is the
    bare name, then the aggregates, then the percentiles."""

    def __init__(self, pool, percentiles):
        self.suffixes = ("",) + _AGGREGATES + tuple(
            f"{int(p * 100)}percentile" for p in percentiles)
        self.pct = {i: p for i, p in enumerate(percentiles,
                                               1 + len(_AGGREGATES))}
        self.full = {}
        for family, names in pool.names.items():
            code = ref.FAMILIES.index(family)
            for k, name in enumerate(names):
                if family == "timer":
                    for i, suffix in enumerate(self.suffixes[1:], 1):
                        self.full[f"{name}.{suffix}"] = (code, k, i)
                else:
                    self.full[name] = (code, k, 0)
        self.tags = {f: [list(t) for t in tags]
                     for f, tags in pool.tags.items()}


def judge(rec: dict, config: dict, limits: Dict[str, float],
          series_groups=None) -> Dict[str, dict]:
    """The numbers compared and their limits. `series_groups` replaces
    what the receiver got (the control puts the reference's own output,
    at a lower precision, in the program's place)."""
    pool = rec["pool"]
    percentiles = config["server"]["percentiles"]
    interval = float(str(config["server"]["interval"]).rstrip("s"))
    traffic = ref.Traffic(pool.fam, pool.key, pool.val, pool.values,
                          pool.rates, pool.members, config["keys"])
    names = _Names(pool, percentiles)
    flushes = rec["flushes"]
    groups = (series_groups if series_groups is not None
              else decode(rec["groups"]))
    # bodies after the last flush's cut came late: counted as unmatched
    late = sum(len(g) for g in groups[flushes:])
    groups = groups[:flushes]
    log = np.asarray(rec["log"], np.int64).reshape(-1, 2)
    n = {"feed_errors": len(rec["feed_errors"]),
         "flushes_unmatched": abs(len(groups) - flushes) + late,
         "counter_wrong": 0, "gauge_wrong": 0, "timer_agg_wrong": 0,
         "set_wrong": 0, "series_missing": 0, "series_extra": 0,
         "tags_wrong": 0}
    rank_err = [0.0]
    n_series = 0
    for epoch, series in enumerate(groups):
        exp = traffic.interval(
            ref.interval_weights(log, traffic.n_batches, epoch))
        hits = [names.full.get(s["metric"]) for s in series]
        mine = [(h, s) for h, s in zip(hits, series) if h is not None]
        fam_tags = [names.tags.get(f, ()) for f in ref.FAMILIES]
        n["tags_wrong"] += sum(1 for (f, k, _), s in mine
                               if s["tags"] != fam_tags[f][k])
        fam = [h[0] for h, _ in mine]
        key = [h[1] for h, _ in mine]
        suf = [h[2] for h, _ in mine]
        val = [s["points"][0][1] for _, s in mine]
        n_series += len(fam)
        fam, key, suf = (np.asarray(a, np.int64) for a in (fam, key, suf))
        val = np.asarray(val, np.float64)
        for code, family in enumerate(ref.FAMILIES):
            nk = traffic.num_keys[family]
            if not nk:
                continue
            present = exp[family]["present"]
            for i, suffix in enumerate(names.suffixes):
                if (family == "timer") == (i == 0):
                    continue
                at = np.flatnonzero((fam == code) & (suf == i))
                seen = np.bincount(key[at], minlength=nk)
                n["series_missing"] += int(np.count_nonzero(
                    present & (seen == 0)))
                n["series_extra"] += int(np.sum(np.where(
                    present, np.maximum(seen - 1, 0), seen)))
                k, v = key[at], val[at]
                ok = present[k]
                k, v = k[ok], v[ok]
                if i in names.pct:
                    if k.size:
                        rank_err.append(float(traffic.rank_error(
                            exp["timer"], k, np.full(k.size, names.pct[i]),
                            v).max()))
                    continue
                check = ("timer_agg_wrong" if family == "timer"
                         else f"{family}_wrong")
                n[check] += _wrong(traffic, exp, family, suffix, k, v,
                                   interval)
    checks = {name: {"value": int(value), "limit": 0}
              for name, value in n.items()
              if name not in _FAMILY_CHECK
              or traffic.num_keys[_FAMILY_CHECK[name]]}
    if traffic.num_keys["timer"]:
        checks["timer_rank_err_k"] = {"value": float(max(rank_err)),
                                      "limit": limits["timer_rank_err_k"]}
    checks["series_judged"] = {"value": n_series, "limit": None}
    return checks


def _wrong(traffic, exp, family: str, suffix: str, k: np.ndarray,
           v: np.ndarray, interval: float) -> int:
    """Series of present keys whose value is not the reference's."""
    if family == "counter":
        return int(np.count_nonzero(v != exp["counter"]["sum"][k]
                                    / interval))
    if family == "gauge":
        # a value the key received in the interval, exact in float32
        f32 = traffic.gauge_f32[traffic.gauge_order].astype(np.float64)
        i = np.clip(np.searchsorted(f32, v), 0, f32.size - 1)
        codes = k * f32.size + traffic.gauge_order[i]
        pairs = exp["gauge"]["pairs"]
        j = np.clip(np.searchsorted(pairs, codes), 0, pairs.size - 1)
        found = (f32[i] == v) & (pairs[j] == codes)
        return int(np.count_nonzero(~found))
    if family == "set":
        return int(np.count_nonzero(v != exp["set"]["estimate"][k]))
    t = exp["timer"]
    if suffix == "count":
        return int(np.count_nonzero(v != t["count"][k] / interval))
    return int(np.count_nonzero(v != t[suffix][k]))

