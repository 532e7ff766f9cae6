"""What a local veneur's flush of DogStatsD traffic has to hold, from the
lines the harness generated and the batches each interval took:
counters, gauges, timers and sets, per key.

The traffic is a pool of batches of lines; an interval is described by
`w`, how many times it took each batch of the pool.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from portbench.reference import hll

FAMILIES = ("counter", "gauge", "timer", "set")
COMPRESSION = 100.0  # the t-digest's k-scale: 0..100 over the quantiles
# a reported quantile is placed among the samples within this tolerance
# (K1's against its plain version: a centroid's float32 mean of equal
# samples need not be that sample to the last bit)
RTOL, ATOL = 2e-5, 1e-4


def k_scale(q):
    """The t-digest's arcsine scale, in k-units from 0 to COMPRESSION."""
    q = np.clip(np.asarray(q, np.float64), 0.0, 1.0)
    return COMPRESSION * (np.arcsin(2.0 * q - 1.0) / math.pi + 0.5)


class Traffic:
    """The pool's lines grouped by family and key, for any interval."""

    def __init__(self, fam: np.ndarray, key: np.ndarray, val: np.ndarray,
                 values: Dict[str, np.ndarray], rates: np.ndarray,
                 members, num_keys: Dict[str, int]):
        n_batches, per = fam.shape
        num_keys = {f: int(num_keys.get(f, 0)) for f in FAMILIES}
        batch = np.repeat(np.arange(n_batches), per)
        fam, key, val = fam.reshape(-1), key.reshape(-1), val.reshape(-1)
        self.n_batches = n_batches
        self.num_keys = num_keys
        self.fam = {}
        self.seg = {}
        for code, family in enumerate(FAMILIES):
            at = np.flatnonzero(fam == code)
            k, v, b = key[at].astype(np.int64), val[at].astype(np.int64), \
                batch[at]
            if family == "timer":
                # lines in (key, value) order, values ranked by their
                # float32 form as the card holds them
                table = values.get("timer", np.zeros(0)).astype(
                    np.float32).astype(np.float64)
                order_t = np.argsort(table, kind="stable")
                rank = np.empty_like(order_t)
                rank[order_t] = np.arange(order_t.size)
                self.timer_sorted = table[order_t]
                v = rank[v]
                o = np.argsort(k * self.timer_sorted.size + v)
            else:
                o = np.argsort(k, kind="stable")
            self.fam[family] = (k[o], v[o], b[o])
            self.seg[family] = np.searchsorted(
                k[o], np.arange(num_keys[family] + 1))
        self.timer_n = self.timer_sorted.size
        tk, tv, _ = self.fam["timer"]
        self.timer_comp = tk * self.timer_n + tv
        self.values = values
        none = np.zeros(0)
        self.contrib = np.trunc(
            (values.get("counter", none).astype(np.float32)[None, :]
             / np.asarray(rates, np.float32)[:, None])).astype(np.float64)
        self.gauge_f32 = values.get("gauge", none).astype(np.float32)
        self.gauge_order = np.argsort(self.gauge_f32, kind="stable")
        self.member_idx, self.member_rho = hll.registers_of(list(members))

    # -- one interval -------------------------------------------------------

    def interval(self, w: np.ndarray) -> dict:
        """Every family's expected state for the interval that took each
        pool batch `w[b]` times."""
        out = {}
        k, v, b = self.fam["counter"]
        lw = w[b].astype(np.float64)
        n = self.num_keys["counter"]
        out["counter"] = {
            "present": np.bincount(k, weights=lw, minlength=n) > 0,
            "sum": np.bincount(k, weights=lw * self.contrib[k, v],
                               minlength=n)}
        k, v, b = self.fam["gauge"]
        live = w[b] > 0
        n = self.num_keys["gauge"]
        out["gauge"] = {
            "present": np.bincount(k[live], minlength=n) > 0,
            "pairs": np.unique(k[live] * len(self.gauge_f32) + v[live])}
        out["timer"] = self._timers(w)
        out["set"] = self._sets(w)
        return out

    def _timers(self, w: np.ndarray) -> dict:
        k, v, b = self.fam["timer"]
        n = self.num_keys["timer"]
        lw = w[b].astype(np.float64)
        count = np.bincount(k, weights=lw, minlength=n)
        live = np.flatnonzero(lw > 0)
        mins = np.full(n, np.nan)
        maxs = np.full(n, np.nan)
        # live lines are in (key, value) order: a key's first and last
        # live line hold its least and greatest value
        keys_live = k[live]
        bounds = np.searchsorted(keys_live, np.arange(n + 1))
        kk = np.flatnonzero(bounds[1:] > bounds[:-1])
        mins[kk] = self.timer_sorted[v[live[bounds[kk]]]]
        maxs[kk] = self.timer_sorted[v[live[bounds[kk + 1] - 1]]]
        comp = self.timer_comp[live]
        return {"present": count > 0, "count": count, "min": mins,
                "max": maxs, "comp": comp,
                "cw": np.concatenate([[0.0], np.cumsum(lw[live])]),
                "start": np.searchsorted(comp, np.arange(n + 1)
                                         * self.timer_n)}

    def rank_error(self, timers: dict, keys: np.ndarray, qs: np.ndarray,
                   got: np.ndarray) -> np.ndarray:
        """How far, in k-units, each reported quantile `got` of key
        `keys` at `qs` lies outside the quantiles its value may stand
        for among the interval's samples: the ranks of the samples it
        equals, or, between two distinct samples, the ranks of both
        neighbouring values (an interpolation between them), widened by
        one sample on either side."""
        comp, cw = timers["comp"], timers["cw"]
        keys = np.asarray(keys, np.int64)
        got = np.asarray(got, np.float64)
        tol = RTOL * np.abs(got) + ATOL
        base = keys * self.timer_n
        lo = np.searchsorted(comp, base + np.searchsorted(
            self.timer_sorted, got - tol, "left"), "left")
        hi = np.searchsorted(comp, base + np.searchsorted(
            self.timer_sorted, got + tol, "right"), "left")
        first, end = timers["start"][keys], timers["start"][keys + 1]
        between = lo >= hi
        below = np.maximum(lo - 1, first)
        lo_b = np.where(between & (lo > first),
                        np.searchsorted(comp, comp[np.minimum(
                            below, comp.size - 1)], "left"), lo)
        hi_b = np.where(between & (hi < end),
                        np.searchsorted(comp, comp[np.minimum(
                            hi, comp.size - 1)], "right"), hi)
        n = cw[end] - cw[first]
        with np.errstate(divide="ignore", invalid="ignore"):
            q_lo = (cw[lo_b] - cw[first] - 1.0) / n
            q_hi = (cw[np.minimum(hi_b, end)] - cw[first] + 1.0) / n
        kq = k_scale(qs)
        err = np.maximum(np.maximum(k_scale(q_lo) - kq,
                                    kq - k_scale(q_hi)), 0.0)
        return np.where(np.isfinite(got) & (n > 0), err, np.inf)

    def _sets(self, w: np.ndarray) -> dict:
        k, v, b = self.fam["set"]
        n = self.num_keys["set"]
        live = w[b] > 0
        pairs = np.unique(k[live] * len(self.member_idx) + v[live])
        pk = pairs // len(self.member_idx)
        pm = pairs % len(self.member_idx)
        regs = pk * hll.M + self.member_idx[pm]
        order = np.lexsort((self.member_rho[pm], regs))
        regs_s = regs[order]
        rho_s = self.member_rho[pm][order].astype(np.int64)
        last = np.flatnonzero(np.append(regs_s[1:] != regs_s[:-1],
                                        regs_s.size > 0))
        reg_keys = regs_s[last] // hll.M
        nonzero = np.bincount(reg_keys, minlength=n)
        inv = np.bincount(reg_keys, weights=np.exp2(-rho_s[last]
                                                     .astype(np.float64)),
                          minlength=n)
        return {"present": nonzero > 0,
                "estimate": hll.estimates(nonzero, inv)}


def interval_weights(log: np.ndarray, n_batches: int,
                     epoch: int) -> np.ndarray:
    """How many times the interval `epoch` took each batch, from the
    gate's log, an (entries, 2) array of (epoch, batch id)."""
    ids = log[log[:, 0] == epoch, 1]
    return np.bincount(ids, minlength=n_batches)
