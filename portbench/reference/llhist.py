"""What a local veneur with `histogram_encoding: circllhist` has to flush
for its timers, written from the stated bin layout (Circllhist,
arXiv:2001.06561, as the README's "Log-linear histograms & OTLP" fixes
it) in plain torch on the CPU, and nothing of the program:

- a value's bin, by the float64 rule: |v| below 1e-9 is the zero bin;
  otherwise e = floor(log10 |v|), corrected so that 10^e <= |v| <
  10^(e+1), clamped to [-9, 15], and the mantissa bucket m =
  floor(|v| / 10^(e-1)), clamped to [10, 99]; bin (e, m) covers
  [m 10^(e-1), (m+1) 10^(e-1)), mirrored for negative values;
- the registers, exact integer counts per (key, bin) over an interval;
- the bins in value order (negative bins from the most negative, the
  zero bin, the positive bins ascending): the `.bucket` lines are the
  cumulative counts at every nonzero bin, each tagged `le:<upper edge>`
  with the edge formatted `.12g`, and `le:+Inf` carrying the total;
- each percentile p by the float32 rule: rank = max(p n, 0.5); the first
  bin whose cumulative count reaches the rank; frac = (rank - the count
  below it) / its count, clamped to [0, 1]; left + width frac;
- `.sum`, the float64 sum of every bin's count times its midpoint.

Two departures from a reading of the README alone, both the layout as
the program states it: the powers of ten are the correctly rounded
doubles 10.0 ** k (so a value such as 1.2 whose quotient 1.2 / 0.1 falls
a hair below 12 lands in the bucket below, as the program bins it), and
a magnitude of 10^16 or more clamps into the top bin of its sign.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXP_MIN, EXP_MAX = -9, 15
MANT = 90                      # mantissa buckets 10..99
NEXP = EXP_MAX - EXP_MIN + 1   # 25 exponents
HALF = MANT * NEXP             # 2250 bins of each sign
BINS = 2 * HALF + 1            # 4501; sorted index HALF is the zero bin
MIN_MAG = 1e-9
F64, F32 = torch.float64, torch.float32
# 10.0 ** k for k in [EXP_MIN - 2, EXP_MAX + 2], index k - (EXP_MIN - 2)
_P0 = EXP_MIN - 2
POW10 = torch.tensor([10.0 ** k for k in range(_P0, EXP_MAX + 3)], dtype=F64)


def _pow10(e: torch.Tensor) -> torch.Tensor:
    return POW10[(e - _P0).long()]


def sorted_bin(values) -> torch.Tensor:
    """The value-ordered bin index (0..BINS-1) of each float64 value."""
    v = torch.as_tensor(np.asarray(values, np.float64)).reshape(-1)
    a = v.abs()
    live = a >= MIN_MAG
    e = torch.floor(torch.log10(torch.where(live, a, 1.0)))
    e = e.clamp(EXP_MIN - 1, EXP_MAX + 1)
    e = torch.where(a < _pow10(e), e - 1, e)
    e = torch.where(a >= _pow10(e + 1), e + 1, e)
    e = e.clamp(EXP_MIN, EXP_MAX)
    m = torch.floor(torch.where(live, a, 1.0) / _pow10(e - 1))
    m = m.clamp(10, 99)
    pos = (e - EXP_MIN).long() * MANT + (m - 10).long()   # 0..HALF-1
    out = torch.where(v < 0, HALF - 1 - pos, HALF + 1 + pos)
    return torch.where(live, out, torch.full_like(out, HALF))


def _geometry():
    """Per sorted bin, float64: lower edge, width, midpoint."""
    e = torch.arange(EXP_MIN, EXP_MAX + 1, dtype=F64).repeat_interleave(MANT)
    m = torch.arange(10, 100, dtype=F64).repeat(NEXP)
    width = _pow10(e - 1)
    left = m * width
    mid = left + width / 2
    zero = torch.zeros(1, dtype=F64)
    return (torch.cat([-(left + width).flip(0), zero, left]),
            torch.cat([width.flip(0), zero, width]),
            torch.cat([-mid.flip(0), zero, mid]))


LEFT, WIDTH, MID = _geometry()
UPPER = LEFT + WIDTH
LEFT32, WIDTH32 = LEFT.to(F32), WIDTH.to(F32)
# `le:` tag of each sorted bin, and BINS for `le:+Inf`
LE_TAGS = [f"le:{format(u, '.12g')}" for u in UPPER.tolist()] + ["le:+Inf"]
LE_INDEX = {t: i for i, t in enumerate(LE_TAGS)}


class Timers:
    """The pool's timer lines, grouped by (key, bin) and by (key, value),
    for any interval: `key` and `batch` per line, `values` the float64
    value of each line as sent."""

    def __init__(self, key: np.ndarray, batch: np.ndarray,
                 values: np.ndarray, num_keys: int):
        self.num_keys = num_keys
        key = np.asarray(key, np.int64)
        values = np.asarray(values, np.float64)
        sbin = sorted_bin(values).numpy()
        self.pairs, self.inverse = np.unique(key * BINS + sbin,
                                             return_inverse=True)
        self.batch = np.asarray(batch, np.int64)
        order = np.lexsort((values, key))
        self.v_key = key[order]
        self.v_value = values[order]
        self.v_batch = self.batch[order]
        self.v_start = np.searchsorted(self.v_key, np.arange(num_keys + 1))

    def interval(self, w: np.ndarray) -> dict:
        """The registers of the interval that took each pool batch `w[b]`
        times: nonzero (key, sorted bin) pairs in order, their counts and
        cumulative counts, and per key the total (int64)."""
        cnt = np.bincount(self.inverse, weights=w[self.batch],
                          minlength=self.pairs.size).astype(np.int64)
        live = cnt > 0
        pairs, cnt = self.pairs[live], cnt[live]
        key = pairs // BINS
        total = np.bincount(key, weights=cnt, minlength=self.num_keys
                            ).astype(np.int64)
        start = np.searchsorted(key, np.arange(self.num_keys + 1))
        cum = torch.from_numpy(cnt).cumsum(0).numpy()
        cum = cum - np.repeat(np.concatenate([[0], cum])[start[:-1]],
                              np.diff(start))
        return {"key": key, "bin": pairs % BINS, "count": cnt, "cum": cum,
                "start": start, "total": total, "present": total > 0,
                "w": w}

    def quantiles(self, reg: dict, ps: Sequence[float]) -> np.ndarray:
        """(keys, P) float32 quantiles by the stated rule; 0 for a key
        with no samples."""
        start, total = reg["start"], reg["total"]
        nnz = np.diff(start)
        width = int(nnz.max()) if nnz.size else 0
        k = self.num_keys
        if width == 0:
            return np.zeros((k, len(ps)), np.float32)
        # each key's cumulative counts as one float32 row, padded with inf
        col = np.arange(reg["key"].size) - np.repeat(start[:-1], nnz)
        cum32 = torch.full((k, width), float("inf"), dtype=F32)
        cum32[reg["key"], col] = torch.from_numpy(reg["cum"]).to(F32)
        cum64 = torch.zeros((k, width + 1), dtype=torch.int64)
        cum64[reg["key"], col + 1] = torch.from_numpy(reg["cum"])
        sbin = torch.zeros((k, width), dtype=torch.int64)
        sbin[reg["key"], col] = torch.from_numpy(reg["bin"])
        p = torch.tensor(ps, dtype=F32).clamp(0.0, 1.0)
        tot32 = torch.from_numpy(total).to(F32)
        rank = torch.clamp_min(p[None, :] * tot32[:, None], 0.5)
        j = torch.searchsorted(cum32, rank.contiguous(), side="left")
        j = j.clamp_max(width - 1)
        prev = torch.gather(cum64, 1, j)
        cnt = (torch.gather(cum64, 1, j + 1) - prev).to(F32)
        frac = torch.where(cnt > 0, (rank - prev.to(F32)) / cnt,
                           torch.tensor(0.5, dtype=F32)).clamp(0.0, 1.0)
        b = torch.gather(sbin, 1, j)
        q = LEFT32[b] + WIDTH32[b] * frac
        q = torch.where(torch.from_numpy(total)[:, None] > 0, q,
                        torch.zeros((), dtype=F32))
        return q.numpy()

    def midpoint_sums(self, reg: dict) -> np.ndarray:
        """Each key's float64 sum of count times bin midpoint."""
        terms = torch.from_numpy(reg["count"]).to(F64) * MID[
            torch.from_numpy(reg["bin"])]
        return torch.zeros(self.num_keys, dtype=F64).index_add_(
            0, torch.from_numpy(reg["key"]), terms).numpy()

    def rank_bins(self, reg: dict, keys: np.ndarray,
                  ps: np.ndarray) -> Dict[str, np.ndarray]:
        """For each (key, p): the sorted bins of the samples at the two
        closest ranks of the exact weighted quantile p (n - 1), widened
        by one sample on either side (`lo`, `hi`)."""
        w = reg["w"][self.v_batch].astype(np.float64)
        cw = np.concatenate([[0.0], np.cumsum(w)])
        keys = np.asarray(keys, np.int64)
        n = reg["total"][keys].astype(np.float64)
        pos = np.asarray(ps, np.float64) * (n - 1)
        base = cw[self.v_start[keys]]
        out = {}
        for name, at in (("lo", np.floor(pos) - 1), ("hi", np.ceil(pos) + 1)):
            i = np.clip(at, 0, np.maximum(n - 1, 0))
            line = np.searchsorted(cw, base + i, "right") - 1
            line = np.clip(line, 0, self.v_value.size - 1)
            out[name] = sorted_bin(self.v_value[line]).numpy()
        return out
