"""The DogStatsD traffic generator: one pool of pre-rendered batches per
run, made from the seed, the configuration's key set and the traffic
mix's parameters.

Every key of every family appears at least once in the pool, so every key
is active in every interval the pool is cycled through; the other lines
draw keys by Zipf popularity within their family (hot keys spread over
the key space by a seeded permutation). Values come from small seeded
tables, rendered once, so a line is three byte strings joined: the key's
`name:`, the value, the key's `|type[|@rate]|#tags`.

Besides the datagrams the pool keeps, per line, the family, the key and
the value's index: the reference works from those, never from the text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

FAMILIES = ("counter", "gauge", "timer", "set")
FAM_CODE = {name: i for i, name in enumerate(FAMILIES)}
_TYPE = {"counter": b"c", "gauge": b"g", "timer": b"ms", "set": b"s"}


@dataclass
class Pool:
    """Pre-rendered traffic: `batches[b]` is a list of datagrams; the
    per-line arrays are (batches, lines a batch), in line order."""

    batches: List[List[bytes]]
    fam: np.ndarray       # int8 family code
    key: np.ndarray       # int32 key index within the family
    val: np.ndarray       # int32 index into the family's value table
    names: Dict[str, List[str]]        # family -> metric name per key
    tags: Dict[str, List[tuple]]       # family -> sorted tags per key
    values: Dict[str, np.ndarray]      # family -> float64 value as sent
    rates: np.ndarray                  # counter key -> its sample rate
    members: List[bytes]               # set member strings by index
    texts: Dict[str, List[bytes]]      # family -> value texts
    parts: Dict[str, tuple]            # family -> (heads, tails) per key

    @property
    def lines_per_batch(self) -> int:
        return self.fam.shape[1]


def zipf_counts(num_keys: int, n: int, s: float) -> np.ndarray:
    """How many of `n` draws each popularity rank gets when rank r has
    weight r**-s: the expected counts, rounded so that they sum to `n`.
    The same for every seed, so every run does the same work."""
    weights = np.arange(1, num_keys + 1, dtype=np.float64) ** -s
    exact = n * weights / weights.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(counts - exact, kind="stable")[:rest]] += 1
    return counts


def _zipf_keys(rng, num_keys: int, n: int, s: float) -> np.ndarray:
    """`n` key indices by Zipf popularity (exponent s) over `num_keys`
    keys: rank r gets its share of `n` (zipf_counts); which key holds
    which rank is the seed's permutation."""
    if n <= 0:
        return np.zeros(0, np.int32)
    return np.repeat(rng.permutation(num_keys).astype(np.int32),
                     zipf_counts(num_keys, n, s))


def _tables(rng, traffic: dict) -> Dict[str, tuple]:
    """Each family's value table: (texts, float64 values as sent)."""
    vt = traffic["values"]
    out = {}
    cvals = np.arange(vt["counter_min"], vt["counter_max"] + 1)
    out["counter"] = ([b"%d" % v for v in cvals], cvals.astype(np.float64))
    for family, draw in (("gauge", lambda n: rng.normal(
            vt["gauge_mean"], vt["gauge_sd"], n)),
                         ("timer", lambda n: rng.gamma(
                             vt["timer_shape"], vt["timer_scale"], n))):
        n = vt[f"{family}_table"]
        texts = np.unique(np.char.mod("%.3f", draw(n)).astype("S"))
        values = texts.astype(np.float64)
        # distinct as the card stores them (float32), so a value maps
        # back to one text
        _, keep = np.unique(values.astype(np.float32), return_index=True)
        out[family] = ([bytes(t) for t in texts[keep]], values[keep])
    members = [b"m%d" % j for j in range(traffic["set_members_per_key"])]
    out["set"] = (members, np.arange(len(members), dtype=np.float64))
    return out


def build(config: dict, traffic: dict, seed: int) -> Pool:
    """The pool for one run."""
    rng = np.random.default_rng([seed & (2**63 - 1), 0x5045])
    keys = config["keys"]
    lines_per_batch = (traffic["datagrams_per_batch"]
                       * traffic["lines_per_datagram"])
    n_batches = traffic["pool_batches"]
    total = n_batches * lines_per_batch
    shares = traffic["family_share"]
    counts = {f: int(round(shares[f] * total)) for f in FAMILIES}
    counts["timer"] += total - sum(counts.values())
    tables = _tables(rng, traffic)

    fam_parts, key_parts, val_parts = [], [], []
    for family in FAMILIES:
        n_keys = keys[family]
        n = counts[family]
        if n < n_keys:
            raise ValueError(f"{family}: {n} lines cannot cover "
                             f"{n_keys} keys")
        k = np.concatenate([np.arange(n_keys, dtype=np.int32),
                            _zipf_keys(rng, n_keys, n - n_keys,
                                       traffic["zipf_s"])])
        v = rng.integers(0, len(tables[family][0]), n).astype(np.int32)
        fam_parts.append(np.full(n, FAM_CODE[family], np.int8))
        key_parts.append(k)
        val_parts.append(v)
    order = rng.permutation(total)
    fam = np.concatenate(fam_parts)[order].reshape(n_batches, -1)
    key = np.concatenate(key_parts)[order].reshape(n_batches, -1)
    val = np.concatenate(val_parts)[order].reshape(n_batches, -1)

    tagset = config["tags"]
    names: Dict[str, List[str]] = {}
    tags: Dict[str, List[tuple]] = {}
    parts = {}
    rates = np.where(np.arange(keys["counter"]) % 2 == 0, 1.0,
                     config["counter_sampled_rate"])
    for family in FAMILIES:
        prefix = config["name_prefix"][family]
        fam_names = [f"{prefix}{k}" for k in range(keys[family])]
        fam_tags = [tuple(sorted(
            f"{t['key']}:{t['value_prefix']}{k % t['values']}"
            for t in tagset)) for k in range(keys[family])]
        names[family], tags[family] = fam_names, fam_tags
        head = [f"{n}:".encode() for n in fam_names]
        tail = []
        for k in range(keys[family]):
            rate = (b"|@%s" % repr(float(rates[k])).encode()
                    if family == "counter" and rates[k] != 1.0 else b"")
            tail.append(b"|" + _TYPE[family] + rate + b"|#"
                        + ",".join(fam_tags[k]).encode())
        parts[family] = (head, tail)

    texts = {f: tables[f][0] for f in FAMILIES}
    batches = _render(fam, key, val, parts, texts,
                      traffic["lines_per_datagram"])
    return Pool(batches=batches, fam=fam, key=key, val=val, names=names,
                tags=tags, values={f: tables[f][1] for f in FAMILIES},
                rates=rates, members=tables["set"][0], texts=texts,
                parts=parts)


def _render(fam, key, val, parts, texts, per_dgram: int,
            chunk: int = 16) -> List[List[bytes]]:
    """Every batch's datagrams, assembled with numpy: each line is four
    segments (head, value, tail, newline) gathered from one byte table."""
    segs: List[bytes] = []
    base = {}
    for family in FAMILIES:
        head, tail = parts[family]
        base[family] = (len(segs), len(segs) + len(head),
                        len(segs) + 2 * len(head))
        segs += head + tail + texts[family]
    newline = len(segs)
    segs.append(b"\n")
    seg_len = np.fromiter((len(x) for x in segs), np.int64, len(segs))
    seg_off = np.cumsum(seg_len) - seg_len
    src = np.frombuffer(b"".join(segs), np.uint8)
    head_id = np.empty(fam.shape, np.int64)
    tail_id = np.empty(fam.shape, np.int64)
    val_id = np.empty(fam.shape, np.int64)
    for family in FAMILIES:
        at = fam == FAM_CODE[family]
        h0, t0, v0 = base[family]
        head_id[at] = h0 + key[at]
        tail_id[at] = t0 + key[at]
        val_id[at] = v0 + val[at]
    out: List[List[bytes]] = []
    n_batches, per_batch = fam.shape
    for b0 in range(0, n_batches, chunk):
        ids = np.stack([head_id[b0:b0 + chunk], val_id[b0:b0 + chunk],
                        tail_id[b0:b0 + chunk],
                        np.full(head_id[b0:b0 + chunk].shape, newline)],
                       axis=-1).reshape(-1)
        lens = seg_len[ids]
        dst = np.cumsum(lens) - lens
        idx = np.repeat(seg_off[ids] - dst, lens) + np.arange(int(lens.sum()))
        buf = src[idx].tobytes()
        line_end = np.cumsum(lens.reshape(-1, 4).sum(axis=1))
        ends = line_end[per_dgram - 1::per_dgram]
        starts = np.concatenate([[0], ends[:-1]])
        dgrams = [buf[s:e - 1] for s, e in zip(starts.tolist(),
                                              ends.tolist())]
        per = per_batch // per_dgram
        out += [dgrams[i:i + per] for i in range(0, len(dgrams), per)]
    return out
